#!/usr/bin/env python3
"""What three choices of the train-width forwards (K3, K7, K1 at the train
width, K10) cost, by ablation, on one CUDA card.

    python3 ablate_k3.py

Builds rsn_torch/csrc/field_train.cu as the port builds it and with one
macro each, one nvcc each, in parallel, into rsn_torch/_build/variants/
(git-ignored):
  RSN_ABLATE_XS_REGS  the normals keep layer 4's x share in registers,
                      not in shared memory;
  RSN_ABLATE_NO_SPILL K3 without its spill stores;
  RSN_ABLATE_NO_IPE   no IPE: the consumers of K3, K7 and K1 at the train
                      width skip theirs (the most that K10's schedule can
                      hide), K10's IPE warps skip theirs and keep the
                      hand-off.
Prints each build's spills of the train forwards (ptxas -v).  Then times
K3 with the normals and the x spill, K7 and K10 with the normals, K1 at
the train width and K10 without them at the default step's pass-2 shape
(1,024 rays x 128 samples), and K1 at the train width at pass 4's (512 x
64) (seeded rays, field weights from chip_smoke.SEED; CUDA events around
one call, median of 10), the builds in turns: full, registers, no spill,
no IPE, no IPE, no spill, registers, full.  The no-spill and no-IPE
builds compute other outputs; only their times are read.  Prints the
card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = (("full", ()),
            ("x share in registers", ("RSN_ABLATE_XS_REGS",)),
            ("no spill", ("RSN_ABLATE_NO_SPILL",)),
            ("no IPE", ("RSN_ABLATE_NO_IPE",)))
# the kernels' mangled names: field_train_kernel<NORMALS, SPILL, SPILL_X>,
# field_forward_v5_kernel<NORMALS>
FORWARDS = (("K3 (normals, x)", "field_train_kernelILb1ELb1ELb1E"),
            ("K7", "field_train_kernelILb1ELb0ELb0E"),
            ("K1 train width", "field_train_kernelILb0ELb0ELb0E"),
            ("K10 (normals)", "field_forward_v5_kernelILb1E"),
            ("K10", "field_forward_v5_kernelILb0E"))


def spills(log: str):
    """-> {forward: ptxas's stack / spill line} from one build's log."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((tag for tag, key in FORWARDS if key in line), None)
        elif cur and "spill" in line:
            out[cur] = line.split(":")[-1].strip()
            cur = None
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ablate_k3.py needs a CUDA card")
    from chip_smoke import SEED
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels.build import finish_variants, start_variant
    from rsn_torch.models.field import Field
    from rsn_torch.utils.timing import time_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    libs, logs = finish_variants({
        name: start_variant("field_train.cu", macros, f"ablate_k3_{i}")
        for i, (name, macros) in enumerate(VARIANTS)})
    for name, _ in VARIANTS:
        print(f"{name}: " + "; ".join(
            f"{tag} {line}" for tag, line in spills(logs[name]).items()))
    dev = torch.device("cuda", 0)
    field = Field(torch.Generator().manual_seed(SEED)).to(dev).eval()
    p3 = ff.pack_params_v3f(field)
    p4 = ft.pack_params_v4f(p3, field)
    blob = ft.train_blob(p3[:8], p3[16])

    def inputs(R, S):
        gen = torch.Generator().manual_seed(R)
        n = R * S
        mc = torch.zeros(n, 16)
        mc[:, :3] = torch.rand(n, 3, generator=gen) * 3.6 - 1.8
        mc[:, 3:6] = torch.rand(n, 3, generator=gen) * 3e-3
        dirs = torch.nn.functional.normalize(
            torch.randn(R, 3, generator=gen), dim=-1).to(dev)
        return mc.to(dev), ff.mid_g_bands(field, dirs), S

    def no_spill(entry, packed, inputs, normals):
        return lambda lib: ft.launch_no_spill(lib, entry, packed, *inputs,
                                              normals, blob)

    pass2, pass4 = inputs(1024, 128), inputs(512, 64)
    k7, k10 = "rsn_field_forward_v4", "rsn_field_forward_v5"
    cases = (
        ("K3 (normals, x) pass 2", lambda lib: ft.launch_field_forward_v6(
            lib, p4, *pass2, True, True, blob)),
        ("K7 pass 2", no_spill(k7, p4, pass2, True)),
        ("K10 (normals) pass 2", no_spill(k10, p4, pass2, True)),
        ("K1 train width pass 2", no_spill(k7, p3, pass2, False)),
        ("K10 pass 2", no_spill(k10, p3, pass2, False)),
        ("K1 train width pass 4", no_spill(k7, p3, pass4, False)))
    order = [VARIANTS[i][0] for i in (0, 1, 2, 3, 3, 2, 1, 0)]
    for tag, fn in cases:
        ms = [(name, time_kernel(fn, libs[name])) for name in order]
        print(f"{tag}: " + ", ".join(f"{name} {t:.4f} ms" for name, t in ms)
              + f" (median of 10; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
