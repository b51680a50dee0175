#!/usr/bin/env python3
"""What two choices of the train-width forwards (K3, K7) cost, by ablation,
on one CUDA card.

    python3 ablate_k3.py

Builds rsn_torch/csrc/field_train.cu as the port builds it, with
RSN_ABLATE_XS_REGS (the normals keep layer 4's x share in registers, not
in shared memory) and with RSN_ABLATE_NO_SPILL (K3 without its spill
stores), one nvcc each, in parallel, into rsn_torch/_build/variants/
(git-ignored); prints each build's spills of the train forwards (ptxas
-v).  Then times K3 with the normals and the x spill and K7 at the default
step's pass-2 shape (1,024 rays x 128 samples) and K1 at the train width
at pass 4's (512 x 64) (seeded rays, field weights from chip_smoke.SEED;
CUDA events, median of 10), the builds in turns: full, registers, no
spill, no spill, registers, full.  The no-spill build leaves the spill
unwritten; only its time is read.  Prints the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = (("full", ()),
            ("x share in registers", ("RSN_ABLATE_XS_REGS",)),
            ("no spill", ("RSN_ABLATE_NO_SPILL",)))
# field_train_kernel<NORMALS, SPILL, SPILL_X>'s mangled template arguments
FORWARDS = (("K3 (normals, x)", "ILb1ELb1ELb1E"), ("K7", "ILb1ELb0ELb0E"),
            ("K1 train width", "ILb0ELb0ELb0E"))


def spills(log: str):
    """-> {forward: ptxas's stack / spill line} from one build's log."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((tag for tag, key in FORWARDS
                        if "field_train_kernel" + key in line), None)
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

    def forward_v4(lib, packed, mc, g, S, normals):
        out = torch.empty((mc.shape[0], ft.OUT_TRAIN), dtype=torch.bfloat16,
                          device=dev)
        rc = lib.rsn_field_forward_v4(
            mc.data_ptr(), g.data_ptr(), ff._ipe_consts(dev).data_ptr(),
            blob.data_ptr(), ff._ptr_array(packed), out.data_ptr(),
            mc.shape[0], S, int(normals),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")

    pass2, pass4 = inputs(1024, 128), inputs(512, 64)
    cases = (
        ("K3 (normals, x) pass 2", lambda lib: ft.launch_field_forward_v6(
            lib, p4, *pass2, True, True, blob)),
        ("K7 pass 2", lambda lib: forward_v4(lib, p4, *pass2, True)),
        ("K1 train width pass 4",
         lambda lib: forward_v4(lib, p3, *pass4, False)))
    order = [VARIANTS[i][0] for i in (0, 1, 2, 2, 1, 0)]
    for tag, fn in cases:
        ms = [(name, time_kernel(fn, libs[name])) for name in order]
        print(f"{tag}: " + ", ".join(f"{name} {t:.4f} ms" for name, t in ms)
              + f" (median of 10; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
