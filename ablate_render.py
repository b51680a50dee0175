#!/usr/bin/env python3
"""Where K1's, K2's, K11's, K12's, K14's and K15's time goes, by ablation,
on one CUDA card.

    python3 ablate_render.py

Builds rsn_torch/csrc/field_forward.cu (K1, K2, K11, K12) and
experiments.cu (K14, K15) once as the port builds them and once per
RSN_ABLATE_* macro of trunk_sm90.cuh, unfolded_sm90.cuh and heads_sm90.cuh
(each leaves one part out of the Hopper kernels: RSN_ABLATE_NO_LOAD the
weight copies, RSN_ABLATE_NO_EPILOGUE the trunk's per-layer bias + ReLU +
bf16 epilogue, RSN_ABLATE_NO_IPE the IPE (K12: its encoding's load),
RSN_ABLATE_NO_STORE K11's and K12's 768-byte rows (field_forward.cu
only), or all four), one nvcc per build, in parallel, into
rsn_torch/_build/variants/ (git-ignored).  Then times K1
(rsn_field_forward_v3), K2 (rsn_field_forward_density), K11
(rsn_field_forward_v2), K12 (rsn_field_forward, on the rows' exact IPE
encoding) and K14 / K15's four schedules (v3u, v3i, v3L, v3F) of every
build on the orbit chunk's shape (16,384 rays x 128 samples = 2,097,152
rows; field weights from chip_smoke.SEED), CUDA events, median of 10, the
full build first and last.  A build with a part left out computes a wrong
result; only its time is read.  Prints the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = (("full", ()),
            ("no weight copies", ("RSN_ABLATE_NO_LOAD",)),
            ("no epilogue", ("RSN_ABLATE_NO_EPILOGUE",)),
            ("no IPE", ("RSN_ABLATE_NO_IPE",)),
            ("no store", ("RSN_ABLATE_NO_STORE",)),
            ("products only", ("RSN_ABLATE_NO_LOAD", "RSN_ABLATE_NO_EPILOGUE",
                               "RSN_ABLATE_NO_IPE", "RSN_ABLATE_NO_STORE")))
# the macros experiments.cu reads (K14 / K15 have no RSN_ABLATE_NO_STORE)
EXP_VARIANTS = tuple(v for v in VARIANTS if v[0] != "no store")


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from chip_smoke import SEED
    from rsn_torch.experiments import interleave
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels.build import finish_variants, start_variant
    from rsn_torch.models.field import Field
    from rsn_torch.utils.timing import time_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("ablate_render.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    waiting = {name: start_variant("field_forward.cu", macros, f"ablate_{i}")
               for i, (name, macros) in enumerate(VARIANTS)}
    waiting.update({
        f"exp {name}": start_variant("experiments.cu", macros,
                                     f"ablate_{i}")
        for i, (name, macros) in enumerate(EXP_VARIANTS)})
    libs, _ = finish_variants(waiting)
    R, S = 16384, 128
    n = R * S
    rng = np.random.default_rng(SEED)
    mc = np.zeros((n, ff.IN_COLS), np.float32)
    mc[:, :3] = rng.uniform(-1.8, 1.8, (n, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, (n, 3))
    dev = torch.device("cuda", 0)
    mc = torch.from_numpy(mc).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((R, 3)).astype(np.float32)),
        dim=-1).to(dev)
    field = Field(torch.Generator().manual_seed(SEED)).to(dev).eval()
    g = ff.mid_g_bands(field, dirs)
    p1, p2 = ff.pack_params_v3f(field), ff.pack_params_density(field)
    p3 = ff.pack_params_v3(field)
    ph = ff.pack_params(field)
    enc = ff.ipe_enc(mc)
    b1, b2 = ff._ring_blob(p1, heads=True), ff._ring_blob(p2, heads=False)
    a1, a2 = ff._ptr_array(p1), ff._ptr_array(p2)
    consts = ff._ipe_consts(dev)
    out1 = torch.empty(n, ff.V3_EVAL_COLS, dtype=torch.bfloat16, device=dev)
    out2 = torch.empty(n, ff.DENS_COLS, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def k1(lib):
        rc = lib.rsn_field_forward_v3(mc.data_ptr(), g.data_ptr(),
                                      consts.data_ptr(), b1.data_ptr(), a1,
                                      out1.data_ptr(), n, S, stream)
        if rc:
            raise RuntimeError(f"K1 launch failed ({rc})")

    def k2(lib):
        rc = lib.rsn_field_forward_density(mc.data_ptr(), consts.data_ptr(),
                                           b2.data_ptr(), a2, out2.data_ptr(),
                                           n, stream)
        if rc:
            raise RuntimeError(f"K2 launch failed ({rc})")

    def k14(lib, entry, flags):
        interleave.launch_kernel(lib, entry, p3, mc, g, S, *flags)

    order = [name for name, _ in VARIANTS] + ["full"]
    for name in order:
        t2 = time_kernel(k2, libs[name], reps=10, warmup=1)
        t1 = time_kernel(k1, libs[name], reps=10, warmup=1)
        t11 = time_kernel(ff.launch_heads, libs[name], "field_forward_v2", ph,
                          mc, reps=10, warmup=1)
        t12 = time_kernel(ff.launch_heads, libs[name], "field_forward", ph,
                          enc, reps=10, warmup=1)
        print(f"{name:18s} K2 {t2:.4f} ms  K1 {t1:.4f} ms  K11 {t11:.4f} ms  "
              f"K12 {t12:.4f} ms  ({n} rows; median of 10; {card})",
              flush=True)
    order = [name for name, _ in EXP_VARIANTS] + ["full"]
    for name in order:
        lib = libs[f"exp {name}"]
        times = "  ".join(
            f"{v.replace('field_forward_', '')} "
            f"{time_kernel(k14, lib, entry, flags, reps=10, warmup=1):.4f} ms"
            for v, (entry, flags) in interleave.ENTRIES.items())
        print(f"{name:18s} {times}  ({n} rows; median of 10; {card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
