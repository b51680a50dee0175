#!/usr/bin/env python3
"""What K8's kernel A spends on its workspace stores, by ablation, on one
CUDA card.

    python3 ablate_k8.py

Builds rsn_torch/csrc/field_train.cu once as the port builds it, once
with RSN_ABLATE_NO_STASH_COPY (kernel A gathers its weight-gradient
operands into its shared staging buffers but copies none to the
workspace) and once with RSN_ABLATE_NO_STASH (neither), one nvcc each, in
parallel, into rsn_torch/_build/ablate/ (git-ignored).  Then times kernel
A over every chunk of one K8 call (field_train.kernel_a per chunk of
field_train.stash_plan, as field_backward_v4 launches it) of each build at
the camera-on step's pass-2 and pass-4 shapes (1,024 rays x 128 samples,
512 x 64; seeded rays, field weights from chip_smoke.SEED), CUDA events,
median of 10, the full build first and last.  The ablated builds leave
the workspace unwritten; only their time is read.  Prints the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = (("full", ()),
            ("gathers, no copies", ("RSN_ABLATE_NO_STASH_COPY",)),
            ("no stash stores", ("RSN_ABLATE_NO_STASH",)))


def build(out_dir: str):
    from rsn_torch.kernels import build as b

    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, (name, macros) in enumerate(VARIANTS):
        lib = os.path.join(out_dir, f"field_train_{i}.so")
        cmd = [b.find_nvcc(), *b.NVCC_FLAGS, *(f"-D{m}" for m in macros),
               "-o", lib, os.path.join(b.CSRC_DIR, "field_train.cu")]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
        b._declare(libs[name], "field_train.cu")
    return libs


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ablate_k8.py needs a CUDA card")
    from chip_smoke import SEED
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.models.field import Field
    from rsn_torch.utils.timing import time_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    libs = build(os.path.join(REPO, "rsn_torch", "_build", "ablate"))
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    field = Field(torch.Generator().manual_seed(SEED)).to(dev).eval()
    packed = ff.pack_params_v3f(field)
    for R, S in ((1024, 128), (512, 64)):
        gen = torch.Generator().manual_seed(R)
        n = R * S
        mc = torch.zeros(n, 16)
        mc[:, :3] = torch.rand(n, 3, generator=gen) * 3.6 - 1.8
        mc[:, 3:6] = torch.rand(n, 3, generator=gen) * 3e-3
        mc = mc.to(dev)
        dirs = torch.nn.functional.normalize(
            torch.randn(R, 3, generator=gen), dim=-1).to(dev)
        g = ff.mid_g_bands(field, dirs)
        f_out = ft.field_forward_v3_train(packed, mc, g, S)
        d_out = torch.randn(n, ft.OUT_TRAIN, generator=gen)
        d_out[:, 14:] = 0.0
        d_out = d_out.to(torch.bfloat16).to(dev)
        plan = ft.stash_plan(R, S, sms)
        sc = ft.stash_scratch(plan, dev)
        inputs = (packed, mc, g, d_out, f_out)

        def kernel_a(lib):
            for chunk in plan.chunks:
                ft.kernel_a(lib, "field_backward_v4", plan, chunk, inputs,
                            sc)

        order = [name for name, _ in VARIANTS] + [VARIANTS[0][0]]
        ms = [(name, time_kernel(kernel_a, libs[name])) for name in order]
        print(f"kernel A at {R} rays x {S} samples ({len(plan.chunks)} "
              f"chunks): " + ", ".join(f"{name} {t:.4f} ms" for name, t in ms)
              + f" (median of 10; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
