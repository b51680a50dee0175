#!/usr/bin/env python3
"""Where the time of one full-width train step of the PyTorch port goes,
on one CUDA card (the training breakdown of PERF.md section 5).

    python3 profile_train.py

For each cell of chip_smoke.py (the registry's reflect-sampling-nerf:
128 + 128 + 64 + 64 samples; reflect-sampling-nerf-proposal: 64 proposal
+ 128 fine + 64 reflect-proposal + 64 reflect-fine samples; the default
method with pose refinement (camera_optimizer SO3xR3) on the recompute
route (use_pallas_acts False); all with compute_dtype bfloat16, 1024
rays, the synthetic sphere at 800x800, seed chip_smoke.SEED), builds the
trainer, runs 60 steps to warm up (kernel build, the adaptive reflect
bucket, the normal losses on from step 50), times STEPS steps without the
profiler, then PROFILED steps under torch.profiler, then one step for its
peak device memory above what the trainer holds before it.  Prints, per
cell, the wall time per step, the device time summed over every kernel,
copy and fill (the device's busy and idle shares of the profiled wall),
the backward kernels' share of it (kernel A of K5, K4 and K8, each its
body's field_backward_v6 / v5 / v4 kernel, and kernel B, wgrad_kernel,
which all three share), the peak memory, and the device time per kernel name, largest first.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP = 60
STEPS = 20
PROFILED = 5
TOP = 25
# (method, model flags, pose refinement on the recompute route)
METHODS = (("reflect-sampling-nerf", {}, False),
           ("reflect-sampling-nerf-proposal", {"use_pallas_proposal": True},
            False),
           ("reflect-sampling-nerf", {}, True))
BWD_KERNELS = (("K5 kernel A", "field_backward_v6_kernel"),
               ("K4 kernel A", "field_backward_v5_kernel"),
               ("K8 kernel A", "field_backward_v4_kernel"),
               ("kernel B", "wgrad_kernel"))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    for method, flags, camera in METHODS:
        profile_steps(method, flags, camera, torch.device("cuda", 0))
    return 0


def profile_steps(method: str, flags, camera: bool, device) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, smoke_config, with_route
    from rsn_torch.engine.trainer import Trainer
    from rsn_torch.kernels import field_forward as ff

    config = dataclasses.replace(smoke_config(method, **flags), seed=SEED)
    if camera:
        config = with_route(config, True, False)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, run_dir=tmp, device=device)
        for _ in range(WARMUP):
            m = trainer.train_step()
        trainer._maybe_adapt_reflect_fraction(
            {k: float(m[k]) for k in ("mask_fraction", "reflect_overflow")})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / STEPS
        ff.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                trainer.train_step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in ff.LAUNCHES.items() if v}
        bucket = trainer._reflect_frac
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base

    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        # device kernels, copies and fills (not the annotated ranges, such
        # as the optimizer's step, which the profiler also shows there)
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and "#" not in e.name):
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e6
    busy = sum(s for _, s in per_name.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    rays = config.pipeline.datamanager.train_num_rays_per_batch
    cell = config.method_name + (" camera SO3xR3, recompute route" if camera
                                 else "")
    print(f"{cell}: {rays}-ray steps after {WARMUP} warm-up "
          f"steps, reflect bucket "
          f"{bucket}; launches in {PROFILED} profiled steps {launches}")
    print(f"wall {step_s * 1e3:.4f} ms per step without the profiler "
          f"({rays / step_s:.1f} rays/s over {STEPS} steps), "
          f"{wall / PROFILED * 1e3:.4f} ms with it")
    print(f"device time {busy / PROFILED * 1e3:.4f} ms per step over "
          f"{sum(c for c, _ in per_name.values()) // PROFILED} device ops: "
          f"busy {busy / wall:.2%}, idle {1 - busy / wall:.2%} of the "
          f"profiled wall")
    bwd = {label: sum(secs for name, (_, secs) in per_name.items()
                      if kernel in name) for label, kernel in BWD_KERNELS}
    total = sum(bwd.values())
    print("backward kernels per step: " + ", ".join(
        f"{label} {secs / PROFILED * 1e3:.4f} ms" for label, secs in
        bwd.items()) + f"; together {total / PROFILED * 1e3:.4f} ms, "
          f"{total / busy:.2%} of device time; peak device memory of one "
          f"step {peak / 2**30:.4f} GiB above the trainer's "
          f"{base / 2**30:.4f} GiB")
    print(f"{'device ms':>10} {'share':>7} {'count':>6}  name (per step)")
    for name, (count, secs) in sorted(per_name.items(),
                                      key=lambda kv: -kv[1][1])[:TOP]:
        print(f"{secs / PROFILED * 1e3:10.4f} {secs / busy:7.2%} "
              f"{count // PROFILED:6d}  {name[:110]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
