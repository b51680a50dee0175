#!/usr/bin/env python3
"""Where the time of one full-width train step of the PyTorch port goes,
on one CUDA card (the training breakdown of PERF.md section 5).

    python3 profile_train.py

Builds the trainer of chip_smoke.py's configuration (the registry's
reflect-sampling-nerf with compute_dtype bfloat16: 1024 rays, 128 + 128 +
64 + 64 samples, the synthetic sphere at 800x800, weights from
chip_smoke.SEED), runs 60 steps to warm up (kernel build, the adaptive
reflect bucket, the normal losses on from step 50), times STEPS steps
without the profiler, then PROFILED steps under torch.profiler.  Prints
the wall time per step, the device time summed over every kernel, copy
and fill (the device's busy and idle shares of the profiled wall), and
the device time per kernel name, largest first.
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


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, smoke_config
    from rsn_torch.engine.trainer import Trainer
    from rsn_torch.kernels import field_forward as ff

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    config = smoke_config()
    config = dataclasses.replace(config, seed=SEED)
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
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    print(f"{rays}-ray steps after {WARMUP} warm-up steps, reflect bucket "
          f"{bucket}; launches in {PROFILED} profiled steps {launches}")
    print(f"wall {step_s * 1e3:.4f} ms per step without the profiler "
          f"({rays / step_s:.1f} rays/s over {STEPS} steps), "
          f"{wall / PROFILED * 1e3:.4f} ms with it")
    print(f"device time {busy / PROFILED * 1e3:.4f} ms per step over "
          f"{sum(c for c, _ in per_name.values()) // PROFILED} device ops: "
          f"busy {busy / wall:.2%}, idle {1 - busy / wall:.2%} of the "
          f"profiled wall")
    print(f"{'device ms':>10} {'share':>7} {'count':>6}  name (per step)")
    for name, (count, secs) in sorted(per_name.items(),
                                      key=lambda kv: -kv[1][1])[:TOP]:
        print(f"{secs / PROFILED * 1e3:10.4f} {secs / busy:7.2%} "
              f"{count // PROFILED:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
