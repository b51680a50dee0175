#!/usr/bin/env python3
"""Where the device time of one 800x800 product frame of the PyTorch port
goes, on one CUDA card (the breakdown of PERF.md section 5).

    python3 profile_render.py

For each method of chip_smoke.py (the registry's reflect-sampling-nerf,
and reflect-sampling-nerf-proposal with use_pallas_proposal and a proposal
field drawn from chip_smoke.SEED + 2; compute_dtype bfloat16, field
weights drawn from chip_smoke.SEED, the synthetic sphere at 800x800),
renders its orbit through render_image with product_only=True, as the
render CLI does.  Frames 0 and 1 warm up (kernel build, compaction
bucket); frame 2 is timed once without the profiler and once under
torch.profiler.  Prints, per method, the wall times, the device time
summed over every kernel, copy and fill (so the device's busy and idle
shares of the profiled frame), and the device time per kernel name,
largest first.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME = 2
TOP = 25
METHODS = (("reflect-sampling-nerf", {}),
           ("reflect-sampling-nerf-proposal", {"use_pallas_proposal": True}))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_render.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    for method, flags in METHODS:
        profile_frame(method, flags, torch.device("cuda", 0))
    return 0


def profile_frame(method: str, flags, device) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FRAME_RES, SEED, smoke_config
    from rsn_torch.cli.render import orbit_cameras
    from rsn_torch.data.synthetic import load_cameras
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models.field import Field
    from rsn_torch.models.proposal import ProposalField

    config = smoke_config(method, **flags)
    field = Field(torch.Generator().manual_seed(SEED)).to(device).eval()
    proposal = (ProposalField(torch.Generator().manual_seed(SEED + 2))
                .to(device).eval() if config.pipeline.model.use_proposal
                else None)
    cams = orbit_cameras(load_cameras("synthetic", f"sphere:res={FRAME_RES}",
                                      "test"), FRAME + 1).to(device)
    chunk = preferred_eval_chunk(config, device)
    memo = {}

    def frame(i):
        t0 = time.perf_counter()
        out = render_image(field, cams, i, config, rays_per_chunk=chunk,
                           product_only=True, reflect_memo=memo,
                           proposal=proposal)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for i in range(FRAME):
        frame(i)
    _, plain_wall = frame(FRAME)
    ff.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall = frame(FRAME)
    launches = dict(ff.LAUNCHES)

    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e6
    busy = sum(s for _, s in per_name.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    n = cams.width * cams.height
    print(f"{config.method_name}: frame {FRAME} at {cams.width}x"
          f"{cams.height}, {chunk}-ray chunks: "
          f"mask fraction {float(out['mask'].mean()):.6f}, reflect bucket "
          f"{next(iter(memo.values()), 1.0)}, launches {launches}")
    print(f"wall {plain_wall:.4f} s without the profiler "
          f"({n / plain_wall:.1f} rays/s), {wall:.4f} s with it")
    print(f"device time {busy:.4f} s over {sum(c for c, _ in per_name.values())}"
          f" device ops: busy {busy / wall:.2%}, idle {1 - busy / wall:.2%} "
          f"of the profiled wall")
    print(f"{'device s':>10} {'share':>7} {'count':>6}  name")
    for name, (count, secs) in sorted(per_name.items(),
                                      key=lambda kv: -kv[1][1])[:TOP]:
        print(f"{secs:10.4f} {secs / busy:7.2%} {count:6d}  {name[:110]}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
