#!/usr/bin/env python3
"""Whether the trainer's profiler window slows the steps after it.

    python3 window_cost.py [--reps 2]

On one CUDA card.  Each process trains `reflect-sampling-nerf` (bf16,
10 full-width steps, `chip_smoke.jpeg_train_run`) four times on
chip_smoke.py's nerfstudio capture of the committed 800x800 JPEG frames:

  none        no run profiles;
  window      the second run profiles steps 3-5 (the trainer sets
              TEARDOWN_CUPTI=1, so Kineto detaches CUPTI after the trace);
  cupti kept  the same with TEARDOWN_CUPTI=0 set by the caller, which the
              trainer leaves standing: CUPTI stays attached after the
              trace, as Kineto leaves it by default.

The three kinds of process run in turn, --reps times.  For each run it
prints the median host ms per step over steps 7-10 (after the window)
and 2-10, and the host's us per launch of a one-element add_ after it,
then the median of each over the reps.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
RUNS = {"none": "plain,plain,plain,plain",
        "window": "plain,profiled,plain,plain",
        "cupti kept": "plain,profiled,plain,plain"}
ENV = {"none": {}, "window": {}, "cupti kept": {"TEARDOWN_CUPTI": "0"}}


def child(order: str) -> None:
    """One process: the runs of `order`, one JSON line each."""
    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from rsn_torch.kernels.build import build_library, load_library

    paths, _ = build_library()
    for source in paths:
        load_library(source)
    with open(os.path.join(cs.JPEG_DIR, "digests.json")) as fh:
        files = json.load(fh)["files"]
    frames = [os.path.join(cs.JPEG_DIR, f) for f in sorted(files)
              if f.startswith("frame_")]
    with tempfile.TemporaryDirectory() as tmp:
        scene = cs.write_jpeg_capture(frames, os.path.join(tmp, "capture"))
        before = cs.launch_us()
        for i, name in enumerate(order.split(",")):
            _, ms = cs.jpeg_train_run("", scene, tmp, f"{name} {i}",
                                      name == "profiled")
            print("RESULT " + json.dumps({
                "run": i, "name": name, "launch_us_before": before,
                "med_7_10": float(np.median(ms[6:])),
                "med_2_10": float(np.median(ms[1:])),
                "launch_us": cs.launch_us()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    got = {kind: [] for kind in RUNS}
    for rep in range(args.reps):
        for kind, order in RUNS.items():
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", order],
                env={**os.environ, **ENV[kind]}, capture_output=True,
                text=True)
            if out.returncode != 0:
                print(out.stdout[-4000:], out.stderr[-4000:])
                raise RuntimeError(f"{kind}: exit {out.returncode}")
            rows = [json.loads(ln[len("RESULT "):])
                    for ln in out.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            got[kind].append(rows)
            print(f"{kind} rep {rep}: launch us before the runs "
                  f"{rows[0]['launch_us_before']:.3f}; " + "; ".join(
                      f"run {r['run']} {r['name']} steps 7-10 "
                      f"{r['med_7_10']:.3f} ms, 2-10 {r['med_2_10']:.3f} "
                      f"ms, launch us after {r['launch_us']:.3f}"
                      for r in rows), flush=True)
    print(f"median over {args.reps} reps (host ms per step; us per launch "
          f"after the run; {card}):")
    for kind, reps in got.items():
        cells = []
        for i in range(len(reps[0])):
            med = {k: statistics.median(rep[i][k] for rep in reps)
                   for k in ("med_7_10", "med_2_10", "launch_us")}
            cells.append(f"run {i} {reps[0][i]['name']} "
                         f"{med['med_7_10']:.3f} / {med['med_2_10']:.3f} ms, "
                         f"{med['launch_us']:.3f} us")
        print(f"  {kind}: " + "; ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
