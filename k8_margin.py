#!/usr/bin/env python3
"""How far K8's weight-gradient check stands from its limit, on one CUDA
card.

    python3 k8_margin.py

chip_smoke.py's phase 12 holds K8's w0..w7 and w_hc to K4's on K3's spill
within K13_TOL (1e-4) of each tensor's max, on passes 2 and 4 of one
camera-on step.  This script reads that error over field seeds SEEDS and
train steps STEPS: chip_smoke.py's full-width camera-on recompute route
on the sphere at 800x800, a trainer per seed (field weights, pose deltas
and the trainer's seed from it), each step's K8 inputs captured as phase
12 captures them.  On the same inputs it also reads what a wrong kernel B
would give: K8's partials with one of the P row slices left out, and with
one 64-row record of the first chunk zeroed before the contraction; and
how far K8's and K4's weight matrices each stand from the fp64 sums of
the same bf16 operands (K8's records, contracted in float64).  Prints one
line per (seed, step, pass), then the largest sound reading and the
smallest wrong one, with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SEEDS = (3, 4, 5)
STEPS = (1, 2, 50, 51, 52, 53)


def readings(lib, args, sms):
    """K8's weight matrices against K4's on K3's spill -> (sound, a slice
    left out, a record zeroed, K8 against the fp64 sums of its records, K4
    against them): each the largest error over each tensor's max."""
    import torch

    from chip_smoke import K8_WEIGHTS, rel_err
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels import wgrad_sm90 as wg

    packed, mc, g, d_out, f_out, S = args
    _, acts = ft.field_forward_v6(packed, mc, g, S)
    k4 = ft.field_backward_v5(packed, mc, g, acts, d_out, f_out, S)
    ref = [k4[2][i] for i in K8_WEIGHTS]
    err = lambda ws: max(rel_err(w, r) for w, r in zip(ws, ref))
    plan = ft.k8_plan(g.shape[0], S, sms)

    exact = torch.zeros((1, wg.PARTIAL_FLOATS), dtype=torch.float64,
                        device=mc.device)

    def partials(zero_record: bool):
        sc = ft.k8_scratch(plan, mc.device)
        part = torch.empty((plan.slices, wg.PARTIAL_FLOATS), device=mc.device)
        for c, chunk in enumerate(plan.chunks):
            ws = ft.k8_kernel_a(lib, plan, chunk, args[:5], sc)
            if zero_record and c == 0:
                ws[0].zero_()  # block 0's first tile: 64 rows
            elif not zero_record:
                wg.contract_plain(ws, exact, accumulate=True)
            wg.contract(ws, part, accumulate=c > 0)
        return part

    sound = [ft.field_backward_v4(*args)[2][i] for i in K8_WEIGHTS]
    part = partials(False)
    if not all(torch.equal(w, s) for w, s in
               zip(wg.weight_grads(part), sound)):
        raise RuntimeError("K8's chunks here differ from field_backward_v4")
    part[plan.slices // 2] = 0.0
    exact = wg.weight_grads(exact)
    return (err(sound), err(wg.weight_grads(part)),
            err(wg.weight_grads(partials(True))),
            max(rel_err(w, e) for w, e in zip(sound, exact)),
            max(rel_err(w, e) for w, e in zip(ref, exact)))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("k8_margin.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (K13_TOL, capture_recompute_inputs, smoke_config,
                            with_route)
    from rsn_torch.engine.trainer import Trainer
    from rsn_torch.kernels.build import load_library
    from rsn_torch.models.field import Field

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = load_library("field_train.cu")
    worst = [0.0, float("inf"), float("inf"), 0.0, 0.0]
    for seed in SEEDS:
        config = with_route(dataclasses.replace(smoke_config(), seed=seed),
                            True, False)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(config, run_dir=tmp, device=dev)
            trainer.field.load_state_dict(
                Field(torch.Generator().manual_seed(seed)).state_dict())
            with torch.no_grad():
                trainer.camera.copy_(0.01 * torch.randn(
                    trainer.camera.shape,
                    generator=torch.Generator().manual_seed(seed)))
            for step in STEPS:
                calls = capture_recompute_inputs(trainer, step)
                for p in (2, 4):
                    r = readings(lib, calls["bwd"][p], sms)
                    worst = [max(worst[0], r[0]), min(worst[1], r[1]),
                             min(worst[2], r[2]), max(worst[3], r[3]),
                             max(worst[4], r[4])]
                    print(f"seed {seed} step {step} pass {p}: sound "
                          f"{r[0]:.6g}, a slice left out {r[1]:.6g}, a "
                          f"record zeroed {r[2]:.6g}; against the fp64 "
                          f"sums of the records K8 {r[3]:.6g}, K4 "
                          f"{r[4]:.6g}", flush=True)
                del calls
            del trainer
        torch.cuda.empty_cache()
    print(f"over {len(SEEDS)} seeds x {len(STEPS)} steps x passes 2, 4: "
          f"largest sound {worst[0]:.6g}, smallest with a slice left out "
          f"{worst[1]:.6g} (the sound reading where the slice holds only "
          f"rows without a gradient), with a record zeroed {worst[2]:.6g} "
          f"(limit {K13_TOL}); against the fp64 sums at most K8 "
          f"{worst[3]:.6g}, K4 {worst[4]:.6g} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
