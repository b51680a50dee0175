#!/usr/bin/env python3
"""How far the weight-gradient checks of kernel B's users stand from their
limit, on one CUDA card.

    python3 k8_margin.py

K8, K4 and K5 take their weight matrices (w0..w7, w_hc) from kernel B.
chip_smoke.py's phase 12 holds K8's to K13's first design (the
RSN_K13_FIRST_DESIGN build of field_train.cu, built here beside the port's:
K8's first-design body, which sums per-block fp32 slices) within K13_TOL
(1e-4) of each tensor's
max, on passes 2 and 4 of one camera-on step.  This script reads that
error for K8 on passes 2 and 4, K5 on pass 2 and K4 on pass 4 (both on
K3's spill of the pass's rows), over field seeds SEEDS and train steps
STEPS: chip_smoke.py's full-width camera-on recompute route on the sphere
at 800x800, a trainer per seed (field weights, pose deltas and the
trainer's seed from it), each step's K8 inputs captured as phase 12
captures them.  On the same inputs it also reads what a wrong kernel B
would give: the partials with one of the P row slices left out, and with
one 64-row record of the first chunk zeroed before the contraction; and
how far the kernel's and K13's weight matrices each stand from the fp64
sums of the same bf16 operands (the kernel's records, contracted in
float64).  Prints one line per (seed, step, kernel, pass), then per kernel
the largest sound reading and the smallest wrong one, with the card's
name and power limit.
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
# (label, wrapper, pass)
READINGS = (("K8", "field_backward_v4", 2), ("K8", "field_backward_v4", 4),
            ("K5", "field_backward_v6", 2), ("K4", "field_backward_v5", 4))


def kernel_args(name: str, args):
    """The wrapper arguments of K8, K4 or K5 (`name`) on K8's captured
    arguments, K4 and K5 on K3's spill of the same rows."""
    from rsn_torch.kernels import field_train as ft

    packed, mc, g, d_out, f_out, S = args
    if name == "field_backward_v4":
        return args
    if name == "field_backward_v5":
        _, acts = ft.field_forward_v6(packed, mc, g, S)
        return (packed, mc, g, acts, d_out, f_out, S)
    _, xacts = ft.field_forward_v6(packed, mc, g, S, spill_x=True)
    return (packed, g, xacts, d_out, f_out, S)


def readings(lib, name: str, args, k13, sms):
    """The weight matrices of K8, K4 or K5 (`name`, on its wrapper's
    arguments `args`) against K13's (`k13`: its 20 gradients on the same
    rows) -> (sound, a slice left out, a record zeroed, the kernel against
    the fp64 sums of its records, K13 against them): each the largest
    error over each tensor's max."""
    import torch

    from chip_smoke import K8_WEIGHTS, rel_err
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels import wgrad_sm90 as wg

    ref = [k13[i] for i in K8_WEIGHTS]
    err = lambda ws: max(rel_err(w, r) for w, r in zip(ws, ref))
    f_out, S = args[-2], args[-1]
    device = f_out.device
    plan = ft.stash_plan(f_out.shape[0] // S, S, sms,
                         name == "field_backward_v4")
    exact = torch.zeros((1, wg.PARTIAL_FLOATS), dtype=torch.float64,
                        device=device)

    def partials(zero_record: bool):
        sc = ft.stash_scratch(plan, device, ft.STASH_KERNELS[name])
        part = torch.empty((plan.slices, wg.PARTIAL_FLOATS), device=device)
        for c, chunk in enumerate(plan.chunks):
            ws = ft.kernel_a(lib, name, plan, chunk, args[:-1], sc)
            if zero_record and c == 0:
                ws[0].zero_()  # block 0's first tile: 64 rows
            elif not zero_record:
                wg.contract_plain(ws, exact, accumulate=True)
            wg.contract(ws, part, accumulate=c > 0)
        return part

    grads = getattr(ft, name)(*args)[-1]
    sound = [grads[i] for i in K8_WEIGHTS]
    part = partials(False)
    if not all(torch.equal(w, s) for w, s in
               zip(wg.weight_grads(part), sound)):
        raise RuntimeError(f"{name}'s chunks here differ from its wrapper")
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
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels.build import load_library, start_variant
    from rsn_torch.models.field import Field

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waiting = start_variant("field_train.cu", ("RSN_K13_FIRST_DESIGN",),
                            "first_design")
    lib = load_library("field_train.cu")
    first, _ = waiting()
    worst = {label: [0.0, float("inf"), float("inf"), 0.0, 0.0]
             for label, _, _ in READINGS}
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
                k13 = {p: ft.field_backward_v3_first_design(
                    first, *calls["bwd"][p])[2] for p in (2, 4)}
                for label, name, p in READINGS:
                    r = readings(lib, name, kernel_args(name,
                                                        calls["bwd"][p]),
                                 k13[p], sms)
                    w = worst[label]
                    worst[label] = [max(w[0], r[0]), min(w[1], r[1]),
                                    min(w[2], r[2]), max(w[3], r[3]),
                                    max(w[4], r[4])]
                    print(f"seed {seed} step {step} {label} pass {p}: sound "
                          f"{r[0]:.6g}, a slice left out {r[1]:.6g}, a "
                          f"record zeroed {r[2]:.6g}; against the fp64 "
                          f"sums of the records {label} {r[3]:.6g}, K13 "
                          f"{r[4]:.6g}", flush=True)
                del calls, k13
            del trainer
        torch.cuda.empty_cache()
    for label, w in worst.items():
        print(f"{label} over {len(SEEDS)} seeds x {len(STEPS)} steps against "
              f"K13: largest sound {w[0]:.6g}, smallest with a slice left "
              f"out {w[1]:.6g} (the sound reading where the slice holds "
              f"only rows without a gradient), with a record zeroed "
              f"{w[2]:.6g} (limit {K13_TOL}); against the fp64 sums at "
              f"most {label} {w[3]:.6g}, K13 {w[4]:.6g} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
