"""K19: the port of tools/exp_bwd_noipe.py.

run_noipe (replaces exp_bwd_noipe.py::run_noipe, kernel _noipe_kernel,
body _noipe_half) is K18's full backward (rsn_torch.experiments.
bwd_ablate) fed from a forward's spill instead of its own recompute: xacts
(N, 2176) bf16 holds the 8 post-ReLU trunk activations and the IPE
encoding x ([acts 0:2048 | x 2048:2176], K3's spill_x layout), g_bands (R,
512) f32, d_out (N, 128) bf16 (columns 0:14 live) and pack_params_v3's 22
operands -> (dg (R, 512) f32, the 22 fp32 weight gradients).  The heads,
the mid seed and the mid head are recomputed from the spilled last
activation; there is no IPE work, no dmc and no layer-0 dgrad.  On K3's
spill of the same rows it equals K18's full mode bit for bit on the card.

The wrapper runs the plain version (run_noipe_plain) for CPU tensors and
launches the CUDA kernels (rsn_torch/csrc/experiments_bwd.cu) for CUDA
tensors: as K18's full + wgrad, per chunk kernel A (the body, stashing
each tile's weight-gradient operands) and kernel B (their wgmma
contraction; bwd_ablate.stash_backward).  run_noipe_chunked_plain is the
two phases in plain PyTorch, for the tests.

    python -m rsn_torch.experiments.bwd_noipe

times K19 against K4 (field_backward_v5, which also does the IPE
backward) on K3's spill of the tool's rows (131,072 rows, 128 samples per
ray) on the card, with TFLOP/s of the tool's 2x count.
"""
from __future__ import annotations

import sys

import torch

from rsn_torch.experiments import bwd_ablate
from rsn_torch.experiments.bwd_ablate import (backward_from_acts,
                                              check_backward_inputs,
                                              tool_cotangent)
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft

BF16 = torch.bfloat16


def run_noipe_plain(packed_v3, xacts: torch.Tensor, g_bands: torch.Tensor,
                    d_out: torch.Tensor, samples_per_ray: int,
                    bneck: torch.Tensor = None):
    """Plain PyTorch K19: K18's plain full mode after its recompute, on the
    spilled activations and x -> (dg, dpacked (22)); bneck as for
    backward_from_acts."""
    _, dg, dpk = backward_from_acts(packed_v3, ft._split_acts(xacts),
                                    xacts[:, ft.ACTS_COLS:], g_bands, d_out,
                                    samples_per_ray, "full", True, None,
                                    bneck)
    return dg, dpk


def run_noipe_chunked_plain(packed_v3, xacts: torch.Tensor,
                            g_bands: torch.Tensor, d_out: torch.Tensor,
                            samples_per_ray: int, sms: int):
    """Plain K19 in its two phases on a card of `sms` SMs (K18 full +
    wgrad's, x and the activations read from the spill) -> (dg, the 22
    gradients)."""
    _, dg, dpk = bwd_ablate._two_phases_plain(
        packed_v3, ft._split_acts(xacts), xacts[:, ft.ACTS_COLS:], g_bands,
        d_out, int(samples_per_ray), None, sms)
    return dg, dpk


def run_noipe(packed_v3, xacts: torch.Tensor, g_bands: torch.Tensor,
              d_out: torch.Tensor, samples_per_ray: int):
    """K19 -> (dg (R, 512) f32, the 22 weight gradients).  On the card,
    bwd_ablate.stash_backward."""
    S = int(samples_per_ray)
    check_backward_inputs("run_noipe", packed_v3, g_bands, d_out, S)
    device, n = d_out.device, d_out.shape[0]
    ff._check("xacts", xacts, (n, ft.XACTS_COLS), BF16, device)
    if device.type == "cpu":
        return run_noipe_plain(packed_v3, xacts, g_bands, d_out, S)
    _, dg, dpk = bwd_ablate.stash_backward(
        "run_noipe", (packed_v3, g_bands, xacts, d_out), S)
    return dg, dpk


def main(argv=None) -> int:
    """K19 and K4 on K3's spill of the tool's rows: ms (median of 10
    CUDA-event captures), TFLOP/s of the tool's 2x count."""
    from rsn_torch.experiments.bwd_ablate import TOOL_FLOPS_PER_ROW
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.utils.timing import time_kernel

    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p3, p1 = ff.pack_params_v3(field), ff.pack_params_v3f(field)
    out, xacts = ft.field_forward_v6(p1, mc, g, S, spill_x=True)
    _, acts = ft.field_forward_v6(p1, mc, g, S)
    d_out = tool_cotangent(n, mc.device)
    print(torch.cuda.get_device_name(0), flush=True)
    flops = 2 * n * TOOL_FLOPS_PER_ROW
    for tag, fn, args in (
            ("K4 (acts, IPE backward)", ft.field_backward_v5,
             (p1, mc, g, acts, d_out[:, :ft.OUT_TRAIN].contiguous(), out,
              S)),
            ("K19 (spill, no IPE)", run_noipe, (p3, xacts, g, d_out, S))):
        ms = time_kernel(fn, *args)
        print(f"{tag:24}: {ms:8.4f} ms ({flops / ms / 1e9:6.1f} TFLOP/s of "
              f"2x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
