"""K17: the port of tools/exp_bwd_whole.py.

field_backward_whole (replaces exp_bwd_whole.py::field_backward_whole;
the tool exits at import and names rsn's field_backward_v4(n_halves=1) as
its equivalent) computes K8's function (rsn_torch.kernels.field_train.
field_backward_v4): pack_params_v3f's 20 operands, (N, 16) f32 mean_cov,
(R, 512) f32 g_bands, the (N, 24) bf16 cotangent d_out and forward output
f_out -> (dmc (N, 16) f32, dg (R, 512) f32, the 20 fp32 weight
gradients).  Its kernel is K8's body on 128-row tiles where K8 runs 64:
each weight-gradient product contracts over all 128 rows between one load
and one store of the block's fp32 slice (the tool's one whole-tile chain
against two halves), which halves the slice traffic per row.  dmc equals
K8's bit for bit; dg and the weight gradients differ from K8's only by the
order of their fp32 sums over the rows.

The wrapper runs K8's plain version for CPU tensors and launches the CUDA
kernel (rsn_torch/csrc/field_train.cu) for CUDA tensors.

    python -m rsn_torch.experiments.bwd_whole

times K17 against K8 on the same rows (the tool's 131,072 rows, 128
samples per ray) on the card, with the largest difference of each output.
"""
from __future__ import annotations

import sys

import torch

from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft

BF16, F32 = torch.bfloat16, torch.float32
WHOLE_ROWS = 2 * ft.TILE_ROWS  # K17's row tile (field_train.cu WHOLE)


def field_backward_whole(packed, mean_cov: torch.Tensor,
                         g_bands: torch.Tensor, d_out: torch.Tensor,
                         f_out: torch.Tensor, samples_per_ray: int):
    """K17 -> (dmc (N, 16) f32, dg (R, 512) f32, dpacked: 20 fp32 tensors
    shaped like the packed operands)."""
    S = int(samples_per_ray)
    R = ft._check_recompute(packed, mean_cov, g_bands, d_out, f_out, S,
                            "field_backward_whole")
    device = mean_cov.device
    if device.type == "cpu":
        return ft.field_backward_v4_plain(packed, mean_cov, g_bands, d_out,
                                          f_out, S)
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    rpb = ft._rays_per_block(R, device, 1)
    blocks = -(-R // rpb)
    dmc = torch.empty((mean_cov.shape[0], ff.IN_COLS), dtype=F32,
                      device=device)
    dg = torch.zeros((R, 512), dtype=F32, device=device)
    buf = torch.zeros((blocks, ft.PACK_FLOATS), dtype=F32, device=device)
    # one 128-row tile's recompute slot and fp32 dx tile per block
    ws = torch.empty((blocks, WHOLE_ROWS, ft.ACTS_COLS), dtype=BF16,
                     device=device)
    dxe = torch.empty((blocks, WHOLE_ROWS, ff.ENC_PAD), dtype=F32,
                      device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_backward_whole(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), d_out.data_ptr(),
            f_out.data_ptr(), ff._ptr_array(packed), dmc.data_ptr(),
            dg.data_ptr(), buf.data_ptr(), ws.data_ptr(), dxe.data_ptr(), R,
            S, rpb, torch.cuda.current_stream().cuda_stream)
    ff._raise_on_error(lib, rc, "field_backward_whole")
    ff.LAUNCHES["field_backward_whole"] += 1
    return dmc, dg, ft._unpack_slices(buf)


def max_diffs(got, ref):
    """{output: max |got - ref|} over dmc, dg and the weight gradients."""
    return {"dmc": float((got[0] - ref[0]).abs().max()),
            "dg": float((got[1] - ref[1]).abs().max()),
            "dpacked": max(float((a - b).abs().max())
                           for a, b in zip(got[2], ref[2]))}


def main(argv=None) -> int:
    """K17 and K8 on the tool's rows (the forward output from K1 at the
    train width, a seeded cotangent): ms (median of 10 CUDA-event
    captures), TFLOP/s of the tool's 3x count, and the largest difference
    of each output between the two."""
    from rsn_torch.experiments.bwd_ablate import TOOL_FLOPS_PER_ROW
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.utils.timing import time_kernel

    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p1 = ff.pack_params_v3f(field)
    f_out = ft.field_forward_v3_train(p1, mc, g, S)
    gen = torch.Generator(mc.device).manual_seed(2)
    d_out = torch.randn(n, ft.OUT_TRAIN, generator=gen,
                        device=mc.device).to(BF16)
    args = (p1, mc, g, d_out, f_out, S)
    print(torch.cuda.get_device_name(0), flush=True)
    diffs = max_diffs(field_backward_whole(*args), ft.field_backward_v4(*args))
    for tag, fn in (("whole (K17, 128 rows)", field_backward_whole),
                    ("halved (K8, 64 rows)", ft.field_backward_v4)):
        ms = time_kernel(fn, *args)
        print(f"{tag:22}: {ms:8.4f} ms "
              f"({3 * n * TOOL_FLOPS_PER_ROW / ms / 1e9:6.1f} TFLOP/s of 3x)",
              flush=True)
    print("max |K17 - K8|: " + ", ".join(f"{k} {v:.6g}"
                                         for k, v in diffs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
