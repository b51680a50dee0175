"""K17: the port of tools/exp_bwd_whole.py.

field_backward_whole (replaces exp_bwd_whole.py::field_backward_whole;
the tool exits at import and names rsn's field_backward_v4(n_halves=1) as
its equivalent) computes K8's function (rsn_torch.kernels.field_train.
field_backward_v4): pack_params_v3f's 20 operands, (N, 16) f32 mean_cov,
(R, 512) f32 g_bands, the (N, 24) bf16 cotangent d_out and forward output
f_out -> (dmc (N, 16) f32, dg (R, 512) f32, the 20 fp32 weight
gradients).  Its body is K8's on 128-row tiles where K8 runs 64 (the
tool's one whole-tile chain against two halves).  On the card it runs as
K8 does: per chunk of K8's plan, its kernel A (the 128-row body, each
tile's two 64-row halves stashed as the records of K8's 64-row tiles, in
turns through one staging buffer) and K8's kernel B, counted as
field_backward_whole and field_backward_whole_wgrad.  Its records are
K8's, so dmc and the weight matrices w0..w7, w_hc equal K8's bit for bit;
dg, b_hc and the mid head's gradients, which kernel A sums over 128 rows,
differ from K8's only by the order of those fp32 sums.  Its first design
(one launch summing every product into per-block fp32 slices) is kept in
the RSN_K13_FIRST_DESIGN build of field_train.cu (first_design).

The wrapper runs K8's plain version for CPU tensors and launches the CUDA
kernels (rsn_torch/csrc/field_train.cu) for CUDA tensors.

    python -m rsn_torch.experiments.bwd_whole

times K17 against its first design and K8 on the same rows (the tool's
131,072 rows, 128 samples per ray) on the card, with the largest
difference of each output.
"""
from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft
from rsn_torch.kernels import wgrad_sm90 as wg

BF16, F32 = torch.bfloat16, torch.float32
WHOLE_ROWS = 2 * ft.TILE_ROWS  # K17's row tile (field_train.cu WHOLE)
WGRAD_LABEL = "field_backward_whole_wgrad"


class WholeScratch(NamedTuple):
    """One K17 call's outputs and scratch on the card."""
    dmc: torch.Tensor    # (N, 16) f32
    dg: torch.Tensor     # (R, 512) f32, zeroed
    small: torch.Tensor  # (blocks, SMALL_FLOATS) f32 compact slices, zeroed
    slots: torch.Tensor  # (blocks, 128, ACTS_COLS) bf16 recompute slots
    dxe: torch.Tensor    # (blocks, 128, 128) f32 dx tiles
    stash: torch.Tensor  # (blocks x the first chunk's tiles, REC_ELEMS) bf16


def whole_scratch(plan: ft.StashPlan, device) -> WholeScratch:
    """A call's WholeScratch on K8's plan, its workspace sized for the
    largest chunk."""
    per = plan.chunks[0][1] - plan.chunks[0][0]
    tiles = (plan.blocks, WHOLE_ROWS)
    return WholeScratch(
        torch.empty((plan.rays * plan.samples_per_ray, ff.IN_COLS),
                    dtype=F32, device=device),
        torch.zeros((plan.rays, 512), dtype=F32, device=device),
        torch.zeros((plan.blocks, ft.SMALL_FLOATS), dtype=F32,
                    device=device),
        torch.empty(tiles + (ft.ACTS_COLS,), dtype=BF16, device=device),
        torch.empty(tiles + (ff.ENC_PAD,), dtype=F32, device=device),
        torch.empty((plan.blocks * per, wg.REC_ELEMS), dtype=BF16,
                    device=device))


def scratch_bytes(plan: ft.StashPlan) -> int:
    """whole_scratch's bytes but dmc and dg, and the partials: K8's, with
    128-row recompute slots and the dx tiles."""
    return (plan.scratch_bytes()
            + plan.blocks * WHOLE_ROWS * (ft.ACTS_COLS * 2 + ff.ENC_PAD * 4)
            - plan.blocks * ft.TILE_ROWS * ft.ACTS_COLS * 2)


def first_design_scratch_bytes(plan: ft.StashPlan) -> int:
    """The first design's scratch on the same partition: the per-block
    fp32 slices of all 20 gradients, the 128-row slots and dx tiles."""
    return plan.blocks * (ft.PACK_FLOATS * 4 + WHOLE_ROWS
                          * (ft.ACTS_COLS * 2 + ff.ENC_PAD * 4))


def kernel_a(lib, plan: ft.StashPlan, chunk, inputs,
             sc: WholeScratch) -> torch.Tensor:
    """K17's kernel A from `lib` (field_train.cu as load_library builds it)
    on chunk (t0, t1) of K8's `plan` (t0 even), on checked CUDA inputs
    (packed, mean_cov, g_bands, d_out, f_out), into `sc` -> the chunk's
    workspace, a view of sc.stash.  Counts its launch."""
    t0, t1 = chunk
    ws = sc.stash[:plan.blocks * (t1 - t0)]
    packed, mean_cov, g_bands, d_out, f_out = inputs
    device = d_out.device
    with torch.cuda.device(device):
        rc = lib.rsn_field_backward_whole_stash(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), d_out.data_ptr(),
            f_out.data_ptr(), ff._ptr_array(packed), sc.dmc.data_ptr(),
            sc.dg.data_ptr(), sc.small.data_ptr(), sc.slots.data_ptr(),
            sc.dxe.data_ptr(), ws.data_ptr(), plan.rays,
            plan.samples_per_ray, plan.rays_per_block, t0, t1,
            torch.cuda.current_stream(device).cuda_stream)
    ff._raise_on_error(lib, rc, "field_backward_whole")
    ff.LAUNCHES["field_backward_whole"] += 1
    return ws


def field_backward_whole(packed, mean_cov: torch.Tensor,
                         g_bands: torch.Tensor, d_out: torch.Tensor,
                         f_out: torch.Tensor, samples_per_ray: int):
    """K17 -> (dmc (N, 16) f32, dg (R, 512) f32, dpacked: 20 fp32 tensors
    shaped like the packed operands).  On the card, kernel A and kernel B
    once per chunk of K8's plan (ft.stash_plan, 4 tiles of every block a
    chunk: on the tools' 131,072 rows 4 chunks of 128 blocks, P = 7); its
    scratch per call (scratch_bytes) there is 286,261,248 bytes of
    workspace + 67,108,864 of slots + 8,388,608 of dx tiles + 1,378,304 of
    compact slices + 15,712,256 of partials = 378,849,280 (the first
    design's: 311,623,680 of slices + 75,497,472 of slots and dx tiles =
    387,121,152)."""
    S = int(samples_per_ray)
    R = ft._check_recompute(packed, mean_cov, g_bands, d_out, f_out, S,
                            "field_backward_whole")
    device = mean_cov.device
    if device.type == "cpu":
        return ft.field_backward_v4_plain(packed, mean_cov, g_bands, d_out,
                                          f_out, S)
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    plan = ft.stash_plan(R, S, ft._sm_count(device))
    sc = whole_scratch(plan, device)
    partial = torch.empty((plan.slices, wg.PARTIAL_FLOATS), dtype=F32,
                          device=device)
    inputs = (packed, mean_cov, g_bands, d_out, f_out)
    for c, chunk in enumerate(plan.chunks):
        wg.contract(kernel_a(lib, plan, chunk, inputs, sc), partial,
                    accumulate=c > 0, label=WGRAD_LABEL)
    dmc, dg, small = sc.dmc, sc.dg, sc.small
    del sc  # the sums below need none of the scratch
    return dmc, dg, ft.stash_grads(small, partial)


def first_design(lib, packed, mean_cov, g_bands, d_out, f_out,
                 samples_per_ray: int):
    """K17's first design on checked CUDA inputs, one launch from `lib`,
    the RSN_K13_FIRST_DESIGN build of field_train.cu: K8's first-design
    body on 128-row tiles, every product summed into its block's fp32
    slice of all 20 gradients -> (dmc, dg, the 20 gradients, the slices
    summed over the blocks by torch.sum).  Counts no launch."""
    device, n = mean_cov.device, mean_cov.shape[0]
    S = int(samples_per_ray)
    R = n // S
    rpb = ft._rays_per_block(R, device)
    blocks = -(-R // rpb)
    dmc = torch.empty((n, ff.IN_COLS), dtype=F32, device=device)
    dg = torch.zeros((R, 512), dtype=F32, device=device)
    buf = torch.zeros((blocks, ft.PACK_FLOATS), dtype=F32, device=device)
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
    ff._raise_on_error(lib, rc, "field_backward_whole (first design)")
    return dmc, dg, ft._packed_views(buf.sum(dim=0))


def max_diffs(got, ref):
    """{output: max |got - ref|} over dmc, dg and the weight gradients."""
    return {"dmc": float((got[0] - ref[0]).abs().max()),
            "dg": float((got[1] - ref[1]).abs().max()),
            "dpacked": max(float((a - b).abs().max())
                           for a, b in zip(got[2], ref[2]))}


def main(argv=None) -> int:
    """K17, its first design (the RSN_K13_FIRST_DESIGN build, built here)
    and K8 on the tool's rows (the forward output from K1 at the train
    width, a seeded cotangent): ms (median of 10 CUDA-event captures),
    TFLOP/s of the tool's 3x count, and the largest difference of each
    output from K17's."""
    from rsn_torch.experiments.bwd_ablate import TOOL_FLOPS_PER_ROW
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.kernels.build import start_variant
    from rsn_torch.utils.timing import time_kernel

    waiting = start_variant("field_train.cu", ("RSN_K13_FIRST_DESIGN",),
                            "first_design")
    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p1 = ff.pack_params_v3f(field)
    f_out = ft.field_forward_v3_train(p1, mc, g, S)
    gen = torch.Generator(mc.device).manual_seed(2)
    d_out = torch.randn(n, ft.OUT_TRAIN, generator=gen,
                        device=mc.device).to(BF16)
    args = (p1, mc, g, d_out, f_out, S)
    lib, _ = waiting()
    first = lambda *a: first_design(lib, *a)
    print(torch.cuda.get_device_name(0), flush=True)
    got = field_backward_whole(*args)
    for tag, fn in (("whole (K17, 128 rows)", field_backward_whole),
                    ("its first design", first),
                    ("halved (K8, 64 rows)", ft.field_backward_v4)):
        ms = time_kernel(fn, *args)
        diffs = "" if fn is field_backward_whole else "; max |K17 - it|: " \
            + ", ".join(f"{k} {v:.6g}" for k, v in
                        max_diffs(got, fn(*args)).items())
        print(f"{tag:22}: {ms:8.4f} ms "
              f"({3 * n * TOOL_FLOPS_PER_ROW / ms / 1e9:6.1f} TFLOP/s of 3x)"
              + diffs, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
