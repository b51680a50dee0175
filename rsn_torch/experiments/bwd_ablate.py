"""K18: the port of tools/exp_bwd_ablate.py.

run (replaces exp_bwd_ablate.py::run, kernel make_kernel, body _half) is
the unfolded recompute backward on pack_params_v3's 22 operands: K1's
polynomial IPE of (N, 16) f32 mean_cov, the bf16 trunk, the unfolded
(256, 384) heads with the 256-wide bottleneck, the mid seed
bf16(bottleneck) @ w_emb + b_mid plus the roughness-attenuated per-ray SH
band partials g_bands (R, 512) f32, the mid head, all recomputed; then the
backward against d_out (N, 128) bf16 (columns 0:14 live, in the V3_*
order) in one of the tool's four modes:

    ("full", True)         dmc (N, 16), dg (R, 512), the 22 fp32 weight
                           gradients;
    ("full", False)        dmc and dg; the weight gradients are not
                           computed (the tool computes and drops them,
                           which XLA removes);
    ("no_ipe_bwd", False)  dg and dmc = dx[:, 0:16], the encoding
                           gradient's first columns (no IPE backward);
    ("recompute", False)   the forward only: dmc[:, 0] = mid[:, 0] + the
                           density pre-activation, the rest 0, dg = 0.

It returns (dmc, dg, dpacked), dpacked the 22 gradients summed over the
blocks in pack_params_v3's order and shapes, or None.  The roughness ->
attenuation edge carries no gradient; the bias gradients sum the fp32
cotangents, not the bf16 ones.

The wrapper launches the CUDA kernels (rsn_torch/csrc/experiments_bwd.cu)
for CUDA tensors.  The three modes without weight gradients recompute the
forward on the Hopper ring (unfolded_sm90.cuh on trunk_sm90.cuh, the
unfolded blob of interleave.ring_blob) and hand it to the backward body
through K3's spill layout (ring_backward): recompute is one launch of the
unfolded ring forward writing the dmc rows; full and no_ipe_bwd are kernel
F (the ring's trunk alone, x and the 8 activations to an (N, 2176) bf16
workspace, counted as SPILL_LABEL) and the body reading that spill, as
K19 reads K3's.  Full + wgrad runs, as K8 does, in chunks
(stash_backward: per chunk kernel A, the body stashing each tile's
weight-gradient operands in wgrad_sm90's UNFOLDED layout, then kernel B,
their wgmma contraction).  For CPU tensors the wrapper runs the plain
version (bwd_ablate_plain) in every mode: the spill only moves where the
activations wait, not their values.  spill_plain is kernel F's plain
version (K3's spill_x layout); bwd_ablate_chunked_plain is full + wgrad's
two phases in plain PyTorch, for the tests.  first_design launches any
mode's first design from the RSN_K18_FIRST_DESIGN build (64-row wmma
tiles recomputing the IPE and the trunk in each block), the bit-for-bit
yardstick of dmc and dg.

    python -m rsn_torch.experiments.bwd_ablate

times the four modes on the tool's rows (131,072 rows, 128 samples per
ray) on the card, with TFLOP/s of the tool's 3x count, then full's and
no_ipe_bwd's whole call back to back in turns with runs of stash_plan's
chunk of rays.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import torch

from rsn_torch.experiments.interleave import ring_blob, unfolded_tail
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH

BF16, F32 = torch.bfloat16, torch.float32
D_OUT_COLS = 128  # the tools' V3_OUT cotangent width: columns 0:14 live
# the tool's (mode, use_wgrad) variants, in its order -> the kernel's mode
# (experiments_bwd.cu Mode)
MODE_CODES = {("full", True): 0, ("full", False): 1, ("no_ipe_bwd", False): 2,
              ("recompute", False): 3}
VARIANTS = tuple(MODE_CODES)
# kernel F's launch count (full and no_ipe_bwd on the card)
SPILL_LABEL = "bwd_ablate_spill"
PACK_FLOATS = sum(r * c for r, c in ff.V3U_SHAPES)  # 674432
# the tools' per-row FLOP count (exp_bwd_ablate.py: 3x of 1.343e6)
TOOL_FLOPS_PER_ROW = 1.343e6
# kernel A's per-block fp32 slice (experiments_bwd.cu USlice<true>): b0..b7,
# bh, b_mid, w_out's 3 live columns (128 x 3), b_out (3, padded to 4)
SMALL_B, SMALL_BH = 0, TRUNK_LAYERS * TRUNK_WIDTH
SMALL_BMID = SMALL_BH + ff.OUT_DIM
SMALL_WOUT = SMALL_BMID + 128
SMALL_BOUT = SMALL_WOUT + 128 * 3
SMALL_FLOATS = SMALL_BOUT + 4  # 2948


def label(mode: str, use_wgrad: bool) -> str:
    """The launch-count label of a variant: bwd_ablate_<mode>[_wgrad]."""
    if (mode, bool(use_wgrad)) not in VARIANTS:
        raise ValueError(f"unknown mode {mode!r} (use_wgrad={use_wgrad}): "
                         f"one of {VARIANTS}")
    return f"bwd_ablate_{mode}" + ("_wgrad" if use_wgrad else "")


def backward_from_acts(packed_v3, hs, x: torch.Tensor, g_bands: torch.Tensor,
                       d_out: torch.Tensor, samples_per_ray: int,
                       mode: str = "full", use_wgrad: bool = True,
                       mean_cov: torch.Tensor = None,
                       bneck: torch.Tensor = None, ops: dict = None):
    """The tools' _half after the trunk recompute, from the 8 post-ReLU
    (N, 256) bf16 activations hs and the (N, 128) bf16 encoding x
    -> (dmc (N, 16) or None, dg (R, 512), dpacked (22) or None).
    mean_cov None: no IPE backward and no layer-0 dgrad (K19).  bneck: the
    (N, 256) bf16 bottleneck to use (unfolded_tail), else rounded here.
    ops: a dict that receives the weight gradients' bf16 operands as
    kernel A stashes them ("dheads": d_heads' 272 columns, "bneck",
    "dmid": dmid_pre, "dpre": dpre_0..dpre_7), with the weight
    gradients."""
    ws = packed_v3[:8]
    wh, _, w_emb, _, w_out, _ = packed_v3[16:]
    n, S = x.shape[0], samples_per_ray
    dev = x.device
    wgrad = use_wgrad and mode == "full"
    dpk = [None] * len(ff.V3U_SHAPES)
    heads, bneck, attens, mid_pre, hmid, mid = unfolded_tail(
        packed_v3, hs[-1], g_bands, S, bneck)
    if mode == "recompute":
        dmc = torch.zeros(n, ff.IN_COLS, device=dev)
        dmc[:, 0] = mid[:, 0] + heads[:, ff.OUT_DENSITY]
        return dmc, torch.zeros(n // S, 512, device=dev), None

    dout = d_out.float()
    diff = torch.sigmoid(heads[:, ff.OUT_DIFF])
    tint = torch.sigmoid(heads[:, ff.OUT_TINT])
    dmid_out = dout[:, 0:3]
    ddiff = dmid_out + dout[:, 3:6]
    dtint = dmid_out * mid + dout[:, 6:9]
    dz3 = dmid_out * tint * mid * (1.0 - mid)
    dz_b = dz3.to(BF16).float()
    if wgrad:
        dpk[20] = torch.zeros(128, 128, device=dev)
        dpk[20][:, 0:3] = hmid.float().t() @ dz_b
        dpk[21] = torch.zeros(1, 128, device=dev)
        dpk[21][0, 0:3] = dz3.sum(dim=0)
    dmid_pre = (dz_b @ w_out[:, 0:3].float().t()) * (mid_pre > 0)
    dmid_pre_b = dmid_pre.to(BF16).float()
    if wgrad and ops is not None:
        ops["bneck"], ops["dmid"] = bneck, dmid_pre.to(BF16)
        ops["dpre"] = [None] * TRUNK_LAYERS
    if wgrad:
        dpk[18] = bneck.float().t() @ dmid_pre_b
        dpk[19] = dmid_pre.sum(dim=0, keepdim=True)
    dbneck = dmid_pre_b @ w_emb.float().t()
    # the roughness -> attenuation edge carries no gradient
    dg = torch.cat([a * dmid_pre for a in attens], dim=1).reshape(
        n // S, S, 512).sum(dim=1)

    d_heads = torch.cat([dbneck, dout[:, 12:13], ddiff * diff * (1.0 - diff),
                         dtint * tint * (1.0 - tint), dout[:, 13:14],
                         dout[:, 9:12],
                         torch.zeros(n, ff.OUT_DIM - ff.N_HEAD_COLS,
                                     device=dev)], dim=1)
    d_heads_b = d_heads.to(BF16).float()
    if wgrad and ops is not None:
        ops["dheads"] = d_heads[:, :wg.DHEADS_N].to(BF16)
    if wgrad:
        dpk[16] = hs[-1].float().t() @ d_heads_b
        dpk[17] = d_heads.sum(dim=0, keepdim=True)
    dh = d_heads_b @ wh.float().t()
    dx_extra = None
    for i in range(TRUNK_LAYERS - 1, -1, -1):
        inp = hs[i - 1] if i > 0 else x
        if i == SKIP_AT:
            inp = torch.cat([x, hs[i - 1]], dim=1)
        dpre_f = dh * (hs[i].float() > 0)
        dpre = dpre_f.to(BF16).float()
        if wgrad and ops is not None:
            ops["dpre"][i] = dpre_f.to(BF16)
        if wgrad:
            dpk[i] = inp.float().t() @ dpre
            dpk[8 + i] = dpre_f.sum(dim=0, keepdim=True)
        if i == 0 and mean_cov is None:
            break  # layer 0's dgrad feeds only the (absent) IPE backward
        dinp = dpre @ ws[i].float().t()
        if i == SKIP_AT:
            dx_extra, dh = dinp[:, :ff.ENC_PAD], dinp[:, ff.ENC_PAD:]
        else:
            dh = dinp
    dpacked = tuple(dpk) if wgrad else None
    if mean_cov is None:
        return None, dg, dpacked
    dx = dh + dx_extra
    if mode == "no_ipe_bwd":
        return dx[:, 0:ff.IN_COLS].contiguous(), dg, dpacked
    dmean, dvar = ft._dmean_dvar(dx, mean_cov, want_var=True)
    dmc = torch.cat([dmean, dvar, torch.zeros(n, ff.IN_COLS - 6, device=dev)],
                    dim=1)
    return dmc, dg, dpacked


def bwd_ablate_plain(packed_v3, mean_cov: torch.Tensor,
                     g_bands: torch.Tensor, d_out: torch.Tensor,
                     samples_per_ray: int, mode: str = "full",
                     use_wgrad: bool = True):
    """Plain PyTorch K18: K1's IPE and the trunk recomputed from mean_cov,
    then backward_from_acts."""
    x = ff.ipe_x(mean_cov)
    hs = ft._trunk_acts(packed_v3[:8], packed_v3[8:16], x)
    return backward_from_acts(packed_v3, hs, x, g_bands, d_out,
                              samples_per_ray, mode, use_wgrad, mean_cov)


# ---- kernel F, plain ----------------------------------------------------

def spill_plain(packed_v3, mean_cov: torch.Tensor) -> torch.Tensor:
    """Plain kernel F: K1's IPE and the trunk from mean_cov -> (N, 2176)
    bf16 [hs0..hs7 | x], K3's spill_x layout."""
    x = ff.ipe_x(mean_cov)
    return torch.cat(ft._trunk_acts(packed_v3[:8], packed_v3[8:16], x)
                     + [x], dim=1)


# ---- full + wgrad and K19 in two phases: the schedule, in plain PyTorch --

def stash_plan(rays: int, samples_per_ray: int, sms: int,
               recompute: bool = True) -> ft.StashPlan:
    """The schedule of K18 full + wgrad (recompute) or K19 on a card of
    `sms` SMs: K4's partition, chunks of UNFOLDED.tiles_per_chunk = 4 tiles
    of every block, kernel B over UNFOLDED's 22 output tiles."""
    return ft.stash_plan(rays, samples_per_ray, sms, recompute, wg.UNFOLDED)


def stash_chunk_plain(plan: ft.StashPlan, chunk, x, hs, ops
                      ) -> torch.Tensor:
    """Plain kernel A's stash: the chunk's records from the rows' operands
    (x, hs, and backward_from_acts's ops), rows past a run's end zero
    -> (records, wg.U_REC_ELEMS) bf16."""
    tile = ft.tile_rows
    return torch.stack([
        wg.pack_unfolded(tile(x, row0, nv), [tile(h, row0, nv) for h in hs],
                         [tile(d, row0, nv) for d in ops["dpre"]],
                         tile(ops["dheads"], row0, nv),
                         tile(ops["bneck"], row0, nv),
                         tile(ops["dmid"], row0, nv))
        for _, _, row0, nv in plan.records(chunk)])


def _with_weights(dpk, w) -> Tuple[torch.Tensor, ...]:
    """The 22 gradients with w0..w7, wh and w_emb taken from w (10
    tensors)."""
    return (tuple(w[:8]) + tuple(dpk[8:16]) + (w[8], dpk[17], w[9])
            + tuple(dpk[19:22]))


def _two_phases_plain(packed_v3, hs, x, g_bands, d_out, S: int, mean_cov,
                      sms: int):
    """backward_from_acts's full + wgrad per-row values (dmc, dg, the
    biases, w_out and b_out), its weight-gradient operands stashed per
    chunk of the card's schedule in the UNFOLDED record layout, and plain
    kernel B's contraction of each chunk (its slices, the P partials
    summed as the wrappers sum them) -> (dmc or None, dg, the 22
    gradients)."""
    plan = stash_plan(d_out.shape[0] // S, S, sms, mean_cov is not None)
    ops = {}
    dmc, dg, dpk = backward_from_acts(packed_v3, hs, x, g_bands, d_out, S,
                                      "full", True, mean_cov, ops=ops)
    partial = torch.empty((plan.slices, wg.U_PARTIAL_FLOATS), dtype=F32)
    for c, chunk in enumerate(plan.chunks):
        wg.contract_plain(stash_chunk_plain(plan, chunk, x, hs, ops),
                          partial, c > 0, wg.UNFOLDED)
    return dmc, dg, _with_weights(dpk, wg.unfolded_weight_grads(partial))


def bwd_ablate_chunked_plain(packed_v3, mean_cov: torch.Tensor,
                             g_bands: torch.Tensor, d_out: torch.Tensor,
                             samples_per_ray: int, sms: int):
    """Plain K18 full + wgrad in its two phases on a card of `sms` SMs: the
    IPE and the trunk recomputed from mean_cov, then _two_phases_plain
    -> (dmc, dg, the 22 gradients)."""
    x = ff.ipe_x(mean_cov)
    hs = ft._trunk_acts(packed_v3[:8], packed_v3[8:16], x)
    return _two_phases_plain(packed_v3, hs, x, g_bands, d_out,
                             int(samples_per_ray), mean_cov, sms)


# ---- on the card ------------------------------------------------------------

class StashScratch(NamedTuple):
    """One K18 full + wgrad or K19 call's outputs and scratch on the card."""
    dmc: torch.Tensor    # K18: (N, 16) f32; K19: None
    dg: torch.Tensor     # (R, 512) f32, zeroed
    small: torch.Tensor  # (blocks, SMALL_FLOATS) f32 compact slices, zeroed
    slots: torch.Tensor  # K18: (blocks, 64, ACTS_COLS) bf16 recompute slots
    dxe: torch.Tensor    # K18: (blocks, 64, 128) f32 dx tiles
    stash: torch.Tensor  # (blocks x the first chunk's tiles, U_REC_ELEMS)


def stash_scratch(plan: ft.StashPlan, device) -> StashScratch:
    """A call's StashScratch, its workspace sized for the largest chunk; dmc,
    the recompute slots and the dx tiles only for K18's plan."""
    per = plan.chunks[0][1] - plan.chunks[0][0]
    n, k18 = plan.rays * plan.samples_per_ray, plan.recompute
    tiles = (plan.blocks, ft.TILE_ROWS)
    return StashScratch(
        torch.empty((n, ff.IN_COLS), dtype=F32, device=device)
        if k18 else None,
        torch.zeros((plan.rays, 512), dtype=F32, device=device),
        torch.zeros((plan.blocks, SMALL_FLOATS), dtype=F32, device=device),
        torch.empty(tiles + (ft.ACTS_COLS,), dtype=BF16, device=device)
        if k18 else None,
        torch.empty(tiles + (ff.ENC_PAD,), dtype=F32, device=device)
        if k18 else None,
        torch.empty((plan.blocks * per, wg.U_REC_ELEMS), dtype=BF16,
                    device=device))


def scratch_bytes(plan: ft.StashPlan) -> int:
    """stash_scratch's bytes: the plan's, plus K18's dx tiles."""
    dxe = plan.blocks * ft.TILE_ROWS * ff.ENC_PAD * 4 if plan.recompute \
        else 0
    return plan.scratch_bytes() + dxe


def kernel_a(lib, name: str, plan: ft.StashPlan, chunk, inputs,
             sc: StashScratch) -> torch.Tensor:
    """Kernel A of `name` ("bwd_ablate_full_wgrad": K18 full + wgrad on
    inputs (packed_v3, mean_cov, g_bands, d_out); "run_noipe": K19 on
    (packed_v3, g_bands, xacts, d_out); checked CUDA tensors) from `lib` (experiments_bwd.cu as
    load_library builds it) on chunk (t0, t1) of `plan`, into `sc` -> the
    chunk's workspace, a view of sc.stash.  Counts its launch."""
    t0, t1 = chunk
    ws = sc.stash[:plan.blocks * (t1 - t0)]
    packed_v3, d_out = inputs[0], inputs[-1]
    device = d_out.device
    sched = (plan.rays, plan.samples_per_ray, plan.rays_per_block, t0, t1,
             torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        if name == "run_noipe":
            g_bands, xacts = inputs[1:3]
            rc = lib.rsn_bwd_noipe_stash(
                g_bands.data_ptr(), xacts.data_ptr(), d_out.data_ptr(),
                ff._ptr_array(packed_v3), sc.dg.data_ptr(),
                sc.small.data_ptr(), ws.data_ptr(), *sched)
        else:
            mean_cov, g_bands = inputs[1:3]
            rc = lib.rsn_bwd_ablate_stash(
                mean_cov.data_ptr(), g_bands.data_ptr(),
                ff._ipe_consts(device).data_ptr(), d_out.data_ptr(),
                ff._ptr_array(packed_v3), sc.dmc.data_ptr(),
                sc.dg.data_ptr(), sc.small.data_ptr(), sc.slots.data_ptr(),
                sc.dxe.data_ptr(), ws.data_ptr(), *sched)
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1
    return ws


def stash_grads(small: torch.Tensor, partial: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """The 22 gradients of a K18 full + wgrad or K19 call: the compact
    slices summed over the blocks (torch.sum over dim 0) and the weight
    matrices from the partials."""
    tot = small.sum(dim=0)
    biases = [tot[SMALL_B + i * TRUNK_WIDTH:SMALL_B + (i + 1) * TRUNK_WIDTH]
              .view(1, TRUNK_WIDTH) for i in range(TRUNK_LAYERS)]
    w_out = torch.zeros((128, 128), dtype=F32, device=small.device)
    w_out[:, :3] = tot[SMALL_WOUT:SMALL_BOUT].view(128, 3)
    b_out = torch.zeros((1, 128), dtype=F32, device=small.device)
    b_out[0, :3] = tot[SMALL_BOUT:SMALL_BOUT + 3]
    dpk = ([None] * 8 + biases
           + [None, tot[SMALL_BH:SMALL_BMID].view(1, ff.OUT_DIM), None,
              tot[SMALL_BMID:SMALL_WOUT].view(1, 128), w_out, b_out])
    return _with_weights(dpk, wg.unfolded_weight_grads(partial))


def stash_backward(name: str, inputs, samples_per_ray: int):
    """K18 full + wgrad or K19 (`name` and the checked CUDA inputs as for
    kernel_a) on the card -> (dmc or None, dg, the 22 gradients).

    stash_plan's schedule: K4's partition, each block's run of 64-row
    tiles cut into chunks of 4 tiles of every block, the most whose records
    (624,640 bytes each) fit in what the first design's per-block fp32
    slice took (674,432 floats).  Per chunk, kernel A (the body: dmc, dg,
    the biases and the mid head's gradients as in the first design; each
    tile's weight-gradient operands to the chunk's workspace) and kernel B
    (their wgmma contraction into P fp32 partials); each counts one launch
    per chunk, kernel A under `name`, kernel B under
    wg.UNFOLDED.label.  The two share the schedule, so K19 equals K18 full
    + wgrad on K3's spill (dg, the 22 gradients) bit for bit.  On the
    tools' 131,072 rows (1,024 rays on 132 SMs: 128 blocks of 16 tiles, 4
    chunks, P = 6) K18's scratch is 319,815,680 bytes of workspace +
    33,554,432 of slots + 4,194,304 of dx tiles + 1,509,376 of compact
    slices + 15,040,512 of partials = 374,114,304 (the first design:
    345,309,184 of slices + 33,554,432 of slots)."""
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments_bwd.cu")
    d_out = inputs[-1]
    device = d_out.device
    plan = stash_plan(d_out.shape[0] // samples_per_ray, samples_per_ray,
                      ft._sm_count(device), name != "run_noipe")
    sc = stash_scratch(plan, device)
    partial = torch.empty((plan.slices, wg.U_PARTIAL_FLOATS), dtype=F32,
                          device=device)
    for c, chunk in enumerate(plan.chunks):
        wg.contract(kernel_a(lib, name, plan, chunk, inputs, sc), partial,
                    c > 0, wg.UNFOLDED)
    dmc, dg, small = sc.dmc, sc.dg, sc.small
    del sc  # the sums below need none of the scratch
    return dmc, dg, stash_grads(small, partial)


def first_design(lib, name: str, inputs, samples_per_ray: int):
    """The first design of K18 in any mode (`name` its label, inputs
    (packed_v3, mean_cov, g_bands, d_out)) or of K19 ("run_noipe", inputs
    as for kernel_a), one launch from `lib`, the RSN_K18_FIRST_DESIGN build
    of experiments_bwd.cu: 64-row tiles, K18 recomputing each tile's IPE
    and trunk into its block's slot; with the weight gradients every tile
    adds its products into its block's fp32 slice of the 22 -> (dmc or
    None, dg, the 22 gradients or None).  Counts no launch."""
    d_out = inputs[-1]
    device, n = d_out.device, d_out.shape[0]
    R, S = n // samples_per_ray, int(samples_per_ray)
    rpb = ft._rays_per_block(R, device)
    blocks = -(-R // rpb)
    dg = torch.zeros((R, 512), dtype=F32, device=device)
    wgrad = name in ("run_noipe", label("full", True))
    buf = torch.zeros((blocks, PACK_FLOATS), dtype=F32, device=device) \
        if wgrad else None
    stream = torch.cuda.current_stream(device).cuda_stream
    dmc = None
    with torch.cuda.device(device):
        if name == "run_noipe":
            g_bands, xacts = inputs[1:3]
            rc = lib.rsn_bwd_noipe(
                g_bands.data_ptr(), xacts.data_ptr(), d_out.data_ptr(),
                ff._ptr_array(inputs[0]), dg.data_ptr(), buf.data_ptr(), R,
                S, rpb, stream)
        else:
            mean_cov, g_bands = inputs[1:3]
            dmc = torch.empty((n, ff.IN_COLS), dtype=F32, device=device)
            ws = torch.empty((blocks, ft.TILE_ROWS, ft.ACTS_COLS),
                             dtype=BF16, device=device)
            code = {label(*v): c for v, c in MODE_CODES.items()}[name]
            rc = lib.rsn_bwd_ablate(
                mean_cov.data_ptr(), g_bands.data_ptr(),
                ff._ipe_consts(device).data_ptr(), d_out.data_ptr(),
                ff._ptr_array(inputs[0]), dmc.data_ptr(), dg.data_ptr(),
                buf.data_ptr() if wgrad else None, ws.data_ptr(), R, S, rpb,
                code, stream)
    ff._raise_on_error(lib, rc, f"{name} (first design)")
    return dmc, dg, unpack_slices(buf) if wgrad else None


def first_design_scratch_bytes(rays: int, device) -> int:
    """The first design's scratch in a mode without weight gradients: its
    blocks' 64 x 2048 bf16 recompute slots."""
    blocks = -(-rays // ft._rays_per_block(rays, device))
    return blocks * ft.TILE_ROWS * ft.ACTS_COLS * 2


def unpack_slices(buf: torch.Tensor):
    """(blocks, 674432) per-block gradients -> the 22 gradients summed over
    the blocks, as views in pack_params_v3's shapes."""
    return ft._packed_views(buf.sum(dim=0), ff.V3U_SHAPES)


def check_backward_inputs(name: str, packed_v3, g_bands: torch.Tensor,
                          d_out: torch.Tensor, samples_per_ray: int) -> int:
    """K18's and K19's shared checks -> R; raises ValueError on rows that
    are not a positive multiple of S, a wrong operand count or shape, or a
    device that is neither the CPU nor CUDA."""
    device, n = d_out.device, d_out.shape[0]
    R = ft._rows(n, int(samples_per_ray), name)
    ff._check("g_bands", g_bands, (R, 512), F32, device)
    ff._check("d_out", d_out, (n, D_OUT_COLS), BF16, device)
    ff._check_packed(packed_v3, ff.V3U_SHAPES, ff.V3U_DTYPES, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return R


def recompute_kernel(lib, packed_v3, mean_cov: torch.Tensor,
                     g_bands: torch.Tensor, samples_per_ray: int,
                     dmc: torch.Tensor) -> None:
    """The recompute mode's one launch from `lib`: the unfolded ring
    forward in step, K1's polynomial IPE, its tail writing the (N, 16) f32
    dmc rows into `dmc` (checked CUDA tensors).  Counts its launch."""
    device, n = mean_cov.device, mean_cov.shape[0]
    with torch.cuda.device(device):
        rc = lib.rsn_bwd_ablate_recompute(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), ring_blob(packed_v3).data_ptr(),
            ff._ptr_array(packed_v3), dmc.data_ptr(), n,
            int(samples_per_ray), torch.cuda.current_stream().cuda_stream)
    name = label("recompute", False)
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1


def spill_kernel(lib, packed_v3, mean_cov: torch.Tensor,
                 xacts: torch.Tensor) -> None:
    """Kernel F from `lib`: the IPE and the trunk of mean_cov's rows on the
    ring (the unfolded blob's first 32 chunks), x and the 8 activations to
    xacts (N, 2176) bf16 in K3's spill_x layout.  Counts its launch under
    SPILL_LABEL."""
    device = mean_cov.device
    with torch.cuda.device(device):
        rc = lib.rsn_bwd_ablate_spill(
            mean_cov.data_ptr(), ff._ipe_consts(device).data_ptr(),
            ring_blob(packed_v3).data_ptr(), ff._ptr_array(packed_v3),
            xacts.data_ptr(), mean_cov.shape[0],
            torch.cuda.current_stream().cuda_stream)
    ff._raise_on_error(lib, rc, SPILL_LABEL)
    ff.LAUNCHES[SPILL_LABEL] += 1


def body_kernel(lib, mode: str, packed_v3, mean_cov: torch.Tensor,
                g_bands: torch.Tensor, xacts: torch.Tensor,
                d_out: torch.Tensor, samples_per_ray: int,
                dmc: torch.Tensor, dg: torch.Tensor) -> None:
    """The body of full or no_ipe_bwd from `lib` on kernel F's spill xacts
    of the rows of mean_cov (K4's partition of their rays, one block an
    SM), into dmc (N, 16) and the zeroed dg (R, 512).  Counts its launch
    under the mode's label."""
    device, S = d_out.device, int(samples_per_ray)
    R = d_out.shape[0] // S
    with torch.cuda.device(device):
        rc = lib.rsn_bwd_ablate_body(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), xacts.data_ptr(),
            d_out.data_ptr(), ff._ptr_array(packed_v3), dmc.data_ptr(),
            dg.data_ptr(), R, S, ft._rays_per_block(R, device),
            MODE_CODES[mode, False], torch.cuda.current_stream().cuda_stream)
    name = label(mode, False)
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1


def spill_scratch_bytes(rows: int) -> int:
    """ring_backward's scratch for full or no_ipe_bwd: the rows' (rows,
    2176) bf16 spill."""
    return rows * ft.XACTS_COLS * 2


def ring_backward(mode: str, packed_v3, mean_cov: torch.Tensor,
                  g_bands: torch.Tensor, d_out: torch.Tensor,
                  samples_per_ray: int):
    """K18 in a mode without weight gradients on the card (checked CUDA
    inputs) -> (dmc, dg, None).  recompute: recompute_kernel, one launch.
    full, no_ipe_bwd: kernel F, then the body on its spill, each one
    launch over the whole call.  Their scratch is the spill, 4,352 bytes
    a row: 570,425,344 bytes on the tools' 131,072 rows (the first
    design's: 33,554,432 bytes of recompute slots).  The whole call was
    faster than runs of 256 rays (stash_plan's chunks; 142,606,336 bytes
    of spill) back to back in turns on an H100 (main(); PERF.md): neither
    spill stays in the 50 MB L2."""
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments_bwd.cu")
    device, n, S = d_out.device, d_out.shape[0], int(samples_per_ray)
    dmc = torch.empty((n, ff.IN_COLS), dtype=F32, device=device)
    dg = torch.zeros((n // S, 512), dtype=F32, device=device)
    if mode == "recompute":
        recompute_kernel(lib, packed_v3, mean_cov, g_bands, S, dmc)
        return dmc, dg, None
    xacts = torch.empty((n, ft.XACTS_COLS), dtype=BF16, device=device)
    spill_kernel(lib, packed_v3, mean_cov, xacts)
    body_kernel(lib, mode, packed_v3, mean_cov, g_bands, xacts, d_out, S,
                dmc, dg)
    return dmc, dg, None


def run(mode: str, use_wgrad: bool, packed_v3, mean_cov: torch.Tensor,
        g_bands: torch.Tensor, d_out: torch.Tensor, samples_per_ray: int):
    """K18 in one mode: -> (dmc (N, 16) f32, dg (R, 512) f32, the 22
    weight gradients or None).  On the card, full + wgrad runs as
    stash_backward, the other modes as ring_backward; on the CPU,
    bwd_ablate_plain."""
    name = label(mode, use_wgrad)
    S = int(samples_per_ray)
    check_backward_inputs(name, packed_v3, g_bands, d_out, S)
    device, n = d_out.device, d_out.shape[0]
    ff._check("mean_cov", mean_cov, (n, ff.IN_COLS), F32, device)
    if device.type == "cpu":
        return bwd_ablate_plain(packed_v3, mean_cov, g_bands, d_out, S, mode,
                                use_wgrad)
    if use_wgrad:
        return stash_backward(name, (packed_v3, mean_cov, g_bands, d_out), S)
    return ring_backward(mode, packed_v3, mean_cov, g_bands, d_out, S)


def tool_cotangent(n: int, device, seed: int = 2) -> torch.Tensor:
    """The tools' d_out: (N, 128) standard normal, bf16, from a seeded
    generator on `device`."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(n, D_OUT_COLS, generator=gen,
                       device=device).to(BF16)


def main(argv=None) -> int:
    """The four modes on the tool's rows: ms (median of 10 CUDA-event
    captures) and TFLOP/s of the tool's 3x count.  Then full's and
    no_ipe_bwd's whole call (ring_backward) back to back in turns (whole,
    runs, whole, runs; 5 calls between two events, median of 10) with the
    same work in runs of stash_plan's chunk of rays, each run's kernel F
    and body a call of their own on one reused spill: the chunking that
    ring_backward does not take."""
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.kernels.build import load_library
    from rsn_torch.utils.timing import time_kernel

    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p3 = ff.pack_params_v3(field)
    d_out = tool_cotangent(n, mc.device)
    print(torch.cuda.get_device_name(0), flush=True)
    for mode, wg in VARIANTS:
        ms = time_kernel(run, mode, wg, p3, mc, g, d_out, S)
        tag = mode + ("+wgrad" if wg else "")
        print(f"{tag:20}: {ms:8.4f} ms ({3 * n * TOOL_FLOPS_PER_ROW / ms / 1e9:6.1f}"
              f" TFLOP/s of 3x)", flush=True)
    lib = load_library("experiments_bwd.cu")
    R = n // S
    sms = torch.cuda.get_device_properties(mc.device).multi_processor_count
    per = -(-R // len(stash_plan(R, S, sms).chunks))

    def in_runs(mode):
        dmc = torch.empty((n, ff.IN_COLS), dtype=F32, device=mc.device)
        dg = torch.zeros((R, 512), dtype=F32, device=mc.device)
        xacts = torch.empty((per * S, ft.XACTS_COLS), dtype=BF16,
                            device=mc.device)
        for r0 in range(0, R, per):
            r1 = min(R, r0 + per)
            rows, spill = slice(r0 * S, r1 * S), xacts[:(r1 - r0) * S]
            spill_kernel(lib, p3, mc[rows], spill)
            body_kernel(lib, mode, p3, mc[rows], g[r0:r1], spill,
                        d_out[rows], S, dmc[rows], dg[r0:r1])
        return dmc, dg

    def five(fn):
        for _ in range(5):
            fn()

    for mode in ("full", "no_ipe_bwd"):
        whole = lambda: ring_backward(mode, p3, mc, g, d_out, S)
        runs = lambda: in_runs(mode)
        a, b = whole(), runs()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise RuntimeError(f"{mode} in runs of {per} rays differs from "
                               "the whole call")
        del a, b
        t = [time_kernel(five, f) / 5 for f in (whole, runs, whole, runs)]
        print(f"{mode}: whole call ({spill_scratch_bytes(n)} bytes of "
              f"spill) {t[0]:.4f} / {t[2]:.4f} ms back to back in turns "
              f"with {-(-R // per)} runs of {per} rays "
              f"({spill_scratch_bytes(per * S)} bytes; == bit for bit) "
              f"{t[1]:.4f} / {t[3]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
