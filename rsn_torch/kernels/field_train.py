"""The training path's field kernels, their plain PyTorch versions and the
autograd Function around them (port of rsn/kernels/field_train.py and of
field_forward_v6 in rsn/kernels/field_pallas.py).

K3 `field_forward_v6` (replaces field_pallas.py::field_forward_v6): K1's
forward at the train width, (N, 24) bf16 — the V3_* columns, d
density_preact / d mean in V4_DPDM (14:17) when want_normals, the mid
value in V3_MIDVAL (17:20) — plus the spill of the 8 post-ReLU trunk
activations, (N, 2048) bf16, with the IPE x appended ((N, 2176)) under
spill_x.

K4 `field_backward_v5` (replaces field_train.py::field_backward_v5): the
backward from the spill and the forward's stored output -> dmc (N, 16),
dg (R, 512) and the 20 fp32 gradients of the packed operands.  On the
card a call is a few chunks of two kernels: the body, which stashes each
tile's weight-gradient operands into a workspace (kernel A), and their
contraction by wgmma (kernel B, rsn_torch/kernels/wgrad_sm90.py).

K5 `field_backward_v6` (replaces field_train.py::field_backward_v6): K4
without dmc (the caller's promise that the mean/cov cotangent is dead),
x read from the spill; the same two kernels on the same schedule.

K7 `field_forward_v4` (replaces field_pallas.py::field_forward_v4): K3
with the normals and without the spill, (N, 24) bf16.  Its sibling
`field_forward_v3_train` is K1 at the train width (field_pallas.py::
field_forward_v3 at its default V3_OUT store): K3 without the normals and
without the spill.  The same kernel body as K3, so both equal K3's output
bit for bit.  The three read their weights from a blob in the Hopper
ring's chunk layout (train_blob: one pack launch, shared by a train
step's calls).

K8 `field_backward_v4` (replaces field_train.py::field_backward_v4): K4
with the trunk activations recomputed in the kernel instead of read from
a spill -> dmc, dg and the 20 gradients; K4's two kernels and schedule
(stash_backward), so it equals K4 on K3's spill bit for bit.

K10 `field_forward_v5` (replaces field_pallas.py::field_forward_v5): K7
(want_normals) or K1 at the train width on another schedule, the next
tile's IPE computed while this tile's trunk runs; the same (N, 24) bf16
output bit for bit.

K13 `field_backward_v3` (replaces field_train.py::field_backward_v3): K8
with whole-grid weight-gradient accumulators: the launches themselves
return the 20 gradients (no sum outside them).  On the card K8's kernels A
and B per chunk, then one sum launch (k13_sum; plain: k13_sum_plain).

K6 `FusedFieldTrain` (replaces field_train.py::fused_field_train, a
custom VJP with no kernel of its own): the autograd Function that runs,
on fp32 packed operands, K3 forward and K4 or K5 backward (save_acts, the
spill route), or K7 / K1 at the train width forward and K8 backward (the
recompute route).

Each wrapper checks its inputs, runs the plain version for CPU tensors
and launches the CUDA kernel (rsn_torch/csrc/field_train.cu) for CUDA
tensors; it never falls back from one to the other.  The launches count
in field_forward.LAUNCHES.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.kernels.field_forward import (BF16, F32, ENC_PAD, FH_COLS,
                                             IN_COLS, IPE_SCALE, IPE_VAR,
                                             LAUNCHES, _BAND_KS, _V3_DTYPES,
                                             _check, _check_packed,
                                             _ipe_consts, _ptr_array,
                                             _raise_on_error, _sin2pi)
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH

# K3 train-width output columns (field_pallas.V4_DPDM / V3_MIDVAL)
OUT_TRAIN = 24
V4_DPDM = slice(14, 17)
V3_MIDVAL = slice(17, 20)
ACTS_COLS = TRUNK_LAYERS * TRUNK_WIDTH  # 2048
XACTS_COLS = ACTS_COLS + ENC_PAD        # 2176
TILE_ROWS = 64  # sample rows per block tile (field_common.cuh TM)
N_PACKED = 20
# one block's fp32 slice of the backward's weight gradients: the packed
# operands in order (field_train.cu PACK_FLOATS)
PACKED_SHAPES = tuple(ff.V3_SHAPES)
PACK_FLOATS = sum(r * c for r, c in PACKED_SHAPES)
# kernel A's per-block fp32 slice (field_train.cu GradSlice<true>): b0..b7,
# b_hc, w_out's 3 live columns (128 x 3), b_out (3, padded to 4)
SMALL_B, SMALL_BHC = 0, TRUNK_LAYERS * TRUNK_WIDTH
SMALL_WOUT = SMALL_BHC + TRUNK_WIDTH
SMALL_BOUT = SMALL_WOUT + 128 * 3
SMALL_FLOATS = SMALL_BOUT + 4  # 2692
# a chunk of kernel A: the most tiles of every block whose workspace records
# fit in what the first design's per-block fp32 slice took (2,434,560 bytes)
TILES_PER_CHUNK = wg.FOLDED.tiles_per_chunk  # 4


def density_row(field) -> torch.Tensor:
    """The density head's weights as K3's (1, 256) fp32 operand: the seed
    of the normals dgrad (no gradient flows through it)."""
    return field.field_output_density.net.weight.detach().float().reshape(
        1, TRUNK_WIDTH).contiguous()


def pack_params_v4f(packed_v3f: Sequence[torch.Tensor], field
                    ) -> Tuple[torch.Tensor, ...]:
    """K3's operands with the normals (field_pallas.pack_params_v4f): the
    v3f operands + density_row(field)."""
    return tuple(packed_v3f) + (density_row(field),)


# ---- plain versions --------------------------------------------------------

def _cos2pi(u: torch.Tensor) -> torch.Tensor:
    """cos(2 pi u) for wrapped u in [-1/2, 1/2] (field_pallas._cos2pi)."""
    w = u * u
    p = torch.full_like(w, 6.52864918)
    for c in (-25.9675931, 60.1676294, -85.4501393, 64.9391175,
              -19.7392045, 0.999999989):
        p = p * w + c
    return p


def _trunk_acts(ws, bs, x: torch.Tensor):
    """The 8 post-ReLU bf16 trunk activations (field_forward's trunk)."""
    hs, h = [], x
    for i in range(TRUNK_LAYERS):
        if i == SKIP_AT:
            h = torch.cat([x, h], dim=1)
        h = torch.relu(h.float() @ ws[i].float() + bs[i]).to(BF16)
        hs.append(h)
    return hs


def _dmean_dvar(dx: torch.Tensor, mean_cov: torch.Tensor, want_var: bool):
    """The IPE backward: dx (N, 128) f32 -> (N, 3) d mean [, (N, 3) d cov
    diagonal] (rsn _bwd_half: dpre_enc @ A^T and dvar @ V^T, written out
    per frequency)."""
    n = dx.shape[0]
    damp, u = ff.ipe_phase(mean_cov)
    scale = torch.as_tensor(IPE_SCALE, device=dx.device)
    d96 = dx[:, :96]
    dpre = (d96 * (damp * _cos2pi(u))).reshape(n, 2, 3, 16)
    dmean = (dpre * scale).sum(dim=(1, 3)) + dx[:, 96:99]
    if not want_var:
        return dmean, None
    var_k = torch.as_tensor(IPE_VAR, device=dx.device)
    dvar = (d96 * -0.5 * damp * _sin2pi(u)).reshape(n, 2, 3, 16)
    return dmean, (dvar * var_k).sum(dim=(1, 3))


def normals_dgrad_plain(packed, hs, mean_cov: torch.Tensor) -> torch.Tensor:
    """K3's normals dgrad on given post-ReLU activations hs (8 x (N, 256)
    bf16): dh = wd_row (packed[20]), dpre = bf16(dh * relu mask),
    dinp = dpre @ W^T through the 8 layers, then the IPE backward
    -> (N, 3) d density_preact / d mean."""
    return _normals_dgrad(packed[:8], packed[20], hs, mean_cov)


def normals_blob_plain(blob: torch.Tensor, wd_row: torch.Tensor, hs,
                       mean_cov: torch.Tensor) -> torch.Tensor:
    """normals_dgrad_plain with the weights read from a train blob's dgrad
    chunks in the kernels' order (trunk_sm90.dgrad_weights)."""
    return _normals_dgrad(ts.dgrad_weights(blob), wd_row, hs, mean_cov)


def _normals_dgrad(ws, wd_row, hs, mean_cov):
    dh = wd_row.expand(mean_cov.shape[0], TRUNK_WIDTH)
    dx_extra = None
    for i in range(TRUNK_LAYERS - 1, -1, -1):
        dpre = (dh * (hs[i].float() > 0)).to(BF16)
        dinp = dpre.float() @ ws[i].float().t()
        if i == SKIP_AT:
            dx_extra, dh = dinp[:, :ENC_PAD], dinp[:, ENC_PAD:]
        else:
            dh = dinp
    return _dmean_dvar(dh + dx_extra, mean_cov, want_var=False)[0]


def field_forward_v6_plain(packed, mean_cov: torch.Tensor,
                           g_bands: torch.Tensor, samples_per_ray: int,
                           want_normals: bool = False, spill_x: bool = False):
    """Plain PyTorch K3 on the same packed operands -> (out (N, 24) bf16,
    acts (N, 2048 | 2176) bf16)."""
    ws, bs = packed[:8], packed[8:16]
    w_hc, b_hc, w_out, b_out = packed[16:20]
    n, S = mean_cov.shape[0], samples_per_ray
    R = n // S
    x = ff.ipe_x(mean_cov)
    hs = _trunk_acts(ws, bs, x)
    h = hs[-1]
    hc = h.float() @ w_hc.float() + b_hc
    density = ff._density_head(h, w_hc[:, 0:ff.DENS_COLS].contiguous(),
                               b_hc[:, 0:ff.DENS_COLS])[:, 0:1]
    diff = torch.sigmoid(hc[:, ff.FH_DIFF])
    tint = torch.sigmoid(hc[:, ff.FH_TINT])
    rough_raw = hc[:, ff.FH_ROUGH:ff.FH_ROUGH + 1]
    normals_raw = hc[:, ff.FH_NORMALS]
    rough_sp = torch.logaddexp(rough_raw, torch.zeros_like(rough_raw))
    mid_pre = hc[:, 128:256].reshape(R, S, 128)
    for bi, k in enumerate(_BAND_KS):
        band = g_bands[:, None, bi * 128:(bi + 1) * 128]
        mid_pre = mid_pre + torch.exp(-rough_sp * k).reshape(R, S, 1) * band
    hmid = torch.relu(mid_pre).reshape(n, 128).to(BF16)
    mid = torch.sigmoid(hmid.float() @ w_out.float() + b_out)[:, 0:3]
    mid_out = diff + tint * mid
    dpdm = torch.zeros(n, 3, device=mean_cov.device)
    if want_normals:
        dpdm = normals_dgrad_plain(packed, hs, mean_cov)
    zeros = torch.zeros(n, OUT_TRAIN - 20, device=mean_cov.device)
    out = torch.cat([mid_out, diff, tint, normals_raw, density, rough_raw,
                     dpdm, mid, zeros], dim=1).to(BF16)
    acts = torch.cat(hs + [x] if spill_x else hs, dim=1)
    return out, acts


def field_forward_v4_plain(packed, mean_cov: torch.Tensor,
                           g_bands: torch.Tensor, samples_per_ray: int,
                           want_normals: bool = True) -> torch.Tensor:
    """Plain PyTorch K7 (want_normals) or K1 at the train width: the
    plain K3's output -> (N, 24) bf16.  Also K10's plain version: rsn
    asserts that field_forward_v5 computes the same function as v3 and v4
    (tests/test_field_train_kernel.py), so one plain version serves all
    three."""
    return field_forward_v6_plain(packed, mean_cov, g_bands, samples_per_ray,
                                  want_normals)[0]


def _backward_plain(packed, g_bands, hs, x, d_out, f_out, S, mean_cov,
                    ops=None):
    """rsn's _bwd_half written out: -> (dmc or None, dg, dpacked).
    mean_cov None: no IPE backward and no layer-0 dgrad (K5).  ops: a dict
    that receives the weight gradients' bf16 operands ("dhc": d_hc (N,
    256), "dpre": dpre_0..dpre_7 (N, 256))."""
    ws, bs = packed[:8], packed[8:16]
    w_hc, b_hc, w_out, b_out = packed[16:20]
    n = d_out.shape[0]
    R = n // S
    dev = d_out.device
    dpk = [None] * N_PACKED

    fout = f_out.float()
    diff, tint = fout[:, 3:6], fout[:, 6:9]
    rough_raw, mid = fout[:, 13:14], fout[:, V3_MIDVAL]
    rough_sp = torch.logaddexp(rough_raw, torch.zeros_like(rough_raw))
    g_rep = g_bands.float().repeat_interleave(S, dim=0)
    h = hs[-1]
    mid_pre = h.float() @ w_hc[:, 128:256].float() + b_hc[:, 128:256]
    attens = []
    for bi, k in enumerate(_BAND_KS):
        a = torch.exp(-rough_sp * k)
        attens.append(a)
        mid_pre = mid_pre + a * g_rep[:, bi * 128:(bi + 1) * 128]
    hmid = torch.relu(mid_pre).to(BF16)

    dout = d_out.float()
    dmid_out = dout[:, 0:3]
    ddiff = dmid_out + dout[:, 3:6]
    dtint = dmid_out * mid + dout[:, 6:9]
    dmid = dmid_out * tint
    dz3 = dmid * mid * (1.0 - mid)
    dz_b = dz3.to(BF16).float()
    dpk[18] = torch.zeros(128, 128, device=dev)
    dpk[18][:, 0:3] = hmid.float().t() @ dz_b
    dpk[19] = torch.zeros(1, 128, device=dev)
    dpk[19][0, 0:3] = dz3.sum(dim=0)
    dhmid = dz_b @ w_out[:, 0:3].float().t()
    dmid_pre = dhmid * (mid_pre > 0)
    # the roughness -> attenuation edge carries no gradient
    dg_all = torch.cat([a * dmid_pre for a in attens], dim=1)
    dg = dg_all.reshape(R, S, 512).sum(dim=1)

    d_heads = torch.cat([dout[:, 12:13], ddiff * diff * (1.0 - diff),
                         dtint * tint * (1.0 - tint), dout[:, 13:14],
                         dout[:, 9:12],
                         torch.zeros(n, 128 - FH_COLS, device=dev)], dim=1)
    d_hc = torch.cat([d_heads, dmid_pre], dim=1)
    d_hc_b = d_hc.to(BF16).float()
    if ops is not None:
        ops["dhc"], ops["dpre"] = d_hc.to(BF16), [None] * TRUNK_LAYERS
    dpk[16] = h.float().t() @ d_hc_b
    dpk[17] = d_hc.sum(dim=0, keepdim=True)
    dh = d_hc_b @ w_hc.float().t()
    dx_extra = None
    for i in range(TRUNK_LAYERS - 1, -1, -1):
        inp = hs[i - 1] if i > 0 else x
        if i == SKIP_AT:
            inp = torch.cat([x, hs[i - 1]], dim=1)
        dpre_f = dh * (hs[i].float() > 0)
        dpre = dpre_f.to(BF16).float()
        if ops is not None:
            ops["dpre"][i] = dpre_f.to(BF16)
        dpk[i] = inp.float().t() @ dpre
        dpk[8 + i] = dpre_f.sum(dim=0, keepdim=True)
        if i == 0 and mean_cov is None:
            break  # layer 0's dgrad only feeds the (dead) IPE backward
        dinp = dpre @ ws[i].float().t()
        if i == SKIP_AT:
            dx_extra, dh = dinp[:, :ENC_PAD], dinp[:, ENC_PAD:]
        else:
            dh = dinp
    if mean_cov is None:
        return None, dg, tuple(dpk)
    dmean, dvar = _dmean_dvar(dh + dx_extra, mean_cov, want_var=True)
    dmc = torch.cat([dmean, dvar, torch.zeros(n, IN_COLS - 6, device=dev)],
                    dim=1)
    return dmc, dg, tuple(dpk)


def _split_acts(acts: torch.Tensor):
    return [acts[:, i * TRUNK_WIDTH:(i + 1) * TRUNK_WIDTH]
            for i in range(TRUNK_LAYERS)]


def field_backward_v5_plain(packed, mean_cov, g_bands, acts, d_out, f_out,
                            samples_per_ray):
    """Plain PyTorch K4 -> (dmc (N, 16), dg (R, 512), dpacked (20))."""
    return _backward_plain(packed[:N_PACKED], g_bands, _split_acts(acts),
                           ff.ipe_x(mean_cov), d_out, f_out,
                           samples_per_ray, mean_cov)


def field_backward_v6_plain(packed, g_bands, xacts, d_out, f_out,
                            samples_per_ray):
    """Plain PyTorch K5 -> (dg (R, 512), dpacked (20))."""
    _, dg, dpk = _backward_plain(packed[:N_PACKED], g_bands,
                                 _split_acts(xacts), xacts[:, ACTS_COLS:],
                                 d_out, f_out, samples_per_ray, None)
    return dg, dpk


def field_backward_v4_plain(packed, mean_cov, g_bands, d_out, f_out,
                            samples_per_ray):
    """Plain PyTorch K8: the plain K4 on the trunk activations recomputed
    from mean_cov -> (dmc (N, 16), dg (R, 512), dpacked (20)).  Also K13's
    plain version: rsn's field_backward_v3 and v4 compute the same function
    and differ only in where the weight gradients are summed."""
    x = ff.ipe_x(mean_cov)
    return _backward_plain(packed[:N_PACKED], g_bands,
                           _trunk_acts(packed[:8], packed[8:16], x), x,
                           d_out, f_out, samples_per_ray, mean_cov)


# ---- the stash schedule on the card, and the two phases in plain PyTorch ---

@dataclasses.dataclass(frozen=True)
class StashPlan:
    """K4, K5 and K8 on the card: K4's partition (rays_per_block whole rays
    per block, one block per SM), each block's run walked in 64-row tiles,
    the tiles cut into chunks [t0, t1) of every block's run; per chunk
    kernel A stashes blocks x (t1 - t0) records and kernel B contracts them
    over `slices` slices.  recompute: K8's route, whose kernel A recomputes
    each tile's trunk into a slot per block (K4 and K5 read K3's spill)."""
    rays: int
    samples_per_ray: int
    rays_per_block: int
    blocks: int
    tiles: int  # a full block's tiles
    chunks: Tuple[Tuple[int, int], ...]
    slices: int
    recompute: bool = True
    # the records' layout: K8's (K4's, K5's), or the tools' K18 / K19's
    layout: wg.Layout = wg.FOLDED

    def records(self, chunk) -> List[Tuple[int, int, int, int]]:
        """The chunk's records in workspace order: (block, tile, first row,
        rows; 0 past the end of the block's run)."""
        t0, t1 = chunk
        S, rpb = self.samples_per_ray, self.rays_per_block
        out = []
        for b in range(self.blocks):
            row_a, row_b = b * rpb * S, min(self.rays, (b + 1) * rpb) * S
            for t in range(t0, t1):
                row0 = row_a + t * TILE_ROWS
                out.append((b, t, row0, max(0, min(TILE_ROWS, row_b - row0))))
        return out

    def scratch_bytes(self) -> int:
        """A call's scratch on the card: the largest chunk's workspace, the
        recompute slots (K8, K18 only), the compact slices and the
        partials."""
        t0, t1 = self.chunks[0]
        slots = self.blocks * TILE_ROWS * ACTS_COLS * 2 if self.recompute \
            else 0
        return (self.blocks * (t1 - t0) * self.layout.rec_bytes + slots
                + self.blocks * self.layout.small_floats * 4
                + self.slices * self.layout.partial_floats * 4)


def stash_plan(rays: int, samples_per_ray: int, sms: int,
               recompute: bool = True,
               layout: wg.Layout = wg.FOLDED) -> StashPlan:
    """The schedule of K8 (recompute) or of K4 and K5 on a card of `sms`
    SMs (K4's rays per block at one block per SM; chunks of the layout's
    tiles_per_chunk tiles, TILES_PER_CHUNK for K8's); with the UNFOLDED
    layout, K18's (recompute) or K19's."""
    S = int(samples_per_ray)
    rpb = _per_block(rays, sms)
    tiles = -(-(rpb * S) // TILE_ROWS)
    per = layout.tiles_per_chunk
    chunks = tuple((t0, min(tiles, t0 + per)) for t0 in range(0, tiles, per))
    blocks = -(-rays // rpb)
    return StashPlan(rays, S, rpb, blocks, tiles, chunks,
                     wg.slices_for(sms, blocks * (chunks[0][1] - chunks[0][0]),
                                   layout),
                     bool(recompute), layout)


def tile_rows(a: torch.Tensor, row0: int, nv: int) -> torch.Tensor:
    """Rows [row0, row0 + nv) of a (N, F) operand as a (64, F) bf16 tile,
    rows nv.. zero (a record's tile)."""
    out = torch.zeros((TILE_ROWS, a.shape[1]), dtype=BF16, device=a.device)
    out[:nv] = a[row0:row0 + nv]
    return out


def stash_chunk_plain(plan: StashPlan, chunk, x, hs, ops) -> torch.Tensor:
    """Plain kernel A's stash: the chunk's records from the rows' operands
    (x, hs, and _backward_plain's ops), rows past a run's end zero
    -> (records, wg.REC_ELEMS) bf16."""
    dhc = ts.head_columns(ops["dhc"])  # the record's 144 columns of d_hc
    return torch.stack([
        wg.pack_record(tile_rows(x, row0, nv),
                       [tile_rows(h, row0, nv) for h in hs],
                       [tile_rows(d, row0, nv) for d in ops["dpre"]],
                       tile_rows(dhc, row0, nv))
        for _, _, row0, nv in plan.records(chunk)])


def _with_weights(dpk, w) -> Tuple[torch.Tensor, ...]:
    """The 20 gradients with w0..w7 and w_hc taken from w (9 tensors)."""
    return tuple(w[:8]) + tuple(dpk[8:16]) + (w[8],) + tuple(dpk[17:20])


def _plain_partials(plan: StashPlan, stash, x, hs, ops) -> torch.Tensor:
    """Plain kernel B over the records `stash(plan, chunk, x, hs, ops)` of
    each chunk of `plan` -> its (P, wg.PARTIAL_FLOATS) partials."""
    partial = torch.empty((plan.slices, wg.PARTIAL_FLOATS), dtype=F32)
    for c, chunk in enumerate(plan.chunks):
        wg.contract_plain(stash(plan, chunk, x, hs, ops), partial,
                          accumulate=c > 0)
    return partial


def _two_phases_plain(packed, g_bands, hs, x, d_out, f_out, S: int, mean_cov,
                      sms: int, recompute: bool, stash=stash_chunk_plain):
    """The plain backward's per-row values (dmc, dg, the biases and the
    mid head's gradients), its weight-gradient operands stashed per chunk
    of the card's schedule in kernel A's record layout (by `stash`: K8's
    64-row walk, or K17's 128-row one), and plain kernel B's contraction
    of each chunk (its slices, the P partials summed as the wrappers sum
    them) -> (dmc or None, dg, the 20 gradients)."""
    plan = stash_plan(d_out.shape[0] // S, S, sms, recompute)
    ops = {}
    dmc, dg, dpk = _backward_plain(packed[:N_PACKED], g_bands, hs, x, d_out,
                                   f_out, S, mean_cov, ops)
    partial = _plain_partials(plan, stash, x, hs, ops)
    return dmc, dg, _with_weights(dpk, wg.weight_grads(partial))


def field_backward_v4_chunked_plain(packed, mean_cov, g_bands, d_out, f_out,
                                    samples_per_ray, sms: int):
    """Plain K8 in its two phases on a card of `sms` SMs: the trunk
    recomputed from mean_cov, then _two_phases_plain -> (dmc, dg, the 20
    gradients)."""
    x = ff.ipe_x(mean_cov)
    return _two_phases_plain(packed, g_bands,
                             _trunk_acts(packed[:8], packed[8:16], x), x,
                             d_out, f_out, int(samples_per_ray), mean_cov,
                             sms, True)


def whole_chunk_plain(plan: StashPlan, chunk, x, hs, ops) -> torch.Tensor:
    """Plain K17 kernel A's stash: each block's run walked in 128-row tiles
    from the chunk's first tile (t0 even), each tile's two 64-row halves
    emitted as the records of those 64-row tiles; a half with no rows, and
    a record past the run's end, stays zero -> (records, wg.REC_ELEMS)
    bf16, stash_chunk_plain's records."""
    t0, t1 = chunk
    assert t0 % 2 == 0, "a 128-row tile's halves lie in one chunk"
    S, rpb, per = plan.samples_per_ray, plan.rays_per_block, t1 - t0
    dhc = ts.head_columns(ops["dhc"])
    out = torch.zeros((plan.blocks * per, wg.REC_ELEMS), dtype=BF16)
    for b in range(plan.blocks):
        row_a, row_b = b * rpb * S, min(plan.rays, (b + 1) * rpb) * S
        end = min(row_b, row_a + t1 * TILE_ROWS)
        for row0 in range(row_a + t0 * TILE_ROWS, end, 2 * TILE_ROWS):
            nv = min(2 * TILE_ROWS, row_b - row0)
            def whole(a):  # the 128-row tile, rows nv.. zero
                return torch.cat([
                    tile_rows(a, row0, min(nv, TILE_ROWS)),
                    tile_rows(a, row0 + TILE_ROWS, max(0, nv - TILE_ROWS))])
            tx, tdhc = whole(x), whole(dhc)
            ths, tdpre = [whole(h) for h in hs], [whole(d) for d in
                                                   ops["dpre"]]
            for h in range(2):
                if nv <= h * TILE_ROWS:
                    continue
                half = slice(h * TILE_ROWS, (h + 1) * TILE_ROWS)
                t = (row0 + h * TILE_ROWS - row_a) // TILE_ROWS
                out[b * per + t - t0] = wg.pack_record(
                    tx[half], [a[half] for a in ths],
                    [a[half] for a in tdpre], tdhc[half])
    return out


def field_backward_whole_chunked_plain(packed, mean_cov, g_bands, d_out,
                                       f_out, samples_per_ray, sms: int):
    """Plain K17 in its two phases on a card of `sms` SMs: K8's plan, the
    records emitted by whole_chunk_plain, plain kernel B per chunk -> (dmc,
    dg, the 20 gradients); K8's two phases' results."""
    x = ff.ipe_x(mean_cov)
    return _two_phases_plain(packed, g_bands,
                             _trunk_acts(packed[:8], packed[8:16], x), x,
                             d_out, f_out, int(samples_per_ray), mean_cov,
                             sms, True, whole_chunk_plain)


def compact_slices_plain(plan: StashPlan, packed, g_bands, hs, x, d_out,
                         f_out, mean_cov) -> torch.Tensor:
    """Plain kernel A's compact slices: per block of `plan`, the plain
    backward of its rays' biases and mid-head gradients in GradSlice<true>'s
    layout -> (blocks, SMALL_FLOATS) f32."""
    S, rpb = plan.samples_per_ray, plan.rays_per_block
    small = torch.zeros((plan.blocks, SMALL_FLOATS), dtype=F32)
    for b in range(plan.blocks):
        rays = slice(b * rpb, min(plan.rays, (b + 1) * rpb))
        rows = slice(rays.start * S, rays.stop * S)
        _, _, dpk = _backward_plain(
            packed[:N_PACKED], g_bands[rays], [h[rows] for h in hs], x[rows],
            d_out[rows], f_out[rows], S, mean_cov[rows])
        small[b, :SMALL_WOUT] = torch.cat([d.reshape(-1)
                                           for d in dpk[8:16] + dpk[17:18]])
        small[b, SMALL_WOUT:SMALL_BOUT] = dpk[18][:, :3].reshape(-1)
        small[b, SMALL_BOUT:SMALL_BOUT + 3] = dpk[19][0, :3]
    return small


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """(K, M) -> (M,): 0 + t[0] + t[1] + ... in that order, each add an fp32
    add (field_backward_v3_sum_kernel's order)."""
    s = torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    for row in t:
        s = s + row
    return s


def k13_sum_plain(small: torch.Tensor, partial: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Plain K13 sum: the blocks' compact slices (blocks, SMALL_FLOATS)
    summed in block order and kernel B's partials (P, wg.PARTIAL_FLOATS) in
    slice order -> the 20 packed-operand gradients, laid out as
    stash_grads lays them out."""
    return _grads_from_totals(_sum_in_order(small), _sum_in_order(partial))


def field_backward_v3_chunked_plain(packed, mean_cov, g_bands, d_out, f_out,
                                    samples_per_ray, sms: int):
    """Plain K13 on a card of `sms` SMs: K8's records and plain kernel B per
    chunk, the blocks' compact slices, then k13_sum_plain -> (dmc, dg, the
    20 gradients)."""
    x = ff.ipe_x(mean_cov)
    hs = _trunk_acts(packed[:8], packed[8:16], x)
    S = int(samples_per_ray)
    plan = stash_plan(d_out.shape[0] // S, S, sms)
    ops = {}
    dmc, dg, _ = _backward_plain(packed[:N_PACKED], g_bands, hs, x, d_out,
                                 f_out, S, mean_cov, ops)
    partial = _plain_partials(plan, stash_chunk_plain, x, hs, ops)
    small = compact_slices_plain(plan, packed, g_bands, hs, x, d_out, f_out,
                                 mean_cov)
    return dmc, dg, k13_sum_plain(small, partial)


def field_backward_v5_chunked_plain(packed, mean_cov, g_bands, acts, d_out,
                                    f_out, samples_per_ray, sms: int):
    """Plain K4 in its two phases on a card of `sms` SMs, on the spill ->
    (dmc, dg, the 20 gradients), field_backward_v5_plain's per-row values
    with the weight matrices summed as kernel B sums them."""
    return _two_phases_plain(packed, g_bands, _split_acts(acts),
                             ff.ipe_x(mean_cov), d_out, f_out,
                             int(samples_per_ray), mean_cov, sms, False)


def field_backward_v6_chunked_plain(packed, g_bands, xacts, d_out, f_out,
                                    samples_per_ray, sms: int):
    """Plain K5 in its two phases on a card of `sms` SMs, x read from the
    spill -> (dg, the 20 gradients)."""
    _, dg, dpk = _two_phases_plain(packed, g_bands, _split_acts(xacts),
                                   xacts[:, ACTS_COLS:], d_out, f_out,
                                   int(samples_per_ray), None, sms, False)
    return dg, dpk


# ---- wrappers --------------------------------------------------------------

def _rows(n: int, S: int, name: str) -> int:
    if S <= 0 or n == 0 or n % S:
        raise ValueError(f"{name}: {n} rows is not a positive multiple of "
                         f"S={S}")
    return n // S


def _check_train_packed(packed, want_normals: bool, device) -> None:
    shapes = list(PACKED_SHAPES) + ([(1, TRUNK_WIDTH)] if want_normals
                                    else [])
    dtypes = _V3_DTYPES + ([F32] if want_normals else [])
    _check_packed(packed, shapes, dtypes, device)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _per_block(rays: int, blocks: int) -> int:
    """Whole rays per block for at most `blocks` blocks."""
    return max(1, -(-rays // blocks))


def _rays_per_block(rays: int, device) -> int:
    """Whole rays per backward block at one block per SM."""
    return _per_block(rays, _sm_count(device))


def _packed_views(flat: torch.Tensor, shapes=PACKED_SHAPES
                  ) -> Tuple[torch.Tensor, ...]:
    """(PACK_FLOATS,) -> the 20 packed-operand gradients (or, for other
    `shapes`, one per shape), as views."""
    out, off = [], 0
    for r, c in shapes:
        out.append(flat[off:off + r * c].view(r, c))
        off += r * c
    return tuple(out)


def train_blob(ws: Sequence[torch.Tensor], w_hc: torch.Tensor
               ) -> torch.Tensor:
    """The weight ring's blob of K3, K7 and K1 at the train width from
    w0..w7 ((in, 256)) and w_hc ((256, 256)), fp32 (pack_params_v3f_f32's,
    any strides) or bf16 -> (trunk_sm90.TRAIN_BLOB_ELEMS,) bf16: trunk_sm90.
    pack_train_blob's layout, each value cast to bf16 as cast_packed casts
    it.  On the card one launch (rsn_pack_train_blob, counted as
    "train_blob"); a train step packs once and hands the blob to its
    forwards."""
    mats = list(ws) + [w_hc]
    device = w_hc.device
    if device.type == "cpu":
        return ts.pack_train_blob(ws, w_hc)
    if device.type != "cuda":
        raise ValueError(f"train_blob: unsupported device {device}")
    dtype = w_hc.dtype
    for i, t in enumerate(mats):
        rows = ff.V3_SHAPES[16 if i == TRUNK_LAYERS else i][0]
        if tuple(t.shape) != (rows, TRUNK_WIDTH) or t.dtype != dtype \
                or t.device != device or dtype not in (F32, BF16):
            raise ValueError(f"train_blob: operand {i} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    blob = torch.empty(ts.TRAIN_BLOB_ELEMS, dtype=BF16, device=device)
    mats = [t.detach() for t in mats]
    strides = (ctypes.c_longlong * (2 * len(mats)))(
        *(s for t in mats for s in t.stride()))
    with torch.cuda.device(device):
        rc = lib.rsn_pack_train_blob(_ptr_array(mats), strides,
                                     int(dtype == BF16), blob.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "train_blob")
    LAUNCHES["train_blob"] += 1
    return blob


def _train_blob_for(packed, blob) -> torch.Tensor:
    """The forwards' blob: the caller's (checked), or one packed here from
    the bf16 operands."""
    if blob is None:
        return train_blob(packed[:8], packed[16])
    _check("blob", blob, (ts.TRAIN_BLOB_ELEMS,), BF16, packed[0].device)
    return blob


def field_forward_v6(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                     samples_per_ray: int, want_normals: bool = False,
                     spill_x: bool = False, blob: torch.Tensor = None):
    """K3: (N, 16) f32 mean_cov + (R, 512) f32 g_bands, N = R * S;
    packed = pack_params_v3f [+ wd_row with want_normals]; blob: train_blob
    of packed's weights (packed here when None; the CPU needs none)
    -> (out (N, 24) bf16, acts (N, 2048 | 2176) bf16)."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    S = int(samples_per_ray)
    R = _rows(n, S, "field_forward_v6")
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check("g_bands", g_bands, (R, 512), F32, device)
    _check_train_packed(packed, want_normals, device)
    if device.type == "cpu":
        return field_forward_v6_plain(packed, mean_cov, g_bands, S,
                                      want_normals, spill_x)
    if device.type != "cuda":
        raise ValueError(f"field_forward_v6: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    return launch_field_forward_v6(load_library("field_train.cu"), packed,
                                   mean_cov, g_bands, S, want_normals,
                                   spill_x, _train_blob_for(packed, blob))


def launch_field_forward_v6(lib, packed, mean_cov, g_bands, S: int,
                            want_normals: bool, spill_x: bool, blob):
    """K3 from `lib` (field_train.cu as load_library builds it, or a timing
    build of it) on checked CUDA inputs and a train blob -> (out, acts).
    Counts its launch."""
    n, device = mean_cov.shape[0], mean_cov.device
    out = torch.empty((n, OUT_TRAIN), dtype=BF16, device=device)
    acts = torch.empty((n, XACTS_COLS if spill_x else ACTS_COLS),
                       dtype=BF16, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_forward_v6(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            _ipe_consts(device).data_ptr(), blob.data_ptr(),
            _ptr_array(packed), out.data_ptr(), acts.data_ptr(), n, S,
            int(want_normals), int(spill_x),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_forward_v6")
    LAUNCHES["field_forward_v6"] += 1
    return out, acts


def _forward_no_spill(packed, mean_cov, g_bands, samples_per_ray,
                      want_normals: bool, name: str, entry: str,
                      blob=None) -> torch.Tensor:
    """K7, K1 at the train width and K10: the same checks, plain version
    and arguments; `entry` is the C function that launches `name`, which
    (but K10's) reads its weights from a train blob."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    S = int(samples_per_ray)
    R = _rows(n, S, name)
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check("g_bands", g_bands, (R, 512), F32, device)
    _check_train_packed(packed, want_normals, device)
    if device.type == "cpu":
        return field_forward_v4_plain(packed, mean_cov, g_bands, S,
                                      want_normals)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    head = (mean_cov.data_ptr(), g_bands.data_ptr(),
            _ipe_consts(device).data_ptr())
    if name != "field_forward_v5":
        # held until the launch, so that out cannot take its memory
        blob = _train_blob_for(packed, blob)
        head += (blob.data_ptr(),)
    out = torch.empty((n, OUT_TRAIN), dtype=BF16, device=device)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            *head, _ptr_array(packed), out.data_ptr(), n, S,
            int(want_normals), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def field_forward_v4(packed_v4f, mean_cov: torch.Tensor,
                     g_bands: torch.Tensor, samples_per_ray: int,
                     blob: torch.Tensor = None) -> torch.Tensor:
    """K7: packed_v4f = pack_params_v4f(...) -> (N, 24) bf16, K3's output
    with the normals (V4_DPDM), no spill; blob as field_forward_v6's."""
    return _forward_no_spill(packed_v4f, mean_cov, g_bands, samples_per_ray,
                             True, "field_forward_v4",
                             "rsn_field_forward_v4", blob)


def field_forward_v3_train(packed, mean_cov: torch.Tensor,
                           g_bands: torch.Tensor, samples_per_ray: int,
                           blob: torch.Tensor = None) -> torch.Tensor:
    """K1 at the train width: pack_params_v3f operands -> (N, 24) bf16,
    K3's output without the normals (V4_DPDM zero), no spill; blob as
    field_forward_v6's."""
    return _forward_no_spill(packed, mean_cov, g_bands, samples_per_ray,
                             False, "field_forward_v3_train",
                             "rsn_field_forward_v4", blob)


def field_forward_v5(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                     samples_per_ray: int,
                     want_normals: bool = False) -> torch.Tensor:
    """K10: K7's operands (pack_params_v4f) with want_normals, else K1's
    (pack_params_v3f) -> (N, 24) bf16, equal to field_forward_v4's or
    field_forward_v3_train's output bit for bit; one persistent block per
    SM computes the next tile's IPE while this tile's trunk runs."""
    return _forward_no_spill(packed, mean_cov, g_bands, samples_per_ray,
                             want_normals, "field_forward_v5",
                             "rsn_field_forward_v5")


def _check_bwd(d_out, f_out, n, device):
    _check("d_out", d_out, (n, OUT_TRAIN), BF16, device)
    _check("f_out", f_out, (n, OUT_TRAIN), BF16, device)


def field_backward_v5(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                      acts: torch.Tensor, d_out: torch.Tensor,
                      f_out: torch.Tensor, samples_per_ray: int):
    """K4 -> (dmc (N, 16) f32, dg (R, 512) f32, dpacked: 20 fp32 tensors
    shaped like the packed operands).  On the card, K8's schedule without
    the recompute (stash_backward); at the default step's pass 4 (512 rays
    x 64 samples on 132 SMs: 128 blocks of 4 tiles, one chunk, P = 7) its
    scratch is 286,261,248 bytes of workspace + 1,378,304 of compact
    slices + 15,712,256 of partials = 303,351,808 (the first design's
    slices: 311,623,680)."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    S = int(samples_per_ray)
    R = _rows(n, S, "field_backward_v5")
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check("g_bands", g_bands, (R, 512), F32, device)
    _check("acts", acts, (n, ACTS_COLS), BF16, device)
    _check_bwd(d_out, f_out, n, device)
    _check_train_packed(packed, False, device)
    if device.type == "cpu":
        return field_backward_v5_plain(packed, mean_cov, g_bands, acts,
                                       d_out, f_out, S)
    if device.type != "cuda":
        raise ValueError(f"field_backward_v5: unsupported device {device}")
    return stash_backward("field_backward_v5",
                          (packed, mean_cov, g_bands, acts, d_out, f_out), S)


def field_backward_v6(packed, g_bands: torch.Tensor, xacts: torch.Tensor,
                      d_out: torch.Tensor, f_out: torch.Tensor,
                      samples_per_ray: int):
    """K5 -> (dg (R, 512) f32, dpacked: 20 fp32 tensors).  On the card,
    K4's schedule (stash_backward); at the default step's pass 2 (1,024
    rays x 128 samples: 128 blocks of 16 tiles, 4 chunks, P = 7) its
    scratch is 303,351,808 bytes (the first design's slices, at two blocks
    per SM: 623,247,360)."""
    device = xacts.device
    n = xacts.shape[0]
    S = int(samples_per_ray)
    R = _rows(n, S, "field_backward_v6")
    _check("g_bands", g_bands, (R, 512), F32, device)
    _check("xacts", xacts, (n, XACTS_COLS), BF16, device)
    _check_bwd(d_out, f_out, n, device)
    _check_train_packed(packed, False, device)
    if device.type == "cpu":
        return field_backward_v6_plain(packed, g_bands, xacts, d_out,
                                       f_out, S)
    if device.type != "cuda":
        raise ValueError(f"field_backward_v6: unsupported device {device}")
    _, dg, dpk = stash_backward("field_backward_v6",
                                (packed, g_bands, xacts, d_out, f_out), S)
    return dg, dpk


def _check_recompute(packed, mean_cov, g_bands, d_out, f_out, S: int,
                     name: str) -> int:
    """K8's and K13's checks -> R; raises on a device that is neither the
    CPU nor CUDA."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    R = _rows(n, S, name)
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check("g_bands", g_bands, (R, 512), F32, device)
    _check_bwd(d_out, f_out, n, device)
    _check_train_packed(packed, False, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return R


class StashScratch(NamedTuple):
    """One K4, K5 or K8 call's outputs and scratch on the card."""
    dmc: torch.Tensor    # (N, 16) f32; K5: None
    dg: torch.Tensor     # (R, 512) f32, zeroed
    small: torch.Tensor  # (blocks, SMALL_FLOATS) f32 compact slices, zeroed
    slots: torch.Tensor  # K8: (blocks, 64, ACTS_COLS) bf16 recompute slots
    stash: torch.Tensor  # (blocks x the first chunk's tiles, REC_ELEMS) bf16


def stash_scratch(plan: StashPlan, device, want_dmc: bool = True
                  ) -> StashScratch:
    """A call's StashScratch, its workspace sized for the largest chunk;
    the recompute slots only for K8's plan, dmc only with want_dmc."""
    per = plan.chunks[0][1] - plan.chunks[0][0]
    n = plan.rays * plan.samples_per_ray
    return StashScratch(
        torch.empty((n, IN_COLS), dtype=F32, device=device)
        if want_dmc else None,
        torch.zeros((plan.rays, 512), dtype=F32, device=device),
        torch.zeros((plan.blocks, SMALL_FLOATS), dtype=F32, device=device),
        torch.empty((plan.blocks, TILE_ROWS, ACTS_COLS), dtype=BF16,
                    device=device) if plan.recompute else None,
        torch.empty((plan.blocks * per, wg.REC_ELEMS), dtype=BF16,
                    device=device))


# the kernels that run as kernel A + kernel B, and whether each computes dmc
# (K13, field_backward_v3, runs K8's kernels under names of its own)
STASH_KERNELS = {"field_backward_v4": True, "field_backward_v5": True,
                 "field_backward_v6": False, "field_backward_v3": True}
RECOMPUTE_KERNELS = ("field_backward_v4", "field_backward_v3")
# kernel B's launch count per kernel (K8's, K4's and K5's: FOLDED's label)
WGRAD_LABELS = {"field_backward_v3": "field_backward_v3_wgrad"}


def kernel_a(lib, name: str, plan: StashPlan, chunk, inputs,
             sc: StashScratch) -> torch.Tensor:
    """Kernel A of `name` (K8 field_backward_v4, K4 field_backward_v5, K5
    field_backward_v6, or K13 field_backward_v3, which launches K8's) from
    `lib` (field_train.cu as load_library builds it, or ablate_k8.py's
    builds of it) on chunk (t0, t1) of `plan`, on checked inputs (the
    wrapper's arguments without samples_per_ray), into `sc` -> the chunk's
    workspace, a view of sc.stash.  Counts its launch under `name`."""
    t0, t1 = chunk
    ws = sc.stash[:plan.blocks * (t1 - t0)]
    packed, d_out, f_out = inputs[0], inputs[-2], inputs[-1]
    device = d_out.device
    tail = (sc.dg.data_ptr(), sc.small.data_ptr())
    sched = (plan.rays, plan.samples_per_ray, plan.rays_per_block, t0, t1,
             torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        if name == "field_backward_v6":
            g_bands, xacts = inputs[1:3]
            rc = lib.rsn_field_backward_v6(
                g_bands.data_ptr(), xacts.data_ptr(), d_out.data_ptr(),
                f_out.data_ptr(), _ptr_array(packed), *tail, ws.data_ptr(),
                *sched)
        else:
            mean_cov, g_bands = inputs[1:3]
            head = (mean_cov.data_ptr(), g_bands.data_ptr(),
                    _ipe_consts(device).data_ptr())
            if name == "field_backward_v5":
                rc = lib.rsn_field_backward_v5(
                    *head, inputs[3].data_ptr(), d_out.data_ptr(),
                    f_out.data_ptr(), _ptr_array(packed), sc.dmc.data_ptr(),
                    *tail, ws.data_ptr(), *sched)
            else:
                rc = lib.rsn_field_backward_v4(
                    *head, d_out.data_ptr(), f_out.data_ptr(),
                    _ptr_array(packed), sc.dmc.data_ptr(), *tail,
                    sc.slots.data_ptr(), ws.data_ptr(), *sched)
    _raise_on_error(lib, rc, name)
    LAUNCHES[name] += 1
    return ws


def stash_grads(small: torch.Tensor, partial: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """The 20 packed-operand gradients of a K4, K5, K8 or K17 call: the
    compact slices summed over the blocks (torch.sum over dim 0, as the
    first design's slices: the same order per column) and the weight
    matrices from the partials (torch.sum over the P slices)."""
    return _grads_from_totals(small.sum(dim=0), partial.sum(dim=0))


def _grads_from_totals(tot: torch.Tensor, wtot: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """The compact slices' sum over the blocks (SMALL_FLOATS,) and the
    partials' over the slices (wg.PARTIAL_FLOATS,) -> the 20 packed-operand
    gradients (w_hc, w_out and b_out with zeros past their live
    columns)."""
    biases = [tot[SMALL_B + i * TRUNK_WIDTH:SMALL_B + (i + 1) * TRUNK_WIDTH]
              .view(1, TRUNK_WIDTH) for i in range(TRUNK_LAYERS)]
    w_out = torch.zeros((128, 128), dtype=F32, device=tot.device)
    w_out[:, :3] = tot[SMALL_WOUT:SMALL_BOUT].view(128, 3)
    b_out = torch.zeros((1, 128), dtype=F32, device=tot.device)
    b_out[0, :3] = tot[SMALL_BOUT:SMALL_BOUT + 3]
    b_hc = tot[SMALL_BHC:SMALL_WOUT].view(1, TRUNK_WIDTH)
    dpk = [None] * 8 + biases + [None, b_hc, w_out, b_out]
    return _with_weights(dpk, wg.weights_from_total(wtot))


def stash_phases(name: str, inputs, samples_per_ray: int):
    """stash_backward's launches, kernel A and kernel B per chunk ->
    (dmc or None, dg, the compact slices, kernel B's partials)."""
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    f_out = inputs[-1]
    plan = stash_plan(f_out.shape[0] // samples_per_ray, samples_per_ray,
                      _sm_count(f_out.device), name in RECOMPUTE_KERNELS)
    device = f_out.device
    sc = stash_scratch(plan, device, STASH_KERNELS[name])
    partial = torch.empty((plan.slices, wg.PARTIAL_FLOATS), dtype=F32,
                          device=device)
    for c, chunk in enumerate(plan.chunks):
        wg.contract(kernel_a(lib, name, plan, chunk, inputs, sc), partial,
                    accumulate=c > 0, label=WGRAD_LABELS.get(name))
    return sc.dmc, sc.dg, sc.small, partial


def stash_backward(name: str, inputs, samples_per_ray: int):
    """K8, K4 or K5 (`name`, a key of STASH_KERNELS) on the card, on checked
    CUDA inputs (the wrapper's arguments without samples_per_ray) -> (dmc
    or None, dg, the 20 gradients).

    stash_plan's schedule: K4's partition, each block's run of 64-row
    tiles cut into chunks of TILES_PER_CHUNK = 4 tiles of every block, the
    most whose records (559,104 bytes each) fit in what the first design's
    per-block fp32 slice took (608,640 floats).  Per chunk, kernel A (the
    body: dmc, dg, the biases and the mid head's gradients as in the first
    design; each tile's weight-gradient operands to the chunk's workspace)
    and kernel B (their wgmma contraction into P fp32 partials); each
    counts one launch per chunk.  The three kernels share the schedule, so
    K4 equals K8 and K5 equals K4 (dg, the 20 gradients) bit for bit."""
    dmc, dg, small, partial = stash_phases(name, inputs, samples_per_ray)
    return dmc, dg, stash_grads(small, partial)


def field_backward_v4(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                      d_out: torch.Tensor, f_out: torch.Tensor,
                      samples_per_ray: int):
    """K8 -> (dmc (N, 16) f32, dg (R, 512) f32, dpacked: 20 fp32 tensors),
    K4's results with the trunk recomputed from mean_cov.

    On the card, stash_backward with K8's kernel A recomputing the trunk
    into each block's slot.  Scratch per call (StashPlan.scratch_bytes):
    at the camera-on step's pass 2 (1,024 rays x 128 samples on 132 SMs:
    128 blocks of 16 tiles, 4 chunks, P = 7) 286,261,248 bytes of
    workspace + 33,554,432 of slots + 1,378,304 of compact slices +
    15,712,256 of partials = 336,906,240 (the first design: 311,623,680
    of slices + 33,554,432 of slots = 345,178,112)."""
    S = int(samples_per_ray)
    _check_recompute(packed, mean_cov, g_bands, d_out, f_out, S,
                     "field_backward_v4")
    if mean_cov.device.type == "cpu":
        return field_backward_v4_plain(packed, mean_cov, g_bands, d_out,
                                       f_out, S)
    return stash_backward("field_backward_v4",
                          (packed, mean_cov, g_bands, d_out, f_out), S)


def field_backward_v3(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                      d_out: torch.Tensor, f_out: torch.Tensor,
                      samples_per_ray: int):
    """K13 -> (dmc (N, 16) f32, dg (R, 512) f32, dpacked: 20 fp32 tensors
    in the packed operands' shapes, summed over the grid by the launches in
    a fixed order).  On the card, K8's kernel A and kernel B per chunk of
    K8's plan (counted as field_backward_v3 and field_backward_v3_wgrad),
    then k13_sum; dmc and dg equal K8's bit for bit, and so does its
    scratch (StashPlan.scratch_bytes, plus the 2,434,560 bytes of the
    gradients it returns)."""
    S = int(samples_per_ray)
    _check_recompute(packed, mean_cov, g_bands, d_out, f_out, S,
                     "field_backward_v3")
    if mean_cov.device.type == "cpu":
        return field_backward_v4_plain(packed, mean_cov, g_bands, d_out,
                                       f_out, S)
    dmc, dg, small, partial = stash_phases(
        "field_backward_v3", (packed, mean_cov, g_bands, d_out, f_out), S)
    return dmc, dg, _packed_views(k13_sum(small, partial))


def k13_sum(small: torch.Tensor, partial: torch.Tensor) -> torch.Tensor:
    """K13's sum launch: (blocks, SMALL_FLOATS) compact slices and (P,
    wg.PARTIAL_FLOATS) partials, f32 tensors on one device -> the
    (PACK_FLOATS,) packed gradients, k13_sum_plain's in one flat tensor,
    bit for bit.  Counted as field_backward_v3_sum; CPU tensors take
    k13_sum_plain."""
    device = partial.device
    _check("small", small, (small.shape[0], SMALL_FLOATS), F32, device)
    _check("partial", partial, (partial.shape[0], wg.PARTIAL_FLOATS), F32,
           device)
    if device.type == "cpu":
        return torch.cat([t.reshape(-1) for t in k13_sum_plain(small,
                                                               partial)])
    if device.type != "cuda":
        raise ValueError(f"k13_sum: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    grads = torch.empty(PACK_FLOATS, dtype=F32, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_backward_v3_sum(
            partial.data_ptr(), partial.shape[0], small.data_ptr(),
            small.shape[0], grads.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_backward_v3_sum")
    LAUNCHES["field_backward_v3_sum"] += 1
    return grads


def field_backward_v3_first_design(lib, packed, mean_cov, g_bands, d_out,
                                   f_out, samples_per_ray: int):
    """K13's first design on checked CUDA inputs, one cooperative launch
    from `lib`, the RSN_K13_FIRST_DESIGN build of field_train.cu: K8's
    first-design body into per-block fp32 slices of all 20 gradients,
    summed in block order behind a grid-wide barrier -> (dmc, dg, the 20
    gradients).  Its scratch: blocks x (PACK_FLOATS floats + a 64-row
    recompute slot).  Counts no launch."""
    device, n = mean_cov.device, mean_cov.shape[0]
    S = int(samples_per_ray)
    R = n // S
    rpb = _rays_per_block(R, device)
    blocks = -(-R // rpb)
    dmc = torch.empty((n, IN_COLS), dtype=F32, device=device)
    dg = torch.zeros((R, 512), dtype=F32, device=device)
    buf = torch.zeros((blocks, PACK_FLOATS), dtype=F32, device=device)
    slots = torch.empty((blocks, TILE_ROWS, ACTS_COLS), dtype=BF16,
                        device=device)
    grads = torch.empty(PACK_FLOATS, dtype=F32, device=device)
    arrived = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_backward_v3(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            _ipe_consts(device).data_ptr(), d_out.data_ptr(),
            f_out.data_ptr(), _ptr_array(packed), dmc.data_ptr(),
            dg.data_ptr(), buf.data_ptr(), slots.data_ptr(),
            grads.data_ptr(), arrived.data_ptr(), R, S, rpb,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_backward_v3 (first design)")
    return dmc, dg, _packed_views(grads)


# ---- K6: the autograd Function ---------------------------------------------

class FusedFieldTrain(torch.autograd.Function):
    """The fused training field (rsn fused_field_train).  save_acts (the
    spill route): K3 forward, K4 (want_dmc) or K5 backward.  Otherwise
    (the recompute route, which keeps no activations between forward and
    backward): K7 (want_normals) or K1 at the train width forward, K8
    backward.

    Differentiable inputs: mean_cov (N, 16) f32, g_bands (R, 512) f32 and
    the 20 fp32 operands of pack_params_v3f_f32.  The bf16 casts happen
    here, so the weight gradients come back fp32.  The output is K3's
    (N, 24) bf16; the cotangents of its columns 14:20 (V4_DPDM,
    V3_MIDVAL) are ignored, and the one of V3_DENSITY..V3_ROUGH enters
    the backward bf16-rounded.  want_dmc=False promises that mean_cov's
    cotangent is dead (rays that are autograd leaves): on the spill route
    K5 runs and the mean_cov gradient is zero; the recompute route always
    returns K8's mean_cov gradient, as rsn's does."""

    @staticmethod
    def forward(ctx, samples_per_ray: int, want_normals: bool,
                want_dmc: bool, save_acts: bool, blob, wd_row, mean_cov,
                g_bands, *packed_f32):
        packed = ff.cast_packed(packed_f32)
        mean_cov = mean_cov.detach().contiguous()
        g_bands = g_bands.detach().float().contiguous()
        ops = packed + ((wd_row.detach().contiguous(),) if want_normals
                        else ())
        if save_acts:
            out, acts = field_forward_v6(ops, mean_cov, g_bands,
                                         samples_per_ray, want_normals,
                                         spill_x=not want_dmc, blob=blob)
            ctx.save_for_backward(mean_cov, g_bands, out, acts, *packed)
        else:
            fwd = field_forward_v4 if want_normals else field_forward_v3_train
            out = fwd(ops, mean_cov, g_bands, samples_per_ray, blob=blob)
            ctx.save_for_backward(mean_cov, g_bands, out, *packed)
        ctx.samples_per_ray = samples_per_ray
        ctx.want_dmc = want_dmc
        ctx.save_acts = save_acts
        return out

    @staticmethod
    def backward(ctx, d_out):
        mean_cov, g_bands, out, *rest = ctx.saved_tensors
        S = ctx.samples_per_ray
        d_out = d_out.to(BF16).contiguous()
        if not ctx.save_acts:
            dmc, dg, dpk = field_backward_v4(rest, mean_cov, g_bands, d_out,
                                             out, S)
        elif ctx.want_dmc:
            dmc, dg, dpk = field_backward_v5(rest[1:], mean_cov, g_bands,
                                             rest[0], d_out, out, S)
        else:
            dg, dpk = field_backward_v6(rest[1:], g_bands, rest[0], d_out,
                                        out, S)
            dmc = torch.zeros_like(mean_cov)  # dead by the caller's promise
        return (None, None, None, None, None, None, dmc, dg) + tuple(dpk)


def fused_field_train(packed_f32, mean_cov: torch.Tensor,
                      g_bands: torch.Tensor, samples_per_ray: int,
                      want_normals: bool = False, want_dmc: bool = True,
                      wd_row: torch.Tensor = None,
                      save_acts: bool = True,
                      blob: torch.Tensor = None) -> torch.Tensor:
    """FusedFieldTrain.apply with rsn's argument order.  packed_f32 =
    pack_params_v3f_f32(field); wd_row = the density head's (1, 256)
    weight row, needed with want_normals; save_acts: the spill route (K3
    with K4 / K5), else the recompute route (K7 / K1 with K8); blob:
    train_blob of packed_f32's weights, which a step's calls share
    (packed per call on the card when None)."""
    if want_normals and wd_row is None:
        raise ValueError("want_normals needs the density head row wd_row")
    return FusedFieldTrain.apply(int(samples_per_ray), bool(want_normals),
                                 bool(want_dmc), bool(save_acts), blob,
                                 wd_row, mean_cov, g_bands, *packed_f32)
