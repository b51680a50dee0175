"""The weight-gradient contraction on Hopper ("kernel B",
rsn_torch/csrc/wgrad_sm90.cuh): the layouts of the workspace that a
backward body ("kernel A") stashes each 64-row tile's operands into, their
output tiles, the wrapper that launches the contraction, and its plain
version.  Two layouts: FOLDED, K8's (also K4's and K5's, kernel A in
field_train.cu), and UNFOLDED, the tools' K18 full + wgrad and K19 (kernel
A in experiments_bwd.cu).

A record holds one 64-row tile.  Each operand is stored feature-major: F
features x 64 rows, feature f's 64 bf16 values in 128 bytes with the
16-byte group of rows 8g..8g+7 at position g ^ (f % 8) -- the K-major
128-byte swizzle that wgmma reads, with the sample rows as k
(trunk_sm90.swizzle_chunk of the (64, F) tile).  In order, FOLDED:

    X (128: the IPE tile) | hs0..hs7 (8 x 256) | dpre0..dpre7 (8 x 256)
    | d_hc (144: w_hc's head columns 0..15 and mid-seed columns 128..255)

8,736 bytes per row; UNFOLDED: the same X, hs and dpre, then

    | d_heads (272: wh's 256 bottleneck columns and 16 head columns, 11
    live) | bottleneck (256) | dmid_pre (128)

9,760 bytes per row.  Rows past the end of a block's rays are zero.

The contraction computes dW += A^T B over a chunk's records for the
layout's output tiles of 128 input features (FOLDED, 18: w0 on X; w1-w3,
w5-w7 on hs_{i-1}; w4 on [X, hs3]; w_hc on hs7 against d_hc.  UNFOLDED,
22: the same 16 trunk tiles; wh on hs7 against d_heads' 256 bottleneck
columns and, apart, its 16 head columns (wgmma takes n <= 256); w_emb on
the bottleneck against dmid_pre), each split over P slices of the records;
slice p's sums go to its own fp32 partial of the layout's partial_floats
(w0..w7, then w_hc's 144 live columns; or wh's 256 columns, its 16, w_emb),
which a call's first chunk overwrites and its later chunks add to.
`weight_grads` / `unfolded_weight_grads` sum the P partials and return the
operands' shapes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels.field_forward import (BF16, ENC_PAD, F32, LAUNCHES,
                                             V3_SHAPES, V3U_SHAPES, _check,
                                             _raise_on_error)
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH

REC_ROWS = 64
HEAD_N = ts.HEAD_N            # 144
HEAD_COLS = ts.HEAD_COLS      # 16
# element (bf16) offsets of the operands in a FOLDED record
X_OFF = 0
ACT_OFF = X_OFF + ENC_PAD * REC_ROWS
DPRE_OFF = ACT_OFF + TRUNK_LAYERS * TRUNK_WIDTH * REC_ROWS
DHC_OFF = DPRE_OFF + TRUNK_LAYERS * TRUNK_WIDTH * REC_ROWS
REC_ELEMS = DHC_OFF + HEAD_N * REC_ROWS
REC_BYTES = 2 * REC_ELEMS     # 559,104
TILE_FEATS = 128              # an output tile's input features
# a partial: w0..w7 (their packed shapes in order), then w_hc's 144 columns
LAYER_ROWS = tuple(ENC_PAD if i == 0 else ENC_PAD + TRUNK_WIDTH
                   if i == SKIP_AT else TRUNK_WIDTH
                   for i in range(TRUNK_LAYERS))
W_FLOATS = sum(r * TRUNK_WIDTH for r in LAYER_ROWS)
PARTIAL_FLOATS = W_FLOATS + TRUNK_WIDTH * HEAD_N

# the UNFOLDED record: FOLDED's X, hs and dpre, then d_heads (272), the
# bottleneck (256), dmid_pre (128)
MID_N = 128
DHEADS_N = TRUNK_WIDTH + HEAD_COLS   # 272
U_DHEADS_OFF = DHC_OFF
U_COT_OFF = U_DHEADS_OFF + TRUNK_WIDTH * REC_ROWS
U_BNECK_OFF = U_DHEADS_OFF + DHEADS_N * REC_ROWS
U_DMID_OFF = U_BNECK_OFF + TRUNK_WIDTH * REC_ROWS
U_REC_ELEMS = U_DMID_OFF + MID_N * REC_ROWS
U_REC_BYTES = 2 * U_REC_ELEMS       # 624,640
# its partial: w0..w7, wh's 256 bottleneck columns (256 x 256), wh's 16
# head columns (256 x 16), w_emb (256 x 128)
U_WH_OFF = W_FLOATS
U_WCOT_OFF = U_WH_OFF + TRUNK_WIDTH * TRUNK_WIDTH
U_WEMB_OFF = U_WCOT_OFF + TRUNK_WIDTH * HEAD_COLS
U_PARTIAL_FLOATS = U_WEMB_OFF + TRUNK_WIDTH * MID_N   # 626,688


def _out_tiles() -> Tuple[Tuple[int, int, int, int, int, int], ...]:
    """FOLDED's output tiles in kernel B's blockIdx.x order: (layer (8:
    w_hc), feature block, A offset, B offset, N, partial offset)."""
    tiles, off = [], 0
    for layer, rows in enumerate(LAYER_ROWS):
        for fb in range(rows // TILE_FEATS):
            if layer == 0 or (layer == SKIP_AT and fb == 0):
                a = X_OFF
            elif layer == SKIP_AT:
                a = (ACT_OFF + (SKIP_AT - 1) * TRUNK_WIDTH * REC_ROWS
                     + (fb - 1) * TILE_FEATS * REC_ROWS)
            else:
                a = (ACT_OFF + (layer - 1) * TRUNK_WIDTH * REC_ROWS
                     + fb * TILE_FEATS * REC_ROWS)
            tiles.append((layer, fb, a,
                          DPRE_OFF + layer * TRUNK_WIDTH * REC_ROWS,
                          TRUNK_WIDTH, off + fb * TILE_FEATS * TRUNK_WIDTH))
        off += rows * TRUNK_WIDTH
    for fb in range(TRUNK_WIDTH // TILE_FEATS):
        tiles.append((TRUNK_LAYERS, fb,
                      ACT_OFF + (TRUNK_LAYERS - 1) * TRUNK_WIDTH * REC_ROWS
                      + fb * TILE_FEATS * REC_ROWS, DHC_OFF, HEAD_N,
                      W_FLOATS + fb * TILE_FEATS * HEAD_N))
    return tuple(tiles)


OUT_TILES = _out_tiles()
# UNFOLDED's: the 16 trunk tiles, then (layer 8) wh on hs7 against d_heads'
# 256 bottleneck columns, (9) against its 16 head columns, (10) w_emb on the
# bottleneck against dmid_pre, each over two feature blocks
_HS7 = ACT_OFF + (TRUNK_LAYERS - 1) * TRUNK_WIDTH * REC_ROWS
U_OUT_TILES = OUT_TILES[:16] + tuple(
    (layer, fb, a + fb * TILE_FEATS * REC_ROWS, b, n_,
     out + fb * TILE_FEATS * n_)
    for layer, a, b, n_, out in (
        (8, _HS7, U_DHEADS_OFF, TRUNK_WIDTH, U_WH_OFF),
        (9, _HS7, U_COT_OFF, HEAD_COLS, U_WCOT_OFF),
        (10, U_BNECK_OFF, U_DMID_OFF, MID_N, U_WEMB_OFF))
    for fb in range(2))


class Layout(NamedTuple):
    """A record layout and its kernel B: the records' bf16 elements, the
    output tiles (as OUT_TILES), the partial's floats, kernel A's compact
    per-block slice (its biases and mid head, fp32), the tiles of every
    block per chunk (the most whose records fit in what the first design's
    fp32 slice took), and kernel B's library, entry point and launch
    count."""
    rec_elems: int
    tiles: Tuple[Tuple[int, int, int, int, int, int], ...]
    partial_floats: int
    small_floats: int
    tiles_per_chunk: int
    source: str
    entry: str
    label: str

    @property
    def rec_bytes(self) -> int:
        return 2 * self.rec_elems


def _fp32_slice(shapes) -> int:
    return sum(r * c for r, c in shapes)


# kernel A's compact slices: b0..b7, then FOLDED b_hc (256) or UNFOLDED
# bh (384) and b_mid (128); w_out's 3 live columns (128 x 3); b_out (3,
# padded to 4) (field_train.cu GradSlice<true>, experiments_bwd.cu
# USlice<true>)
FOLDED = Layout(REC_ELEMS, OUT_TILES, PARTIAL_FLOATS,
                TRUNK_LAYERS * TRUNK_WIDTH + TRUNK_WIDTH + 128 * 3 + 4,
                _fp32_slice(V3_SHAPES) * 4 // REC_BYTES, "field_train.cu",
                "rsn_wgrad_sm90", "field_backward_v4_wgrad")
UNFOLDED = Layout(U_REC_ELEMS, U_OUT_TILES, U_PARTIAL_FLOATS,
                  TRUNK_LAYERS * TRUNK_WIDTH + 384 + 128 + 128 * 3 + 4,
                  _fp32_slice(V3U_SHAPES) * 4 // U_REC_BYTES,
                  "experiments_bwd.cu", "rsn_wgrad_unfolded",
                  "bwd_unfolded_wgrad")


def slices_for(sms: int, records: int, layout: Layout = FOLDED) -> int:
    """P: enough slices that the layout's tiles x P blocks fill the card at
    one block per SM (FOLDED 7, UNFOLDED 6 on 132 SMs), and no more slices
    than records."""
    return max(1, min(sms // len(layout.tiles), records))


# ---- the record layout -----------------------------------------------------

def _unswizzle(flat: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n * 64) swizzled operands -> (..., 64, n) tiles: the batched
    trunk_sm90.unswizzle_chunk."""
    lead = flat.shape[:-1]
    g = flat.reshape(*lead, n, 8, 8)
    r = torch.arange(n, device=flat.device)[:, None] % 8
    idx = (torch.arange(8, device=flat.device)[None, :] ^ r)
    idx = idx[:, :, None].expand(n, 8, 8).expand(*lead, n, 8, 8)
    return torch.gather(g, -2, idx).reshape(*lead, n, REC_ROWS) \
        .transpose(-1, -2)


def _pack(parts) -> torch.Tensor:
    return torch.cat([ts.swizzle_chunk(p.to(BF16)) for p in parts])


def pack_record(x: torch.Tensor, hs: Sequence[torch.Tensor],
                dpre: Sequence[torch.Tensor],
                dhc: torch.Tensor) -> torch.Tensor:
    """One tile's operands, each (64, F) bf16 (x: 128, hs and dpre: 8 of
    256, dhc: 144) -> the (REC_ELEMS,) bf16 FOLDED record."""
    return _pack([x] + list(hs) + list(dpre) + [dhc])


def pack_unfolded(x: torch.Tensor, hs: Sequence[torch.Tensor],
                  dpre: Sequence[torch.Tensor], d_heads: torch.Tensor,
                  bneck: torch.Tensor, dmid: torch.Tensor) -> torch.Tensor:
    """One tile's operands, each (64, F) bf16 (x: 128, hs and dpre: 8 of
    256, d_heads: 272, bneck: 256, dmid: 128) -> the (U_REC_ELEMS,) bf16
    UNFOLDED record."""
    return _pack([x] + list(hs) + list(dpre) + [d_heads, bneck, dmid])


def _unpack_trunk(rec: torch.Tensor):
    x = ts.unswizzle_chunk(rec[X_OFF:ACT_OFF], ENC_PAD)
    step = TRUNK_WIDTH * REC_ROWS
    hs = [ts.unswizzle_chunk(rec[ACT_OFF + i * step:ACT_OFF + (i + 1) * step],
                             TRUNK_WIDTH) for i in range(TRUNK_LAYERS)]
    dpre = [ts.unswizzle_chunk(rec[DPRE_OFF + i * step:
                                   DPRE_OFF + (i + 1) * step], TRUNK_WIDTH)
            for i in range(TRUNK_LAYERS)]
    return x, hs, dpre


def unpack_record(rec: torch.Tensor):
    """pack_record's inverse -> (x, hs (8), dpre (8), dhc)."""
    x, hs, dpre = _unpack_trunk(rec)
    return x, hs, dpre, ts.unswizzle_chunk(rec[DHC_OFF:REC_ELEMS], HEAD_N)


def unpack_unfolded(rec: torch.Tensor):
    """pack_unfolded's inverse -> (x, hs (8), dpre (8), d_heads, bneck,
    dmid)."""
    x, hs, dpre = _unpack_trunk(rec)
    return (x, hs, dpre,
            ts.unswizzle_chunk(rec[U_DHEADS_OFF:U_BNECK_OFF], DHEADS_N),
            ts.unswizzle_chunk(rec[U_BNECK_OFF:U_DMID_OFF], TRUNK_WIDTH),
            ts.unswizzle_chunk(rec[U_DMID_OFF:U_REC_ELEMS], MID_N))


# ---- kernel B and its plain version -----------------------------------------

def contract_plain(ws: torch.Tensor, partial: torch.Tensor,
                   accumulate: bool, layout: Layout = FOLDED) -> None:
    """Plain kernel B, in place: for each of the layout's output tiles and
    slice p of the records (kernel B's split), partial[p] (or zero) + A^T
    B over the slice's rows in record order, in the partial's dtype (fp32
    as kernel B's; fp64 gives a reference of the sums)."""
    records, slices = ws.shape[0], partial.shape[0]
    if not accumulate:
        partial.zero_()
    for p in range(slices):
        r0, r1 = records * p // slices, records * (p + 1) // slices
        if r1 == r0:
            continue
        recs = ws[r0:r1]
        for _, _, a_off, b_off, n, out_off in layout.tiles:
            a = _unswizzle(recs[:, a_off:a_off + TILE_FEATS * REC_ROWS],
                           TILE_FEATS).reshape(-1, TILE_FEATS)
            b = _unswizzle(recs[:, b_off:b_off + n * REC_ROWS],
                           n).reshape(-1, n)
            out = partial[p, out_off:out_off + TILE_FEATS * n]
            out += (a.to(out.dtype).t() @ b.to(out.dtype)).reshape(-1)


def contract(ws: torch.Tensor, partial: torch.Tensor,
             accumulate: bool, layout: Layout = FOLDED,
             label: str = None) -> None:
    """Kernel B: ws (records, layout.rec_elems) bf16 records of a chunk ->
    partial (P, layout.partial_floats) fp32, overwritten (accumulate
    False) or added to, in place.  Launches on CUDA tensors (counted under
    `label`, by default layout.label), the plain version on CPU ones."""
    records = ws.shape[0]
    _check("ws", ws, (records, layout.rec_elems), BF16, ws.device)
    if partial.dim() != 2 or partial.shape[1] != layout.partial_floats:
        raise ValueError(f"partial: expected (P, {layout.partial_floats}), "
                         f"got {tuple(partial.shape)}")
    _check("partial", partial, tuple(partial.shape), F32, ws.device)
    if ws.device.type == "cpu":
        return contract_plain(ws, partial, accumulate, layout)
    if ws.device.type != "cuda":
        raise ValueError(f"contract: unsupported device {ws.device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library(layout.source)
    with torch.cuda.device(ws.device):
        rc = getattr(lib, layout.entry)(
            ws.data_ptr(), partial.data_ptr(), records, partial.shape[0],
            int(accumulate), torch.cuda.current_stream().cuda_stream)
    label = label or layout.label
    _raise_on_error(lib, rc, label)
    LAUNCHES[label] += 1


def _trunk_grads(tot: torch.Tensor) -> List[torch.Tensor]:
    out, off = [], 0
    for rows in LAYER_ROWS:
        out.append(tot[off:off + rows * TRUNK_WIDTH].view(rows, TRUNK_WIDTH))
        off += rows * TRUNK_WIDTH
    return out


def weight_grads(partial: torch.Tensor) -> List[torch.Tensor]:
    """FOLDED (P, PARTIAL_FLOATS) partials -> [dw0..dw7 (their packed
    shapes), dw_hc (256, 256)], summed over the P slices (one torch.sum: a
    fixed order for a given shape)."""
    return weights_from_total(partial.sum(dim=0))


def weights_from_total(tot: torch.Tensor) -> List[torch.Tensor]:
    """A FOLDED partial's (PARTIAL_FLOATS,) sum over the slices ->
    weight_grads' tensors: w_hc's 144 columns spread to 256, zero
    between."""
    out = _trunk_grads(tot)
    hc = tot[W_FLOATS:].view(TRUNK_WIDTH, HEAD_N)
    w_hc = torch.zeros(TRUNK_WIDTH, TRUNK_WIDTH, dtype=F32,
                       device=tot.device)
    w_hc[:, :HEAD_COLS] = hc[:, :HEAD_COLS]
    w_hc[:, TRUNK_WIDTH - (HEAD_N - HEAD_COLS):] = hc[:, HEAD_COLS:]
    out.append(w_hc)
    return out


def unfolded_weight_grads(partial: torch.Tensor) -> List[torch.Tensor]:
    """UNFOLDED (P, U_PARTIAL_FLOATS) partials -> [dw0..dw7, dwh (256,
    384: the 272 columns kernel B contracts, zero past them), dw_emb (256,
    128)], summed over the P slices as weight_grads sums them."""
    tot = partial.sum(dim=0)
    out = _trunk_grads(tot)
    wh = torch.zeros(TRUNK_WIDTH, 384, dtype=F32, device=partial.device)
    wh[:, :TRUNK_WIDTH] = tot[U_WH_OFF:U_WCOT_OFF].view(TRUNK_WIDTH,
                                                         TRUNK_WIDTH)
    wh[:, TRUNK_WIDTH:DHEADS_N] = tot[U_WCOT_OFF:U_WEMB_OFF].view(
        TRUNK_WIDTH, HEAD_COLS)
    out.append(wh)
    out.append(tot[U_WEMB_OFF:].view(TRUNK_WIDTH, MID_N))
    return out
