"""K8's weight-gradient contraction on Hopper ("kernel B",
rsn_torch/csrc/wgrad_sm90.cuh): the layout of the workspace that K8's
body ("kernel A", field_train.cu) stashes each 64-row tile's operands
into, the 18 output tiles, the wrapper that launches the contraction, and
its plain version.

A record holds one 64-row tile.  Each operand is stored feature-major: F
features x 64 rows, feature f's 64 bf16 values in 128 bytes with the
16-byte group of rows 8g..8g+7 at position g ^ (f % 8) -- the K-major
128-byte swizzle that wgmma reads, with the sample rows as k
(trunk_sm90.swizzle_chunk of the (64, F) tile).  In order:

    X (128: the IPE tile) | hs0..hs7 (8 x 256) | dpre0..dpre7 (8 x 256)
    | d_hc (144: w_hc's head columns 0..15 and mid-seed columns 128..255)

8,736 bytes per row.  Rows past the end of a block's rays are zero.

The contraction computes dW_i += A_i^T dpre_i over a chunk's records for
18 output tiles of 128 input features (w0 on X; w1-w3, w5-w7 on
hs_{i-1}; w4 on [X, hs3]; w_hc on hs7 against d_hc), each split over P
slices of the records; slice p's sums go to its own fp32 partial of
PARTIAL_FLOATS (w0..w7, then w_hc's 144 live columns), which a call's
first chunk overwrites and its later chunks add to.  `weight_grads` sums
the P partials and returns the packed operands' shapes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels.field_forward import (BF16, ENC_PAD, F32, LAUNCHES,
                                             _check, _raise_on_error)
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH

REC_ROWS = 64
HEAD_N = ts.HEAD_N            # 144
HEAD_COLS = ts.HEAD_COLS      # 16
# element (bf16) offsets of the operands in a record
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


def _out_tiles() -> Tuple[Tuple[int, int, int, int, int, int], ...]:
    """The output tiles in kernel B's blockIdx.x order: (layer (8: w_hc),
    feature block, A offset, B offset, N, partial offset)."""
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


def slices_for(sms: int, records: int) -> int:
    """P: enough slices that the 18 x P blocks fill the card at one block
    per SM (7 on 132 SMs), and no more slices than records."""
    return max(1, min(sms // len(OUT_TILES), records))


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


def pack_record(x: torch.Tensor, hs: Sequence[torch.Tensor],
                dpre: Sequence[torch.Tensor],
                dhc: torch.Tensor) -> torch.Tensor:
    """One tile's operands, each (64, F) bf16 (x: 128, hs and dpre: 8 of
    256, dhc: 144) -> the (REC_ELEMS,) bf16 record."""
    parts = [x] + list(hs) + list(dpre) + [dhc]
    return torch.cat([ts.swizzle_chunk(p.to(BF16)) for p in parts])


def unpack_record(rec: torch.Tensor):
    """pack_record's inverse -> (x, hs (8), dpre (8), dhc)."""
    x = ts.unswizzle_chunk(rec[X_OFF:ACT_OFF], ENC_PAD)
    step = TRUNK_WIDTH * REC_ROWS
    hs = [ts.unswizzle_chunk(rec[ACT_OFF + i * step:ACT_OFF + (i + 1) * step],
                             TRUNK_WIDTH) for i in range(TRUNK_LAYERS)]
    dpre = [ts.unswizzle_chunk(rec[DPRE_OFF + i * step:
                                   DPRE_OFF + (i + 1) * step], TRUNK_WIDTH)
            for i in range(TRUNK_LAYERS)]
    dhc = ts.unswizzle_chunk(rec[DHC_OFF:REC_ELEMS], HEAD_N)
    return x, hs, dpre, dhc


# ---- kernel B and its plain version -----------------------------------------

def contract_plain(ws: torch.Tensor, partial: torch.Tensor,
                   accumulate: bool) -> None:
    """Plain kernel B, in place: for each output tile and slice p of the
    records (kernel B's split), partial[p] (or zero) + A^T B over the
    slice's rows in record order, in the partial's dtype (fp32 as kernel
    B's; fp64 gives a reference of the sums)."""
    records, slices = ws.shape[0], partial.shape[0]
    if not accumulate:
        partial.zero_()
    for p in range(slices):
        r0, r1 = records * p // slices, records * (p + 1) // slices
        if r1 == r0:
            continue
        recs = ws[r0:r1]
        for _, _, a_off, b_off, n, out_off in OUT_TILES:
            a = _unswizzle(recs[:, a_off:a_off + TILE_FEATS * REC_ROWS],
                           TILE_FEATS).reshape(-1, TILE_FEATS)
            b = _unswizzle(recs[:, b_off:b_off + n * REC_ROWS],
                           n).reshape(-1, n)
            out = partial[p, out_off:out_off + TILE_FEATS * n]
            out += (a.to(out.dtype).t() @ b.to(out.dtype)).reshape(-1)


def contract(ws: torch.Tensor, partial: torch.Tensor,
             accumulate: bool) -> None:
    """Kernel B: ws (records, REC_ELEMS) bf16 records of a chunk ->
    partial (P, PARTIAL_FLOATS) fp32, overwritten (accumulate False) or
    added to, in place.  Launches on CUDA tensors, the plain version on
    CPU ones."""
    records = ws.shape[0]
    _check("ws", ws, (records, REC_ELEMS), BF16, ws.device)
    if partial.dim() != 2 or partial.shape[1] != PARTIAL_FLOATS:
        raise ValueError(f"partial: expected (P, {PARTIAL_FLOATS}), got "
                         f"{tuple(partial.shape)}")
    _check("partial", partial, tuple(partial.shape), F32, ws.device)
    if ws.device.type == "cpu":
        return contract_plain(ws, partial, accumulate)
    if ws.device.type != "cuda":
        raise ValueError(f"contract: unsupported device {ws.device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    with torch.cuda.device(ws.device):
        rc = lib.rsn_wgrad_sm90(ws.data_ptr(), partial.data_ptr(), records,
                                partial.shape[0], int(accumulate),
                                torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_backward_v4_wgrad")
    LAUNCHES["field_backward_v4_wgrad"] += 1


def weight_grads(partial: torch.Tensor) -> List[torch.Tensor]:
    """(P, PARTIAL_FLOATS) partials -> [dw0..dw7 (their packed shapes),
    dw_hc (256, 256)], summed over the P slices (one torch.sum: a fixed
    order for a given shape)."""
    tot = partial.sum(dim=0)
    out, off = [], 0
    for rows in LAYER_ROWS:
        out.append(tot[off:off + rows * TRUNK_WIDTH].view(rows, TRUNK_WIDTH))
        off += rows * TRUNK_WIDTH
    hc = tot[W_FLOATS:].view(TRUNK_WIDTH, HEAD_N)
    w_hc = torch.zeros(TRUNK_WIDTH, TRUNK_WIDTH, dtype=F32,
                       device=partial.device)
    w_hc[:, :HEAD_COLS] = hc[:, :HEAD_COLS]
    w_hc[:, TRUNK_WIDTH - (HEAD_N - HEAD_COLS):] = hc[:, HEAD_COLS:]
    out.append(w_hc)
    return out
