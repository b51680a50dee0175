"""The weights of K1 (`field_forward_v3`) and K2 (`field_forward_density`)
pre-packed for their Hopper kernels' weight ring
(rsn_torch/csrc/trunk_sm90.cuh), the train blob of K3, K7 and K1 at the
train width (rsn_torch/csrc/train_sm90.cuh), the plain versions that read
them back, and the wgmma / mma.sync probe.

The kernels stream every layer's weights through shared memory as chunks
of 64 k-rows, in the order they use them: layer 0 (2 chunks: the IPE's
128 padded rows), layers 1-3 (4 each), layer 4 (6: the IPE's 128 rows,
then the 256 of the previous layer), layers 5-7 (4 each), and for K1 the
heads + mid-seed product (4 chunks of w_hc's 16 head and 128 mid-seed
columns).  A chunk is its (64, N) block transposed to (N, 64), each row
128 bytes with its eight 16-byte groups swizzled (group g of row n at
position g ^ (n % 8)): the K-major, 128-byte swizzled layout that wgmma
reads its B operand in.  The blob is the chunks back to back, built once
per packed tuple (per render), never per call.

The second chunk of layers 0 and 4 holds the IPE's rows 64..127, of
which 99..127 are zero padding; the kernels multiply three of its four
16-row k-steps (rows 112..127 meet the IPE's zero columns, and adding
their zero products leaves every sum unchanged).

The train blob is K1's blob followed by the normals' dgrad chunks
(dgrad_schedule): dinp = dpre @ W_i^T for layers 7 down to 0, each as 4
chunks of 64 of W_i's 256 output columns.  wgmma's K-major B operand of
that product is W_i itself with its rows (input dimensions) as N, so a
dgrad chunk is W_i[r0:r0 + N, k0:k0 + 64] swizzled like the others (no
transposed copy).  Layer 4 takes its x share (rows 0..103: the IPE's 99
live dimensions to a multiple of 8) and then its h part (rows 128..383)
as two passes over the same dpre; layer 0 is the x share alone.  On the
card one launch packs it from the fp32 operands (field_train.train_blob).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH

BF16 = torch.bfloat16
CHUNK_K = 64
ENC_PAD = 128
MID = 128
HEAD_COLS = 16           # w_hc's head columns 0..15 (11 live)
HEAD_N = HEAD_COLS + MID  # 144: the heads and the mid seed
XS_N = 104                # the dgrad's x share: the IPE's 99 live dims


def _layer_rows(layer: int) -> int:
    if layer == 0:
        return ENC_PAD
    return ENC_PAD + TRUNK_WIDTH if layer == SKIP_AT else TRUNK_WIDTH


def trunk_schedule() -> List[Tuple[int, int, int]]:
    """The trunk's chunks in the kernels' order: (layer, first k-row,
    k-steps of 16 the kernels multiply)."""
    out = []
    for layer in range(TRUNK_LAYERS):
        for k0 in range(0, _layer_rows(layer), CHUNK_K):
            pad = k0 == CHUNK_K and layer in (0, SKIP_AT)
            out.append((layer, k0, 3 if pad else 4))
    return out


def _group_index(n: int, device) -> torch.Tensor:
    """(n, 8): position p of row r holds 16-byte group p ^ (r % 8)."""
    r = torch.arange(n, device=device)[:, None] % 8
    return torch.arange(8, device=device)[None, :] ^ r


def swizzle_chunk(block: torch.Tensor) -> torch.Tensor:
    """(64, N) bf16 k-rows -> (N * 64,) in the B-operand layout."""
    n = block.shape[1]
    bt = block.t().reshape(n, 8, 8)
    idx = _group_index(n, block.device)[:, :, None].expand(n, 8, 8)
    return torch.gather(bt, 1, idx).reshape(-1)


def unswizzle_chunk(chunk: torch.Tensor, n: int) -> torch.Tensor:
    """swizzle_chunk's inverse: (n * 64,) -> (64, n)."""
    g = chunk.reshape(n, 8, 8)
    idx = _group_index(n, chunk.device)[:, :, None].expand(n, 8, 8)
    return torch.gather(g, 1, idx).reshape(n, CHUNK_K).t()


def head_columns(w_hc: torch.Tensor) -> torch.Tensor:
    """w_hc's columns that K1 multiplies: (256, 256) -> (256, 144), the head
    columns 0..15 and the mid seed 128..255 (11..127 are zero padding)."""
    return torch.cat([w_hc[:, :HEAD_COLS], w_hc[:, MID:]], dim=1)


@torch.no_grad()
def pack_blob(ws: Sequence[torch.Tensor],
              w_hc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring's chunks of the trunk weights w0..w7 (bf16, (in, 256)),
    then, for K1, of w_hc's used columns -> 1-D bf16, contiguous."""
    parts = [swizzle_chunk(ws[layer][k0:k0 + CHUNK_K])
             for layer, k0, _ in trunk_schedule()]
    if w_hc is not None:
        heads = head_columns(w_hc)
        parts += [swizzle_chunk(heads[k0:k0 + CHUNK_K])
                  for k0 in range(0, TRUNK_WIDTH, CHUNK_K)]
    return torch.cat(parts).contiguous()


def _chunks(blob: torch.Tensor):
    """Yield (layer or "heads", k0, k-steps, (64, N) block) in blob order."""
    off = 0
    for layer, k0, ksteps in trunk_schedule():
        n = CHUNK_K * TRUNK_WIDTH
        yield layer, k0, ksteps, unswizzle_chunk(blob[off:off + n],
                                                 TRUNK_WIDTH)
        off += n
    while off < blob.numel():
        n = CHUNK_K * HEAD_N
        yield "heads", off, 4, unswizzle_chunk(blob[off:off + n], HEAD_N)
        off += n


def unpack_blob(blob: torch.Tensor):
    """pack_blob's inverse -> (w0..w7, w_hc's used columns or None)."""
    rows = {}
    for layer, _, _, block in _chunks(blob):
        rows.setdefault(layer, []).append(block)
    ws = [torch.cat(rows[layer]) for layer in range(TRUNK_LAYERS)]
    heads = torch.cat(rows["heads"]) if "heads" in rows else None
    return ws, heads


def trunk_blob_plain(blob: torch.Tensor, bs: Sequence[torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """The trunk read from the blob chunk by chunk in the kernels' order:
    each layer's weights are its chunks stacked as they arrive, then the
    layer is field_forward._trunk_plain's (fp32 product, bias, ReLU, bf16).
    x (N, 128) bf16 -> (N, 256) bf16."""
    h, layer, rows = x, 0, []
    for lyr, _, _, block in _chunks(blob):
        if lyr == "heads":
            break
        rows.append(block)
        if sum(r.shape[0] for r in rows) == _layer_rows(lyr):
            inp = torch.cat([x, h], dim=1) if lyr == SKIP_AT else h
            h = torch.relu(inp.float() @ torch.cat(rows).float()
                           + bs[lyr]).to(BF16)
            layer, rows = lyr + 1, []
    if layer != TRUNK_LAYERS:
        raise ValueError(f"blob holds {layer} of {TRUNK_LAYERS} layers")
    return h


def dgrad_schedule() -> List[Tuple[int, int, int, int]]:
    """The normals' dgrad chunks in the kernels' order (train_sm90.cuh):
    (layer, first row of W_layer, rows N, first output column k0)."""
    out = []
    for layer in range(TRUNK_LAYERS - 1, -1, -1):
        parts = []
        if layer in (0, SKIP_AT):
            parts.append((0, XS_N))
        if layer > 0:
            parts.append((ENC_PAD if layer == SKIP_AT else 0, TRUNK_WIDTH))
        for r0, n in parts:
            out += [(layer, r0, n, k0)
                    for k0 in range(0, TRUNK_WIDTH, CHUNK_K)]
    return out


# the train blob's bf16 values: K1's blob, then the dgrad chunks (2,146,304
# bytes)
FWD_BLOB_ELEMS = CHUNK_K * (len(trunk_schedule()) * TRUNK_WIDTH
                            + TRUNK_WIDTH // CHUNK_K * HEAD_N)
TRAIN_BLOB_ELEMS = FWD_BLOB_ELEMS + CHUNK_K * sum(
    n for _, _, n, _ in dgrad_schedule())


def dgrad_chunk(w: torch.Tensor, r0: int, n: int, k0: int) -> torch.Tensor:
    """One dgrad chunk of W (in, 256): rows r0..r0 + n, output columns
    k0..k0 + 64, in the B-operand layout -> (n * 64,)."""
    return swizzle_chunk(w[r0:r0 + n, k0:k0 + CHUNK_K].t())


@torch.no_grad()
def pack_train_blob(ws: Sequence[torch.Tensor],
                    w_hc: torch.Tensor) -> torch.Tensor:
    """The train blob of w0..w7 ((in, 256)) and w_hc, fp32 or bf16 (cast to
    bf16 as field_forward.cast_packed casts): pack_blob's chunks, then the
    dgrad chunks -> 1-D bf16, contiguous (the plain version of the card's
    pack launch)."""
    ws = [w.to(BF16) for w in ws]
    return torch.cat([pack_blob(ws, w_hc.to(BF16))] + [
        dgrad_chunk(ws[layer], r0, n, k0)
        for layer, r0, n, k0 in dgrad_schedule()]).contiguous()


def train_blob_split(blob: torch.Tensor):
    """A train blob -> (K1's blob, the dgrad chunks as (layer, r0, n, k0,
    (n, 64) block) in the kernels' order)."""
    off, chunks = FWD_BLOB_ELEMS, []
    for layer, r0, n, k0 in dgrad_schedule():
        block = unswizzle_chunk(blob[off:off + n * CHUNK_K], n).t()
        chunks.append((layer, r0, n, k0, block))
        off += n * CHUNK_K
    if off != blob.numel():
        raise ValueError(f"train blob of {blob.numel()} values, expected "
                         f"{off}")
    return blob[:FWD_BLOB_ELEMS], chunks


def dgrad_weights(blob: torch.Tensor) -> List[torch.Tensor]:
    """The trunk weights as the dgrad chunks hold them: each layer's (in,
    256) matrix with its chunks put back in place as they arrive (rows
    104..127 of the x share, which no chunk holds, zero)."""
    ws = [torch.zeros(ENC_PAD if i == 0 else ENC_PAD + TRUNK_WIDTH
                      if i == SKIP_AT else TRUNK_WIDTH, TRUNK_WIDTH,
                      dtype=BF16) for i in range(TRUNK_LAYERS)]
    for layer, r0, n, k0, block in train_blob_split(blob)[1]:
        ws[layer][r0:r0 + n, k0:k0 + CHUNK_K] = block
    return ws


def mma_probe(a: torch.Tensor, w: torch.Tensor):
    """One (64, 256) @ (256, 256) bf16 product with fp32 sums on the card by
    wgmma (w through pack_blob's chunk layout and a bulk copy) and by
    mma.sync (wmma, as trunk() multiplies) -> (d_wgmma, d_mma), each
    (64, 256) fp32, every sum k ascending in steps of 16."""
    from rsn_torch.kernels.build import load_library

    if a.shape != (64, TRUNK_WIDTH) or w.shape != (TRUNK_WIDTH, TRUNK_WIDTH):
        raise ValueError("mma_probe: a (64, 256) and w (256, 256)")
    if a.dtype != BF16 or w.dtype != BF16 or a.device.type != "cuda":
        raise ValueError("mma_probe: bf16 tensors on a CUDA card")
    a, w = a.contiguous(), w.to(a.device).contiguous()
    blob = torch.cat([swizzle_chunk(w[k0:k0 + CHUNK_K])
                      for k0 in range(0, TRUNK_WIDTH, CHUNK_K)])
    d_wgmma = torch.empty(64, TRUNK_WIDTH, device=a.device)
    d_mma = torch.empty_like(d_wgmma)
    lib = load_library("field_forward.cu")
    with torch.cuda.device(a.device):
        rc = lib.rsn_mma_probe(a.data_ptr(), w.data_ptr(), blob.data_ptr(),
                               d_wgmma.data_ptr(), d_mma.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("mma_probe launch failed: "
                           f"{lib.rsn_cuda_error_string(rc).decode()}")
    return d_wgmma, d_mma
