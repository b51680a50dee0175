// Hopper (sm_90a) body of the field API's K11 (field_forward_v2) and K12
// (field_forward), in field_forward.cu, on trunk_sm90.cuh's persistent
// block: the weight ring fed by cp.async.bulk from a pre-packed blob
// (rsn_torch/kernels/unfolded_sm90.py, pack_heads_blob), 128-row tiles, two
// 64-row consumer warpgroups on wgmma, kept in step, and one producer
// thread.
//
// The function (rsn's _kernel_v2 / _kernel, column for column): the front
// end (K11: the exact IPE, ipe_exact_wg; K12: the caller's (N, 128) bf16
// encoding), the 8x256 trunk (trunk_wg), then every head in one (256, 384)
// product plus bh, as (N, 384) bf16 in the OUT_* columns:
//   columns 0:256   the bottleneck Bn = bf16(H @ wh[:, 0:256] + bh), 4 ring
//                   chunks of m64n256, written into H (the trunk's output
//                   is dead once both head products have read it;
//                   trunk_sm90.cuh's bottleneck_wg, K14's too);
//   columns 256:272 bf16(H @ wh[:, 256:272] + bh), 4 chunks of m64n16: the
//                   11 live heads and 5 zero weight columns;
//   columns 272:384 zero weight columns: bf16(bh), zero for pack_params'
//                   padding, as the first design writes them.
// A tile streams 40 ring chunks (trunk_sm90.cuh's heads_chunk_bytes: K14's
// first 40), 1,187,840 bytes.  Each element's sum runs k ascending in steps
// of 16 from +0, as the first design's wmma sums do, and the epilogues are
// its arithmetic, so K11 and K12 equal their first design
// (RSN_K11_FIRST_DESIGN) bit for bit.  On X, K11's layers 0 and 4 take 7
// k-steps (the IPE's columns 112..127 are zero); K12's take all 8, because
// a caller's encoding may hold anything in its columns 99..127 and rsn
// multiplies all 128 (by zero weight rows).
//
// The row, 768 bytes, has no staging buffer of its own: the whole
// warpgroup reads Bn back from H's swizzled rows, the head columns from a
// 2 KB tile, the padding from one block-wide copy of bf16(bh[272:384]),
// and issues streamed 16-byte stores, neighbouring threads on neighbouring
// addresses.  The stores are fire-and-forget: the next tile's front end
// and trunk run while the memory system drains them.  The next tile
// overwrites X (front end), H (layer 0) and the head columns (its tail),
// so the tile starts at a warpgroup barrier that every thread reaches only
// once its loads for the row are done.
#pragma once

#include "trunk_sm90.cuh"

namespace {
namespace sm90 {

constexpr int HEAD_COL0 = WIDTH;                  // wh's head columns 256..
constexpr int HEAD_PAD0 = HEAD_COL0 + HC_N;       // 272: zero weights on
constexpr int ROW_PIECES = HEAD_COLS / 8;         // 48 x 16 bytes a row
constexpr int HHC_WG_BYTES = WG_ROWS * HC_N * 2;  // 64 x 16 bf16, 2 KB
// per consumer: its head columns; once: bf16(bh[272:384]); the ring's
// barriers (+ 1024: the base is aligned up to 1024 bytes at run time)
constexpr int OFF_HHC = OFF_HS + CONSUMERS * H_WG_BYTES;
constexpr int OFF_HPAD = OFF_HHC + CONSUMERS * HHC_WG_BYTES;
constexpr int OFF_HBARS = OFF_HPAD + (HEAD_COLS - HEAD_PAD0) * 2;
constexpr int H_SMEM_BYTES = OFF_HBARS + 2 * STAGES * 8 + 1024;
static_assert(H_SMEM_BYTES <= 232448, "K11 / K12 exceed 227 KB");
static_assert(OFF_HPAD % 16 == 0 && OFF_HBARS % 8 == 0, "alignment");

__host__ __device__ constexpr long long heads_blob_bytes() {
  long long b = 0;
  for (int c = 0; c < HEADS_TILE_CHUNKS; ++c) b += heads_chunk_bytes(c);
  return b;
}
static_assert(heads_blob_bytes() == 1187840, "the heads blob's bytes");

struct HeadsParams {
  RenderParams r;     // mc, consts (K11), blob, b[8], n, out (N, 384)
  const bf16* enc;    // K12: (n, 128) bf16
  const float* bh;    // (384,): [bottleneck | density | diff | tint |
                      // roughness | normals | 0]
};

// K12's front end: the warpgroup's 64 encoding rows into X's two k-blocks,
// 16 bytes a thread and step (8 loads in flight), rows at or past n zero.
__device__ __forceinline__ void enc_wg(const bf16* __restrict__ enc,
                                       long long row0, long long n,
                                       unsigned char* X, int t) {
  constexpr int Q = ENC / 8;
#pragma unroll
  for (int e = t; e < WG_ROWS * Q; e += WG_THREADS) {
    const int r = e / Q, q = e % Q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = __ldcs(reinterpret_cast<const uint4*>(enc + (row0 + r) * ENC) + q);
    *reinterpret_cast<uint4*>(X + swz(r, 8 * q)) = v;
  }
}

// The heads on the warpgroup's trunk output H and the rows row0.. of the
// output: the head columns into hcs (64 x 16 bf16), Bn into H, then the
// 768-byte rows (pad: bf16(bh[272:384]), 14 pieces of 16 bytes).
__device__ __forceinline__ void heads_tail_wg(const HeadsParams& hp,
                                              RingPos& rp, unsigned char* H,
                                              bf16* hcs, const uint4* pad,
                                              long long row0, int wg, int t) {
  {  // bf16(H @ wh[:, 256:272] + bh) into hcs
    const uint32_t ha = smem_u32(H);
    float hc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) hc[i] = 0.f;
    fence_regs<8>(hc);
    mma_chunks<HC_N>(
        hc, rp, 4, [&](int j) { return ha + j * KB_BYTES; },
        [](int) { return 4; });
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int col = frag_col(t, i);
      const float2 bb =
          *reinterpret_cast<const float2*>(hp.bh + HEAD_COL0 + col);
      *reinterpret_cast<__nv_bfloat162*>(hcs + frag_row(t, i) * HC_N + col) =
          __floats2bfloat162_rn(__fadd_rn(hc[i], bb.x),
                                __fadd_rn(hc[i + 1], bb.y));
    }
  }

  NoChunkTurn none;
  bottleneck_wg(rp, H, hp.bh, wg, t, none);  // Bn into H
  wg_sync(wg);  // Bn and the head columns are visible to the warpgroup

#ifndef RSN_ABLATE_NO_STORE  // ablate_render.py: the rows left out
  // the (64, 384) rows, piece qq of row r: Bn's (0..31), the head
  // columns' (32, 33), the padding's (34..47)
#pragma unroll 8
  for (int e = t; e < WG_ROWS * ROW_PIECES; e += WG_THREADS) {
    const int r = e / ROW_PIECES, qq = e % ROW_PIECES;
    const long long row = row0 + r;
    if (row < hp.r.n) {
      const uint4 v =
          qq < WIDTH / 8 ? *reinterpret_cast<const uint4*>(H + swz(r, 8 * qq))
          : qq < HEAD_PAD0 / 8
              ? reinterpret_cast<const uint4*>(hcs + r * HC_N)[qq - WIDTH / 8]
              : pad[qq - HEAD_PAD0 / 8];
      __stcs(reinterpret_cast<uint4*>(hp.r.out + row * HEAD_COLS) + qq, v);
    }
  }
#endif
}

// K11 (IPE) or K12: the persistent block (one per SM at most), in the
// kernel's dynamic shared memory smem_raw (H_SMEM_BYTES).
template <bool IPE>
__device__ void heads_body(const HeadsParams& hp, unsigned char* smem_raw) {
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_HBARS);
  uint64_t* empty = full + STAGES;
  bf16* padv = reinterpret_cast<bf16*>(smem + OFF_HPAD);
  for (int c = threadIdx.x; c < HEAD_COLS - HEAD_PAD0; c += BLOCK_THREADS)
    padv[c] = __float2bfloat16_rn(hp.bh[HEAD_PAD0 + c]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const RenderParams& p = hp.r;
  const int ntiles = (int)((p.n + TILE_ROWS - 1) / TILE_ROWS);
  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    setmaxnreg_dec40();
    if (threadIdx.x == 0)
      produce_chunks(p.blob, smem + OFF_RING, full, empty, HEADS_TILE_CHUNKS,
                     ntiles, [](int c) { return heads_chunk_bytes(c); });
    return;
  }
  setmaxnreg_inc232();
  const int wg = wgi - 1, t = threadIdx.x % WG_THREADS;
  unsigned char* X = smem + OFF_XS + wg * X_WG_BYTES;
  unsigned char* H = smem + OFF_HS + wg * H_WG_BYTES;
  bf16* hcs = reinterpret_cast<bf16*>(smem + OFF_HHC + wg * HHC_WG_BYTES);
  const uint4* pad = reinterpret_cast<const uint4*>(padv);
  RingPos rp{smem + OFF_RING, full, empty, 0, 0u};
  if constexpr (IPE) zero_x_pad(X, t);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // the warpgroup's first row, derived where it is used (not held
    // through the trunk)
    const auto first_row = [&] {
      return (long long)tile * TILE_ROWS + wg * WG_ROWS;
    };
    wg_sync(wg);  // the previous tile's rows have read H and hcs
#ifndef RSN_ABLATE_NO_IPE  // ablate_render.py: X keeps stale values
    if constexpr (IPE)
      ipe_exact_wg(p.mc, first_row(), p.n, X, t, p.consts + 8 * (t & 1),
                   p.consts + NFREQ + 8 * (t & 1));
    else
      enc_wg(hp.enc, first_row(), p.n, X, t);
#endif
    fence_async_smem();
    wg_sync(wg);
    NoTrunkHook hook;
    NoChunkTurn none;
    trunk_wg<IPE ? 3 : 4>(p, rp, X, H, wg, t, hook, none);
    heads_tail_wg(hp, rp, H, hcs, pad, first_row(), wg, t);
  }
}

}  // namespace sm90
}  // namespace
