// The train-width forwards on Hopper (sm_90a), built from trunk_sm90.cuh's
// parts: K3 `field_forward_v6` (rsn/kernels/field_pallas.py:794), K7
// `field_forward_v4` (field_pallas.py:691) and, as K7 without the normals,
// K1 at the train width (field_pallas.py:512 at its V3_OUT store).  One
// body, train_trunk below, so the three equal each other bit for bit; K10
// `field_forward_v5` (field_pallas.py:945) is the same body with each
// tile's IPE written by the producer warpgroup's idle warps (AHEAD).
//
// What bounds them: their products (K1's trunk and heads, and with the
// normals 8 more layers: about 2.2 M MACs a row against 4.4 KB of spill),
// above the card's ~295 operations per byte.
//
// The design: K1's persistent block (trunk_sm90.cuh: 1 producer warpgroup
// streaming the weights through a ring of 32 KB stages by cp.async.bulk,
// 2 consumer warpgroups of 64 rows on 128-row tiles, wgmma) with
//   - the train-width tail (v3_tail_wg<24>: the mid value in 17:20);
//   - the normals (d density_preact / d mean) as 36 more chunks on the same
//     ring: dinp = dpre @ W_i^T for layers 7..0 by wgmma from the dgrad
//     chunks of the blob (trunk_sm90.cuh: W_i's rows as N, no transposed
//     copy), each sum from zero, k ascending in steps of 16, as trunk()'s
//     mma.sync took them; layer 4's x share (m64n104) first, then its h part
//     (m64n256); the x share's 52 fp32 values a thread wait in shared
//     memory that is free by then (the warpgroup's X and tail scratch, and
//     4 KB more) until layer 0's are added to them (dx = __fadd_rn(layer
//     0, layer 4)); kept in registers instead (RSN_ABLATE_XS_REGS,
//     ablate_k3.py) they add to the consumers' spills;
//   - the ReLU masks in registers: register i of consumer thread t holds
//     fragment element (frag_row(t, i), frag_col(t, i)) both in the forward
//     epilogue of layer i - 1 and in the drain of dgrad layer i, so each
//     thread keeps its own 128 bits a layer (4 words) from the bf16 values
//     it stored (> 0): no shared memory, no sync;
//   - dpre in place of H: D = bf16(mask_7 ? wd_row : 0) once the tail has
//     read H; each dgrad drain overwrites D once its products are done;
//     the fp32 dx (the 99 live columns) then goes to H for the IPE
//     backward, which runs field_train.cu's old per-(row, d) order;
//   - the spill (K3): each layer's H, and under spill_x the IPE tile X, to
//     (N, 2048 | 2176) row-major bf16, 16-byte pieces read from the
//     swizzled tile, one warp per 512 contiguous bytes of a row, marked
//     evict-first (the spill is read back after the step's other passes;
//     the weights and g stay in L2).  The stores issue between the layer's
//     epilogue and the next layer's products.
#pragma once

#include "trunk_sm90.cuh"

namespace {
namespace sm90 {

constexpr int TRAIN_COLS = 24;                  // the (N, 24) train row
constexpr int ROWS_WG_BYTES = WG_ROWS * TRAIN_COLS * 2;  // staged rows, 3 KB
constexpr int OFF_ROWS = off_bars<true>();      // behind K1's layout
// the x share's 52 fp32 values a thread from layer 4's dgrad to layer 0's,
// value j of thread t at float j * 128 + t of the warpgroup's X (j < 32),
// tail scratch (j < 44) and this (j < 52): the three are free then
constexpr int XS_IN_X = X_WG_BYTES / (4 * WG_THREADS);            // 32
constexpr int XS_IN_TAIL = XS_IN_X + TAIL_WG_BYTES / (4 * WG_THREADS);  // 44
constexpr int XS_WG_BYTES = (XS_N / 2 - XS_IN_TAIL) * 4 * WG_THREADS;
constexpr int OFF_XS_REST = OFF_ROWS + CONSUMERS * ROWS_WG_BYTES;
constexpr int OFF_TRAIN_BARS = OFF_XS_REST + CONSUMERS * XS_WG_BYTES;
constexpr int TRAIN_SMEM_BYTES = OFF_TRAIN_BARS + 2 * STAGES * 8 + 1024;
static_assert(TRAIN_SMEM_BYTES <= 232448, "the train forward exceeds 227 KB");
// K10 (the IPE ahead): the IPE constants behind the ring's barriers.  The
// layout leaves 5,072 bytes free: room for these 128, not for a second X
// (32 KB for the two consumers).
constexpr int TRAIN_AHEAD_SMEM_BYTES = TRAIN_SMEM_BYTES + AHEAD_BYTES;
static_assert(TRAIN_AHEAD_SMEM_BYTES <= 232448, "K10 exceeds 227 KB");
static_assert(TRAIN_SMEM_BYTES + CONSUMERS * X_WG_BYTES > 232448,
              "a second X slot would fit");
constexpr int DX_LD = IPE_DIM + 2;              // dx's f32 row stride (odd)
static_assert(WG_ROWS * DX_LD * 4 <= H_WG_BYTES, "dx must fit H");
constexpr int XS_R = XS_N / 2;                  // the x share's registers

struct TrainParams {
  RenderParams r;        // mc, consts, blob (the train blob), b, n, out
                         // ((n, 24)), g, S, w_hc, b_hc, w_out, b_out
  const float* wd_row;   // (1, 256) f32, the normals' seed
  bf16* acts;            // the spill, (n, ld) bf16 (K3)
  int ld;                // 2048, or 2176 with x
};

// rows [0, nv) of a tile of KB k-blocks (64 rows x 64 bf16 each, swizzled)
// to dst + r * ld, 16-byte pieces: lanes of a warp take neighbouring pieces
// of one row, so each warp instruction stores contiguous bytes.
template <int KB>
__device__ __forceinline__ void store_tile_rows(bf16* dst, long long ld,
                                                const unsigned char* T,
                                                int nv, int t) {
  constexpr int PIECES = KB * 8;
#pragma unroll 4
  for (int e = t; e < WG_ROWS * PIECES; e += WG_THREADS) {
    const int r = e / PIECES, q = e % PIECES;
    if (r < nv) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          T + (q >> 3) * KB_BYTES + r * 128 + (((q & 7) ^ (r & 7)) << 4));
      asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(
                       dst + r * ld + q * 8),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// trunk_wg's hook on the train path: with NORMALS each layer's ReLU mask
// (m[i]: bit i % 32 of word i / 32 is register i's bf16 value > 0), with
// SPILL each layer's output to the spill; with AHEAD and without NORMALS,
// X released once layer SKIP_AT's products, its last readers, are done.
template <bool NORMALS, bool SPILL, bool AHEAD = false>
struct TrainHook {
  uint32_t m[LAYERS][4];
  uint32_t cur[4];
  bf16* acts;            // the spill's row row0
  long long ld;
  int nv;                // the warpgroup's rows below n
  const unsigned char* H;
  int t;
  int rel;               // AHEAD: release_x's rel
  __device__ __forceinline__ void value(int i, __nv_bfloat162 v) {
    if constexpr (NORMALS) {
      const uint32_t bits = (__low2float(v) > 0.f ? 1u : 0u) |
                            (__high2float(v) > 0.f ? 2u : 0u);
      cur[i >> 5] |= bits << (i & 31);
    }
  }
  __device__ __forceinline__ void layer(int layer) {
    if constexpr (AHEAD && !NORMALS) {
      if (layer == SKIP_AT) release_x(rel);
    }
    if constexpr (NORMALS) {
#pragma unroll
      for (int l = 0; l < LAYERS - 1; ++l)
#pragma unroll
        for (int w = 0; w < 4; ++w) m[l][w] = m[l + 1][w];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        m[LAYERS - 1][w] = cur[w];
        cur[w] = 0u;
      }
    }
#ifndef RSN_ABLATE_NO_SPILL  // chip_smoke.py, ablate_k3.py: no spill stores
    if constexpr (SPILL)
      store_tile_rows<4>(acts + layer * WIDTH, ld, H, nv, t);
#endif
  }
};

// acc (zeroed here) = D @ the next 4 ring stages (one dgrad layer part: 4
// chunks of 64 k, 4 k-steps each)
template <int N>
__device__ __forceinline__ void dgrad_mma_wg(float* acc, RingPos& rp,
                                             uint32_t da) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs<N / 2>(acc);
  mma_chunks<N>(
      acc, rp, 4, [&](int j) { return da + j * KB_BYTES; },
      [](int) { return 4; });
}

// One dgrad layer's h part: dinp = D @ W^T (m64n256 from the ring), then
// D = bf16(mk ? dinp : 0) in place, mk the ReLU mask of the layer's input.
__device__ __forceinline__ void dgrad_wg(RingPos& rp, unsigned char* H,
                                         const uint32_t (&mk)[4], int wg,
                                         int t) {
  float acc[128];
  dgrad_mma_wg<256>(acc, rp, smem_u32(H));
  wg_sync(wg);  // no product of this layer still reads D
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int col = 8 * jj + 2 * (t & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * jj + 2 * h;
      const uint32_t bits = mk[i >> 5] >> (i & 31);
      *reinterpret_cast<__nv_bfloat162*>(H + swz(frag_row(t, i), col)) =
          __floats2bfloat162_rn(bits & 1u ? acc[i] : 0.f,
                                bits & 2u ? acc[i + 1] : 0.f);
    }
  }
  fence_async_smem();
  wg_sync(wg);
}

// Three dgrad layers, each with the first of q's masks (q shifts down).
__device__ __forceinline__ void dgrad3_wg(RingPos& rp, unsigned char* H,
                                          uint32_t (&q)[3][4], int wg,
                                          int t) {
#pragma unroll 1
  for (int l = 0; l < 3; ++l) {
    dgrad_wg(rp, H, q[0], wg, t);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      q[0][w] = q[1][w];
      q[1][w] = q[2][w];
    }
  }
}

// Where value j of the x share of thread t waits (XS_IN_X).
__device__ __forceinline__ float* xs_slot(unsigned char* X, float* tail,
                                          float* rest, int j, int t) {
  return j < XS_IN_X      ? reinterpret_cast<float*>(X) + j * WG_THREADS + t
         : j < XS_IN_TAIL ? tail + (j - XS_IN_X) * WG_THREADS + t
                          : rest + (j - XS_IN_TAIL) * WG_THREADS + t;
}

// The normals of the warpgroup's 64 rows (K3's and K7's V4_DPDM columns)
// into the staged rows (row r at rows + 24 r, columns 14..16): the
// density head row through the 8 layers (dh = wd_row; dpre = bf16(dh *
// mask); dinp = dpre @ W^T) and the IPE.  m: the forward's masks.  X, tail
// and rest hold layer 4's x share; X's zero columns 100..127 are zero
// again at the end, and with AHEAD X is released then, before the IPE
// backward.  Starts with the tail's reads of H possibly in flight; ends
// with the rows complete and visible to the warpgroup.
template <bool AHEAD = false>
__device__ __forceinline__ void normals_wg(const TrainParams& tp,
                                           RingPos& rp, unsigned char* X,
                                           unsigned char* H, float* tail,
                                           float* rest,
                                           const uint32_t (&m)[LAYERS][4],
                                           bf16* rows, long long row0,
                                           int wg, int t, int rel = -1) {
  wg_sync(wg);  // the tail's reads of H are done
  // dpre_7 = bf16(mask_7 ? wd_row : 0)
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int col = 8 * jj + 2 * (t & 3);
    const float2 wd = *reinterpret_cast<const float2*>(tp.wd_row + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * jj + 2 * h;
      const uint32_t bits = m[LAYERS - 1][i >> 5] >> (i & 31);
      *reinterpret_cast<__nv_bfloat162*>(H + swz(frag_row(t, i), col)) =
          __floats2bfloat162_rn(bits & 1u ? wd.x : 0.f,
                                bits & 2u ? wd.y : 0.f);
    }
  }
  fence_async_smem();
  wg_sync(wg);
  const uint32_t da = smem_u32(H);
  uint32_t q[3][4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    q[0][w] = m[6][w];
    q[1][w] = m[5][w];
    q[2][w] = m[4][w];
  }
  dgrad3_wg(rp, H, q, wg, t);  // layers 7, 6, 5
#ifdef RSN_ABLATE_XS_REGS  // ablate_k3.py: the x share in registers
  float xs[XS_R];
  dgrad_mma_wg<XS_N>(xs, rp, da);
#else
  {
    float xs[XS_R];  // layer 4's x share, to shared memory until layer 0
    dgrad_mma_wg<XS_N>(xs, rp, da);
#pragma unroll
    for (int j = 0; j < XS_R; ++j) *xs_slot(X, tail, rest, j, t) = xs[j];
  }
#endif
  dgrad_wg(rp, H, m[3], wg, t);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    q[0][w] = m[2][w];
    q[1][w] = m[1][w];
    q[2][w] = m[0][w];
  }
  dgrad3_wg(rp, H, q, wg, t);  // layers 3, 2, 1
  float x0[XS_R];              // layer 0
  dgrad_mma_wg<XS_N>(x0, rp, da);
  wg_sync(wg);  // no product reads D any more: H takes dx
  float* dx = reinterpret_cast<float*>(H);
#pragma unroll
  for (int i = 0; i < XS_R; ++i) {
    const int c = frag_col(t, i);
#ifdef RSN_ABLATE_XS_REGS
    const float x4 = xs[i];
#else
    const float x4 = *xs_slot(X, tail, rest, i, t);
#endif
    if (c < IPE_DIM) dx[frag_row(t, i) * DX_LD + c] = __fadd_rn(x0[i], x4);
  }
  wg_sync(wg);
  zero_x_pad(X, t);
  if constexpr (AHEAD) release_x(rel);
  // the IPE backward of the mean: dx damp cos(2 pi u) 2 pi f_k over both
  // halves, plus the identity columns 96..98; one (row, d) per thread
  for (int e = t; e < WG_ROWS * 3; e += WG_THREADS) {
    const int r = e / 3, d = e % 3;
    const long long row = row0 + r;
    if (row < tp.r.n) {
      const float* mr = tp.r.mc + row * IN_COLS;
      const float* dxr = dx + r * DX_LD;
      float s = 0.f;
      for (int half = 0; half < 2; ++half)
        for (int k = 0; k < NFREQ; ++k) {
          const int c = half * 48 + d * NFREQ + k;
          float damp, u;
          ipe_phase(mr, tp.r.consts, c, &damp, &u);
          const float dpre = __fmul_rn(dxr[c], __fmul_rn(damp, cos2pi(u)));
          s = __fmaf_rn(dpre, tp.r.consts[k], s);
        }
      s = __fadd_rn(s, dxr[96 + d]);
      rows[r * TRAIN_COLS + 14 + d] = __float2bfloat16_rn(s);
    }
  }
  wg_sync(wg);
}

// The train-width tile of K3 (SPILL), K7 (NORMALS) and K1 at the train
// width: the spill of X, the trunk with TrainHook, the train-width tail
// (into the staged rows with the normals, else to out) and the normals.
// AHEAD (K10): X is released where its last reader is done (after layer
// SKIP_AT, or with the normals once the x share has left it).
template <bool NORMALS, bool SPILL, bool SPILL_X, bool AHEAD = false>
struct TrainTile {
  const TrainParams& tp;
  bf16* staged;            // the block's staged rows (NORMALS)
  unsigned char* xs_rest;  // the rest of the x shares (NORMALS)
  __device__ __forceinline__ void operator()(RingPos& rp, unsigned char* X,
                                             unsigned char* H, float* tail,
                                             const float* wcol,
                                             const float4* wout,
                                             long long row0, int wg, int t) {
    const RenderParams& p = tp.r;
    const int nv = (int)min((long long)WG_ROWS, p.n - row0);
    bf16* acts = SPILL ? tp.acts + row0 * tp.ld : nullptr;
#ifndef RSN_ABLATE_NO_SPILL
    if constexpr (SPILL_X)
      store_tile_rows<2>(acts + LAYERS * WIDTH, tp.ld, X, nv, t);
#endif
    // the release of X, but on the block's last tile
    const int rel = AHEAD && row0 - wg * WG_ROWS +
                                     (long long)gridDim.x * TILE_ROWS < p.n
                        ? wg
                        : -1;
    TrainHook<NORMALS, SPILL, AHEAD> hook{
        {}, {0u, 0u, 0u, 0u}, acts, tp.ld, nv, H, t, rel};
    trunk_wg(p, rp, X, H, wg, t, hook);
    bf16* rows = NORMALS ? staged + wg * (WG_ROWS * TRAIN_COLS)
                         : p.out + row0 * TRAIN_COLS;
    v3_tail_wg<TRAIN_COLS>(p, rp, H, wcol, wout, tail, row0, wg, t, rows);
    if constexpr (NORMALS) {
      normals_wg<AHEAD>(tp, rp, X, H, tail,
                        reinterpret_cast<float*>(xs_rest + wg * XS_WG_BYTES),
                        hook.m, rows, row0, wg, t, rel);
      // the staged rows below n, 16 bytes a thread and step
      for (int e = t; e < WG_ROWS * 3; e += WG_THREADS)
        if (e / 3 < nv)
          reinterpret_cast<uint4*>(p.out + row0 * TRAIN_COLS)[e] =
              reinterpret_cast<const uint4*>(rows)[e];
    }
  }
};

// K3, K7 and K1 at the train width: the whole body.  AHEAD: K10, the same
// tile with its IPE written by the producer warpgroup's idle warps
// (persistent_body's IPE_AHEAD; TRAIN_AHEAD_SMEM_BYTES).
template <bool NORMALS, bool SPILL, bool SPILL_X, bool AHEAD = false>
__device__ void train_trunk(const TrainParams& tp, unsigned char* smem_raw) {
  static_assert(SPILL || !SPILL_X, "x is spilled with the activations");
  unsigned char* smem = align_1024(smem_raw);
  TrainTile<NORMALS, SPILL, SPILL_X, AHEAD> tile{
      tp, reinterpret_cast<bf16*>(smem + OFF_ROWS), smem + OFF_XS_REST};
  persistent_body<true, AHEAD>(tp.r, smem, OFF_TRAIN_BARS,
                               FWD_CHUNKS + (NORMALS ? DGRAD_CHUNKS : 0),
                               tile);
}

// ---- the train blob, packed on the card --------------------------------

// w0..w7 and w_hc, element (r, c) at p[r * s0 + c * s1] (fp32 or bf16)
struct PackArgs {
  const void* p[LAYERS + 1];
  long long s0[LAYERS + 1], s1[LAYERS + 1];
};

// The train blob (trunk_sm90.py's pack_train_blob): 16 bytes a thread, the
// chunks of trunk_sm90.cuh's schedule back to back, each value rounded to
// bf16 to nearest even (torch's cast).
template <typename T>
__global__ void __launch_bounds__(256)
    pack_train_blob_kernel(const __grid_constant__ PackArgs a,
                           unsigned char* __restrict__ blob) {
  constexpr long long GROUPS = blob_bytes(FWD_CHUNKS + DGRAD_CHUNKS) / 16;
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= GROUPS) return;
  const long long off = gi * 16;
  int c = 0;
  long long base = 0;
  while (base + chunk_bytes(c) <= off) base += chunk_bytes(c++);
  const int in = (int)(off - base);
  const int n = in >> 7, k8 = 8 * (((in >> 4) & 7) ^ (n & 7));
  // the source matrix and the (row, column) of k = 0
  int src, r, col;
  bool k_is_row;  // the forward's chunks run k down a column
  if (c < TRUNK_CHUNKS) {
    int layer = 0, first = 0;
    while (c >= first + layer_chunks(layer)) first += layer_chunks(layer++);
    src = layer, r = CHUNK_K * (c - first) + k8, col = n, k_is_row = true;
  } else if (c < FWD_CHUNKS) {
    src = LAYERS, r = CHUNK_K * (c - TRUNK_CHUNKS) + k8;
    col = n < 16 ? n : n + (MID - 16), k_is_row = true;
  } else {
    const int d = c - FWD_CHUNKS;
    src = dgrad_layer(d), r = dgrad_row0(d) + n;
    col = CHUNK_K * (d & 3) + k8, k_is_row = false;
  }
  const T* w = static_cast<const T*>(a.p[src]);
  const long long step = k_is_row ? a.s0[src] : a.s1[src];
  const T* w0 = w + r * a.s0[src] + col * a.s1[src];
  alignas(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (sizeof(T) == 4)
      v[e] = __float2bfloat16_rn(w0[e * step]);
    else
      v[e] = w0[e * step];
  }
  *reinterpret_cast<uint4*>(blob + off) = *reinterpret_cast<const uint4*>(v);
}

}  // namespace sm90
}  // namespace
