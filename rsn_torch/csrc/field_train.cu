// Field training kernels, for NVIDIA Hopper (sm_90a).
//
// Replaces seven Pallas TPU kernels:
//   field_forward_v6   (K3; rsn/kernels/field_pallas.py, body
//                       _field_kernel_halved_acts / _field_half): K1's
//                       forward at the train width (24 columns: the V3_*
//                       columns, d density_preact / d mean in 14:17 when
//                       the normals are wanted, the mid value in 17:20)
//                       plus the spill of the 8 post-ReLU trunk
//                       activations, (N, 2048) bf16, with the IPE tile x
//                       appended ((N, 2176)) under spill_x.  With the
//                       normals, the density head row is backpropagated
//                       through the 8 layers and the IPE in the same block.
//   field_forward_v4   (K7; field_pallas.py, _field_kernel_halved with
//                       the normals): K3 with the normals and no spill.
//                       Without the normals the same kernel is K1 at the
//                       train width (field_forward_v3 at its default
//                       V3_OUT store, which writes the mid value for the
//                       backward).  One body for the three forwards, so
//                       their outputs are equal bit for bit.
//   field_backward_v5  (K4; rsn/kernels/field_train.py, body _bwd_half):
//                       the backward from the spilled activations and the
//                       forward's stored output: dmc (N, 16), dg (R, 512)
//                       and the 20 packed-operand weight gradients.
//   field_backward_v6  (K5; _bwd_half with want_dmc=False): the same
//                       without the IPE backward, x read from the spill.
//   field_backward_v4  (K8; _bwd_kernel_impl(two_d=True, has_acts=False)):
//                       K4 with the trunk activations recomputed in the
//                       block instead of read from a spill.
//   field_forward_v5   (K10; field_pallas.py, _kernel_v5): K7 (with the
//                       normals) or K1 at the train width, with the next
//                       tile's IPE computed while this tile's trunk runs.
//   field_backward_v3  (K13; field_train.py, _bwd_kernel_impl(two_d=False)):
//                       K8 with whole-grid weight-gradient accumulators:
//                       the kernel returns the 20 gradients themselves.
//
// What bounds them on this card: about 2.2 MFLOP of bf16 products per
// sample row each, against 4.3 KB (K3 spill) or 4.4 KB (K4/K5 reads) of
// device memory per row: about 500 FLOP per byte, above the card's ~295,
// so the tensor cores are the limit.  In this first design the weight
// gradient accumulators are not: they live in device memory (one fp32
// slice of 2.4 MB per block), and every 64-row tile reads and writes its
// block's slice once, about 38 KB per row of traffic.
//
// What the design does about it (a first, simple design):
//   - The forward (K3) is K1's code: ipe_tile, trunk and v3_tail of
//     field_common.cuh, with a layer hook that stores each layer's tile to
//     the spill with 16-byte stores and, for the normals, keeps the ReLU
//     masks as bits (64 rows x 256 x 8 layers = 16 KB of shared memory).
//     The normals dgrad reuses the freed forward buffers: W^T is the same
//     bf16 weight read as a col_major fragment, no transposed copy.
//   - The backward (K4/K5) gives each block a run of whole rays, walked
//     in 64-row tiles.  Per-ray band gradients dg are summed in the block
//     (no one-hot matrix, no float atomics); weight gradients go to the
//     block's own fp32 slice of a (blocks, 608640) buffer, which the
//     wrapper reduces over blocks.  The result is the same from run to
//     run.
//   - Every product is nvcuda::wmma 16x16x16 bf16 -> fp32.  Dgrads are
//     computed for all 64 rows into registers, then written back over
//     their own input (one barrier), which keeps K5 at 100 KB of shared
//     memory (two blocks per SM); K4 adds the fp32 dx tile (132 KB).
//   - Roundings follow the TPU kernels: cotangents enter bf16, dpre is
//     rounded to bf16 before its products, bias gradients sum the fp32
//     values, the roughness -> attenuation edge carries no gradient.
//   - K8 (the recompute route, which keeps no (N, 2048) spill alive
//     between the forward and the backward): K4 reads layer i's tile
//     whenever its backward needs it, and a 64-row tile's eight bf16
//     layers (256 KB) do not fit the 227 KB of shared memory.  So each
//     block recomputes its tile's trunk with K3's code (ipe_tile, trunk
//     and K3's spill hook) into its own 64 x 2048 bf16 slot of a
//     workspace (one slot per block, not per row: ~34 MB at one block
//     per SM, within the 50 MB L2), and K4's body then reads that slot
//     unchanged.  The recompute equals K3's spill bit for bit (every row
//     is computed by the same code from the same inputs), and K8 uses
//     K4's rays-per-block partition, so K8 equals K4 on K3's spill bit
//     for bit.  The other simple design, 32-row tiles with all layers in
//     shared memory, would double the weight-gradient slice traffic per
//     row, which already bounds K4.
//   - K10 carries rsn's schedule over, not its two-slot VMEM buffer kept
//     across sequential grid steps: one persistent block per SM, whose four
//     producer warps write the next tile's IPE into one of two X slots
//     while its eight consumer warps run the current tile from the other,
//     handed over through named barriers.  The consumers run K7's code
//     (forward_train_tile) and the producers K7's ipe_tile, so K10 equals K7
//     and K1 at the train width bit for bit.  The normals' IPE backward
//     recomputes damp and u from mc, so only X is double-buffered (146 KB,
//     one block per SM).
//   - K13's whole-grid accumulators without float atomics: each block runs
//     K8's body into its own slice; a cooperative launch keeps every block
//     resident, so a grid-wide barrier on a counter can wait for all
//     slices, and the blocks then sum the columns over the slices in block
//     order.  dmc and dg equal K8's bit for bit (its partition); the
//     weight gradients differ from K8's (torch.sum over the slices) only by
//     the order of the fp32 sums, and are the same from run to run.
// Later work: keep the weight-gradient accumulators on chip (larger row
// tiles, or a split of the layers over blocks), wgmma, TMA.
#include "field_common.cuh"

namespace {

constexpr int OUT_TRAIN = 24;      // K3 store width
constexpr int ACTS_COLS = LAYERS * WIDTH;   // 2048
constexpr int XACTS_COLS = ACTS_COLS + ENC;  // 2176
constexpr int MASK_WORDS = WIDTH / 32;       // 8 words per row and layer

// the fp32 weight-gradient slice of one block: the packed operands in
// order w0..w7, b0..b7, w_hc, b_hc, w_out, b_out
// (rows: 128 for w0, 384 for w4, 256 for the others)
__host__ __device__ constexpr int off_w(int i) {
  return i == 0 ? 0
                : ENC * WIDTH + (i - 1) * WIDTH * WIDTH +
                      (i > SKIP_AT ? ENC * WIDTH : 0);
}
constexpr int OFF_B = off_w(LAYERS);                 // 524288
constexpr int OFF_WHC = OFF_B + LAYERS * WIDTH;
constexpr int OFF_BHC = OFF_WHC + WIDTH * WIDTH;
constexpr int OFF_WOUT = OFF_BHC + WIDTH;
constexpr int OFF_BOUT = OFF_WOUT + MID * MID;
constexpr int PACK_FLOATS = OFF_BOUT + MID;          // 608640
static_assert(PACK_FLOATS == 608640, "packed-gradient layout");

// k-tiles / n-tiles of the fused heads+mid product that carry data:
// column tile 0 (the 11 head columns) and tiles 8..15 (the mid seed)
constexpr unsigned HC_TILES = 0xFF01u;
constexpr unsigned ALL_TILES = 0xFFFFu;

// ---- K3 ---------------------------------------------------------------

constexpr int OFF_MASKS = FWD_SMEM_BYTES;
constexpr int MASK_BYTES = LAYERS * TM * MASK_WORDS * 4;
constexpr int OFF_ROWOUT = OFF_MASKS + MASK_BYTES;
constexpr int K3_SMEM_BYTES = OFF_ROWOUT + TM * OUT_TRAIN * 2;
static_assert(OFF_MASKS % 32 == 0 && OFF_ROWOUT % 32 == 0, "alignment");

__device__ __forceinline__ bool mask_bit(const uint32_t* masks, int layer,
                                         int r, int c) {
  return (masks[(layer * TM + r) * MASK_WORDS + (c >> 5)] >> (c & 31)) & 1u;
}

// Copies rows [0, nv) of a (TM, ncols) bf16 shared tile to dst rows
// (stride ld), 16 bytes per thread and step.
__device__ void store_rows(bf16* dst, long long ld, const bf16* src,
                           int lds, int ncols, int nv) {
  const int q8 = ncols / 8;
  for (int e = threadIdx.x; e < TM * q8; e += THREADS) {
    const int r = e / q8, q = e % q8;
    if (r < nv)
      *reinterpret_cast<uint4*>(dst + r * ld + q * 8) =
          *reinterpret_cast<const uint4*>(src + r * lds + q * 8);
  }
}

// Loads rows [0, nv) of dst (TM, ncols) from src rows (stride ld); rows
// nv.. are zero.
__device__ void load_rows(bf16* dst, int ldd, const bf16* src, long long ld,
                          int ncols, int nv) {
  const int q8 = ncols / 8;
  for (int e = threadIdx.x; e < TM * q8; e += THREADS) {
    const int r = e / q8, q = e % q8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nv) v = *reinterpret_cast<const uint4*>(src + r * ld + q * 8);
    *reinterpret_cast<uint4*>(dst + r * ldd + q * 8) = v;
  }
}

// K3's trunk hook: each layer's tile to the spill, and its ReLU mask bits.
struct SpillHook {
  bf16* acts;          // row row0 of the spill; nullptr: no spill (K7)
  int ld;              // 2048 or 2176
  int nv;              // valid rows of the tile
  uint32_t* masks;     // nullptr: no normals
  __device__ void operator()(int i, const bf16* H) const {
    if (acts != nullptr) store_rows(acts + i * WIDTH, ld, H, LDH, WIDTH, nv);
    if (masks == nullptr) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp * (TM / WARPS); r < (warp + 1) * (TM / WARPS); ++r)
      for (int w = 0; w < MASK_WORDS; ++w) {
        const bool on = __bfloat162float(H[r * LDH + w * 32 + lane]) > 0.f;
        const unsigned bits = __ballot_sync(0xffffffffu, on);
        if (lane == 0) masks[(i * TM + r) * MASK_WORDS + w] = bits;
      }
  }
};

// ---- products shared by the normals dgrad and the backward -------------

// acc = D @ W^T for the warp's NF column tiles starting at column
// c0 + warp * 16 * NF of W's rows (the layer's input dims): D is the
// (TM, 256) bf16 tile in shared memory, W the (in, 256) row-major bf16
// weight in global memory, read as a col_major fragment.  Only the
// k-tiles set in kmask are visited (the others are zero in D).
template <int NF>
__device__ void dgrad_mma(const bf16* D, const bf16* __restrict__ W, int c0,
                          unsigned kmask, FragC (&acc)[4][NF]) {
  const int warp = threadIdx.x >> 5;
  const int cw = c0 + warp * 16 * NF;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int kt = 0; kt < WIDTH / 16; ++kt) {
    if (!((kmask >> kt) & 1u)) continue;
    FragBT b[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::load_matrix_sync(b[j], W + (cw + j * 16) * WIDTH + kt * 16,
                             WIDTH);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, D + i * 16 * LDH + kt * 16, LDH);
#pragma unroll
      for (int j = 0; j < NF; ++j) wmma::mma_sync(acc[i][j], a, b[j],
                                                  acc[i][j]);
    }
  }
}

// Hands every element of the warp's accumulators to epi(r, c, v), which
// returns the value to add to column c's sum; colsum(c, s) then receives
// the column sums over the 64 rows (fixed order: each lane owns one
// column of a fragment).
template <int NF, typename Epi, typename ColSum>
__device__ void drain(FragC (&acc)[4][NF], int c0, float* stage,
                      const Epi& epi, const ColSum& colsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = c0 + warp * 16 * NF;
  float* st = stage + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int c = cw + j * 16 + (lane & 15);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int t = 0; t < 8; ++t) {
        const int rr = (lane >> 4) + 2 * t;
        part += epi(i * 16 + rr, c, st[rr * LDS + (lane & 15)]);
      }
      __syncwarp();
    }
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 16));
    if (lane < 16) colsum(c, part);
  }
}

struct NoColSum {
  __device__ void operator()(int, float) const {}
};

// Adds into a global fp32 bias slice.
struct BiasSum {
  float* b;
  __device__ void operator()(int c, float s) const { b[c] += s; }
};

// dW[m][n] += sum_{k < TM} A[k][m] * B[k][n] for m < M and the n-tiles in
// nmask: A (TM, M) bf16 in shared memory (stride lda), B (TM, 256) bf16 in
// shared memory (stride LDH), dW (M, 256) fp32 row-major in the block's
// gradient slice.  Warp w takes the 16-row strips m = w, w + 8, ...
__device__ void wgrad_acc(const bf16* A, int lda, int M, const bf16* B,
                          unsigned nmask, float* dW) {
  const int warp = threadIdx.x >> 5;
  for (int mt = warp; mt < M / 16; mt += WARPS) {
    FragAT a[TM / 16];
#pragma unroll
    for (int kt = 0; kt < TM / 16; ++kt)
      wmma::load_matrix_sync(a[kt], A + kt * 16 * lda + mt * 16, lda);
    for (int nt = 0; nt < WIDTH / 16; ++nt) {
      if (!((nmask >> nt) & 1u)) continue;
      float* dst = dW + mt * 16 * WIDTH + nt * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, dst, WIDTH, wmma::mem_row_major);
#pragma unroll
      for (int kt = 0; kt < TM / 16; ++kt) {
        FragB b;
        wmma::load_matrix_sync(b, B + kt * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(acc, a[kt], b, acc);
      }
      wmma::store_matrix_sync(dst, acc, WIDTH, wmma::mem_row_major);
    }
  }
}

// ---- K3 / K7 / K1 at the train width -----------------------------------

// The train-width forward of the 64-row tile at row0, whose IPE X already
// holds (visible to every thread of the routines); SPILL: K3's activation
// spill (acts), else none (K7, K10, and K1 at the train width without the
// normals).  Reads X only in the trunk.
template <bool NORMALS, bool SPILL, bool SPILL_X>
__device__ void forward_train_tile(const float* __restrict__ mc,
                                   const float* __restrict__ g,
                                   const float* __restrict__ consts,
                                   const V3Params& p,
                                   const float* __restrict__ wd_row,
                                   bf16* __restrict__ out,
                                   bf16* __restrict__ acts, long long n,
                                   int S, long long row0, const bf16* X) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + OFF_MASKS);
  bf16* rowout = reinterpret_cast<bf16*>(smem + OFF_ROWOUT);
  const int tid = threadIdx.x;
  const int nv = (int)min((long long)TM, n - row0);
  constexpr int ld = SPILL_X ? XACTS_COLS : ACTS_COLS;
  bf16* acts_tile = SPILL ? acts + row0 * ld : nullptr;

  if (SPILL && SPILL_X) store_rows(acts_tile + ACTS_COLS, ld, X, LDX, ENC, nv);
  SpillHook hook{acts_tile, ld, nv, NORMALS ? masks : nullptr};
  bf16* H = trunk(p.trunk, X, H0, H1, stage, hook);
  v3_tail<OUT_TRAIN>(p, H, smem, g, row0, n, S, rowout);

  if (NORMALS) {
    // d density_preact / d mean: dh = wd_row, then through the 8 layers
    // (dpre = bf16(dh * relu mask), dinp = dpre @ W^T) and the IPE.
    bf16* D = H0;                                  // dpre, in place
    float* dxe = reinterpret_cast<float*>(H1);     // (TM, 128) dx tile
    for (int e = tid; e < TM * WIDTH; e += THREADS) {
      const int r = e / WIDTH, c = e % WIDTH;
      D[r * LDH + c] = __float2bfloat16_rn(
          mask_bit(masks, LAYERS - 1, r, c) ? wd_row[c] : 0.f);
    }
    block_sync();
    for (int i = LAYERS - 1; i >= 0; --i) {
      const bf16* W = p.trunk.w[i];
      if (i == 0 || i == SKIP_AT) {  // the x part: dx (layer 0) or its
        FragC acc[4][1];             // skip share (layer 4)
        dgrad_mma<1>(D, W, 0, ALL_TILES, acc);
        const bool first = i == SKIP_AT;
        drain<1>(acc, 0, stage, [&](int r, int c, float v) {
          float* d = dxe + r * ENC + c;
          *d = first ? v : __fadd_rn(v, *d);
          return 0.f;
        }, NoColSum());
      }
      if (i > 0) {
        const int c0 = i == SKIP_AT ? ENC : 0;
        FragC acc[4][2];
        dgrad_mma<2>(D, W, c0, ALL_TILES, acc);
        block_sync();  // every warp's reads of D are done
        drain<2>(acc, c0, stage, [&](int r, int c, float v) {
          const int h = c - c0;
          const float m = mask_bit(masks, i - 1, r, h) ? v : 0.f;
          D[r * LDH + h] = __float2bfloat16_rn(m);
          return 0.f;
        }, NoColSum());
      }
      block_sync();
    }
    // IPE backward of the mean: dx * damp * cos (the sin and cos halves)
    // times 2 pi f_k, plus the identity columns 96..98
    if (tid < TM * 3) {
      const int r = tid / 3, d = tid % 3;
      const long long row = row0 + r;
      if (row < n) {
        const float* m = mc + row * IN_COLS;
        float s = 0.f;
        for (int half = 0; half < 2; ++half)
          for (int k = 0; k < NFREQ; ++k) {
            const int c = half * 48 + d * NFREQ + k;
            float damp, u;
            ipe_phase(m, consts, c, &damp, &u);
            const float dpre = __fmul_rn(dxe[r * ENC + c],
                                         __fmul_rn(damp, cos2pi(u)));
            s = __fmaf_rn(dpre, consts[k], s);
          }
        s = __fadd_rn(s, dxe[r * ENC + 96 + d]);
        rowout[r * OUT_TRAIN + 14 + d] = __float2bfloat16_rn(s);
      }
    }
    block_sync();
  }
  store_rows(out + row0 * OUT_TRAIN, OUT_TRAIN, rowout, OUT_TRAIN,
             OUT_TRAIN, nv);
}

// The block's own tile: its IPE into X, then forward_train_tile.
template <bool NORMALS, bool SPILL, bool SPILL_X>
__device__ void field_forward_train_body(const float* __restrict__ mc,
                                         const float* __restrict__ g,
                                         const float* __restrict__ consts,
                                         const V3Params& p,
                                         const float* __restrict__ wd_row,
                                         bf16* __restrict__ out,
                                         bf16* __restrict__ acts,
                                         long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + OFF_X);
  const long long row0 = (long long)blockIdx.x * TM;
  ipe_tile(mc, consts, row0, n, X);
  block_sync();
  forward_train_tile<NORMALS, SPILL, SPILL_X>(mc, g, consts, p, wd_row, out,
                                              acts, n, S, row0, X);
}

template <bool NORMALS, bool SPILL_X>
__global__ void __launch_bounds__(THREADS, 2)
    field_forward_v6_kernel(const float* __restrict__ mc,
                            const float* __restrict__ g,
                            const float* __restrict__ consts, V3Params p,
                            const float* __restrict__ wd_row,
                            bf16* __restrict__ out, bf16* __restrict__ acts,
                            long long n, int S) {
  field_forward_train_body<NORMALS, true, SPILL_X>(mc, g, consts, p, wd_row,
                                                   out, acts, n, S);
}

template <bool NORMALS>
__global__ void __launch_bounds__(THREADS, 2)
    field_forward_v4_kernel(const float* __restrict__ mc,
                            const float* __restrict__ g,
                            const float* __restrict__ consts, V3Params p,
                            const float* __restrict__ wd_row,
                            bf16* __restrict__ out, long long n, int S) {
  field_forward_train_body<NORMALS, false, false>(mc, g, consts, p, wd_row,
                                                  out, nullptr, n, S);
}

// ---- K10: K7 / K1 at the train width, the next tile's IPE ahead ---------

// A persistent block (one per SM) walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...  Its THREADS consumer threads run each tile
// with K7's code (forward_train_tile) from one of two X slots, while
// PRODUCERS producer threads fill the other slot with the next tile's IPE
// (ipe_tile, the same routine and arithmetic as K7's).  Hand-off through
// named barriers over all K10_THREADS threads: FULL(s) (producers arrive
// after writing slot s, consumers wait) and EMPTY(s) (consumers arrive
// after a tile, producers wait before refilling its slot two tiles on).
constexpr int PRODUCERS = 128;
constexpr int K10_THREADS = THREADS + PRODUCERS;
constexpr int OFF_SLOTS = K3_SMEM_BYTES;
constexpr int K10_SMEM_BYTES = OFF_SLOTS + 2 * X_BYTES;
static_assert(OFF_SLOTS % 32 == 0 && X_BYTES % 32 == 0, "alignment");
constexpr int BAR_FULL = 2, BAR_EMPTY = 4;  // + slot; 1 is block_sync()

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(K10_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(K10_THREADS) : "memory");
}

template <bool NORMALS>
__global__ void __launch_bounds__(K10_THREADS, 1)
    field_forward_v5_kernel(const float* __restrict__ mc,
                            const float* __restrict__ g,
                            const float* __restrict__ consts, V3Params p,
                            const float* __restrict__ wd_row,
                            bf16* __restrict__ out, long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long tiles = (n + TM - 1) / TM;  // > blockIdx.x
  const long long count = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto slot = [&](long long j) {
    return reinterpret_cast<bf16*>(smem + OFF_SLOTS + (j & 1) * X_BYTES);
  };
  auto row0 = [&](long long j) {
    return (blockIdx.x + j * gridDim.x) * (long long)TM;
  };
  if (threadIdx.x >= THREADS) {  // producers
    for (long long j = 0; j < count; ++j) {
      if (j >= 2) bar_wait(BAR_EMPTY + (int)(j & 1));
      ipe_tile(mc, consts, row0(j), n, slot(j), threadIdx.x - THREADS,
               PRODUCERS);
      __threadfence_block();
      bar_arrive(BAR_FULL + (int)(j & 1));
    }
    return;
  }
  for (long long j = 0; j < count; ++j) {
    bar_wait(BAR_FULL + (int)(j & 1));
    forward_train_tile<NORMALS, false, false>(mc, g, consts, p, wd_row, out,
                                              nullptr, n, S, row0(j),
                                              slot(j));
    block_sync();  // the next tile rewrites H0, H1, the masks and rowout
    if (j + 2 < count) bar_arrive(BAR_EMPTY + (int)(j & 1));
  }
}

// ---- K4 / K5 -----------------------------------------------------------

constexpr int RF = 24;  // per-row scalars: [0:4) atten, [4:7) dz3,
                        // [7:10) bf16(dz3), [10:21) d heads (FH_* order)
constexpr int OFF_D = 0;
constexpr int OFF_INP = OFF_D + H_BYTES;
constexpr int OFF_BX = OFF_INP + H_BYTES;
constexpr int OFF_ROWF = OFF_BX + X_BYTES;
constexpr int OFF_MBITS = OFF_ROWF + TM * RF * 4;
constexpr int OFF_BSTAGE = OFF_MBITS + TM * (MID / 32) * 4;
constexpr int OFF_DXE = OFF_BSTAGE + STAGE_BYTES;
constexpr int K5_SMEM_BYTES = OFF_DXE;
constexpr int K4_SMEM_BYTES = OFF_DXE + TM * ENC * 4;
static_assert(OFF_ROWF % 32 == 0 && OFF_MBITS % 32 == 0 &&
              OFF_BSTAGE % 32 == 0 && OFF_DXE % 32 == 0, "alignment");

struct BwdArgs {
  const float* mc;      // (N, 16) f32, K4 and K8
  const float* g;       // (R, 512) f32
  const float* consts;  // IPE constants, K4 and K8
  const bf16* acts;     // (N, 2048) K4 or (N, 2176) K5; K8: none
  const bf16* dout;     // (N, 24) bf16 cotangent of the forward's output
  const bf16* fout;     // (N, 24) bf16, the forward's output
  float* dmc;           // (N, 16) f32, K4 and K8
  float* dg;            // (R, 512) f32, zeroed by the caller
  float* dpk;           // (blocks, PACK_FLOATS) f32, zeroed by the caller
  bf16* ws;             // K8: (blocks, TM, 2048) bf16 recompute slots
  long long rays;
  int S;
  int rays_per_block;
};

// K4 (WANT_DMC), K5, and with RECOMPUTE (K8) K4 on activations that the
// block recomputes per tile into its workspace slot.
template <bool WANT_DMC, bool RECOMPUTE>
__device__ void field_backward_body(const V3Params& p, const BwdArgs& a) {
  static_assert(WANT_DMC || !RECOMPUTE, "K8 computes dmc");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* D = reinterpret_cast<bf16*>(smem + OFF_D);
  bf16* INP = reinterpret_cast<bf16*>(smem + OFF_INP);
  bf16* X = reinterpret_cast<bf16*>(smem + OFF_BX);
  float* rowf = reinterpret_cast<float*>(smem + OFF_ROWF);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + OFF_MBITS);
  float* stage = reinterpret_cast<float*>(smem + OFF_BSTAGE);
  float* dxe = reinterpret_cast<float*>(smem + OFF_DXE);  // K4 only
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = a.S;
  constexpr int ld = WANT_DMC ? ACTS_COLS : XACTS_COLS;

  const long long ray0 = (long long)blockIdx.x * a.rays_per_block;
  const long long ray1 = min(a.rays, ray0 + a.rays_per_block);
  const long long rowA = ray0 * S, rowB = ray1 * S;
  float* grp = a.dpk + (long long)blockIdx.x * PACK_FLOATS;

  for (long long row0 = rowA; row0 < rowB; row0 += TM) {
    const int nv = (int)min((long long)TM, rowB - row0);
    bf16* slot = RECOMPUTE ? a.ws + (long long)blockIdx.x * TM * ld : nullptr;
    const bf16* acts = RECOMPUTE ? slot : a.acts + row0 * ld;

    // ---- K8: the tile's trunk forward again, K3's code, into the slot
    // (D and INP serve as the two activation buffers, BSTAGE as stage) ----
    if (RECOMPUTE) {
      ipe_tile(a.mc, a.consts, row0, rowB, X);
      block_sync();
      trunk(p.trunk, X, D, INP, stage, SpillHook{slot, ld, nv, nullptr});
    }

    // ---- loads: hs7, x, per-row scalars ----
    load_rows(INP, LDH, acts + (LAYERS - 1) * WIDTH, ld, WIDTH, nv);
    if (WANT_DMC && !RECOMPUTE)
      ipe_tile(a.mc, a.consts, row0, rowB, X);
    else if (!WANT_DMC)
      load_rows(X, LDX, acts + ACTS_COLS, ld, ENC, nv);
    for (int e = tid; e < TM * (MID / 32); e += THREADS) mbits[e] = 0u;
    if (tid < TM) {
      float* rf = rowf + tid * RF;
      for (int i = 0; i < RF; ++i) rf[i] = 0.f;
      if (tid < nv) {
        const bf16* fo = a.fout + (row0 + tid) * OUT_TRAIN;
        const bf16* dq = a.dout + (row0 + tid) * OUT_TRAIN;
        float dout[14];
        for (int i = 0; i < 14; ++i) dout[i] = __bfloat162float(dq[i]);
        const float sp = softplusf(__bfloat162float(fo[13]));
        for (int b = 0; b < 4; ++b) rf[b] = expf(__fmul_rn(-sp, band_k(b)));
        for (int i = 0; i < 3; ++i) {
          const float diff = __bfloat162float(fo[3 + i]);
          const float tint = __bfloat162float(fo[6 + i]);
          const float mid = __bfloat162float(fo[17 + i]);
          const float dmid_out = dout[i];
          const float ddiff = __fadd_rn(dmid_out, dout[3 + i]);
          const float dtint = __fadd_rn(__fmul_rn(dmid_out, mid), dout[6 + i]);
          const float dmid = __fmul_rn(dmid_out, tint);
          const float dz = __fmul_rn(__fmul_rn(dmid, mid), __fsub_rn(1.f, mid));
          rf[4 + i] = dz;
          rf[7 + i] = __bfloat162float(__float2bfloat16_rn(dz));
          rf[10 + 1 + i] = __fmul_rn(__fmul_rn(ddiff, diff),
                                     __fsub_rn(1.f, diff));
          rf[10 + 4 + i] = __fmul_rn(__fmul_rn(dtint, tint),
                                     __fsub_rn(1.f, tint));
          rf[10 + 8 + i] = dout[9 + i];
        }
        rf[10 + 0] = dout[12];
        rf[10 + 7] = dout[13];
      }
    }
    block_sync();

    // ---- mid seed recompute: hmid into D[:, 0:128], mid_pre > 0 bits ----
    {
      FragC acc[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i][0], 0.f);
      for (int kt = 0; kt < WIDTH / 16; ++kt) {
        FragB b;
        wmma::load_matrix_sync(b, p.w_hc + kt * 16 * WIDTH + MID + warp * 16,
                               WIDTH);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, INP + i * 16 * LDH + kt * 16, LDH);
          wmma::mma_sync(acc[i][0], fa, b, acc[i][0]);
        }
      }
      drain<1>(acc, 0, stage, [&](int r, int c, float v) {
        float m = __fadd_rn(v, p.b_hc[MID + c]);
        if (r < nv) {
          const float* gr = a.g + ((row0 + r) / S) * G_COLS + c;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            m = __fadd_rn(m, __fmul_rn(rowf[r * RF + b], gr[b * MID]));
        }
        D[r * LDH + c] = __float2bfloat16_rn(relu_keep_nan(m));
        if (m > 0.f) atomicOr(&mbits[r * (MID / 32) + (c >> 5)],
                              1u << (c & 31));
        return 0.f;
      }, NoColSum());
    }
    block_sync();

    // ---- mid head: w_out / b_out gradients; dmid_pre, dg, b_hc[128:] ----
    for (int e = tid; e < MID * 3 + 3; e += THREADS) {
      if (e < MID * 3) {  // dW_out[c][j] = sum_r hmid[r][c] * bf16(dz)[r][j]
        const int c = e / 3, j = e % 3;
        float s = 0.f;
        for (int r = 0; r < TM; ++r)
          s = __fmaf_rn(__bfloat162float(D[r * LDH + c]), rowf[r * RF + 7 + j],
                        s);
        grp[OFF_WOUT + c * MID + j] += s;
      } else {
        const int j = e - MID * 3;
        float s = 0.f;
        for (int r = 0; r < TM; ++r) s = __fadd_rn(s, rowf[r * RF + 4 + j]);
        grp[OFF_BOUT + j] += s;
      }
    }
    if (tid < MID) {
      const int c = tid;
      const float w0 = __bfloat162float(p.w_out[c * MID + 0]);
      const float w1 = __bfloat162float(p.w_out[c * MID + 1]);
      const float w2 = __bfloat162float(p.w_out[c * MID + 2]);
      float bias = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
      long long ray_cur = -1;
      for (int r = 0; r < TM; ++r) {
        float v = 0.f;
        if (r < nv && ((mbits[r * (MID / 32) + (c >> 5)] >> (c & 31)) & 1u)) {
          const float* dz = rowf + r * RF + 7;
          v = __fmaf_rn(dz[2], w2, __fmaf_rn(dz[1], w1, __fmul_rn(dz[0], w0)));
        }
        D[r * LDH + MID + c] = __float2bfloat16_rn(v);
        if (r >= nv) continue;
        bias = __fadd_rn(bias, v);
        const long long ray = (row0 + r) / S;
        if (ray != ray_cur) {
          if (ray_cur >= 0)
            for (int b = 0; b < 4; ++b) a.dg[ray_cur * G_COLS + b * MID + c] +=
                acc[b];
          ray_cur = ray;
          for (int b = 0; b < 4; ++b) acc[b] = 0.f;
        }
        for (int b = 0; b < 4; ++b)
          acc[b] = __fmaf_rn(rowf[r * RF + b], v, acc[b]);
      }
      if (ray_cur >= 0)
        for (int b = 0; b < 4; ++b)
          a.dg[ray_cur * G_COLS + b * MID + c] += acc[b];
      grp[OFF_BHC + MID + c] += bias;
    }
    block_sync();

    // ---- the head columns of d_hc into D[:, 0:16] ----
    for (int e = tid; e < TM * 16; e += THREADS) {
      const int r = e / 16, c = e % 16;
      D[r * LDH + c] = __float2bfloat16_rn(c < 11 ? rowf[r * RF + 10 + c] : 0.f);
    }
    if (tid < 11) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s = __fadd_rn(s, rowf[r * RF + 10 + tid]);
      grp[OFF_BHC + tid] += s;
    }
    block_sync();

    // ---- heads + mid: dW_hc += hs7^T d_hc; dh7 = d_hc w_hc^T ----
    wgrad_acc(INP, LDH, WIDTH, D, HC_TILES, grp + OFF_WHC);
    {
      FragC acc[4][2];
      dgrad_mma<2>(D, p.w_hc, 0, HC_TILES, acc);
      block_sync();
      drain<2>(acc, 0, stage, [&](int r, int c, float v) {
        const float m =
            (r < nv && __bfloat162float(INP[r * LDH + c]) > 0.f) ? v : 0.f;
        D[r * LDH + c] = __float2bfloat16_rn(m);
        return m;
      }, BiasSum{grp + OFF_B + (LAYERS - 1) * WIDTH});
    }
    block_sync();

    // ---- trunk: D holds dpre_i; INP gets layer i's input hs_{i-1} ----
    for (int i = LAYERS - 1; i >= 0; --i) {
      if (i > 0) {
        load_rows(INP, LDH, acts + (i - 1) * WIDTH, ld, WIDTH, nv);
        block_sync();
      }
      float* dW = grp + off_w(i);
      if (i == 0 || i == SKIP_AT) wgrad_acc(X, LDX, ENC, D, ALL_TILES, dW);
      if (i > 0)
        wgrad_acc(INP, LDH, WIDTH, D, ALL_TILES,
                  i == SKIP_AT ? dW + ENC * WIDTH : dW);
      const bf16* W = p.trunk.w[i];
      if (WANT_DMC && (i == 0 || i == SKIP_AT)) {
        FragC acc[4][1];
        dgrad_mma<1>(D, W, 0, ALL_TILES, acc);
        const bool first = i == SKIP_AT;
        drain<1>(acc, 0, stage, [&](int r, int c, float v) {
          float* d = dxe + r * ENC + c;
          *d = first ? v : __fadd_rn(v, *d);
          return 0.f;
        }, NoColSum());
      }
      if (i > 0) {
        const int c0 = i == SKIP_AT ? ENC : 0;
        FragC acc[4][2];
        dgrad_mma<2>(D, W, c0, ALL_TILES, acc);
        block_sync();  // wgrad and dgrad reads of D are done
        drain<2>(acc, c0, stage, [&](int r, int c, float v) {
          const int h = c - c0;
          const float m =
              (r < nv && __bfloat162float(INP[r * LDH + h]) > 0.f) ? v : 0.f;
          D[r * LDH + h] = __float2bfloat16_rn(m);
          return m;
        }, BiasSum{grp + OFF_B + (i - 1) * WIDTH - c0});
      }
      block_sync();
    }

    // ---- IPE backward (K4): dmc = dpre_enc A^T + dvar V^T ----
    if (WANT_DMC) {
      for (int e = tid; e < TM * IN_COLS; e += THREADS) {
        const int r = e / IN_COLS, col = e % IN_COLS;
        if (r >= nv) continue;
        const long long row = row0 + r;
        float s = 0.f;
        if (col < 6) {
          const float* m = a.mc + row * IN_COLS;
          const int d = col % 3;
          const bool var = col >= 3;
          for (int half = 0; half < 2; ++half)
            for (int k = 0; k < NFREQ; ++k) {
              const int c = half * 48 + d * NFREQ + k;
              float damp, u;
              ipe_phase(m, a.consts, c, &damp, &u);
              const float dx = dxe[r * ENC + c];
              const float t = var
                  ? __fmul_rn(__fmul_rn(__fmul_rn(dx, -0.5f), damp), sin2pi(u))
                  : __fmul_rn(dx, __fmul_rn(damp, cos2pi(u)));
              s = __fmaf_rn(t, a.consts[(var ? NFREQ : 0) + k], s);
            }
          if (!var) s = __fadd_rn(s, dxe[r * ENC + 96 + d]);
        }
        a.dmc[row * IN_COLS + col] = s;
      }
      block_sync();
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v5_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, false>(p, a);
}

__global__ void __launch_bounds__(THREADS, 2)
    field_backward_v6_kernel(V3Params p, BwdArgs a) {
  field_backward_body<false, false>(p, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v4_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, true>(p, a);
}

// K13: K8's body, then the weight gradients summed over the blocks' slices
// in the kernel.  Launched cooperatively (every block resident), so a
// grid-wide barrier on the zeroed counter `arrived` can wait for every
// slice; then each thread sums its columns over the slices in block order
// (a fixed order, no float atomics) into grads (608640 floats, the packed
// operands' shapes in order).
__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v3_kernel(V3Params p, BwdArgs a, float* __restrict__ grads,
                             unsigned* arrived) {
  field_backward_body<true, true>(p, a);
  __threadfence();  // this thread's slice, dmc and dg writes, device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(arrived, 1u);
    while (atomicAdd(arrived, 0u) < gridDim.x) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
  for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
       c < PACK_FLOATS; c += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b)
      s = __fadd_rn(s, __ldcg(a.dpk + (long long)b * PACK_FLOATS + c));
    grads[c] = s;
  }
}

unsigned grid_for(long long n) { return (unsigned)((n + TM - 1) / TM); }

template <bool NORMALS, bool SPILL_X>
int launch_v6(const float* mc, const float* g, const float* consts,
              const V3Params& p, const float* wd_row, bf16* out, bf16* acts,
              long long n, int S, cudaStream_t stream) {
  auto kernel = field_forward_v6_kernel<NORMALS, SPILL_X>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(n), THREADS, K3_SMEM_BYTES, stream>>>(
      mc, g, consts, p, wd_row, out, acts, n, S);
  return (int)cudaGetLastError();
}

template <bool NORMALS>
int launch_v4(const float* mc, const float* g, const float* consts,
              const V3Params& p, const float* wd_row, bf16* out, long long n,
              int S, cudaStream_t stream) {
  auto kernel = field_forward_v4_kernel<NORMALS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(n), THREADS, K3_SMEM_BYTES, stream>>>(
      mc, g, consts, p, wd_row, out, n, S);
  return (int)cudaGetLastError();
}

template <bool NORMALS>
int launch_v5(const float* mc, const float* g, const float* consts,
              const V3Params& p, const float* wd_row, bf16* out, long long n,
              int S, cudaStream_t stream) {
  auto kernel = field_forward_v5_kernel<NORMALS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K10_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + TM - 1) / TM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, K10_THREADS, K10_SMEM_BYTES, stream>>>(mc, g, consts, p,
                                                        wd_row, out, n, S);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch_backward(Kernel kernel, int smem_bytes, const V3Params& p,
                    const BwdArgs& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)((a.rays + a.rays_per_block - 1) / a.rays_per_block);
  kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: w0..w7, b0..b7, w_hc, b_hc, w_out, b_out [, wd_row (1, 256) f32
// when want_normals] (device pointers).  out (N, 24) bf16, acts (N, 2048)
// or (N, 2176) with spill_x.  Returns a cudaError_t code (0 = launched).
int rsn_field_forward_v6(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* const* ptrs,
                         void* out, void* acts, long long n,
                         int samples_per_ray, int want_normals, int spill_x,
                         void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  const float* mc = static_cast<const float*>(mean_cov);
  const float* g = static_cast<const float*>(g_bands);
  const float* consts = static_cast<const float*>(ipe_consts);
  const float* wd_row =
      want_normals ? static_cast<const float*>(ptrs[20]) : nullptr;
  bf16* o = static_cast<bf16*>(out);
  bf16* s = static_cast<bf16*>(acts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals && spill_x)
    return launch_v6<true, true>(mc, g, consts, p, wd_row, o, s, n,
                                 samples_per_ray, st);
  if (want_normals)
    return launch_v6<true, false>(mc, g, consts, p, wd_row, o, s, n,
                                  samples_per_ray, st);
  if (spill_x)
    return launch_v6<false, true>(mc, g, consts, p, wd_row, o, s, n,
                                  samples_per_ray, st);
  return launch_v6<false, false>(mc, g, consts, p, wd_row, o, s, n,
                                 samples_per_ray, st);
}

// K7 (want_normals: ptrs carries wd_row as ptrs[20]) or K1 at the train
// width: K3's out (N, 24) bf16 without the spill.
int rsn_field_forward_v4(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* const* ptrs,
                         void* out, long long n, int samples_per_ray,
                         int want_normals, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  const float* mc = static_cast<const float*>(mean_cov);
  const float* g = static_cast<const float*>(g_bands);
  const float* consts = static_cast<const float*>(ipe_consts);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals)
    return launch_v4<true>(mc, g, consts, p,
                           static_cast<const float*>(ptrs[20]), o, n,
                           samples_per_ray, st);
  return launch_v4<false>(mc, g, consts, p, nullptr, o, n, samples_per_ray,
                          st);
}

// K4.  ptrs: the 20 packed operands.  dg and dpk must be zeroed; dpk has
// ceil(rays / rays_per_block) slices of 608640 floats.
int rsn_field_backward_v5(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* acts,
                          const void* d_out, const void* f_out,
                          const void* const* ptrs, void* dmc, void* dg,
                          void* dpk, long long rays, int samples_per_ray,
                          int rays_per_block, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts),
            static_cast<const bf16*>(acts), static_cast<const bf16*>(d_out),
            static_cast<const bf16*>(f_out), static_cast<float*>(dmc),
            static_cast<float*>(dg), static_cast<float*>(dpk), nullptr,
            rays, samples_per_ray, rays_per_block};
  return launch_backward(field_backward_v5_kernel, K4_SMEM_BYTES, p, a,
                         stream);
}

// K5: K4 without dmc; xacts (N, 2176) carries x.
int rsn_field_backward_v6(const void* g_bands, const void* xacts,
                          const void* d_out, const void* f_out,
                          const void* const* ptrs, void* dg, void* dpk,
                          long long rays, int samples_per_ray,
                          int rays_per_block, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{nullptr, static_cast<const float*>(g_bands), nullptr,
            static_cast<const bf16*>(xacts), static_cast<const bf16*>(d_out),
            static_cast<const bf16*>(f_out), nullptr,
            static_cast<float*>(dg), static_cast<float*>(dpk), nullptr,
            rays, samples_per_ray, rays_per_block};
  return launch_backward(field_backward_v6_kernel, K5_SMEM_BYTES, p, a,
                         stream);
}

// K8: K4 with no spill.  ws: ceil(rays / rays_per_block) slots of
// 64 x 2048 bf16 (uninitialised); dg and dpk as for K4.
int rsn_field_backward_v4(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* d_out,
                          const void* f_out, const void* const* ptrs,
                          void* dmc, void* dg, void* dpk, void* ws,
                          long long rays, int samples_per_ray,
                          int rays_per_block, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(dpk), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block};
  return launch_backward(field_backward_v4_kernel, K4_SMEM_BYTES, p, a,
                         stream);
}

// K10: K7 (want_normals: ptrs carries wd_row as ptrs[20]) or K1 at the
// train width, on a persistent grid with the next tile's IPE computed
// ahead; the same (N, 24) bf16 output, bit for bit.
int rsn_field_forward_v5(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* const* ptrs,
                         void* out, long long n, int samples_per_ray,
                         int want_normals, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  const float* mc = static_cast<const float*>(mean_cov);
  const float* g = static_cast<const float*>(g_bands);
  const float* consts = static_cast<const float*>(ipe_consts);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals)
    return launch_v5<true>(mc, g, consts, p,
                           static_cast<const float*>(ptrs[20]), o, n,
                           samples_per_ray, st);
  return launch_v5<false>(mc, g, consts, p, nullptr, o, n, samples_per_ray,
                          st);
}

// K13: K8's arguments, plus grads (608640 floats, written) and arrived (one
// zeroed unsigned).  dpk is K8's zeroed per-block workspace; the grid must
// fit the card at one block per SM (the cooperative launch checks it).
int rsn_field_backward_v3(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* d_out,
                          const void* f_out, const void* const* ptrs,
                          void* dmc, void* dg, void* dpk, void* ws,
                          void* grads, void* arrived, long long rays,
                          int samples_per_ray, int rays_per_block,
                          void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(dpk), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block};
  float* gr = static_cast<float*>(grads);
  unsigned* ar = static_cast<unsigned*>(arrived);
  cudaError_t err = cudaFuncSetAttribute(
      field_backward_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K4_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rays + rays_per_block - 1) /
                                   rays_per_block);
  void* args[] = {&p, &a, &gr, &ar};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(field_backward_v3_kernel), dim3(grid),
      dim3(THREADS), args, K4_SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
