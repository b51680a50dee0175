// Device routines shared by the field kernels (field_forward.cu: K1, K2,
// K11, K12; field_train.cu: K3, K4, K5, K7, K8 (with wgrad_sm90.cuh), K10,
// K13, K17;
// experiments.cu: K14, K15; experiments_bwd.cu: K18, K19).  Every kernel
// computes its IPE (K1's polynomial one, or K11's exact one) through
// ipe_rows (K1 and K2: ipe_sincos, the same operations on every element).
// Every kernel but K1, K2, K3, K7, K11, K12, K14 and K15 runs its trunk
// through trunk() / trunk_rows() (wmma, 64-row tiles), and K10 its V3 tail
// through v3_tail; K1, K2, K3, K7, K11, K12, K14 and K15 run the same sums
// on Hopper's wgmma (trunk_sm90.cuh, train_sm90.cuh, heads_sm90.cuh,
// unfolded_sm90.cuh), in the same k order and with the same epilogue
// arithmetic, so K2's density column and K3's column 12 equal K1's, K10's
// output K7's, and K11's, K12's, K14's and K15's their first design's, bit
// for bit.
//
// The routines run on THREADS threads (threadIdx.x < THREADS) and meet at
// block_sync(), named barrier 1 over THREADS threads: in a block of
// THREADS threads that is __syncthreads(), and K10's block adds producer
// warps (threadIdx.x >= THREADS) that never take it.  The *_rows variants
// run on a group of warps that owns a row sub-tile and meets at its own
// barrier (the two warp groups of K14's and K15's first design).
//
// Each .cu includes this header and is compiled on its own (one nvcc per
// source, run in parallel); everything here sits in an anonymous
// namespace, so the two libraries hold separate copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;          // sample rows per block tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 256;      // trunk width
constexpr int ENC = 128;        // IPE (99) zero-padded
constexpr int IPE_DIM = 99;
constexpr int SKIP_AT = 4;
constexpr int LAYERS = 8;
constexpr int IN_COLS = 16;
constexpr int G_COLS = 512;     // 4 SH bands x 128
constexpr int MID = 128;
constexpr int NFREQ = 16;

// shared-memory row strides: +8 bf16 (16 B) spreads rows over the banks
constexpr int LDH = WIDTH + 8;   // activations, bf16
constexpr int LDX = ENC + 8;     // IPE tile, bf16
constexpr int LDS = 20;          // per-warp f32 epilogue staging
constexpr int LDHC = 16 + MID;   // f32 [head columns 0..15 | mid seed]

constexpr int H_BYTES = TM * LDH * 2;
constexpr int X_BYTES = TM * LDX * 2;
constexpr int STAGE_BYTES = WARPS * 16 * LDS * 4;
// the forward layout (K1, K2, K3): [H0 | X | H1 | stage]
constexpr int OFF_H0 = 0;
constexpr int OFF_X = OFF_H0 + H_BYTES;  // H0 and X adjacent: the V3 tail
                                         // reuses both for the f32 HC tile
constexpr int OFF_H1 = OFF_X + X_BYTES;
constexpr int OFF_STAGE = OFF_H1 + H_BYTES;
constexpr int FWD_SMEM_BYTES = OFF_STAGE + STAGE_BYTES;
static_assert(TM * LDHC * 4 <= H_BYTES + X_BYTES, "HC tile must fit H0+X");
static_assert(OFF_X % 32 == 0 && OFF_H1 % 32 == 0 && OFF_STAGE % 32 == 0,
              "wmma needs 32-byte aligned tiles");
static_assert(TM * 8 * 4 <= STAGE_BYTES, "row scalars must fit the stage");

constexpr float HALF_PI = 1.57079637f;       // f32(pi / 2)
constexpr float INV_2PI = 0.159154943f;      // f32(1 / 2pi)
constexpr float HALF_LOG2E = 0.721347520f;   // f32(0.5 / ln 2)

struct TrunkParams {
  const bf16* w[LAYERS];   // (in, 256) row-major; in = 128, 384 at SKIP_AT
  const float* b[LAYERS];  // (256,)
};
struct V3Params {
  TrunkParams trunk;
  const bf16* w_hc;   // (256, 256): [heads (FH_* cols, padded) | w_comb]
  const float* b_hc;  // (256,)
  const bf16* w_out;  // (128, 128), 3 live columns
  const float* b_out;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// sin(2 pi u) for wrapped u in [-1/2, 1/2]: field_pallas._sin2pi's odd
// minimax polynomial (max err 4.5e-7)
__device__ __forceinline__ float sin2pi(float u) {
  const float w = __fmul_rn(u, u);
  float p = -12.2688402f;
  p = __fmaf_rn(p, w, 41.2037313f);
  p = __fmaf_rn(p, w, -76.5796851f);
  p = __fmaf_rn(p, w, 81.5961385f);
  p = __fmaf_rn(p, w, -41.3414194f);
  p = __fmaf_rn(p, w, 6.28318279f);
  return __fmul_rn(p, u);
}

// cos(2 pi u) for wrapped u in [-1/2, 1/2]: field_pallas._cos2pi's even
// polynomial (max err 3.3e-7)
__device__ __forceinline__ float cos2pi(float u) {
  const float w = __fmul_rn(u, u);
  float p = 6.52864918f;
  p = __fmaf_rn(p, w, -25.9675931f);
  p = __fmaf_rn(p, w, 60.1676294f);
  p = __fmaf_rn(p, w, -85.4501393f);
  p = __fmaf_rn(p, w, 64.9391175f);
  p = __fmaf_rn(p, w, -19.7392045f);
  return __fmaf_rn(p, w, 0.999999989f);
}

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// roughness attenuation exponents l(l+1)/2 of the SH bands l = 1, 2, 4, 8
__device__ __forceinline__ float band_k(int b) {
  return b == 0 ? 1.f : b == 1 ? 3.f : b == 2 ? 10.f : 36.f;
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v < 0.f ? 0.f : v;
}

// A phase in turns, wrapped to [-1/2, 1/2]: pre / 2 pi - rint(pre / 2 pi).
__device__ __forceinline__ float wrap_turns(float pre) {
  const float uu = __fmul_rn(pre, INV_2PI);
  return __fsub_rn(uu, rintf(uu));
}

// The IPE of one element: column c < 96 of row m = [mean(3) | cov(3)]:
// the damping exp(-f_k^2 var_d / 2) and the wrapped phase u of
// 2 pi f_k mean_d (+ pi/2 on the cos half [48, 96)), in turns.
// consts = [2 pi f_k (16) | f_k^2 (16)] as f32.
__device__ __forceinline__ void ipe_phase(const float* m,
                                          const float* __restrict__ consts,
                                          int c, float* damp, float* u) {
  const int cc = c % 48, d = cc / 16, k = cc % 16;
  float pre = __fmul_rn(m[d], consts[k]);
  if (c >= 48) pre = __fadd_rn(pre, HALF_PI);
  const float var = __fmul_rn(m[3 + d], consts[NFREQ + k]);
  *damp = exp2f(__fmul_rn(-HALF_LOG2E, var));
  *u = wrap_turns(pre);
}

// Both columns of one (d, k) at once, with one damping: *s = column
// 16 d + k, *c = column 48 + 16 d + k, each the same operations on the same
// operands as ipe_rows<false> (mean_d = m[d], cov_d = m[3 + d],
// sk = consts[k], vk = consts[NFREQ + k]).
__device__ __forceinline__ void ipe_sincos(float mean_d, float cov_d,
                                           float sk, float vk, float* s,
                                           float* c) {
  const float pre = __fmul_rn(mean_d, sk);
  const float damp = exp2f(__fmul_rn(-HALF_LOG2E, __fmul_rn(cov_d, vk)));
  *s = __fmul_rn(damp, sin2pi(wrap_turns(pre)));
  *c = __fmul_rn(damp, sin2pi(wrap_turns(__fadd_rn(pre, HALF_PI))));
}

// IPE of `rows` rows from row0 into X (rows x ENC bf16): cols [0, 48)
// damp * sin(2 pi f_k mean_d), [48, 96) the cos half, [96, 99) mean,
// [99, 128) zero.  Rows at or past n are zero.  Thread t0 + i of a group
// of nt threads computes elements i, i + nt, ...; each element's value
// does not depend on which thread computes it.
//   EXACT false (K1 and the kernels built on it): the wrapped phase and the
//     polynomial sine, damp = exp2(-var / (2 ln 2)).
//   EXACT true (K11's and K14's first design; their Hopper kernels compute
//     the same bits two threads a row, trunk_sm90.cuh's ipe_exact_wg; rsn's
//     _ipe_in_kernel): sinf of the fp32 phase
//     2 pi f_k mean_d (+ f32(pi / 2) on the cos half, not a cos) and
//     expf(-var / 2), with full range reduction (no fast-math intrinsics):
//     phases reach 2 pi 2^16 |mean| ~ 8e5 at the top octave.
template <bool EXACT>
__device__ void ipe_rows(const float* __restrict__ mc,
                         const float* __restrict__ consts, long long row0,
                         long long n, bf16* X, int t0, int nt, int rows) {
  for (int e = t0; e < rows * ENC; e += nt) {
    const int r = e / ENC, c = e % ENC;
    const long long row = row0 + r;
    float v = 0.f;
    if (row < n && c < IPE_DIM) {
      const float* m = mc + row * IN_COLS;
      if (c >= 96) {
        v = m[c - 96];
      } else if (EXACT) {
        const int cc = c % 48, d = cc / 16, k = cc % 16;
        float pre = __fmul_rn(m[d], consts[k]);
        if (c >= 48) pre = __fadd_rn(pre, HALF_PI);
        const float var = __fmul_rn(m[3 + d], consts[NFREQ + k]);
        v = __fmul_rn(expf(__fmul_rn(-0.5f, var)), sinf(pre));
      } else {
        float damp, u;
        ipe_phase(m, consts, c, &damp, &u);
        v = __fmul_rn(damp, sin2pi(u));
      }
    }
    X[r * LDX + c] = __float2bfloat16_rn(v);
  }
}

__device__ void ipe_tile(const float* __restrict__ mc,
                         const float* __restrict__ consts, long long row0,
                         long long n, bf16* X, int t0, int nt) {
  ipe_rows<false>(mc, consts, row0, n, X, t0, nt, TM);
}

__device__ void ipe_tile(const float* __restrict__ mc,
                         const float* __restrict__ consts, long long row0,
                         long long n, bf16* X) {
  ipe_tile(mc, consts, row0, n, X, threadIdx.x, THREADS);
}

// No hand-off around a warp's products (every kernel but K15's first
// design, whose two warp groups take turns on the tensor cores).
struct NoTurn {
  __device__ void begin() {}
  __device__ void end() {}
};

// One warp's part of a product on a tile of 16 RT rows:
//   acc = [A0 | A1] @ W[:, col0 : col0 + 16 CT],
// A0 (k0 columns, stride lda0) and A1 (k1 columns) in shared memory, W
// (k0 + k1 rows, stride ldw) bf16 row-major in global memory (L2-resident),
// each weight fragment read one k-step ahead of its use.  Then
// epi(r, c, v) for every element: r in [0, 16 RT), c the absolute column,
// v the fp32 sum; the fragments reach it through the warp's stage `st`.
// turn.begin() comes before the first product, turn.end() after the last.
// An element's sum does not depend on RT, CT or the warp computing it.
template <int RT, int CT, typename Turn, typename Epi>
__device__ void warp_product(const bf16* A0, int lda0, int k0,
                             const bf16* A1, int lda1, int k1,
                             const bf16* __restrict__ W, int ldw, int col0,
                             float* st, Turn& turn, const Epi& epi) {
  const int lane = threadIdx.x & 31;
  FragC acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int ksteps = (k0 + k1) / 16;
  FragB b[CT], bn[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j)
    wmma::load_matrix_sync(b[j], W + col0 + j * 16, ldw);
  turn.begin();
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {  // next k-step's weights, ahead of their use
      const bf16* wn = W + (ks + 1) * 16 * ldw + col0;
#pragma unroll
      for (int j = 0; j < CT; ++j)
        wmma::load_matrix_sync(bn[j], wn + j * 16, ldw);
    }
    const int kc = ks * 16;
    const bf16* A = kc < k0 ? A0 + kc : A1 + (kc - k0);
    const int lda = kc < k0 ? lda0 : lda1;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, A + i * 16 * lda, lda);
#pragma unroll
      for (int j = 0; j < CT; ++j)
        wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
    }
    if (ks + 1 < ksteps) {
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = bn[j];
    }
  }
  turn.end();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        epi(i * 16 + r, col0 + j * 16 + c, st[r * LDS + c]);
      }
      __syncwarp();
    }
  }
}

// One trunk layer on a tile of 16 RT rows, by the NW = 16 / CT warps of a
// group: Out = bf16(relu([A0 | A1] @ W + b)), W (k0 + k1, 256); warp w of
// the group computes output columns [16 CT w, 16 CT (w + 1)).
template <int RT, int CT, typename Turn>
__device__ void dense_relu_rows(const bf16* A0, int lda0, int k0,
                                const bf16* A1, int lda1, int k1,
                                const bf16* __restrict__ W,
                                const float* __restrict__ bias, bf16* Out,
                                int warp, float* st, Turn& turn) {
  warp_product<RT, CT>(
      A0, lda0, k0, A1, lda1, k1, W, WIDTH, warp * 16 * CT, st, turn,
      [&](int r, int c, float v) {
        Out[r * LDH + c] =
            __float2bfloat16_rn(relu_keep_nan(__fadd_rn(v, bias[c])));
      });
}

// Nothing to do after a trunk layer (the first designs of K11, K12, K14
// and K15).
struct NoLayerHook {
  __device__ void operator()(int, const bf16*) const {}
};

// block_sync() as a functor (the trunk's meeting point by default).
struct BlockSync {
  __device__ void operator()() const { block_sync(); }
};

// The trunk on the X tile of 16 RT rows, by the warps of a group (warp:
// its index in the group, st: its stage) that meet at sync(); returns the
// buffer holding the last layer's output.  After each layer (and a sync)
// `hook(i, out)` sees the layer's output tile; it must not write it.  Ends
// with sync(): the result is visible to every thread of the group.
template <int RT, int CT, typename Sync, typename Turn, typename Hook>
__device__ bf16* trunk_rows(const TrunkParams& p, const bf16* X, bf16* H0,
                            bf16* H1, int warp, float* st, const Sync& sync,
                            Turn& turn, const Hook& hook) {
  dense_relu_rows<RT, CT>(X, LDX, ENC, nullptr, 0, 0, p.w[0], p.b[0], H0,
                          warp, st, turn);
  sync();
  hook(0, H0);
  bf16* hin = H0;
  bf16* hout = H1;
  for (int i = 1; i < LAYERS; ++i) {
    if (i == SKIP_AT)
      dense_relu_rows<RT, CT>(X, LDX, ENC, hin, LDH, WIDTH, p.w[i], p.b[i],
                              hout, warp, st, turn);
    else
      dense_relu_rows<RT, CT>(nullptr, 0, 0, hin, LDH, WIDTH, p.w[i],
                              p.b[i], hout, warp, st, turn);
    sync();
    hook(i, hout);
    bf16* t = hin;
    hin = hout;
    hout = t;
  }
  sync();
  return hin;
}

// The trunk on the block's 64 rows by its 8 warps, meeting at block_sync().
template <typename Hook>
__device__ bf16* trunk(const TrunkParams& p, const bf16* X, bf16* H0,
                       bf16* H1, float* stage, const Hook& hook) {
  const int warp = threadIdx.x >> 5;
  NoTurn turn;
  return trunk_rows<4, 2>(p, X, H0, H1, warp, stage + warp * 16 * LDS,
                          BlockSync(), turn, hook);
}

// Density pre-activation of row threadIdx.x / 4: dot(h_row, w[:, 0]) + b.
// Four threads per row sum interleaved quarters in a fixed order, then
// combine with two xor shuffles; every thread of the row gets the value.
// K10 calls this; K1, K2, K3 and K7 (trunk_sm90.cuh, density_sw) take the
// same operands in the same order, which makes the density columns
// identical.
__device__ float density_row(const bf16* H, const bf16* __restrict__ w,
                             int wstride, float b) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float s = 0.f;
  for (int j = 0; j < WIDTH / 4; ++j) {
    const int k = 4 * j + q;
    s = __fmaf_rn(__bfloat162float(H[r * LDH + k]),
                  __bfloat162float(w[k * wstride]), s);
  }
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  return __fadd_rn(s, b);
}

// The V3 tail on the trunk output H of the block's rows (K10; K1, K3 and
// K7 run the same arithmetic in trunk_sm90.cuh's v3_tail_wg):
// heads + folded mid seed in one product, roughness attenuation against
// the per-ray SH band partials g, the mid head, and the row of OUTC bf16
// columns [mid_out | diff | tint | normals raw | density | rough raw |
// 0 0 0 | (OUTC >= 24: mid | 0 ...)] into dst + r * OUTC for rows
// r < n - row0.  Uses H0 + X (HC tile) and the stage; H is overwritten
// with hmid.  Starts and ends with the block in step.
template <int OUTC>
__device__ void v3_tail(const V3Params& p, bf16* H, unsigned char* smem,
                        const float* __restrict__ g, long long row0,
                        long long n, int S, bf16* dst) {
  static_assert(OUTC == 16 || OUTC == 24, "16 (eval) or 24 (train) cols");
  float* HC = reinterpret_cast<float*>(smem + OFF_H0);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5;

  // heads + mid seed: HC[:, 0:16] = H @ w_hc[:, 0:16] (warp w < 4 does
  // row tile w), HC[:, 16:144] = H @ w_hc[:, 128:256] (warp w: 16 cols).
  // Head columns 11..127 of w_hc are zero padding and are skipped.
  {
    FragC acc[4], acc_h;
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
    wmma::fill_fragment(acc_h, 0.f);
    for (int ks = 0; ks < WIDTH / 16; ++ks) {
      const bf16* wrow = p.w_hc + ks * 16 * WIDTH;
      FragB b, bh;
      wmma::load_matrix_sync(b, wrow + MID + warp * 16, WIDTH);
      if (warp < 4) wmma::load_matrix_sync(bh, wrow, WIDTH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA a;
        wmma::load_matrix_sync(a, H + i * 16 * LDH + ks * 16, LDH);
        wmma::mma_sync(acc[i], a, b, acc[i]);
        if (i == warp) wmma::mma_sync(acc_h, a, bh, acc_h);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(HC + i * 16 * LDHC + 16 + warp * 16, acc[i],
                              LDHC, wmma::mem_row_major);
    if (warp < 4)
      wmma::store_matrix_sync(HC + warp * 16 * LDHC, acc_h, LDHC,
                              wmma::mem_row_major);
  }
  block_sync();

  // per-row scalars in the stage area: [0:4) band attenuations,
  // [4] density pre-activation, [5:8) mid
  float* rowf = stage;
  const int r4 = tid >> 2;
  const float dens = density_row(H, p.w_hc, WIDTH, p.b_hc[0]);
  if ((tid & 3) == 0) {
    const float rough_raw = __fadd_rn(HC[r4 * LDHC + 7], p.b_hc[7]);
    const float sp = softplusf(rough_raw);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      rowf[r4 * 8 + b] = expf(__fmul_rn(-sp, band_k(b)));
    rowf[r4 * 8 + 4] = dens;
  }
  block_sync();  // also: every density_row read of H is done

  // hmid = bf16(relu(seed + b + sum_b atten_b * g_b[ray])) into H
  for (int e = tid; e < TM * MID; e += THREADS) {
    const int r = e / MID, c = e % MID;
    const long long row = row0 + r;
    float m = __fadd_rn(HC[r * LDHC + 16 + c], p.b_hc[MID + c]);
    if (row < n) {
      const float* gr = g + (row / S) * G_COLS + c;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        m = __fadd_rn(m, __fmul_rn(rowf[r * 8 + b], gr[b * MID]));
    }
    H[r * LDH + c] = __float2bfloat16_rn(relu_keep_nan(m));
  }
  block_sync();

  // mid = sigmoid(hmid @ w_out[:, 0:3] + b_out): one thread per (row, col)
  if (tid < TM * 3) {
    const int r = tid / 3, c = tid % 3;
    float s = 0.f;
    for (int k = 0; k < MID; ++k)
      s = __fmaf_rn(__bfloat162float(H[r * LDH + k]),
                    __bfloat162float(p.w_out[k * MID + c]), s);
    rowf[r * 8 + 5 + c] = sigmoidf(__fadd_rn(s, p.b_out[c]));
  }
  block_sync();

  // assemble the row
  if (tid < TM) {
    const long long row = row0 + tid;
    if (row < n) {
      const float* hc = HC + tid * LDHC;
      const float* rf = rowf + tid * 8;
      alignas(16) bf16 v[OUTC];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float diff = sigmoidf(__fadd_rn(hc[1 + i], p.b_hc[1 + i]));
        const float tint = sigmoidf(__fadd_rn(hc[4 + i], p.b_hc[4 + i]));
        v[i] = __float2bfloat16_rn(__fadd_rn(diff, __fmul_rn(tint, rf[5 + i])));
        v[3 + i] = __float2bfloat16_rn(diff);
        v[6 + i] = __float2bfloat16_rn(tint);
        v[9 + i] = __float2bfloat16_rn(__fadd_rn(hc[8 + i], p.b_hc[8 + i]));
      }
      v[12] = __float2bfloat16_rn(rf[4]);
      v[13] = __float2bfloat16_rn(__fadd_rn(hc[7], p.b_hc[7]));
#pragma unroll
      for (int i = 14; i < OUTC; ++i) v[i] = __float2bfloat16_rn(0.f);
      if (OUTC >= 24) {
#pragma unroll
        for (int i = 0; i < 3; ++i) v[17 + i] = __float2bfloat16_rn(rf[5 + i]);
      }
      uint4* out = reinterpret_cast<uint4*>(dst + tid * OUTC);
      const uint4* src = reinterpret_cast<const uint4*>(v);
#pragma unroll
      for (int i = 0; i < OUTC / 8; ++i) out[i] = src[i];
    }
  }
  block_sync();
}

// ---- the backward kernels' routines (field_train.cu: K3's normals, K4,
// K5, K8, K13, K17; experiments_bwd.cu: K18, K19) ------------------------

constexpr int ACTS_COLS = LAYERS * WIDTH;    // the spill: 8 layers, 2048
constexpr int XACTS_COLS = ACTS_COLS + ENC;  // with the IPE tile x, 2176
constexpr unsigned ALL_TILES = 0xFFFFu;

// the trunk's part of a block's fp32 weight-gradient slice: w0..w7 (rows:
// 128 for w0, 384 for w4, 256 for the others), then b0..b7
__host__ __device__ constexpr int off_w(int i) {
  return i == 0 ? 0
                : ENC * WIDTH + (i - 1) * WIDTH * WIDTH +
                      (i > SKIP_AT ? ENC * WIDTH : 0);
}
constexpr int OFF_B = off_w(LAYERS);                 // 524288

// Copies rows [0, nv) of a (ROWS, ncols) bf16 shared tile to dst rows
// (stride ld), 16 bytes per thread and step.
template <int ROWS = TM>
__device__ void store_rows(bf16* dst, long long ld, const bf16* src,
                           int lds, int ncols, int nv) {
  const int q8 = ncols / 8;
  for (int e = threadIdx.x; e < ROWS * q8; e += THREADS) {
    const int r = e / q8, q = e % q8;
    if (r < nv)
      *reinterpret_cast<uint4*>(dst + r * ld + q * 8) =
          *reinterpret_cast<const uint4*>(src + r * lds + q * 8);
  }
}

// Loads rows [0, nv) of dst (ROWS, ncols) from src rows (stride ld); rows
// nv.. are zero.
template <int ROWS = TM>
__device__ void load_rows(bf16* dst, int ldd, const bf16* src, long long ld,
                          int ncols, int nv) {
  const int q8 = ncols / 8;
  for (int e = threadIdx.x; e < ROWS * q8; e += THREADS) {
    const int r = e / q8, q = e % q8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nv) v = *reinterpret_cast<const uint4*>(src + r * ld + q * 8);
    *reinterpret_cast<uint4*>(dst + r * ldd + q * 8) = v;
  }
}

// acc = D @ W^T on a 64-row tile, for the warp's NF column tiles starting
// at column c0 + warp * 16 * NF of W's rows (the layer's input dims): D
// (TM, 16 ktiles) bf16 in shared memory (stride ldd), W (in, 16 ktiles)
// row-major bf16 in global memory (stride ldw), read as a col_major
// fragment.  Only the k-tiles set in kmask are visited (the others are
// zero in D).
template <int NF>
__device__ void dgrad_mma(const bf16* D, int ldd, const bf16* __restrict__ W,
                          int ldw, int c0, int ktiles, unsigned kmask,
                          FragC (&acc)[4][NF]) {
  const int warp = threadIdx.x >> 5;
  const int cw = c0 + warp * 16 * NF;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int kt = 0; kt < ktiles; ++kt) {
    if (!((kmask >> kt) & 1u)) continue;
    FragBT b[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::load_matrix_sync(b[j], W + (cw + j * 16) * ldw + kt * 16, ldw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, D + i * 16 * ldd + kt * 16, ldd);
#pragma unroll
      for (int j = 0; j < NF; ++j) wmma::mma_sync(acc[i][j], a, b[j],
                                                  acc[i][j]);
    }
  }
}

// The trunk's case: D (TM, 256) at stride LDH, W (in, 256).
template <int NF>
__device__ void dgrad_mma(const bf16* D, const bf16* __restrict__ W, int c0,
                          unsigned kmask, FragC (&acc)[4][NF]) {
  dgrad_mma<NF>(D, LDH, W, WIDTH, c0, WIDTH / 16, kmask, acc);
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

// Adds into a global fp32 bias slice (none when b is null: K18's modes
// without weight gradients).
struct BiasSum {
  float* b;
  __device__ void operator()(int c, float s) const {
    if (b != nullptr) b[c] += s;
  }
};

// dW[m][n] += sum_{k < ROWS} A[k][m] * B[k][n] for m < M and the n-tiles
// in nmask: A (ROWS, M) bf16 in shared memory (stride lda), B (ROWS, 16
// n-tiles of nmask) bf16 in shared memory (stride ldb), dW (M, ldw) fp32
// row-major in the block's gradient slice: one load and one store of each
// dW fragment per call, the contraction over all ROWS rows between them.
// Warp w takes the 16-row strips m = w, w + 8, ...
template <int ROWS = TM>
__device__ void wgrad_acc(const bf16* A, int lda, int M, const bf16* B,
                          int ldb, unsigned nmask, float* dW, int ldw) {
  const int warp = threadIdx.x >> 5;
  for (int mt = warp; mt < M / 16; mt += WARPS) {
    FragAT a[ROWS / 16];
#pragma unroll
    for (int kt = 0; kt < ROWS / 16; ++kt)
      wmma::load_matrix_sync(a[kt], A + kt * 16 * lda + mt * 16, lda);
    for (int nt = 0; nt < 32; ++nt) {
      if (!((nmask >> nt) & 1u)) continue;
      float* dst = dW + mt * 16 * ldw + nt * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, dst, ldw, wmma::mem_row_major);
#pragma unroll
      for (int kt = 0; kt < ROWS / 16; ++kt) {
        FragB b;
        wmma::load_matrix_sync(b, B + kt * 16 * ldb + nt * 16, ldb);
        wmma::mma_sync(acc, a[kt], b, acc);
      }
      wmma::store_matrix_sync(dst, acc, ldw, wmma::mem_row_major);
    }
  }
}

// The trunk's case: B (TM, 256) at stride LDH, dW (M, 256).
__device__ void wgrad_acc(const bf16* A, int lda, int M, const bf16* B,
                          unsigned nmask, float* dW) {
  wgrad_acc<TM>(A, lda, M, B, LDH, nmask, dW, WIDTH);
}

constexpr int MASK_WORDS = WIDTH / 32;  // 8 words per row and layer

// The trunk hook of K3 and of the recomputes (K8, K17, K18): each layer's
// tile to the spill or a block's slot, and (K3's normals) its ReLU mask
// bits.
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

// The V3 tail's per-row cotangents (K4, K5, K8, K17, K18, K19) from the
// row's d_out columns dq[0:14) (bf16) and its diff, tint and mid values:
// rf[4:7) dz3 = dmid_out tint mid (1 - mid) at the mid head's
// pre-activation, rf[7:10) bf16(dz3), rf[10:21) the head columns'
// cotangents in FH_* order (density, diff, tint, roughness, normals).
__device__ void tail_cotangents(const bf16* __restrict__ dq,
                                const float* diff, const float* tint,
                                const float* mid, float* rf) {
  float dout[14];
  for (int i = 0; i < 14; ++i) dout[i] = __bfloat162float(dq[i]);
  for (int i = 0; i < 3; ++i) {
    const float dmid_out = dout[i];
    const float ddiff = __fadd_rn(dmid_out, dout[3 + i]);
    const float dtint = __fadd_rn(__fmul_rn(dmid_out, mid[i]), dout[6 + i]);
    const float dmid = __fmul_rn(dmid_out, tint[i]);
    const float dz =
        __fmul_rn(__fmul_rn(dmid, mid[i]), __fsub_rn(1.f, mid[i]));
    rf[4 + i] = dz;
    rf[7 + i] = __bfloat162float(__float2bfloat16_rn(dz));
    rf[10 + 1 + i] = __fmul_rn(__fmul_rn(ddiff, diff[i]),
                               __fsub_rn(1.f, diff[i]));
    rf[10 + 4 + i] = __fmul_rn(__fmul_rn(dtint, tint[i]),
                               __fsub_rn(1.f, tint[i]));
    rf[10 + 8 + i] = dout[9 + i];
  }
  rf[10 + 0] = dout[12];
  rf[10 + 7] = dout[13];
}

// The mid head's weight gradients over a tile of `rows` rows: dw_out[c][j]
// (row stride ldw) += sum_r hmid[r][c] bf16(dz3)[r][j] for j < 3,
// db_out[j] += sum_r dz3[r][j]; hmid bf16 (stride ldh), the row scalars of
// tail_cotangents at stride rs.
__device__ void mid_head_wgrad(const bf16* hmid, int ldh, const float* rowf,
                               int rs, int rows, float* dw_out,
                               float* db_out, int ldw = MID) {
  for (int e = threadIdx.x; e < MID * 3 + 3; e += THREADS) {
    if (e < MID * 3) {
      const int c = e / 3, j = e % 3;
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s = __fmaf_rn(__bfloat162float(hmid[r * ldh + c]),
                      rowf[r * rs + 7 + j], s);
      dw_out[c * ldw + j] += s;
    } else {
      const int j = e - MID * 3;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = __fadd_rn(s, rowf[r * rs + 4 + j]);
      db_out[j] += s;
    }
  }
}

// dmid_pre on a tile, thread c < MID owning column c: for rows r < nv
// (bf16(dz3) @ w_out[:, 0:3]^T) where mid_pre > 0 (the bits mbits), else
// 0, written bf16 to out[r * ldo + c] for all `rows` rows; its fp32 sum
// into bias[c] (bias null: not wanted); the per-ray band gradients
// dg[ray][b][c] += sum over the ray's rows of atten_b dmid_pre
// (rowf[0:4) at stride rs), in row order.
__device__ void dmid_pre_rows(const bf16* __restrict__ w_out,
                              const uint32_t* mbits, const float* rowf,
                              int rs, int rows, int nv, long long row0,
                              int S, float* __restrict__ dg, bf16* out,
                              int ldo, float* bias) {
  const int c = threadIdx.x;
  if (c >= MID) return;
  const float w0 = __bfloat162float(w_out[c * MID + 0]);
  const float w1 = __bfloat162float(w_out[c * MID + 1]);
  const float w2 = __bfloat162float(w_out[c * MID + 2]);
  float sum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  long long ray_cur = -1;
  for (int r = 0; r < rows; ++r) {
    float v = 0.f;
    if (r < nv && ((mbits[r * (MID / 32) + (c >> 5)] >> (c & 31)) & 1u)) {
      const float* dz = rowf + r * rs + 7;
      v = __fmaf_rn(dz[2], w2, __fmaf_rn(dz[1], w1, __fmul_rn(dz[0], w0)));
    }
    out[r * ldo + c] = __float2bfloat16_rn(v);
    if (r >= nv) continue;
    sum = __fadd_rn(sum, v);
    const long long ray = (row0 + r) / S;
    if (ray != ray_cur) {
      if (ray_cur >= 0)
        for (int b = 0; b < 4; ++b) dg[ray_cur * G_COLS + b * MID + c] +=
            acc[b];
      ray_cur = ray;
      for (int b = 0; b < 4; ++b) acc[b] = 0.f;
    }
    for (int b = 0; b < 4; ++b) acc[b] = __fmaf_rn(rowf[r * rs + b], v, acc[b]);
  }
  if (ray_cur >= 0)
    for (int b = 0; b < 4; ++b) dg[ray_cur * G_COLS + b * MID + c] += acc[b];
  if (bias != nullptr) bias[c] += sum;
}

// The IPE backward of rows [0, nv) of the tile at row0 (K4, K8, K17,
// K18): from the fp32 dx tile dxe (rows x 128, stride ENC) to dmc (N, 16)
// f32 = dpre_enc A^T + dvar V^T, written out per frequency: d mean in
// columns 0:3 (dx damp cos(2 pi u) 2 pi f_k over both halves, plus the
// identity columns 96..98), d cov in 3:6 (-dx damp sin(2 pi u) / 2 f_k^2),
// zero in 6:16.
__device__ void ipe_backward_rows(const float* __restrict__ mc,
                                  const float* __restrict__ consts,
                                  const float* dxe, float* __restrict__ dmc,
                                  long long row0, int nv, int rows) {
  for (int e = threadIdx.x; e < rows * IN_COLS; e += THREADS) {
    const int r = e / IN_COLS, col = e % IN_COLS;
    if (r >= nv) continue;
    const long long row = row0 + r;
    float s = 0.f;
    if (col < 6) {
      const float* m = mc + row * IN_COLS;
      const int d = col % 3;
      const bool var = col >= 3;
      for (int half = 0; half < 2; ++half)
        for (int k = 0; k < NFREQ; ++k) {
          const int c = half * 48 + d * NFREQ + k;
          float damp, u;
          ipe_phase(m, consts, c, &damp, &u);
          const float dx = dxe[r * ENC + c];
          const float t = var
              ? __fmul_rn(__fmul_rn(__fmul_rn(dx, -0.5f), damp), sin2pi(u))
              : __fmul_rn(dx, __fmul_rn(damp, cos2pi(u)));
          s = __fmaf_rn(t, consts[(var ? NFREQ : 0) + k], s);
        }
      if (!var) s = __fadd_rn(s, dxe[r * ENC + 96 + d]);
    }
    dmc[row * IN_COLS + col] = s;
  }
}

// The unfolded operands (pack_params_v3, 22 tensors: K14, K15, K18, K19).
struct V3UParams {
  TrunkParams trunk;
  const bf16* wh;      // (256, 384): [bottleneck | density | diff | tint |
                       // roughness | normals | 0]
  const float* bh;     // (384,)
  const bf16* w_emb;   // (256, 128): the mid-MLP's bottleneck rows
  const float* b_mid;  // (128,)
  const bf16* w_out;   // (128, 128), 3 live columns
  const float* b_out;  // (128,)
};
constexpr int HEAD_COLS = 384;   // the unfolded heads' width (OUT_*)
constexpr int OUT_DENSITY = 256, OUT_DIFF = 257, OUT_TINT = 260,
              OUT_ROUGH = 263, OUT_NORMALS = 264;

void fill_trunk(TrunkParams* t, const void* const* ptrs) {
  for (int i = 0; i < LAYERS; ++i) {
    t->w[i] = static_cast<const bf16*>(ptrs[i]);
    t->b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  }
}

void fill_v3(V3Params* p, const void* const* ptrs) {
  fill_trunk(&p->trunk, ptrs);
  p->w_hc = static_cast<const bf16*>(ptrs[16]);
  p->b_hc = static_cast<const float*>(ptrs[17]);
  p->w_out = static_cast<const bf16*>(ptrs[18]);
  p->b_out = static_cast<const float*>(ptrs[19]);
}

void fill_v3u(V3UParams* p, const void* const* ptrs) {
  fill_trunk(&p->trunk, ptrs);
  p->wh = static_cast<const bf16*>(ptrs[16]);
  p->bh = static_cast<const float*>(ptrs[17]);
  p->w_emb = static_cast<const bf16*>(ptrs[18]);
  p->b_mid = static_cast<const float*>(ptrs[19]);
  p->w_out = static_cast<const bf16*>(ptrs[20]);
  p->b_out = static_cast<const float*>(ptrs[21]);
}

}  // namespace
