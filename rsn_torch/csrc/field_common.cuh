// Device routines shared by the field kernels (field_forward.cu: K1, K2,
// K11, K12; field_train.cu: K3, K4, K5, K7, K8, K10, K13; experiments.cu:
// K14, K15).  Every kernel computes its trunk and its IPE (K1's polynomial
// one, or K11's exact one) through these routines, and K1, K2, K3 their
// density column and V3 tail, so the values they have in common come from
// one piece of code: K2's density column and K3's column 12 equal K1's bit
// for bit.
//
// The routines run on THREADS threads (threadIdx.x < THREADS) and meet at
// block_sync(), named barrier 1 over THREADS threads: in a block of
// THREADS threads that is __syncthreads(), and K10's block adds producer
// warps (threadIdx.x >= THREADS) that never take it.  The *_rows variants
// run on a group of warps that owns a row sub-tile and meets at its own
// barrier (K14's and K15's two warp groups).
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
  float uu = __fmul_rn(pre, INV_2PI);
  *u = __fsub_rn(uu, rintf(uu));
}

// IPE of `rows` rows from row0 into X (rows x ENC bf16): cols [0, 48)
// damp * sin(2 pi f_k mean_d), [48, 96) the cos half, [96, 99) mean,
// [99, 128) zero.  Rows at or past n are zero.  Thread t0 + i of a group
// of nt threads computes elements i, i + nt, ...; each element's value
// does not depend on which thread computes it.
//   EXACT false (K1 and the kernels built on it): the wrapped phase and the
//     polynomial sine, damp = exp2(-var / (2 ln 2)).
//   EXACT true (K11, K14; rsn's _ipe_in_kernel): sinf of the fp32 phase
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

// No hand-off around a warp's products (every kernel but K15's, whose two
// warp groups take turns on the tensor cores).
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

// Nothing to do after a trunk layer (K1, K2).
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
// K1, K2 and K3 all call this, which makes their density columns identical.
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

// The V3 tail on the trunk output H of the block's rows (K1, K3):
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

}  // namespace
