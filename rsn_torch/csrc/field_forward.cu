// Field forward kernels of the render path, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of rsn/kernels/field_pallas.py:
//   field_forward_v3       (K1; body _field_kernel_halved / _field_half /
//                           _ipe_parts): IPE -> bf16 trunk 8x256 with the
//                           skip at layer 4 -> one (256, 256) product for
//                           the 11 head columns and the folded mid-MLP seed
//                           -> roughness attenuation against the per-ray SH
//                           band partials -> mid head -> (N, 16) bf16.
//   field_forward_density  (K2; body _density_kernel): IPE -> trunk ->
//                           density column only -> (N, 8) bf16.
//
// What bounds it on this card: about 1.18 MFLOP of bf16 matrix products
// per sample row against 64 B read and 32 B written, so device memory is
// far from the limit; the tensor cores are, and behind them the L2 traffic
// of the weights (1.2 MB of bf16, re-read by every row tile).
//
// What the design does about it (a first, simple design):
//   - One block of 8 warps owns a tile of TM = 64 sample rows; the ragged
//     last tile is masked.  No intermediate goes to device memory: the
//     IPE tile x and the activations ping-pong in shared memory (93 KB,
//     two blocks per SM), only the 16 (or 8) output columns are stored.
//   - Products run on the tensor cores through nvcuda::wmma 16x16x16 bf16
//     fragments with fp32 accumulators.  Warp w owns output columns
//     [32w, 32w + 32) of all 64 rows, so every weight fragment is read
//     once per block, straight from global memory (L2-resident), one
//     k-step ahead of its use.
//   - The bias + ReLU epilogue rounds activations to bf16, as the TPU
//     kernel does; heads, softplus, sigmoid, attenuation and
//     diff + tint * mid stay fp32; hmid is rounded to bf16 before the mid
//     head; the output is stored bf16.
//   - A sample row finds its ray as row / S (the TPU kernel's one-hot
//     expansion matmul is dropped), and the IPE is computed per element
//     (no 128-lane constant matrices).
//   - The density pre-activation comes from one scalar routine with a
//     fixed summation order that both kernels call, so K2's column 0
//     equals K1's column 12 bit for bit.
// Later work: larger row tiles (fewer L2 weight reads), wgmma with a TMA
// ring for the weights, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;          // sample rows per block
constexpr int THREADS = 256;    // 8 warps
constexpr int WIDTH = 256;      // trunk width
constexpr int ENC = 128;        // IPE (99) zero-padded
constexpr int IPE_DIM = 99;
constexpr int SKIP_AT = 4;
constexpr int LAYERS = 8;
constexpr int IN_COLS = 16;
constexpr int OUT_COLS = 16;    // K1 eval store (V3_EVAL_COLS)
constexpr int DENS_COLS = 8;    // K2 store
constexpr int G_COLS = 512;     // 4 SH bands x 128
constexpr int MID = 128;

// shared-memory row strides: +8 bf16 (16 B) spreads rows over the banks
constexpr int LDH = WIDTH + 8;   // activations, bf16
constexpr int LDX = ENC + 8;     // IPE tile, bf16
constexpr int LDS = 20;          // per-warp f32 epilogue staging
constexpr int LDHC = 16 + MID;   // f32 [head columns 0..15 | mid seed]

constexpr int H_BYTES = TM * LDH * 2;
constexpr int X_BYTES = TM * LDX * 2;
constexpr int STAGE_BYTES = 8 * 16 * LDS * 4;
constexpr int OFF_H0 = 0;
constexpr int OFF_X = OFF_H0 + H_BYTES;  // H0 and X adjacent: the K1 tail
                                         // reuses both for the f32 HC tile
constexpr int OFF_H1 = OFF_X + X_BYTES;
constexpr int OFF_STAGE = OFF_H1 + H_BYTES;
constexpr int SMEM_BYTES = OFF_STAGE + STAGE_BYTES;
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
struct DensityParams {
  TrunkParams trunk;
  const bf16* wd;     // (256, 8), column 0 live
  const float* bd;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
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

// IPE of the block's rows into X (TM x ENC bf16):
// cols [0, 48) damp * sin(2 pi f_k mean_d), [48, 96) the cos half (phase
// + pi/2 added before the wrap), [96, 99) mean, [99, 128) zero.
// consts = [2 pi f_k (16) | f_k^2 (16)] as f32.
__device__ void ipe_tile(const float* __restrict__ mc,
                         const float* __restrict__ consts, long long row0,
                         long long n, bf16* X) {
  for (int e = threadIdx.x; e < TM * ENC; e += THREADS) {
    const int r = e / ENC, c = e % ENC;
    const long long row = row0 + r;
    float v = 0.f;
    if (row < n && c < IPE_DIM) {
      const float* m = mc + row * IN_COLS;
      if (c >= 96) {
        v = m[c - 96];
      } else {
        const int cc = c % 48, d = cc / 16, k = cc % 16;
        float pre = __fmul_rn(m[d], consts[k]);
        if (c >= 48) pre = __fadd_rn(pre, HALF_PI);
        const float var = __fmul_rn(m[3 + d], consts[16 + k]);
        const float damp = exp2f(__fmul_rn(-HALF_LOG2E, var));
        float u = __fmul_rn(pre, INV_2PI);
        u = __fsub_rn(u, rintf(u));
        v = __fmul_rn(damp, sin2pi(u));
      }
    }
    X[r * LDX + c] = __float2bfloat16_rn(v);
  }
}

// One trunk layer on the block's 64 rows:
//   Out = bf16(relu([A0 | A1] @ W + b)),
// A0 (k0 columns, stride lda0) and A1 (k1 columns) in shared memory,
// W (k0 + k1, 256) bf16 row-major in global memory.  Warp w computes
// output columns [32w, 32w + 32).
__device__ void dense_relu_layer(const bf16* A0, int lda0, int k0,
                                 const bf16* A1, int lda1, int k1,
                                 const bf16* __restrict__ W,
                                 const float* __restrict__ bias, bf16* Out,
                                 float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * 32;
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
  const int ksteps = (k0 + k1) / 16;
  FragB b[2], bn[2];
  wmma::load_matrix_sync(b[0], W + col0, WIDTH);
  wmma::load_matrix_sync(b[1], W + col0 + 16, WIDTH);
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {  // next k-step's weights, ahead of their use
      const bf16* wn = W + (ks + 1) * 16 * WIDTH + col0;
      wmma::load_matrix_sync(bn[0], wn, WIDTH);
      wmma::load_matrix_sync(bn[1], wn + 16, WIDTH);
    }
    const int kc = ks * 16;
    const bf16* A = kc < k0 ? A0 + kc : A1 + (kc - k0);
    const int lda = kc < k0 ? lda0 : lda1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, A + i * 16 * lda, lda);
      wmma::mma_sync(acc[i][0], a, b[0], acc[i][0]);
      wmma::mma_sync(acc[i][1], a, b[1], acc[i][1]);
    }
    if (ks + 1 < ksteps) {
      b[0] = bn[0];
      b[1] = bn[1];
    }
  }
  float* st = stage + warp * 16 * LDS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15, col = col0 + j * 16 + c;
        const float v = __fadd_rn(st[r * LDS + c], bias[col]);
        Out[(i * 16 + r) * LDH + col] = __float2bfloat16_rn(relu_keep_nan(v));
      }
      __syncwarp();
    }
  }
}

// The trunk on X; returns the buffer holding the last layer's output.
// Ends with __syncthreads(): the result is visible to the whole block.
__device__ bf16* trunk(const TrunkParams& p, const bf16* X, bf16* H0,
                       bf16* H1, float* stage) {
  dense_relu_layer(X, LDX, ENC, nullptr, 0, 0, p.w[0], p.b[0], H0, stage);
  __syncthreads();
  bf16* hin = H0;
  bf16* hout = H1;
  for (int i = 1; i < LAYERS; ++i) {
    if (i == SKIP_AT)
      dense_relu_layer(X, LDX, ENC, hin, LDH, WIDTH, p.w[i], p.b[i], hout,
                       stage);
    else
      dense_relu_layer(nullptr, 0, 0, hin, LDH, WIDTH, p.w[i], p.b[i], hout,
                       stage);
    __syncthreads();
    bf16* t = hin;
    hin = hout;
    hout = t;
  }
  return hin;
}

// Density pre-activation of row threadIdx.x / 4: dot(h_row, w[:, 0]) + b.
// Four threads per row sum interleaved quarters in a fixed order, then
// combine with two xor shuffles; every thread of the row gets the value.
// K1 and K2 both call this, which makes their density columns identical.
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

__global__ void __launch_bounds__(THREADS, 2)
    field_forward_v3_kernel(const float* __restrict__ mc,
                            const float* __restrict__ g,
                            const float* __restrict__ consts, V3Params p,
                            bf16* __restrict__ out, long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* X = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * TM;

  ipe_tile(mc, consts, row0, n, X);
  __syncthreads();
  bf16* H = trunk(p.trunk, X, H0, H1, stage);  // == H1

  // heads + mid seed: HC[:, 0:16] = H @ w_hc[:, 0:16] (warp w < 4 does
  // row tile w), HC[:, 16:144] = H @ w_hc[:, 128:256] (warp w: 16 cols).
  // Head columns 11..127 of w_hc are zero padding and are skipped.
  float* HC = reinterpret_cast<float*>(smem + OFF_H0);
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
  __syncthreads();

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
  __syncthreads();  // also: every density_row read of H is done

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
  __syncthreads();

  // mid = sigmoid(hmid @ w_out[:, 0:3] + b_out): one thread per (row, col)
  if (tid < TM * 3) {
    const int r = tid / 3, c = tid % 3;
    float s = 0.f;
    for (int k = 0; k < MID; ++k)
      s = __fmaf_rn(__bfloat162float(H[r * LDH + k]),
                    __bfloat162float(p.w_out[k * MID + c]), s);
    rowf[r * 8 + 5 + c] = sigmoidf(__fadd_rn(s, p.b_out[c]));
  }
  __syncthreads();

  // assemble [mid_out | diff | tint | normals raw | density | rough raw | 0 0]
  if (tid < TM) {
    const long long row = row0 + tid;
    if (row < n) {
      const float* hc = HC + tid * LDHC;
      const float* rf = rowf + tid * 8;
      alignas(16) bf16 v[OUT_COLS];
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
      v[14] = v[15] = __float2bfloat16_rn(0.f);
      uint4* dst = reinterpret_cast<uint4*>(out + row * OUT_COLS);
      const uint4* src = reinterpret_cast<const uint4*>(v);
      dst[0] = src[0];
      dst[1] = src[1];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    field_forward_density_kernel(const float* __restrict__ mc,
                                 const float* __restrict__ consts,
                                 DensityParams p, bf16* __restrict__ out,
                                 long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* X = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  const long long row0 = (long long)blockIdx.x * TM;

  ipe_tile(mc, consts, row0, n, X);
  __syncthreads();
  const bf16* H = trunk(p.trunk, X, H0, H1, stage);
  const float dens = density_row(H, p.wd, DENS_COLS, p.bd[0]);
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long row = row0 + r;
  if (row < n) {  // thread q stores columns 2q, 2q + 1
    // columns 1..7 of wd are zero padding: their value is the bias
    const float c0 = q == 0 ? dens : p.bd[2 * q];
    out[row * DENS_COLS + 2 * q] = __float2bfloat16_rn(c0);
    out[row * DENS_COLS + 2 * q + 1] = __float2bfloat16_rn(p.bd[2 * q + 1]);
  }
}

void fill_trunk(TrunkParams* t, const void* const* ptrs) {
  for (int i = 0; i < LAYERS; ++i) {
    t->w[i] = static_cast<const bf16*>(ptrs[i]);
    t->b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  }
}

unsigned grid_for(long long n) { return (unsigned)((n + TM - 1) / TM); }

}  // namespace

extern "C" {

// ptrs: w0..w7, b0..b7, w_hc, b_hc, w_out, b_out (device pointers).
// Returns a cudaError_t code (0 = launched).
int rsn_field_forward_v3(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* const* ptrs,
                         void* out, long long n, int samples_per_ray,
                         void* stream) {
  V3Params p;
  fill_trunk(&p.trunk, ptrs);
  p.w_hc = static_cast<const bf16*>(ptrs[16]);
  p.b_hc = static_cast<const float*>(ptrs[17]);
  p.w_out = static_cast<const bf16*>(ptrs[18]);
  p.b_out = static_cast<const float*>(ptrs[19]);
  cudaError_t err = cudaFuncSetAttribute(
      field_forward_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  field_forward_v3_kernel<<<grid_for(n), THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean_cov), static_cast<const float*>(g_bands),
      static_cast<const float*>(ipe_consts), p, static_cast<bf16*>(out), n,
      samples_per_ray);
  return (int)cudaGetLastError();
}

// ptrs: w0..w7, b0..b7, wd, bd (device pointers).
int rsn_field_forward_density(const void* mean_cov, const void* ipe_consts,
                              const void* const* ptrs, void* out,
                              long long n, void* stream) {
  DensityParams p;
  fill_trunk(&p.trunk, ptrs);
  p.wd = static_cast<const bf16*>(ptrs[16]);
  p.bd = static_cast<const float*>(ptrs[17]);
  cudaError_t err = cudaFuncSetAttribute(
      field_forward_density_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  field_forward_density_kernel<<<grid_for(n), THREADS, SMEM_BYTES,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean_cov),
      static_cast<const float*>(ipe_consts), p, static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
