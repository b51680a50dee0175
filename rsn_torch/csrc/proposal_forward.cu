// Proposal-field forward kernel of the preset's render path (K9), for
// NVIDIA Hopper (sm_90a).
//
// Replaces rsn/kernels/proposal_pallas.py::prop_forward (body _prop_kernel):
// (N, 16) f32 rows [mean(3) | cov_diag(3) | 0 ...] -> the 8-octave IPE as 64
// bf16 columns [damp*sin (24) | damp*cos (24) | mean (3) | 0 (13)] -> 4 x 64
// ReLU trunk (bf16 operands, fp32 sums, bf16 activations) -> the density
// pre-activation, one f32 per row.
//
// What bounds it on this card: per row the function needs 24 B read (the
// mean and cov columns; the kernel reads the whole 64-B row) and 4 B
// written, and 2 * (51 * 64 + 3 * 64 * 64 + 64) = 31,232 FLOP of products
// on the tensor cores (0.033 ms for 2^20 rows at the bf16 peak; the bytes
// take 0.009 ms).
// Each row also takes 48 full-precision sinf and 48 expf on the CUDA
// cores, whose argument reduction and polynomials are some thousands of
// instructions per row: those, not the products or the bytes, are
// expected to set the kernel's time.
//
// What the design does about it (a first, simple design):
//   - A block of 8 warps copies the four bf16 weight matrices (32 KB), the
//     biases, the head column and the IPE constants into shared memory
//     once, then walks 64-row tiles (grid-stride; the grid fills the card
//     at the occupancy the kernel allows).  The ragged last tile is
//     masked; N is not padded.
//   - The tile's input rows are staged in shared memory with 16-byte
//     loads; the IPE tile is written there as bf16, and the four layers
//     ping-pong between two 64 x 64 bf16 tiles.  Only the pre-activation
//     is stored to device memory.
//   - Products run on the tensor cores as nvcuda::wmma 16x16x16 bf16
//     fragments with fp32 accumulators; warp w owns output columns
//     [16 (w % 4), +16) of row tiles 2 (w / 4) and 2 (w / 4) + 1.  The
//     epilogue adds the bias in fp32, applies the ReLU (keeping NaN, as
//     jnp.maximum does) and rounds to bf16.
//   - The 64 -> 1 head is a per-row fp32 dot of the bf16 activations with
//     the bf16 head column in a fixed order (four threads per row, two xor
//     shuffles), plus the fp32 bias.
//   - The phase and the variance round as rsn's `mc @ A + bA` and `mc @ V`
//     do (one nonzero term per column): __fmul_rn / __fadd_rn keep nvcc
//     from contracting them into an FMA, and sinf / expf are the
//     full-precision functions (the phases reach 2 pi 256 2 ~ 3.2e3 rad;
//     no fast-math intrinsics, no --use_fast_math).
// Later work: overlap the IPE of the next tile with the products of this
// one (warp specialisation), wgmma on 64-row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;          // rows per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int WIDTH = 64;       // trunk width == the padded IPE width
constexpr int LAYERS = 4;
constexpr int IN_COLS = 16;
constexpr int NFREQ = 8;
constexpr int SIN_COLS = 3 * NFREQ;      // 24 per half
constexpr int IPE_DIM = 6 * NFREQ + 3;   // 51
constexpr int HEAD_COLS = 8;    // the packed head's width, column 0 live

// shared-memory row strides: +8 bf16 (16 B) spreads rows over the banks
constexpr int LD = WIDTH + 8;
constexpr int LDS = 20;         // per-warp f32 epilogue staging

constexpr int W_BYTES = LAYERS * WIDTH * LD * 2;
constexpr int T_BYTES = TM * LD * 2;
constexpr int MC_BYTES = TM * IN_COLS * 4;
constexpr int STAGE_BYTES = WARPS * 16 * LDS * 4;
// [bias (4 x 64) | head column (64) | 2 pi f_k (8) | f_k^2 (8)], f32
constexpr int SMALL_FLOATS = LAYERS * WIDTH + WIDTH + 2 * NFREQ;
constexpr int OFF_W = 0;
constexpr int OFF_H0 = OFF_W + W_BYTES;
constexpr int OFF_H1 = OFF_H0 + T_BYTES;
constexpr int OFF_MC = OFF_H1 + T_BYTES;
constexpr int OFF_STAGE = OFF_MC + MC_BYTES;
constexpr int OFF_SMALL = OFF_STAGE + STAGE_BYTES;
constexpr int SMEM_BYTES = OFF_SMALL + SMALL_FLOATS * 4;
static_assert(OFF_H0 % 128 == 0 && OFF_H1 % 128 == 0 && OFF_MC % 128 == 0 &&
                  OFF_STAGE % 128 == 0 && OFF_SMALL % 128 == 0,
              "wmma and 16-byte copies need aligned tiles");
static_assert(TM * 4 == THREADS, "four threads per row in the head");

constexpr float HALF_PI = 1.57079637f;   // f32(pi / 2)

struct PropParams {
  const bf16* w[LAYERS];   // (64, 64) row-major (in, out); layer 0's rows
                           // 51..63 are zero
  const float* b[LAYERS];  // (64,)
  const bf16* wd;          // (64, 8), column 0 live
  const float* bd;         // (8,)
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// The IPE of the staged rows MC (TM x 16 f32) into X (TM x WIDTH bf16).
// Column c < 48: cc = c mod 24, d = cc / 8, k = cc mod 8;
// pre = fl(mean_d * 2 pi f_k) (+ pi / 2 for c >= 24),
// var = fl(cov_d * f_k^2), value fl(expf(-var / 2) * sinf(pre)).
// Columns 48..50: mean; 51..63: zero.
__device__ void ipe_tile(const float* MC, const float* cst, bf16* X) {
  for (int e = threadIdx.x; e < TM * WIDTH; e += THREADS) {
    const int r = e / WIDTH, c = e % WIDTH;
    const float* m = MC + r * IN_COLS;
    float v = 0.f;
    if (c < 2 * SIN_COLS) {
      const int cc = c % SIN_COLS, d = cc / NFREQ, k = cc % NFREQ;
      float pre = __fmul_rn(m[d], cst[k]);
      if (c >= SIN_COLS) pre = __fadd_rn(pre, HALF_PI);
      const float var = __fmul_rn(m[3 + d], cst[NFREQ + k]);
      v = __fmul_rn(expf(__fmul_rn(-0.5f, var)), sinf(pre));
    } else if (c < IPE_DIM) {
      v = m[c - 2 * SIN_COLS];
    }
    X[r * LD + c] = __float2bfloat16_rn(v);
  }
}

// Out = bf16(relu(A @ Wl + b)) on the block's 64 rows; A, Wl and Out in
// shared memory (stride LD).  Warp w: columns [16 (w % 4), +16) of row
// tiles 2 (w / 4), 2 (w / 4) + 1.
__device__ void dense_relu(const bf16* A, const bf16* Wl, const float* b,
                           bf16* Out, float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (warp & 3) * 16, rt0 = (warp >> 2) * 2;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
  for (int ks = 0; ks < WIDTH / 16; ++ks) {
    FragB bw;
    wmma::load_matrix_sync(bw, Wl + ks * 16 * LD + col0, LD);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, A + (rt0 + i) * 16 * LD + ks * 16, LD);
      wmma::mma_sync(acc[i], a, bw, acc[i]);
    }
  }
  float* st = stage + warp * 16 * LDS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::store_matrix_sync(st, acc[i], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15, col = col0 + c;
      const float v = __fadd_rn(st[r * LDS + c], b[col]);
      Out[((rt0 + i) * 16 + r) * LD + col] =
          __float2bfloat16_rn(v < 0.f ? 0.f : v);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    prop_forward_kernel(const float* __restrict__ mc,
                        const float* __restrict__ consts, PropParams p,
                        float* __restrict__ out, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W = reinterpret_cast<bf16*>(smem + OFF_W);
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* MC = reinterpret_cast<float*>(smem + OFF_MC);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  float* bias = reinterpret_cast<float*>(smem + OFF_SMALL);
  float* head = bias + LAYERS * WIDTH;
  float* cst = head + WIDTH;
  const int tid = threadIdx.x;

  // once per block: the weights (16-byte copies), biases, head, constants
  constexpr int ROW_VECS = WIDTH / 8;  // uint4 per weight row
  for (int e = tid; e < LAYERS * WIDTH * ROW_VECS; e += THREADS) {
    const int l = e / (WIDTH * ROW_VECS), r = (e / ROW_VECS) % WIDTH,
              v = e % ROW_VECS;
    const uint4 x = reinterpret_cast<const uint4*>(p.w[l])[r * ROW_VECS + v];
    *reinterpret_cast<uint4*>(W + (l * WIDTH + r) * LD + v * 8) = x;
  }
  for (int e = tid; e < LAYERS * WIDTH; e += THREADS)
    bias[e] = p.b[e / WIDTH][e % WIDTH];
  if (tid < WIDTH) head[tid] = __bfloat162float(p.wd[tid * HEAD_COLS]);
  if (tid < 2 * NFREQ) cst[tid] = consts[tid];
  const float bd0 = p.bd[0];
  __syncthreads();

  const long long tiles = (n + TM - 1) / TM;
  const int r4 = tid >> 2, q = tid & 3;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * TM;
    for (int e = tid; e < TM * IN_COLS / 4; e += THREADS) {
      const long long row = row0 + e / 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n) x = reinterpret_cast<const float4*>(mc)[row * 4 + e % 4];
      reinterpret_cast<float4*>(MC)[e] = x;
    }
    __syncthreads();
    ipe_tile(MC, cst, H1);
    __syncthreads();
    // X (in H1) -> H0 -> H1 -> H0 -> H1
    bf16* hin = H1;
    bf16* hout = H0;
    for (int l = 0; l < LAYERS; ++l) {
      dense_relu(hin, W + l * WIDTH * LD, bias + l * WIDTH, hout, stage);
      __syncthreads();
      bf16* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    // head: four threads per row sum interleaved quarters, then combine
    float s = 0.f;
    for (int j = 0; j < WIDTH / 4; ++j) {
      const int k = 4 * j + q;
      s = __fmaf_rn(__bfloat162float(hin[r4 * LD + k]), head[k], s);
    }
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    if (q == 0 && row0 + r4 < n) out[row0 + r4] = __fadd_rn(s, bd0);
    __syncthreads();  // the next tile rewrites MC and H1
  }
}

}  // namespace

extern "C" {

// ptrs: w0..w3, b0..b3, wd, bd (device pointers); consts: [2 pi f_k (8) |
// f_k^2 (8)] f32 on the device.  Returns a cudaError_t code (0 = launched).
int rsn_prop_forward(const void* mean_cov, const void* consts,
                     const void* const* ptrs, void* out, long long n,
                     void* stream) {
  PropParams p;
  for (int i = 0; i < LAYERS; ++i) {
    p.w[i] = static_cast<const bf16*>(ptrs[i]);
    p.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  }
  p.wd = static_cast<const bf16*>(ptrs[2 * LAYERS]);
  p.bd = static_cast<const float*>(ptrs[2 * LAYERS + 1]);
  cudaError_t err = cudaFuncSetAttribute(
      prop_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, prop_forward_kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n + TM - 1) / TM;
  const long long slots = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  prop_forward_kernel<<<grid, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean_cov), static_cast<const float*>(consts),
      p, static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
