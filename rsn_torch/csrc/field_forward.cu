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
// The device routines live in field_common.cuh, shared with the training
// kernels (field_train.cu).
// Later work: larger row tiles (fewer L2 weight reads), wgmma with a TMA
// ring for the weights, warp specialisation.
#include "field_common.cuh"

namespace {

constexpr int OUT_COLS = 16;    // K1 eval store (V3_EVAL_COLS)
constexpr int DENS_COLS = 8;    // K2 store

struct DensityParams {
  TrunkParams trunk;
  const bf16* wd;     // (256, 8), column 0 live
  const float* bd;
};

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
  const long long row0 = (long long)blockIdx.x * TM;

  ipe_tile(mc, consts, row0, n, X);
  __syncthreads();
  bf16* H = trunk(p.trunk, X, H0, H1, stage, NoLayerHook());  // == H1
  v3_tail<OUT_COLS>(p, H, smem, g, row0, n, S, out + row0 * OUT_COLS);
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
  const bf16* H = trunk(p.trunk, X, H0, H1, stage, NoLayerHook());
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
  fill_v3(&p, ptrs);
  cudaError_t err = cudaFuncSetAttribute(
      field_forward_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  field_forward_v3_kernel<<<grid_for(n), THREADS, FWD_SMEM_BYTES,
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
      cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  field_forward_density_kernel<<<grid_for(n), THREADS, FWD_SMEM_BYTES,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean_cov),
      static_cast<const float*>(ipe_consts), p, static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
