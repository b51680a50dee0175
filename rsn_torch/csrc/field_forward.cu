// Field forward kernels of the render path and of the field API, for
// NVIDIA Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of rsn/kernels/field_pallas.py:
//   field_forward_v3       (K1; body _field_kernel_halved / _field_half /
//                           _ipe_parts): IPE -> bf16 trunk 8x256 with the
//                           skip at layer 4 -> one (256, 256) product for
//                           the 11 head columns and the folded mid-MLP seed
//                           -> roughness attenuation against the per-ray SH
//                           band partials -> mid head -> (N, 16) bf16.
//   field_forward_density  (K2; body _density_kernel): IPE -> trunk ->
//                           density column only -> (N, 8) bf16.
//   field_forward_v2       (K11; body _kernel_v2 / _ipe_in_kernel): the IPE
//                           with exact sin and exp -> trunk -> one
//                           (256, 384) product for every head, the 256-wide
//                           bottleneck included -> (N, 384) bf16 in the
//                           OUT_* columns (267 live, the rest zero).  The
//                           field's kernel route (Field.get_field_outputs
//                           with use_pallas, not differentiable).
//   field_forward          (K12; body _kernel): K11 from a precomputed
//                           (N, 128) bf16 encoding, no IPE.  K11 and K12
//                           are one kernel with one template flag.
//
// What bounds it on this card: about 1.18 MFLOP of bf16 matrix products
// per sample row against 64 B read and 32 B written, so device memory is
// far from the limit; the tensor cores are, and behind them the L2 traffic
// of the weights (1.2 MB of bf16, re-read by every row tile).  K11 and
// K12 write 768 B per row (K12 reads 256 B), still about 1,400 FLOP per
// byte: the tensor cores again.
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
//   - K11's IPE is not K1's: rsn's v2 front end takes jnp.sin of the fp32
//     phase 2 pi f_k mean_d (+ f32(pi / 2) on the cos half, not a cos) and
//     jnp.exp(-var / 2), not K1's wrapped polynomial (ipe_rows<true> in
//     field_common.cuh, which K14 shares).  Its heads epilogue stages
//     the (64, 384) bf16 output tile in the freed H0 + X buffers and stores
//     whole rows with 16-byte stores.
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
  block_sync();
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
  block_sync();
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

// ---- K11 / K12 ------------------------------------------------------------

constexpr int HEAD_TILES = 17;   // 16-column tiles holding the 267 live ones
constexpr int LDO = HEAD_COLS + 8;  // bf16 output staging stride
static_assert(TM * LDO * 2 <= H_BYTES + X_BYTES, "output tile must fit H0+X");

struct HeadsParams {
  TrunkParams trunk;
  const bf16* wh;     // (256, 384): [bottleneck | density | diff | tint |
                      // roughness | normals | 0]
  const float* bh;    // (384,)
};

// K12's (N, 128) bf16 encoding rows into X, 16 bytes per thread and step;
// rows at or past n zero.
__device__ void load_enc_tile(const bf16* __restrict__ enc, long long row0,
                              long long n, bf16* X) {
  constexpr int Q = ENC / 8;
  for (int e = threadIdx.x; e < TM * Q; e += THREADS) {
    const int r = e / Q, q = e % Q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(enc + (row0 + r) * ENC + q * 8);
    *reinterpret_cast<uint4*>(X + r * LDX + q * 8) = v;
  }
}

// O = bf16(H @ wh + bh) for the block's 64 rows, O (TM x LDO) in shared
// memory.  Warp w computes the column tiles w, w + 8, w + 16 that hold live
// columns (< HEAD_TILES); the others are zero weights, so their value is
// the bias.
__device__ void heads_product(const bf16* H, const HeadsParams& p, bf16* O,
                              float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  FragC acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int ks = 0; ks < WIDTH / 16; ++ks) {
    FragB b[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int nt = warp + 8 * j;
      if (nt < HEAD_TILES)
        wmma::load_matrix_sync(b[j], p.wh + ks * 16 * HEAD_COLS + nt * 16,
                               HEAD_COLS);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, H + i * 16 * LDH + ks * 16, LDH);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (warp + 8 * j < HEAD_TILES)
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
    }
  }
  float* st = stage + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int nt = warp + 8 * j, col0 = nt * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (nt < HEAD_TILES) {
        wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
        __syncwarp();
      }
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const float v = nt < HEAD_TILES
                            ? __fadd_rn(st[r * LDS + c], p.bh[col0 + c])
                            : p.bh[col0 + c];
        O[(i * 16 + r) * LDO + col0 + c] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// K11 (IPE: from mean_cov) or K12 (from the encoding).
template <bool IPE>
__global__ void __launch_bounds__(THREADS, 2)
    field_heads_kernel(const float* __restrict__ mc,
                       const bf16* __restrict__ enc,
                       const float* __restrict__ consts, HeadsParams p,
                       bf16* __restrict__ out, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* X = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  const long long row0 = (long long)blockIdx.x * TM;

  if (IPE)
    ipe_rows<true>(mc, consts, row0, n, X, threadIdx.x, THREADS, TM);
  else
    load_enc_tile(enc, row0, n, X);
  block_sync();
  const bf16* H = trunk(p.trunk, X, H0, H1, stage, NoLayerHook());  // == H1
  bf16* O = H0;  // spans H0 and X, both free after the trunk
  heads_product(H, p, O, stage);
  block_sync();
  constexpr int Q = HEAD_COLS / 8;
  for (int e = threadIdx.x; e < TM * Q; e += THREADS) {
    const int r = e / Q, q = e % Q;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out + (row0 + r) * HEAD_COLS + q * 8) =
          *reinterpret_cast<const uint4*>(O + r * LDO + q * 8);
  }
}

unsigned grid_for(long long n) { return (unsigned)((n + TM - 1) / TM); }

template <bool IPE>
int launch_heads(const float* mc, const bf16* enc, const float* consts,
                 const void* const* ptrs, bf16* out, long long n,
                 cudaStream_t stream) {
  HeadsParams p;
  fill_trunk(&p.trunk, ptrs);
  p.wh = static_cast<const bf16*>(ptrs[16]);
  p.bh = static_cast<const float*>(ptrs[17]);
  auto kernel = field_heads_kernel<IPE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(n), THREADS, FWD_SMEM_BYTES, stream>>>(mc, enc, consts,
                                                           p, out, n);
  return (int)cudaGetLastError();
}

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

// K11.  ptrs: w0..w7, b0..b7, wh, bh (device pointers); out (N, 384) bf16.
int rsn_field_forward_v2(const void* mean_cov, const void* ipe_consts,
                         const void* const* ptrs, void* out, long long n,
                         void* stream) {
  return launch_heads<true>(static_cast<const float*>(mean_cov), nullptr,
                            static_cast<const float*>(ipe_consts), ptrs,
                            static_cast<bf16*>(out), n,
                            static_cast<cudaStream_t>(stream));
}

// K12.  enc (N, 128) bf16; ptrs and out as for K11.
int rsn_field_forward(const void* enc, const void* const* ptrs, void* out,
                      long long n, void* stream) {
  return launch_heads<false>(nullptr, static_cast<const bf16*>(enc), nullptr,
                             ptrs, static_cast<bf16*>(out), n,
                             static_cast<cudaStream_t>(stream));
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
