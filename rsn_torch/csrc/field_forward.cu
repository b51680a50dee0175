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
// far from the limit; the tensor cores are.  K11 and K12 write 768 B per
// row (K12 reads 256 B), still about 1,400 FLOP per byte.
//
// K1 and K2 (the render path; sm90::render_trunk in trunk_sm90.cuh):
//   - A persistent grid of at most one block per SM walks 128-row tiles;
//     the ragged last tile is masked.  Warpgroup 0's producer thread
//     streams the weights, pre-packed once per packed tuple into 64-row
//     chunks in wgmma's B layout (rsn_torch/kernels/trunk_sm90.py), through
//     a 3-stage ring of 32 KB with a cp.async.bulk and an mbarrier per
//     stage, continuously across layers and tiles.  Each weight byte
//     brought on chip serves 128 rows.
//   - Warpgroups 1 and 2 own 64 rows each: the IPE tile X and the
//     activations H stay in shared memory in wgmma's A layout (one H per
//     warpgroup: a layer's output overwrites its input).  Each layer is
//     one m64n256k16 wgmma accumulator, k ascending in steps of 16 from +0,
//     which the probe (rsn_mma_probe) finds bit-identical to trunk()'s
//     mma.sync; the bias + ReLU + bf16 epilogue runs from the registers.
//     Layer 0 and layer 4's x part take 7 k-steps: the IPE's columns
//     112..127 are zero.
//   - The IPE: two threads per row, each sin / cos pair from one damping
//     (ipe_sincos, ipe_rows' operations, so X has the same bits).  K1's
//     heads + mid seed are one m64n144 wgmma from the ring; roughness
//     attenuation, hmid, the mid head and the row follow v3_tail's
//     arithmetic.  The density column comes from density_row's operands in
//     its order, so K2's column 0 and K3's column 12 (trunk()) equal K1's
//     column 12 bit for bit.
//   - Where the time goes (ablations on the card, PERF.md): the products;
//     then each layer's epilogue, which stops its warpgroup's tensor work.
//
// K11 and K12 (the field API; sm90::heads_body in heads_sm90.cuh): K1's
// block, ring and trunk, with a 40-chunk blob a tile (the trunk's 32, wh's
// head columns as 4 chunks of m64n16, its bottleneck as 4 of m64n256);
// K11's front end is the exact IPE (rsn's v2: jnp.sin of the fp32 phase
// 2 pi f_k mean_d, + f32(pi / 2) on the cos half, and jnp.exp(-var / 2);
// ipe_exact_wg, K14's), K12's the caller's encoding with all 8 k-steps of
// its x part.  Each consumer writes its (64, 384) bf16 rows with streamed
// 16-byte stores straight from its own tiles (Bn in H, the head columns,
// the padding), no staging buffer.  Each equals its first design bit for
// bit.  The first design (one block of 8 warps a 64-row tile, two blocks
// an SM, nvcuda::wmma with every weight fragment read from L2 one k-step
// ahead, the output tile staged in the freed H0 + X) is kept under
// RSN_K11_FIRST_DESIGN, which only chip_smoke.py, the card tests and
// ablate_render.py build; both builds take the same arguments, and the
// first design ignores the blob.
//
// In every kernel a sample row finds its ray as row / S (the TPU kernel's
// one-hot expansion matmul is dropped), the bias + ReLU epilogue rounds
// activations to bf16 as the TPU kernel does, and heads, softplus,
// sigmoid, attenuation and diff + tint * mid stay fp32.
#include "field_common.cuh"
#include "trunk_sm90.cuh"
#ifndef RSN_K11_FIRST_DESIGN
#include "heads_sm90.cuh"
#endif

namespace {

// K1 and K2: the body is sm90::render_trunk (trunk_sm90.cuh).
template <bool HEADS>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    field_render_kernel(const __grid_constant__ sm90::RenderParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  sm90::render_trunk<HEADS>(p, smem_raw);
}

// At most one block per SM over n's 128-row tiles (K1, K2, K11, K12).
int persistent_grid(long long n, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (n + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS;
  *grid = (unsigned)(tiles < sms ? tiles : sms);
  return (int)err;
}

// ---- K11 / K12 ------------------------------------------------------------

#ifndef RSN_K11_FIRST_DESIGN

// K11 (IPE) and K12: the body is sm90::heads_body (heads_sm90.cuh).
template <bool IPE>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    heads_kernel(const __grid_constant__ sm90::HeadsParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  sm90::heads_body<IPE>(p, smem_raw);
}

// On a persistent grid.  ptrs: w0..w7, b0..b7, wh, bh (the kernel reads
// the weights from blob, the biases from ptrs).
template <bool IPE>
int launch_heads(const float* mc, const bf16* enc, const float* consts,
                 const void* blob, const void* const* ptrs, bf16* out,
                 long long n, cudaStream_t stream) {
  sm90::HeadsParams p{};
  p.r.mc = mc;
  p.r.consts = consts;
  p.r.blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p.r.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p.r.n = n;
  p.r.out = out;
  p.enc = enc;
  p.bh = static_cast<const float*>(ptrs[17]);
  auto kernel = heads_kernel<IPE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sm90::H_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  if (int rc = persistent_grid(n, &grid)) return rc;
  kernel<<<grid, sm90::BLOCK_THREADS, sm90::H_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

#else  // RSN_K11_FIRST_DESIGN: the first design, for the bit-for-bit check

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
                 const void* blob, const void* const* ptrs, bf16* out,
                 long long n, cudaStream_t stream) {
  (void)blob;
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

#endif  // RSN_K11_FIRST_DESIGN

// ---- the wgmma / mma.sync probe ---------------------------------------------
// One 64 x 256 x 256 bf16 product with fp32 sums, by both of Hopper's
// tensor-core instructions: wgmma m64n256k16 (A and B from shared memory in
// the layouts of trunk_sm90.cuh, B bulk-copied from a pre-packed blob) and
// wmma 16x16x16 (mma.sync m16n8k16, trunk()'s instruction), each sum k
// ascending in steps of 16 into one accumulator that starts at +0.  Equal
// bits say that the two instructions round a k-step's sum the same way.
constexpr int PROBE_SMEM =
    4 * sm90::W_CHUNK_BYTES + 4 * sm90::KB_BYTES + 1024 + 64;

__global__ void __launch_bounds__(128, 1)
    mma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const bf16* __restrict__ blob,
                     float* __restrict__ d_wgmma, float* __restrict__ d_mma) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Bs = align_1024(smem_raw);
  unsigned char* As = Bs + 4 * W_CHUNK_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(As + 4 * KB_BYTES);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 4 * W_CHUNK_BYTES);
    for (int c = 0; c < 4; ++c)
      bulk_load(Bs + c * W_CHUNK_BYTES,
                reinterpret_cast<const unsigned char*>(blob) +
                    c * W_CHUNK_BYTES,
                W_CHUNK_BYTES, bar);
  }
  for (int e = t; e < 64 * WIDTH; e += 128)
    *reinterpret_cast<bf16*>(As + swz(e / WIDTH, e % WIDTH)) = a[e];
  fence_async_smem();
  __syncthreads();
  mbar_wait(bar, 0);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  wgmma_fence();
  fence_regs<128>(acc);
#pragma unroll
  for (int ks = 0; ks < WIDTH / 16; ++ks)
    wgmma_n256(acc,
               desc_sw128(smem_u32(As + (ks >> 2) * KB_BYTES + (ks & 3) * 32)),
               desc_sw128(smem_u32(Bs + (ks >> 2) * W_CHUNK_BYTES +
                                   (ks & 3) * 32)));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<128>(acc);
#pragma unroll
  for (int i = 0; i < 128; ++i)
    d_wgmma[frag_row(t, i) * WIDTH + frag_col(t, i)] = acc[i];

  const int warp = t >> 5;
  for (int nt = 0; nt < WIDTH / 16; ++nt) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int ks = 0; ks < WIDTH / 16; ++ks) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + warp * 16 * WIDTH + ks * 16, WIDTH);
      wmma::load_matrix_sync(fb, w + ks * 16 * WIDTH + nt * 16, WIDTH);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(d_mma + warp * 16 * WIDTH + nt * 16, c, WIDTH,
                            wmma::mem_row_major);
  }
}

// K1 / K2 on a persistent grid of at most one block per SM.
template <bool HEADS>
int launch_render(const sm90::RenderParams& p, cudaStream_t stream) {
  constexpr int smem = sm90::smem_bytes<HEADS>();
  auto kernel = field_render_kernel<HEADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  if (int rc = persistent_grid(p.n, &grid)) return rc;
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

void fill_render(sm90::RenderParams* p, const void* mean_cov,
                 const void* ipe_consts, const void* blob,
                 const void* const* ptrs, void* out, long long n) {
  *p = sm90::RenderParams{};
  p->mc = static_cast<const float*>(mean_cov);
  p->consts = static_cast<const float*>(ipe_consts);
  p->blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p->b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p->n = n;
  p->out = static_cast<bf16*>(out);
}

}  // namespace

extern "C" {

// K1.  ptrs: w0..w7, b0..b7, w_hc, b_hc, w_out, b_out (device pointers; the
// kernel reads the weights from blob, the biases, w_hc's column 0 and w_out
// from ptrs); blob: trunk_sm90.pack_blob(w0..w7, w_hc).
// Returns a cudaError_t code (0 = launched).
int rsn_field_forward_v3(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* blob,
                         const void* const* ptrs, void* out, long long n,
                         int samples_per_ray, void* stream) {
  sm90::RenderParams p;
  fill_render(&p, mean_cov, ipe_consts, blob, ptrs, out, n);
  p.g = static_cast<const float*>(g_bands);
  p.S = samples_per_ray;
  p.w_hc = static_cast<const bf16*>(ptrs[16]);
  p.b_hc = static_cast<const float*>(ptrs[17]);
  p.w_out = static_cast<const bf16*>(ptrs[18]);
  p.b_out = static_cast<const float*>(ptrs[19]);
  return launch_render<true>(p, static_cast<cudaStream_t>(stream));
}

// K2.  ptrs: w0..w7, b0..b7, wd, bd; blob: trunk_sm90.pack_blob(w0..w7).
int rsn_field_forward_density(const void* mean_cov, const void* ipe_consts,
                              const void* blob, const void* const* ptrs,
                              void* out, long long n, void* stream) {
  sm90::RenderParams p;
  fill_render(&p, mean_cov, ipe_consts, blob, ptrs, out, n);
  p.wd = static_cast<const bf16*>(ptrs[16]);
  p.bd = static_cast<const float*>(ptrs[17]);
  return launch_render<false>(p, static_cast<cudaStream_t>(stream));
}

// K11.  blob: unfolded_sm90.pack_heads_blob of the operands; ptrs: w0..w7,
// b0..b7, wh, bh (pack_params, device pointers); out (N, 384) bf16.  The
// RSN_K11_FIRST_DESIGN build launches the first design and ignores blob.
int rsn_field_forward_v2(const void* mean_cov, const void* ipe_consts,
                         const void* blob, const void* const* ptrs, void* out,
                         long long n, void* stream) {
  return launch_heads<true>(static_cast<const float*>(mean_cov), nullptr,
                            static_cast<const float*>(ipe_consts), blob, ptrs,
                            static_cast<bf16*>(out), n,
                            static_cast<cudaStream_t>(stream));
}

// K12.  enc (N, 128) bf16; blob, ptrs and out as for K11.
int rsn_field_forward(const void* enc, const void* blob,
                      const void* const* ptrs, void* out, long long n,
                      void* stream) {
  return launch_heads<false>(nullptr, static_cast<const bf16*>(enc), nullptr,
                             blob, ptrs, static_cast<bf16*>(out), n,
                             static_cast<cudaStream_t>(stream));
}

// The probe: a (64, 256) bf16, w (256, 256) bf16 row-major, blob = w in
// four pre-packed 64-row chunks; d_wgmma, d_mma (64, 256) fp32.
int rsn_mma_probe(const void* a, const void* w, const void* blob,
                  void* d_wgmma, void* d_mma, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PROBE_SMEM);
  if (err != cudaSuccess) return (int)err;
  mma_probe_kernel<<<1, 128, PROBE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const bf16*>(blob), static_cast<float*>(d_wgmma),
      static_cast<float*>(d_mma));
  return (int)cudaGetLastError();
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
