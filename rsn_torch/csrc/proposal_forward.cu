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
// mean and cov columns) and 4 B written, and 2 * (51 * 64 + 3 * 64 * 64 +
// 64) = 31,232 FLOP of products on the tensor cores (0.033 ms for 2^20 rows
// at the bf16 peak; the bytes take 0.009 ms).  Each row also takes 48
// full-precision sinf and 24 expf on the CUDA cores: each sinf is some 25
// instructions on its fast path (range reduction by three FFMAs, a
// polynomial, the |x| >= 105615 test around the slow path), so the IPE is
// most of the kernel's instructions, and the issue slots they take, not
// the products or the bytes, set the floor.  chip_smoke.py phase 9 counts
// them in this kernel's SASS and gives the floor (PERF.md).
//
// What the design does about it: a 4 x 64 MLP fits whole on an SM (32 KB of
// bf16 weights), so each warp runs the whole function on its own rows with
// the activations in registers, and nothing but the weights is shared.
//   - A block of 4 warps copies the four weight matrices (padded rows: the
//     ldmatrix reads below are free of bank conflicts), the biases and the
//     head column into shared memory once, behind its only barrier.  Then
//     each warp walks its own 16-row tiles (tile w, w + W, ... of the W
//     warps of a persistent grid sized by the occupancy the kernel allows:
//     an even split, at most one tile apart), with no block barrier: one
//     warp's IPE on the CUDA cores runs beside another's products on the
//     tensor cores.  At most 102 registers a thread keep 20 warps on an
//     SM; two m-tiles per warp would share each B fragment but need some
//     160 registers, and so halve the warps that hide each other's
//     latency.
//   - The products are mma.sync m16n8k16 (bf16 in, fp32 sums): a warp owns
//     16 rows, and the tiles are small (N = 64, K = 64), so the synchronous
//     instruction serves as well as wgmma here and keeps each warp
//     independent of the others.  B fragments come from shared memory
//     through ldmatrix.trans, one x4 per (k-step, pair of n-tiles).
//   - The IPE goes straight into layer 0's A fragments: lane (g, t) holds
//     rows g and g + 8 and columns 16 ks + 2 t + {0, 1, 8, 9}, so it owns
//     the sine and the cosine column of (d, k) for k in {2 t, 2 t + 1} and
//     every d, and computes each damping expf(-var / 2) once for both
//     (24 expf a row, not 48).  The mean columns are lanes t = 0, 1's;
//     the 13 zero columns cost nothing.  Only the 24 live bytes of a row
//     are read, one tile ahead of their use.
//   - Layer to layer in registers: the C fragment of m16n8k16 (rows g,
//     g + 8, columns 8 j + 2 t + {0, 1}) is, pair by pair, the A fragment
//     of the next product, so the bias (__fadd_rn), the NaN-keeping ReLU
//     (max.NaN, one instruction) and the bf16 rounding turn layer l's sums
//     into layer l + 1's operand without a shuffle.
//   - The 64 -> 1 head keeps the first design's order: row r's quarter q
//     sums columns q, q + 4, ..., q + 60 in one fma chain from +0, lane t
//     = q gathering them from its group by two shuffles per 8 columns;
//     then the two xor shuffles and the bias.
//   - Same bits as the first design: the IPE's roundings (__fmul_rn for
//     the phase and the variance, the cosine as sinf(pre + f32(pi / 2)),
//     full-precision sinf and expf, no fast-math intrinsics: the phases
//     reach 2 pi 256 2 ~ 3.2e3 rad), each product's fp32 sums k ascending
//     in steps of 16 from +0 (wmma 16x16x16 runs as mma.sync m16n8k16 on
//     this card), the epilogue's and the head's.  The first design is kept
//     below under RSN_K9_FIRST_DESIGN, which only chip_smoke.py and the
//     card tests build, to hold the two equal bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#ifdef RSN_K9_FIRST_DESIGN
#include <mma.h>
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WIDTH = 64;       // trunk width == the padded IPE width
constexpr int LAYERS = 4;
constexpr int IN_COLS = 16;
constexpr int NFREQ = 8;
constexpr int HEAD_COLS = 8;    // the packed head's width, column 0 live
constexpr float HALF_PI = 1.57079637f;   // f32(pi / 2)

struct PropParams {
  const bf16* w[LAYERS];   // (64, 64) row-major (in, out); layer 0's rows
                           // 51..63 are zero
  const float* b[LAYERS];  // (64,)
  const bf16* wd;          // (64, 8), column 0 live
  const float* bd;         // (8,)
};

// The persistent grid: as many blocks as the card holds at once, at most
// one per `per_block` units of work.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem,
                            long long units, int per_block, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (units + per_block - 1) / per_block;
  const long long slots = (long long)sms * per_sm;
  *grid = (unsigned)(want < slots ? want : slots);
  return cudaSuccess;
}

#ifndef RSN_K9_FIRST_DESIGN

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 5;        // <= 102 registers: 20 warps an SM
constexpr int ROWS = 16;             // rows per warp tile (one m-tile)
constexpr int KS = WIDTH / 16;       // k-steps per product
constexpr int NT = WIDTH / 8;        // n-tiles of 8 columns
constexpr int LDW = WIDTH + 8;       // padded weight rows (bf16)

struct Shared {
  bf16 w[LAYERS][WIDTH][LDW];
  float b[LAYERS][WIDTH];
  float head[WIDTH];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a @ b on one m16n8k16 tile (bf16 operands, fp32 sums).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first design's ReLU, v < 0 ? 0 : v, in one instruction: max.NaN
// keeps a NaN (as the canonical NaN that the bias add already gives); a
// sum from +0 is never -0, so the zeros agree too.
__device__ __forceinline__ float relu_keep_nan(float v) {
  asm("max.NaN.f32 %0, %0, 0f00000000;" : "+f"(v));
  return v;
}

// Two f32 -> one bf16x2 register: lo in bits 0..15 (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// One row's inputs: mean (3) and cov_diag (3).
struct RowIn {
  float m[3], c[3];
};

__device__ __forceinline__ RowIn load_row(const float* __restrict__ mc,
                                          long long row, long long n) {
  RowIn r;
  if (row < n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(mc + row * IN_COLS));
    const float2 b =
        __ldg(reinterpret_cast<const float2*>(mc + row * IN_COLS + 4));
    r.m[0] = a.x, r.m[1] = a.y, r.m[2] = a.z;
    r.c[0] = a.w, r.c[1] = b.x, r.c[2] = b.y;
  } else {
    r.m[0] = r.m[1] = r.m[2] = r.c[0] = r.c[1] = r.c[2] = 0.f;
  }
  return r;
}

// Layer 0's A fragments of one row half h (row g + 8 h) straight from the
// IPE.  Lane (g, t) holds columns 16 ks + 2 t + {0, 1} (register h) and
// 16 ks + 8 + 2 t + {0, 1} (register 2 + h): the sine and the cosine of
// (d, k) for k = 2 t + e, every d; sc / vk are f32(2 pi f_k) and f32(f_k^2)
// of those k.
__device__ __forceinline__ void ipe_fragment(uint32_t (&a)[KS][4],
                                             const RowIn& r, int h, int t,
                                             const float (&sc)[2],
                                             const float (&vk)[2]) {
  float s[3][2], c[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pre = __fmul_rn(r.m[d], sc[e]);
      const float var = __fmul_rn(r.c[d], vk[e]);
      const float damp = expf(__fmul_rn(-0.5f, var));
      s[d][e] = __fmul_rn(damp, sinf(pre));
      c[d][e] = __fmul_rn(damp, sinf(__fadd_rn(pre, HALF_PI)));
    }
  }
  // columns 0..23: damp*sin, d * 8 + k; 24..47: damp*cos
  a[0][h] = pack_bf16(s[0][0], s[0][1]);
  a[0][2 + h] = pack_bf16(s[1][0], s[1][1]);
  a[1][h] = pack_bf16(s[2][0], s[2][1]);
  a[1][2 + h] = pack_bf16(c[0][0], c[0][1]);
  a[2][h] = pack_bf16(c[1][0], c[1][1]);
  a[2][2 + h] = pack_bf16(c[2][0], c[2][1]);
  // columns 48..50: the mean; 51..63: zero
  a[3][h] = t == 0 ? pack_bf16(r.m[0], r.m[1])
                   : (t == 1 ? pack_bf16(r.m[2], 0.f) : 0u);
  a[3][2 + h] = 0u;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    prop_forward_kernel(const float* __restrict__ mc,
                        const float* __restrict__ consts, PropParams p,
                        float* __restrict__ out, long long n) {
  __shared__ __align__(16) Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // once per block: the weights (16-byte copies), biases, head column
  constexpr int ROW_VECS = WIDTH / 8;  // uint4 per weight row
  for (int e = tid; e < LAYERS * WIDTH * ROW_VECS; e += THREADS) {
    const int l = e / (WIDTH * ROW_VECS), r = (e / ROW_VECS) % WIDTH,
              v = e % ROW_VECS;
    *reinterpret_cast<uint4*>(&sh.w[l][r][v * 8]) =
        reinterpret_cast<const uint4*>(p.w[l])[r * ROW_VECS + v];
  }
  for (int e = tid; e < LAYERS * WIDTH; e += THREADS)
    sh.b[e / WIDTH][e % WIDTH] = p.b[e / WIDTH][e % WIDTH];
  if (tid < WIDTH) sh.head[tid] = __bfloat162float(p.wd[tid * HEAD_COLS]);
  const float bd0 = p.bd[0];
  const float sc[2] = {consts[2 * t], consts[2 * t + 1]};
  const float vk[2] = {consts[NFREQ + 2 * t], consts[NFREQ + 2 * t + 1]};
  __syncthreads();

  // ldmatrix.x4.trans row addresses: matrix q = lane / 8 is (k-half q % 2,
  // n-tile q / 2) of a (16 k x 16 n) block, row lane % 8 of it
  const int lq = lane >> 3;
  const int b_off = ((lq & 1) * 8 + (lane & 7)) * LDW + (lq >> 1) * 8;

  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long wstride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  RowIn nxt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    nxt[h] = load_row(mc, tile * ROWS + h * 8 + g, n);

  for (; tile < tiles; tile += wstride) {
    const long long row0 = tile * ROWS;
    uint32_t a[KS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const RowIn cur = nxt[h];
      // the next tile's rows, in flight under this tile's work
      nxt[h] = load_row(mc, (tile + wstride) * ROWS + h * 8 + g, n);
      ipe_fragment(a, cur, h, t, sc, vk);
    }

#pragma unroll 1
    for (int l = 0; l < LAYERS; ++l) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      const bf16* wl = &sh.w[l][0][0] + b_off;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_trans(b, wl + ks * 16 * LDW + jp * 16);
          mma16816(acc[2 * jp], a[ks], b[0], b[1]);
          mma16816(acc[2 * jp + 1], a[ks], b[2], b[3]);
        }
      }
      // bias, ReLU keeping NaN, bf16: C pair j of rows g / g + 8 is A
      // register (j % 2) * 2 + {0, 1} of k-step j / 2
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bj =
            *reinterpret_cast<const float2*>(&sh.b[l][8 * j + 2 * t]);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = relu_keep_nan(
              __fadd_rn(acc[j][i], (i & 1) ? bj.y : bj.x));
        a[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
        a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
      }
    }

    // head: lane t sums quarter t of its rows, columns 8 m + 4 p + t
    // (p = 0, 1), which lane 2 p + t / 2 of its group holds in register
    // pair m, half t % 2
    const int src0 = (lane & ~3) | (t >> 1), src1 = src0 | 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        const uint32_t r = a[m >> 1][(m & 1) * 2 + h];
        const uint32_t v0 = __shfl_sync(0xffffffffu, r, src0);
        const uint32_t v1 = __shfl_sync(0xffffffffu, r, src1);
        s = __fmaf_rn((t & 1) ? bf16_hi(v0) : bf16_lo(v0),
                      sh.head[8 * m + t], s);
        s = __fmaf_rn((t & 1) ? bf16_hi(v1) : bf16_lo(v1),
                      sh.head[8 * m + 4 + t], s);
      }
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      const long long row = row0 + h * 8 + g;
      if (t == 0 && row < n) out[row] = __fadd_rn(s, bd0);
    }
  }
}

int launch_prop(const float* mc, const float* consts, const PropParams& p,
                float* out, long long n, cudaStream_t stream) {
  unsigned grid = 0;
  cudaError_t err = persistent_grid(prop_forward_kernel, THREADS, 0,
                                    (n + ROWS - 1) / ROWS, WARPS, &grid);
  if (err != cudaSuccess) return (int)err;
  prop_forward_kernel<<<grid, THREADS, 0, stream>>>(mc, consts, p, out, n);
  return (int)cudaGetLastError();
}

#else  // RSN_K9_FIRST_DESIGN: the first design, for the bit-for-bit check

// A block of 8 warps copies the weights, biases, head column and IPE
// constants into shared memory once, then walks 64-row tiles
// (grid-stride): the tile's rows staged with 16-byte loads, the IPE tile
// written there as bf16, four wmma 16x16x16 layers ping-ponging between
// two 64 x 64 bf16 tiles (warp w: columns [16 (w % 4), +16) of row tiles
// 2 (w / 4), 2 (w / 4) + 1; each accumulator drained through a per-warp
// f32 stage), the head four threads per row; seven block barriers a tile.
using namespace nvcuda;

constexpr int TM = 64;          // rows per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SIN_COLS = 3 * NFREQ;      // 24 per half
constexpr int IPE_DIM = 6 * NFREQ + 3;   // 51

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

int launch_prop(const float* mc, const float* consts, const PropParams& p,
                float* out, long long n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      prop_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  err = persistent_grid(prop_forward_kernel, THREADS, SMEM_BYTES, n, TM,
                        &grid);
  if (err != cudaSuccess) return (int)err;
  prop_forward_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(mc, consts, p,
                                                             out, n);
  return (int)cudaGetLastError();
}

#endif  // RSN_K9_FIRST_DESIGN

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
  return launch_prop(static_cast<const float*>(mean_cov),
                     static_cast<const float*>(consts), p,
                     static_cast<float*>(out), n,
                     static_cast<cudaStream_t>(stream));
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
