// K8's weight gradients on Hopper (sm_90a): the workspace that K8's body
// stashes each 64-row tile's wgrad operands into ("kernel A",
// field_backward_body<..., STASH> in field_train.cu), and the contraction
// of that workspace by wgmma ("kernel B", wgrad_kernel below).  Part of
// K8 `field_backward_v4` (rsn/kernels/field_train.py:427), whose TPU
// kernel keeps per-group accumulators and sums them afterwards.
//
// The workspace: one record per 64-row tile of a chunk (tiles [t0, t1) of
// every block's run, record b (t1 - t0) + (t - t0)), each operand stored
// feature-major: F features x 64 rows, feature f's 64 bf16 values in 128
// bytes, the 16-byte group of rows 8g..8g+7 at position g ^ (f % 8).  That
// is trunk_sm90.cuh's K-major 128-byte swizzle (swz) with the sample rows as
// k, so 64 features of an activation are wgmma's A operand (8 KB) and a
// layer's 256 dpre columns its B operand (32 KB), each one contiguous piece
// that a 1-D bulk copy brings in.  A record (8,736 bytes per row):
//   X (128 features: the IPE tile, w0 and w4's x part) | hs0..hs7 (8 x 256)
//   | dpre0..dpre7 (8 x 256) | d_hc (144: w_hc's head columns 0..15 and the
//   mid seed's 128..255).
// Rows past the end of a block's rays are zero in every operand.
//
// Kernel B: dW_i += A_i^T dpre_i over the chunk's rows, for 18 output tiles
// of 128 input features x all N (w0: 1 tile, w1-w3 and w5-w7: 2 each, w4
// on [X, hs3]: 3, w_hc on hs7 against d_hc's 144 columns: 2), each over P
// slices of the chunk's records (grid 18 x P).  A block: one producer
// thread keeps a ring of STAGES 48 KB stages full (16 KB of A, a 32 KB or
// 18 KB B) with cp.async.bulk and an mbarrier per stage; two consumer
// warpgroups each own 64 of the tile's features as one m64n256 (m64n144)
// fp32 accumulator, 4 k-steps of 16 rows per record.  The accumulator
// starts at zero on a call's first chunk and at the slice's partial
// otherwise, and ends in the slice's own (PARTIAL_FLOATS) fp32 partial:
// one read and one write per chunk, no float atomics; the wrapper sums
// the P partials in a fixed order, so the result is the same from run to
// run.
//
// What bounds it: its bytes.  It reads each record once per output tile
// that needs it (~1.5x the workspace, the second reads of dpre mostly from
// L2, since a layer's tiles walk the same slice at the same time); its
// products are ~560 K MACs per row.
#pragma once

#include "trunk_sm90.cuh"

namespace {
namespace wgrad {

using sm90::bulk_load;
using sm90::desc_sw128;
using sm90::fence_regs;
using sm90::frag_col;
using sm90::frag_row;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

// ---- bulk copies from shared to global memory -----------------------------

// `bytes` (a multiple of 16) from shared src to global dst, in the calling
// thread's current bulk async-group, its lines first out of L2: a
// streaming write that should not push out what the block reads again
__device__ __forceinline__ void bulk_store_evict_first(void* dst,
                                                       const void* src,
                                                       int bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until at most N of the thread's newest groups still read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// until every group of the thread is complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr int REC_ROWS = TM;                       // rows per record
constexpr int FEAT_BYTES = REC_ROWS * 2;           // one feature's 64 rows
constexpr int ACT_BYTES = WIDTH * FEAT_BYTES;      // 256 features, 32 KB
constexpr int X_OFF = 0;
constexpr int ACT_OFF = X_OFF + ENC * FEAT_BYTES;
constexpr int DPRE_OFF = ACT_OFF + LAYERS * ACT_BYTES;
constexpr int DHC_OFF = DPRE_OFF + LAYERS * ACT_BYTES;
constexpr int REC_BYTES = DHC_OFF + sm90::HEAD_N * FEAT_BYTES;
static_assert(REC_BYTES == 559104, "8,736 bytes per row");

constexpr int TILE_FEATS = 128;                    // an output tile's rows
constexpr int A_BYTES = TILE_FEATS * FEAT_BYTES;   // 16 KB: two 8 KB A blocks
constexpr int STAGE = A_BYTES + ACT_BYTES;         // 48 KB
constexpr int STAGES = 4;
constexpr int OUT_TILES = 18;
constexpr int W_FLOATS = off_w(LAYERS);            // w0..w7, 524288
constexpr int PARTIAL_FLOATS = W_FLOATS + WIDTH * sm90::HEAD_N;  // + w_hc's
constexpr int SMEM_BYTES = STAGES * STAGE + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "kernel B exceeds 227 KB");
static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0 &&
                  ACT_OFF % 1024 == 0 && DHC_OFF % 1024 == 0,
              "swizzle atoms are 1024-byte aligned");

// ---- kernel A's side: the stores ----------------------------------------
//
// Each stash point's two operands (an activation or X, and the matching
// dpre or d_hc) are gathered from their shared tiles, transposed and
// swizzled, into two shared staging buffers, and two bulk copies write
// them to their places in the record: whole 128-byte lines, from the async
// proxy, first out of L2, while the block goes on to the next products.
// (Stored straight from the registers, a warp's 16-byte pieces land in 32
// different lines, which costs several times the bytes' own time:
// ablate_k8.py.)  The stash adds no barrier of its own: the gathers start
// after a barrier of the body, before which thread 0 has waited for the
// previous stash point's copies to read the buffers, and thread 0 starts
// the copies after the body's next barrier.

constexpr int STAGING_BYTES = ACT_BYTES;  // the largest operand, 32 KB
constexpr int STASH_SMEM_BYTES = 2 * STAGING_BYTES;

__device__ __forceinline__ void ldsm_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Rows 0..63 of nf features of a shared (64, *) bf16 tile (its columns
// from src, stride lds) into features f0.. (a multiple of 8) of a staging
// buffer in the record's layout.  A warp step moves 8 rows of 8 NM
// features: one ldmatrix.trans of NM 8 x 8 blocks (lane t receives rows
// 2 (t % 4) and 2 (t % 4) + 1 of feature t / 4 of each block; the padded
// row strides put a block's 8 rows in 8 bank groups) and NM 4-byte stores,
// each a quarter of a feature's 16-byte group (the swizzle spreads a
// store's 32 lanes over the 32 banks).
template <int NM>
__device__ void stage_steps(unsigned char* buf, const bf16* src, int lds,
                            int nf, int f0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fblocks = nf / (8 * NM);
  for (int it = warp; it < fblocks * 8; it += WARPS) {
    const int fs = (it % fblocks) * 8 * NM, g = it / fblocks;
    uint32_t r[NM];
    ldsm_trans(r, src + (8 * g + (lane & 7)) * lds + fs +
                      8 * ((lane >> 3) % NM));
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int fo = f0 + fs + 8 * m + (lane >> 2);
      *reinterpret_cast<uint32_t*>(buf + fo * FEAT_BYTES +
                                   ((g ^ (fo & 7)) << 4) + 4 * (lane & 3)) =
          r[m];
    }
  }
}

// ablate_k8.py's builds, which only time kernel A (the port sets neither
// macro): RSN_ABLATE_NO_STASH_COPY leaves out copy_out's copies,
// RSN_ABLATE_NO_STASH stage_rows's gathers as well.  Nothing else reads
// them.
#ifdef RSN_ABLATE_NO_STASH
#define RSN_ABLATE_NO_STASH_COPY
#endif

// nf: a multiple of 16 (the heads' 16 columns), else of 32.
__device__ void stage_rows(unsigned char* buf, const bf16* src, int lds,
                           int nf, int f0 = 0) {
#ifndef RSN_ABLATE_NO_STASH
  if (nf % 32 == 0)
    stage_steps<4>(buf, src, lds, nf, f0);
  else
    stage_steps<2>(buf, src, lds, nf, f0);
#endif
}

// The two staging buffers; thread 0 starts, commits and waits for every
// copy.
struct Stash {
  unsigned char* buf;  // STASH_SMEM_BYTES of shared memory
  __device__ unsigned char* second() const { return buf + STAGING_BYTES; }
  // before the barrier that precedes the gathers: the previous stash
  // point's copies have read both buffers
  __device__ void wait_free() const {
    if (threadIdx.x == 0) bulk_wait_read<0>();
  }
  // after a thread's gathers: its writes visible to the copies
  __device__ void gathered() const { sm90::fence_async_smem(); }
  // after a barrier that follows every thread's gathered(): the first
  // buffer's bytes0 to dst0, the second's bytes1 to dst1
  __device__ void copy_out(unsigned char* dst0, int bytes0,
                           unsigned char* dst1, int bytes1) const {
    if (threadIdx.x == 0) {
#ifndef RSN_ABLATE_NO_STASH_COPY
      bulk_store_evict_first(dst0, buf, bytes0);
      bulk_store_evict_first(dst1, second(), bytes1);
#endif
      bulk_commit();
    }
  }
  // before the block exits: every copy complete
  __device__ void drain() const {
    if (threadIdx.x == 0) bulk_wait_all();
  }
};

// A record with no rows (a block whose run ends before the chunk's tiles).
__device__ void zero_record(unsigned char* __restrict__ rec) {
  for (int e = threadIdx.x; e < REC_BYTES / 16; e += THREADS)
    reinterpret_cast<uint4*>(rec)[e] = make_uint4(0u, 0u, 0u, 0u);
}

// ---- kernel B -------------------------------------------------------------

struct OutTile {
  int a_off;    // byte offset of its 128 A features in a record
  int b_off;    // of its B operand
  int b_bytes;  // 32 KB (a trunk layer's dpre) or 18 KB (d_hc)
  int n;        // 256 or 144
  int out_off;  // float offset of its first row in a partial
};

__device__ __forceinline__ int in_rows(int layer) {
  return layer == 0 ? ENC : layer == SKIP_AT ? ENC + WIDTH : WIDTH;
}

// Output tile t: layers 0..7 by their 128-row blocks, then w_hc's two.
__device__ OutTile out_tile(int t) {
  int layer = 0, fb = t;
  while (layer < LAYERS && fb >= in_rows(layer) / TILE_FEATS) {
    fb -= in_rows(layer) / TILE_FEATS;
    ++layer;
  }
  OutTile o;
  if (layer == LAYERS) {  // w_hc on hs7
    o.a_off = ACT_OFF + (LAYERS - 1) * ACT_BYTES + fb * A_BYTES;
    o.b_off = DHC_OFF;
    o.b_bytes = sm90::HEAD_N * FEAT_BYTES;
    o.n = sm90::HEAD_N;
    o.out_off = W_FLOATS + fb * TILE_FEATS * sm90::HEAD_N;
    return o;
  }
  if (layer == 0 || (layer == SKIP_AT && fb == 0))
    o.a_off = X_OFF;
  else if (layer == SKIP_AT)
    o.a_off = ACT_OFF + (SKIP_AT - 1) * ACT_BYTES + (fb - 1) * A_BYTES;
  else
    o.a_off = ACT_OFF + (layer - 1) * ACT_BYTES + fb * A_BYTES;
  o.b_off = DPRE_OFF + layer * ACT_BYTES;
  o.b_bytes = ACT_BYTES;
  o.n = WIDTH;
  o.out_off = off_w(layer) + fb * TILE_FEATS * WIDTH;
  return o;
}

// The producer thread: the slice's records in order, A then B per stage.
__device__ void produce_records(const unsigned char* __restrict__ ws,
                                long long r0, long long r1, const OutTile& o,
                                unsigned char* ring, uint64_t* full,
                                uint64_t* empty) {
  int st = 0;
  uint32_t ph = 0;
  for (long long r = r0; r < r1; ++r) {
    mbar_wait(&empty[st], ph ^ 1);
    const unsigned char* rec = ws + r * REC_BYTES;
    unsigned char* s = ring + st * STAGE;
    mbar_expect_tx(&full[st], A_BYTES + o.b_bytes);
    bulk_load(s, rec + o.a_off, A_BYTES, &full[st]);
    bulk_load(s + A_BYTES, rec + o.b_off, o.b_bytes, &full[st]);
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
}

// A consumer warpgroup (c: its 64 features) over `count` records: acc =
// A^T B from zero, k ascending in steps of 16 rows, then to dst (its rows
// at stride N), added to dst's value by an fp32 add when accumulating.
// (The tensor cores' adds truncate: a chain that carried the sum of the
// earlier chunks in acc lost ~7e-5 of a weight's max over a pass-2 call,
// k8_margin.py; each chunk's chain starts from zero.)  Each stage is
// released (one arrival per warp) once the products that read it are done.
template <int N>
__device__ void consume_records(const unsigned char* ring, uint64_t* full,
                                uint64_t* empty, long long count, float* dst,
                                bool accumulate, int c, int t) {
  constexpr int R = N / 2;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  fence_regs<R>(acc);
  const bool lane0 = (t & 31) == 0;
  int st = 0, prev = 0;
  uint32_t ph = 0;
  for (long long j = 0; j < count; ++j) {
    const uint32_t a = smem_u32(ring + st * STAGE) + c * sm90::KB_BYTES;
    const uint32_t b = smem_u32(ring + st * STAGE + A_BYTES);
    mbar_wait(&full[st], ph);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < REC_ROWS / 16; ++k) {
      if constexpr (N == WIDTH)
        sm90::wgmma_n256(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
      else
        sm90::wgmma_n144(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      fence_regs<R>(acc);
      if (lane0) mbar_arrive(&empty[prev]);
    }
    prev = st;
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<R>(acc);
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    float2* d =
        reinterpret_cast<float2*>(dst + frag_row(t, i) * N + frag_col(t, i));
    float2 v = make_float2(acc[i], acc[i + 1]);
    if (accumulate) {
      const float2 old = *d;
      v = make_float2(__fadd_rn(old.x, v.x), __fadd_rn(old.y, v.y));
    }
    *d = v;
  }
}

// Block (output tile blockIdx.x, slice blockIdx.y of gridDim.y) of a chunk
// of `records` records at ws; partial: gridDim.y slices of PARTIAL_FLOATS.
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    wgrad_kernel(const unsigned char* __restrict__ ws,
                 float* __restrict__ partial, long long records,
                 int accumulate) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const OutTile o = out_tile(blockIdx.x);
  const long long r0 = records * blockIdx.y / gridDim.y;
  const long long r1 = records * (blockIdx.y + 1) / gridDim.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], sm90::CONSUMERS * 4);  // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wgi = threadIdx.x / sm90::WG_THREADS;
  if (wgi == 0) {
    sm90::setmaxnreg_dec40();
    if (threadIdx.x == 0) produce_records(ws, r0, r1, o, ring, full, empty);
    return;
  }
  sm90::setmaxnreg_inc232();
  const int c = wgi - 1, t = threadIdx.x % sm90::WG_THREADS;
  float* dst = partial + (long long)blockIdx.y * PARTIAL_FLOATS + o.out_off +
               c * 64 * o.n;
  if (o.n == WIDTH)
    consume_records<WIDTH>(ring, full, empty, r1 - r0, dst, accumulate != 0,
                           c, t);
  else
    consume_records<sm90::HEAD_N>(ring, full, empty, r1 - r0, dst,
                                  accumulate != 0, c, t);
}

int launch_wgrad(const void* ws, void* partial, long long records,
                 int slices, int accumulate, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<dim3(OUT_TILES, slices), sm90::BLOCK_THREADS, SMEM_BYTES,
                 stream>>>(static_cast<const unsigned char*>(ws),
                           static_cast<float*>(partial), records, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace wgrad
}  // namespace
