// Hopper (sm_90a) building blocks of the field kernels on 128-row tiles: the
// render path's K1 (field_forward_v3) and K2 (field_forward_density) and the
// field API's K11 (field_forward_v2) and K12 (field_forward, heads_sm90.cuh)
// in field_forward.cu, the train-width forwards K3 (field_forward_v6), K7
// (field_forward_v4) and K1 at the train width (train_sm90.cuh, in
// field_train.cu), and the tools' K14 / K15 (unfolded_sm90.cuh, in
// experiments.cu): shared-memory layouts for wgmma's operands, the
// mbarrier / bulk-copy ring that feeds the weights, the wgmma instructions,
// and the persistent block they share.
//
// Layout (every operand tile K-major, 128-byte swizzle): a tile of R rows
// by 64 k-values (bf16) is R x 128 bytes; element (r, k) lies at byte
//   r * 128 + ((k / 8) ^ (r % 8)) * 16 + (k % 8) * 2
// of its 1024-byte aligned base.  A wider operand is a row of such
// "k-blocks".  The activations of a 64-row warpgroup tile are wgmma's A
// operand in this layout (k-blocks of 64 x 64, 8 KB); each 64-row chunk
// of a weight matrix, transposed to (N, 64), is its B operand (the
// wrapper pre-packs the weights into these chunks once,
// rsn_torch/kernels/trunk_sm90.py).  One wgmma k-step reads 16 k-values:
// the descriptor's start address moves by 32 bytes within the k-block.
#pragma once

#include "field_common.cuh"

namespace {
namespace sm90 {

constexpr int CHUNK_K = 64;                       // k-values per weight chunk
constexpr int KB_BYTES = 64 * CHUNK_K * 2;        // k-block of 64 rows, 8 KB
constexpr int W_CHUNK_BYTES = WIDTH * CHUNK_K * 2;   // trunk chunk, 32 KB
constexpr int HEAD_N = 16 + MID;                  // w_hc's used columns
constexpr int HEAD_CHUNK_BYTES = HEAD_N * CHUNK_K * 2;  // 18 KB

// byte offset of element (r, k) in a row of 64-row k-blocks
__device__ __forceinline__ int swz(int r, int k) {
  return (k >> 6) * KB_BYTES + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4) +
         ((k & 7) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major, 128-byte swizzled operand at shared
// address `a` (8-row groups 1024 bytes apart; the leading offset is unused
// by this layout)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- mbarriers and the bulk copy -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// (the mbarrier at shared address a)
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(a)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

// spin until the phase of parity `parity` of the mbarrier at shared address
// a has completed; a phase that never completes (a ring out of step) traps
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// `bytes` (a multiple of 16) from global src to shared dst, completion
// reported to `bar` as transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// generic-proxy writes to shared memory, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
// instructions it does not see into
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += A (64 x 16, smem, K-major, 128B swizzle) @ B (16 x 256, smem,
// K-major, 128B swizzle); acc is the m64n256 fp32 fragment.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A (64 x 16, smem, K-major, 128B swizzle) @ B (16 x 144, smem,
// K-major, 128B swizzle); acc is the m64n144 fp32 fragment.
__device__ __forceinline__ void wgmma_n144(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A (64 x 16, smem, K-major, 128B swizzle) @ B (16 x 104, smem,
// K-major, 128B swizzle); acc is the m64n104 fp32 fragment (the normals'
// x share: the IPE's 99 live dimensions).
__device__ __forceinline__ void wgmma_n104(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A (64 x 16, smem, K-major, 128B swizzle) @ B (16 x 128, smem,
// K-major, 128B swizzle); acc is the m64n128 fp32 fragment (K14 / K15's mid
// seed).
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A (64 x 16, smem, K-major, 128B swizzle) @ B (16 x 16, smem,
// K-major, 128B swizzle); acc is the m64n16 fp32 fragment (K14 / K15's head
// columns).
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// Register i of an m64nN fp32 fragment of warpgroup thread t holds
// (row, col) = (16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
//               8 (i / 4) + 2 (t % 4) + i % 2).
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// ---- the render trunk: K1 and K2 on 128-row tiles ----------------------------
//
// Block: 3 warpgroups.  Warpgroup 0 is the producer: one thread streams the
// blob's chunks (the trunk's 32, then K1's 4 head chunks, again for every
// tile) into a ring of STAGES 32 KB stages, each with a "full" mbarrier
// (the bulk copy's bytes) and an "empty" one (one arrival per consumer
// warp once its products have read the stage).  Warpgroups 1 and 2 are
// the consumers: each owns 64 rows of the block's 128-row tile, its IPE
// tile X (64 x 128) and its activations H (64 x 256) in shared memory in
// the A layout, and runs every layer as one m64n256 wgmma accumulator over
// the layer's chunks, k ascending, then the bias + ReLU + bf16 epilogue
// from the accumulator registers into H (a layer's output overwrites its
// input: the rows are private to the warpgroup).  Persistent: a grid of at
// most one block per SM walks the tiles; the ring runs on across layers
// and tiles, so the next weights arrive during the products and the tail.

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;
constexpr int BLOCK_THREADS = WG_THREADS * (1 + CONSUMERS);
constexpr int WG_ROWS = 64;
constexpr int TILE_ROWS = WG_ROWS * CONSUMERS;   // 128
constexpr int STAGES = 3;
constexpr int TRUNK_CHUNKS = 32;
constexpr int HEAD_CHUNKS = 4;
constexpr int X_WG_BYTES = 2 * KB_BYTES;         // 64 x 128 bf16
constexpr int H_WG_BYTES = 4 * KB_BYTES;         // 64 x 256 bf16
constexpr int HS_COLS = 16;                      // K1: f32 head sums
constexpr int ROWF = 8;                          // K1: per-row scalars
constexpr int TAIL_WG_BYTES = WG_ROWS * (HS_COLS + ROWF) * 4;

constexpr int OFF_RING = 0;
constexpr int OFF_XS = OFF_RING + STAGES * W_CHUNK_BYTES;
constexpr int OFF_HS = OFF_XS + CONSUMERS * X_WG_BYTES;
// the block's f32 copies of the density weights (256) and, for K1, of
// w_out's three live columns (128 x float4)
constexpr int OFF_WD = OFF_HS + CONSUMERS * H_WG_BYTES;
constexpr int OFF_WOUT = OFF_WD + WIDTH * 4;
constexpr int OFF_TAIL = OFF_WOUT + MID * 16;
template <bool HEADS>
__host__ __device__ constexpr int off_bars() {
  return HEADS ? OFF_TAIL + CONSUMERS * TAIL_WG_BYTES : OFF_WOUT;
}
// + 1024: the base is aligned up to 1024 bytes at run time
template <bool HEADS>
__host__ __device__ constexpr int smem_bytes() {
  return off_bars<HEADS>() + 2 * STAGES * 8 + 1024;
}
static_assert(smem_bytes<true>() <= 232448, "K1 exceeds 227 KB");

__host__ __device__ constexpr int layer_chunks(int layer) {
  return layer == 0 ? 2 : layer == SKIP_AT ? 6 : 4;
}

// The normals' dgrad chunks (the train-width forwards with the normals), a
// tile's chunks FWD_CHUNKS.. of the ring: dinp = dpre @ W_i^T for layers 7
// down to 0, each as 4 chunks of 64 of W_i's 256 output columns (k), k
// ascending.  wgmma's K-major B operand of dpre @ W_i^T is W_i itself, rows
// (its input dimensions) as N: chunk (i, k0) holds W_i[r0 : r0 + N, k0 :
// k0 + 64] in the swizzled (N, 64) layout.  Layers 1-3 and 5-7: N = 256
// (32 KB).  Layer 4: first its x share (rows 0..103: the IPE's 99 live
// dimensions to a multiple of 8, 13 KB a chunk), then its h part (rows
// 128..383); layer 0: the x share alone.  Dgrad chunk d: layer 7 (0-3), 6,
// 5, 4's x share (12-15), 4's h part (16-19), 3, 2, 1, 0's x share
// (32-35).
constexpr int FWD_CHUNKS = TRUNK_CHUNKS + HEAD_CHUNKS;  // 36
constexpr int DGRAD_CHUNKS = 36;
constexpr int XS_N = 104;
constexpr int XS_CHUNK_BYTES = XS_N * CHUNK_K * 2;      // 13 KB
__host__ __device__ constexpr int dgrad_layer(int d) {
  return d < 12 ? LAYERS - 1 - d / 4 : d < 20 ? SKIP_AT : 3 - (d - 20) / 4;
}
__host__ __device__ constexpr bool dgrad_x_share(int d) {
  return (d >= 12 && d < 16) || d >= 32;
}
// the first row of W_i that dgrad chunk d holds
__host__ __device__ constexpr int dgrad_row0(int d) {
  return d >= 16 && d < 20 ? ENC : 0;
}
// chunk c of a tile (the trunk's, the heads', then the dgrad's): its bytes
__host__ __device__ constexpr int chunk_bytes(int c) {
  return c < TRUNK_CHUNKS ? W_CHUNK_BYTES
         : c < FWD_CHUNKS ? HEAD_CHUNK_BYTES
         : dgrad_x_share(c - FWD_CHUNKS) ? XS_CHUNK_BYTES
                                         : W_CHUNK_BYTES;
}
__host__ __device__ constexpr long long blob_bytes(int chunks) {
  long long b = 0;
  for (int c = 0; c < chunks; ++c) b += chunk_bytes(c);
  return b;
}
static_assert(blob_bytes(FWD_CHUNKS + DGRAD_CHUNKS) == 2146304,
              "the train blob: 1,122,304 forward + 1,024,000 dgrad bytes");

// The unfolded heads' ring chunks (pack_params' wh: the K11 / K12 blob,
// and the first HEADS_TILE_CHUNKS of K14 / K15's): the trunk's 32, then the
// head columns wh[:, 256:272] (4 chunks of 64 x 16), then the bottleneck
// wh[:, 0:256] (4 of 64 x 256); rsn_torch/kernels/unfolded_sm90.py packs
// them.
constexpr int HC_N = 16;                             // wh's head columns
constexpr int HEADS_TILE_CHUNKS = TRUNK_CHUNKS + 8;  // 40
__host__ __device__ constexpr int heads_chunk_bytes(int c) {
  return c < TRUNK_CHUNKS ? W_CHUNK_BYTES
         : c < TRUNK_CHUNKS + 4 ? HC_N * CHUNK_K * 2
                                : W_CHUNK_BYTES;
}

struct RenderParams {
  const float* mc;       // (n, 16) f32
  const float* consts;   // IPE constants
  const unsigned char* blob;  // the ring's chunks (trunk_sm90.py)
  const float* b[LAYERS];
  long long n;
  bf16* out;
  // K2
  const bf16* wd;        // (256, 8), column 0 live
  const float* bd;
  // K1
  const float* g;        // (n / S, 512) f32
  int S;
  const bf16* w_hc;      // (256, 256): column 0 is the density head
  const float* b_hc;
  const bf16* w_out;     // (128, 128), 3 live columns
  const float* b_out;
};

__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}

// named barrier of consumer warpgroup wg (ids 2, 3)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(2 + wg), "n"(WG_THREADS) : "memory");
}

// The producer thread: the first `chunks` chunks of the blob (back to back,
// chunk c of bytes_of(c) bytes) for every tile of this block, in order.
template <typename Bytes>
__device__ void produce_chunks(const unsigned char* __restrict__ blob,
                               unsigned char* ring, uint64_t* full,
                               uint64_t* empty, int chunks, int ntiles,
                               const Bytes& bytes_of) {
  int st = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    long long off = 0;
    for (int c = 0; c < chunks; ++c) {
      const int bytes = bytes_of(c);
      mbar_wait(&empty[st], ph ^ 1);
#ifdef RSN_ABLATE_NO_LOAD  // ablate_render.py: the ring without its copies
      mbar_arrive(&full[st]);
#else
      mbar_expect_tx(&full[st], bytes);
      bulk_load(ring + st * W_CHUNK_BYTES, blob + off, bytes, &full[st]);
#endif
      off += bytes;
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// The blob of K1, K2 and the train-width forwards (chunk_bytes).
__device__ void produce(const unsigned char* __restrict__ blob,
                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                        int chunks, int ntiles) {
  produce_chunks(blob, ring, full, empty, chunks, ntiles,
                 [](int c) { return chunk_bytes(c); });
}

// A consumer warpgroup's place in the ring.
struct RingPos {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int st;
  uint32_t ph;
  __device__ void advance() {
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
};

// No hand-off of the tensor cores around a chunk's products (every kernel
// but K15's turns, unfolded_sm90.cuh).
struct NoChunkTurn {
  __device__ void before() {}
  __device__ void after() {}
};

// acc (an m64nN fragment, zeroed by the caller) += A @ the next `chunks`
// ring stages; A's chunk j at a_base(j), with ksteps(j) k-steps of 16.
// Each stage is released (one arrival per warp) once its products are done.
// turn.before() runs before a chunk's products are issued, turn.after()
// as soon as they are.
template <int N, typename ABase, typename KSteps, typename Turn>
__device__ __forceinline__ void mma_chunks(float* acc, RingPos& rp,
                                           int chunks, const ABase& a_base,
                                           const KSteps& ksteps, Turn& turn) {
  constexpr int R = N / 2;
  const bool lane0 = (threadIdx.x & 31) == 0;
  int prev = 0;
  for (int j = 0; j < chunks; ++j) {
    const uint32_t a = a_base(j);
    const uint32_t b = smem_u32(rp.ring + rp.st * W_CHUNK_BYTES);
    const int ks = ksteps(j);
    turn.before();
    mbar_wait(&rp.full[rp.st], rp.ph);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
        if constexpr (N == 256)
          wgmma_n256(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        else if constexpr (N == HEAD_N)
          wgmma_n144(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        else if constexpr (N == XS_N)
          wgmma_n104(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        else if constexpr (N == 128)
          wgmma_n128(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        else {
          static_assert(N == 16, "N: 256, 144, 104, 128 or 16");
          wgmma_n16(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        }
      }
    }
    wgmma_commit();
    turn.after();
    if (j > 0) {
      wgmma_wait<1>();
      fence_regs<R>(acc);
      if (lane0) mbar_arrive(&rp.empty[prev]);
    }
    prev = rp.st;
    rp.advance();
  }
  wgmma_wait<0>();
  fence_regs<R>(acc);
  if (lane0) mbar_arrive(&rp.empty[prev]);
}

template <int N, typename ABase, typename KSteps>
__device__ __forceinline__ void mma_chunks(float* acc, RingPos& rp,
                                           int chunks, const ABase& a_base,
                                           const KSteps& ksteps) {
  NoChunkTurn none;
  mma_chunks<N>(acc, rp, chunks, a_base, ksteps, none);
}

// Nothing to do after a layer (K1, K2).
struct NoTrunkHook {
  __device__ void value(int, __nv_bfloat162) {}
  __device__ void layer(int) {}
};

// The trunk on a warpgroup's 64 rows: X (IPE, 2 k-blocks) -> H (4
// k-blocks), 8 layers.  Every element's sum is k ascending in steps of 16
// into one fp32 accumulator that starts at +0 (trunk()'s order), then
// relu_keep_nan(__fadd_rn(sum, bias)) rounded to bf16.  X_LAST_KSTEPS: the
// k-steps of the x part's second chunk in layers 0 and 4; 3 where X's
// columns 112..127 are zero (an IPE: the 8th k-step would add zero
// products), 4 for an encoding the caller gives (K12).  hook.value(i, v)
// sees the bf16 pair stored from the thread's registers i, i + 1;
// hook.layer(layer) runs once the layer's output in H is visible to the
// warpgroup, before the next layer's products.  Starts after X is visible
// to wgmma; ends with H visible to wgmma and to the warpgroup.  turn: around
// each chunk's products (mma_chunks).
template <int X_LAST_KSTEPS = 3, typename Hook, typename Turn>
__device__ __forceinline__ void trunk_wg(const RenderParams& p, RingPos& rp,
                                         unsigned char* X, unsigned char* H,
                                         int wg, int t, Hook& hook,
                                         Turn& turn) {
  const uint32_t xa = smem_u32(X), ha = smem_u32(H);
  for (int layer = 0; layer < LAYERS; ++layer) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs<128>(acc);
    const bool x_first = layer == 0 || layer == SKIP_AT;
    mma_chunks<256>(
        acc, rp, layer_chunks(layer),
        [&](int j) {
          return x_first && j < 2
                     ? xa + j * KB_BYTES
                     : ha + (j - (layer == SKIP_AT ? 2 : 0)) * KB_BYTES;
        },
        [&](int j) { return x_first && j == 1 ? X_LAST_KSTEPS : 4; }, turn);
    wg_sync(wg);  // no product of this layer still reads H
#ifdef RSN_ABLATE_NO_EPILOGUE  // ablate_render.py: H keeps the layer's input
    if (acc[0] == 12345.f) *reinterpret_cast<float*>(H) = acc[127];
    continue;
#endif
    const float* __restrict__ bias = p.b[layer];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int col = 8 * jj + 2 * (t & 3);
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * jj + 2 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            relu_keep_nan(__fadd_rn(acc[i], bb.x)),
            relu_keep_nan(__fadd_rn(acc[i + 1], bb.y)));
        *reinterpret_cast<__nv_bfloat162*>(H + swz(frag_row(t, i), col)) = v;
        hook.value(i, v);
      }
    }
    fence_async_smem();
    wg_sync(wg);
    hook.layer(layer);
  }
}

template <typename Hook>
__device__ __forceinline__ void trunk_wg(const RenderParams& p, RingPos& rp,
                                         unsigned char* X, unsigned char* H,
                                         int wg, int t, Hook& hook) {
  NoChunkTurn none;
  trunk_wg(p, rp, X, H, wg, t, hook, none);
}

// The unfolded heads' bottleneck on the warpgroup's trunk output H (K11,
// K12, K14, K15): Bn = bf16(H @ wh[:, 0:256] + bh), 4 ring chunks of
// m64n256 (the heads blob's last 4), written into H once no product reads
// it any more.  Ends with Bn written by each thread, not yet visible to
// the warpgroup or to wgmma.  turn: around each chunk's products.
template <typename Turn>
__device__ __forceinline__ void bottleneck_wg(RingPos& rp, unsigned char* H,
                                              const float* __restrict__ bh,
                                              int wg, int t, Turn& turn) {
  const uint32_t ha = smem_u32(H);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_regs<128>(acc);
  mma_chunks<256>(
      acc, rp, 4, [&](int j) { return ha + j * KB_BYTES; },
      [](int) { return 4; }, turn);
  wg_sync(wg);  // no product still reads H
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int col = 8 * jj + 2 * (t & 3);
    const float2 bb = *reinterpret_cast<const float2*>(bh + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * jj + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(H + swz(frag_row(t, i), col)) =
          __floats2bfloat162_rn(__fadd_rn(acc[i], bb.x),
                                __fadd_rn(acc[i + 1], bb.y));
    }
  }
}

// density_row's sum on the warpgroup's H: dot(h_r, w[:, 0]) + b for row
// r = t / 4 + 32 h, four threads per row summing interleaved quarters in
// the same order, combined by the same two xor shuffles.  wcol: the f32
// values of w[:, 0] (exact copies of the bf16 weights).
__device__ __forceinline__ float density_sw(const unsigned char* H,
                                            const float* wcol, float b,
                                            int t, int h) {
  const int r = (t >> 2) + 32 * h, q = t & 3;
  // swz(r, 4 j + q) = Hr + (j / 16) KB + (((j / 2) % 8) ^ (r % 8)) 16 + 8 (j % 2)
  const unsigned char* Hr = H + r * 128 + 2 * q;
  const float* wq = wcol + q;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < WIDTH / 4; ++j) {
    const int off = (j >> 4) * KB_BYTES + ((((j >> 1) & 7) ^ (r & 7)) << 4) +
                    (j & 1) * 8;
    s = __fmaf_rn(__bfloat162float(*reinterpret_cast<const bf16*>(Hr + off)),
                  wq[4 * j], s);
  }
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  return __fadd_rn(s, b);
}

// K2's end: the density column of the warpgroup's rows (row0 + r).
__device__ void density_tail(const RenderParams& p, const unsigned char* H,
                             const float* wcol, long long row0, int t) {
  constexpr int DC = 8;
  const int q = t & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float dens = density_sw(H, wcol, p.bd[0], t, h);
    const long long row = row0 + (t >> 2) + 32 * h;
    if (row < p.n) {  // thread q stores columns 2q, 2q + 1
      // columns 1..7 of wd are zero padding: their value is the bias
      p.out[row * DC + 2 * q] = __float2bfloat16_rn(q == 0 ? dens : p.bd[2 * q]);
      p.out[row * DC + 2 * q + 1] = __float2bfloat16_rn(p.bd[2 * q + 1]);
    }
  }
}

// The IPE of the warpgroup's 64 rows into X (ipe_rows<false>'s bits):
// two threads per row, thread t the 24 (d, k) of its eight frequencies
// [8 (t % 2), 8 (t % 2) + 8), each sin and cos pair from one damping
// (ipe_sincos), stored two columns at a time; then the mean columns 96..98
// and column 99.  Columns 100..127 are zero from the kernel's start.  sk,
// vk: the thread's consts[k] and consts[NFREQ + k].
__device__ __forceinline__ void ipe_wg(const float* __restrict__ mc,
                                       long long row0, long long n,
                                       unsigned char* X, int t,
                                       const float* sk, const float* vk) {
  const int r = t >> 1, hf = t & 1;
  const long long row = row0 + r;
  const bool live = row < n;
  float m[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) m[i] = live ? mc[row * IN_COLS + i] : 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      float s0, s1, c0, c1;
      ipe_sincos(m[d], m[3 + d], sk[2 * kp], vk[2 * kp], &s0, &c0);
      ipe_sincos(m[d], m[3 + d], sk[2 * kp + 1], vk[2 * kp + 1], &s1, &c1);
      const int col = 16 * d + 8 * hf + 2 * kp;
      *reinterpret_cast<__nv_bfloat162*>(X + swz(r, col)) =
          live ? __floats2bfloat162_rn(s0, s1) : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(X + swz(r, 48 + col)) =
          live ? __floats2bfloat162_rn(c0, c1) : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(X + swz(r, 96 + 2 * hf)) =
      __floats2bfloat162_rn(hf ? m[2] : m[0], hf ? 0.f : m[1]);
}

// The exact IPE of the warpgroup's 64 rows into X (ipe_rows<true>'s bits):
// two threads per row, thread t the 24 (d, k) of its eight frequencies
// [8 (t % 2), 8 (t % 2) + 8), each damping expf(-var / 2) once for its
// sine and cosine column (sinf(pre), sinf(pre + f32(pi / 2))), full-range
// sinf and expf; then the mean columns 96..98 and column 99.  sk, vk: the
// thread's consts[k] and consts[NFREQ + k].  One d at a time (not
// unrolled): sinf's slow path is long, and three of them side by side
// spill.
__device__ __forceinline__ void ipe_exact_wg(const float* __restrict__ mc,
                                             long long row0, long long n,
                                             unsigned char* X, int t,
                                             const float* sk,
                                             const float* vk) {
  const int r = t >> 1, hf = t & 1;
  const long long row = row0 + r;
  const bool live = row < n;
  float m[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) m[i] = live ? mc[row * IN_COLS + i] : 0.f;
#pragma unroll 1
  for (int d = 0; d < 3; ++d) {
    const float mean = d == 0 ? m[0] : d == 1 ? m[1] : m[2];
    const float cov = d == 0 ? m[3] : d == 1 ? m[4] : m[5];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      float s[2], c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pre = __fmul_rn(mean, sk[2 * kp + e]);
        const float var = __fmul_rn(cov, vk[2 * kp + e]);
        const float damp = expf(__fmul_rn(-0.5f, var));
        s[e] = __fmul_rn(damp, sinf(pre));
        c[e] = __fmul_rn(damp, sinf(__fadd_rn(pre, HALF_PI)));
      }
      const int col = 16 * d + 8 * hf + 2 * kp;
      *reinterpret_cast<__nv_bfloat162*>(X + swz(r, col)) =
          live ? __floats2bfloat162_rn(s[0], s[1])
               : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(X + swz(r, 48 + col)) =
          live ? __floats2bfloat162_rn(c[0], c[1])
               : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(X + swz(r, 96 + 2 * hf)) =
      __floats2bfloat162_rn(hf ? m[2] : m[0], hf ? 0.f : m[1]);
}

// X's zero columns 100..127 (ipe_wg writes 0..99)
__device__ __forceinline__ void zero_x_pad(unsigned char* X, int t) {
  for (int e = t; e < WG_ROWS * (ENC - 100); e += WG_THREADS)
    *reinterpret_cast<bf16*>(X + swz(e / (ENC - 100), 100 + e % (ENC - 100))) =
        __float2bfloat16_rn(0.f);
}

// ---- the IPE ahead (K10): the producer warpgroup's idle warps ---------------
//
// With persistent_body's IPE_AHEAD the consumers compute no IPE.  Warps
// 1..3 of the producer warpgroup (IPE_THREADS threads, at the producer's
// 40 registers; warp 0's thread 0 issues the ring's copies) write each
// tile's IPE into each consumer warpgroup's X while that warpgroup runs
// the rest of the tile before.  Two signals per consumer warpgroup c hand
// X over: "X full" (the IPE warps to c, each thread behind a
// fence.proxy.async: wgmma reads X through the async proxy) and "X empty"
// (c to the IPE warps once the tile's last reader of X is done, if the
// block has a next tile: release_x).  Each is a named barrier of the IPE
// warps and c (X_PAIR threads): the side that signals arrives
// (bar.arrive), the side that waits syncs (bar.sync); mbarriers measured
// slower (PERF.md).  The IPE warps read the IPE constants from a shared
// copy behind the ring's barriers.
constexpr int IPE_THREADS = WG_THREADS - 32;
constexpr int X_PAIR = WG_THREADS + IPE_THREADS;  // 224
constexpr int X_FULL_BAR = 4, X_EMPTY_BAR = 6;    // + c (wg_sync: 2, 3)
constexpr int AHEAD_BYTES = 2 * NFREQ * 4;       // the IPE constants, 128

// The shared copy of the IPE constants (consts[k], consts[NFREQ + k]).
__device__ __forceinline__ float* ahead_consts(unsigned char* smem,
                                               int bars_off) {
  return reinterpret_cast<float*>(smem + bars_off + 2 * STAGES * 8);
}

// The signal "X full" (full) or "X empty" of consumer warpgroup c.
__device__ __forceinline__ void x_signal(bool full, int c) {
  asm volatile("bar.arrive %0, %1;" ::"r"((full ? X_FULL_BAR : X_EMPTY_BAR) +
                                          c),
               "n"(X_PAIR)
               : "memory");
}

// The wait for it.
__device__ __forceinline__ void x_wait(bool full, int c) {
  asm volatile("bar.sync %0, %1;" ::"r"((full ? X_FULL_BAR : X_EMPTY_BAR) +
                                        c),
               "n"(X_PAIR)
               : "memory");
}

// A consumer thread's release of its warpgroup's X after its last read of
// X (and, where X held other data, its last write).  rel: the warpgroup,
// or -1 on the block's last tile, whose X no IPE warp waits for.
__device__ __forceinline__ void release_x(int rel) {
  if (rel >= 0) x_signal(false, rel);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ipe_wg's bits for one consumer warpgroup's 64 rows from the IPE warps
// (thread i of IPE_THREADS): a unit is (row r, d, half hf of the 16
// frequencies), r = e % 64 so that the 8 threads of a quarter warp store
// to 8 rows (the swizzle puts them on all 32 banks); its 8 sin and 8 cos
// columns go out as one 16-byte store each; then the mean columns 96..98
// and column 99, one row a thread.  consts: the shared copy.
__device__ __forceinline__ void ipe_ahead_wg(const float* __restrict__ mc,
                                             const float* consts,
                                             long long row0, long long n,
                                             unsigned char* X, int i) {
#pragma unroll 1
  for (int e = i; e < WG_ROWS * 6; e += IPE_THREADS) {
    const int r = e % WG_ROWS, d = e / (2 * WG_ROWS), hf = (e / WG_ROWS) & 1;
    const long long row = row0 + r;
    uint32_t s[4] = {0u, 0u, 0u, 0u}, c[4] = {0u, 0u, 0u, 0u};
    if (row < n) {
      const float mean = mc[row * IN_COLS + d];
      const float cov = mc[row * IN_COLS + 3 + d];
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        const int k = 8 * hf + 2 * kp;
        float s0, s1, c0, c1;
        ipe_sincos(mean, cov, consts[k], consts[NFREQ + k], &s0, &c0);
        ipe_sincos(mean, cov, consts[k + 1], consts[NFREQ + k + 1], &s1,
                   &c1);
        s[kp] = bf16x2_bits(s0, s1);
        c[kp] = bf16x2_bits(c0, c1);
      }
    }
    *reinterpret_cast<uint4*>(X + swz(r, 16 * d + 8 * hf)) =
        make_uint4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<uint4*>(X + swz(r, 48 + 16 * d + 8 * hf)) =
        make_uint4(c[0], c[1], c[2], c[3]);
  }
  for (int r = i; r < WG_ROWS; r += IPE_THREADS) {
    const long long row = row0 + r;
    const bool live = row < n;
    const float* m = mc + row * IN_COLS;
    *reinterpret_cast<uint2*>(X + swz(r, 96)) =
        live ? make_uint2(bf16x2_bits(m[0], m[1]), bf16x2_bits(m[2], 0.f))
             : make_uint2(0u, 0u);
  }
}

// The IPE warps' loop: for every tile of the block, each consumer
// warpgroup's rows into its X as soon as that warpgroup has released it
// (X is empty before the block's first tile).
__device__ void ipe_ahead(const RenderParams& p, unsigned char* xs,
                          const float* consts, int ntiles, int i) {
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll 1
    for (int c = 0; c < CONSUMERS; ++c) {
      if (tile != (int)blockIdx.x) x_wait(false, c);
#ifndef RSN_ABLATE_NO_IPE  // ablate_k3.py: the hand-off without the IPE
      ipe_ahead_wg(p.mc, consts,
                   (long long)tile * TILE_ROWS + c * WG_ROWS, p.n,
                   xs + c * X_WG_BYTES, i);
#endif
      fence_async_smem();
      x_signal(true, c);
    }
  }
}

// K1's end (v3_tail's arithmetic on 64 rows): the heads + mid-seed product
// as one m64n144 wgmma over 4 ring chunks (w_hc's columns 0..15 and
// 128..255), the roughness attenuation, hmid (into H's first two k-blocks,
// once the product and the density have read H), the mid head and the
// row of OUTC bf16 columns (v3_tail's: 16 at the render width, 24 at the
// train width with the mid value in 17:20 and zero in 14:17) into
// rows + r * OUTC for the warpgroup's rows r < n - row0.
template <int OUTC>
__device__ __forceinline__ void v3_tail_wg(const RenderParams& p,
                                           RingPos& rp, unsigned char* H,
                                           const float* wcol,
                                           const float4* wout, float* tail,
                                           long long row0, int wg, int t,
                                           bf16* rows) {
  static_assert(OUTC == 16 || OUTC == 24, "16 (render) or 24 (train) cols");
  float* HSm = tail;                          // 64 x 16 f32 head sums
  float* rowf = tail + WG_ROWS * HS_COLS;     // 64 x 8: atten(4), dens, mid(3)
  const int q = t & 3;
  // the thread's rows r0 and r0 + 8 and their rays' SH band partials,
  // brought into L1 while the heads product runs
  const int r0 = frag_row(t, 0);
  const float* g0 =
      row0 + r0 < p.n ? p.g + ((row0 + r0) / p.S) * G_COLS : nullptr;
  const float* g1 =
      row0 + r0 + 8 < p.n ? p.g + ((row0 + r0 + 8) / p.S) * G_COLS : nullptr;
  const bool one_ray = g0 == g1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // the 16 lines of 128 bytes hmid reads
    if (g0) prefetch_l1(g0 + 32 * i);
    if (g1 && !one_ray) prefetch_l1(g1 + 32 * i);
  }
  float hc[72];
#pragma unroll
  for (int i = 0; i < 72; ++i) hc[i] = 0.f;
  fence_regs<72>(hc);
  const uint32_t ha = smem_u32(H);
  mma_chunks<HEAD_N>(
      hc, rp, HEAD_CHUNKS, [&](int j) { return ha + j * KB_BYTES; },
      [](int) { return 4; });

#pragma unroll
  for (int i = 0; i < 8; ++i)
    HSm[frag_row(t, i) * HS_COLS + frag_col(t, i)] = hc[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float dens = density_sw(H, wcol, p.b_hc[0], t, h);
    if (q == 0) rowf[((t >> 2) + 32 * h) * ROWF + 4] = dens;
  }
  if (q == 3) {  // column 7 (rough_raw) of rows frag_row(t, 1), (t, 3)
#pragma unroll
    for (int i = 1; i < 4; i += 2) {
      const int r = frag_row(t, i);
      const float sp = softplusf(__fadd_rn(hc[i], p.b_hc[7]));
#pragma unroll
      for (int b = 0; b < 4; ++b)
        rowf[r * ROWF + b] = expf(__fmul_rn(-sp, band_k(b)));
    }
  }
  wg_sync(wg);  // rowf is complete; no one reads H any more

  // hmid = bf16(relu(seed + b + sum_b atten_b * g_b[ray])) into H, for the
  // thread's rows r0 and r0 + 8 (one load of g serves both in one ray)
  float a0[4], a1[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    a0[b] = rowf[r0 * ROWF + b];
    a1[b] = rowf[(r0 + 8) * ROWF + b];
  }
#pragma unroll
  for (int jj = 2; jj < HEAD_N / 8; ++jj) {
    const int c = 8 * (jj - 2) + 2 * q;   // mid column, even
    const float2 bb = *reinterpret_cast<const float2*>(p.b_hc + MID + c);
    float m00 = __fadd_rn(hc[4 * jj], bb.x), m01 = __fadd_rn(hc[4 * jj + 1], bb.y);
    float m10 = __fadd_rn(hc[4 * jj + 2], bb.x),
          m11 = __fadd_rn(hc[4 * jj + 3], bb.y);
    float2 gv0[4], gv1[4];
    if (g0) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        gv0[b] = *reinterpret_cast<const float2*>(g0 + b * MID + c);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        m00 = __fadd_rn(m00, __fmul_rn(a0[b], gv0[b].x));
        m01 = __fadd_rn(m01, __fmul_rn(a0[b], gv0[b].y));
      }
    }
    if (g1) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        gv1[b] = one_ray ? gv0[b]
                         : *reinterpret_cast<const float2*>(g1 + b * MID + c);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        m10 = __fadd_rn(m10, __fmul_rn(a1[b], gv1[b].x));
        m11 = __fadd_rn(m11, __fmul_rn(a1[b], gv1[b].y));
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(H + swz(r0, c)) =
        __floats2bfloat162_rn(relu_keep_nan(m00), relu_keep_nan(m01));
    *reinterpret_cast<__nv_bfloat162*>(H + swz(r0 + 8, c)) =
        __floats2bfloat162_rn(relu_keep_nan(m10), relu_keep_nan(m11));
  }
  wg_sync(wg);

  // mid = sigmoid(hmid @ w_out[:, 0:3] + b_out) and the row, one thread
  // per row (each (row, column) sum k ascending, as v3_tail's)
  if (t < WG_ROWS) {
    const long long row = row0 + t;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int k8 = 0; k8 < MID / 8; ++k8) {
      const uint4 v = *reinterpret_cast<const uint4*>(H + swz(t, 8 * k8));
      const bf16* hv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float hk = __bfloat162float(hv[e]);
        const float4 w = wout[8 * k8 + e];
        s0 = __fmaf_rn(hk, w.x, s0);
        s1 = __fmaf_rn(hk, w.y, s1);
        s2 = __fmaf_rn(hk, w.z, s2);
      }
    }
    if (row < p.n) {
      const float mid[3] = {sigmoidf(__fadd_rn(s0, p.b_out[0])),
                            sigmoidf(__fadd_rn(s1, p.b_out[1])),
                            sigmoidf(__fadd_rn(s2, p.b_out[2]))};
      const float* hcr = HSm + t * HS_COLS;
      alignas(16) bf16 v[OUTC];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float diff = sigmoidf(__fadd_rn(hcr[1 + i], p.b_hc[1 + i]));
        const float tint = sigmoidf(__fadd_rn(hcr[4 + i], p.b_hc[4 + i]));
        v[i] = __float2bfloat16_rn(__fadd_rn(diff, __fmul_rn(tint, mid[i])));
        v[3 + i] = __float2bfloat16_rn(diff);
        v[6 + i] = __float2bfloat16_rn(tint);
        v[9 + i] = __float2bfloat16_rn(__fadd_rn(hcr[8 + i], p.b_hc[8 + i]));
      }
      v[12] = __float2bfloat16_rn(rowf[t * ROWF + 4]);
      v[13] = __float2bfloat16_rn(__fadd_rn(hcr[7], p.b_hc[7]));
#pragma unroll
      for (int i = 14; i < OUTC; ++i) v[i] = __float2bfloat16_rn(0.f);
      if constexpr (OUTC == 24) {
#pragma unroll
        for (int i = 0; i < 3; ++i) v[17 + i] = __float2bfloat16_rn(mid[i]);
      }
      uint4* o = reinterpret_cast<uint4*>(rows + t * OUTC);
#pragma unroll
      for (int i = 0; i < OUTC / 8; ++i)
        o[i] = reinterpret_cast<const uint4*>(v)[i];
    }
  }
}

// The persistent block of K1, K2, the train-width forwards and K18's trunk
// spill: the block's f32 copies of the density column (w_hc's column 0 with
// HEADS, else wd's; none without HEADS and wd: a tile that reads neither)
// and of w_out's three live columns, the ring's barriers at bars_off; the
// producer streams the blob's first `chunks` chunks for every tile; each
// consumer warpgroup writes its 64 rows' IPE into X, then runs
// tile_fn(rp, X, H, tail, wcol, wout, row0, wg, t) on them.  IPE_AHEAD
// (K10): the IPE warps write X instead (ipe_ahead; AHEAD_BYTES behind the
// ring's barriers), and tile_fn releases each tile's X (release_x) but the
// block's last.
template <bool HEADS, bool IPE_AHEAD = false, typename Tile>
__device__ __forceinline__ void persistent_body(const RenderParams& p,
                                                unsigned char* smem,
                                                int bars_off, int chunks,
                                                Tile& tile_fn) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars_off);
  uint64_t* empty = full + STAGES;
  float* wcol = reinterpret_cast<float*>(smem + OFF_WD);
  float4* wout = reinterpret_cast<float4*>(smem + OFF_WOUT);
  for (int k = threadIdx.x; k < (HEADS || p.wd ? WIDTH : 0);
       k += BLOCK_THREADS) {
    wcol[k] = __bfloat162float(HEADS ? p.w_hc[k * WIDTH] : p.wd[k * 8]);
    if (HEADS && k < MID)
      wout[k] = make_float4(__bfloat162float(p.w_out[k * MID]),
                            __bfloat162float(p.w_out[k * MID + 1]),
                            __bfloat162float(p.w_out[k * MID + 2]), 0.f);
  }
  float* consts = ahead_consts(smem, bars_off);
  if constexpr (IPE_AHEAD) {
    if (threadIdx.x < 2 * NFREQ) consts[threadIdx.x] = p.consts[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (int)((p.n + TILE_ROWS - 1) / TILE_ROWS);
  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    setmaxnreg_dec40();
    if (threadIdx.x == 0)
      produce(p.blob, smem + OFF_RING, full, empty, chunks, ntiles);
    else if (IPE_AHEAD && threadIdx.x >= 32)
      ipe_ahead(p, smem + OFF_XS, consts, ntiles, threadIdx.x - 32);
    return;
  }
  setmaxnreg_inc232();
  const int wg = wgi - 1, t = threadIdx.x % WG_THREADS;
  unsigned char* X = smem + OFF_XS + wg * X_WG_BYTES;
  unsigned char* H = smem + OFF_HS + wg * H_WG_BYTES;
  float* tail = reinterpret_cast<float*>(smem + OFF_TAIL + wg * TAIL_WG_BYTES);
  RingPos rp{smem + OFF_RING, full, empty, 0, 0u};
  if constexpr (IPE_AHEAD) {
    zero_x_pad(X, t);  // for good: the IPE warps write columns 0..99
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long row0 = (long long)tile * TILE_ROWS + wg * WG_ROWS;
      fence_async_smem();  // the warpgroup's own writes of X's zero columns
      wg_sync(wg);         // the previous tile's tail is done with H, scratch
      x_wait(true, wg);
      tile_fn(rp, X, H, tail, wcol, wout, row0, wg, t);
    }
    return;
  }
  float sk[8], vk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sk[i] = p.consts[8 * (t & 1) + i];
    vk[i] = p.consts[NFREQ + 8 * (t & 1) + i];
  }
  zero_x_pad(X, t);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TILE_ROWS + wg * WG_ROWS;
    wg_sync(wg);  // the previous tile's tail is done with X, H, the scratch
#ifndef RSN_ABLATE_NO_IPE  // ablate_render.py: X keeps stale values
    ipe_wg(p.mc, row0, p.n, X, t, sk, vk);
#endif
    fence_async_smem();
    wg_sync(wg);
    tile_fn(rp, X, H, tail, wcol, wout, row0, wg, t);
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// K1's (HEADS) or K2's tile: the trunk, then the V3 tail or the density.
template <bool HEADS>
struct RenderTile {
  const RenderParams& p;
  __device__ __forceinline__ void operator()(RingPos& rp, unsigned char* X,
                                             unsigned char* H, float* tail,
                                             const float* wcol,
                                             const float4* wout,
                                             long long row0, int wg, int t) {
    NoTrunkHook hook;
    trunk_wg(p, rp, X, H, wg, t, hook);
    if constexpr (HEADS)
      v3_tail_wg<16>(p, rp, H, wcol, wout, tail, row0, wg, t,
                     p.out + row0 * 16);
    else
      density_tail(p, H, wcol, row0, t);
  }
};

// K1 (HEADS) or K2: the whole kernel body.  (The RSN_ABLATE_* macros leave
// out one part each in ablate_render.py's timing builds; the port's build
// never defines them.)
template <bool HEADS>
__device__ void render_trunk(const RenderParams& p, unsigned char* smem_raw) {
  RenderTile<HEADS> tile{p};
  persistent_body<HEADS>(p, align_1024(smem_raw), off_bars<HEADS>(),
                         TRUNK_CHUNKS + (HEADS ? HEAD_CHUNKS : 0), tile);
}

}  // namespace sm90
}  // namespace
