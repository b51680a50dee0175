// Field training kernels, for NVIDIA Hopper (sm_90a).
//
// Replaces eight Pallas TPU kernels:
//   field_forward_v6   (K3; rsn/kernels/field_pallas.py, body
//                       _field_kernel_halved_acts / _field_half): K1's
//                       forward at the train width (24 columns: the V3_*
//                       columns, d density_preact / d mean in 14:17 when
//                       the normals are wanted, the mid value in 17:20)
//                       plus the spill of the 8 post-ReLU trunk
//                       activations, (N, 2048) bf16, with the IPE tile x
//                       appended ((N, 2176)) under spill_x.  With the
//                       normals, the density head row is backpropagated
//                       through the 8 layers and the IPE in the same block.
//   field_forward_v4   (K7; field_pallas.py, _field_kernel_halved with
//                       the normals): K3 with the normals and no spill.
//                       Without the normals the same kernel is K1 at the
//                       train width (field_forward_v3 at its default
//                       V3_OUT store, which writes the mid value for the
//                       backward).  One body for the three forwards
//                       (train_sm90.cuh, on trunk_sm90.cuh's ring and
//                       wgmma), so their outputs are equal bit for bit.
//   field_backward_v5  (K4; rsn/kernels/field_train.py, body _bwd_half):
//                       the backward from the spilled activations and the
//                       forward's stored output: dmc (N, 16), dg (R, 512)
//                       and the 20 packed-operand weight gradients, whose
//                       weight matrices are contracted by wgmma in a
//                       second kernel (wgrad_sm90.cuh).
//   field_backward_v6  (K5; _bwd_half with want_dmc=False): the same
//                       without the IPE backward, x read from the spill.
//   field_backward_v4  (K8; _bwd_kernel_impl(two_d=True, has_acts=False)):
//                       K4 with the trunk activations recomputed in the
//                       block instead of read from a spill.
//   field_forward_v5   (K10; field_pallas.py, _kernel_v5): K7 (with the
//                       normals) or K1 at the train width, with the next
//                       tile's IPE computed off the tensor cores' path.
//   field_backward_v3  (K13; field_train.py, _bwd_kernel_impl(two_d=False)):
//                       K8 with whole-grid weight-gradient accumulators:
//                       the launches return the 20 gradients themselves
//                       (K8's kernels A and B, then a sum kernel).
//   field_backward_whole (K17; tools/exp_bwd_whole.py, field_backward_whole,
//                       rsn's field_backward_v4(n_halves=1)): K8's
//                       function on 128-row tiles (the tool's one
//                       whole-tile chain).
//
// What bounds them on this card: about 2.2 MFLOP of bf16 products per
// sample row each, against 4.3 KB (K3 spill) or 4.4 KB (K4/K5 reads) of
// device memory per row: about 500 FLOP per byte, above the card's ~295,
// so the tensor cores are the limit.  In the first design (K4, K5, K8, K13
// and K17 before kernel B) the weight-gradient accumulators are not:
// they live in device memory (one fp32 slice of 2.4 MB per block), and
// every 64-row tile reads and writes its block's slice once, about 38 KB
// per row of traffic (K18: 57% of the backward).
//
// What the design does about it:
//   - The forwards (K3, K7, K1 at the train width) are the render K1's
//     Hopper design with the normals' dgrad as more chunks on its weight
//     ring and the ReLU masks in registers: train_sm90.cuh says how.  Their
//     weights come from a blob that one launch (rsn_pack_train_blob) packs
//     from the fp32 operands per train step.  The old 64-row wmma forward
//     (forward_train_tile below: trunk and v3_tail of field_common.cuh, the
//     masks as bits in shared memory) stays as K10's first design.
//   - The backward (K4/K5) gives each block a run of whole rays, walked
//     in 64-row tiles.  Per-ray band gradients dg are summed in the block
//     (no one-hot matrix, no float atomics); in the first design the
//     weight gradients go to the block's own fp32 slice of a (blocks,
//     608640) buffer, which the wrapper reduces over blocks.  The result
//     is the same from run to run.
//   - Every product is nvcuda::wmma 16x16x16 bf16 -> fp32.  Dgrads are
//     computed for all 64 rows into registers, then written back over
//     their own input (one barrier), which keeps K5's body at 100 KB of
//     shared memory; K4 adds the fp32 dx tile (132 KB).
//   - Roundings follow the TPU kernels: cotangents enter bf16, dpre is
//     rounded to bf16 before its products, bias gradients sum the fp32
//     values, the roughness -> attenuation edge carries no gradient.
//   - K8 (the recompute route, which keeps no (N, 2048) spill alive
//     between the forward and the backward): K4 reads layer i's tile
//     whenever its backward needs it, and a 64-row tile's eight bf16
//     layers (256 KB) do not fit the 227 KB of shared memory.  So each
//     block recomputes its tile's trunk with K3's code (ipe_tile, trunk
//     and K3's spill hook) into its own 64 x 2048 bf16 slot of a
//     workspace (one slot per block, not per row: ~34 MB at one block
//     per SM, within the 50 MB L2), and K4's body then reads that slot
//     unchanged.  The recompute equals K3's spill bit for bit (every row
//     is computed by the same code from the same inputs), and K8 uses
//     K4's rays-per-block partition, so every per-row value and every sum
//     the body takes in its tile loop (dmc, dg, the biases, the mid
//     head's gradients) equals K4's on K3's spill bit for bit.
//   - The weight gradients of K4, K5 and K8 leave the tile loop: a call
//     runs in chunks of up to 4 tiles of every block's run, and per chunk
//     the body (kernel A, STASH) stores each weight-gradient product's two
//     operand tiles (X, hs0..hs7, dpre0..dpre7, d_hc: 8,736 bytes per row)
//     to the tile's record of a workspace, in the K-major swizzled layout
//     wgmma reads, where the first design multiplies them into its slice
//     (gathered through two shared staging buffers, 64 KB behind the
//     kernel's own layout, and written by bulk copies); kernel B
//     (wgrad_sm90.cuh) then contracts the chunk's records over all their
//     rows with wgmma, 18 output tiles x P slices, each slice's sums in its
//     own fp32 partial (read and written once per chunk).  The workspace
//     per block fits in what the first design's slice took (4 x 559,104 <=
//     2,434,560 bytes).  The stash does not care where its operands come
//     from: K8's recompute slot, or K3's spill (K4, K5, which then run one
//     block per SM on K4's partition: 164 KB and 196 KB of shared memory).
//     The three kernels share the partition and the chunks, so they take
//     every per-row value and every sum in the same order: K4 equals K8,
//     and K5 equals K4 on dg, on every one of the 20 gradients, bit for
//     bit.  The weight matrices differ from the first design's (the
//     RSN_K13_FIRST_DESIGN build's K13) only by the order of their fp32
//     sums over the rows, and are the same from run to run.
//   - K10 carries rsn's schedule over, not its two-slot VMEM buffer kept
//     across sequential grid steps: it is K7 / K1 at the train width on the
//     same ring and wgmma (train_trunk with AHEAD: the train blob, 128-row
//     tiles, 2 consumer warpgroups), but its consumers compute no IPE.
//     The producer warpgroup's warps 1-3, idle in K7 (one thread issues the
//     ring's copies), write each tile's IPE into each consumer's X, handed
//     over by two named barriers per consumer (X full, X empty;
//     trunk_sm90.cuh's ipe_ahead; mbarriers measured slower).  The train layout leaves 5,072 of the
//     232,448 bytes free, so X is filled in place, not in a second slot:
//     without the normals X is free after layer 4's products (its last
//     reader), so the next tile's IPE overlaps layers 5-7, the heads and
//     the tail; with them X holds the x share from dgrad layer 4 to layer
//     0, so the fill overlaps only the IPE backward and the row stores.
//     Every value is ipe_wg's and every sum K7's, so K10 equals K7 and K1
//     at the train width bit for bit.  Its first design
//     (RSN_K10_FIRST_DESIGN, the yardstick that the ring keeps the 64-row
//     forward's sum order): one persistent block per SM, four producer
//     warps writing the next tile's IPE (ipe_tile) into one of two X slots
//     while eight consumer warps ran forward_train_tile (wmma) on the
//     other, handed over through named barriers (146 KB).
//   - K13's whole-grid accumulators without float atomics: K8's kernels A
//     and B on K8's chunks, then one launch (field_backward_v3_sum_kernel)
//     that sums kernel B's P partials in slice order and the blocks'
//     compact slices in block order into the 20 gradients, one thread per
//     output float.  dmc and dg equal K8's bit for bit (the same launches);
//     the weight and bias gradients differ from K8's (torch.sum over the
//     partials and slices) only by the order of those fp32 sums.  The first
//     design (RSN_K13_FIRST_DESIGN) ran K8's first-design body into
//     per-block slices of all 20 gradients and summed them behind a
//     grid-wide barrier of a cooperative launch.
//   - K17 is K8's body with a template row tile of 128 (the tool's "one
//     whole-tile chain"): its tile's D, INP and X take 170 KB of shared
//     memory, so its fp32 dx tile (64 KB) lives in the block's global
//     workspace beside its 128-row recompute slot; the recompute, the
//     dgrads and their epilogues run on the two 64-row halves, so every
//     per-row value (dmc, the activations, every stashed operand) equals
//     K8's bit for bit.  Its kernel A stashes each half as the record of
//     the matching 64-row tile of K8's plan, so kernel B sums K8's records
//     in K8's order: w0..w7 and w_hc equal K8's bit for bit, and only the
//     sums that kernel A takes over 128 rows (dg, b_hc, the mid head)
//     change order.  Its 194,560 bytes of shared memory leave room for one
//     32 KB staging buffer, not two: each stash point's four pieces (two
//     operands of two halves) go out in turns, a bulk copy each, the next
//     gather waiting until the copy has read the buffer.  The first design
//     (RSN_K13_FIRST_DESIGN) summed the products into the block's fp32
//     slice over all 128 rows, which halved K8's first-design slice
//     traffic per row.
// Later work: the recompute and the dgrads on wgmma (trunk_sm90.cuh).
#include "field_common.cuh"
#include "train_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace {

constexpr int OUT_TRAIN = sm90::TRAIN_COLS;  // the train-width row

constexpr int OFF_WHC = OFF_B + LAYERS * WIDTH;
constexpr int OFF_BHC = OFF_WHC + WIDTH * WIDTH;
constexpr int OFF_WOUT = OFF_BHC + WIDTH;
constexpr int OFF_BOUT = OFF_WOUT + MID * MID;
constexpr int PACK_FLOATS = OFF_BOUT + MID;          // 608640
static_assert(PACK_FLOATS == 608640, "packed-gradient layout");

// k-tiles / n-tiles of the fused heads+mid product that carry data:
// column tile 0 (the 11 head columns) and tiles 8..15 (the mid seed)
constexpr unsigned HC_TILES = 0xFF01u;

#ifdef RSN_K10_FIRST_DESIGN
// ---- K10's first design: the 64-row forward -----------------------------

constexpr int OFF_MASKS = FWD_SMEM_BYTES;
constexpr int MASK_BYTES = LAYERS * TM * MASK_WORDS * 4;
constexpr int OFF_ROWOUT = OFF_MASKS + MASK_BYTES;
constexpr int FWD64_SMEM_BYTES = OFF_ROWOUT + TM * OUT_TRAIN * 2;
static_assert(OFF_MASKS % 32 == 0 && OFF_ROWOUT % 32 == 0, "alignment");

__device__ __forceinline__ bool mask_bit(const uint32_t* masks, int layer,
                                         int r, int c) {
  return (masks[(layer * TM + r) * MASK_WORDS + (c >> 5)] >> (c & 31)) & 1u;
}

// The train-width forward of the 64-row tile at row0 (the first design of
// K3 / K7 and of K10: trunk() and v3_tail on wmma), whose IPE X
// already holds (visible to every thread of the routines).  Reads X only in
// the trunk.
template <bool NORMALS>
__device__ void forward_train_tile(const float* __restrict__ mc,
                                   const float* __restrict__ g,
                                   const float* __restrict__ consts,
                                   const V3Params& p,
                                   const float* __restrict__ wd_row,
                                   bf16* __restrict__ out, long long n,
                                   int S, long long row0, const bf16* X) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* H0 = reinterpret_cast<bf16*>(smem + OFF_H0);
  bf16* H1 = reinterpret_cast<bf16*>(smem + OFF_H1);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + OFF_MASKS);
  bf16* rowout = reinterpret_cast<bf16*>(smem + OFF_ROWOUT);
  const int tid = threadIdx.x;
  const int nv = (int)min((long long)TM, n - row0);
  SpillHook hook{nullptr, 0, nv, NORMALS ? masks : nullptr};
  bf16* H = trunk(p.trunk, X, H0, H1, stage, hook);
  v3_tail<OUT_TRAIN>(p, H, smem, g, row0, n, S, rowout);

  if (NORMALS) {
    // d density_preact / d mean: dh = wd_row, then through the 8 layers
    // (dpre = bf16(dh * relu mask), dinp = dpre @ W^T) and the IPE.
    bf16* D = H0;                                  // dpre, in place
    float* dxe = reinterpret_cast<float*>(H1);     // (TM, 128) dx tile
    for (int e = tid; e < TM * WIDTH; e += THREADS) {
      const int r = e / WIDTH, c = e % WIDTH;
      D[r * LDH + c] = __float2bfloat16_rn(
          mask_bit(masks, LAYERS - 1, r, c) ? wd_row[c] : 0.f);
    }
    block_sync();
    for (int i = LAYERS - 1; i >= 0; --i) {
      const bf16* W = p.trunk.w[i];
      if (i == 0 || i == SKIP_AT) {  // the x part: dx (layer 0) or its
        FragC acc[4][1];             // skip share (layer 4)
        dgrad_mma<1>(D, W, 0, ALL_TILES, acc);
        const bool first = i == SKIP_AT;
        drain<1>(acc, 0, stage, [&](int r, int c, float v) {
          float* d = dxe + r * ENC + c;
          *d = first ? v : __fadd_rn(v, *d);
          return 0.f;
        }, NoColSum());
      }
      if (i > 0) {
        const int c0 = i == SKIP_AT ? ENC : 0;
        FragC acc[4][2];
        dgrad_mma<2>(D, W, c0, ALL_TILES, acc);
        block_sync();  // every warp's reads of D are done
        drain<2>(acc, c0, stage, [&](int r, int c, float v) {
          const int h = c - c0;
          const float m = mask_bit(masks, i - 1, r, h) ? v : 0.f;
          D[r * LDH + h] = __float2bfloat16_rn(m);
          return 0.f;
        }, NoColSum());
      }
      block_sync();
    }
    // IPE backward of the mean: dx * damp * cos (the sin and cos halves)
    // times 2 pi f_k, plus the identity columns 96..98
    if (tid < TM * 3) {
      const int r = tid / 3, d = tid % 3;
      const long long row = row0 + r;
      if (row < n) {
        const float* m = mc + row * IN_COLS;
        float s = 0.f;
        for (int half = 0; half < 2; ++half)
          for (int k = 0; k < NFREQ; ++k) {
            const int c = half * 48 + d * NFREQ + k;
            float damp, u;
            ipe_phase(m, consts, c, &damp, &u);
            const float dpre = __fmul_rn(dxe[r * ENC + c],
                                         __fmul_rn(damp, cos2pi(u)));
            s = __fmaf_rn(dpre, consts[k], s);
          }
        s = __fadd_rn(s, dxe[r * ENC + 96 + d]);
        rowout[r * OUT_TRAIN + 14 + d] = __float2bfloat16_rn(s);
      }
    }
    block_sync();
  }
  store_rows(out + row0 * OUT_TRAIN, OUT_TRAIN, rowout, OUT_TRAIN,
             OUT_TRAIN, nv);
}

// ---- K10's first design: the next tile's IPE in a second slot ----------

// A persistent block (one per SM) walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...  Its THREADS consumer threads run each tile
// with the 64-row forward (forward_train_tile) from one of two X slots,
// while PRODUCERS producer threads fill the other slot with the next tile's
// IPE (ipe_tile, the same arithmetic as K7's ipe_wg).  Hand-off through
// named barriers over all K10_THREADS threads: FULL(s) (producers arrive
// after writing slot s, consumers wait) and EMPTY(s) (consumers arrive
// after a tile, producers wait before refilling its slot two tiles on).
constexpr int PRODUCERS = 128;
constexpr int K10_THREADS = THREADS + PRODUCERS;
constexpr int OFF_SLOTS = FWD64_SMEM_BYTES;
constexpr int K10_SMEM_BYTES = OFF_SLOTS + 2 * X_BYTES;
static_assert(OFF_SLOTS % 32 == 0 && X_BYTES % 32 == 0, "alignment");
constexpr int BAR_FULL = 2, BAR_EMPTY = 4;  // + slot; 1 is block_sync()

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(K10_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(K10_THREADS) : "memory");
}

template <bool NORMALS>
__global__ void __launch_bounds__(K10_THREADS, 1)
    field_forward_v5_first_kernel(const float* __restrict__ mc,
                            const float* __restrict__ g,
                            const float* __restrict__ consts, V3Params p,
                            const float* __restrict__ wd_row,
                            bf16* __restrict__ out, long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long tiles = (n + TM - 1) / TM;  // > blockIdx.x
  const long long count = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto slot = [&](long long j) {
    return reinterpret_cast<bf16*>(smem + OFF_SLOTS + (j & 1) * X_BYTES);
  };
  auto row0 = [&](long long j) {
    return (blockIdx.x + j * gridDim.x) * (long long)TM;
  };
  if (threadIdx.x >= THREADS) {  // producers
    for (long long j = 0; j < count; ++j) {
      if (j >= 2) bar_wait(BAR_EMPTY + (int)(j & 1));
      ipe_tile(mc, consts, row0(j), n, slot(j), threadIdx.x - THREADS,
               PRODUCERS);
      __threadfence_block();
      bar_arrive(BAR_FULL + (int)(j & 1));
    }
    return;
  }
  for (long long j = 0; j < count; ++j) {
    bar_wait(BAR_FULL + (int)(j & 1));
    forward_train_tile<NORMALS>(mc, g, consts, p, wd_row, out, n, S, row0(j),
                                slot(j));
    block_sync();  // the next tile rewrites H0, H1, the masks and rowout
    if (j + 2 < count) bar_arrive(BAR_EMPTY + (int)(j & 1));
  }
}
#endif  // RSN_K10_FIRST_DESIGN

// K3 (SPILL), K7 and K1 at the train width (train_sm90.cuh).
template <bool NORMALS, bool SPILL, bool SPILL_X>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    field_train_kernel(const __grid_constant__ sm90::TrainParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  sm90::train_trunk<NORMALS, SPILL, SPILL_X>(p, smem_raw);
}

// K10: K7 (NORMALS) or K1 at the train width, each tile's IPE from the
// producer warpgroup's idle warps.
template <bool NORMALS>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    field_forward_v5_kernel(const __grid_constant__ sm90::TrainParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  sm90::train_trunk<NORMALS, false, false, true>(p, smem_raw);
}

// ---- K4 / K5 / K8 / K17 -------------------------------------------------

constexpr int RF = 24;  // per-row scalars: [0:4) atten, [4:7) dz3,
                        // [7:10) bf16(dz3), [10:21) d heads (FH_* order)

// The backward's shared memory on a tile of ROWS rows: D and INP (ROWS x
// 256 bf16), X (ROWS x 128 bf16), the row scalars, the mid-seed mask bits,
// the stage, and with K4 / K8 the fp32 dx tile (64 rows only: K17 keeps
// its 128-row dx tile in its block's global workspace).
template <int ROWS>
struct BwdSmem {
  static constexpr int D = 0;
  static constexpr int INP = D + ROWS * LDH * 2;
  static constexpr int BX = INP + ROWS * LDH * 2;
  static constexpr int ROWF = BX + ROWS * LDX * 2;
  static constexpr int MBITS = ROWF + ROWS * RF * 4;
  static constexpr int STAGE = MBITS + ROWS * (MID / 32) * 4;
  static constexpr int DXE = STAGE + STAGE_BYTES;
  static_assert(ROWF % 32 == 0 && MBITS % 32 == 0 && STAGE % 32 == 0 &&
                DXE % 32 == 0, "alignment");
};
constexpr int K5_SMEM_BYTES = BwdSmem<TM>::DXE;
constexpr int K4_SMEM_BYTES = BwdSmem<TM>::DXE + TM * ENC * 4;
// kernel A: the stash's staging buffers behind the layout of the body that
// uses them (K5's, or K4's with the dx tile: K4 and K8)
constexpr int K5A_SMEM_BYTES = K5_SMEM_BYTES + wgrad::STASH_SMEM_BYTES;
constexpr int K4A_SMEM_BYTES = K4_SMEM_BYTES + wgrad::STASH_SMEM_BYTES;
static_assert(K4A_SMEM_BYTES <= 232448, "K4's kernel A must fit one SM");
constexpr int WHOLE = 2 * TM;  // K17's row tile
constexpr int K17_SMEM_BYTES = BwdSmem<WHOLE>::DXE;
static_assert(K17_SMEM_BYTES <= 232448, "K17 must fit one SM");
// K17's kernel A: its 194,560 bytes and two staging buffers (260,096) do
// not fit, so it stages through one 32 KB buffer, a piece at a time
constexpr int K17A_SMEM_BYTES = K17_SMEM_BYTES + wgrad::STAGING_BYTES;
static_assert(K17A_SMEM_BYTES <= 232448, "K17's kernel A must fit one SM");
static_assert(K17_SMEM_BYTES % 1024 == 0, "the staging buffer's alignment");

struct BwdArgs {
  const float* mc;      // (N, 16) f32, K4 and K8
  const float* g;       // (R, 512) f32
  const float* consts;  // IPE constants, K4 and K8
  const bf16* acts;     // (N, 2048) K4 or (N, 2176) K5; K8: none
  const bf16* dout;     // (N, 24) bf16 cotangent of the forward's output
  const bf16* fout;     // (N, 24) bf16, the forward's output
  float* dmc;           // (N, 16) f32, K4 and K8
  float* dg;            // (R, 512) f32, zeroed by the caller
  float* dpk;           // (blocks, GradSlice<STASH>::FLOATS) f32, zeroed
  bf16* ws;             // K8: (blocks, ROWS, 2048) bf16 recompute slots
  long long rays;
  int S;
  int rays_per_block;
  float* dxe;           // K17: (blocks, 128, 128) f32 dx tiles
  unsigned char* stash = nullptr;  // kernel A: the chunk's wgrad workspace
  int tile0 = 0, tile1 = 0;        // kernel A: the chunk's tiles of each run
};

// Offsets in a block's fp32 gradient slice: the 20 packed operands
// (PACK_FLOATS), or with STASH (kernel A, whose weight matrices go to the
// workspace instead) only the biases and the mid head: b0..b7, b_hc,
// w_out's 3 live columns (128 x 3), b_out (3, padded to 4).
template <bool STASH>
struct GradSlice {
  static constexpr int B = STASH ? 0 : OFF_B;
  static constexpr int BHC = STASH ? LAYERS * WIDTH : OFF_BHC;
  static constexpr int WOUT = STASH ? BHC + WIDTH : OFF_WOUT;
  static constexpr int LDWOUT = STASH ? 3 : MID;
  static constexpr int BOUT = STASH ? WOUT + MID * 3 : OFF_BOUT;
  static constexpr int FLOATS = STASH ? BOUT + 4 : PACK_FLOATS;
};
static_assert(GradSlice<true>::FLOATS == 2692, "K8's compact slice");

// K4 (WANT_DMC), K5, and with RECOMPUTE (K8, K13) K4 on activations that
// the block recomputes per tile into its workspace slot.  ROWS: the row
// tile, 64 (K4, K5, K8, K13) or 128 (K17, recompute only).  Every product
// that contracts over the rows (the weight gradients) runs over the whole
// tile between one load and one store of the block's slice; the trunk
// recompute, the dgrads and their epilogues run on the tile's 64-row
// halves, each element computed as on a 64-row tile.  STASH (kernel A of
// K4, K5, K8, K13 and K17): only the tiles [a.tile0, a.tile1) of the
// block's run, and instead of
// each weight-gradient product its two operand tiles go to the tile's
// record of the chunk's workspace (wgrad_sm90.cuh), which kernel B
// contracts; the biases and the mid head's gradients go to the block's
// compact slice (GradSlice<true>), summed over the chunks' launches in
// the same order as over one run.  K17's 128-row tile stashes each of its
// two 64-row halves as the record of that 64-row tile (so its records are
// K8's); a chunk's a.tile0 is even, so no 128-row tile straddles two
// chunks, and a half past the end of the run has no record of its own.
template <bool WANT_DMC, bool RECOMPUTE, int ROWS = TM, bool STASH = false>
__device__ void field_backward_body(const V3Params& p, const BwdArgs& a) {
  static_assert(WANT_DMC || !RECOMPUTE, "K8 computes dmc");
  static_assert(ROWS == TM || RECOMPUTE, "128-row tiles: K17 only");
  static_assert(ROWS % TM == 0 && ROWS <= THREADS, "64-row halves");
  typedef BwdSmem<ROWS> L;
  typedef GradSlice<STASH> G;
  constexpr int HALVES = ROWS / TM;
  // K17's kernel A: one staging buffer (K17A_SMEM_BYTES), so each stash
  // point's four pieces (the two operands of each half) go out in turns
  constexpr bool SPLIT = STASH && HALVES == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* D = reinterpret_cast<bf16*>(smem + L::D);
  bf16* INP = reinterpret_cast<bf16*>(smem + L::INP);
  bf16* X = reinterpret_cast<bf16*>(smem + L::BX);
  float* rowf = reinterpret_cast<float*>(smem + L::ROWF);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L::MBITS);
  float* stage = reinterpret_cast<float*>(smem + L::STAGE);
  float* dxe = ROWS == TM  // K4, K8: in shared memory; K17: its workspace
      ? reinterpret_cast<float*>(smem + L::DXE)
      : a.dxe + (long long)blockIdx.x * ROWS * ENC;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = a.S;
  constexpr int ld = WANT_DMC ? ACTS_COLS : XACTS_COLS;

  const long long ray0 = (long long)blockIdx.x * a.rays_per_block;
  const long long ray1 = min(a.rays, ray0 + a.rays_per_block);
  const long long rowA = ray0 * S, rowB = ray1 * S;
  float* grp = a.dpk + (long long)blockIdx.x * G::FLOATS;
  const long long rowEnd =
      STASH ? min(rowB, rowA + (long long)a.tile1 * TM) : rowB;
  const long long chunk_tiles = a.tile1 - a.tile0;
  // kernel A: the staging buffers behind the body's layout (K4's with the
  // dx tile, or K5's; K17's one buffer behind its own)
  wgrad::Stash st{smem + (ROWS == WHOLE ? K17_SMEM_BYTES
                          : WANT_DMC    ? K4_SMEM_BYTES
                                        : K5_SMEM_BYTES)};
  // K17's kernel A: one piece of a stash point through the one buffer,
  // once every thread's previous gathers may overwrite it; thread 0 copies
  // it to dst (a half with rows only) after the barrier behind the gathers
  auto turn = [&](auto gather, unsigned char* dst, int bytes, bool live) {
    st.wait_free();
    block_sync();
    gather();
    st.gathered();
    block_sync();
    if (live) st.copy_out(dst, bytes);
  };

  for (long long row0 = STASH ? rowA + (long long)a.tile0 * TM : rowA;
       row0 < rowEnd; row0 += ROWS) {
    const int nv = (int)min((long long)ROWS, rowB - row0);
    // kernel A: the record of the tile's 64-row half h
    auto record = [&](int h) {
      return a.stash + (blockIdx.x * chunk_tiles + (row0 + h * TM - rowA) / TM -
                        a.tile0) * wgrad::REC_BYTES;
    };
    unsigned char* rec = STASH ? record(0) : nullptr;
    bf16* slot =
        RECOMPUTE ? a.ws + (long long)blockIdx.x * ROWS * ld : nullptr;
    const bf16* acts = RECOMPUTE ? slot : a.acts + row0 * ld;

    // ---- K8: the tile's trunk forward again, K3's code, into the slot
    // (D and INP serve as the two activation buffers, BSTAGE as stage) ----
    if (RECOMPUTE) {
      ipe_rows<false>(a.mc, a.consts, row0, rowB, X, tid, THREADS, ROWS);
      block_sync();
      for (int h = 0; h < HALVES; ++h)
        trunk(p.trunk, X + h * TM * LDX, D + h * TM * LDH,
              INP + h * TM * LDH, stage,
              SpillHook{slot + h * TM * ld, ld, nv - h * TM, nullptr});
    }

    // ---- loads: hs7, x, per-row scalars ----
    load_rows<ROWS>(INP, LDH, acts + (LAYERS - 1) * WIDTH, ld, WIDTH, nv);
    if (WANT_DMC && !RECOMPUTE)
      ipe_tile(a.mc, a.consts, row0, rowB, X);
    else if (!WANT_DMC)
      load_rows(X, LDX, acts + ACTS_COLS, ld, ENC, nv);
    for (int e = tid; e < ROWS * (MID / 32); e += THREADS) mbits[e] = 0u;
    if (tid < ROWS) {
      float* rf = rowf + tid * RF;
      for (int i = 0; i < RF; ++i) rf[i] = 0.f;
      if (tid < nv) {
        const bf16* fo = a.fout + (row0 + tid) * OUT_TRAIN;
        const float sp = softplusf(__bfloat162float(fo[13]));
        for (int b = 0; b < 4; ++b) rf[b] = expf(__fmul_rn(-sp, band_k(b)));
        float diff[3], tint[3], mid[3];
        for (int i = 0; i < 3; ++i) {
          diff[i] = __bfloat162float(fo[3 + i]);
          tint[i] = __bfloat162float(fo[6 + i]);
          mid[i] = __bfloat162float(fo[17 + i]);
        }
        tail_cotangents(a.dout + (row0 + tid) * OUT_TRAIN, diff, tint, mid,
                        rf);
      }
    }
    block_sync();

    // ---- mid seed recompute: hmid into D[:, 0:128], mid_pre > 0 bits ----
    for (int h = 0; h < HALVES; ++h) {
      const int r0 = h * TM;
      FragC acc[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i][0], 0.f);
      for (int kt = 0; kt < WIDTH / 16; ++kt) {
        FragB b;
        wmma::load_matrix_sync(b, p.w_hc + kt * 16 * WIDTH + MID + warp * 16,
                               WIDTH);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, INP + (r0 + i * 16) * LDH + kt * 16, LDH);
          wmma::mma_sync(acc[i][0], fa, b, acc[i][0]);
        }
      }
      drain<1>(acc, 0, stage, [&](int rr, int c, float v) {
        const int r = r0 + rr;
        float m = __fadd_rn(v, p.b_hc[MID + c]);
        if (r < nv) {
          const float* gr = a.g + ((row0 + r) / S) * G_COLS + c;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            m = __fadd_rn(m, __fmul_rn(rowf[r * RF + b], gr[b * MID]));
        }
        D[r * LDH + c] = __float2bfloat16_rn(relu_keep_nan(m));
        if (m > 0.f) atomicOr(&mbits[r * (MID / 32) + (c >> 5)],
                              1u << (c & 31));
        return 0.f;
      }, NoColSum());
    }
    block_sync();

    // ---- mid head: w_out / b_out gradients; dmid_pre, dg, b_hc[128:] ----
    mid_head_wgrad(D, LDH, rowf, RF, ROWS, grp + G::WOUT, grp + G::BOUT,
                   G::LDWOUT);
    dmid_pre_rows(p.w_out, mbits, rowf, RF, ROWS, nv, row0, S, a.dg,
                  D + MID, LDH, grp + G::BHC + MID);
    block_sync();

    // ---- the head columns of d_hc into D[:, 0:16] ----
    for (int e = tid; e < ROWS * 16; e += THREADS) {
      const int r = e / 16, c = e % 16;
      D[r * LDH + c] = __float2bfloat16_rn(c < 11 ? rowf[r * RF + 10 + c] : 0.f);
    }
    if (tid < 11) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s = __fadd_rn(s, rowf[r * RF + 10 + tid]);
      grp[G::BHC + tid] += s;
    }
    if constexpr (STASH) st.wait_free();
    block_sync();

    // ---- heads + mid: dW_hc += hs7^T d_hc (kernel A: hs7 and d_hc's 144 live
    // columns to the record, copied after the barrier below; K17: each
    // half's, in turns, here); dh7 = d_hc w_hc^T ----
    if constexpr (SPLIT) {
      for (int h = 0; h < HALVES; ++h) {
        const bf16* Dh = D + h * TM * LDH;
        turn([&] { wgrad::stage_rows(st.buf, INP + h * TM * LDH, LDH,
                                     WIDTH); },
             record(h) + wgrad::ACT_OFF + (LAYERS - 1) * wgrad::ACT_BYTES,
             wgrad::ACT_BYTES, nv > h * TM);
        turn([&] {
               wgrad::stage_rows(st.buf, Dh, LDH, 16);
               wgrad::stage_rows(st.buf, Dh + MID, LDH, MID, 16);
             },
             record(h) + wgrad::DHC_OFF, sm90::HEAD_N * wgrad::FEAT_BYTES,
             nv > h * TM);
      }
    } else if constexpr (STASH) {
      wgrad::stage_rows(st.buf, INP, LDH, WIDTH);
      wgrad::stage_rows(st.second(), D, LDH, 16);  // the heads, the mid seed
      wgrad::stage_rows(st.second(), D + MID, LDH, MID, 16);
      st.gathered();
    } else {
      wgrad_acc<ROWS>(INP, LDH, WIDTH, D, LDH, HC_TILES, grp + OFF_WHC,
                      WIDTH);
    }
    for (int h = 0; h < HALVES; ++h) {
      const int r0 = h * TM;
      FragC acc[4][2];
      dgrad_mma<2>(D + r0 * LDH, p.w_hc, 0, HC_TILES, acc);
      block_sync();
      if constexpr (STASH && !SPLIT)
        st.copy_out(rec + wgrad::ACT_OFF + (LAYERS - 1) * wgrad::ACT_BYTES,
                    wgrad::ACT_BYTES, rec + wgrad::DHC_OFF,
                    sm90::HEAD_N * wgrad::FEAT_BYTES);
      drain<2>(acc, 0, stage, [&](int rr, int c, float v) {
        const int r = r0 + rr;
        const float m =
            (r < nv && __bfloat162float(INP[r * LDH + c]) > 0.f) ? v : 0.f;
        D[r * LDH + c] = __float2bfloat16_rn(m);
        return m;
      }, BiasSum{grp + G::B + (LAYERS - 1) * WIDTH});
    }
    block_sync();

    // ---- trunk: D holds dpre_i; INP gets layer i's input hs_{i-1} ----
    for (int i = LAYERS - 1; i >= 0; --i) {
      if (i > 0) {
        load_rows<ROWS>(INP, LDH, acts + (i - 1) * WIDTH, ld, WIDTH, nv);
        if constexpr (STASH) st.wait_free();
        block_sync();
      }
      // kernel A: X (layer 0) or hs_{i-1}, and dpre_i, to the record: copied
      // after the next barrier (K17: each half's, in turns, here)
      const int off0 =
          i == 0 ? wgrad::X_OFF : wgrad::ACT_OFF + (i - 1) * wgrad::ACT_BYTES;
      const int bytes0 = (i == 0 ? ENC : WIDTH) * wgrad::FEAT_BYTES;
      const int off1 = wgrad::DPRE_OFF + i * wgrad::ACT_BYTES;
      if constexpr (SPLIT) {
        for (int h = 0; h < HALVES; ++h) {
          turn([&] {
                 if (i == 0)
                   wgrad::stage_rows(st.buf, X + h * TM * LDX, LDX, ENC);
                 else
                   wgrad::stage_rows(st.buf, INP + h * TM * LDH, LDH, WIDTH);
               },
               record(h) + off0, bytes0, nv > h * TM);
          turn([&] { wgrad::stage_rows(st.buf, D + h * TM * LDH, LDH,
                                       WIDTH); },
               record(h) + off1, wgrad::ACT_BYTES, nv > h * TM);
        }
      } else if constexpr (STASH) {
        if (i == 0)
          wgrad::stage_rows(st.buf, X, LDX, ENC);
        else
          wgrad::stage_rows(st.buf, INP, LDH, WIDTH);
        wgrad::stage_rows(st.second(), D, LDH, WIDTH);
        st.gathered();
      } else {
        float* dW = grp + off_w(i);
        if (i == 0 || i == SKIP_AT)
          wgrad_acc<ROWS>(X, LDX, ENC, D, LDH, ALL_TILES, dW, WIDTH);
        if (i > 0)
          wgrad_acc<ROWS>(INP, LDH, WIDTH, D, LDH, ALL_TILES,
                          i == SKIP_AT ? dW + ENC * WIDTH : dW, WIDTH);
      }
      const bf16* W = p.trunk.w[i];
      for (int h = 0; h < HALVES; ++h) {
        const int r0 = h * TM;
        if (WANT_DMC && (i == 0 || i == SKIP_AT)) {
          FragC acc[4][1];
          dgrad_mma<1>(D + r0 * LDH, W, 0, ALL_TILES, acc);
          const bool first = i == SKIP_AT;
          drain<1>(acc, 0, stage, [&](int rr, int c, float v) {
            float* d = dxe + (r0 + rr) * ENC + c;
            *d = first ? v : __fadd_rn(v, *d);
            return 0.f;
          }, NoColSum());
        }
        if (i > 0) {
          const int c0 = i == SKIP_AT ? ENC : 0;
          FragC acc[4][2];
          dgrad_mma<2>(D + r0 * LDH, W, c0, ALL_TILES, acc);
          block_sync();  // wgrad and dgrad reads of D are done
          if constexpr (STASH && !SPLIT)
            st.copy_out(rec + off0, bytes0, rec + off1, wgrad::ACT_BYTES);
          drain<2>(acc, c0, stage, [&](int rr, int c, float v) {
            const int r = r0 + rr, hc = c - c0;
            const float m =
                (r < nv && __bfloat162float(INP[r * LDH + hc]) > 0.f) ? v
                                                                      : 0.f;
            D[r * LDH + hc] = __float2bfloat16_rn(m);
            return m;
          }, BiasSum{grp + G::B + (i - 1) * WIDTH - c0});
        }
      }
      if constexpr (STASH)
        if (i == 1) st.wait_free();  // layer 0 gathers after this barrier
      block_sync();
      if constexpr (STASH && !SPLIT)
        if (i == 0)
          st.copy_out(rec + off0, bytes0, rec + off1, wgrad::ACT_BYTES);
    }

    // ---- IPE backward (K4): dmc = dpre_enc A^T + dvar V^T ----
    if (WANT_DMC) {
      ipe_backward_rows(a.mc, a.consts, dxe, a.dmc, row0, nv, ROWS);
      block_sync();
    }
  }
  if constexpr (STASH) {  // the chunk's records past the end of the run
    const long long tiles = (rowB - rowA + TM - 1) / TM;
    for (long long t = max(tiles, (long long)a.tile0); t < a.tile1; ++t)
      wgrad::zero_record(a.stash + (blockIdx.x * chunk_tiles + t - a.tile0) *
                                       wgrad::REC_BYTES);
    st.drain();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v5_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, false, TM, true>(p, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v6_kernel(V3Params p, BwdArgs a) {
  field_backward_body<false, false, TM, true>(p, a);
}

__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v4_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, true, TM, true>(p, a);
}

// K17's kernel A: K8's on 128-row tiles, each tile's halves stashed as the
// records of K8's 64-row tiles
__global__ void __launch_bounds__(THREADS, 1)
    field_backward_whole_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, true, WHOLE, true>(p, a);
}

// K13's whole-grid sums, after K8's kernel A and kernel B on every chunk:
// grads (PACK_FLOATS, the packed operands' shapes in order) from kernel B's
// `slices` partials (w0..w7, then w_hc's 144 live columns), summed in slice
// order, and the `blocks` compact slices of kernel A (GradSlice<true>: the
// biases, w_out's and b_out's 3 live columns), summed in block order; w_hc's
// columns 16..127 and w_out's and b_out's past 3 are zero.  One thread per
// output float, a fixed order, no atomics, so the result is the same from
// run to run.  Bound by its bytes: it reads each of the slices x 561,152
// partial floats and blocks x 2,692 slice floats once and writes 608,640.
constexpr int SUM_THREADS = 256;
__global__ void __launch_bounds__(SUM_THREADS)
    field_backward_v3_sum_kernel(const float* __restrict__ partial,
                                 int slices, const float* __restrict__ small,
                                 int blocks, float* __restrict__ grads) {
  typedef GradSlice<true> G;
  const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (c >= PACK_FLOATS) return;
  const float* src = nullptr;  // the column's first term; none: zero
  int terms = 0;
  long long stride = 0;
  auto from_partial = [&](int off) {
    src = partial + off;
    terms = slices;
    stride = wgrad::PARTIAL_FLOATS;
  };
  auto from_small = [&](int off) {
    src = small + off;
    terms = blocks;
    stride = G::FLOATS;
  };
  if (c < OFF_B) {
    from_partial(c);  // w0..w7: the partial's first W_FLOATS, in order
  } else if (c < OFF_WHC) {
    from_small(G::B + c - OFF_B);
  } else if (c < OFF_BHC) {  // w_hc (256, 256): 16 head, 128 mid columns
    const int r = (c - OFF_WHC) / WIDTH, k = (c - OFF_WHC) % WIDTH;
    const int live = k < 16 ? k : k >= MID ? 16 + k - MID : -1;
    if (live >= 0) from_partial(wgrad::W_FLOATS + r * sm90::HEAD_N + live);
  } else if (c < OFF_WOUT) {
    from_small(G::BHC + c - OFF_BHC);
  } else if (c < OFF_BOUT) {  // w_out (128, 128): columns 0..2
    const int r = (c - OFF_WOUT) / MID, k = (c - OFF_WOUT) % MID;
    if (k < 3) from_small(G::WOUT + r * 3 + k);
  } else if (c - OFF_BOUT < 3) {
    from_small(G::BOUT + c - OFF_BOUT);
  }
  float s = 0.f;
  for (int t = 0; t < terms; ++t) s = __fadd_rn(s, src[t * stride]);
  grads[c] = s;
}
static_assert(wgrad::W_FLOATS == OFF_B, "the partial's w0..w7 are packed");

#ifdef RSN_K13_FIRST_DESIGN
// The first design of K17 and K13 (chip_smoke.py, the card tests), kept as
// their yardstick: K8's body with the weight-gradient products summed into
// the block's fp32 slice of all 20 gradients.  K17 on 128-row tiles:
__global__ void __launch_bounds__(THREADS, 1)
    field_backward_whole_first_kernel(V3Params p, BwdArgs a) {
  field_backward_body<true, true, WHOLE>(p, a);
}

// K13: K8's body, then the weight gradients summed over the blocks' slices
// in the kernel.  Launched cooperatively (every block resident), so a
// grid-wide barrier on the zeroed counter `arrived` can wait for every
// slice; then each thread sums its columns over the slices in block order
// (a fixed order, no float atomics) into grads (608640 floats, the packed
// operands' shapes in order).
__global__ void __launch_bounds__(THREADS, 1)
    field_backward_v3_kernel(V3Params p, BwdArgs a, float* __restrict__ grads,
                             unsigned* arrived) {
  field_backward_body<true, true>(p, a);
  __threadfence();  // this thread's slice, dmc and dg writes, device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(arrived, 1u);
    while (atomicAdd(arrived, 0u) < gridDim.x) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
  for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
       c < PACK_FLOATS; c += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b)
      s = __fadd_rn(s, __ldcg(a.dpk + (long long)b * PACK_FLOATS + c));
    grads[c] = s;
  }
}
#endif

// A persistent grid of at most one block per SM over the 128-row tiles.
template <typename Kernel>
int launch_ring(Kernel kernel, int smem_bytes, const sm90::TrainParams& p,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.r.n + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, sm90::BLOCK_THREADS, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool NORMALS, bool SPILL, bool SPILL_X>
int launch_train(const sm90::TrainParams& p, cudaStream_t stream) {
  return launch_ring(field_train_kernel<NORMALS, SPILL, SPILL_X>,
                     sm90::TRAIN_SMEM_BYTES, p, stream);
}

// ptrs: the 20 packed operands [+ wd_row]; blob: the train blob.
void fill_train(sm90::TrainParams* t, const void* mean_cov,
                const void* g_bands, const void* ipe_consts,
                const void* blob, const void* const* ptrs, void* out,
                long long n, int samples_per_ray, int want_normals) {
  *t = sm90::TrainParams{};
  sm90::RenderParams& p = t->r;
  p.mc = static_cast<const float*>(mean_cov);
  p.consts = static_cast<const float*>(ipe_consts);
  p.blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p.n = n;
  p.out = static_cast<bf16*>(out);
  p.g = static_cast<const float*>(g_bands);
  p.S = samples_per_ray;
  p.w_hc = static_cast<const bf16*>(ptrs[16]);
  p.b_hc = static_cast<const float*>(ptrs[17]);
  p.w_out = static_cast<const bf16*>(ptrs[18]);
  p.b_out = static_cast<const float*>(ptrs[19]);
  t->wd_row = want_normals ? static_cast<const float*>(ptrs[20]) : nullptr;
}

#ifdef RSN_K10_FIRST_DESIGN
template <bool NORMALS>
int launch_v5(const float* mc, const float* g, const float* consts,
              const V3Params& p, const float* wd_row, bf16* out, long long n,
              int S, cudaStream_t stream) {
  auto kernel = field_forward_v5_first_kernel<NORMALS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K10_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + TM - 1) / TM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, K10_THREADS, K10_SMEM_BYTES, stream>>>(mc, g, consts, p,
                                                        wd_row, out, n, S);
  return (int)cudaGetLastError();
}
#endif

template <typename Kernel>
int launch_backward(Kernel kernel, int smem_bytes, const V3Params& p,
                    const BwdArgs& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)((a.rays + a.rays_per_block - 1) / a.rays_per_block);
  kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: w0..w7, b0..b7, w_hc, b_hc, w_out, b_out [, wd_row (1, 256) f32
// when want_normals] (device pointers; the kernel reads the weights from
// blob, the biases, w_hc's column 0 and w_out from ptrs); blob:
// rsn_pack_train_blob's.  out (N, 24) bf16, acts (N, 2048) or (N, 2176)
// with spill_x.  Returns a cudaError_t code (0 = launched).
int rsn_field_forward_v6(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* blob,
                         const void* const* ptrs, void* out, void* acts,
                         long long n, int samples_per_ray, int want_normals,
                         int spill_x, void* stream) {
  sm90::TrainParams p;
  fill_train(&p, mean_cov, g_bands, ipe_consts, blob, ptrs, out, n,
             samples_per_ray, want_normals);
  p.acts = static_cast<bf16*>(acts);
  p.ld = spill_x ? XACTS_COLS : ACTS_COLS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals && spill_x) return launch_train<true, true, true>(p, st);
  if (want_normals) return launch_train<true, true, false>(p, st);
  if (spill_x) return launch_train<false, true, true>(p, st);
  return launch_train<false, true, false>(p, st);
}

// K7 (want_normals: ptrs carries wd_row as ptrs[20]) or K1 at the train
// width: K3's out (N, 24) bf16 without the spill.
int rsn_field_forward_v4(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* blob,
                         const void* const* ptrs, void* out, long long n,
                         int samples_per_ray, int want_normals,
                         void* stream) {
  sm90::TrainParams p;
  fill_train(&p, mean_cov, g_bands, ipe_consts, blob, ptrs, out, n,
             samples_per_ray, want_normals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals) return launch_train<true, false, false>(p, st);
  return launch_train<false, false, false>(p, st);
}

// The train blob of K3, K7 and K1 at the train width (2,146,304 bytes):
// ptrs w0..w7, w_hc (fp32, or bf16 with bf16_in), strides their (row,
// column) element strides, 18 values.  One launch.
int rsn_pack_train_blob(const void* const* ptrs, const long long* strides,
                        int bf16_in, void* blob, void* stream) {
  sm90::PackArgs a;
  for (int i = 0; i <= LAYERS; ++i) {
    a.p[i] = ptrs[i];
    a.s0[i] = strides[2 * i];
    a.s1[i] = strides[2 * i + 1];
  }
  constexpr long long groups =
      sm90::blob_bytes(sm90::FWD_CHUNKS + sm90::DGRAD_CHUNKS) / 16;
  const unsigned grid = (unsigned)((groups + 255) / 256);
  unsigned char* b = static_cast<unsigned char*>(blob);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    sm90::pack_train_blob_kernel<bf16><<<grid, 256, 0, st>>>(a, b);
  else
    sm90::pack_train_blob_kernel<float><<<grid, 256, 0, st>>>(a, b);
  return (int)cudaGetLastError();
}

// K4's kernel A on one chunk: tiles [tile0, tile1) of every block's run
// (rays_per_block whole rays per block).  ptrs: the 20 packed operands;
// small: ceil(rays / rays_per_block) zeroed compact slices of 2692 floats
// (GradSlice<true>), summed into over a call's chunks; stash: the chunk's
// blocks x (tile1 - tile0) records of wgrad::REC_BYTES (written whole); dg
// zeroed.
int rsn_field_backward_v5(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* acts,
                          const void* d_out, const void* f_out,
                          const void* const* ptrs, void* dmc, void* dg,
                          void* small, void* stash, long long rays,
                          int samples_per_ray, int rays_per_block, int tile0,
                          int tile1, void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts),
            static_cast<const bf16*>(acts), static_cast<const bf16*>(d_out),
            static_cast<const bf16*>(f_out), static_cast<float*>(dmc),
            static_cast<float*>(dg), static_cast<float*>(small), nullptr,
            rays, samples_per_ray, rays_per_block, nullptr,
            static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_backward(field_backward_v5_kernel, K4A_SMEM_BYTES, p, a,
                         stream);
}

// K5's kernel A on one chunk: K4's without dmc; xacts (N, 2176) carries x.
int rsn_field_backward_v6(const void* g_bands, const void* xacts,
                          const void* d_out, const void* f_out,
                          const void* const* ptrs, void* dg, void* small,
                          void* stash, long long rays, int samples_per_ray,
                          int rays_per_block, int tile0, int tile1,
                          void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{nullptr, static_cast<const float*>(g_bands), nullptr,
            static_cast<const bf16*>(xacts), static_cast<const bf16*>(d_out),
            static_cast<const bf16*>(f_out), nullptr,
            static_cast<float*>(dg), static_cast<float*>(small), nullptr,
            rays, samples_per_ray, rays_per_block, nullptr,
            static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_backward(field_backward_v6_kernel, K5A_SMEM_BYTES, p, a,
                         stream);
}

// K8's kernel A on one chunk: K4's arguments without the spill, plus ws:
// ceil(rays / rays_per_block) recompute slots of 64 x 2048 bf16
// (uninitialised).
int rsn_field_backward_v4(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* d_out,
                          const void* f_out, const void* const* ptrs,
                          void* dmc, void* dg, void* small, void* ws,
                          void* stash, long long rays, int samples_per_ray,
                          int rays_per_block, int tile0, int tile1,
                          void* stream) {
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(small), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block, nullptr,
            static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_backward(field_backward_v4_kernel, K4A_SMEM_BYTES, p, a,
                         stream);
}

// Kernel B (K4's, K5's and K8's) on one chunk: records (blocks x tiles of
// the chunk) at
// stash into `slices` fp32 partials of wgrad::PARTIAL_FLOATS (w0..w7, then
// w_hc's 144 live columns), which it overwrites (accumulate 0: the call's
// first chunk) or adds to.
int rsn_wgrad_sm90(const void* stash, void* partial, long long records,
                   int slices, int accumulate, void* stream) {
  return wgrad::launch_wgrad<wgrad::Folded>(
      stash, partial, records, slices, accumulate,
      static_cast<cudaStream_t>(stream));
}

// K17's kernel A on one chunk: K8's arguments (tile0 even), with ws
// ceil(rays / rays_per_block) recompute slots of 128 x 2048 bf16 and dxe as
// many (128, 128) f32 dx tiles (both uninitialised); its records are K8's
// for the same chunk, and kernel B (rsn_wgrad_sm90) contracts them.
int rsn_field_backward_whole_stash(const void* mean_cov, const void* g_bands,
                                   const void* ipe_consts, const void* d_out,
                                   const void* f_out, const void* const* ptrs,
                                   void* dmc, void* dg, void* small, void* ws,
                                   void* dxe, void* stash, long long rays,
                                   int samples_per_ray, int rays_per_block,
                                   int tile0, int tile1, void* stream) {
  if (tile0 % 2) return (int)cudaErrorInvalidValue;  // a 128-row tile's
                                                      // halves: one chunk
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(small), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block, static_cast<float*>(dxe),
            static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_backward(field_backward_whole_kernel, K17A_SMEM_BYTES, p, a,
                         stream);
}

// K13's sums after its chunks (K8's kernel A and kernel B): partial, the
// `slices` fp32 partials of kernel B (wgrad::PARTIAL_FLOATS each); small,
// the `blocks` compact slices of kernel A (2692 floats each); grads, the
// 608640 floats of the 20 gradients (written).
int rsn_field_backward_v3_sum(const void* partial, int slices,
                              const void* small, int blocks, void* grads,
                              void* stream) {
  const unsigned grid = (PACK_FLOATS + SUM_THREADS - 1) / SUM_THREADS;
  field_backward_v3_sum_kernel<<<grid, SUM_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), slices,
      static_cast<const float*>(small), blocks, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

// K17's first design, one launch (the RSN_K13_FIRST_DESIGN build; the
// port's returns cudaErrorNotSupported: K17 runs in chunks,
// rsn_field_backward_whole_stash then rsn_wgrad_sm90).  ws and dxe as for
// the stash; dg zeroed, dpk as many zeroed slices of 608640 floats.
int rsn_field_backward_whole(const void* mean_cov, const void* g_bands,
                             const void* ipe_consts, const void* d_out,
                             const void* f_out, const void* const* ptrs,
                             void* dmc, void* dg, void* dpk, void* ws,
                             void* dxe, long long rays, int samples_per_ray,
                             int rays_per_block, void* stream) {
#ifdef RSN_K13_FIRST_DESIGN
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(dpk), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block, static_cast<float*>(dxe)};
  return launch_backward(field_backward_whole_first_kernel, K17_SMEM_BYTES,
                         p, a, stream);
#else
  (void)mean_cov, (void)g_bands, (void)ipe_consts, (void)d_out, (void)f_out;
  (void)ptrs, (void)dmc, (void)dg, (void)dpk, (void)ws, (void)dxe;
  (void)rays, (void)samples_per_ray, (void)rays_per_block, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

// K10: K7 (want_normals: ptrs carries wd_row as ptrs[20]) or K1 at the
// train width, each tile's IPE computed by the producer warpgroup's idle
// warps; K7's arguments (blob: rsn_pack_train_blob's) and the same (N, 24)
// bf16 output, bit for bit.  The RSN_K10_FIRST_DESIGN build runs the
// 64-row wmma forward with a second X slot instead (blob unused).
int rsn_field_forward_v5(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* blob,
                         const void* const* ptrs, void* out, long long n,
                         int samples_per_ray, int want_normals,
                         void* stream) {
#ifndef RSN_K10_FIRST_DESIGN
  sm90::TrainParams t;
  fill_train(&t, mean_cov, g_bands, ipe_consts, blob, ptrs, out, n,
             samples_per_ray, want_normals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_normals)
    return launch_ring(field_forward_v5_kernel<true>,
                       sm90::TRAIN_AHEAD_SMEM_BYTES, t, s);
  return launch_ring(field_forward_v5_kernel<false>,
                     sm90::TRAIN_AHEAD_SMEM_BYTES, t, s);
#else
  (void)blob;
  V3Params p;
  fill_v3(&p, ptrs);
  const float* mc = static_cast<const float*>(mean_cov);
  const float* g = static_cast<const float*>(g_bands);
  const float* consts = static_cast<const float*>(ipe_consts);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (want_normals)
    return launch_v5<true>(mc, g, consts, p,
                           static_cast<const float*>(ptrs[20]), o, n,
                           samples_per_ray, st);
  return launch_v5<false>(mc, g, consts, p, nullptr, o, n, samples_per_ray,
                          st);
#endif
}

// K13's first design, one cooperative launch (the RSN_K13_FIRST_DESIGN
// build; the port's returns cudaErrorNotSupported: K13 runs K8's chunks,
// then rsn_field_backward_v3_sum): K8's first-design arguments (dpk
// ceil(rays / rays_per_block) zeroed slices of 608640 floats, ws as many
// 64 x 2048 bf16 slots), plus grads (608640 floats, written) and arrived
// (one zeroed unsigned).  The grid must fit the card at one block per SM
// (the cooperative launch checks it).
int rsn_field_backward_v3(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* d_out,
                          const void* f_out, const void* const* ptrs,
                          void* dmc, void* dg, void* dpk, void* ws,
                          void* grads, void* arrived, long long rays,
                          int samples_per_ray, int rays_per_block,
                          void* stream) {
#ifndef RSN_K13_FIRST_DESIGN
  (void)mean_cov, (void)g_bands, (void)ipe_consts, (void)d_out, (void)f_out;
  (void)ptrs, (void)dmc, (void)dg, (void)dpk, (void)ws, (void)grads;
  (void)arrived, (void)rays, (void)samples_per_ray, (void)rays_per_block;
  (void)stream;
  return (int)cudaErrorNotSupported;
#else
  V3Params p;
  fill_v3(&p, ptrs);
  BwdArgs a{static_cast<const float*>(mean_cov),
            static_cast<const float*>(g_bands),
            static_cast<const float*>(ipe_consts), nullptr,
            static_cast<const bf16*>(d_out), static_cast<const bf16*>(f_out),
            static_cast<float*>(dmc), static_cast<float*>(dg),
            static_cast<float*>(dpk), static_cast<bf16*>(ws), rays,
            samples_per_ray, rays_per_block};
  float* gr = static_cast<float*>(grads);
  unsigned* ar = static_cast<unsigned*>(arrived);
  cudaError_t err = cudaFuncSetAttribute(
      field_backward_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K4_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rays + rays_per_block - 1) /
                                   rays_per_block);
  void* args[] = {&p, &a, &gr, &ar};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(field_backward_v3_kernel), dim3(grid),
      dim3(THREADS), args, K4_SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#endif
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
