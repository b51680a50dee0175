// The backward experiments of rsn's tools/, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels under tools/ (the third, K17, is K8's
// body on 128-row tiles in field_train.cu):
//   run (K18; tools/exp_bwd_ablate.py, make_kernel / _half): the unfolded
//       recompute backward in four modes, on pack_params_v3's 22 operands:
//       K1's polynomial IPE -> bf16 trunk -> the unfolded (256, 384) heads
//       with the 256-wide bottleneck -> bf16(bottleneck) @ w_emb + b_mid +
//       the roughness-attenuated per-ray SH band partials -> mid head, all
//       recomputed from mean_cov, then backward against d_out (N, 128)
//       bf16 (columns 0:14 live):
//         full + wgrad  dmc (N, 16), dg (R, 512) and the 22 weight
//                       gradients;
//         full          dmc and dg, no weight gradient computed;
//         no_ipe_bwd    dg, and dmc = the encoding gradient dx[:, 0:16]
//                       (no IPE backward), no weight gradient;
//         recompute     the forward only: dmc[:, 0] = mid[:, 0] + the
//                       density pre-activation, dmc[:, 1:16] = 0, dg = 0.
//   run_noipe (K19; tools/exp_bwd_noipe.py, _noipe_kernel / _noipe_half):
//       the same backward from the spilled x and trunk activations
//       ((N, 2176) bf16, K3's spill_x layout): dg and the 22 weight
//       gradients, no IPE work, no dmc, no layer-0 dgrad.
//
// What bounds them on this card: K18's full mode does about 2.2 MFLOP of
// bf16 products per row against ~400 B of device memory per row, so the
// tensor cores (K8's case, with the heads' 267 live columns and the
// separate w_emb product in place of the folded 144).  In the first design
// the weight gradients are not: as in K8 every 64-row tile reads and
// writes its block's fp32 slice of the 22 gradients (674,432 floats, 2.70
// MB) once, ~84 KB per row of traffic; the ablation's modes without the
// weight gradients measure what that costs.
//
// What the design does about it (K8's scheme, so that the modes differ
// only in the math):
//   - The modes without weight gradients recompute the forward on the
//     Hopper ring (trunk_sm90.cuh: 128-row tiles, two 64-row consumer
//     warpgroups on wgmma, the weights streamed by cp.async.bulk from the
//     blob of rsn_torch/kernels/unfolded_sm90.py's pack_unfolded_blob), and
//     it reaches the backward body through K3's spill layout:
//       recompute   one launch of unfolded_sm90.cuh's body in step with K1's
//                   polynomial IPE (K15's), its tail writing the (N, 16)
//                   f32 dmc row (unfolded_body<IN_STEP, false, true>);
//       full, no_ipe_bwd   kernel F (spill_kernel: the ring's trunk alone
//                   with K3's spill_x stores, the blob's first 32 chunks)
//                   writes x and hs0..hs7 to an (N, 2176) bf16 workspace,
//                   then the body reads them from there (SPILLED), as K19
//                   reads K3's spill; the fp32 dx tile stays in shared
//                   memory.
//     K3's ring spill fed to the body gives K18 full's first design bit for
//     bit (K19 == K18 full), so the three modes equal their first design.
//   - A body block owns a run of whole rays and walks them in 64-row tiles
//     (K4's partition; one block per SM).  The first design recomputes each
//     tile's IPE and trunk with K3's first code (ipe_tile, trunk) into its
//     own 64 x 2048 bf16 workspace slot; K19 and K18's port read their tile
//     of a spill; from there all run one body.
//   - The heads' forward (bottleneck and the 11 head columns), the mid seed
//     and the mid head are recomputed per tile as K14 computes them (the
//     tools' _half recomputes them; K8 reads them from the forward's
//     output instead).
//   - Backward: dW_out and dmid_pre (the mask of mid_pre > 0 as bits), the
//     per-ray dg summed in the block; dW_emb = bottleneck^T dmid_pre and
//     dbottleneck = dmid_pre w_emb^T; d_heads (384 columns: dbottleneck and
//     the 11 head cotangents) in one (64, 392) bf16 tile, dW_h = hs7^T
//     d_heads and dh7 = d_heads wh^T over its 17 live column tiles; then
//     K8's trunk backward (dpre = bf16(dh * relu mask), wgrad, dgrad) and
//     K4's IPE backward.  The roughness -> attenuation edge carries no
//     gradient; bias gradients sum the fp32 values, not the bf16 dpre.
//   - Every product of the body is nvcuda::wmma 16x16x16 bf16 -> fp32 (the
//     routines of field_common.cuh); no one-hot sample expansion, no
//     128-lane IPE matrices, no halves: the tools' two halves are one
//     64-row tile.
//   - The weight gradients of full + wgrad and K19 leave the tile loop, as
//     K8's did (field_train.cu): a call runs in chunks of up to 4 tiles of
//     every block's run, and per chunk the body (kernel A, STASH) stores
//     each weight-gradient product's two operand tiles to the tile's record
//     of a workspace in wgrad_sm90.cuh's unfolded layout (X, hs0..hs7,
//     dpre0..dpre7, d_heads, bottleneck, dmid_pre: 9,760 bytes per row),
//     and kernel B (wgrad_sm90.cuh, 22 output tiles) contracts them with
//     wgmma into P fp32 partials.  Four records a block (4 x 624,640 bytes)
//     fit in what the first design's slice took (2,697,728 bytes).  w_out,
//     b_out and every bias stay in the body, in the block's compact slice
//     (USlice<true>), summed over the chunks in the order of one run.  The
//     stash reads three points of the body: the bottleneck (before the
//     dbottleneck drain overwrites it) with dmid_pre and the head
//     cotangents, one 51,200-byte copy; hs7 with dbottleneck; each trunk
//     layer's input with its dpre.  Its two 32 KB staging buffers do not
//     fit beside the fp32 dx tile (173,056 + 65,536 > 232,448 bytes), so
//     with the stash K18's dx tile lives in a per-block global slot (32 KB
//     a block, in L2), as K17's does: the same fp32 adds, so dmc and dg
//     keep their bits; kernel A takes 205,824 bytes of shared memory.
//     (Full + wgrad's kernel A still recomputes the IPE and the trunk with
//     the first design's code.)
//   - The first design of all four K18 modes and of K19 stays under
//     RSN_K18_FIRST_DESIGN (built only by chip_smoke.py and the card
//     tests), the bit-for-bit yardstick of dmc and dg; the weight matrices
//     differ from it only by the order of their fp32 sums over the rows.
#include "field_common.cuh"
#include "train_sm90.cuh"
#include "unfolded_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace {

constexpr int DOUT_COLS = 128;     // d_out: the tools' V3_OUT, 0:14 live
constexpr int LDD = HEAD_COLS + 8;  // the d_heads / dpre tile, bf16
// per-row scalars: [0:4) atten, [4:7) dz3, [7:10) bf16(dz3), [10:21) the
// head cotangents (heads' columns 256..266), [21:24) mid, [24:40) the head
// products of columns 256..271 (no bias)
constexpr int RU = 40;
constexpr int RU_D = 10, RU_MID = 21, RU_HEADS = 24;
constexpr unsigned HEAD_TILES = 0x1FFFFu;  // bottleneck (16) + head tile
constexpr unsigned MID_TILES = 0xFFu;

// a block's fp32 slice of the 22 weight gradients, in pack_params_v3's
// order: w0..w7, b0..b7, wh, bh, w_emb, b_mid, w_out, b_out
constexpr int U_WH = OFF_B + LAYERS * WIDTH;
constexpr int U_BH = U_WH + WIDTH * HEAD_COLS;
constexpr int U_WEMB = U_BH + HEAD_COLS;
constexpr int U_BMID = U_WEMB + WIDTH * MID;
constexpr int U_WOUT = U_BMID + MID;
constexpr int U_BOUT = U_WOUT + MID * MID;
constexpr int U_PACK_FLOATS = U_BOUT + MID;
static_assert(U_PACK_FLOATS == 674432, "unfolded packed-gradient layout");
// a chunk of kernel A: the most tiles of every block whose records fit in
// what the first design's slice took
constexpr int TILES_PER_CHUNK = U_PACK_FLOATS * 4 / wgrad::UNF_REC_BYTES;
static_assert(TILES_PER_CHUNK == 4, "4 records of 624,640 bytes a block");

// Offsets in a block's fp32 gradient slice: the 22 operands
// (U_PACK_FLOATS), or with STASH (kernel A, whose weight matrices go to the
// workspace instead) only the biases and the mid head: b0..b7, bh, b_mid,
// w_out's 3 live columns (128 x 3), b_out (3, padded to 4).
template <bool STASH>
struct USlice {
  static constexpr int B = STASH ? 0 : OFF_B;
  static constexpr int BH = STASH ? LAYERS * WIDTH : U_BH;
  static constexpr int BMID = STASH ? BH + HEAD_COLS : U_BMID;
  static constexpr int WOUT = STASH ? BMID + MID : U_WOUT;
  static constexpr int LDWOUT = STASH ? 3 : MID;
  static constexpr int BOUT = STASH ? WOUT + MID * 3 : U_BOUT;
  static constexpr int FLOATS = STASH ? BOUT + 4 : U_PACK_FLOATS;
};
static_assert(USlice<true>::FLOATS == 2948, "K18 / K19's compact slice");

// shared memory: D (64 x 392 bf16; also the trunk recompute's first
// buffer), INP (64 x 264), X (64 x 136), HM (64 x 136: hmid, then
// bf16(dmid_pre)), the row scalars, the mid-seed mask bits, the stage, and
// for the modes with a dx the fp32 dx tile (173,056 bytes); kernel A
// (STASH): the stash's two staging buffers in its place (205,824 bytes)
constexpr int SM_D = 0;
constexpr int SM_INP = SM_D + TM * LDD * 2;
constexpr int SM_X = SM_INP + H_BYTES;
constexpr int SM_HM = SM_X + X_BYTES;
constexpr int SM_ROWF = SM_HM + X_BYTES;
constexpr int SM_MBITS = SM_ROWF + TM * RU * 4;
constexpr int SM_STAGE = SM_MBITS + TM * (MID / 32) * 4;
constexpr int SM_DXE = SM_STAGE + STAGE_BYTES;
constexpr int SMEM_NO_DX = SM_DXE;
constexpr int SMEM_DX = SM_DXE + TM * ENC * 4;
constexpr int SMEM_STASH = SMEM_NO_DX + wgrad::STASH_SMEM_BYTES;
static_assert(SMEM_DX == 173056 && SMEM_STASH == 205824 &&
                  SMEM_STASH <= 232448, "kernel A must fit one SM");
static_assert(SM_INP % 32 == 0 && SM_X % 32 == 0 && SM_HM % 32 == 0 &&
              SM_ROWF % 32 == 0 && SM_MBITS % 32 == 0 &&
              SM_STAGE % 32 == 0 && SM_DXE % 32 == 0, "alignment");
static_assert(TM * LDD * 2 >= H_BYTES, "D holds a trunk buffer");

enum Mode { FULL_WGRAD, FULL, NO_IPE_BWD, RECOMPUTE, NOIPE };

struct UArgs {
  const float* mc;      // (N, 16) f32, K18
  const float* g;       // (R, 512) f32
  const float* consts;  // IPE constants, K18
  const bf16* xacts;    // K19: (N, 2176) bf16 [acts | x]
  const bf16* dout;     // (N, 128) bf16, columns 0:14 live
  float* dmc;           // K18: (N, 16) f32
  float* dg;            // (R, 512) f32, zeroed by the caller
  float* dpk;           // (blocks, USlice<STASH>::FLOATS) f32, zeroed; the
                        // wgrad modes
  bf16* ws;             // K18: (blocks, 64, 2048) bf16 recompute slots
  long long rays;
  int S;
  int rays_per_block;
  float* dxe = nullptr;            // kernel A of K18: (blocks, 64, 128) f32
  unsigned char* stash = nullptr;  // kernel A: the chunk's wgrad workspace
  int tile0 = 0, tile1 = 0;        // kernel A: the chunk's tiles of each run
};

// MODE's body over a block's run.  STASH (kernel A of full + wgrad and
// K19): only the tiles [a.tile0, a.tile1) of the run, and instead of each
// weight-gradient product its two operand tiles go to the tile's record of
// the chunk's workspace (wgrad_sm90.cuh's unfolded layout), which kernel B
// contracts; the biases and the mid head's gradients go to the block's
// compact slice (USlice<true>), K18's fp32 dx tile to its global slot.
// SPILLED (K19, and K18 full / no_ipe_bwd after kernel F): x and the trunk
// activations from a.xacts (K3's spill_x layout), else recomputed into the
// block's slot of a.ws (the first design).
template <int MODE, bool STASH = false, bool SPILLED = MODE == NOIPE>
__device__ void unfolded_backward_body(const V3UParams& p, const UArgs& a) {
  constexpr bool WGRAD = MODE == FULL_WGRAD || MODE == NOIPE;
  constexpr bool DX = MODE == FULL_WGRAD || MODE == FULL ||
                      MODE == NO_IPE_BWD;
  static_assert(!STASH || WGRAD, "the stash holds weight-gradient operands");
  static_assert(SPILLED || MODE != NOIPE, "K19 has no mean_cov");
  static_assert(!SPILLED || MODE != RECOMPUTE, "recompute spills nothing");
  typedef USlice<STASH> G;
  constexpr int ld = SPILLED ? XACTS_COLS : ACTS_COLS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* D = reinterpret_cast<bf16*>(smem + SM_D);
  bf16* INP = reinterpret_cast<bf16*>(smem + SM_INP);
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* HM = reinterpret_cast<bf16*>(smem + SM_HM);
  float* rowf = reinterpret_cast<float*>(smem + SM_ROWF);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + SM_MBITS);
  float* stage = reinterpret_cast<float*>(smem + SM_STAGE);
  float* dxe = STASH && DX ? a.dxe + (long long)blockIdx.x * TM * ENC
                           : reinterpret_cast<float*>(smem + SM_DXE);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* st = stage + warp * 16 * LDS;
  const int S = a.S;
  NoTurn none;

  const long long ray0 = (long long)blockIdx.x * a.rays_per_block;
  const long long ray1 = min(a.rays, ray0 + a.rays_per_block);
  const long long rowA = ray0 * S, rowB = ray1 * S;
  float* grp =
      WGRAD ? a.dpk + (long long)blockIdx.x * G::FLOATS : nullptr;
  auto slice = [&](int off) { return WGRAD ? grp + off : nullptr; };
  const long long rowEnd =
      STASH ? min(rowB, rowA + (long long)a.tile1 * TM) : rowB;
  const long long chunk_tiles = a.tile1 - a.tile0;
  // kernel A: the staging buffers in the dx tile's place
  wgrad::Stash stash{smem + SMEM_NO_DX};

  for (long long row0 = STASH ? rowA + (long long)a.tile0 * TM : rowA;
       row0 < rowEnd; row0 += TM) {
    const int nv = (int)min((long long)TM, rowB - row0);
    unsigned char* rec =
        STASH ? a.stash + (blockIdx.x * chunk_tiles + (row0 - rowA) / TM -
                           a.tile0) * wgrad::UNF_REC_BYTES
              : nullptr;

    // ---- x and the trunk activations: a spill, or the first design's
    // recompute (K3's first code) into the block's slot ----
    const bf16* acts;
    if constexpr (SPILLED) {
      acts = a.xacts + row0 * ld;
      load_rows(X, LDX, acts + ACTS_COLS, ld, ENC, nv);
    } else {
      bf16* slot = a.ws + (long long)blockIdx.x * TM * ACTS_COLS;
      acts = slot;
      ipe_tile(a.mc, a.consts, row0, rowB, X);
      block_sync();
      trunk(p.trunk, X, D, INP, stage,
            SpillHook{slot, ACTS_COLS, nv, nullptr});
    }
    load_rows(INP, LDH, acts + (LAYERS - 1) * WIDTH, ld, WIDTH, nv);
    for (int e = tid; e < TM * (MID / 32); e += THREADS) mbits[e] = 0u;
    if (tid < TM)
      for (int i = 0; i < RU_HEADS; ++i) rowf[tid * RU + i] = 0.f;
    block_sync();

    // ---- heads: D[:, 0:256] = bf16(hs7 @ wh[:, 0:256] + bh), the head
    // products of columns 256..271 into the row scalars ----
    warp_product<4, 2>(INP, LDH, WIDTH, nullptr, 0, 0, p.wh, HEAD_COLS,
                       warp * 32, st, none, [&](int r, int c, float v) {
                         D[r * LDD + c] =
                             __float2bfloat16_rn(__fadd_rn(v, p.bh[c]));
                       });
    if (warp < 4) {
      const int r0 = warp * 16;
      warp_product<1, 1>(INP + r0 * LDH, LDH, WIDTH, nullptr, 0, 0, p.wh,
                         HEAD_COLS, WIDTH, st, none,
                         [&](int r, int c, float v) {
                           rowf[(r0 + r) * RU + RU_HEADS + c - WIDTH] = v;
                         });
    }
    block_sync();
    if (tid < nv) {  // the band attenuations exp(-softplus(rough) k_b)
      float* rf = rowf + tid * RU;
      const float sp =
          softplusf(__fadd_rn(rf[RU_HEADS + 7], p.bh[OUT_ROUGH]));
#pragma unroll
      for (int b = 0; b < 4; ++b) rf[b] = expf(__fmul_rn(-sp, band_k(b)));
    }
    block_sync();

    // ---- mid seed: hmid = bf16(relu(bottleneck @ w_emb + b_mid +
    // sum_b atten_b g_b[ray])) into HM, mid_pre > 0 as bits ----
    {
      FragC acc[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i][0], 0.f);
      for (int kt = 0; kt < WIDTH / 16; ++kt) {
        FragB b;
        wmma::load_matrix_sync(b, p.w_emb + kt * 16 * MID + warp * 16, MID);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragA fa;
          wmma::load_matrix_sync(fa, D + i * 16 * LDD + kt * 16, LDD);
          wmma::mma_sync(acc[i][0], fa, b, acc[i][0]);
        }
      }
      drain<1>(acc, 0, stage, [&](int r, int c, float v) {
        float m = __fadd_rn(v, p.b_mid[c]);
        if (r < nv) {
          const float* gr = a.g + ((row0 + r) / S) * G_COLS + c;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            m = __fadd_rn(m, __fmul_rn(rowf[r * RU + b], gr[b * MID]));
        }
        HM[r * LDX + c] = __float2bfloat16_rn(relu_keep_nan(m));
        if (m > 0.f) atomicOr(&mbits[r * (MID / 32) + (c >> 5)],
                              1u << (c & 31));
        return 0.f;
      }, NoColSum());
    }
    block_sync();

    // ---- mid = sigmoid(hmid @ w_out[:, 0:3] + b_out): one thread per
    // (row, col) ----
    if (tid < TM * 3) {
      const int r = tid / 3, c = tid % 3;
      float s = 0.f;
      for (int k = 0; k < MID; ++k)
        s = __fmaf_rn(__bfloat162float(HM[r * LDX + k]),
                      __bfloat162float(p.w_out[k * MID + c]), s);
      rowf[r * RU + RU_MID + c] = sigmoidf(__fadd_rn(s, p.b_out[c]));
    }
    block_sync();

    if (MODE == RECOMPUTE) {  // dmc[:, 0] = mid[:, 0] + density pre-act
      if (tid < nv) {
        const float* rf = rowf + tid * RU;
        float* o = a.dmc + (row0 + tid) * IN_COLS;
        o[0] = __fadd_rn(rf[RU_MID],
                         __fadd_rn(rf[RU_HEADS], p.bh[OUT_DENSITY]));
        for (int c = 1; c < IN_COLS; ++c) o[c] = 0.f;
      }
      block_sync();
      continue;
    }

    // ---- per-row cotangents: dz3 (f32 and bf16), the head columns' ----
    if (tid < nv) {
      float* rf = rowf + tid * RU;
      const float* hp = rf + RU_HEADS;
      float diff[3], tint[3];
      for (int i = 0; i < 3; ++i) {
        diff[i] = sigmoidf(__fadd_rn(hp[1 + i], p.bh[OUT_DIFF + i]));
        tint[i] = sigmoidf(__fadd_rn(hp[4 + i], p.bh[OUT_TINT + i]));
      }
      tail_cotangents(a.dout + (row0 + tid) * DOUT_COLS, diff, tint,
                      rf + RU_MID, rf);
    }
    block_sync();

    // the head cotangents into D[:, 256:272) (bf16)
    auto head_cotangents = [&] {
      for (int e = tid; e < TM * 16; e += THREADS) {
        const int r = e / 16, c = e % 16;
        D[r * LDD + WIDTH + c] =
            __float2bfloat16_rn(c < 11 ? rowf[r * RU + RU_D + c] : 0.f);
      }
    };
    // kernel A: the head cotangents now, for the first stash below; the
    // bottleneck's rows past nv zero (in the record, rows past the run are
    // zero in every operand; dmid_pre's are)
    if constexpr (STASH) {
      head_cotangents();
      for (int e = tid; e < (TM - nv) * WIDTH; e += THREADS)
        D[(nv + e / WIDTH) * LDD + e % WIDTH] = __float2bfloat16_rn(0.f);
    }

    // ---- mid head: dW_out, db_out; then dmid_pre as bf16 into HM (its
    // hmid read), b_mid, the per-ray dg ----
    if (WGRAD) {
      mid_head_wgrad(HM, LDX, rowf, RU, TM, grp + G::WOUT, grp + G::BOUT,
                     G::LDWOUT);
      block_sync();
    }
    dmid_pre_rows(p.w_out, mbits, rowf, RU, TM, nv, row0, S, a.dg, HM, LDX,
                  slice(G::BMID));
    if constexpr (STASH) stash.wait_free();
    block_sync();

    // ---- dW_emb += bottleneck^T dmid_pre (kernel A: the head
    // cotangents, the bottleneck and dmid_pre to the record's last 400
    // features, copied after the barrier below); dbottleneck = dmid_pre
    // w_emb^T into D[:, 0:256] (bf16), its fp32 column sums into
    // bh[0:256] ----
    if constexpr (STASH) {
      wgrad::stage_rows(stash.buf, D + WIDTH, LDD, wgrad::COT_N);
      wgrad::stage_rows(stash.buf, D, LDD, WIDTH, wgrad::COT_N);
      wgrad::stage_rows(stash.buf, HM, LDX, MID, wgrad::COT_N + WIDTH);
      stash.gathered();
    } else if (WGRAD) {
      wgrad_acc<TM>(D, LDD, WIDTH, HM, LDX, MID_TILES, grp + U_WEMB, MID);
    }
    {
      FragC acc[4][2];
      dgrad_mma<2>(HM, LDX, p.w_emb, MID, 0, MID / 16, MID_TILES, acc);
      block_sync();  // the wgrad's reads of the bottleneck are done
      if constexpr (STASH)
        stash.copy_out(rec + wgrad::UNF_COT_OFF,
                       (wgrad::COT_N + WIDTH + MID) * wgrad::FEAT_BYTES);
      drain<2>(acc, 0, stage, [&](int r, int c, float v) {
        D[r * LDD + c] = __float2bfloat16_rn(v);
        return v;
      }, BiasSum{slice(G::BH)});
    }
    // the head cotangents (kernel A: already there), their sums into
    // bh[256:267]
    if constexpr (!STASH) head_cotangents();
    if (WGRAD && tid < 11) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s = __fadd_rn(s, rowf[r * RU + RU_D + tid]);
      grp[G::BH + WIDTH + tid] += s;
    }
    if constexpr (STASH) stash.wait_free();
    block_sync();

    // ---- heads: dW_h += hs7^T d_heads (kernel A: hs7 and dbottleneck to
    // the record, copied after the barrier below); dh7 = d_heads wh^T ----
    if constexpr (STASH) {
      wgrad::stage_rows(stash.buf, INP, LDH, WIDTH);
      wgrad::stage_rows(stash.second(), D, LDD, WIDTH);
      stash.gathered();
    } else if (WGRAD) {
      wgrad_acc<TM>(INP, LDH, WIDTH, D, LDD, HEAD_TILES, grp + U_WH,
                    HEAD_COLS);
    }
    {
      FragC acc[4][2];
      dgrad_mma<2>(D, LDD, p.wh, HEAD_COLS, 0, HEAD_COLS / 16, HEAD_TILES,
                   acc);
      block_sync();
      if constexpr (STASH)
        stash.copy_out(rec + wgrad::ACT_OFF + (LAYERS - 1) * wgrad::ACT_BYTES,
                       wgrad::ACT_BYTES, rec + wgrad::UNF_DHEADS_OFF,
                       wgrad::ACT_BYTES);
      drain<2>(acc, 0, stage, [&](int r, int c, float v) {
        const float m =
            (r < nv && __bfloat162float(INP[r * LDH + c]) > 0.f) ? v : 0.f;
        D[r * LDD + c] = __float2bfloat16_rn(m);
        return m;
      }, BiasSum{slice(G::B + (LAYERS - 1) * WIDTH)});
    }
    block_sync();

    // ---- trunk: D holds dpre_i; INP gets layer i's input hs_{i-1} ----
    for (int i = LAYERS - 1; i >= 0; --i) {
      if (i > 0) {
        load_rows(INP, LDH, acts + (i - 1) * WIDTH, ld, WIDTH, nv);
        if constexpr (STASH) stash.wait_free();
        block_sync();
      }
      // kernel A: X (layer 0) or hs_{i-1}, and dpre_i, to the record:
      // copied after the next barrier
      const int off0 =
          i == 0 ? wgrad::X_OFF : wgrad::ACT_OFF + (i - 1) * wgrad::ACT_BYTES;
      const int bytes0 = (i == 0 ? ENC : WIDTH) * wgrad::FEAT_BYTES;
      const int off1 = wgrad::DPRE_OFF + i * wgrad::ACT_BYTES;
      if constexpr (STASH) {
        if (i == 0)
          wgrad::stage_rows(stash.buf, X, LDX, ENC);
        else
          wgrad::stage_rows(stash.buf, INP, LDH, WIDTH);
        wgrad::stage_rows(stash.second(), D, LDD, WIDTH);
        stash.gathered();
      } else if (WGRAD) {
        float* dW = grp + off_w(i);
        if (i == 0 || i == SKIP_AT)
          wgrad_acc<TM>(X, LDX, ENC, D, LDD, ALL_TILES, dW, WIDTH);
        if (i > 0)
          wgrad_acc<TM>(INP, LDH, WIDTH, D, LDD, ALL_TILES,
                        i == SKIP_AT ? dW + ENC * WIDTH : dW, WIDTH);
      }
      const bf16* W = p.trunk.w[i];
      if (DX && (i == 0 || i == SKIP_AT)) {  // dx: layer 0 + the skip share
        FragC acc[4][1];
        dgrad_mma<1>(D, LDD, W, WIDTH, 0, WIDTH / 16, ALL_TILES, acc);
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
        dgrad_mma<2>(D, LDD, W, WIDTH, c0, WIDTH / 16, ALL_TILES, acc);
        block_sync();  // wgrad and dgrad reads of D are done
        if constexpr (STASH)
          stash.copy_out(rec + off0, bytes0, rec + off1, wgrad::ACT_BYTES);
        drain<2>(acc, c0, stage, [&](int r, int c, float v) {
          const int h = c - c0;
          const float m =
              (r < nv && __bfloat162float(INP[r * LDH + h]) > 0.f) ? v : 0.f;
          D[r * LDD + h] = __float2bfloat16_rn(m);
          return m;
        }, BiasSum{slice(G::B + (i - 1) * WIDTH - c0)});
      }
      if constexpr (STASH)
        if (i == 1) stash.wait_free();  // layer 0 gathers after this barrier
      block_sync();
      if constexpr (STASH)
        if (i == 0)
          stash.copy_out(rec + off0, bytes0, rec + off1, wgrad::ACT_BYTES);
    }

    // ---- dmc: the IPE backward (full), or dx[:, 0:16] (no_ipe_bwd) ----
    if (MODE == FULL_WGRAD || MODE == FULL) {
      ipe_backward_rows(a.mc, a.consts, dxe, a.dmc, row0, nv, TM);
      block_sync();
    } else if (MODE == NO_IPE_BWD) {
      for (int e = tid; e < TM * IN_COLS; e += THREADS) {
        const int r = e / IN_COLS, c = e % IN_COLS;
        if (r < nv) a.dmc[(row0 + r) * IN_COLS + c] = dxe[r * ENC + c];
      }
      block_sync();
    }
  }
  if constexpr (STASH) {  // the chunk's records past the end of the run
    const long long tiles = (rowB - rowA + TM - 1) / TM;
    for (long long t = max(tiles, (long long)a.tile0); t < a.tile1; ++t)
      wgrad::zero_record<wgrad::UNF_REC_BYTES>(
          a.stash + (blockIdx.x * chunk_tiles + t - a.tile0) *
                        wgrad::UNF_REC_BYTES);
    stash.drain();
  }
}

template <int MODE, bool STASH, bool SPILLED>
__global__ void __launch_bounds__(THREADS, 1)
    unfolded_backward_kernel(V3UParams p, UArgs a) {
  unfolded_backward_body<MODE, STASH, SPILLED>(p, a);
}

template <int MODE, bool STASH = false, bool SPILLED = MODE == NOIPE>
int launch_unfolded(const void* const* ptrs, const UArgs& a, void* stream) {
  constexpr int smem = STASH ? SMEM_STASH
                             : (MODE == FULL_WGRAD || MODE == FULL ||
                                MODE == NO_IPE_BWD) ? SMEM_DX : SMEM_NO_DX;
  V3UParams p;
  fill_v3u(&p, ptrs);
  auto kernel = unfolded_backward_kernel<MODE, STASH, SPILLED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)((a.rays + a.rays_per_block - 1) / a.rays_per_block);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, a);
  return (int)cudaGetLastError();
}

#ifndef RSN_K18_FIRST_DESIGN

// ---- the port's recompute on the ring (trunk_sm90.cuh) -------------------

// K18 recompute: unfolded_sm90.cuh's body in step, K1's polynomial IPE, the
// tail writing the (N, 16) f32 dmc rows.
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    recompute_kernel(const __grid_constant__ sm90::UnfoldedParams p) {
  sm90::unfolded_body<sm90::IN_STEP, false, true>(p);
}

// Kernel F's tile: the consumer's X to the spill's columns 2048:2176, then
// the trunk with each layer's output to its 256 columns (TrainTile under
// SPILL_X without the tail: K3's stores, K3's bits).
struct SpillTile {
  const sm90::RenderParams& p;
  bf16* xacts;  // (n, XACTS_COLS)
  __device__ __forceinline__ void operator()(sm90::RingPos& rp,
                                             unsigned char* X,
                                             unsigned char* H, float*,
                                             const float*, const float4*,
                                             long long row0, int wg, int t) {
    const int nv = (int)min((long long)sm90::WG_ROWS, p.n - row0);
    bf16* acts = xacts + row0 * XACTS_COLS;
    sm90::store_tile_rows<2>(acts + ACTS_COLS, XACTS_COLS, X, nv, t);
    sm90::TrainHook<false, true> hook{
        {}, {0u, 0u, 0u, 0u}, acts, XACTS_COLS, nv, H, t, -1};
    sm90::trunk_wg(p, rp, X, H, wg, t, hook);
  }
};

// Kernel F: K1's persistent block on the ring without heads, the blob's
// first TRUNK_CHUNKS chunks (the trunk's) for every tile.
constexpr int SPILL_SMEM_BYTES = sm90::smem_bytes<false>();

__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    spill_kernel(const __grid_constant__ sm90::RenderParams p, bf16* xacts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SpillTile tile{p, xacts};
  sm90::persistent_body<false>(p, sm90::align_1024(smem_raw),
                               sm90::off_bars<false>(), sm90::TRUNK_CHUNKS,
                               tile);
}

// The persistent grid over n rows' 128-row tiles: at most one block per SM.
int ring_grid(long long n, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (n + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS;
  *grid = (unsigned)(tiles < sms ? tiles : sms);
  return (int)err;
}

#endif  // RSN_K18_FIRST_DESIGN

}  // namespace

extern "C" {

// K18's first design, one launch (the RSN_K18_FIRST_DESIGN build; the
// port's returns cudaErrorNotSupported: full + wgrad runs in chunks,
// rsn_bwd_ablate_stash then rsn_wgrad_unfolded, the other modes on the
// ring, rsn_bwd_ablate_recompute or rsn_bwd_ablate_spill then
// rsn_bwd_ablate_body).  ptrs: pack_params_v3's 22 operands (device
// pointers); d_out (N, 128) bf16; dmc (N, 16) f32 (written); dg (R, 512)
// f32, zeroed; ws ceil(rays / rays_per_block) 64 x 2048 bf16 slots
// (uninitialised).  mode: 0 full + wgrad (dpk as many zeroed slices of
// 674432 floats), 1 full, 2 no_ipe_bwd, 3 recompute.  Returns a
// cudaError_t code.
int rsn_bwd_ablate(const void* mean_cov, const void* g_bands,
                   const void* ipe_consts, const void* d_out,
                   const void* const* ptrs, void* dmc, void* dg, void* dpk,
                   void* ws, long long rays, int samples_per_ray,
                   int rays_per_block, int mode, void* stream) {
  const UArgs a{static_cast<const float*>(mean_cov),
                static_cast<const float*>(g_bands),
                static_cast<const float*>(ipe_consts), nullptr,
                static_cast<const bf16*>(d_out), static_cast<float*>(dmc),
                static_cast<float*>(dg), static_cast<float*>(dpk),
                static_cast<bf16*>(ws), rays, samples_per_ray,
                rays_per_block};
  switch (mode) {
#ifdef RSN_K18_FIRST_DESIGN
    case FULL_WGRAD: return launch_unfolded<FULL_WGRAD>(ptrs, a, stream);
    case FULL: return launch_unfolded<FULL>(ptrs, a, stream);
    case NO_IPE_BWD: return launch_unfolded<NO_IPE_BWD>(ptrs, a, stream);
    case RECOMPUTE: return launch_unfolded<RECOMPUTE>(ptrs, a, stream);
#else
    case FULL_WGRAD:
    case FULL:
    case NO_IPE_BWD:
    case RECOMPUTE: return (int)cudaErrorNotSupported;
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

// K18 recompute on the ring, one launch: blob unfolded_sm90.
// pack_unfolded_blob of the operands; ptrs as for rsn_bwd_ablate (the
// biases, w_out from there); dmc (N, 16) f32, written whole.  (The
// RSN_K18_FIRST_DESIGN build returns cudaErrorNotSupported here and in the
// two entries below.)
int rsn_bwd_ablate_recompute(const void* mean_cov, const void* g_bands,
                             const void* ipe_consts, const void* blob,
                             const void* const* ptrs, void* dmc, long long n,
                             int samples_per_ray, void* stream) {
#ifdef RSN_K18_FIRST_DESIGN
  (void)mean_cov, (void)g_bands, (void)ipe_consts, (void)blob, (void)ptrs;
  (void)dmc, (void)n, (void)samples_per_ray, (void)stream;
  return (int)cudaErrorNotSupported;
#else
  sm90::UnfoldedParams p{};
  p.r.mc = static_cast<const float*>(mean_cov);
  p.r.consts = static_cast<const float*>(ipe_consts);
  p.r.blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p.r.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p.r.n = n;
  p.r.g = static_cast<const float*>(g_bands);
  p.r.S = samples_per_ray;
  p.bh = static_cast<const float*>(ptrs[17]);
  p.b_mid = static_cast<const float*>(ptrs[19]);
  p.r.w_out = static_cast<const bf16*>(ptrs[20]);
  p.r.b_out = static_cast<const float*>(ptrs[21]);
  p.dmc = static_cast<float*>(dmc);
  cudaError_t err = cudaFuncSetAttribute(
      recompute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sm90::U_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  const int rc = ring_grid(n, &grid);
  if (rc != 0) return rc;
  recompute_kernel<<<grid, sm90::BLOCK_THREADS, sm90::U_SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
#endif
}

// K18 full / no_ipe_bwd, kernel F: x and the 8 trunk activations of the N
// rows, recomputed on the ring from mean_cov, to xacts (N, 2176) bf16
// [acts | x] (K3's spill_x layout, written whole).  blob and ptrs as for
// rsn_bwd_ablate_recompute (the blob's first 32 chunks, the trunk biases).
int rsn_bwd_ablate_spill(const void* mean_cov, const void* ipe_consts,
                         const void* blob, const void* const* ptrs,
                         void* xacts, long long n, void* stream) {
#ifdef RSN_K18_FIRST_DESIGN
  (void)mean_cov, (void)ipe_consts, (void)blob, (void)ptrs, (void)xacts;
  (void)n, (void)stream;
  return (int)cudaErrorNotSupported;
#else
  sm90::RenderParams p{};
  p.mc = static_cast<const float*>(mean_cov);
  p.consts = static_cast<const float*>(ipe_consts);
  p.blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p.n = n;
  cudaError_t err = cudaFuncSetAttribute(
      spill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SPILL_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  const int rc = ring_grid(n, &grid);
  if (rc != 0) return rc;
  spill_kernel<<<grid, sm90::BLOCK_THREADS, SPILL_SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<bf16*>(xacts));
  return (int)cudaGetLastError();
#endif
}

// K18 full (mode 1) or no_ipe_bwd (mode 2), the body on kernel F's spill:
// xacts as rsn_bwd_ablate_spill writes it; the other arguments as for
// rsn_bwd_ablate (no ws).
int rsn_bwd_ablate_body(const void* mean_cov, const void* g_bands,
                        const void* ipe_consts, const void* xacts,
                        const void* d_out, const void* const* ptrs, void* dmc,
                        void* dg, long long rays, int samples_per_ray,
                        int rays_per_block, int mode, void* stream) {
#ifdef RSN_K18_FIRST_DESIGN
  (void)mean_cov, (void)g_bands, (void)ipe_consts, (void)xacts, (void)d_out;
  (void)ptrs, (void)dmc, (void)dg, (void)rays, (void)samples_per_ray;
  (void)rays_per_block, (void)mode, (void)stream;
  return (int)cudaErrorNotSupported;
#else
  const UArgs a{static_cast<const float*>(mean_cov),
                static_cast<const float*>(g_bands),
                static_cast<const float*>(ipe_consts),
                static_cast<const bf16*>(xacts),
                static_cast<const bf16*>(d_out), static_cast<float*>(dmc),
                static_cast<float*>(dg), nullptr, nullptr, rays,
                samples_per_ray, rays_per_block};
  switch (mode) {
    case FULL: return launch_unfolded<FULL, false, true>(ptrs, a, stream);
    case NO_IPE_BWD:
      return launch_unfolded<NO_IPE_BWD, false, true>(ptrs, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
#endif
}

// K19's first design, one launch (the RSN_K18_FIRST_DESIGN build; the
// port's returns cudaErrorNotSupported: K19 runs in chunks,
// rsn_bwd_noipe_stash then rsn_wgrad_unfolded).  xacts (N, 2176) bf16
// [acts | x] (K3's spill_x layout); d_out, dg and dpk as for K18's mode 0.
int rsn_bwd_noipe(const void* g_bands, const void* xacts, const void* d_out,
                  const void* const* ptrs, void* dg, void* dpk,
                  long long rays, int samples_per_ray, int rays_per_block,
                  void* stream) {
#ifdef RSN_K18_FIRST_DESIGN
  const UArgs a{nullptr, static_cast<const float*>(g_bands), nullptr,
                static_cast<const bf16*>(xacts),
                static_cast<const bf16*>(d_out), nullptr,
                static_cast<float*>(dg), static_cast<float*>(dpk), nullptr,
                rays, samples_per_ray, rays_per_block};
  return launch_unfolded<NOIPE>(ptrs, a, stream);
#else
  (void)g_bands, (void)xacts, (void)d_out, (void)ptrs, (void)dg, (void)dpk;
  (void)rays, (void)samples_per_ray, (void)rays_per_block, (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

// K18 full + wgrad's kernel A on one chunk: tiles [tile0, tile1) of every
// block's run (rays_per_block whole rays per block).  mean_cov, d_out,
// ptrs, dmc, dg and ws as for rsn_bwd_ablate; small: ceil(rays /
// rays_per_block) zeroed compact slices of 2948 floats (USlice<true>),
// summed into over a call's chunks; dxe: as many (64, 128) f32 dx tiles
// (uninitialised); stash: the chunk's blocks x (tile1 - tile0) records of
// wgrad::UNF_REC_BYTES (written whole).
int rsn_bwd_ablate_stash(const void* mean_cov, const void* g_bands,
                         const void* ipe_consts, const void* d_out,
                         const void* const* ptrs, void* dmc, void* dg,
                         void* small, void* ws, void* dxe, void* stash,
                         long long rays, int samples_per_ray,
                         int rays_per_block, int tile0, int tile1,
                         void* stream) {
  const UArgs a{static_cast<const float*>(mean_cov),
                static_cast<const float*>(g_bands),
                static_cast<const float*>(ipe_consts), nullptr,
                static_cast<const bf16*>(d_out), static_cast<float*>(dmc),
                static_cast<float*>(dg), static_cast<float*>(small),
                static_cast<bf16*>(ws), rays, samples_per_ray,
                rays_per_block, static_cast<float*>(dxe),
                static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_unfolded<FULL_WGRAD, true>(ptrs, a, stream);
}

// K19's kernel A on one chunk: xacts as for rsn_bwd_noipe; dg, small and
// stash as for rsn_bwd_ablate_stash.
int rsn_bwd_noipe_stash(const void* g_bands, const void* xacts,
                        const void* d_out, const void* const* ptrs,
                        void* dg, void* small, void* stash, long long rays,
                        int samples_per_ray, int rays_per_block, int tile0,
                        int tile1, void* stream) {
  const UArgs a{nullptr, static_cast<const float*>(g_bands), nullptr,
                static_cast<const bf16*>(xacts),
                static_cast<const bf16*>(d_out), nullptr,
                static_cast<float*>(dg), static_cast<float*>(small), nullptr,
                rays, samples_per_ray, rays_per_block, nullptr,
                static_cast<unsigned char*>(stash), tile0, tile1};
  return launch_unfolded<NOIPE, true>(ptrs, a, stream);
}

// Kernel B of K18 full + wgrad and K19 on one chunk: records (blocks x
// tiles of the chunk) at stash into `slices` fp32 partials of
// wgrad::UNF_PARTIAL_FLOATS (w0..w7, wh's dbottleneck columns, its head
// columns, w_emb), which it overwrites (accumulate 0: the call's first
// chunk) or adds to.
int rsn_wgrad_unfolded(const void* stash, void* partial, long long records,
                       int slices, int accumulate, void* stream) {
  return wgrad::launch_wgrad<wgrad::Unfolded>(
      stash, partial, records, slices, accumulate,
      static_cast<cudaStream_t>(stream));
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
