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
// separate w_emb product in place of the folded 144).  In this first
// design the weight gradients are not: as in K8 every 64-row tile reads
// and writes its block's fp32 slice of the 22 gradients (674,432 floats,
// 2.70 MB) once, ~84 KB per row of traffic; the ablation's modes without
// the weight gradients measure what that costs.
//
// What the design does about it (a first, simple design, K8's scheme, so
// that the modes differ only in the math):
//   - A block owns a run of whole rays and walks them in 64-row tiles (K4's
//     partition; one block per SM).  K18 recomputes each tile's IPE and
//     trunk with K3's code (ipe_tile, trunk) into its own 64 x 2048 bf16
//     workspace slot, K19 reads its tile of the spill; from there both run
//     one body, so K19 equals K18's full mode on K3's spill bit for bit.
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
//   - Every product is nvcuda::wmma 16x16x16 bf16 -> fp32 (the routines of
//     field_common.cuh); no one-hot sample expansion, no 128-lane IPE
//     matrices, no halves: the tools' two halves are one 64-row tile.
#include "field_common.cuh"

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

// shared memory: D (64 x 392 bf16; also the trunk recompute's first
// buffer), INP (64 x 264), X (64 x 136), HM (64 x 136: hmid, then
// bf16(dmid_pre)), the row scalars, the mid-seed mask bits, the stage, and
// for the modes with a dx the fp32 dx tile
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
  float* dpk;           // (blocks, 674432) f32, zeroed; the wgrad modes
  bf16* ws;             // K18: (blocks, 64, 2048) bf16 recompute slots
  long long rays;
  int S;
  int rays_per_block;
};

template <int MODE>
__device__ void unfolded_backward_body(const V3UParams& p, const UArgs& a) {
  constexpr bool WGRAD = MODE == FULL_WGRAD || MODE == NOIPE;
  constexpr bool SPILLED = MODE == NOIPE;
  constexpr bool DX = MODE == FULL_WGRAD || MODE == FULL ||
                      MODE == NO_IPE_BWD;
  constexpr int ld = SPILLED ? XACTS_COLS : ACTS_COLS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* D = reinterpret_cast<bf16*>(smem + SM_D);
  bf16* INP = reinterpret_cast<bf16*>(smem + SM_INP);
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* HM = reinterpret_cast<bf16*>(smem + SM_HM);
  float* rowf = reinterpret_cast<float*>(smem + SM_ROWF);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + SM_MBITS);
  float* stage = reinterpret_cast<float*>(smem + SM_STAGE);
  float* dxe = reinterpret_cast<float*>(smem + SM_DXE);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* st = stage + warp * 16 * LDS;
  const int S = a.S;
  NoTurn none;

  const long long ray0 = (long long)blockIdx.x * a.rays_per_block;
  const long long ray1 = min(a.rays, ray0 + a.rays_per_block);
  const long long rowA = ray0 * S, rowB = ray1 * S;
  float* grp =
      WGRAD ? a.dpk + (long long)blockIdx.x * U_PACK_FLOATS : nullptr;
  auto slice = [&](int off) { return WGRAD ? grp + off : nullptr; };

  for (long long row0 = rowA; row0 < rowB; row0 += TM) {
    const int nv = (int)min((long long)TM, rowB - row0);

    // ---- x and the trunk activations: K19's spill, or K18's recompute
    // (K3's code) into the block's slot ----
    const bf16* acts;
    if (SPILLED) {
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

    // ---- mid head: dW_out, db_out; then dmid_pre as bf16 into HM (its
    // hmid read), b_mid, the per-ray dg ----
    if (WGRAD) {
      mid_head_wgrad(HM, LDX, rowf, RU, TM, grp + U_WOUT, grp + U_BOUT);
      block_sync();
    }
    dmid_pre_rows(p.w_out, mbits, rowf, RU, TM, nv, row0, S, a.dg, HM, LDX,
                  slice(U_BMID));
    block_sync();

    // ---- dW_emb += bottleneck^T dmid_pre; dbottleneck = dmid_pre w_emb^T
    // into D[:, 0:256] (bf16), its fp32 column sums into bh[0:256] ----
    if (WGRAD)
      wgrad_acc<TM>(D, LDD, WIDTH, HM, LDX, MID_TILES, grp + U_WEMB, MID);
    {
      FragC acc[4][2];
      dgrad_mma<2>(HM, LDX, p.w_emb, MID, 0, MID / 16, MID_TILES, acc);
      block_sync();  // the wgrad's reads of the bottleneck are done
      drain<2>(acc, 0, stage, [&](int r, int c, float v) {
        D[r * LDD + c] = __float2bfloat16_rn(v);
        return v;
      }, BiasSum{slice(U_BH)});
    }
    // the head cotangents into D[:, 256:272), their sums into bh[256:267]
    for (int e = tid; e < TM * 16; e += THREADS) {
      const int r = e / 16, c = e % 16;
      D[r * LDD + WIDTH + c] =
          __float2bfloat16_rn(c < 11 ? rowf[r * RU + RU_D + c] : 0.f);
    }
    if (WGRAD && tid < 11) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s = __fadd_rn(s, rowf[r * RU + RU_D + tid]);
      grp[U_BH + WIDTH + tid] += s;
    }
    block_sync();

    // ---- heads: dW_h += hs7^T d_heads; dh7 = d_heads wh^T ----
    if (WGRAD)
      wgrad_acc<TM>(INP, LDH, WIDTH, D, LDD, HEAD_TILES, grp + U_WH,
                    HEAD_COLS);
    {
      FragC acc[4][2];
      dgrad_mma<2>(D, LDD, p.wh, HEAD_COLS, 0, HEAD_COLS / 16, HEAD_TILES,
                   acc);
      block_sync();
      drain<2>(acc, 0, stage, [&](int r, int c, float v) {
        const float m =
            (r < nv && __bfloat162float(INP[r * LDH + c]) > 0.f) ? v : 0.f;
        D[r * LDD + c] = __float2bfloat16_rn(m);
        return m;
      }, BiasSum{slice(OFF_B + (LAYERS - 1) * WIDTH)});
    }
    block_sync();

    // ---- trunk: D holds dpre_i; INP gets layer i's input hs_{i-1} ----
    for (int i = LAYERS - 1; i >= 0; --i) {
      if (i > 0) {
        load_rows(INP, LDH, acts + (i - 1) * WIDTH, ld, WIDTH, nv);
        block_sync();
      }
      if (WGRAD) {
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
        drain<2>(acc, c0, stage, [&](int r, int c, float v) {
          const int h = c - c0;
          const float m =
              (r < nv && __bfloat162float(INP[r * LDH + h]) > 0.f) ? v : 0.f;
          D[r * LDD + h] = __float2bfloat16_rn(m);
          return m;
        }, BiasSum{slice(OFF_B + (i - 1) * WIDTH - c0)});
      }
      block_sync();
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
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    unfolded_backward_kernel(V3UParams p, UArgs a) {
  unfolded_backward_body<MODE>(p, a);
}

template <int MODE>
int launch_unfolded(const void* const* ptrs, const UArgs& a, void* stream) {
  constexpr int smem = (MODE == FULL_WGRAD || MODE == FULL ||
                        MODE == NO_IPE_BWD) ? SMEM_DX : SMEM_NO_DX;
  V3UParams p;
  fill_v3u(&p, ptrs);
  auto kernel = unfolded_backward_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)((a.rays + a.rays_per_block - 1) / a.rays_per_block);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K18.  ptrs: pack_params_v3's 22 operands (device pointers); d_out (N,
// 128) bf16; dmc (N, 16) f32 (written); dg (R, 512) f32 and, with
// mode 0, dpk (ceil(rays / rays_per_block), 674432) f32, both zeroed; ws
// as many 64 x 2048 bf16 slots (uninitialised).  mode: 0 full + wgrad,
// 1 full, 2 no_ipe_bwd, 3 recompute.  Returns a cudaError_t code.
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
    case FULL_WGRAD: return launch_unfolded<FULL_WGRAD>(ptrs, a, stream);
    case FULL: return launch_unfolded<FULL>(ptrs, a, stream);
    case NO_IPE_BWD: return launch_unfolded<NO_IPE_BWD>(ptrs, a, stream);
    case RECOMPUTE: return launch_unfolded<RECOMPUTE>(ptrs, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K19.  xacts (N, 2176) bf16 [acts | x] (K3's spill_x layout); d_out,
// dg and dpk as for K18's mode 0.
int rsn_bwd_noipe(const void* g_bands, const void* xacts, const void* d_out,
                  const void* const* ptrs, void* dg, void* dpk,
                  long long rays, int samples_per_ray, int rays_per_block,
                  void* stream) {
  const UArgs a{nullptr, static_cast<const float*>(g_bands), nullptr,
                static_cast<const bf16*>(xacts),
                static_cast<const bf16*>(d_out), nullptr,
                static_cast<float*>(dg), static_cast<float*>(dpk), nullptr,
                rays, samples_per_ray, rays_per_block};
  return launch_unfolded<NOIPE>(ptrs, a, stream);
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
