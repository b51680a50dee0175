// Hopper (sm_90a) bodies of the tools' forward experiments K14
// (field_forward_v3u / v3i) and K15 (field_forward_v3L / v3F), in
// experiments.cu, on trunk_sm90.cuh's persistent block: the weight ring fed
// by cp.async.bulk from a pre-packed blob (rsn_torch/kernels/
// unfolded_sm90.py), 128-row tiles, two 64-row consumer warpgroups on
// wgmma, one producer thread.
//
// The function (the tools' _half, column for column): the IPE (K11's exact
// sine, ipe_exact_wg, for v3u / v3i, K1's polynomial one, ipe_wg, for v3L /
// v3F; both in trunk_sm90.cuh), the
// 8x256 trunk (trunk_wg), the unfolded heads Bn = bf16(H @ wh[:, 0:256] +
// bh) and HC = H @ wh[:, 256:272] (its bias added where it is read), the
// mid seed Bn @ w_emb + b_mid plus the four roughness-attenuated SH band
// partials of the row's ray, bf16(relu) -> hmid, the mid head, and the
// (rows, 128) bf16 row [V3_* columns 0:14 | 0].
//
// A tile's ring chunks, after the trunk's 32: the head columns (4 chunks
// of 64 x 16, m64n16), the bottleneck (4 of 64 x 256, m64n256) (these 40
// are K11's and K12's blob: trunk_sm90.cuh's heads_chunk_bytes), the mid
// seed (4 of 64 x 128, m64n128): 44 chunks, 1,253,376 bytes.  Each
// element's sum runs k ascending in steps of 16 from +0, as the first
// design's wmma sums do, and the epilogues are its arithmetic, so each
// variant equals its first design (RSN_K14_FIRST_DESIGN) bit for bit.
//
// The schedules.  The tools' two row halves are the block's two consumer
// warpgroups; only the order in which they issue their products differs:
//   IN_STEP (v3u): K1's: both read each stage as it lands and take their
//     epilogues in step.
//   OUT_OF_STEP (v3i): no order between them but the ring's; consumer 1
//     issues its first products only once consumer 0 has issued its first
//     TURN_LAG chunks (named barrier 4, once).
//   TURNS_TRUNK (v3L): the consumers take turns chunk by chunk through the
//     trunk: consumer 1 issues chunk c once consumer 0 has issued chunk c;
//     consumer 0 issues chunk c once consumer 1 has issued chunk c -
//     TURN_LAG.  Each passes the turn as soon as its products are issued,
//     so the leader's epilogue runs under the follower's last chunks of the
//     layer, and the follower's under the leader's first chunks of the
//     next.  The tail runs in step.
//   TURNS_ALL (v3F): the turns also through the tail's 12 chunks.
// Why per chunk: both consumers read every stage, so a consumer can be at
// most STAGES - 1 chunks ahead of the other (its next stage waits for the
// other's release).  A layer is 4-6 chunks and the ring holds 3: a turn
// handed over only after a whole layer waits on itself (consumer 0's
// fourth chunk needs the stage that consumer 1, waiting for the turn,
// never releases).  TURN_LAG = STAGES - 1 is the most lag the ring allows;
// the turns are mbarriers, TURN_SLOTS per consumer, so that a signal is
// never two phases ahead of its wait.  unfolded_sm90.py simulates each
// plan on the ring (tests/test_torch_exp_sm90.py).
#pragma once

#include "trunk_sm90.cuh"

namespace {
namespace sm90 {

constexpr int U_OUT_COLS = 128;    // V3_OUT: columns 0:14 live, 14:128 zero
constexpr int U_HC_N = HC_N;       // wh[:, 256:272]: the head columns
constexpr int U_EMB_N = MID;       // w_emb: the mid seed
constexpr int U_TAIL_CHUNKS = 12;
constexpr int U_CHUNKS = TRUNK_CHUNKS + U_TAIL_CHUNKS;   // 44
constexpr int TURN_LAG = STAGES - 1;
constexpr int TURN_SLOTS = TURN_LAG + 1;

// chunk c of a tile: the heads' (the trunk's 32, the head columns' 4, the
// bottleneck's 4: heads_chunk_bytes), then the mid seed's 4
__host__ __device__ constexpr int u_chunk_bytes(int c) {
  return c < HEADS_TILE_CHUNKS ? heads_chunk_bytes(c)
                               : U_EMB_N * CHUNK_K * 2;
}
__host__ __device__ constexpr long long u_blob_bytes() {
  long long b = 0;
  for (int c = 0; c < U_CHUNKS; ++c) b += u_chunk_bytes(c);
  return b;
}
static_assert(u_blob_bytes() == 1253376, "the unfolded blob's bytes");

// per consumer: the head columns (64 x 16 f32), the row scalars (64 x 8
// f32: 4 attenuations, -, 3 mid), the row's 16 first columns (64 x 16 bf16)
constexpr int U_TAIL_WG_BYTES = TAIL_WG_BYTES + WG_ROWS * 16 * 2;
constexpr int OFF_UWOUT = OFF_HS + CONSUMERS * H_WG_BYTES;  // MID float4
constexpr int OFF_UTAIL = OFF_UWOUT + MID * 16;
constexpr int OFF_UBARS = OFF_UTAIL + CONSUMERS * U_TAIL_WG_BYTES;
// the ring's full and empty barriers, the turns' (+ 1024: the base is
// aligned up to 1024 bytes at run time)
constexpr int U_SMEM_BYTES =
    OFF_UBARS + (2 * STAGES + CONSUMERS * TURN_SLOTS) * 8 + 1024;
static_assert(U_SMEM_BYTES <= 232448, "K14 / K15 exceed 227 KB");

enum Schedule { IN_STEP, OUT_OF_STEP, TURNS_TRUNK, TURNS_ALL };

struct UnfoldedParams {
  RenderParams r;      // mc, consts, blob, b[8], n, out, g, S, w_out, b_out
  const float* bh;     // (384,): [bottleneck | density | diff | tint |
                       // roughness | normals | 0]
  const float* b_mid;  // (128,)
  float* dmc;          // DMC (K18 recompute): (n, 16) f32, in out's place
};

// The block's dynamic shared memory, aligned up to 1024 bytes: a constant
// address, so what is derived from it need not stay in a register.
__device__ __forceinline__ unsigned char* u_smem() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return align_1024(smem_raw);
}

// v3L / v3F: consumer 1 issues chunk c once consumer 0 has issued chunk c;
// consumer 0 issues chunk c once consumer 1 has issued chunk c - TURN_LAG.
// Consumer g's TURN_SLOTS mbarriers at OFF_UBARS + 8 (2 STAGES + g
// TURN_SLOTS) (slot c % TURN_SLOTS) take one arrival per warp of g once its
// products of chunk c are issued.  One register through the trunk: c (the
// addresses and the consumer come from constants and threadIdx.x).
struct ChunkTurns {
  uint32_t c = 0;
  __device__ static uint32_t slot(int g, uint32_t k) {
    return smem_u32(u_smem() + OFF_UBARS) +
           8 * (2 * STAGES + g * TURN_SLOTS + k % TURN_SLOTS);
  }
  __device__ void before() {
    const int wg = threadIdx.x / WG_THREADS - 1;
    const uint32_t lag = wg == 0 ? TURN_LAG : 0;
    if (c < lag) return;
    const uint32_t j = c - lag;
    mbar_wait(slot(1 - wg, j), (j / TURN_SLOTS) & 1);
  }
  __device__ void after() {
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(slot(threadIdx.x / WG_THREADS - 1, c));
    ++c;
  }
};

// v3i: consumer 1's first products wait once for consumer 0's first
// TURN_LAG chunks (named barrier 4 over both consumers); then no order.
struct OutOfStepStart {
  int wg;
  int c;
  __device__ void before() {
    if (wg == 1 && c == 0)
      asm volatile("bar.sync 4, %0;" ::"n"(2 * WG_THREADS) : "memory");
  }
  __device__ void after() {
    if (c > TURN_LAG) return;
    if (wg == 0 && c == TURN_LAG - 1)
      asm volatile("bar.arrive 4, %0;" ::"n"(2 * WG_THREADS) : "memory");
    ++c;
  }
};

// The unfolded tail on the warpgroup's trunk output H (64 x 256 in the A
// layout), rows row0.. of the output: the head columns HC = H @ wh[:,
// 256:272] (4 chunks of m64n16) and the band attenuations from HC's
// roughness column; Bn = bf16(H @ wh[:, 0:256] + bh) into H once both
// products have read it (4 chunks of m64n256); the mid seed Bn @ w_emb (4
// chunks of m64n128) + b_mid + the attenuated band partials -> hmid =
// bf16(relu) into H's first 128 columns; the mid head and the row's 16
// first columns (one thread a row, each sum k ascending); the (64, 128)
// rows from the whole warpgroup, 16 bytes a thread.  DMC (K18's recompute
// mode, experiments_bwd.cu): in place of the rows, the thread's (16,) f32
// row of up.dmc, [mid[0] + the density pre-activation | 0], the first
// design's arithmetic.  turn: around each chunk's products.
template <bool DMC, typename Turn>
__device__ __forceinline__ void unfolded_tail_wg(const UnfoldedParams& up,
                                                 RingPos& rp,
                                                 unsigned char* H,
                                                 long long row0, int wg,
                                                 int t, Turn& turn) {
  const RenderParams& p = up.r;
  const float4* wout = reinterpret_cast<const float4*>(u_smem() + OFF_UWOUT);
  float* tail =
      reinterpret_cast<float*>(u_smem() + OFF_UTAIL + wg * U_TAIL_WG_BYTES);
  float* HSm = tail;                                  // 64 x 16 f32
  float* rowf = tail + WG_ROWS * HS_COLS;             // 64 x 8 f32
  bf16* ost = reinterpret_cast<bf16*>(rowf + WG_ROWS * ROWF);  // 64 x 16
  const int q = t & 3;
  const uint32_t ha = smem_u32(H);
  const auto a_h = [&](int j) { return ha + j * KB_BYTES; };
  const auto four = [](int) { return 4; };

  {  // the head columns, and the attenuations exp(-softplus(rough) k_b)
    float hc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) hc[i] = 0.f;
    fence_regs<8>(hc);
    mma_chunks<U_HC_N>(hc, rp, 4, a_h, four, turn);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      HSm[frag_row(t, i) * HS_COLS + frag_col(t, i)] = hc[i];
    if (q == 3) {  // column 7 (rough_raw) of rows frag_row(t, 1), (t, 3)
#pragma unroll
      for (int i = 1; i < 4; i += 2) {
        const float sp = softplusf(__fadd_rn(hc[i], up.bh[OUT_ROUGH]));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rowf[frag_row(t, i) * ROWF + b] = expf(__fmul_rn(-sp, band_k(b)));
      }
    }
  }

  bottleneck_wg(rp, H, up.bh, wg, t, turn);  // Bn into H
  fence_async_smem();
  wg_sync(wg);  // Bn is visible to wgmma, the attenuations to the group

  {  // hmid = bf16(relu(Bn @ w_emb + b_mid + sum_b atten_b g_b[ray])) into
     // H, for the thread's rows r0 and r0 + 8, one after the other
    // the rows' rays' SH band partials, brought into L1 while the mid
    // seed's products run (not earlier: the pointers would stay live
    // through the bottleneck's accumulator)
    const int r0 = frag_row(t, 0);
    const float* gr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + r0 + 8 * h;
      gr[h] = row < p.n ? p.g + (row / p.S) * G_COLS : nullptr;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // the 16 lines of 128 bytes hmid reads
      if (gr[0]) prefetch_l1(gr[0] + 32 * i);
      if (gr[1] && gr[1] != gr[0]) prefetch_l1(gr[1] + 32 * i);
    }
    float ms[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) ms[i] = 0.f;
    fence_regs<64>(ms);
    mma_chunks<U_EMB_N>(ms, rp, 4, a_h, four, turn);
    wg_sync(wg);  // no product still reads Bn
    float at[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) at[h][b] = rowf[(r0 + 8 * h) * ROWF + b];
#pragma unroll
    for (int jj = 0; jj < MID / 8; ++jj) {
      const int c = 8 * jj + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(up.b_mid + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m0 = __fadd_rn(ms[4 * jj + 2 * h], bb.x);
        float m1 = __fadd_rn(ms[4 * jj + 2 * h + 1], bb.y);
        if (gr[h]) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float2 gv =
                *reinterpret_cast<const float2*>(gr[h] + b * MID + c);
            m0 = __fadd_rn(m0, __fmul_rn(at[h][b], gv.x));
            m1 = __fadd_rn(m1, __fmul_rn(at[h][b], gv.y));
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(H + swz(r0 + 8 * h, c)) =
            __floats2bfloat162_rn(relu_keep_nan(m0), relu_keep_nan(m1));
      }
    }
    wg_sync(wg);
  }

  // mid = sigmoid(hmid @ w_out[:, 0:3] + b_out) and the row's 16 first
  // columns [mid_out | diff | tint | normals raw | density | rough raw |
  // 0 0], one thread per row (each sum k ascending, as the first design's)
  if (t < WG_ROWS) {
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
    const float mid[3] = {sigmoidf(__fadd_rn(s0, p.b_out[0])),
                          sigmoidf(__fadd_rn(s1, p.b_out[1])),
                          sigmoidf(__fadd_rn(s2, p.b_out[2]))};
    const float* hcr = HSm + t * HS_COLS;
    if constexpr (DMC) {
      const long long row = row0 + t;
      if (row < p.n) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        float4* o = reinterpret_cast<float4*>(up.dmc + row * IN_COLS);
        o[0] = make_float4(
            __fadd_rn(mid[0], __fadd_rn(hcr[0], up.bh[OUT_DENSITY])), 0.f,
            0.f, 0.f);
        o[1] = o[2] = o[3] = z;
      }
    } else {
      alignas(16) bf16 v[16];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float diff =
            sigmoidf(__fadd_rn(hcr[1 + i], up.bh[OUT_DIFF + i]));
        const float tint =
            sigmoidf(__fadd_rn(hcr[4 + i], up.bh[OUT_TINT + i]));
        v[i] = __float2bfloat16_rn(__fadd_rn(diff, __fmul_rn(tint, mid[i])));
        v[3 + i] = __float2bfloat16_rn(diff);
        v[6 + i] = __float2bfloat16_rn(tint);
        v[9 + i] = __float2bfloat16_rn(
            __fadd_rn(hcr[8 + i], up.bh[OUT_NORMALS + i]));
      }
      v[12] = __float2bfloat16_rn(__fadd_rn(hcr[0], up.bh[OUT_DENSITY]));
      v[13] = __float2bfloat16_rn(__fadd_rn(hcr[7], up.bh[OUT_ROUGH]));
      v[14] = v[15] = __float2bfloat16_rn(0.f);
      uint4* o = reinterpret_cast<uint4*>(ost + t * 16);
      o[0] = reinterpret_cast<const uint4*>(v)[0];
      o[1] = reinterpret_cast<const uint4*>(v)[1];
    }
  }
  if constexpr (DMC) return;  // the next tile's first wg_sync orders H
  wg_sync(wg);

  // the (64, 128) rows, 16 bytes per thread and step, zeros past column 16
  constexpr int Q = U_OUT_COLS / 8;
#pragma unroll
  for (int e = t; e < WG_ROWS * Q; e += WG_THREADS) {
    const int r = e / Q, qq = e % Q;
    const long long row = row0 + r;
    if (row < p.n)
      __stcs(reinterpret_cast<uint4*>(p.out + row * U_OUT_COLS + qq * 8),
             qq < 2 ? reinterpret_cast<const uint4*>(ost + r * 16)[qq]
                    : make_uint4(0u, 0u, 0u, 0u));
  }
}

// The whole tile of one consumer: the IPE (wg_sync'd; EXACT: K11's exact
// sine, else K1's polynomial one), the trunk with trunk_turn around its
// chunks, the tail (DMC as for unfolded_tail_wg) with tail_turn around its.
template <bool EXACT, bool DMC, typename TrunkTurn, typename TailTurn>
__device__ __forceinline__ void unfolded_tile_wg(
    const UnfoldedParams& up, RingPos& rp, unsigned char* X,
    unsigned char* H, int tile, int wg, int t, TrunkTurn& trunk_turn,
    TailTurn& tail_turn) {
  // the warpgroup's first row, derived where it is used (not held through
  // the trunk)
  const auto first_row = [&] {
    return (long long)tile * TILE_ROWS + wg * WG_ROWS;
  };
  wg_sync(wg);  // the previous tile's tail is done with X, H, the scratch
#ifndef RSN_ABLATE_NO_IPE  // ablate_render.py: X keeps stale values
  // the thread's IPE constants, read here (from L1) rather than held in
  // registers through the products
  const float* sk = up.r.consts + 8 * (t & 1);
  const float* vk = up.r.consts + NFREQ + 8 * (t & 1);
  if constexpr (EXACT)
    ipe_exact_wg(up.r.mc, first_row(), up.r.n, X, t, sk, vk);
  else
    ipe_wg(up.r.mc, first_row(), up.r.n, X, t, sk, vk);
#endif
  fence_async_smem();
  wg_sync(wg);
  NoTrunkHook hook;
  trunk_wg(up.r, rp, X, H, wg, t, hook, trunk_turn);
  unfolded_tail_wg<DMC>(up, rp, H, first_row(), wg, t, tail_turn);
}

// K14 / K15 (and K18's recompute mode, DMC): the persistent block (one per
// SM at most) on the schedule, in the kernel's dynamic shared memory
// (U_SMEM_BYTES); EXACT: the exact IPE (K14), else the polynomial one (K15,
// K18).
template <int SCHED, bool EXACT, bool DMC = false>
__device__ void unfolded_body(const UnfoldedParams& up) {
  unsigned char* smem = u_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_UBARS);
  uint64_t* empty = full + STAGES;
  uint64_t* issued = empty + STAGES;
  float4* wout = reinterpret_cast<float4*>(smem + OFF_UWOUT);
  const RenderParams& p = up.r;
  for (int k = threadIdx.x; k < MID; k += BLOCK_THREADS)
    wout[k] = make_float4(__bfloat162float(p.w_out[k * MID]),
                          __bfloat162float(p.w_out[k * MID + 1]),
                          __bfloat162float(p.w_out[k * MID + 2]), 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < CONSUMERS * TURN_SLOTS; ++s)
      mbar_init(&issued[s], 4);  // one arrival per warp of its consumer
    mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (int)((p.n + TILE_ROWS - 1) / TILE_ROWS);
  const int wgi = threadIdx.x / WG_THREADS;
  if (wgi == 0) {
    setmaxnreg_dec40();
    if (threadIdx.x == 0)
      produce_chunks(p.blob, smem + OFF_RING, full, empty, U_CHUNKS, ntiles,
                     [](int c) { return u_chunk_bytes(c); });
    return;
  }
  setmaxnreg_inc232();
  const int wg = wgi - 1, t = threadIdx.x % WG_THREADS;
  unsigned char* X = smem + OFF_XS + wg * X_WG_BYTES;
  unsigned char* H = smem + OFF_HS + wg * H_WG_BYTES;
  RingPos rp{smem + OFF_RING, full, empty, 0, 0u};
  zero_x_pad(X, t);
  NoChunkTurn none;
  OutOfStepStart start{wg, 0};
  ChunkTurns turns;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if constexpr (SCHED == IN_STEP)
      unfolded_tile_wg<EXACT, DMC>(up, rp, X, H, tile, wg, t, none, none);
    else if constexpr (SCHED == OUT_OF_STEP)
      unfolded_tile_wg<EXACT, DMC>(up, rp, X, H, tile, wg, t, start, start);
    else if constexpr (SCHED == TURNS_TRUNK)
      unfolded_tile_wg<EXACT, DMC>(up, rp, X, H, tile, wg, t, turns, none);
    else
      unfolded_tile_wg<EXACT, DMC>(up, rp, X, H, tile, wg, t, turns, turns);
  }
}

}  // namespace sm90
}  // namespace
