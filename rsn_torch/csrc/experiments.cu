// The forward experiments of rsn's tools/, for NVIDIA Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels under tools/:
//   field_forward_v3u / field_forward_v3i (K14; tools/exp_interleave.py,
//       bodies _kernel_v3u / _kernel_v3i / _half): K11's exact IPE -> bf16
//       trunk 8x256 (skip at 4) -> the unfolded (256, 384) heads with the
//       256-wide bottleneck -> bf16(bottleneck) @ w_emb + b_mid as the
//       mid-MLP seed, roughness attenuation of the 4 per-ray SH band
//       partials, mid head -> (N, 128) bf16: the V3_* columns 0:14, zero
//       14:128.  v3i computes the same function as two row halves.
//   field_forward_v3L (K15; tools/exp_interleave2.py, _kernel_v3L): the
//       same with K1's polynomial IPE; the two halves take turns on the
//       tensor cores through the trunk (v3L), and with `full` also through
//       the heads and the mid seed (v3F).
//   run (K16; tools/exp_cheap_sin.py, make_kernel): one elementwise mode
//       per launch, (N, 128) f32 -> (N, 128) f32.
//
// What bounds them on this card: K14 / K15 do 1.22 MFLOP of bf16 products
// per row (the trunk on the IPE's 99 live columns, 267 live head columns,
// the mid seed, the mid head) against 64 B read and 256 B written: the
// tensor cores (2.59 ms at 2,097,152 rows).  K16 moves 1 KB per row for a
// few tens of fp32 operations per element: device memory (0.64 ms at
// 2,097,152 rows).
//
// What the design does about it:
//   - K14 / K15 run on K1's Hopper block (unfolded_sm90.cuh on
//     trunk_sm90.cuh): a persistent grid, 128-row tiles, the weights
//     streamed through a 3-stage ring of shared memory by cp.async.bulk
//     from a blob packed once per operand tuple (rsn_torch/kernels/
//     unfolded_sm90.py), the products on wgmma (m64n256 trunk and
//     bottleneck, m64n16 head columns, m64n128 mid seed), the two 64-row
//     consumer warpgroups in the roles of the tools' two halves.  The four
//     variants differ only in the order in which the two consumers issue
//     their products (unfolded_sm90.cuh): v3u in step, v3i out of step,
//     v3L in turns chunk by chunk through the trunk, v3F through the tail
//     too.  v3i equals v3u and v3F equals v3L bit for bit, and each equals
//     its first design.
//   - The first design (64-row tiles, two blocks an SM, every intermediate
//     in shared memory, wmma 16x16x16 with the weights read from L2 one
//     k-step ahead; the halves two 32-row warp groups meeting at their own
//     named barriers, v3L's turns around whole layers' products) is kept
//     under RSN_K14_FIRST_DESIGN, which only chip_smoke.py and the card
//     tests build, to hold the new kernels equal to it bit for bit.  Both
//     builds take the same arguments; the first design ignores the blob.
//   - No one-hot sample expansion (a row finds its ray as row / S), no
//     128-lane IPE matrices, no padding of N: the ragged last tile is
//     masked.
//   - K16: a template over the mode; one 128-thread block per chunk of
//     128 x (float4 a thread), streamed (.cs: 2 GiB pass through the 50
//     MB L2 once), the last chunk masked.  The modes bound by the bytes
//     keep four 16-byte loads in flight a thread before their math and
//     their stores, and run there at PyTorch's own elementwise pass's
//     rate; exact, bound by sinf's slow range reduction, takes one float4
//     a thread (more warps in flight; time_k16.py).  fp32 arithmetic
//     through __fmul_rn / __fadd_rn (no contraction into fma), sinf /
//     expf / exp2f with full range reduction (the build has no
//     --use_fast_math), rintf for jnp.round; poly_bf16 rounds every
//     product and sum to bf16 on its own, as rsn's chain is written.
//     K16 is the same in both builds.
#include "field_common.cuh"

#ifndef RSN_K14_FIRST_DESIGN
#include "unfolded_sm90.cuh"
#endif

namespace {

#ifndef RSN_K14_FIRST_DESIGN

// K14 / K15: sm90::unfolded_body on the schedule (unfolded_sm90.cuh), K14's
// with the exact IPE.
template <int SCHED>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    unfolded_kernel(const __grid_constant__ sm90::UnfoldedParams p) {
  sm90::unfolded_body<SCHED, SCHED == sm90::IN_STEP ||
                                 SCHED == sm90::OUT_OF_STEP>(p);
}

// On a persistent grid of at most one block per SM.  ptrs: the 22 operands
// (the weights are read from blob; the biases, w_out from ptrs).
template <int SCHED>
int launch_unfolded(const void* mean_cov, const void* g_bands,
                    const void* ipe_consts, const void* blob,
                    const void* const* ptrs, void* out, long long n, int S,
                    void* stream) {
  sm90::UnfoldedParams p{};
  p.r.mc = static_cast<const float*>(mean_cov);
  p.r.consts = static_cast<const float*>(ipe_consts);
  p.r.blob = static_cast<const unsigned char*>(blob);
  for (int i = 0; i < LAYERS; ++i)
    p.r.b[i] = static_cast<const float*>(ptrs[LAYERS + i]);
  p.r.n = n;
  p.r.out = static_cast<bf16*>(out);
  p.r.g = static_cast<const float*>(g_bands);
  p.r.S = S;
  p.bh = static_cast<const float*>(ptrs[17]);
  p.b_mid = static_cast<const float*>(ptrs[19]);
  p.r.w_out = static_cast<const bf16*>(ptrs[20]);
  p.r.b_out = static_cast<const float*>(ptrs[21]);
  auto kernel = unfolded_kernel<SCHED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sm90::U_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + sm90::TILE_ROWS - 1) / sm90::TILE_ROWS;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, sm90::BLOCK_THREADS, sm90::U_SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

#else  // RSN_K14_FIRST_DESIGN: the first design, for the bit-for-bit check

constexpr int OUT_COLS = 128;    // V3_OUT: columns 0:14 live, 14:128 zero
constexpr int LDF = 20;          // f32 head columns 256..271, + 4
constexpr int LDM = MID + 4;     // f32 mid seed
constexpr int ROWF = 8;          // per row: 4 attenuations, density, 3 mid
constexpr int SUB = TM / 2;      // rows of a half
static_assert(TM * LDM * 4 <= H_BYTES, "the mid seed must fit H1");
static_assert(TM * (LDF + ROWF) * 4 + TM * 16 * 2 <= X_BYTES,
              "head columns, row scalars and the row staging must fit X");

struct GroupSync {
  int bar, nt;
  __device__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(nt) : "memory");
  }
};

// A group of warps and the row tile it owns: its rows of the block's
// buffers, its warps' stages, its barrier.
struct Rows {
  long long row0;     // the tile's first row
  bf16 *X, *H0, *H1;  // the tile's rows of the IPE and activation buffers
  float* st;          // this warp's stage
  int tid, nt, warp;  // thread and warp in the group; threads in the group
  GroupSync sync;
};

// K15's hand-off of the tensor cores between the two warp groups: group 0
// runs the products of phase p (p > 0) once group 1 has issued those of
// phase p - 1; group 1 runs phase p once group 0 has issued it.  Named
// barrier 4 + g says "group g may go"; each counts both groups' threads,
// the waiting group's bar.sync and the other's bar.arrive.
struct PingPong {
  int grp, phases, p;
  __device__ void begin() {
    if (grp == 1 || p > 0)
      asm volatile("bar.sync %0, %1;" ::"r"(4 + grp), "n"(THREADS)
                   : "memory");
  }
  __device__ void end() {
    if (grp == 0 || p < phases - 1)
      asm volatile("bar.arrive %0, %1;" ::"r"(5 - grp), "n"(THREADS)
                   : "memory");
    ++p;
  }
};

// The whole forward of one row tile of 16 RT rows by its group of 2 RT
// warps: the IPE (exact or polynomial), the trunk (turn: around each
// layer's products), the unfolded heads and the mid tail (tail_turn:
// around the heads, the mid seed and the mid head), the (rows, 128) store.
template <int RT, bool EXACT, typename Turn, typename TailTurn>
__device__ void unfolded_rows(const Rows& t, const float* __restrict__ mc,
                              const float* __restrict__ g,
                              const float* __restrict__ consts,
                              const V3UParams& p, bf16* __restrict__ out,
                              long long n, int S, Turn& turn,
                              TailTurn& tail_turn) {
  constexpr int R = 16 * RT;       // rows
  constexpr int CT = 8 / RT;       // 16-column trunk tiles per warp
  constexpr int CM = MID / 16 / (2 * RT);  // mid-seed tiles per warp
  NoTurn none;

  ipe_rows<EXACT>(mc, consts, t.row0, n, t.X, t.tid, t.nt, R);
  t.sync();
  const bf16* H = trunk_rows<RT, CT>(p.trunk, t.X, t.H0, t.H1, t.warp, t.st,
                                     t.sync, turn, NoLayerHook());  // H1
  float* HC = reinterpret_cast<float*>(t.X);  // (R, LDF) head columns
  float* rowf = HC + R * LDF;                 // (R, ROWF) row scalars
  bf16* ost = reinterpret_cast<bf16*>(rowf + R * ROWF);  // (R, 16) row
  bf16* Bn = t.H0;                            // bottleneck, then hmid
  float* MS = reinterpret_cast<float*>(t.H1);  // mid seed, after the heads

  // heads: Bn = bf16(H @ wh[:, 0:256] + bh[0:256]); HC = H @ wh[:, 256:272]
  // (warp w < RT: row tile w), the bias added where it is read
  tail_turn.begin();
  warp_product<RT, CT>(H, LDH, WIDTH, nullptr, 0, 0, p.wh, HEAD_COLS,
                       t.warp * 16 * CT, t.st, none,
                       [&](int r, int c, float v) {
                         Bn[r * LDH + c] =
                             __float2bfloat16_rn(__fadd_rn(v, p.bh[c]));
                       });
  if (t.warp < RT) {
    const int r0 = t.warp * 16;
    warp_product<1, 1>(H + r0 * LDH, LDH, WIDTH, nullptr, 0, 0, p.wh,
                       HEAD_COLS, WIDTH, t.st, none,
                       [&](int r, int c, float v) {
                         HC[(r0 + r) * LDF + c - WIDTH] = v;
                       });
  }
  tail_turn.end();
  t.sync();

  // per row: the band attenuations exp(-softplus(rough) k_b); the mid seed
  // MS = Bn @ w_emb (H is dead: MS takes its place)
  if (t.tid < R) {
    const int r = t.tid;
    const float sp = softplusf(__fadd_rn(HC[r * LDF + 7], p.bh[OUT_ROUGH]));
#pragma unroll
    for (int b = 0; b < 4; ++b)
      rowf[r * ROWF + b] = expf(__fmul_rn(-sp, band_k(b)));
  }
  tail_turn.begin();
  warp_product<RT, CM>(Bn, LDH, WIDTH, nullptr, 0, 0, p.w_emb, MID,
                       t.warp * 16 * CM, t.st, none,
                       [&](int r, int c, float v) { MS[r * LDM + c] = v; });
  tail_turn.end();
  t.sync();

  // hmid = bf16(relu(MS + b_mid + sum_b atten_b * g_b[ray])) into Bn
  for (int e = t.tid; e < R * MID; e += t.nt) {
    const int r = e / MID, c = e % MID;
    const long long row = t.row0 + r;
    float m = __fadd_rn(MS[r * LDM + c], p.b_mid[c]);
    if (row < n) {
      const float* gr = g + (row / S) * G_COLS + c;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        m = __fadd_rn(m, __fmul_rn(rowf[r * ROWF + b], gr[b * MID]));
    }
    Bn[r * LDH + c] = __float2bfloat16_rn(relu_keep_nan(m));
  }
  t.sync();

  // mid = sigmoid(hmid @ w_out[:, 0:3] + b_out): one thread per (row, col)
  tail_turn.begin();
  if (t.tid < R * 3) {
    const int r = t.tid / 3, c = t.tid % 3;
    float s = 0.f;
    for (int k = 0; k < MID; ++k)
      s = __fmaf_rn(__bfloat162float(Bn[r * LDH + k]),
                    __bfloat162float(p.w_out[k * MID + c]), s);
    rowf[r * ROWF + 5 + c] = sigmoidf(__fadd_rn(s, p.b_out[c]));
  }
  tail_turn.end();
  t.sync();

  // the row's 16 first columns [mid_out | diff | tint | normals raw |
  // density | rough raw | 0 0] into the staging
  if (t.tid < R) {
    const int r = t.tid;
    const float* hc = HC + r * LDF;
    const float* rf = rowf + r * ROWF;
    alignas(16) bf16 v[16];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float diff = sigmoidf(__fadd_rn(hc[1 + i], p.bh[OUT_DIFF + i]));
      const float tint = sigmoidf(__fadd_rn(hc[4 + i], p.bh[OUT_TINT + i]));
      v[i] = __float2bfloat16_rn(__fadd_rn(diff, __fmul_rn(tint, rf[5 + i])));
      v[3 + i] = __float2bfloat16_rn(diff);
      v[6 + i] = __float2bfloat16_rn(tint);
      v[9 + i] = __float2bfloat16_rn(__fadd_rn(hc[8 + i],
                                               p.bh[OUT_NORMALS + i]));
    }
    v[12] = __float2bfloat16_rn(__fadd_rn(hc[0], p.bh[OUT_DENSITY]));
    v[13] = __float2bfloat16_rn(__fadd_rn(hc[7], p.bh[OUT_ROUGH]));
    v[14] = v[15] = __float2bfloat16_rn(0.f);
    uint4* o = reinterpret_cast<uint4*>(ost + r * 16);
    o[0] = reinterpret_cast<const uint4*>(v)[0];
    o[1] = reinterpret_cast<const uint4*>(v)[1];
  }
  t.sync();

  // the (R, 128) rows, 16 bytes per thread and step, zeros past column 16
  constexpr int Q = OUT_COLS / 8;
  for (int e = t.tid; e < R * Q; e += t.nt) {
    const int r = e / Q, q = e % Q;
    const long long row = t.row0 + r;
    if (row < n)
      *reinterpret_cast<uint4*>(out + row * OUT_COLS + q * 8) =
          q < 2 ? reinterpret_cast<const uint4*>(ost + r * 16)[q]
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    field_forward_v3u_kernel(const float* __restrict__ mc,
                             const float* __restrict__ g,
                             const float* __restrict__ consts, V3UParams p,
                             bf16* __restrict__ out, long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const Rows t{(long long)blockIdx.x * TM,
               reinterpret_cast<bf16*>(smem + OFF_X),
               reinterpret_cast<bf16*>(smem + OFF_H0),
               reinterpret_cast<bf16*>(smem + OFF_H1),
               reinterpret_cast<float*>(smem + OFF_STAGE) + warp * 16 * LDS,
               (int)threadIdx.x, THREADS, warp, GroupSync{1, THREADS}};
  NoTurn a, b;
  unfolded_rows<4, true>(t, mc, g, consts, p, out, n, S, a, b);
}

// The halves: warp group grp (4 warps) owns rows [32 grp, 32 grp + 32) of
// the block's tile.  SCHEDULE 0: independent (v3i); 1: turns through the
// trunk (v3L); 2: turns through the trunk and the tail (v3F).
template <bool EXACT, int SCHEDULE>
__global__ void __launch_bounds__(THREADS, 2)
    field_forward_halves_kernel(const float* __restrict__ mc,
                                const float* __restrict__ g,
                                const float* __restrict__ consts,
                                V3UParams p, bf16* __restrict__ out,
                                long long n, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, grp = threadIdx.x >> 7;
  const Rows t{(long long)blockIdx.x * TM + SUB * grp,
               reinterpret_cast<bf16*>(smem + OFF_X) + SUB * grp * LDX,
               reinterpret_cast<bf16*>(smem + OFF_H0) + SUB * grp * LDH,
               reinterpret_cast<bf16*>(smem + OFF_H1) + SUB * grp * LDH,
               reinterpret_cast<float*>(smem + OFF_STAGE) + warp * 16 * LDS,
               (int)threadIdx.x & 127, 128, warp & 3, GroupSync{2 + grp, 128}};
  if (SCHEDULE == 0) {
    NoTurn a, b;
    unfolded_rows<2, EXACT>(t, mc, g, consts, p, out, n, S, a, b);
  } else if (SCHEDULE == 1) {
    PingPong a{grp, LAYERS, 0};
    NoTurn b;
    unfolded_rows<2, EXACT>(t, mc, g, consts, p, out, n, S, a, b);
  } else {  // the trunk's 8 phases, then the heads, mid seed and mid head
    PingPong a{grp, LAYERS + 3, 0};
    unfolded_rows<2, EXACT>(t, mc, g, consts, p, out, n, S, a, a);
  }
}

typedef void (*ForwardKernel)(const float*, const float*, const float*,
                              V3UParams, bf16*, long long, int);

int launch_forward(ForwardKernel kernel, const void* mean_cov,
                   const void* g_bands, const void* ipe_consts,
                   const void* const* ptrs, void* out, long long n, int S,
                   void* stream) {
  V3UParams p;
  fill_v3u(&p, ptrs);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((n + TM - 1) / TM), THREADS, FWD_SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean_cov), static_cast<const float*>(g_bands),
      static_cast<const float*>(ipe_consts), p, static_cast<bf16*>(out), n,
      S);
  return (int)cudaGetLastError();
}

#endif  // RSN_K14_FIRST_DESIGN

// ---- K16 ------------------------------------------------------------------

enum CheapSinMode {
  COPY, EXACT_SIN, POLY, EXP, EXP2, EXP2_LDEXP, POLY_BF16, COS_POLY,
  N_MODES
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__device__ __forceinline__ float cheap_sin(float t) {
  if (MODE == COPY) return __fmul_rn(t, 2.f);
  if (MODE == EXACT_SIN) return sinf(__fmul_rn(t, 6.28318530717958648f));
  if (MODE == EXP) return expf(__fmul_rn(-0.5f, fabsf(t)));
  if (MODE == EXP2) return exp2f(__fmul_rn(-0.72134752f, fabsf(t)));
  if (MODE == EXP2_LDEXP) {
    const float u = fmaxf(__fmul_rn(-0.72134752f, fabsf(t)), -126.f);
    const float i = floorf(u), f = __fsub_rn(u, i);
    float p = __fmul_rn(f, 0.00961813f);
    p = __fmul_rn(f, __fadd_rn(0.05550411f, p));
    p = __fmul_rn(f, __fadd_rn(0.24022650f, p));
    p = __fmul_rn(f, __fadd_rn(0.69314718f, p));
    p = __fadd_rn(1.f, p);
    return __fmul_rn(__int_as_float(((int)i + 127) << 23), p);
  }
  const float u = __fsub_rn(t, rintf(t));  // the wrapped phase, in turns
  if (MODE == POLY) {
    const float w = __fmul_rn(u, u);
    float p = __fmul_rn(w, 42.008881f);
    p = __fmul_rn(w, __fadd_rn(-76.581304f, p));
    p = __fmul_rn(w, __fadd_rn(81.602455f, p));
    p = __fmul_rn(w, __fadd_rn(-41.341663f, p));
    return __fmul_rn(u, __fadd_rn(6.2831852f, p));
  }
  if (MODE == COS_POLY) {
    const float w = __fmul_rn(u, u);
    float p = __fsub_rn(60.244179f, __fmul_rn(w, 27.06042f));
    p = __fmul_rn(w, __fadd_rn(-85.474136f, __fmul_rn(w, p)));
    p = __fmul_rn(w, __fadd_rn(64.939394f, p));
    p = __fmul_rn(w, __fadd_rn(-19.739206f, p));
    return __fadd_rn(0.9999999f, p);
  }
  // POLY_BF16: each product and sum rounded to bf16 on its own
  const float ub = round_bf16(u);
  const float w = round_bf16(__fmul_rn(ub, ub));
  float p = round_bf16(-12.2688402f);
  p = round_bf16(__fadd_rn(round_bf16(__fmul_rn(p, w)), round_bf16(41.2037313f)));
  p = round_bf16(__fadd_rn(round_bf16(__fmul_rn(p, w)), round_bf16(-76.5796851f)));
  p = round_bf16(__fadd_rn(round_bf16(__fmul_rn(p, w)), round_bf16(81.5961385f)));
  p = round_bf16(__fadd_rn(round_bf16(__fmul_rn(p, w)), round_bf16(-41.3414194f)));
  p = round_bf16(__fadd_rn(round_bf16(__fmul_rn(p, w)), round_bf16(6.28318279f)));
  return round_bf16(__fmul_rn(p, ub));
}

constexpr int K16_THREADS = 128;

// float4 in flight per thread: four for the modes bound by the bytes; one
// for exact, whose sinf (the slow range reduction) gains more from the
// warps that fewer live registers allow than from loads in flight
template <int MODE>
constexpr int K16_UNROLL = MODE == EXACT_SIN ? 1 : 4;

// One block per chunk of 128 x K16_UNROLL float4: each thread issues its
// 16-byte loads (lanes on neighbouring addresses) before its math and its
// stores, streaming (ld.global.cs / st.global.cs: the pass touches every
// byte once); the ragged last chunk is masked.
template <int MODE>
__global__ void __launch_bounds__(K16_THREADS)
    cheap_sin_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                     long long n4) {
  constexpr int UNROLL = K16_UNROLL<MODE>;
  const long long i0 =
      (long long)blockIdx.x * (K16_THREADS * UNROLL) + threadIdx.x;
  float4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = i0 + u * K16_THREADS;
    if (i < n4) v[u] = __ldcs(x + i);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = i0 + u * K16_THREADS;
    if (i < n4) {
      v[u].x = cheap_sin<MODE>(v[u].x);
      v[u].y = cheap_sin<MODE>(v[u].y);
      v[u].z = cheap_sin<MODE>(v[u].z);
      v[u].w = cheap_sin<MODE>(v[u].w);
      __stcs(y + i, v[u]);
    }
  }
}

template <int MODE>
int launch_cheap_sin(const float* x, float* y, long long n,
                     cudaStream_t stream) {
  const long long n4 = n * 128 / 4;
  constexpr int chunk = K16_THREADS * K16_UNROLL<MODE>;
  const long long grid = (n4 + chunk - 1) / chunk;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cheap_sin_kernel<MODE><<<(unsigned)grid, K16_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K14, K15.  blob: unfolded_sm90.pack_unfolded_blob of the operands; ptrs:
// w0..w7, b0..b7, wh, bh, w_emb, b_mid, w_out, b_out (pack_params_v3,
// device pointers); out (N, 128) bf16.  Each returns a cudaError_t code
// (0 = launched).  The RSN_K14_FIRST_DESIGN build launches the first
// design and ignores blob.
int rsn_field_forward_v3u(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* blob,
                          const void* const* ptrs, void* out, long long n,
                          int samples_per_ray, void* stream) {
#ifndef RSN_K14_FIRST_DESIGN
  return launch_unfolded<sm90::IN_STEP>(mean_cov, g_bands, ipe_consts, blob,
                                        ptrs, out, n, samples_per_ray,
                                        stream);
#else
  (void)blob;
  return launch_forward(field_forward_v3u_kernel, mean_cov, g_bands,
                        ipe_consts, ptrs, out, n, samples_per_ray, stream);
#endif
}

int rsn_field_forward_v3i(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* blob,
                          const void* const* ptrs, void* out, long long n,
                          int samples_per_ray, void* stream) {
#ifndef RSN_K14_FIRST_DESIGN
  return launch_unfolded<sm90::OUT_OF_STEP>(mean_cov, g_bands, ipe_consts,
                                            blob, ptrs, out, n,
                                            samples_per_ray, stream);
#else
  (void)blob;
  return launch_forward(field_forward_halves_kernel<true, 0>, mean_cov,
                        g_bands, ipe_consts, ptrs, out, n, samples_per_ray,
                        stream);
#endif
}

int rsn_field_forward_v3L(const void* mean_cov, const void* g_bands,
                          const void* ipe_consts, const void* blob,
                          const void* const* ptrs, void* out, long long n,
                          int samples_per_ray, int full, void* stream) {
#ifndef RSN_K14_FIRST_DESIGN
  return full ? launch_unfolded<sm90::TURNS_ALL>(mean_cov, g_bands,
                                                 ipe_consts, blob, ptrs, out,
                                                 n, samples_per_ray, stream)
              : launch_unfolded<sm90::TURNS_TRUNK>(mean_cov, g_bands,
                                                   ipe_consts, blob, ptrs,
                                                   out, n, samples_per_ray,
                                                   stream);
#else
  (void)blob;
  return launch_forward(full ? field_forward_halves_kernel<false, 2>
                             : field_forward_halves_kernel<false, 1>,
                        mean_cov, g_bands, ipe_consts, ptrs, out, n,
                        samples_per_ray, stream);
#endif
}

// K16.  x, y (N, 128) f32; mode: 0 copy, 1 exact, 2 poly, 3 exp, 4 exp2,
// 5 exp2_ldexp, 6 poly_bf16, 7 cos_poly.
int rsn_cheap_sin(const void* x, void* y, long long n, int mode,
                  void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case COPY: return launch_cheap_sin<COPY>(xf, yf, n, s);
    case EXACT_SIN: return launch_cheap_sin<EXACT_SIN>(xf, yf, n, s);
    case POLY: return launch_cheap_sin<POLY>(xf, yf, n, s);
    case EXP: return launch_cheap_sin<EXP>(xf, yf, n, s);
    case EXP2: return launch_cheap_sin<EXP2>(xf, yf, n, s);
    case EXP2_LDEXP: return launch_cheap_sin<EXP2_LDEXP>(xf, yf, n, s);
    case POLY_BF16: return launch_cheap_sin<POLY_BF16>(xf, yf, n, s);
    case COS_POLY: return launch_cheap_sin<COS_POLY>(xf, yf, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rsn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
