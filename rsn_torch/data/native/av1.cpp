// AV1 still pictures as dav1d 1.5.1 decodes them for PIL's AVIF plugin,
// for rsn_torch.data.avif.
//
// The decode follows the AV1 specification (AV1 Bitstream & Decoding
// Process Specification, version 1.0.0 with errata 1): a conforming
// decoder gives every sample exactly, and dav1d is conforming.  The scope
// is an 8-bit shown key frame under a reduced or a full sequence header
// (operating point 0 of idc 0, no decoder model), in uniformly or
// explicitly sized tiles, with every intra tool (palette with its colour
// cache, CfL, filter intra, the directional modes with the intra edge
// filter and upsampling, smooth and Paeth), blocks coded as skipped,
// segmentation (its quantizer, loop-filter and skip features), delta q
// and delta lf (one level or one per edge and plane), lossless blocks
// (the Walsh-Hadamard transform), the deblocking filter and loop
// restoration (Wiener and self-guided).  Where dav1d departs from the
// specification for a stream no encoder writes, it follows dav1d: a
// segment id past the last active segment is 0.  A stream that uses a
// tool outside the scope is refused with its name: intra block copy, CDEF
// with a nonzero strength, film grain, superres, quantizer matrices, 10 or
// 12 bits, frames other than shown key frames, scalable streams, a
// decoder model, and segmentation with no feature enabled (whose segment
// ids dav1d reads past its table).  A stream dav1d refuses (a missing
// sequence header, a tile whose symbols run past its data, a header out of
// range) is an error.
//
// The symbol decoder is dav1d's (msac.c), which is the specification's
// read_symbol with the window kept inverted.  The inverse transforms
// follow libaom's flow graphs, which the specification defines: the DCT
// is built recursively (the even half is the DCT of half the size, the
// odd half a fixed ladder of rotations and butterflies), each rotation
// rounded to 12 bits and each sum clipped to 16 bits as dav1d clips it.
// A tile whose coefficients overflow the 16 bits the specification
// allows (no encoder writes one) may come out otherwise than from dav1d,
// whose C and x86 assembly differ from each other there too.
//
// The tables (default CDFs, quantizer lookups, scans, smooth weights,
// filter-intra taps, derivatives, DCT constants, self-guided parameters)
// are av1_tables.h, read out of the library PIL ships by
// tests/golden/avif/extract_av1_tables.py.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

// ERR_SHAPE: a caller's planes of another count or shape than the frame's
enum { ERR_INVALID = 1, ERR_REFUSED = 2, ERR_SHAPE = 3 };
struct Fail {
  int kind;
  std::string msg;
};
[[noreturn]] void invalid(const std::string &m) { throw Fail{ERR_INVALID, m}; }
[[noreturn]] void refuse(const std::string &m) { throw Fail{ERR_REFUSED, m}; }

// ---- tool counts ----------------------------------------------------------
#define AV1_COUNTS(X)                                                        \
  X(frames) X(tiles) X(sb64) X(sb128) X(mono) X(s420) X(s422) X(s444)       \
  X(full_range) X(limited_range) X(delta_q) X(delta_lf) X(lossless_blocks)  \
  X(reduced_tx_set) X(tx_mode_select) X(disable_cdf_update)                 \
  X(screen_content) X(loop_filter) X(lf_sharpness) X(lr_frames)             \
  X(lr_wiener) X(lr_sgrproj) X(lr_switchable) X(blocks) X(palette_y)        \
  X(palette_uv) X(palette_cache) X(cfl) X(filter_intra) X(angle_delta)      \
  X(edge_filter) X(edge_upsample)                                           \
  X(y_dc) X(y_v) X(y_h) X(y_d45) X(y_d135) X(y_d113) X(y_d157) X(y_d203)     \
  X(y_d67) X(y_smooth) X(y_smooth_v) X(y_smooth_h) X(y_paeth) X(uv_dc)       \
  X(uv_v) X(uv_h) X(uv_d45) X(uv_d135) X(uv_d113) X(uv_d157) X(uv_d203)     \
  X(uv_d67) X(uv_smooth) X(uv_smooth_v) X(uv_smooth_h) X(uv_paeth)          \
  X(uv_cfl) X(tx_4x4) X(tx_8x8) X(tx_16x16) X(tx_32x32) X(tx_64x64)         \
  X(tx_4x8) X(tx_8x4) X(tx_8x16) X(tx_16x8) X(tx_16x32) X(tx_32x16)         \
  X(tx_32x64) X(tx_64x32) X(tx_4x16) X(tx_16x4) X(tx_8x32) X(tx_32x8)       \
  X(tx_16x64) X(tx_64x16) X(txt_dct_dct) X(txt_adst_dct) X(txt_dct_adst)    \
  X(txt_adst_adst) X(txt_idtx) X(txt_v_dct) X(txt_h_dct) X(txt_wht)         \
  X(golomb) X(partition_4) X(partition_ab) X(dc_only) X(skip_blocks)   \
  X(segmentation) X(segment_ids) X(seg_alt_q) X(seg_alt_lf) X(seg_skip)     \
  X(delta_lf_multi) X(explicit_tiles) X(full_headers) X(decoder_model)     \
  X(frame_header_obus)

enum Count {
#define X(n) C_##n,
  AV1_COUNTS(X)
#undef X
  C_NUM
};
const char *const COUNT_NAMES =
#define X(n) #n ","
    AV1_COUNTS(X)
#undef X
    ;

// ---- sizes ----------------------------------------------------------------
enum {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
  BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
  BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
  BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_SIZES, BLOCK_INVALID = 255
};
// log2 of the width and height in 4-sample units
const uint8_t BW4L[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                          4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t BH4L[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                          3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};

enum {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
  TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
  TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL
};
const uint8_t TXWL[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t TXHL[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};

int block_of(int wl4, int hl4) {  // log2 sizes in 4-sample units
  for (int b = 0; b < BLOCK_SIZES; b++)
    if (BW4L[b] == wl4 && BH4L[b] == hl4) return b;
  return BLOCK_INVALID;
}
int tx_of(int wl, int hl) {  // log2 sizes in samples
  for (int t = 0; t < TX_SIZES_ALL; t++)
    if (TXWL[t] == wl && TXHL[t] == hl) return t;
  return -1;
}
int tx_sqr(int t) { return tx_of(std::min(TXWL[t], TXHL[t]), std::min(TXWL[t], TXHL[t])); }
int tx_sqr_up(int t) { return tx_of(std::max(TXWL[t], TXHL[t]), std::max(TXWL[t], TXHL[t])); }
int tx_split(int t) {
  int w = TXWL[t], h = TXHL[t];
  if (w == h) return tx_of(w - 1, h - 1);
  return w > h ? tx_of(w - 1, h) : tx_of(w, h - 1);
}
int max_tx_rect(int bs) {
  return tx_of(std::min(BW4L[bs] + 2, 6), std::min(BH4L[bs] + 2, 6));
}
int plane_block(int bs, int sx, int sy) {  // Subsampled_Size
  int wl = BW4L[bs] - sx, hl = BH4L[bs] - sy;
  if (wl < 0) wl = 0;
  if (hl < 0) hl = 0;
  int b = block_of(wl, hl);
  if (b == BLOCK_INVALID) {
    // 4:2:2 on 4x16 / 16x4 shapes that do not exist: the specification's
    // table gives these
    if (wl == 0 && hl == 3) return BLOCK_4X16;  // unreachable shapes
    return BLOCK_INVALID;
  }
  return b;
}

enum {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
  D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
  PAETH_PRED, UV_CFL_PRED
};
const int MODE_TO_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const uint8_t INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

enum {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
  FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
  V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, WHT_WHT
};
const uint8_t MODE_TO_TXFM[14] = {
    DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const uint8_t INV_SET1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t INV_SET2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t FILTER_TO_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };

int tx_class(int t) {
  if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
  if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}
bool in_set(int set, int t) {
  if (set == TX_SET_DCTONLY) return t == DCT_DCT;
  if (set == TX_SET_INTRA_1)
    return t == IDTX || t == DCT_DCT || t == V_DCT || t == H_DCT ||
           t == ADST_ADST || t == ADST_DCT || t == DCT_ADST;
  return t == IDTX || t == DCT_DCT || t == ADST_ADST || t == ADST_DCT ||
         t == DCT_ADST;
}

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
inline int64_t round2l(int64_t x, int n) { return n ? (x + ((int64_t)1 << (n - 1))) >> n : x; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceil_log2(uint32_t x) { if (x < 2) return 0; int i = 1; uint32_t p = 2; while (p < x) { i++; p <<= 1; } return i; }

// ---- bit reader (headers) -------------------------------------------------
struct Bits {
  const uint8_t *d;
  size_t n;      // bytes
  size_t pos;    // bits
  Bits(const uint8_t *data, size_t size) : d(data), n(size), pos(0) {}
  uint32_t f(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) {
      if ((pos >> 3) >= n) invalid("a header runs past its OBU");
      v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return v;
  }
  int su(int bits) {
    int v = (int)f(bits);
    int sign = 1 << (bits - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t ns(uint32_t nv) {
    int w = floor_log2(nv) + 1;
    uint32_t m = (1u << w) - nv;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!f(1)) {
      lz++;
      if (lz >= 32) invalid("a uvlc code is too long");
    }
    return lz ? f(lz) + (1u << lz) - 1 : 0;
  }
  void byte_align() { pos = (pos + 7) & ~(size_t)7; }
  size_t byte_pos() const { return (pos + 7) >> 3; }
};

// ---- the symbol decoder (dav1d's msac) ------------------------------------
struct Msac {
  const uint8_t *p, *end;
  uint64_t dif;
  uint32_t rng;
  int cnt;
  bool update;
  void refill() {
    int c = 64 - cnt - 24;
    uint64_t d = dif;
    do {
      if (p >= end) break;  // the window keeps ones: zeros past the end
      d ^= (uint64_t)*p++ << c;
      c -= 8;
    } while (c >= 0);
    dif = d;
    cnt = 64 - c - 24;
  }
  void init(const uint8_t *data, size_t sz, bool disable_update) {
    p = data;
    end = data + sz;
    dif = ((uint64_t)1 << 63) - 1;
    rng = 0x8000;
    cnt = -15;
    update = !disable_update;
    refill();
  }
  void norm(uint64_t d, uint32_t r) {
    int s = 15 ^ (31 ^ __builtin_clz(r));
    cnt -= s;
    dif = ((d + 1) << s) - 1;
    rng = r << s;
    if (cnt < 0) refill();
  }
  int bool_f(uint32_t f) {  // f: 32768 - the probability of 0, 15 bits
    uint32_t r = rng;
    uint64_t d = dif;
    uint32_t v = ((r >> 8) * (f >> 6) >> 1) + 4;
    uint64_t vw = (uint64_t)v << 48;
    uint32_t ret = d >= vw;
    d -= ret * vw;
    v += ret * (r - 2 * v);
    norm(d, v);
    return !ret;
  }
  int bit() { return bool_f(16384); }
  uint32_t lit(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }
  uint32_t ns(uint32_t nv) {
    int w = floor_log2(nv) + 1;
    uint32_t m = (1u << w) - nv;
    uint32_t v = lit(w - 1);
    if (v < m) return v;
    return (v << 1) - m + lit(1);
  }
  // cdf: N - 1 values of 32768 - x, 0, counter (the layout of CdfCtx)
  int sym(uint16_t *cdf, int N) {
    uint32_t c = (uint32_t)(dif >> 48), r = rng >> 8;
    uint32_t u, v = rng;
    int val = -1;
    const int n = N - 1;
    do {
      val++;
      u = v;
      v = val < n ? (r * (cdf[val] >> 6) >> 1) + 4 * (n - val) : 0;
    } while (c < v);
    dif -= (uint64_t)v << 48;
    norm(dif, u - v);
    if (update) {
      uint32_t count = cdf[N];
      int rate = 4 + (count >> 4) + (n > 2);
      int i;
      for (i = 0; i < val; i++) cdf[i] += (32768 - cdf[i]) >> rate;
      for (; i < n; i++) cdf[i] -= cdf[i] >> rate;
      cdf[N] = count + (count < 32);
    }
    return val;
  }
};

// ---- CDFs -----------------------------------------------------------------
struct CdfCtx {
  uint16_t kf_y_mode[5][5][14];
  uint16_t uv_cfl_no[13][14];
  uint16_t uv_cfl[13][15];
  uint16_t part8[4][5], part16[4][11], part32[4][11], part64[4][11], part128[4][9];
  uint16_t skip[3][3];
  uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
  uint16_t segment_id[3][9];
  uint16_t tx8[3][3], tx16[3][4], tx32[3][4], tx64[3][4];
  uint16_t filter_intra[22][3], filter_intra_mode[6];
  uint16_t cfl_sign[9], cfl_alpha[6][17];
  uint16_t angle_delta[8][8];
  uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3];
  uint16_t pal_y_size[7][8], pal_uv_size[7][8];
  uint16_t pal_y_color[7][5][9], pal_uv_color[7][5][9];
  uint16_t set1[2][13][8], set2[3][13][6];
  uint16_t lr_switchable[4], lr_wiener[3], lr_sgrproj[3];
  uint16_t txb_skip[5][13][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9],
      eob256[2][2][10], eob512[2][11], eob1024[2][12];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
};

// specification layout (x, .., 32768, 0) -> decoder layout (32768 - x, ..,
// 0, 0)
template <size_t K>
void load(uint16_t *dst, const uint16_t *src) {
  for (size_t i = 0; i < K; i++) dst[i] = src[i];
}
void to_inverse(uint16_t *a, size_t count, int stride) {
  for (size_t k = 0; k < count; k++) {
    uint16_t *c = a + k * stride;
    for (int i = 0; i < stride - 1; i++) c[i] = (uint16_t)(32768 - c[i]);
    c[stride - 1] = 0;
  }
}
#define LOADCDF(dst, src)                                              \
  do {                                                                 \
    static_assert(sizeof(dst) == sizeof(src), "cdf shape");            \
    memcpy(&(dst), &(src), sizeof(dst));                               \
  } while (0)
#define INV(a, n) to_inverse(reinterpret_cast<uint16_t *>(&(a)), sizeof(a) / sizeof(uint16_t) / (n + 1), n + 1)

void init_cdfs(CdfCtx &c, int base_q_idx) {
  LOADCDF(c.kf_y_mode, av1_kf_y_mode_cdf); INV(c.kf_y_mode, 13);
  LOADCDF(c.uv_cfl_no, av1_uv_mode_cfl_not_allowed_cdf); INV(c.uv_cfl_no, 13);
  LOADCDF(c.uv_cfl, av1_uv_mode_cfl_allowed_cdf); INV(c.uv_cfl, 14);
  LOADCDF(c.part8, av1_partition_w8_cdf); INV(c.part8, 4);
  LOADCDF(c.part16, av1_partition_w16_cdf); INV(c.part16, 10);
  LOADCDF(c.part32, av1_partition_w32_cdf); INV(c.part32, 10);
  LOADCDF(c.part64, av1_partition_w64_cdf); INV(c.part64, 10);
  LOADCDF(c.part128, av1_partition_w128_cdf); INV(c.part128, 8);
  LOADCDF(c.skip, av1_skip_cdf); INV(c.skip, 2);
  LOADCDF(c.delta_q, av1_delta_q_cdf); INV(c.delta_q, 4);
  LOADCDF(c.delta_lf, av1_delta_lf_cdf); INV(c.delta_lf, 4);
  for (int i = 0; i < 4; i++) memcpy(c.delta_lf_multi[i], c.delta_lf, sizeof(c.delta_lf));
  LOADCDF(c.segment_id, av1_segment_id_cdf); INV(c.segment_id, 8);
  LOADCDF(c.tx8, av1_tx_8x8_cdf); INV(c.tx8, 2);
  LOADCDF(c.tx16, av1_tx_16x16_cdf); INV(c.tx16, 3);
  LOADCDF(c.tx32, av1_tx_32x32_cdf); INV(c.tx32, 3);
  LOADCDF(c.tx64, av1_tx_64x64_cdf); INV(c.tx64, 3);
  LOADCDF(c.filter_intra, av1_filter_intra_cdf); INV(c.filter_intra, 2);
  LOADCDF(c.filter_intra_mode, av1_filter_intra_mode_cdf); INV(c.filter_intra_mode, 5);
  LOADCDF(c.cfl_sign, av1_cfl_sign_cdf); INV(c.cfl_sign, 8);
  LOADCDF(c.cfl_alpha, av1_cfl_alpha_cdf); INV(c.cfl_alpha, 16);
  LOADCDF(c.angle_delta, av1_angle_delta_cdf); INV(c.angle_delta, 7);
  LOADCDF(c.pal_y_mode, av1_palette_y_mode_cdf); INV(c.pal_y_mode, 2);
  LOADCDF(c.pal_uv_mode, av1_palette_uv_mode_cdf); INV(c.pal_uv_mode, 2);
  LOADCDF(c.pal_y_size, av1_palette_y_size_cdf); INV(c.pal_y_size, 7);
  LOADCDF(c.pal_uv_size, av1_palette_uv_size_cdf); INV(c.pal_uv_size, 7);
  const uint16_t *ycol[7] = {&av1_palette_y_color_2_cdf[0][0], &av1_palette_y_color_3_cdf[0][0],
                             &av1_palette_y_color_4_cdf[0][0], &av1_palette_y_color_5_cdf[0][0],
                             &av1_palette_y_color_6_cdf[0][0], &av1_palette_y_color_7_cdf[0][0],
                             &av1_palette_y_color_8_cdf[0][0]};
  const uint16_t *ucol[7] = {&av1_palette_uv_color_2_cdf[0][0], &av1_palette_uv_color_3_cdf[0][0],
                             &av1_palette_uv_color_4_cdf[0][0], &av1_palette_uv_color_5_cdf[0][0],
                             &av1_palette_uv_color_6_cdf[0][0], &av1_palette_uv_color_7_cdf[0][0],
                             &av1_palette_uv_color_8_cdf[0][0]};
  memset(c.pal_y_color, 0, sizeof(c.pal_y_color));
  memset(c.pal_uv_color, 0, sizeof(c.pal_uv_color));
  for (int n = 2; n <= 8; n++)
    for (int k = 0; k < 5; k++) {
      for (int i = 0; i <= n; i++) {
        c.pal_y_color[n - 2][k][i] = ycol[n - 2][k * (n + 1) + i];
        c.pal_uv_color[n - 2][k][i] = ucol[n - 2][k * (n + 1) + i];
      }
      to_inverse(c.pal_y_color[n - 2][k], 1, n + 1);
      to_inverse(c.pal_uv_color[n - 2][k], 1, n + 1);
    }
  LOADCDF(c.set1, av1_intra_tx_set1_cdf); INV(c.set1, 7);
  LOADCDF(c.set2, av1_intra_tx_set2_cdf); INV(c.set2, 5);
  LOADCDF(c.lr_switchable, av1_restoration_switchable_cdf); INV(c.lr_switchable, 3);
  LOADCDF(c.lr_wiener, av1_restoration_wiener_cdf); INV(c.lr_wiener, 2);
  LOADCDF(c.lr_sgrproj, av1_restoration_sgrproj_cdf); INV(c.lr_sgrproj, 2);
  int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
  LOADCDF(c.txb_skip, av1_txb_skip_cdf[q]); INV(c.txb_skip, 2);
  LOADCDF(c.eob16, av1_eob_pt_16_cdf[q]); INV(c.eob16, 5);
  LOADCDF(c.eob32, av1_eob_pt_32_cdf[q]); INV(c.eob32, 6);
  LOADCDF(c.eob64, av1_eob_pt_64_cdf[q]); INV(c.eob64, 7);
  LOADCDF(c.eob128, av1_eob_pt_128_cdf[q]); INV(c.eob128, 8);
  LOADCDF(c.eob256, av1_eob_pt_256_cdf[q]); INV(c.eob256, 9);
  LOADCDF(c.eob512, av1_eob_pt_512_cdf[q]); INV(c.eob512, 10);
  LOADCDF(c.eob1024, av1_eob_pt_1024_cdf[q]); INV(c.eob1024, 11);
  LOADCDF(c.eob_extra, av1_eob_extra_cdf[q]); INV(c.eob_extra, 2);
  LOADCDF(c.dc_sign, av1_dc_sign_cdf[q]); INV(c.dc_sign, 2);
  LOADCDF(c.base_eob, av1_coeff_base_eob_cdf[q]); INV(c.base_eob, 3);
  LOADCDF(c.base, av1_coeff_base_cdf[q]); INV(c.base, 4);
  LOADCDF(c.br, av1_coeff_br_cdf[q]); INV(c.br, 4);
}

// ---- inverse transforms ---------------------------------------------------
inline int32_t clip16(int64_t v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : (int32_t)v; }
inline int32_t rnd12(int64_t v) { return (int32_t)((v + 2048) >> 12); }
inline int cosv(int a) { return a == 64 ? 0 : av1_cospi[a]; }
int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

// DCT of size n on t[0..n) in bit-reversed input order, output natural
void idct_rec(int32_t *t, int n) {
  if (n == 2) {
    int32_t a = t[0], b = t[1];
    t[0] = rnd12((int64_t)(a + b) * cosv(32));
    t[1] = rnd12((int64_t)(a - b) * cosv(32));
    return;
  }
  const int M = n / 2, b0 = M, lg = floor_log2(n);
  idct_rec(t, M);
  // first rotations of the odd half
  for (int p = 0; p < M / 2; p++) {
    int k = brev(lg, M + p);
    int a = 64 - (64 / n) * k;
    int32_t x = t[b0 + p], y = t[n - 1 - p];
    t[b0 + p] = rnd12((int64_t)x * cosv(a) - (int64_t)y * cosv(64 - a));
    t[n - 1 - p] = rnd12((int64_t)x * cosv(64 - a) + (int64_t)y * cosv(a));
  }
  const int m = floor_log2(M);
  for (int L = 1; L <= m - 1; L++) {
    const int G = 1 << L;
    for (int g = 0; g < M / G; g++) {
      int s = b0 + g * G;
      for (int j = 0; j < G / 2; j++) {
        int32_t x = t[s + j], y = t[s + G - 1 - j];
        if (g & 1) {
          t[s + j] = clip16((int64_t)y - x);
          t[s + G - 1 - j] = clip16((int64_t)x + y);
        } else {
          t[s + j] = clip16((int64_t)x + y);
          t[s + G - 1 - j] = clip16((int64_t)x - y);
        }
      }
    }
    if (L + 1 < m) {
      const int ngroups = M / (4 * G);
      const int base = (64 / M) * G;
      const int lgn = floor_log2(ngroups);
      for (int g = 0; g < ngroups; g++) {
        int th = base + (64 / ngroups) * brev(lgn, g);
        int s = b0 + g * 2 * G;
        for (int q = 0; q < G; q++) {
          int e = s + G / 2 + q, e2 = 2 * b0 + M - 1 - e;
          int32_t lo = t[e], hi = t[e2];
          if (q < G / 2) {  // type A
            t[e] = rnd12(-(int64_t)lo * cosv(th) + (int64_t)hi * cosv(64 - th));
            t[e2] = rnd12((int64_t)lo * cosv(64 - th) + (int64_t)hi * cosv(th));
          } else {  // type B
            t[e] = rnd12(-(int64_t)lo * cosv(64 - th) - (int64_t)hi * cosv(th));
            t[e2] = rnd12(-(int64_t)lo * cosv(th) + (int64_t)hi * cosv(64 - th));
          }
        }
      }
    }
  }
  if (m >= 2) {
    for (int e = b0 + M / 4; e < b0 + M / 2; e++) {
      int e2 = 2 * b0 + M - 1 - e;
      int32_t lo = t[e], hi = t[e2];
      t[e] = rnd12((int64_t)(hi - lo) * cosv(32));
      t[e2] = rnd12((int64_t)(lo + hi) * cosv(32));
    }
  }
  for (int i = 0; i < M; i++) {
    int32_t a = t[i], c = t[n - 1 - i];
    t[i] = clip16((int64_t)a + c);
    t[n - 1 - i] = clip16((int64_t)a - c);
  }
}

void idct(int32_t *io, int n) {
  int32_t t[64];
  int lg = floor_log2(n);
  for (int i = 0; i < n; i++) t[i] = io[brev(lg, i)];
  idct_rec(t, n);
  memcpy(io, t, n * sizeof(int32_t));
}

void iadst4(int32_t *io) {
  const int32_t *sp = av1_sinpi;
  int64_t x0 = io[0], x1 = io[1], x2 = io[2], x3 = io[3];
  int64_t s0 = sp[1] * x0, s1 = sp[2] * x0, s2 = sp[3] * x1, s3 = sp[4] * x2;
  int64_t s4 = sp[1] * x2, s5 = sp[2] * x3, s6 = sp[4] * x3;
  int64_t s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = sp[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t o0 = s0 + s3, o1 = s1 + s3, o2 = s2, o3 = s0 + s1;
  o3 = o3 - s3;
  io[0] = rnd12(o0);
  io[1] = rnd12(o1);
  io[2] = rnd12(o2);
  io[3] = rnd12(o3);
}

inline int32_t hbtf(int w0, int32_t a, int w1, int32_t b) {
  return rnd12((int64_t)w0 * a + (int64_t)w1 * b);
}

// libaom's av1_iadst8 / av1_iadst16
void iadst8(int32_t *io) {
  const int *c = av1_cospi;
  int32_t b[8], t[8];
  b[0] = io[7]; b[1] = io[0]; b[2] = io[5]; b[3] = io[2];
  b[4] = io[3]; b[5] = io[4]; b[6] = io[1]; b[7] = io[6];
  for (int i = 0; i < 4; i++) {
    int a = 4 + 16 * i;
    t[2 * i] = hbtf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
    t[2 * i + 1] = hbtf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
  }
  for (int i = 0; i < 4; i++) {
    b[i] = clip16((int64_t)t[i] + t[i + 4]);
    b[i + 4] = clip16((int64_t)t[i] - t[i + 4]);
  }
  t[0] = b[0]; t[1] = b[1]; t[2] = b[2]; t[3] = b[3];
  t[4] = hbtf(c[16], b[4], c[48], b[5]);
  t[5] = hbtf(c[48], b[4], -c[16], b[5]);
  t[6] = hbtf(-c[48], b[6], c[16], b[7]);
  t[7] = hbtf(c[16], b[6], c[48], b[7]);
  b[0] = clip16((int64_t)t[0] + t[2]); b[1] = clip16((int64_t)t[1] + t[3]);
  b[2] = clip16((int64_t)t[0] - t[2]); b[3] = clip16((int64_t)t[1] - t[3]);
  b[4] = clip16((int64_t)t[4] + t[6]); b[5] = clip16((int64_t)t[5] + t[7]);
  b[6] = clip16((int64_t)t[4] - t[6]); b[7] = clip16((int64_t)t[5] - t[7]);
  t[0] = b[0]; t[1] = b[1];
  t[2] = hbtf(c[32], b[2], c[32], b[3]);
  t[3] = hbtf(c[32], b[2], -c[32], b[3]);
  t[4] = b[4]; t[5] = b[5];
  t[6] = hbtf(c[32], b[6], c[32], b[7]);
  t[7] = hbtf(c[32], b[6], -c[32], b[7]);
  io[0] = t[0]; io[1] = -t[4]; io[2] = t[6]; io[3] = -t[2];
  io[4] = t[3]; io[5] = -t[7]; io[6] = t[5]; io[7] = -t[1];
}

void iadst16(int32_t *io) {
  const int *c = av1_cospi;
  int32_t b[16], t[16];
  static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
  for (int i = 0; i < 16; i++) b[i] = io[perm[i]];
  for (int i = 0; i < 8; i++) {
    int a = 2 + 8 * i;
    t[2 * i] = hbtf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
    t[2 * i + 1] = hbtf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
  }
  for (int i = 0; i < 8; i++) {
    b[i] = clip16((int64_t)t[i] + t[i + 8]);
    b[i + 8] = clip16((int64_t)t[i] - t[i + 8]);
  }
  for (int i = 0; i < 8; i++) t[i] = b[i];
  t[8] = hbtf(c[8], b[8], c[56], b[9]);
  t[9] = hbtf(c[56], b[8], -c[8], b[9]);
  t[10] = hbtf(c[40], b[10], c[24], b[11]);
  t[11] = hbtf(c[24], b[10], -c[40], b[11]);
  t[12] = hbtf(-c[56], b[12], c[8], b[13]);
  t[13] = hbtf(c[8], b[12], c[56], b[13]);
  t[14] = hbtf(-c[24], b[14], c[40], b[15]);
  t[15] = hbtf(c[40], b[14], c[24], b[15]);
  for (int h = 0; h < 16; h += 8)
    for (int i = 0; i < 4; i++) {
      b[h + i] = clip16((int64_t)t[h + i] + t[h + i + 4]);
      b[h + i + 4] = clip16((int64_t)t[h + i] - t[h + i + 4]);
    }
  for (int h = 0; h < 16; h += 8) {
    t[h + 0] = b[h + 0]; t[h + 1] = b[h + 1]; t[h + 2] = b[h + 2]; t[h + 3] = b[h + 3];
    t[h + 4] = hbtf(c[16], b[h + 4], c[48], b[h + 5]);
    t[h + 5] = hbtf(c[48], b[h + 4], -c[16], b[h + 5]);
    t[h + 6] = hbtf(-c[48], b[h + 6], c[16], b[h + 7]);
    t[h + 7] = hbtf(c[16], b[h + 6], c[48], b[h + 7]);
  }
  for (int h = 0; h < 16; h += 4) {
    b[h + 0] = clip16((int64_t)t[h + 0] + t[h + 2]);
    b[h + 1] = clip16((int64_t)t[h + 1] + t[h + 3]);
    b[h + 2] = clip16((int64_t)t[h + 0] - t[h + 2]);
    b[h + 3] = clip16((int64_t)t[h + 1] - t[h + 3]);
  }
  for (int h = 0; h < 16; h += 4) {
    t[h + 0] = b[h + 0]; t[h + 1] = b[h + 1];
    t[h + 2] = hbtf(c[32], b[h + 2], c[32], b[h + 3]);
    t[h + 3] = hbtf(c[32], b[h + 2], -c[32], b[h + 3]);
  }
  static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; i++) io[i] = (i & 1) ? -t[out[i]] : t[out[i]];
}

void iidentity(int32_t *io, int n) {
  for (int i = 0; i < n; i++) {
    int64_t x = io[i];
    if (n == 4) io[i] = (int32_t)round2l(x * 5793, 12);
    else if (n == 8) io[i] = (int32_t)(x * 2);
    else if (n == 16) io[i] = (int32_t)round2l(x * 11586, 12);
    else io[i] = (int32_t)(x * 4);
  }
}

enum { T_DCT, T_ADST, T_FLIPADST, T_IDTX };
void tx_types_1d(int t, int &col, int &row) {
  switch (t) {
    case DCT_DCT: col = T_DCT; row = T_DCT; break;
    case ADST_DCT: col = T_ADST; row = T_DCT; break;
    case DCT_ADST: col = T_DCT; row = T_ADST; break;
    case ADST_ADST: col = T_ADST; row = T_ADST; break;
    case FLIPADST_DCT: col = T_FLIPADST; row = T_DCT; break;
    case DCT_FLIPADST: col = T_DCT; row = T_FLIPADST; break;
    case FLIPADST_FLIPADST: col = T_FLIPADST; row = T_FLIPADST; break;
    case ADST_FLIPADST: col = T_ADST; row = T_FLIPADST; break;
    case FLIPADST_ADST: col = T_FLIPADST; row = T_ADST; break;
    case IDTX: col = T_IDTX; row = T_IDTX; break;
    case V_DCT: col = T_DCT; row = T_IDTX; break;
    case H_DCT: col = T_IDTX; row = T_DCT; break;
    case V_ADST: col = T_ADST; row = T_IDTX; break;
    case H_ADST: col = T_IDTX; row = T_ADST; break;
    case V_FLIPADST: col = T_FLIPADST; row = T_IDTX; break;
    default: col = T_IDTX; row = T_FLIPADST; break;
  }
}
void tx1d(int kind, int32_t *io, int n) {
  if (kind == T_DCT) idct(io, n);
  else if (kind == T_IDTX) iidentity(io, n);
  else {
    if (n == 4) iadst4(io);
    else if (n == 8) iadst8(io);
    else iadst16(io);
    if (kind == T_FLIPADST) std::reverse(io, io + n);
  }
}

const uint8_t ROW_SHIFT[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

// coef: row-major, width min(w, 32), rows min(h, 32); dst: the prediction
void inverse_transform_add(const int32_t *coef, int txSz, int txType,
                           bool lossless, uint8_t *dst, int stride) {
  const int wl = TXWL[txSz], hl = TXHL[txSz];
  const int w = 1 << wl, h = 1 << hl;
  const int cw = std::min(w, 32), ch = std::min(h, 32);
  static thread_local int32_t res[64 * 64];
  if (lossless) {  // Walsh-Hadamard, 4x4 only
    int32_t t[16];
    for (int i = 0; i < 4; i++) {
      int32_t a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2;
      int32_t d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
      a += c; d -= b;
      int32_t e = (a - d) >> 1;
      b = e - b; c = e - c; a -= b; d += c;
      t[i * 4 + 0] = a; t[i * 4 + 1] = b; t[i * 4 + 2] = c; t[i * 4 + 3] = d;
    }
    for (int j = 0; j < 4; j++) {
      int32_t a = t[0 * 4 + j], c = t[1 * 4 + j], d = t[2 * 4 + j], b = t[3 * 4 + j];
      a += c; d -= b;
      int32_t e = (a - d) >> 1;
      b = e - b; c = e - c; a -= b; d += c;
      int32_t o[4] = {a, b, c, d};
      for (int i = 0; i < 4; i++) dst[i * stride + j] = clip1(dst[i * stride + j] + o[i]);
    }
    return;
  }
  int colk, rowk;
  tx_types_1d(txType, colk, rowk);
  const int rs = ROW_SHIFT[txSz];
  const bool rect2 = std::abs(wl - hl) == 1;
  int32_t T[64];
  for (int i = 0; i < h; i++) {
    bool any = false;
    if (i < ch)
      for (int j = 0; j < cw; j++) any |= coef[i * cw + j] != 0;
    if (!any) {
      memset(res + i * w, 0, w * sizeof(int32_t));
      continue;
    }
    for (int j = 0; j < w; j++) {
      int32_t v = j < cw ? coef[i * cw + j] : 0;
      if (rect2) v = rnd12((int64_t)v * 2896);
      T[j] = v;
    }
    tx1d(rowk, T, w);
    for (int j = 0; j < w; j++) res[i * w + j] = clip16(round2l(T[j], rs));
  }
  for (int j = 0; j < w; j++) {
    for (int i = 0; i < h; i++) T[i] = res[i * w + j];
    tx1d(colk, T, h);
    for (int i = 0; i < h; i++)
      dst[i * stride + j] = clip1(dst[i * stride + j] + (int)round2l(T[i], 4));
  }
}

// ---- headers ----------------------------------------------------------------
struct SeqHdr {
  int profile = 0, still = 0, reduced = 0;
  int fw_bits = 0, fh_bits = 0, max_w = 0, max_h = 0;
  int sb128 = 0, filter_intra = 0, edge_filter = 0;
  int superres = 0, cdef = 0, restoration = 0;
  int bitdepth = 8, mono = 0, color_desc = 0, cp = 2, tc = 2, mc = 2, range = 0;
  int sx = 1, sy = 1, csp = 0, sep_uv_dq = 0, film_grain = 0;
  // a full header's: timing info, decoder model, operating points, frame
  // ids, inter tools, screen content and integer motion vector choices (2:
  // chosen per frame), order hint bits
  int timing = 0, units_in_tick = 0, time_scale = 0, equal_interval = 0, ticks_per_picture = 0;
  int decoder_model = 0, buffer_delay_len = 0, units_in_decoding_tick = 0;
  int removal_len = 0, frame_pres_len = 0, display_model = 0, n_ops = 0;
  // per operating point: idc, level, tier, decoder and display model
  // present, initial display delay
  int op_idc[32] = {}, op_level[32] = {}, op_tier[32] = {}, op_dm[32] = {};
  int op_disp[32] = {}, op_delay[32] = {};
  int frame_ids = 0, delta_id_len = 0, id_len = 0, inter_tools = 0, order_hint = 0;
  int order_hint_tools = 0, force_sct = 2, force_int_mv = 2, order_hint_bits = 0;
  int seen = 0;
};

// Two sequence headers are one sequence when all they hold but each
// operating point's decoder model parameters (its buffer delays, which
// parse_seq does not keep) is equal, as dav1d compares them.
bool same_sequence(const SeqHdr &a, const SeqHdr &b) {
  static_assert(sizeof(SeqHdr) % sizeof(int) == 0, "SeqHdr holds ints only");
  return memcmp(&a, &b, sizeof(SeqHdr)) == 0;
}

void parse_seq(Bits &b, SeqHdr &s) {
  s.profile = b.f(3);
  if (s.profile > 2) invalid("sequence header: profile above 2");
  s.still = b.f(1);
  s.reduced = b.f(1);
  if (s.reduced && !s.still) invalid("sequence header: a reduced header on a moving picture");
  if (s.reduced) {
    s.n_ops = 1;
    s.op_level[0] = b.f(5);
    s.op_delay[0] = 10;
  } else {
    s.timing = b.f(1);
    if (s.timing) {
      s.units_in_tick = b.f(32);
      s.time_scale = b.f(32);
      s.equal_interval = b.f(1);
      if (s.equal_interval) s.ticks_per_picture = b.uvlc();
      s.decoder_model = b.f(1);
      if (s.decoder_model) {
        s.buffer_delay_len = b.f(5) + 1;
        s.units_in_decoding_tick = b.f(32);
        s.removal_len = b.f(5) + 1;
        s.frame_pres_len = b.f(5) + 1;
      }
    }
    s.display_model = b.f(1);
    s.n_ops = b.f(5) + 1;
    for (int i = 0; i < s.n_ops; i++) {
      s.op_idc[i] = b.f(12);
      s.op_level[i] = b.f(5);
      if (s.op_level[i] > 7) s.op_tier[i] = b.f(1);
      if (s.decoder_model) s.op_dm[i] = b.f(1);
      if (s.op_dm[i]) {  // decoder and encoder buffer delays, low delay mode
        b.f(s.buffer_delay_len);
        b.f(s.buffer_delay_len);
        b.f(1);
      }
      if (s.display_model) s.op_disp[i] = b.f(1);
      s.op_delay[i] = s.op_disp[i] ? (int)b.f(4) + 1 : 10;
    }
  }
  s.fw_bits = b.f(4) + 1;
  s.fh_bits = b.f(4) + 1;
  s.max_w = b.f(s.fw_bits) + 1;
  s.max_h = b.f(s.fh_bits) + 1;
  if (!s.reduced) {
    s.frame_ids = b.f(1);
    if (s.frame_ids) {
      s.delta_id_len = b.f(4) + 2;
      s.id_len = b.f(3) + s.delta_id_len + 1;
    }
  }
  s.sb128 = b.f(1);
  s.filter_intra = b.f(1);
  s.edge_filter = b.f(1);
  if (!s.reduced) {
    s.inter_tools = b.f(4);  // interintra, masked compound, warped motion, dual filter
    s.order_hint = b.f(1);
    if (s.order_hint) s.order_hint_tools = b.f(2);  // jnt_comp, ref_frame_mvs
    s.force_sct = b.f(1) ? 2 : (int)b.f(1);
    if (s.force_sct > 0) s.force_int_mv = b.f(1) ? 2 : (int)b.f(1);
    if (s.order_hint) s.order_hint_bits = b.f(3) + 1;
  }
  s.superres = b.f(1);
  s.cdef = b.f(1);
  s.restoration = b.f(1);
  // color_config
  int high = b.f(1);
  if (s.profile == 2 && high) s.bitdepth = b.f(1) ? 12 : 10;
  else s.bitdepth = high ? 10 : 8;
  s.mono = s.profile == 1 ? 0 : b.f(1);
  s.color_desc = b.f(1);
  if (s.color_desc) {
    s.cp = b.f(8);
    s.tc = b.f(8);
    s.mc = b.f(8);
  } else {
    s.cp = s.tc = s.mc = 2;
  }
  if (s.mono) {
    s.range = b.f(1);
    s.sx = s.sy = 1;
    s.sep_uv_dq = 0;
  } else {
    if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
      s.range = 1;
      s.sx = s.sy = 0;
    } else {
      s.range = b.f(1);
      if (s.profile == 0) s.sx = s.sy = 1;
      else if (s.profile == 1) s.sx = s.sy = 0;
      else if (s.bitdepth == 12) {
        s.sx = b.f(1);
        s.sy = s.sx ? b.f(1) : 0;
      } else {
        s.sx = 1;
        s.sy = 0;
      }
      if (s.sx && s.sy) s.csp = b.f(2);
    }
    s.sep_uv_dq = b.f(1);
  }
  s.film_grain = b.f(1);
  if (s.profile == 1 && (s.sx || s.sy)) invalid("sequence header: profile 1 is 4:4:4");
  if (s.profile == 0 && !(s.mono || (s.sx && s.sy))) invalid("sequence header: profile 0 is 4:2:0");
  s.seen = 1;
}

struct FrameHdr {
  int disable_cdf_update = 0, allow_sct = 0;
  int width = 0, height = 0, mi_cols = 0, mi_rows = 0;
  int allow_intrabc = 0, use_superres = 0;
  // tiles
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int mi_col_starts[65], mi_row_starts[65];
  int tile_size_bytes = 4, context_update_tile_id = 0;
  // quantization
  int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
  int using_qmatrix = 0;
  // deltas
  int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0;
  int delta_lf_multi = 0, uniform_tiles = 1;
  // segmentation: features per segment (SEG_LVL_ALT_Q .. SEG_LVL_GLOBALMV)
  int seg_enabled = 0, seg_id_pre_skip = 0, last_active_seg_id = -1;
  int seg_feature_enabled[8][8] = {}, seg_feature_data[8][8] = {};
  int lossless_seg[8] = {};
  int coded_lossless = 0;
  // loop filter
  int lf_level[4] = {0, 0, 0, 0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
  // cdef
  int cdef_bits = 0, cdef_nonzero = 0;
  // loop restoration
  int lr_type[3] = {0, 0, 0}, lr_size[3] = {256, 256, 256}, uses_lr = 0;
  int tx_mode_select = 0, reduced_tx_set = 0;
};

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

int read_delta_q(Bits &b) { return b.f(1) ? b.su(7) : 0; }

// tid, sid: the temporal and spatial layer of the frame's OBU
void parse_frame_header(Bits &b, const SeqHdr &s, FrameHdr &f, int tid, int sid) {
  if (s.bitdepth != 8) refuse(std::to_string(s.bitdepth) + "-bit samples");
  // operating point 0 is decoded: all its layers
  if (s.op_idc[0] != 0)
    refuse("a scalable stream (operating_point_idc " + std::to_string(s.op_idc[0]) + ")");
  // a reduced still-picture header: a key frame, shown, error resilient;
  // screen content tools and integer motion vectors chosen per frame, no
  // frame ids, no order hints, no decoder model
  int size_override = 0;
  if (!s.reduced) {
    // the first frame of an item: no frame has been decoded to show
    if (b.f(1)) invalid("a frame header that shows an existing frame, before any frame");
    const int frame_type = b.f(2);
    const int show = b.f(1);
    if (show && s.decoder_model && !s.equal_interval) b.f(s.frame_pres_len);  // temporal_point_info
    if (frame_type != 0 || !show) refuse("frames other than shown key frames");
    // a shown key frame is error resilient and refreshes every slot
  }
  f.disable_cdf_update = b.f(1);
  f.allow_sct = s.force_sct == 2 ? (int)b.f(1) : s.force_sct;
  if (f.allow_sct && s.force_int_mv == 2) b.f(1);  // force_integer_mv
  if (!s.reduced) {
    if (s.frame_ids) b.f(s.id_len);  // current_frame_id
    size_override = b.f(1);
    b.f(s.order_hint_bits);  // order_hint
    if (s.decoder_model && b.f(1)) {  // buffer_removal_time_present_flag
      for (int i = 0; i < s.n_ops; i++) {
        const int idc = s.op_idc[i];
        if (s.op_dm[i] && (!idc || (((idc >> tid) & 1) && ((idc >> (sid + 8)) & 1))))
          b.f(s.removal_len);  // buffer_removal_time
      }
    }
  }
  f.width = s.max_w;
  f.height = s.max_h;
  if (size_override) {
    f.width = b.f(s.fw_bits) + 1;
    f.height = b.f(s.fh_bits) + 1;
  }
  if (s.superres) f.use_superres = b.f(1);
  if (f.use_superres) refuse("superres");
  f.mi_cols = 2 * ((f.width + 7) >> 3);
  f.mi_rows = 2 * ((f.height + 7) >> 3);
  if (b.f(1)) {  // render size
    b.f(16);
    b.f(16);
  }
  if (f.allow_sct) f.allow_intrabc = b.f(1);
  if (f.allow_intrabc) refuse("intra block copy (allow_intrabc)");
  // disable_frame_end_update_cdf: one frame, nothing to update
  if (!s.reduced && !f.disable_cdf_update) b.f(1);
  // tile_info
  const int sb_cols = s.sb128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
  const int sb_rows = s.sb128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
  const int sb_shift = s.sb128 ? 5 : 4;
  const int sb_size = sb_shift + 2;
  const int max_tile_w_sb = 4096 >> sb_size;
  const int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  const int min_log2_cols = tile_log2(max_tile_w_sb, sb_cols);
  const int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
  const int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
  const int min_log2_tiles = std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  f.uniform_tiles = b.f(1);
  if (f.uniform_tiles) {
    f.tile_cols_log2 = min_log2_cols;
    while (f.tile_cols_log2 < max_log2_cols) {
      if (b.f(1)) f.tile_cols_log2++;
      else break;
    }
    int tw = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
    int i = 0;
    for (int st = 0; st < sb_cols; st += tw) f.mi_col_starts[i++] = st << sb_shift;
    f.mi_col_starts[i] = f.mi_cols;
    f.tile_cols = i;
    int min_log2_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
    f.tile_rows_log2 = min_log2_rows;
    while (f.tile_rows_log2 < max_log2_rows) {
      if (b.f(1)) f.tile_rows_log2++;
      else break;
    }
    int th = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
    i = 0;
    for (int st = 0; st < sb_rows; st += th) f.mi_row_starts[i++] = st << sb_shift;
    f.mi_row_starts[i] = f.mi_rows;
    f.tile_rows = i;
  } else {
    int widest = 0, i = 0;
    for (int st = 0; st < sb_cols; i++) {
      if (i >= 64) invalid("more than 64 tile columns");
      f.mi_col_starts[i] = st << sb_shift;
      int size = (int)b.ns((uint32_t)std::min(sb_cols - st, max_tile_w_sb)) + 1;
      widest = std::max(widest, size);
      st += size;
    }
    f.mi_col_starts[i] = f.mi_cols;
    f.tile_cols = i;
    f.tile_cols_log2 = tile_log2(1, f.tile_cols);
    int max_area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                      : sb_rows * sb_cols;
    int max_h = std::max(max_area / widest, 1);
    i = 0;
    for (int st = 0; st < sb_rows; i++) {
      if (i >= 64) invalid("more than 64 tile rows");
      f.mi_row_starts[i] = st << sb_shift;
      st += (int)b.ns((uint32_t)std::min(sb_rows - st, max_h)) + 1;
    }
    f.mi_row_starts[i] = f.mi_rows;
    f.tile_rows = i;
    f.tile_rows_log2 = tile_log2(1, f.tile_rows);
  }
  if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
    f.context_update_tile_id = b.f(f.tile_rows_log2 + f.tile_cols_log2);
    f.tile_size_bytes = b.f(2) + 1;
    if (f.context_update_tile_id >= f.tile_cols * f.tile_rows) invalid("context_update_tile_id out of range");
  }
  // quantization_params
  f.base_q_idx = b.f(8);
  f.dq_y_dc = read_delta_q(b);
  if (!s.mono) {
    int diff = s.sep_uv_dq ? b.f(1) : 0;
    f.dq_u_dc = read_delta_q(b);
    f.dq_u_ac = read_delta_q(b);
    if (diff) {
      f.dq_v_dc = read_delta_q(b);
      f.dq_v_ac = read_delta_q(b);
    } else {
      f.dq_v_dc = f.dq_u_dc;
      f.dq_v_ac = f.dq_u_ac;
    }
  }
  f.using_qmatrix = b.f(1);
  if (f.using_qmatrix) refuse("quantizer matrices (using_qmatrix)");
  // segmentation_params (an intra frame updates the map and the data)
  f.seg_enabled = b.f(1);
  if (f.seg_enabled) {
    static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
    static const int sgn[8] = {1, 1, 1, 1, 1, 0, 0, 0};
    static const int lim[8] = {255, 63, 63, 63, 63, 7, 0, 0};
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int on = b.f(1), v = 0;
        if (on) {
          if (sgn[j]) v = clip3(-lim[j], lim[j], b.su(1 + bits[j]));
          else v = clip3(0, lim[j], (int)b.f(bits[j]));
          f.last_active_seg_id = i;
          if (j >= 5) f.seg_id_pre_skip = 1;
        }
        f.seg_feature_enabled[i][j] = on;
        f.seg_feature_data[i][j] = v;
      }
    // no segment active: dav1d's segment ids then index past its table
    if (f.last_active_seg_id < 0) refuse("segmentation with no feature enabled");
  }
  // delta q / lf
  f.delta_q_present = f.base_q_idx > 0 ? b.f(1) : 0;
  if (f.delta_q_present) f.delta_q_res = b.f(2);
  if (f.delta_q_present) {
    f.delta_lf_present = b.f(1);
    if (f.delta_lf_present) {
      f.delta_lf_res = b.f(2);
      f.delta_lf_multi = b.f(1);
    }
  }
  f.coded_lossless = 1;
  for (int i = 0; i < 8; i++) {
    int q = f.base_q_idx;
    if (f.seg_enabled && f.seg_feature_enabled[i][0]) q = clip3(0, 255, q + f.seg_feature_data[i][0]);
    f.lossless_seg[i] = q == 0 && f.dq_y_dc == 0 && f.dq_u_ac == 0 && f.dq_u_dc == 0 &&
                        f.dq_v_ac == 0 && f.dq_v_dc == 0;
    if (!f.lossless_seg[i]) f.coded_lossless = 0;
  }
  // loop_filter_params
  if (!f.coded_lossless) {
    f.lf_level[0] = b.f(6);
    f.lf_level[1] = b.f(6);
    if (!s.mono && (f.lf_level[0] || f.lf_level[1])) {
      f.lf_level[2] = b.f(6);
      f.lf_level[3] = b.f(6);
    }
    f.lf_sharpness = b.f(3);
    f.lf_delta_enabled = b.f(1);
    if (f.lf_delta_enabled) {
      if (b.f(1)) {
        for (int i = 0; i < 8; i++)
          if (b.f(1)) f.lf_ref_deltas[i] = b.su(7);
        for (int i = 0; i < 2; i++)
          if (b.f(1)) f.lf_mode_deltas[i] = b.su(7);
      }
    }
  }
  // cdef_params
  if (!f.coded_lossless && s.cdef) {
    b.f(2);
    f.cdef_bits = b.f(2);
    for (int i = 0; i < (1 << f.cdef_bits); i++) {
      int yp = b.f(4), ys = b.f(2);
      int up = 0, us = 0;
      if (!s.mono) {
        up = b.f(4);
        us = b.f(2);
      }
      if (yp || ys || up || us) f.cdef_nonzero = 1;
    }
    if (f.cdef_nonzero) refuse("CDEF with a nonzero strength");
  }
  // lr_params
  if (!f.coded_lossless && s.restoration) {
    static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
    int uses_chroma = 0;
    int np = s.mono ? 1 : 3;
    for (int i = 0; i < np; i++) {
      f.lr_type[i] = remap[b.f(2)];
      if (f.lr_type[i] != RESTORE_NONE) {
        f.uses_lr = 1;
        if (i > 0) uses_chroma = 1;
      }
    }
    if (f.uses_lr) {
      int shift;
      if (s.sb128) {
        shift = b.f(1) + 1;
      } else {
        shift = b.f(1);
        if (shift) shift += b.f(1);
      }
      f.lr_size[0] = 256 >> (2 - shift);
      int uv_shift = (s.sx && s.sy && uses_chroma) ? b.f(1) : 0;
      f.lr_size[1] = f.lr_size[2] = f.lr_size[0] >> uv_shift;
    }
  }
  // tx mode
  f.tx_mode_select = f.coded_lossless ? 0 : b.f(1);
  // frame_reference_mode, skip_mode, warped motion: nothing in an intra frame
  f.reduced_tx_set = b.f(1);
  // global motion: nothing in an intra frame; film grain
  if (s.film_grain && b.f(1)) refuse("film grain");
}

// ---- the decoder ------------------------------------------------------------
struct BlockInfo {
  uint8_t size, ymode, uvmode, skip, tx, pal_y, pal_uv;
  uint8_t colors_y[8], colors_u[8];
  uint8_t seg;
  int8_t delta_lf[4];
};

struct Plane {
  std::vector<uint8_t> buf;
  int stride = 0, w = 0, h = 0;  // allocated
  uint8_t *at(int x, int y) { return &buf[(size_t)y * stride + x]; }
};

struct Decoder {
  SeqHdr s;
  FrameHdr f;
  uint64_t *counts;
  int np = 3, sx = 1, sy = 1;
  Plane pl[3];
  std::vector<int32_t> mi_block;  // per 4x4 luma: index into blocks
  std::vector<BlockInfo> blocks;
  int mi_stride = 0;
  std::vector<uint8_t> lf_tx[3];  // per 4x4 of each plane
  int lf_stride[3] = {0, 0, 0};
  // contexts
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  // loop restoration units
  std::vector<uint8_t> lr_unit_type[3];
  std::vector<int16_t> lr_unit_coef[3];  // wiener: 2x3 per unit; sgr: set, xqd0, xqd1
  int lr_rows[3] = {0, 0, 0}, lr_cols[3] = {0, 0, 0};
  CdfCtx frame_cdf;

  // tile state
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  Msac ms;
  CdfCtx cdf;
  int cur_q;
  int delta_lf[4], segment_id;
  int read_deltas;
  int ref_lr_wiener[3][2][3];
  int ref_sgr_xqd[3][2];
  uint8_t block_decoded[3][35][35];  // [y + 1][x + 1]

  // block state
  int mi_row, mi_col, mi_size, bw4, bh4, has_chroma;
  bool avail_u, avail_l, avail_uc, avail_lc;
  int skip, ymode, uvmode, angle_y, angle_uv, use_filter_intra, filter_mode;
  int cfl_u, cfl_v, pal_y, pal_uv, tx_size, lossless;
  uint8_t colors_y[8], colors_u[8], colors_v[8];
  uint8_t color_map_y[64 * 64], color_map_uv[64 * 64];
  int max_luma_w, max_luma_h;
  int32_t quant[32 * 32];

  BlockInfo *info_at(int r, int c) { return &blocks[mi_block[(size_t)r * mi_stride + c]]; }
  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }
  void count(int c, uint64_t n = 1) { counts[c] += n; }

  void alloc() {
    np = s.mono ? 1 : 3;
    sx = s.sx;
    sy = s.sy;
    const int aw = ((f.mi_cols * 4 + 127) & ~127) + 160;
    const int ah = ((f.mi_rows * 4 + 127) & ~127) + 160;
    for (int p = 0; p < np; p++) {
      int ssx = p ? sx : 0, ssy = p ? sy : 0;
      pl[p].stride = aw >> ssx;
      pl[p].w = aw >> ssx;
      pl[p].h = ah >> ssy;
      pl[p].buf.assign((size_t)pl[p].stride * pl[p].h, 0);
      lf_stride[p] = (aw >> ssx) / 4;
      lf_tx[p].assign((size_t)lf_stride[p] * ((ah >> ssy) / 4), 0);
      above_level[p].assign(aw / 4 + 64, 0);
      above_dc[p].assign(aw / 4 + 64, 0);
      left_level[p].assign(ah / 4 + 64, 0);
      left_dc[p].assign(ah / 4 + 64, 0);
    }
    mi_stride = f.mi_cols + 32;
    mi_block.assign((size_t)mi_stride * (f.mi_rows + 32), 0);
    blocks.clear();
    blocks.reserve(1024);
    for (int p = 0; p < np; p++) {
      if (f.lr_type[p] == RESTORE_NONE) continue;
      int ssx = p ? sx : 0, ssy = p ? sy : 0;
      int us = f.lr_size[p];
      int ph = round2(f.height, ssy), pw = round2(f.width, ssx);
      lr_rows[p] = std::max((ph + (us >> 1)) / us, 1);
      lr_cols[p] = std::max((pw + (us >> 1)) / us, 1);
      lr_unit_type[p].assign((size_t)lr_rows[p] * lr_cols[p], 0);
      lr_unit_coef[p].assign((size_t)lr_rows[p] * lr_cols[p] * 6, 0);
    }
  }

  // ---- tile --------------------------------------------------------------
  void decode_tile(const uint8_t *data, size_t size, int tile_row, int tile_col) {
    mi_row_start = f.mi_row_starts[tile_row];
    mi_row_end = f.mi_row_starts[tile_row + 1];
    mi_col_start = f.mi_col_starts[tile_col];
    mi_col_end = f.mi_col_starts[tile_col + 1];
    cur_q = f.base_q_idx;
    cdf = frame_cdf;
    ms.init(data, size, f.disable_cdf_update);
    for (int p = 0; p < np; p++) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < np; p++) {
      ref_sgr_xqd[p][0] = -32;
      ref_sgr_xqd[p][1] = 31;
      for (int pass = 0; pass < 2; pass++) {
        ref_lr_wiener[p][pass][0] = 3;
        ref_lr_wiener[p][pass][1] = -7;
        ref_lr_wiener[p][pass][2] = 15;
      }
    }
    const int sb4 = s.sb128 ? 32 : 16;
    const int sbsize = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < np; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = f.delta_q_present;
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sbsize);
        decode_partition(r, c, sbsize);
      }
    }
  }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < np; p++) {
      int ssx = p ? sx : 0, ssy = p ? sy : 0;
      int sbw4 = (mi_col_end - c) >> ssx;
      int sbh4 = (mi_row_end - r) >> ssy;
      for (int y = -1; y <= (sb4 >> ssy); y++)
        for (int x = -1; x <= (sb4 >> ssx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[p][y + 1][x + 1] = v;
        }
      block_decoded[p][(sb4 >> ssy) + 1][0] = 0;
    }
  }

  // ---- loop restoration coefficients -------------------------------------
  int decode_subexp_bool(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (num_syms <= mk + 3 * a) return (int)ms.ns(num_syms - mk) + mk;
      if (ms.lit(1)) {
        i++;
        mk += a;
      } else {
        return (int)ms.lit(b2) + mk;
      }
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }
  int decode_signed_subexp(int low, int high, int k, int r) {
    int mx = high - low;
    r -= low;
    int v = decode_subexp_bool(mx, k);
    int x = ((r << 1) <= mx) ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
  }
  void read_lr(int r, int c, int bsize) {
    const int w = 1 << BW4L[bsize], h = 1 << BH4L[bsize];
    for (int p = 0; p < np; p++) {
      if (f.lr_type[p] == RESTORE_NONE) continue;
      int ssx = p ? sx : 0, ssy = p ? sy : 0;
      int us = f.lr_size[p];
      int rows = lr_rows[p], cols = lr_cols[p];
      int row_start = (r * (4 >> ssy) + us - 1) / us;
      int row_end = std::min(rows, ((r + h) * (4 >> ssy) + us - 1) / us);
      int col_start = (c * (4 >> ssx) + us - 1) / us;
      int col_end = std::min(cols, ((c + w) * (4 >> ssx) + us - 1) / us);
      for (int ur = row_start; ur < row_end; ur++)
        for (int uc = col_start; uc < col_end; uc++) read_lr_unit(p, ur, uc);
    }
  }
  void read_lr_unit(int p, int ur, int uc) {
    int type;
    if (f.lr_type[p] == RESTORE_WIENER) type = ms.sym(cdf.lr_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (f.lr_type[p] == RESTORE_SGRPROJ) type = ms.sym(cdf.lr_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else type = ms.sym(cdf.lr_switchable, 3);
    size_t idx = (size_t)ur * lr_cols[p] + uc;
    lr_unit_type[p][idx] = (uint8_t)type;
    int16_t *co = &lr_unit_coef[p][idx * 6];
    static const int wmin[3] = {-5, -23, -17}, wmax[3] = {10, 8, 46}, wk[3] = {1, 2, 3};
    if (type == RESTORE_WIENER) {
      count(C_lr_wiener);
      for (int pass = 0; pass < 2; pass++) {
        int first = 0;
        if (p) {
          first = 1;
          co[pass * 3] = 0;
        }
        for (int j = first; j < 3; j++) {
          int v = decode_signed_subexp(wmin[j], wmax[j] + 1, wk[j], ref_lr_wiener[p][pass][j]);
          co[pass * 3 + j] = (int16_t)v;
          ref_lr_wiener[p][pass][j] = v;
        }
      }
    } else if (type == RESTORE_SGRPROJ) {
      count(C_lr_sgrproj);
      int set = (int)ms.lit(4);
      co[0] = (int16_t)set;
      static const int xmin[2] = {-96, -32}, xmax[2] = {31, 95};
      for (int i = 0; i < 2; i++) {
        int radius = av1_sgr_params[set][i * 2];
        int v;
        if (radius) {
          v = decode_signed_subexp(xmin[i], xmax[i] + 1, 4, ref_sgr_xqd[p][i]);
        } else {
          v = 0;
          if (i == 1) v = clip3(xmin[i], xmax[i], (1 << 7) - ref_sgr_xqd[p][0]);
        }
        co[1 + i] = (int16_t)v;
        ref_sgr_xqd[p][i] = v;
      }
    }
  }

  // ---- partition -----------------------------------------------------------
  void decode_partition(int r, int c, int bsize) {
    if (r >= f.mi_rows || c >= f.mi_cols) return;
    const bool au = inside(r - 1, c), al = inside(r, c - 1);
    const int n4 = 1 << BW4L[bsize];
    const int half = n4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < f.mi_rows;
    const bool has_cols = (c + half) < f.mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = 0;
    } else {
      const int bsl = BW4L[bsize];
      int above = au && BW4L[info_at(r - 1, c)->size] < bsl;
      int left = al && BH4L[info_at(r, c - 1)->size] < bsl;
      int ctx = left * 2 + above;
      uint16_t *pc;
      int N;
      switch (bsl) {
        case 1: pc = cdf.part8[ctx]; N = 4; break;
        case 2: pc = cdf.part16[ctx]; N = 10; break;
        case 3: pc = cdf.part32[ctx]; N = 10; break;
        case 4: pc = cdf.part64[ctx]; N = 10; break;
        default: pc = cdf.part128[ctx]; N = 8; break;
      }
      auto prob = [&](int e) { return (e > 0 ? pc[e - 1] : 32768) - pc[e]; };
      if (has_rows && has_cols) {
        partition = ms.sym(pc, N);
      } else if (has_cols) {
        // split_or_horz: every partition with a vertical split in its top
        // half becomes SPLIT
        uint32_t psum = prob(2) + prob(3);  // VERT, SPLIT
        if (N >= 8) psum += prob(4) + prob(6) + prob(7);  // HORZ_A, VERT_A, VERT_B
        if (N == 10) psum += prob(9);  // VERT_4
        partition = ms.bool_f(psum) ? 3 : 1;
      } else if (has_rows) {
        // split_or_vert: likewise with a horizontal split in the left half
        uint32_t psum = prob(1) + prob(3);  // HORZ, SPLIT
        if (N >= 8) psum += prob(4) + prob(5) + prob(6);  // HORZ_A, HORZ_B, VERT_A
        if (N == 10) psum += prob(8);  // HORZ_4
        partition = ms.bool_f(psum) ? 3 : 2;
      } else {
        partition = 3;
      }
    }
    // 4:2:2 halves the width only: a block taller than wide has no chroma
    // block size, and the specification forbids every partition that
    // makes one; dav1d refuses them
    if (sx && !sy && (partition == 2 || partition == 6 || partition == 7 || partition == 9))
      invalid("a vertical partition in 4:2:2");
    const int l = BW4L[bsize];
    auto sub = [&](int wl, int hl) { return block_of(wl, hl); };
    const int split = bsize == BLOCK_8X8 ? BLOCK_4X4 : sub(l - 1, l - 1);
    switch (partition) {
      case 0: decode_block(r, c, bsize); break;
      case 1:
        decode_block(r, c, sub(l, l - 1));
        if (has_rows) decode_block(r + half, c, sub(l, l - 1));
        break;
      case 2:
        decode_block(r, c, sub(l - 1, l));
        if (has_cols) decode_block(r, c + half, sub(l - 1, l));
        break;
      case 3:
        decode_partition(r, c, split);
        decode_partition(r, c + half, split);
        decode_partition(r + half, c, split);
        decode_partition(r + half, c + half, split);
        break;
      case 4:
        count(C_partition_ab);
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub(l, l - 1));
        break;
      case 5:
        count(C_partition_ab);
        decode_block(r, c, sub(l, l - 1));
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case 6:
        count(C_partition_ab);
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub(l - 1, l));
        break;
      case 7:
        count(C_partition_ab);
        decode_block(r, c, sub(l - 1, l));
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case 8:
        count(C_partition_4);
        for (int i = 0; i < 4; i++) {
          if (i == 3 && r + quarter * 3 >= f.mi_rows) break;
          decode_block(r + quarter * i, c, sub(l, l - 2));
        }
        break;
      default:
        count(C_partition_4);
        for (int i = 0; i < 4; i++) {
          if (i == 3 && c + quarter * 3 >= f.mi_cols) break;
          decode_block(r, c + quarter * i, sub(l - 2, l));
        }
        break;
    }
  }

  // ---- block ---------------------------------------------------------------
  void decode_block(int r, int c, int bsize) {
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    bw4 = 1 << BW4L[bsize];
    bh4 = 1 << BH4L[bsize];
    if (bh4 == 1 && sy && (r & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && sx && (c & 1) == 0) has_chroma = 0;
    else has_chroma = np > 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_uc = avail_u;
    avail_lc = avail_l;
    if (has_chroma) {
      if (sy && bh4 == 1) avail_uc = inside(r - 2, c);
      if (sx && bw4 == 1) avail_lc = inside(r, c - 2);
    } else {
      avail_uc = avail_lc = false;
    }
    count(C_blocks);
    mode_info();
    palette_tokens();
    read_tx_size();

    // store the block
    BlockInfo bi;
    memset(&bi, 0, sizeof(bi));
    bi.size = (uint8_t)bsize;
    bi.ymode = (uint8_t)ymode;
    bi.uvmode = (uint8_t)(has_chroma ? uvmode : DC_PRED);
    bi.skip = (uint8_t)skip;
    bi.tx = (uint8_t)tx_size;
    bi.pal_y = (uint8_t)pal_y;
    bi.pal_uv = (uint8_t)pal_uv;
    memcpy(bi.colors_y, colors_y, 8);
    memcpy(bi.colors_u, colors_u, 8);
    bi.seg = (uint8_t)segment_id;
    for (int i = 0; i < 4; i++) bi.delta_lf[i] = (int8_t)delta_lf[i];
    int idx = (int)blocks.size();
    blocks.push_back(bi);
    for (int y = 0; y < bh4; y++) {
      if (r + y >= f.mi_rows) break;
      for (int x = 0; x < bw4; x++) {
        if (c + x >= f.mi_cols) break;
        mi_block[(size_t)(r + y) * mi_stride + c + x] = idx;
      }
    }
    if (skip) reset_block_context();
    residual();
  }

  // the coefficient contexts of a block without residual (reset_block_context)
  void reset_block_context() {
    for (int p = 0; p < 1 + has_chroma * 2; p++) {
      int ssx = p ? sx : 0, ssy = p ? sy : 0;
      for (int i = mi_col >> ssx; i < (mi_col + bw4) >> ssx; i++)
        above_level[p][i] = above_dc[p][i] = 0;
      for (int i = mi_row >> ssy; i < (mi_row + bh4) >> ssy; i++)
        left_level[p][i] = left_dc[p][i] = 0;
    }
  }

  // the segment of a block (intra_segment_id): coded against the one its
  // neighbours predict
  void read_segment_id() {
    if (!f.seg_enabled) return;
    int ul = avail_u && avail_l ? info_at(mi_row - 1, mi_col - 1)->seg : -1;
    int u = avail_u ? info_at(mi_row - 1, mi_col)->seg : -1;
    int l = avail_l ? info_at(mi_row, mi_col - 1)->seg : -1;
    int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : (ul == u ? u : l);
    if (skip) {
      segment_id = pred;
      return;
    }
    int ctx = ul < 0 ? 0 : (ul == u && ul == l) ? 2 : (ul == u || ul == l || u == l) ? 1 : 0;
    int diff = ms.sym(cdf.segment_id[ctx], 8);
    const int max = f.last_active_seg_id + 1;
    int v;
    if (!pred) v = diff;
    else if (pred >= max - 1) v = max - diff - 1;
    else if (2 * pred < max) v = diff <= 2 * pred ? ((diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1)) : diff;
    else v = diff <= 2 * (max - pred - 1) ? ((diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1))
                                           : max - (diff + 1);
    // dav1d puts a segment past the last active one to 0 (the
    // specification clips it to the last active one)
    segment_id = v < 0 || v > f.last_active_seg_id ? 0 : v;
    count(C_segment_ids);
  }

  // get_qindex: the block's quantizer index, with its segment's
  int qindex(bool ignore_delta_q) const {
    const bool dq = !ignore_delta_q && f.delta_q_present;
    if (f.seg_enabled && f.seg_feature_enabled[segment_id][0])
      return clip3(0, 255, (dq ? cur_q : f.base_q_idx) + f.seg_feature_data[segment_id][0]);
    return dq ? cur_q : f.base_q_idx;
  }

  void mode_info() {
    const int sbsize = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    segment_id = 0;
    skip = 0;
    if (f.seg_id_pre_skip) read_segment_id();
    if (f.seg_id_pre_skip && f.seg_feature_enabled[segment_id][6]) {
      skip = 1;  // SEG_LVL_SKIP
    } else {
      int ctx = 0;
      if (avail_u) ctx += info_at(mi_row - 1, mi_col)->skip;
      if (avail_l) ctx += info_at(mi_row, mi_col - 1)->skip;
      skip = ms.sym(cdf.skip[ctx], 2);
    }
    if (!f.seg_id_pre_skip) read_segment_id();
    if (skip) count(C_skip_blocks);
    lossless = f.lossless_seg[segment_id];
    if (lossless) count(C_lossless_blocks);
    // cdef: the sequence or the frame has it off, or every strength is 0:
    // read the index all the same (cdef_bits bits once per 64x64)
    if (!(skip || f.coded_lossless || !s.cdef)) read_cdef();
    // delta q
    if (!(mi_size == sbsize && skip) && read_deltas) {
      int abs_ = ms.sym(cdf.delta_q, 4);
      if (abs_ == 3) {
        int rem = (int)ms.lit(3) + 1;
        abs_ = (int)ms.lit(rem) + (1 << rem) + 1;
      }
      if (abs_) {
        int sign = ms.lit(1);
        int red = sign ? -abs_ : abs_;
        cur_q = clip3(1, 255, cur_q + (red << f.delta_q_res));
      }
    }
    if (!(mi_size == sbsize && skip) && read_deltas && f.delta_lf_present) {
      const int n_lf = f.delta_lf_multi ? (np > 1 ? 4 : 2) : 1;
      if (f.delta_lf_multi) count(C_delta_lf_multi);
      for (int i = 0; i < n_lf; i++) {
        int abs_ = ms.sym(f.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
        if (abs_ == 3) {
          int n = (int)ms.lit(3) + 1;
          abs_ = (int)ms.lit(n) + (1 << n) + 1;
        }
        if (abs_) {
          int sign = ms.lit(1);
          int red = sign ? -abs_ : abs_;
          delta_lf[i] = clip3(-63, 63, delta_lf[i] + (red << f.delta_lf_res));
        }
      }
    }
    read_deltas = 0;
    // intra_frame_y_mode
    int above = avail_u ? info_at(mi_row - 1, mi_col)->ymode : DC_PRED;
    int left = avail_l ? info_at(mi_row, mi_col - 1)->ymode : DC_PRED;
    ymode = ms.sym(cdf.kf_y_mode[INTRA_MODE_CONTEXT[above]][INTRA_MODE_CONTEXT[left]], 13);
    count(C_y_dc + ymode);
    angle_y = 0;
    if (mi_size >= BLOCK_8X8 && ymode >= V_PRED && ymode <= D67_PRED) {
      angle_y = ms.sym(cdf.angle_delta[ymode - V_PRED], 7) - 3;
      if (angle_y) count(C_angle_delta);
    }
    uvmode = DC_PRED;
    angle_uv = 0;
    cfl_u = cfl_v = 0;
    if (has_chroma) {
      bool cfl_allowed;
      if (lossless && plane_block(mi_size, sx, sy) == BLOCK_4X4) cfl_allowed = true;
      else if (!lossless && std::max(bw4, bh4) <= 8) cfl_allowed = true;
      else cfl_allowed = false;
      uvmode = cfl_allowed ? ms.sym(cdf.uv_cfl[ymode], 14) : ms.sym(cdf.uv_cfl_no[ymode], 13);
      count(C_uv_dc + uvmode);
      if (uvmode == UV_CFL_PRED) {
        count(C_cfl);
        int signs = ms.sym(cdf.cfl_sign, 8);
        int su = (signs + 1) / 3, sv = (signs + 1) % 3;
        if (su) {
          cfl_u = 1 + ms.sym(cdf.cfl_alpha[(su - 1) * 3 + sv], 16);
          if (su == 1) cfl_u = -cfl_u;
        }
        if (sv) {
          cfl_v = 1 + ms.sym(cdf.cfl_alpha[(sv - 1) * 3 + su], 16);
          if (sv == 1) cfl_v = -cfl_v;
        }
      }
      if (mi_size >= BLOCK_8X8 && uvmode >= V_PRED && uvmode <= D67_PRED) {
        angle_uv = ms.sym(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
        if (angle_uv) count(C_angle_delta);
      }
    }
    pal_y = pal_uv = 0;
    if (mi_size >= BLOCK_8X8 && bw4 <= 16 && bh4 <= 16 && f.allow_sct) palette_mode_info();
    use_filter_intra = 0;
    if (s.filter_intra && ymode == DC_PRED && pal_y == 0 && std::max(bw4, bh4) <= 8) {
      use_filter_intra = ms.sym(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) {
        count(C_filter_intra);
        filter_mode = ms.sym(cdf.filter_intra_mode, 5);
      }
    }
  }

  std::vector<int8_t> cdef_seen;
  void read_cdef() {
    // CDEF strengths are all 0 here (others are refused): the index only
    // has to be read in the right place
    int r = mi_row & ~15, c = mi_col & ~15;
    int key = (r >> 4) * 1024 + (c >> 4);
    if (cdef_seen.empty()) cdef_seen.assign(1024 * 1024, 0);
    if (!cdef_seen[key]) {
      ms.lit(f.cdef_bits);
      for (int y = r; y < r + bh4; y += 16)
        for (int x = c; x < c + bw4; x += 16) cdef_seen[(y >> 4) * 1024 + (x >> 4)] = 1;
    }
  }

  int get_palette_cache(int plane, uint8_t *cache) {
    int above_n = 0, left_n = 0;
    const BlockInfo *ab = nullptr, *lb = nullptr;
    if ((mi_row * 4) % 64 && avail_u) {
      ab = info_at(mi_row - 1, mi_col);
      above_n = plane ? ab->pal_uv : ab->pal_y;
    }
    if (avail_l) {
      lb = info_at(mi_row, mi_col - 1);
      left_n = plane ? lb->pal_uv : lb->pal_y;
    }
    const uint8_t *ac = ab ? (plane ? ab->colors_u : ab->colors_y) : nullptr;
    const uint8_t *lc = lb ? (plane ? lb->colors_u : lb->colors_y) : nullptr;
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
      int a = ac[ai], l = lc[li];
      if (l < a) {
        if (n == 0 || l != cache[n - 1]) cache[n++] = (uint8_t)l;
        li++;
      } else {
        if (n == 0 || a != cache[n - 1]) cache[n++] = (uint8_t)a;
        ai++;
        if (l == a) li++;
      }
    }
    while (ai < above_n) {
      int v = ac[ai++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    while (li < left_n) {
      int v = lc[li++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    return n;
  }

  void read_palette_colors(int plane, int n, uint8_t *colors, bool luma) {
    uint8_t cache[16];
    int cn = get_palette_cache(plane, cache);
    int idx = 0;
    for (int i = 0; i < cn && idx < n; i++)
      if (ms.lit(1)) {
        colors[idx++] = cache[i];
        count(C_palette_cache);
      }
    if (idx < n) colors[idx++] = (uint8_t)ms.lit(8);
    int bits = 0;
    if (idx < n) bits = 8 - 3 + (int)ms.lit(2);
    while (idx < n) {
      int delta = (int)ms.lit(bits);
      if (luma) delta++;
      colors[idx] = clip1(colors[idx - 1] + delta);
      int range = 256 - colors[idx] - (luma ? 1 : 0);
      bits = std::min(bits, ceil_log2(range));
      idx++;
    }
    std::sort(colors, colors + n);
  }

  void palette_mode_info() {
    const int bsctx = BW4L[mi_size] + BH4L[mi_size] - 2;
    if (ymode == DC_PRED) {
      int ctx = 0;
      if (avail_u && info_at(mi_row - 1, mi_col)->pal_y) ctx++;
      if (avail_l && info_at(mi_row, mi_col - 1)->pal_y) ctx++;
      if (ms.sym(cdf.pal_y_mode[bsctx][ctx], 2)) {
        pal_y = ms.sym(cdf.pal_y_size[bsctx], 7) + 2;
        count(C_palette_y);
        read_palette_colors(0, pal_y, colors_y, true);
      }
    }
    if (has_chroma && uvmode == DC_PRED) {
      if (ms.sym(cdf.pal_uv_mode[pal_y > 0], 2)) {
        pal_uv = ms.sym(cdf.pal_uv_size[bsctx], 7) + 2;
        count(C_palette_uv);
        read_palette_colors(1, pal_uv, colors_u, false);
        if (ms.lit(1)) {
          int bits = 8 - 4 + (int)ms.lit(2);
          colors_v[0] = (uint8_t)ms.lit(8);
          for (int i = 1; i < pal_uv; i++) {
            int d = (int)ms.lit(bits);
            if (d && ms.lit(1)) d = -d;
            int v = colors_v[i - 1] + d;
            if (v < 0) v += 256;
            if (v >= 256) v -= 256;
            colors_v[i] = clip1(v);
          }
        } else {
          for (int i = 0; i < pal_uv; i++) colors_v[i] = (uint8_t)ms.lit(8);
        }
      }
    }
  }

  void read_color_map(uint8_t *map, int n, int bw, int bh, int onw, int onh, bool luma) {
    map[0] = (uint8_t)ms.ns(n);
    for (int i = 1; i < onh + onw - 1; i++) {
      for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
        int r = i - j, c = j;
        int scores[8] = {0}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
        if (c > 0) scores[map[r * bw + c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[(r - 1) * bw + c - 1]] += 1;
        if (r > 0) scores[map[(r - 1) * bw + c]] += 2;
        for (int k = 0; k < 3; k++) {
          int ms_ = scores[k], mi = k;
          for (int l = k + 1; l < n; l++)
            if (scores[l] > ms_) {
              ms_ = scores[l];
              mi = l;
            }
          if (mi != k) {
            int mo = order[mi];
            for (int l = mi; l > k; l--) {
              scores[l] = scores[l - 1];
              order[l] = order[l - 1];
            }
            scores[k] = ms_;
            order[k] = mo;
          }
        }
        int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
        static const int ctx_of[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
        int ctx = ctx_of[hash];
        if (ctx < 0) invalid("palette colour context");
        uint16_t *cd = luma ? cdf.pal_y_color[n - 2][ctx] : cdf.pal_uv_color[n - 2][ctx];
        int v = ms.sym(cd, n);
        map[r * bw + c] = (uint8_t)order[v];
      }
    }
    for (int i = 0; i < onh; i++)
      for (int j = onw; j < bw; j++) map[i * bw + j] = map[i * bw + onw - 1];
    for (int i = onh; i < bh; i++) memcpy(&map[i * bw], &map[(onh - 1) * bw], bw);
  }

  void palette_tokens() {
    int bh = bh4 * 4, bw = bw4 * 4;
    int onh = std::min(bh, (f.mi_rows - mi_row) * 4);
    int onw = std::min(bw, (f.mi_cols - mi_col) * 4);
    if (pal_y) read_color_map(color_map_y, pal_y, bw, bh, onw, onh, true);
    if (pal_uv) {
      bh >>= sy;
      bw >>= sx;
      onh >>= sy;
      onw >>= sx;
      if (bw < 4) {
        bw += 2;
        onw += 2;
      }
      if (bh < 4) {
        bh += 2;
        onh += 2;
      }
      read_color_map(color_map_uv, pal_uv, bw, bh, onw, onh, false);
      uv_map_w = bw;
    }
  }
  int uv_map_w = 0;

  int above_tx_width(int r, int c) {
    if (!avail_u) return 64;
    return 1 << TXWL[info_at(r - 1, c)->tx];
  }
  int left_tx_height(int r, int c) {
    if (!avail_l) return 64;
    return 1 << TXHL[info_at(r, c - 1)->tx];
  }

  void read_tx_size() {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    const int maxr = max_tx_rect(mi_size);
    tx_size = maxr;
    if (mi_size > BLOCK_4X4 && f.tx_mode_select) {
      int depth = 0;
      for (int t = maxr; t != TX_4X4; t = tx_split(t)) depth++;
      const int cat = depth - 1;
      const int max_depth = std::min(depth, 2);
      const int maxw = 1 << TXWL[maxr], maxh = 1 << TXHL[maxr];
      int aw = avail_u ? above_tx_width(mi_row, mi_col) : 0;
      int lh = avail_l ? left_tx_height(mi_row, mi_col) : 0;
      int ctx = (aw >= maxw) + (lh >= maxh);
      int d;
      if (cat == 0) d = ms.sym(cdf.tx8[ctx], 2);
      else if (cat == 1) d = ms.sym(cdf.tx16[ctx], max_depth + 1);
      else if (cat == 2) d = ms.sym(cdf.tx32[ctx], max_depth + 1);
      else d = ms.sym(cdf.tx64[ctx], max_depth + 1);
      for (int i = 0; i < d; i++) tx_size = tx_split(tx_size);
    }
  }

  // ---- residual ------------------------------------------------------------
  int uv_tx_size() {
    int pb = plane_block(mi_size, sx, sy);
    int uv = max_tx_rect(pb);
    if (TXWL[uv] == 6 || TXHL[uv] == 6) {
      if (TXWL[uv] == 4) return TX_16X32;
      if (TXHL[uv] == 4) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  void residual() {
    const int wchunks = std::max(1, bw4 >> 4), hchunks = std::max(1, bh4 >> 4);
    for (int cy = 0; cy < hchunks; cy++)
      for (int cx = 0; cx < wchunks; cx++) {
        for (int p = 0; p < 1 + has_chroma * 2; p++) {
          int tx = lossless ? TX_4X4 : (p ? uv_tx_size() : tx_size);
          int stepx = 1 << (TXWL[tx] - 2), stepy = 1 << (TXHL[tx] - 2);
          int ssx = p ? sx : 0, ssy = p ? sy : 0;
          int pb = p ? plane_block(mi_size, ssx, ssy) : mi_size;
          int n4w = 1 << BW4L[pb], n4h = 1 << BH4L[pb];
          int basex = (mi_col >> ssx) * 4, basey = (mi_row >> ssy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> ssy); y += stepy)
            for (int x = 0; x < std::min(n4w, 16 >> ssx); x += stepx)
              transform_block(p, basex, basey, tx, x + ((cx << 4) >> ssx), y + ((cy << 4) >> ssy));
        }
      }
  }

  bool bd(int p, int y, int x) {
    if (y < -1 || x < -1 || y > 33 || x > 33) return false;
    return block_decoded[p][y + 1][x + 1];
  }

  void transform_block(int p, int basex, int basey, int tx, int x, int y) {
    const int ssx = p ? sx : 0, ssy = p ? sy : 0;
    const int startx = basex + 4 * x, starty = basey + 4 * y;
    const int row = (starty << ssy) >> 2, col = (startx << ssx) >> 2;
    const int sbmask = s.sb128 ? 31 : 15;
    const int sbr = row & sbmask, sbc = col & sbmask;
    const int stepx = 1 << (TXWL[tx] - 2), stepy = 1 << (TXHL[tx] - 2);
    const int maxx = f.mi_cols * 4 - 1, maxy = f.mi_rows * 4 - 1;
    if (startx >= ((maxx >> ssx) + 1) || starty >= ((maxy >> ssy) + 1)) return;
    count(C_tx_4x4 + tx);
    const bool palette = p == 0 ? pal_y > 0 : pal_uv > 0;
    if (palette) {
      const int w = 1 << TXWL[tx], h = 1 << TXHL[tx];
      const uint8_t *pal = p == 0 ? colors_y : p == 1 ? colors_u : colors_v;
      const uint8_t *map = p == 0 ? color_map_y : color_map_uv;
      const int mw = p == 0 ? bw4 * 4 : uv_map_w;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          *pl[p].at(startx + j, starty + i) = pal[map[(y * 4 + i) * mw + x * 4 + j]];
    } else {
      const bool is_cfl = p > 0 && uvmode == UV_CFL_PRED;
      int mode = p == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
      bool have_left = (p == 0 ? avail_l : avail_lc) || x > 0;
      bool have_above = (p == 0 ? avail_u : avail_uc) || y > 0;
      bool have_ar = bd(p, (sbr >> ssy) - 1, (sbc >> ssx) + stepx);
      bool have_bl = bd(p, (sbr >> ssy) + stepy, (sbc >> ssx) - 1);
      predict_intra(p, startx, starty, have_left, have_above, have_ar, have_bl, mode, TXWL[tx], TXHL[tx]);
      if (is_cfl) predict_cfl(p, startx, starty, tx);
    }
    if (p == 0) {
      max_luma_w = startx + stepx * 4;
      max_luma_h = starty + stepy * 4;
    }
    if (!skip) {
      int eob = coeffs(p, startx, starty, tx);
      if (eob > 0) reconstruct(p, startx, starty, tx, eob);
    }
    for (int i = 0; i < stepy; i++)
      for (int j = 0; j < stepx; j++) {
        int ly = (row >> ssy) + i, lx = (col >> ssx) + j;
        if (lx < lf_stride[p] && (size_t)ly * lf_stride[p] + lx < lf_tx[p].size())
          lf_tx[p][(size_t)ly * lf_stride[p] + lx] = (uint8_t)tx;
        int by = (sbr >> ssy) + i, bx = (sbc >> ssx) + j;
        if (by <= 33 && bx <= 33) block_decoded[p][by + 1][bx + 1] = 1;
      }
  }

  // ---- intra prediction ----------------------------------------------------
  bool is_smooth_at(int r, int c, int p) {
    const BlockInfo *b = info_at(r, c);
    int m = p == 0 ? b->ymode : b->uvmode;
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }
  int filter_type(int p) {
    bool as = false, ls = false;
    if (p == 0 ? avail_u : avail_uc) {
      int r = mi_row - 1, c = mi_col;
      if (p > 0) {
        if (sx && !(mi_col & 1)) c++;
        if (sy && (mi_row & 1)) r--;
      }
      as = is_smooth_at(r, c, p);
    }
    if (p == 0 ? avail_l : avail_lc) {
      int r = mi_row, c = mi_col - 1;
      if (p > 0) {
        if (sx && (mi_col & 1)) c--;
        if (sy && !(mi_row & 1)) r++;
      }
      ls = is_smooth_at(r, c, p);
    }
    return as || ls;
  }
  static int edge_strength(int w, int h, int type, int delta) {
    int d = std::abs(delta), wh = w + h, s = 0;
    if (type == 0) {
      if (wh <= 8) { if (d >= 56) s = 1; }
      else if (wh <= 12) { if (d >= 40) s = 1; }
      else if (wh <= 16) { if (d >= 40) s = 1; }
      else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (wh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  static bool use_upsample(int w, int h, int type, int delta) {
    int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return false;
    return type ? wh <= 8 : wh <= 16;
  }
  // buf points at index 0 of an edge with index -1 .. valid
  void edge_filter(int *buf, int sz, int strength) {
    if (!strength) return;
    static const int k[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s_ = 0;
      for (int j = 0; j < 5; j++) {
        int kk = clip3(0, sz - 1, i - 2 + j);
        s_ += k[strength - 1][j] * edge[kk];
      }
      buf[i - 1] = (s_ + 8) >> 4;
    }
    count(C_edge_filter);
  }
  void edge_upsample(int *buf, int numpx) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < numpx; i++) dup[i + 2] = buf[i];
    dup[numpx + 2] = buf[numpx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numpx; i++) {
      int s_ = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s_ = clip1(round2(s_, 4));
      buf[2 * i - 1] = s_;
      buf[2 * i] = dup[i + 2];
    }
    count(C_edge_upsample);
  }

  void predict_intra(int p, int x, int y, bool have_left, bool have_above, bool have_ar,
                     bool have_bl, int mode, int wl, int hl) {
    const int w = 1 << wl, h = 1 << hl;
    const int ssx = p ? sx : 0, ssy = p ? sy : 0;
    const int maxx = ((f.mi_cols * 4) >> ssx) - 1, maxy = ((f.mi_rows * 4) >> ssy) - 1;
    Plane &P = pl[p];
    int above_buf[300], left_buf[300];
    int *A = above_buf + 16, *Lc = left_buf + 16;
    const int n = w + h;
    if (!have_above && have_left) {
      int v = *P.at(x - 1, y);
      for (int i = 0; i < n; i++) A[i] = v;
    } else if (!have_above && !have_left) {
      for (int i = 0; i < n; i++) A[i] = 127;
    } else {
      int lim = std::min(maxx, x + (have_ar ? 2 * w : w) - 1);
      for (int i = 0; i < n; i++) A[i] = *P.at(std::min(lim, x + i), y - 1);
    }
    if (!have_left && have_above) {
      int v = *P.at(x, y - 1);
      for (int i = 0; i < n; i++) Lc[i] = v;
    } else if (!have_left && !have_above) {
      for (int i = 0; i < n; i++) Lc[i] = 129;
    } else {
      int lim = std::min(maxy, y + (have_bl ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) Lc[i] = *P.at(x - 1, std::min(lim, y + i));
    }
    if (have_above && have_left) A[-1] = *P.at(x - 1, y - 1);
    else if (have_above) A[-1] = *P.at(x, y - 1);
    else if (have_left) A[-1] = *P.at(x - 1, y);
    else A[-1] = 128;
    Lc[-1] = A[-1];
    auto out = [&](int i, int j) -> uint8_t & { return *P.at(x + j, y + i); };
    if (p == 0 && use_filter_intra) {
      const int w4 = w >> 2, h2 = h >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int pv[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) pv[i] = A[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) pv[i] = Lc[(i2 << 1) - 1];
              else pv[i] = out((i2 << 1) - 1, (j4 << 2) + i - 1);
            } else {
              if (j4 == 0) pv[i] = Lc[(i2 << 1) + i - 5];
              else pv[i] = out((i2 << 1) + i - 5, (j4 << 2) - 1);
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += av1_filter_intra_taps[filter_mode][i][j] * pv[j];
            int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
            out((i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)) = clip1(v);
          }
        }
      return;
    }
    if (mode >= V_PRED && mode <= D67_PRED) {
      const int angle = MODE_TO_ANGLE[mode] + (p == 0 ? angle_y : angle_uv) * 3;
      int up_a = 0, up_l = 0;
      if (s.edge_filter) {
        if (angle != 90 && angle != 180) {
          if (angle > 90 && angle < 180 && (w + h) >= 24) {
            int v = round2(Lc[0] * 5 + A[-1] * 6 + A[0] * 5, 4);
            Lc[-1] = A[-1] = v;
          }
          int ft = filter_type(p);
          if (have_above) {
            int st = edge_strength(w, h, ft, angle - 90);
            int num = std::min(w, maxx - x + 1) + (angle < 90 ? h : 0) + 1;
            edge_filter(A, num, st);
          }
          if (have_left) {
            int st = edge_strength(w, h, ft, angle - 180);
            int num = std::min(h, maxy - y + 1) + (angle > 180 ? w : 0) + 1;
            edge_filter(Lc, num, st);
          }
        }
        int ft = filter_type(p);
        up_a = use_upsample(w, h, ft, angle - 90);
        if (up_a) edge_upsample(A, w + (angle < 90 ? h : 0));
        up_l = use_upsample(w, h, ft, angle - 180);
        if (up_l) edge_upsample(Lc, h + (angle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (angle < 90) dx = av1_dr_intra_derivative[angle];
      else if (angle > 90 && angle < 180) dx = av1_dr_intra_derivative[180 - angle];
      if (angle > 90 && angle < 180) dy = av1_dr_intra_derivative[angle - 90];
      else if (angle > 180) dy = av1_dr_intra_derivative[270 - angle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (angle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - up_a)) + (j << up_a);
            int shift = ((idx << up_a) >> 1) & 0x1f;
            int maxb = (w + h - 1) << up_a;
            if (base < maxb) v = round2(A[base] * (32 - shift) + A[base + 1] * shift, 5);
            else v = A[maxb];
          } else if (angle > 90 && angle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - up_a);
            if (base >= -(1 << up_a)) {
              int shift = ((idx * (1 << up_a)) >> 1) & 0x1f;
              v = round2(A[base] * (32 - shift) + A[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - up_l);
              int shift = ((idx * (1 << up_l)) >> 1) & 0x1f;
              v = round2(Lc[base] * (32 - shift) + Lc[base + 1] * shift, 5);
            }
          } else if (angle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - up_l)) + (i << up_l);
            int shift = ((idx << up_l) >> 1) & 0x1f;
            int maxb = (w + h - 1) << up_l;
            if (base < maxb) v = round2(Lc[base] * (32 - shift) + Lc[base + 1] * shift, 5);
            else v = Lc[maxb];
          } else if (angle == 90) {
            v = A[j];
          } else {
            v = Lc[i];
          }
          out(i, j) = (uint8_t)v;
        }
      return;
    }
    if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      static const int off[7] = {0, 0, 0, 4, 12, 28, 60};
      const uint8_t *wx = av1_sm_weights + off[wl], *wy = av1_sm_weights + off[hl];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (mode == SMOOTH_PRED)
            v = round2(wy[i] * A[j] + (256 - wy[i]) * Lc[h - 1] + wx[j] * Lc[i] +
                           (256 - wx[j]) * A[w - 1], 9);
          else if (mode == SMOOTH_V_PRED)
            v = round2(wy[i] * A[j] + (256 - wy[i]) * Lc[h - 1], 8);
          else
            v = round2(wx[j] * Lc[i] + (256 - wx[j]) * A[w - 1], 8);
          out(i, j) = (uint8_t)v;
        }
      return;
    }
    if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += A[k];
        for (int k = 0; k < h; k++) sum += Lc[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += Lc[k];
        avg = (sum + (h >> 1)) >> hl;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += A[k];
        avg = (sum + (w >> 1)) >> wl;
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++) memset(&out(i, 0), avg, w);
      return;
    }
    // Paeth
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int base = A[j] + Lc[i] - A[-1];
        int pl_ = std::abs(base - Lc[i]), pt = std::abs(base - A[j]), ptl = std::abs(base - A[-1]);
        int v;
        if (pl_ <= pt && pl_ <= ptl) v = Lc[i];
        else if (pt <= ptl) v = A[j];
        else v = A[-1];
        out(i, j) = (uint8_t)v;
      }
  }

  void predict_cfl(int p, int startx, int starty, int tx) {
    const int w = 1 << TXWL[tx], h = 1 << TXHL[tx];
    const int alpha = p == 1 ? cfl_u : cfl_v;
    int L[32 * 32];
    int64_t avg = 0;
    for (int i = 0; i < h; i++) {
      int ly = std::min(starty + i, (max_luma_h >> sy) - 1) << sy;
      for (int j = 0; j < w; j++) {
        int lx = std::min(startx + j, (max_luma_w >> sx) - 1) << sx;
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += *pl[0].at(lx + dx, ly + dy);
        int v = t << (3 - sx - sy);
        L[i * w + j] = v;
        avg += v;
      }
    }
    int lavg = (int)round2l(avg, TXWL[tx] + TXHL[tx]);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        uint8_t &px = *pl[p].at(startx + j, starty + i);
        int sc = alpha * (L[i * w + j] - lavg);
        int scaled = sc >= 0 ? (sc + 32) >> 6 : -((-sc + 32) >> 6);
        px = clip1(px + scaled);
      }
  }

  // ---- coefficients ----------------------------------------------------------
  int get_tx_set(int tx) {
    int sqr_up = tx_sqr_up(tx), sqr = tx_sqr(tx);
    if (sqr_up > TX_32X32) return TX_SET_DCTONLY;
    if (sqr_up == TX_32X32) return TX_SET_DCTONLY;
    if (f.reduced_tx_set) return TX_SET_INTRA_2;
    if (sqr == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  int coeffs(int p, int startx, int starty, int tx) {
    const int ssx = p ? sx : 0, ssy = p ? sy : 0;
    const int x4 = startx >> 2, y4 = starty >> 2;
    const int w4 = 1 << (TXWL[tx] - 2), h4 = 1 << (TXHL[tx] - 2);
    const int txsz_ctx = (tx_sqr(tx) + tx_sqr_up(tx) + 1) >> 1;
    const int ptype = p > 0;
    const int adj_wl = std::min((int)TXWL[tx], 5), adj_hl = std::min((int)TXHL[tx], 5);
    const int bwl = adj_wl, txh = 1 << adj_hl;
    int max_x4 = f.mi_cols, max_y4 = f.mi_rows;
    if (p > 0) {
      max_x4 >>= ssx;
      max_y4 >>= ssy;
    }
    // all_zero context
    int ctx;
    const int w = 1 << TXWL[tx], h = 1 << TXHL[tx];
    if (p == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < max_x4) top = std::max(top, (int)above_level[p][x4 + k]);
      for (int k = 0; k < h4; k++)
        if (y4 + k < max_y4) left = std::max(left, (int)left_level[p][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if ((4 << BW4L[mi_size]) == w && (4 << BH4L[mi_size]) == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < max_x4) above |= above_level[p][x4 + i] | above_dc[p][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < max_y4) left |= left_level[p][y4 + i] | left_dc[p][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      int pb = plane_block(mi_size, ssx, ssy);
      if ((4 << BW4L[pb]) * (4 << BH4L[pb]) > w * h) ctx += 3;
    }
    int all_zero = ms.sym(cdf.txb_skip[txsz_ctx][ctx], 2);
    int eob = 0, cul = 0, dc_cat = 0;
    if (all_zero) {
      cur_tx_type = DCT_DCT;
    } else {
      int txtype;
      if (p == 0) {
        // transform_type
        int set = get_tx_set(tx);
        int qidx = f.seg_enabled ? qindex(true) : f.base_q_idx;
        txtype = DCT_DCT;
        if (set > 0 && qidx > 0) {
          int dir = use_filter_intra ? FILTER_TO_DIR[filter_mode] : ymode;
          int sqr = tx_sqr(tx);
          if (set == TX_SET_INTRA_1) txtype = INV_SET1[ms.sym(cdf.set1[sqr][dir], 7)];
          else txtype = INV_SET2[ms.sym(cdf.set2[sqr][dir], 5)];
        }
        if (lossless) txtype = WHT_WHT;
        else if (tx_sqr_up(tx) > TX_32X32) txtype = DCT_DCT;
        luma_tx_type = txtype;
      } else {
        if (lossless) txtype = WHT_WHT;
        else if (tx_sqr_up(tx) > TX_32X32) txtype = DCT_DCT;
        else {
          int set = get_tx_set(tx);
          txtype = MODE_TO_TXFM[uvmode];
          if (!in_set(set, txtype)) txtype = DCT_DCT;
        }
      }
      cur_tx_type = txtype;
      const int cls = txtype == WHT_WHT ? TX_CLASS_2D : tx_class(txtype);
      const uint16_t *scan = get_scan(tx, txtype);
      const int eob_multi = std::min((int)TXWL[tx], 5) + std::min((int)TXHL[tx], 5) - 4;
      const int ectx = cls == TX_CLASS_2D ? 0 : 1;
      int eob_pt;
      switch (eob_multi) {
        case 0: eob_pt = ms.sym(cdf.eob16[ptype][ectx], 5); break;
        case 1: eob_pt = ms.sym(cdf.eob32[ptype][ectx], 6); break;
        case 2: eob_pt = ms.sym(cdf.eob64[ptype][ectx], 7); break;
        case 3: eob_pt = ms.sym(cdf.eob128[ptype][ectx], 8); break;
        case 4: eob_pt = ms.sym(cdf.eob256[ptype][ectx], 9); break;
        case 5: eob_pt = ms.sym(cdf.eob512[ptype], 10); break;
        default: eob_pt = ms.sym(cdf.eob1024[ptype], 11); break;
      }
      eob_pt += 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (ms.sym(cdf.eob_extra[txsz_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          eob_shift = std::max(0, eob_pt - 2) - 1 - i;
          if (ms.lit(1)) eob += 1 << eob_shift;
        }
      }
      const int area = txh << bwl;
      memset(quant, 0, sizeof(int32_t) * area);
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          int bctx = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
          level = ms.sym(cdf.base_eob[txsz_ctx][ptype][bctx], 3) + 1;
        } else {
          level = ms.sym(cdf.base[txsz_ctx][ptype][base_ctx(tx, cls, bwl, txh, pos)], 4);
        }
        if (level > 2) {
          int brc = br_ctx(cls, bwl, txh, pos);
          for (int idx = 0; idx < 4; idx++) {
            int k = ms.sym(cdf.br[std::min(txsz_ctx, 3)][ptype][brc], 4);
            level += k;
            if (k < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dcs = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < max_x4) {
                int sg = above_dc[p][x4 + k];
                if (sg == 1) dcs--;
                else if (sg == 2) dcs++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < max_y4) {
                int sg = left_dc[p][y4 + k];
                if (sg == 1) dcs--;
                else if (sg == 2) dcs++;
              }
            int dctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
            sign = ms.sym(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = ms.lit(1);
          }
        }
        if (quant[pos] > 14) {
          count(C_golomb);
          int length = 0, bit;
          do {
            length++;
            bit = ms.lit(1);
            if (length > 32) invalid("a coefficient's Golomb code is too long");
          } while (!bit);
          int xg = 1;
          for (int i = length - 2; i >= 0; i--) xg = (xg << 1) | ms.lit(1);
          quant[pos] = xg + 14;
        }
        if (pos == 0 && quant[pos] > 0) dc_cat = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = std::min(63, cul);
      count(txtype == WHT_WHT ? C_txt_wht : txtype == IDTX ? C_txt_idtx
            : txtype == V_DCT ? C_txt_v_dct : txtype == H_DCT ? C_txt_h_dct
            : C_txt_dct_dct + txtype);
      if (eob == 1) count(C_dc_only);
    }
    for (int i = 0; i < w4; i++) {
      above_level[p][x4 + i] = (uint8_t)cul;
      above_dc[p][x4 + i] = (uint8_t)dc_cat;
    }
    for (int i = 0; i < h4; i++) {
      left_level[p][y4 + i] = (uint8_t)cul;
      left_dc[p][y4 + i] = (uint8_t)dc_cat;
    }
    return eob;
  }
  int cur_tx_type = 0, luma_tx_type = 0;

  const uint16_t *get_scan(int tx, int txtype) {
    if (tx == TX_16X64) return av1_default_scan_16x32;
    if (tx == TX_64X16) return av1_default_scan_32x16;
    if (tx_sqr_up(tx) == TX_64X64) return av1_default_scan_32x32;
    if (txtype == WHT_WHT) return av1_default_scan_4x4;
    bool prow = txtype == V_DCT || txtype == V_ADST || txtype == V_FLIPADST;
    bool pcol = txtype == H_DCT || txtype == H_ADST || txtype == H_FLIPADST;
    if (txtype == IDTX) prow = pcol = false;
#define SCAN3(sz)                                                   \
  return prow ? av1_mrow_scan_##sz : pcol ? av1_mcol_scan_##sz      \
                                          : av1_default_scan_##sz
    switch (tx) {
      case TX_4X4: SCAN3(4x4);
      case TX_8X8: SCAN3(8x8);
      case TX_16X16: SCAN3(16x16);
      case TX_4X8: SCAN3(4x8);
      case TX_8X4: SCAN3(8x4);
      case TX_8X16: SCAN3(8x16);
      case TX_16X8: SCAN3(16x8);
      case TX_4X16: SCAN3(4x16);
      case TX_16X4: SCAN3(16x4);
      case TX_32X32: return av1_default_scan_32x32;
      case TX_16X32: return av1_default_scan_16x32;
      case TX_32X16: return av1_default_scan_32x16;
      case TX_8X32: return av1_default_scan_8x32;
      case TX_32X8: return av1_default_scan_32x8;
      default: return av1_default_scan_32x32;
    }
#undef SCAN3
  }

  int base_ctx(int tx, int cls, int bwl, int txh, int pos) {
    static const int sig_ref[3][5][2] = {
        {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
        {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
        {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
    const int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int i = 0; i < 5; i++) {
      int rr = row + sig_ref[cls][i][0], cc = col + sig_ref[cls][i][1];
      if (rr < txh && cc < (1 << bwl)) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (cls == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      const int w = TXWL[tx], h = TXHL[tx];
      int off;
      if (w < h && row < 2) off = 11;
      else if (w > h && col < 2) off = 16;
      else if (row + col < 2) off = 1;
      else if (row + col < 4) off = 6;
      else off = 21;
      return ctx + off;
    }
    int idx = cls == TX_CLASS_VERT ? row : col;
    static const int pos_off[3] = {26, 31, 36};
    return ctx + pos_off[std::min(idx, 2)];
  }

  int br_ctx(int cls, int bwl, int txh, int pos) {
    static const int mag_ref[3][3][2] = {
        {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
    const int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int i = 0; i < 3; i++) {
      int rr = row + mag_ref[cls][i][0], cc = col + mag_ref[cls][i][1];
      if (rr < txh && cc < (1 << bwl)) mag += std::min(quant[rr * (1 << bwl) + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
    if (cls == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
    return row == 0 ? mag + 7 : mag + 14;
  }

  void reconstruct(int p, int x, int y, int tx, int eob) {
    const int qidx = qindex(false);
    int dcq, acq;
    if (p == 0) {
      dcq = av1_dc_qlookup[clip3(0, 255, qidx + f.dq_y_dc)];
      acq = av1_ac_qlookup[clip3(0, 255, qidx)];
    } else if (p == 1) {
      dcq = av1_dc_qlookup[clip3(0, 255, qidx + f.dq_u_dc)];
      acq = av1_ac_qlookup[clip3(0, 255, qidx + f.dq_u_ac)];
    } else {
      dcq = av1_dc_qlookup[clip3(0, 255, qidx + f.dq_v_dc)];
      acq = av1_ac_qlookup[clip3(0, 255, qidx + f.dq_v_ac)];
    }
    const int pels = 1 << (TXWL[tx] + TXHL[tx]);
    const int shift = (pels > 256) + (pels > 1024);
    const int cw = 1 << std::min((int)TXWL[tx], 5), ch = 1 << std::min((int)TXHL[tx], 5);
    static thread_local int32_t coef[32 * 32];
    memset(coef, 0, sizeof(int32_t) * cw * ch);
    const uint16_t *scan = get_scan(tx, cur_tx_type);
    for (int c = 0; c < eob; c++) {
      int pos = scan[c];
      int q = quant[pos];
      if (!q) continue;
      int64_t dq = (int64_t)std::abs(q) * (pos == 0 ? dcq : acq);
      dq &= 0xFFFFFF;
      dq >>= shift;
      if (dq > 32767) dq = 32767;
      coef[pos] = (int32_t)(q < 0 ? -dq : dq);
    }
    inverse_transform_add(coef, tx, cur_tx_type, cur_tx_type == WHT_WHT, pl[p].at(x, y), pl[p].stride);
  }

  // ---- deblocking ----------------------------------------------------------
  void loop_filter() {
    if (!f.lf_level[0] && !f.lf_level[1]) return;
    count(C_loop_filter);
    if (f.lf_sharpness) count(C_lf_sharpness);
    for (int p = 0; p < np; p++) {
      if (p > 0 && !f.lf_level[1 + p]) continue;
      const int ssx = p ? sx : 0, ssy = p ? sy : 0;
      for (int pass = 0; pass < 2; pass++) {
        const int rstep = p ? (1 << ssy) : 1, cstep = p ? (1 << ssx) : 1;
        for (int row = 0; row < f.mi_rows; row += rstep)
          for (int col = 0; col < f.mi_cols; col += cstep) edge(p, pass, row, col, ssx, ssy);
      }
    }
  }

  int filter_level(int row, int col, int p, int pass) {
    const BlockInfo *b = info_at(row, col);
    int i = p == 0 ? pass : p + 1;
    int lvl = clip3(0, 63, b->delta_lf[f.delta_lf_multi ? i : 0] + f.lf_level[i]);
    if (f.seg_enabled && f.seg_feature_enabled[b->seg][1 + i])
      lvl = clip3(0, 63, lvl + f.seg_feature_data[b->seg][1 + i]);
    if (f.lf_delta_enabled) {
      int nshift = lvl >> 5;
      lvl = clip3(0, 63, lvl + (f.lf_ref_deltas[0] * (1 << nshift)));
    }
    return lvl;
  }

  void edge(int p, int pass, int row, int col, int ssx, int ssy) {
    const int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
    const int x = col * 4, y = row * 4;
    row |= ssy;
    col |= ssx;
    if (x >= f.width || y >= f.height) return;
    if (pass == 0 && x == 0) return;
    if (pass == 1 && y == 0) return;
    const int xp = x >> ssx, yp = y >> ssy;
    const int prow = row - (dy << ssy), pcol = col - (dx << ssx);
    const int tx = lf_tx[p][(size_t)(row >> ssy) * lf_stride[p] + (col >> ssx)];
    const int ptx = lf_tx[p][(size_t)(prow >> ssy) * lf_stride[p] + (pcol >> ssx)];
    const bool is_tx_edge = pass == 0 ? (xp % (1 << TXWL[tx]) == 0) : (yp % (1 << TXHL[tx]) == 0);
    if (!is_tx_edge) return;
    int base_size = pass == 0 ? std::min(1 << TXWL[ptx], 1 << TXWL[tx])
                              : std::min(1 << TXHL[ptx], 1 << TXHL[tx]);
    int fsize = p == 0 ? std::min(16, base_size) : std::min(8, base_size);
    int lvl = filter_level(row, col, p, pass);
    if (lvl == 0) lvl = filter_level(prow, pcol, p, pass);
    if (lvl == 0) return;
    const int sh = f.lf_sharpness;
    const int shift = sh > 4 ? 2 : sh > 0 ? 1 : 0;
    const int limit = sh > 0 ? clip3(1, 9 - sh, lvl >> shift) : std::max(1, lvl >> shift);
    const int blimit = 2 * (lvl + 2) + limit;
    const int thresh = lvl >> 4;
    for (int i = 0; i < 4; i++) sample_filter(p, xp + dy * i, yp + dx * i, limit, blimit, thresh, dx, dy, fsize);
  }

  void sample_filter(int p, int x, int y, int limit, int blimit, int thresh, int dx, int dy, int fsize) {
    Plane &P = pl[p];
    const int step = dx ? 1 : P.stride;
    uint8_t *c0 = P.at(x, y);
    auto F = [&](int k) -> int { return c0[k * step]; };
    const int q0 = F(0), q1 = F(1), q2 = F(2), q3 = F(3);
    const int p0 = F(-1), p1 = F(-2), p2 = F(-3), p3 = F(-4);
    const bool hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int flen;
    if (fsize == 4) flen = 4;
    else if (p != 0) flen = 6;
    else if (fsize == 8) flen = 8;
    else flen = 16;
    bool mask;
    if (flen == 4)
      mask = std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
             std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    else if (flen == 6)
      mask = std::abs(p2 - p1) > limit || std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
             std::abs(q2 - q1) > limit || std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    else
      mask = std::abs(p3 - p2) > limit || std::abs(p2 - p1) > limit || std::abs(p1 - p0) > limit ||
             std::abs(q1 - q0) > limit || std::abs(q2 - q1) > limit || std::abs(q3 - q2) > limit ||
             std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    if (mask) return;
    bool flat = false, flat2 = false;
    if (fsize >= 8) {
      if (flen == 6)
        flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
               std::abs(q2 - q0) <= 1;
      else
        flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
               std::abs(q2 - q0) <= 1 && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
    }
    if (fsize >= 16) {
      const int q4 = F(4), q5 = F(5), q6 = F(6), p4 = F(-5), p5 = F(-6), p6 = F(-7);
      flat2 = std::abs(p6 - p0) <= 1 && std::abs(q6 - q0) <= 1 && std::abs(p5 - p0) <= 1 &&
              std::abs(q5 - q0) <= 1 && std::abs(p4 - p0) <= 1 && std::abs(q4 - q0) <= 1;
    }
    if (fsize == 4 || !flat) {
      auto c4 = [](int v) { return clip3(-128, 127, v); };
      int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
      int filt = hev ? c4(ps1 - qs1) : 0;
      filt = c4(filt + 3 * (qs0 - ps0));
      int f1 = c4(filt + 4) >> 3, f2 = c4(filt + 3) >> 3;
      c0[0] = (uint8_t)(c4(qs0 - f1) + 128);
      c0[-step] = (uint8_t)(c4(ps0 + f2) + 128);
      if (!hev) {
        int fl = round2(f1, 1);
        c0[step] = (uint8_t)(c4(qs1 - fl) + 128);
        c0[-2 * step] = (uint8_t)(c4(ps1 + fl) + 128);
      }
      return;
    }
    const int log2 = (fsize == 8 || !flat2) ? 3 : 4;
    int n;
    if (log2 == 4) n = 6;
    else if (p == 0) n = 3;
    else n = 2;
    const int n2 = (log2 == 3 && p == 0) ? 0 : 1;
    int in[16], outv[16];
    for (int k = -(n + 1); k <= n; k++) in[k + 8] = F(k);
    for (int i = -n; i < n; i++) {
      int t = 0;
      for (int j = -n; j <= n; j++) {
        int pp = clip3(-(n + 1), n, i + j);
        int tap = std::abs(j) <= n2 ? 2 : 1;
        t += in[pp + 8] * tap;
      }
      outv[i + 8] = round2(t, log2);
    }
    for (int i = -n; i < n; i++) c0[i * step] = (uint8_t)outv[i + 8];
  }

  // ---- loop restoration ------------------------------------------------------
  std::vector<uint8_t> pre[3];  // the deblocked frame, read by the filters
  int stripe_start, stripe_end, plane_end_x, plane_end_y;
  int src(int p, int x, int y) {
    x = std::max(0, std::min(plane_end_x, x));
    y = std::max(0, std::min(plane_end_y, y));
    if (y < stripe_start) y = std::max(stripe_start - 2, y);
    else if (y > stripe_end) y = std::min(stripe_end + 2, y);
    return pre[p][(size_t)y * pl[p].stride + x];
  }

  void loop_restoration() {
    if (!f.uses_lr) return;
    count(C_lr_frames);
    if (f.lr_type[0] == RESTORE_SWITCHABLE || f.lr_type[1] == RESTORE_SWITCHABLE ||
        f.lr_type[2] == RESTORE_SWITCHABLE)
      count(C_lr_switchable);
    for (int p = 0; p < np; p++)
      if (f.lr_type[p] != RESTORE_NONE) pre[p] = pl[p].buf;
    for (int y = 0; y < f.height; y += 4)
      for (int x = 0; x < f.width; x += 4)
        for (int p = 0; p < np; p++)
          if (f.lr_type[p] != RESTORE_NONE) restore_block(p, y >> 2, x >> 2);
  }

  void restore_block(int p, int row, int col) {
    const int ssx = p ? sx : 0, ssy = p ? sy : 0;
    const int luma_y = row * 4;
    const int stripe = (luma_y + 8) / 64;
    stripe_start = (-8 + stripe * 64) >> ssy;
    stripe_end = stripe_start + (64 >> ssy) - 1;
    const int us = f.lr_size[p];
    const int ur = std::min(lr_rows[p] - 1, ((row * 4 + 8) >> ssy) / us);
    const int uc = std::min(lr_cols[p] - 1, ((col * 4) >> ssx) / us);
    plane_end_x = round2(f.width, ssx) - 1;
    plane_end_y = round2(f.height, ssy) - 1;
    const int x = (col * 4) >> ssx, y = (row * 4) >> ssy;
    const int bw = std::min(4 >> ssx, plane_end_x - x + 1);
    const int bh = std::min(4 >> ssy, plane_end_y - y + 1);
    if (bw <= 0 || bh <= 0) return;
    const size_t idx = (size_t)ur * lr_cols[p] + uc;
    const int type = lr_unit_type[p][idx];
    const int16_t *co = &lr_unit_coef[p][idx * 6];
    if (type == RESTORE_WIENER) wiener(p, co, x, y, bw, bh);
    else if (type == RESTORE_SGRPROJ) sgr(p, co, x, y, bw, bh);
  }

  void wiener(int p, const int16_t *co, int x, int y, int w, int h) {
    int vf[7], hf[7];
    auto get = [](const int16_t *c, int *fl) {
      fl[3] = 128;
      for (int i = 0; i < 3; i++) {
        fl[i] = c[i];
        fl[6 - i] = c[i];
        fl[3] -= 2 * c[i];
      }
    };
    get(co, vf);
    get(co + 3, hf);
    const int r0 = 3, r1 = 11;
    const int offset = 1 << (8 + 7 - r0 - 1);
    const int limit = (1 << (8 + 1 + 7 - r0)) - 1;
    int inter[10][4];
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int s_ = 0;
        for (int t = 0; t < 7; t++) s_ += hf[t] * src(p, x + c + t - 3, y + r - 3);
        int v = round2(s_, r0);
        inter[r][c] = clip3(-offset, limit - offset, v);
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int s_ = 0;
        for (int t = 0; t < 7; t++) s_ += vf[t] * inter[r + t][c];
        *pl[p].at(x + c, y + r) = clip1(round2(s_, r1));
      }
  }

  void box_filter(int p, int x, int y, int w, int h, int set, int pass, int F[4][4]) {
    const int r = av1_sgr_params[set][pass * 2];
    const int sv = av1_sgr_params[set][pass * 2 + 1];
    const int n = (2 * r + 1) * (2 * r + 1);
    const int one_over_n = ((1 << 12) + (n / 2)) / n;
    int A[6][6], B[6][6];
    for (int i = -1; i < h + 1; i++)
      for (int j = -1; j < w + 1; j++) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = src(p, x + j + dx, y + i + dy);
            a += c * c;
            b += c;
          }
        int64_t pp = std::max<int64_t>(0, (int64_t)a * n - (int64_t)b * b);
        int64_t z = round2l(pp * sv, 20);
        int a2;
        if (z >= 255) a2 = 256;
        else if (z == 0) a2 = 1;
        else a2 = (int)(((z << 8) + (z / 2)) / (z + 1));
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
        A[i + 1][j + 1] = a2;
        B[i + 1][j + 1] = (int)round2l(b2, 12);
      }
    for (int i = 0; i < h; i++) {
      int shift = 5;
      if (pass == 0 && (i & 1)) shift = 4;
      for (int j = 0; j < w; j++) {
        int64_t a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int wt;
            if (pass == 0) wt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else wt = (dx == 0 || dy == 0) ? 4 : 3;
            a += wt * A[i + dy + 1][j + dx + 1];
            b += wt * B[i + dy + 1][j + dx + 1];
          }
        int64_t v = a * pre[p][(size_t)(y + i) * pl[p].stride + x + j] + b;
        F[i][j] = (int)round2l(v, 8 + shift - 4);
      }
    }
  }

  void sgr(int p, const int16_t *co, int x, int y, int w, int h) {
    const int set = co[0];
    int f0[4][4], f1[4][4];
    const int r0 = av1_sgr_params[set][0], r1 = av1_sgr_params[set][2];
    if (r0) box_filter(p, x, y, w, h, set, 0, f0);
    if (r1) box_filter(p, x, y, w, h, set, 1, f1);
    const int w0 = co[1], w1 = co[2], w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int u = pre[p][(size_t)(y + i) * pl[p].stride + x + j] << 4;
        int64_t v = (int64_t)w1 * u;
        v += r0 ? (int64_t)w0 * f0[i][j] : (int64_t)w0 * u;
        v += r1 ? (int64_t)w2 * f1[i][j] : (int64_t)w2 * u;
        *pl[p].at(x + j, y + i) = clip1((int)round2l(v, 11));
      }
  }
};

// ---- YUV to RGB as libavif 1.3.0 converts for PIL ------------------------
// 8-bit YUV to 8-bit RGB / RGBA goes through libyuv 1909 for the BT.601,
// BT.709 and BT.2020 matrices (an unspecified one is BT.601): chroma
// upsampled with ScaleRowUp2_Linear / ScaleRowUp2_Bilinear (the "Any"
// wrappers: the first and last sample copied or blended 3:1 vertically,
// the first and last rows of 4:2:0 horizontal only), then YuvPixel's
// 6-bit fixed point.  4:0:0 to RGB and the identity matrix (4:4:4) go
// through libavif's own code, which maps limited range with
// avifLimitedToFullY; 4:0:0 to RGBA through libyuv's I400ToARGBMatrix.
// A premultiplied image is divided by its alpha with libyuv's
// ARGBUnattenuate as it runs on x86 (a 16-bit high multiply saturated to
// a signed word, so alpha 1 turns samples of 128 and more into 0).
struct YuvConst {
  int yg, yb, ub, ug, vg, vr;
};
const YuvConst YUV_I601 = {18997, -1160, 128, 25, 52, 102};
const YuvConst YUV_JPEG = {16320, 32, 113, 22, 46, 90};
const YuvConst YUV_H709 = {18997, -1160, 128, 14, 34, 115};
const YuvConst YUV_F709 = {16320, 32, 119, 12, 30, 101};
const YuvConst YUV_2020 = {19003, -1160, 128, 12, 42, 107};
const YuvConst YUV_V2020 = {16320, 32, 120, 11, 37, 94};

inline void yuv_pixel(int y, int u, int v, const YuvConst &c, uint8_t *rgb) {
  const int bb = c.ub * 128 - c.yb, bg = c.ug * 128 + c.vg * 128 + c.yb,
            br = c.vr * 128 - c.yb;
  const int y1 = (int)((uint32_t)(y * 0x0101 * c.yg) >> 16);
  rgb[0] = clip1((y1 + v * c.vr - br) >> 6);
  rgb[1] = clip1((y1 + bg - (u * c.ug + v * c.vg)) >> 6);
  rgb[2] = clip1((y1 + u * c.ub - bb) >> 6);
}
inline int limited_to_full_y(int y) { return clip3(0, 255, ((y - 16) * 255 + 109) / 219); }

void up_linear(const uint8_t *s, int w, int *out) {
  out[0] = s[0];
  const int ww = (w - 1) & ~1;
  for (int x = 0; x < ww / 2; x++) {
    out[1 + 2 * x] = (3 * s[x] + s[x + 1] + 2) >> 2;
    out[2 + 2 * x] = (s[x] + 3 * s[x + 1] + 2) >> 2;
  }
  out[w - 1] = s[(w - 1) / 2];
}
void up_bilinear(const uint8_t *sa, const uint8_t *sb, int w, int *da, int *db) {
  da[0] = (3 * sa[0] + sb[0] + 2) >> 2;
  db[0] = (sa[0] + 3 * sb[0] + 2) >> 2;
  const int ww = (w - 1) & ~1;
  for (int x = 0; x < ww / 2; x++) {
    const int s0 = sa[x], s1 = sa[x + 1], t0 = sb[x], t1 = sb[x + 1];
    da[1 + 2 * x] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4;
    da[2 + 2 * x] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4;
    db[1 + 2 * x] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4;
    db[2 + 2 * x] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4;
  }
  const int k = (w - 1) / 2;
  da[w - 1] = (3 * sa[k] + sb[k] + 2) >> 2;
  db[w - 1] = (sa[k] + 3 * sb[k] + 2) >> 2;
}

}  // namespace

extern "C" {

// layout: 0 4:4:4, 1 4:2:2, 2 4:2:0, 3 4:0:0.  -> 0, or ERR_REFUSED for a
// matrix libavif converts with code not ported here
int rsn_avif_to_rgb(const uint8_t *y, int64_t ys, const uint8_t *u, int64_t us,
                    const uint8_t *v, int64_t vs, const uint8_t *a, int64_t as,
                    int w, int h, int layout, int matrix, int full_range,
                    int premultiplied, uint8_t *out, int64_t os, int channels) {
  const YuvConst *c;
  switch (matrix) {
    case 1: c = full_range ? &YUV_F709 : &YUV_H709; break;
    case 2: case 5: case 6: c = full_range ? &YUV_JPEG : &YUV_I601; break;
    case 9: c = full_range ? &YUV_V2020 : &YUV_2020; break;
    case 0: c = nullptr; break;
    // libavif refuses these (AVIF_RESULT_NOT_IMPLEMENTED)
    case 3: case 10: case 11: case 13: case 14: return ERR_INVALID;
    case 8: return full_range ? ERR_REFUSED : ERR_INVALID;
    // its floating-point path (4, 7, 12, 15) is not ported
    default: return matrix >= 16 ? ERR_INVALID : ERR_REFUSED;
  }
  if (!c && (layout == 1 || layout == 2)) return ERR_INVALID;
  if (!c && layout == 3) return ERR_REFUSED;
  // libavif un-premultiplies the identity matrix's limited range in float
  if (!c && premultiplied && !full_range && channels == 4) return ERR_REFUSED;
  std::vector<int> ua(w), va(w), ub(w), vb(w);
  int chroma_row = 0;
  for (int r = 0; r < h; r++) {
    const uint8_t *yr = y + r * ys;
    uint8_t *o = out + r * os;
    if (layout == 3) {
      for (int x = 0; x < w; x++) {
        uint8_t *px = o + x * channels;
        if (channels == 3) {
          px[0] = px[1] = px[2] = (uint8_t)(full_range ? yr[x] : limited_to_full_y(yr[x]));
        } else {
          yuv_pixel(yr[x], 128, 128, *c, px);
        }
      }
    } else if (!c) {  // identity: G = Y, B = U, R = V
      for (int x = 0; x < w; x++) {
        uint8_t *px = o + x * channels;
        int gy = yr[x], bu = u[r * us + x], rv = v[r * vs + x];
        if (!full_range) {
          gy = limited_to_full_y(gy);
          bu = limited_to_full_y(bu);
          rv = limited_to_full_y(rv);
        }
        px[0] = (uint8_t)rv;
        px[1] = (uint8_t)gy;
        px[2] = (uint8_t)bu;
      }
    } else {
      const int *uu, *vv;
      if (layout == 0) {
        for (int x = 0; x < w; x++) {
          ua[x] = u[r * us + x];
          va[x] = v[r * vs + x];
        }
        uu = ua.data();
        vv = va.data();
      } else if (layout == 1) {
        up_linear(u + r * us, w, ua.data());
        up_linear(v + r * vs, w, va.data());
        uu = ua.data();
        vv = va.data();
      } else if (r == 0 || (r == h - 1 && (r & 1))) {
        // the first row, and the last of an even height: one chroma row
        up_linear(u + chroma_row * us, w, ua.data());
        up_linear(v + chroma_row * vs, w, va.data());
        uu = ua.data();
        vv = va.data();
      } else if (r & 1) {
        up_bilinear(u + chroma_row * us, u + (chroma_row + 1) * us, w, ua.data(), ub.data());
        up_bilinear(v + chroma_row * vs, v + (chroma_row + 1) * vs, w, va.data(), vb.data());
        uu = ua.data();
        vv = va.data();
      } else {
        uu = ub.data();
        vv = vb.data();
        chroma_row++;
      }
      for (int x = 0; x < w; x++) yuv_pixel(yr[x], uu[x], vv[x], *c, o + x * channels);
    }
    if (channels == 4) {
      const uint8_t *ar = a + r * as;
      for (int x = 0; x < w; x++) {
        uint8_t *px = o + x * 4;
        const int al = ar[x];
        px[3] = (uint8_t)al;
        if (premultiplied && al != 255) {
          const uint32_t ia = al == 0 ? 0 : al == 1 ? 0xffff : 0x10000 / al;
          for (int k = 0; k < 3; k++) {
            uint32_t t = ((uint32_t)px[k] * 257 * ia) >> 16;
            px[k] = t >= 32768 ? 0 : (uint8_t)std::min<uint32_t>(t, 255);
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// ---- OBUs -------------------------------------------------------------------
struct Obu {
  int type, tid, sid;  // the OBU type, its temporal and spatial layer
  const uint8_t *data;
  size_t size;
};

std::vector<Obu> split_obus(const uint8_t *d, size_t n) {
  std::vector<Obu> out;
  size_t pos = 0;
  while (pos < n) {
    uint8_t h = d[pos];
    int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
    size_t hl = 1 + ext;
    if (pos + hl > n) invalid("an OBU header runs past the data");
    const int tid = ext ? d[pos + 1] >> 5 : 0, sid = ext ? (d[pos + 1] >> 3) & 3 : 0;
    size_t sz;
    if (has_size) {
      uint64_t v = 0;
      int i = 0;
      while (true) {
        if (pos + hl >= n) invalid("an OBU size runs past the data");
        uint8_t b = d[pos + hl];
        hl++;
        v |= (uint64_t)(b & 0x7f) << (7 * i);
        i++;
        if (!(b & 0x80)) break;
        if (i >= 8) invalid("an OBU size is too long");
      }
      sz = (size_t)v;
    } else {
      sz = n - pos - hl;
    }
    if (sz > n - pos - hl) invalid("an OBU runs past the data");
    out.push_back({type, tid, sid, d + pos + hl, sz});
    pos += hl + sz;
  }
  return out;
}

struct Result {
  int width = 0, height = 0, sx = 0, sy = 0, mono = 0, bitdepth = 8;
  int cp = 2, tc = 2, mc = 2, range = 0;
};

// A tile group: its data, where its first tile starts, its tiles' range.
struct TileGroup {
  const uint8_t *data;
  size_t size, pos;
  int start, end;
};

[[noreturn]] void bad_planes(const std::string &m) { throw Fail{ERR_SHAPE, m}; }

// Decode an item's OBUs as dav1d decodes them for PIL, which runs it with
// frame threads on more than one core: every OBU of the item is parsed,
// and the first frame is the one decoded.  planes == nullptr only parses
// the headers into res; else nplanes planes of dims (rows, columns each)
// are written, after their count and shapes are checked against the frame.
void decode(const uint8_t *data, size_t size, Result &res, uint8_t *const *planes,
            const int64_t *strides, const int *dims, int nplanes, uint64_t *counts) {
  std::vector<Obu> obus = split_obus(data, size);
  std::unique_ptr<Decoder> holder(new Decoder());
  Decoder &D = *holder;
  D.counts = counts;
  bool have_frame_header = false, complete = false, header_obu = false;
  std::vector<TileGroup> tile_groups;
  int next_tile = 0;
  auto add_tile_group = [&](const uint8_t *d, size_t n) {
    const FrameHdr &F = D.f;
    const int ntiles = F.tile_cols * F.tile_rows;
    Bits b(d, n);
    int start = 0, end = ntiles - 1;
    if (ntiles > 1 && b.f(1)) {
      int bits = F.tile_cols_log2 + F.tile_rows_log2;
      start = b.f(bits);
      end = b.f(bits);
    }
    b.byte_align();
    if (start != next_tile || end < start || end >= ntiles) invalid("tile groups out of order");
    tile_groups.push_back({d, n, b.byte_pos(), start, end});
    next_tile = end + 1;
    complete = next_tile == ntiles;
  };
  for (const Obu &o : obus) {
    if (o.type == 1) {
      SeqHdr s;
      Bits b(o.data, o.size);
      parse_seq(b, s);
      // after the frame's last tile a new sequence would start with the
      // next frame; before it, dav1d drops the frame header its tiles need
      if (complete) continue;
      if (have_frame_header && !same_sequence(s, D.s))
        invalid("a new sequence header between a frame header and its tiles");
      D.s = s;
    } else if (o.type == 3 || o.type == 5 || o.type == 6) {
      if (complete) refuse("a second frame after it in the item");
      if (o.type == 5 && have_frame_header) continue;  // a redundant copy
      if (!D.s.seen) invalid("a frame before any sequence header");
      // a frame header anew: dav1d drops the tiles read before it
      D.f = FrameHdr();
      tile_groups.clear();
      next_tile = 0;
      Bits b(o.data, o.size);
      parse_frame_header(b, D.s, D.f, o.tid, o.sid);
      have_frame_header = true;
      header_obu = o.type != 6;
      if (o.type == 6) {
        b.byte_align();
        size_t fh_end = b.byte_pos();
        if (fh_end > o.size) invalid("a frame header runs past its OBU");
        add_tile_group(o.data + fh_end, o.size - fh_end);
      } else {
        b.f(1);  // trailing_one_bit, inside the OBU
      }
    } else if (o.type == 4) {
      if (!have_frame_header || complete) invalid("a tile group without its frame header");
      add_tile_group(o.data, o.size);
    }
    // temporal delimiters, tile lists (large-scale tiles, which dav1d does
    // not decode), metadata, padding and reserved types: skipped
  }
  if (!D.s.seen) invalid("no sequence header");
  if (!have_frame_header) invalid("no frame header");
  if (!complete) invalid("a frame's tiles are missing");
  FrameHdr &F = D.f;
  SeqHdr &S = D.s;
  res.width = F.width;
  res.height = F.height;
  res.sx = S.mono ? 1 : S.sx;
  res.sy = S.mono ? 1 : S.sy;
  res.mono = S.mono;
  res.bitdepth = S.bitdepth;
  res.cp = S.cp;
  res.tc = S.tc;
  res.mc = S.mc;
  res.range = S.range;
  if (!planes) return;
  const int n = S.mono ? 1 : 3;
  if (nplanes != n) bad_planes(std::to_string(n) + " planes expected, " + std::to_string(nplanes) + " given");
  int pw[3], ph[3];
  for (int p = 0; p < n; p++) {
    const int ssx = p ? res.sx : 0, ssy = p ? res.sy : 0;
    pw[p] = (F.width + ssx) >> ssx;
    ph[p] = (F.height + ssy) >> ssy;
    if (dims[2 * p] != ph[p] || dims[2 * p + 1] != pw[p])
      bad_planes("plane " + std::to_string(p) + " is (" + std::to_string(dims[2 * p]) + ", " +
                 std::to_string(dims[2 * p + 1]) + "), not (" + std::to_string(ph[p]) + ", " +
                 std::to_string(pw[p]) + ")");
  }
  counts[C_frames]++;
  counts[S.mono ? C_mono : (S.sx && S.sy) ? C_s420 : S.sx ? C_s422 : C_s444]++;
  counts[S.range ? C_full_range : C_limited_range]++;
  counts[S.sb128 ? C_sb128 : C_sb64]++;
  if (!S.reduced) counts[C_full_headers]++;
  if (S.decoder_model) counts[C_decoder_model]++;
  if (header_obu) counts[C_frame_header_obus]++;
  if (F.delta_q_present) counts[C_delta_q]++;
  if (F.delta_lf_present) counts[C_delta_lf]++;
  if (!F.uniform_tiles) counts[C_explicit_tiles]++;
  if (F.seg_enabled) {
    counts[C_segmentation]++;
    for (int i = 0; i < 8; i++) {
      if (F.seg_feature_enabled[i][0]) counts[C_seg_alt_q]++;
      for (int j = 1; j < 5; j++)
        if (F.seg_feature_enabled[i][j]) counts[C_seg_alt_lf]++;
      if (F.seg_feature_enabled[i][6]) counts[C_seg_skip]++;
    }
  }
  if (F.reduced_tx_set) counts[C_reduced_tx_set]++;
  if (F.tx_mode_select) counts[C_tx_mode_select]++;
  if (F.disable_cdf_update) counts[C_disable_cdf_update]++;
  if (F.allow_sct) counts[C_screen_content]++;
  D.alloc();
  init_cdfs(D.frame_cdf, F.base_q_idx);
  for (const TileGroup &tg : tile_groups) {
    size_t pos = tg.pos;
    for (int t = tg.start; t <= tg.end; t++) {
      size_t tsize;
      if (t == tg.end) {
        if (pos > tg.size) invalid("a tile group ends early");
        tsize = tg.size - pos;
      } else {
        if (pos + F.tile_size_bytes > tg.size) invalid("a tile size runs past the data");
        uint64_t v = 0;
        for (int i = 0; i < F.tile_size_bytes; i++) v |= (uint64_t)tg.data[pos + i] << (8 * i);
        pos += F.tile_size_bytes;
        tsize = (size_t)v + 1;
        if (tsize > tg.size - pos) invalid("a tile runs past the data");
      }
      if (tsize == 0) invalid("an empty tile");
      counts[C_tiles]++;
      D.decode_tile(tg.data + pos, tsize, t / F.tile_cols, t % F.tile_cols);
      // dav1d's check: the symbol decoder read more than 15 bits past the
      // tile's data
      if (D.ms.cnt < -15) invalid("a tile's symbols run past its data");
      pos += tsize;
    }
  }
  D.loop_filter();
  D.loop_restoration();
  for (int p = 0; p < n; p++)
    for (int y = 0; y < ph[p]; y++) memcpy(planes[p] + y * strides[p], D.pl[p].at(0, y), pw[p]);
}

}  // namespace

extern "C" {

const char *rsn_av1_count_names() { return COUNT_NAMES; }
int rsn_av1_count_len() { return C_NUM; }

// Decode into nplanes planes (Y, or Y, U, V) of dims (6 ints: rows and
// columns of each) and strides, adding each tool's uses to counts, and
// fill info as rsn_av1_probe does.  planes == nullptr: the probe.  -> 0,
// ERR_INVALID / ERR_REFUSED, or ERR_SHAPE for planes of another count or
// shape than the frame's, before anything is written.
int rsn_av1_decode(const uint8_t *data, size_t size, int *info, uint8_t *const *planes,
                   const int64_t *strides, const int *dims, int nplanes, uint64_t *counts,
                   char *err, int errlen) {
  try {
    Result r;
    decode(data, size, r, planes, strides, dims, nplanes, counts);
    int v[10] = {r.width, r.height, r.sx, r.sy, r.mono, r.bitdepth, r.cp, r.tc, r.mc, r.range};
    memcpy(info, v, sizeof(v));
    return 0;
  } catch (const Fail &e) {
    snprintf(err, errlen, "%s", e.msg.c_str());
    return e.kind;
  } catch (const std::bad_alloc &) {
    snprintf(err, errlen, "out of memory");
    return ERR_INVALID;
  }
}

// info (10 ints): width, height, subsampling x, y, monochrome, bit depth,
// colour primaries, transfer, matrix, full range.  -> 0, or ERR_INVALID /
// ERR_REFUSED with the reason in err.
int rsn_av1_probe(const uint8_t *data, size_t size, int *info, char *err, int errlen) {
  return rsn_av1_decode(data, size, info, nullptr, nullptr, nullptr, 0, nullptr, err, errlen);
}

}  // extern "C"
