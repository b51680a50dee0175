// A JPEG decoder that gives the pixels of libjpeg-turbo 3.1.3's default
// decompression, as PIL's `np.asarray(Image.open(path))` reads them: every
// frame PIL opens (8-bit precision; 1, 3 or 4 components) and libjpeg
// decodes.  That is sequential and progressive DCT frames, Huffman or
// arithmetic coded (SOF0-2, SOF9, SOF10), and lossless Huffman frames
// (SOF3); "L", "RGB" or "CMYK" (PIL's inverted "CMYK;I" bytes).
//
// The stages follow libjpeg-turbo's sources, so that every step rounds as
// theirs does:
//   - markers (jdmarker.c): SOI, APP0 (JFIF), APP14 (Adobe, its transform
//     byte), DQT (8- and 16-bit entries), SOFn, DHT (redefinable between
//     scans), DAC, DRI, SOS, RSTn, EOI; COM and other APPn are skipped;
//     decoding stops at the first EOI (an MPO file gives its first image);
//   - Huffman decoding (jdhuff.c, jdphuff.c, jdlhuff.c): a sequential
//     frame's DC / AC table 0 or 1 that no DHT defined by its first scan is
//     Annex K.3's (jstdhuff.c, Motion-JPEG's frames); a progressive or
//     lossless scan without its table is refused, as libjpeg refuses it;
//   - arithmetic decoding (jdarith.c): the QM decoder and its Qe table
//     (jaricom.c), the DC statistics conditioned on DAC's L / U bounds and
//     the AC statistics on Kx, a restart resetting the statistics and the
//     predictors, a marker met inside the data feeding zero bits;
//   - every scan into one whole-image coefficient buffer, as
//     jpeg_start_decompress takes in every scan of a multi-scan file before
//     its first output row; progressive spectral selection and successive
//     approximation, EOB runs, restart intervals;
//   - progressive block smoothing (jdcoefct.c's smoothing_ok and
//     decompress_smooth_data): a file whose scans leave low-frequency bits
//     unsent has them estimated from the 5x5 neighbourhood of DC values
//     (and its DC too when no AC bit came), with that code's edges;
//   - the inverse DCT as libjpeg-turbo's SIMD jsimd_idct_islow computes it
//     on x86-64 (jidctint.c's algorithm in 16-bit lanes: dequantized
//     coefficients and some sums wrap, each pass's outputs saturate);
//   - lossless frames (jdlossls.c, jddiffct.c): predictors 1-7, the first
//     row of a scan and of each restart interval from 2^(7-Pt) and its left
//     neighbour, the first column from the sample above, the point
//     transform, one iMCU row differenced, then undifferenced;
//   - upsampling (jdsample.c's jinit_upsampler): fancy h2v1 and h2v2 where
//     the chroma is more than two samples wide, fancy h1v2, the context
//     rows of jdmainct.c repeating the first and last rows, and
//     replication (int_upsample) for every other integral ratio; lossless
//     frames replicate only;
//   - colour (jdcolor.c, its 16-bit fixed-point tables): YCbCr -> RGB,
//     YCCK -> CMYK, the colour space from jdapimin.c's
//     default_decompress_parms at the first scan; a lossless frame is
//     converted to nothing (libjpeg refuses YCbCr and YCCK there).
// What PIL or libjpeg refuses is refused: a precision other than 8,
// hierarchical (SOF5-7, SOF13-15) and lossless arithmetic (SOF11) frames,
// fractional sampling, 2 components.
//
// C interface (ctypes): rsn_probe_jpeg and rsn_decode_jpeg on the file's
// bytes.  Each returns 0, or 1 (a kind PIL or libjpeg refuses as well) or
// 2 (a corrupt or truncated file, or an output buffer of another size than
// the probe's) with a message.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

enum Code { kOk = 0, kRefused = 1, kCorrupt = 2 };

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) {
  throw Failure{code, what};
}

// jutils.c's jpeg_natural_order, with the 16 extra entries that keep a
// corrupt run length inside the block
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kMaxComponents = 4;
constexpr int kSavedCoefs = 10;    // jdcoefct.c: DC and the first 9 AC
constexpr int kArithTables = 16;   // NUM_ARITH_TBLS
// PIL refuses images of more pixels than this (Image.MAX_IMAGE_PIXELS * 2,
// DecompressionBombError) before it decodes them
constexpr int64_t kMaxPixels = 2 * int64_t{89478485};

// ---- Huffman tables (jdhuff.c's jpeg_make_d_derived_tbl) ----------------

struct HuffSpec {  // a DHT's table as sent
  bool defined = false;
  uint8_t counts[17] = {};
  uint8_t vals[256] = {};
  int n = 0;
};

// T.81 Annex K.3's tables (jstdhuff.c)
const uint8_t kStdCounts[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.3's table: 0 / 1 DC luminance / chrominance, 2 / 3 AC
HuffSpec std_table(int which) {
  HuffSpec s;
  std::memcpy(s.counts, kStdCounts[which], 17);
  for (int l = 1; l <= 16; l++) s.n += s.counts[l];
  const uint8_t* vals = which < 2 ? kStdDcVals
                                  : (which == 2 ? kStdAcLuma : kStdAcChroma);
  std::memcpy(s.vals, vals, s.n);
  s.defined = true;
  return s;
}

struct HuffTable {
  uint8_t values[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // 9-bit lookahead: (code length << 8) | symbol, 0 when longer
  uint16_t look[512] = {};

  // max_dc_symbol: 15 for a DCT frame's DC table, 16 for a lossless
  // frame's, -1 for an AC table (any byte)
  void build(const HuffSpec& spec, int max_dc_symbol) {
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < spec.counts[l]; i++)
        size[p++] = static_cast<uint8_t>(l);
    size[p] = 0;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1u << si)) fail(kCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (spec.counts[l]) {
        valoffset[l] = p - static_cast<int32_t>(code_of[p]);
        p += spec.counts[l];
        maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++)
      for (int i = 0; i < spec.counts[l]; i++, p++) {
        int lookbits = static_cast<int>(code_of[p] << (9 - l));
        for (int c = 0; c < (1 << (9 - l)); c++)
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | spec.vals[p]);
      }
    std::memcpy(values, spec.vals, spec.n);
    if (max_dc_symbol >= 0)
      for (int i = 0; i < spec.n; i++)
        if (spec.vals[i] > max_dc_symbol) fail(kCorrupt, "bad Huffman table");
  }
};

// ---- the bit reader of an entropy-coded segment (jdhuff.c) -------------

// The position of the next marker's FF from q, skipping what libjpeg's
// next_marker skips (other bytes, FF 00); the marker code in *code.
const uint8_t* find_marker(const uint8_t* q, const uint8_t* end, int* code) {
  for (;;) {
    while (q < end && *q != 0xFF) q++;
    const uint8_t* r = q;
    while (r < end && *r == 0xFF) r++;
    if (r >= end) fail(kCorrupt, "truncated file");
    if (*r != 0) {
      *code = *r;
      return r - 1;
    }
    q = r + 1;
  }
}

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;  // bits MSB-first
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (p >= end) fail(kCorrupt, "truncated file");
        byte = *p;
        if (byte == 0xFF) {  // FF 00 is a data FF; FF FF ... are fill bytes
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q >= end) fail(kCorrupt, "truncated file");
          if (*q == 0) {
            p = q + 1;
          } else {  // a marker: the segment gives zeros from here on
            at_marker = true;
            byte = 0;
          }
        } else {
          p++;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - n);
      n += 8;
    }
  }

  inline int bits(int k) {  // k in [0, 16]
    if (k == 0) return 0;
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }

  inline int bit() { return bits(1); }

  inline int decode(const HuffTable& t) {
    if (n < 16) fill();
    int peek = static_cast<int>(acc >> (64 - 9));
    int e = t.look[peek];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      n -= l;
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    if (l > 16) fail(kCorrupt, "bad Huffman code");
    acc <<= l;
    n -= l;
    return t.values[(code + t.valoffset[l]) & 0xFF];
  }

  void restart(int expected) {
    int code;
    const uint8_t* m = find_marker(p, end, &code);
    if (code != 0xD0 + expected)
      fail(kCorrupt, "missing restart marker");
    p = m + 2;
    acc = 0;
    n = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + static_cast<int>((~0u << s) + 1u) : v;
}

// The DC predictor plus a difference; libjpeg-turbo rejects a sum that
// overflows (JERR_BAD_DCT_COEF)
inline int add_dc(int last, int diff) {
  int64_t sum = int64_t{last} + diff;
  if (sum > INT32_MAX || sum < INT32_MIN) fail(kCorrupt, "bad DC coefficient");
  return static_cast<int>(sum);
}

// ---- the arithmetic decoder (jdarith.c, jaricom.c) -----------------------

// T.81 Table D.2 packed as jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed
// probability 0.5 of T.851
#define V(i, a, b, c, d) ((int64_t{a} << 16) | (int64_t{c} << 8) | ((d) << 7) | (b))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct ArithReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  int64_t c = 0;  // C register: base of the interval and the input bits
  int64_t a = 0;  // A register: the interval's normalized size
  int ct = -16;   // bits left in C's input part; -16 reads 2 bytes first
  bool at_marker = false;

  void start(const uint8_t* from, const uint8_t* to) {
    p = from;
    end = to;
    c = 0;
    a = 0;
    ct = -16;
    at_marker = false;
  }

  int get_byte() {
    if (p >= end) fail(kCorrupt, "truncated file");
    return *p++;
  }

  // arith_decode: one decision in the statistics bin *st
  inline int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and input, T.81 D.2.6
      if (--ct < 0) {
        int data = 0;
        if (!at_marker) {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {  // a marker: zeros from here on, the marker unread
              at_marker = true;
              p -= 2;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two bytes read: A becomes 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void restart(int expected) {
    int code;
    const uint8_t* m = find_marker(p, end, &code);
    if (code != 0xD0 + expected)
      fail(kCorrupt, "missing restart marker");
    start(m + 2, end);
  }
};

// ---- the frame -----------------------------------------------------------

// jdsample.c's upsampling method of a component
enum Upsample { kFullsize, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kReplicate };

// the colour space of default_decompress_parms
enum Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK, kRaw };
// a colour space the caller sets (libtiff's JPEG codec sets it, whatever
// the markers say): kKeep leaves jdapimin.c's choice
enum ForceColour { kKeep = -1, kNoConversion = 0, kToRgb = 1 };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;              // downsampled size
  int bw = 0, bh = 0;                  // data units with image data
  int bw_pad = 0, bh_pad = 0;          // data units to the MCU grid
  int dc_tbl = 0, ac_tbl = 0;
  int rh = 1, rv = 1;                  // the upsampling ratio
  Upsample up = kFullsize;
  bool quant_latched = false;
  int16_t quant[64] = {};              // natural order, ISLOW_MULT_TYPE
  int coef_bits[64];                   // jdphuff.c's coef_bits
  std::vector<int16_t> coef;           // bw_pad * bh_pad blocks of 64
  int stride = 0;                      // of plane: bw * 8, lossless bw
  std::vector<uint8_t> plane;          // stride by bh * 8 (lossless bh)
  // lossless (jddiffct.c): one iMCU row of differences and of
  // undifferenced samples (v rows of bw_pad), the undifferencer's state
  std::vector<int> diff, undiff;
  bool first_row = true;
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw_pad + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;

  bool saw_sof = false, saw_eoi = false;
  bool progressive = false, arith = false, lossless = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  Colour colour = kGray;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  int scan_number = 0;
  uint16_t qtables[4][64] = {};
  bool qdefined[4] = {};
  HuffSpec dc_specs[4], ac_specs[4];
  uint8_t arith_dc_l[kArithTables], arith_dc_u[kArithTables];
  uint8_t arith_ac_k[kArithTables];
  Component comp[kMaxComponents];

  // a TIFF strip: libjpeg itself decodes 2 components as well
  bool any_count = false;
  Decoder(const uint8_t* d, size_t len) : data(d), end(d + len), p(d) {
    for (int i = 0; i < kArithTables; i++) {  // jdmarker.c's defaults
      arith_dc_l[i] = 0;
      arith_dc_u[i] = 1;
      arith_ac_k[i] = 5;
    }
  }

  int byte() {
    if (p >= end) fail(kCorrupt, "truncated file");
    return *p++;
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {  // jdmarker.c's next_marker
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // Markers up to SOF (probe) or through EOI (decode).
  void run(bool header_only) {
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kCorrupt, "not a JPEG file");
    p = data + 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {  // EOI
        saw_eoi = true;
        return;
      }
      if (m == 0xD8) fail(kCorrupt, "a second SOI");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no parameters
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD: case 0xCE:
        case 0xCF:
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (word() != 4) fail(kCorrupt, "bad DRI length");
          restart_interval = word();
          break;
        case 0xDA:
          if (!saw_sof) fail(kCorrupt, "SOS before SOF");
          read_sos();
          break;
        case 0xE0: case 0xEE: read_app(m); break;
        default: skip_segment(); break;  // COM, other APPn, DNL, ...
      }
    }
  }

  void skip_segment() {
    int len = word();
    if (len < 2) fail(kCorrupt, "bad marker length");
    if (end - p < len - 2) fail(kCorrupt, "truncated file");
    p += len - 2;
  }

  void read_app(int m) {  // jdmarker.c's get_interesting_appn
    int len = word();
    if (len < 2) fail(kCorrupt, "bad marker length");
    int datalen = len - 2;
    if (end - p < datalen) fail(kCorrupt, "truncated file");
    const uint8_t* b = p;
    if (m == 0xE0 && datalen >= 14 && b[0] == 'J' && b[1] == 'F' &&
        b[2] == 'I' && b[3] == 'F' && b[4] == 0)
      saw_jfif = true;
    if (m == 0xEE && datalen >= 12 && b[0] == 'A' && b[1] == 'd' &&
        b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    p += datalen;
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq >= 4 || pq > 1) fail(kCorrupt, "bad DQT");
      int count = pq ? 128 : 64;
      if (len < 1 + count) fail(kCorrupt, "bad DQT length");
      for (int i = 0; i < 64; i++)
        qtables[tq][kNaturalOrder[i]] =
            static_cast<uint16_t>(pq ? word() : byte());
      qdefined[tq] = true;
      len -= 1 + count;
    }
    if (len != 0) fail(kCorrupt, "bad DQT length");
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 16) {
      int tc_th = byte();
      HuffSpec spec;
      for (int l = 1; l <= 16; l++) {
        spec.counts[l] = static_cast<uint8_t>(byte());
        spec.n += spec.counts[l];
      }
      len -= 17;
      if (spec.n > 256 || spec.n > len) fail(kCorrupt, "bad Huffman table");
      for (int i = 0; i < spec.n; i++) spec.vals[i] = static_cast<uint8_t>(byte());
      len -= spec.n;
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th >= 4 || tc > 1) fail(kCorrupt, "bad DHT table index");
      spec.defined = true;
      (tc ? ac_specs : dc_specs)[th] = spec;
    }
    if (len != 0) fail(kCorrupt, "bad DHT length");
  }

  void read_dac() {  // jdmarker.c's get_dac
    int len = word() - 2;
    while (len > 0) {
      int index = byte(), val = byte();
      len -= 2;
      if (index >= 2 * kArithTables) fail(kCorrupt, "bad DAC table index");
      if (index >= kArithTables) {
        arith_ac_k[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        arith_dc_l[index] = static_cast<uint8_t>(val & 15);
        arith_dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index])
          fail(kCorrupt, "bad DAC value");
      }
    }
    if (len != 0) fail(kCorrupt, "bad DAC length");
  }

  void read_sof(int m) {
    if (saw_sof) fail(kCorrupt, "a second SOF");
    saw_sof = true;
    int len = word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    // PIL's SOF handler refuses these before libjpeg sees the file
    if (precision != 8)
      fail(kRefused, std::to_string(precision) + "-bit precision (PIL "
                     "opens 8-bit frames only)");
    if (ncomp < 1 || ncomp > kMaxComponents ||
        (!any_count && ncomp == 2))
      fail(kRefused, std::to_string(ncomp) + " components (PIL opens 1, "
                     "3 or 4)");
    const std::string sof = "SOF" + std::to_string(m - 0xC0);
    if ((m >= 0xC5 && m <= 0xC7) || m >= 0xCD)
      fail(kRefused, "a hierarchical frame (" + sof + ", which libjpeg "
                     "does not decode)");
    if (m == 0xCB)
      fail(kRefused, "a lossless arithmetic-coded frame (SOF11, which "
                     "libjpeg-turbo does not decode)");
    progressive = (m == 0xC2 || m == 0xCA);
    arith = (m == 0xC9 || m == 0xCA);
    lossless = (m == 0xC3);
    if (height == 0) fail(kCorrupt, "empty image (DNL not supported)");
    if (width == 0) fail(kCorrupt, "empty image");
    if (int64_t{width} * height > kMaxPixels)
      fail(kCorrupt, "more pixels than PIL's decompression-bomb limit");
    if (len != 8 + ncomp * 3) fail(kCorrupt, "bad SOF length");
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.id = byte();
      int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail(kCorrupt, "bad sampling factors");
      max_h = std::max(max_h, k.h);
      max_v = std::max(max_v, k.v);
    }
    const int du = lossless ? 1 : 8;  // samples across a data unit
    mcus_x = (width + du * max_h - 1) / (du * max_h);
    mcus_y = (height + du * max_v - 1) / (du * max_v);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      // jinit_upsampler's choice; fancy upsampling needs DCT blocks
      // (min_DCT_scaled_size > 1)
      if (max_h % k.h || max_v % k.v)
        fail(kRefused, "fractional sampling " + layout() + " (libjpeg: "
                       "\"Fractional sampling not implemented yet\")");
      k.rh = max_h / k.h;
      k.rv = max_v / k.v;
      k.ds_w = static_cast<int>((static_cast<int64_t>(width) * k.h + max_h - 1) / max_h);
      k.ds_h = static_cast<int>((static_cast<int64_t>(height) * k.v + max_v - 1) / max_v);
      const bool fancy = !lossless;
      if (k.rh == 1 && k.rv == 1) k.up = kFullsize;
      else if (k.rh == 2 && k.rv == 1)
        k.up = fancy && k.ds_w > 2 ? kH2V1Fancy : kReplicate;
      else if (k.rh == 1 && k.rv == 2 && fancy) k.up = kH1V2Fancy;
      else if (k.rh == 2 && k.rv == 2)
        k.up = fancy && k.ds_w > 2 ? kH2V2Fancy : kReplicate;
      else k.up = kReplicate;  // int_upsample
      k.bw = (k.ds_w + du - 1) / du;
      k.bh = (k.ds_h + du - 1) / du;
      k.bw_pad = mcus_x * k.h;
      k.bh_pad = mcus_y * k.v;
      k.stride = k.bw * du;
      for (int i = 0; i < 64; i++) k.coef_bits[i] = -1;
    }
  }

  std::string layout() const {
    std::string s;
    for (int c = 0; c < ncomp; c++) {
      if (c) s += ",";
      s += std::to_string(comp[c].h) + "x" + std::to_string(comp[c].v);
    }
    return s;
  }

  void allocate() {
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      if (lossless) {
        if (k.plane.empty()) {
          k.plane.assign(static_cast<size_t>(k.stride) * k.bh, 0);
          k.diff.assign(static_cast<size_t>(k.v) * k.bw_pad, 0);
          k.undiff.assign(static_cast<size_t>(k.v) * k.bw_pad, 0);
        }
      } else if (k.coef.empty()) {
        k.coef.assign(static_cast<size_t>(k.bw_pad) * k.bh_pad * 64, 0);
      }
    }
  }

  // jdapimin.c's default_decompress_parms, at the first scan, and
  // jdcolor.c's refusal of a conversion in a lossless frame
  void choose_colour() {
    if (ncomp == 1) {
      colour = kGray;
    } else if (ncomp == 3) {
      const int c0 = comp[0].id, c1 = comp[1].id, c2 = comp[2].id;
      if (saw_jfif) colour = kYCbCr;
      else if (saw_adobe) colour = adobe_transform == 0 ? kRGB : kYCbCr;
      else if (c0 == 1 && c1 == 2 && c2 == 3) colour = lossless ? kRGB : kYCbCr;
      else if (c0 == 82 && c1 == 71 && c2 == 66) colour = kRGB;
      else colour = lossless ? kRGB : kYCbCr;
    } else {
      colour = saw_adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    }
    if (lossless && (colour == kYCbCr || colour == kYCCK))
      fail(kRefused, std::string("a lossless frame in ") +
                         (colour == kYCbCr ? "YCbCr" : "YCCK") +
                         " (libjpeg converts no colour in a lossless frame)");
  }

  // ---- a scan ----

  int ss = 0, se = 63, ah = 0, al = 0;
  int ns = 0;
  Component* scomp[4] = {};
  int last_dc[4] = {};
  int eobrun = 0;
  BitReader br;
  // the arithmetic decoder's state (jdarith.c's arith_entropy_decoder)
  ArithReader ar;
  uint8_t dc_stats[kArithTables][64];
  uint8_t ac_stats[kArithTables][256];
  uint8_t fixed_bin = 113;
  int dc_context[4] = {};
  bool arith_error = false;  // ct == -1: a bad code, nothing until a restart

  void read_sos() {
    int len = word();
    ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + ns * 2) fail(kCorrupt, "bad SOS");
    for (int i = 0; i < ns; i++) {
      int cs = byte(), t = byte();
      Component* k = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == cs) k = &comp[c];
      if (k == nullptr) fail(kCorrupt, "bad component id in SOS");
      for (int j = 0; j < i; j++)
        if (scomp[j] == k) fail(kCorrupt, "a component twice in one scan");
      k->dc_tbl = t >> 4;
      k->ac_tbl = t & 15;
      scomp[i] = k;
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    if (scan_number++ == 0) {
      choose_colour();
      // jinit_huff_decoder's std_huff_tables: a sequential Huffman
      // frame's tables 0 and 1 that no DHT defined are Annex K.3's
      if (!progressive && !arith && !lossless)
        for (int t = 0; t < 2; t++) {
          if (!dc_specs[t].defined) dc_specs[t] = std_table(t);
          if (!ac_specs[t].defined) ac_specs[t] = std_table(2 + t);
        }
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += scomp[i]->h * scomp[i]->v;
      if (blocks > 10) fail(kCorrupt, "too many blocks in an MCU");
    }
    allocate();
    if (!lossless)
      for (int i = 0; i < ns; i++) {  // jdinput.c's latch_quant_tables
        Component* k = scomp[i];
        if (!k->quant_latched) {
          if (!qdefined[k->tq]) fail(kCorrupt, "no quantization table");
          for (int j = 0; j < 64; j++)
            k->quant[j] = static_cast<int16_t>(qtables[k->tq][j]);
          k->quant_latched = true;
        }
      }
    if (progressive) check_progression();
    if (arith) {
      ar.start(p, end);
    } else {
      br = BitReader();
      br.p = p;
      br.end = end;
    }
    if (lossless) decode_lossless_scan();
    else decode_scan();
    int code;
    p = find_marker(arith ? ar.p : br.p, end, &code);
  }

  void check_progression() {  // start_pass_phuff_decoder / jdarith's
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (ns != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail(kCorrupt, "bad progression parameters");
    for (int i = 0; i < ns; i++)
      for (int c = ss; c <= se; c++) scomp[i]->coef_bits[c] = al;
  }

  // jpeg_make_d_derived_tbl: the scan's table, refused when no DHT (or
  // the sequential frame's defaults) defined it
  void derive(HuffTable* out, bool dc, int i) {
    if (i > 3)
      fail(kCorrupt, "a Huffman table number above 3");
    const HuffSpec& spec = dc ? dc_specs[i] : ac_specs[i];
    if (!spec.defined)
      fail(kRefused, std::string("a scan whose ") + (dc ? "DC" : "AC") +
                         " Huffman table " + std::to_string(i) +
                         " no DHT defined (libjpeg supplies Annex K.3's "
                         "tables 0 and 1 to sequential frames only)");
    out->build(spec, dc ? (lossless ? 16 : 15) : -1);
  }

  // jdarith.c's start_pass / process_restart: the statistics of the
  // scan's tables and the DC predictors to zero
  void arith_reset() {
    for (int i = 0; i < ns; i++) {
      Component* k = scomp[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[k->dc_tbl], 0, 64);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss)
        std::memset(ac_stats[k->ac_tbl], 0, 256);
    }
    arith_error = false;
  }

  HuffTable dct[4], act[4];

  void decode_scan() {
    for (int i = 0; i < 4; i++) last_dc[i] = 0;
    eobrun = 0;
    int mode;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!progressive) mode = 0;
    else if (ss == 0) mode = ah == 0 ? 1 : 2;
    else mode = ah == 0 ? 3 : 4;
    if (arith) {
      arith_reset();
    } else {
      for (int i = 0; i < ns; i++) {
        if (mode == 0 || mode == 1) derive(&dct[i], true, scomp[i]->dc_tbl);
        if (mode == 0 || mode >= 3) derive(&act[i], false, scomp[i]->ac_tbl);
      }
    }
    int restarts_left = restart_interval, next_rst = 0;
    auto maybe_restart = [&]() {
      if (restart_interval == 0) return;
      if (restarts_left == 0) {
        if (arith) {
          ar.restart(next_rst);
          arith_reset();
        } else {
          br.restart(next_rst);
          for (int i = 0; i < 4; i++) last_dc[i] = 0;
          eobrun = 0;
        }
        next_rst = (next_rst + 1) & 7;
        restarts_left = restart_interval;
      }
      restarts_left--;
    };
    auto block = [&](int m, int16_t* blk, int ci) {
      if (!arith) decode_block(m, blk, ci, &dct[ci], &act[ci]);
      else if (!arith_error) arith_block(m, blk, ci);
    };
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component* k = scomp[0];
      for (int by = 0; by < k->bh; by++)
        for (int bx = 0; bx < k->bw; bx++) {
          maybe_restart();
          block(mode, k->block(bx, by), 0);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          maybe_restart();
          for (int i = 0; i < ns; i++) {
            Component* k = scomp[i];
            for (int y = 0; y < k->v; y++)
              for (int x = 0; x < k->h; x++)
                block(mode, k->block(mx * k->h + x, my * k->v + y), i);
          }
        }
    }
  }

  inline void decode_block(int mode, int16_t* blk, int ci,
                           const HuffTable* dct, const HuffTable* act) {
    switch (mode) {
      case 0: {  // jdhuff.c's decode_mcu
        int s = br.decode(*dct);
        int diff = s ? extend(br.bits(s), s) : 0;
        last_dc[ci] = add_dc(last_dc[ci], diff);
        blk[0] = static_cast<int16_t>(last_dc[ci]);
        for (int k = 1; k < 64; k++) {
          int rs = br.decode(*act);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(br.bits(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        break;
      }
      case 1: {  // decode_mcu_DC_first
        int s = br.decode(*dct);
        int diff = s ? extend(br.bits(s), s) : 0;
        last_dc[ci] = add_dc(last_dc[ci], diff);
        blk[0] = static_cast<int16_t>(
            static_cast<uint32_t>(last_dc[ci]) << al);
        break;
      }
      case 2:  // decode_mcu_DC_refine
        if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        break;
      case 3:  // decode_mcu_AC_first
        if (eobrun > 0) {
          eobrun--;
          break;
        }
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(*act);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            int v = extend(br.bits(s), s);
            blk[kNaturalOrder[k]] =
                static_cast<int16_t>(static_cast<uint32_t>(v) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            eobrun--;
            break;
          }
        }
        break;
      case 4:
        ac_refine(blk, *act);
        break;
    }
  }

  void ac_refine(int16_t* blk, const HuffTable& act) {  // decode_mcu_AC_refine
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* c) {
      if (br.bit()) {
        if ((*c & p1) == 0) {
          if (*c >= 0) *c = static_cast<int16_t>(*c + p1);
          else *c = static_cast<int16_t>(*c + m1);
        }
      }
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a newly non-zero coefficient has size 1 (libjpeg warns and
          // goes on otherwise)
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = blk + kNaturalOrder[k];
          if (*c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = blk + kNaturalOrder[k];
        if (*c != 0) correct(c);
      }
      eobrun--;
    }
  }

  // ---- arithmetic-coded blocks (jdarith.c) ----

  // Figures F.19-F.24: a DC difference in the statistics of table tbl,
  // conditioned on component ci's context; false when no difference
  bool arith_dc_diff(int ci, int tbl, int* diff) {
    uint8_t* stats = dc_stats[tbl];
    uint8_t* st = stats + dc_context[ci];
    if (ar.decode(st) == 0) {
      dc_context[ci] = 0;
      return false;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = stats + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {  // magnitude overflow
          arith_error = true;
          return false;
        }
        st += 1;
      }
    }
    if (m < ((1 << arith_dc_l[tbl]) >> 1)) dc_context[ci] = 0;
    else if (m > ((1 << arith_dc_u[tbl]) >> 1)) dc_context[ci] = 12 + sign * 4;
    else dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // an AC coefficient's value after its EOB and zero-run decisions;
  // false on a magnitude overflow
  bool arith_ac_value(int k, int tbl, int* value) {
    uint8_t* stats = ac_stats[tbl];
    uint8_t* st = stats + 3 * (k - 1);
    int sign = ar.decode(&fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0) {
      if (ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= arith_ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            arith_error = true;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *value = sign ? -v : v;
    return true;
  }

  // the AC coefficients ss..se of a block; false on an error
  bool arith_ac(int16_t* blk, int tbl, int first, int last, int shift) {
    uint8_t* stats = ac_stats[tbl];
    for (int k = first; k <= last; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > last) {  // spectral overflow
          arith_error = true;
          return false;
        }
      }
      int v;
      if (!arith_ac_value(k, tbl, &v)) return false;
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << shift);
    }
    return true;
  }

  void arith_block(int mode, int16_t* blk, int ci) {
    Component* k = scomp[ci];
    switch (mode) {
      case 0: {  // decode_mcu
        int diff;
        if (arith_dc_diff(ci, k->dc_tbl, &diff))
          last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
        if (arith_error) return;
        blk[0] = static_cast<int16_t>(last_dc[ci]);
        arith_ac(blk, k->ac_tbl, 1, 63, 0);
        break;
      }
      case 1: {  // decode_mcu_DC_first
        int diff;
        if (arith_dc_diff(ci, k->dc_tbl, &diff))
          last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
        if (arith_error) return;
        blk[0] = static_cast<int16_t>(
            static_cast<uint32_t>(last_dc[ci]) << al);
        break;
      }
      case 2:  // decode_mcu_DC_refine
        if (ar.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        break;
      case 3:  // decode_mcu_AC_first
        arith_ac(blk, k->ac_tbl, ss, se, al);
        break;
      case 4: {  // decode_mcu_AC_refine
        uint8_t* stats = ac_stats[k->ac_tbl];
        const int p1 = 1 << al;
        const int m1 = -1 * (1 << al);
        int kex = se;  // the previous stage's end of block
        for (; kex > 0; kex--)
          if (blk[kNaturalOrder[kex]]) break;
        for (int kk = ss; kk <= se; kk++) {
          uint8_t* st = stats + 3 * (kk - 1);
          if (kk > kex)
            if (ar.decode(st)) break;  // EOB
          for (;;) {
            int16_t* c = blk + kNaturalOrder[kk];
            if (*c) {  // previously non-zero
              if (ar.decode(st + 2))
                *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
              break;
            }
            if (ar.decode(st + 1)) {  // newly non-zero
              *c = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++kk > se) {
              arith_error = true;
              return;
            }
          }
        }
        break;
      }
    }
  }

  // ---- a lossless scan (jddiffct.c, jdlhuff.c, jdlossls.c) ----

  // one row of component k: differences d into samples out, from the row
  // above (prev), by the component's undifferencer
  void undifference(Component* k, const int* d, const int* prev, int* out) {
    const int w = k->bw;
    if (k->first_row) {  // jpeg_undifference_first_row
      int ra = (d[0] + (1 << (7 - al))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) {
        ra = (d[x] + ra) & 0xFFFF;
        out[x] = ra;
      }
      k->first_row = false;
      return;
    }
    int rb = prev[0];
    int ra = (d[0] + rb) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < w; x++) {
      int rc = rb;
      rb = prev[x];
      int pred;
      switch (ss) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      ra = (d[x] + pred) & 0xFFFF;
      out[x] = ra;
    }
  }

  void decode_lossless_scan() {
    // start_pass_lossless's checks (an error there, as in libjpeg)
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      fail(kCorrupt, "bad lossless scan parameters");
    const bool interleaved = ns > 1;
    const int per_row = interleaved ? mcus_x : scomp[0]->bw;
    if (restart_interval % per_row)
      fail(kCorrupt, "a restart interval that is not a whole number of "
                     "MCU rows in a lossless scan");
    for (int i = 0; i < ns; i++) derive(&dct[i], true, scomp[i]->dc_tbl);
    for (int c = 0; c < ncomp; c++) comp[c].first_row = true;
    const int rows_per_interval = restart_interval / per_row;
    int rows_to_go = rows_per_interval, next_rst = 0;
    auto value = [&](int i) {
      int s = br.decode(dct[i]);
      if (s == 0) return 0;
      if (s == 16) return 32768;
      return extend(br.bits(s), s);
    };
    for (int r = 0; r < mcus_y; r++) {
      const bool last = r == mcus_y - 1;
      auto rows_in = [&](const Component* k) {
        if (!last) return k->v;
        int rem = k->bh % k->v;
        return rem ? rem : k->v;
      };
      const int mcu_rows = interleaved ? 1 : rows_in(scomp[0]);
      for (int yoff = 0; yoff < mcu_rows; yoff++) {
        if (restart_interval && rows_to_go == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int c = 0; c < ncomp; c++) comp[c].first_row = true;
          rows_to_go = rows_per_interval;
        }
        if (interleaved) {
          for (int mx = 0; mx < mcus_x; mx++)
            for (int i = 0; i < ns; i++) {
              Component* k = scomp[i];
              for (int y = 0; y < k->v; y++)
                for (int x = 0; x < k->h; x++)
                  k->diff[static_cast<size_t>(y) * k->bw_pad + mx * k->h + x] =
                      value(i);
            }
        } else {
          Component* k = scomp[0];
          int* row = k->diff.data() + static_cast<size_t>(yoff) * k->bw_pad;
          for (int x = 0; x < per_row; x++) row[x] = value(0);
        }
        if (restart_interval) rows_to_go--;
      }
      // the iMCU row's rows undifferenced and scaled
      for (int i = 0; i < ns; i++) {
        Component* k = scomp[i];
        const int n = rows_in(k);
        for (int row = 0; row < n; row++) {
          const int prev = row == 0 ? k->v - 1 : row - 1;
          int* out = k->undiff.data() + static_cast<size_t>(row) * k->bw_pad;
          undifference(k, k->diff.data() + static_cast<size_t>(row) * k->bw_pad,
                       k->undiff.data() + static_cast<size_t>(prev) * k->bw_pad,
                       out);
          uint8_t* o = k->plane.data() +
                       static_cast<size_t>(r * k->v + row) * k->stride;
          for (int x = 0; x < k->bw; x++)
            o[x] = static_cast<uint8_t>(out[x] << al);
        }
      }
    }
  }

  // ---- after the last scan ----

  // jdcoefct.c's smoothing_ok: true when libjpeg smooths the blocks
  bool would_smooth() const {
    if (!progressive) return false;
    static const int q_pos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp; c++) {
      const Component& k = comp[c];
      if (!k.quant_latched) return false;
      for (int i = 0; i < kSavedCoefs; i++)
        if (k.quant[q_pos[i]] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < kSavedCoefs; i++)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }
};

// ---- the inverse DCT (jidctint-sse2.asm / -avx2.asm, jsimd_idct_islow) ----
//
// libjpeg-turbo runs jpeg_idct_islow's algorithm in SIMD on x86-64, and
// its 16-bit lanes change what happens out of range (jidctint.c's range
// table would wrap instead):
//   - each coefficient times its quantizer keeps its low 16 bits (pmullw);
//   - a block whose rows 1-7 are all zero gives DC << 2 in 16 bits (psllw)
//     down every column;
//   - in0 + in4, in0 - in4 and the odd part's z3 = in7 + in3,
//     z4 = in5 + in1 wrap in 16 bits (paddw / psubw); the products with the
//     constants and their sums are 32-bit (pmaddwd / paddd), the constants
//     paired as jidctint's comments pair them;
//   - pass 1's outputs saturate to 16 bits (packssdw), pass 2's to 16 and
//     then to 8 bits (packsswb) before the +128 (paddb).
// In range this is jidctint.c's arithmetic term for term.

constexpr int32_t kF029 = 2446, kF039 = 3196, kF054 = 4433, kF076 = 6270,
                  kF089 = 7373, kF117 = 9633, kF150 = 12299, kF184 = 15137,
                  kF196 = 16069, kF205 = 16819, kF256 = 20995, kF307 = 25172;

inline int32_t wrap16(int32_t v) { return static_cast<int16_t>(v); }
inline int32_t wrap32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}
inline int32_t sat16(int32_t v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

// One 1-D pass over 8 values v[0], v[step], ..., descaled by `shift` with
// `bias` added first and saturated to 16 bits -> o[0], o[ostep], ...
void idct_pass(const int32_t* v, int step, int32_t* o, int ostep, int shift,
               int32_t bias) {
  const int64_t in0 = v[0], in1 = v[step], in2 = v[2 * step],
                in3 = v[3 * step], in4 = v[4 * step], in5 = v[5 * step],
                in6 = v[6 * step], in7 = v[7 * step];
  const int32_t tmp3 = wrap32(in2 * (kF054 + kF076) + in6 * kF054);
  const int32_t tmp2 = wrap32(in2 * kF054 + in6 * (kF054 - kF184));
  const int64_t tmp0 = int64_t{wrap16(static_cast<int32_t>(in0 + in4))} * 8192;
  const int64_t tmp1 = int64_t{wrap16(static_cast<int32_t>(in0 - in4))} * 8192;
  const int32_t t10 = wrap32(tmp0 + tmp3), t13 = wrap32(tmp0 - tmp3);
  const int32_t t11 = wrap32(tmp1 + tmp2), t12 = wrap32(tmp1 - tmp2);
  const int64_t z3 = wrap16(static_cast<int32_t>(in7 + in3));
  const int64_t z4 = wrap16(static_cast<int32_t>(in5 + in1));
  const int32_t z3p = wrap32(z3 * (kF117 - kF196) + z4 * kF117);
  const int32_t z4p = wrap32(z3 * kF117 + z4 * (kF117 - kF039));
  const int32_t o0 = wrap32(in7 * (kF029 - kF089) + in1 * -kF089 + z3p);
  const int32_t o3 = wrap32(in7 * -kF089 + in1 * (kF150 - kF089) + z4p);
  const int32_t o1 = wrap32(in5 * (kF205 - kF256) + in3 * -kF256 + z4p);
  const int32_t o2 = wrap32(in5 * -kF256 + in3 * (kF307 - kF256) + z3p);
  const int32_t out[8] = {wrap32(int64_t{t10} + o3), wrap32(int64_t{t11} + o2),
                          wrap32(int64_t{t12} + o1), wrap32(int64_t{t13} + o0),
                          wrap32(int64_t{t13} - o0), wrap32(int64_t{t12} - o1),
                          wrap32(int64_t{t11} - o2), wrap32(int64_t{t10} - o3)};
  for (int r = 0; r < 8; r++)
    o[r * ostep] = sat16(wrap32(int64_t{out[r]} + bias) >> shift);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int32_t deq[64], ws[64];
  bool ac_rows_zero = true;
  for (int i = 0; i < 64; i++) {
    deq[i] = wrap16(int32_t{in[i]} * q[i]);
    if (i >= 8 && in[i] != 0) ac_rows_zero = false;
  }
  if (ac_rows_zero) {
    for (int col = 0; col < 8; col++) {
      const int32_t dc = wrap16(deq[col] * 4);
      for (int r = 0; r < 8; r++) ws[r * 8 + col] = dc;
    }
  } else {
    for (int col = 0; col < 8; col++)
      idct_pass(deq + col, 8, ws + col, 8, 11, 1 << 10);
  }
  for (int row = 0; row < 8; row++) {
    int32_t o[8];
    idct_pass(ws + row * 8, 1, o, 1, 18, 1 << 17);
    uint8_t* dst = out + static_cast<size_t>(row) * stride;
    for (int i = 0; i < 8; i++) {
      const int32_t v = o[i] < -128 ? -128 : (o[i] > 127 ? 127 : o[i]);
      dst[i] = static_cast<uint8_t>(v + 128);
    }
  }
}

void inverse_dct(Component& k) {
  const int stride = k.bw * 8;
  k.plane.assign(static_cast<size_t>(stride) * k.bh * 8, 0);
  for (int by = 0; by < k.bh; by++)
    for (int bx = 0; bx < k.bw; bx++)
      idct_islow(k.block(bx, by), k.quant,
                 k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
                 stride);
}


// ---- block smoothing (jdcoefct.c's decompress_smooth_data) ----------------

// The IDCT of every block of component k, with the coefficients libjpeg
// estimates where the scans left bits unsent: coef_bits[1..9] (zigzag) say
// which AC coefficients are inexact; when none of them came at all, the DC
// is estimated too.  The DC values of a 5x5 neighbourhood feed each
// estimate, the columns clamped to the image's blocks and the rows chosen
// as decompress_smooth_data chooses them per iMCU row (its image_block_row
// counts the last iMCU row's rows from block_rows of that row).
void smooth_inverse_dct(Component& k, int total_imcu_rows) {
  const int stride = k.bw * 8;
  k.plane.assign(static_cast<size_t>(stride) * k.bh * 8, 0);
  const int* cb = k.coef_bits;  // zigzag positions 0-9
  bool change_dc = true;
  for (int i = 1; i < kSavedCoefs; i++)
    if (cb[i] != -1) change_dc = false;
  const int64_t q00 = k.quant[0], q01 = k.quant[1], q10 = k.quant[8],
                q20 = k.quant[16], q11 = k.quant[9], q02 = k.quant[2],
                q03 = k.quant[3], q12 = k.quant[10], q21 = k.quant[17],
                q30 = k.quant[24];
  const int last_imcu = total_imcu_rows - 1;
  const int last_col = k.bw - 1;
  int16_t ws[64];
  // pred = the rounded quotient num / (q << 8), clamped below 2^al
  auto estimate = [](int64_t num, int64_t q, int al) {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return static_cast<int16_t>(pred);
  };
  for (int r = 0; r < total_imcu_rows; r++) {
    int block_rows = k.v;
    if (r == last_imcu) {
      block_rows = k.bh % k.v;
      if (block_rows == 0) block_rows = k.v;
    }
    const int image_block_rows = block_rows * total_imcu_rows;
    for (int b = 0; b < block_rows; b++) {
      const int y = r * k.v + b;
      const int ibr = r * block_rows + b;
      const int prev = ibr > 0 ? y - 1 : y;
      const int pprev = ibr > 1 ? y - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? y + 1 : y;
      const int nnext = ibr < image_block_rows - 2 ? y + 2 : next;
      const int rows[5] = {pprev, prev, y, next, nnext};
      for (int x = 0; x < k.bw; x++) {
        int dc[5][5];  // DC01..DC25 row by row
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) {
            int col = std::min(std::max(x + j - 2, 0), last_col);
            dc[i][j] = k.block(col, rows[i])[0];
          }
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2],
                  DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0],
                  DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3],
                  DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                  DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
                  DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2],
                  DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0],
                  DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                  DC25 = dc[4][4];
        std::memcpy(ws, k.block(x, y), sizeof(ws));
        int64_t num;
        if (cb[1] != 0 && ws[1] == 0) {  // AC01
          num = q00 * (change_dc
                           ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                              13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                              38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                              DC22 + DC24 + DC25)
                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = estimate(num, q01, cb[1]);
        }
        if (cb[2] != 0 && ws[8] == 0) {  // AC10
          num = q00 * (change_dc
                           ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                              DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 -
                              DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                              3 * DC24 + DC25)
                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = estimate(num, q10, cb[2]);
        }
        if (cb[3] != 0 && ws[16] == 0) {  // AC20
          num = q00 * (change_dc
                           ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                              5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                              7 * DC18 + 2 * DC19 + DC23)
                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                              DC23));
          ws[16] = estimate(num, q20, cb[3]);
        }
        if (cb[4] != 0 && ws[9] == 0) {  // AC11
          num = q00 * (change_dc
                           ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25)
                           : (-DC02 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09 + DC10 + DC16 - 10 * DC17 +
                              10 * DC19 - DC20 + DC22 - DC24));
          ws[9] = estimate(num, q11, cb[4]);
        }
        if (cb[5] != 0 && ws[2] == 0) {  // AC02
          num = q00 * (change_dc
                           ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                              7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                              2 * DC17 - 5 * DC18 + 2 * DC19)
                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                              DC15));
          ws[2] = estimate(num, q02, cb[5]);
        }
        if (change_dc) {
          if (cb[6] != 0 && ws[3] == 0) {  // AC03
            num = q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = estimate(num, q03, cb[6]);
          }
          if (cb[7] != 0 && ws[10] == 0) {  // AC12
            num = q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = estimate(num, q12, cb[7]);
          }
          if (cb[8] != 0 && ws[17] == 0) {  // AC21
            num = q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = estimate(num, q21, cb[8]);
          }
          if (cb[9] != 0 && ws[24] == 0) {  // AC30
            num = q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = estimate(num, q30, cb[9]);
          }
          num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                       2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                       6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                       6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                       2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                       2 * DC25);
          ws[0] = estimate(num, q00, 0);
        }
        idct_islow(ws, k.quant,
                   k.plane.data() + static_cast<size_t>(y) * 8 * stride + x * 8,
                   stride);
      }
    }
  }
}

// ---- upsampling (jdsample.c) to a full-size row ---------------------------

// Row y of component k at the output's width (w samples).
void upsampled_row(const Component& k, int y, int w, uint8_t* out) {
  const int stride = k.stride;
  if (k.up == kFullsize) {
    std::memcpy(out, k.plane.data() + static_cast<size_t>(y) * stride, w);
    return;
  }
  const int cy = y / k.rv;
  const uint8_t* near = k.plane.data() + static_cast<size_t>(cy) * stride;
  if (k.up == kReplicate) {  // h2v1_upsample, h2v2_upsample, int_upsample
    if (k.rh == 1) {
      std::memcpy(out, near, w);
      return;
    }
    for (int x = 0; x < w; x++) out[x] = near[x / k.rh];
    return;
  }
  const int last = k.ds_w - 1;
  if (k.up == kH2V1Fancy) {
    for (int x = 0; x < w; x++) {
      int c = x >> 1;
      int v3 = near[c] * 3;
      if (x & 1) out[x] = static_cast<uint8_t>((v3 + near[std::min(c + 1, last)] + 2) >> 2);
      else out[x] = static_cast<uint8_t>((v3 + near[std::max(c - 1, 0)] + 1) >> 2);
    }
    return;
  }
  // h1v2 / h2v2 fancy; the context rows of jdmainct.c repeat the first and
  // last real rows
  int fy = (y & 1) ? std::min(cy + 1, k.ds_h - 1) : std::max(cy - 1, 0);
  const uint8_t* far = k.plane.data() + static_cast<size_t>(fy) * stride;
  if (k.up == kH1V2Fancy) {
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < w; x++)
      out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    return;
  }
  auto colsum = [&](int c) { return near[c] * 3 + far[c]; };
  for (int x = 0; x < w; x++) {
    int c = x >> 1;
    int t3 = colsum(c) * 3;
    if (x & 1) out[x] = static_cast<uint8_t>((t3 + colsum(std::min(c + 1, last)) + 7) >> 4);
    else out[x] = static_cast<uint8_t>((t3 + colsum(std::max(c - 1, 0)) + 8) >> 4);
  }
}

// ---- colour (jdcolor.c) -----------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t{1} << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t{1} << 16) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Image {
  int height = 0, width = 0, channels = 0;
  std::vector<uint8_t> pixels;
};

void decode(const uint8_t* data, size_t len, Image* img,
            int force = kKeep) {
  Decoder d(data, len);
  d.any_count = force != kKeep;
  d.run(false);
  if (!d.saw_sof) fail(kCorrupt, "no frame");
  if (d.scan_number == 0) fail(kCorrupt, "no scan");
  if (force == kToRgb) {  // jpeg_color_space JCS_YCbCr, out JCS_RGB
    if (d.ncomp != 3) fail(kCorrupt, "YCbCr data of other than 3 components");
    d.colour = kYCbCr;
  } else if (force == kNoConversion) {  // JCS_UNKNOWN: null_convert
    d.colour = d.ncomp == 1 ? kGray : kRaw;
  }
  d.allocate();
  if (!d.lossless) {
    const bool smooth = d.would_smooth();
    for (int c = 0; c < d.ncomp; c++) {
      if (smooth) smooth_inverse_dct(d.comp[c], d.mcus_y);
      else inverse_dct(d.comp[c]);
    }
  }
  const int w = d.width, h = d.height, nc = d.ncomp;
  img->height = h;
  img->width = w;
  img->channels = nc;
  img->pixels.resize(static_cast<size_t>(h) * w * nc);
  std::vector<uint8_t> rows(static_cast<size_t>(w) * nc);
  for (int y = 0; y < h; y++) {
    for (int c = 0; c < nc; c++)
      upsampled_row(d.comp[c], y, w, rows.data() + static_cast<size_t>(c) * w);
    const uint8_t* r0 = rows.data();
    const uint8_t* r1 = r0 + w;
    const uint8_t* r2 = r1 + w;
    const uint8_t* r3 = r2 + w;
    uint8_t* o = img->pixels.data() + static_cast<size_t>(y) * w * nc;
    switch (d.colour) {
      case kGray:
        std::memcpy(o, r0, w);
        break;
      case kRGB:
        for (int x = 0; x < w; x++) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        break;
      case kYCbCr:
        for (int x = 0; x < w; x++) {  // ycc_rgb_convert
          int yy = r0[x], cb = r1[x], cr = r2[x];
          o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
          o[3 * x + 1] = clamp255(
              yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
        }
        break;
      case kCMYK:  // null_convert, then PIL's "CMYK;I" inversion
        for (int x = 0; x < w; x++) {
          o[4 * x] = static_cast<uint8_t>(255 - r0[x]);
          o[4 * x + 1] = static_cast<uint8_t>(255 - r1[x]);
          o[4 * x + 2] = static_cast<uint8_t>(255 - r2[x]);
          o[4 * x + 3] = static_cast<uint8_t>(255 - r3[x]);
        }
        break;
      case kRaw:  // the components as they are, interleaved
        for (int c = 0; c < nc; c++) {
          const uint8_t* r = rows.data() + static_cast<size_t>(c) * w;
          for (int x = 0; x < w; x++) o[nc * x + c] = r[x];
        }
        break;
      case kYCCK:
        // ycck_cmyk_convert gives 255 - clamp(Y + ...) per ink, which PIL
        // inverts back to clamp(Y + ...); K passes through, inverted
        for (int x = 0; x < w; x++) {
          int yy = r0[x], cb = r1[x], cr = r2[x];
          o[4 * x] = clamp255(yy + kYcc.cr_r[cr]);
          o[4 * x + 1] = clamp255(
              yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
          o[4 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
          o[4 * x + 3] = static_cast<uint8_t>(255 - r3[x]);
        }
        break;
    }
  }
}

void set_message(char* msg, int msg_len, const std::string& s) {
  if (msg == nullptr || msg_len <= 0) return;
  size_t n = std::min(s.size(), static_cast<size_t>(msg_len - 1));
  std::memcpy(msg, s.data(), n);
  msg[n] = 0;
}

}  // namespace

extern "C" {

// The frame's height, width and channels (1 for "L", 3 for "RGB", 4 for
// "CMYK") from the markers up to SOF; what PIL refuses there is reported.
int rsn_probe_jpeg(const uint8_t* data, int64_t len, int* height, int* width,
                   int* channels, char* msg, int msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.run(true);
    if (!d.saw_sof) fail(kCorrupt, "no frame");
    *height = d.height;
    *width = d.width;
    *channels = d.ncomp;
    return kOk;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
    return f.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return kCorrupt;
  }
}

// The whole image into out (height * width * channels bytes, row-major).
int rsn_decode_jpeg(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_len, char* msg, int msg_len) {
  try {
    Image img;
    decode(data, static_cast<size_t>(len), &img);
    if (static_cast<int64_t>(img.pixels.size()) != out_len)
      fail(kCorrupt, "output buffer of the wrong size");
    std::memcpy(out, img.pixels.data(), img.pixels.size());
    return kOk;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
    return f.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return kCorrupt;
  }
}

// One JPEG strip or tile of a TIFF, as libtiff's JPEG codec decodes it
// (tif_jpeg.c's JPEGPreDecode): the JPEGTables tag's abbreviated stream
// (tables, tables_len; 0 for none) read first, then the strip's stream; a
// stream of the strip's width and at least its height (a taller last
// strip is cut); rgb: YCbCr to RGB (JPEGCOLORMODE_RGB), else the
// components as they are (JCS_UNKNOWN).  out: height rows of width *
// comps bytes.
int rsn_decode_tiff_jpeg(const uint8_t* tables, int64_t tables_len,
                         const uint8_t* data, int64_t len, uint8_t* out,
                         int width, int height, int comps, int rgb,
                         char* msg, int msg_len) {
  try {
    std::vector<uint8_t> stream;
    if (tables_len >= 4) {  // its SOI and tables, without its EOI
      int64_t end = tables_len;
      if (tables[end - 2] == 0xFF && tables[end - 1] == 0xD9) end -= 2;
      stream.assign(tables, tables + end);
      if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
        data += 2;
        len -= 2;
      }
    }
    stream.insert(stream.end(), data, data + len);
    Image img;
    decode(stream.data(), stream.size(), &img, rgb ? kToRgb : kNoConversion);
    if (img.channels != comps)
      fail(kCorrupt, "improper JPEG component count");
    if (img.width != width || img.height < height)
      fail(kCorrupt, "a JPEG of another size than the strip or tile (" +
                         std::to_string(img.width) + "x" +
                         std::to_string(img.height) + ", expected " +
                         std::to_string(width) + "x" +
                         std::to_string(height) + ")");
    std::memcpy(out, img.pixels.data(),
                static_cast<size_t>(height) * width * comps);
    return kOk;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
    return f.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
    return kCorrupt;
  }
}

}  // extern "C"
