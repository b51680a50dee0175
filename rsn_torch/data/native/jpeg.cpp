// A JPEG decoder that gives the pixels of libjpeg-turbo's default
// decompression, as PIL's `np.asarray(Image.open(path))` reads them:
// 8-bit baseline, extended sequential and progressive Huffman frames
// (SOF0, SOF1, SOF2), gray ("L") or three components ("RGB").
//
// The stages follow libjpeg-turbo's sources, so that every step rounds as
// theirs does:
//   - markers (jdmarker.c): SOI, APP0 (JFIF), APP14 (Adobe, its transform
//     byte), DQT (8- and 16-bit entries), SOFn, DHT (redefinable between
//     scans), DRI, SOS, RSTn, EOI; COM and other APPn are skipped; decoding
//     stops at the first EOI (an MPO file gives its first image);
//   - entropy decoding (jdhuff.c, jdphuff.c): every scan into one
//     whole-image coefficient buffer, as jpeg_start_decompress takes in
//     every scan of a multi-scan file before its first output row;
//     progressive spectral selection and successive approximation, EOB
//     runs, restart intervals (DC predictors and the EOB run reset);
//   - the inverse DCT (jidctint.c, jpeg_idct_islow) and the post-IDCT
//     range-limit table of jdmaster.c;
//   - fancy upsampling of 2x1 and 2x2 chroma (jdsample.c: h2v1 and h2v2,
//     the first and last columns from downsampled_width; jdmainct.c's
//     context rows duplicate the first and last chroma rows), box
//     upsampling for chroma two samples wide or less, as jinit_upsampler
//     chooses;
//   - YCbCr -> RGB (jdcolor.c, its 16-bit fixed-point tables); the colour
//     space from jdapimin.c's default_decompress_parms.
// A complete progressive file needs no block smoothing (jdcoefct.c's
// smoothing_ok: every low-frequency bit is known); a file whose scans leave
// those bits out is reported as unsupported rather than decoded otherwise
// than libjpeg would.
//
// C interface (ctypes): rsn_probe_jpeg and rsn_decode_jpeg on the file's
// bytes.  Each returns 0, or 1 (a kind of JPEG this decoder leaves out) or
// 2 (a corrupt or truncated file, or an output buffer of another size than
// the probe's) with a message.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

enum Code { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

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

constexpr int kMaxComponents = 4;  // 1 and 3 are decoded, 4 is reported
constexpr int kSavedCoefs = 10;    // jdcoefct.c: DC and the first 9 AC
// PIL refuses images of more pixels than this (Image.MAX_IMAGE_PIXELS * 2,
// DecompressionBombError) before it decodes them
constexpr int64_t kMaxPixels = 2 * int64_t{89478485};

// ---- Huffman tables (jdhuff.c's jpeg_make_d_derived_tbl) ----------------

struct HuffTable {
  bool defined = false;
  uint8_t values[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // 9-bit lookahead: (code length << 8) | symbol, 0 when longer
  uint16_t look[512] = {};

  void build(const uint8_t counts[17], const uint8_t* vals, int n,
             bool is_dc) {
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l]; i++) size[p++] = static_cast<uint8_t>(l);
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
      if (counts[l]) {
        valoffset[l] = p - static_cast<int32_t>(code_of[p]);
        p += counts[l];
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
      for (int i = 0; i < counts[l]; i++, p++) {
        int lookbits = static_cast<int>(code_of[p] << (9 - l));
        for (int c = 0; c < (1 << (9 - l)); c++)
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    std::memcpy(values, vals, n);
    if (is_dc)
      for (int i = 0; i < n; i++)
        if (vals[i] > 15) fail(kCorrupt, "bad Huffman table");
    defined = true;
  }
};

// ---- the bit reader of an entropy-coded segment (jdhuff.c) -------------

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

  // The position of the next marker's FF, skipping what libjpeg's
  // next_marker skips; the marker code in *code.
  const uint8_t* next_marker(int* code) {
    const uint8_t* q = p;
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

  void restart(int expected) {
    int code;
    const uint8_t* m = next_marker(&code);
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

// ---- the frame -----------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;              // downsampled size
  int bw = 0, bh = 0;                  // blocks with image data
  int bw_pad = 0, bh_pad = 0;          // blocks to the MCU grid
  int dc_tbl = 0, ac_tbl = 0;
  bool quant_latched = false;
  int16_t quant[64] = {};              // natural order, ISLOW_MULT_TYPE
  int coef_bits[64];                   // jdphuff.c's coef_bits
  std::vector<int16_t> coef;           // bw_pad * bh_pad blocks of 64
  std::vector<uint8_t> plane;          // bw * 8 by bh * 8 samples
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw_pad + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;

  bool saw_sof = false, saw_eoi = false;
  bool progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  int scan_number = 0;
  uint16_t qtables[4][64] = {};
  bool qdefined[4] = {};
  HuffTable dc_tables[4], ac_tables[4];
  Component comp[kMaxComponents];

  Decoder(const uint8_t* d, size_t len) : data(d), end(d + len), p(d) {}

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

  // Markers up to the first SOS (probe) or through EOI (decode).
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
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF:
          fail(kUnsupported, "a lossless or hierarchical frame (SOF" +
                                 std::to_string(m - 0xC0) + ")");
        case 0xC9: case 0xCA:
          fail(kUnsupported, "an arithmetic-coded frame (SOF" +
                                 std::to_string(m - 0xC0) + ")");
        case 0xC4: read_dht(); break;
        case 0xCC:
          fail(kUnsupported, "arithmetic coding conditioning (DAC)");
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
      uint8_t counts[17] = {};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = static_cast<uint8_t>(byte());
        total += counts[l];
      }
      len -= 17;
      if (total > 256 || total > len) fail(kCorrupt, "bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = static_cast<uint8_t>(byte());
      len -= total;
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th >= 4 || tc > 1) fail(kCorrupt, "bad DHT table index");
      (tc ? ac_tables : dc_tables)[th].build(counts, vals, total, tc == 0);
    }
    if (len != 0) fail(kCorrupt, "bad DHT length");
  }

  void read_sof(int m) {
    if (saw_sof) fail(kCorrupt, "a second SOF");
    saw_sof = true;
    progressive = (m == 0xC2);
    int len = word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8)
      fail(kUnsupported, std::to_string(precision) + "-bit precision");
    if (height == 0) fail(kCorrupt, "empty image (DNL not supported)");
    if (width == 0 || ncomp == 0) fail(kCorrupt, "empty image");
    if (int64_t{width} * height > kMaxPixels)
      fail(kCorrupt, "more pixels than PIL's decompression-bomb limit");
    if (len != 8 + ncomp * 3) fail(kCorrupt, "bad SOF length");
    if (ncomp == 4)
      fail(kUnsupported, "4 components (CMYK or YCCK)");
    if (ncomp != 1 && ncomp != 3)
      fail(kCorrupt, std::to_string(ncomp) + " components");
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
    // the sampling layouts decoded: every component at full size, or a
    // full-size first component over chroma halved across (2x1) or
    // across and down (2x2)
    for (int c = 0; c < ncomp; c++) {
      const Component& k = comp[c];
      int rh = max_h / k.h, rv = max_v / k.v;
      bool ok = (max_h % k.h == 0) && (max_v % k.v == 0) &&
                ((rh == 1 && rv == 1) ||
                 (c > 0 && rh == 2 && (rv == 1 || rv == 2)));
      if (ncomp == 1) ok = true;  // one component is never upsampled
      if (!ok)
        fail(kUnsupported, "the sampling layout " + layout());
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.ds_w = static_cast<int>((static_cast<int64_t>(width) * k.h + max_h - 1) / max_h);
      k.ds_h = static_cast<int>((static_cast<int64_t>(height) * k.v + max_v - 1) / max_v);
      k.bw = (k.ds_w + 7) / 8;
      k.bh = (k.ds_h + 7) / 8;
      k.bw_pad = mcus_x * k.h;
      k.bh_pad = mcus_y * k.v;
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
      if (k.coef.empty())
        k.coef.assign(static_cast<size_t>(k.bw_pad) * k.bh_pad * 64, 0);
    }
  }

  // ---- a scan ----

  int ss = 0, se = 63, ah = 0, al = 0;
  int ns = 0;
  Component* scomp[4] = {};
  int last_dc[4] = {};
  int eobrun = 0;
  BitReader br;

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
      if (k->dc_tbl > 3 || k->ac_tbl > 3) fail(kCorrupt, "bad table index");
      scomp[i] = k;
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    scan_number++;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += scomp[i]->h * scomp[i]->v;
      if (blocks > 10) fail(kCorrupt, "too many blocks in an MCU");
    }
    allocate();
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
    br = BitReader();
    br.p = p;
    br.end = end;
    decode_scan();
    int code;
    p = br.next_marker(&code);
  }

  void check_progression() {  // jdphuff.c's start_pass_phuff_decoder
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

  const HuffTable& table(bool dc, int i) {
    const HuffTable& t = dc ? dc_tables[i] : ac_tables[i];
    if (!t.defined)
      fail(kUnsupported, "a scan without its Huffman table (Motion-JPEG)");
    return t;
  }

  void decode_scan() {
    for (int i = 0; i < 4; i++) last_dc[i] = 0;
    eobrun = 0;
    int mode;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!progressive) mode = 0;
    else if (ss == 0) mode = ah == 0 ? 1 : 2;
    else mode = ah == 0 ? 3 : 4;
    const HuffTable* dct[4] = {};
    const HuffTable* act[4] = {};
    for (int i = 0; i < ns; i++) {
      if (mode == 0 || mode == 1) dct[i] = &table(true, scomp[i]->dc_tbl);
      if (mode == 0 || mode >= 3) act[i] = &table(false, scomp[i]->ac_tbl);
    }
    int restarts_left = restart_interval, next_rst = 0;
    auto maybe_restart = [&]() {
      if (restart_interval == 0) return;
      if (restarts_left == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < 4; i++) last_dc[i] = 0;
        eobrun = 0;
        restarts_left = restart_interval;
      }
      restarts_left--;
    };
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component* k = scomp[0];
      for (int by = 0; by < k->bh; by++)
        for (int bx = 0; bx < k->bw; bx++) {
          maybe_restart();
          decode_block(mode, k->block(bx, by), 0, dct[0], act[0]);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          maybe_restart();
          for (int i = 0; i < ns; i++) {
            Component* k = scomp[i];
            for (int y = 0; y < k->v; y++)
              for (int x = 0; x < k->h; x++)
                decode_block(mode, k->block(mx * k->h + x, my * k->v + y), i,
                             dct[i], act[i]);
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

  // ---- after the last scan ----

  // jdcoefct.c's smoothing_ok: true when libjpeg would smooth blocks
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

// ---- the inverse DCT (jidctint.c, jpeg_idct_islow) ------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdmaster.c's prepare_range_limit_table, from the post-IDCT start:
// index (x & 1023) of the descaled IDCT output x
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) idct[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) idct[i] = 255;
      else if (i < 896) idct[i] = 0;
      else idct[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* c = in + col;
    const int16_t* qq = q + col;
    int* w = ws + col;
    if (c[8] == 0 && c[16] == 0 && c[24] == 0 && c[32] == 0 && c[40] == 0 &&
        c[48] == 0 && c[56] == 0) {
      int dc = static_cast<int>(static_cast<uint32_t>(c[0] * qq[0])
                                << kPass1Bits);
      for (int r = 0; r < 8; r++) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = c[16] * qq[16], z3 = c[48] * qq[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = c[0] * qq[0];
    z3 = c[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = c[56] * qq[56];
    tmp1 = c[40] * qq[40];
    tmp2 = c[24] * qq[24];
    tmp3 = c[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const uint8_t* lim = kRange.idct;
  for (int row = 0; row < 8; row++) {
    const int* w = ws + row * 8;
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = lim[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = lim[static_cast<int>(descale(tmp10 + tmp3, sh)) & 1023];
    o[7] = lim[static_cast<int>(descale(tmp10 - tmp3, sh)) & 1023];
    o[1] = lim[static_cast<int>(descale(tmp11 + tmp2, sh)) & 1023];
    o[6] = lim[static_cast<int>(descale(tmp11 - tmp2, sh)) & 1023];
    o[2] = lim[static_cast<int>(descale(tmp12 + tmp1, sh)) & 1023];
    o[5] = lim[static_cast<int>(descale(tmp12 - tmp1, sh)) & 1023];
    o[3] = lim[static_cast<int>(descale(tmp13 + tmp0, sh)) & 1023];
    o[4] = lim[static_cast<int>(descale(tmp13 - tmp0, sh)) & 1023];
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

// ---- upsampling (jdsample.c) to a full-size row ---------------------------

// Row y of component k at the output's width (w samples).
void upsampled_row(const Component& k, int max_h, int max_v, int y, int w,
                   uint8_t* out) {
  const int stride = k.bw * 8;
  const int rh = max_h / k.h, rv = max_v / k.v;
  if (rh == 1 && rv == 1) {  // fullsize_upsample
    std::memcpy(out, k.plane.data() + static_cast<size_t>(y) * stride, w);
    return;
  }
  const bool fancy = k.ds_w > 2;  // jinit_upsampler: do_fancy && width > 2
  const int cy = y / rv;
  const uint8_t* near = k.plane.data() + static_cast<size_t>(cy) * stride;
  if (!fancy) {  // h2v1_upsample / h2v2_upsample: replicate
    for (int x = 0; x < w; x++) out[x] = near[x >> 1];
    return;
  }
  const int last = k.ds_w - 1;
  if (rv == 1) {  // h2v1_fancy_upsample
    for (int x = 0; x < w; x++) {
      int c = x >> 1;
      int v3 = near[c] * 3;
      if (x & 1) out[x] = static_cast<uint8_t>((v3 + near[std::min(c + 1, last)] + 2) >> 2);
      else out[x] = static_cast<uint8_t>((v3 + near[std::max(c - 1, 0)] + 1) >> 2);
    }
    return;
  }
  // h2v2_fancy_upsample; the context rows of jdmainct.c repeat the first
  // and last real chroma rows
  int fy = (y & 1) ? std::min(cy + 1, k.ds_h - 1) : std::max(cy - 1, 0);
  const uint8_t* far = k.plane.data() + static_cast<size_t>(fy) * stride;
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

void decode(const uint8_t* data, size_t len, Image* img) {
  Decoder d(data, len);
  d.run(false);
  if (!d.saw_sof) fail(kCorrupt, "no frame");
  if (d.scan_number == 0) fail(kCorrupt, "no scan");
  if (d.would_smooth())
    fail(kUnsupported,
         "a progressive file whose scans leave low-frequency bits unsent "
         "(libjpeg smooths its blocks)");
  d.allocate();
  for (int c = 0; c < d.ncomp; c++) inverse_dct(d.comp[c]);
  const int w = d.width, h = d.height;
  img->height = h;
  img->width = w;
  img->channels = d.ncomp == 1 ? 1 : 3;
  img->pixels.resize(static_cast<size_t>(h) * w * img->channels);
  if (d.ncomp == 1) {
    for (int y = 0; y < h; y++)
      upsampled_row(d.comp[0], d.max_h, d.max_v, y, w,
                    img->pixels.data() + static_cast<size_t>(y) * w);
    return;
  }
  // jdapimin.c's default_decompress_parms for three components
  bool rgb;
  if (d.saw_jfif) rgb = false;
  else if (d.saw_adobe) rgb = (d.adobe_transform == 0);
  else rgb = (d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66);
  std::vector<uint8_t> r0(w), r1(w), r2(w);
  for (int y = 0; y < h; y++) {
    upsampled_row(d.comp[0], d.max_h, d.max_v, y, w, r0.data());
    upsampled_row(d.comp[1], d.max_h, d.max_v, y, w, r1.data());
    upsampled_row(d.comp[2], d.max_h, d.max_v, y, w, r2.data());
    uint8_t* o = img->pixels.data() + static_cast<size_t>(y) * w * 3;
    if (rgb) {
      for (int x = 0; x < w; x++) {
        o[3 * x] = r0[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < w; x++) {  // ycc_rgb_convert
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(
          yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
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

// The frame's height, width and channels (1 for "L", 3 for "RGB") from the
// markers up to SOF; the kinds left out are reported here.
int rsn_probe_jpeg(const uint8_t* data, int64_t len, int* height, int* width,
                   int* channels, char* msg, int msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.run(true);
    if (!d.saw_sof) fail(kCorrupt, "no frame");
    *height = d.height;
    *width = d.width;
    *channels = d.ncomp == 1 ? 1 : 3;
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

}  // extern "C"
