// WebP's codecs as libwebp 1.6.0 decodes a frame for PIL's WebPAnimDecoder
// (rsn_torch/data/webp.py reads the RIFF container and picks the frame):
//
//   - VP8L (lossless; vp8l_dec.c): the header, the predictor (14 modes, 14
//     and 15 as 0), cross-colour, subtract-green and colour-indexing
//     transforms (pixel bundling at 2, 4 and 16 colours, the palette
//     delta-coded and padded with transparent black), the entropy image,
//     the colour cache (hash 0x1e35a7bd), LZ77 copies with the 120-entry
//     distance map, simple and normal prefix codes (the code-length code
//     order, repeat codes 16 / 17 / 18, max_symbol), a code of one symbol
//     read with no bits, an incomplete or over-full code an error; bits
//     past the end read as zeros and an error only once more than
//     8 * max(size, 8) bits were read (VP8LIsEndOfStream);
//   - ALPH (alpha_dec.c): compression 0 (raw rows) or 1 (a headerless VP8L
//     stream whose green is the alpha), filters none / horizontal /
//     vertical / gradient undone with filters.c's edge rules; the
//     pre-processing bits are checked (0 or 1) and otherwise ignored, as
//     alpha dithering is off in WebPAnimDecoder's configuration;
//   - VP8 key frames (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c):
//     the boolean decoder (an error once it needs a byte past its
//     partition), segment and filter headers, 1-8 token partitions, the
//     quantiser tables and their special cases, coefficient probability
//     updates, intra modes with their contexts, tokens, the WHT and the
//     inverse DCT as x86-64 libwebp runs them (a block with more than
//     three coefficients through Transform_SSE2's 16-bit lanes, which
//     wrap, the others and the WHT through the C code's 32-bit ints),
//     the 16x16 / 8x8 / 4x4 predictors on the 127 / 129 edges (prediction
//     from unfiltered samples), the simple and normal loop filters per
//     macroblock after its row, the frame cropped to its size;
//   - the output as WebPDecode writes MODE_RGBA with its defaults: fancy
//     upsampling of 4:2:0 chroma (9-3-3-1, the first row and the last row
//     of an even height from one chroma row, the last column of an even
//     width from one chroma column) and yuv.h's VP8YUVToR/G/B (14-bit
//     fixed point, MultHi, VP8Clip8), alpha attached unpremultiplied.
//
// The constant tables are RFC 6386's (§13 coefficient probabilities, §11
// modes, §14 quantisers) in libwebp's order of the 4x4 modes.
//
// C interface (ctypes): rsn_webp_vp8l, rsn_webp_vp8.  Each returns 0, or 2
// (a stream libwebp refuses) with a message.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Failure{what}; }

// ---- VP8L -------------------------------------------------------------------

// LSB-first bits; past the data, zeros
class LBits {
 public:
  LBits(const uint8_t* data, size_t size)
      : data_(data), size_(size),
        limit_(8 * static_cast<uint64_t>(std::max<size_t>(size, 8))) {}
  uint32_t peek() {  // the next 32 bits
    fill();
    return static_cast<uint32_t>(val_);
  }
  void skip(int n) {
    val_ >>= n;
    nbits_ -= n;
    used_ += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek() & ((1u << n) - 1);
    skip(n);
    return v;
  }
  bool eos() const { return used_ > limit_; }

 private:
  void fill() {
    while (nbits_ <= 56) {
      const uint64_t b = next_ < size_ ? data_[next_] : 0;
      ++next_;
      val_ |= b << nbits_;
      nbits_ += 8;
    }
  }
  const uint8_t* data_;
  size_t size_;
  size_t next_ = 0;
  uint64_t val_ = 0;
  int nbits_ = 0;
  uint64_t used_ = 0;
  uint64_t limit_;
};

constexpr int kRootBits = 8;
constexpr int kMaxCodeLength = 15;

struct HCode {
  uint8_t bits;    // the code's length, or root + subtable bits
  uint16_t value;  // the symbol, or the subtable's offset
};

int NextKey(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? static_cast<int>((key & (step - 1)) + step)
              : static_cast<int>(key);
}

void Replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int NextTableBits(const int* count, int len) {
  int left = 1 << (len - kRootBits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - kRootBits;
}

// huffman_utils.c's BuildHuffmanTable: a root of 8 bits and second-level
// tables; false for an incomplete or over-full code or no symbol at all.
// One symbol is a code of no bits, whatever its length.
bool BuildCode(const int* lengths, int n, std::vector<HCode>* out) {
  int count[kMaxCodeLength + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  int offset[kMaxCodeLength + 1];
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  if (offset[kMaxCodeLength] == 1) {
    out->assign(1 << kRootBits, HCode{0, sorted[0]});
    return true;
  }
  // the size first, then the tables
  int total = 1 << kRootBits;
  {
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    uint32_t key = 0, low = 0xffffffffu;
    const uint32_t mask = total - 1;
    int num_open = 1, num_nodes = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return false;
      for (; cnt[len] > 0; --cnt[len]) {
        if (len > kRootBits && (key & mask) != low) {
          total += 1 << NextTableBits(cnt, len);
          low = key & mask;
        }
        key = NextKey(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return false;
  }
  out->assign(total, HCode{0, 0});
  HCode* root = out->data();
  HCode* table = root;
  int table_bits = kRootBits, table_size = 1 << kRootBits;
  uint32_t key = 0, low = 0xffffffffu;
  const uint32_t mask = (1u << kRootBits) - 1;
  int symbol = 0;
  for (int len = 1, step = 2; len <= kRootBits; ++len, step <<= 1) {
    for (; count[len] > 0; --count[len]) {
      Replicate(&table[key], step, table_size,
                HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = NextKey(key, len);
    }
  }
  for (int len = kRootBits + 1, step = 2; len <= kMaxCodeLength;
       ++len, step <<= 1) {
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = NextTableBits(count, len);
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = static_cast<uint8_t>(table_bits + kRootBits);
        root[low].value = static_cast<uint16_t>((table - root) - low);
      }
      Replicate(&table[key >> kRootBits], step, table_size,
                HCode{static_cast<uint8_t>(len - kRootBits),
                      sorted[symbol++]});
      key = NextKey(key, len);
    }
  }
  return true;
}

int ReadSymbol(const HCode* table, LBits& br) {
  uint32_t val = br.peek();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.skip(kRootBits);
    val = br.peek();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

constexpr int kLiterals = 256, kLengthCodes = 24, kDistanceCodes = 40;
constexpr int kAlphabet[5] = {kLiterals + kLengthCodes, 256, 256, 256,
                              kDistanceCodes};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// (dx, dy) of the 120 short distance codes as dy << 4 | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

bool ReadCode(LBits& br, int alphabet, std::vector<int>& lengths,
              std::vector<HCode>* out) {
  std::fill(lengths.begin(), lengths.end(), 0);
  if (br.read(1)) {  // simple: one or two symbols
    const int num = static_cast<int>(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
    std::vector<HCode> cl_code;
    if (!BuildCode(cl_lengths, 19, &cl_code)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > alphabet) return false;
    }
    int prev = 8;
    for (int symbol = 0; symbol < alphabet;) {
      if (max_symbol-- == 0) break;
      const int code = ReadSymbol(cl_code.data(), br);
      if (code < 16) {
        lengths[symbol++] = code;
        if (code != 0) prev = code;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = static_cast<int>(br.read(kExtra[code - 16])) +
                     kOffset[code - 16];
        if (symbol + repeat > alphabet) return false;
        const int length = code == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }
  if (br.eos()) return false;
  std::vector<HCode> scratch;
  return BuildCode(lengths.data(), alphabet, out ? out : &scratch);
}

struct Group {
  std::vector<HCode> codes[5];  // green + length + cache, red, blue, alpha,
                                // distance
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t Average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

uint32_t Clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

int Sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L
  const int d = Sub3(a >> 24, b >> 24, c >> 24) +
                Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                Sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

uint32_t ClampFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) +
                  static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    out |= Clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}

uint32_t ClampHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff);
    const int b = static_cast<int>((c2 >> s) & 0xff);
    out |= Clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

// mode 0-13 (14 and 15 are 0) from the left pixel and the row above
uint32_t Predict(int mode, const uint32_t* left, const uint32_t* top) {
  switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return Average2(Average2(*left, top[1]), top[0]);
    case 6: return Average2(*left, top[-1]);
    case 7: return Average2(*left, top[0]);
    case 8: return Average2(top[-1], top[0]);
    case 9: return Average2(top[0], top[1]);
    case 10:
      return Average2(Average2(*left, top[-1]), Average2(top[0], top[1]));
    case 11: return Select(top[0], *left, top[-1]);
    case 12: return ClampFull(*left, top[0], top[-1]);
    case 13: return ClampHalf(*left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

int SubSample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class Lossless {
 public:
  Lossless(const uint8_t* data, size_t size) : br_(data, size) {}

  // a VP8L chunk's payload -> ARGB (width, height from its header; its
  // alpha bit is the container's business)
  std::vector<uint32_t> DecodeImage(int* width, int* height) {
    if (br_.read(8) != 0x2f) fail("VP8L: bad signature");
    *width = static_cast<int>(br_.read(14)) + 1;
    *height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);
    if (br_.read(3) != 0) fail("VP8L: unknown version");
    if (br_.eos()) fail("VP8L: truncated header");
    return DecodeLevel0(*width, *height);
  }

  // the image stream of an ALPH chunk: its transforms, codes and pixels
  std::vector<uint32_t> DecodeLevel0(int width, int height) {
    int xsize = width;
    while (br_.read(1)) ReadTransform(&xsize, height);
    std::vector<uint32_t> px = DecodeStream(xsize, height, true);
    for (int i = static_cast<int>(transforms_.size()) - 1; i >= 0; --i)
      Inverse(transforms_[i], &px);
    return px;
  }

 private:
  void ReadTransform(int* xsize, int ysize) {
    const int type = static_cast<int>(br_.read(2));
    if (seen_ & (1 << type)) fail("VP8L: a transform used twice");
    seen_ |= 1 << type;
    Transform t{type, 0, *xsize, ysize, {}};
    if (type == 0 || type == 1) {
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = DecodeStream(SubSample(t.xsize, t.bits),
                            SubSample(t.ysize, t.bits), false);
    } else if (type == 3) {
      const int num_colors = static_cast<int>(br_.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2
                                                                          : 3;
      *xsize = SubSample(t.xsize, t.bits);
      std::vector<uint32_t> pal = DecodeStream(num_colors, 1, false);
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i)
        t.data[i] = AddPixels(pal[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
  }

  std::vector<uint32_t> DecodeStream(int xsize, int ysize, bool level0) {
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache");
    }
    // the entropy image (level 0 only)
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int num_groups = 1;
    if (level0 && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_xsize = SubSample(xsize, meta_bits);
      meta = DecodeStream(meta_xsize, SubSample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, static_cast<int>(m) + 1);
      }
    }
    if (br_.eos()) fail("VP8L: truncated");
    std::vector<char> used(num_groups, meta.empty() ? 1 : 0);
    for (uint32_t m : meta) used[m] = 1;
    std::vector<Group> groups(num_groups);
    std::vector<int> lengths(kAlphabet[0] + (cache_bits ? 1 << cache_bits : 0));
    for (int g = 0; g < num_groups; ++g) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabet[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        if (!ReadCode(br_, alphabet, lengths,
                      used[g] ? &groups[g].codes[j] : nullptr))
          fail("VP8L: a bad prefix code");
      }
    }
    std::vector<uint32_t> px(static_cast<size_t>(xsize) * ysize);
    DecodePixels(xsize, cache_bits, groups, meta, meta_bits, meta_xsize,
                 &px);
    if (br_.eos()) fail("VP8L: truncated");
    return px;
  }

  void DecodePixels(int width, int cache_bits,
                    const std::vector<Group>& groups,
                    const std::vector<uint32_t>& meta, int meta_bits,
                    int meta_xsize, std::vector<uint32_t>* out) {
    uint32_t* const data = out->data();
    const size_t total = out->size();
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const Group& {
      if (meta.empty()) return groups[0];
      return groups[meta[static_cast<size_t>(y >> meta_bits) * meta_xsize +
                         (x >> meta_bits)]];
    };
    auto insert = [&]() {
      if (!cache_bits) return;
      for (; cached < pos; ++cached)
        cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached];
    };
    while (pos < total) {
      const Group& g = group_at(col, row);
      const int code = ReadSymbol(g.codes[0].data(), br_);
      if (code < kLiterals) {
        const int red = ReadSymbol(g.codes[1].data(), br_);
        const int blue = ReadSymbol(g.codes[2].data(), br_);
        const int alpha = ReadSymbol(g.codes[3].data(), br_);
        if (br_.eos()) fail("VP8L: truncated");
        data[pos++] = static_cast<uint32_t>(alpha) << 24 |
                      static_cast<uint32_t>(red) << 16 |
                      static_cast<uint32_t>(code) << 8 |
                      static_cast<uint32_t>(blue);
        if (++col >= width) {
          col = 0;
          ++row;
          insert();
        }
      } else if (code < kLiterals + kLengthCodes) {
        const int length = CopyValue(code - kLiterals);
        const int dist_symbol = ReadSymbol(g.codes[4].data(), br_);
        const int dist_code = CopyValue(dist_symbol);
        int dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int p = kCodeToPlane[dist_code - 1];
          dist = (p >> 4) * width + (8 - (p & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br_.eos()) fail("VP8L: truncated");
        if (pos < static_cast<size_t>(dist) ||
            total - pos < static_cast<size_t>(length))
          fail("VP8L: a copy outside the image");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        insert();
      } else if (code < kLiterals + kLengthCodes + (1 << cache_bits) &&
                 cache_bits) {
        insert();
        data[pos++] = cache[code - kLiterals - kLengthCodes];
        if (++col >= width) {
          col = 0;
          ++row;
          insert();
        }
      } else {
        fail("VP8L: a symbol past the alphabet");
      }
      if (br_.eos()) fail("VP8L: truncated");
    }
  }

  int CopyValue(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  static void Inverse(const Transform& t, std::vector<uint32_t>* px) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // subtract green
      for (uint32_t& p : *px) {
        const uint32_t green = (p >> 8) & 0xff;
        uint32_t rb = p & 0x00ff00ffu;
        rb += (green << 16) | green;
        p = (p & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
    } else if (t.type == 0) {  // predictor
      uint32_t* d = px->data();
      d[0] = AddPixels(d[0], 0xff000000u);
      for (int x = 1; x < w; ++x) d[x] = AddPixels(d[x], d[x - 1]);
      const int tiles = SubSample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = d + static_cast<size_t>(y) * w;
        const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
        row[0] = AddPixels(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = AddPixels(row[x], Predict(mode, row + x - 1, row + x - w));
        }
      }
    } else if (t.type == 1) {  // cross colour
      const int tiles = SubSample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px->data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = static_cast<int8_t>(m & 0xff);
          const int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red += (g2r * green) >> 5;
          red &= 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 |
                   static_cast<uint32_t>(blue);
        }
      }
    } else {  // colour indexing: packed indices in green
      const int packed_w = SubSample(w, t.bits);
      std::vector<uint32_t> outp(static_cast<size_t>(w) * h);
      const int bpp = 8 >> t.bits, per = 1 << t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px->data() + static_cast<size_t>(y) * packed_w;
        uint32_t* dst = outp.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          const uint32_t index = (src[x / per] >> 8) & 0xff;
          dst[x] = t.data[(index >> (bpp * (x % per))) & mask];
        }
      }
      px->swap(outp);
    }
  }

  LBits br_;
  std::vector<Transform> transforms_;
  int seen_ = 0;
};

// ---- ALPH -------------------------------------------------------------------

// filters.c's unfilters; prev is the row above (null for the first)
void Unfilter(int filter, const uint8_t* prev, const uint8_t* in,
              uint8_t* out, int width) {
  if (filter == 0) {
    if (in != out) std::memcpy(out, in, width);
  } else if (filter == 1 || prev == nullptr) {
    uint8_t pred = (prev == nullptr) ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = static_cast<uint8_t>(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i)
      out[i] = static_cast<uint8_t>(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = static_cast<uint8_t>(in[i] + pred);
      top_left = top;
      out[i] = left;
    }
  }
}

// an ALPH chunk's payload -> width * height alpha
std::vector<uint8_t> DecodeAlpha(const uint8_t* data, size_t size, int width,
                                 int height) {
  if (size <= 1) fail("ALPH: no data");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) fail("ALPH: a bad header");
  const size_t n = static_cast<size_t>(width) * height;
  std::vector<uint8_t> alpha(n);
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: truncated");
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
      uint8_t* row = alpha.data() + static_cast<size_t>(y) * width;
      Unfilter(filter, prev, data + 1 + static_cast<size_t>(y) * width, row,
               width);
      prev = row;
    }
  } else {
    Lossless dec(data + 1, size - 1);
    const std::vector<uint32_t> px = dec.DecodeLevel0(width, height);
    for (size_t i = 0; i < n; ++i) alpha[i] = (px[i] >> 8) & 0xff;
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
      uint8_t* row = alpha.data() + static_cast<size_t>(y) * width;
      if (filter != 0) Unfilter(filter, prev, row, row, width);
      prev = row;
    }
  }
  return alpha;
}

// ---- VP8 --------------------------------------------------------------------

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};
const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// coefficient index -> band (the 17th entry a sentinel)
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 mode tree: > 0 a node, <= 0 minus a mode
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5,
                                  -6, 7, -7, 8, -8, -9};

// libwebp's mode numbers: the 4x4 modes, then 16x16 / chroma ones sharing
// them (DC 0, TM 1, V 2, H 3), then the DC modes at the frame's edges
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };

int Log2Floor(uint32_t v) { return 31 - __builtin_clz(v); }

// bit_reader_utils.h's boolean decoder, one byte at a time: range_ holds
// range - 1 and eof_ is set when a byte past the partition is needed
class BoolDec {
 public:
  void Init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    range_ = 254;
    bits_ = -8;
    eof_ = false;
    Load();
  }
  int Bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) Load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ Log2Floor(range);
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int Signed(int v) {  // VP8GetSigned: prob 0x80, a shift of one
    if (bits_ < 0) Load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int32_t mask = static_cast<int32_t>(split - value) >> 31;
    bits_ -= 1;
    range_ += static_cast<uint32_t>(mask);
    range_ |= 1;
    value_ -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask))
              << pos;
    return (v ^ mask) - mask;
  }
  int Value(int n) {
    int v = 0;
    while (n-- > 0) v |= Bit(0x80) << n;
    return v;
  }
  int SignedValue(int n) {
    const int v = Value(n);
    return Bit(0x80) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void Load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = static_cast<uint64_t>(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

uint8_t Clip8b(int v) { return (v & ~0xff) == 0 ? v : v < 0 ? 0 : 255; }

int Mul1(int a) { return ((a * 20091) >> 16) + a; }
int Mul2(int a) { return (a * 35468) >> 16; }

// dec_sse2.c's Transform_SSE2 on one block: 16-bit lanes that wrap
int16_t W16(int v) { return static_cast<int16_t>(v); }
int16_t MulHi(int16_t a, int k) { return W16((a * k) >> 16); }

void TransformSSE2(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // t[r][i]: the vertical pass's output r of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = W16(i0 + i2), b = W16(i0 - i2);
    const int16_t c = W16(W16(i1 - i3) + W16(MulHi(i1, -30068) -
                                             MulHi(i3, 20091)));
    const int16_t d = W16(W16(i1 + i3) + W16(MulHi(i1, 20091) +
                                             MulHi(i3, -30068)));
    t[0][i] = W16(a + d);
    t[1][i] = W16(b + c);
    t[2][i] = W16(b - c);
    t[3][i] = W16(a - d);
  }
  for (int j = 0; j < 4; ++j) {  // row j from t[j][0..3]
    const int16_t T0 = t[j][0], T1 = t[j][1], T2 = t[j][2], T3 = t[j][3];
    const int16_t dc = W16(T0 + 4);
    const int16_t a = W16(dc + T2), b = W16(dc - T2);
    const int16_t c = W16(W16(T1 - T3) + W16(MulHi(T1, -30068) -
                                             MulHi(T3, 20091)));
    const int16_t d = W16(W16(T1 + T3) + W16(MulHi(T1, 20091) +
                                             MulHi(T3, -30068)));
    const int16_t out[4] = {W16(a + d), W16(b + c), W16(b - c), W16(a - d)};
    for (int x = 0; x < 4; ++x) {
      const int v = dst[j * BPS + x] + (out[x] >> 3);
      dst[j * BPS + x] = v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v);
    }
  }
}

// dec.c's TransformAC3_C and TransformDC_C (32-bit ints)
void TransformAC3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = Mul2(in[4]), d4 = Mul1(in[4]);
  const int c1 = Mul2(in[1]), d1 = Mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int DC = rows[y];
    const int v[4] = {DC + d1, DC + c1, DC - c1, DC - d1};
    for (int x = 0; x < 4; ++x)
      dst[y * BPS + x] = Clip8b(dst[y * BPS + x] + (v[x] >> 3));
  }
}

void TransformDC(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[y * BPS + x] = Clip8b(dst[y * BPS + x] + (DC >> 3));
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = W16((a0 + a1) >> 3);
    out[16] = W16((a3 + a2) >> 3);
    out[32] = W16((a0 - a1) >> 3);
    out[48] = W16((a3 - a2) >> 3);
    out += 64;
  }
}

// a 4x4 block's code: 3 more than three coefficients, 2 two or three, 1 the
// DC alone, 0 none
void DoTransform(uint32_t code, const int16_t* src, uint8_t* dst) {
  if (code == 3) TransformSSE2(src, dst);
  else if (code == 2) TransformAC3(src, dst);
  else if (code == 1) TransformDC(src, dst);
}

void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  if (bits & 0xaa) {  // TransformUV: VP8Transform on all four
    TransformSSE2(src, dst);
    TransformSSE2(src + 16, dst + 4);
    TransformSSE2(src + 32, dst + 4 * BPS);
    TransformSSE2(src + 48, dst + 4 * BPS + 4);
  } else {  // TransformDCUV
    if (src[0]) TransformDC(src, dst);
    if (src[16]) TransformDC(src + 16, dst + 4);
    if (src[32]) TransformDC(src + 32, dst + 4 * BPS);
    if (src[48]) TransformDC(src + 48, dst + 4 * BPS + 4);
  }
}

// ---- predictors (dec.c) ----

uint8_t Avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
uint8_t Avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x)
      dst[y * BPS + x] = Clip8b(top[x] + dst[y * BPS - 1] - top[-1]);
}

void Fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void PredictLuma16(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      Fill(dst, 16, (dc + 16) >> 5);
      break;
    case DC_NOTOP:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      Fill(dst, 16, (dc + 8) >> 4);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      Fill(dst, 16, (dc + 8) >> 4);
      break;
    case DC_NOTOPLEFT: Fill(dst, 16, 0x80); break;
    case B_TM: TrueMotion(dst, 16); break;
    case B_VE:
      for (int y = 0; y < 16; ++y) std::memcpy(dst + y * BPS, dst - BPS, 16);
      break;
    case B_HE:
      for (int y = 0; y < 16; ++y)
        std::memset(dst + y * BPS, dst[y * BPS - 1], 16);
      break;
  }
}

void PredictChroma8(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      Fill(dst, 8, (dc + 8) >> 4);
      break;
    case DC_NOTOP:
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS];
      Fill(dst, 8, (dc + 4) >> 3);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS];
      Fill(dst, 8, (dc + 4) >> 3);
      break;
    case DC_NOTOPLEFT: Fill(dst, 8, 0x80); break;
    case B_TM: TrueMotion(dst, 8); break;
    case B_VE:
      for (int y = 0; y < 8; ++y) std::memcpy(dst + y * BPS, dst - BPS, 8);
      break;
    case B_HE:
      for (int y = 0; y < 8; ++y)
        std::memset(dst + y * BPS, dst[y * BPS - 1], 8);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void PredictLuma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      Fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: TrueMotion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {Avg3(X, A, B), Avg3(A, B, C), Avg3(B, C, D),
                            Avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * BPS, Avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, Avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, Avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, Avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = Avg2(X, A);
      DST(1, 0) = DST(2, 2) = Avg2(A, B);
      DST(2, 0) = DST(3, 2) = Avg2(B, C);
      DST(3, 0) = Avg2(C, D);
      DST(0, 3) = Avg3(K, J, I);
      DST(0, 2) = Avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
      DST(3, 1) = Avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = Avg2(A, B);
      DST(1, 0) = DST(0, 2) = Avg2(B, C);
      DST(2, 0) = DST(1, 2) = Avg2(C, D);
      DST(3, 0) = DST(2, 2) = Avg2(D, E);
      DST(0, 1) = Avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
      DST(3, 2) = Avg3(E, F, G);
      DST(3, 3) = Avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = Avg2(I, X);
      DST(0, 1) = DST(2, 2) = Avg2(J, I);
      DST(0, 2) = DST(2, 3) = Avg2(K, J);
      DST(0, 3) = Avg2(L, K);
      DST(3, 0) = Avg3(A, B, C);
      DST(2, 0) = Avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
      DST(1, 3) = Avg3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// ---- the loop filters (dec.c's C versions) ----

int SClip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // ksclip1
int SClip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // ksclip2
uint8_t Clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }      // kclip1

void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + SClip1(p1 - q1);
  const int a1 = SClip2((a + 4) >> 3), a2 = SClip2((a + 3) >> 3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
}

void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = SClip2((a + 4) >> 3), a2 = SClip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip1(p1 + a3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a3);
}

void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = SClip1(3 * (q0 - p0) + SClip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip1(p2 + a3);
  p[-2 * step] = Clip1(p1 + a2);
  p[-step] = Clip1(p0 + a1);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a2);
  p[2 * step] = Clip1(q2 - a3);
}

bool Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

bool NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// along an edge of `size` pixels: hstride across it, vstride along it
void SimpleFilter(uint8_t* p, int hstride, int vstride, int size,
                  int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (NeedsFilter(p, hstride, t2)) DoFilter2(p, hstride);
}

void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                int ithresh, int hev_thresh, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!NeedsFilter2(p, hstride, t2, ithresh)) continue;
    if (Hev(p, hstride, hev_thresh)) DoFilter2(p, hstride);
    else if (edge) DoFilter6(p, hstride);
    else DoFilter4(p, hstride);
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
  FInfo f;
};

class Lossy {
 public:
  // `data` is the VP8 chunk's payload to the end of its padded chunk
  Lossy(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void Decode(uint8_t* rgba, int64_t stride, const uint8_t* alpha) {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    y_.assign(static_cast<size_t>(yw) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uvw) * mb_h_ * 8, 0);
    v_.assign(u_.size(), 0);
    yt_.assign(yw, 0);
    ut_.assign(uvw, 0);
    vt_.assign(uvw, 0);
    intra_t_.assign(4 * mb_w_, B_DC);
    nz_.assign(mb_w_, 0);
    nz_dc_.assign(mb_w_, 0);
    mbs_.resize(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      std::memset(intra_l_, B_DC, 4);
      left_nz_ = left_nz_dc_ = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) ParseIntraMode(mb_x);
      if (br_.eof()) fail("VP8: premature end of partition 0");
      BoolDec& tokens = parts_[mb_y & (num_parts_ - 1)];
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        DecodeMB(mb_x, tokens);
        if (tokens.eof()) fail("VP8: premature end of a token partition");
      }
      ReconstructRow(mb_y);
      if (filter_type_ > 0)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) FilterMB(mb_x, mb_y);
    }
    EmitRGBA(rgba, stride, alpha);
  }

  int width() const { return width_; }
  int height() const { return height_; }

  // the frame header, partition 0's headers and the partitions
  void ParseHeaders() {
    const uint8_t* buf = data_;
    size_t size = size_;
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    buf += 3;
    size -= 3;
    if (!key_frame) fail("VP8: not a key frame");
    if (size < 7) fail("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      fail("VP8: bad code word");
    width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;   // the scale bits ignored
    height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    std::memcpy(proba_, kCoeffsProba0, sizeof(proba_));
    if (partition_length > size) fail("VP8: bad partition length");
    br_.Init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br_.Bit(0x80);  // colour space
    br_.Bit(0x80);  // clamping type
    // segments
    use_segment_ = br_.Bit(0x80);
    if (use_segment_) {
      update_map_ = br_.Bit(0x80);
      if (br_.Bit(0x80)) {
        absolute_delta_ = br_.Bit(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br_.Bit(0x80) ? br_.SignedValue(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.Bit(0x80) ? br_.SignedValue(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          segment_p_[s] = br_.Bit(0x80) ? br_.Value(8) : 255;
    }
    if (br_.eof()) fail("VP8: cannot parse segment header");
    // filter
    simple_ = br_.Bit(0x80);
    level_ = br_.Value(6);
    sharpness_ = br_.Value(3);
    use_lf_delta_ = br_.Bit(0x80);
    if (use_lf_delta_ && br_.Bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.Bit(0x80)) ref_lf_delta_[i] = br_.SignedValue(6);
      for (int i = 0; i < 4; ++i)
        if (br_.Bit(0x80)) mode_lf_delta_[i] = br_.SignedValue(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) fail("VP8: cannot parse filter header");
    // partitions
    num_parts_ = 1 << br_.Value(2);
    const size_t last = num_parts_ - 1;
    if (size < 3 * last) fail("VP8: cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].Init(start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    parts_[last].Init(start, left);
    if (start >= buf + size) fail("VP8: cannot parse partitions");
    // quantisers
    const int base_q0 = br_.Value(7);
    int dq[5];
    for (int& d : dq) d = br_.Bit(0x80) ? br_.SignedValue(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment_) {
        q = quantizer_[s] + (absolute_delta_ ? 0 : base_q0);
      } else if (s > 0) {
        dqm_[s] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[s];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;  // x 155/100
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
    br_.Bit(0x80);  // refresh entropy probs: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            if (br_.Bit(kCoeffsUpdateProba[t][b][c][p]))
              proba_[t][b][c][p] = static_cast<uint8_t>(br_.Value(8));
    use_skip_ = br_.Bit(0x80);
    if (use_skip_) skip_p_ = br_.Value(8);
    // filter strengths per segment and 4x4-ness
    if (filter_type_ > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = level_;
        if (use_segment_)
          base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
          FInfo& info = fstrengths_[s][i4x4];
          int level = base;
          if (use_lf_delta_) {
            level += ref_lf_delta_[0];
            if (i4x4) level += mode_lf_delta_[0];
          }
          level = level < 0 ? 0 : level > 63 ? 63 : level;
          if (level > 0) {
            int ilevel = level;
            if (sharpness_ > 0) {
              ilevel >>= sharpness_ > 4 ? 2 : 1;
              if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
            }
            if (ilevel < 1) ilevel = 1;
            info.ilevel = ilevel;
            info.limit = 2 * level + ilevel;
            info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
          } else {
            info.limit = 0;
          }
          info.inner = i4x4;
        }
      }
    }
  }

 private:
  void ParseIntraMode(int mb_x) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    uint8_t* left = intra_l_;
    MBData& mb = mbs_[mb_x];
    if (update_map_) {
      mb.segment = !br_.Bit(segment_p_[0]) ? br_.Bit(segment_p_[1])
                                           : br_.Bit(segment_p_[2]) + 2;
    } else {
      mb.segment = 0;
    }
    mb.skip = use_skip_ ? br_.Bit(skip_p_) : 0;
    mb.is_i4x4 = !br_.Bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.Bit(156) ? (br_.Bit(128) ? B_TM : B_HE)
                                     : (br_.Bit(163) ? B_VE : B_DC);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.Bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.Bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br_.Bit(142) ? B_DC : !br_.Bit(114) ? B_VE
                                      : br_.Bit(183) ? B_TM : B_HE;
  }

  // tree_dec.c / vp8_dec.c's GetCoeffs: -> the index past the last
  // coefficient read
  int GetCoeffs(BoolDec& br, int type, int ctx, const int* dq, int n,
                int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.Bit(p[0])) return n;
      while (!br.Bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.Bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = LargeValue(br, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = W16(br.Signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static int LargeValue(BoolDec& br, const uint8_t* p) {
    int v;
    if (!br.Bit(p[3])) {
      v = !br.Bit(p[4]) ? 2 : 3 + br.Bit(p[5]);
    } else if (!br.Bit(p[6])) {
      if (!br.Bit(p[7])) {
        v = 5 + br.Bit(159);
      } else {
        v = 7 + 2 * br.Bit(165);
        v += br.Bit(145);
      }
    } else {
      const int bit1 = br.Bit(p[8]);
      const int bit0 = br.Bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.Bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  static uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // -> true when the macroblock has no non-zero coefficient
  bool ParseResiduals(int mb_x, BoolDec& br) {
    MBData& mb = mbs_[mb_x];
    const Quant& q = dqm_[mb.segment];
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    uint8_t& top_nz = nz_[mb_x];
    uint8_t& top_nz_dc = nz_dc_[mb_x];
    int first, ac_type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz_dc + left_nz_dc_;
      const int nz = GetCoeffs(br, 1, ctx, q.y2, 0, dc);
      top_nz_dc = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        TransformWHT(dc, dst);
      } else {
        const int16_t dc0 = W16((dc[0] + 3) >> 3);
        for (int i = 0; i < 256; i += 16) dst[i] = dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = top_nz & 0x0f, lnz = left_nz_ & 0x0f;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top_nz >> (4 + ch);
      lnz = left_nz_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = GetCoeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top_nz = static_cast<uint8_t>(out_t_nz);
    left_nz_ = static_cast<uint8_t>(out_l_nz);
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void DecodeMB(int mb_x, BoolDec& tokens) {
    MBData& mb = mbs_[mb_x];
    bool skip = use_skip_ ? mb.skip : false;
    if (!skip) {
      skip = ParseResiduals(mb_x, tokens);
    } else {
      left_nz_ = nz_[mb_x] = 0;
      if (!mb.is_i4x4) left_nz_dc_ = nz_dc_[mb_x] = 0;
      mb.non_zero_y = mb.non_zero_uv = 0;
    }
    if (filter_type_ > 0) {
      mb.f = fstrengths_[mb.segment][mb.is_i4x4];
      mb.f.inner |= !skip;
    }
  }

  static int CheckMode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : B_DC;
    }
    return mode;
  }

  void ReconstructRow(int mb_y) {
    uint8_t work[kWorkSize];
    std::memset(work, 0, sizeof(work));
    uint8_t* const y_dst = work + kYOff;
    uint8_t* const u_dst = work + kUOff;
    uint8_t* const v_dst = work + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& mb = mbs_[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* top_y = yt_.data() + mb_x * 16;
      uint8_t* top_u = ut_.data() + mb_x * 8;
      uint8_t* top_v = vt_.data() + mb_x * 8;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      uint32_t bits = mb.non_zero_y;
      if (mb.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) std::memset(top_right, top_y[15], 4);
          else std::memcpy(top_right, top_y + 16, 4);
        }
        for (int k = 1; k <= 3; ++k)
          std::memcpy(top_right + k * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          PredictLuma4(mb.imodes[n], dst);
          DoTransform(bits >> 30, mb.coeffs + n * 16, dst);
        }
      } else {
        PredictLuma16(CheckMode(mb_x, mb_y, mb.imodes[0]), y_dst);
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2)
            DoTransform(bits >> 30, mb.coeffs + n * 16,
                        y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = CheckMode(mb_x, mb_y, mb.uvmode);
      PredictChroma8(uvmode, u_dst);
      PredictChroma8(uvmode, v_dst);
      DoUVTransform(mb.non_zero_uv >> 0, mb.coeffs + 16 * 16, u_dst);
      DoUVTransform(mb.non_zero_uv >> 8, mb.coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&y_[(static_cast<size_t>(mb_y) * 16 + j) * yw + mb_x * 16],
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        const size_t at = (static_cast<size_t>(mb_y) * 8 + j) * uvw + mb_x * 8;
        std::memcpy(&u_[at], u_dst + j * BPS, 8);
        std::memcpy(&v_[at], v_dst + j * BPS, 8);
      }
    }
  }

  void FilterMB(int mb_x, int mb_y) {
    const FInfo& f = mbs_[mb_x].f;
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = mb_w_ * 16, uvs = mb_w_ * 8;
    uint8_t* y = &y_[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
    if (filter_type_ == 1) {  // simple: luma only
      if (mb_x > 0) SimpleFilter(y, 1, ys, 16, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4) SimpleFilter(y + k, 1, ys, 16, limit);
      if (mb_y > 0) SimpleFilter(y, ys, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4)
          SimpleFilter(y + k * ys, ys, 1, 16, limit);
      return;
    }
    const size_t uv_at = static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
    uint8_t* u = &u_[uv_at];
    uint8_t* v = &v_[uv_at];
    const int il = f.ilevel, hev = f.hev_thresh;
    if (mb_x > 0) {
      FilterLoop(y, 1, ys, 16, limit + 4, il, hev, true);
      FilterLoop(u, 1, uvs, 8, limit + 4, il, hev, true);
      FilterLoop(v, 1, uvs, 8, limit + 4, il, hev, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        FilterLoop(y + k, 1, ys, 16, limit, il, hev, false);
      FilterLoop(u + 4, 1, uvs, 8, limit, il, hev, false);
      FilterLoop(v + 4, 1, uvs, 8, limit, il, hev, false);
    }
    if (mb_y > 0) {
      FilterLoop(y, ys, 1, 16, limit + 4, il, hev, true);
      FilterLoop(u, uvs, 1, 8, limit + 4, il, hev, true);
      FilterLoop(v, uvs, 1, 8, limit + 4, il, hev, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4)
        FilterLoop(y + k * ys, ys, 1, 16, limit, il, hev, false);
      FilterLoop(u + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
      FilterLoop(v + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
    }
  }

  // yuv.h
  static int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
  static uint8_t Clip8(int v) {
    constexpr int kMask = (256 << 6) - 1;
    return (v & ~kMask) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
  }
  static void YuvToRgba(int y, int u, int v, uint8_t* out) {
    const int yy = MultHi(y, 19077);
    out[0] = Clip8(yy + MultHi(v, 26149) - 14234);
    out[1] = Clip8(yy - MultHi(u, 6419) - MultHi(v, 13320) + 8708);
    out[2] = Clip8(yy + MultHi(u, 33050) - 17685);
    out[3] = 0xff;
  }

  // upsampling.c's fancy upsampler on one output row: chroma rows `near`
  // (3/4) and `far` (1/4), each also 3:1 across columns
  void UpsampleRow(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                   const uint8_t* fu, const uint8_t* fv, uint8_t* out) {
    const int len = width_;
    // chroma column cx mixed 3:1 down the rows; then 3:1 across columns
    auto sample = [&](int cx, const uint8_t* n, const uint8_t* f) {
      return 3 * n[cx] + f[cx];
    };
    auto mix = [&](int a, int b) {  // a the near column's, b the far's
      return (3 * a + b + 8) >> 4;
    };
    {
      const int u0 = (sample(0, nu, fu) + 2) >> 2, v0 = (sample(0, nv, fv) + 2) >> 2;
      YuvToRgba(y[0], u0, v0, out);
    }
    const int last_pair = (len - 1) >> 1;
    for (int x = 1; x <= last_pair; ++x) {
      const int ul = sample(x - 1, nu, fu), ur = sample(x, nu, fu);
      const int vl = sample(x - 1, nv, fv), vr = sample(x, nv, fv);
      YuvToRgba(y[2 * x - 1], mix(ul, ur), mix(vl, vr), out + (2 * x - 1) * 4);
      YuvToRgba(y[2 * x], mix(ur, ul), mix(vr, vl), out + 2 * x * 4);
    }
    if (!(len & 1)) {
      const int cx = (len - 1) >> 1;
      YuvToRgba(y[len - 1], (sample(cx, nu, fu) + 2) >> 2,
                (sample(cx, nv, fv) + 2) >> 2, out + (len - 1) * 4);
    }
  }

  void EmitRGBA(uint8_t* rgba, int64_t stride, const uint8_t* alpha) {
    const int ys = mb_w_ * 16, uvs = mb_w_ * 8;
    for (int y = 0; y < height_; ++y) {
      int near_row, far_row;
      if (y == 0) {
        near_row = far_row = 0;
      } else if (y & 1) {  // the last row of an even height: one row
        near_row = (y - 1) / 2;
        far_row = y == height_ - 1 ? near_row : (y + 1) / 2;
      } else {
        near_row = y / 2;
        far_row = y / 2 - 1;
      }
      uint8_t* out = rgba + y * stride;
      UpsampleRow(&y_[static_cast<size_t>(y) * ys],
                  &u_[static_cast<size_t>(near_row) * uvs],
                  &v_[static_cast<size_t>(near_row) * uvs],
                  &u_[static_cast<size_t>(far_row) * uvs],
                  &v_[static_cast<size_t>(far_row) * uvs], out);
      if (alpha)
        for (int x = 0; x < width_; ++x)
          out[4 * x + 3] = alpha[static_cast<size_t>(y) * width_ + x];
    }
  }

  struct Quant {
    int y1[2], y2[2], uv[2];
  };

  const uint8_t* data_;
  size_t size_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolDec br_;
  BoolDec parts_[8];
  int num_parts_ = 1;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  int segment_p_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  FInfo fstrengths_[4][2];
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_ = false;
  int skip_p_ = 0;
  std::vector<uint8_t> intra_t_, nz_, nz_dc_;
  uint8_t intra_l_[4];
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<MBData> mbs_;
  std::vector<uint8_t> y_, u_, v_, yt_, ut_, vt_;
};

void Report(const Failure& f, char* msg, int msg_len) {
  if (msg_len > 0) {
    std::strncpy(msg, f.what.c_str(), msg_len - 1);
    msg[msg_len - 1] = 0;
  }
}

}  // namespace

extern "C" {

// a VP8L chunk's payload -> (height, width, 4) RGBA rows `stride` bytes
// apart; its header's size must be width x height
int rsn_webp_vp8l(const uint8_t* data, int64_t size, uint8_t* rgba,
                  int64_t stride, int width, int height, char* msg,
                  int msg_len) {
  try {
    Lossless dec(data, static_cast<size_t>(size));
    int w, h;
    const std::vector<uint32_t> px = dec.DecodeImage(&w, &h);
    if (w != width || h != height) fail("VP8L: another size than expected");
    for (int y = 0; y < h; ++y) {
      uint8_t* out = rgba + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = px[static_cast<size_t>(y) * w + x];
        out[4 * x] = (p >> 16) & 0xff;
        out[4 * x + 1] = (p >> 8) & 0xff;
        out[4 * x + 2] = p & 0xff;
        out[4 * x + 3] = p >> 24;
      }
    }
    return 0;
  } catch (const Failure& f) {
    Report(f, msg, msg_len);
    return 2;
  }
}

// a VP8 key frame (its chunk's payload to the end of the padded chunk) and
// its ALPH payload (alpha_size < 0: none) -> RGBA rows
int rsn_webp_vp8(const uint8_t* data, int64_t size, const uint8_t* alpha,
                 int64_t alpha_size, uint8_t* rgba, int64_t stride, int width,
                 int height, char* msg, int msg_len) {
  try {
    Lossy dec(data, static_cast<size_t>(size));
    dec.ParseHeaders();
    if (dec.width() != width || dec.height() != height)
      fail("VP8: another size than expected");
    std::vector<uint8_t> a;
    if (alpha_size >= 0)
      a = DecodeAlpha(alpha, static_cast<size_t>(alpha_size), width, height);
    dec.Decode(rgba, stride, alpha_size >= 0 ? a.data() : nullptr);
    return 0;
  } catch (const Failure& f) {
    Report(f, msg, msg_len);
    return 2;
  }
}

}  // extern "C"
