// The codecs of TIFF strips and tiles, as libtiff 4.7 decodes them for
// PIL's TiffDecode.c (rsn_torch/data/tiff.py reads the container):
//   - PackBits (tif_packbits.c's PackBitsDecode): a literal run cut to
//     the room left, a replicate run cut likewise, a missing byte ending
//     the strip;
//   - LZW (tif_lzw.c's LZWDecode, new-style codes): MSB first, 9 to 12
//     bits, the width grown when the next free entry passes 2^width - 2,
//     a code past the table or a string of length 0 an error, a strip
//     without EOI ended where its data ends;
//   - Deflate (tif_zip.c's ZIPDecode): zlib's inflate until the strip is
//     full or the stream ends;
//   - FillOrder 2: each byte's bits reversed before decoding
//     (TIFFReverseBits in tif_read.c);
//   - predictor 2 (tif_predict.c's horAcc8 / horAcc16 / horAcc32 and their
//     swab versions) and predictor 3 (fpAcc): per row, after decoding;
//   - 16 and 32-bit samples of the other byte order swapped to the host's
//     (libtiff's postdecode), except after predictor 3, which writes the
//     host's order itself.
// A strip that decodes to fewer bytes than the strip holds is an error, as
// libtiff's "Not enough data" is; bytes past it are ignored.
//
// C interface (ctypes): rsn_tiff_decode.  It returns 0, or 2 (corrupt or
// truncated data) with a message.
#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Codec { kPackBits = 1, kLzw = 2, kDeflate = 3 };

struct Failure {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Failure{what}; }

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

void packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  int64_t i = 0;
  while (i < n && occ > 0) {
    int v = static_cast<int8_t>(in[i++]);
    if (v < 0) {
      if (v == -128) continue;  // a no-op
      int64_t run = 1 - v;
      if (occ < run) run = occ;
      if (i >= n) break;  // "Terminating PackBitsDecode due to lack of data"
      uint8_t b = in[i++];
      std::memset(out, b, static_cast<size_t>(run));
      out += run;
      occ -= run;
    } else {
      int64_t run = v + 1;
      if (occ < run) run = occ;
      if (n - i < run) break;
      std::memcpy(out, in + i, static_cast<size_t>(run));
      out += run;
      occ -= run;
      i += run;
    }
  }
  if (occ > 0) fail("PackBits: not enough data for the strip");
}

// LZW: each code's string is its prefix's string and one byte
constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;
constexpr int kTableSize = 1 << kMaxBits;

struct LzwEntry {
  int prefix;
  int length;
  uint8_t value, first;
};

void lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  std::vector<LzwEntry> table(kTableSize + 1);
  for (int c = 0; c < 256; c++)
    table[c] = {-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
  int64_t bitpos = 0;
  const int64_t total_bits = n * 8;
  int nbits = 9;
  int free_ent = kFirst;
  int oldcode = -1;
  auto next_code = [&]() -> int {
    if (total_bits - bitpos < nbits) return kEoi;  // no EOI: ended here
    int code = 0;
    for (int k = 0; k < nbits; k++, bitpos++)
      code = code << 1 | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return code;
  };
  std::vector<uint8_t> str;
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail("LZW: corrupted table after a Clear code");
      *out++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (oldcode < 0) {  // the first code of the data, no Clear before it
      if (code >= 256) fail("LZW: a first code that is not a byte");
      *out++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (code > free_ent || free_ent >= kTableSize)
      fail("LZW: a code past the table (corrupted data)");
    LzwEntry& e = table[free_ent];
    e.prefix = oldcode;
    e.first = table[oldcode].first;
    e.length = table[oldcode].length + 1;
    e.value = code < free_ent ? table[code].first : e.first;
    if (++free_ent > (1 << nbits) - 2) {
      if (++nbits > kMaxBits) nbits = kMaxBits;
    }
    oldcode = code;
    if (code < 256) {
      *out++ = static_cast<uint8_t>(code);
      occ--;
      continue;
    }
    const LzwEntry& c = table[code];
    if (c.length == 0) fail("LZW: a string of length 0 (corrupted data)");
    str.resize(static_cast<size_t>(c.length));
    int k = code;
    for (int j = c.length - 1; j >= 0; j--) {
      str[static_cast<size_t>(j)] = table[k].value;
      k = table[k].prefix;
    }
    int64_t m = std::min<int64_t>(occ, c.length);
    std::memcpy(out, str.data(), static_cast<size_t>(m));
    out += m;
    occ -= m;
  }
  if (occ > 0) fail("LZW: not enough data for the strip");
}

void deflate(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) fail("zlib: inflateInit failed");
  zs.next_in = const_cast<Bytef*>(in);
  zs.avail_in = static_cast<uInt>(std::min<int64_t>(n, 0xFFFFFFFFLL));
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(std::min<int64_t>(occ, 0xFFFFFFFFLL));
  int state = Z_OK;
  while (zs.avail_out > 0) {
    state = inflate(&zs, Z_PARTIAL_FLUSH);
    if (state == Z_STREAM_END) break;
    if (state != Z_OK) break;
  }
  const int64_t left = zs.avail_out;
  inflateEnd(&zs);
  if (state != Z_OK && state != Z_STREAM_END)
    fail(std::string("Deflate: decoding error (") +
         (zs.msg ? zs.msg : "zlib error") + ")");
  if (left > 0) fail("Deflate: not enough data for the strip");
}

template <typename T>
T swapped(T v) {
  T r = 0;
  for (size_t k = 0; k < sizeof(T); k++)
    r = static_cast<T>(r << 8 | ((v >> (8 * k)) & 0xFF));
  return r;
}

template <typename T>
void swab_row(uint8_t* row, int64_t bytes) {
  for (int64_t i = 0; i + static_cast<int64_t>(sizeof(T)) <= bytes;
       i += sizeof(T)) {
    T v;
    std::memcpy(&v, row + i, sizeof(T));
    v = swapped(v);
    std::memcpy(row + i, &v, sizeof(T));
  }
}

// horAcc: each sample plus the one `stride` samples before it, modulo its
// width, the row in the host's byte order
template <typename T>
void hor_acc(uint8_t* row, int64_t bytes, int stride) {
  const int64_t n = bytes / static_cast<int64_t>(sizeof(T));
  for (int64_t i = stride; i < n; i++) {
    T a, b;
    std::memcpy(&a, row + (i - stride) * sizeof(T), sizeof(T));
    std::memcpy(&b, row + i * sizeof(T), sizeof(T));
    b = static_cast<T>(a + b);
    std::memcpy(row + i * sizeof(T), &b, sizeof(T));
  }
}

// fpAcc: bytes summed `stride` apart, then the byte planes (most
// significant first) woven back into samples of the host's order
void fp_acc(uint8_t* row, int64_t bytes, int stride, int bps,
            std::vector<uint8_t>* tmp) {
  for (int64_t i = stride; i < bytes; i++)
    row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
  const int64_t wc = bytes / bps;
  tmp->assign(row, row + bytes);
  for (int64_t c = 0; c < wc; c++)
    for (int b = 0; b < bps; b++)  // little-endian host
      row[bps * c + b] = (*tmp)[static_cast<size_t>((bps - b - 1) * wc + c)];
}

void set_message(char* msg, int msg_len, const std::string& s) {
  if (msg == nullptr || msg_len <= 0) return;
  size_t n = std::min(s.size(), static_cast<size_t>(msg_len - 1));
  std::memcpy(msg, s.data(), n);
  msg[n] = 0;
}

}  // namespace

extern "C" {

// One strip or tile: `n` compressed bytes -> exactly `size` bytes in out,
// in rows of `row_bytes`.  predictor 1, 2 or 3 on `bps`-bit samples,
// `stride` samples to a pixel; swab: the file's byte order is not the
// host's; reverse: FillOrder 2.
int rsn_tiff_decode(const uint8_t* in, int64_t n, int codec, uint8_t* out,
                    int64_t size, int predictor, int64_t row_bytes, int bps,
                    int stride, int swab, int reverse, char* msg,
                    int msg_len) {
  try {
    std::vector<uint8_t> flipped;
    if (reverse) {
      flipped.resize(static_cast<size_t>(n));
      for (int64_t i = 0; i < n; i++) flipped[i] = reversed(in[i]);
      in = flipped.data();
    }
    switch (codec) {
      case kPackBits:
        packbits(in, n, out, size);
        break;
      case kLzw:
        lzw(in, n, out, size);
        break;
      case kDeflate:
        deflate(in, n, out, size);
        break;
      default:
        fail("unknown codec");
    }
    if (row_bytes <= 0) return 0;
    std::vector<uint8_t> tmp;
    for (int64_t r = 0; r + row_bytes <= size; r += row_bytes) {
      uint8_t* row = out + r;
      if (predictor == 3) {
        fp_acc(row, row_bytes, stride, bps / 8, &tmp);
        continue;
      }
      if (swab && bps == 16) swab_row<uint16_t>(row, row_bytes);
      if (swab && bps == 32) swab_row<uint32_t>(row, row_bytes);
      if (predictor != 2) continue;
      if (bps == 8) hor_acc<uint8_t>(row, row_bytes, stride);
      else if (bps == 16) hor_acc<uint16_t>(row, row_bytes, stride);
      else if (bps == 32) hor_acc<uint32_t>(row, row_bytes, stride);
    }
    return 0;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
    return 2;
  }
}

}  // extern "C"
