// The host loops of the simple raster formats, as PIL 12.1.0 runs them for
// rsn_torch.data's BMP, TGA, GIF and PPM readers (built by
// rsn_torch.data.native.get_raster_lib with g++ at first use):
//
// - rsn_bmp_rle: BmpImagePlugin.BmpRleDecoder (PIL's Python RLE8 / RLE4
//   decoder), its quirks included: a delta escape reads four bytes and
//   takes the last two, RLE4's absolute runs of odd length lose their last
//   pixel, the word alignment follows the absolute file position.
// - rsn_tga_rle: libImaging's TgaRleDecode.c (a run past the row's end is
//   an overrun, a literal packet continues on the next rows).
// - rsn_gif_lzw: libImaging's GifDecode.c (codes of the minimum code size
//   + 1 to 12 bits, the table full at 4096, interlaced passes).
// - rsn_ppm_plain: PpmImagePlugin.PpmPlainDecoder (P1's bits, P2 / P3's
//   decimal tokens rescaled to 255 or 65535, comments dropped per 1 MiB
//   block as it drops them).
//
// The two C decoders are driven as ImageFile.load drives them: the file
// read in blocks of 65536 bytes from the tile's offset, each call given
// what the last left plus the next block; the file's end before the
// decoder reports the image done is a truncated file.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, TRUNCATED = 1, BROKEN = 2, OVERRUN = 3, CONFIG = 4 };
const int64_t MAXBLOCK = 65536;        // ImageFile.MAXBLOCK
const int64_t SAFEBLOCK = 1024 * 1024;  // ImageFile.SAFEBLOCK

void say(char* msg, int len, const char* what) {
  if (len > 0) std::snprintf(msg, len, "%s", what);
}

// ImageFile.load's loop over a C decoder: `decode(buffer, bytes)` returns
// the bytes it consumed, or -1 when done (err set on failure).
template <class Decoder>
int drive(const uint8_t* data, int64_t size, int64_t offset, Decoder& dec) {
  std::vector<uint8_t> b;
  int64_t pos = offset < size ? offset : size;
  for (;;) {
    int64_t s = size - pos < MAXBLOCK ? size - pos : MAXBLOCK;
    if (s <= 0) return TRUNCATED;
    b.insert(b.end(), data + pos, data + pos + s);
    pos += s;
    int64_t n = dec.decode(b.data(), (int64_t)b.size());
    if (n < 0) return dec.err;
    b.erase(b.begin(), b.begin() + n);
  }
}

// ---- TGA RLE (TgaRleDecode.c) --------------------------------------------

template <int D>
void fill_n(uint8_t* out, const uint8_t* px, int64_t n) {
  for (int64_t i = 0; i < n; i += D)
    for (int k = 0; k < D; k++) out[i + k] = px[k];
}

struct TgaRle {
  int depth;          // bytes per pixel (state->count)
  int64_t row_bytes;  // state->bytes
  int ysize;
  uint8_t* out;       // ysize rows of row_bytes, in decode order
  std::vector<uint8_t> line;
  int64_t x = 0;
  int y = 0;
  int err = OK;

  // a run's n bytes of one pixel
  void fill(uint8_t* out, const uint8_t* px, int64_t n) {
    switch (depth) {
      case 1: std::memset(out, px[0], n); break;
      case 2: fill_n<2>(out, px, n); break;
      case 3: fill_n<3>(out, px, n); break;
      default: fill_n<4>(out, px, n); break;
    }
  }

  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    int64_t extra = 0;
    for (;;) {
      if (bytes < 1) return ptr - buf;
      int64_t n = (int64_t)depth * ((ptr[0] & 0x7f) + 1);
      if (ptr[0] & 0x80) {
        if (bytes < 1 + depth) break;
        if (x + n > row_bytes) {
          err = OVERRUN;
          return -1;
        }
        fill(line.data() + x, ptr + 1, n);
        ptr += 1 + depth;
        bytes -= 1 + depth;
      } else {
        if (bytes < 1 + n) break;
        if (x + n > row_bytes) {
          extra = n;
          n = row_bytes - x;
          extra -= n;
        }
        std::memcpy(line.data() + x, ptr + 1, n);
        ptr += 1 + n;
        bytes -= 1 + n;
      }
      for (;;) {
        x += n;
        if (x >= row_bytes) {
          std::memcpy(out + (int64_t)y * row_bytes, line.data(), row_bytes);
          x = 0;
          if (++y >= ysize) return -1;
        }
        if (extra == 0 || x > 0) break;
        n = extra >= row_bytes ? row_bytes : extra;
        std::memcpy(line.data() + x, ptr, n);
        ptr += n;
        bytes -= n;
        extra -= n;
      }
    }
    return ptr - buf;
  }
};

// ---- GIF LZW (GifDecode.c) -------------------------------------------------

const int GIFTABLE = 4096, GIFBITS = 12;

struct GifLzw {
  int bits, interlace;
  uint8_t* image;
  int64_t pitch;
  int xoff, yoff, xsize, ysize;
  int err = OK;
  int state = 0, x = 0, y = 0;
  int step = 1, repeat = 0;
  int32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int clear = 0, end = 0, next = 0, codesize = 0, codemask = 0;
  int lastcode = 0;
  uint8_t lastdata = 0;
  int bufferindex = 0;
  uint8_t buffer[GIFTABLE];
  uint8_t data[GIFTABLE];
  uint16_t link[GIFTABLE];

  uint8_t* row(int yy) { return image + (int64_t)(yy + yoff) * pitch + xoff; }

  // NEWLINE: false when the image is done
  bool newline(uint8_t*& out) {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1:
          repeat = y = 4;
          interlace = 2;
          break;
        case 2:
          step = 4;
          repeat = y = 2;
          interlace = 3;
          break;
        case 3:
          step = 2;
          repeat = y = 1;
          interlace = 0;
          break;
        default:
          return false;
      }
    }
    if (y < ysize) out = row(y);
    return true;
  }

  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      if (bits < 0 || bits > 12) {
        err = CONFIG;
        return -1;
      }
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = repeat = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    uint8_t* out = row(y) + x;
    const uint8_t* p;
    int i, c;
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = GIFTABLE;
        state = 2;
      }
      if (bufferindex < GIFTABLE) {
        i = GIFTABLE - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = GIFTABLE;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            c = *ptr++;
            bytes--;
            blocksize--;
            bitbuffer |= (int32_t)c << bitcount;
            bitcount += 8;
          } else {
            if (bytes < 1) return ptr - buf;
            c = *ptr;
            if (bytes < c + 1) return ptr - buf;
            blocksize = c;
            ptr++;
            bytes--;
          }
        }
        c = (int)bitbuffer & codemask;
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) break;
        i = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) {
            err = BROKEN;
            return -1;
          }
          lastdata = (uint8_t)c;
          lastcode = c;
          state = 3;
        } else {
          int thiscode = c;
          if (c > next) {
            err = BROKEN;
            return -1;
          }
          if (c == next) {
            if (bufferindex <= 0) {
              err = BROKEN;
              return -1;
            }
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= GIFTABLE) {
              err = BROKEN;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = (uint8_t)c;
          if (next < GIFTABLE) {
            data[next] = (uint8_t)c;
            link[next] = (uint16_t)lastcode;
            if (next == codemask && codesize < GIFBITS) {
              codesize++;
              codemask = (1 << codesize) - 1;
            }
            next++;
          }
          lastcode = thiscode;
        }
      }
      if (y >= ysize) {
        err = OVERRUN;
        return -1;
      }
      // frame 0 has no transparency for the decoder: the fast paths
      if (i == 1) {
        if (x < xsize - 1) {
          *out++ = p[0];
          x++;
          continue;
        }
      } else if (x + i <= xsize) {
        std::memcpy(out, p, i);
        out += i;
        x += i;
        if (x == xsize && !newline(out)) return -1;
        continue;
      }
      for (c = 0; c < i; c++) {
        *out++ = p[c];
        if (++x >= xsize) {
          if (!newline(out)) return -1;
          if (y >= ysize) return -1;
        }
      }
    }
    return ptr - buf;
  }
};

// ---- PPM plain tokens (PpmPlainDecoder) -------------------------------------

bool is_space(uint8_t c) {  // bytes.split / isspace: ASCII whitespace
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0x0b ||
         c == 0x0c;
}

struct PlainReader {
  const uint8_t* data;
  int64_t size, pos;
  bool comment_spans = false;

  std::string read_block() {
    int64_t n = size - pos < SAFEBLOCK ? size - pos : SAFEBLOCK;
    if (n <= 0) return std::string();
    std::string s((const char*)data + pos, (size_t)n);
    pos += n;
    return s;
  }

  // _find_comment_end: min of the \n and \r indices when their product is
  // positive, else the larger (so an index 0 loses to a later one)
  static int64_t comment_end(const std::string& b, size_t start) {
    size_t fa = b.find('\n', start), fb = b.find('\r', start);
    int64_t a = fa == std::string::npos ? -1 : (int64_t)fa;
    int64_t c = fb == std::string::npos ? -1 : (int64_t)fb;
    if (a * c > 0) return a < c ? a : c;
    return a > c ? a : c;
  }

  std::string ignore_comments(std::string block) {
    if (comment_spans) {
      while (!block.empty()) {
        int64_t e = comment_end(block, 0);
        if (e != -1) {
          block = block.substr((size_t)e + 1);
          break;
        }
        block = read_block();
      }
    }
    comment_spans = false;
    for (;;) {
      size_t start = block.find('#');
      if (start == std::string::npos) break;
      int64_t e = comment_end(block, start);
      if (e != -1) {
        block = block.substr(0, start) + block.substr((size_t)e + 1);
      } else {
        block = block.substr(0, start);
        comment_spans = true;
        break;
      }
    }
    return block;
  }
};

std::vector<std::string> split_ws(const std::string& b) {
  std::vector<std::string> out;
  size_t i = 0, n = b.size();
  while (i < n) {
    while (i < n && is_space((uint8_t)b[i])) i++;
    size_t j = i;
    while (j < n && !is_space((uint8_t)b[j])) j++;
    if (j > i) out.push_back(b.substr(i, j - i));
    i = j;
  }
  return out;
}

// Python's int() of a token without whitespace: [+-]digits, single
// underscores between digits
bool python_int(const std::string& t, int64_t* value) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size()) return false;
  int64_t v = 0;
  bool digit_before = false;
  for (; i < t.size(); i++) {
    char ch = t[i];
    if (ch >= '0' && ch <= '9') {
      v = v * 10 + (ch - '0');
      digit_before = true;
    } else if (ch == '_' && digit_before && i + 1 < t.size() &&
               t[i + 1] >= '0' && t[i + 1] <= '9') {
      digit_before = false;
    } else {
      return false;
    }
  }
  *value = neg ? -v : v;
  return true;
}

std::string shown(const std::string& t) {
  std::string s;
  for (unsigned char ch : t.substr(0, 11)) {
    char b[8];
    if (ch >= 32 && ch < 127) {
      s += (char)ch;
    } else {
      std::snprintf(b, sizeof b, "\\x%02x", ch);
      s += b;
    }
  }
  return s;
}

}  // namespace

extern "C" {

// BmpRleDecoder.decode from `offset`: the pixel bytes (P indices or L
// values) in file order into out[0, xsize * ysize); *length gets the
// length PIL's bytearray reaches (past xsize * ysize when the last run
// overshoots, short of it when the data ends first).  1: a delta escape
// cut short, PIL's ValueError.
int rsn_bmp_rle(const uint8_t* data, int64_t size, int64_t offset, int xsize,
                int ysize, int rle4, uint8_t* out, int64_t* length, char* msg,
                int msglen) {
  const int64_t dest = (int64_t)xsize * ysize;
  int64_t len = 0, x = 0, pos = offset;
  auto avail = [&](int64_t n) {
    int64_t left = size - pos;
    if (left < 0) left = 0;
    return n < left ? n : left;
  };
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    len++;
  };
  auto zeros = [&](int64_t n) {
    for (int64_t k = len; k < len + n && k < dest; k++) out[k] = 0;
    len += n;
  };
  std::memset(out, 0, (size_t)dest);
  while (len < dest) {
    if (avail(2) < 2) break;  // read(1) twice: both must give a byte
    int64_t num = data[pos];
    uint8_t byte = data[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > xsize) num = xsize - x > 0 ? xsize - x : 0;
      if (rle4) {
        uint8_t first = byte >> 4, second = byte & 0x0f;
        for (int64_t k = 0; k < num; k++) put(k % 2 == 0 ? first : second);
      } else {
        for (int64_t k = 0; k < num; k++) put(byte);
      }
      x += num;
    } else if (byte == 0) {  // end of line
      zeros((xsize - len % xsize) % xsize);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: read(2), then `right, up = read(2)`
      if (avail(2) < 2) break;
      pos += 2;
      if (avail(2) != 2) {
        say(msg, msglen, "a delta escape cut short (not enough values to "
                         "unpack)");
        return 1;
      }
      int64_t right = data[pos], up = data[pos + 1];
      pos += 2;
      zeros(right + up * xsize);
      x = len % xsize;
    } else {  // absolute mode
      int64_t count = rle4 ? byte / 2 : byte;
      int64_t got = avail(count);
      for (int64_t k = 0; k < got; k++) {
        uint8_t v = data[pos + k];
        if (rle4) {
          put(v >> 4);
          put(v & 0x0f);
        } else {
          put(v);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if (pos % 2 != 0) pos += 1;  // fd.tell() % 2: the file's position
    }
  }
  *length = len;
  return 0;
}

// TgaRleDecode.c from `offset` into `rows` rows of row_bytes (decode
// order) -> 0, 1 truncated, 3 overrun.
int rsn_tga_rle(const uint8_t* data, int64_t size, int64_t offset, int depth,
                int64_t row_bytes, int rows, uint8_t* out) {
  if (depth <= 0) return TRUNCATED;  // 1-bit: packets of no bytes, to EOF
  TgaRle dec{depth, row_bytes, rows, out};
  dec.line.assign((size_t)row_bytes, 0);
  return drive(data, size, offset, dec);
}

// GifDecode.c from `offset` (the sub-blocks after the minimum code size)
// into the (xoff, yoff, xsize, ysize) window of `image` (rows `pitch`
// bytes apart) -> 0, 1 truncated, 2 broken, 3 overrun, 4 config.
int rsn_gif_lzw(const uint8_t* data, int64_t size, int64_t offset, int bits,
                int interlace, uint8_t* image, int64_t pitch, int xoff,
                int yoff, int xsize, int ysize) {
  GifLzw* dec = new GifLzw();
  dec->bits = bits;
  dec->interlace = interlace;
  dec->image = image;
  dec->pitch = pitch;
  dec->xoff = xoff;
  dec->yoff = yoff;
  dec->xsize = xsize;
  dec->ysize = ysize;
  int rc = drive(data, size, offset, *dec);
  delete dec;
  return rc;
}

// PpmPlainDecoder from `offset`: bitonal (P1) -> one byte a pixel, 0xff
// for "0" and 0 for "1" (rawmode 1;8); else decimal tokens rescaled to 255
// (bytes) or, out_i32, to 65535 (little-endian int32) -> 0 with *produced
// the bytes made (short of total when the tokens end first), or 1 and
// PIL's ValueError in msg.
int rsn_ppm_plain(const uint8_t* data, int64_t size, int64_t offset,
                  int bitonal, int64_t maxval, int out_i32, int64_t total,
                  uint8_t* out, int64_t* produced, char* msg, int msglen) {
  PlainReader rd{data, size, offset < size ? offset : size};
  int64_t len = 0;
  *produced = 0;
  if (bitonal) {
    while (len != total) {
      std::string block = rd.read_block();
      if (block.empty()) break;
      block = rd.ignore_comments(block);
      std::string tokens;
      for (unsigned char ch : block)
        if (!is_space(ch)) tokens += (char)ch;
      for (unsigned char ch : tokens) {
        if (ch != '0' && ch != '1') {
          std::string m = "Invalid token for this mode: " +
                          shown(std::string(1, (char)ch));
          say(msg, msglen, m.c_str());
          return 1;
        }
      }
      for (unsigned char ch : tokens) {
        if (len == total) break;
        out[len++] = ch == '0' ? 0xff : 0x00;
      }
    }
    *produced = len;
    return 0;
  }
  const int max_len = 10;
  const double out_max = out_i32 ? 65535.0 : 255.0;
  std::string half;
  while (len != total) {
    std::string block = rd.read_block();
    if (block.empty()) {
      if (!half.empty()) {
        block = " ";
      } else {
        break;
      }
    }
    block = rd.ignore_comments(block);
    if (!half.empty()) {
      block = half + block;
      half.clear();
    }
    std::vector<std::string> tokens = split_ws(block);
    if (!block.empty() && !is_space((uint8_t)block.back())) {
      half = tokens.back();
      tokens.pop_back();
      if ((int)half.size() > max_len) {
        std::string m = "Token too long found in data: " + shown(half);
        say(msg, msglen, m.c_str());
        return 1;
      }
    }
    for (const std::string& t : tokens) {
      if ((int)t.size() > max_len) {
        std::string m = "Token too long found in data: " + shown(t);
        say(msg, msglen, m.c_str());
        return 1;
      }
      int64_t v;
      if (!python_int(t, &v)) {
        std::string m = "invalid literal for int() with base 10: " + shown(t);
        say(msg, msglen, m.c_str());
        return 1;
      }
      if (v < 0) {
        say(msg, msglen, "Channel value is negative");
        return 1;
      }
      if (v > maxval) {
        say(msg, msglen, "Channel value too large for this mode");
        return 1;
      }
      int64_t r = (int64_t)std::nearbyint((double)v / (double)maxval * out_max);
      if (out_i32) {
        int32_t w = (int32_t)r;
        std::memcpy(out + len, &w, 4);  // o32le on a little-endian host
        len += 4;
      } else {
        out[len++] = (uint8_t)r;
      }
      if (len == total) break;
    }
  }
  *produced = len;
  return 0;
}

}  // extern "C"
