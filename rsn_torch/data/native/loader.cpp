// rsn native dataloader: multithreaded PNG decode -> float32 RGB.
//
// TPU-native counterpart of the reference's native data path (the
// reference inherits nerfstudio's PIL/torch loaders backed by C
// decoders; SURVEY.md §2.3).  Decodes 8-bit RGB/RGBA/gray non-interlaced
// PNGs with zlib, applies the Blender white-alpha blend
// (BlenderDataParser semantics) and writes straight into the caller's
// pinned (N, H, W, 3) float32 buffer from a pthread pool — one image
// per task, no Python in the loop.
//
// Exposed C API (ctypes):
//   int rsn_decode_png_batch(const char** paths, int n,
//                            int height, int width, int blend_white,
//                            float* out, int num_threads);
// Returns 0 on success, else the (1-based) index of the first failing
// image negated.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using std::abs;

namespace {

struct Png {
  uint32_t width = 0, height = 0;
  int channels = 0;   // 1, 3 or 4 (8-bit only)
  std::vector<uint8_t> pixels;  // defiltered, channels per pixel
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const char* path, Png* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (fread(data.data(), 1, size, f) != size_t(size)) {
    fclose(f);
    return false;
  }
  fclose(f);
  static const uint8_t kMagic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || memcmp(data.data(), kMagic, 8) != 0) return false;

  std::vector<uint8_t> idat;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  size_t pos = 8;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    const uint8_t* type = &data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    if (pos + 12 + len > data.size()) return false;
    if (!memcmp(type, "IHDR", 4)) {
      w = be32(body);
      h = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || bit_depth != 8 || interlace != 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return false;  // palette unsupported
  }

  const size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return false;
  }

  out->width = w;
  out->height = h;
  out->channels = ch;
  out->pixels.resize(stride * h);
  const int bpp = ch;  // bytes per pixel (8-bit)
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &out->pixels[stride * y];
    const uint8_t* up = y ? &out->pixels[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }
  return true;
}

// one decoded image -> float32 RGB with optional white-alpha blend
bool emit(const Png& png, int height, int width, int blend_white,
          float* out) {
  if (int(png.height) != height || int(png.width) != width) return false;
  const float inv = 1.0f / 255.0f;
  const size_t npix = size_t(height) * width;
  const uint8_t* p = png.pixels.data();
  switch (png.channels) {
    case 3:
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i + 0] = p[3 * i + 0] * inv;
        out[3 * i + 1] = p[3 * i + 1] * inv;
        out[3 * i + 2] = p[3 * i + 2] * inv;
      }
      return true;
    case 4:
      for (size_t i = 0; i < npix; ++i) {
        float a = p[4 * i + 3] * inv;
        float bg = blend_white ? (1.0f - a) : 0.0f;
        out[3 * i + 0] = p[4 * i + 0] * inv * a + bg;
        out[3 * i + 1] = p[4 * i + 1] * inv * a + bg;
        out[3 * i + 2] = p[4 * i + 2] * inv * a + bg;
      }
      return true;
    case 1:
      for (size_t i = 0; i < npix; ++i) {
        float v = p[i] * inv;
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v;
      }
      return true;
    case 2:
      for (size_t i = 0; i < npix; ++i) {
        float v = p[2 * i] * inv;
        float a = p[2 * i + 1] * inv;
        float bg = blend_white ? (1.0f - a) : 0.0f;
        float val = v * a + bg;
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = val;
      }
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int rsn_decode_png_batch(const char** paths, int n, int height,
                                    int width, int blend_white, float* out,
                                    int num_threads) {
  if (num_threads < 1) num_threads = std::thread::hardware_concurrency();
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      Png png;
      if (!decode_png(paths[i], &png) ||
          !emit(png, height, width, blend_white,
                out + size_t(i) * height * width * 3)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  const int nt = std::min(num_threads, n);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return -failed.load();
}

extern "C" int rsn_probe_png(const char* path, int* height, int* width) {
  Png png;
  if (!decode_png(path, &png)) return -1;
  *height = int(png.height);
  *width = int(png.width);
  return 0;
}
