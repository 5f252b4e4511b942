// Native data-loader for splat_tpu_torch (a copy of the JAX package's native/imgcache.cpp): multithreaded PNG decode + image cache.
//
// Role: the framework's native runtime component for data IO (SURVEY.md §2b
// FullImageDatamanager: 3DGS trains on whole cached images; caching a scene's
// full-resolution image set through Python/PIL is single-threaded and slow).
// This library decodes PNGs (the benchmark datasets' format) with a from-
// scratch decoder on top of system zlib, in parallel across images, straight
// into one dense float32 (N, H, W, 3) cache buffer, with optional integer-
// factor box downscaling.
//
// C ABI (consumed by splat_tpu_torch/data/native_loader.py via ctypes):
//   int png_probe(const char* path, int* w, int* h);
//   int load_images_f32(const char** paths, int n, int w, int h,
//                       int downscale, int n_threads, float* out);
//     -> 0 on success; out has shape (n, h/downscale, w/downscale, 3).
//
// Supported PNG subset: 8-bit gray / gray+alpha / RGB / RGBA / palette,
// non-interlaced (covers every encoder used by the reference pipelines;
// 16-bit and Adam7 return an error so Python can fall back to PIL).

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
  int w = 0, h = 0, channels = 0, bit_depth = 0, color_type = 0;
  std::vector<uint8_t> rgb;  // (h, w, 3)
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// returns 0 on success
int decode_png(const uint8_t* data, size_t size, Png* out) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || memcmp(data, magic, 8) != 0) return 1;

  size_t pos = 8;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;      // rgb triples
  std::vector<uint8_t> trns;         // palette alpha (unused; we drop alpha)
  int interlace = 0;

  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > size) return 2;
    if (memcmp(type, "IHDR", 4) == 0) {
      out->w = int(be32(body));
      out->h = int(be32(body + 4));
      out->bit_depth = body[8];
      out->color_type = body[9];
      interlace = body[12];
      if (out->bit_depth != 8 || interlace != 0) return 3;  // unsupported
      switch (out->color_type) {
        case 0: out->channels = 1; break;  // gray
        case 2: out->channels = 3; break;  // rgb
        case 3: out->channels = 1; break;  // palette
        case 4: out->channels = 2; break;  // gray+alpha
        case 6: out->channels = 4; break;  // rgba
        default: return 3;
      }
    } else if (memcmp(type, "PLTE", 4) == 0) {
      palette.assign(body, body + len);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (out->w <= 0 || out->h <= 0 || idat.empty()) return 4;

  const int ch = out->channels;
  const size_t stride = size_t(out->w) * ch;
  std::vector<uint8_t> raw((stride + 1) * out->h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return 5;

  // unfilter scanlines in place into `img`
  std::vector<uint8_t> img(stride * out->h);
  for (int y = 0; y < out->h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = img.data() + stride * y;
    const uint8_t* up = y > 0 ? img.data() + stride * (y - 1) : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(ch) ? dst[x - ch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(ch)) ? up[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return 6;
      }
      dst[x] = uint8_t(v);
    }
  }

  // expand to rgb
  out->rgb.resize(size_t(out->w) * out->h * 3);
  for (size_t i = 0; i < size_t(out->w) * out->h; ++i) {
    const uint8_t* p = img.data() + i * ch;
    uint8_t r, g, b;
    switch (out->color_type) {
      case 0: case 4: r = g = b = p[0]; break;
      case 2: case 6: r = p[0]; g = p[1]; b = p[2]; break;
      case 3: {
        if (size_t(p[0]) * 3 + 2 >= palette.size()) return 7;
        r = palette[p[0] * 3]; g = palette[p[0] * 3 + 1]; b = palette[p[0] * 3 + 2];
        break;
      }
      default: return 3;
    }
    out->rgb[i * 3] = r;
    out->rgb[i * 3 + 1] = g;
    out->rgb[i * 3 + 2] = b;
  }
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf->resize(sz);
  size_t rd = fread(buf->data(), 1, sz, f);
  fclose(f);
  return rd == size_t(sz) ? 0 : 2;
}

}  // namespace

extern "C" {

// probe dimensions without full decode; returns 0 on success
int png_probe(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf) != 0 || buf.size() < 33) return 1;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (memcmp(buf.data(), magic, 8) != 0) return 1;
  *w = int(be32(buf.data() + 16));
  *h = int(be32(buf.data() + 20));
  return 0;
}

// Decode n PNGs into out (n, h/d, w/d, 3) float32 in [0,1], using n_threads.
// All images must share dimensions (w, h). Returns 0 on success, else the
// first nonzero per-image error code.
int load_images_f32(const char** paths, int n, int w, int h, int downscale,
                    int n_threads, float* out) {
  if (downscale < 1) downscale = 1;
  const int ow = w / downscale, oh = h / downscale;
  const size_t img_stride = size_t(ow) * oh * 3;
  std::atomic<int> next(0), err(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      std::vector<uint8_t> buf;
      Png png;
      int e = read_file(paths[i], &buf);
      if (e == 0) e = decode_png(buf.data(), buf.size(), &png);
      if (e == 0 && (png.w != w || png.h != h)) e = 8;
      if (e != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, e);
        return;
      }
      float* dst = out + img_stride * i;
      if (downscale == 1) {
        const float k = 1.0f / 255.0f;
        for (size_t j = 0; j < size_t(w) * h * 3; ++j) dst[j] = png.rgb[j] * k;
      } else {
        const int d = downscale;
        const float norm = 1.0f / (255.0f * d * d);
        for (int y = 0; y < oh; ++y) {
          for (int x = 0; x < ow; ++x) {
            float acc[3] = {0, 0, 0};
            for (int dy = 0; dy < d; ++dy) {
              const uint8_t* row = png.rgb.data() + (size_t(y * d + dy) * w + x * d) * 3;
              for (int dx = 0; dx < d; ++dx) {
                acc[0] += row[dx * 3];
                acc[1] += row[dx * 3 + 1];
                acc[2] += row[dx * 3 + 2];
              }
            }
            float* px = dst + (size_t(y) * ow + x) * 3;
            px[0] = acc[0] * norm;
            px[1] = acc[1] * norm;
            px[2] = acc[2] * norm;
          }
        }
      }
    }
  };

  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
