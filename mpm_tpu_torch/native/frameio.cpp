// Native frame and state I/O for mpm_tpu_torch: bulk PNG encoding for frame
// export (a per-row adaptive filter choice and zlib, or at level <= 1 the
// "up" filter alone) and raw float blob I/O, called from Python through
// ctypes (mpm_tpu_torch/native/__init__.py), which falls back to the
// standard library where this file cannot be built. The port's copy of
// mpm_tpu/native/frameio.cpp: the same code and the same build flags, so
// that both libraries write the same bytes on one machine.
//
// Built at first use with g++ into mpm_tpu_torch/_build/ (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void chunk(std::vector<uint8_t>& out, const char tag[4], const uint8_t* data,
           size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
  int p = int(a) + int(b) - int(c);
  int pa = abs(p - int(a)), pb = abs(p - int(b)), pc = abs(p - int(c));
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

int finish_png(int w, int h, const uint8_t* z, size_t zlen, uint8_t** out,
               size_t* out_len) {
  std::vector<uint8_t> png;
  png.reserve(zlen + 128);
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk(png, "IHDR", ihdr, 13);
  chunk(png, "IDAT", z, zlen);
  chunk(png, "IEND", nullptr, 0);

  *out_len = png.size();
  *out = static_cast<uint8_t*>(malloc(png.size()));
  if (!*out) return -3;
  memcpy(*out, png.data(), png.size());
  return 0;
}

}  // namespace

extern "C" {

// Encode an RGB8 image ([h][w][3], row-major) into a PNG byte buffer.
// Applies per-row filter selection (none/sub/up/paeth by minimum absolute
// residual sum) before zlib, which both shrinks and speeds the deflate.
// Returns a malloc'd buffer in *out (caller frees via frameio_free).
int frameio_encode_png(const uint8_t* rgb, int w, int h, int compress_level,
                       uint8_t** out, size_t* out_len) {
  if (!rgb || w <= 0 || h <= 0 || !out || !out_len) return -1;
  const size_t stride = static_cast<size_t>(w) * 3;

  // build filtered scanline stream. Fast path (level <= 1, the frame-export
  // default): "up" filter only — one subtraction per byte instead of the
  // 4-way adaptive scoring, and smooth renders compress nearly as well.
  std::vector<uint8_t> raw;
  raw.reserve((stride + 1) * h);
  if (compress_level <= 1) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = rgb + y * stride;
      const uint8_t* prev = y ? rgb + (y - 1) * stride : nullptr;
      raw.push_back(prev ? 2 : 0);
      if (!prev) {
        raw.insert(raw.end(), row, row + stride);
      } else {
        size_t base = raw.size();
        raw.resize(base + stride);
        uint8_t* dst = raw.data() + base;
        for (size_t i = 0; i < stride; ++i) dst[i] = uint8_t(row[i] - prev[i]);
      }
    }
    uLongf bound = compressBound(static_cast<uLong>(raw.size()));
    std::vector<uint8_t> z(bound);
    if (compress2(z.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                  1) != Z_OK)
      return -2;
    return finish_png(w, h, z.data(), bound, out, out_len);
  }
  std::vector<uint8_t> cand(stride);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + y * stride;
    // score filters: 0 none, 1 sub, 2 up, 4 paeth
    long best_score = -1;
    int best_f = 0;
    std::vector<uint8_t> best(stride);
    for (int f : {0, 1, 2, 4}) {
      if (f == 2 && !prev) continue;
      long score = 0;
      for (size_t i = 0; i < stride; ++i) {
        uint8_t a = i >= 3 ? row[i - 3] : 0;
        uint8_t b = prev ? prev[i] : 0;
        uint8_t c = (prev && i >= 3) ? prev[i - 3] : 0;
        uint8_t v;
        switch (f) {
          case 0: v = row[i]; break;
          case 1: v = uint8_t(row[i] - a); break;
          case 2: v = uint8_t(row[i] - b); break;
          default: v = uint8_t(row[i] - paeth(a, b, c)); break;
        }
        cand[i] = v;
        score += v < 128 ? v : 256 - v;
      }
      if (best_score < 0 || score < best_score) {
        best_score = score;
        best_f = f;
        best.swap(cand);
      }
    }
    raw.push_back(static_cast<uint8_t>(best_f));
    raw.insert(raw.end(), best.begin(), best.end());
    prev = row;
  }

  // zlib-compress
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                compress_level) != Z_OK)
    return -2;
  return finish_png(w, h, z.data(), bound, out, out_len);
}

// Convert a float32 linear-light image [h][w][3] to sRGB-ish uint8 in place
// of the Python gamma loop (gamma 2.2, clamp [0,1]).
void frameio_tonemap_u8(const float* img, int n, uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    float x = img[i];
    if (x < 0.f) x = 0.f;
    if (x > 1.f) x = 1.f;
    // fast pow(x, 1/2.2) via exp/log; exactness is irrelevant for display
    float g = x <= 0.f ? 0.f : __builtin_expf(__builtin_logf(x) * (1.0f / 2.2f));
    int v = static_cast<int>(g * 255.0f + 0.5f);
    out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

void frameio_free(uint8_t* p) { free(p); }

// Raw state blob write: header (magic, count, record fields) + float32 data.
// Used for high-rate trajectory capture where npz overhead dominates.
int frameio_write_blob(const char* path, const float* data, int64_t count) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t magic = 0x4d504d54;  // 'MPMT'
  fwrite(&magic, 4, 1, f);
  fwrite(&count, 8, 1, f);
  size_t written = fwrite(data, sizeof(float), static_cast<size_t>(count), f);
  fclose(f);
  return written == static_cast<size_t>(count) ? 0 : -2;
}

int frameio_read_blob(const char* path, float* data, int64_t count) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0;
  int64_t n = 0;
  if (fread(&magic, 4, 1, f) != 1 || magic != 0x4d504d54) { fclose(f); return -2; }
  if (fread(&n, 8, 1, f) != 1 || n != count) { fclose(f); return -3; }
  size_t got = fread(data, sizeof(float), static_cast<size_t>(count), f);
  fclose(f);
  return got == static_cast<size_t>(count) ? 0 : -4;
}

}  // extern "C"
