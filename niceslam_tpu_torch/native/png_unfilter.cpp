// Undo the row filters of a non-interlaced PNG image (PNG specification,
// section 9: filter method 0, types None, Sub, Up, Average and Paeth).
//
// Host code for the port's PNG reader (niceslam_tpu_torch/io/png.py), which
// inflates the IDAT stream with zlib and hands the rows here: a per-byte
// loop in Python would hold the interpreter lock for about a second per
// 640x480 RGB frame, while the frame prefetcher shares that lock with the
// loop that launches the kernels. Called through ctypes, which releases it.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// in:  rows * (1 + stride) bytes, each row a filter-type byte and its data;
// out: rows * stride bytes of unfiltered data. bpp is the number of bytes
// per complete pixel (at least 1). Returns 0, or 1 + the index of the first
// row whose filter type is not 0-4.
int png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows, int64_t stride,
                 int64_t bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* src = in + y * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* dst = out + y * stride;
    switch (type) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (x >= bpp ? dst[x - bpp] : 0);
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) dst[x] = src[x] + (prev ? prev[x] : 0);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int left = x >= bpp ? dst[x - bpp] : 0;
          const int up = prev ? prev[x] : 0;
          dst[x] = src[x] + static_cast<uint8_t>((left + up) >> 1);
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int left = x >= bpp ? dst[x - bpp] : 0;
          const int up = prev ? prev[x] : 0;
          const int upleft = (prev && x >= bpp) ? prev[x - bpp] : 0;
          dst[x] = src[x] + paeth(left, up, upleft);
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
