// PNG scanline unfiltering on the host (datr_torch/data/png.py).
//
// The five PNG filters (None, Sub, Up, Average, Paeth; PNG spec section 9)
// undone in one pass over the inflated IDAT stream. Sub, Average and Paeth
// are recurrences along each row, so they do not vectorize in numpy; a
// Cityscapes frame (1024x2048 RGB) is 6 M bytes. Built with
// `g++ -O2 -shared -fPIC` at first use and loaded with ctypes, which
// releases the GIL for the call.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: h rows of (1 filter byte + rowbytes bytes); out: h * rowbytes bytes.
// bpp: bytes per complete pixel (1..8). Returns 0, or 1 + the row of the
// first unknown filter type.
int png_unfilter(const uint8_t* src, int64_t h, int64_t rowbytes, int bpp,
                 uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above the first is all zero
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int filter = in[0];
    ++in;
    uint8_t* cur = out + y * rowbytes;
    switch (filter) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = in[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = in[i] + pred;
        }
        break;
      default:
        return static_cast<int>(1 + y);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
