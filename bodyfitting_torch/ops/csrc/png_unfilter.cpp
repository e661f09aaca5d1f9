// PNG row unfiltering (host C++): the five filter types of the PNG
// specification, section 9, for 8-bit samples.
//
// The Average and Paeth filters read the reconstructed byte to the left,
// so a row is sequential; a per-pixel Python loop over a multi-megapixel
// mask takes seconds, this loop milliseconds.  Built at first use by
// bodyfitting_torch/ops/kernels/_build.py with the system
// C++ compiler; io/png.py calls it through ctypes.

#include <stdint.h>
#include <stdlib.h>

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                            int64_t stride, int bpp) {
  // raw: height rows of (1 filter byte + stride bytes); out: height x stride.
  // Returns 0, or 1 + the row index of an unknown filter type.
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const int ft = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ft) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}
