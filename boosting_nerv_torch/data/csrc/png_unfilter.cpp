// Undo the five PNG row filters (PNG specification, section 9): None,
// Sub, Up, Average and Paeth.  Sub, Average and Paeth predict each byte
// from the byte one pixel to its left in the same, already reconstructed
// row, so the loop runs byte by byte; this is the part of PNG decoding
// that numpy cannot vectorise.
//
// raw:    h rows, each a filter-type byte then `stride` filtered bytes
//         (the inflated IDAT stream, or one Adam7 pass of it: each pass
//         is filtered as an image of its own);
// out:    h * stride reconstructed bytes;
// stride: ceil(width * samples a pixel * bit depth / 8);
// bpp:    bytes of one complete pixel, rounded up to at least 1 (1 below
//         8 bits, 2 * samples at 16 bits), the distance to the "left"
//         byte.
// Returns 0, or the 1-based row whose filter type is not 0-4.

#include <cstdint>
#include <cstdlib>

extern "C" long png_unfilter(const uint8_t* raw, uint8_t* out, long h,
                             long stride, int bpp) {
  for (long y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;  // the row above
    switch (type) {
      case 0:  // None
        for (long i = 0; i < stride; ++i) cur[i] = src[i];
        break;
      case 1:  // Sub
        for (long i = 0; i < stride; ++i)
          cur[i] = src[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:  // Up
        for (long i = 0; i < stride; ++i)
          cur[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = src[i] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = src[i] + pred;
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
