// PNG scanline unfiltering (the PNG specification, section 9): the five
// filter types None, Sub, Up, Average and Paeth, undone row by row over
// the inflated data of one image or one Adam7 pass. Built into the decode
// pool's library beside the JPEG decoder; ctypes releases the GIL.
//
// C ABI:
//   int png_unfilter(const unsigned char* src /* rows*(1+stride) */,
//                    int rows, int stride, int bpp,
//                    unsigned char* out /* rows*stride */);
//   `stride` is the bytes of a row without its filter byte, `bpp` the
//   bytes of a pixel rounded up to 1; returns 0, or -1 on a filter type
//   above 4.

#include <cstdlib>

extern "C" int png_unfilter(const unsigned char* src, int rows, int stride,
                            int bpp, unsigned char* out) {
  const unsigned char* prior = nullptr;  // the row above, reconstructed
  for (int r = 0; r < rows; ++r) {
    const unsigned char* in = src + static_cast<long>(r) * (stride + 1);
    unsigned char* row = out + static_cast<long>(r) * stride;
    const int type = in[0];
    ++in;
    for (int x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = prior ? prior[x] : 0;
      const int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      row[x] = static_cast<unsigned char>(in[x] + pred);
    }
    prior = row;
  }
  return 0;
}
