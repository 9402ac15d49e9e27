// Pillow's bicubic resample (libImaging/Resample.c, 8 bits a channel): the
// bytes of PIL's Image.resize((out_w, out_h)) with its default filter on
// each frame of a batch of interleaved uint8 frames. Built into the decode
// pool's library beside the JPEG decoder; ctypes releases the GIL, so
// callers resize in parallel from their own threads.
//
// As Pillow does it:
//   * the bicubic filter with a = -0.5, its support scaled by the downscale
//     factor; each output index's weights summed left to right, normalised,
//     and put in fixed point with PRECISION_BITS = 22 fractional bits;
//   * a horizontal pass into a uint8 temporary that holds only the source
//     rows from the first to the last one the vertical pass reads, then the
//     vertical pass; an axis whose size does not change is not resampled;
//   * int32 sums started at one half, shifted down, clipped to 0..255.
//
// C ABI:
//   int rs_resize_bicubic(const unsigned char* src /* n*h*w*c */, int n,
//                         int h, int w, int c, int out_h, int out_w,
//                         unsigned char* out /* n*out_h*out_w*c */);
//   returns 0, or -1 for a size below 1.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr double kSupport = 2.0;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// precompute_coeffs and normalize_coeffs_8bpc for the box (0, in_size):
// the first source index and the count of taps of each output index, and
// ksize fixed-point weights each (0 past the count) → ksize.
struct Taps {
  int ksize = 0;
  std::vector<int> first, count;
  std::vector<int32_t> k;
};

Taps make_taps(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = kSupport * filterscale;
  Taps t;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.first.resize(out_size);
  t.count.resize(out_size);
  t.k.assign(static_cast<size_t>(out_size) * t.ksize, 0);
  std::vector<double> w(t.ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = bicubic((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t* k = &t.k[static_cast<size_t>(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = v < 0 ? static_cast<int32_t>(-0.5 + v * (1 << kPrecisionBits))
                   : static_cast<int32_t>(0.5 + v * (1 << kPrecisionBits));
    }
    t.first[xx] = xmin;
    t.count[xx] = xmax;
  }
  return t;
}

inline unsigned char clip8(int32_t sum) {
  const int32_t v = sum >> kPrecisionBits;
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// rows × in_w × c → rows × out_w × c along each row
void horizontal(const unsigned char* src, int rows, int in_w, int c,
                const Taps& t, int out_w, unsigned char* dst) {
  std::vector<int32_t> acc(c);
  for (int y = 0; y < rows; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * in_w * c;
    unsigned char* out = dst + static_cast<size_t>(y) * out_w * c;
    for (int xx = 0; xx < out_w; ++xx) {
      const int32_t* k = &t.k[static_cast<size_t>(xx) * t.ksize];
      const unsigned char* p = row + static_cast<size_t>(t.first[xx]) * c;
      for (int ch = 0; ch < c; ++ch) acc[ch] = 1 << (kPrecisionBits - 1);
      for (int x = 0; x < t.count[xx]; ++x)
        for (int ch = 0; ch < c; ++ch) acc[ch] += p[x * c + ch] * k[x];
      for (int ch = 0; ch < c; ++ch) out[xx * c + ch] = clip8(acc[ch]);
    }
  }
}

// in rows of `width` bytes, indexed from the first one `src` holds → out_h
// rows, each a weighted sum of whole rows (the inner loop vectorises)
void vertical(const unsigned char* src, int width, const Taps& t, int row0,
              int out_h, unsigned char* dst) {
  std::vector<int32_t> acc(width);
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* k = &t.k[static_cast<size_t>(yy) * t.ksize];
    for (int i = 0; i < width; ++i) acc[i] = 1 << (kPrecisionBits - 1);
    for (int y = 0; y < t.count[yy]; ++y) {
      const unsigned char* row =
          src + static_cast<size_t>(t.first[yy] - row0 + y) * width;
      const int32_t ky = k[y];
      for (int i = 0; i < width; ++i) acc[i] += row[i] * ky;
    }
    unsigned char* out = dst + static_cast<size_t>(yy) * width;
    for (int i = 0; i < width; ++i) out[i] = clip8(acc[i]);
  }
}

}  // namespace

extern "C" int rs_resize_bicubic(const unsigned char* src, int n, int h, int w,
                                 int c, int out_h, int out_w,
                                 unsigned char* out) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || out_h < 1 || out_w < 1) return -1;
  const size_t in_frame = static_cast<size_t>(h) * w * c;
  const size_t out_frame = static_cast<size_t>(out_h) * out_w * c;
  const Taps ty = make_taps(h, out_h);
  // the source rows the vertical pass reads
  const int row0 = ty.first[0];
  const int row1 = ty.first[out_h - 1] + ty.count[out_h - 1];
  const bool need_h = w != out_w, need_v = h != out_h;
  Taps tx;
  std::vector<unsigned char> tmp;
  if (need_h) {
    tx = make_taps(w, out_w);
    tmp.resize(static_cast<size_t>(row1 - row0) * out_w * c);
  }
  for (int i = 0; i < n; ++i) {
    const unsigned char* frame = src + i * in_frame;
    unsigned char* dst = out + i * out_frame;
    if (!need_v && !need_h) {
      std::memcpy(dst, frame, in_frame);
    } else if (!need_v) {  // the rows it reads are all of them
      horizontal(frame, h, w, c, tx, out_w, dst);
    } else if (!need_h) {
      vertical(frame, w * c, ty, 0, out_h, dst);
    } else {
      horizontal(frame + static_cast<size_t>(row0) * w * c, row1 - row0, w,
                 c, tx, out_w, tmp.data());
      vertical(tmp.data(), out_w * c, ty, row0, out_h, dst);
    }
  }
  return 0;
}
