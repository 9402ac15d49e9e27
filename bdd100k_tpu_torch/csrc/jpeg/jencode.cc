// Baseline JPEG encoder: (H, W, 3) RGB in, the bytes libjpeg-turbo writes
// for it with its defaults out, which is what PIL's
// `Image.fromarray(rgb).save(f, quality=q)` writes. Built into the decode
// pool's library beside jdecode.cc; each call is independent.
//
// Every step is libjpeg-turbo's integer arithmetic, so the bytes are equal:
//   * jccolor.c rgb_ycc_convert: fixed point with SCALEBITS 16; Cb and Cr
//     get CBCR_OFFSET plus ONE_HALF - 1;
//   * jcprepct.c / jcsample.c: the last column is replicated out to the
//     component's padded width (expand_right_edge), an odd last row is
//     doubled before downsampling, and the downsampled rows are padded to
//     the iMCU height with their last row (expand_bottom_edge); 4:2:0
//     chroma is h2v2_downsample, the mean of 2x2 with the bias 1,2,1,2...;
//   * jccoefct.c compress_data: luma blocks past the component's
//     width_in_blocks / height_in_blocks inside the last MCU are dummy
//     blocks, zero but for the DC copied from the block before;
//   * jfdctint.c jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2) on samples
//     minus 128, then jcdctmgr.c's quantize with compute_reciprocal's
//     reciprocal, correction and shift on the divisor quantval << 3, in the
//     16-bit DCTELEM of the SIMD builds;
//   * jcparam.c: the Annex K tables scaled by jpeg_quality_scaling (q < 50:
//     5000 / q, else 200 - 2q), (v * scale + 50) / 100 clamped to 1..255;
//   * jchuff.c: the standard Annex K Huffman tables (no optimization), 0xFF
//     stuffed with 0x00, the last byte padded with 1-bits;
//   * jcmarker.c: SOI, APP0 JFIF 1.01 (density 1x1, no unit), DQT 0, DQT 1,
//     SOF0 (Y 2x2, Cb and Cr 1x1), DHT DC0, AC0, DC1, AC1, SOS, EOI.
//
// C ABI:
//   long je_encode_rgb(const unsigned char* rgb /* h*w*3 */, int h, int w,
//                      int quality, unsigned char* out, long cap);
//   returns the JPEG's length, writing it to `out` when it fits in `cap`
//   bytes (a larger return value means nothing was written: call again
//   with that capacity), or -1 for a size JPEG cannot hold (0 or > 65535).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNatural[64 + 16] = {  // jutils.c jpeg_natural_order
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kStdLuminanceQuant[64] = {  // natural order (Annex K.1)
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

constexpr int kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: bits[1..16] (index 0 unused) and the symbols
constexpr uint8_t kDcLuminanceBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                          1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChrominanceBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                            1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

constexpr uint8_t kAcLuminanceBits[17] = {0, 0, 2, 1, 3, 3, 2, 4,    3,
                                          5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLuminanceValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr uint8_t kAcChrominanceBits[17] = {0, 0, 2, 1, 2, 4, 4, 3,   4,
                                            7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChrominanceValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* values;
  int count;
};

// jchuff.c jpeg_make_c_derived_tbl: the canonical code of each symbol
struct HuffCodes {
  unsigned code[256] = {};
  int size[256] = {};

  explicit HuffCodes(const HuffSpec& spec) {
    int lengths[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < spec.bits[l]; i++) lengths[p++] = l;
    lengths[p] = 0;
    unsigned c = 0;
    int si = lengths[0];
    p = 0;
    while (lengths[p]) {
      while (lengths[p] == si) {
        code[spec.values[p]] = c++;
        size[spec.values[p]] = si;
        p++;
      }
      c <<= 1;
      si++;
    }
  }
};

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

int flss(uint16_t v) {  // position of the highest set bit, 1-based
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

// (the divisor is quantval << 3, never 1, so the identity case is left out)
Divisor compute_reciprocal(uint16_t divisor) {
  int b = flss(divisor) - 1;
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {uint16_t(fq), uint16_t(c), r};
}

// jfdctint.c jpeg_fdct_islow
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    // pass 0: rows, scaled up by PASS1_BITS; pass 1: columns, scaled back
    const int step = pass == 0 ? 1 : 8;
    const int stride = pass == 0 ? 8 : 1;
    const int shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ctr++) {
      int32_t* d = data + ctr * stride;
      int32_t tmp0 = d[0 * step] + d[7 * step];
      int32_t tmp7 = d[0 * step] - d[7 * step];
      int32_t tmp1 = d[1 * step] + d[6 * step];
      int32_t tmp6 = d[1 * step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step];
      int32_t tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step];
      int32_t tmp4 = d[3 * step] - d[4 * step];

      int32_t tmp10 = tmp0 + tmp3;
      int32_t tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2;
      int32_t tmp12 = tmp1 - tmp2;

      if (pass == 0) {
        d[0 * step] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        d[0 * step] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, shift);
      d[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, shift);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6;
      int32_t z3 = tmp4 + tmp6;
      int32_t z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      d[7 * step] = descale(tmp4 + z1 + z3, shift);
      d[5 * step] = descale(tmp5 + z2 + z4, shift);
      d[3 * step] = descale(tmp6 + z2 + z3, shift);
      d[1 * step] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

  void put(unsigned code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      uint8_t byte = uint8_t(acc_ >> (bits_ - 8));
      out_.push_back(byte);
      if (byte == 0xFF) out_.push_back(0);
      bits_ -= 8;
    }
    acc_ &= (uint64_t(1) << bits_) - 1;
  }

  void flush() {  // jchuff.c flush_bits: fill the last byte with 1-bits
    put(0x7F, 7);
    acc_ = 0;
    bits_ = 0;
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

// jchuff.c encode_one_block; `block` is in natural order
void encode_block(BitWriter& bw, const int16_t* block, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  int diff = block[0] - last_dc;
  last_dc = block[0];
  int mag = diff < 0 ? -diff : diff;
  int nbits = nbits_of(mag);
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(unsigned(diff < 0 ? diff - 1 : diff), nbits);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = block[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    nbits = nbits_of(mag);
    int sym = (run << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(unsigned(v < 0 ? v - 1 : v), nbits);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void quant_table(const int* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = uint16_t(t);
  }
}

// One 8x8 block of a sample plane (row stride `stride`) → DCT → quantized
// coefficients in natural order.
void forward_block(const uint8_t* plane, int stride, int y0, int x0,
                   const Divisor* div, int16_t* coef) {
  int32_t ws[64];
  for (int r = 0; r < 8; r++) {
    const uint8_t* row = plane + size_t(y0 + r) * stride + x0;
    for (int c = 0; c < 8; c++) ws[r * 8 + c] = int32_t(row[c]) - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    // jcdctmgr.c quantize: |t| + correction, times the reciprocal, shifted
    uint32_t a = uint32_t(t < 0 ? -t : t);
    uint32_t q = uint32_t((uint64_t(a + div[i].corr) * div[i].recip) >> div[i].shift);
    coef[i] = int16_t(t < 0 ? -int32_t(q) : int32_t(q));
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void put_dht(std::vector<uint8_t>& o, int index, const HuffSpec& s) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + s.count);
  o.push_back(uint8_t(index));
  for (int l = 1; l <= 16; l++) o.push_back(s.bits[l]);
  for (int i = 0; i < s.count; i++) o.push_back(s.values[i]);
}

}  // namespace

extern "C" long je_encode_rgb(const unsigned char* rgb, int h, int w,
                              int quality, unsigned char* out, long cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return -1;
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int pw = mcux * 16, ph = mcuy * 16;          // padded luma plane
  const int cw = mcux * 8, ch = mcuy * 8;            // chroma planes
  const int ywb = (w + 7) / 8, yhb = (h + 7) / 8;    // luma width/height_in_blocks

  // jccolor.c rgb_ycc_start's tables
  constexpr int kScale = 16;
  constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
  constexpr int32_t kCbCrOffset = int32_t(128) << kScale;
  auto fix = [](double x) { return int32_t(x * (1L << kScale) + 0.5); };
  static int32_t tab[8 * 256];
  static bool tab_ready = false;
  if (!tab_ready) {  // a benign race: every writer stores the same values
    for (int i = 0; i < 256; i++) {
      tab[i + 0 * 256] = fix(0.29900) * i;
      tab[i + 1 * 256] = fix(0.58700) * i;
      tab[i + 2 * 256] = fix(0.11400) * i + kHalf;
      tab[i + 3 * 256] = -fix(0.16874) * i;
      tab[i + 4 * 256] = -fix(0.33126) * i;
      tab[i + 5 * 256] = fix(0.50000) * i + kCbCrOffset + kHalf - 1;
      tab[i + 6 * 256] = -fix(0.41869) * i;
      tab[i + 7 * 256] = -fix(0.08131) * i;
    }
    tab_ready = true;
  }

  // full-size Y, Cb, Cr over the padded plane: columns past the image
  // repeat its last column, rows past it its last row
  std::vector<uint8_t> Y(size_t(ph) * pw), Cb(size_t(ph) * pw), Cr(size_t(ph) * pw);
  for (int y = 0; y < h; y++) {
    const unsigned char* src = rgb + size_t(y) * w * 3;
    uint8_t* yr = &Y[size_t(y) * pw];
    uint8_t* br = &Cb[size_t(y) * pw];
    uint8_t* rr = &Cr[size_t(y) * pw];
    for (int x = 0; x < w; x++) {
      int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
      yr[x] = uint8_t((tab[r] + tab[g + 256] + tab[b + 512]) >> kScale);
      br[x] = uint8_t((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> kScale);
      rr[x] = uint8_t((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> kScale);
    }
    for (int x = w; x < pw; x++) {
      yr[x] = yr[w - 1];
      br[x] = br[w - 1];
      rr[x] = rr[w - 1];
    }
  }
  for (int y = h; y < ph; y++) {
    std::memcpy(&Y[size_t(y) * pw], &Y[size_t(h - 1) * pw], pw);
    std::memcpy(&Cb[size_t(y) * pw], &Cb[size_t(h - 1) * pw], pw);
    std::memcpy(&Cr[size_t(y) * pw], &Cr[size_t(h - 1) * pw], pw);
  }

  // h2v2_downsample over the real row pairs (an odd last row paired with
  // itself), then the last downsampled row repeated to the iMCU height
  const int chr = (h + 1) / 2;
  std::vector<uint8_t> Cbs(size_t(ch) * cw), Crs(size_t(ch) * cw);
  for (int pi = 0; pi < 2; pi++) {
    const std::vector<uint8_t>& full = pi == 0 ? Cb : Cr;
    std::vector<uint8_t>& sub = pi == 0 ? Cbs : Crs;
    for (int j = 0; j < chr; j++) {
      const uint8_t* r0 = &full[size_t(2 * j) * pw];
      const uint8_t* r1 = &full[size_t(2 * j + 1 < h ? 2 * j + 1 : h - 1) * pw];
      uint8_t* o = &sub[size_t(j) * cw];
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int j = chr; j < ch; j++)
      std::memcpy(&sub[size_t(j) * cw], &sub[size_t(chr - 1) * cw], cw);
  }

  uint16_t qt[2][64];
  quant_table(kStdLuminanceQuant, quality, qt[0]);
  quant_table(kStdChrominanceQuant, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = compute_reciprocal(uint16_t(qt[t][i] << 3));

  const HuffSpec dc0{kDcLuminanceBits, kDcValues, 12};
  const HuffSpec ac0{kAcLuminanceBits, kAcLuminanceValues, 162};
  const HuffSpec dc1{kDcChrominanceBits, kDcValues, 12};
  const HuffSpec ac1{kAcChrominanceBits, kAcChrominanceValues, 162};
  const HuffCodes hdc0(dc0), hac0(ac0), hdc1(dc1), hac1(ac1);

  std::vector<uint8_t> o;
  o.reserve(size_t(w) * h / 2 + 1024);
  const uint8_t header[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), header, header + sizeof(header));
  for (int t = 0; t < 2; t++) {  // DQT, 8-bit, in zigzag order
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_u16(o, 67);
    o.push_back(uint8_t(t));
    for (int i = 0; i < 64; i++) o.push_back(uint8_t(qt[t][kNatural[i]]));
  }
  o.push_back(0xFF);  // SOF0
  o.push_back(0xC0);
  put_u16(o, 17);
  o.push_back(8);
  put_u16(o, h);
  put_u16(o, w);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  put_dht(o, 0x00, dc0);
  put_dht(o, 0x10, ac0);
  put_dht(o, 0x01, dc1);
  put_dht(o, 0x11, ac1);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int16_t blocks[6][64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      // jccoefct.c compress_data: four luma blocks, dummies past the
      // component's blocks, then one Cb and one Cr block
      for (int yi = 0; yi < 2; yi++) {
        int16_t* row = blocks[yi * 2];
        if (my * 2 + yi < yhb) {
          for (int xi = 0; xi < 2; xi++) {
            int16_t* blk = row + xi * 64;
            if (mx * 2 + xi < ywb) {
              forward_block(Y.data(), pw, my * 16 + yi * 8, mx * 16 + xi * 8, div[0], blk);
            } else {
              std::memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = blk[-64];
            }
          }
        } else {
          int16_t dc = row[-64];  // the block before this row
          std::memset(row, 0, 2 * 64 * sizeof(int16_t));
          row[0] = row[64] = dc;
        }
      }
      forward_block(Cbs.data(), cw, my * 8, mx * 8, div[1], blocks[4]);
      forward_block(Crs.data(), cw, my * 8, mx * 8, div[1], blocks[5]);
      for (int b = 0; b < 4; b++) encode_block(bw, blocks[b], last_dc[0], hdc0, hac0);
      encode_block(bw, blocks[4], last_dc[1], hdc1, hac1);
      encode_block(bw, blocks[5], last_dc[2], hdc1, hac1);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  long n = long(o.size());
  if (n <= cap) std::memcpy(out, o.data(), size_t(n));
  return n;
}
