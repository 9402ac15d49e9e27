// A sequential- and progressive-Huffman JPEG decoder behind the libjpeg
// API subset of jpeglib.h, written to give libjpeg-turbo's pixels bit for
// bit.
//
// The arithmetic follows the Independent JPEG Group's integer routines,
// which libjpeg-turbo keeps (and matches in its SIMD code):
//   * the "islow" 8x8 IDCT (jidctint.c) and the reduced 4x4, 2x2 and 1x1
//     IDCTs of jidctred.c, with their constants, rounding and the
//     post-IDCT range-limit table;
//   * the choice of each component's IDCT size when scaling
//     (jpeg_calc_output_dimensions: chroma is scaled up by the IDCT rather
//     than upsampled where the ratios allow);
//   * fancy (triangle) upsampling, h2v1, h1v2 and h2v2 (jdsample.c), with
//     the edge rows and columns replicated, and box replication otherwise;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c;
//   * the entropy decoder's handling of corrupt data: a code of more than
//     16 bits decodes as 0, a segment that ends early is padded with zero
//     bits and the MCUs after it stay zero up to the next restart marker;
//   * progressive scans (jdphuff.c): DC first and refine scans, AC first
//     and refine scans with their end-of-band runs, decoded into the
//     whole image's coefficients, which are IDCT'd once the input ends
//     (jdcoefct.c's multi-scan mode). libjpeg's interblock smoothing of
//     coefficients that are not yet fully refined (a file cut before its
//     last scans) is not done.
// This software is based in part on the work of the Independent JPEG
// Group.
//
// Errors are C++ exceptions inside; each API entry catches them and hands
// them to the caller's error_exit, outside any handler, as libjpeg does.

#include "jpeglib.h"

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int kDctSize = 8;

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// zigzag position -> natural (row-major) position, padded for corrupt
// run lengths that step past 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ bit reader

struct BitReader {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  uint64_t buf = 0;  // MSB-aligned; the bits below `bits` are zero
  int bits = 0;
  int unread_marker = 0;   // the marker that ended the segment, if any
  bool insufficient = false;

  int next_byte() {
    // past the end, the source supplies a fake EOI, as jpeg_mem_src does
    if (pos >= size) return -1;
    return data[pos++];
  }

  // Load whole bytes while they fit, stopping at a marker.
  void load() {
    while (bits <= 56 && unread_marker == 0) {
      int c = next_byte();
      if (c < 0) {
        unread_marker = 0xD9;
        break;
      }
      if (c == 0xFF) {
        int m;
        do {
          m = next_byte();
        } while (m == 0xFF);
        if (m < 0) {
          unread_marker = 0xD9;
          break;
        }
        if (m != 0) {
          unread_marker = m;
          break;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }

  // Make `n` bits available; past the segment's end they are zeros.
  void need(int n) {
    if (bits >= n) return;
    load();
    if (bits < n) {
      insufficient = true;
      bits = 57;
    }
  }

  int get(int n) {  // 1 <= n <= 16
    need(n);
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }

  // Drop what is left of the segment, as a restart does.
  void reset() {
    buf = 0;
    bits = 0;
  }
};

// ------------------------------------------------------------- Huffman

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int64_t maxcode[18] = {};
  int64_t valoffset[18] = {};
  // (code length << 8) | symbol for codes of <= kLookBits bits, else 0
  uint16_t look[1 << kLookBits] = {};

  void build(bool dc) {
    char size[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = bits[l];
      if (p + n > 256) fail("bad Huffman table");
      while (n--) size[p++] = static_cast<char>(l);
    }
    size[p] = 0;
    const int nsym = p;
    unsigned code_of[257];
    unsigned code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = static_cast<int64_t>(p) - code_of[p];
        p += bits[l];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        const int lookbits = static_cast<int>(code_of[p] << (kLookBits - l));
        for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
          look[lookbits + ctr - 1] =
              static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < nsym; ++i)
        if (vals[i] > 15) fail("bad Huffman table");
    defined = true;
  }

  int decode(BitReader& br) const {
    if (br.bits < kLookBits) br.load();
    if (br.bits >= kLookBits) {
      const uint16_t e = look[br.buf >> (64 - kLookBits)];
      if (e) {
        const int l = e >> 8;
        br.buf <<= l;
        br.bits -= l;
        return e & 0xFF;
      }
    }
    // bit by bit; with garbage input the sentinel stops it at 17 bits
    int l = 1;
    int64_t c = br.get(1);
    while (c > maxcode[l]) {
      c = (c << 1) | br.get(1);
      ++l;
    }
    if (l > 16) return 0;
    return vals[static_cast<int>(c + valoffset[l])];
  }
};

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + static_cast<int>((~0u) << s) + 1 : x;
}

// --------------------------------------------------------------- IDCTs

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// The post-IDCT range limit: libjpeg's table indexed by (x & 1023), which
// clamps x + 128 to [0, 255] for the values a valid stream gives.
inline uint8_t range_limit(int64_t x) {
  const int i = static_cast<int>(x) & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 384) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// jidctint.c constants (CONST_BITS = 13)
constexpr int64_t F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_562915447 = 20995, F_3_072711026 = 25172;
// jidctred.c adds these
constexpr int64_t F_0_211164243 = 1730, F_0_509795579 = 4176,
                  F_0_601344887 = 4926, F_0_720959822 = 5906,
                  F_0_850430095 = 6967, F_1_061594337 = 8697,
                  F_1_272758580 = 10426, F_1_451774981 = 11893,
                  F_2_172734803 = 17799, F_3_624509785 = 29692;

void idct_8x8(const int16_t* in, const uint16_t* q, uint8_t* out,
              size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = ip[0] * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
              size_t stride) {
  int ws[8 * 4];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      const int dc = ip[0] * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 4; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t tmp0 = static_cast<int64_t>(ip[0] * qp[0]) * (1 << (kConstBits + 1));
    const int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t tmp2 = z2 * F_1_847759065 + z3 * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = ip[56] * qp[56], y2 = ip[40] * qp[40];
    const int64_t y3 = ip[24] * qp[24], z4 = ip[8] * qp[8];
    tmp0 = z1 * -F_0_211164243 + y2 * F_1_451774981 + y3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + y2 * -F_0_601344887 + y3 * F_0_899976223 +
           z4 * F_2_562915447;
    const int sh = kConstBits - kPass1Bits + 1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp2, sh));
    wp[24] = static_cast<int>(descale(tmp10 - tmp2, sh));
    wp[8] = static_cast<int>(descale(tmp12 + tmp0, sh));
    wp[16] = static_cast<int>(descale(tmp12 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      const uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
      std::memset(op, v, 4);
      continue;
    }
    int64_t tmp0 = static_cast<int64_t>(wp[0]) * (1 << (kConstBits + 1));
    int64_t tmp2 = wp[2] * F_1_847759065 + wp[6] * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 +
           z4 * F_1_061594337;
    tmp2 = z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 +
           z4 * F_2_562915447;
    op[0] = range_limit(descale(tmp10 + tmp2, sh));
    op[3] = range_limit(descale(tmp10 - tmp2, sh));
    op[1] = range_limit(descale(tmp12 + tmp0, sh));
    op[2] = range_limit(descale(tmp12 - tmp0, sh));
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
              size_t stride) {
  int ws[8 * 2];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // unread by the second pass
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[24] == 0 && ip[40] == 0 && ip[56] == 0) {
      const int dc = ip[0] * qp[0] * (1 << kPass1Bits);
      wp[0] = dc;
      wp[8] = dc;
      continue;
    }
    const int64_t tmp10 =
        static_cast<int64_t>(ip[0] * qp[0]) * (1 << (kConstBits + 2));
    const int64_t tmp0 = static_cast<int64_t>(ip[56] * qp[56]) * -F_0_720959822 +
                         static_cast<int64_t>(ip[40] * qp[40]) * F_0_850430095 +
                         static_cast<int64_t>(ip[24] * qp[24]) * -F_1_272758580 +
                         static_cast<int64_t>(ip[8] * qp[8]) * F_3_624509785;
    const int sh = kConstBits - kPass1Bits + 2;
    wp[0] = static_cast<int>(descale(tmp10 + tmp0, sh));
    wp[8] = static_cast<int>(descale(tmp10 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[3] == 0 && wp[5] == 0 && wp[7] == 0) {
      const uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
      op[0] = v;
      op[1] = v;
      continue;
    }
    const int64_t tmp10 = static_cast<int64_t>(wp[0]) * (1 << (kConstBits + 2));
    const int64_t tmp0 = wp[7] * -F_0_720959822 + wp[5] * F_0_850430095 +
                         wp[3] * -F_1_272758580 + wp[1] * F_3_624509785;
    op[0] = range_limit(descale(tmp10 + tmp0, sh));
    op[1] = range_limit(descale(tmp10 - tmp0, sh));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, size_t) {
  out[0] = range_limit(descale(in[0] * q[0], 3));
}

// ------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  bool quant_latched = false;
  uint16_t quant[64] = {};       // natural order, latched at its first scan
  int bw = 0, bh = 0;            // width_in_blocks, height_in_blocks
  int bw_pad = 0, bh_pad = 0;    // padded to whole MCUs
  std::vector<int16_t> coef;     // bh_pad * bw_pad blocks of 64
  int ssize = 8;                 // DCT_scaled_size
  int pw = 0, ph = 0;            // IDCT'd plane: bw * ssize, bh * ssize
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;

  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  bool have_frame = false;
  bool progressive = false;
  int width = 0, height = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;  // MCUs per row, MCU rows (interleaved)

  int pending_marker = 0;  // a marker read but not yet processed
  bool header_done = false;

  std::vector<jpeg_component_info> info;
  std::vector<uint8_t> out;  // the output image, output_components a pixel
  int out_comps = 0;

  // ---- markers

  int byte() {
    if (pos >= size) fail("unexpected end of JPEG data");
    return data[pos++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    if (pending_marker) {
      const int m = pending_marker;
      pending_marker = 0;
      return m;
    }
    // skip anything up to an FF, then fill bytes
    for (;;) {
      if (pos >= size) return 0xD9;  // a missing EOI reads as one
      int c = data[pos++];
      if (c != 0xFF) continue;
      do {
        if (pos >= size) return 0xD9;
        c = data[pos++];
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    const int len = u16();
    if (len < 2 || pos + (len - 2) > size) fail("bad marker length");
    pos += len - 2;
  }

  void read_app(int marker) {
    const int len = u16();
    if (len < 2 || pos + (len - 2) > size) fail("bad marker length");
    const uint8_t* p = data + pos;
    const int n = len - 2;
    if (marker == 0xE0 && n >= 5 && std::memcmp(p, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos += n;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantization table index");
      if (pq > 1) fail("bad quantization table precision");
      for (int i = 0; i < 64; ++i) {
        const int v = pq ? u16() : byte();
        qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) fail("bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table index");
      Huffman& h = tc ? ac[th] : dc[th];
      int count = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = static_cast<uint8_t>(byte());
        count += h.bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) fail("bad Huffman table");
      std::memset(h.vals, 0, sizeof(h.vals));
      for (int i = 0; i < count; ++i) h.vals[i] = static_cast<uint8_t>(byte());
      len -= count;
      h.build(tc == 0);
    }
    if (len != 0) fail("bad DHT length");
  }

  void read_sof(int marker) {
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2)
      fail("only sequential and progressive Huffman JPEG is supported");
    if (have_frame) fail("more than one frame");
    progressive = marker == 0xC2;
    const int len = u16();
    if (byte() != 8) fail("only 8-bit JPEG is supported");
    height = u16();
    width = u16();
    const int n = byte();
    if (len != 8 + 3 * n) fail("bad SOF length");
    if (width <= 0 || height <= 0) fail("empty image");
    if (n != 1 && n != 3) fail("only 1- and 3-component JPEG is supported");
    comps.assign(n, Component());
    for (auto& c : comps) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = static_cast<int>(
          (static_cast<long>(width) * c.h + 8L * hmax - 1) / (8L * hmax));
      c.bh = static_cast<int>(
          (static_cast<long>(height) * c.v + 8L * vmax - 1) / (8L * vmax));
      c.bw_pad = mcux * c.h;
      c.bh_pad = mcuy * c.v;
    }
    have_frame = true;
  }

  // Read markers up to the first SOS (left pending).
  void read_header() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xDA) {
        if (!have_frame) fail("SOS before SOF");
        pending_marker = m;
        break;
      }
      if (m == 0xD9) fail("no image in the JPEG file");
      process_marker(m);
    }
    header_done = true;
  }

  void process_marker(int m) {
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      read_sof(m);
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) fail("bad DRI length");
      restart_interval = u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      // TEM and stray RSTn carry no length
    } else if (m == 0xD8) {
      fail("SOI inside the image");
    } else {
      skip_segment();  // COM, DNL and the rest
    }
  }

  J_COLOR_SPACE color_space() const {
    if (comps.size() == 1) return JCS_GRAYSCALE;
    if (saw_jfif) return JCS_YCbCr;
    if (saw_adobe) return adobe_transform == 0 ? JCS_RGB : JCS_YCbCr;
    if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B')
      return JCS_RGB;
    return JCS_YCbCr;
  }

  // ---- entropy-coded data

  void decode_block(BitReader& br, const Huffman& dct, const Huffman& act,
                    int& last_dc, int16_t* blk) {
    int s = dct.decode(br);
    if (s) s = extend(br.get(s), s);
    last_dc = static_cast<int>(static_cast<unsigned>(s) +
                               static_cast<unsigned>(last_dc));
    blk[0] = static_cast<int16_t>(last_dc);
    for (int k = 1; k < 64; ++k) {
      const int rs = act.decode(br);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // ---- progressive scans (jdphuff.c), one block each

  static void decode_dc_first(BitReader& br, const Huffman& dct, int& last_dc,
                              int al, int16_t* blk) {
    int s = dct.decode(br);
    if (s) s = extend(br.get(s), s);
    last_dc = static_cast<int>(static_cast<unsigned>(s) +
                               static_cast<unsigned>(last_dc));
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc) << al);
  }

  static void decode_dc_refine(BitReader& br, int al, int16_t* blk) {
    if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  static void decode_ac_first(BitReader& br, const Huffman& act, int ss,
                              int se, int al, int& eobrun, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = act.decode(br);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // One correction bit for an already-nonzero coefficient.
  static void refine_nonzero(BitReader& br, int16_t* coef, int p1, int m1) {
    if (br.get(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  }

  static void decode_ac_refine(BitReader& br, const Huffman& act, int ss,
                               int se, int al, int& eobrun, int16_t* blk) {
    const int p1 = 1 << al;
    const int m1 = static_cast<int>(~0u << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = act.decode(br);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a new coefficient is always +-1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;  // the rest of the block is the end-of-band run's
        }
        // skip r zero coefficients, refining the nonzero ones passed over
        do {
          int16_t* c = &blk[kNatural[k]];
          if (*c != 0) {
            refine_nonzero(br, c, p1, m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = &blk[kNatural[k]];
        if (*c != 0) refine_nonzero(br, c, p1, m1);
      }
      --eobrun;
    }
  }

  // At a restart: drop the segment's last bits and read the RSTn marker.
  void restart(BitReader& br, int* last_dc, int n) {
    br.reset();
    int m = br.unread_marker;
    br.unread_marker = 0;
    if (m == 0) {
      pos = br.pos;
      m = next_marker();
      br.pos = pos;
    }
    // not a restart marker: left for the marker reader, and the rest of the
    // scan decodes as zeros
    if (m < 0xD0 || m > 0xD7) br.unread_marker = m;
    for (int i = 0; i < n; ++i) last_dc[i] = 0;
    br.insufficient = br.unread_marker != 0;
  }

  void read_scan() {
    const int len = u16();
    const int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int tables = byte();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == id) c = &cc;
      if (c == nullptr) fail("SOS names an unknown component");
      c->dc_tbl = tables >> 4;
      c->ac_tbl = tables & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("bad Huffman table index");
      if (!c->quant_latched) {
        if (!qt_defined[c->tq]) fail("a quantization table is missing");
        std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      if (c->coef.empty())
        c->coef.assign(static_cast<size_t>(c->bw_pad) * c->bh_pad * 64, 0);
      sc.push_back(c);
    }
    // Ss, Se, Ah/Al: fixed when sequential (libjpeg only warns otherwise)
    const int ss = byte(), se = byte(), ahal = byte();
    const int ah = ahal >> 4, al = ahal & 15;
    const bool dc_band = ss == 0;
    if (progressive) {  // jdphuff.c's checks of the scan's parameters
      const bool bad = (dc_band ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
                       (ah != 0 && al != ah - 1) || al > 13;
      if (bad) fail("bad progressive scan parameters");
    }
    // the tables the scan decodes with: a DC refinement needs none
    const bool need_dc = !progressive || (dc_band && ah == 0);
    const bool need_ac = !progressive || !dc_band;
    for (const Component* c : sc)
      if ((need_dc && !dc[c->dc_tbl].defined) ||
          (need_ac && !ac[c->ac_tbl].defined))
        fail("a Huffman table is missing");

    BitReader br;
    br.data = data;
    br.size = size;
    br.pos = pos;
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int to_go = restart_interval;

    auto mcu_prologue = [&]() {
      if (restart_interval) {
        if (to_go == 0) {
          restart(br, last_dc, ns);
          eobrun = 0;
          to_go = restart_interval;
        }
        --to_go;
      }
      // a DC refinement reads on past the data's end: its zero bits change
      // nothing
      return !br.insufficient || (progressive && dc_band && ah != 0);
    };
    auto block = [&](int i, int16_t* blk) {
      const Component& c = *sc[i];
      if (!progressive) {
        decode_block(br, dc[c.dc_tbl], ac[c.ac_tbl], last_dc[i], blk);
      } else if (dc_band) {
        if (ah == 0)
          decode_dc_first(br, dc[c.dc_tbl], last_dc[i], al, blk);
        else
          decode_dc_refine(br, al, blk);
      } else if (ah == 0) {
        decode_ac_first(br, ac[c.ac_tbl], ss, se, al, eobrun, blk);
      } else {
        decode_ac_refine(br, ac[c.ac_tbl], ss, se, al, eobrun, blk);
      }
    };

    if (ns == 1) {  // non-interleaved: the component's own blocks, no padding
      Component& c = *sc[0];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          if (!mcu_prologue()) continue;
          block(0, &c.coef[(static_cast<size_t>(by) * c.bw_pad + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (!mcu_prologue()) continue;
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                const size_t by = static_cast<size_t>(my) * c.v + v;
                const size_t bx = static_cast<size_t>(mx) * c.h + h;
                block(i, &c.coef[(by * c.bw_pad + bx) * 64]);
              }
          }
        }
    }
    // carry on after the segment: at the marker that ended it, if one did
    pos = br.pos;
    if (br.unread_marker) pending_marker = br.unread_marker;
  }

  // Every scan up to EOI.
  void read_scans() {
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        read_scan();
      } else {
        process_marker(m);
      }
    }
    for (auto& c : comps)
      if (c.coef.empty()) fail("a component has no scan");
  }

  // ---- output

  void start(jpeg_decompress_struct* ci) {
    // the smallest IDCT size k with scale_num * 8 <= scale_denom * k
    if (ci->scale_num == 0 || ci->scale_denom == 0) fail("bad scale");
    int k = 1;
    while (k < 16 && ci->scale_num * 8 > ci->scale_denom * static_cast<unsigned>(k))
      ++k;
    if (k != 1 && k != 2 && k != 4 && k != 8)
      fail("only the scales 1/1, 1/2, 1/4 and 1/8 are supported");
    ci->min_DCT_scaled_size = k;
    ci->max_h_samp_factor = hmax;
    ci->max_v_samp_factor = vmax;
    ci->output_width =
        static_cast<JDIMENSION>((static_cast<long>(width) * k + 7) / 8);
    ci->output_height =
        static_cast<JDIMENSION>((static_cast<long>(height) * k + 7) / 8);
    info.assign(comps.size(), jpeg_component_info());
    for (size_t i = 0; i < comps.size(); ++i) {
      Component& c = comps[i];
      int ssize = k;
      while (ssize < kDctSize && (hmax * k) % (c.h * ssize * 2) == 0 &&
             (vmax * k) % (c.v * ssize * 2) == 0)
        ssize *= 2;
      c.ssize = ssize;
      jpeg_component_info& ji = info[i];
      ji.h_samp_factor = c.h;
      ji.v_samp_factor = c.v;
      ji.DCT_scaled_size = ssize;
      ji.downsampled_width = static_cast<JDIMENSION>(
          (static_cast<long>(width) * c.h * ssize + hmax * 8L - 1) /
          (hmax * 8L));
      ji.downsampled_height = static_cast<JDIMENSION>(
          (static_cast<long>(height) * c.v * ssize + vmax * 8L - 1) /
          (vmax * 8L));
    }
    ci->comp_info = info.data();

    const J_COLOR_SPACE jcs = color_space();
    if (jcs != JCS_GRAYSCALE && jcs != JCS_YCbCr)
      fail("only grayscale and YCbCr JPEG is supported");
    if (!ci->raw_data_out) {
      const J_COLOR_SPACE ocs = ci->out_color_space;
      const bool ok = (jcs == JCS_GRAYSCALE &&
                       (ocs == JCS_GRAYSCALE || ocs == JCS_RGB)) ||
                      (jcs == JCS_YCbCr && (ocs == JCS_RGB || ocs == JCS_YCbCr));
      if (!ok) fail("unsupported color conversion");
      out_comps = ocs == JCS_GRAYSCALE ? 1 : 3;
    } else {
      out_comps = static_cast<int>(comps.size());
    }
    ci->output_components = out_comps;
    ci->output_scanline = 0;

    read_scans();
    for (auto& c : comps) idct_component(c);
    if (!ci->raw_data_out) render(ci);
  }

  void idct_component(Component& c) {
    void (*idct)(const int16_t*, const uint16_t*, uint8_t*, size_t) =
        c.ssize == 8 ? idct_8x8
        : c.ssize == 4 ? idct_4x4
        : c.ssize == 2 ? idct_2x2
                       : idct_1x1;
    c.pw = c.bw * c.ssize;
    c.ph = c.bh * c.ssize;
    c.plane.assign(static_cast<size_t>(c.pw) * c.ph, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct(&c.coef[(static_cast<size_t>(by) * c.bw_pad + bx) * 64], c.quant,
             &c.plane[static_cast<size_t>(by) * c.ssize * c.pw + bx * c.ssize],
             static_cast<size_t>(c.pw));
    std::vector<int16_t>().swap(c.coef);
  }

  // One component upsampled to the output's width for output row y.
  void upsample_row(const Component& c, const jpeg_component_info& ji,
                    bool fancy_ok, int y, int min_ss, uint8_t* dst) const {
    const int h_in = c.h * c.ssize / min_ss, v_in = c.v * c.ssize / min_ss;
    const int hexp = hmax / h_in, vexp = vmax / v_in;
    const int dw = static_cast<int>(ji.downsampled_width);
    const int dh = static_cast<int>(ji.downsampled_height);
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
      return &c.plane[static_cast<size_t>(r) * c.pw];
    };
    const int in_row = y / vexp;
    const bool fancy_h = fancy_ok && hexp == 2 && dw > 2;
    if (hexp == 2 && vexp == 2 && fancy_h) {  // h2v2 triangle
      const uint8_t* p0 = row(in_row);
      const uint8_t* p1 = row(y % 2 == 0 ? in_row - 1 : in_row + 1);
      int this_sum = p0[0] * 3 + p1[0];
      int next_sum = p0[1] * 3 + p1[1];
      uint8_t* o = dst;
      *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dw; ++x) {
        next_sum = p0[x] * 3 + p1[x];
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      return;
    }
    if (hexp == 2 && vexp == 1 && fancy_h) {  // h2v1 triangle
      const uint8_t* p = row(in_row);
      uint8_t* o = dst;
      int v = p[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + p[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = p[x] * 3;
        *o++ = static_cast<uint8_t>((v + p[x - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + p[x + 1] + 2) >> 2);
      }
      v = p[dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + p[dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      return;
    }
    if (hexp == 1 && vexp == 2 && fancy_ok) {  // h1v2 triangle
      const uint8_t* p0 = row(in_row);
      const bool above = y % 2 == 0;
      const uint8_t* p1 = row(above ? in_row - 1 : in_row + 1);
      const int bias = above ? 1 : 2;
      for (int x = 0; x < dw; ++x)
        dst[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
      return;
    }
    // full size, or box replication by integral factors
    const uint8_t* p = row(in_row);
    if (hexp == 1) {
      std::memcpy(dst, p, static_cast<size_t>(dw));
      return;
    }
    for (int x = 0; x < dw; ++x)
      std::memset(dst + static_cast<size_t>(x) * hexp, p[x], hexp);
  }

  void render(jpeg_decompress_struct* ci) {
    const int ow = static_cast<int>(ci->output_width);
    const int oh = static_cast<int>(ci->output_height);
    const int k = ci->min_DCT_scaled_size;
    const bool fancy_ok = ci->do_fancy_upsampling && k > 1;
    for (size_t i = 0; i < comps.size(); ++i) {
      const Component& c = comps[i];
      const int h_in = c.h * c.ssize / k, v_in = c.v * c.ssize / k;
      if (h_in == 0 || v_in == 0 || hmax % h_in || vmax % v_in)
        fail("unsupported sampling factors");
    }
    out.assign(static_cast<size_t>(ow) * oh * out_comps, 0);
    const size_t rw = static_cast<size_t>(ow) + 2 * 16 * kDctSize;
    std::vector<uint8_t> rows(rw * comps.size());
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      constexpr int kScale = 16;
      constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
      auto fix = [](double v) {
        return static_cast<int64_t>(v * (int64_t{1} << kScale) + 0.5);
      };
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    const bool ycc_to_rgb =
        comps.size() == 3 && ci->out_color_space == JCS_RGB;
    for (int y = 0; y < oh; ++y) {
      for (size_t i = 0; i < comps.size(); ++i)
        upsample_row(comps[i], info[i], fancy_ok, y, k, &rows[i * rw]);
      uint8_t* o = &out[static_cast<size_t>(y) * ow * out_comps];
      if (comps.size() == 1) {
        const uint8_t* g = &rows[0];
        if (out_comps == 1) {
          std::memcpy(o, g, static_cast<size_t>(ow));
        } else {
          for (int x = 0; x < ow; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
        }
      } else if (ycc_to_rgb) {
        const uint8_t* py = &rows[0];
        const uint8_t* pb = &rows[rw];
        const uint8_t* pr = &rows[2 * rw];
        for (int x = 0; x < ow; ++x) {
          const int yy = py[x], cb = pb[x], cr = pr[x];
          o[3 * x] = clamp(yy + cr_r[cr]);
          o[3 * x + 1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp(yy + cb_b[cb]);
        }
      } else {
        for (int x = 0; x < ow; ++x)
          for (int i = 0; i < 3; ++i) o[3 * x + i] = rows[i * rw + x];
      }
    }
    for (auto& c : comps) std::vector<uint8_t>().swap(c.plane);
  }

  JDIMENSION read_scanlines(jpeg_decompress_struct* ci, JSAMPARRAY rows,
                            JDIMENSION max_lines) {
    JDIMENSION n = 0;
    const size_t bytes = static_cast<size_t>(ci->output_width) * out_comps;
    while (n < max_lines && ci->output_scanline < ci->output_height) {
      std::memcpy(rows[n], &out[ci->output_scanline * bytes], bytes);
      ++n;
      ++ci->output_scanline;
    }
    return n;
  }

  JDIMENSION read_raw(jpeg_decompress_struct* ci, JSAMPIMAGE data,
                      JDIMENSION max_lines) {
    if (ci->output_scanline >= ci->output_height) return 0;
    const int lines = vmax * ci->min_DCT_scaled_size;
    if (max_lines < static_cast<JDIMENSION>(lines))
      fail("jpeg_read_raw_data needs a whole iMCU row");
    const int imcu = static_cast<int>(ci->output_scanline) / lines;
    for (size_t i = 0; i < comps.size(); ++i) {
      const Component& c = comps[i];
      const int n = c.v * c.ssize;
      for (int r = 0; r < n; ++r) {
        const int src = imcu * n + r;
        if (src >= c.ph) break;  // the useful rows only
        std::memcpy(data[i][r], &c.plane[static_cast<size_t>(src) * c.pw],
                    static_cast<size_t>(c.pw));
      }
    }
    ci->output_scanline += lines;
    return static_cast<JDIMENSION>(lines);
  }
};

Decoder* state(j_decompress_ptr ci) {
  if (ci->internal == nullptr) fail("jpeg_create_decompress was not called");
  return static_cast<Decoder*>(ci->internal);
}

void default_error_exit(j_common_ptr ci) {
  ci->err->output_message(ci);
  std::abort();
}

void default_output_message(j_common_ptr ci) {
  std::fprintf(stderr, "jpeg: %s\n", ci->err->last_message);
}

// Run `body`; on a decode error, store its message and call error_exit
// outside the handler (it longjmps out of this frame, as in libjpeg).
template <typename F>
auto guarded(j_decompress_ptr ci, F body) -> decltype(body()) {
  bool failed = false;
  try {
    return body();
  } catch (const JpegError& e) {
    std::snprintf(ci->err->last_message, sizeof(ci->err->last_message), "%s",
                  e.what());
    failed = true;
  } catch (const std::bad_alloc&) {
    std::snprintf(ci->err->last_message, sizeof(ci->err->last_message),
                  "out of memory");
    failed = true;
  }
  if (failed) ci->err->error_exit(reinterpret_cast<j_common_ptr>(ci));
  std::abort();  // error_exit must not return
}

}  // namespace

extern "C" {

struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err) {
  err->error_exit = default_error_exit;
  err->output_message = default_output_message;
  err->last_message[0] = 0;
  return err;
}

void jpeg_create_decompress(j_decompress_ptr ci) {
  struct jpeg_error_mgr* err = ci->err;
  std::memset(ci, 0, sizeof(*ci));
  ci->err = err;
  guarded(ci, [&] {
    ci->internal = new Decoder();
    return 0;
  });
}

void jpeg_destroy_decompress(j_decompress_ptr ci) {
  delete static_cast<Decoder*>(ci->internal);
  ci->internal = nullptr;
}

void jpeg_mem_src(j_decompress_ptr ci, const unsigned char* buffer,
                  unsigned long size) {
  guarded(ci, [&] {
    if (buffer == nullptr || size == 0) fail("empty input buffer");
    Decoder* d = state(ci);
    d->data = buffer;
    d->size = size;
    return 0;
  });
}

int jpeg_read_header(j_decompress_ptr ci, boolean /*require_image*/) {
  return guarded(ci, [&] {
    Decoder* d = state(ci);
    d->read_header();
    ci->image_width = static_cast<JDIMENSION>(d->width);
    ci->image_height = static_cast<JDIMENSION>(d->height);
    ci->num_components = static_cast<int>(d->comps.size());
    ci->jpeg_color_space = d->color_space();
    ci->out_color_space =
        ci->jpeg_color_space == JCS_GRAYSCALE ? JCS_GRAYSCALE : JCS_RGB;
    ci->scale_num = 1;
    ci->scale_denom = 1;
    ci->raw_data_out = FALSE;
    ci->do_fancy_upsampling = TRUE;
    // the header's component geometry at scale 1/1, as libjpeg fills it
    d->info.assign(d->comps.size(), jpeg_component_info());
    for (size_t i = 0; i < d->comps.size(); ++i) {
      const Component& c = d->comps[i];
      jpeg_component_info& ji = d->info[i];
      ji.h_samp_factor = c.h;
      ji.v_samp_factor = c.v;
      ji.DCT_scaled_size = kDctSize;
    }
    ci->comp_info = d->info.data();
    ci->max_h_samp_factor = d->hmax;
    ci->max_v_samp_factor = d->vmax;
    return JPEG_HEADER_OK;
  });
}

boolean jpeg_start_decompress(j_decompress_ptr ci) {
  return guarded(ci, [&] {
    Decoder* d = state(ci);
    if (!d->header_done) fail("jpeg_read_header was not called");
    d->start(ci);
    return TRUE;
  });
}

JDIMENSION jpeg_read_scanlines(j_decompress_ptr ci, JSAMPARRAY scanlines,
                               JDIMENSION max_lines) {
  return guarded(ci, [&] {
    Decoder* d = state(ci);
    if (ci->raw_data_out) fail("jpeg_read_scanlines in raw-data mode");
    return d->read_scanlines(ci, scanlines, max_lines);
  });
}

JDIMENSION jpeg_read_raw_data(j_decompress_ptr ci, JSAMPIMAGE data,
                              JDIMENSION max_lines) {
  return guarded(ci, [&] {
    Decoder* d = state(ci);
    if (!ci->raw_data_out) fail("jpeg_read_raw_data without raw_data_out");
    return d->read_raw(ci, data, max_lines);
  });
}

boolean jpeg_finish_decompress(j_decompress_ptr ci) {
  (void)ci;
  return TRUE;
}

}  // extern "C"
