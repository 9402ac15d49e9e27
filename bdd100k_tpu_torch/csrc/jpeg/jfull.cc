// Full-resolution JPEG decode: one JPEG in, (H, W, 3) RGB out at scale 1/1
// with fancy upsampling and no resize — the pixels of libjpeg's defaults,
// which are what PIL's Image.open(path).convert("RGB") gives for a YCbCr
// or grayscale JPEG — or at libjpeg's scale 1/2 or 1/4, as cv2.imdecode's
// IMREAD_REDUCED_COLOR_2 and _4 decode. Built into the decode pool's
// library beside jdecode.cc; each call is independent, so callers decode
// in parallel from their own threads (ctypes releases the GIL).
//
// C ABI:
//   int jd_image_size(const unsigned char* jpeg, long len, int* h, int* w);
//   int jd_decode_rgb(const unsigned char* jpeg, long len, int denom, int h,
//                     int w, unsigned char* out /* h*w*3 */);
//   both return 0 on success and -1 when the decoder refuses the JPEG;
//   jd_decode_rgb decodes at scale 1/denom, returns -2 when the image at
//   that scale is not h×w, and -3 when the data ended before the EOI
//   marker (libjpeg's "premature end of JPEG file"): `out` then holds the
//   decode libjpeg gives, which PIL and cv2 refuse.

#include <csetjmp>
#include <cstddef>

#include "jpeglib.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

}  // namespace

extern "C" {

int jd_image_size(const unsigned char* jpeg, long len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jd_decode_rgb(const unsigned char* jpeg, long len, int denom, int h,
                  int w, unsigned char* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned int>(denom);
  cinfo.do_fancy_upsampling = TRUE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const size_t pitch = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + cinfo.output_scanline * pitch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  const bool truncated = err.pub.num_warnings > 0;
  jpeg_destroy_decompress(&cinfo);
  return truncated ? -3 : 0;
}

}  // extern "C"
