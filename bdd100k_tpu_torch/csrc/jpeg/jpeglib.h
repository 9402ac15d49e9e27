/* The subset of libjpeg's decompression API that native/decode_pool.cc
 * calls, with libjpeg's names, types and semantics, implemented by
 * jdecode.cc beside this header.
 *
 * The decode pool is built against this header and jdecode.cc instead of
 * the system's libjpeg, on every machine, so that a JPEG decodes to the
 * same pixels wherever the port runs, and to the pixels libjpeg-turbo
 * gives with its default settings (islow integer IDCT and its reduced
 * 4x4 / 2x2 / 1x1 forms, fancy upsampling, the YCbCr tables).
 *
 * Scope: baseline and extended sequential and progressive Huffman JPEGs,
 * 8-bit, one or more scans, grayscale or YCbCr, any sampling factors whose
 * ratios are integral, restart intervals, scale 1/1, 1/2, 1/4 and 1/8.
 * Arithmetic-coded, lossless, 12-bit, RGB (Adobe) and CMYK files are
 * refused through error_exit.
 *
 * The functions are hidden outside the shared library they are linked
 * into, so they never interpose on, or bind to, a system libjpeg loaded
 * in the same process.
 */

#ifndef BDD100K_TPU_TORCH_JPEGLIB_H
#define BDD100K_TPU_TORCH_JPEGLIB_H

#ifdef __cplusplus
extern "C" {
#endif

#define JPEG_API __attribute__((visibility("hidden")))

typedef int boolean;
#ifndef FALSE
#define FALSE 0
#endif
#ifndef TRUE
#define TRUE 1
#endif

typedef unsigned char JSAMPLE;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;
typedef JSAMPARRAY* JSAMPIMAGE;
typedef unsigned int JDIMENSION;

typedef enum {
  JCS_UNKNOWN,
  JCS_GRAYSCALE,
  JCS_RGB,
  JCS_YCbCr,
  JCS_CMYK,
  JCS_YCCK
} J_COLOR_SPACE;

#define JPEG_HEADER_OK 1

typedef struct {
  int h_samp_factor;
  int v_samp_factor;
  int DCT_scaled_size;          /* the IDCT's output size: 1, 2, 4 or 8 */
  JDIMENSION downsampled_width; /* samples after the IDCT's scaling */
  JDIMENSION downsampled_height;
} jpeg_component_info;

struct jpeg_common_struct;
typedef struct jpeg_common_struct* j_common_ptr;
struct jpeg_decompress_struct;
typedef struct jpeg_decompress_struct* j_decompress_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo); /* must not return */
  void (*output_message)(j_common_ptr cinfo);
  char last_message[200];
};

struct jpeg_common_struct {
  struct jpeg_error_mgr* err;
};

struct jpeg_decompress_struct {
  struct jpeg_error_mgr* err; /* first, as in jpeg_common_struct */

  /* from the header */
  JDIMENSION image_width;
  JDIMENSION image_height;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;

  /* decompression parameters, defaults set by jpeg_read_header */
  J_COLOR_SPACE out_color_space;
  unsigned int scale_num;
  unsigned int scale_denom;
  boolean raw_data_out;
  boolean do_fancy_upsampling;

  /* set by jpeg_start_decompress */
  JDIMENSION output_width;
  JDIMENSION output_height;
  int output_components;
  JDIMENSION output_scanline;
  int max_h_samp_factor;
  int max_v_samp_factor;
  int min_DCT_scaled_size;
  jpeg_component_info* comp_info;

  void* internal; /* the decoder's state, owned by this struct */
};

JPEG_API struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err);
JPEG_API void jpeg_create_decompress(j_decompress_ptr cinfo);
JPEG_API void jpeg_destroy_decompress(j_decompress_ptr cinfo);
JPEG_API void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* buffer,
                           unsigned long size);
JPEG_API int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
JPEG_API boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JPEG_API JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo,
                                        JSAMPARRAY scanlines,
                                        JDIMENSION max_lines);
JPEG_API JDIMENSION jpeg_read_raw_data(j_decompress_ptr cinfo, JSAMPIMAGE data,
                                       JDIMENSION max_lines);
JPEG_API boolean jpeg_finish_decompress(j_decompress_ptr cinfo);

#ifdef __cplusplus
}
#endif

#endif /* BDD100K_TPU_TORCH_JPEGLIB_H */
