/* write_codings: writes a JPEG in a coding that cv2 and Pillow do not write
 * (arithmetic coding, lossless, 12-bit samples) through libjpeg-turbo's
 * own compressor, for the port's decoder tests.
 *
 *   write_codings IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS [OPTION=VALUE ...]
 *
 * IN.raw holds the rows of samples: bytes, or 16-bit little-endian words
 * for precisions above 8.  Options:
 *   precision=P      data precision (default 8; 12 writes through
 *                    jpeg12_write_scanlines)
 *   quality=Q        quantisation tables of jpeg_set_quality (default 75)
 *   arith=1          arithmetic coding (SOF9, SOF10 when progressive)
 *   progressive=1    jpeg_simple_progression's scan script
 *   lossless=PSV,PT  lossless (SOF3) with predictor PSV and point transform PT
 *                    (libjpeg-turbo keeps the input's colour space and 1x1
 *                    sampling in lossless mode)
 *   sampling=HV      the first component's sampling factors (e.g. 22, 21, 11)
 *   cmyk=1           read four components as CMYK (stored as CMYK)
 *   restart=N        a restart marker every N MCUs
 *   dac=L,U,K        the arithmetic conditioning of every table (DAC)
 *
 * Build against a libjpeg-turbo 3.x library with the v6.2 ABI (the
 * jpeglib.h of any libjpeg-turbo of that ABI has its struct layout); the
 * lossless and 12-bit entry points are declared here, as older headers
 * lack them.  tests/torch_jpeg/write_codings.py builds and drives it.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

typedef short J12SAMPLE_;
typedef J12SAMPLE_ *J12SAMPROW_;
extern void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                                 int point_transform);
extern JDIMENSION jpeg12_write_scanlines(j_compress_ptr cinfo, J12SAMPROW_ *scanlines,
                                         JDIMENSION num_lines);

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS [OPTION=VALUE ...]\n",
            argv[0]);
    return 2;
  }
  int width = atoi(argv[3]), height = atoi(argv[4]), ncomp = atoi(argv[5]);
  int precision = 8, quality = 75, arith = 0, progressive = 0, psv = 0, pt = 0;
  int sampling = 0, cmyk = 0, restart = 0, dac_l = -1, dac_u = -1, dac_k = -1;
  for (int i = 6; i < argc; ++i) {
    const char *a = argv[i];
    if (!strncmp(a, "precision=", 10)) precision = atoi(a + 10);
    else if (!strncmp(a, "quality=", 8)) quality = atoi(a + 8);
    else if (!strncmp(a, "arith=", 6)) arith = atoi(a + 6);
    else if (!strncmp(a, "progressive=", 12)) progressive = atoi(a + 12);
    else if (!strncmp(a, "lossless=", 9)) sscanf(a + 9, "%d,%d", &psv, &pt);
    else if (!strncmp(a, "sampling=", 9)) sampling = atoi(a + 9);
    else if (!strncmp(a, "cmyk=", 5)) cmyk = atoi(a + 5);
    else if (!strncmp(a, "restart=", 8)) restart = atoi(a + 8);
    else if (!strncmp(a, "dac=", 4)) sscanf(a + 4, "%d,%d,%d", &dac_l, &dac_u, &dac_k);
    else {
      fprintf(stderr, "unknown option %s\n", a);
      return 2;
    }
  }
  size_t word = precision > 8 ? 2 : 1;
  size_t row_samples = (size_t)width * ncomp;
  size_t total = row_samples * height * word;
  unsigned char *raw = malloc(total);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(raw, 1, total, in) != total) {
    fprintf(stderr, "cannot read %zu bytes of samples from %s\n", total, argv[1]);
    return 1;
  }
  fclose(in);
  FILE *out = fopen(argv[2], "wb");
  if (!out) {
    fprintf(stderr, "cannot write %s\n", argv[2]);
    return 1;
  }

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : (cmyk ? JCS_CMYK : JCS_RGB);
  jpeg_set_defaults(&cinfo);
  cinfo.data_precision = precision;
  if (psv) {
    jpeg_enable_lossless(&cinfo, psv, pt);
  } else {
    jpeg_set_quality(&cinfo, quality, TRUE);
    if (progressive) jpeg_simple_progression(&cinfo);
  }
  if (sampling && ncomp > 1) {
    cinfo.comp_info[0].h_samp_factor = sampling / 10;
    cinfo.comp_info[0].v_samp_factor = sampling % 10;
  }
  cinfo.arith_code = arith ? TRUE : FALSE;
  if (arith) cinfo.optimize_coding = FALSE;
  cinfo.restart_interval = restart;
  if (dac_l >= 0) {
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      cinfo.arith_dc_L[t] = (UINT8)dac_l;
      cinfo.arith_dc_U[t] = (UINT8)dac_u;
      cinfo.arith_ac_K[t] = (UINT8)dac_k;
    }
  }
  jpeg_start_compress(&cinfo, TRUE);
  if (precision > 8) {
    J12SAMPLE_ *row = malloc(row_samples * sizeof(J12SAMPLE_));
    while (cinfo.next_scanline < cinfo.image_height) {
      const unsigned char *src = raw + (size_t)cinfo.next_scanline * row_samples * 2;
      for (size_t i = 0; i < row_samples; ++i) row[i] = (J12SAMPLE_)(src[2 * i] | (src[2 * i + 1] << 8));
      J12SAMPROW_ rows[1] = {row};
      jpeg12_write_scanlines(&cinfo, rows, 1);
    }
    free(row);
  } else {
    while (cinfo.next_scanline < cinfo.image_height) {
      JSAMPROW rows[1] = {raw + (size_t)cinfo.next_scanline * row_samples};
      jpeg_write_scanlines(&cinfo, rows, 1);
    }
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(raw);
  return 0;
}
