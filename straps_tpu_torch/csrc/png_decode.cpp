// png_decode: the row unfiltering of PNG image data (the one sequential
// step of PNG decoding), for straps_tpu_torch/utils/png.py, which inflates
// the data and unpacks, deinterlaces and converts the rows with numpy.
//
// The inflated data holds one or more passes (one, or Adam7's seven, of
// which the empty ones are absent), each a run of rows that start with a
// filter-type byte: 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth (PNG 1.2,
// section 9).  Every pass's first row is unfiltered against a row of
// zeros, and `bpp` (bytes per complete pixel, at least 1) is the distance
// to the byte on the left.
//
// Plain C interface for ctypes.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Unfilters `npasses` passes of `rows[p]` rows of `rowbytes[p]` bytes from
// `raw` (each row preceded by its filter byte) into `out` (the same rows
// without their filter bytes, back to back).  `raw` must hold every row.
// Returns 0, or the 1-based index of the first row whose filter type is
// not 0-4 (counted over all passes).
int64_t sp_png_unfilter(const uint8_t* raw, const int32_t* rows, const int64_t* rowbytes,
                        int32_t npasses, int32_t bpp, uint8_t* out) {
  int64_t row_index = 0;
  for (int32_t p = 0; p < npasses; ++p) {
    const int64_t n = rowbytes[p];
    const uint8_t* prev = nullptr;  // the pass's previous output row
    for (int32_t r = 0; r < rows[p]; ++r, ++row_index) {
      const int ft = *raw++;
      const uint8_t* in = raw;
      uint8_t* cur = out;
      switch (ft) {
        case 0:
          for (int64_t i = 0; i < n; ++i) cur[i] = in[i];
          break;
        case 1:
          for (int64_t i = 0; i < n; ++i)
            cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
          break;
        case 2:
          for (int64_t i = 0; i < n; ++i)
            cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
          break;
        case 3:
          for (int64_t i = 0; i < n; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int b = prev ? prev[i] : 0;
            cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
          }
          break;
        case 4:
          for (int64_t i = 0; i < n; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int b = prev ? prev[i] : 0;
            int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
            int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
            int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            cur[i] = static_cast<uint8_t>(in[i] + pred);
          }
          break;
        default:
          return row_index + 1;
      }
      prev = cur;
      raw += n;
      out += n;
    }
  }
  return 0;
}

}  // extern "C"
