/* Host-side PNG scanline unfiltering for the port's decoder
 * (gan_aug_pfa_torch/data/native_loader.py).
 *
 * The counterpart of the JAX package's native PNG decoder.  Python parses
 * the chunks and inflates the image data with the standard library's
 * zlib (which releases the GIL around inflate); this file undoes the
 * per-scanline filters, the part that is one byte at a time in numpy for
 * the Average and Paeth filters.  Called through ctypes.CDLL, which
 * releases the GIL, so a thread pool decodes files in parallel.
 *
 * One call unfilters one image (or one Adam7 pass): `height` scanlines of
 * `stride` bytes each, every one preceded by its filter-type byte in
 * `raw` (height * (stride + 1) bytes), into `out` (height * stride bytes).
 * `bpp` is the filter's byte distance, max(1, bytes per pixel): 1 to 8.
 * All five filter types of the PNG specification are handled, at every
 * bit depth, since filters work on bytes.
 *
 * Build: cc -O3 -std=c11 -shared -fPIC -o libpng_decode.so png_decode.c
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Error codes; keep in sync with native_loader.py. */
enum {
  PNG_DECODE_OK = 0,
  PNG_DECODE_ERR_ARGS = -1,   /* a null pointer, a negative size, bpp */
  PNG_DECODE_ERR_FILTER = -2, /* a filter-type byte above 4 */
};

static inline uint8_t paeth(int a, int b, int c) {
  int pa = b - c, pb = a - c, pc = a + b - 2 * c;
  pa = pa < 0 ? -pa : pa;
  pb = pb < 0 ? -pb : pb;
  pc = pc < 0 ? -pc : pc;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

/* One scanline: `src` the filtered bytes, `prev` the unfiltered line above
 * (NULL for the first line, which the specification pads with zeros). */
static int unfilter_row(int ftype, const uint8_t *src, const uint8_t *prev,
                        uint8_t *row, size_t stride, size_t bpp) {
  size_t head = bpp < stride ? bpp : stride;
  size_t x;
  switch (ftype) {
    case 0: /* None */
      memcpy(row, src, stride);
      return PNG_DECODE_OK;
    case 1: /* Sub */
      memcpy(row, src, head);
      for (x = bpp; x < stride; ++x) row[x] = (uint8_t)(src[x] + row[x - bpp]);
      return PNG_DECODE_OK;
    case 2: /* Up */
      if (!prev) {
        memcpy(row, src, stride);
      } else {
        for (x = 0; x < stride; ++x) row[x] = (uint8_t)(src[x] + prev[x]);
      }
      return PNG_DECODE_OK;
    case 3: /* Average */
      if (!prev) {
        memcpy(row, src, head);
        for (x = bpp; x < stride; ++x)
          row[x] = (uint8_t)(src[x] + (row[x - bpp] >> 1));
      } else {
        for (x = 0; x < head; ++x) row[x] = (uint8_t)(src[x] + (prev[x] >> 1));
        for (x = bpp; x < stride; ++x)
          row[x] = (uint8_t)(src[x] + ((row[x - bpp] + prev[x]) >> 1));
      }
      return PNG_DECODE_OK;
    case 4: /* Paeth; above the first line b = c = 0, so it is Sub */
      if (!prev) {
        memcpy(row, src, head);
        for (x = bpp; x < stride; ++x) row[x] = (uint8_t)(src[x] + row[x - bpp]);
      } else {
        for (x = 0; x < head; ++x) row[x] = (uint8_t)(src[x] + prev[x]);
        for (x = bpp; x < stride; ++x)
          row[x] = (uint8_t)(src[x] + paeth(row[x - bpp], prev[x],
                                            prev[x - bpp]));
      }
      return PNG_DECODE_OK;
    default:
      return PNG_DECODE_ERR_FILTER;
  }
}

int png_unfilter(const uint8_t *raw, uint8_t *out, int height, int stride,
                 int bpp) {
  if (!raw || !out || height < 0 || stride < 0 || bpp < 1 || bpp > 8)
    return PNG_DECODE_ERR_ARGS;
  const size_t n = (size_t)stride;
  const uint8_t *prev = NULL;
  for (int y = 0; y < height; ++y) {
    const uint8_t *line = raw + (size_t)y * (n + 1);
    uint8_t *row = out + (size_t)y * n;
    int rc = unfilter_row(line[0], line + 1, prev, row, n, (size_t)bpp);
    if (rc != PNG_DECODE_OK) return rc;
    prev = row;
  }
  return PNG_DECODE_OK;
}

/* Library version and ABI marker for the ctypes side. */
int png_decode_abi_version(void) { return 1; }
