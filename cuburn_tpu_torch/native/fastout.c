/* fastout: the output path's per-pixel loops in C, for the port's
 * frame writers (cuburn_tpu_torch/output.py).
 *
 * The device renders frames; the host thread that encodes frame N-1 is
 * the one that launches frame N, so the per-frame conversion loops are
 * kept out of Python and numpy here.  A plain C interface (no Python
 * headers), loaded with ctypes (native/__init__.py); deflate and the
 * PNG chunks stay in Python's zlib:
 *
 *   paeth_rows(rgba, width, height, out)
 *       RGBA8 rows -> PNG scanlines, each a filter-type byte (4, Paeth)
 *       and the Paeth-filtered row: (1 + 4 * width) * height bytes
 *   rgb_to_ycbcr444(px, npix, channels, out)
 *       pixels of `channels` (3 or 4) bytes, rgb first -> planar 4:4:4
 *       YCbCr (BT.601 full range, x1024 fixed point), 3 * npix bytes
 *
 * Both give the bytes of the JAX package's cuburn_tpu/native/fastout.c
 * on the same frames.
 */

#include <stdint.h>
#include <stdlib.h>

static int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

void paeth_rows(const uint8_t *rgba, int64_t width, int64_t height,
                uint8_t *out) {
    const int64_t stride = width * 4;
    for (int64_t y = 0; y < height; y++) {
        const uint8_t *row = rgba + y * stride;
        const uint8_t *prev = (y > 0) ? row - stride : NULL;
        uint8_t *o = out + y * (stride + 1);
        o[0] = 4; /* Paeth */
        for (int64_t x = 0; x < stride; x++) {
            int a = (x >= 4) ? row[x - 4] : 0;
            int b = prev ? prev[x] : 0;
            int c = (prev && x >= 4) ? prev[x - 4] : 0;
            o[1 + x] = (uint8_t)(row[x] - paeth(a, b, c));
        }
    }
}

static uint8_t clamp_u8(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void rgb_to_ycbcr444(const uint8_t *px, int64_t npix, int64_t channels,
                     uint8_t *out) {
    uint8_t *yp = out, *cb = out + npix, *cr = out + 2 * npix;
    for (int64_t i = 0; i < npix; i++) {
        const uint8_t *p = px + i * channels;
        int r = p[0], g = p[1], b = p[2];
        /* BT.601 full range, fixed point (x1024) */
        int y = (306 * r + 601 * g + 117 * b + 512) >> 10;
        int pb = ((-173 * r - 339 * g + 512 * b + 512) >> 10) + 128;
        int pr = ((512 * r - 429 * g - 83 * b + 512) >> 10) + 128;
        yp[i] = clamp_u8(y);
        cb[i] = clamp_u8(pb);
        cr[i] = clamp_u8(pr);
    }
}
