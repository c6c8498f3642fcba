// Undo the row filters of PNG scanlines (PNG specification, section 9).
//
// Called from one2345_tpu_torch/utils/png.py through ctypes; built with
// g++ -O3 -shared -fPIC by one2345_tpu_torch/native/build.py.  Average and
// Paeth depend on the byte bpp to the left in the row being decoded, so a
// row is a sequential scan; this loop runs it at memory speed.

#include <cstdint>
#include <cstdlib>
#include <cstring>

// raw: h rows of (1 filter byte + stride bytes); out: h rows of stride bytes.
// bpp: bytes per complete pixel, at least 1.  The caller guarantees that raw
// holds h * (stride + 1) bytes and out h * stride.  Returns 0, or y + 1 for
// the first row y whose filter type is not 0-4 (out is then partial).
extern "C" int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                                uint8_t* out) {
    const uint8_t* prev = nullptr;  // the row above; none (all zero) for row 0
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t kind = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        switch (kind) {
            case 0:  // None
                std::memcpy(cur, line, stride);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < stride; ++x)
                    cur[x] = line[x] + (x >= bpp ? cur[x - bpp] : 0);
                break;
            case 2:  // Up
                for (int64_t x = 0; x < stride; ++x)
                    cur[x] = line[x] + (prev ? prev[x] : 0);
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    cur[x] = line[x] + ((a + b) >> 1);
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? cur[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    cur[x] = line[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
                }
                break;
            default:
                return y + 1;
        }
        prev = cur;
    }
    return 0;
}
