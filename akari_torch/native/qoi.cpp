// QOI decoding for akari_torch/core/qoi.py.
//
// The JAX package reads textures through PIL, whose QoiImagePlugin decodes
// the op stream in Python (QoiDecoder); this follows it op for op:
//
// - the previous pixel starts as (0, 0, 0, 255) and the 64-entry index
//   table empty, an empty slot reading (0, 0, 0, 0);
// - QOI_OP_RGB (0xFE) keeps the previous alpha, QOI_OP_RGBA (0xFF) reads
//   four bytes, QOI_OP_INDEX, QOI_OP_DIFF and QOI_OP_LUMA as the
//   specification has them; every one of these pixels becomes the
//   previous pixel and enters the index at (r * 3 + g * 5 + b * 7 +
//   a * 11) % 64;
// - QOI_OP_RUN repeats the previous pixel without touching the index; a
//   run past the last pixel is cut;
// - decoding stops once every pixel is written: the end marker and any
//   bytes after it are never read. The data ending before that is an
//   error (PIL's IndexError or ValueError on a short read).
//
// The channels byte does not change the pixels: PIL reads RGB or RGBA,
// and ``convert("RGB")`` drops the alpha either way.
//
// C ABI (ctypes):
//   int akr_qoi_decode(const uint8_t* data, int64_t size, int64_t pos,
//                      int64_t n_pixels, uint8_t* rgb);
// Returns 0 when the n_pixels RGB pixels are written, 1 when the data ends
// first.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>

extern "C" int akr_qoi_decode(const uint8_t* data, int64_t size, int64_t pos,
                              int64_t n_pixels, uint8_t* rgb) {
    uint8_t index[64][4];
    std::memset(index, 0, sizeof(index));
    uint8_t px[4] = {0, 0, 0, 255};
    int64_t i = 0;
    while (i < n_pixels) {
        if (pos >= size) return 1;
        const uint8_t b = data[pos++];
        if (b == 0xFE) {
            if (size - pos < 3) return 1;
            px[0] = data[pos];
            px[1] = data[pos + 1];
            px[2] = data[pos + 2];
            pos += 3;
        } else if (b == 0xFF) {
            if (size - pos < 4) return 1;
            std::memcpy(px, data + pos, 4);
            pos += 4;
        } else {
            const int op = b >> 6;
            if (op == 0) {
                std::memcpy(px, index[b & 63], 4);
            } else if (op == 1) {
                px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
                px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
                px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
            } else if (op == 2) {
                if (pos >= size) return 1;
                const uint8_t b2 = data[pos++];
                const int dg = (b & 63) - 32;
                px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 15) - 8);
                px[1] = static_cast<uint8_t>(px[1] + dg);
                px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
            } else {
                int64_t run = (b & 63) + 1;
                if (run > n_pixels - i) run = n_pixels - i;
                for (int64_t k = 0; k < run; ++k, ++i) std::memcpy(rgb + 3 * i, px, 3);
                continue;
            }
        }
        std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
        std::memcpy(rgb + 3 * i, px, 3);
        ++i;
    }
    return 0;
}
