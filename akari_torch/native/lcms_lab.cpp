// 8-bit Lab -> 8-bit RGB through a 16-bit CLUT, for akari_torch/core/lcms.py.
//
// PIL converts LAB images to RGB with LittleCMS 2.17, whose optimised
// 8-bit transform resamples the pipeline into a 33^3 16-bit CLUT and then
// evaluates each pixel as cmsxform.c / cmsintrp.c do:
//
// - each input byte v becomes the 16-bit value v * 257 (FROM_8_TO_16);
// - TetrahedralInterp16 on the CLUT: fx = _cmsToFixedDomain(v16 * 32),
//   the node x0 = fx >> 16 and the rest rx = fx & 0xFFFF per axis; the
//   step to the next node is 0 on an axis whose input is 0xFFFF; the
//   tetrahedron is picked by the order of rx, ry, rz (ties as the C code
//   breaks them), and each output is
//   c0 + ((Rest + (Rest >> 16)) >> 16), Rest = c1 rx + c2 ry + c3 rz + 0x8001;
// - each 16-bit output becomes a byte by FROM_16_TO_8,
//   (v * 65281 + 8388608) >> 24.
//
// C ABI (ctypes):
//   void akr_lab8_to_rgb8(const uint16_t* clut, const uint8_t* lab,
//                         int64_t n, uint8_t* rgb);
// ``clut`` is the [33, 33, 33, 3] table (L slowest), ``lab`` and ``rgb``
// hold n pixels of 3 bytes.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>

namespace {

constexpr int kGrid = 33;
constexpr int kStrideL = kGrid * kGrid * 3;
constexpr int kStrideA = kGrid * 3;
constexpr int kStrideB = 3;

struct Axis {
    int32_t base;  // offset of the node below, in table entries
    int32_t step;  // offset to the node above (0 at 0xFFFF)
    int32_t rest;  // 16-bit fraction
};

Axis axis(int v8, int stride) {
    const int32_t v16 = v8 * 257;
    const int32_t a = v16 * (kGrid - 1);
    const int32_t fx = a + ((a + 0x7FFF) / 0xFFFF);  // _cmsToFixedDomain
    return {(fx >> 16) * stride, v16 == 0xFFFF ? 0 : stride, fx & 0xFFFF};
}

inline uint8_t to8(int32_t v16) {
    return static_cast<uint8_t>(((static_cast<uint32_t>(v16) * 65281u + 8388608u) >> 24) & 0xFFu);
}

}  // namespace

extern "C" void akr_lab8_to_rgb8(const uint16_t* clut, const uint8_t* lab, int64_t n,
                                 uint8_t* rgb) {
    Axis ax[3][256];
    for (int v = 0; v < 256; ++v) {
        ax[0][v] = axis(v, kStrideL);
        ax[1][v] = axis(v, kStrideA);
        ax[2][v] = axis(v, kStrideB);
    }
    for (int64_t i = 0; i < n; ++i) {
        const Axis& x = ax[0][lab[3 * i]];
        const Axis& y = ax[1][lab[3 * i + 1]];
        const Axis& z = ax[2][lab[3 * i + 2]];
        const uint16_t* t = clut + x.base + y.base + z.base;
        const int32_t rx = x.rest, ry = y.rest, rz = z.rest;
        int32_t X1 = x.step, Y1 = y.step, Z1 = z.step;
        int kind;
        if (rx >= ry) {
            if (ry >= rz) {
                Y1 += X1; Z1 += Y1; kind = 0;
            } else if (rz >= rx) {
                X1 += Z1; Y1 += X1; kind = 1;
            } else {
                Z1 += X1; Y1 += Z1; kind = 2;
            }
        } else {
            if (rx >= rz) {
                X1 += Y1; Z1 += X1; kind = 3;
            } else if (ry >= rz) {
                Z1 += Y1; X1 += Z1; kind = 4;
            } else {
                Y1 += Z1; X1 += Y1; kind = 5;
            }
        }
        for (int k = 0; k < 3; ++k) {
            int64_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k], c3 = t[Z1 + k];
            switch (kind) {
                case 0: c3 -= c2; c2 -= c1; c1 -= c0; break;
                case 1: c2 -= c1; c1 -= c3; c3 -= c0; break;
                case 2: c2 -= c3; c3 -= c1; c1 -= c0; break;
                case 3: c3 -= c1; c1 -= c2; c2 -= c0; break;
                case 4: c1 -= c3; c3 -= c2; c2 -= c0; break;
                default: c1 -= c2; c2 -= c3; c3 -= c0; break;
            }
            const int64_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
            rgb[3 * i + k] = to8(static_cast<int32_t>((c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF));
        }
    }
}
