// Lossy WebP (a VP8 key frame, RFC 6386) decoding to RGB for
// akari_torch/core/webp.py.
//
// The JAX package reads WebP through PIL, which hands the file to libwebp's
// WebPAnimDecoder with its default options. The decoder follows libwebp's
// src/dec (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c), src/dsp
// (dec.c, upsampling.c, yuv.h) and src/utils/bit_reader (BSD licence,
// Copyright 2010 Google Inc.; the constant tables below are libwebp's,
// which are RFC 6386's with the 4x4 modes in libwebp's order), so that it
// gives libwebp's pixels and refuses what libwebp refuses:
//
// - the frame header (key frame, profile 0-3, shown, 14-bit sizes, the
//   scale bits ignored), the segment header (map probabilities; quantiser
//   and filter values absolute unless the delta bit says otherwise, and 0
//   when the segment data are not updated), the filter header (no filtering
//   at all when the frame's level is 0), 1-8 token partitions (the last one
//   must hold a byte), the quantiser (y2 DC doubled, y2 AC x 155 / 100 with
//   a floor of 8, uv DC clipped to index 117) and the coefficient
//   probability updates;
// - the boolean decoder, with libwebp's end-of-data rule: a partition whose
//   bits run out is an error once a bit past its end is needed;
// - intra modes (16x16, 4x4 with key-frame contexts, chroma), the
//   coefficient tokens with their contexts and the skip flag;
// - prediction from unfiltered samples (127 above the frame, 129 left of
//   it, the corner 127 on the top row and 129 below it; DC without top or
//   left; the above-right pixels of the right 4x4 column taken from the
//   macroblock above-right, or repeated at the frame's right edge);
// - the inverse WHT and DCT on int16 coefficients, as libwebp stores them:
//   a block of more than three coefficients through the arithmetic of
//   libwebp's SSE2 routine, which x86-64 builds run (16-bit sums that wrap,
//   so a crafted stream's overflowing coefficients read as there), the
//   others through its C routines;
// - the simple and normal loop filters with libwebp's levels, sharpness,
//   delta terms, thresholds and edge order, inner edges only for 4x4
//   macroblocks and those with coefficients;
// - fancy upsampling of the 4:2:0 chroma (9-3-3-1, with the first and last
//   rows and columns as libwebp does them) and the 14-bit fixed-point
//   YUV -> RGB of src/dsp/yuv.h.
//
// C ABI (ctypes):
//   int akr_vp8_decode(const uint8_t* data, int64_t size, int32_t width,
//                      int32_t height, uint8_t* rgb);
//   data: a VP8 chunk's payload (with its padding byte, as libwebp's
//   demuxer passes it); width x height its frame size; rgb receives
//   height x width x 3 bytes.
// Returns 0, or one of the AKR_VP8_* codes below.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
    AKR_VP8_OK = 0,
    AKR_VP8_BAD_HEADER = 1,     // frame tag, start code, size or a header past its partition
    AKR_VP8_BAD_PARTITIONS = 2, // partition sizes that do not fit the data
    AKR_VP8_SHORT_MODES = 3,    // the first partition ends inside the modes
    AKR_VP8_SHORT_TOKENS = 4,   // a token partition ends inside the coefficients
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// [type 4][band 8][context 3][node 11]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// [above mode][left mode][node 9], modes in libwebp's order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's prediction modes
enum {
    B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
    B_HD_PRED, B_HU_PRED,
    DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
    DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6,
};

constexpr int BPS = 32;  // stride of the reconstruction buffer
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
uint8_t clip8b(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// libwebp's VP8BitReader (56-bit loads on 64-bit hosts).
struct BoolReader {
    uint64_t value = 0;
    uint32_t range = 254;  // range - 1
    int bits = -8;         // valid bits in ``value`` less 8
    const uint8_t* buf = nullptr;
    const uint8_t* buf_end = nullptr;
    const uint8_t* buf_max = nullptr;
    bool eof = false;

    void init(const uint8_t* start, size_t size) {
        range = 254;
        value = 0;
        bits = -8;
        eof = false;
        buf = start;
        buf_end = start + size;
        buf_max = size >= 8 ? start + size - 8 + 1 : start;
        load_new_bytes();
    }
    void load_new_bytes() {
        if (buf < buf_max) {
            uint64_t in = 0;
            for (int k = 0; k < 7; ++k) in = (in << 8) | buf[k];
            buf += 7;
            value = in | (value << 56);
            bits += 56;
        } else if (buf < buf_end) {
            bits += 8;
            value = uint64_t(*buf++) | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get_bit(int prob) {
        uint32_t r = range;
        if (bits < 0) load_new_bytes();
        const int pos = bits;
        const uint32_t split = (r * uint32_t(prob)) >> 8;
        const uint32_t v = uint32_t(value >> pos);
        const int bit = v > split;
        if (bit) {
            r -= split;
            value -= uint64_t(split + 1) << pos;
        } else {
            r = split + 1;
        }
        const int shift = 7 ^ (31 - __builtin_clz(r));
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    int get_value(int n) {
        int v = 0;
        while (n-- > 0) v |= get_bit(0x80) << n;
        return v;
    }
    int get() { return get_value(1); }
    int get_signed_value(int n) {
        const int v = get_value(n);
        return get() ? -v : v;
    }
    // VP8GetSigned: a bit at probability 1/2 by a mask. It equals
    // get_bit(0x80) until corrupt data drives ``value`` 2^31 past the split
    // (a partition that starts with 0xFF never leaves value >= range).
    int get_signed(int v) {
        if (bits < 0) load_new_bytes();
        const int pos = bits;
        const uint32_t split = range >> 1;
        const uint32_t val = uint32_t(value >> pos);
        const int32_t mask = int32_t(split - val) >> 31;  // -1 or 0
        bits -= 1;
        range += uint32_t(mask);
        range |= 1;
        value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
        return (v ^ mask) - mask;
    }
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBContext {
    uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, uvmode, segment, skip;
    uint8_t imodes[16];
    uint32_t non_zero_y, non_zero_uv;
};

int get_large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.get_bit(p[3])) {
        v = !br.get_bit(p[4]) ? 2 : 3 + br.get_bit(p[5]);
    } else if (!br.get_bit(p[6])) {
        if (!br.get_bit(p[7])) {
            v = 5 + br.get_bit(159);
        } else {
            v = 7 + 2 * br.get_bit(165);
            v += br.get_bit(145);
        }
    } else {
        const int bit1 = br.get_bit(p[8]);
        const int bit0 = br.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
        v += 3 + (8 << cat);
    }
    return v;
}

// Returns the position after the last non-zero coefficient (or ``n``).
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get_bit(p[0])) return n;
        while (!br.get_bit(p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
        int v;
        if (!br.get_bit(p[2])) {
            v = 1;
            p = p_ctx[1];
        } else {
            v = get_large_value(br, p);
            p = p_ctx[2];
        }
        out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : uint32_t(dc_nz);
    return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = int16_t((a0 + a1) >> 3);
        out[16] = int16_t((a3 + a2) >> 3);
        out[32] = int16_t((a0 - a1) >> 3);
        out[48] = int16_t((a3 - a2) >> 3);
        out += 64;
    }
}

int mul1(int a) { return ((a * 20091) >> 16) + a; }
int mul2(int a) { return (a * 35468) >> 16; }

// TransformDC_C and TransformAC3_C: int arithmetic on the int16
// coefficients (equal to the full transform on those inputs).
void transform_c(const int16_t* in, uint8_t* dst) {
    int c[16];
    int* tmp = c;
    for (int i = 0; i < 4; ++i) {  // vertical pass
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int cc = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + cc;
        tmp[2] = b - cc;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = c;
    for (int i = 0; i < 4; ++i) {  // horizontal pass
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int cc = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8b(dst[0] + ((a + d) >> 3));
        dst[1] = clip8b(dst[1] + ((b + cc) >> 3));
        dst[2] = clip8b(dst[2] + ((b - cc) >> 3));
        dst[3] = clip8b(dst[3] + ((a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

// Transform_SSE2, which libwebp runs on x86-64 for a block with more than
// three coefficients: every sum wraps at 16 bits, the products are
// _mm_mulhi_epi16 with 20091 and 35468 - 65536, the residual is added at 16
// bits and saturated to 0-255. Equal to transform_c for the coefficients an
// encoder writes; they differ only where a sum leaves int16.
inline int16_t w16(int v) { return int16_t(uint16_t(v)); }
inline int mulhi(int16_t x, int k) { return (int(x) * k) >> 16; }

void transform_sse2(const int16_t* in, uint8_t* dst) {
    int16_t t[4][4];  // t[column][row] after the vertical pass
    for (int i = 0; i < 4; ++i) {
        const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
        const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
        const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
        const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
        t[i][0] = w16(a + d);
        t[i][1] = w16(b + c);
        t[i][2] = w16(b - c);
        t[i][3] = w16(a - d);
    }
    for (int k = 0; k < 4; ++k) {  // row k
        const int16_t dc = w16(t[0][k] + 4);
        const int16_t a = w16(dc + t[2][k]), b = w16(dc - t[2][k]);
        const int16_t c = w16(w16(t[1][k] - t[3][k]) +
                              w16(mulhi(t[1][k], -30068) - mulhi(t[3][k], 20091)));
        const int16_t d = w16(w16(t[1][k] + t[3][k]) +
                              w16(mulhi(t[1][k], 20091) + mulhi(t[3][k], -30068)));
        const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
        uint8_t* row = dst + k * BPS;
        for (int x = 0; x < 4; ++x) row[x] = clip8b(w16(row[x] + (out[x] >> 3)));
    }
}

// DoTransform: the routine libwebp picks from the block's non-zero code.
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    switch (bits >> 30) {
        case 3: transform_sse2(src, dst); break;
        case 2:
        case 1: transform_c(src, dst); break;
        default: break;
    }
}

// --- intra prediction (src/dsp/dec.c) ---

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void fill(uint8_t* dst, int v, int size) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x) dst[x] = clip8b(top[x] + dst[-1] - top[-1]);
        dst += BPS;
    }
}

void pred_luma16(int mode, uint8_t* dst) {
    int dc;
    switch (mode) {
        case DC_PRED:
            dc = 16;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, dc >> 5, 16);
            break;
        case TM_PRED: true_motion(dst, 16); break;
        case V_PRED:
            for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
            break;
        case H_PRED:
            for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
            break;
        case DC_NOTOP:
            dc = 8;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
            fill(dst, dc >> 4, 16);
            break;
        case DC_NOLEFT:
            dc = 8;
            for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
            fill(dst, dc >> 4, 16);
            break;
        default: fill(dst, 0x80, 16); break;
    }
}

void pred_chroma8(int mode, uint8_t* dst) {
    int dc;
    switch (mode) {
        case DC_PRED:
            dc = 8;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, dc >> 4, 8);
            break;
        case TM_PRED: true_motion(dst, 8); break;
        case V_PRED:
            for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
            break;
        case H_PRED:
            for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
            break;
        case DC_NOTOP:
            dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
            fill(dst, dc >> 3, 8);
            break;
        case DC_NOLEFT:
            dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
            fill(dst, dc >> 3, 8);
            break;
        default: fill(dst, 0x80, 8); break;
    }
}

void pred_luma4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    switch (mode) {
        case B_DC_PRED: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, int(dc >> 3), 4);
            break;
        }
        case B_TM_PRED: true_motion(dst, 4); break;
        case B_VE_PRED: {
            const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED:
            std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
            std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
            std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
            std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
            break;
        case B_RD_PRED:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD_PRED:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR_PRED:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL_PRED:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD_PRED:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU_PRED
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
            break;
    }
}
#undef DST

int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
        if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
        return mb_y == 0 ? DC_NOTOP : B_DC_PRED;
    }
    return mode;
}

// --- loop filter (src/dsp/dec.c) ---

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int iabs(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8b(p0 + a2);
    p[0] = clip8b(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8b(p1 + a3);
    p[-step] = clip8b(p0 + a2);
    p[0] = clip8b(q0 - a1);
    p[step] = clip8b(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8b(p2 + a3);
    p[-2 * step] = clip8b(p1 + a2);
    p[-step] = clip8b(p0 + a1);
    p[0] = clip8b(q0 - a1);
    p[step] = clip8b(q1 - a2);
    p[2 * step] = clip8b(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    return iabs(p[-2 * step] - p[-step]) > thresh || iabs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    return 4 * iabs(p[-step] - p[0]) + iabs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
    return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
           iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}

// across the edge before p, along ``size`` pixels
void simple_filter(uint8_t* p, int step, int along, int thresh) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += along)
        if (needs_filter(p, step, thresh2)) do_filter2(p, step);
}

void filter_loop(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
    const int thresh2 = 2 * thresh + 1;
    for (; size-- > 0; p += along) {
        if (!needs_filter2(p, step, thresh2, ithresh)) continue;
        if (hev(p, step, hev_thresh))
            do_filter2(p, step);
        else if (edge)
            do_filter6(p, step);
        else
            do_filter4(p, step);
    }
}

// --- YUV -> RGB (src/dsp/yuv.h) ---

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t clip8(int v) {
    return uint8_t((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

class Decoder {
  public:
    int decode(const uint8_t* data, size_t size, int width, int height, uint8_t* rgb);

  private:
    BoolReader br_;
    std::vector<BoolReader> parts_;
    int mb_w_ = 0, mb_h_ = 0;
    // segment header
    bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
    int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
    uint8_t seg_proba_[3] = {255, 255, 255};
    // filter header
    int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
    int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
    int filter_type_ = 0;
    QuantMatrix dqm_[4];
    uint8_t bands_[4][8][3][11];
    bool use_skip_proba_ = false;
    int skip_p_ = 0;
    FInfo fstrengths_[4][2];
    // per-row state
    std::vector<uint8_t> intra_t_;
    uint8_t intra_l_[4];
    std::vector<MBContext> mb_info_;  // [0] is the left context, [1 + x] the top of column x
    std::vector<MBData> mb_data_;     // one row
    std::vector<FInfo> f_info_;       // whole frame
    // planes (macroblock-aligned), unfiltered until the end
    std::vector<uint8_t> y_, u_, v_;
    int y_stride_ = 0, uv_stride_ = 0;
    uint8_t yuv_b_[YUV_SIZE];
    std::vector<uint8_t> top_y_, top_u_, top_v_;  // unfiltered last rows of the row above

    void parse_segment_header();
    void parse_filter_header();
    int parse_partitions(const uint8_t* buf, size_t size);
    void parse_quant();
    void parse_proba();
    void precompute_filter_strengths();
    void parse_intra_mode(int mb_x);
    bool parse_residuals(int mb_x, MBData* block, BoolReader& token_br);
    void reconstruct(int mb_x, int mb_y, const MBData& block);
    void do_filter(int mb_x, int mb_y);
};

void Decoder::parse_segment_header() {
    use_segment_ = br_.get();
    if (use_segment_) {
        update_map_ = br_.get();
        if (br_.get()) {  // update data
            absolute_delta_ = br_.get();
            for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get() ? br_.get_signed_value(7) : 0;
            for (int s = 0; s < 4; ++s)
                filter_strength_[s] = br_.get() ? br_.get_signed_value(6) : 0;
        }
        if (update_map_)
            for (int s = 0; s < 3; ++s) seg_proba_[s] = uint8_t(br_.get() ? br_.get_value(8) : 255);
    } else {
        update_map_ = false;
    }
}

void Decoder::parse_filter_header() {
    simple_ = br_.get();
    level_ = br_.get_value(6);
    sharpness_ = br_.get_value(3);
    use_lf_delta_ = br_.get();
    if (use_lf_delta_ && br_.get()) {
        for (int i = 0; i < 4; ++i)
            if (br_.get()) ref_lf_delta_[i] = br_.get_signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br_.get()) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
}

int Decoder::parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    const size_t last_part = (size_t(1) << br_.get_value(2)) - 1;
    if (size < 3 * last_part) return AKR_VP8_BAD_PARTITIONS;
    parts_.assign(last_part + 1, BoolReader());
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
        size_t psize = size_t(sz[0]) | (size_t(sz[1]) << 8) | (size_t(sz[2]) << 16);
        if (psize > size_left) psize = size_left;
        parts_[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
    }
    parts_[last_part].init(part_start, size_left);
    return part_start < buf_end ? AKR_VP8_OK : AKR_VP8_BAD_PARTITIONS;
}

void Decoder::parse_quant() {
    const int base_q0 = br_.get_value(7);
    const int dqy1_dc = br_.get() ? br_.get_signed_value(4) : 0;
    const int dqy2_dc = br_.get() ? br_.get_signed_value(4) : 0;
    const int dqy2_ac = br_.get() ? br_.get_signed_value(4) : 0;
    const int dquv_dc = br_.get() ? br_.get_signed_value(4) : 0;
    const int dquv_ac = br_.get() ? br_.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
        int q;
        if (use_segment_) {
            q = quantizer_[i];
            if (!absolute_delta_) q += base_q0;
        } else if (i > 0) {
            dqm_[i] = dqm_[0];
            continue;
        } else {
            q = base_q0;
        }
        QuantMatrix& m = dqm_[i];
        m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clip(q, 127)];
        m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
}

void Decoder::parse_proba() {
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    bands_[t][b][c][p] = uint8_t(br_.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                                     ? br_.get_value(8)
                                                     : kCoeffsProba0[t][b][c][p]);
    use_skip_proba_ = br_.get();
    if (use_skip_proba_) skip_p_ = br_.get_value(8);
}

void Decoder::precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
        int base_level;
        if (use_segment_) {
            base_level = filter_strength_[s];
            if (!absolute_delta_) base_level += level_;
        } else {
            base_level = level_;
        }
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
            FInfo& info = fstrengths_[s][i4x4];
            int level = base_level;
            if (use_lf_delta_) {
                level += ref_lf_delta_[0];
                if (i4x4) level += mode_lf_delta_[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (sharpness_ > 0) {
                    ilevel >>= sharpness_ > 4 ? 2 : 1;
                    if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                }
                if (ilevel < 1) ilevel = 1;
                info.ilevel = ilevel;
                info.limit = 2 * level + ilevel;
                info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info.limit = 0;
            }
            info.inner = i4x4;
        }
    }
}

void Decoder::parse_intra_mode(int mb_x) {
    uint8_t* const top = &intra_t_[4 * size_t(mb_x)];
    uint8_t* const left = intra_l_;
    MBData& block = mb_data_[size_t(mb_x)];
    if (update_map_) {
        block.segment = uint8_t(!br_.get_bit(seg_proba_[0]) ? br_.get_bit(seg_proba_[1])
                                                            : br_.get_bit(seg_proba_[2]) + 2);
    } else {
        block.segment = 0;
    }
    block.skip = use_skip_proba_ ? uint8_t(br_.get_bit(skip_p_)) : 0;
    block.is_i4x4 = !br_.get_bit(145);
    if (!block.is_i4x4) {
        const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                                           : (br_.get_bit(163) ? V_PRED : DC_PRED);
        block.imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
    } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba[top[x]][ymode];
                ymode = !br_.get_bit(prob[0])   ? B_DC_PRED
                        : !br_.get_bit(prob[1]) ? B_TM_PRED
                        : !br_.get_bit(prob[2]) ? B_VE_PRED
                        : !br_.get_bit(prob[3])
                            ? (!br_.get_bit(prob[4])   ? B_HE_PRED
                               : !br_.get_bit(prob[5]) ? B_RD_PRED
                                                       : B_VR_PRED)
                            : (!br_.get_bit(prob[6])   ? B_LD_PRED
                               : !br_.get_bit(prob[7]) ? B_VL_PRED
                               : !br_.get_bit(prob[8]) ? B_HD_PRED
                                                       : B_HU_PRED);
                top[x] = uint8_t(ymode);
            }
            std::memcpy(modes, top, 4);
            modes += 4;
            left[y] = uint8_t(ymode);
        }
    }
    block.uvmode = uint8_t(!br_.get_bit(142)   ? DC_PRED
                           : !br_.get_bit(114) ? V_PRED
                           : br_.get_bit(183)  ? TM_PRED
                                               : H_PRED);
}

// ParseResiduals; returns true when the macroblock has no non-zero coefficient.
bool Decoder::parse_residuals(int mb_x, MBData* block, BoolReader& token_br) {
    MBContext* const mb = &mb_info_[1 + size_t(mb_x)];
    MBContext* const left_mb = &mb_info_[0];
    const QuantMatrix& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first;
    const uint8_t (*ac_proba)[3][11];
    std::memset(dst, 0, 384 * sizeof(*dst));
    if (!block->is_i4x4) {  // the Y2 block
        int16_t dc[16] = {0};
        const int ctx = mb->nz_dc + left_mb->nz_dc;
        const int nz = get_coeffs(token_br, bands_[1], ctx, q.y2, 0, dc);
        mb->nz_dc = left_mb->nz_dc = uint8_t(nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
        }
        first = 1;
        ac_proba = bands_[0];
    } else {
        first = 0;
        ac_proba = bands_[3];
    }
    uint8_t tnz = mb->nz & 0x0f;
    uint8_t lnz = left_mb->nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(token_br, ac_proba, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = uint8_t((lnz >> 1) | (l << 7));
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t nz_coeffs = 0;
        tnz = uint8_t(mb->nz >> (4 + ch));
        lnz = uint8_t(left_mb->nz >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(token_br, bands_[2], ctx, q.uv, 0, dst);
                l = nz > 0;
                tnz = uint8_t((tnz >> 1) | (l << 3));
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
        }
        non_zero_uv |= nz_coeffs << (4 * ch);
        out_t_nz |= uint32_t(tnz << 4) << ch;
        out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb->nz = uint8_t(out_t_nz);
    left_mb->nz = uint8_t(out_l_nz);
    block->non_zero_y = non_zero_y;
    block->non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

// ReconstructRow for one macroblock: predict from the unfiltered samples in
// yuv_b_ and the saved top rows, add the residuals, store into the planes.
void Decoder::reconstruct(int mb_x, int mb_y, const MBData& block) {
    uint8_t* const y_dst = yuv_b_ + Y_OFF;
    uint8_t* const u_dst = yuv_b_ + U_OFF;
    uint8_t* const v_dst = yuv_b_ + V_OFF;
    if (mb_x == 0) {
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
    } else {  // rotate in the left samples of the macroblock before
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
            std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
    }
    const uint8_t* top_y = &top_y_[16 * size_t(mb_x)];
    if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, &top_u_[8 * size_t(mb_x)], 8);
        std::memcpy(v_dst - BPS, &top_v_[8 * size_t(mb_x)], 8);
    }
    uint32_t bits = block.non_zero_y;
    const int16_t* coeffs = block.coeffs;
    if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
            if (mb_x >= mb_w_ - 1)
                std::memset(top_right, top_y[15], 4);
            else
                std::memcpy(top_right, top_y + 16, 4);
        }
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred_luma4(block.imodes[n], dst);
            do_transform(bits, coeffs + n * 16, dst);
        }
    } else {
        pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        for (int n = 0; bits != 0 && n < 16; ++n, bits <<= 2)
            do_transform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
    pred_chroma8(uv_mode, u_dst);
    pred_chroma8(uv_mode, v_dst);
    for (int ch = 0; ch < 2; ++ch) {  // DoUVTransform
        const uint32_t bits_uv = (block.non_zero_uv >> (8 * ch)) & 0xff;
        if (!bits_uv) continue;
        uint8_t* const dst = ch ? v_dst : u_dst;
        const int16_t* src = coeffs + (16 + 4 * ch) * 16;
        uint8_t* const dsts[4] = {dst, dst + 4, dst + 4 * BPS, dst + 4 * BPS + 4};
        for (int k = 0; k < 4; ++k) {
            if (bits_uv & 0xaa)  // TransformUV: all four through the SSE2 routine
                transform_sse2(src + 16 * k, dsts[k]);
            else if (src[16 * k])  // TransformDCUV
                transform_c(src + 16 * k, dsts[k]);
        }
    }
    if (mb_y < mb_h_ - 1) {  // stash the unfiltered bottom rows for the row below
        std::memcpy(&top_y_[16 * size_t(mb_x)], y_dst + 15 * BPS, 16);
        std::memcpy(&top_u_[8 * size_t(mb_x)], u_dst + 7 * BPS, 8);
        std::memcpy(&top_v_[8 * size_t(mb_x)], v_dst + 7 * BPS, 8);
    }
    uint8_t* const y_out = &y_[size_t(mb_y) * 16 * y_stride_ + size_t(mb_x) * 16];
    uint8_t* const u_out = &u_[size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8];
    uint8_t* const v_out = &v_[size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8];
    for (int j = 0; j < 16; ++j) std::memcpy(y_out + size_t(j) * y_stride_, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
        std::memcpy(u_out + size_t(j) * uv_stride_, u_dst + j * BPS, 8);
        std::memcpy(v_out + size_t(j) * uv_stride_, v_dst + j * BPS, 8);
    }
}

// DoFilter: left edge, inner vertical edges, top edge, inner horizontal edges.
void Decoder::do_filter(int mb_x, int mb_y) {
    const FInfo& f = f_info_[size_t(mb_y) * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = y_stride_, uvs = uv_stride_;
    uint8_t* const y_dst = &y_[size_t(mb_y) * 16 * ys + size_t(mb_x) * 16];
    if (filter_type_ == 1) {  // simple
        if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
        if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
        if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
        return;
    }
    uint8_t* const u_dst = &u_[size_t(mb_y) * 8 * uvs + size_t(mb_x) * 8];
    uint8_t* const v_dst = &v_[size_t(mb_y) * 8 * uvs + size_t(mb_x) * 8];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
        filter_loop(y_dst, 1, ys, 16, limit + 4, il, hev_t, true);
        filter_loop(u_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
        filter_loop(v_dst, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
        for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, hev_t, false);
        filter_loop(u_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
        filter_loop(v_dst + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
        filter_loop(y_dst, ys, 1, 16, limit + 4, il, hev_t, true);
        filter_loop(u_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
        filter_loop(v_dst, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
        for (int k = 1; k <= 3; ++k)
            filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
        filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
        filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
}

int Decoder::decode(const uint8_t* data, size_t size, int width, int height, uint8_t* rgb) {
    // VP8GetHeaders
    if (size < 4) return AKR_VP8_BAD_HEADER;
    const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(tag & 1);
    const uint32_t partition_length = tag >> 5;
    if (((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) || !key_frame) return AKR_VP8_BAD_HEADER;
    const uint8_t* buf = data + 3;
    size_t buf_size = size - 3;
    if (buf_size < 7 || buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
        return AKR_VP8_BAD_HEADER;
    const int w = ((buf[4] << 8) | buf[3]) & 0x3fff;
    const int h = ((buf[6] << 8) | buf[5]) & 0x3fff;
    if (w != width || h != height || w == 0 || h == 0) return AKR_VP8_BAD_HEADER;
    buf += 7;
    buf_size -= 7;
    mb_w_ = (w + 15) >> 4;
    mb_h_ = (h + 15) >> 4;
    if (partition_length > buf_size) return AKR_VP8_BAD_HEADER;
    br_.init(buf, partition_length);
    buf += partition_length;
    buf_size -= partition_length;
    br_.get();  // colour space
    br_.get();  // clamping type (libwebp always clamps)
    parse_segment_header();
    if (br_.eof) return AKR_VP8_BAD_HEADER;
    parse_filter_header();
    if (br_.eof) return AKR_VP8_BAD_HEADER;
    if (const int rc = parse_partitions(buf, buf_size)) return rc;
    parse_quant();
    br_.get();  // refresh_entropy_probs: ignored
    parse_proba();
    precompute_filter_strengths();

    // frame state
    intra_t_.assign(4 * size_t(mb_w_), B_DC_PRED);
    mb_info_.assign(size_t(mb_w_) + 1, MBContext());
    mb_data_.resize(size_t(mb_w_));
    f_info_.assign(size_t(mb_w_) * mb_h_, FInfo());
    y_stride_ = 16 * mb_w_;
    uv_stride_ = 8 * mb_w_;
    y_.assign(size_t(y_stride_) * 16 * mb_h_, 0);
    u_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
    v_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
    top_y_.assign(16 * size_t(mb_w_), 0);
    top_u_.assign(8 * size_t(mb_w_), 0);
    top_v_.assign(8 * size_t(mb_w_), 0);
    std::memset(yuv_b_, 0, sizeof(yuv_b_));
    std::memset(intra_l_, B_DC_PRED, 4);

    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        BoolReader& token_br = parts_[size_t(mb_y) & (parts_.size() - 1)];
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x);
        if (br_.eof) return AKR_VP8_SHORT_MODES;
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
            MBData& block = mb_data_[size_t(mb_x)];
            bool skip = use_skip_proba_ ? block.skip : false;
            if (!skip) {
                skip = parse_residuals(mb_x, &block, token_br);
            } else {
                mb_info_[0].nz = mb_info_[1 + size_t(mb_x)].nz = 0;
                if (!block.is_i4x4) mb_info_[0].nz_dc = mb_info_[1 + size_t(mb_x)].nz_dc = 0;
                block.non_zero_y = block.non_zero_uv = 0;
            }
            if (filter_type_ > 0) {
                FInfo& fi = f_info_[size_t(mb_y) * mb_w_ + mb_x];
                fi = fstrengths_[block.segment][block.is_i4x4];
                fi.inner |= !skip;
            }
            if (token_br.eof) return AKR_VP8_SHORT_TOKENS;
            reconstruct(mb_x, mb_y, block);
        }
        mb_info_[0] = MBContext();  // VP8InitScanline
        std::memset(intra_l_, B_DC_PRED, 4);
    }
    if (filter_type_ > 0)
        for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w_; ++mb_x) do_filter(mb_x, mb_y);

    // EmitFancyRGB: chroma row ``near`` weighted 3 to 1 against ``far``.
    const int uv_rows = (h + 1) / 2;
    for (int y = 0; y < h; ++y) {
        const int near = y >> 1;
        int far = y == 0 ? 0 : (y & 1) ? near + 1 : near - 1;
        if (far >= uv_rows) far = near;
        const uint8_t* yr = &y_[size_t(y) * y_stride_];
        const uint8_t* nu = &u_[size_t(near) * uv_stride_];
        const uint8_t* nv = &v_[size_t(near) * uv_stride_];
        const uint8_t* fu = &u_[size_t(far) * uv_stride_];
        const uint8_t* fv = &v_[size_t(far) * uv_stride_];
        uint8_t* out = rgb + size_t(y) * w * 3;
        yuv_to_rgb(yr[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2, out);
        const int last_pair = (w - 1) >> 1;
        for (int x = 1; x <= last_pair; ++x) {
            const int du12 = (nu[x - 1] + 3 * nu[x] + 3 * fu[x - 1] + fu[x] + 8) >> 3;
            const int du03 = (3 * nu[x - 1] + nu[x] + fu[x - 1] + 3 * fu[x] + 8) >> 3;
            const int dv12 = (nv[x - 1] + 3 * nv[x] + 3 * fv[x - 1] + fv[x] + 8) >> 3;
            const int dv03 = (3 * nv[x - 1] + nv[x] + fv[x - 1] + 3 * fv[x] + 8) >> 3;
            yuv_to_rgb(yr[2 * x - 1], (du12 + nu[x - 1]) >> 1, (dv12 + nv[x - 1]) >> 1,
                       out + 3 * (2 * x - 1));
            yuv_to_rgb(yr[2 * x], (du03 + nu[x]) >> 1, (dv03 + nv[x]) >> 1, out + 3 * (2 * x));
        }
        if (!(w & 1)) {
            const int l = last_pair;
            yuv_to_rgb(yr[w - 1], (3 * nu[l] + fu[l] + 2) >> 2, (3 * nv[l] + fv[l] + 2) >> 2,
                       out + 3 * (w - 1));
        }
    }
    return AKR_VP8_OK;
}

}  // namespace

extern "C" int akr_vp8_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                              uint8_t* rgb) {
    if (size < 0) return AKR_VP8_BAD_HEADER;
    Decoder dec;
    return dec.decode(data, size_t(size), width, height, rgb);
}
