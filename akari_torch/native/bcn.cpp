// BCn (S3TC / DXTn, RGTC, BPTC) block decoding, as Pillow's "bcn" decoder
// gives it (the DDS and FTEX plugins of PIL 12.1.0 read through it).
//
// Each entry point decodes the top level of a width x height image from
// its 4x4 blocks, left to right and top to bottom, (width + 3) / 4 blocks
// a row; the pixels of the edge blocks that fall outside the image are
// dropped. The output is the mode PIL gives the image:
//
//   akr_bc1 / akr_bc2 / akr_bc3 / akr_bc7 -> RGBA, 4 bytes a pixel
//   akr_bc4                              -> L, 1 byte a pixel
//   akr_bc5 / akr_bc6h                   -> RGB, 3 bytes a pixel
//
// A payload of fewer bytes than the blocks the size needs returns -1 (PIL:
// "image file is truncated"); bytes past the last needed block are never
// read. Returns 0 on success.
//
// Pillow's decoder, found by probing it on drawn blocks:
// - BC1 colour endpoints expand 5/6 bits by replicating their high bits;
//   c0 <= c1 selects the 3-colour mode, whose index 3 is transparent black.
//   BC2 and BC3 colour blocks are always in 4-colour mode. The thirds are
//   (2 * a + b) / 3 in integers, the half (a + b) / 2.
// - BC3 alpha, BC4 and BC5 channels: 8 levels when e0 > e1, else 6 and the
//   constants 0 and 255; interpolants (k * e0 + (7 - k) * e1) / 7 or over
//   5. BC5 signed reads its endpoints as int8 and adds 128 before the same
//   arithmetic, and fills blue with 128 (unsigned: 0).
// - BC6H: the D3D11 format's 14 modes and their endpoint layouts; the
//   reserved modes are black. Where it parts from the specification: the
//   endpoints are 16-bit words, and a transformed endpoint is the base plus
//   the sign-extended delta masked to the base's width and not sign-extended
//   again, so a signed one reads negative only at 16 bits; the interpolation
//   (a * (64 - w) + b * w) >> 6 has no rounding term. The result is scaled
//   by 31/64 (unsigned) or by 31/32 on its magnitude (signed) to a half,
//   whose value is clamped to [0, 1], multiplied by 255 and truncated.
// - BC7: the eight modes of the BPTC specification; a first byte of zero
//   (no mode bit) is an opaque black block.

#include <cstdint>
#include <cstring>

namespace {

struct RGBA {
    uint8_t r, g, b, a;
};

inline uint32_t load16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t load32(const uint8_t* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
           (uint32_t(p[3]) << 24);
}

// a 128-bit block as two little-endian words
struct Block128 {
    uint64_t lo, hi;
    explicit Block128(const uint8_t* src) {
        lo = hi = 0;
        for (int i = 7; i >= 0; i--) {
            lo = (lo << 8) | src[i];
            hi = (hi << 8) | src[8 + i];
        }
    }
};

// ``count`` (<= 16) bits from bit ``bit`` of the block, least significant first
inline int get_bits(const Block128& b, int bit, int count) {
    uint64_t v;
    if (bit >= 64)
        v = b.hi >> (bit - 64);
    else if (bit == 0)
        v = b.lo;
    else
        v = (b.lo >> bit) | (b.hi << (64 - bit));
    return int(v & ((uint64_t(1) << count) - 1));
}

inline int get_bit(const Block128& b, int bit) { return get_bits(b, bit, 1); }

RGBA decode_565(uint32_t x) {
    int r = (x & 0xf800) >> 8;
    r |= r >> 5;
    int g = (x & 0x7e0) >> 3;
    g |= g >> 6;
    int b = (x & 0x1f) << 3;
    b |= b >> 5;
    return {uint8_t(r), uint8_t(g), uint8_t(b), 255};
}

void bc1_color(RGBA* col, const uint8_t* src, bool four_colours) {
    uint32_t c0 = load16(src), c1 = load16(src + 2), lut = load32(src + 4);
    RGBA p[4];
    p[0] = decode_565(c0);
    p[1] = decode_565(c1);
    int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
    if (c0 > c1 || four_colours) {
        p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
                uint8_t((2 * b0 + b1) / 3), 255};
        p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
                uint8_t((b0 + 2 * b1) / 3), 255};
    } else {
        p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
        p[3] = {0, 0, 0, 0};
    }
    for (int n = 0; n < 16; n++) col[n] = p[3 & (lut >> (2 * n))];
}

// one BC3-alpha / BC4 / BC5 channel into byte ``o`` of each ``stride``-byte pixel
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
    int a0 = src[0], a1 = src[1];
    if (sign) {
        a0 = int8_t(src[0]) + 128;
        a1 = int8_t(src[1]) + 128;
    }
    uint8_t a[8];
    a[0] = uint8_t(a0);
    a[1] = uint8_t(a1);
    if (a0 > a1) {
        for (int k = 1; k < 7; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
    } else {
        for (int k = 1; k < 5; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
        a[6] = 0;
        a[7] = 255;
    }
    uint32_t lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
    uint32_t lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
    for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
    for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// ---------------------------------------------------------------- BPTC tables

// the 2-subset partitions (bit n: the subset of pixel n) and 3-subset
// partitions (2 bits a pixel), and the anchor pixel of subset 1 (2-subset)
// and of subsets 1 and 2 (3-subset)
const uint16_t kSubsets2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kSubsets3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8, 2,  2, 8,
    8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2, 8,  2, 2,
    2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2, 15};
const uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3,  15, 15, 8, 8, 6,  6, 6, 5,  3,  3,  3,  3, 8,  15, 3,  3,
    6, 10, 5, 8,  8, 6,  8,  5,  15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5,
    15, 15, 15, 15, 3, 15, 5, 5,  5,  8,  5,  10, 5, 10, 8, 13, 15, 12, 3, 3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8,  15, 3,  15, 8,
    15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8, 15,
    3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
    return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int ns, int partition, int n) {
    if (ns == 2) return 1 & (kSubsets2[partition] >> n);
    if (ns == 3) return 3 & (kSubsets3[partition] >> (2 * n));
    return 0;
}

// whether pixel n holds one index bit fewer (the anchor of its subset)
bool is_anchor(int ns, int partition, int n) {
    if (n == 0) return true;
    if (ns == 2) return n == kAnchor2[partition];
    if (ns == 3) return n == kAnchor3a[partition] || n == kAnchor3b[partition];
    return false;
}

// ------------------------------------------------------------------- BC7

struct Bc7Mode {
    int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline uint8_t lerp6(int e0, int e1, int w) { return uint8_t(((64 - w) * e0 + w * e1 + 32) >> 6); }

void bc7_block(RGBA* col, const uint8_t* bytes) {
    if (bytes[0] == 0) {  // no mode bit: the reserved mode 8
        for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
        return;
    }
    const Block128 src(bytes);
    int mode = 0;
    while (!(bytes[0] & (1 << mode))) mode++;
    const Bc7Mode& m = kBc7Modes[mode];
    int bit = mode + 1;
    int partition = get_bits(src, bit, m.pb);
    bit += m.pb;
    int rotation = get_bits(src, bit, m.rb);
    bit += m.rb;
    int index_sel = get_bits(src, bit, m.isb);
    bit += m.isb;
    int numep = m.ns * 2, cb = m.cb, ab = m.ab;
    int ep[6][4];  // r, g, b, a of each endpoint
    for (int c = 0; c < 3; c++)
        for (int i = 0; i < numep; i++, bit += cb) ep[i][c] = get_bits(src, bit, cb);
    for (int i = 0; i < numep; i++) {
        ep[i][3] = ab ? get_bits(src, bit, ab) : 255;
        bit += ab;
    }
    if (m.epb) {  // a p-bit an endpoint
        cb++;
        if (ab) ab++;
        for (int i = 0; i < numep; i++, bit++)
            for (int c = 0; c < (ab ? 4 : 3); c++) ep[i][c] = (ep[i][c] << 1) | get_bit(src, bit);
    }
    if (m.spb) {  // a p-bit a subset
        cb++;
        if (ab) ab++;
        for (int i = 0; i < numep; i += 2, bit++)
            for (int c = 0; c < (ab ? 4 : 3); c++) {
                ep[i][c] = (ep[i][c] << 1) | get_bit(src, bit);
                ep[i + 1][c] = (ep[i + 1][c] << 1) | get_bit(src, bit);
            }
    }
    for (int i = 0; i < numep; i++) {
        for (int c = 0; c < 3; c++)
            ep[i][c] = uint8_t((ep[i][c] << (8 - cb)) | (ep[i][c] >> (2 * cb - 8)));
        if (ab) ep[i][3] = uint8_t((ep[i][3] << (8 - ab)) | (ep[i][3] >> (2 * ab - 8)));
    }
    const uint8_t* cw = weights(m.ib);
    const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
    int cibit = bit, aibit = bit + 16 * m.ib - m.ns;
    for (int i = 0; i < 16; i++) {
        int s = subset_of(m.ns, partition, i) << 1;
        int ib = m.ib - (is_anchor(m.ns, partition, i) ? 1 : 0);
        int i0 = get_bits(src, cibit, ib);
        cibit += ib;
        int wc = cw[i0], wa = cw[i0];
        if (ab && m.ib2) {
            int ib2 = m.ib2 - (i == 0 ? 1 : 0);
            int i1 = get_bits(src, aibit, ib2);
            aibit += ib2;
            if (index_sel) {
                wc = aw[i1];
                wa = cw[i0];
            } else {
                wa = aw[i1];
            }
        }
        RGBA p = {lerp6(ep[s][0], ep[s + 1][0], wc), lerp6(ep[s][1], ep[s + 1][1], wc),
                  lerp6(ep[s][2], ep[s + 1][2], wc), lerp6(ep[s][3], ep[s + 1][3], wa)};
        uint8_t t;
        if (rotation == 1) {
            t = p.r, p.r = p.a, p.a = t;
        } else if (rotation == 2) {
            t = p.g, p.g = p.a, p.a = t;
        } else if (rotation == 3) {
            t = p.b, p.b = p.a, p.a = t;
        }
        col[i] = p;
    }
}

// ------------------------------------------------------------------- BC6H

struct Bc6Mode {
    int ns, tr, eb, db[3];
    const char* layout;  // the endpoint fields after the mode bits, in block order
};
// A field "c<e>[a:b]" is channel r / g / b of endpoint e (0-1 the first
// region's, 2-3 the second's); see ``parse_layouts`` for its bit order.
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, {5, 5, 5},
     "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
     "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 7, {6, 6, 6},
     "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
     "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"},
    {2, 1, 11, {5, 4, 4},
     "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] "
     "b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 11, {4, 5, 4},
     "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] "
     "b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]"},
    {2, 1, 11, {4, 4, 5},
     "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] "
     "b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]"},
    {2, 1, 9, {5, 5, 5},
     "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
     "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 8, {6, 5, 5},
     "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] "
     "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]"},
    {2, 1, 8, {5, 6, 5},
     "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
     "g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 8, {5, 5, 6},
     "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
     "g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 0, 6, {6, 6, 6},
     "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] "
     "b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"},
    {1, 0, 10, {10, 10, 10}, "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]"},
    {1, 1, 11, {9, 9, 9},
     "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]"},
    {1, 1, 12, {8, 8, 8},
     "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]"},
    {1, 1, 16, {4, 4, 4},
     "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]"},
};

// (endpoint value index 0-11, bit) of each endpoint bit of each mode, in
// block order: a field [a:b] with a >= b runs b, b + 1, ..., a, and one with
// a < b runs b, b - 1, ..., a (the high bits of modes 12 and 13, stored most
// significant first)
struct Bc6Bits {
    uint8_t count;
    uint8_t field[75], bit[75];
};
Bc6Bits g_bc6_bits[14];

void parse_layouts() {
    for (int mode = 0; mode < 14; mode++) {
        Bc6Bits& out = g_bc6_bits[mode];
        out.count = 0;
        const char* p = kBc6Modes[mode].layout;
        while (*p) {
            while (*p == ' ') p++;
            if (!*p) break;
            int channel = *p == 'r' ? 0 : *p == 'g' ? 1 : 2;
            int endpoint = p[1] - '0';
            p += 3;  // past "c<e>["
            int a = 0, b;
            while (*p >= '0' && *p <= '9') a = a * 10 + (*p++ - '0');
            b = a;
            if (*p == ':') {
                p++;
                b = 0;
                while (*p >= '0' && *p <= '9') b = b * 10 + (*p++ - '0');
            }
            p++;  // past ']'
            int field = 3 * endpoint + channel;
            if (a >= b) {
                for (int k = b; k <= a; k++, out.count++) {
                    out.field[out.count] = uint8_t(field);
                    out.bit[out.count] = uint8_t(k);
                }
            } else {
                for (int k = b; k >= a; k--, out.count++) {
                    out.field[out.count] = uint8_t(field);
                    out.bit[out.count] = uint8_t(k);
                }
            }
        }
    }
}

int sign_extend(int v, int bits) {
    v &= (1 << bits) - 1;
    return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
    if (!sign) {
        if (bits >= 15) return v;
        if (v == 0) return 0;
        if (v == (1 << bits) - 1) return 0xffff;
        return ((v << 16) + 0x8000) >> bits;
    }
    v = int16_t(uint16_t(v));  // the endpoints are 16-bit words, read back as signed
    if (bits >= 16) return v;
    int s = 0;
    if (v < 0) {
        s = 1;
        v = -v;
    }
    int q;
    if (v == 0)
        q = 0;
    else if (v >= (1 << (bits - 1)) - 1)
        q = 0x7fff;
    else
        q = ((v << 15) + 0x4000) >> (bits - 1);
    return s ? -q : q;
}

float half_to_float(uint16_t h) {
    int e = (h >> 10) & 31, m = h & 1023;
    float v;
    if (e == 0)
        v = float(m) / 16777216.0f;  // 2^-24
    else if (e == 31)
        v = m ? __builtin_nanf("") : __builtin_inff();
    else {
        uint32_t u = (uint32_t(e + 112) << 23) | (uint32_t(m) << 13);
        std::memcpy(&v, &u, 4);
    }
    return (h & 0x8000) ? -v : v;
}

uint8_t bc6_to_8bit(int v, bool sign) {
    uint16_t h;
    if (sign)
        h = v < 0 ? uint16_t(0x8000 | ((-v) * 31 / 32)) : uint16_t(v * 31 / 32);
    else
        h = uint16_t(v * 31 / 64);
    float f = half_to_float(h);
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return uint8_t(f * 255.0f);
}

void bc6_block(uint8_t* rgb, const uint8_t* bytes, bool sign) {
    const Block128 src(bytes);
    int mode = bytes[0] & 0x1f, bit = 5;
    if ((mode & 3) < 2) {
        mode &= 3;
        bit = 2;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
    } else {
        mode = 10 + (mode >> 2);
    }
    if (mode >= 14) {  // the reserved modes 10011, 10111, 11011, 11111
        std::memset(rgb, 0, 48);
        return;
    }
    const Bc6Mode& m = kBc6Modes[mode];
    const Bc6Bits& lay = g_bc6_bits[mode];
    int e[12] = {0};
    for (int i = 0; i < lay.count; i++) e[lay.field[i]] |= get_bit(src, bit + i) << lay.bit[i];
    bit += lay.count;
    int partition = 0;
    if (m.ns == 2) {
        partition = get_bits(src, bit, 5);
        bit += 5;
    }
    int numep = m.ns * 6;
    if (sign)
        for (int c = 0; c < 3; c++) e[c] = sign_extend(e[c], m.eb);
    if (sign || m.tr)
        for (int i = 3; i < numep; i++) e[i] = sign_extend(e[i], m.db[i % 3]);
    if (m.tr)
        for (int i = 3; i < numep; i++) {
            e[i] = (e[i] + e[i % 3]) & ((1 << m.eb) - 1);
        }
    int u[12];
    for (int i = 0; i < numep; i++) u[i] = bc6_unquantize(e[i], m.eb, sign);
    int ib = m.ns == 2 ? 3 : 4;
    const uint8_t* w = weights(ib);
    for (int i = 0; i < 16; i++) {
        int s = m.ns == 2 ? 6 * subset_of(2, partition, i) : 0;
        int n = ib - (is_anchor(m.ns, partition, i) ? 1 : 0);
        int wi = w[get_bits(src, bit, n)];
        bit += n;
        for (int c = 0; c < 3; c++) {
            int v = (u[s + c] * (64 - wi) + u[s + 3 + c] * wi) >> 6;
            rgb[3 * i + c] = bc6_to_8bit(v, sign);
        }
    }
}

// ------------------------------------------------------------- the image loop

// decode a width x height image of ``block_bytes``-byte blocks into ``dst``
// (``px`` bytes a pixel); ``fn(block, src)`` writes 16 pixels of ``px`` bytes
template <typename F>
int decode_image(const uint8_t* src, int64_t size, int width, int height, int block_bytes,
                 int px, uint8_t* dst, F fn) {
    int64_t bx = (int64_t(width) + 3) / 4, by = (int64_t(height) + 3) / 4;
    if (size < bx * by * block_bytes) return -1;
    uint8_t block[16 * 4];
    for (int64_t y = 0; y < by; y++)
        for (int64_t x = 0; x < bx; x++) {
            fn(block, src + (y * bx + x) * block_bytes);
            for (int j = 0; j < 4; j++) {
                int64_t yy = 4 * y + j;
                if (yy >= height) break;
                for (int i = 0; i < 4; i++) {
                    int64_t xx = 4 * x + i;
                    if (xx >= width) break;
                    std::memcpy(dst + (yy * width + xx) * px, block + (4 * j + i) * px, px);
                }
            }
        }
    return 0;
}

}  // namespace

extern "C" {

int akr_bc1(const uint8_t* src, int64_t size, int width, int height, uint8_t* dst) {
    return decode_image(src, size, width, height, 8, 4, dst, [](uint8_t* out, const uint8_t* b) {
        bc1_color(reinterpret_cast<RGBA*>(out), b, false);
    });
}

int akr_bc2(const uint8_t* src, int64_t size, int width, int height, uint8_t* dst) {
    return decode_image(src, size, width, height, 16, 4, dst,
                        [](uint8_t* out, const uint8_t* b) {
                            RGBA* col = reinterpret_cast<RGBA*>(out);
                            bc1_color(col, b + 8, true);
                            for (int n = 0; n < 16; n++) {
                                int av = 0xf & (b[n >> 1] >> (4 * (n & 1)));
                                col[n].a = uint8_t((av << 4) | av);
                            }
                        });
}

int akr_bc3(const uint8_t* src, int64_t size, int width, int height, uint8_t* dst) {
    return decode_image(src, size, width, height, 16, 4, dst,
                        [](uint8_t* out, const uint8_t* b) {
                            bc1_color(reinterpret_cast<RGBA*>(out), b + 8, true);
                            bc3_alpha(out, b, 4, 3, false);
                        });
}

int akr_bc4(const uint8_t* src, int64_t size, int width, int height, uint8_t* dst) {
    return decode_image(src, size, width, height, 8, 1, dst, [](uint8_t* out, const uint8_t* b) {
        bc3_alpha(out, b, 1, 0, false);
    });
}

int akr_bc5(const uint8_t* src, int64_t size, int width, int height, int sign, uint8_t* dst) {
    return decode_image(src, size, width, height, 16, 3, dst,
                        [sign](uint8_t* out, const uint8_t* b) {
                            std::memset(out, sign ? 128 : 0, 48);
                            bc3_alpha(out, b, 3, 0, sign != 0);
                            bc3_alpha(out, b + 8, 3, 1, sign != 0);
                        });
}

int akr_bc6h(const uint8_t* src, int64_t size, int width, int height, int sign, uint8_t* dst) {
    static const bool parsed = (parse_layouts(), true);
    (void)parsed;
    return decode_image(src, size, width, height, 16, 3, dst,
                        [sign](uint8_t* out, const uint8_t* b) { bc6_block(out, b, sign != 0); });
}

int akr_bc7(const uint8_t* src, int64_t size, int width, int height, uint8_t* dst) {
    return decode_image(src, size, width, height, 16, 4, dst, [](uint8_t* out, const uint8_t* b) {
        bc7_block(reinterpret_cast<RGBA*>(out), b);
    });
}

}  // extern "C"
