// AV1 still-image decoding (the intra key frame of an AVIF image item) to
// YUV planes at 8, 10 or 12 bits, and the YUV -> RGB conversion, for
// akari_torch/core/avif.py.
//
// The JAX package reads AVIF through PIL, which hands the item to libavif
// 1.3.0; libavif decodes it with dav1d 1.5.1 and converts it to RGB with
// libyuv. The decoder follows the AV1 specification's decoding process
// (AV1 Bitstream & Decoding Process Specification, 2019, sections 5-7), to
// which dav1d is conformant, so its planes are dav1d's:
//
// - OBUs: temporal delimiters, padding and metadata skipped; the sequence
//   header (reduced or full, timing / decoder-model / operating-point
//   fields parsed and ignored; profiles 0-2, 8, 10 and 12 bits), the frame
//   header of a key frame, and the frame's tile groups (OBU_FRAME, or
//   OBU_FRAME_HEADER with OBU_TILE_GROUPs), uniform and non-uniform tile
//   spacing; a hidden (showable) key frame is output when a later
//   show_existing_frame header of the data names a slot it refreshed;
// - every pixel is 16-bit; at 10 and 12 bits the dequantisation tables,
//   the coefficient and transform ranges, intra prediction's base value,
//   the deblocking limits, CDEF's strengths and damping, loop
//   restoration's rounding and scaling and film grain's ranges and
//   scaling follow the specification at BitDepth (dav1d's 16 bpc code);
// - superres (7.16): the frame decoded, deblocked and CDEF-filtered at its
//   downscaled width, then upscaled (Upscale_Filter, dav1d's resize_c)
//   before film grain;
// - the symbol decoder, with CDF adaptation unless the frame disables it;
//   each tile starts from the default CDFs (av1_tables.h), the coefficient
//   CDFs of the frame's qindex context;
// - partitions of 64x64 and 128x128 superblocks, intra mode info (key-frame
//   y modes with their above / left contexts, uv modes with CfL, angle
//   deltas, filter intra, palettes with their colour cache and colour
//   index maps, tx_size depth under TX_MODE_SELECT), the skip flag;
// - segmentation (the features of each segment, segment ids predicted from
//   the above, left and above-left blocks and read before or after skip,
//   the skip feature, each segment's q index, lossless and quantizer-matrix
//   level), delta q and delta lf (read at a superblock's first block;
//   CurrentQIndex and DeltaLF start each tile afresh, as in dav1d);
// - intra block copy: the block vector's reference stack (find_mv_stack
//   for INTRA_FRAME), its coded difference (integer), dav1d's clip to the
//   decoded part of the tile, the txfm_split transform tree, the inter
//   transform sets (16, 12 and 2 types, flipped ADSTs; chroma takes the
//   co-located luma type), the prediction copied from the frame as decoded
//   so far (bilinear at odd chroma positions, dav1d's put_bilin);
// - coefficients (all_zero, eob, base levels, ranges, Golomb tails, signs,
//   with every context), dequantisation, and the inverse DCT (4-64), ADST
//   (4, 8, 16), identity and, for lossless frames, Walsh-Hadamard
//   transforms with the specification's intermediate rounding and dav1d's
//   16-bit clamps;
// - intra prediction: DC, the directional modes (edge filtering and
//   upsampling), smooth, smooth-V / H, Paeth, recursive filter intra, CfL
//   and palette;
// - quantizer matrices (levels 0-14 of 2-D transforms; av1_tables.h);
// - the deblocking filter (4, 6, 8 and 14 taps; levels per block, plane
//   and direction with the block's delta lf, its segment's ALT_LF feature
//   and the reference-delta term, the level before the edge where the
//   block's is 0; sharpness);
// - CDEF (the cdef_idx of each 64x64 block read in the tile, direction
//   search, primary and secondary taps, the chroma direction map, skipped
//   8x8 blocks, the frame edge);
// - loop restoration (the units' Wiener taps and self-guided sets read in
//   the tile, delta-coded on the unit before; 64-row stripes offset by 8
//   whose rows above and below come from the deblocked frame before CDEF;
//   every unit size and subsampling);
// - film grain (the frame's parameters, grain templates from the Gaussian
//   sequence and the AR filter, scaling lookups, 32x32 blocks at random
//   offsets with overlap, chroma from luma) applied to the output only.
//
// Anything else a header turns on is refused with a message naming it: a
// palette above 8 bits (its colours are literals of the depth, and no file
// made here holds one), superres with loop restoration (units counted on
// the upscaled width), non-key frames, a hidden key frame that no
// show_existing_frame shows; so is a stream whose transforms leave the
// range the specification requires (see g_itx_overflow).
//
// C ABI (ctypes):
//   int akr_av1_probe(const uint8_t* data, int64_t size, int32_t* info,
//                     char* err, int32_t errlen);
//   int akr_av1_decode(const uint8_t* data, int64_t size, uint16_t* y,
//                      uint16_t* u, uint16_t* v, int64_t* stats, char* err,
//                      int32_t errlen);
//   int akr_av1_sequence_header(const uint8_t* data, int64_t size, char* err,
//                               int32_t errlen);
//   void akr_yuv_to_rgb(...), akr_scale_plane(...), akr_scale_plane16(...)
//        (see the end of the file)
// data: the item's OBUs. info receives 30 values: width (the upscaled
// width under superres), height, bit depth,
// mono, subsampling x, subsampling y, colour range, colour primaries,
// transfer, matrix, chroma sample position, profile, 128x128 superblocks,
// tx mode (0 only 4x4, 1 largest, 2 select), screen content tools, tile
// columns, tile rows, lossless (every segment's), the four loop filter
// levels (a byte each),
// base_q_idx, the quantizer-matrix levels (y, u, v, four bits each; 15:
// none), the number of nonzero CDEF strengths, the restoration type per
// plane (two bits each: none, Wiener, self-guided, switchable),
// apply_grain, segmentation, delta q, delta lf, allow_intrabc, the superres
// denominator (8: none) and whether the frame was hidden. The 16-bit
// planes are written at the frame's size, chroma at ((width + ssx) >> ssx)
// x ((height + ssy) >> ssy); stats (may be null) receives 14 counts:
// blocks, luma palettes, chroma palettes, filter intra, CfL, tx_depth > 0
// (or transform splits), luma transforms other than DCT_DCT, angle deltas,
// blocks of a nonzero segment, superblocks with a nonzero delta q, intra
// block copies, 8x8 blocks CDEF filtered, stripes of restoration units
// filtered, planes given grain.
// Returns 0, or -1 with a message in err.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "av1_tables.h"

namespace {

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};
// a tool or form the decoder does not read (as opposed to a malformed stream)
struct Unported : DecodeError {
    using DecodeError::DecodeError;
};

[[noreturn]] void fail(const char* fmt, ...) {
    char buf[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw DecodeError(buf);
}

[[noreturn]] void unported(const char* what) {
    char buf[256];
    snprintf(buf, sizeof buf, "%s", what);
    throw Unported(buf);
}

inline int imin(int a, int b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int clip3(int lo, int hi, int x) { return x < lo ? lo : (x > hi ? hi : x); }
inline int round2(int64_t x, int n) { return n == 0 ? int(x) : int((x + (int64_t(1) << (n - 1))) >> n); }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floorlog2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceillog2(int x) { if (x < 2) return 0; int i = 1, p = 2; while (p < x) { i++; p <<= 1; } return i; }

// ---------------------------------------------------------------------------
// block and transform sizes (the specification's enumerations)

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
       BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64,
       BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32,
       BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_INVALID };
const int kBw[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
const int kBh[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

int block_of(int w, int h) {
    for (int b = 0; b < 22; b++)
        if (kBw[b] == w && kBh[b] == h) return b;
    return BLOCK_INVALID;
}
int mi_wlog2(int b) { return floorlog2(kBw[b] >> 2); }
int mi_hlog2(int b) { return floorlog2(kBh[b] >> 2); }

enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8,
       TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8,
       TX_16X64, TX_64X16 };
const int kTw[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int kTh[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

int tx_of(int w, int h) {
    for (int t = 0; t < 19; t++)
        if (kTw[t] == w && kTh[t] == h) return t;
    fail("no transform of %dx%d", w, h);
}
int tx_sqr_of(int t) { int s = imin(kTw[t], kTh[t]); return tx_of(s, s); }
int tx_sqr_up_of(int t) { int s = imax(kTw[t], kTh[t]); return tx_of(s, s); }
int tx_split(int t) {
    int w = kTw[t], h = kTh[t];
    if (w == h) return w == 4 ? TX_4X4 : tx_of(w / 2, h / 2);
    if (w == 2 * h || h == 2 * w) { int s = imin(w, h); return tx_of(s, s); }
    return w > h ? tx_of(w / 2, h) : tx_of(w, h / 2);
}
int max_tx_rect(int b) { return tx_of(imin(kBw[b], 64), imin(kBh[b], 64)); }
// splits from the largest transform of a block to 4x4
int tx_depth_of(int b) { int t = max_tx_rect(b), d = 0; while (t != TX_4X4) { t = tx_split(t); d++; } return d; }
int adjusted_tx_of(int t) { return tx_of(imin(kTw[t], 32), imin(kTh[t], 32)); }

// per-size lookups, computed once
struct TxTables {
    int sqr[19], sqr_up[19], adjusted[19], split[19];
    TxTables() {
        for (int t = 0; t < 19; t++) {
            sqr[t] = tx_sqr_of(t);
            sqr_up[t] = tx_sqr_up_of(t);
            adjusted[t] = adjusted_tx_of(t);
            split[t] = tx_split(t);
        }
    }
};
const TxTables& txt() { static TxTables t; return t; }
inline int tx_sqr(int t) { return txt().sqr[t]; }
inline int tx_sqr_up(int t) { return txt().sqr_up[t]; }
inline int adjusted_tx(int t) { return txt().adjusted[t]; }

enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
       ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}
// 1-D kinds: 0 DCT, 1 ADST (or a flipped ADST), 2 identity (vertical,
// horizontal); whether the columns' output is flipped upside down
// (FLIPADST vertically), the rows' left to right (FLIPADST horizontally)
void tx_kinds(int t, int* vk, int* hk, int* flip_ud, int* flip_lr) {
    static const int v[16] = {0, 1, 0, 1, 1, 0, 1, 1, 1, 2, 0, 2, 1, 2, 1, 2};
    static const int h[16] = {0, 0, 1, 1, 0, 1, 1, 1, 1, 2, 2, 0, 2, 1, 2, 1};
    *vk = v[t];
    *hk = h[t];
    *flip_ud = t == FLIPADST_DCT || t == FLIPADST_FLIPADST || t == FLIPADST_ADST || t == V_FLIPADST;
    *flip_lr = t == DCT_FLIPADST || t == FLIPADST_FLIPADST || t == ADST_FLIPADST || t == H_FLIPADST;
}

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
       SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                             DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const int kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const int kTxTypeIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int kTxTypeIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int kTxTypeInterInvSet1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
                                     DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
                                     ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int kTxTypeInterInvSet2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                                     DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                     FLIPADST_ADST};
const int kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int kPaletteColorHashMultipliers[3] = {1, 2, 2};
const int kSigRefDiffOffset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int kMagRefOffset[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
const int kIntraEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
       PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };

int partition_subsize(int p, int b) {
    int w = kBw[b], h = kBh[b];
    switch (p) {
        case PARTITION_NONE: return b;
        case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: return block_of(w, h / 2);
        case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: return block_of(w / 2, h);
        case PARTITION_SPLIT: return block_of(w / 2, h / 2);
        case PARTITION_HORZ_4: return block_of(w, h / 4);
        default: return block_of(w / 4, h);
    }
}

// ---------------------------------------------------------------------------
// scan orders (row-major positions, the specification's tables): square
// sizes zig-zag, starting to the right; wide sizes run each anti-diagonal
// from bottom-left to top-right, tall sizes from top-right to bottom-left.

struct Scans {
    std::vector<uint16_t> def[19], mrow[19], mcol[19];
    Scans() {
        for (int t = 0; t < 19; t++) {
            int w = imin(kTw[t], 32), h = imin(kTh[t], 32);
            std::vector<uint16_t>& s = def[t];
            for (int d = 0; d < w + h - 1; d++) {
                std::vector<uint16_t> cells;
                for (int r = 0; r < h; r++) {
                    int c = d - r;
                    if (c >= 0 && c < w) cells.push_back(uint16_t(r * w + c));
                }
                bool reverse = w == h ? (d % 2 == 0) : (w > h);
                if (reverse) std::reverse(cells.begin(), cells.end());
                s.insert(s.end(), cells.begin(), cells.end());
            }
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) mrow[t].push_back(uint16_t(r * w + c));
            for (int c = 0; c < w; c++)
                for (int r = 0; r < h; r++) mcol[t].push_back(uint16_t(r * w + c));
        }
    }
};
const Scans& scans() { static Scans s; return s; }

// ---------------------------------------------------------------------------
// bit reader for headers

struct BitReader {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;  // bits
    BitReader(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}
    int bit() {
        if ((pos >> 3) >= n) fail("a header runs past the end of its OBU");
        int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    uint32_t f(int k) { uint32_t x = 0; for (int i = 0; i < k; i++) x = (x << 1) | uint32_t(bit()); return x; }
    int su(int k) { int v = int(f(k)); int sign = 1 << (k - 1); return (v & sign) ? v - 2 * sign : v; }
    int ns(int nn) {
        int w = floorlog2(uint32_t(nn)) + 1, m = (1 << w) - nn;
        int v = int(f(w - 1));
        if (v < m) return v;
        return (v << 1) - m + int(f(1));
    }
    uint32_t uvlc() {
        int lz = 0;
        while (!bit()) { if (++lz >= 32) fail("bad uvlc value in a header"); }
        return lz ? f(lz) + ((1u << lz) - 1) : 0;
    }
    void byte_align() { pos = (pos + 7) & ~size_t(7); }
    // dav1d's trailing-bits check (not strict, as libavif runs it): one
    // more bit must be in the OBU
    void trailing_bit() { bit(); }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t* pos) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) {
        if (*pos >= n) fail("an OBU size runs past the end of the data");
        uint8_t b = d[(*pos)++];
        v |= uint64_t(b & 0x7f) << (7 * i);
        if (!(b & 0x80)) return v;
    }
    fail("an OBU size of more than 8 bytes");
}

// ---------------------------------------------------------------------------
// symbol decoder

struct Cdfs {
    uint16_t kf_y_mode[5][5][16];
    uint16_t uv_mode_cfl_not_allowed[13][16], uv_mode_cfl_allowed[13][16];
    uint16_t partition128[4][8], partition64[4][16], partition32[4][16], partition16[4][16],
        partition8[4][4];
    uint16_t cfl_alpha[6][16], intra_tx_set1[2][13][8], intra_tx_set2[3][13][8], cfl_sign[8],
        angle_delta[8][8], filter_intra_mode[8];
    uint16_t palette_y_size[7][8], palette_uv_size[7][8], palette_y_color[7][5][8],
        palette_uv_color[7][5][8];
    uint16_t tx_size8[3][4], tx_size16[3][4], tx_size32[3][4], tx_size64[3][4],
        use_filter_intra[22][2], skip[3][2], palette_y_mode[7][3][2], palette_uv_mode[2][2],
        restoration_type[4], use_wiener[2], use_sgrproj[2];
    uint16_t eob_pt16[2][2][8], eob_pt32[2][2][8], eob_pt64[2][2][8], eob_pt128[2][2][8],
        eob_pt256[2][2][16], eob_pt512[2][16], eob_pt1024[2][16];
    uint16_t coeff_base_eob[5][2][4][4], coeff_base[5][2][41][4], coeff_br[4][2][21][4],
        eob_extra[5][2][9][2], txb_skip[5][13][2], dc_sign[2][3][2];
    // segment ids, delta q / lf, intra block copy: the flag, the transform
    // split tree and the inter transform sets, the vector's (one set per
    // component: vertical, horizontal)
    uint16_t seg_id[3][8], delta_q[4], delta_lf[5][4], intrabc[2], txfm_split[21][2],
        inter_tx_set1[2][16], inter_tx_set2[16], inter_tx_set3[4][2], mv_joint[4];
    struct MvComponent {
        uint16_t classes[16], sign[2], class0[2], bits[10][2];
    } mv[2];

    void init(int base_q_idx) {
#define CP(name) memcpy(name, av1_##name, sizeof name)
        CP(kf_y_mode); CP(uv_mode_cfl_not_allowed); CP(uv_mode_cfl_allowed);
        CP(partition128); CP(partition64); CP(partition32); CP(partition16); CP(partition8);
        CP(cfl_alpha); CP(intra_tx_set1); CP(intra_tx_set2); CP(cfl_sign); CP(angle_delta);
        CP(filter_intra_mode); CP(palette_y_size); CP(palette_uv_size); CP(palette_y_color);
        CP(palette_uv_color); CP(tx_size8); CP(tx_size16); CP(tx_size32); CP(tx_size64);
        CP(use_filter_intra); CP(skip); CP(palette_y_mode); CP(palette_uv_mode);
        CP(restoration_type); CP(use_wiener); CP(use_sgrproj);
        CP(seg_id); CP(delta_q); CP(delta_lf); CP(intrabc); CP(inter_tx_set1); CP(inter_tx_set2);
        CP(inter_tx_set3); CP(mv_joint);
#undef CP
        memcpy(txfm_split, av1_txfm_split, sizeof txfm_split);
        for (auto& c : mv) {
            memcpy(c.classes, av1_mv_classes, sizeof c.classes);
            memcpy(c.sign, av1_mv_sign, sizeof c.sign);
            memcpy(c.class0, av1_mv_class0, sizeof c.class0);
            memcpy(c.bits, av1_mv_bits, sizeof c.bits);
        }
        int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
#define CQ(name) memcpy(name, av1_##name[q], sizeof name)
        CQ(eob_pt16); CQ(eob_pt32); CQ(eob_pt64); CQ(eob_pt128); CQ(eob_pt256); CQ(eob_pt512);
        CQ(eob_pt1024); CQ(coeff_base_eob); CQ(coeff_base); CQ(coeff_br); CQ(eob_extra);
        CQ(txb_skip); CQ(dc_sign);
#undef CQ
    }
};

struct SymbolDecoder {
    const uint8_t* d = nullptr;
    int64_t size = 0, bitpos = 0, maxbits = 0;
    uint32_t value = 0, range = 0;
    bool adapt = true;

    uint32_t bits(int k) {  // k <= 15; zeros past the end of the tile
        if (k == 0) return 0;
        int64_t byte = bitpos >> 3;
        uint32_t w = 0;
        if (byte + 4 <= size) {
            w = (uint32_t(d[byte]) << 24) | (uint32_t(d[byte + 1]) << 16) |
                (uint32_t(d[byte + 2]) << 8) | uint32_t(d[byte + 3]);
        } else {
            for (int i = 0; i < 4; i++) w = (w << 8) | (byte + i < size ? d[byte + i] : 0u);
        }
        uint32_t x = (w << (bitpos & 7)) >> (32 - k);
        bitpos += k;
        return x;
    }
    void init(const uint8_t* p, int64_t sz, bool disable_cdf_update) {
        d = p;
        size = sz;
        bitpos = 0;
        int nb = int(std::min<int64_t>(sz * 8, 15));
        uint32_t buf = bits(nb);
        uint32_t padded = buf << (15 - nb);
        value = ((1u << 15) - 1) ^ padded;
        range = 1u << 15;
        maxbits = 8 * sz - 15;
        adapt = !disable_cdf_update;
    }
    int read(uint16_t* cdf, int n, bool update = true) {
        uint32_t cur = range, prev;
        int s = -1;
        do {
            s++;
            prev = cur;
            uint32_t f = s < n - 1 ? cdf[s] : 0;
            cur = (((range >> 8) * (f >> 6)) >> 1) + 4u * uint32_t(n - s - 1);
        } while (value < cur);
        range = prev - cur;
        value -= cur;
        int b = 15 - floorlog2(range);
        range <<= b;
        int nb = int(std::min<int64_t>(b, std::max<int64_t>(0, maxbits)));
        uint32_t data = bits(nb);
        uint32_t padded = data << (b - nb);
        value = padded ^ (((value + 1) << b) - 1);
        maxbits -= b;
        if (update && adapt) {
            int cnt = cdf[n - 1];
            int rate = 3 + (cnt > 15) + (cnt > 31) + imin(floorlog2(uint32_t(n)), 2);
            for (int i = 0; i < n - 1; i++) {
                if (i < s) cdf[i] += (32768 - cdf[i]) >> rate;
                else cdf[i] -= cdf[i] >> rate;
            }
            cdf[n - 1] += cnt < 32;
        }
        return s;
    }
    int read_bool() { uint16_t c[2] = {16384, 0}; return read(c, 2, false); }
    int lit(int k) { int x = 0; for (int i = 0; i < k; i++) x = 2 * x + read_bool(); return x; }
    int ns(int nn) {
        int w = floorlog2(uint32_t(nn)) + 1, m = (1 << w) - nn;
        int v = lit(w - 1);
        if (v < m) return v;
        return (v << 1) - m + lit(1);
    }
};

// ---------------------------------------------------------------------------
// inverse transforms

// round(4096 cos(i pi / 128)), the specification's cos128 for i = 0..64
const int g_cospi[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948, 3920, 3889, 3857,
    3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102,
    3035, 2967, 2896, 2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931,
    1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0};

// Set when a transform's intermediate value leaves the range the
// specification requires of a conformant stream (BitDepth + 8 bits in the
// row transforms, Max(BitDepth + 6, 16) in the column transforms: 16 and
// 16 at 8 bits): dav1d's C clamps only its sums there, its x86 assembly
// (which PIL runs) saturates its lanes (16-bit ones at 8 bits, 16- or
// 32-bit ones at 10 and 12), so their pixels part on such (corrupt)
// streams. g_itx_max is the current pass's bound.
thread_local bool g_itx_overflow = false;
thread_local int32_t g_itx_max = 32767;

inline int32_t chk_range(int64_t v) {
    if (v < -int64_t(g_itx_max) - 1 || v > g_itx_max) g_itx_overflow = true;
    return int32_t(v);
}

inline int32_t hb(int w0, int32_t x0, int w1, int32_t x1) {
    return chk_range((int64_t(w0) * x0 + int64_t(w1) * x1 + 2048) >> 12);
}

struct Clamp {
    int lo, hi;
    int32_t operator()(int64_t x) const { return int32_t(x < lo ? lo : (x > hi ? hi : x)); }
};

inline int brev_slow(int nbits, int x) {
    int r = 0;
    for (int i = 0; i < nbits; i++) r |= ((x >> i) & 1) << (nbits - 1 - i);
    return r;
}
struct BrevTables {
    uint8_t t[7][64];  // t[nbits][x]
    BrevTables() {
        for (int b = 0; b < 7; b++)
            for (int x = 0; x < 64; x++) t[b][x] = uint8_t(x < (1 << b) ? brev_slow(b, x) : 0);
    }
};
inline int brev(int nbits, int x) { static const BrevTables bt; return bt.t[nbits][x]; }

// the odd half of an n-point inverse DCT, on positions m..2m-1 of t (in
// bit-reversed input order), as libaom's av1_idct* stages run it
void idct_odd(int32_t* t, int n, const Clamp& cl) {
    int m = n / 2;
    const int* c = g_cospi;
    int32_t u[64];
    // first rotations: pairs (m + j, n - 1 - j)
    int s = 64 / n;
    for (int j = 0; j < m / 2; j++) {
        int a = m + j, b = n - 1 - j;
        int k = brev(floorlog2(uint32_t(n)), a);  // the input index at position a
        int ang = s * k;
        int32_t xa = t[a], xb = t[b];
        t[a] = hb(c[64 - ang], xa, -c[ang], xb);
        t[b] = hb(c[ang], xa, c[64 - ang], xb);
    }
    for (int g = 2; g <= m / 2; g *= 2) {
        // add / sub in groups of g, alternating plus and minus groups
        for (int i = 0; i < m; i++) u[i] = t[m + i];
        for (int grp = 0; grp < m / g; grp++) {
            int base = grp * g;
            for (int i = 0; i < g / 2; i++) {
                int a = base + i, b = base + g - 1 - i;
                if ((grp & 1) == 0) {
                    t[m + a] = cl(int64_t(u[a]) + u[b]);
                    t[m + b] = cl(int64_t(u[a]) - u[b]);
                } else {
                    t[m + a] = cl(-int64_t(u[a]) + u[b]);
                    t[m + b] = cl(int64_t(u[a]) + u[b]);
                }
            }
        }
        if (g == m / 2) {
            // final rotations by 32 on the middle pairs
            for (int i = 0; i < g / 2; i++) {
                int a = m + g / 2 + i, b = n - 1 - g / 2 - i;
                int32_t xa = t[a], xb = t[b];
                t[a] = hb(-c[32], xa, c[32], xb);
                t[b] = hb(c[32], xa, c[32], xb);
            }
        } else {
            // rotations on blocks of 2g from both ends
            int nb = m / (4 * g);  // blocks per end
            int a0 = 64 * 2 * g / n;
            int lb = floorlog2(uint32_t(nb));
            for (int bl = 0; bl < nb; bl++) {
                int ang = a0 + brev(lb, bl) * (64 / nb);
                int lo = m + bl * 2 * g, hi = n - 1 - bl * 2 * g;
                for (int off = g / 2; off < g; off++) {  // type 1
                    int a = lo + off, b = hi - off;
                    int32_t xa = t[a], xb = t[b];
                    t[a] = hb(-c[ang], xa, c[64 - ang], xb);
                    t[b] = hb(c[64 - ang], xa, c[ang], xb);
                }
                for (int off = g; off < g + g / 2; off++) {  // type 2
                    int a = lo + off, b = hi - off;
                    int32_t xa = t[a], xb = t[b];
                    t[a] = hb(-c[64 - ang], xa, -c[ang], xb);
                    t[b] = hb(-c[ang], xa, c[64 - ang], xb);
                }
            }
        }
    }
}

// in-place inverse DCT of t[0..n-1] already in bit-reversed order
void idct_rec(int32_t* t, int n, const Clamp& cl) {
    if (n == 2) {
        int32_t x0 = t[0], x1 = t[1];
        t[0] = hb(g_cospi[32], x0, g_cospi[32], x1);
        t[1] = hb(g_cospi[32], x0, -g_cospi[32], x1);
        return;
    }
    int m = n / 2;
    idct_rec(t, m, cl);
    idct_odd(t, n, cl);
    int32_t u[64];
    for (int i = 0; i < n; i++) u[i] = t[i];
    for (int i = 0; i < m; i++) {
        t[i] = cl(int64_t(u[i]) + u[n - 1 - i]);
        t[n - 1 - i] = cl(int64_t(u[i]) - u[n - 1 - i]);
    }
}

void idct(int32_t* x, int n, const Clamp& cl) {
    int32_t t[64];
    int lb = floorlog2(uint32_t(n));
    for (int i = 0; i < n; i++) t[i] = x[brev(lb, i)];
    idct_rec(t, n, cl);
    for (int i = 0; i < n; i++) x[i] = t[i];
}

void iadst4(int32_t* x) {
    const int64_t s1 = 1321, s2 = 2482, s3 = 3344, s4 = 3803;
    int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    int64_t a0 = s1 * x0, a1 = s2 * x0, a2 = s3 * x1, a3 = s4 * x2, a4 = s1 * x2, a5 = s2 * x3,
            a6 = s4 * x3;
    int64_t b7 = x0 - x2 + x3;
    a0 = a0 + a3;
    a1 = a1 - a4;
    a3 = a2;
    a2 = s3 * b7;
    a0 = a0 + a5;
    a1 = a1 - a6;
    int64_t o0 = a0 + a3, o1 = a1 + a3, o2 = a2, o3 = a0 + a1 - a3;
    x[0] = chk_range((o0 + 2048) >> 12);
    x[1] = chk_range((o1 + 2048) >> 12);
    x[2] = chk_range((o2 + 2048) >> 12);
    x[3] = chk_range((o3 + 2048) >> 12);
}

void iadst8(int32_t* x, const Clamp& cl) {
    const int* c = g_cospi;
    int32_t b[8], o[8];
    b[0] = x[7]; b[1] = x[0]; b[2] = x[5]; b[3] = x[2];
    b[4] = x[3]; b[5] = x[4]; b[6] = x[1]; b[7] = x[6];
    for (int i = 0; i < 4; i++) {
        int a = 4 + 16 * i;
        o[2 * i] = hb(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
        o[2 * i + 1] = hb(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 4; i++) {
        b[i] = cl(int64_t(o[i]) + o[i + 4]);
        b[i + 4] = cl(int64_t(o[i]) - o[i + 4]);
    }
    o[0] = b[0]; o[1] = b[1]; o[2] = b[2]; o[3] = b[3];
    o[4] = hb(c[16], b[4], c[48], b[5]);
    o[5] = hb(c[48], b[4], -c[16], b[5]);
    o[6] = hb(-c[48], b[6], c[16], b[7]);
    o[7] = hb(c[16], b[6], c[48], b[7]);
    b[0] = cl(int64_t(o[0]) + o[2]); b[1] = cl(int64_t(o[1]) + o[3]);
    b[2] = cl(int64_t(o[0]) - o[2]); b[3] = cl(int64_t(o[1]) - o[3]);
    b[4] = cl(int64_t(o[4]) + o[6]); b[5] = cl(int64_t(o[5]) + o[7]);
    b[6] = cl(int64_t(o[4]) - o[6]); b[7] = cl(int64_t(o[5]) - o[7]);
    o[0] = b[0]; o[1] = b[1];
    o[2] = hb(c[32], b[2], c[32], b[3]);
    o[3] = hb(c[32], b[2], -c[32], b[3]);
    o[4] = b[4]; o[5] = b[5];
    o[6] = hb(c[32], b[6], c[32], b[7]);
    o[7] = hb(c[32], b[6], -c[32], b[7]);
    x[0] = o[0]; x[1] = chk_range(-int64_t(o[4])); x[2] = o[6]; x[3] = chk_range(-int64_t(o[2]));
    x[4] = o[3]; x[5] = chk_range(-int64_t(o[7])); x[6] = o[5]; x[7] = chk_range(-int64_t(o[1]));
}

void iadst16(int32_t* x, const Clamp& cl) {
    const int* c = g_cospi;
    int32_t b[16], o[16];
    static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    for (int i = 0; i < 16; i++) b[i] = x[perm[i]];
    for (int i = 0; i < 8; i++) {
        int a = 2 + 8 * i;
        o[2 * i] = hb(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
        o[2 * i + 1] = hb(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 8; i++) {
        b[i] = cl(int64_t(o[i]) + o[i + 8]);
        b[i + 8] = cl(int64_t(o[i]) - o[i + 8]);
    }
    for (int i = 0; i < 8; i++) o[i] = b[i];
    o[8] = hb(c[8], b[8], c[56], b[9]);
    o[9] = hb(c[56], b[8], -c[8], b[9]);
    o[10] = hb(c[40], b[10], c[24], b[11]);
    o[11] = hb(c[24], b[10], -c[40], b[11]);
    o[12] = hb(-c[56], b[12], c[8], b[13]);
    o[13] = hb(c[8], b[12], c[56], b[13]);
    o[14] = hb(-c[24], b[14], c[40], b[15]);
    o[15] = hb(c[40], b[14], c[24], b[15]);
    for (int i = 0; i < 4; i++) {
        b[i] = cl(int64_t(o[i]) + o[i + 4]);
        b[i + 4] = cl(int64_t(o[i]) - o[i + 4]);
        b[8 + i] = cl(int64_t(o[8 + i]) + o[12 + i]);
        b[12 + i] = cl(int64_t(o[8 + i]) - o[12 + i]);
    }
    for (int k = 0; k < 16; k += 8) {
        o[k + 0] = b[k + 0]; o[k + 1] = b[k + 1]; o[k + 2] = b[k + 2]; o[k + 3] = b[k + 3];
        o[k + 4] = hb(c[16], b[k + 4], c[48], b[k + 5]);
        o[k + 5] = hb(c[48], b[k + 4], -c[16], b[k + 5]);
        o[k + 6] = hb(-c[48], b[k + 6], c[16], b[k + 7]);
        o[k + 7] = hb(c[16], b[k + 6], c[48], b[k + 7]);
    }
    for (int k = 0; k < 16; k += 4) {
        b[k + 0] = cl(int64_t(o[k + 0]) + o[k + 2]);
        b[k + 1] = cl(int64_t(o[k + 1]) + o[k + 3]);
        b[k + 2] = cl(int64_t(o[k + 0]) - o[k + 2]);
        b[k + 3] = cl(int64_t(o[k + 1]) - o[k + 3]);
    }
    for (int k = 0; k < 16; k += 4) {
        o[k + 0] = b[k + 0];
        o[k + 1] = b[k + 1];
        o[k + 2] = hb(c[32], b[k + 2], c[32], b[k + 3]);
        o[k + 3] = hb(c[32], b[k + 2], -c[32], b[k + 3]);
    }
    static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; i++) x[i] = (i & 1) ? chk_range(-int64_t(o[out[i]])) : o[out[i]];
}

void iidentity(int32_t* x, int n) {
    for (int i = 0; i < n; i++) {
        int64_t v = x[i];
        if (n == 4) x[i] = chk_range((v * 5793 + 2048) >> 12);
        else if (n == 8) x[i] = chk_range(v * 2);
        else if (n == 16) x[i] = chk_range((v * 11586 + 2048) >> 12);
        else x[i] = chk_range(v * 4);
    }
}

void itx1d(int32_t* x, int n, int kind, const Clamp& cl) {
    if (kind == 2) iidentity(x, n);
    else if (kind == 0) idct(x, n, cl);
    else if (n == 4) iadst4(x);
    else if (n == 8) iadst8(x, cl);
    else iadst16(x, cl);
}

void iwht4(int32_t* t, int shift) {
    int32_t a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift, b = t[3] >> shift;
    a = chk_range(int64_t(a) + c);
    d = chk_range(int64_t(d) - b);
    int32_t e = (a - d) >> 1;
    b = chk_range(int64_t(e) - b);
    c = chk_range(int64_t(e) - c);
    a = chk_range(int64_t(a) - b);
    d = chk_range(int64_t(d) + c);
    t[0] = a; t[1] = b; t[2] = c; t[3] = d;
}

// ---------------------------------------------------------------------------
// the decoder

// pixels are 16-bit at every depth (8-bit values at 8 bits)
typedef uint16_t pixel;

struct Plane {
    std::vector<pixel> px;
    int stride = 0, rows = 0;
    pixel* at(int y, int x) { return &px[size_t(y) * stride + x]; }
};

struct Decoder {
    // sequence header
    int profile = 0, still = 0, reduced = 0, use128 = 0, enable_filter_intra = 0,
        enable_intra_edge_filter = 0, enable_superres = 0, enable_cdef = 0,
        enable_restoration = 0, bitdepth = 8, mono = 0, ssx = 1, ssy = 1, color_range = 0,
        cp = 2, tc = 2, mc = 2, csp = 0, separate_uv_delta_q = 0, film_grain_present = 0;
    int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0,
        frame_id_numbers_present = 0, id_len = 0, decoder_model_info_present = 0,
        equal_picture_interval = 0, buffer_removal_time_length = 0,
        frame_presentation_time_length = 0, order_hint_bits = 0,
        seq_force_screen_content_tools = 2, seq_force_integer_mv = 2, op_count = 0;
    int op_idc[32] = {0}, op_decoder_model_present[32] = {0};
    bool have_seq = false;
    // frame header: W the coded (superres-downscaled) width, UpW the
    // output width (W where superres is off)
    int W = 0, H = 0, UpW = 0, MiCols = 0, MiRows = 0, num_planes = 3;
    int use_superres = 0, superres_denom = 8;
    // a hidden key frame (show_frame 0, showable): its refresh_frame_flags;
    // shown_existing once a show_existing_frame header names one of them
    int show_frame = 1, showable_frame = 0, refresh_frame_flags = 0xFF, shown_existing = 0;
    int disable_cdf_update = 0, allow_screen_content_tools = 0, allow_intrabc = 0;
    int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
    int tx_mode = 0, reduced_tx_set = 0;
    // lossless: each segment's (LosslessArray), every segment's
    // (CodedLossless; AllLossless is it without superres)
    int lossless_seg[8] = {0}, coded_lossless = 0;
    // segmentation (a key frame updates the map and the data): the
    // features of each segment and their values, SegIdPreSkip,
    // LastActiveSegId (-1: no feature on)
    enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_SKIP = 6 };
    int seg_enabled = 0, seg_feature[8][8] = {{0}}, seg_data[8][8] = {{0}}, seg_preskip = 0,
        last_active_seg = -1;
    // delta q / delta lf
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0,
        delta_lf_multi = 0;
    int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
    int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    int tile_cols = 0, tile_rows = 0, tile_cols_log2 = 0, tile_rows_log2 = 0,
        tile_size_bytes = 4;
    int mi_col_starts[65] = {0}, mi_row_starts[65] = {0};
    bool have_frame_header = false;
    bool header_only = false;  // parse headers of frames after the first, decode nothing
    int tiles_decoded = 0;
    // what the frame used: blocks, palette (luma, chroma), filter intra,
    // CfL, tx_depth > 0, non-DCT_DCT luma transforms, angle deltas
    // (then blocks of a nonzero segment, superblocks with a nonzero delta q,
    // intra block copies; then the filters' counts)
    int64_t stats[14] = {0};
    Cdfs frame_cdfs;
    // frame state
    Plane plane[3];
    // per 4x4: tx_size_ is the specification's InterTxSizes (an intra
    // block's transform size, an intra block copy's transform tree)
    std::vector<uint8_t> mi_size, y_mode, uv_mode, skip_, tx_size_, pal_size[2], tx_type;
    // segment ids, is_inter (an intra block copy), blocks decoded so far,
    // the block vectors (1/8 pel; row, column), deblocking levels (luma
    // vertical, luma horizontal, u, v edges)
    std::vector<uint8_t> seg_ids, is_inter_, decoded_, lf_lvl;
    std::vector<int32_t> mvs;
    std::vector<uint8_t> pal_colors[2];  // 8 per mi
    std::vector<uint8_t> lf_tx_size[3];
    int lf_stride[3] = {0};
    // quantizer matrices: the level per plane (15: none) and per segment
    int using_qm = 0, qm_level[3] = {15, 15, 15}, seg_qm[8][3];
    // CDEF: damping, bits, strengths (y primary, y secondary, uv primary,
    // uv secondary) and each 64x64 block's cdef_idx (-1: not read)
    bool cdef_on = false;
    int cdef_damping = 3, cdef_bits = 0, cdef_strength[8][4] = {{0}};
    std::vector<int8_t> cdef_idx;
    // loop restoration: FrameRestorationType, unit size, units per plane
    int uses_lr = 0, lr_type[3] = {0}, lr_unit_size[3] = {64, 64, 64};
    int lr_rows[3] = {0}, lr_cols[3] = {0};
    struct LrUnit {
        int8_t type = RESTORE_NONE, set = 0;
        int16_t wiener[2][3] = {{0}}, xqd[2] = {0};
    };
    std::vector<LrUnit> lr_units[3];
    // film grain (the frame's parameters; applied to the output only)
    struct FilmGrain {
        int apply = 0, seed = 0, num_y = 0, y_points[14][2] = {{0}}, csfl = 0,
            num_uv[2] = {0}, uv_points[2][10][2] = {{{0}}}, scaling_shift = 8, ar_lag = 0,
            ar_y[24] = {0}, ar_uv[2][25] = {{0}}, ar_shift = 6, grain_scale_shift = 0,
            uv_mult[2] = {0}, uv_luma_mult[2] = {0}, uv_offset[2] = {0}, overlap = 0,
            clip_restricted = 0;
    } fg;

    int mi(int r, int c) const { return r * MiCols + c; }

    // ---- sequence header
    void parse_sequence_header(BitReader& br) {
        profile = int(br.f(3));
        if (profile > 2) fail("AV1 sequence profile %d", profile);
        still = int(br.f(1));
        reduced = int(br.f(1));
        if (reduced && !still) fail("a reduced still-picture header on a sequence that is not a still picture");
        decoder_model_info_present = 0;
        int initial_display_delay_present = 0, buffer_delay_length = 0;
        if (reduced) {
            op_count = 1;
            op_idc[0] = 0;
            br.f(5);  // seq_level_idx
        } else {
            int timing_info_present = int(br.f(1));
            if (timing_info_present) {  // dav1d refuses zero ticks and scales
                if (!br.f(32) || !br.f(32)) fail("AV1 timing info of zero ticks or scale");
                equal_picture_interval = int(br.f(1));
                if (equal_picture_interval && br.uvlc() == 0xFFFFFFFFu)
                    fail("AV1 timing info of 2^32 ticks a picture");
                decoder_model_info_present = int(br.f(1));
                if (decoder_model_info_present) {
                    buffer_delay_length = int(br.f(5)) + 1;
                    if (!br.f(32)) fail("an AV1 decoder model of zero decoding ticks");
                    buffer_removal_time_length = int(br.f(5)) + 1;
                    frame_presentation_time_length = int(br.f(5)) + 1;
                }
            }
            initial_display_delay_present = int(br.f(1));
            op_count = int(br.f(5)) + 1;
            for (int i = 0; i < op_count; i++) {
                op_idc[i] = int(br.f(12));
                // dav1d: an operating point names a temporal and a spatial layer or none
                if (op_idc[i] && (!(op_idc[i] & 0xff) || !(op_idc[i] & 0xf00)))
                    fail("an AV1 operating point of idc 0x%x", op_idc[i]);
                int level = int(br.f(5));
                if (level > 7) br.f(1);
                op_decoder_model_present[i] = 0;
                if (decoder_model_info_present) {
                    op_decoder_model_present[i] = int(br.f(1));
                    if (op_decoder_model_present[i]) {
                        br.f(buffer_delay_length);
                        br.f(buffer_delay_length);
                        br.f(1);
                    }
                }
                if (initial_display_delay_present)
                    if (br.f(1)) br.f(4);
            }
        }
        frame_width_bits = int(br.f(4)) + 1;
        frame_height_bits = int(br.f(4)) + 1;
        max_w = int(br.f(frame_width_bits)) + 1;
        max_h = int(br.f(frame_height_bits)) + 1;
        frame_id_numbers_present = reduced ? 0 : int(br.f(1));
        if (frame_id_numbers_present) {
            int delta = int(br.f(4)) + 2;
            int add = int(br.f(3)) + 1;
            id_len = delta + add;
        }
        use128 = int(br.f(1));
        enable_filter_intra = int(br.f(1));
        enable_intra_edge_filter = int(br.f(1));
        if (reduced) {
            seq_force_screen_content_tools = 2;
            seq_force_integer_mv = 2;
            order_hint_bits = 0;
        } else {
            br.f(4);  // interintra, masked compound, warped motion, dual filter
            int enable_order_hint = int(br.f(1));
            if (enable_order_hint) br.f(2);  // jnt_comp, ref_frame_mvs
            int seq_choose_sct = int(br.f(1));
            seq_force_screen_content_tools = seq_choose_sct ? 2 : int(br.f(1));
            if (seq_force_screen_content_tools > 0) {
                int seq_choose_imv = int(br.f(1));
                seq_force_integer_mv = seq_choose_imv ? 2 : int(br.f(1));
            } else {
                seq_force_integer_mv = 2;
            }
            order_hint_bits = enable_order_hint ? int(br.f(3)) + 1 : 0;
        }
        enable_superres = int(br.f(1));
        enable_cdef = int(br.f(1));
        enable_restoration = int(br.f(1));
        // colour config
        int high_bitdepth = int(br.f(1));
        if (profile == 2 && high_bitdepth) bitdepth = br.f(1) ? 12 : 10;
        else bitdepth = high_bitdepth ? 10 : 8;
        mono = profile == 1 ? 0 : int(br.f(1));
        int desc = int(br.f(1));
        if (desc) {
            cp = int(br.f(8));
            tc = int(br.f(8));
            mc = int(br.f(8));
        } else {
            cp = tc = mc = 2;
        }
        csp = 0;
        if (mono) {
            color_range = int(br.f(1));
            ssx = ssy = 1;
            separate_uv_delta_q = 0;
        } else {
            if (cp == 1 && tc == 13 && mc == 0) {
                color_range = 1;
                ssx = ssy = 0;
            } else {
                color_range = int(br.f(1));
                if (profile == 0) ssx = ssy = 1;
                else if (profile == 1) ssx = ssy = 0;
                else if (bitdepth == 12) {
                    ssx = int(br.f(1));
                    ssy = ssx ? int(br.f(1)) : 0;
                } else {
                    ssx = 1;
                    ssy = 0;
                }
                if (ssx && ssy) csp = int(br.f(2));
            }
            separate_uv_delta_q = int(br.f(1));
        }
        film_grain_present = int(br.f(1));
        num_planes = mono ? 1 : 3;
        have_seq = true;
    }

    // ---- frame header
    static int tile_log2(int blk, int target) { int k = 0; while ((blk << k) < target) k++; return k; }

    int read_delta_q(BitReader& br) { return br.f(1) ? br.su(7) : 0; }

    // a show_existing_frame header (its first bit read): the slot it shows
    int parse_show_existing(BitReader& br) {
        int idx = int(br.f(3));
        if (decoder_model_info_present && !equal_picture_interval)
            br.f(frame_presentation_time_length);
        if (frame_id_numbers_present) br.f(id_len);  // display_frame_id
        return idx;
    }

    void parse_frame_header(BitReader& br, int temporal_id, int spatial_id) {
        if (!have_seq) fail("a frame header before any sequence header");
        int frame_type = 0, error_resilient = 1;
        show_frame = 1;
        showable_frame = 0;
        refresh_frame_flags = 0xFF;
        if (!reduced) {
            if (br.f(1)) unported("show_existing_frame of a frame not decoded before it");
            frame_type = int(br.f(2));
            if (frame_type != 0) unported("a non-key AV1 frame (the port reads key frames)");
            show_frame = int(br.f(1));
            if (show_frame && decoder_model_info_present && !equal_picture_interval)
                br.f(frame_presentation_time_length);
            if (!show_frame) {
                // a hidden key frame, shown later by show_existing_frame
                showable_frame = int(br.f(1));
                if (!showable_frame) unported("a hidden AV1 key frame that no later frame may show");
                error_resilient = int(br.f(1));
            }
        }
        disable_cdf_update = int(br.f(1));
        allow_screen_content_tools = seq_force_screen_content_tools == 2
                                         ? int(br.f(1)) : seq_force_screen_content_tools;
        if (allow_screen_content_tools && seq_force_integer_mv == 2) br.f(1);  // force_integer_mv
        if (frame_id_numbers_present) br.f(id_len);
        int frame_size_override = reduced ? 0 : int(br.f(1));
        br.f(order_hint_bits);
        // primary_ref_frame: none for a key frame
        if (decoder_model_info_present) {
            int present = int(br.f(1));
            if (present) {
                for (int op = 0; op < op_count; op++) {
                    if (!op_decoder_model_present[op]) continue;
                    int idc = op_idc[op];
                    int in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
                    if (idc == 0 || (in_t && in_s)) br.f(buffer_removal_time_length);
                }
            }
        }
        // refresh_frame_flags: all for a shown key frame
        if (!show_frame) {
            refresh_frame_flags = int(br.f(8));
            if (refresh_frame_flags != 0xFF && error_resilient)
                for (int i = 0; i < 8; i++) br.f(order_hint_bits);  // ref_order_hint
        }
        // frame size, superres (7.21: FrameWidth the downscaled width)
        if (frame_size_override) {
            UpW = int(br.f(frame_width_bits)) + 1;
            H = int(br.f(frame_height_bits)) + 1;
        } else {
            UpW = max_w;
            H = max_h;
        }
        use_superres = enable_superres ? int(br.f(1)) : 0;
        superres_denom = use_superres ? int(br.f(3)) + 9 : 8;
        W = imax((UpW * 8 + superres_denom / 2) / superres_denom, imin(16, UpW));
        MiCols = 2 * ((W + 7) >> 3);
        MiRows = 2 * ((H + 7) >> 3);
        if (br.f(1)) { br.f(16); br.f(16); }  // render size
        allow_intrabc = 0;
        if (allow_screen_content_tools && UpW == W) allow_intrabc = int(br.f(1));
        // disable_frame_end_update_cdf
        if (!(reduced || disable_cdf_update)) br.f(1);
        // tile info
        int sb_cols = use128 ? ((MiCols + 31) >> 5) : ((MiCols + 15) >> 4);
        int sb_rows = use128 ? ((MiRows + 31) >> 5) : ((MiRows + 15) >> 4);
        int sb_shift = use128 ? 5 : 4;
        int sb_size = sb_shift + 2;
        int max_tile_width_sb = 4096 >> sb_size;
        int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
        int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
        int max_log2_tile_cols = tile_log2(1, imin(sb_cols, 64));
        int max_log2_tile_rows = tile_log2(1, imin(sb_rows, 64));
        int min_log2_tiles = imax(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
        int uniform = int(br.f(1));
        if (uniform) {
            tile_cols_log2 = min_log2_tile_cols;
            while (tile_cols_log2 < max_log2_tile_cols) {
                if (br.f(1)) tile_cols_log2++;
                else break;
            }
            int tw = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2;
            int i = 0;
            for (int start = 0; start < sb_cols; start += tw) mi_col_starts[i++] = start << sb_shift;
            mi_col_starts[i] = MiCols;
            tile_cols = i;
            int min_log2_tile_rows = imax(min_log2_tiles - tile_cols_log2, 0);
            tile_rows_log2 = min_log2_tile_rows;
            while (tile_rows_log2 < max_log2_tile_rows) {
                if (br.f(1)) tile_rows_log2++;
                else break;
            }
            int th = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2;
            i = 0;
            for (int start = 0; start < sb_rows; start += th) mi_row_starts[i++] = start << sb_shift;
            mi_row_starts[i] = MiRows;
            tile_rows = i;
        } else {
            int widest = 0, start = 0, i;
            for (i = 0; start < sb_cols; i++) {
                if (i >= 64) fail("more than 64 AV1 tile columns");
                mi_col_starts[i] = start << sb_shift;
                int maxw = imin(sb_cols - start, max_tile_width_sb);
                int size = br.ns(maxw) + 1;
                widest = imax(size, widest);
                start += size;
            }
            mi_col_starts[i] = MiCols;
            tile_cols = i;
            tile_cols_log2 = tile_log2(1, tile_cols);
            int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                          : sb_rows * sb_cols;
            int max_tile_height_sb = imax(area / widest, 1);
            start = 0;
            for (i = 0; start < sb_rows; i++) {
                if (i >= 64) fail("more than 64 AV1 tile rows");
                mi_row_starts[i] = start << sb_shift;
                int maxh = imin(sb_rows - start, max_tile_height_sb);
                int size = br.ns(maxh) + 1;
                start += size;
            }
            mi_row_starts[i] = MiRows;
            tile_rows = i;
            tile_rows_log2 = tile_log2(1, tile_rows);
        }
        if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
            br.f(tile_rows_log2 + tile_cols_log2);  // context_update_tile_id
            tile_size_bytes = int(br.f(2)) + 1;
        }
        // quantisation
        base_q_idx = int(br.f(8));
        dq_y_dc = read_delta_q(br);
        dq_u_dc = dq_u_ac = dq_v_dc = dq_v_ac = 0;
        if (num_planes > 1) {
            int diff_uv = separate_uv_delta_q ? int(br.f(1)) : 0;
            dq_u_dc = read_delta_q(br);
            dq_u_ac = read_delta_q(br);
            if (diff_uv) {
                dq_v_dc = read_delta_q(br);
                dq_v_ac = read_delta_q(br);
            } else {
                dq_v_dc = dq_u_dc;
                dq_v_ac = dq_u_ac;
            }
        }
        using_qm = int(br.f(1));
        qm_level[0] = qm_level[1] = qm_level[2] = 15;
        if (using_qm) {
            qm_level[0] = int(br.f(4));
            qm_level[1] = int(br.f(4));
            qm_level[2] = separate_uv_delta_q ? int(br.f(4)) : qm_level[1];
        }
        parse_segmentation(br);
        // delta q / delta lf (delta lf is not read where intra block copy is on)
        delta_q_present = delta_q_res = delta_lf_present = delta_lf_res = delta_lf_multi = 0;
        if (base_q_idx > 0) delta_q_present = int(br.f(1));
        if (delta_q_present) {
            delta_q_res = int(br.f(2));
            if (!allow_intrabc) delta_lf_present = int(br.f(1));
            if (delta_lf_present) {
                delta_lf_res = int(br.f(2));
                delta_lf_multi = int(br.f(1));
            }
        }
        // LosslessArray, CodedLossless, SegQMLevel
        coded_lossless = 1;
        for (int s = 0; s < 8; s++) {
            lossless_seg[s] = seg_qindex(s, base_q_idx) == 0 && dq_y_dc == 0 && dq_u_ac == 0 &&
                              dq_u_dc == 0 && dq_v_ac == 0 && dq_v_dc == 0;
            coded_lossless &= lossless_seg[s];
            for (int p = 0; p < 3; p++) seg_qm[s][p] = lossless_seg[s] ? 15 : qm_level[p];
        }
        // loop filter (none where every segment is lossless or intra block
        // copy is on)
        for (int i = 0; i < 4; i++) lf_level[i] = 0;
        lf_sharpness = 0;
        lf_delta_enabled = 0;
        static const int ref_defaults[8] = {1, 0, 0, 0, -1, 0, -1, -1};
        memcpy(lf_ref_deltas, ref_defaults, sizeof lf_ref_deltas);
        lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
        if (!coded_lossless && !allow_intrabc) {
            lf_level[0] = int(br.f(6));
            lf_level[1] = int(br.f(6));
            if (num_planes > 1 && (lf_level[0] || lf_level[1])) {
                lf_level[2] = int(br.f(6));
                lf_level[3] = int(br.f(6));
            }
            lf_sharpness = int(br.f(3));
            lf_delta_enabled = int(br.f(1));
            if (lf_delta_enabled) {
                if (br.f(1)) {
                    for (int i = 0; i < 8; i++)
                        if (br.f(1)) lf_ref_deltas[i] = br.su(7);
                    for (int i = 0; i < 2; i++)
                        if (br.f(1)) lf_mode_deltas[i] = br.su(7);
                }
            }
        }
        if (coded_lossless) qm_level[0] = qm_level[1] = qm_level[2] = 15;
        // CDEF (none where every segment is lossless or intra block copy is
        // on; cdef_idx is not read)
        cdef_on = !coded_lossless && !allow_intrabc && enable_cdef;
        cdef_damping = 3;
        cdef_bits = 0;
        memset(cdef_strength, 0, sizeof cdef_strength);
        if (cdef_on) {
            cdef_damping = int(br.f(2)) + 3;
            cdef_bits = int(br.f(2));
            for (int i = 0; i < (1 << cdef_bits); i++) {
                cdef_strength[i][0] = int(br.f(4));
                cdef_strength[i][1] = int(br.f(2));
                if (cdef_strength[i][1] == 3) cdef_strength[i][1] = 4;
                if (num_planes > 1) {
                    cdef_strength[i][2] = int(br.f(4));
                    cdef_strength[i][3] = int(br.f(2));
                    if (cdef_strength[i][3] == 3) cdef_strength[i][3] = 4;
                }
            }
        }
        // loop restoration: FrameRestorationType per plane and the unit sizes
        uses_lr = 0;
        for (int i = 0; i < 3; i++) { lr_type[i] = RESTORE_NONE; lr_unit_size[i] = 64; }
        // (AllLossless: CodedLossless without superres)
        if (!(coded_lossless && !use_superres) && !allow_intrabc && enable_restoration) {
            static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                                         RESTORE_SGRPROJ};
            int uses_chroma = 0;
            for (int i = 0; i < num_planes; i++) {
                lr_type[i] = remap[br.f(2)];
                if (lr_type[i] != RESTORE_NONE) { uses_lr = 1; uses_chroma |= i > 0; }
            }
            if (uses_lr) {
                int shift = int(br.f(1));
                if (use128) shift++;
                else if (shift) shift += int(br.f(1));
                lr_unit_size[0] = 64 << shift;
                int uv_shift = (ssx && ssy && uses_chroma) ? int(br.f(1)) : 0;
                lr_unit_size[1] = lr_unit_size[2] = lr_unit_size[0] >> uv_shift;
            }
        }
        // tx mode
        if (coded_lossless) tx_mode = 0;
        else tx_mode = br.f(1) ? 2 : 1;
        reduced_tx_set = int(br.f(1));
        parse_film_grain(br);
        have_frame_header = true;
        if (use_superres && uses_lr)
            unported("superres with loop restoration (its units are counted on the upscaled "
                     "width)");
        if (header_only) return;
        frame_cdfs.init(base_q_idx);
        alloc_frame();
    }

    // segmentation_params of a key frame (primary_ref_frame none: the map
    // and the data are updated); values clamped to the features' ranges
    void parse_segmentation(BitReader& br) {
        static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0}, sgn[8] = {1, 1, 1, 1, 1, 0, 0, 0},
                         mx[8] = {255, 63, 63, 63, 63, 7, 0, 0};
        memset(seg_feature, 0, sizeof seg_feature);
        memset(seg_data, 0, sizeof seg_data);
        seg_enabled = int(br.f(1));
        seg_preskip = 0;
        last_active_seg = -1;
        if (!seg_enabled) return;
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
                if (!br.f(1)) continue;
                seg_feature[i][j] = 1;
                int v = sgn[j] ? br.su(1 + bits[j]) : int(br.f(bits[j]));
                seg_data[i][j] = clip3(sgn[j] ? -mx[j] : 0, mx[j], v);
                last_active_seg = i;
                if (j >= 5) seg_preskip = 1;
            }
    }
    bool seg_active(int s, int feature) const { return seg_enabled && seg_feature[s][feature]; }
    // get_qindex of a segment from a q index (base_q_idx, or CurrentQIndex
    // where delta q is on)
    int seg_qindex(int s, int q) const {
        return seg_active(s, SEG_LVL_ALT_Q) ? clip3(0, 255, q + seg_data[s][SEG_LVL_ALT_Q]) : q;
    }
    // a block's deblocking level for edges i (luma vertical, luma
    // horizontal, u, v; 7.14.4): the frame's level with the block's delta
    // lf, the segment's ALT_LF feature, the intra reference delta
    int block_lf_level(int s, int i, const int* delta_lf) const {
        int delta = delta_lf[delta_lf_multi ? i : 0];
        int l = clip3(0, 63, delta + lf_level[i]);
        if (seg_active(s, SEG_LVL_ALT_LF_Y_V + i)) l = clip3(0, 63, l + seg_data[s][SEG_LVL_ALT_LF_Y_V + i]);
        if (lf_delta_enabled) l = clip3(0, 63, l + lf_ref_deltas[0] * (1 << (l >> 5)));
        return l;
    }

    void alloc_frame() {
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            plane[p].stride = ((MiCols * 4 + 127) & ~127) / (1 << sx) + 160;
            plane[p].rows = ((MiRows * 4 + 127) & ~127) / (1 << sy) + 160;
            plane[p].px.assign(size_t(plane[p].stride) * plane[p].rows, 0);
            lf_stride[p] = (MiCols >> sx) + 34;
            lf_tx_size[p].assign(size_t(lf_stride[p]) * ((MiRows >> sy) + 34), 0);
        }
        size_t n = size_t(MiRows) * MiCols;
        mi_size.assign(n, 0); y_mode.assign(n, 0); uv_mode.assign(n, 0); skip_.assign(n, 0);
        tx_size_.assign(n, 0); tx_type.assign(n, 0);
        seg_ids.assign(n, 0); is_inter_.assign(n, 0); decoded_.assign(n, 0);
        lf_lvl.assign(n * 4, 0); mvs.assign(n * 2, 0);
        for (int p = 0; p < 2; p++) { pal_size[p].assign(n, 0); pal_colors[p].assign(n * 8, 0); }
        tiles_decoded = 0;
        cdef_idx.assign(size_t((MiRows + 15) >> 4) * ((MiCols + 15) >> 4), -1);
        for (int p = 0; p < num_planes; p++) {
            lr_units[p].clear();
            lr_rows[p] = lr_cols[p] = 0;
            if (lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            lr_rows[p] = lr_count(lr_unit_size[p], round2(H, sy));
            lr_cols[p] = lr_count(lr_unit_size[p], round2(W, sx));
            lr_units[p].assign(size_t(lr_rows[p]) * lr_cols[p], LrUnit());
        }
    }
    static int lr_count(int unit, int size) { return imax((size + (unit >> 1)) / unit, 1); }

    // ---- film grain parameters (dav1d's parse_film_grain_data checks)
    void parse_film_grain(BitReader& br) {
        fg = FilmGrain();
        if (!film_grain_present || (!show_frame && !showable_frame)) return;
        fg.apply = int(br.f(1));
        if (!fg.apply) return;
        fg.seed = int(br.f(16));
        fg.num_y = int(br.f(4));
        if (fg.num_y > 14) fail("AV1 film grain of %d luma points", fg.num_y);
        for (int i = 0; i < fg.num_y; i++) {
            fg.y_points[i][0] = int(br.f(8));
            if (i && fg.y_points[i - 1][0] >= fg.y_points[i][0])
                fail("AV1 film grain luma points out of order");
            fg.y_points[i][1] = int(br.f(8));
        }
        fg.csfl = mono ? 0 : int(br.f(1));
        if (!(mono || fg.csfl || (ssx && ssy && !fg.num_y))) {
            for (int pl = 0; pl < 2; pl++) {
                fg.num_uv[pl] = int(br.f(4));
                if (fg.num_uv[pl] > 10) fail("AV1 film grain of %d chroma points", fg.num_uv[pl]);
                for (int i = 0; i < fg.num_uv[pl]; i++) {
                    fg.uv_points[pl][i][0] = int(br.f(8));
                    if (i && fg.uv_points[pl][i - 1][0] >= fg.uv_points[pl][i][0])
                        fail("AV1 film grain chroma points out of order");
                    fg.uv_points[pl][i][1] = int(br.f(8));
                }
            }
        }
        if (ssx && ssy && !!fg.num_uv[0] != !!fg.num_uv[1])
            fail("AV1 film grain points on one 4:2:0 chroma plane only");
        fg.scaling_shift = int(br.f(2)) + 8;
        fg.ar_lag = int(br.f(2));
        int num_pos = 2 * fg.ar_lag * (fg.ar_lag + 1);
        if (fg.num_y)
            for (int i = 0; i < num_pos; i++) fg.ar_y[i] = int(br.f(8)) - 128;
        for (int pl = 0; pl < 2; pl++)
            if (fg.num_uv[pl] || fg.csfl) {
                int n = num_pos + (fg.num_y ? 1 : 0);
                for (int i = 0; i < n; i++) fg.ar_uv[pl][i] = int(br.f(8)) - 128;
            }
        fg.ar_shift = int(br.f(2)) + 6;
        fg.grain_scale_shift = int(br.f(2));
        for (int pl = 0; pl < 2; pl++)
            if (fg.num_uv[pl]) {
                fg.uv_mult[pl] = int(br.f(8)) - 128;
                fg.uv_luma_mult[pl] = int(br.f(8)) - 128;
                fg.uv_offset[pl] = int(br.f(9)) - 256;
            }
        fg.overlap = int(br.f(1));
        fg.clip_restricted = int(br.f(1));
    }

    // ---- tile groups
    void parse_tile_group(const uint8_t* d, size_t n) {
        if (!have_frame_header) fail("an AV1 tile group before its frame header");
        BitReader br(d, n);
        int num_tiles = tile_cols * tile_rows;
        int start = 0, end = num_tiles - 1;
        if (num_tiles > 1 && br.f(1)) {
            int bits = tile_cols_log2 + tile_rows_log2;
            start = int(br.f(bits));
            end = int(br.f(bits));
        }
        br.byte_align();
        size_t pos = br.pos >> 3;
        if (start != tiles_decoded || end < start || end >= num_tiles)
            fail("AV1 tile group of tiles %d-%d after %d tiles", start, end, tiles_decoded);
        for (int t = start; t <= end; t++) {
            size_t size;
            if (t == end) {
                if (pos > n) fail("an AV1 tile group ends inside its header");
                size = n - pos;
            } else {
                if (pos + tile_size_bytes > n) fail("AV1 tile sizes run past the tile group");
                size_t s = 0;
                for (int i = 0; i < tile_size_bytes; i++) s |= size_t(d[pos + i]) << (8 * i);
                pos += tile_size_bytes;
                size = s + 1;
                if (pos + size > n) fail("an AV1 tile runs past its tile group");
            }
            decode_tile(t / tile_cols, t % tile_cols, d + pos, int64_t(size));
            pos += size;
        }
        tiles_decoded = end + 1;
    }

    // ---- per-tile decoding
    struct Tile;
    void decode_tile(int tile_row, int tile_col, const uint8_t* data, int64_t size);

    // ---- loop filter, CDEF, loop restoration, film grain
    void cdef();
    void loop_restoration(const Plane* pre_cdef);
    void film_grain(pixel* const out[3]);
    void superres_upscale();
    void loop_filter();
    void edge_filter(int p, int pass, int row, int col);
    void filter_level(int l, int* limit, int* blimit, int* thresh);
};

// tile-level state
struct Decoder::Tile {
    Decoder& f;
    SymbolDecoder sd;
    Cdfs cdf;
    int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    uint8_t block_decoded[3][35][35];  // [plane][y + 1][x + 1]
    // current block
    int mi_row = 0, mi_col = 0, mi_sz = 0, bw4 = 0, bh4 = 0;
    bool has_chroma = false, avail_u = false, avail_l = false, avail_u_chroma = false,
         avail_l_chroma = false;
    int skip = 0, ymode = 0, uvmode = 0, angle_delta_y = 0, angle_delta_uv = 0;
    int cfl_alpha_u = 0, cfl_alpha_v = 0, use_filter_intra = 0, filter_intra_mode = 0;
    int pal_size_y = 0, pal_size_uv = 0;
    uint8_t pal_y[8], pal_u[8], pal_v[8];
    uint8_t color_map_y[64 * 64], color_map_uv[64 * 64];  // stride 64
    int txsz = 0, max_luma_w = 0, max_luma_h = 0;
    int32_t quant[1024];
    int plane_tx_type = 0;
    // segmentation and delta q / lf: the block's segment, Lossless and q
    // index; the tile's CurrentQIndex and DeltaLF (dav1d's, which start
    // each tile afresh), ReadDeltas
    int seg_id = 0, lossless = 0, qindex = 0, cur_qidx = 0, delta_lf[4] = {0, 0, 0, 0};
    bool read_deltas = false;
    // intra block copy: the block's flag (is_inter) and vector (1/8 pel)
    int use_intrabc = 0, mv_r = 0, mv_c = 0;

    Tile(Decoder& d) : f(d) {}

    bool is_inside(int r, int c) const {
        return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
    }

    void run(int tr, int tc, const uint8_t* data, int64_t size) {
        mi_row_start = f.mi_row_starts[tr];
        mi_row_end = f.mi_row_starts[tr + 1];
        mi_col_start = f.mi_col_starts[tc];
        mi_col_end = f.mi_col_starts[tc + 1];
        memcpy(&cdf, &f.frame_cdfs, sizeof cdf);
        sd.init(data, size, f.disable_cdf_update);
        for (int p = 0; p < f.num_planes; p++) {
            above_level[p].assign(size_t(f.MiCols) + 64, 0);
            above_dc[p].assign(size_t(f.MiCols) + 64, 0);
            left_level[p].assign(size_t(f.MiRows) + 64, 0);
            left_dc[p].assign(size_t(f.MiRows) + 64, 0);
        }
        static const int wiener_mid[3] = {3, -7, 15};
        for (int p = 0; p < 3; p++) {
            ref_xqd[p][0] = -32;
            ref_xqd[p][1] = 31;
            for (int pass = 0; pass < 2; pass++)
                for (int i = 0; i < 3; i++) ref_wiener[p][pass][i] = wiener_mid[i];
        }
        int sb = f.use128 ? BLOCK_128X128 : BLOCK_64X64;
        int sb4 = kBw[sb] >> 2;
        cur_qidx = f.base_q_idx;
        for (int i = 0; i < 4; i++) delta_lf[i] = 0;
        for (int r = mi_row_start; r < mi_row_end; r += sb4) {
            for (int p = 0; p < f.num_planes; p++) {
                std::fill(left_level[p].begin(), left_level[p].end(), 0);
                std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
            }
            for (int c = mi_col_start; c < mi_col_end; c += sb4) {
                clear_cdef(r, c);
                clear_block_decoded(r, c, sb4);
                read_lr(r, c, sb);
                read_deltas = f.delta_q_present;
                decode_partition(r, c, sb);
            }
            // dav1d's overread check after each superblock row: 15 bits or
            // more read past the end of the tile's data is an error
            if (sd.maxbits <= -15) fail("AV1 tile data end inside superblock row %d", r);
        }
    }

    // ---- CDEF indices: one per 64x64 block that holds a non-skip block
    int8_t& cdef_at(int r, int c) { return f.cdef_idx[size_t(r >> 4) * ((f.MiCols + 15) >> 4) + (c >> 4)]; }

    void clear_cdef(int r, int c) {
        cdef_at(r, c) = -1;
        if (f.use128) {
            if (c + 16 < f.MiCols) cdef_at(r, c + 16) = -1;
            if (r + 16 < f.MiRows) {
                cdef_at(r + 16, c) = -1;
                if (c + 16 < f.MiCols) cdef_at(r + 16, c + 16) = -1;
            }
        }
    }

    void read_cdef() {
        if (skip || !f.cdef_on) return;
        int r = mi_row & ~15, c = mi_col & ~15;
        if (cdef_at(r, c) != -1) return;
        int idx = sd.lit(f.cdef_bits);
        for (int y = r; y < r + bh4; y += 16)
            for (int x = c; x < c + bw4; x += 16)
                if (y < f.MiRows && x < f.MiCols) cdef_at(y, x) = int8_t(idx);
    }

    // ---- loop-restoration coefficients of the units a superblock starts
    int ref_wiener[3][2][3], ref_xqd[3][2];

    int subexp(int num_syms, int k) {
        int i = 0, mk = 0;
        for (;;) {
            int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (num_syms <= mk + 3 * a) return sd.ns(num_syms - mk) + mk;
            if (!sd.lit(1)) return sd.lit(b2) + mk;
            i++;
            mk += a;
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
    }
    int signed_subexp_ref(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int v = subexp(mx, k);
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }

    void read_lr(int r, int c, int b) {
        int w = kBw[b] >> 2, h = kBh[b] >> 2;
        for (int p = 0; p < f.num_planes; p++) {
            if (f.lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            int unit = f.lr_unit_size[p];
            int row0 = (r * (4 >> sy) + unit - 1) / unit;
            int row1 = imin(f.lr_rows[p], ((r + h) * (4 >> sy) + unit - 1) / unit);
            int col0 = (c * (4 >> sx) + unit - 1) / unit;
            int col1 = imin(f.lr_cols[p], ((c + w) * (4 >> sx) + unit - 1) / unit);
            for (int ur = row0; ur < row1; ur++)
                for (int uc = col0; uc < col1; uc++) read_lr_unit(p, f.lr_units[p][size_t(ur) * f.lr_cols[p] + uc]);
        }
    }

    void read_lr_unit(int p, LrUnit& u) {
        static const int wmin[3] = {-5, -23, -17}, wmax[3] = {10, 8, 46}, wk[3] = {1, 2, 3};
        static const int xmin[2] = {-96, -32}, xmax[2] = {31, 95};
        int type;
        if (f.lr_type[p] == RESTORE_WIENER) type = sd.read(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (f.lr_type[p] == RESTORE_SGRPROJ) type = sd.read(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else type = sd.read(cdf.restoration_type, 3);  // none, Wiener, self-guided
        u.type = int8_t(type);
        if (type == RESTORE_WIENER) {
            for (int pass = 0; pass < 2; pass++) {
                int first = p ? 1 : 0;
                u.wiener[pass][0] = 0;
                for (int j = first; j < 3; j++) {
                    int v = signed_subexp_ref(wmin[j], wmax[j] + 1, wk[j], ref_wiener[p][pass][j]);
                    u.wiener[pass][j] = int16_t(v);
                    ref_wiener[p][pass][j] = v;
                }
            }
        } else if (type == RESTORE_SGRPROJ) {
            int set = sd.lit(4);
            u.set = int8_t(set);
            for (int i = 0; i < 2; i++) {
                int radius = av1_sgr_params[set][i * 2];
                int v;
                if (radius) v = signed_subexp_ref(xmin[i], xmax[i] + 1, 4, ref_xqd[p][i]);
                else v = i == 1 ? clip3(xmin[i], xmax[i], 128 - ref_xqd[p][0]) : 0;
                u.xqd[i] = int16_t(v);
                ref_xqd[p][i] = v;
            }
        }
    }

    void clear_block_decoded(int r, int c, int sb4) {
        for (int p = 0; p < f.num_planes; p++) {
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); y++)
                for (int x = -1; x <= (sb4 >> sx); x++) {
                    uint8_t v;
                    if (y < 0 && x < sbw4) v = 1;
                    else if (x < 0 && y < sbh4) v = 1;
                    else v = 0;
                    block_decoded[p][y + 1][x + 1] = v;
                }
            block_decoded[p][(sb4 >> sy) + 1][0] = 0;
        }
    }

    uint16_t* partition_cdf(int bsl, int ctx, int* n) {
        switch (bsl) {
            case 1: *n = 4; return cdf.partition8[ctx];
            case 2: *n = 10; return cdf.partition16[ctx];
            case 3: *n = 10; return cdf.partition32[ctx];
            case 4: *n = 10; return cdf.partition64[ctx];
            default: *n = 8; return cdf.partition128[ctx];
        }
    }

    void decode_partition(int r, int c, int b) {
        if (r >= f.MiRows || c >= f.MiCols) return;
        bool au = is_inside(r - 1, c), al = is_inside(r, c - 1);
        int num4 = kBw[b] >> 2, half = num4 >> 1, quarter = half >> 1;
        bool has_rows = (r + half) < f.MiRows, has_cols = (c + half) < f.MiCols;
        int partition;
        if (b < BLOCK_8X8) {
            partition = PARTITION_NONE;
        } else {
            int bsl = mi_wlog2(b);
            int above = au && mi_wlog2(f.mi_size[f.mi(r - 1, c)]) < bsl;
            int left = al && mi_hlog2(f.mi_size[f.mi(r, c - 1)]) < bsl;
            int ctx = left * 2 + above, n;
            uint16_t* pc = partition_cdf(bsl, ctx, &n);
            auto prob = [&](int k) -> int {  // P(symbol k) from the inverted CDF
                if (k >= n) return 0;
                int hi = k == 0 ? 32768 : pc[k - 1];
                int lo = k == n - 1 ? 0 : pc[k];
                return hi - lo;
            };
            if (has_rows && has_cols) {
                partition = sd.read(pc, n);
            } else if (has_cols) {
                int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT);
                if (b != BLOCK_8X8) {
                    psum += prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
                    if (b != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
                }
                uint16_t c2[2] = {uint16_t(psum), 0};
                partition = sd.read(c2, 2, false) ? PARTITION_SPLIT : PARTITION_HORZ;
            } else if (has_rows) {
                int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT);
                if (b != BLOCK_8X8) {
                    psum += prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
                    if (b != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
                }
                uint16_t c2[2] = {uint16_t(psum), 0};
                partition = sd.read(c2, 2, false) ? PARTITION_SPLIT : PARTITION_VERT;
            } else {
                partition = PARTITION_SPLIT;
            }
        }
        int sub = partition_subsize(partition, b);
        int split = partition_subsize(PARTITION_SPLIT, b);
        // dav1d refuses vertical partitions in 4:2:2 (decode_sb)
        if (f.num_planes > 1 && f.ssx && !f.ssy &&
            (partition == PARTITION_VERT || partition == PARTITION_VERT_4 ||
             partition == PARTITION_VERT_A || partition == PARTITION_VERT_B))
            fail("a vertical AV1 partition (%d) of a %dx%d block in 4:2:2", partition, kBw[b], kBh[b]);
        switch (partition) {
            case PARTITION_NONE: decode_block(r, c, sub); break;
            case PARTITION_HORZ:
                decode_block(r, c, sub);
                if (has_rows) decode_block(r + half, c, sub);
                break;
            case PARTITION_VERT:
                decode_block(r, c, sub);
                if (has_cols) decode_block(r, c + half, sub);
                break;
            case PARTITION_SPLIT:
                decode_partition(r, c, sub);
                decode_partition(r, c + half, sub);
                decode_partition(r + half, c, sub);
                decode_partition(r + half, c + half, sub);
                break;
            case PARTITION_HORZ_A:
                decode_block(r, c, split);
                decode_block(r, c + half, split);
                decode_block(r + half, c, sub);
                break;
            case PARTITION_HORZ_B:
                decode_block(r, c, sub);
                decode_block(r + half, c, split);
                decode_block(r + half, c + half, split);
                break;
            case PARTITION_VERT_A:
                decode_block(r, c, split);
                decode_block(r + half, c, split);
                decode_block(r, c + half, sub);
                break;
            case PARTITION_VERT_B:
                decode_block(r, c, sub);
                decode_block(r, c + half, split);
                decode_block(r + half, c + half, split);
                break;
            case PARTITION_HORZ_4:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < f.MiRows) decode_block(r + quarter * i, c, sub);
                break;
            default:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || c + quarter * 3 < f.MiCols) decode_block(r, c + quarter * i, sub);
                break;
        }
    }

    int residual_size(int b, int p) {
        if (p == 0) return b;
        int w = imax(4, kBw[b] >> f.ssx), h = imax(4, kBh[b] >> f.ssy);
        int r = block_of(w, h);
        if (r == BLOCK_INVALID) fail("a %dx%d block has no chroma block in this subsampling", kBw[b], kBh[b]);
        return r;
    }

    void decode_block(int r, int c, int b) {
        mi_row = r;
        mi_col = c;
        mi_sz = b;
        bw4 = kBw[b] >> 2;
        bh4 = kBh[b] >> 2;
        if (bh4 == 1 && f.ssy && (r & 1) == 0) has_chroma = false;
        else if (bw4 == 1 && f.ssx && (c & 1) == 0) has_chroma = false;
        else has_chroma = f.num_planes > 1;
        avail_u = is_inside(r - 1, c);
        avail_l = is_inside(r, c - 1);
        avail_u_chroma = avail_u;
        avail_l_chroma = avail_l;
        if (has_chroma) {
            if (f.ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
            if (f.ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
        } else {
            avail_u_chroma = avail_l_chroma = false;
        }
        intra_frame_mode_info();
        palette_tokens();
        if (use_intrabc) read_block_tx_size_inter();
        else read_tx_size();
        // store the block's mode info
        int lvl[4];
        for (int i = 0; i < 4; i++) lvl[i] = f.block_lf_level(seg_id, i, delta_lf);
        for (int y = 0; y < bh4; y++) {
            if (r + y >= f.MiRows) break;
            for (int x = 0; x < bw4; x++) {
                if (c + x >= f.MiCols) break;
                int i = f.mi(r + y, c + x);
                f.y_mode[i] = uint8_t(ymode);
                if (has_chroma) f.uv_mode[i] = uint8_t(uvmode);
                f.mi_size[i] = uint8_t(b);
                f.skip_[i] = uint8_t(skip);
                if (!use_intrabc) f.tx_size_[i] = uint8_t(txsz);  // else written by its tree
                f.pal_size[0][i] = uint8_t(pal_size_y);
                f.pal_size[1][i] = uint8_t(pal_size_uv);
                memcpy(&f.pal_colors[0][size_t(i) * 8], pal_y, 8);
                memcpy(&f.pal_colors[1][size_t(i) * 8], pal_u, 8);
                f.seg_ids[i] = uint8_t(seg_id);
                f.is_inter_[i] = uint8_t(use_intrabc);
                f.decoded_[i] = 1;
                f.mvs[2 * size_t(i)] = mv_r;
                f.mvs[2 * size_t(i) + 1] = mv_c;
                for (int k = 0; k < 4; k++) f.lf_lvl[4 * size_t(i) + k] = uint8_t(lvl[k]);
            }
        }
        if (skip) reset_block_context();
        f.stats[0]++;
        f.stats[1] += pal_size_y > 0;
        f.stats[2] += pal_size_uv > 0;
        f.stats[3] += use_filter_intra;
        f.stats[4] += uvmode == UV_CFL_PRED && has_chroma;
        f.stats[7] += angle_delta_y != 0 || angle_delta_uv != 0;
        f.stats[8] += seg_id != 0;
        f.stats[10] += use_intrabc;
        if (use_intrabc) predict_intrabc();
        residual();
    }

    void reset_block_context() {
        for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++) { above_level[p][i] = 0; above_dc[p][i] = 0; }
            for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++) { left_level[p][i] = 0; left_dc[p][i] = 0; }
        }
    }

    void intra_frame_mode_info() {
        // the segment id before or after skip (SegIdPreSkip); skip (the
        // segment's skip feature sets it)
        skip = 0;
        seg_id = 0;
        if (f.seg_enabled && f.seg_preskip) read_segment_id();
        if (f.seg_preskip && f.seg_active(seg_id, Decoder::SEG_LVL_SKIP)) {
            skip = 1;
        } else {
            int ctx = (avail_u ? f.skip_[f.mi(mi_row - 1, mi_col)] : 0) +
                      (avail_l ? f.skip_[f.mi(mi_row, mi_col - 1)] : 0);
            skip = sd.read(cdf.skip[ctx], 2);
        }
        if (f.seg_enabled && !f.seg_preskip) read_segment_id();
        lossless = f.lossless_seg[seg_id];
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        qindex = f.seg_qindex(seg_id, f.delta_q_present ? cur_qidx : f.base_q_idx);
        use_intrabc = f.allow_intrabc ? sd.read(cdf.intrabc, 2) : 0;
        mv_r = mv_c = 0;
        if (use_intrabc) {
            // an inter block of the current frame: no intra modes, palettes
            // or filter intra; later blocks read DC_PRED as its modes
            ymode = uvmode = DC_PRED;
            angle_delta_y = angle_delta_uv = 0;
            cfl_alpha_u = cfl_alpha_v = 0;
            pal_size_y = pal_size_uv = 0;
            memset(pal_y, 0, 8); memset(pal_u, 0, 8); memset(pal_v, 0, 8);
            use_filter_intra = 0;
            intrabc_vector();
            return;
        }
        // y mode
        int am = kIntraModeContext[avail_u ? int(f.y_mode[f.mi(mi_row - 1, mi_col)]) : 0];
        int lm = kIntraModeContext[avail_l ? int(f.y_mode[f.mi(mi_row, mi_col - 1)]) : 0];
        ymode = sd.read(cdf.kf_y_mode[am][lm], 13);
        angle_delta_y = 0;
        if (mi_sz >= BLOCK_8X8 && ymode >= V_PRED && ymode <= D67_PRED)
            angle_delta_y = sd.read(cdf.angle_delta[ymode - V_PRED], 7) - 3;
        uvmode = DC_PRED;
        angle_delta_uv = 0;
        cfl_alpha_u = cfl_alpha_v = 0;
        if (has_chroma) {
            bool cfl_allowed;
            if (lossless && residual_size(mi_sz, 1) == BLOCK_4X4) cfl_allowed = true;
            else if (!lossless && imax(kBw[mi_sz], kBh[mi_sz]) <= 32) cfl_allowed = true;
            else cfl_allowed = false;
            if (cfl_allowed) uvmode = sd.read(cdf.uv_mode_cfl_allowed[ymode], 14);
            else uvmode = sd.read(cdf.uv_mode_cfl_not_allowed[ymode], 13);
            if (uvmode == UV_CFL_PRED) read_cfl_alphas();
            if (mi_sz >= BLOCK_8X8 && uvmode >= V_PRED && uvmode <= D67_PRED)
                angle_delta_uv = sd.read(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
        }
        pal_size_y = pal_size_uv = 0;
        memset(pal_y, 0, 8); memset(pal_u, 0, 8); memset(pal_v, 0, 8);
        if (mi_sz >= BLOCK_8X8 && kBw[mi_sz] <= 64 && kBh[mi_sz] <= 64 && f.allow_screen_content_tools)
            palette_mode_info();
        use_filter_intra = 0;
        if (f.enable_filter_intra && ymode == DC_PRED && pal_size_y == 0 &&
            imax(kBw[mi_sz], kBh[mi_sz]) <= 32) {
            use_filter_intra = sd.read(cdf.use_filter_intra[mi_sz], 2);
            if (use_filter_intra) filter_intra_mode = sd.read(cdf.filter_intra_mode, 5);
        }
    }

    // ---- segment ids (5.11.9): predicted from the above, left and
    // above-left blocks; read where the block is not skipped
    static int neg_deinterleave(int diff, int ref, int max) {
        if (!ref) return diff;
        if (ref >= max - 1) return max - diff - 1;
        if (2 * ref < max) {
            if (diff <= 2 * ref) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
            return diff;
        }
        if (diff <= 2 * (max - ref - 1)) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return max - (diff + 1);
    }

    void read_segment_id() {
        int ul = avail_u && avail_l ? f.seg_ids[f.mi(mi_row - 1, mi_col - 1)] : -1;
        int u = avail_u ? f.seg_ids[f.mi(mi_row - 1, mi_col)] : -1;
        int l = avail_l ? f.seg_ids[f.mi(mi_row, mi_col - 1)] : -1;
        int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : (ul == u ? u : l);
        if (skip) {
            seg_id = pred;
            return;
        }
        int ctx = ul < 0 || u < 0 || l < 0 ? 0 : (ul == u && ul == l) ? 2
                  : (ul == u || ul == l || u == l) ? 1 : 0;
        int diff = sd.read(cdf.seg_id[ctx], 8);
        int id = neg_deinterleave(diff, pred, f.last_active_seg + 1);
        seg_id = id < 0 || id > f.last_active_seg ? 0 : id;  // dav1d's, where the spec clamps
    }

    // ---- delta q and delta lf, read at a superblock's first block unless
    // it is the whole superblock and skipped
    int delta_abs(uint16_t* cdf_) {
        int a = sd.read(cdf_, 4);
        if (a == 3) {
            int nb = sd.lit(3) + 1;
            a = sd.lit(nb) + (1 << nb) + 1;
        }
        return a && sd.lit(1) ? -a : a;
    }

    void read_delta_qindex() {
        if (!read_deltas || (mi_sz == (f.use128 ? BLOCK_128X128 : BLOCK_64X64) && skip)) return;
        int d = delta_abs(cdf.delta_q);
        if (d) {
            cur_qidx = clip3(1, 255, cur_qidx + d * (1 << f.delta_q_res));
            f.stats[9]++;
        }
    }

    void read_delta_lf() {
        if (!read_deltas || !f.delta_lf_present ||
            (mi_sz == (f.use128 ? BLOCK_128X128 : BLOCK_64X64) && skip))
            return;
        int n = f.delta_lf_multi ? (f.num_planes > 1 ? 4 : 2) : 1;
        for (int i = 0; i < n; i++) {
            int d = delta_abs(f.delta_lf_multi ? cdf.delta_lf[1 + i] : cdf.delta_lf[0]);
            if (d) delta_lf[i] = clip3(-63, 63, delta_lf[i] + d * (1 << f.delta_lf_res));
        }
    }

    void read_cfl_alphas() {
        int signs = sd.read(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
            int a = 1 + sd.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
            cfl_alpha_u = sign_u == 1 ? -a : a;
        }
        if (sign_v) {
            int a = 1 + sd.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
            cfl_alpha_v = sign_v == 1 ? -a : a;
        }
    }

    int palette_cache(int p, uint8_t* cache) {
        int above_n = 0, left_n = 0;
        if ((mi_row * 4) % 64 && avail_u) above_n = f.pal_size[p][f.mi(mi_row - 1, mi_col)];
        if (avail_l) left_n = f.pal_size[p][f.mi(mi_row, mi_col - 1)];
        const uint8_t* ac = avail_u ? &f.pal_colors[p][size_t(f.mi(mi_row - 1, mi_col)) * 8] : nullptr;
        const uint8_t* lc = avail_l ? &f.pal_colors[p][size_t(f.mi(mi_row, mi_col - 1)) * 8] : nullptr;
        int ai = 0, li = 0, n = 0;
        while (ai < above_n && li < left_n) {
            int a = ac[ai], l = lc[li];
            if (l < a) {
                if (n == 0 || l != cache[n - 1]) cache[n++] = uint8_t(l);
                li++;
            } else {
                if (n == 0 || a != cache[n - 1]) cache[n++] = uint8_t(a);
                ai++;
                if (l == a) li++;
            }
        }
        while (ai < above_n) { int v = ac[ai++]; if (n == 0 || v != cache[n - 1]) cache[n++] = uint8_t(v); }
        while (li < left_n) { int v = lc[li++]; if (n == 0 || v != cache[n - 1]) cache[n++] = uint8_t(v); }
        return n;
    }

    // a palette's colours are literals of BitDepth bits: no file made here
    // holds one above 8 bits, so the port reads 8-bit palettes only
    [[noreturn]] void unported_palette() {
        unported(f.bitdepth == 10 ? "a palette at a bit depth of 10 (the port reads 8-bit palettes)"
                                  : "a palette at a bit depth of 12 (the port reads 8-bit palettes)");
    }

    void palette_mode_info() {
        int bctx = mi_wlog2(mi_sz) + mi_hlog2(mi_sz) - 2;
        const int bd = 8;
        if (ymode == DC_PRED) {
            int ctx = (avail_u && f.pal_size[0][f.mi(mi_row - 1, mi_col)] > 0) +
                      (avail_l && f.pal_size[0][f.mi(mi_row, mi_col - 1)] > 0);
            if (sd.read(cdf.palette_y_mode[bctx][ctx], 2)) {
                if (f.bitdepth > 8) unported_palette();
                pal_size_y = sd.read(cdf.palette_y_size[bctx], 7) + 2;
                uint8_t cache[16];
                int cn = palette_cache(0, cache), idx = 0;
                for (int i = 0; i < cn && idx < pal_size_y; i++)
                    if (sd.lit(1)) pal_y[idx++] = cache[i];
                if (idx < pal_size_y) pal_y[idx++] = uint8_t(sd.lit(bd));
                int pbits = 0;
                if (idx < pal_size_y) pbits = bd - 3 + sd.lit(2);
                while (idx < pal_size_y) {
                    int delta = sd.lit(pbits) + 1;
                    pal_y[idx] = uint8_t(imin(255, pal_y[idx - 1] + delta));
                    int range = (1 << bd) - pal_y[idx] - 1;
                    pbits = imin(pbits, ceillog2(range));
                    idx++;
                }
                std::sort(pal_y, pal_y + pal_size_y);
            }
        }
        if (has_chroma && uvmode == DC_PRED) {
            int ctx = pal_size_y > 0;
            if (sd.read(cdf.palette_uv_mode[ctx], 2)) {
                if (f.bitdepth > 8) unported_palette();
                pal_size_uv = sd.read(cdf.palette_uv_size[bctx], 7) + 2;
                uint8_t cache[16];
                int cn = palette_cache(1, cache), idx = 0;
                for (int i = 0; i < cn && idx < pal_size_uv; i++)
                    if (sd.lit(1)) pal_u[idx++] = cache[i];
                if (idx < pal_size_uv) pal_u[idx++] = uint8_t(sd.lit(bd));
                int pbits = 0;
                if (idx < pal_size_uv) pbits = bd - 3 + sd.lit(2);
                while (idx < pal_size_uv) {
                    int delta = sd.lit(pbits);
                    pal_u[idx] = uint8_t(imin(255, pal_u[idx - 1] + delta));
                    int range = (1 << bd) - pal_u[idx];
                    idx++;
                    pbits = imin(pbits, ceillog2(range));
                }
                std::sort(pal_u, pal_u + pal_size_uv);
                if (sd.lit(1)) {
                    int min_bits = bd - 4, max_val = 1 << bd;
                    int pb = min_bits + sd.lit(2);
                    pal_v[0] = uint8_t(sd.lit(bd));
                    for (int i = 1; i < pal_size_uv; i++) {
                        int delta = sd.lit(pb);
                        if (delta && sd.lit(1)) delta = -delta;
                        int val = pal_v[i - 1] + delta;
                        if (val < 0) val += max_val;
                        if (val >= max_val) val -= max_val;
                        pal_v[i] = uint8_t(clip3(0, 255, val));
                    }
                } else {
                    for (int i = 0; i < pal_size_uv; i++) pal_v[i] = uint8_t(sd.lit(bd));
                }
            }
        }
    }

    void color_map(uint8_t* map, int n, int bw, int bh, int onw, int onh, bool uv) {
        map[0] = uint8_t(sd.ns(n));
        for (int i = 1; i < onh + onw - 1; i++) {
            for (int j = imin(i, onw - 1); j >= imax(0, i - onh + 1); j--) {
                int r = i - j, c = j;
                int scores[8] = {0}, order[8];
                for (int k = 0; k < 8; k++) order[k] = k;
                if (c > 0) scores[map[r * 64 + c - 1]] += 2;
                if (r > 0 && c > 0) scores[map[(r - 1) * 64 + c - 1]] += 1;
                if (r > 0) scores[map[(r - 1) * 64 + c]] += 2;
                for (int k = 0; k < 3; k++) {
                    int max_score = scores[k], max_idx = k;
                    for (int l = k + 1; l < n; l++)
                        if (scores[l] > max_score) { max_score = scores[l]; max_idx = l; }
                    if (max_idx != k) {
                        int ms = scores[max_idx], mo = order[max_idx];
                        for (int l = max_idx; l > k; l--) { scores[l] = scores[l - 1]; order[l] = order[l - 1]; }
                        scores[k] = ms;
                        order[k] = mo;
                    }
                }
                int hash = 0;
                for (int k = 0; k < 3; k++) hash += scores[k] * kPaletteColorHashMultipliers[k];
                int ctx = kPaletteColorContext[hash];
                uint16_t* pc = uv ? cdf.palette_uv_color[n - 2][ctx] : cdf.palette_y_color[n - 2][ctx];
                int sym = sd.read(pc, n);
                map[r * 64 + c] = uint8_t(order[sym]);
            }
        }
        for (int i = 0; i < onh; i++)
            for (int j = onw; j < bw; j++) map[i * 64 + j] = map[i * 64 + onw - 1];
        for (int i = onh; i < bh; i++)
            for (int j = 0; j < bw; j++) map[i * 64 + j] = map[(onh - 1) * 64 + j];
    }

    void palette_tokens() {
        int bh = kBh[mi_sz], bw = kBw[mi_sz];
        int onh = imin(bh, (f.MiRows - mi_row) * 4), onw = imin(bw, (f.MiCols - mi_col) * 4);
        if (pal_size_y) color_map(color_map_y, pal_size_y, bw, bh, onw, onh, false);
        if (pal_size_uv) {
            bh >>= f.ssy; bw >>= f.ssx; onh >>= f.ssy; onw >>= f.ssx;
            if (bw < 4) { bw += 2; onw += 2; }
            if (bh < 4) { bh += 2; onh += 2; }
            color_map(color_map_uv, pal_size_uv, bw, bh, onw, onh, true);
        }
    }

    void read_tx_size() {
        if (lossless) { txsz = TX_4X4; return; }
        int max_rect = max_tx_rect(mi_sz);
        txsz = max_rect;
        if (mi_sz > BLOCK_4X4 && f.tx_mode == 2) {
            int maxw = kTw[max_rect], maxh = kTh[max_rect];
            int above_w = 0, left_h = 0;  // an intra block copy's: its block size
            if (avail_u) {
                int i = f.mi(mi_row - 1, mi_col);
                above_w = f.is_inter_[i] ? kBw[f.mi_size[i]] : kTw[f.tx_size_[i]];
            }
            if (avail_l) {
                int i = f.mi(mi_row, mi_col - 1);
                left_h = f.is_inter_[i] ? kBh[f.mi_size[i]] : kTh[f.tx_size_[i]];
            }
            int ctx = (avail_u && above_w >= maxw) + (avail_l && left_h >= maxh);
            int depth = tx_depth_of(mi_sz);
            int cat = depth - 1;
            int nsym = imin(depth, 2) + 1;
            uint16_t* pc = cat == 0 ? cdf.tx_size8[ctx] : cat == 1 ? cdf.tx_size16[ctx]
                         : cat == 2 ? cdf.tx_size32[ctx] : cdf.tx_size64[ctx];
            int d = sd.read(pc, nsym);
            f.stats[5] += d > 0;
            for (int i = 0; i < d; i++) txsz = tx_split(txsz);
        }
    }

    // ---- an intra block copy's transform sizes (read_block_tx_size): the
    // txfm_split tree under TX_MODE_SELECT where the block is coded, else
    // the largest (4x4 where lossless)
    void read_block_tx_size_inter() {
        int max_rect = max_tx_rect(mi_sz);
        if (f.tx_mode == 2 && mi_sz > BLOCK_4X4 && !skip && !lossless) {
            int tw4 = kTw[max_rect] >> 2, th4 = kTh[max_rect] >> 2;
            for (int r = mi_row; r < mi_row + bh4; r += th4)
                for (int c = mi_col; c < mi_col + bw4; c += tw4) read_var_tx_size(r, c, max_rect, 0);
            txsz = max_rect;
            return;
        }
        txsz = lossless ? TX_4X4 : max_rect;
        for (int y = 0; y < bh4 && mi_row + y < f.MiRows; y++)
            for (int x = 0; x < bw4 && mi_col + x < f.MiCols; x++)
                f.tx_size_[f.mi(mi_row + y, mi_col + x)] = uint8_t(txsz);
    }

    int above_tx_width(int r, int c) {
        if (r == mi_row) {
            if (!avail_u) return 64;
            int i = f.mi(r - 1, c);
            if (f.skip_[i] && f.is_inter_[i]) return kBw[f.mi_size[i]];
        }
        return kTw[f.tx_size_[f.mi(r - 1, c)]];
    }
    int left_tx_height(int r, int c) {
        if (c == mi_col) {
            if (!avail_l) return 64;
            int i = f.mi(r, c - 1);
            if (f.skip_[i] && f.is_inter_[i]) return kBh[f.mi_size[i]];
        }
        return kTh[f.tx_size_[f.mi(r, c - 1)]];
    }

    void read_var_tx_size(int r, int c, int t, int depth) {
        if (r >= f.MiRows || c >= f.MiCols) return;
        int split = 0;
        if (t != TX_4X4 && depth < 2) {
            int size = imin(64, imax(kBw[mi_sz], kBh[mi_sz]));
            int maxsq = tx_of(size, size);
            int ctx = (tx_sqr_up(t) != maxsq) * 3 + (TX_64X64 - maxsq) * 6 +
                      (above_tx_width(r, c) < kTw[t]) + (left_tx_height(r, c) < kTh[t]);
            split = sd.read(cdf.txfm_split[ctx], 2);
        }
        int w4 = kTw[t] >> 2, h4 = kTh[t] >> 2;
        if (split) {
            f.stats[5]++;
            int sub = tx_split(t), sw = kTw[sub] >> 2, sh = kTh[sub] >> 2;
            for (int i = 0; i < h4; i += sh)
                for (int j = 0; j < w4; j += sw) read_var_tx_size(r + i, c + j, sub, depth + 1);
            return;
        }
        for (int i = 0; i < h4 && r + i < f.MiRows; i++)
            for (int j = 0; j < w4 && c + j < f.MiCols; j++) f.tx_size_[f.mi(r + i, c + j)] = uint8_t(t);
    }

    // ---- an intra block copy's vector: the reference stack of find_mv_stack
    // for INTRA_FRAME (7.10.2: rows and columns of the blocks above and to
    // the left, the top-right and top-left points, weighted and sorted), the
    // predicted vector (the first nonzero of the stack's two, else a
    // default a superblock up or left), the coded difference (integer), then
    // dav1d's clip to the decoded part of the tile. Every stored vector is
    // whole pixels (the clip's), so the specification's rounding of the
    // candidates to whole pixels changes none.
    int nmv = 0, stk[8][2], wgt[8];

    void add_candidate(int r, int c, int weight) {
        int i = f.mi(r, c);
        if (!f.is_inter_[i]) return;
        int mr = f.mvs[2 * size_t(i)], mc = f.mvs[2 * size_t(i) + 1];
        for (int k = 0; k < nmv; k++)
            if (stk[k][0] == mr && stk[k][1] == mc) { wgt[k] += weight; return; }
        if (nmv < 8) {
            stk[nmv][0] = mr;
            stk[nmv][1] = mc;
            wgt[nmv++] = weight;
        }
    }
    void scan_row(int dr) {
        int end4 = imin(imin(bw4, f.MiCols - mi_col), 16), dc = 0;
        bool far = abs(dr) > 1;
        if (far) { dr += mi_row & 1; dc = 1 - (mi_col & 1); }
        for (int i = 0; i < end4;) {
            int r = mi_row + dr, c = mi_col + dc + i;
            if (!is_inside(r, c)) break;
            int len = imin(bw4, kBw[f.mi_size[f.mi(r, c)]] >> 2);
            if (far) len = imax(2, len);
            if (bw4 >= 16) len = imax(4, len);
            add_candidate(r, c, 2 * len);
            i += len;
        }
    }
    void scan_col(int dc) {
        int end4 = imin(imin(bh4, f.MiRows - mi_row), 16), dr = 0;
        bool far = abs(dc) > 1;
        if (far) { dr = 1 - (mi_row & 1); dc += mi_col & 1; }
        for (int i = 0; i < end4;) {
            int r = mi_row + dr + i, c = mi_col + dc;
            if (!is_inside(r, c)) break;
            int len = imin(bh4, kBh[f.mi_size[f.mi(r, c)]] >> 2);
            if (far) len = imax(2, len);
            if (bh4 >= 16) len = imax(4, len);
            add_candidate(r, c, 2 * len);
            i += len;
        }
    }
    void scan_point(int dr, int dc) {  // a block decoded before this one
        int r = mi_row + dr, c = mi_col + dc;
        if (is_inside(r, c) && f.decoded_[f.mi(r, c)]) add_candidate(r, c, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int i = start + 1; i < end; i++)
                if (wgt[i - 1] < wgt[i]) {
                    std::swap(wgt[i - 1], wgt[i]);
                    std::swap(stk[i - 1][0], stk[i][0]);
                    std::swap(stk[i - 1][1], stk[i][1]);
                    new_end = i;
                }
            end = new_end;
        }
    }
    int read_mv_component(Cdfs::MvComponent& m) {
        int sign = sd.read(m.sign, 2);
        int cls = sd.read(m.classes, 11), mag;
        if (cls == 0) {
            mag = ((sd.read(m.class0, 2) << 3) | 7) + 1;
        } else {
            int d = 0;
            for (int i = 0; i < cls; i++) d |= sd.read(m.bits[i], 2) << i;
            mag = (2 << (cls + 2)) + ((d << 3) | 7) + 1;
        }
        return sign ? -mag : mag;
    }

    void intrabc_vector() {
        nmv = 0;
        scan_row(-1);
        scan_col(-1);
        if (imax(bw4, bh4) <= 16) scan_point(-1, bw4);
        int nearest = nmv;
        for (int k = 0; k < nearest; k++) wgt[k] += 640;
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (bh4 > 1) scan_row(-5);
        if (bw4 > 1) scan_col(-5);
        sort_stack(0, nearest);
        sort_stack(nearest, nmv);
        for (int k = nmv; k < 2; k++) stk[k][0] = stk[k][1] = 0;  // GlobalMvs[0]
        for (int k = 0; k < nmv; k++) {  // context_and_clamping
            stk[k][0] = clip3(-(mi_row + bh4 + 4) * 32, (f.MiRows - mi_row + 4) * 32, stk[k][0]);
            stk[k][1] = clip3(-(mi_col + bw4 + 4) * 32, (f.MiCols - mi_col + 4) * 32, stk[k][1]);
        }
        int pr = stk[0][0], pc = stk[0][1];
        if (!pr && !pc) { pr = stk[1][0]; pc = stk[1][1]; }
        int sb4 = f.use128 ? 32 : 16;
        if (!pr && !pc) {
            if (mi_row - sb4 < mi_row_start) { pr = 0; pc = -(sb4 * 4 + 256) * 8; }
            else { pr = -(sb4 * 4 * 8); pc = 0; }
        }
        int joint = sd.read(cdf.mv_joint, 4);
        if (joint == 2 || joint == 3) pr += read_mv_component(cdf.mv[0]);
        if (joint == 1 || joint == 3) pc += read_mv_component(cdf.mv[1]);
        // dav1d's clip of the vector to the decoded part of the tile: left
        // and right tile edges, the top, out of the current superblock
        // (up, else left), not below the superblock row; a vector still in
        // the current superblock fails the decode
        int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
        if (has_chroma) {
            if (bw4 < 2 && f.ssx) border_left += 4;
            if (bh4 < 2 && f.ssy) border_top += 4;
        }
        int left = mi_col * 4 + (pc >> 3), top = mi_row * 4 + (pr >> 3);
        int right = left + bw4 * 4, bottom = top + bh4 * 4;
        int border_right = ((mi_col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
        if (left < border_left) { right += border_left - left; left = border_left; }
        else if (right > border_right) { left -= right - border_right; right = border_right; }
        if (top < border_top) { bottom += border_top - top; top = border_top; }
        int sbx = (mi_col >> (4 + f.use128)) << (6 + f.use128);
        int sby = (mi_row >> (4 + f.use128)) << (6 + f.use128);
        int sbsz = 1 << (6 + f.use128);
        if (bottom > sby && right > sbx) {
            if (top - border_top >= bottom - sby) { top -= bottom - sby; bottom = sby; }
            else if (left - border_left >= right - sbx) { left -= right - sbx; right = sbx; }
        }
        if (bottom > sby + sbsz) { top -= bottom - (sby + sbsz); bottom = sby + sbsz; }
        if (bottom > sby && right > sbx)
            fail("an AV1 intra block copy from its own superblock (block at %d, %d)", mi_row, mi_col);
        mv_c = (left - mi_col * 4) * 8;
        mv_r = (top - mi_row * 4) * 8;
    }

    // ---- an intra block copy's prediction, before the residual: each
    // plane's block (a chroma block covering several luma blocks: this
    // block's vector) from the current frame as decoded so far, bilinear at
    // the half-pel chroma positions of subsampled planes (dav1d's put_bilin;
    // samples past the frame's 8x8 grid repeat its edge)
    void predict_intrabc() {
        static thread_local pixel buf[128 * 128];
        const int ib = f.bitdepth == 12 ? 2 : 4, maxv = (1 << f.bitdepth) - 1;
        for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            int psz = residual_size(mi_sz, p), w = kBw[psz], h = kBh[psz];
            int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
            int ix = x0 + (mv_c >> (3 + sx)), iy = y0 + (mv_r >> (3 + sy));
            int mx = mv_c & (15 >> !sx), my = mv_r & (15 >> !sy);
            mx <<= !sx;
            my <<= !sy;
            int pw = (f.MiCols * 4) >> sx, ph = (f.MiRows * 4) >> sy;
            Plane& pl = f.plane[p];
            auto P = [&](int y, int x) -> int { return *pl.at(clip3(0, ph - 1, y), clip3(0, pw - 1, x)); };
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int y = iy + i, x = ix + j, v;
                    if (mx && my) {
                        int sh = 4 - ib, rnd = (1 << sh) >> 1;
                        int m0 = (16 * P(y, x) + mx * (P(y, x + 1) - P(y, x)) + rnd) >> sh;
                        int m1 = (16 * P(y + 1, x) + mx * (P(y + 1, x + 1) - P(y + 1, x)) + rnd) >> sh;
                        v = clip3(0, maxv, (16 * m0 + my * (m1 - m0) + (1 << (3 + ib))) >> (4 + ib));
                    } else if (mx) {
                        int sh = 4 - ib, rnd = (1 << sh) >> 1;
                        int m = (16 * P(y, x) + mx * (P(y, x + 1) - P(y, x)) + rnd) >> sh;
                        v = clip3(0, maxv, (m + ((1 << ib) >> 1)) >> ib);
                    } else if (my) {
                        v = (16 * P(y, x) + my * (P(y + 1, x) - P(y, x)) + 8) >> 4;
                    } else {
                        v = P(y, x);
                    }
                    buf[i * 128 + j] = pixel(v);
                }
            for (int i = 0; i < h; i++) memcpy(pl.at(y0 + i, x0), &buf[i * 128], sizeof(pixel) * size_t(w));
        }
    }

    int get_tx_size(int p, int t) {
        if (p == 0) return t;
        int uv = max_tx_rect(residual_size(mi_sz, p));
        if (kTw[uv] == 64 || kTh[uv] == 64) {
            if (kTw[uv] == 16) return TX_16X32;
            if (kTh[uv] == 16) return TX_32X16;
            return TX_32X32;
        }
        return uv;
    }

    void residual() {
        int wchunks = imax(1, kBw[mi_sz] >> 6), hchunks = imax(1, kBh[mi_sz] >> 6);
        for (int cy = 0; cy < hchunks; cy++)
            for (int cx = 0; cx < wchunks; cx++) {
                for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
                    if (use_intrabc && !lossless && p == 0) {
                        // the chunk's largest transforms, each down its tree
                        int t = max_tx_rect(mi_sz), tw4 = kTw[t] >> 2, th4 = kTh[t] >> 2;
                        for (int y = cy * 16; y < imin(bh4, cy * 16 + 16); y += th4)
                            for (int x = cx * 16; x < imin(bw4, cx * 16 + 16); x += tw4)
                                transform_tree(mi_row + y, mi_col + x, t);
                        continue;
                    }
                    int t = lossless ? TX_4X4 : get_tx_size(p, txsz);
                    int stepx = kTw[t] >> 2, stepy = kTh[t] >> 2;
                    int psz = residual_size(mi_sz, p);
                    int n4w = kBw[psz] >> 2, n4h = kBh[psz] >> 2;
                    int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
                    int bx = (mi_col >> sx) * 4, by = (mi_row >> sy) * 4;
                    for (int y = 0; y < imin(n4h, 16 >> sy); y += stepy)
                        for (int x = 0; x < imin(n4w, 16 >> sx); x += stepx)
                            transform_block(p, bx, by, t, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                }
            }
    }

    void transform_tree(int r, int c, int t) {
        if (r >= f.MiRows || c >= f.MiCols) return;
        int leaf = f.tx_size_[f.mi(r, c)];
        if (kTw[leaf] >= kTw[t] && kTh[leaf] >= kTh[t]) {
            transform_block(0, c * 4, r * 4, t, 0, 0);
            return;
        }
        int sub = tx_split(t), sw = kTw[sub] >> 2, sh = kTh[sub] >> 2;
        for (int i = 0; i < kTh[t] >> 2; i += sh)
            for (int j = 0; j < kTw[t] >> 2; j += sw) transform_tree(r + i, c + j, sub);
    }

    void transform_block(int p, int base_x, int base_y, int t, int x, int y) {
        int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
        int sb_mask = f.use128 ? 31 : 15;
        int sbr = row & sb_mask, sbc = col & sb_mask;
        int stepx = kTw[t] >> 2, stepy = kTh[t] >> 2;
        int max_x = (f.MiCols * 4) >> sx, max_y = (f.MiRows * 4) >> sy;
        if (start_x >= max_x || start_y >= max_y) return;
        if (use_intrabc) {
            // predicted with the block (predict_intrabc)
        } else if ((p == 0 && pal_size_y) || (p != 0 && pal_size_uv)) {
            predict_palette(p, start_x, start_y, x, y, t);
        } else {
            bool is_cfl = p > 0 && uvmode == UV_CFL_PRED;
            int mode = p == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
            int log2w = floorlog2(uint32_t(kTw[t])), log2h = floorlog2(uint32_t(kTh[t]));
            bool have_left = (p == 0 ? avail_l : avail_l_chroma) || x > 0;
            bool have_above = (p == 0 ? avail_u : avail_u_chroma) || y > 0;
            bool have_ar = block_decoded[p][(sbr >> sy) - 1 + 1][(sbc >> sx) + stepx + 1];
            bool have_bl = block_decoded[p][(sbr >> sy) + stepy + 1][(sbc >> sx) - 1 + 1];
            predict_intra(p, start_x, start_y, have_left, have_above, have_ar, have_bl, mode,
                          log2w, log2h);
            if (is_cfl) predict_cfl(p, start_x, start_y, t);
        }
        if (p == 0) {
            max_luma_w = start_x + stepx * 4;
            max_luma_h = start_y + stepy * 4;
        }
        if (!skip) {
            int eob = coeffs(p, start_x, start_y, t);
            if (eob > 0) reconstruct(p, start_x, start_y, t, eob);
        }
        for (int i = 0; i < stepy; i++)
            for (int j = 0; j < stepx; j++) {
                f.lf_tx_size[p][size_t((row >> sy) + i) * f.lf_stride[p] + (col >> sx) + j] = uint8_t(t);
                block_decoded[p][(sbr >> sy) + i + 1][(sbc >> sx) + j + 1] = 1;
            }
    }

    void predict_palette(int p, int sx0, int sy0, int x, int y, int t) {
        int w = kTw[t], h = kTh[t];
        const uint8_t* pal = p == 0 ? pal_y : p == 1 ? pal_u : pal_v;
        const uint8_t* map = p == 0 ? color_map_y : color_map_uv;
        Plane& pl = f.plane[p];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) *pl.at(sy0 + i, sx0 + j) = pal[map[(y * 4 + i) * 64 + x * 4 + j]];
    }

    // ---- intra prediction
    bool is_smooth(int r, int c, int p) {
        int m = p == 0 ? f.y_mode[f.mi(r, c)] : f.uv_mode[f.mi(r, c)];
        return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    }
    int filter_type(int p) {
        bool as = false, ls = false;
        if (p == 0 ? avail_u : avail_u_chroma) {
            int r = mi_row - 1, c = mi_col;
            if (p > 0) {
                if (f.ssx && !(mi_col & 1)) c++;
                if (f.ssy && (mi_row & 1)) r--;
            }
            as = is_smooth(r, c, p);
        }
        if (p == 0 ? avail_l : avail_l_chroma) {
            int r = mi_row, c = mi_col - 1;
            if (p > 0) {
                if (f.ssx && (mi_col & 1)) c--;
                if (f.ssy && !(mi_row & 1)) r++;
            }
            ls = is_smooth(r, c, p);
        }
        return as || ls;
    }

    static int edge_strength(int w, int h, int type, int delta) {
        int d = delta < 0 ? -delta : delta, wh = w + h, s = 0;
        if (type == 0) {
            if (wh <= 8) { if (d >= 56) s = 1; }
            else if (wh <= 12) { if (d >= 40) s = 1; }
            else if (wh <= 16) { if (d >= 40) s = 1; }
            else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
            else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
            else { if (d >= 1) s = 3; }
        } else {
            if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
            else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
            else if (wh <= 24) { if (d >= 4) s = 3; }
            else { if (d >= 1) s = 3; }
        }
        return s;
    }
    static bool use_upsample(int w, int h, int type, int delta) {
        int d = delta < 0 ? -delta : delta, wh = w + h;
        if (d <= 0 || d >= 40) return false;
        return type == 0 ? wh <= 16 : wh <= 8;
    }
    static void edge_filter(int* buf, int sz, int strength) {  // buf[i - 1] for i = 0..sz-1
        if (!strength) return;
        int edge[300];
        for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
        for (int i = 1; i < sz; i++) {
            int s = 0;
            for (int j = 0; j < 5; j++) {
                int k = clip3(0, sz - 1, i - 2 + j);
                s += kIntraEdgeKernel[strength - 1][j] * edge[k];
            }
            buf[i - 1] = (s + 8) >> 4;
        }
    }
    static void upsample(int* buf, int num_px, int maxv) {
        int dup[300];
        dup[0] = buf[-1];
        for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
        dup[num_px + 2] = buf[num_px - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < num_px; i++) {
            int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
            s = clip3(0, maxv, round2(s, 4));
            buf[2 * i - 1] = s;
            buf[2 * i] = dup[i + 2];
        }
    }

    void predict_intra(int p, int x, int y, bool have_left, bool have_above, bool have_ar,
                       bool have_bl, int mode, int log2w, int log2h) {
        Plane& pl = f.plane[p];
        int w = 1 << log2w, h = 1 << log2h;
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int max_x = ((f.MiCols * 4) >> sx) - 1, max_y = ((f.MiRows * 4) >> sy) - 1;
        int above_buf[320], left_buf[320];
        int* above = above_buf + 16;
        int* left = left_buf + 16;
        int n = w + h;
        const int base = 1 << (f.bitdepth - 1), maxv = (1 << f.bitdepth) - 1;
        if (!have_above && have_left) {
            int v = *pl.at(y, x - 1);
            for (int i = -1; i < n; i++) above[i] = v;
        } else if (!have_above && !have_left) {
            for (int i = -1; i < n; i++) above[i] = base - 1;
        } else {
            int lim = imin(max_x, x + (have_ar ? 2 * w : w) - 1);
            for (int i = 0; i < n; i++) above[i] = *pl.at(y - 1, imin(lim, x + i));
        }
        if (!have_left && have_above) {
            int v = *pl.at(y - 1, x);
            for (int i = -1; i < n; i++) left[i] = v;
        } else if (!have_left && !have_above) {
            for (int i = -1; i < n; i++) left[i] = base + 1;
        } else {
            int lim = imin(max_y, y + (have_bl ? 2 * h : h) - 1);
            for (int i = 0; i < n; i++) left[i] = *pl.at(imin(lim, y + i), x - 1);
        }
        if (have_above && have_left) above[-1] = *pl.at(y - 1, x - 1);
        else if (have_above) above[-1] = *pl.at(y - 1, x);
        else if (have_left) above[-1] = *pl.at(y, x - 1);
        else above[-1] = base;
        left[-1] = above[-1];

        pixel* dst = pl.at(y, x);
        int st = pl.stride;
        if (p == 0 && use_filter_intra) {
            int w4 = w >> 2, h2 = h >> 1;
            for (int i2 = 0; i2 < h2; i2++)
                for (int j4 = 0; j4 < w4; j4++) {
                    int pv[7];
                    for (int i = 0; i < 7; i++) {
                        if (i < 5) {
                            if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
                            else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
                            else pv[i] = dst[((i2 << 1) - 1) * st + (j4 << 2) + i - 1];
                        } else {
                            if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
                            else pv[i] = dst[((i2 << 1) + i - 5) * st + (j4 << 2) - 1];
                        }
                    }
                    for (int i = 0; i < 8; i++) {
                        int pr = 0;
                        for (int j = 0; j < 7; j++) pr += av1_filter_intra_taps[filter_intra_mode][i][j] * pv[j];
                        dst[((i2 << 1) + (i >> 2)) * st + (j4 << 2) + (i & 3)] =
                            pixel(clip3(0, maxv, round2signed(pr, 4)));
                    }
                }
            return;
        }
        if (mode >= V_PRED && mode <= D67_PRED) {
            int angle_delta = p == 0 ? angle_delta_y : angle_delta_uv;
            int pangle = av1_mode_to_angle[mode] + angle_delta * 3;
            int up_above = 0, up_left = 0;
            if (f.enable_intra_edge_filter) {
                int ftype = filter_type(p);
                if (pangle != 90 && pangle != 180) {
                    if (pangle > 90 && pangle < 180 && (w + h) >= 24) {
                        int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                        above[-1] = left[-1] = v;
                    }
                    if (have_above) {
                        int s = edge_strength(w, h, ftype, pangle - 90);
                        int num = imin(w, max_x - x + 1) + (pangle < 90 ? h : 0) + 1;
                        edge_filter(above, num, s);
                    }
                    if (have_left) {
                        int s = edge_strength(w, h, ftype, pangle - 180);
                        int num = imin(h, max_y - y + 1) + (pangle > 180 ? w : 0) + 1;
                        edge_filter(left, num, s);
                    }
                }
                up_above = use_upsample(w, h, ftype, pangle - 90);
                if (up_above) upsample(above, w + (pangle < 90 ? h : 0), maxv);
                up_left = use_upsample(w, h, ftype, pangle - 180);
                if (up_left) upsample(left, h + (pangle > 180 ? w : 0), maxv);
            }
            int dx = 0, dy = 0;
            if (pangle < 90) dx = av1_dr_intra_derivative[pangle];
            else if (pangle > 90 && pangle < 180) dx = av1_dr_intra_derivative[180 - pangle];
            if (pangle > 90 && pangle < 180) dy = av1_dr_intra_derivative[pangle - 90];
            else if (pangle > 180) dy = av1_dr_intra_derivative[270 - pangle];
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int pred;
                    if (pangle < 90) {
                        int idx = (i + 1) * dx;
                        int base = (idx >> (6 - up_above)) + (j << up_above);
                        int shift = ((idx << up_above) >> 1) & 0x1f;
                        int max_base = (w + h - 1) << up_above;
                        if (base < max_base)
                            pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        else
                            pred = above[max_base];
                    } else if (pangle > 90 && pangle < 180) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int base = idx >> (6 - up_above);
                        if (base >= -(1 << up_above)) {
                            int shift = ((idx * (1 << up_above)) >> 1) & 0x1f;
                            pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        } else {
                            idx = (i << 6) - (j + 1) * dy;
                            base = idx >> (6 - up_left);
                            int shift = ((idx * (1 << up_left)) >> 1) & 0x1f;
                            pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        }
                    } else if (pangle > 180) {
                        int idx = (j + 1) * dy;
                        int base = (idx >> (6 - up_left)) + (i << up_left);
                        int shift = ((idx << up_left) >> 1) & 0x1f;
                        int max_base = (w + h - 1) << up_left;
                        if (base < max_base)
                            pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        else
                            pred = left[max_base];
                    } else if (pangle == 90) {
                        pred = above[j];
                    } else {
                        pred = left[i];
                    }
                    dst[i * st + j] = pixel(pred);
                }
            return;
        }
        switch (mode) {
            case SMOOTH_PRED: {
                const uint8_t* wx = av1_sm_weights + w;
                const uint8_t* wy = av1_sm_weights + h;
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++) {
                        int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                                (256 - wx[j]) * above[w - 1];
                        dst[i * st + j] = pixel(round2(s, 9));
                    }
                break;
            }
            case SMOOTH_V_PRED: {
                const uint8_t* wy = av1_sm_weights + h;
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++)
                        dst[i * st + j] = pixel(round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8));
                break;
            }
            case SMOOTH_H_PRED: {
                const uint8_t* wx = av1_sm_weights + w;
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++)
                        dst[i * st + j] = pixel(round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8));
                break;
            }
            case PAETH_PRED:
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++) {
                        int base = above[j] + left[i] - above[-1];
                        int pl_ = abs(base - left[i]), pt = abs(base - above[j]), ptl = abs(base - above[-1]);
                        int v;
                        if (pl_ <= pt && pl_ <= ptl) v = left[i];
                        else if (pt <= ptl) v = above[j];
                        else v = above[-1];
                        dst[i * st + j] = pixel(v);
                    }
                break;
            default: {  // DC
                int avg;
                if (have_left && have_above) {
                    int sum = 0;
                    for (int k = 0; k < w; k++) sum += above[k];
                    for (int k = 0; k < h; k++) sum += left[k];
                    avg = (sum + ((w + h) >> 1)) / (w + h);
                } else if (have_left) {
                    int sum = 0;
                    for (int k = 0; k < h; k++) sum += left[k];
                    avg = (sum + (h >> 1)) >> log2h;
                } else if (have_above) {
                    int sum = 0;
                    for (int k = 0; k < w; k++) sum += above[k];
                    avg = (sum + (w >> 1)) >> log2w;
                } else {
                    avg = base;
                }
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++) dst[i * st + j] = pixel(avg);
            }
        }
    }

    void predict_cfl(int p, int sx0, int sy0, int t) {
        int w = kTw[t], h = kTh[t];
        int sx = f.ssx, sy = f.ssy;
        int alpha = p == 1 ? cfl_alpha_u : cfl_alpha_v;
        Plane& luma = f.plane[0];
        Plane& pl = f.plane[p];
        static thread_local int L[64 * 64];
        int64_t avg = 0;
        for (int i = 0; i < h; i++) {
            int ly = imin((sy0 + i) << sy, max_luma_h - (1 << sy));
            for (int j = 0; j < w; j++) {
                int lx = imin((sx0 + j) << sx, max_luma_w - (1 << sx));
                int tsum = 0;
                for (int dy = 0; dy <= sy; dy++)
                    for (int dx = 0; dx <= sx; dx++) tsum += *luma.at(ly + dy, lx + dx);
                int v = tsum << (3 - sx - sy);
                L[i * w + j] = v;
                avg += v;
            }
        }
        int lavg = round2(avg, floorlog2(uint32_t(w)) + floorlog2(uint32_t(h)));
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                pixel* d = pl.at(sy0 + i, sx0 + j);
                int scaled = round2signed(alpha * (L[i * w + j] - lavg), 6);
                *d = pixel(clip3(0, (1 << f.bitdepth) - 1, *d + scaled));
            }
    }

    // ---- coefficients
    // the transform set of a size: 0 DCT only; intra 1 and 2 (the
    // specification's TX_SET_INTRA_1 / 2); an intra block copy's inter sets
    // 1 (16 types), 2 (12) and 3 (IDTX, DCT)
    int tx_set(int t) {
        int sq = tx_sqr(t), up = tx_sqr_up(t);
        if (up > TX_32X32) return 0;
        if (use_intrabc) {
            if (f.reduced_tx_set || up == TX_32X32) return 3;
            return sq == TX_16X16 ? 2 : 1;
        }
        if (up == TX_32X32) return 0;
        if (f.reduced_tx_set) return 2;
        if (sq == TX_16X16) return 2;
        return 1;
    }

    int compute_tx_type(int p, int t, int x4, int y4) {
        if (lossless || tx_sqr_up(t) > TX_32X32) return DCT_DCT;
        int set = tx_set(t);
        if (p == 0) return f.tx_type[f.mi(y4, x4)];
        static const bool in_set[3][16] = {
            {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
            {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0},
            {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0}};
        static const bool in_inter_set[4][16] = {
            {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
            {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
            {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
            {1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0}};
        if (use_intrabc) {  // the co-located luma transform's type
            int tt = f.tx_type[f.mi(imax(mi_row, y4 << f.ssy), imax(mi_col, x4 << f.ssx))];
            return in_inter_set[set][tt] ? tt : DCT_DCT;
        }
        int tt = kModeToTxfm[uvmode];
        if (!in_set[set][tt]) return DCT_DCT;
        return tt;
    }

    const uint16_t* get_scan(int t) {
        const Scans& s = scans();
        if (t == TX_16X64) return s.def[TX_16X32].data();
        if (t == TX_64X16) return s.def[TX_32X16].data();
        if (tx_sqr_up(t) == TX_64X64) return s.def[TX_32X32].data();
        if (plane_tx_type == IDTX) return s.def[t].data();
        bool prefer_row = plane_tx_type == V_DCT || plane_tx_type == V_ADST || plane_tx_type == V_FLIPADST;
        bool prefer_col = plane_tx_type == H_DCT || plane_tx_type == H_ADST || plane_tx_type == H_FLIPADST;
        if (prefer_row) return s.mrow[t].data();
        if (prefer_col) return s.mcol[t].data();
        return s.def[t].data();
    }

    int coeff_base_ctx(int t, int tclass, int pos) {
        int adj = adjusted_tx(t);
        int bwl = floorlog2(uint32_t(kTw[adj]));
        int txh = kTh[adj];
        int row = pos >> bwl, col = pos - (row << bwl);
        int mag = 0;
        for (int k = 0; k < 5; k++) {
            int rr = row + kSigRefDiffOffset[tclass][k][0];
            int cc = col + kSigRefDiffOffset[tclass][k][1];
            if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl)) mag += imin(abs(quant[(rr << bwl) + cc]), 3);
        }
        int ctx = imin((mag + 1) >> 1, 4);
        if (tclass == TX_CLASS_2D) {
            if (row == 0 && col == 0) return 0;
            int w = kTw[t], h = kTh[t];
            int k = w == h ? 0 : (w > h ? 1 : 2);
            return ctx + av1_lo_ctx_offsets[k][imin(row, 4)][imin(col, 4)];
        }
        int idx = tclass == TX_CLASS_VERT ? row : col;
        static const int pos_off[3] = {26, 31, 36};
        return ctx + pos_off[imin(idx, 2)];
    }

    int br_ctx(int t, int tclass, int pos) {
        int adj = adjusted_tx(t);
        int bwl = floorlog2(uint32_t(kTw[adj]));
        int txw = kTw[adj], txh = kTh[adj];
        int row = pos >> bwl, col = pos - (row << bwl);
        int mag = 0;
        for (int k = 0; k < 3; k++) {
            int rr = row + kMagRefOffset[tclass][k][0];
            int cc = col + kMagRefOffset[tclass][k][1];
            if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl)) mag += imin(quant[rr * txw + cc], 15);
        }
        mag = imin((mag + 1) >> 1, 6);
        if (pos == 0) return mag;
        if (tclass == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
        if (tclass == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
        return row == 0 ? mag + 7 : mag + 14;
    }

    int coeffs(int p, int sx0, int sy0, int t) {
        int x4 = sx0 >> 2, y4 = sy0 >> 2, w4 = kTw[t] >> 2, h4 = kTh[t] >> 2;
        int tsc = (tx_sqr(t) + tx_sqr_up(t) + 1) >> 1;
        int ptype = p > 0;
        int seg_eob = (t == TX_16X64 || t == TX_64X16) ? 512 : imin(1024, kTw[t] * kTh[t]);
        for (int c = 0; c < seg_eob; c++) quant[c] = 0;
        int eob = 0, cul_level = 0, dc_category = 0;
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int max_x4 = f.MiCols >> sx, max_y4 = f.MiRows >> sy;
        int w = kTw[t], h = kTh[t];
        // all_zero context
        int ctx;
        int psz = residual_size(mi_sz, p);
        if (p == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++) if (x4 + k < max_x4) top = imax(top, above_level[p][x4 + k]);
            for (int k = 0; k < h4; k++) if (y4 + k < max_y4) left = imax(left, left_level[p][y4 + k]);
            top = imin(top, 255);
            left = imin(left, 255);
            if (kBw[psz] == w && kBh[psz] == h) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (imax(top, left) > 3);
            else if (imax(top, left) <= 3) ctx = 4;
            else if (imin(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int k = 0; k < w4; k++) if (x4 + k < max_x4) above |= above_level[p][x4 + k] | above_dc[p][x4 + k];
            for (int k = 0; k < h4; k++) if (y4 + k < max_y4) left |= left_level[p][y4 + k] | left_dc[p][y4 + k];
            ctx = (above != 0) + (left != 0) + 7;
            if (kBw[psz] * kBh[psz] > w * h) ctx += 3;
        }
        int all_zero = sd.read(cdf.txb_skip[tsc][ctx], 2);
        if (all_zero) {
            if (p == 0)
                for (int i = 0; i < w4; i++)
                    for (int j = 0; j < h4; j++)
                        if (y4 + j < f.MiRows && x4 + i < f.MiCols) f.tx_type[f.mi(y4 + j, x4 + i)] = DCT_DCT;
        } else {
            if (p == 0) {
                int tt = DCT_DCT;
                int set = tx_set(t);
                if (set > 0 && f.seg_qindex(seg_id, f.base_q_idx) > 0) {
                    int sq = tx_sqr(t);
                    if (use_intrabc) {
                        if (set == 1) tt = kTxTypeInterInvSet1[sd.read(cdf.inter_tx_set1[sq], 16)];
                        else if (set == 2) tt = kTxTypeInterInvSet2[sd.read(cdf.inter_tx_set2, 12)];
                        else tt = sd.read(cdf.inter_tx_set3[sq], 2) ? DCT_DCT : IDTX;
                    } else {
                        int dir = use_filter_intra ? kFilterIntraModeToIntraDir[filter_intra_mode] : ymode;
                        if (set == 1) tt = kTxTypeIntraInvSet1[sd.read(cdf.intra_tx_set1[sq][dir], 7)];
                        else tt = kTxTypeIntraInvSet2[sd.read(cdf.intra_tx_set2[sq][dir], 5)];
                    }
                }
                f.stats[6] += tt != DCT_DCT;
                for (int i = 0; i < w4; i++)
                    for (int j = 0; j < h4; j++)
                        if (y4 + j < f.MiRows && x4 + i < f.MiCols) f.tx_type[f.mi(y4 + j, x4 + i)] = uint8_t(tt);
            }
            plane_tx_type = compute_tx_type(p, t, x4, y4);
            int tclass = tx_class(plane_tx_type);
            const uint16_t* scan = get_scan(t);
            int ems = imin(floorlog2(uint32_t(w)), 5) + imin(floorlog2(uint32_t(h)), 5) - 4;
            int ectx = tclass == TX_CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (ems) {
                case 0: eob_pt = sd.read(cdf.eob_pt16[ptype][ectx], 5) + 1; break;
                case 1: eob_pt = sd.read(cdf.eob_pt32[ptype][ectx], 6) + 1; break;
                case 2: eob_pt = sd.read(cdf.eob_pt64[ptype][ectx], 7) + 1; break;
                case 3: eob_pt = sd.read(cdf.eob_pt128[ptype][ectx], 8) + 1; break;
                case 4: eob_pt = sd.read(cdf.eob_pt256[ptype][ectx], 9) + 1; break;
                case 5: eob_pt = sd.read(cdf.eob_pt512[ptype], 10) + 1; break;
                default: eob_pt = sd.read(cdf.eob_pt1024[ptype], 11) + 1; break;
            }
            eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
            int eob_shift = eob_pt - 3;
            if (eob_shift >= 0) {
                if (sd.read(cdf.eob_extra[tsc][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
                for (int i = 1; i < imax(0, eob_pt - 2); i++) {
                    eob_shift = imax(0, eob_pt - 2) - 1 - i;
                    if (sd.lit(1)) eob += 1 << eob_shift;
                }
            }
            int adj = adjusted_tx(t);
            int area = kTw[adj] * kTh[adj];
            int brsz = imin(tsc, TX_32X32);
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c];
                int level;
                if (c == eob - 1) {
                    int ec = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
                    level = sd.read(cdf.coeff_base_eob[tsc][ptype][ec], 3) + 1;
                } else {
                    int bc = coeff_base_ctx(t, tclass, pos);
                    level = sd.read(cdf.coeff_base[tsc][ptype][bc], 4);
                }
                if (level > 2) {
                    int rc = br_ctx(t, tclass, pos);
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sd.read(cdf.coeff_br[brsz][ptype][rc], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int c = 0; c < eob; c++) {
                int pos = scan[c];
                int sign = 0;
                if (quant[pos] != 0) {
                    if (c == 0) {
                        int dcs = 0;
                        for (int k = 0; k < w4; k++)
                            if (x4 + k < max_x4) {
                                int s = above_dc[p][x4 + k];
                                if (s == 1) dcs--; else if (s == 2) dcs++;
                            }
                        for (int k = 0; k < h4; k++)
                            if (y4 + k < max_y4) {
                                int s = left_dc[p][y4 + k];
                                if (s == 1) dcs--; else if (s == 2) dcs++;
                            }
                        int dctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
                        sign = sd.read(cdf.dc_sign[ptype][dctx], 2);
                    } else {
                        sign = sd.lit(1);
                    }
                }
                if (quant[pos] > 14) {  // a Golomb tail, read as dav1d reads it
                    int len = 0;
                    uint32_t x = 1;
                    while (!sd.lit(1) && len < 32) len++;
                    while (len--) x = (x << 1) + uint32_t(sd.lit(1));
                    quant[pos] = int32_t((x + 14u) & 0xFFFFFu);
                }
                if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                cul_level += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            cul_level = imin(63, cul_level);
        }
        for (int i = 0; i < w4; i++) { above_level[p][x4 + i] = uint8_t(cul_level); above_dc[p][x4 + i] = uint8_t(dc_category); }
        for (int i = 0; i < h4; i++) { left_level[p][y4 + i] = uint8_t(cul_level); left_dc[p][y4 + i] = uint8_t(dc_category); }
        return eob;
    }

    static int qm_offset(int t) {  // the specification's Qm_Offset (sizes up to 32)
        int off = 0;
        for (int k = 0; k < t; k++)
            if (kTw[k] <= 32 && kTh[k] <= 32) off += kTw[k] * kTh[k];
        return off;
    }

    int dc_q(int b) {
        const int16_t* t = f.bitdepth == 12 ? av1_dc_qlookup12 : f.bitdepth == 10 ? av1_dc_qlookup10 : av1_dc_qlookup;
        return t[clip3(0, 255, b)];
    }
    int ac_q(int b) {
        const int16_t* t = f.bitdepth == 12 ? av1_ac_qlookup12 : f.bitdepth == 10 ? av1_ac_qlookup10 : av1_ac_qlookup;
        return t[clip3(0, 255, b)];
    }

    void reconstruct(int p, int x, int y, int t, int eob) {
        int w = kTw[t], h = kTh[t];
        int tw = imin(32, w), th = imin(32, h);
        int area = w * h;
        int dq_shift = (area > 256) + (area > 1024);
        int qi = qindex;
        int dcq = p == 0 ? dc_q(qi + f.dq_y_dc) : p == 1 ? dc_q(qi + f.dq_u_dc) : dc_q(qi + f.dq_v_dc);
        int acq = p == 0 ? ac_q(qi) : p == 1 ? ac_q(qi + f.dq_u_ac) : ac_q(qi + f.dq_v_ac);
        static thread_local int32_t coef[32 * 32];
        // the dequantised coefficient's range: 7 + BitDepth bits and a sign
        const int64_t cmax = (int64_t(1) << (7 + f.bitdepth)) - 1;
        // the quantizer matrix of a 2-D transform (the adjusted size's; none
        // at level 15 or for the identity-bearing types)
        const uint8_t* qm = nullptr;
        int qm_level = f.seg_qm[seg_id][p];
        if (qm_level < 15 && plane_tx_type < IDTX)
            qm = &av1_qm[qm_level][p > 0][qm_offset(adjusted_tx(t))];
        for (int i = 0; i < th; i++)
            for (int j = 0; j < tw; j++) {
                int32_t qv = quant[i * tw + j];
                if (!qv) { coef[i * tw + j] = 0; continue; }
                int q = (i == 0 && j == 0) ? dcq : acq;
                if (qm) q = (q * qm[j * th + i] + 16) >> 5;  // the matrix is stored by columns
                int64_t mag = int64_t(qv < 0 ? -qv : qv) * q;
                mag &= 0xFFFFFF;
                mag >>= dq_shift;
                int64_t dq = qv < 0 ? -mag : mag;
                coef[i * tw + j] = int32_t(dq < -cmax - 1 ? -cmax - 1 : dq > cmax ? cmax : dq);
            }
        if (plane_tx_type == DCT_DCT && eob == 1 && !lossless) {
            // dav1d's DC-only route: the DCT of a lone DC coefficient without
            // the intermediate clamps (the same bits as the full route on
            // a conformant stream)
            int dc = coef[0];
            if (w == 2 * h || h == 2 * w) dc = (dc * 181 + 128) >> 8;
            g_itx_max = row_max();
            dc = chk_range((int64_t(dc) * 181 + 128) >> 8);
            int sh = kRowShift[t];
            dc = (dc + ((1 << sh) >> 1)) >> sh;
            g_itx_max = col_max();
            dc = chk_range((int64_t(dc) * 181 + 128) >> 8);
            dc = (dc + 8) >> 4;
            Plane& pl = f.plane[p];
            const int maxv = (1 << f.bitdepth) - 1;
            for (int i = 0; i < h; i++) {
                pixel* d = pl.at(y + i, x);
                for (int j = 0; j < w; j++) d[j] = pixel(clip3(0, maxv, d[j] + dc));
            }
            return;
        }
        inverse_transform_add(p, x, y, t, coef);
    }

    // the largest intermediate value of the row and column transforms
    // (BitDepth + 8 bits, Max(BitDepth + 6, 16) bits; dav1d's clip ranges)
    int32_t row_max() const { return (1 << (f.bitdepth + 7)) - 1; }
    int32_t col_max() const { return (1 << imax(f.bitdepth + 5, 15)) - 1; }

    void inverse_transform_add(int p, int x, int y, int t, const int32_t* coef) {
        int w = kTw[t], h = kTh[t];
        int tw = imin(32, w), th = imin(32, h);
        int log2w = floorlog2(uint32_t(w)), log2h = floorlog2(uint32_t(h));
        int row_shift = lossless ? 0 : kRowShift[t];
        int col_shift = lossless ? 0 : 4;
        Clamp rcl{-row_max() - 1, row_max()}, ccl{-col_max() - 1, col_max()};
        static thread_local int32_t res[64 * 64];
        int vk, hk, flip_ud, flip_lr;
        tx_kinds(plane_tx_type, &vk, &hk, &flip_ud, &flip_lr);
        int32_t T[64];
        g_itx_max = row_max();
        for (int i = 0; i < h; i++) {
            if (i >= th) {
                for (int j = 0; j < w; j++) res[i * 64 + j] = 0;
                continue;
            }
            bool any = false;
            for (int j = 0; j < tw; j++) any |= coef[i * tw + j] != 0;
            if (!any) {  // every 1-D transform maps zeros to zeros
                for (int j = 0; j < w; j++) res[i * 64 + j] = 0;
                continue;
            }
            for (int j = 0; j < w; j++) T[j] = j < tw ? coef[i * tw + j] : 0;
            if (abs(log2w - log2h) == 1)
                for (int j = 0; j < w; j++) T[j] = int32_t((int64_t(T[j]) * 2896 + 2048) >> 12);
            if (lossless) iwht4(T, 2);
            else itx1d(T, w, hk, rcl);
            for (int j = 0; j < w; j++) {
                int32_t v = round2(T[flip_lr ? w - 1 - j : j], row_shift);
                if (!lossless) v = ccl(v);
                res[i * 64 + j] = v;
            }
        }
        g_itx_max = col_max();
        for (int j = 0; j < w; j++) {
            for (int i = 0; i < h; i++) T[i] = res[i * 64 + j];
            if (lossless) iwht4(T, 0);
            else itx1d(T, h, vk, ccl);
            for (int i = 0; i < h; i++) res[i * 64 + j] = round2(T[flip_ud ? h - 1 - i : i], col_shift);
        }
        Plane& pl = f.plane[p];
        const int maxv = (1 << f.bitdepth) - 1;
        for (int i = 0; i < h; i++) {
            pixel* d = pl.at(y + i, x);
            for (int j = 0; j < w; j++) d[j] = pixel(clip3(0, maxv, d[j] + res[i * 64 + j]));
        }
    }
};

void Decoder::decode_tile(int tile_row, int tile_col, const uint8_t* data, int64_t size) {
    Tile* t = new Tile(*this);
    try {
        t->run(tile_row, tile_col, data, size);
    } catch (...) {
        delete t;
        throw;
    }
    delete t;
}

// ---- deblocking

// the limits of a level
void Decoder::filter_level(int l, int* limit, int* blimit, int* thresh) {
    int shift = lf_sharpness > 4 ? 2 : (lf_sharpness > 0 ? 1 : 0);
    int lim = lf_sharpness > 0 ? clip3(1, 9 - lf_sharpness, l >> shift) : imax(1, l >> shift);
    *limit = lim;
    *blimit = 2 * (l + 2) + lim;
    *thresh = l >> 4;
}

void Decoder::edge_filter(int p, int pass, int row, int col) {
    int sx = p ? ssx : 0, sy = p ? ssy : 0;
    int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
    int x = col * 4, y = row * 4;
    row |= sy;
    col |= sx;
    bool on_screen;
    if (x >= W) on_screen = false;
    else if (y >= H) on_screen = false;
    else if (pass == 0 && x == 0) on_screen = false;
    else if (pass == 1 && y == 0) on_screen = false;
    else on_screen = true;
    if (!on_screen) return;
    int xp = x >> sx, yp = y >> sy;
    int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
    int t = lf_tx_size[p][size_t(row >> sy) * lf_stride[p] + (col >> sx)];
    int prev_t = lf_tx_size[p][size_t(prev_row >> sy) * lf_stride[p] + (prev_col >> sx)];
    // every block is intra (a frame with intra block copies is not
    // deblocked), so every transform edge is filtered, block edge or not,
    // skipped or not
    bool apply = pass == 0 ? (xp % kTw[t] == 0) : (yp % kTh[t] == 0);
    int base_size = pass == 0 ? imin(kTw[prev_t], kTw[t]) : imin(kTh[prev_t], kTh[t]);
    int filter_size = p == 0 ? imin(16, base_size) : imin(8, base_size);
    // the block's level, else the level of the block before the edge
    int li = p == 0 ? pass : p + 1;
    int lvl = lf_lvl[4 * size_t(mi(row, col)) + li];
    if (!lvl) lvl = lf_lvl[4 * size_t(mi(prev_row, prev_col)) + li];
    if (!apply || lvl == 0) return;
    int limit, blimit, thresh;
    filter_level(lvl, &limit, &blimit, &thresh);
    // at depth: the limits and the flatness threshold shifted up, the
    // narrow filter about (0x80 << shift) clamped to BitDepth signed bits
    const int bs = bitdepth - 8, one = 1 << bs, half = 0x80 << bs;
    limit <<= bs;
    blimit <<= bs;
    thresh <<= bs;
    const int c4lo = -(1 << (bitdepth - 1)), c4hi = (1 << (bitdepth - 1)) - 1;
    Plane& pl = plane[p];
    int across = dx ? 1 : pl.stride;  // across the edge
    for (int i = 0; i < 4; i++) {
        pixel* s = pl.at(yp, xp) + (dx ? i * pl.stride : i);  // the i-th sample along it
        auto S = [&](int k) -> int { return s[k * across]; };
        int q0 = S(0), q1 = S(1), q2 = S(2), q3 = S(3);
        int p0 = S(-1), p1 = S(-2), p2 = S(-3), p3 = S(-4);
        bool hev = abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
        int flen = filter_size == 4 ? 4 : p != 0 ? 6 : filter_size == 8 ? 8 : 16;
        bool mask = abs(p1 - p0) <= limit && abs(q1 - q0) <= limit &&
                    abs(p0 - q0) * 2 + abs(p1 - q1) / 2 <= blimit;
        if (flen >= 6) mask = mask && abs(p2 - p1) <= limit && abs(q2 - q1) <= limit;
        if (flen >= 8) mask = mask && abs(p3 - p2) <= limit && abs(q3 - q2) <= limit;
        if (!mask) continue;
        bool flat = false, flat2 = false;
        if (filter_size >= 8) {
            flat = abs(p1 - p0) <= one && abs(q1 - q0) <= one && abs(p2 - p0) <= one && abs(q2 - q0) <= one;
            if (flen >= 8) flat = flat && abs(p3 - p0) <= one && abs(q3 - q0) <= one;
        }
        if (filter_size >= 16) {
            int q4 = S(4), q5 = S(5), q6 = S(6), p4 = S(-5), p5 = S(-6), p6 = S(-7);
            flat2 = abs(p6 - p0) <= one && abs(q6 - q0) <= one && abs(p5 - p0) <= one &&
                    abs(q5 - q0) <= one && abs(p4 - p0) <= one && abs(q4 - q0) <= one;
        }
        if (filter_size == 4 || !flat) {
            auto c4 = [&](int v) { return clip3(c4lo, c4hi, v); };
            int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
            int fl = hev ? c4(ps1 - qs1) : 0;
            fl = c4(fl + 3 * (qs0 - ps0));
            int f1 = c4(fl + 4) >> 3, f2 = c4(fl + 3) >> 3;
            s[0] = pixel(c4(qs0 - f1) + half);
            s[-across] = pixel(c4(ps0 + f2) + half);
            if (!hev) {
                int fv = round2(f1, 1);
                s[across] = pixel(c4(qs1 - fv) + half);
                s[-2 * across] = pixel(c4(ps1 + fv) + half);
            }
        } else {
            int log2size = (filter_size == 8 || !flat2) ? 3 : 4;
            int n = log2size == 4 ? 6 : (p == 0 ? 3 : 2);
            int n2 = (log2size == 3 && p == 0) ? 0 : 1;
            int v[16], F[16];
            for (int k = -(n + 1); k <= n; k++) v[k + 8] = S(k);
            for (int i2 = -n; i2 < n; i2++) {
                int tsum = 0;
                for (int j = -n; j <= n; j++) {
                    int pp = clip3(-(n + 1), n, i2 + j);
                    int tap = abs(j) <= n2 ? 2 : 1;
                    tsum += v[pp + 8] * tap;
                }
                F[i2 + 8] = round2(tsum, log2size);
            }
            for (int i2 = -n; i2 < n; i2++) s[i2 * across] = pixel(F[i2 + 8]);
        }
    }
}

void Decoder::loop_filter() {
    if (!(lf_level[0] || lf_level[1])) return;
    for (int p = 0; p < num_planes; p++) {
        if (p > 0 && !lf_level[1 + p]) continue;
        for (int pass = 0; pass < 2; pass++) {
            int rstep = p == 0 ? 1 : (1 << ssy), cstep = p == 0 ? 1 : (1 << ssx);
            for (int r = 0; r < MiRows; r += rstep)
                for (int c = 0; c < MiCols; c += cstep) edge_filter(p, pass, r, c);
        }
    }
}

// f(i, worker) for i in [0, n) on up to 8 threads (f must not throw); the
// filters below write disjoint pixels, so the result does not depend on
// the split
template <class F>
void parallel_for(int n, F f) {
    int nt = imax(1, imin(imin(int(std::thread::hardware_concurrency()), 8), n));
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++)
        pool.emplace_back([&, t] {
            for (int i = t; i < n; i += nt) f(i, t);
        });
    for (int i = 0; i < n; i += nt) f(i, 0);
    for (auto& th : pool) th.join();
}

// ---- CDEF (specification 7.15; dav1d's results, which are the same)

namespace cdef_detail {
// Cdef_Directions: (row, column) of the two taps of each direction
const int kDir[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                           {{1, 1}, {2, 2}}, {{1, 0}, {2, 1}}, {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
const int kUvDir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                             {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};

int find_dir(const pixel* img, int stride, int bitdepth, int* var) {
    static const int div_table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    int partial[8][15] = {{0}};
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            int x = (int(img[i * stride + j]) >> (bitdepth - 8)) - 128;
            partial[0][i + j] += x;
            partial[1][i + j / 2] += x;
            partial[2][i] += x;
            partial[3][3 + i - j / 2] += x;
            partial[4][7 + i - j] += x;
            partial[5][3 - i / 2 + j] += x;
            partial[6][j] += x;
            partial[7][i / 2 + j] += x;
        }
    int64_t cost[8] = {0};
    for (int i = 0; i < 8; i++) {
        cost[2] += int64_t(partial[2][i]) * partial[2][i];
        cost[6] += int64_t(partial[6][i]) * partial[6][i];
    }
    cost[2] *= div_table[8];
    cost[6] *= div_table[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (int64_t(partial[0][i]) * partial[0][i] +
                    int64_t(partial[0][14 - i]) * partial[0][14 - i]) * div_table[i + 1];
        cost[4] += (int64_t(partial[4][i]) * partial[4][i] +
                    int64_t(partial[4][14 - i]) * partial[4][14 - i]) * div_table[i + 1];
    }
    cost[0] += int64_t(partial[0][7]) * partial[0][7] * div_table[8];
    cost[4] += int64_t(partial[4][7]) * partial[4][7] * div_table[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += int64_t(partial[i][3 + j]) * partial[i][3 + j];
        cost[i] *= div_table[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (int64_t(partial[i][j]) * partial[i][j] +
                        int64_t(partial[i][10 - j]) * partial[i][10 - j]) * div_table[2 * j + 2];
    }
    int best = 0;
    int64_t best_cost = 0;
    for (int i = 0; i < 8; i++)
        if (cost[i] > best_cost) { best_cost = cost[i]; best = i; }
    *var = int((best_cost - cost[(best + 4) & 7]) >> 10);
    return best;
}

// constrain() of the specification, its damping shift max(0, damping -
// FloorLog2(threshold)) given (threshold 0: no tap)
inline int constrain(int diff, int threshold, int shift) {
    int a = diff < 0 ? -diff : diff;
    int v = imin(a, imax(0, threshold - (a >> shift)));
    return diff < 0 ? -v : v;
}
}  // namespace cdef_detail

void Decoder::cdef() {
    using namespace cdef_detail;
    if (!cdef_on) return;
    Plane src[3];
    for (int p = 0; p < num_planes; p++) src[p] = plane[p];
    // an 8x8 (or chroma) block with two pixels about it, unavailable ones
    // (past the frame's 4x4 grid) marked: they add no tap and bound nothing
    const int S = 12, NA = -30000;
    static const int pri_tap_sets[2][2] = {{4, 2}, {3, 3}}, sec_taps[2] = {2, 1};
    int fb_cols = (MiCols + 15) >> 4;
    int64_t filtered[8] = {0};
    parallel_for(MiRows / 2, [&](int row8, int worker) {
        int buf[S * S];
        int r = row8 * 2;
        for (int c = 0; c < MiCols; c += 2) {
            int idx = cdef_idx[size_t(r >> 4) * fb_cols + (c >> 4)];
            if (idx < 0) continue;
            if (skip_[mi(r, c)] && skip_[mi(r + 1, c)] && skip_[mi(r, c + 1)] && skip_[mi(r + 1, c + 1)])
                continue;
            int var = 0;
            int ydir = find_dir(src[0].at(r * 4, c * 4), src[0].stride, bitdepth, &var);
            for (int p = 0; p < num_planes; p++) {
                int sx = p ? ssx : 0, sy = p ? ssy : 0;
                // strengths and damping shifted up at depth (coeff_shift)
                const int cs = bitdepth - 8;
                int pri = cdef_strength[idx][p ? 2 : 0] << cs, sec = cdef_strength[idx][p ? 3 : 1] << cs;
                int dir = pri ? (p ? kUvDir[ssx][ssy][ydir] : ydir) : 0;
                int damping = cdef_damping + cs - (p ? 1 : 0);
                if (p == 0) {
                    int var_str = (var >> 6) ? imin(floorlog2(uint32_t(var >> 6)), 12) : 0;
                    pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
                }
                if (!pri && !sec) continue;
                filtered[worker] += p == 0;
                int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
                int xend = (MiCols * 4) >> sx, yend = (MiRows * 4) >> sy;
                Plane& sp = src[p];
                for (int i = -2; i < h + 2; i++) {
                    int y = y0 + i;
                    bool row_ok = y >= 0 && y < yend;
                    for (int j = -2; j < w + 2; j++) {
                        int x = x0 + j;
                        buf[(i + 2) * S + j + 2] = row_ok && x >= 0 && x < xend ? *sp.at(y, x) : NA;
                    }
                }
                int po[2], so1[2], so2[2];
                for (int k = 0; k < 2; k++) {
                    po[k] = kDir[dir][k][0] * S + kDir[dir][k][1];
                    so1[k] = kDir[(dir + 2) & 7][k][0] * S + kDir[(dir + 2) & 7][k][1];
                    so2[k] = kDir[(dir + 6) & 7][k][0] * S + kDir[(dir + 6) & 7][k][1];
                }
                const int* pri_taps = pri_tap_sets[(pri >> cs) & 1];
                int pri_shift = pri ? imax(0, damping - floorlog2(uint32_t(pri))) : 0;
                int sec_shift = sec ? imax(0, damping - floorlog2(uint32_t(sec))) : 0;
                for (int i = 0; i < h; i++) {
                    pixel* out = plane[p].at(y0 + i, x0);
                    for (int j = 0; j < w; j++) {
                        const int* b = &buf[(i + 2) * S + j + 2];
                        int px = b[0], sum = 0, mx = px;
                        unsigned mn = unsigned(px);
                        for (int k = 0; k < 2; k++)
                            for (int sign = -1; sign <= 1; sign += 2) {
                                int v = b[sign * po[k]];
                                sum += pri_taps[k] * constrain(v - px, pri, pri_shift);
                                mx = imax(mx, v);
                                mn = std::min(mn, unsigned(v));
                                int s1 = b[sign * so1[k]], s2 = b[sign * so2[k]];
                                sum += sec_taps[k] * (constrain(s1 - px, sec, sec_shift) +
                                                      constrain(s2 - px, sec, sec_shift));
                                mx = imax(mx, imax(s1, s2));
                                mn = std::min(mn, std::min(unsigned(s1), unsigned(s2)));
                            }
                        out[j] = pixel(clip3(int(mn), mx, px + ((8 + sum - (sum < 0)) >> 4)));
                    }
                }
            }
        }
    });
    for (int64_t n : filtered) stats[11] += n;
}

// ---- loop restoration (specification 7.17): 64-row stripes offset by 8
// rows, whose rows above and below come from the deblocked frame before
// CDEF; Wiener and self-guided filters per restoration unit

void Decoder::loop_restoration(const Plane* pre) {
    if (!uses_lr) return;
    for (int p = 0; p < num_planes; p++) {
        if (lr_type[p] == RESTORE_NONE) continue;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int pw = round2(W, sx), ph = round2(H, sy);
        int unit = lr_unit_size[p];
        const int maxv = (1 << bitdepth) - 1;
        Plane out = plane[p];
        const Plane& cd = plane[p];
        const Plane& dbk = pre[p];
        const int PAD = 4;
        int n_stripes = 0;
        while (imax(0, (-8 + n_stripes * 64) >> sy) < ph) n_stripes++;
        int64_t filtered[8] = {0};
        parallel_for(n_stripes, [&](int stripe, int worker) {
            std::vector<int> buf;
            int sstart = (-8 + stripe * 64) >> sy, send = sstart + (64 >> sy) - 1;
            int y0 = imax(0, sstart), y1 = imin(ph, send + 1);
            int urow = imin(lr_rows[p] - 1, (y0 + (8 >> sy)) / unit);
            for (int ucol = 0; ucol < lr_cols[p]; ucol++) {
                const LrUnit& u = lr_units[p][size_t(urow) * lr_cols[p] + ucol];
                if (u.type == RESTORE_NONE) continue;
                filtered[worker]++;
                int x0 = ucol * unit, x1 = ucol == lr_cols[p] - 1 ? pw : (ucol + 1) * unit;
                int bw = x1 - x0 + 2 * PAD, bh = y1 - y0 + 2 * PAD;
                buf.resize(size_t(bw) * bh);
                for (int i = 0; i < bh; i++) {
                    int y = clip3(0, ph - 1, y0 - PAD + i);
                    const Plane* srcp = &cd;
                    if (y < sstart) { y = imax(sstart - 2, y); srcp = &dbk; }
                    else if (y > send) { y = imin(send + 2, y); srcp = &dbk; }
                    const pixel* row = &srcp->px[size_t(y) * srcp->stride];
                    for (int j = 0; j < bw; j++) buf[size_t(i) * bw + j] = row[clip3(0, pw - 1, x0 - PAD + j)];
                }
                auto S = [&](int i, int j) { return buf[size_t(i + PAD) * bw + j + PAD]; };
                int w = x1 - x0, h = y1 - y0;
                if (u.type == RESTORE_WIENER) {
                    int vf[7], hf[7];
                    for (int pass = 0; pass < 2; pass++) {
                        int* fl = pass ? hf : vf;
                        fl[3] = 128;
                        for (int i = 0; i < 3; i++) {
                            int cf = u.wiener[pass][i];
                            fl[i] = fl[6 - i] = cf;
                            fl[3] -= 2 * cf;
                        }
                    }
                    // InterRound0 3 and InterRound1 11, 5 and 9 at 12 bits
                    const int r0 = bitdepth == 12 ? 5 : 3, r1 = bitdepth == 12 ? 9 : 11;
                    const int offset = 1 << (bitdepth + 7 - r0 - 1),
                              limit = (1 << (bitdepth + 1 + 7 - r0)) - 1;
                    std::vector<int> inter(size_t(h + 6) * w);
                    for (int r = 0; r < h + 6; r++)
                        for (int c = 0; c < w; c++) {
                            int sum = 0;
                            for (int t = 0; t < 7; t++) sum += hf[t] * S(r - 3, c + t - 3);
                            inter[size_t(r) * w + c] = clip3(-offset, limit - offset, round2(sum, r0));
                        }
                    for (int r = 0; r < h; r++)
                        for (int c = 0; c < w; c++) {
                            int sum = 0;
                            for (int t = 0; t < 7; t++) sum += vf[t] * inter[size_t(r + t) * w + c];
                            *out.at(y0 + r, x0 + c) = pixel(clip3(0, maxv, round2(sum, r1)));
                        }
                } else {
                    const int* prm = av1_sgr_params[u.set];
                    std::vector<int> flt[2];
                    for (int pass = 0; pass < 2; pass++) {
                        int rad = prm[pass * 2], sc = prm[pass * 2 + 1];
                        if (!rad) continue;
                        int n = (2 * rad + 1) * (2 * rad + 1);
                        int one_over_n = ((1 << 12) + (n / 2)) / n;
                        int aw = w + 2;
                        std::vector<int> A(size_t(h + 2) * aw), B(size_t(h + 2) * aw);
                        for (int i = -1; i < h + 1; i++) {
                            for (int j = -1; j < w + 1; j++) {
                                int a = 0, b = 0;
                                for (int dy = -rad; dy <= rad; dy++)
                                    for (int dx = -rad; dx <= rad; dx++) {
                                        int cv = S(i + dy, j + dx);
                                        a += cv * cv;
                                        b += cv;
                                    }
                                // at depth: a and b scaled back to 8 bits
                                int as = round2(a, 2 * (bitdepth - 8)), bs = round2(b, bitdepth - 8);
                                int pv = imax(0, as * n - bs * bs);
                                int z = int((int64_t(pv) * sc + (1 << 19)) >> 20);
                                int a2 = 256 - av1_sgr_x_by_x[imin(z, 255)];
                                int64_t b2 = int64_t(256 - a2) * b * one_over_n;
                                A[size_t(i + 1) * aw + j + 1] = a2;
                                B[size_t(i + 1) * aw + j + 1] = int((b2 + (1 << 11)) >> 12);
                            }
                        }
                        flt[pass].assign(size_t(h) * w, 0);
                        for (int i = 0; i < h; i++) {
                            int shift = (pass == 0 && (i & 1)) ? 4 : 5;
                            for (int j = 0; j < w; j++) {
                                int a = 0, b = 0;
                                for (int dy = -1; dy <= 1; dy++)
                                    for (int dx = -1; dx <= 1; dx++) {
                                        int wt;
                                        if (pass == 0) wt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                                        else wt = (dx == 0 || dy == 0) ? 4 : 3;
                                        a += wt * A[size_t(i + dy + 1) * aw + j + dx + 1];
                                        b += wt * B[size_t(i + dy + 1) * aw + j + dx + 1];
                                    }
                                int v = a * S(i, j) + b;
                                flt[pass][size_t(i) * w + j] = round2(v, 8 + shift - 4);
                            }
                        }
                    }
                    int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << 7) - w0 - w1;
                    for (int i = 0; i < h; i++)
                        for (int j = 0; j < w; j++) {
                            int uu = S(i, j) << 4;
                            int v = w1 * uu;
                            v += prm[0] ? w0 * flt[0][size_t(i) * w + j] : w0 * uu;
                            v += prm[2] ? w2 * flt[1][size_t(i) * w + j] : w2 * uu;
                            *out.at(y0 + i, x0 + j) = pixel(clip3(0, maxv, round2(v, 4 + 7)));
                        }
                }
            }
        });
        for (int64_t n : filtered) stats[12] += n;
        plane[p] = std::move(out);
    }
}

// ---- superres upscaling (specification 7.16, as dav1d's resize_c runs
// it): each plane from its downscaled width to its upscaled one, 8-tap
// Upscale_Filter phases stepped in 1/16384 pixels from the initial
// position, samples past the frame's 4x4 grid clamped to its edge; after
// CDEF, before loop restoration and film grain

void Decoder::superres_upscale() {
    if (!use_superres) return;
    const int maxv = (1 << bitdepth) - 1;
    for (int p = 0; p < num_planes; p++) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int in_w = (W + sx) >> sx, out_w = (UpW + sx) >> sx, h = (H + sy) >> sy;
        int src_w = (4 * MiCols + sx) >> sx;
        int step = ((in_w << 14) + (out_w >> 1)) / out_w;
        int err = out_w * step - (in_w << 14);
        int x0 = ((-((out_w - in_w) << 13) + (out_w >> 1)) / out_w + 128 - err / 2) & 0x3fff;
        Plane out;
        out.stride = out_w + 16;
        out.rows = h;
        out.px.assign(size_t(out.stride) * out.rows, 0);
        for (int y = 0; y < h; y++) {
            const pixel* src = plane[p].at(y, 0);
            pixel* dst = out.at(y, 0);
            int mx = x0, src_x = -1;
            for (int x = 0; x < out_w; x++) {
                const int16_t* F = av1_upscale_filter[mx >> 8];
                int sum = 0;
                for (int k = 0; k < 8; k++) sum += F[k] * src[clip3(0, src_w - 1, src_x - 3 + k)];
                dst[x] = pixel(clip3(0, maxv, (sum + 64) >> 7));
                mx += step;
                src_x += mx >> 14;
                mx &= 0x3fff;
            }
        }
        plane[p] = std::move(out);
    }
}

// ---- film grain synthesis (specification 7.18.3), applied to the output
// planes only

namespace grain_detail {
struct Rng {
    int r;
    int next(int bits) {
        int bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
        r = (r >> 1) | (bit << 15);
        return (r >> (16 - bits)) & ((1 << bits) - 1);
    }
};
void scaling_lut(const int (*pts)[2], int n, uint8_t* lut) {
    if (!n) { memset(lut, 0, 256); return; }
    for (int x = 0; x < pts[0][0]; x++) lut[x] = uint8_t(pts[0][1]);
    for (int i = 0; i < n - 1; i++) {
        int dy = pts[i + 1][1] - pts[i][1], dx = pts[i + 1][0] - pts[i][0];
        int delta = dy * ((65536 + (dx >> 1)) / dx);
        for (int x = 0; x < dx; x++) lut[pts[i][0] + x] = uint8_t(pts[i][1] + ((x * delta + 32768) >> 16));
    }
    for (int x = pts[n - 1][0]; x < 256; x++) lut[x] = uint8_t(pts[n - 1][1]);
}
}  // namespace grain_detail

void Decoder::film_grain(pixel* const out[3]) {
    using namespace grain_detail;
    const FilmGrain& g = fg;
    if (!g.apply) return;
    const int bs = bitdepth - 8;
    const int gmin = -(128 << bs), gmax = (128 << bs) - 1;
    // grain templates
    static thread_local int luma[73][82], cb[73][82], cr[73][82];
    Rng rng{g.seed};
    int shift = 12 - bitdepth + g.grain_scale_shift;
    for (int y = 0; y < 73; y++)
        for (int x = 0; x < 82; x++)
            luma[y][x] = g.num_y ? round2(av1_gaussian_sequence[rng.next(11)], shift) : 0;
    int ar_shift = g.ar_shift, lag = g.ar_lag;
    for (int y = 3; y < 73; y++)
        for (int x = 3; x < 82 - 3; x++) {
            int sum = 0, pos = 0;
            for (int dr = -lag; dr <= 0; dr++)
                for (int dc = -lag; dc <= lag; dc++) {
                    if (dr == 0 && dc == 0) break;
                    sum += luma[y + dr][x + dc] * g.ar_y[pos++];
                }
            luma[y][x] = clip3(gmin, gmax, luma[y][x] + round2(sum, ar_shift));
        }
    int cw_t = ssx ? 44 : 82, ch_t = ssy ? 38 : 73;
    if (!mono) {
        int (*cg[2])[82] = {cb, cr};
        for (int pl = 0; pl < 2; pl++) {
            rng.r = g.seed ^ (pl ? 0x49d8 : 0xb524);
            bool on = g.num_uv[pl] || g.csfl;
            for (int y = 0; y < ch_t; y++)
                for (int x = 0; x < cw_t; x++)
                    cg[pl][y][x] = on ? round2(av1_gaussian_sequence[rng.next(11)], shift) : 0;
        }
        for (int y = 3; y < ch_t; y++)
            for (int x = 3; x < cw_t - 3; x++) {
                int sum[2] = {0, 0}, pos = 0;
                for (int dr = -lag; dr <= 0; dr++)
                    for (int dc = -lag; dc <= lag; dc++) {
                        if (dr == 0 && dc == 0) {
                            if (g.num_y) {
                                int l = 0;
                                int lx = ((x - 3) << ssx) + 3, ly = ((y - 3) << ssy) + 3;
                                for (int i = 0; i <= ssy; i++)
                                    for (int j = 0; j <= ssx; j++) l += luma[ly + i][lx + j];
                                l = round2(l, ssx + ssy);
                                sum[0] += l * g.ar_uv[0][pos];
                                sum[1] += l * g.ar_uv[1][pos];
                            }
                            break;
                        }
                        sum[0] += g.ar_uv[0][pos] * cb[y + dr][x + dc];
                        sum[1] += g.ar_uv[1][pos] * cr[y + dr][x + dc];
                        pos++;
                    }
                for (int pl = 0; pl < 2; pl++)
                    if (g.num_uv[pl] || g.csfl)
                        cg[pl][y][x] = clip3(gmin, gmax, cg[pl][y][x] + round2(sum[pl], ar_shift));
            }
    }
    // scaling lookups
    uint8_t lut[3][256];
    scaling_lut(g.y_points, g.num_y, lut[0]);
    for (int pl = 0; pl < 2; pl++) {
        if (g.csfl) memcpy(lut[1 + pl], lut[0], 256);
        else scaling_lut(g.uv_points[pl], g.num_uv[pl], lut[1 + pl]);
    }
    // the scaling at depth: between two of the 256 entries, interpolated
    // (the specification's scale_lut; dav1d's high-bit-depth scaling table)
    auto scale = [&](int pl, int index) -> int {
        if (!bs) return lut[pl][index];
        int x = index >> bs, rem = index - (x << bs);
        if (x == 255) return lut[pl][255];
        int start = lut[pl][x], end = lut[pl][x + 1];
        return start + round2((end - start) * rem, bs);
    };
    // the noise image: 32x32 blocks (of luma) at random offsets, overlapped
    int w = UpW, h = H;
    int cw = (w + ssx) >> ssx, chh = (h + ssy) >> ssy;
    int nstripes = (h + 31) / 32;
    int np = mono ? 1 : 3;
    std::vector<int> stripe[3];  // [stripe][34][plane width + 34]
    int sw[3];
    for (int p = 0; p < np; p++) {
        int psx = p ? ssx : 0;
        sw[p] = ((w + psx) >> psx) + 34;
        stripe[p].assign(size_t(nstripes) * 34 * sw[p], 0);
    }
    for (int ln = 0; ln < nstripes; ln++) {
        Rng rr{g.seed};
        rr.r ^= ((ln * 37 + 178) & 255) << 8;
        rr.r ^= ((ln * 173 + 105) & 255);
        for (int x = 0; x < (w + 1) / 2; x += 16) {
            int rnd = rr.next(8);
            int ox = rnd >> 4, oy = rnd & 15;
            for (int p = 0; p < np; p++) {
                int psx = p ? ssx : 0, psy = p ? ssy : 0;
                int pox = psx ? 6 + ox : 9 + ox * 2, poy = psy ? 6 + oy : 9 + oy * 2;
                const int (*src)[82] = p == 0 ? luma : p == 1 ? cb : cr;
                int* st = &stripe[p][size_t(ln) * 34 * sw[p]];
                for (int i = 0; i < (34 >> psy); i++)
                    for (int j = 0; j < (34 >> psx); j++) {
                        int gv = src[poy + i][pox + j];
                        int col = psx ? x + j : x * 2 + j;
                        if (col >= sw[p]) continue;
                        int& o = st[size_t(i) * sw[p] + col];
                        if (!psx) {
                            if (j < 2 && g.overlap && x > 0) {
                                gv = j == 0 ? o * 27 + gv * 17 : o * 17 + gv * 27;
                                gv = clip3(gmin, gmax, round2(gv, 5));
                            }
                        } else if (j == 0 && g.overlap && x > 0) {
                            gv = clip3(gmin, gmax, round2(o * 23 + gv * 22, 5));
                        }
                        o = gv;
                    }
            }
        }
    }
    auto noise_at = [&](int p, int y, int x) {
        int psy = p ? ssy : 0;
        int ln = y >> (5 - psy), i = y - (ln << (5 - psy));
        int gv = stripe[p][(size_t(ln) * 34 + i) * sw[p] + x];
        if (g.overlap && ln > 0) {
            if (!psy && i < 2) {
                int o = stripe[p][(size_t(ln - 1) * 34 + i + 32) * sw[p] + x];
                gv = i == 0 ? o * 27 + gv * 17 : o * 17 + gv * 27;
                gv = clip3(gmin, gmax, round2(gv, 5));
            } else if (psy && i < 1) {
                int o = stripe[p][(size_t(ln - 1) * 34 + i + 16) * sw[p] + x];
                gv = clip3(gmin, gmax, round2(o * 23 + gv * 22, 5));
            }
        }
        return gv;
    };
    int minv = 0, maxl = (256 << bs) - 1, maxc = (256 << bs) - 1;
    if (g.clip_restricted) {
        minv = 16 << bs;
        maxl = 235 << bs;
        maxc = (mc == 0 ? 235 : 240) << bs;
    }
    const int maxv = (1 << bitdepth) - 1;
    int sshift = g.scaling_shift;
    stats[13] = (g.num_y > 0) + (mono ? 0 : (g.num_uv[0] || g.csfl) + (g.num_uv[1] || g.csfl));
    if (!mono) {
        for (int y = 0; y < chh; y++)
            for (int x = 0; x < cw; x++) {
                int lx = x << ssx, ly = y << ssy;
                int lnx = imin(lx + 1, w - 1);
                const pixel* yr = out[0] + size_t(ly) * w;
                int avg = ssx ? (yr[lx] + yr[lnx] + 1) >> 1 : yr[lx];
                for (int pl = 0; pl < 2; pl++) {
                    if (!(g.num_uv[pl] || g.csfl)) continue;
                    pixel* o = out[1 + pl] + size_t(y) * cw + x;
                    int orig = *o, merged;
                    if (g.csfl) merged = avg;
                    else merged = clip3(0, maxv, ((avg * g.uv_luma_mult[pl] + orig * g.uv_mult[pl]) >> 6) + g.uv_offset[pl] * (1 << bs));
                    int nz = round2(scale(1 + pl, merged) * noise_at(1 + pl, y, x), sshift);
                    *o = pixel(clip3(minv, maxc, orig + nz));
                }
            }
    }
    if (g.num_y)
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                pixel* o = out[0] + size_t(y) * w + x;
                int nz = round2(scale(0, *o) * noise_at(0, y, x), sshift);
                *o = pixel(clip3(minv, maxl, *o + nz));
            }
}

// ---------------------------------------------------------------------------
// OBU walk

struct Obus {
    Decoder dec;
    bool frame_done = false;

    // dav1d's metadata OBU checks: its type must be readable, and HDR CLL /
    // MDCV payloads hold their fields and a trailing bit; others are ignored
    static void parse_metadata(const uint8_t* d, size_t n) {
        size_t pos = 0;
        uint64_t type = leb128(d, n, &pos);
        if (type != 1 && type != 2) return;
        BitReader br(d + pos, n - pos);
        br.f(type == 1 ? 32 : 32 * 3 + 32 + 32 + 32);  // HDR CLL / MDCV fields
        br.trailing_bit();
    }

    // The OBUs after the frame: dav1d (with frame threads, as libavif runs
    // it) parses every OBU of the item before it outputs the frame, so an
    // error in any of them fails the decode. Their sequence and frame
    // headers are parsed (a tool the port does not read ends a header's
    // parse there, without error) and nothing more is decoded.
    Decoder later;
    bool later_frame = false;
    const uint8_t* seq_obu = nullptr;
    size_t seq_size = 0;

    void later_obu(int type, const uint8_t* body, size_t size, int temporal_id, int spatial_id) {
        switch (type) {
            case 1: {
                BitReader br(body, size);
                later = Decoder();
                later.parse_sequence_header(br);
                br.trailing_bit();
                break;
            }
            case 3: case 6: case 7: {
                if (!later.have_seq) fail("an AV1 frame header without a sequence header");
                if (!later.reduced && size && (body[0] & 0x80)) {
                    // show_existing_frame: of the hidden key frame, it shows it
                    // (with its film grain, load_grain_params)
                    BitReader br(body, size);
                    br.f(1);
                    int idx = later.parse_show_existing(br);
                    if (type != 6) br.trailing_bit();
                    if (!dec.show_frame && !dec.shown_existing) {
                        if (!dec.showable_frame || !((dec.refresh_frame_flags >> idx) & 1))
                            fail("show_existing_frame of AV1 slot %d, which holds no showable frame", idx);
                        dec.shown_existing = 1;
                    }
                    later_frame = false;
                    break;
                }
                later.header_only = true;
                later.have_frame_header = false;
                BitReader br(body, size);
                try {
                    later.parse_frame_header(br, temporal_id, spatial_id);
                    if (type != 6) br.trailing_bit();
                } catch (const Unported&) {
                    later_frame = true;  // dav1d parses what the port does not: accept it
                    break;
                }
                later_frame = true;
                if (type == 6) {
                    br.byte_align();
                    size_t off = br.pos >> 3;
                    if (off > size) fail("an AV1 frame OBU ends inside its header");
                    later_tile_group(body + off, size - off);
                }
                break;
            }
            case 4:
                if (!later_frame) fail("an AV1 tile group after its frame's tiles");
                later_tile_group(body, size);
                break;
            case 5:
                parse_metadata(body, size);
                break;
            default:
                break;
        }
    }

    void later_tile_group(const uint8_t* d, size_t n) {
        if (!later.have_frame_header) return;  // a header the port did not parse through
        BitReader br(d, n);
        int num_tiles = later.tile_cols * later.tile_rows;
        if (num_tiles > 1 && br.f(1)) {
            int bits = later.tile_cols_log2 + later.tile_rows_log2;
            int start = int(br.f(bits)), end = int(br.f(bits));
            if (start != 0 || end < start || end >= num_tiles)
                fail("AV1 tile group of tiles %d-%d in a later frame", start, end);
        }
    }

    void run(const uint8_t* d, size_t n, bool probe_only) {
        size_t pos = 0;
        while (pos < n) {
            uint8_t h = d[pos++];
            // the forbidden bit is not checked (dav1d ignores it)
            int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
            int temporal_id = 0, spatial_id = 0;
            if (ext) {
                if (pos >= n) fail("an OBU header runs past the end of the data");
                temporal_id = d[pos] >> 5;
                spatial_id = (d[pos] >> 3) & 3;
                pos++;
            }
            size_t size;
            if (has_size) {
                size = size_t(leb128(d, n, &pos));
                if (size > n - pos) fail("an OBU runs past the end of the data");
            } else {
                size = n - pos;
            }
            const uint8_t* body = d + pos;
            pos += size;
            if (ext && dec.have_seq && dec.op_idc[0]) {
                int in_t = (dec.op_idc[0] >> temporal_id) & 1;
                int in_s = (dec.op_idc[0] >> (spatial_id + 8)) & 1;
                if (type != 1 && type != 2 && (!in_t || !in_s)) continue;
            }
            if (frame_done) {
                later_obu(type, body, size, temporal_id, spatial_id);
                continue;
            }
            switch (type) {
                case 1: {
                    BitReader br(body, size);
                    dec.parse_sequence_header(br);
                    br.trailing_bit();
                    break;
                }
                case 5:
                    parse_metadata(body, size);
                    break;
                case 7:  // a redundant frame header: read as one before the frame header
                    if (dec.have_frame_header) break;
                    [[fallthrough]];
                case 3: case 6: {
                    if (dec.have_frame_header) fail("a second AV1 frame header before the frame's tiles");
                    BitReader br(body, size);
                    dec.parse_frame_header(br, temporal_id, spatial_id);
                    if (type != 6) br.trailing_bit();
                    if (probe_only) return;
                    if (type == 6) {
                        br.byte_align();
                        size_t off = br.pos >> 3;
                        if (off > size) fail("an AV1 frame OBU ends inside its header");
                        dec.parse_tile_group(body + off, size - off);
                    }
                    break;
                }
                case 4:
                    if (probe_only) fail("an AV1 tile group before its frame header");
                    dec.parse_tile_group(body, size);
                    break;
                case 2: case 8: case 15: default:
                    break;
            }
            if (type == 1) { seq_obu = body; seq_size = size; }
            if (dec.have_frame_header && dec.tiles_decoded == dec.tile_cols * dec.tile_rows) {
                frame_done = true;
                BitReader br(seq_obu, seq_size);  // its sequence header reads the OBUs that follow
                later.parse_sequence_header(br);
            }
        }
        if (!dec.have_seq) fail("no AV1 sequence header");
        if (!dec.have_frame_header) fail("no AV1 frame header");
        if (!probe_only && !frame_done)
            fail("AV1 frame data end after %d of %d tiles", dec.tiles_decoded, dec.tile_cols * dec.tile_rows);
        if (!probe_only && !dec.show_frame && !dec.shown_existing)
            unported("a hidden AV1 key frame that no show_existing_frame of its sample shows");
    }
};

void set_err(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        snprintf(err, size_t(errlen), "%s", msg);
    }
}

}  // namespace

extern "C" int akr_av1_probe(const uint8_t* data, int64_t size, int32_t* info, char* err,
                             int32_t errlen) {
    try {
        Obus o;
        o.run(data, size_t(size), true);
        Decoder& d = o.dec;
        int cdef_nonzero = 0;
        if (d.cdef_on)
            for (int i = 0; i < (1 << d.cdef_bits); i++)
                for (int k = 0; k < 4; k++) cdef_nonzero += d.cdef_strength[i][k] != 0;
        int32_t v[30] = {d.UpW, d.H, d.bitdepth, d.mono, d.ssx, d.ssy, d.color_range, d.cp,
                         d.tc, d.mc, d.csp, d.profile, d.use128, d.tx_mode,
                         d.allow_screen_content_tools, d.tile_cols, d.tile_rows, d.coded_lossless,
                         d.lf_level[0] | (d.lf_level[1] << 8) | (d.lf_level[2] << 16) |
                             (d.lf_level[3] << 24),
                         d.base_q_idx,
                         d.qm_level[0] | (d.qm_level[1] << 4) | (d.qm_level[2] << 8),
                         cdef_nonzero,
                         d.lr_type[0] | (d.lr_type[1] << 2) | (d.lr_type[2] << 4),
                         d.fg.apply, d.seg_enabled, d.delta_q_present, d.delta_lf_present,
                         d.allow_intrabc, d.superres_denom, !d.show_frame};
        memcpy(info, v, sizeof v);
        return 0;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// The payload of a sequence header OBU parsed alone: 0, or -1 with a message.
extern "C" int akr_av1_sequence_header(const uint8_t* data, int64_t size, char* err,
                                       int32_t errlen) {
    try {
        Decoder d;
        BitReader br(data, size_t(size));
        d.parse_sequence_header(br);
        return 0;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

extern "C" int akr_av1_decode(const uint8_t* data, int64_t size, uint16_t* y, uint16_t* u,
                              uint16_t* v, int64_t* stats, char* err, int32_t errlen) {
    try {
        g_itx_overflow = false;
        Obus o;
        o.run(data, size_t(size), false);
        Decoder& d = o.dec;
        if (g_itx_overflow) {
            if (d.bitdepth == 8)
                fail("an AV1 transform whose intermediate values leave the 16-bit range the "
                     "specification requires (a non-conformant stream, on which dav1d's x86 "
                     "assembly gives pixels of its own)");
            fail("an AV1 transform whose intermediate values leave the range the "
                 "specification requires at a bit depth of %d (a non-conformant stream, on "
                 "which dav1d's x86 assembly gives pixels of its own)", d.bitdepth);
        }
        d.loop_filter();
        Plane pre_cdef[3];
        if (d.uses_lr)
            for (int p = 0; p < d.num_planes; p++) pre_cdef[p] = d.plane[p];
        d.cdef();
        d.superres_upscale();
        d.loop_restoration(pre_cdef);
        if (stats) memcpy(stats, d.stats, sizeof d.stats);
        pixel* out[3] = {y, u, v};
        for (int p = 0; p < d.num_planes; p++) {
            int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
            int w = (d.UpW + sx) >> sx, h = (d.H + sy) >> sy;
            for (int r = 0; r < h; r++)
                memcpy(out[p] + size_t(r) * w, d.plane[p].at(r, 0), sizeof(pixel) * size_t(w));
        }
        d.film_grain(out);
        if (stats) memcpy(stats, d.stats, sizeof d.stats);
        return 0;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// ---------------------------------------------------------------------------
// YUV -> RGB as libavif 1.3.0 runs it through libyuv 1909 for 8-bit
// BT.601 / BT.709 / BT.2020 (NCL) full and limited range, with libyuv's
// bilinear chroma upsampling (libavif's AVIF_CHROMA_UPSAMPLING_AUTOMATIC):
//
//   y1 = ((y * 0x0101 * yg) >> 16) + yb
//   b = clamp((y1 + (u - 128) * ub) >> 6), g = clamp((y1 - ((u - 128) * ug
//       + (v - 128) * vg)) >> 6), r = clamp((y1 + (v - 128) * vr) >> 6)
//
// (libyuv's YuvPixel, row_common.cc, with the matrix's constants k = {yg,
// yb, ub, ug, vg, vr}). 4:2:0 chroma is upsampled as libyuv's
// I420ToRGB24MatrixBilinear does: the first row (and the last of an even
// height) with ScaleRowUp2_Linear (3:1 horizontally), the others in pairs
// with ScaleRowUp2_Bilinear (9:3:3:1), the first and last columns as its
// "Any" wrappers write them; 4:2:2 row by row with ScaleRowUp2_Linear;
// 4:0:0 reads u = v = 128.
//
//   void akr_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
//                       int32_t width, int32_t height, int32_t ssx,
//                       int32_t ssy, int32_t mono, const int32_t* k,
//                       uint8_t* rgb);

namespace {

template <class T>
void up_linear(const T* s, T* d, int w) {
    int work = (w - 1) & ~1;
    d[0] = s[0];
    for (int k = 0; k < work / 2; k++) {
        d[1 + 2 * k] = T((3 * s[k] + s[k + 1] + 2) >> 2);
        d[2 + 2 * k] = T((s[k] + 3 * s[k + 1] + 2) >> 2);
    }
    d[w - 1] = s[(w - 1) / 2];
}

template <class T>
void up_bilinear(const T* sa, const T* sb, T* da, T* db, int w) {
    int work = (w - 1) & ~1;
    da[0] = T((3 * sa[0] + sb[0] + 2) >> 2);
    db[0] = T((sa[0] + 3 * sb[0] + 2) >> 2);
    for (int k = 0; k < work / 2; k++) {
        int a0 = sa[k], a1 = sa[k + 1], b0 = sb[k], b1 = sb[k + 1];
        da[1 + 2 * k] = T((9 * a0 + 3 * a1 + 3 * b0 + b1 + 8) >> 4);
        da[2 + 2 * k] = T((3 * a0 + 9 * a1 + b0 + 3 * b1 + 8) >> 4);
        db[1 + 2 * k] = T((3 * a0 + a1 + 9 * b0 + 3 * b1 + 8) >> 4);
        db[2 + 2 * k] = T((a0 + 3 * a1 + 3 * b0 + 9 * b1 + 8) >> 4);
    }
    int last = (w - 1) / 2;
    da[w - 1] = T((3 * sa[last] + sb[last] + 2) >> 2);
    db[w - 1] = T((sa[last] + 3 * sb[last] + 2) >> 2);
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void yuv_row(const uint8_t* y, const uint8_t* u, const uint8_t* v, uint8_t* rgb, int w,
             const int32_t* k) {
    const int yg = k[0], yb = k[1], ub = k[2], ug = k[3], vg = k[4], vr = k[5];
    for (int x = 0; x < w; x++) {
        int y1 = int((uint32_t(y[x]) * 0x0101u * uint32_t(yg)) >> 16) + yb;
        int ui = int(u[x]) - 128, vi = int(v[x]) - 128;
        rgb[3 * x + 0] = clamp255((y1 + vi * vr) >> 6);
        rgb[3 * x + 1] = clamp255((y1 - (ui * ug + vi * vg)) >> 6);
        rgb[3 * x + 2] = clamp255((y1 + ui * ub) >> 6);
    }
}

}  // namespace

extern "C" void akr_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                               int32_t width, int32_t height, int32_t ssx, int32_t ssy,
                               int32_t mono, const int32_t* k, uint8_t* rgb) {
    const int w = width, h = height, cw = (w + ssx) >> ssx;
    std::vector<uint8_t> t(size_t(w) * 4 + 64, 128);
    uint8_t *u1 = t.data(), *u2 = u1 + w, *v1 = u2 + w, *v2 = v1 + w;
    const size_t row = size_t(w) * 3;
    if (mono) {
        for (int r = 0; r < h; r++) yuv_row(y + size_t(r) * w, u1, v1, rgb + r * row, w, k);
        return;
    }
    if (!ssx) {  // 4:4:4
        for (int r = 0; r < h; r++)
            yuv_row(y + size_t(r) * w, u + size_t(r) * w, v + size_t(r) * w, rgb + r * row, w, k);
        return;
    }
    if (!ssy) {  // 4:2:2
        for (int r = 0; r < h; r++) {
            up_linear(u + size_t(r) * cw, u1, w);
            up_linear(v + size_t(r) * cw, v1, w);
            yuv_row(y + size_t(r) * w, u1, v1, rgb + r * row, w, k);
        }
        return;
    }
    // 4:2:0
    const uint8_t *su = u, *sv = v;
    up_linear(su, u1, w);
    up_linear(sv, v1, w);
    yuv_row(y, u1, v1, rgb, w, k);
    int r = 1;
    for (int yy = 0; yy < h - 2; yy += 2) {
        up_bilinear(su, su + cw, u1, u2, w);
        up_bilinear(sv, sv + cw, v1, v2, w);
        yuv_row(y + size_t(r) * w, u1, v1, rgb + r * row, w, k);
        r++;
        yuv_row(y + size_t(r) * w, u2, v2, rgb + r * row, w, k);
        r++;
        su += cw;
        sv += cw;
    }
    if (!(h & 1)) {
        up_linear(su, u1, w);
        up_linear(sv, v1, w);
        yuv_row(y + size_t(r) * w, u1, v1, rgb + r * row, w, k);
    }
}

// ---------------------------------------------------------------------------
// libavif 1.3.0's avifImageScale: a frame (or alpha plane) whose size
// differs from its item's ispe or its track's tkhd is scaled to it, plane by
// plane, with libyuv's ScalePlane(kFilterBox) (scale.cc) as its x86-64 build
// runs it. ScaleFilterReduce turns the box filter into bilinear where an
// axis keeps half its size or more, bilinear into linear where the height
// is kept or divided by 3 (or is 1), linear into none where the width is
// (or 1); then the routes, in ScalePlane's order:
//
// - the width kept: ScalePlaneVertical (rows blended by InterpolateRow);
// - down by 3/4, 1/2, 3/8 or (box) 1/4 in both axes: ScalePlaneDown34 /
//   Down2 / Down38 / Down4 (the 3/4 and 3/8 rows of whole groups of 24 and
//   6 outputs by the SSSE3 rows, which average vertically first, the rest by
//   the C rows);
// - box, the height under half: ScalePlaneBox (sums of whole source
//   pixels times 65536 / area, >> 16);
// - up by 2 (linear, or bilinear in both axes): ScalePlaneUp2_Linear /
//   Up2_Bilinear (3:1 and 9:3:3:1);
// - bilinear up or down (ScalePlaneBilinearUp / Down): 16.16 steps,
//   InterpolateRow across rows, ScaleFilterCols_SSSE3 across columns (7-bit
//   fractions);
// - none: ScalePlaneSimple (nearest).
//
// The 16-bit planes of a high bit depth take ScalePlane_16's same routes
// with its C rows: the 3/4 and 3/8 rows without the SSSE3 rounding, 16-bit
// fractions across columns (ScaleFilterCols_16_C), 32-bit box sums.
//
//   void akr_scale_plane(const uint8_t* src, int32_t src_w, int32_t src_h,
//                        uint8_t* dst, int32_t dst_w, int32_t dst_h);
//   void akr_scale_plane16(...)  (the same of uint16_t planes)
// (planes packed, rows of their width)

namespace {
namespace yuv_scale {

enum Filter { kNone, kLinear, kBilinear, kBox };

int fixed_div(int num, int div) { return int((int64_t(num) << 16) / div); }
int fixed_div1(int num, int div) { return int(((int64_t(num) << 16) - 0x00010001) / (div - 1)); }
int center_start(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }
inline int avg(int a, int b) { return (a + b + 1) >> 1; }

Filter filter_reduce(int sw, int sh, int dw, int dh, Filter f) {
    if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
    if (f == kBilinear) {
        if (sh == 1 || dh == sh || dh * 3 == sh) f = kLinear;
        if (sw == 1) f = kNone;
    }
    if (f == kLinear && (sw == 1 || dw == sw || dw * 3 == sw)) f = kNone;
    return f;
}

void slope(int sw, int sh, int dw, int dh, Filter f, int* x, int* y, int* dx, int* dy) {
    *x = *y = *dx = *dy = 0;
    if (dw == 1 && sw >= 32768) dw = sw;
    if (dh == 1 && sh >= 32768) dh = sh;
    if (f == kBox) {
        *dx = fixed_div(sw, dw);
        *dy = fixed_div(sh, dh);
    } else if (f == kBilinear || f == kLinear) {
        if (dw <= sw) {
            *dx = fixed_div(sw, dw);
            *x = center_start(*dx, -32768);
        } else if (sw > 1 && dw > 1) {
            *dx = fixed_div1(sw, dw);
        }
        if (f == kLinear) {
            *dy = fixed_div(sh, dh);
            *y = *dy >> 1;
        } else if (dh <= sh) {
            *dy = fixed_div(sh, dh);
            *y = center_start(*dy, -32768);
        } else if (sh > 1 && dh > 1) {
            *dy = fixed_div1(sh, dh);
        }
    } else {
        *dx = fixed_div(sw, dw);
        *dy = fixed_div(sh, dh);
        *x = center_start(*dx, 0);
        *y = center_start(*dy, 0);
    }
}

// InterpolateRow: rows a and b blended by f / 256 (f = 0: a)
template <class T>
void interpolate_row(T* d, const T* a, const T* b, int w, int f) {
    if (!f) { memcpy(d, a, sizeof(T) * size_t(w)); return; }
    for (int x = 0; x < w; x++) d[x] = T((a[x] * (256 - f) + b[x] * f + 128) >> 8);
}

// ScaleFilterCols_SSSE3: 7-bit fractions of the 16.16 positions; 16-bit
// planes ScaleFilterCols_16_C: 16-bit fractions
template <class T>
void filter_cols(T* d, const T* s, int dw, int x, int dx) {
    for (int j = 0; j < dw; j++, x += dx) {
        int xi = x >> 16;
        if (sizeof(T) == 1) {
            int f = (x >> 9) & 127;
            d[j] = T(((128 - f) * s[xi] + f * s[xi + 1] + 64) >> 7);
        } else {
            int a = s[xi], b = s[xi + 1];
            d[j] = T(a + int((int64_t(x & 0xffff) * (b - a) + 0x8000) >> 16));
        }
    }
}

template <class T>
void vertical(const T* src, int sw, int sh, T* dst, int dh, Filter f) {
    int y = 0, dy = 0;
    if (dh <= sh) {
        dy = fixed_div(sh, dh);
        y = center_start(dy, -32768);
    } else if (sh > 1 && dh > 1) {
        dy = fixed_div1(sh, dh);
    }
    const int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
    for (int j = 0; j < dh; j++, y += dy) {
        if (y > max_y) y = max_y;
        const T* a = src + size_t(y >> 16) * sw;
        interpolate_row(dst + size_t(j) * sw, a, a + sw, sw, f ? (y >> 8) & 255 : 0);
    }
}

template <class T>
void down2(const T* src, int sw, T* dst, int dw, int dh) {
    for (int j = 0; j < dh; j++) {
        const T *s = src + size_t(2 * j) * sw, *t = s + sw;
        for (int x = 0; x < dw; x++)
            dst[size_t(j) * dw + x] = T((s[2 * x] + s[2 * x + 1] + t[2 * x] + t[2 * x + 1] + 2) >> 2);
    }
}

template <class T>
void down4(const T* src, int sw, T* dst, int dw, int dh) {
    for (int j = 0; j < dh; j++)
        for (int x = 0; x < dw; x++) {
            int sum = 0;
            for (int r = 0; r < 4; r++)
                for (int c = 0; c < 4; c++) sum += src[size_t(4 * j + r) * sw + 4 * x + c];
            dst[size_t(j) * dw + x] = T((sum + 8) >> 4);
        }
}

// a 3/4 row from rows s and t: rows 3:1 (w31) or 1:1; the first simd_n
// outputs as the SSSE3 row (vertically first), the rest as the C row
template <class T>
void down34_row(const T* s, const T* t, T* d, int dw, bool w31) {
    int simd_n = sizeof(T) == 1 ? dw - dw % 24 : 0;  // 16-bit planes: C rows only
    for (int x = 0, i = 0; x < dw; x += 3, i += 4) {
        if (x < simd_n) {
            int v[4];
            for (int k = 0; k < 4; k++) v[k] = w31 ? avg(s[i + k], avg(s[i + k], t[i + k])) : avg(s[i + k], t[i + k]);
            d[x] = T((3 * v[0] + v[1] + 2) >> 2);
            d[x + 1] = T((2 * v[1] + 2 * v[2] + 2) >> 2);
            d[x + 2] = T((v[2] + 3 * v[3] + 2) >> 2);
        } else {
            int a0 = (s[i] * 3 + s[i + 1] + 2) >> 2, a1 = (s[i + 1] + s[i + 2] + 1) >> 1,
                a2 = (s[i + 2] + s[i + 3] * 3 + 2) >> 2;
            int b0 = (t[i] * 3 + t[i + 1] + 2) >> 2, b1 = (t[i + 1] + t[i + 2] + 1) >> 1,
                b2 = (t[i + 2] + t[i + 3] * 3 + 2) >> 2;
            if (w31) {
                d[x] = T((a0 * 3 + b0 + 2) >> 2);
                d[x + 1] = T((a1 * 3 + b1 + 2) >> 2);
                d[x + 2] = T((a2 * 3 + b2 + 2) >> 2);
            } else {
                d[x] = T((a0 + b0 + 1) >> 1);
                d[x + 1] = T((a1 + b1 + 1) >> 1);
                d[x + 2] = T((a2 + b2 + 1) >> 1);
            }
        }
    }
}

template <class T>
void down34(const T* src, int sw, T* dst, int dw, int dh) {
    const T* s = src;
    T* d = dst;
    int y = 0;
    for (; y < dh - 2; y += 3) {
        down34_row(s, s + sw, d, dw, true);
        s += sw;
        d += dw;
        down34_row(s, s + sw, d, dw, false);
        s += sw;
        d += dw;
        down34_row(s + sw, s, d, dw, true);  // rows 3 and 2, 3:1
        s += 2 * sw;
        d += dw;
    }
    if (dh % 3 == 2) {
        down34_row(s, s + sw, d, dw, true);
        s += sw;
        d += dw;
        down34_row(s, s, d, dw, false);
    } else if (dh % 3 == 1) {
        down34_row(s, s, d, dw, true);
    }
}

// a 3/8 row from 3 rows (s, s + st, s + 2 st) or 2 (s, s + st); the first
// simd_n outputs of a 2-row box as the SSSE3 row (rows averaged first)
template <class T>
void down38_row(const T* s, ptrdiff_t st, T* d, int dw, bool three) {
    int simd_n = sizeof(T) == 1 ? dw - dw % 6 : 0;
    for (int x = 0, i = 0; x < dw; x += 3, i += 8) {
        if (three) {
            int c[8];
            for (int k = 0; k < 8; k++) c[k] = s[i + k] + s[i + k + st] + s[i + k + 2 * st];
            d[x] = T(((c[0] + c[1] + c[2]) * (65536 / 9)) >> 16);
            d[x + 1] = T(((c[3] + c[4] + c[5]) * (65536 / 9)) >> 16);
            d[x + 2] = T(((c[6] + c[7]) * (65536 / 6)) >> 16);
        } else if (x < simd_n) {
            int v[8];
            for (int k = 0; k < 8; k++) v[k] = avg(s[i + k], s[i + k + st]);
            d[x] = T(((v[0] + v[1] + v[2]) * (65536 / 3)) >> 16);
            d[x + 1] = T(((v[3] + v[4] + v[5]) * (65536 / 3)) >> 16);
            d[x + 2] = T(((v[6] + v[7]) * (65536 / 2)) >> 16);
        } else {
            int c[8];
            for (int k = 0; k < 8; k++) c[k] = s[i + k] + s[i + k + st];
            d[x] = T(((c[0] + c[1] + c[2]) * (65536 / 6)) >> 16);
            d[x + 1] = T(((c[3] + c[4] + c[5]) * (65536 / 6)) >> 16);
            d[x + 2] = T(((c[6] + c[7]) * (65536 / 4)) >> 16);
        }
    }
}

template <class T>
void down38(const T* src, int sw, T* dst, int dw, int dh) {
    const T* s = src;
    T* d = dst;
    int y = 0;
    for (; y < dh - 2; y += 3) {
        down38_row(s, sw, d, dw, true);
        s += 3 * sw;
        d += dw;
        down38_row(s, sw, d, dw, true);
        s += 3 * sw;
        d += dw;
        down38_row(s, sw, d, dw, false);
        s += 2 * sw;
        d += dw;
    }
    if (dh % 3 == 2) {
        down38_row(s, sw, d, dw, true);
        s += 3 * sw;
        d += dw;
        down38_row(s, 0, d, dw, true);
    } else if (dh % 3 == 1) {
        down38_row(s, 0, d, dw, true);
    }
}

template <class T>
void box(const T* src, int sw, int sh, T* dst, int dw, int dh) {
    int x0, y, dx, dy;
    slope(sw, sh, dw, dh, kBox, &x0, &y, &dx, &dy);
    const int max_y = sh << 16;
    std::vector<uint32_t> row(size_t(sw) + 1);
    auto min1 = [](int v) { return v < 1 ? 1 : v; };
    for (int j = 0; j < dh; j++) {
        int iy = y >> 16;
        y += dy;
        if (y > max_y) y = max_y;
        int bh = min1((y >> 16) - iy);
        std::fill(row.begin(), row.end(), 0u);
        for (int k = 0; k < bh; k++)
            for (int c = 0; c < sw; c++)  // ScaleAddRow_C's 16-bit sums, ScaleAddRow_16_C's 32
                row[c] = sizeof(T) == 1 ? uint16_t(row[c] + src[size_t(iy + k) * sw + c])
                                        : row[c] + src[size_t(iy + k) * sw + c];
        T* d = dst + size_t(j) * dw;
        if (dx & 0xffff) {  // ScaleAddCols2_C
            int minw = dx >> 16, x = x0;
            int tbl[2] = {65536 / (min1(minw) * bh), 65536 / (min1(minw + 1) * bh)};
            for (int i = 0; i < dw; i++) {
                int ix = x >> 16;
                x += dx;
                int bw = min1((x >> 16) - ix);
                uint32_t sum = 0;
                for (int k = 0; k < bw; k++) sum += row[ix + k];
                d[i] = T((sum * uint32_t(tbl[bw - minw])) >> 16);
            }
        } else if (dx != 0x10000) {  // ScaleAddCols1_C
            int bw = min1(dx >> 16), scale = 65536 / (bw * bh), x = x0 >> 16;
            for (int i = 0; i < dw; i++, x += bw) {
                uint32_t sum = 0;
                for (int k = 0; k < bw; k++) sum += row[x + k];
                d[i] = T((sum * uint32_t(scale)) >> 16);
            }
        } else {  // ScaleAddCols0_C
            int scale = 65536 / bh;
            for (int i = 0; i < dw; i++) d[i] = T((row[(x0 >> 16) + i] * uint32_t(scale)) >> 16);
        }
    }
}

// ScaleRowUp2_Linear / ScaleRowUp2_Bilinear (the rows of the YUV -> RGB
// chroma upsampling above)
template <class T>
void up2_linear(const T* src, int sw, int sh, T* dst, int dw, int dh) {
    if (dh == 1) {
        up_linear(src + size_t((sh - 1) / 2) * sw, dst, dw);
        return;
    }
    int dy = fixed_div(sh - 1, dh - 1), y = (1 << 15) - 1;
    for (int i = 0; i < dh; i++, y += dy) up_linear(src + size_t(y >> 16) * sw, dst + size_t(i) * dw, dw);
}

template <class T>
void up2_bilinear(const T* src, int sw, int sh, T* dst, int dw, int dh) {
    up_linear(src, dst, dw);
    T* d = dst + dw;
    const T* s = src;
    for (int x = 0; x < sh - 1; x++) {
        up_bilinear(s, s + sw, d, d + dw, dw);
        s += sw;
        d += 2 * size_t(dw);
    }
    if (!(dh & 1)) up_linear(s, d, dw);
}

template <class T>
void bilinear_up(const T* src, int sw, int sh, T* dst, int dw, int dh, Filter f) {
    int x, y, dx, dy;
    slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
    const int max_y = (sh - 1) << 16;
    if (y > max_y) y = max_y;
    const int row_size = (dw + 31) & ~31;
    std::vector<T> rows(size_t(row_size) * 2 + 64);
    T* rowptr = rows.data();
    int rowstride = row_size;
    int yi = y >> 16, lasty = yi;
    const T* s = src + size_t(yi) * sw;
    filter_cols(rowptr, s, dw, x, dx);
    if (sh > 1) s += sw;
    filter_cols(rowptr + rowstride, s, dw, x, dx);
    if (sh > 2) s += sw;
    for (int j = 0; j < dh; j++) {
        yi = y >> 16;
        if (yi != lasty) {
            if (y > max_y) {
                y = max_y;
                yi = y >> 16;
                s = src + size_t(yi) * sw;
            }
            if (yi != lasty) {
                filter_cols(rowptr, s, dw, x, dx);
                rowptr += rowstride;
                rowstride = -rowstride;
                lasty = yi;
                if ((y + 65536) < max_y) s += sw;
            }
        }
        T* d = dst + size_t(j) * dw;
        if (f == kLinear) interpolate_row(d, rowptr, rowptr, dw, 0);
        else interpolate_row(d, rowptr, rowptr + rowstride, dw, (y >> 8) & 255);
        y += dy;
    }
}

template <class T>
void bilinear_down(const T* src, int sw, int sh, T* dst, int dw, int dh, Filter f) {
    int x, y, dx, dy;
    slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
    const int max_y = (sh - 1) << 16;
    std::vector<T> row(size_t(sw) + 64);
    if (y > max_y) y = max_y;
    for (int j = 0; j < dh; j++) {
        const T* s = src + size_t(y >> 16) * sw;
        T* d = dst + size_t(j) * dw;
        if (f == kLinear) {
            filter_cols(d, s, dw, x, dx);
        } else {
            interpolate_row(row.data(), s, s + sw, sw, (y >> 8) & 255);
            filter_cols(d, row.data(), dw, x, dx);
        }
        y += dy;
        if (y > max_y) y = max_y;
    }
}

template <class T>
void simple(const T* src, int sw, int sh, T* dst, int dw, int dh) {
    int x0, y, dx, dy;
    slope(sw, sh, dw, dh, kNone, &x0, &y, &dx, &dy);
    bool up2 = sw * 2 == dw && x0 < 0x8000;
    for (int i = 0; i < dh; i++, y += dy) {
        const T* s = src + size_t(y >> 16) * sw;
        T* d = dst + size_t(i) * dw;
        if (up2) {
            for (int j = 0; j < dw; j++) d[j] = s[j >> 1];
        } else {
            int x = x0;
            for (int j = 0; j < dw; j++, x += dx) d[j] = s[x >> 16];
        }
    }
}

}  // namespace yuv_scale
}  // namespace

namespace {
template <class T>
void scale_plane(const T* src, int sw, int sh, T* dst, int dw, int dh) {
    using namespace yuv_scale;
    Filter f = filter_reduce(sw, sh, dw, dh, kBox);
    if (dw == sw && dh == sh) {
        memcpy(dst, src, sizeof(T) * size_t(sw) * sh);
    } else if (dw == sw && f != kBox) {
        vertical(src, sw, sh, dst, dh, f);
    } else if (dw <= sw && dh <= sh && 4 * dw == 3 * sw && 4 * dh == 3 * sh) {
        down34(src, sw, dst, dw, dh);
    } else if (dw <= sw && dh <= sh && 2 * dw == sw && 2 * dh == sh) {
        down2(src, sw, dst, dw, dh);
    } else if (dw <= sw && dh <= sh && 8 * dw == 3 * sw && 8 * dh == 3 * sh) {
        down38(src, sw, dst, dw, dh);
    } else if (dw <= sw && dh <= sh && 4 * dw == sw && 4 * dh == sh && (f == kBox || f == kNone)) {
        down4(src, sw, dst, dw, dh);
    } else if (f == kBox && dh * 2 < sh) {
        box(src, sw, sh, dst, dw, dh);
    } else if ((dw + 1) / 2 == sw && f == kLinear) {
        up2_linear(src, sw, sh, dst, dw, dh);
    } else if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kBilinear || f == kBox)) {
        up2_bilinear(src, sw, sh, dst, dw, dh);
    } else if (f != kNone && dh > sh) {
        bilinear_up(src, sw, sh, dst, dw, dh, f);
    } else if (f != kNone) {
        bilinear_down(src, sw, sh, dst, dw, dh, f);
    } else {
        simple(src, sw, sh, dst, dw, dh);
    }
}
}  // namespace

extern "C" void akr_scale_plane(const uint8_t* src, int32_t sw, int32_t sh, uint8_t* dst, int32_t dw,
                                int32_t dh) {
    scale_plane(src, sw, sh, dst, dw, dh);
}

// the same for the 16-bit planes of a high bit depth (libyuv's ScalePlane_16)
extern "C" void akr_scale_plane16(const uint16_t* src, int32_t sw, int32_t sh, uint16_t* dst,
                                  int32_t dw, int32_t dh) {
    scale_plane(src, sw, sh, dst, dw, dh);
}
