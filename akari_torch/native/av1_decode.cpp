// AV1 decoding of an AVIF item's or sample's OBUs (its shown frame: a key
// frame, or a frame decoded through the inter and intra-only frames of the
// sample) to YUV planes at 8, 10 or 12 bits, and the YUV -> RGB conversion,
// for akari_torch/core/avif.py.
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
//   headers of key, intra-only and inter frames, and the frames' tile
//   groups (OBU_FRAME, or OBU_FRAME_HEADER with OBU_TILE_GROUPs), uniform
//   and non-uniform tile spacing; the frames of the data decoded in turn
//   until one is shown (show_frame, or a show_existing_frame header naming
//   a showable slot), each refreshing its reference slots (7.20: the frame
//   after its loop filters, its sizes and order hints, the CDFs the context
//   tile ends with, counters cleared, unless disable_frame_end_update_cdf,
//   the loop-filter deltas, segmentation features and map, global motion
//   and film grain parameters, the motion field of 7.19);
// - every pixel is 16-bit; at 10 and 12 bits the dequantisation tables,
//   the coefficient and transform ranges, intra prediction's base value,
//   the sub-pixel filters' rounding (InterRound0 5 at 12 bits), the
//   deblocking limits, CDEF's strengths and damping, loop restoration's
//   rounding and scaling and film grain's ranges and scaling follow the
//   specification at BitDepth (dav1d's 16 bpc code);
// - superres (7.16): the frame decoded, deblocked and CDEF-filtered at its
//   downscaled width, then upscaled (Upscale_Filter, dav1d's resize_c),
//   with the deblocked rows loop restoration reads, before loop
//   restoration (units counted on the upscaled width, a superblock's
//   through SuperresDenom) and film grain; a frame superres leaves at its
//   width (under 16) is not upscaled, as in dav1d;
// - the symbol decoder, with CDF adaptation unless the frame disables it;
//   each tile starts from the primary reference frame's CDFs (load_cdfs),
//   or the default ones (av1_tables.h) with the coefficient CDFs of the
//   frame's qindex context;
// - partitions of 64x64 and 128x128 superblocks, intra mode info (key-frame
//   y modes with their above / left contexts, an inter frame's by block
//   size, uv modes with CfL, angle deltas, filter intra, palettes with
//   their colour cache and colour index maps, tx_size depth under
//   TX_MODE_SELECT), the skip flag;
// - inter frames (5.9.2, 5.11.18-5.11.33, 7.9-7.11): the header's
//   references, sizes, interpolation filter, motion modes, reference
//   select, skip mode (its two references), warped motion, global motion
//   against the primary reference's parameters, loop-filter deltas,
//   segmentation and film grain carried from it (update_grain 0 with the
//   frame's seed); skip_mode, is_inter, single and compound references
//   with every context; find_mv_stack (the spatial
//   scan, temporal candidates from the motion field projected from the
//   references' saved fields, the extra search, sorting, the contexts);
//   NEWMV / NEARESTMV / NEARMV / GLOBALMV and the compound modes with
//   drl_mode and read_mv; inter-intra (smooth masks and wedges), OBMC,
//   local warp (find_warp_samples, the least-squares fit, setupShear),
//   global warp, compound average, distance, wedge and difference-weighted
//   masks; the 8-tap (4-tap at 4 wide or high) sub-pixel filters with the
//   dual filters, chroma of sub-8x8 blocks from each luma block's vector;
//   inter residuals through the txfm_split tree and the inter transform
//   sets; intra-only frames read like key frames;
// - segmentation (the features of each segment, segment ids predicted from
//   the above, left and above-left blocks and read before or after skip,
//   or taken from the previous frame's map where the map is not updated;
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
//   and the reference and mode deltas, the level before the edge where the
//   block's is 0; sharpness; no inner transform edges in a skipped inter
//   block);
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
// made here holds one), switch frames, frame ids on an inter frame, a
// reference of another size (scaled prediction, superres on an inter
// frame), and the tools no file made here holds
// (segmentation_temporal_update, a frame size taken from a reference
// (found_ref), frame_refs_short_signaling, error-resilient inter frames,
// global motion of type TRANSLATION); a hidden key frame that no later
// frame may show; a sample whose frames are all hidden; so is a stream
// whose transforms leave the range the specification requires (see
// g_itx_overflow). An inter frame whose reference slots hold no frame
// fails, as it does in dav1d; a sequence header that differs from the one
// before it (its operating parameters aside) empties every slot first.
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
// data: the item's OBUs. info receives 30 values, of the header of the
// shown frame (of the last frame parsed where a show_existing_frame header
// shows a slot; of the first shown one where only headers are parsed, the
// frames hidden before it followed through): width (the upscaled
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
// denominator (8: none) and whether the sample's first frame was hidden. The 16-bit
// planes are written at the frame's size, chroma at ((width + ssx) >> ssx)
// x ((height + ssy) >> ssy); stats (may be null) receives N_STATS (35)
// counts over the frames decoded: blocks, luma palettes, chroma palettes,
// filter intra, CfL, tx_depth > 0 (or transform splits), luma transforms
// other than DCT_DCT, angle deltas, blocks of a nonzero segment,
// superblocks with a nonzero delta q, intra block copies, 8x8 blocks CDEF
// filtered, stripes of restoration units filtered, planes given grain;
// then the inter tools (the STAT_ enumeration).
// Returns 0, or -1 with a message in err.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <thread>
#include <utility>
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
        uint16_t classes[16], sign[2], class0[2], bits[10][2], class0_fr[2][4], class0_hp[2],
            fr[4], hp[2];
    } mv[2];
    // inter frames: an intra block's y mode, the inter modes and their
    // references, vectors (MvCtx 0: imv_joint, imv), filters and masks;
    // single_ref [p1..p6][ctx], comp_ref [comp_ref, p1, p2][ctx],
    // comp_bwd_ref [comp_bwdref, p1][ctx], uni_comp_ref [uni_comp_ref, p1, p2][ctx]
    uint16_t y_mode[4][16], wedge_index[9][16], compound_mode[8][8], interp_filter[2][8][4],
        interintra_mode[4][4], motion_mode[22][4], skip_mode[3][2], new_mv[6][2], zero_mv[2][2],
        ref_mv[6][2], drl_mode[3][2], is_inter[4][2], comp_mode[5][2], comp_ref_type[5][2],
        compound_idx[6][2], comp_group_idx[6][2], compound_type[9][2], single_ref[6][3][2],
        comp_ref[3][3][2], comp_bwd_ref[2][3][2], uni_comp_ref[3][3][2],
        interintra[4][2], wedge_interintra[7][2], use_obmc[22][2], imv_joint[4];
    MvComponent imv[2];

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
        CP(y_mode); CP(wedge_index); CP(compound_mode); CP(interp_filter); CP(interintra_mode);
        CP(motion_mode); CP(skip_mode); CP(new_mv); CP(zero_mv); CP(ref_mv); CP(drl_mode);
        CP(is_inter); CP(comp_mode); CP(comp_ref_type); CP(compound_idx); CP(comp_group_idx);
        CP(compound_type); CP(single_ref); CP(comp_ref); CP(comp_bwd_ref); CP(uni_comp_ref);
        CP(interintra); CP(wedge_interintra); CP(use_obmc);
#undef CP
        memcpy(imv_joint, av1_mv_joint, sizeof imv_joint);
        memcpy(txfm_split, av1_txfm_split, sizeof txfm_split);
        for (auto* set : {mv, imv})
            for (int k = 0; k < 2; k++) {
                MvComponent& c = set[k];
                memcpy(c.classes, av1_mv_classes, sizeof c.classes);
                memcpy(c.sign, av1_mv_sign, sizeof c.sign);
                memcpy(c.class0, av1_mv_class0, sizeof c.class0);
                memcpy(c.bits, av1_mv_bits, sizeof c.bits);
                memcpy(c.class0_fr, av1_mv_class0_fr, sizeof c.class0_fr);
                memcpy(c.class0_hp, av1_mv_class0_hp, sizeof c.class0_hp);
                memcpy(c.fr, av1_mv_fr, sizeof c.fr);
                memcpy(c.hp, av1_mv_hp, sizeof c.hp);
            }
        int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
#define CQ(name) memcpy(name, av1_##name[q], sizeof name)
        CQ(eob_pt16); CQ(eob_pt32); CQ(eob_pt64); CQ(eob_pt128); CQ(eob_pt256); CQ(eob_pt512);
        CQ(eob_pt1024); CQ(coeff_base_eob); CQ(coeff_base); CQ(coeff_br); CQ(eob_extra);
        CQ(txb_skip); CQ(dc_sign);
#undef CQ
    }

    // the adaptation counters (each CDF's slot after its last value) set to
    // 0, as the CDFs a frame saves for the frames after it are
    static void zero_counts(uint16_t* base, size_t bytes, int stride, int nsym) {
        for (size_t r = 0; r < bytes / (2 * size_t(stride)); r++) base[r * stride + nsym - 1] = 0;
    }
    void clear_counts() {
#define ZC(name, stride, nsym) zero_counts(&name[0], sizeof name, stride, nsym)
#define ZCN(name, stride, nsym) zero_counts(reinterpret_cast<uint16_t*>(name), sizeof name, stride, nsym)
        ZCN(kf_y_mode, 16, 13); ZCN(uv_mode_cfl_not_allowed, 16, 13); ZCN(uv_mode_cfl_allowed, 16, 14);
        ZCN(partition128, 8, 8); ZCN(partition64, 16, 10); ZCN(partition32, 16, 10);
        ZCN(partition16, 16, 10); ZCN(partition8, 4, 4); ZCN(cfl_alpha, 16, 16);
        ZCN(intra_tx_set1, 8, 7); ZCN(intra_tx_set2, 8, 5); ZC(cfl_sign, 8, 8);
        ZCN(angle_delta, 8, 7); ZC(filter_intra_mode, 8, 5); ZCN(palette_y_size, 8, 7);
        ZCN(palette_uv_size, 8, 7);
        for (int i = 0; i < 7; i++)
            for (int c = 0; c < 5; c++) {
                palette_y_color[i][c][i + 1] = 0;
                palette_uv_color[i][c][i + 1] = 0;
            }
        ZCN(tx_size8, 4, 2); ZCN(tx_size16, 4, 3); ZCN(tx_size32, 4, 3); ZCN(tx_size64, 4, 3);
        ZCN(use_filter_intra, 2, 2); ZCN(skip, 2, 2); ZCN(palette_y_mode, 2, 2);
        ZCN(palette_uv_mode, 2, 2); ZC(restoration_type, 4, 3); ZC(use_wiener, 2, 2);
        ZC(use_sgrproj, 2, 2);
        ZCN(eob_pt16, 8, 5); ZCN(eob_pt32, 8, 6); ZCN(eob_pt64, 8, 7); ZCN(eob_pt128, 8, 8);
        ZCN(eob_pt256, 16, 9); ZCN(eob_pt512, 16, 10); ZCN(eob_pt1024, 16, 11);
        ZCN(coeff_base_eob, 4, 3); ZCN(coeff_base, 4, 4); ZCN(coeff_br, 4, 4);
        ZCN(eob_extra, 2, 2); ZCN(txb_skip, 2, 2); ZCN(dc_sign, 2, 2);
        ZCN(seg_id, 8, 8); ZC(delta_q, 4, 4); ZCN(delta_lf, 4, 4); ZC(intrabc, 2, 2);
        ZCN(txfm_split, 2, 2); ZCN(inter_tx_set1, 16, 16); ZC(inter_tx_set2, 16, 12);
        ZCN(inter_tx_set3, 2, 2); ZC(mv_joint, 4, 4); ZC(imv_joint, 4, 4);
        for (auto* set : {mv, imv})
            for (int k = 0; k < 2; k++) {
                MvComponent& c = set[k];
                ZC(c.classes, 16, 11); ZC(c.sign, 2, 2); ZC(c.class0, 2, 2); ZCN(c.bits, 2, 2);
                ZCN(c.class0_fr, 4, 4); ZC(c.class0_hp, 2, 2); ZC(c.fr, 4, 4); ZC(c.hp, 2, 2);
            }
        ZCN(y_mode, 16, 13); ZCN(wedge_index, 16, 16); ZCN(compound_mode, 8, 8);
        ZCN(interp_filter, 4, 3); ZCN(interintra_mode, 4, 4); ZCN(motion_mode, 4, 3);
        ZCN(skip_mode, 2, 2); ZCN(new_mv, 2, 2); ZCN(zero_mv, 2, 2); ZCN(ref_mv, 2, 2);
        ZCN(drl_mode, 2, 2); ZCN(is_inter, 2, 2); ZCN(comp_mode, 2, 2); ZCN(comp_ref_type, 2, 2);
        ZCN(compound_idx, 2, 2); ZCN(comp_group_idx, 2, 2); ZCN(compound_type, 2, 2);
        ZCN(single_ref, 2, 2); ZCN(comp_ref, 2, 2); ZCN(comp_bwd_ref, 2, 2);
        ZCN(uni_comp_ref, 2, 2); ZCN(interintra, 2, 2);
        ZCN(wedge_interintra, 2, 2); ZCN(use_obmc, 2, 2);
#undef ZC
#undef ZCN
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

// frame types, reference frames (NONE: -1), the inter modes after the
// intra ones, global motion types, interpolation filters
enum { KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME };
enum { INTRA_FRAME, LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME, BWDREF_FRAME,
       ALTREF2_FRAME, ALTREF_FRAME };
const int PRIMARY_REF_NONE = 7;
enum { NEARESTMV = 13, NEARMV, GLOBALMV, NEWMV, NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV,
       NEW_NEARESTMV, NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV };
enum { GM_IDENTITY, GM_TRANSLATION, GM_ROTZOOM, GM_AFFINE };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { SIMPLE, OBMC, LOCALWARP };
enum { COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_INTRA, COMPOUND_DISTANCE };
const int INVALID_MV = -32768;

// the counts akr_av1_decode reports after its first 14 (inter frames)
enum { STAT_INTER = 14, STAT_INTRA_IN_INTER, STAT_SKIP_MODE, STAT_COMP_AVERAGE, STAT_COMP_DISTANCE,
       STAT_COMP_WEDGE, STAT_COMP_DIFFWTD, STAT_OBMC, STAT_LOCALWARP, STAT_GLOBALWARP,
       STAT_INTERINTRA, STAT_INTERINTRA_WEDGE, STAT_TEMPORAL, STAT_DUAL_FILTER, STAT_NEWMV,
       STAT_SUB8X8, STAT_FRAMES, STAT_INTRA_ONLY, STAT_GRAIN_LOADED, STAT_GLOBAL_MV,
       STAT_PALETTE_IN_INTER, STAT_LOSSLESS_INTER, N_STATS };

struct FilmGrain {
    int apply = 0, seed = 0, num_y = 0, y_points[14][2] = {{0}}, csfl = 0,
        num_uv[2] = {0}, uv_points[2][10][2] = {{{0}}}, scaling_shift = 8, ar_lag = 0,
        ar_y[24] = {0}, ar_uv[2][25] = {{0}}, ar_shift = 6, grain_scale_shift = 0,
        uv_mult[2] = {0}, uv_luma_mult[2] = {0}, uv_offset[2] = {0}, overlap = 0,
        clip_restricted = 0;
};

// a decoded frame's planes, after the loop filters and superres (film
// grain is applied to the output only)
struct Pixels {
    Plane p[3];
};

// the motion field a frame saves (7.19): per 8x8 block, the reference
// frame (0: none) and vector of its bottom-right 4x4 block
struct MotionField {
    std::vector<int8_t> ref;
    std::vector<int16_t> mv;  // row, column
};

// a reference slot (7.20): the frame and what later frames load from it
// (its sequence's subsampling, planes and depth with it)
struct RefSlot {
    bool valid = false;
    int order_hint = 0, upw = 0, h = 0, mi_cols = 0, mi_rows = 0, showable = 0;
    int ssx = 0, ssy = 0, mono = 0, bitdepth = 0;
    int saved_order_hints[8] = {0};
    int gm[8][6] = {{0}};
    int lf_ref_deltas[8] = {0}, lf_mode_deltas[2] = {0};
    int seg_feature[8][8] = {{0}}, seg_data[8][8] = {{0}};
    FilmGrain fg;
    std::shared_ptr<Cdfs> cdfs;
    std::shared_ptr<std::vector<uint8_t>> seg_map;
    std::shared_ptr<Pixels> px;
    std::shared_ptr<MotionField> mf;
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
    // the header's bits but each operating point's operating_parameters_info
    // (which may change within a sequence): dav1d starts a new sequence,
    // every reference dropped, where the rest differs from the header before
    std::vector<uint8_t> seq_bits;
    int enable_interintra = 0, enable_masked_compound = 0, enable_warped_motion = 0,
        enable_dual_filter = 0, enable_order_hint = 0, enable_jnt_comp = 0,
        enable_ref_frame_mvs = 0;
    bool have_seq = false;
    // the reference slots; refs_enabled: frames other than key frames are
    // decoded (not where only the headers after the shown frame are read)
    RefSlot refs[8];
    bool refs_enabled = true;
    // the frame's type and references: ref_frame_idx, OrderHints and the
    // sign biases per reference frame, the global motion (gm_type, gm, the
    // primary reference's prev_gm)
    int frame_type = 0, frame_is_intra = 1, error_resilient = 1, primary_ref_frame = 7,
        order_hint = 0, ref_frame_idx[7] = {0}, order_hints[8] = {0}, sign_bias[8] = {0};
    int force_integer_mv = 0, allow_high_precision_mv = 0, interpolation_filter = 0,
        is_motion_mode_switchable = 0, use_ref_frame_mvs = 0, reference_select = 0,
        skip_mode_present = 0, skip_mode_frame[2] = {0}, allow_warped_motion = 0;
    int gm_type[8] = {0}, gm[8][6] = {{0}}, prev_gm[8][6] = {{0}};
    int disable_frame_end_update_cdf = 1, context_update_tile_id = 0;
    int seg_update_map = 0, seg_temporal_update = 0;
    std::vector<uint8_t> prev_seg_ids;
    // the context tile's CDFs at its end
    Cdfs end_cdfs;
    // frame header: W the coded (superres-downscaled) width, UpW the
    // output width (W where superres is off)
    int W = 0, H = 0, UpW = 0, MiCols = 0, MiRows = 0, num_planes = 3;
    int use_superres = 0, superres_denom = 8;
    // show_frame, showable_frame, the slots the frame refreshes
    int show_frame = 1, showable_frame = 0, refresh_frame_flags = 0xFF;
    int disable_cdf_update = 0, allow_screen_content_tools = 0, allow_intrabc = 0;
    int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
    int tx_mode = 0, reduced_tx_set = 0;
    // lossless: each segment's (LosslessArray), every segment's
    // (CodedLossless; AllLossless is it without superres)
    int lossless_seg[8] = {0}, coded_lossless = 0;
    // segmentation (a key frame updates the map and the data): the
    // features of each segment and their values, SegIdPreSkip,
    // LastActiveSegId (-1: no feature on)
    enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_REF_FRAME = 5, SEG_LVL_SKIP = 6,
           SEG_LVL_GLOBALMV = 7 };
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
    int64_t stats[N_STATS] = {0};
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
    // the vectors (1/8 pel; list 0 row, column, list 1 row, column), the
    // reference frames (RefFrames: two per 4x4, -1 none), the filters (y,
    // x), skip_mode, comp_group_idx and compound_idx of each 4x4
    std::vector<int32_t> mvs;
    std::vector<int8_t> ref_frames;
    std::vector<uint8_t> interp_filter_, skip_mode_, comp_group_, compound_idx_;
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
    FilmGrain fg;

    int mi(int r, int c) const { return r * MiCols + c; }

    // ---- sequence header
    void parse_sequence_header(BitReader& br) {
        size_t start = br.pos;
        std::vector<std::pair<size_t, size_t>> op_params;  // bit ranges left out of seq_bits
        profile = int(br.f(3));
        if (profile > 2) fail("AV1 sequence profile %d", profile);
        still = int(br.f(1));
        reduced = int(br.f(1));
        if (reduced && !still) fail("a reduced still-picture header on a sequence that is not a still picture");
        decoder_model_info_present = equal_picture_interval = 0;
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
                        size_t from = br.pos;
                        br.f(buffer_delay_length);
                        br.f(buffer_delay_length);
                        br.f(1);
                        op_params.push_back({from, br.pos});
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
            enable_interintra = enable_masked_compound = enable_warped_motion = 0;
            enable_dual_filter = enable_order_hint = enable_jnt_comp = enable_ref_frame_mvs = 0;
        } else {
            enable_interintra = int(br.f(1));
            enable_masked_compound = int(br.f(1));
            enable_warped_motion = int(br.f(1));
            enable_dual_filter = int(br.f(1));
            enable_order_hint = int(br.f(1));
            enable_jnt_comp = enable_ref_frame_mvs = 0;
            if (enable_order_hint) {
                enable_jnt_comp = int(br.f(1));
                enable_ref_frame_mvs = int(br.f(1));
            }
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
        seq_bits.clear();
        size_t k = 0;
        for (size_t p = start; p < br.pos; p++) {
            if (k < op_params.size() && p == op_params[k].first) {
                p = op_params[k++].second - 1;
                continue;
            }
            seq_bits.push_back((br.d[p >> 3] >> (7 - (p & 7))) & 1);
        }
    }

    // dav1d on a sequence header that differs from the one before it: no
    // reference slot holds a frame, and a frame header awaiting its tiles
    // is dropped
    void new_sequence() {
        for (auto& r : refs) r = RefSlot();
        for (int i = 0; i < 8; i++) order_hints[i] = 0;
        have_frame_header = false;
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

    // ---- frame header (5.9): key, intra-only and inter frames
    int rel_dist(int a, int b) const {
        if (!enable_order_hint) return 0;
        int diff = a - b, m = 1 << (order_hint_bits - 1);
        return (diff & (m - 1)) - (diff & m);
    }

    // frame_size (with superres_params and compute_image_size): W the
    // superres-downscaled width, UpW the upscaled one
    void frame_size(BitReader& br, int override_flag) {
        if (override_flag) {
            UpW = int(br.f(frame_width_bits)) + 1;
            H = int(br.f(frame_height_bits)) + 1;
        } else {
            UpW = max_w;
            H = max_h;
        }
        superres_params(br);
    }
    void superres_params(BitReader& br) {
        use_superres = enable_superres ? int(br.f(1)) : 0;
        superres_denom = use_superres ? int(br.f(3)) + 9 : 8;
        W = imax((UpW * 8 + superres_denom / 2) / superres_denom, imin(16, UpW));
        MiCols = 2 * ((W + 7) >> 3);
        MiRows = 2 * ((H + 7) >> 3);
    }
    void render_size(BitReader& br) {
        if (br.f(1)) br.f(32);  // render_width_minus_1, render_height_minus_1
    }

    void parse_frame_header(BitReader& br, int temporal_id, int spatial_id) {
        if (!have_seq) fail("a frame header before any sequence header");
        frame_type = KEY_FRAME;
        error_resilient = 1;
        show_frame = 1;
        showable_frame = 0;
        refresh_frame_flags = 0xFF;
        if (!reduced) {
            if (br.f(1)) unported("show_existing_frame of a frame not decoded before it");
            frame_type = int(br.f(2));
            if (frame_type == SWITCH_FRAME) unported("an AV1 switch frame (frame_type 3)");
            if (frame_type != KEY_FRAME && !refs_enabled)
                unported("a non-key AV1 frame after the shown frame");
            show_frame = int(br.f(1));
            if (show_frame && decoder_model_info_present && !equal_picture_interval)
                br.f(frame_presentation_time_length);
            if (show_frame) {
                showable_frame = frame_type != KEY_FRAME;
            } else {
                showable_frame = int(br.f(1));
                if (!showable_frame && frame_type == KEY_FRAME)
                    unported("a hidden AV1 key frame that no later frame may show");
            }
            error_resilient = frame_type == KEY_FRAME && show_frame ? 1 : int(br.f(1));
            if (error_resilient && frame_type == INTER_FRAME)
                unported("an error-resilient AV1 inter frame (no file made here holds one)");
        }
        frame_is_intra = frame_type == KEY_FRAME || frame_type == INTRA_ONLY_FRAME;
        if (frame_type == KEY_FRAME && show_frame) {
            for (auto& r : refs) r = RefSlot();
            for (int i = 0; i < 8; i++) order_hints[i] = 0;
        }
        disable_cdf_update = int(br.f(1));
        allow_screen_content_tools = seq_force_screen_content_tools == 2
                                         ? int(br.f(1)) : seq_force_screen_content_tools;
        force_integer_mv = 0;
        if (allow_screen_content_tools)
            force_integer_mv = seq_force_integer_mv == 2 ? int(br.f(1)) : seq_force_integer_mv;
        if (frame_is_intra) force_integer_mv = 1;
        if (frame_id_numbers_present) {
            if (!frame_is_intra) unported("frame ids on an AV1 inter frame");
            br.f(id_len);
        }
        int frame_size_override = reduced ? 0 : int(br.f(1));
        order_hint = int(br.f(order_hint_bits));
        primary_ref_frame = frame_is_intra || error_resilient ? PRIMARY_REF_NONE : int(br.f(3));
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
        allow_high_precision_mv = use_ref_frame_mvs = allow_intrabc = 0;
        if (!(frame_type == KEY_FRAME && show_frame)) refresh_frame_flags = int(br.f(8));
        if (frame_type == INTRA_ONLY_FRAME && refresh_frame_flags == 0xFF)
            fail("an intra-only AV1 frame that refreshes every slot");
        if ((!frame_is_intra || refresh_frame_flags != 0xFF) && error_resilient && enable_order_hint)
            for (int i = 0; i < 8; i++) br.f(order_hint_bits);  // ref_order_hint (dav1d skips them)
        if (frame_is_intra) {
            frame_size(br, frame_size_override);
            render_size(br);
            if (allow_screen_content_tools && UpW == W) allow_intrabc = int(br.f(1));
        } else {
            if (enable_order_hint && br.f(1))
                unported("frame_refs_short_signaling (no file made here holds it)");
            for (int i = 0; i < 7; i++) {
                ref_frame_idx[i] = int(br.f(3));
                if (!refs[ref_frame_idx[i]].valid)
                    fail("an AV1 inter frame whose reference slot %d holds no frame", ref_frame_idx[i]);
            }
            if (frame_size_override && !error_resilient)  // frame_size_with_refs
                for (int i = 0; i < 7; i++)
                    if (br.f(1))
                        unported("an AV1 frame size taken from a reference (found_ref; no file "
                                 "made here holds it)");
            frame_size(br, frame_size_override);
            render_size(br);
            allow_high_precision_mv = force_integer_mv ? 0 : int(br.f(1));
            interpolation_filter = br.f(1) ? SWITCHABLE : int(br.f(2));
            is_motion_mode_switchable = int(br.f(1));
            use_ref_frame_mvs = error_resilient || !enable_ref_frame_mvs ? 0 : int(br.f(1));
            for (int i = 0; i < 7; i++) {
                const RefSlot& r = refs[ref_frame_idx[i]];
                if (r.upw != UpW || r.h != H || W != UpW)
                    unported("an AV1 inter frame with a reference of another size (scaled "
                             "prediction)");
                if (r.ssx != ssx || r.ssy != ssy || r.mono != mono || r.bitdepth != bitdepth)
                    fail("an AV1 inter frame whose reference slot %d holds a frame of another "
                         "subsampling or depth", ref_frame_idx[i]);
                order_hints[LAST_FRAME + i] = r.order_hint;
                sign_bias[LAST_FRAME + i] = rel_dist(r.order_hint, order_hint) > 0;
            }
        }
        disable_frame_end_update_cdf = reduced || disable_cdf_update ? 1 : int(br.f(1));
        // the primary reference frame's state (load_cdfs, load_previous), or
        // the defaults (setup_past_independence)
        const RefSlot* prev = primary_ref_frame == PRIMARY_REF_NONE
                                  ? nullptr : &refs[ref_frame_idx[primary_ref_frame]];
        static const int ref_defaults[8] = {1, 0, 0, 0, -1, 0, -1, -1};
        memcpy(lf_ref_deltas, ref_defaults, sizeof lf_ref_deltas);
        lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
        memset(seg_feature, 0, sizeof seg_feature);
        memset(seg_data, 0, sizeof seg_data);
        for (int r = 0; r < 8; r++)
            for (int i = 0; i < 6; i++) prev_gm[r][i] = i % 3 == 2 ? 1 << 16 : 0;
        if (prev) {
            memcpy(lf_ref_deltas, prev->lf_ref_deltas, sizeof lf_ref_deltas);
            memcpy(lf_mode_deltas, prev->lf_mode_deltas, sizeof lf_mode_deltas);
            memcpy(seg_feature, prev->seg_feature, sizeof seg_feature);
            memcpy(seg_data, prev->seg_data, sizeof seg_data);
            memcpy(prev_gm, prev->gm, sizeof prev_gm);
        }
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
        context_update_tile_id = 0;
        if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
            context_update_tile_id = int(br.f(tile_rows_log2 + tile_cols_log2));
            if (context_update_tile_id >= tile_cols * tile_rows)
                fail("AV1 context_update_tile_id %d of %d tiles", context_update_tile_id,
                     tile_cols * tile_rows);
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
        // copy is on); the deltas carried from the primary reference frame
        for (int i = 0; i < 4; i++) lf_level[i] = 0;
        lf_sharpness = 0;
        lf_delta_enabled = 0;
        if (coded_lossless || allow_intrabc) {
            memcpy(lf_ref_deltas, ref_defaults, sizeof lf_ref_deltas);
            lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
        } else {
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
        // (AllLossless: CodedLossless at the upscaled width)
        if (!(coded_lossless && W == UpW) && !allow_intrabc && enable_restoration) {
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
        reference_select = frame_is_intra ? 0 : int(br.f(1));
        skip_mode_params(br);
        allow_warped_motion = frame_is_intra || error_resilient || !enable_warped_motion
                                  ? 0 : int(br.f(1));
        reduced_tx_set = int(br.f(1));
        global_motion_params(br);
        parse_film_grain(br);
        have_frame_header = true;
        if (header_only) return;
        if (prev) frame_cdfs = *prev->cdfs;
        else frame_cdfs.init(base_q_idx);
        alloc_frame();
        // PrevSegmentIds (load_previous_segment_ids)
        prev_seg_ids.assign(size_t(MiRows) * MiCols, 0);
        if (prev && seg_enabled && prev->mi_cols == MiCols && prev->mi_rows == MiRows && prev->seg_map)
            prev_seg_ids = *prev->seg_map;
        if (!frame_is_intra) {
            interp_filter_.assign(size_t(MiRows) * MiCols * 2, 0);
            if (use_ref_frame_mvs) motion_field_estimation();
        }
    }

    // skip_mode_params (5.9.22): the nearest forward reference and the
    // nearest backward one (else the second nearest forward one)
    void skip_mode_params(BitReader& br) {
        skip_mode_present = 0;
        if (frame_is_intra || !reference_select || !enable_order_hint) return;
        int fwd = -1, bwd = -1, fwd_hint = 0, bwd_hint = 0;
        for (int i = 0; i < 7; i++) {
            int h = refs[ref_frame_idx[i]].order_hint;
            if (rel_dist(h, order_hint) < 0) {
                if (fwd < 0 || rel_dist(h, fwd_hint) > 0) { fwd = i; fwd_hint = h; }
            } else if (rel_dist(h, order_hint) > 0) {
                if (bwd < 0 || rel_dist(h, bwd_hint) < 0) { bwd = i; bwd_hint = h; }
            }
        }
        if (fwd < 0) return;
        if (bwd < 0) {
            int fwd2_hint = 0;
            for (int i = 0; i < 7; i++) {
                int h = refs[ref_frame_idx[i]].order_hint;
                if (rel_dist(h, fwd_hint) < 0 && (bwd < 0 || rel_dist(h, fwd2_hint) > 0)) {
                    bwd = i;
                    fwd2_hint = h;
                }
            }
            if (bwd < 0) return;
        }
        skip_mode_frame[0] = LAST_FRAME + imin(fwd, bwd);
        skip_mode_frame[1] = LAST_FRAME + imax(fwd, bwd);
        skip_mode_present = int(br.f(1));
    }

    // global_motion_params (5.9.24), each coded against the primary
    // reference frame's
    static int decode_subexp(BitReader& br, int num_syms) {
        int i = 0, mk = 0, k = 3;
        for (;;) {
            int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (num_syms <= mk + 3 * a) return br.ns(num_syms - mk) + mk;
            if (!br.f(1)) return int(br.f(b2)) + mk;
            i++;
            mk += a;
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
    }
    void read_global_param(BitReader& br, int type, int ref, int idx) {
        int abs_bits = 12, prec_bits = 15;
        if (idx < 2) {
            if (type == GM_TRANSLATION) {
                abs_bits = 9 - !allow_high_precision_mv;
                prec_bits = 3 - !allow_high_precision_mv;
            } else {
                abs_bits = 12;
                prec_bits = 6;
            }
        }
        int prec_diff = 16 - prec_bits;
        int round = idx % 3 == 2 ? 1 << 16 : 0, sub = idx % 3 == 2 ? 1 << prec_bits : 0;
        int mx = 1 << abs_bits;
        int r = (prev_gm[ref][idx] >> prec_diff) - sub;
        // decode_signed_subexp_with_ref(-mx, mx + 1, r)
        int low = -mx, high = mx + 1, n = high - low, rr = r - low;
        int v = decode_subexp(br, n);
        int x = (rr << 1) <= n ? inverse_recenter(rr, v) : n - 1 - inverse_recenter(n - 1 - rr, v);
        gm[ref][idx] = ((x + low) * (1 << prec_diff)) + round;
    }
    void global_motion_params(BitReader& br) {
        for (int ref = 0; ref < 8; ref++) {
            gm_type[ref] = GM_IDENTITY;
            for (int i = 0; i < 6; i++) gm[ref][i] = i % 3 == 2 ? 1 << 16 : 0;
        }
        if (frame_is_intra) return;
        for (int ref = LAST_FRAME; ref <= ALTREF_FRAME; ref++) {
            int type = GM_IDENTITY;
            if (br.f(1)) {
                if (br.f(1)) type = GM_ROTZOOM;
                else type = br.f(1) ? GM_TRANSLATION : GM_AFFINE;
            }
            if (type == GM_TRANSLATION)
                unported("an AV1 global motion of type TRANSLATION (no file made here holds one)");
            gm_type[ref] = type;
            if (type >= GM_ROTZOOM) {
                read_global_param(br, type, ref, 2);
                read_global_param(br, type, ref, 3);
                if (type == GM_AFFINE) {
                    read_global_param(br, type, ref, 4);
                    read_global_param(br, type, ref, 5);
                } else {
                    gm[ref][4] = -gm[ref][3];
                    gm[ref][5] = gm[ref][2];
                }
            }
            if (type >= GM_TRANSLATION) {
                read_global_param(br, type, ref, 0);
                read_global_param(br, type, ref, 1);
            }
        }
    }

    // segmentation_params: the map and the data updated, or carried from
    // the primary reference frame (load_previous); values clamped to the
    // features' ranges
    void parse_segmentation(BitReader& br) {
        static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0}, sgn[8] = {1, 1, 1, 1, 1, 0, 0, 0},
                         mx[8] = {255, 63, 63, 63, 63, 7, 0, 0};
        seg_enabled = int(br.f(1));
        seg_update_map = seg_temporal_update = 0;
        int update_data = 0;
        if (seg_enabled) {
            if (primary_ref_frame == PRIMARY_REF_NONE) {
                seg_update_map = 1;
                update_data = 1;
            } else {
                seg_update_map = int(br.f(1));
                if (seg_update_map) seg_temporal_update = int(br.f(1));
                if (seg_temporal_update)
                    unported("AV1 segment ids predicted from the previous frame's map "
                             "(segmentation_temporal_update; no file made here holds it)");
                update_data = int(br.f(1));
            }
        }
        if (!seg_enabled || update_data) {
            memset(seg_feature, 0, sizeof seg_feature);
            memset(seg_data, 0, sizeof seg_data);
        }
        if (update_data) {
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 8; j++) {
                    if (!br.f(1)) continue;
                    seg_feature[i][j] = 1;
                    int v = sgn[j] ? br.su(1 + bits[j]) : int(br.f(bits[j]));
                    seg_data[i][j] = clip3(sgn[j] ? -mx[j] : 0, mx[j], v);
                }
        }
        seg_preskip = 0;
        last_active_seg = -1;
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                if (seg_feature[i][j]) {
                    last_active_seg = i;
                    if (j >= SEG_LVL_REF_FRAME) seg_preskip = 1;
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
    // lf, the segment's ALT_LF feature, the reference and mode deltas
    int block_lf_level(int s, int i, const int* delta_lf, int ref, int mode) const {
        int delta = delta_lf[delta_lf_multi ? i : 0];
        int l = clip3(0, 63, delta + lf_level[i]);
        if (seg_active(s, SEG_LVL_ALT_LF_Y_V + i)) l = clip3(0, 63, l + seg_data[s][SEG_LVL_ALT_LF_Y_V + i]);
        if (lf_delta_enabled) {
            int sh = l >> 5;
            if (ref <= INTRA_FRAME) {
                l += lf_ref_deltas[INTRA_FRAME] * (1 << sh);
            } else {
                int mode_type = mode >= NEARESTMV && mode != GLOBALMV && mode != GLOBAL_GLOBALMV;
                l += lf_ref_deltas[ref] * (1 << sh) + lf_mode_deltas[mode_type] * (1 << sh);
            }
            l = clip3(0, 63, l);
        }
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
        lf_lvl.assign(n * 4, 0); mvs.assign(n * 4, 0); ref_frames.assign(n * 2, -1);
        skip_mode_.assign(n, 0); comp_group_.assign(n, 0); compound_idx_.assign(n, 0);
        for (int p = 0; p < 2; p++) { pal_size[p].assign(n, 0); pal_colors[p].assign(n * 8, 0); }
        tiles_decoded = 0;
        cdef_idx.assign(size_t((MiRows + 15) >> 4) * ((MiCols + 15) >> 4), -1);
        for (int p = 0; p < num_planes; p++) {
            lr_units[p].clear();
            lr_rows[p] = lr_cols[p] = 0;
            if (lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            lr_rows[p] = lr_count(lr_unit_size[p], round2(H, sy));
            lr_cols[p] = lr_count(lr_unit_size[p], round2(UpW, sx));
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
        if (frame_type == INTER_FRAME && !br.f(1)) {
            // update_grain 0: the parameters of a reference (load_grain_params)
            // with this frame's seed
            int idx = int(br.f(3)), k = 0;
            while (k < 7 && ref_frame_idx[k] != idx) k++;
            if (k == 7 || !refs[idx].valid)
                fail("AV1 film grain parameters of slot %d, not a reference of the frame", idx);
            int seed = fg.seed;
            stats[STAT_GRAIN_LOADED]++;
            fg = refs[idx].fg;
            fg.apply = 1;
            fg.seed = seed;
            return;
        }
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
    void superres_upscale(Plane* planes);
    // the motion field of the references (7.9): per 8x8 block, the vector
    // projected onto the frame and its reference offset (0: none)
    std::vector<int16_t> tpl_mv;
    std::vector<int8_t> tpl_off;
    void motion_field_estimation();
    bool projection(int src, int dst_sign);
    // after the last tile: the loop filters, then the reference slots the
    // frame refreshes; out_px the frame's planes
    std::shared_ptr<Pixels> out_px;
    void finish_frame();
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
        if (tr * f.tile_cols + tc == f.context_update_tile_id) f.end_cdfs = cdf;
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
            // units are counted on the upscaled width (5.11.57)
            bool up = f.W != f.UpW;
            int num = (4 >> sx) * (up ? f.superres_denom : 1), den = unit * (up ? 8 : 1);
            int col0 = (c * num + den - 1) / den;
            int col1 = imin(f.lr_cols[p], ((c + w) * num + den - 1) / den);
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
        if (f.frame_is_intra) {
            intra_frame_mode_info();
            mvv[0][0] = mv_r;
            mvv[0][1] = mv_c;
        } else {
            inter_frame_mode_info();
        }
        palette_tokens();
        if (is_inter) read_block_tx_size_inter();
        else read_tx_size();
        // store the block's mode info
        int lvl[4];
        for (int i = 0; i < 4; i++) lvl[i] = f.block_lf_level(seg_id, i, delta_lf, ref_frame[0], ymode);
        for (int y = 0; y < bh4; y++) {
            if (r + y >= f.MiRows) break;
            for (int x = 0; x < bw4; x++) {
                if (c + x >= f.MiCols) break;
                int i = f.mi(r + y, c + x);
                f.y_mode[i] = uint8_t(ymode);
                if (has_chroma && !is_inter) f.uv_mode[i] = uint8_t(uvmode);
                f.mi_size[i] = uint8_t(b);
                f.skip_[i] = uint8_t(skip);
                if (!is_inter) f.tx_size_[i] = uint8_t(txsz);  // else written by its tree
                f.pal_size[0][i] = uint8_t(pal_size_y);
                f.pal_size[1][i] = uint8_t(pal_size_uv);
                memcpy(&f.pal_colors[0][size_t(i) * 8], pal_y, 8);
                memcpy(&f.pal_colors[1][size_t(i) * 8], pal_u, 8);
                f.seg_ids[i] = uint8_t(seg_id);
                f.is_inter_[i] = uint8_t(is_inter);
                f.decoded_[i] = 1;
                memcpy(&f.mvs[4 * size_t(i)], mvv, sizeof(int32_t) * 4);
                f.ref_frames[2 * size_t(i)] = int8_t(ref_frame[0]);
                f.ref_frames[2 * size_t(i) + 1] = int8_t(ref_frame[1]);
                f.skip_mode_[i] = uint8_t(skip_mode);
                f.comp_group_[i] = uint8_t(comp_group_idx);
                f.compound_idx_[i] = uint8_t(compound_idx);
                if (!f.frame_is_intra) {
                    f.interp_filter_[2 * size_t(i)] = uint8_t(interp[0]);
                    f.interp_filter_[2 * size_t(i) + 1] = uint8_t(interp[1]);
                }
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
        if (!f.frame_is_intra) {
            f.stats[STAT_INTER] += is_inter;
            f.stats[STAT_INTRA_IN_INTER] += !is_inter;
            f.stats[STAT_SKIP_MODE] += skip_mode;
            if (ref_frame[1] > INTRA_FRAME) f.stats[compound_type == COMPOUND_AVERAGE ? STAT_COMP_AVERAGE
                                                     : compound_type == COMPOUND_DISTANCE ? STAT_COMP_DISTANCE
                                                     : compound_type == COMPOUND_WEDGE ? STAT_COMP_WEDGE
                                                     : STAT_COMP_DIFFWTD]++;
            f.stats[STAT_INTERINTRA] += interintra && !wedge_interintra;
            f.stats[STAT_GLOBAL_MV] += (ymode == GLOBALMV || ymode == GLOBAL_GLOBALMV) &&
                                       f.gm_type[ref_frame[0]] > GM_IDENTITY;
            f.stats[STAT_PALETTE_IN_INTER] += pal_size_y > 0 || pal_size_uv > 0;
            f.stats[STAT_LOSSLESS_INTER] += is_inter && lossless;
            f.stats[STAT_INTERINTRA_WEDGE] += interintra && wedge_interintra;
        }
        if (use_intrabc) predict_intrabc();
        else if (is_inter) predict_inter_block();
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
        is_inter = use_intrabc;
        skip_mode = 0;
        ref_frame[0] = INTRA_FRAME;
        ref_frame[1] = -1;
        interp[0] = interp[1] = 0;
        motion_mode = SIMPLE;
        compound_type = COMPOUND_AVERAGE;
        comp_group_idx = 0;
        compound_idx = 1;
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
        intra_modes_after_y();
    }

    // an intra block's modes after its y mode: angle deltas, the uv mode
    // and CfL, palettes, filter intra
    void intra_modes_after_y() {
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

    // ==== inter frames: mode info (5.11.18-5.11.33)
    int is_inter = 0, skip_mode = 0, ref_frame[2] = {INTRA_FRAME, -1}, mvv[2][2] = {{0, 0}, {0, 0}};
    int interp[2] = {0, 0}, motion_mode = SIMPLE, interintra = 0, interintra_mode = 0,
        wedge_interintra = 0, wedge_index = 0, wedge_sign = 0, mask_type = 0,
        compound_type = COMPOUND_AVERAGE, comp_group_idx = 0, compound_idx = 1, ref_mv_idx = 0;
    int above_ref[2] = {INTRA_FRAME, -1}, left_ref[2] = {INTRA_FRAME, -1};
    bool above_intra = true, left_intra = true, above_single = true, left_single = true;
    static constexpr int kSizeGroup[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0,
                                           1, 1, 2, 2};
    static constexpr int kWedgeBits[22] = {0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0,
                                           4, 4, 0, 0};

    int mi_ref(int r, int c, int list) const { return f.ref_frames[2 * size_t(f.mi(r, c)) + list]; }
    const int32_t* mi_mv(int r, int c, int list) const {
        return &f.mvs[4 * size_t(f.mi(r, c)) + 2 * list];
    }

    void inter_frame_mode_info() {
        use_intrabc = 0;
        above_ref[0] = avail_u ? mi_ref(mi_row - 1, mi_col, 0) : INTRA_FRAME;
        above_ref[1] = avail_u ? mi_ref(mi_row - 1, mi_col, 1) : -1;
        left_ref[0] = avail_l ? mi_ref(mi_row, mi_col - 1, 0) : INTRA_FRAME;
        left_ref[1] = avail_l ? mi_ref(mi_row, mi_col - 1, 1) : -1;
        above_intra = above_ref[0] <= INTRA_FRAME;
        left_intra = left_ref[0] <= INTRA_FRAME;
        above_single = above_ref[1] <= INTRA_FRAME;
        left_single = left_ref[1] <= INTRA_FRAME;
        skip = 0;
        seg_id = 0;
        inter_segment_id(true);
        read_skip_mode();
        if (skip_mode) {
            skip = 1;
        } else if (f.seg_preskip && f.seg_active(seg_id, Decoder::SEG_LVL_SKIP)) {
            skip = 1;
        } else {
            int ctx = (avail_u ? f.skip_[f.mi(mi_row - 1, mi_col)] : 0) +
                      (avail_l ? f.skip_[f.mi(mi_row, mi_col - 1)] : 0);
            skip = sd.read(cdf.skip[ctx], 2);
        }
        if (!f.seg_preskip) inter_segment_id(false);
        lossless = f.lossless_seg[seg_id];
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        qindex = f.seg_qindex(seg_id, f.delta_q_present ? cur_qidx : f.base_q_idx);
        read_is_inter();
        // defaults of the inter syntax (an intra block reads none of it)
        motion_mode = SIMPLE;
        interintra = wedge_interintra = 0;
        compound_type = COMPOUND_AVERAGE;
        comp_group_idx = 0;
        compound_idx = 1;
        interp[0] = interp[1] = 0;
        mvv[0][0] = mvv[0][1] = mvv[1][0] = mvv[1][1] = 0;
        if (is_inter) {
            inter_block_mode_info();
        } else {
            ref_frame[0] = INTRA_FRAME;
            ref_frame[1] = -1;
            ymode = sd.read(cdf.y_mode[kSizeGroup[mi_sz]], 13);
            intra_modes_after_y();
        }
    }

    // get_segment_id: the least of PrevSegmentIds over the block
    int predicted_segment_id() {
        int seg = 7;
        for (int y = 0; y < imin(bh4, f.MiRows - mi_row); y++)
            for (int x = 0; x < imin(bw4, f.MiCols - mi_col); x++)
                seg = imin(seg, f.prev_seg_ids[f.mi(mi_row + y, mi_col + x)]);
        return seg;
    }
    void inter_segment_id(bool pre_skip) {
        if (!f.seg_enabled) {
            seg_id = 0;
            return;
        }
        int pred = predicted_segment_id();
        if (!f.seg_update_map) {
            seg_id = pred;
            return;
        }
        if (pre_skip && !f.seg_preskip) {
            seg_id = 0;
            return;
        }
        if (!pre_skip && skip) {
            read_segment_id();
            return;
        }
        read_segment_id();  // (segmentation_temporal_update is refused)
    }

    void read_skip_mode() {
        skip_mode = 0;
        if (f.seg_active(seg_id, Decoder::SEG_LVL_SKIP) || f.seg_active(seg_id, Decoder::SEG_LVL_REF_FRAME) ||
            f.seg_active(seg_id, Decoder::SEG_LVL_GLOBALMV) || !f.skip_mode_present ||
            kBw[mi_sz] < 8 || kBh[mi_sz] < 8)
            return;
        int ctx = (avail_u ? f.skip_mode_[f.mi(mi_row - 1, mi_col)] : 0) +
                  (avail_l ? f.skip_mode_[f.mi(mi_row, mi_col - 1)] : 0);
        skip_mode = sd.read(cdf.skip_mode[ctx], 2);
    }

    void read_is_inter() {
        if (skip_mode) {
            is_inter = 1;
        } else if (f.seg_active(seg_id, Decoder::SEG_LVL_REF_FRAME)) {
            is_inter = f.seg_data[seg_id][Decoder::SEG_LVL_REF_FRAME] != INTRA_FRAME;
        } else if (f.seg_active(seg_id, Decoder::SEG_LVL_GLOBALMV)) {
            is_inter = 1;
        } else {
            int ctx;
            if (avail_u && avail_l) ctx = left_intra && above_intra ? 3 : (left_intra || above_intra ? 1 : 0);
            else if (avail_u || avail_l) ctx = 2 * (avail_u ? above_intra : left_intra);
            else ctx = 0;
            is_inter = sd.read(cdf.is_inter[ctx], 2);
        }
    }

    // ---- reference frames (read_ref_frames) and their contexts (8.3.2)
    int count_refs(int t) const {
        int c = 0;
        if (avail_u) c += (above_ref[0] == t) + (above_ref[1] == t);
        if (avail_l) c += (left_ref[0] == t) + (left_ref[1] == t);
        return c;
    }
    static int ref_count_ctx(int c0, int c1) { return c0 < c1 ? 0 : (c0 == c1 ? 1 : 2); }
    static bool check_backward(int r) { return r >= BWDREF_FRAME && r <= ALTREF_FRAME; }
    int comp_mode_ctx() const {
        if (avail_u && avail_l) {
            if (above_single && left_single)
                return check_backward(above_ref[0]) ^ check_backward(left_ref[0]);
            if (above_single) return 2 + (check_backward(above_ref[0]) || above_intra);
            if (left_single) return 2 + (check_backward(left_ref[0]) || left_intra);
            return 4;
        }
        if (avail_u) return above_single ? check_backward(above_ref[0]) : 3;
        if (avail_l) return left_single ? check_backward(left_ref[0]) : 3;
        return 1;
    }
    int comp_ref_type_ctx() const {
        auto samedir = [](int a, int b) { return (a >= BWDREF_FRAME) == (b >= BWDREF_FRAME); };
        int a0 = above_ref[0], a1 = above_ref[1], l0 = left_ref[0], l1 = left_ref[1];
        bool above_comp = avail_u && !above_intra && !above_single;
        bool left_comp = avail_l && !left_intra && !left_single;
        bool above_uni = above_comp && samedir(a0, a1);
        bool left_uni = left_comp && samedir(l0, l1);
        if (avail_u && !above_intra && avail_l && !left_intra) {
            int same = samedir(a0, l0);
            if (!above_comp && !left_comp) return 1 + 2 * same;
            if (!above_comp) return left_uni ? 3 + same : 1;
            if (!left_comp) return above_uni ? 3 + same : 1;
            if (!above_uni && !left_uni) return 0;
            if (!above_uni || !left_uni) return 2;
            return 3 + ((a0 == BWDREF_FRAME) == (l0 == BWDREF_FRAME));
        }
        if (avail_u && avail_l) {
            if (above_comp) return 1 + 2 * above_uni;
            if (left_comp) return 1 + 2 * left_uni;
            return 2;
        }
        if (above_comp) return 4 * above_uni;
        if (left_comp) return 4 * left_uni;
        return 2;
    }
    int fwd_bwd_ctx() const {
        return ref_count_ctx(count_refs(LAST_FRAME) + count_refs(LAST2_FRAME) + count_refs(LAST3_FRAME) +
                                 count_refs(GOLDEN_FRAME),
                             count_refs(BWDREF_FRAME) + count_refs(ALTREF2_FRAME) + count_refs(ALTREF_FRAME));
    }
    int last12_ctx() const {
        return ref_count_ctx(count_refs(LAST_FRAME) + count_refs(LAST2_FRAME),
                             count_refs(LAST3_FRAME) + count_refs(GOLDEN_FRAME));
    }
    int bwd_alt2_ctx() const {
        return ref_count_ctx(count_refs(BWDREF_FRAME) + count_refs(ALTREF2_FRAME), count_refs(ALTREF_FRAME));
    }

    void read_ref_frames() {
        if (skip_mode) {
            ref_frame[0] = f.skip_mode_frame[0];
            ref_frame[1] = f.skip_mode_frame[1];
            return;
        }
        ref_frame[1] = -1;
        if (f.seg_active(seg_id, Decoder::SEG_LVL_REF_FRAME)) {
            ref_frame[0] = f.seg_data[seg_id][Decoder::SEG_LVL_REF_FRAME];
            return;
        }
        if (f.seg_active(seg_id, Decoder::SEG_LVL_SKIP) || f.seg_active(seg_id, Decoder::SEG_LVL_GLOBALMV)) {
            ref_frame[0] = LAST_FRAME;
            return;
        }
        int comp = f.reference_select && imin(bw4, bh4) >= 2 ? sd.read(cdf.comp_mode[comp_mode_ctx()], 2) : 0;
        if (comp) {
            int type = sd.read(cdf.comp_ref_type[comp_ref_type_ctx()], 2);
            if (type == 0) {  // UNIDIR_COMP_REFERENCE
                if (sd.read(cdf.uni_comp_ref[0][fwd_bwd_ctx()], 2)) {
                    ref_frame[0] = BWDREF_FRAME;
                    ref_frame[1] = ALTREF_FRAME;
                } else {
                    int c1 = ref_count_ctx(count_refs(LAST2_FRAME), count_refs(LAST3_FRAME) + count_refs(GOLDEN_FRAME));
                    ref_frame[0] = LAST_FRAME;
                    if (sd.read(cdf.uni_comp_ref[1][c1], 2)) {
                        int c2 = ref_count_ctx(count_refs(LAST3_FRAME), count_refs(GOLDEN_FRAME));
                        ref_frame[1] = sd.read(cdf.uni_comp_ref[2][c2], 2) ? GOLDEN_FRAME : LAST3_FRAME;
                    } else {
                        ref_frame[1] = LAST2_FRAME;
                    }
                }
            } else {
                if (sd.read(cdf.comp_ref[0][last12_ctx()], 2) == 0) {
                    int c = ref_count_ctx(count_refs(LAST_FRAME), count_refs(LAST2_FRAME));
                    ref_frame[0] = sd.read(cdf.comp_ref[1][c], 2) ? LAST2_FRAME : LAST_FRAME;
                } else {
                    int c = ref_count_ctx(count_refs(LAST3_FRAME), count_refs(GOLDEN_FRAME));
                    ref_frame[0] = sd.read(cdf.comp_ref[2][c], 2) ? GOLDEN_FRAME : LAST3_FRAME;
                }
                if (sd.read(cdf.comp_bwd_ref[0][bwd_alt2_ctx()], 2) == 0) {
                    int c = ref_count_ctx(count_refs(BWDREF_FRAME), count_refs(ALTREF2_FRAME));
                    ref_frame[1] = sd.read(cdf.comp_bwd_ref[1][c], 2) ? ALTREF2_FRAME : BWDREF_FRAME;
                } else {
                    ref_frame[1] = ALTREF_FRAME;
                }
            }
            return;
        }
        if (sd.read(cdf.single_ref[0][fwd_bwd_ctx()], 2)) {
            if (sd.read(cdf.single_ref[1][bwd_alt2_ctx()], 2) == 0) {
                int c = ref_count_ctx(count_refs(BWDREF_FRAME), count_refs(ALTREF2_FRAME));
                ref_frame[0] = sd.read(cdf.single_ref[5][c], 2) ? ALTREF2_FRAME : BWDREF_FRAME;
            } else {
                ref_frame[0] = ALTREF_FRAME;
            }
        } else if (sd.read(cdf.single_ref[2][last12_ctx()], 2)) {
            int c = ref_count_ctx(count_refs(LAST3_FRAME), count_refs(GOLDEN_FRAME));
            ref_frame[0] = sd.read(cdf.single_ref[4][c], 2) ? GOLDEN_FRAME : LAST3_FRAME;
        } else {
            int c = ref_count_ctx(count_refs(LAST_FRAME), count_refs(LAST2_FRAME));
            ref_frame[0] = sd.read(cdf.single_ref[3][c], 2) ? LAST2_FRAME : LAST_FRAME;
        }
    }

    // ---- the modes (inter_block_mode_info)
    static bool has_newmv(int m) {
        return m == NEWMV || m == NEW_NEWMV || m == NEAR_NEWMV || m == NEW_NEARMV ||
               m == NEAREST_NEWMV || m == NEW_NEARESTMV;
    }
    int get_mode(int list) const {
        if (list == 0) {
            if (ymode < NEAREST_NEARESTMV) return ymode;
            if (ymode == NEW_NEWMV || ymode == NEW_NEARESTMV || ymode == NEW_NEARMV) return NEWMV;
            if (ymode == NEAREST_NEARESTMV || ymode == NEAREST_NEWMV) return NEARESTMV;
            if (ymode == NEAR_NEARMV || ymode == NEAR_NEWMV) return NEARMV;
            return GLOBALMV;
        }
        if (ymode == NEW_NEWMV || ymode == NEAREST_NEWMV || ymode == NEAR_NEWMV) return NEWMV;
        if (ymode == NEAREST_NEARESTMV || ymode == NEW_NEARESTMV) return NEARESTMV;
        if (ymode == NEAR_NEARMV || ymode == NEW_NEARMV) return NEARMV;
        return GLOBALMV;
    }

    void inter_block_mode_info() {
        pal_size_y = pal_size_uv = 0;
        memset(pal_y, 0, 8); memset(pal_u, 0, 8); memset(pal_v, 0, 8);
        use_filter_intra = 0;
        angle_delta_y = angle_delta_uv = 0;
        uvmode = DC_PRED;
        read_ref_frames();
        bool comp = ref_frame[1] > INTRA_FRAME;
        find_mv_stack(comp);
        if (skip_mode) {
            ymode = NEAREST_NEARESTMV;
        } else if (f.seg_active(seg_id, Decoder::SEG_LVL_SKIP) || f.seg_active(seg_id, Decoder::SEG_LVL_GLOBALMV)) {
            ymode = GLOBALMV;
        } else if (comp) {
            static const int ctx_map[3][5] = {{0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
            int ctx = ctx_map[ref_mv_ctx >> 1][imin(new_mv_ctx, 4)];
            ymode = NEAREST_NEARESTMV + sd.read(cdf.compound_mode[ctx], 8);
        } else if (sd.read(cdf.new_mv[new_mv_ctx], 2) == 0) {
            ymode = NEWMV;
        } else if (sd.read(cdf.zero_mv[zero_mv_ctx], 2) == 0) {
            ymode = GLOBALMV;
        } else {
            ymode = sd.read(cdf.ref_mv[ref_mv_ctx], 2) == 0 ? NEARESTMV : NEARMV;
        }
        ref_mv_idx = 0;
        if (ymode == NEWMV || ymode == NEW_NEWMV) {
            for (int idx = 0; idx < 2; idx++) {
                if (num_mv_found > idx + 1) {
                    int drl = sd.read(cdf.drl_mode[drl_ctx[idx]], 2);
                    if (drl == 0) { ref_mv_idx = idx; break; }
                    ref_mv_idx = idx + 1;
                }
            }
        } else if (ymode == NEARMV || ymode == NEAR_NEARMV || ymode == NEAR_NEWMV || ymode == NEW_NEARMV) {
            ref_mv_idx = 1;
            for (int idx = 1; idx < 3; idx++) {
                if (num_mv_found > idx + 1) {
                    int drl = sd.read(cdf.drl_mode[drl_ctx[idx]], 2);
                    if (drl == 0) { ref_mv_idx = idx; break; }
                    ref_mv_idx = idx + 1;
                }
            }
        }
        // assign_mv
        for (int i = 0; i < 1 + comp; i++) {
            int m = get_mode(i), pred[2];
            if (m == GLOBALMV) {
                pred[0] = global_mvs[i][0];
                pred[1] = global_mvs[i][1];
            } else {
                int pos = m == NEARESTMV ? 0 : ref_mv_idx;
                if (m == NEWMV && num_mv_found <= 1) pos = 0;
                pred[0] = ref_stack[pos][i][0];
                pred[1] = ref_stack[pos][i][1];
            }
            if (m == NEWMV) {
                int joint = sd.read(cdf.imv_joint, 4);
                if (joint == 2 || joint == 3) pred[0] += read_mv_component_inter(cdf.imv[0]);
                if (joint == 1 || joint == 3) pred[1] += read_mv_component_inter(cdf.imv[1]);
            }
            mvv[i][0] = pred[0];
            mvv[i][1] = pred[1];
        }
        f.stats[STAT_NEWMV] += has_newmv(ymode);
        // inter-intra
        interintra = 0;
        if (!skip_mode && f.enable_interintra && !comp && mi_sz >= BLOCK_8X8 && mi_sz <= BLOCK_32X32) {
            int g = kSizeGroup[mi_sz];
            interintra = sd.read(cdf.interintra[g], 2);
            if (interintra) {
                interintra_mode = sd.read(cdf.interintra_mode[g], 4);
                ref_frame[1] = INTRA_FRAME;
                wedge_interintra = sd.read(cdf.wedge_interintra[mi_sz - BLOCK_8X8], 2);
                if (wedge_interintra) {
                    wedge_index = sd.read(cdf.wedge_index[wedge_ctx(mi_sz)], 16);
                    wedge_sign = 0;
                }
            }
        }
        read_motion_mode(comp);
        // compound type
        comp_group_idx = 0;
        compound_idx = 1;
        if (skip_mode) {
            compound_type = COMPOUND_AVERAGE;
        } else if (comp) {
            int n = kWedgeBits[mi_sz];
            if (f.enable_masked_compound) comp_group_idx = sd.read(cdf.comp_group_idx[comp_group_ctx()], 2);
            if (comp_group_idx == 0) {
                if (f.enable_jnt_comp) {
                    compound_idx = sd.read(cdf.compound_idx[compound_idx_ctx()], 2);
                    compound_type = compound_idx ? COMPOUND_AVERAGE : COMPOUND_DISTANCE;
                } else {
                    compound_type = COMPOUND_AVERAGE;
                }
            } else if (n == 0) {
                compound_type = COMPOUND_DIFFWTD;
            } else {
                compound_type = sd.read(cdf.compound_type[wedge_ctx(mi_sz)], 2);
            }
            if (compound_type == COMPOUND_WEDGE) {
                wedge_index = sd.read(cdf.wedge_index[wedge_ctx(mi_sz)], 16);
                wedge_sign = sd.lit(1);
            } else if (compound_type == COMPOUND_DIFFWTD) {
                mask_type = sd.lit(1);
            }
        } else {
            compound_type = interintra ? (wedge_interintra ? COMPOUND_WEDGE : COMPOUND_INTRA) : COMPOUND_AVERAGE;
        }
        // interpolation filters
        if (f.interpolation_filter == SWITCHABLE) {
            for (int dir = 0; dir < (f.enable_dual_filter ? 2 : 1); dir++) {
                if (needs_interp_filter()) {
                    int ctx = ((dir & 1) * 2 + (ref_frame[1] > INTRA_FRAME)) * 4;
                    int lt = 3, at = 3;
                    if (avail_l) {
                        int r = mi_row, c = mi_col - 1;
                        if (mi_ref(r, c, 0) == ref_frame[0] || mi_ref(r, c, 1) == ref_frame[0])
                            lt = f.interp_filter_[2 * size_t(f.mi(r, c)) + dir];
                    }
                    if (avail_u) {
                        int r = mi_row - 1, c = mi_col;
                        if (mi_ref(r, c, 0) == ref_frame[0] || mi_ref(r, c, 1) == ref_frame[0])
                            at = f.interp_filter_[2 * size_t(f.mi(r, c)) + dir];
                    }
                    if (lt == at) ctx += lt;
                    else if (lt == 3) ctx += at;
                    else if (at == 3) ctx += lt;
                    else ctx += 3;
                    interp[dir] = sd.read(cdf.interp_filter[dir][ctx & 7], 3);
                } else {
                    interp[dir] = EIGHTTAP;
                }
            }
            if (!f.enable_dual_filter) interp[1] = interp[0];
        } else {
            interp[0] = interp[1] = f.interpolation_filter;
        }
        f.stats[STAT_DUAL_FILTER] += interp[0] != interp[1];
    }

    static int wedge_ctx(int b) {
        switch (b) {
            case BLOCK_8X8: return 0;
            case BLOCK_8X16: return 1;
            case BLOCK_16X8: return 2;
            case BLOCK_16X16: return 3;
            case BLOCK_16X32: return 4;
            case BLOCK_32X16: return 5;
            case BLOCK_32X32: return 6;
            case BLOCK_8X32: return 7;
            default: return 8;
        }
    }
    int comp_group_ctx() const {
        int ctx = 0;
        if (avail_u) {
            if (!above_single) ctx += f.comp_group_[f.mi(mi_row - 1, mi_col)];
            else if (above_ref[0] == ALTREF_FRAME) ctx += 3;
        }
        if (avail_l) {
            if (!left_single) ctx += f.comp_group_[f.mi(mi_row, mi_col - 1)];
            else if (left_ref[0] == ALTREF_FRAME) ctx += 3;
        }
        return imin(5, ctx);
    }
    int compound_idx_ctx() const {
        int fwd = abs(f.rel_dist(f.order_hints[ref_frame[0]], f.order_hint));
        int bck = abs(f.rel_dist(f.order_hints[ref_frame[1]], f.order_hint));
        int ctx = fwd == bck ? 3 : 0;
        if (avail_u) {
            if (!above_single) ctx += f.compound_idx_[f.mi(mi_row - 1, mi_col)];
            else if (above_ref[0] == ALTREF_FRAME) ctx++;
        }
        if (avail_l) {
            if (!left_single) ctx += f.compound_idx_[f.mi(mi_row, mi_col - 1)];
            else if (left_ref[0] == ALTREF_FRAME) ctx++;
        }
        return ctx;
    }
    bool needs_interp_filter() const {
        bool large = imin(kBw[mi_sz], kBh[mi_sz]) >= 8;
        if (skip_mode || motion_mode == LOCALWARP) return false;
        if (large && ymode == GLOBALMV) return f.gm_type[ref_frame[0]] == GM_TRANSLATION;
        if (large && ymode == GLOBAL_GLOBALMV)
            return f.gm_type[ref_frame[0]] == GM_TRANSLATION || f.gm_type[ref_frame[1]] == GM_TRANSLATION;
        return true;
    }

    int read_mv_component_inter(Cdfs::MvComponent& m) {
        int sign = sd.read(m.sign, 2);
        int cls = sd.read(m.classes, 11), mag;
        if (cls == 0) {
            int c0 = sd.read(m.class0, 2);
            int fr = f.force_integer_mv ? 3 : sd.read(m.class0_fr[c0], 4);
            int hp = f.allow_high_precision_mv ? sd.read(m.class0_hp, 2) : 1;
            mag = ((c0 << 3) | (fr << 1) | hp) + 1;
        } else {
            int d = 0;
            for (int i = 0; i < cls; i++) d |= sd.read(m.bits[i], 2) << i;
            mag = 2 << (cls + 2);
            int fr = f.force_integer_mv ? 3 : sd.read(m.fr, 4);
            int hp = f.allow_high_precision_mv ? sd.read(m.hp, 2) : 1;
            mag += ((d << 3) | (fr << 1) | hp) + 1;
        }
        return sign ? -mag : mag;
    }

    // ---- motion modes (read_motion_mode; find_warp_samples, 7.10.4)
    int num_samples = 0, num_scanned = 0, cand_list[8][4];

    bool has_overlappable_candidates() {
        if (avail_u)
            for (int x4 = mi_col; x4 < imin(f.MiCols, mi_col + bw4); x4 += 2) {
                int x5 = imin(x4 | 1, f.MiCols - 1);
                if (mi_ref(mi_row - 1, x5, 0) > INTRA_FRAME) return true;
            }
        if (avail_l)
            for (int y4 = mi_row; y4 < imin(f.MiRows, mi_row + bh4); y4 += 2) {
                int y5 = imin(y4 | 1, f.MiRows - 1);
                if (mi_ref(y5, mi_col - 1, 0) > INTRA_FRAME) return true;
            }
        return false;
    }
    void add_sample(int dr, int dc) {
        if (num_scanned >= 8) return;
        int r = mi_row + dr, c = mi_col + dc;
        if (!is_inside(r, c) || !f.decoded_[f.mi(r, c)]) return;
        if (mi_ref(r, c, 0) != ref_frame[0] || mi_ref(r, c, 1) != -1) return;
        int sz = f.mi_size[f.mi(r, c)];
        int w4 = kBw[sz] >> 2, h4 = kBh[sz] >> 2;
        int cr = r & ~(h4 - 1), cc = c & ~(w4 - 1);
        int mid_y = cr * 4 + h4 * 2 - 1, mid_x = cc * 4 + w4 * 2 - 1;
        int thresh = clip3(16, 112, imax(kBw[mi_sz], kBh[mi_sz]));
        const int32_t* cmv = mi_mv(cr, cc, 0);
        int diff = abs(cmv[0] - mvv[0][0]) + abs(cmv[1] - mvv[0][1]);
        bool valid = diff <= thresh;
        num_scanned++;
        if (!valid && num_scanned > 1) return;
        cand_list[num_samples][0] = mid_y * 8;
        cand_list[num_samples][1] = mid_x * 8;
        cand_list[num_samples][2] = mid_y * 8 + cmv[0];
        cand_list[num_samples][3] = mid_x * 8 + cmv[1];
        if (valid) num_samples++;
    }
    void find_warp_samples() {
        num_samples = num_scanned = 0;
        bool top_left = true, top_right = true;
        if (avail_u) {
            int sw = kBw[f.mi_size[f.mi(mi_row - 1, mi_col)]] >> 2;
            if (bw4 <= sw) {
                int off = -(mi_col & (sw - 1));
                if (off < 0) top_left = false;
                if (off + sw > bw4) top_right = false;
                add_sample(-1, 0);
            } else {
                for (int i = 0, step; i < imin(bw4, f.MiCols - mi_col); i += step) {
                    step = kBw[f.mi_size[f.mi(mi_row - 1, mi_col + i)]] >> 2;
                    add_sample(-1, i);
                }
            }
        }
        if (avail_l) {
            int sh = kBh[f.mi_size[f.mi(mi_row, mi_col - 1)]] >> 2;
            if (bh4 <= sh) {
                if (-(mi_row & (sh - 1)) < 0) top_left = false;
                add_sample(0, -1);
            } else {
                for (int i = 0, step; i < imin(bh4, f.MiRows - mi_row); i += step) {
                    step = kBh[f.mi_size[f.mi(mi_row + i, mi_col - 1)]] >> 2;
                    add_sample(i, -1);
                }
            }
        }
        if (top_left) add_sample(-1, -1);
        if (top_right && imax(bw4, bh4) <= 16) add_sample(-1, bw4);
        if (num_samples == 0 && num_scanned > 0) num_samples = 1;
    }
    void read_motion_mode(bool comp) {
        motion_mode = SIMPLE;
        if (skip_mode || !f.is_motion_mode_switchable) return;
        if (imin(kBw[mi_sz], kBh[mi_sz]) < 8) return;
        if (!f.force_integer_mv && (ymode == GLOBALMV || ymode == GLOBAL_GLOBALMV) &&
            f.gm_type[ref_frame[0]] > GM_TRANSLATION)
            return;
        if (comp || ref_frame[1] == INTRA_FRAME || !has_overlappable_candidates()) return;
        find_warp_samples();
        if (f.force_integer_mv || num_samples == 0 || !f.allow_warped_motion) {
            motion_mode = sd.read(cdf.use_obmc[mi_sz], 2) ? OBMC : SIMPLE;
        } else {
            motion_mode = sd.read(cdf.motion_mode[mi_sz], 3);
        }
    }

    // ---- the reference vector stack (find_mv_stack, 7.10.2)
    int num_mv_found = 0, new_mv_count = 0, ref_stack[9][2][2], weight_stack[9], global_mvs[2][2],
        drl_ctx[9], new_mv_ctx = 0, ref_mv_ctx = 0, zero_mv_ctx = 0;
    bool found_match = false;
    int ref_id_count[2], ref_diff_count[2], ref_id_mvs[2][2][2], ref_diff_mvs[2][2][2];

    void lower_precision(int* mv) const {
        if (f.allow_high_precision_mv) return;
        for (int i = 0; i < 2; i++) {
            if (f.force_integer_mv) {
                int a = abs(mv[i]), ai = (a + 3) >> 3;
                mv[i] = mv[i] > 0 ? ai << 3 : -(ai << 3);
            } else if (mv[i] & 1) {
                mv[i] += mv[i] > 0 ? -1 : 1;
            }
        }
    }
    void setup_global_mv(int list, int* mv) {
        int ref = ref_frame[list];
        int typ = ref > INTRA_FRAME ? f.gm_type[ref] : GM_IDENTITY;
        if (ref <= INTRA_FRAME || typ == GM_IDENTITY) {
            mv[0] = mv[1] = 0;
        } else if (typ == GM_TRANSLATION) {
            mv[0] = f.gm[ref][0] >> 13;
            mv[1] = f.gm[ref][1] >> 13;
        } else {
            int x = mi_col * 4 + kBw[mi_sz] / 2 - 1, y = mi_row * 4 + kBh[mi_sz] / 2 - 1;
            const int* g = f.gm[ref];
            int64_t xc = int64_t(g[2] - (1 << 16)) * x + int64_t(g[3]) * y + g[0];
            int64_t yc = int64_t(g[4]) * x + int64_t(g[5] - (1 << 16)) * y + g[1];
            if (f.allow_high_precision_mv) {
                mv[0] = int(round2signed64(yc, 13));
                mv[1] = int(round2signed64(xc, 13));
            } else {
                mv[0] = int(round2signed64(yc, 14)) * 2;
                mv[1] = int(round2signed64(xc, 14)) * 2;
            }
        }
        lower_precision(mv);
    }
    static int64_t round2signed64(int64_t x, int n) {
        return x >= 0 ? (x + (int64_t(1) << (n - 1))) >> n : -((-x + (int64_t(1) << (n - 1))) >> n);
    }

    void push_single(const int* mv, int weight) {
        int k = 0;
        while (k < num_mv_found && !(ref_stack[k][0][0] == mv[0] && ref_stack[k][0][1] == mv[1])) k++;
        if (k < num_mv_found) {
            weight_stack[k] += weight;
        } else if (num_mv_found < 8) {
            ref_stack[num_mv_found][0][0] = mv[0];
            ref_stack[num_mv_found][0][1] = mv[1];
            weight_stack[num_mv_found++] = weight;
        }
    }
    void push_compound(const int mv[2][2], int weight) {
        int k = 0;
        while (k < num_mv_found && !(ref_stack[k][0][0] == mv[0][0] && ref_stack[k][0][1] == mv[0][1] &&
                                     ref_stack[k][1][0] == mv[1][0] && ref_stack[k][1][1] == mv[1][1]))
            k++;
        if (k < num_mv_found) {
            weight_stack[k] += weight;
        } else if (num_mv_found < 8) {
            memcpy(ref_stack[num_mv_found], mv, sizeof(int) * 4);
            weight_stack[num_mv_found++] = weight;
        }
    }
    void add_ref_mv_candidate(int r, int c, bool comp, int weight) {
        int i = f.mi(r, c);
        if (!f.is_inter_[i]) return;
        int cand_mode = f.y_mode[i], cand_sz = f.mi_size[i];
        bool large = imin(kBw[cand_sz], kBh[cand_sz]) >= 8;
        if (!comp) {
            for (int list = 0; list < 2; list++) {
                if (mi_ref(r, c, list) != ref_frame[0]) continue;
                int mv[2];
                if ((cand_mode == GLOBALMV || cand_mode == GLOBAL_GLOBALMV) &&
                    f.gm_type[ref_frame[0]] > GM_TRANSLATION && large) {
                    mv[0] = global_mvs[0][0];
                    mv[1] = global_mvs[0][1];
                } else {
                    mv[0] = mi_mv(r, c, list)[0];
                    mv[1] = mi_mv(r, c, list)[1];
                }
                lower_precision(mv);
                new_mv_count += has_newmv(cand_mode);
                found_match = true;
                push_single(mv, weight);
            }
            return;
        }
        if (mi_ref(r, c, 0) != ref_frame[0] || mi_ref(r, c, 1) != ref_frame[1]) return;
        int mv[2][2];
        for (int list = 0; list < 2; list++) {
            if (cand_mode == GLOBAL_GLOBALMV && f.gm_type[ref_frame[list]] > GM_TRANSLATION && large) {
                mv[list][0] = global_mvs[list][0];
                mv[list][1] = global_mvs[list][1];
            } else {
                mv[list][0] = mi_mv(r, c, list)[0];
                mv[list][1] = mi_mv(r, c, list)[1];
            }
            lower_precision(mv[list]);
        }
        found_match = true;
        push_compound(mv, weight);
        new_mv_count += has_newmv(cand_mode);
    }
    void mv_scan_row(int dr, bool comp) {
        int end4 = imin(imin(bw4, f.MiCols - mi_col), 16), dc = 0;
        bool far = abs(dr) > 1;
        if (far) { dr += mi_row & 1; dc = 1 - (mi_col & 1); }
        for (int i = 0; i < end4;) {
            int r = mi_row + dr, c = mi_col + dc + i;
            if (!is_inside(r, c)) break;
            int len = imin(bw4, kBw[f.mi_size[f.mi(r, c)]] >> 2);
            if (far) len = imax(2, len);
            if (bw4 >= 16) len = imax(4, len);
            add_ref_mv_candidate(r, c, comp, 2 * len);
            i += len;
        }
    }
    void mv_scan_col(int dc, bool comp) {
        int end4 = imin(imin(bh4, f.MiRows - mi_row), 16), dr = 0;
        bool far = abs(dc) > 1;
        if (far) { dr = 1 - (mi_row & 1); dc += mi_col & 1; }
        for (int i = 0; i < end4;) {
            int r = mi_row + dr + i, c = mi_col + dc;
            if (!is_inside(r, c)) break;
            int len = imin(bh4, kBh[f.mi_size[f.mi(r, c)]] >> 2);
            if (far) len = imax(2, len);
            if (bh4 >= 16) len = imax(4, len);
            add_ref_mv_candidate(r, c, comp, 2 * len);
            i += len;
        }
    }
    void mv_scan_point(int dr, int dc, bool comp) {
        int r = mi_row + dr, c = mi_col + dc;
        if (is_inside(r, c) && f.decoded_[f.mi(r, c)]) add_ref_mv_candidate(r, c, comp, 4);
    }
    // a temporal candidate: the motion field's vector at the 8x8 block,
    // projected to the reference frame(s)
    bool tpl_mv(int y8, int x8, int ref, int* mv) const {
        size_t k = size_t(y8) * (f.MiCols >> 1) + x8;
        int off = f.tpl_off[k];
        if (!off) return false;
        int num = f.rel_dist(f.order_hint, f.order_hints[ref]);
        int den = imin(off, 31);
        num = clip3(-31, 31, num);
        for (int i = 0; i < 2; i++) {
            int64_t v = int64_t(f.tpl_mv[2 * k + i]) * num * av1_div_mult[den];
            mv[i] = clip3(-(1 << 14) + 1, (1 << 14) - 1, int(round2signed64(v, 14)));
        }
        return true;
    }
    void add_tpl_ref_mv(int dr, int dc, bool comp) {
        int r = (mi_row + dr) | 1, c = (mi_col + dc) | 1;
        if (!is_inside(r, c)) return;
        int x8 = c >> 1, y8 = r >> 1;
        if (dr == 0 && dc == 0) zero_mv_ctx = 1;
        if (!comp) {
            int mv[2];
            if (!tpl_mv(y8, x8, ref_frame[0], mv)) return;
            f.stats[STAT_TEMPORAL]++;
            lower_precision(mv);
            if (dr == 0 && dc == 0)
                zero_mv_ctx = abs(mv[0] - global_mvs[0][0]) >= 16 || abs(mv[1] - global_mvs[0][1]) >= 16;
            push_single(mv, 2);
        } else {
            int mv[2][2];
            if (!tpl_mv(y8, x8, ref_frame[0], mv[0]) || !tpl_mv(y8, x8, ref_frame[1], mv[1])) return;
            f.stats[STAT_TEMPORAL]++;
            lower_precision(mv[0]);
            lower_precision(mv[1]);
            if (dr == 0 && dc == 0)
                zero_mv_ctx = abs(mv[0][0] - global_mvs[0][0]) >= 16 || abs(mv[0][1] - global_mvs[0][1]) >= 16 ||
                              abs(mv[1][0] - global_mvs[1][0]) >= 16 || abs(mv[1][1] - global_mvs[1][1]) >= 16;
            push_compound(mv, 2);
        }
    }
    void temporal_scan(bool comp) {
        int sw = bw4 >= 16 ? 4 : 2, sh = bh4 >= 16 ? 4 : 2;
        for (int dr = 0; dr < imin(bh4, 16); dr += sh)
            for (int dc = 0; dc < imin(bw4, 16); dc += sw) add_tpl_ref_mv(dr, dc, comp);
        bool ext = bh4 >= 2 && bh4 < 16 && bw4 >= 2 && bw4 < 16;
        if (ext) {
            const int pos[3][2] = {{bh4, -2}, {bh4, bw4}, {bh4 - 2, bw4}};
            for (int i = 0; i < 3; i++) {
                int row = (mi_row & 15) + pos[i][0], col = (mi_col & 15) + pos[i][1];
                if (row >= 0 && row < 16 && col >= 0 && col < 16) add_tpl_ref_mv(pos[i][0], pos[i][1], comp);
            }
        }
    }
    void sort_mv_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int i = start + 1; i < end; i++)
                if (weight_stack[i - 1] < weight_stack[i]) {
                    std::swap(weight_stack[i - 1], weight_stack[i]);
                    int t[2][2];
                    memcpy(t, ref_stack[i - 1], sizeof t);
                    memcpy(ref_stack[i - 1], ref_stack[i], sizeof t);
                    memcpy(ref_stack[i], t, sizeof t);
                    new_end = i;
                }
            end = new_end;
        }
    }
    void add_extra_mv_candidate(int r, int c, bool comp) {
        for (int cl = 0; cl < 2; cl++) {
            int cref = mi_ref(r, c, cl);
            if (cref <= INTRA_FRAME) continue;
            if (comp) {
                for (int list = 0; list < 2; list++) {
                    int mv[2] = {mi_mv(r, c, cl)[0], mi_mv(r, c, cl)[1]};
                    if (cref == ref_frame[list] && ref_id_count[list] < 2) {
                        memcpy(ref_id_mvs[list][ref_id_count[list]++], mv, sizeof mv);
                    } else if (ref_diff_count[list] < 2) {
                        if (f.sign_bias[cref] != f.sign_bias[ref_frame[list]]) { mv[0] = -mv[0]; mv[1] = -mv[1]; }
                        memcpy(ref_diff_mvs[list][ref_diff_count[list]++], mv, sizeof mv);
                    }
                }
            } else {
                int mv[2] = {mi_mv(r, c, cl)[0], mi_mv(r, c, cl)[1]};
                if (f.sign_bias[cref] != f.sign_bias[ref_frame[0]]) { mv[0] = -mv[0]; mv[1] = -mv[1]; }
                int k = 0;
                while (k < num_mv_found && !(ref_stack[k][0][0] == mv[0] && ref_stack[k][0][1] == mv[1])) k++;
                if (k == num_mv_found) {
                    ref_stack[k][0][0] = mv[0];
                    ref_stack[k][0][1] = mv[1];
                    weight_stack[k] = 2;
                    num_mv_found++;
                }
            }
        }
    }
    void extra_search(bool comp) {
        ref_id_count[0] = ref_id_count[1] = ref_diff_count[0] = ref_diff_count[1] = 0;
        int w4 = imin(imin(16, bw4), f.MiCols - mi_col), h4 = imin(imin(16, bh4), f.MiRows - mi_row);
        int n4 = imin(w4, h4);
        for (int pass = 0; pass < 2 && num_mv_found < 2; pass++) {
            for (int idx = 0; idx < n4 && num_mv_found < 2;) {
                int r = pass == 0 ? mi_row - 1 : mi_row + idx, c = pass == 0 ? mi_col + idx : mi_col - 1;
                if (!is_inside(r, c)) break;
                add_extra_mv_candidate(r, c, comp);
                int sz = f.mi_size[f.mi(r, c)];
                idx += pass == 0 ? kBw[sz] >> 2 : kBh[sz] >> 2;
            }
        }
        if (comp) {
            int combined[2][2][2];
            for (int list = 0; list < 2; list++) {
                int n = 0;
                for (int k = 0; k < ref_id_count[list]; k++) memcpy(combined[n++][list], ref_id_mvs[list][k], 8);
                for (int k = 0; k < ref_diff_count[list] && n < 2; k++)
                    memcpy(combined[n++][list], ref_diff_mvs[list][k], 8);
                while (n < 2) memcpy(combined[n++][list], global_mvs[list], 8);
            }
            if (num_mv_found == 1) {
                int pick = combined[0][0][0] == ref_stack[0][0][0] && combined[0][0][1] == ref_stack[0][0][1] &&
                                   combined[0][1][0] == ref_stack[0][1][0] && combined[0][1][1] == ref_stack[0][1][1]
                               ? 1 : 0;
                memcpy(ref_stack[1], combined[pick], sizeof(int) * 4);
                weight_stack[1] = 2;
                num_mv_found = 2;
            } else {
                for (int k = 0; k < 2; k++) {
                    memcpy(ref_stack[num_mv_found], combined[k], sizeof(int) * 4);
                    weight_stack[num_mv_found++] = 2;
                }
            }
        } else {
            for (int k = num_mv_found; k < 2; k++) {
                ref_stack[k][0][0] = global_mvs[0][0];
                ref_stack[k][0][1] = global_mvs[0][1];
            }
        }
    }
    void find_mv_stack(bool comp) {
        num_mv_found = new_mv_count = 0;
        global_mvs[1][0] = global_mvs[1][1] = 0;
        setup_global_mv(0, global_mvs[0]);
        if (comp) setup_global_mv(1, global_mvs[1]);
        found_match = false;
        mv_scan_row(-1, comp);
        bool above_match = found_match;
        found_match = false;
        mv_scan_col(-1, comp);
        bool left_match = found_match;
        found_match = false;
        if (imax(bw4, bh4) <= 16) mv_scan_point(-1, bw4, comp);
        if (found_match) above_match = true;
        int close_matches = above_match + left_match;
        int num_nearest = num_mv_found, num_new = new_mv_count;
        for (int k = 0; k < num_nearest; k++) weight_stack[k] += 640;
        zero_mv_ctx = 0;
        if (f.use_ref_frame_mvs) temporal_scan(comp);
        found_match = false;
        mv_scan_point(-1, -1, comp);
        if (found_match) above_match = true;
        found_match = false;
        mv_scan_row(-3, comp);
        if (found_match) above_match = true;
        found_match = false;
        mv_scan_col(-3, comp);
        if (found_match) left_match = true;
        found_match = false;
        if (bh4 > 1) mv_scan_row(-5, comp);
        if (found_match) above_match = true;
        found_match = false;
        if (bw4 > 1) mv_scan_col(-5, comp);
        if (found_match) left_match = true;
        int total_matches = above_match + left_match;
        sort_mv_stack(0, num_nearest);
        sort_mv_stack(num_nearest, num_mv_found);
        if (num_mv_found < 2) extra_search(comp);
        // context and clamping
        for (int k = 0; k < num_mv_found; k++) {
            int z = 0;
            if (k + 1 < num_mv_found) {
                int w0 = weight_stack[k], w1 = weight_stack[k + 1];
                if (w0 >= 640) z = w1 < 640 ? 1 : 0;
                else z = 2;
            }
            drl_ctx[k] = z;
        }
        for (int list = 0; list < 1 + comp; list++)
            for (int k = 0; k < num_mv_found; k++) {
                int* mv = ref_stack[k][list];
                int border_r = 128 + bh4 * 4 * 8, border_c = 128 + bw4 * 4 * 8;
                mv[0] = clip3(-(mi_row * 4 * 8) - border_r, (f.MiRows - bh4 - mi_row) * 4 * 8 + border_r, mv[0]);
                mv[1] = clip3(-(mi_col * 4 * 8) - border_c, (f.MiCols - bw4 - mi_col) * 4 * 8 + border_c, mv[1]);
            }
        if (close_matches == 0) {
            new_mv_ctx = imin(total_matches, 1);
            ref_mv_ctx = total_matches;
        } else if (close_matches == 1) {
            new_mv_ctx = 3 - imin(num_new, 1);
            ref_mv_ctx = 2 + total_matches;
        } else {
            new_mv_ctx = 5 - imin(num_new, 1);
            ref_mv_ctx = 5;
        }
    }

    // ==== inter prediction (7.11.3)
    uint8_t mask_[128 * 128];
    int mask_stride = 0, fwd_weight = 0, bck_weight = 0;
    int local_valid = 0, local_wp[6] = {0}, local_abcd[4] = {0};

    // setupShear (7.11.3.6), dav1d's and aom's checks: alpha, beta,
    // gamma, delta of a warp's parameters, and whether it is valid
    static bool setup_shear(const int* wp, int* abcd) {
        if (wp[2] <= 0) return false;
        auto clip16 = [](int64_t v) { return int(v < -32768 ? -32768 : v > 32767 ? 32767 : v); };
        auto reduce = [](int v) { return int(round2signed64(v, 6) * 64); };
        int alpha = clip16(wp[2] - (1 << 16)), beta = clip16(wp[3]);
        int shift;
        int factor = resolve_divisor(wp[2], &shift);
        int64_t v = (int64_t(wp[4]) << 16) * factor;
        int gamma = clip16(round2signed64(v, shift));
        int64_t w = int64_t(wp[3]) * wp[4] * factor;
        int delta = clip16(int64_t(wp[5]) - round2signed64(w, shift) - (1 << 16));
        abcd[0] = reduce(alpha);
        abcd[1] = reduce(beta);
        abcd[2] = reduce(gamma);
        abcd[3] = reduce(delta);
        if (4 * abs(abcd[0]) + 7 * abs(abcd[1]) >= (1 << 16)) return false;
        if (4 * abs(abcd[2]) + 4 * abs(abcd[3]) >= (1 << 16)) return false;
        return true;
    }
    static int resolve_divisor(int64_t d, int* shift) {
        int64_t a = d < 0 ? -d : d;
        int n = 0;
        while ((a >> n) > 1) n++;
        int64_t e = a - (int64_t(1) << n);
        int64_t fr = n > 8 ? (e + (int64_t(1) << (n - 9))) >> (n - 8) : e << (8 - n);
        *shift = n + 14;
        return d < 0 ? -av1_div_lut[fr] : av1_div_lut[fr];
    }

    // warp_estimation (7.11.3.8): the local warp's parameters from the
    // samples' least squares
    void warp_estimation() {
        int64_t A[2][2] = {{0, 0}, {0, 0}}, bx[2] = {0, 0}, by[2] = {0, 0};
        int bw = kBw[mi_sz], bh = kBh[mi_sz];
        int mid_y = mi_row * 4 + bh / 2 - 1, mid_x = mi_col * 4 + bw / 2 - 1;
        int suy = mid_y * 8, sux = mid_x * 8, duy = suy + mvv[0][0], dux = sux + mvv[0][1];
        auto ls = [](int64_t a, int64_t b) { return ((a * b) >> 2) + (a + b); };
        for (int i = 0; i < num_samples; i++) {
            int sy = cand_list[i][0] - suy, sx = cand_list[i][1] - sux;
            int dy = cand_list[i][2] - duy, dx = cand_list[i][3] - dux;
            if (abs(sx - dx) < 256 && abs(sy - dy) < 256) {
                A[0][0] += ls(sx, sx) + 8;
                A[0][1] += ls(sx, sy) + 4;
                A[1][1] += ls(sy, sy) + 8;
                bx[0] += ls(sx, dx) + 8;
                bx[1] += ls(sy, dx) + 4;
                by[0] += ls(sx, dy) + 4;
                by[1] += ls(sy, dy) + 8;
            }
        }
        int64_t det = A[0][0] * A[1][1] - A[0][1] * A[0][1];
        local_valid = det != 0;
        if (!local_valid) return;
        int shift;
        int64_t factor = resolve_divisor(det, &shift);
        shift -= 16;
        if (shift < 0) {
            factor <<= -shift;
            shift = 0;
        }
        auto mul = [&](int64_t v) {
            // v * factor can pass 64 bits only on streams no encoder makes
            __int128 p = (__int128)v * factor;
            if (shift == 0) return int64_t(p);
            __int128 h = (__int128)1 << (shift - 1);
            return int64_t(p >= 0 ? (p + h) >> shift : -((-p + h) >> shift));
        };
        auto diag = [&](int64_t v) { return int(std::min<int64_t>(std::max<int64_t>(mul(v), 0xE001), 0x11FFF)); };
        auto nondiag = [&](int64_t v) {
            return int(std::min<int64_t>(std::max<int64_t>(mul(v), -(1 << 13) + 1), (1 << 13) - 1));
        };
        local_wp[2] = diag(A[1][1] * bx[0] - A[0][1] * bx[1]);
        local_wp[3] = nondiag(-A[0][1] * bx[0] + A[0][0] * bx[1]);
        local_wp[4] = nondiag(A[1][1] * by[0] - A[0][1] * by[1]);
        local_wp[5] = diag(-A[0][1] * by[0] + A[0][0] * by[1]);
        int64_t vx = int64_t(mvv[0][1]) * (1 << 13) -
                     (int64_t(mid_x) * (local_wp[2] - (1 << 16)) + int64_t(mid_y) * local_wp[3]);
        int64_t vy = int64_t(mvv[0][0]) * (1 << 13) -
                     (int64_t(mid_x) * local_wp[4] + int64_t(mid_y) * (local_wp[5] - (1 << 16)));
        const int64_t clampv = 1 << 23;
        local_wp[0] = int(std::min<int64_t>(std::max<int64_t>(vx, -clampv), clampv - 1));
        local_wp[1] = int(std::min<int64_t>(std::max<int64_t>(vy, -clampv), clampv - 1));
        local_valid = setup_shear(local_wp, local_abcd);
    }

    // block_inter_prediction (7.11.3.4) from a reference of the frame's
    // size: 8-tap (4-tap where the block is 4 wide or high) filters, in
    // 1/16 pel, samples past the frame clamped to its edge
    void block_inter(const Plane& ref, int p, int x, int y, int w, int h, const int32_t* mv,
                     int cand_r, int cand_c, int r0, int r1, int32_t* out) {
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int last_x = ((f.UpW + sx) >> sx) - 1, last_y = ((f.H + sy) >> sy) - 1;
        int pos_x = (x << 4) + ((2 * mv[1]) >> sx), pos_y = (y << 4) + ((2 * mv[0]) >> sy);
        int ix = pos_x >> 4, fx = pos_x & 15, iy = pos_y >> 4, fy = pos_y & 15;
        const uint8_t* filt = &f.interp_filter_[2 * size_t(f.mi(cand_r, cand_c))];
        int fh = filt[1], fv = filt[0];
        if (w <= 4) fh = fh == EIGHTTAP || fh == EIGHTTAP_SHARP ? 4 : fh == EIGHTTAP_SMOOTH ? 5 : fh;
        if (h <= 4) fv = fv == EIGHTTAP || fv == EIGHTTAP_SHARP ? 4 : fv == EIGHTTAP_SMOOTH ? 5 : fv;
        const int16_t* hf = av1_subpel_filters[fh][fx];
        const int16_t* vf = av1_subpel_filters[fv][fy];
        static thread_local int32_t mid[(128 + 7) * 128];
        static thread_local int cols[128 + 8];
        for (int c = 0; c < w + 7; c++) cols[c] = clip3(0, last_x, ix + c - 3);
        for (int r = 0; r < h + 7; r++) {
            const pixel* row = &ref.px[size_t(clip3(0, last_y, iy + r - 3)) * ref.stride];
            int32_t* m = &mid[r * w];
            for (int c = 0; c < w; c++) {
                const int* cc = &cols[c];
                int s = hf[0] * row[cc[0]] + hf[1] * row[cc[1]] + hf[2] * row[cc[2]] + hf[3] * row[cc[3]] +
                        hf[4] * row[cc[4]] + hf[5] * row[cc[5]] + hf[6] * row[cc[6]] + hf[7] * row[cc[7]];
                m[c] = round2(s, r0);
            }
        }
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                const int32_t* m = &mid[r * w + c];
                int64_t s = 0;
                for (int t = 0; t < 8; t++) s += int64_t(vf[t]) * m[t * w];
                out[r * w + c] = round2(s, r1);
            }
    }

    // block_warp (7.11.3.5): an 8x8 block of the warp (local or global)
    void block_warp(const Plane& ref, int p, int x, int y, int i8, int j8, int w, int h, const int* wp,
                    const int* abcd, int r0, int r1, int32_t* out) {
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int last_x = ((f.UpW + sx) >> sx) - 1, last_y = ((f.H + sy) >> sy) - 1;
        int src_x = (x + j8 * 8 + 4) << sx, src_y = (y + i8 * 8 + 4) << sy;
        int64_t dst_x = int64_t(wp[2]) * src_x + int64_t(wp[3]) * src_y + wp[0];
        int64_t dst_y = int64_t(wp[4]) * src_x + int64_t(wp[5]) * src_y + wp[1];
        int64_t x4 = dst_x >> sx, y4 = dst_y >> sy;
        int ix4 = int(x4 >> 16), sx4 = int(x4 & 0xffff) & ~63;
        int iy4 = int(y4 >> 16), sy4 = int(y4 & 0xffff) & ~63;
        int inter[15][8];
        for (int i1 = -7; i1 < 8; i1++) {
            const pixel* row = &ref.px[size_t(clip3(0, last_y, iy4 + i1)) * ref.stride];
            for (int i2 = -4; i2 < 4; i2++) {
                int sxv = sx4 + abcd[0] * i2 + abcd[1] * i1;
                const int16_t* wf = av1_warped_filters[round2(sxv, 10) + 64];
                int s = 0;
                for (int t = 0; t < 8; t++) s += wf[t] * row[clip3(0, last_x, ix4 + i2 - 3 + t)];
                inter[i1 + 7][i2 + 4] = round2(s, r0);
            }
        }
        for (int i1 = -4; i1 < imin(4, h - i8 * 8 - 4); i1++)
            for (int i2 = -4; i2 < imin(4, w - j8 * 8 - 4); i2++) {
                int syv = sy4 + abcd[2] * i2 + abcd[3] * i1;
                const int16_t* wf = av1_warped_filters[round2(syv, 10) + 64];
                int64_t s = 0;
                for (int t = 0; t < 8; t++) s += int64_t(wf[t]) * inter[i1 + t + 4][i2 + 4];
                out[(i8 * 8 + i1 + 4) * w + j8 * 8 + i2 + 4] = round2(s, r1);
            }
    }

    const Plane& ref_plane(int ref, int p) const { return f.refs[f.ref_frame_idx[ref - 1]].px->p[p]; }

    // the wedge masks of a block size (7.11.3.11), built once
    struct Wedges {
        std::vector<uint8_t> m[22][2][16];
        Wedges() {
            static uint8_t master[6][64][64];
            for (int j = 0; j < 64; j++) {
                int shift = 16;
                for (int i = 0; i < 64; i += 2) {
                    master[3][i][j] = av1_wedge_master[1][clip3(0, 63, j - shift)];  // OBLIQUE63, even
                    shift--;
                    master[3][i + 1][j] = av1_wedge_master[0][clip3(0, 63, j - shift)];
                    master[1][i][j] = av1_wedge_master[2][j];  // VERTICAL
                    master[1][i + 1][j] = av1_wedge_master[2][j];
                }
            }
            for (int i = 0; i < 64; i++)
                for (int j = 0; j < 64; j++) {
                    int msk = master[3][i][j];
                    master[2][j][i] = uint8_t(msk);               // OBLIQUE27
                    master[4][i][63 - j] = uint8_t(64 - msk);     // OBLIQUE117
                    master[5][63 - j][i] = uint8_t(64 - msk);     // OBLIQUE153
                    master[0][j][i] = master[1][i][j];            // HORIZONTAL
                }
            for (int b = 0; b < 22; b++) {
                if (!kWedgeBits[b]) continue;
                int w = kBw[b], h = kBh[b];
                int shape = h > w ? 0 : h < w ? 1 : 2;
                for (int k = 0; k < 16; k++) {
                    const uint8_t* cb = av1_wedge_codebook[shape][k];
                    int dir = cb[0];
                    int xoff = 32 - ((cb[1] * w) >> 3), yoff = 32 - ((cb[2] * h) >> 3);
                    int sum = 0;
                    for (int i = 0; i < w; i++) sum += master[dir][yoff][xoff + i];
                    for (int i = 1; i < h; i++) sum += master[dir][yoff + i][xoff];
                    int avg = (sum + (w + h - 1) / 2) / (w + h - 1);
                    int flip = avg < 32;
                    m[b][flip][k].resize(size_t(w) * h);
                    m[b][!flip][k].resize(size_t(w) * h);
                    for (int i = 0; i < h; i++)
                        for (int j = 0; j < w; j++) {
                            m[b][flip][k][i * w + j] = master[dir][yoff + i][xoff + j];
                            m[b][!flip][k][i * w + j] = uint8_t(64 - master[dir][yoff + i][xoff + j]);
                        }
                }
            }
        }
    };
    static const Wedges& wedges() { static const Wedges w; return w; }

    void predict_inter_block() {
        int sb_mask = f.use128 ? 31 : 15;
        int sbr = mi_row & sb_mask, sbc = mi_col & sb_mask;
        if (motion_mode == LOCALWARP) warp_estimation();
        for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            int psz = residual_size(mi_sz, p);
            int n4w = kBw[psz] >> 2, n4h = kBh[psz] >> 2;
            int bx = (mi_col >> sx) * 4, by = (mi_row >> sy) * 4;
            int cand_r = (mi_row >> sy) << sy, cand_c = (mi_col >> sx) << sx;
            if (ref_frame[1] == INTRA_FRAME) {
                static const int ii_modes[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
                bool have_ar = block_decoded[p][(sbr >> sy) - 1 + 1][(sbc >> sx) + n4w + 1];
                bool have_bl = block_decoded[p][(sbr >> sy) + n4h + 1][(sbc >> sx) - 1 + 1];
                predict_intra(p, bx, by, p == 0 ? avail_l : avail_l_chroma,
                              p == 0 ? avail_u : avail_u_chroma, have_ar, have_bl,
                              ii_modes[interintra_mode], 2 + mi_wlog2(psz), 2 + mi_hlog2(psz));
            }
            int pw = kBw[mi_sz] >> sx, ph = kBh[mi_sz] >> sy;
            bool some_intra = false;
            for (int r = 0; r < (n4h << sy); r++)
                for (int c = 0; c < (n4w << sx); c++)
                    if (mi_ref(cand_r + r, cand_c + c, 0) == INTRA_FRAME) some_intra = true;
            if (some_intra) {
                pw = n4w * 4;
                ph = n4h * 4;
                cand_r = mi_row;
                cand_c = mi_col;
            }
            f.stats[STAT_SUB8X8] += pw < n4w * 4 || ph < n4h * 4;
            for (int y = 0, r = 0; y < n4h * 4; y += ph, r++)
                for (int x = 0, c = 0; x < n4w * 4; x += pw, c++)
                    predict_inter(p, bx + x, by + y, pw, ph, cand_r + r, cand_c + c);
        }
    }

    void predict_inter(int p, int x, int y, int w, int h, int cand_r, int cand_c) {
        static thread_local int32_t preds[2][128 * 128];
        bool comp = mi_ref(cand_r, cand_c, 1) > INTRA_FRAME;
        int r0 = f.bitdepth == 12 ? 5 : 3, r1 = comp ? 7 : (f.bitdepth == 12 ? 9 : 11);
        int post = 14 - r0 - r1;
        bool global_mode = ymode == GLOBALMV || ymode == GLOBAL_GLOBALMV;
        for (int list = 0; list < 1 + comp; list++) {
            int ref = mi_ref(cand_r, cand_c, list);
            const Plane& rp = ref_plane(ref, p);
            int abcd[4];
            int use_warp = 0;
            if (w < 8 || h < 8 || f.force_integer_mv) use_warp = 0;
            else if (motion_mode == LOCALWARP && local_valid) use_warp = 1;
            else if (global_mode && f.gm_type[ref] > GM_TRANSLATION && setup_shear(f.gm[ref], abcd)) use_warp = 2;
            if (use_warp) {
                const int* wp = use_warp == 1 ? local_wp : f.gm[ref];
                const int* ab = use_warp == 1 ? local_abcd : abcd;
                for (int i8 = 0; i8 <= (h - 1) >> 3; i8++)
                    for (int j8 = 0; j8 <= (w - 1) >> 3; j8++)
                        block_warp(rp, p, x, y, i8, j8, w, h, wp, ab, r0, r1, preds[list]);
                if (p == 0) f.stats[use_warp == 1 ? STAT_LOCALWARP : STAT_GLOBALWARP]++;
            } else {
                block_inter(rp, p, x, y, w, h, mi_mv(cand_r, cand_c, list), cand_r, cand_c, r0, r1,
                            preds[list]);
            }
        }
        bool ii = ref_frame[1] == INTRA_FRAME;
        if (compound_type == COMPOUND_WEDGE && p == 0) {
            const std::vector<uint8_t>& m = wedges().m[mi_sz][wedge_sign][wedge_index];
            memcpy(mask_, m.data(), m.size());
            mask_stride = kBw[mi_sz];
        } else if (compound_type == COMPOUND_INTRA) {
            int scale = 128 / imax(h, w);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int v = 32;
                    if (interintra_mode == 1) v = av1_ii_weights[i * scale];
                    else if (interintra_mode == 2) v = av1_ii_weights[j * scale];
                    else if (interintra_mode == 3) v = av1_ii_weights[imin(i, j) * scale];
                    mask_[i * w + j] = uint8_t(v);
                }
            mask_stride = w;
        } else if (compound_type == COMPOUND_DIFFWTD && p == 0) {
            int sh = (f.bitdepth - 8) + post;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int diff = round2(abs(preds[0][i * w + j] - preds[1][i * w + j]), sh);
                    int m = clip3(0, 64, 38 + diff / 16);
                    mask_[i * w + j] = uint8_t(mask_type ? 64 - m : m);
                }
            mask_stride = w;
        }
        Plane& pl = f.plane[p];
        const int maxv = (1 << f.bitdepth) - 1;
        if (!comp && !ii) {
            for (int i = 0; i < h; i++) {
                pixel* d = pl.at(y + i, x);
                for (int j = 0; j < w; j++) d[j] = pixel(clip3(0, maxv, preds[0][i * w + j]));
            }
        } else if (comp && compound_type == COMPOUND_AVERAGE) {
            for (int i = 0; i < h; i++) {
                pixel* d = pl.at(y + i, x);
                for (int j = 0; j < w; j++)
                    d[j] = pixel(clip3(0, maxv, round2(preds[0][i * w + j] + preds[1][i * w + j], 1 + post)));
            }
        } else if (comp && compound_type == COMPOUND_DISTANCE) {
            distance_weights(cand_r, cand_c);
            for (int i = 0; i < h; i++) {
                pixel* d = pl.at(y + i, x);
                for (int j = 0; j < w; j++)
                    d[j] = pixel(clip3(0, maxv, round2(int64_t(fwd_weight) * preds[0][i * w + j] +
                                                           int64_t(bck_weight) * preds[1][i * w + j], 4 + post)));
            }
        } else {
            int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
            const uint8_t* mk = mask_;
            int ms = mask_stride;
            bool full = (!sx && !sy) || (ii && !wedge_interintra);
            for (int i = 0; i < h; i++) {
                pixel* d = pl.at(y + i, x);
                for (int j = 0; j < w; j++) {
                    int m;
                    if (full) m = mk[i * ms + j];
                    else if (sx && !sy) m = round2(mk[i * ms + 2 * j] + mk[i * ms + 2 * j + 1], 1);
                    else if (!sx && sy) m = round2(mk[2 * i * ms + j] + mk[(2 * i + 1) * ms + j], 1);
                    else
                        m = round2(mk[2 * i * ms + 2 * j] + mk[2 * i * ms + 2 * j + 1] +
                                   mk[(2 * i + 1) * ms + 2 * j] + mk[(2 * i + 1) * ms + 2 * j + 1], 2);
                    if (ii) {
                        int p0 = clip3(0, maxv, round2(preds[0][i * w + j], post));
                        d[j] = pixel(round2(m * int(d[j]) + (64 - m) * p0, 6));
                    } else {
                        d[j] = pixel(clip3(0, maxv, round2(int64_t(m) * preds[0][i * w + j] +
                                                               int64_t(64 - m) * preds[1][i * w + j], 6 + post)));
                    }
                }
            }
        }
        if (motion_mode == OBMC) overlapped_mc(p, w, h);
    }

    void distance_weights(int cand_r, int cand_c) {
        int dist[2];
        for (int list = 0; list < 2; list++) {
            int hnt = f.order_hints[mi_ref(cand_r, cand_c, list)];
            dist[list] = clip3(0, 31, abs(f.rel_dist(hnt, f.order_hint)));
        }
        int d0 = dist[1], d1 = dist[0];
        int order = d0 <= d1;
        if (d0 == 0 || d1 == 0) {
            fwd_weight = av1_quant_dist[1][3][order];
            bck_weight = av1_quant_dist[1][3][1 - order];
            return;
        }
        int i;
        for (i = 0; i < 3; i++) {
            int c0 = av1_quant_dist[0][i][order], c1 = av1_quant_dist[0][i][!order];
            if (order ? d0 * c0 > d1 * c1 : d0 * c0 < d1 * c1) break;
        }
        fwd_weight = av1_quant_dist[1][i][order];
        bck_weight = av1_quant_dist[1][i][1 - order];
    }

    // overlapped motion compensation (7.11.3.10): the predictions of the
    // blocks above and to the left blended into the block's edge
    void overlap(int p, int cand_r, int cand_c, int x4, int y4, int pw, int ph, const uint8_t* mask,
                 bool above) {
        static thread_local int32_t op[128 * 128];
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        int px = (x4 * 4) >> sx, py = (y4 * 4) >> sy;
        int r0 = f.bitdepth == 12 ? 5 : 3, r1 = f.bitdepth == 12 ? 9 : 11;
        block_inter(ref_plane(mi_ref(cand_r, cand_c, 0), p), p, px, py, pw, ph, mi_mv(cand_r, cand_c, 0),
                    cand_r, cand_c, r0, r1, op);
        const int maxv = (1 << f.bitdepth) - 1;
        Plane& pl = f.plane[p];
        for (int i = 0; i < ph; i++) {
            pixel* d = pl.at(py + i, px);
            for (int j = 0; j < pw; j++) {
                int m = above ? mask[i] : mask[j];
                int o = clip3(0, maxv, op[i * pw + j]);
                d[j] = pixel(round2(m * int(d[j]) + (64 - m) * o, 6));
            }
        }
    }
    void overlapped_mc(int p, int w, int h) {
        int sx = p ? f.ssx : 0, sy = p ? f.ssy : 0;
        if (p == 0) f.stats[STAT_OBMC]++;
        if (avail_u && residual_size(mi_sz, p) >= BLOCK_8X8) {
            int count = 0, limit = imin(4, mi_wlog2(mi_sz));
            for (int x4 = mi_col; count < limit && x4 < imin(f.MiCols, mi_col + bw4);) {
                int cr = mi_row - 1, cc = x4 | 1;
                int step = clip3(2, 16, kBw[f.mi_size[f.mi(cr, cc)]] >> 2);
                if (mi_ref(cr, cc, 0) > INTRA_FRAME) {
                    count++;
                    int pw = imin(w, (step * 4) >> sx), ph = imin(h >> 1, 32 >> sy);
                    overlap(p, cr, cc, x4, mi_row, pw, ph, &av1_obmc_masks[ph], true);
                }
                x4 += step;
            }
        }
        if (avail_l) {
            int count = 0, limit = imin(4, mi_hlog2(mi_sz));
            for (int y4 = mi_row; count < limit && y4 < imin(f.MiRows, mi_row + bh4);) {
                int cc = mi_col - 1, cr = y4 | 1;
                int step = clip3(2, 16, kBh[f.mi_size[f.mi(cr, cc)]] >> 2);
                if (mi_ref(cr, cc, 0) > INTRA_FRAME) {
                    count++;
                    int pw = imin(w >> 1, 32 >> sx), ph = imin(h, (step * 4) >> sy);
                    overlap(p, cr, cc, mi_col, y4, pw, ph, &av1_obmc_masks[pw], false);
                }
                y4 += step;
            }
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
        // dav1d's, where the spec clamps: an id past LastActiveSegId is 0;
        // with no feature on (LastActiveSegId -1, unsigned there) the coded
        // id stands where the prediction is 0
        if (f.last_active_seg < 0) seg_id = pred == 0 ? diff : 0;
        else seg_id = id < 0 || id > f.last_active_seg ? 0 : id;
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
        int mr = f.mvs[4 * size_t(i)], mc = f.mvs[4 * size_t(i) + 1];
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
                    if (is_inter && !lossless && p == 0) {
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
        if (is_inter) {
            // predicted with the block (predict_intrabc, predict_inter_block)
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
        if (is_inter) {
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
        if (is_inter) {  // the co-located luma transform's type
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
                    if (is_inter) {
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
    // a transform edge is filtered where it is a block edge, or the block
    // is coded or intra (a skipped inter block has no inner transform
    // edges; a frame with intra block copies is not deblocked)
    bool apply = pass == 0 ? (xp % kTw[t] == 0) : (yp % kTh[t] == 0);
    int bi = mi(row, col);
    if (apply && skip_[bi] && is_inter_[bi]) {
        int b = mi_size[bi];
        int pbw = imax(4, kBw[b] >> sx), pbh = imax(4, kBh[b] >> sy);
        apply = pass == 0 ? xp % pbw == 0 : yp % pbh == 0;
    }
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
        int pw = round2(UpW, sx), ph = round2(H, sy);
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

void Decoder::superres_upscale(Plane* planes) {
    if (W == UpW) return;  // (dav1d's: superres at a width it leaves as it is)
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
            const pixel* src = planes[p].at(y, 0);
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
        planes[p] = std::move(out);
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

// ---- the motion field of the references (7.9; the projection sources
// counted as aom counts them)
bool Decoder::projection(int src, int dst_sign) {
    const RefSlot& s = refs[ref_frame_idx[src - LAST_FRAME]];
    if (!s.mf || s.mi_rows != MiRows || s.mi_cols != MiCols) return false;
    int w8 = MiCols >> 1, h8 = MiRows >> 1;
    int ref_to_cur = rel_dist(order_hints[src], order_hint);
    int offs[8] = {0};
    for (int r = LAST_FRAME; r <= ALTREF_FRAME; r++) offs[r] = rel_dist(order_hints[src], s.saved_order_hints[r]);
    int num = clip3(-31, 31, ref_to_cur * dst_sign);
    for (int y8 = 0; y8 < h8; y8++)
        for (int x8 = 0; x8 < w8; x8++) {
            size_t k = size_t(y8) * w8 + x8;
            int ref = s.mf->ref[k];
            if (ref <= INTRA_FRAME) continue;
            int off = offs[ref];
            if (!(abs(ref_to_cur) <= 31 && abs(off) <= 31 && off > 0)) continue;
            int proj[2];
            for (int i = 0; i < 2; i++) {
                int64_t v = int64_t(s.mf->mv[2 * k + i]) * num * av1_div_mult[imin(off, 31)];
                int64_t rr = v >= 0 ? (v + 8192) >> 14 : -((-v + 8192) >> 14);
                proj[i] = clip3(-(1 << 14) + 1, (1 << 14) - 1, int(rr));
            }
            int pos[2], v8[2] = {y8, x8}, max8[2] = {h8, w8}, maxoff[2] = {0, 8};
            bool valid = true;
            for (int i = 0; i < 2; i++) {
                int base8 = (v8[i] >> 3) << 3;
                int o8 = proj[i] >= 0 ? proj[i] >> 6 : -((-proj[i]) >> 6);
                int v = v8[i] + dst_sign * o8;
                if (v < 0 || v >= max8[i] || v < base8 - maxoff[i] || v >= base8 + 8 + maxoff[i]) valid = false;
                pos[i] = v;
            }
            if (!valid) continue;
            size_t t = size_t(pos[0]) * w8 + pos[1];
            tpl_mv[2 * t] = s.mf->mv[2 * k];
            tpl_mv[2 * t + 1] = s.mf->mv[2 * k + 1];
            tpl_off[t] = int8_t(off);
        }
    return true;
}

void Decoder::motion_field_estimation() {
    size_t n8 = size_t(MiCols >> 1) * (MiRows >> 1);
    tpl_mv.assign(2 * n8, 0);
    tpl_off.assign(n8, 0);
    const RefSlot& last = refs[ref_frame_idx[0]];
    if (last.saved_order_hints[ALTREF_FRAME] != order_hints[GOLDEN_FRAME]) projection(LAST_FRAME, -1);
    int stamp = 1;
    if (rel_dist(order_hints[BWDREF_FRAME], order_hint) > 0 && projection(BWDREF_FRAME, 1)) stamp--;
    if (rel_dist(order_hints[ALTREF2_FRAME], order_hint) > 0 && projection(ALTREF2_FRAME, 1)) stamp--;
    if (rel_dist(order_hints[ALTREF_FRAME], order_hint) > 0 && stamp >= 0 && projection(ALTREF_FRAME, 1))
        stamp--;
    if (stamp >= 0) projection(LAST2_FRAME, -1);
}

void Decoder::finish_frame() {
    stats[STAT_FRAMES]++;
    stats[STAT_INTRA_ONLY] += frame_type == INTRA_ONLY_FRAME;
    RefSlot s;
    s.valid = true;
    s.order_hint = order_hint;
    s.upw = UpW;
    s.h = H;
    s.ssx = ssx;
    s.ssy = ssy;
    s.mono = mono;
    s.bitdepth = bitdepth;
    s.mi_cols = MiCols;
    s.mi_rows = MiRows;
    s.showable = showable_frame;
    memcpy(s.saved_order_hints, order_hints, sizeof order_hints);
    memcpy(s.gm, gm, sizeof gm);
    memcpy(s.lf_ref_deltas, lf_ref_deltas, sizeof lf_ref_deltas);
    memcpy(s.lf_mode_deltas, lf_mode_deltas, sizeof lf_mode_deltas);
    memcpy(s.seg_feature, seg_feature, sizeof seg_feature);
    memcpy(s.seg_data, seg_data, sizeof seg_data);
    s.fg = fg;
    out_px.reset();
    if (!header_only) {
        loop_filter();
        Plane pre_cdef[3];
        if (uses_lr)
            for (int p = 0; p < num_planes; p++) pre_cdef[p] = plane[p];
        cdef();
        superres_upscale(plane);
        if (uses_lr) superres_upscale(pre_cdef);
        loop_restoration(pre_cdef);
        out_px = std::make_shared<Pixels>();
        for (int p = 0; p < num_planes; p++) out_px->p[p] = std::move(plane[p]);
        s.px = out_px;
        s.cdfs = std::make_shared<Cdfs>(disable_frame_end_update_cdf ? frame_cdfs : end_cdfs);
        s.cdfs->clear_counts();
        s.seg_map = std::make_shared<std::vector<uint8_t>>(seg_ids);
        if (!frame_is_intra) {
            // the motion field (7.19): each 8x8 block's bottom-right 4x4,
            // a vector to a reference before the frame, up to 2^12 - 1
            auto mf = std::make_shared<MotionField>();
            int w8 = MiCols >> 1, h8 = MiRows >> 1;
            mf->ref.assign(size_t(w8) * h8, 0);
            mf->mv.assign(size_t(w8) * h8 * 2, 0);
            for (int y8 = 0; y8 < h8; y8++)
                for (int x8 = 0; x8 < w8; x8++) {
                    size_t i = size_t(mi(2 * y8 + 1, 2 * x8 + 1)), k = size_t(y8) * w8 + x8;
                    for (int list = 0; list < 2; list++) {
                        int r = ref_frames[2 * i + list];
                        if (r <= INTRA_FRAME || rel_dist(order_hints[r], order_hint) >= 0) continue;
                        int mr = mvs[4 * i + 2 * list], mc = mvs[4 * i + 2 * list + 1];
                        if (abs(mr) > 4095 || abs(mc) > 4095) continue;
                        mf->ref[k] = int8_t(r);
                        mf->mv[2 * k] = int16_t(mr);
                        mf->mv[2 * k + 1] = int16_t(mc);
                    }
                }
            s.mf = mf;
        }
    }
    for (int i = 0; i < 8; i++)
        if ((refresh_frame_flags >> i) & 1) refs[i] = s;
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
                later.refs_enabled = false;
                later.parse_sequence_header(br);
                br.trailing_bit();
                break;
            }
            case 3: case 6: case 7: {
                if (!later.have_seq) fail("an AV1 frame header without a sequence header");
                if (!later.reduced && size && (body[0] & 0x80)) {
                    BitReader br(body, size);
                    br.f(1);
                    later.parse_show_existing(br);
                    if (type != 6) br.trailing_bit();
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

    // the frame the sample shows: its planes (null while probing), size,
    // film grain; whether the first frame was hidden; frames parsed
    std::shared_ptr<Pixels> out_px;
    FilmGrain out_fg;
    int out_w = 0, out_h = 0, frames = 0, key_frames_only = 1;
    bool first_hidden = false, skip_tiles = false;

    void shown(int idx) {
        frame_done = true;
        if (idx >= 0) {
            const RefSlot& s = dec.refs[idx];
            out_px = s.px;
            out_fg = s.fg;
            out_w = s.upw;
            out_h = s.h;
        } else {
            out_px = dec.out_px;
            out_fg = dec.fg;
            out_w = dec.UpW;
            out_h = dec.H;
        }
        BitReader br(seq_obu, seq_size);  // its sequence header reads the OBUs that follow
        later.refs_enabled = false;
        later.parse_sequence_header(br);
    }

    void run(const uint8_t* d, size_t n, bool probe_only) {
        dec.header_only = probe_only;
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
                    bool had = dec.have_seq;
                    std::vector<uint8_t> before = dec.seq_bits;
                    dec.parse_sequence_header(br);
                    br.trailing_bit();
                    if (had && dec.seq_bits != before) dec.new_sequence();
                    seq_obu = body;
                    seq_size = size;
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
                    if (!dec.have_seq) fail("a frame header before any sequence header");
                    BitReader br(body, size);
                    if (!dec.reduced && size && (body[0] & 0x80)) {
                        // show_existing_frame: the slot's frame, with its film
                        // grain (load_grain_params)
                        br.f(1);
                        int idx = dec.parse_show_existing(br);
                        if (type != 6) br.trailing_bit();
                        const RefSlot& s = dec.refs[idx];
                        if (!s.valid || !s.showable)
                            fail("show_existing_frame of AV1 slot %d, which holds no showable frame", idx);
                        shown(idx);
                        if (probe_only) return;
                        break;
                    }
                    dec.parse_frame_header(br, temporal_id, spatial_id);
                    if (type != 6) br.trailing_bit();
                    if (frames++ == 0) first_hidden = !dec.show_frame;
                    key_frames_only &= dec.frame_type == KEY_FRAME;
                    if (probe_only) {
                        if (dec.show_frame) return;
                        // a hidden frame: its slots, then the frames after it
                        dec.finish_frame();
                        dec.have_frame_header = false;
                        skip_tiles = true;
                        break;
                    }
                    if (type == 6) {
                        br.byte_align();
                        size_t off = br.pos >> 3;
                        if (off > size) fail("an AV1 frame OBU ends inside its header");
                        dec.parse_tile_group(body + off, size - off);
                    }
                    break;
                }
                case 4:
                    if (probe_only) {
                        if (skip_tiles) break;
                        fail("an AV1 tile group before its frame header");
                    }
                    dec.parse_tile_group(body, size);
                    break;
                case 2: case 8: case 15: default:
                    break;
            }
            if (!probe_only && dec.have_frame_header &&
                dec.tiles_decoded == dec.tile_cols * dec.tile_rows) {
                dec.finish_frame();
                dec.have_frame_header = false;
                if (dec.show_frame) shown(-1);
            }
        }
        if (!dec.have_seq) fail("no AV1 sequence header");
        if (!frames && !frame_done) fail("no AV1 frame header");
        if (probe_only) return;
        if (dec.have_frame_header)
            fail("AV1 frame data end after %d of %d tiles", dec.tiles_decoded, dec.tile_cols * dec.tile_rows);
        if (!frame_done) {
            if (key_frames_only)
                unported("a hidden AV1 key frame that no show_existing_frame of its sample shows");
            unported("hidden AV1 frames that no shown frame of their sample follows");
        }
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
                         d.allow_intrabc, d.superres_denom, int(o.first_hidden)};
        if (o.frame_done) {  // the shown frame's size (show_existing_frame: its slot's)
            v[0] = o.out_w;
            v[1] = o.out_h;
        }
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
        if (stats) memcpy(stats, d.stats, sizeof d.stats);
        pixel* out[3] = {y, u, v};
        d.UpW = o.out_w;
        d.H = o.out_h;
        for (int p = 0; p < d.num_planes; p++) {
            int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
            int w = (d.UpW + sx) >> sx, h = (d.H + sy) >> sy;
            for (int r = 0; r < h; r++)
                memcpy(out[p] + size_t(r) * w, o.out_px->p[p].at(r, 0), sizeof(pixel) * size_t(w));
        }
        d.fg = o.out_fg;
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
