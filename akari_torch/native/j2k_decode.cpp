// JPEG 2000 Part-1 codestream decoding, as OpenJPEG 2.5 decodes it, and
// Pillow's per-tile unpack of the decoded components (Jpeg2KDecode.c).
//
// The JAX package reads JPEG 2000 textures with PIL, which decodes them with
// OpenJPEG tile by tile (opj_read_tile_header / opj_decode_tile_data) and
// unpacks each tile into the image as it comes. This file does both, so the
// pixels equal PIL's bit for bit:
//
// - the main header and tile-part headers: SIZ, COD / COC, QCD / QCC (no
//   quantisation, scalar derived, scalar expounded), RGN, POC, PPM / PPT,
//   TLM / PLM / PLT, CRG and COM, with OpenJPEG's checks (strict mode: a
//   tile-part longer than the stream is refused);
// - tier 2: the packet iterator for LRCP, RLCP, RPCL, PCRL and CPRL with
//   precincts and POC, packet headers (tag trees, inclusion, zero bit-planes,
//   pass counts, Lblock), SOP / EPH, quality layers and tile-parts;
// - tier 1: the MQ decoder (segments end in OpenJPEG's 0xFF 0xFF sentinel)
//   and the three coding passes under every code-block style (BYPASS, RESET,
//   TERMALL, VSC, PTERM, SEGSYM);
// - reconstruction: dequantisation with the half-bin value, ROI max-shift,
//   the 5/3 inverse DWT in integers and the 9/7 in float with OpenJPEG's
//   constants and order of operations (build with -ffp-contract=off, never
//   -ffast-math), the inverse RCT / ICT and the DC level shift with lrintf's
//   round-half-to-even and OpenJPEG's clamp;
// - Pillow's unpackers per mode and colour space (subsampled components
//   repeated from the tile origin, sYCC through Pillow's YCbCr tables).
//
// - HTJ2K code-blocks (Part 15, the HT code-block style of COD / COC) as
//   OpenJPEG's ht_dec.c decodes them: tier 2's HT segments (the cleanup
//   pass alone in the first, the SigProp and MagRef passes in the second),
//   the cleanup pass (MEL, VLC with UVLC, MagSgn; VLC tables of
//   j2k_ht_tables.h), the SigProp and MagRef passes, and OpenJPEG's limits
//   and refusals; the samples leave at the MQ path's fixed point;
// - the Part-2 MCT, MCC, MCO and CBD markers as OpenJPEG reads them: an MCO
//   zeroes the DC level shifts and applies an MCC's offset array; a CBD
//   sets the components' precision and sign. COD transform 2 is refused as
//   OpenJPEG refuses it.

#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "j2k_ht_tables.h"

namespace {

enum { AKR_OK = 0, AKR_BROKEN = 1 };

struct Failure {
    std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
    char buf[512];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Failure{buf};
}

#define FAIL(...) fail(__VA_ARGS__)

// OpenJPEG's colour spaces (opj_image_t.color_space)
enum { CS_UNKNOWN = -1, CS_UNSPECIFIED = 0, CS_SRGB = 1, CS_GRAY = 2, CS_SYCC = 3, CS_EYCC = 4,
       CS_CMYK = 5 };

// decoder states (j2k.c)
enum : uint32_t {
    ST_NONE = 0, ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16,
    ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256
};

enum : uint32_t {
    M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9, M_CAP = 0xff50, M_SIZ = 0xff51,
    M_COD = 0xff52, M_COC = 0xff53, M_RGN = 0xff5e, M_QCD = 0xff5c, M_QCC = 0xff5d,
    M_POC = 0xff5f, M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58, M_PPM = 0xff60,
    M_PPT = 0xff61, M_SOP = 0xff91, M_CRG = 0xff63, M_COM = 0xff64, M_CBD = 0xff78,
    M_MCC = 0xff75, M_MCT = 0xff74, M_MCO = 0xff77, M_CPF = 0xff59
};

const int MAXRLVLS = 33;
const int MAXBANDS = 3 * MAXRLVLS - 2;
const uint32_t CBLK_LAZY = 0x01, CBLK_RESET = 0x02, CBLK_TERMALL = 0x04, CBLK_VSC = 0x08,
               CBLK_PTERM = 0x10, CBLK_SEGSYM = 0x20, CBLK_HT = 0x40, CBLK_HTMIXED = 0x80;
const uint32_t CP_CSTY_PRT = 0x01, CP_CSTY_SOP = 0x02, CP_CSTY_EPH = 0x04;

inline int32_t ceildivpow2(int32_t a, int b) { return (int32_t)((a + ((int64_t)1 << b) - 1) >> b); }
inline int32_t ceildivpow2_64(int64_t a, int b) { return (int32_t)((a + ((int64_t)1 << b) - 1) >> b); }
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }
inline uint32_t uceildiv(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
inline uint32_t uceildivpow2(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a + ((uint64_t)1 << b) - 1) >> b);
}
inline uint32_t uint64_ceildiv_u32(uint64_t a, uint64_t b) { return (uint32_t)((a + b - 1) / b); }
inline uint32_t uadds(uint32_t a, uint32_t b) {
    uint64_t s = (uint64_t)a + b;
    return s > 0xffffffffu ? 0xffffffffu : (uint32_t)s;
}
inline uint32_t be(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = v << 8 | p[i];
    return v;
}

// ------------------------------------------------------------------ coding parameters

struct Stepsize {
    int32_t expn = 0, mant = 0;
};

struct Tccp {
    uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    uint32_t qntsty = 0, numgbits = 0;
    int32_t roishift = 0;
    Stepsize stepsizes[MAXBANDS];
    uint32_t prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
    int32_t dc_level_shift = 0;
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    int32_t prg = 0;
};

// Part-2 MCT and MCC records (opj_mct_data_t, opj_simple_mcc_decorrelation_data_t)
struct MctRecord {
    uint32_t index = 0, element_type = 0;
    std::vector<uint8_t> data;
};

struct MccRecord {
    uint32_t index = 0, nb_comps = 0;
    int32_t deco = -1, offset = -1;  // MCT record slots
};

struct Tcp {
    uint32_t csty = 0;
    int32_t prg = 0;
    uint32_t numlayers = 0, num_layers_to_decode = 0, mct = 0;
    std::vector<Tccp> tccps;
    bool cod = false, POC = false;
    uint32_t numpocs = 0;
    Poc pocs[32];
    bool ppt = false, ppt_merged = false;
    std::vector<std::vector<uint8_t>> ppt_markers;  // by Zppt
    std::vector<bool> ppt_present;
    std::vector<uint8_t> ppt_buffer;
    size_t ppt_pos = 0;
    std::vector<uint8_t> data;  // the tile-parts' bodies
    bool has_data = false;
    uint32_t nb_tile_parts = 0;
    int32_t current_tile_part = -1;
    std::vector<MctRecord> mct_records;
    std::vector<MccRecord> mcc_slots;  // the first nb_mcc are the records
    uint32_t nb_mcc = 0;
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 8, sgnd = 0, resno_decoded = 0;
};

// ------------------------------------------------------------------ tile structures

struct TagTree {
    struct Node {
        int32_t parent = -1, value = 999, low = 0;
    };
    std::vector<Node> nodes;
    void build(uint32_t w, uint32_t h) {
        nodes.clear();
        if (w == 0 || h == 0) return;
        std::vector<uint32_t> nw, nh;
        uint32_t a = w, b = h;
        size_t total = 0;
        for (;;) {
            nw.push_back(a);
            nh.push_back(b);
            total += (size_t)a * b;
            if ((size_t)a * b <= 1) break;
            a = (a + 1) / 2;
            b = (b + 1) / 2;
        }
        nodes.assign(total, Node());
        size_t base = 0;
        for (size_t l = 0; l + 1 < nw.size(); ++l) {
            size_t next = base + (size_t)nw[l] * nh[l];
            for (uint32_t j = 0; j < nh[l]; ++j)
                for (uint32_t i = 0; i < nw[l]; ++i)
                    nodes[base + (size_t)j * nw[l] + i].parent =
                        (int32_t)(next + (size_t)(j / 2) * nw[l + 1] + i / 2);
            base = next;
        }
    }
    void reset() {
        for (auto& n : nodes) {
            n.value = 999;
            n.low = 0;
        }
    }
};

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
             newlen = 0;
};

struct Chunk {
    const uint8_t* data;
    uint32_t len;
};

struct Cblk {
    int32_t x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    uint32_t Mb = 0;  // the band's bit-planes, for HT code-blocks
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};

struct Precinct {
    int32_t x0, y0, x1, y1;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int32_t x0, y0, x1, y1;
    uint32_t bandno;
    float stepsize;
    int32_t numbps;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
    int32_t x0, y0, x1, y1;
    uint32_t pw = 0, ph = 0, numbands = 0;
    Band bands[3];
};

struct TileComp {
    int32_t x0, y0, x1, y1;
    uint32_t numresolutions;
    std::vector<Resolution> res;
    std::vector<int32_t> data;  // int32 (5/3) or float bits (9/7)
};

// ------------------------------------------------------------------ bit input (tier-2)

struct Bio {
    const uint8_t *start, *end, *bp;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t len) : start(p), end(p + len), bp(p) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t getbit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1u;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= getbit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leafno, int32_t threshold) {
    int32_t stk[32];
    int depth = 0;
    int32_t node = (int32_t)leafno;
    while (tree.nodes[node].parent >= 0) {
        stk[depth++] = node;
        node = tree.nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
        auto& n = tree.nodes[node];
        if (low > n.low) n.low = low;
        else low = n.low;
        while (low < threshold && low < n.value) {
            if (bio.read(1)) n.value = low;
            else ++low;
        }
        n.low = low;
        if (depth == 0) break;
        node = stk[--depth];
    }
    return tree.nodes[node].value < threshold ? 1u : 0u;
}

// ------------------------------------------------------------------ MQ decoder (tier-1)

struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

const MqState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},  {0x3401, 2, 6, 0},  {0x1801, 3, 9, 0},  {0x0ac1, 4, 12, 0},
    {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},  {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0}, {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0},
    {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTXS = 19 };

struct Mqc {
    const uint8_t* bp;  // the byte being read; the data ends in 0xFF 0xFF
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[NUM_CTXS], mps[NUM_CTXS];

    void resetstates() {
        memset(state, 0, sizeof state);
        memset(mps, 0, sizeof mps);
    }
    void setstate(int ctx, int msb, int prob) {
        state[ctx] = (uint8_t)prob;
        mps[ctx] = (uint8_t)msb;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += (uint32_t)*bp << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += (uint32_t)*bp << 8;
            ct = 8;
        }
    }
    void init_dec(const uint8_t* p, uint32_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : (uint32_t)*bp << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    uint32_t decode(int ctx) {
        const MqState& s = MQ_TABLE[state[ctx]];
        uint32_t d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            // LPS exchange
            if (a < s.qe) {
                a = s.qe;
                d = mps[ctx];
                state[ctx] = s.nmps;
            } else {
                a = s.qe;
                d = 1u - mps[ctx];
                if (s.sw) mps[ctx] = (uint8_t)(1 - mps[ctx]);
                state[ctx] = s.nlps;
            }
            renorm();
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) == 0) {
                // MPS exchange
                if (a < s.qe) {
                    d = 1u - mps[ctx];
                    if (s.sw) mps[ctx] = (uint8_t)(1 - mps[ctx]);
                    state[ctx] = s.nlps;
                } else {
                    d = mps[ctx];
                    state[ctx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[ctx];
            }
        }
        return d;
    }
    // raw (BYPASS) segments
    void raw_init_dec(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    uint32_t raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp;
                    bp++;
                    ct = 7;
                }
            } else {
                c = *bp;
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1u;
    }
};

// ------------------------------------------------------------------ tier-1

// per-coefficient flags
enum : uint8_t { F_SIG = 1, F_NEG = 2, F_PI = 4, F_MU = 8 };

uint8_t ZC_LUT[4][256];  // [orientation][neighbour significance pattern]

// neighbour pattern bits: 0 N, 1 S, 2 W, 3 E, 4 NW, 5 NE, 6 SW, 7 SE
int zc_context(int orient, int pat) {
    int h = ((pat >> 2) & 1) + ((pat >> 3) & 1);
    int v = (pat & 1) + ((pat >> 1) & 1);
    int d = ((pat >> 4) & 1) + ((pat >> 5) & 1) + ((pat >> 6) & 1) + ((pat >> 7) & 1);
    if (orient == 1) std::swap(h, v);  // HL: vertical neighbours lead
    if (orient == 3) {
        int hv = h + v;
        if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
        if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (h == 0) {
        if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
        return v == 1 ? 3 : 4;
    }
    if (h == 1) {
        if (v == 0) return d == 0 ? 5 : 6;
        return 7;
    }
    return 8;
}

struct LutInit {
    LutInit() {
        for (int o = 0; o < 4; ++o)
            for (int p = 0; p < 256; ++p) ZC_LUT[o][p] = (uint8_t)zc_context(o, p);
    }
} lut_init;

struct T1 {
    uint32_t w = 0, h = 0, fs = 0;  // flags stride = w + 2
    std::vector<int32_t> data;
    std::vector<uint8_t> flags;     // (h + 2) x (w + 2), one-sample border
    Mqc mqc;
    bool vsc = false;
    int orient = 0;

    uint8_t& F(uint32_t x, uint32_t y) { return flags[(size_t)(y + 1) * fs + x + 1]; }

    // neighbour significance pattern, with the next stripe's samples left out
    // of the last row of a stripe under VSC
    int pattern(uint32_t x, uint32_t y) {
        const uint8_t* c = &flags[(size_t)(y + 1) * fs + x + 1];
        const uint8_t* n = c - fs;
        const uint8_t* s = c + fs;
        bool south = !(vsc && (y & 3) == 3);
        int p = (n[0] & F_SIG) | ((c[-1] & F_SIG) << 2) | ((c[1] & F_SIG) << 3) |
                ((n[-1] & F_SIG) << 4) | ((n[1] & F_SIG) << 5);
        if (south) p |= ((s[0] & F_SIG) << 1) | ((s[-1] & F_SIG) << 6) | ((s[1] & F_SIG) << 7);
        return p;
    }
    int zc_ctx(uint32_t x, uint32_t y) { return CTX_ZC + ZC_LUT[orient][pattern(x, y)]; }
    // sign context and the XOR bit (Table D.3)
    void sc_ctx(uint32_t x, uint32_t y, int& ctx, uint32_t& xorbit) {
        const uint8_t* c = &flags[(size_t)(y + 1) * fs + x + 1];
        auto contrib = [](uint8_t f) { return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0; };
        int hc = contrib(c[-1]) + contrib(c[1]);
        int vc = contrib(c[-(int)fs]);
        if (!(vsc && (y & 3) == 3)) vc += contrib(c[fs]);
        hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
        vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
        xorbit = 0;
        if (hc < 0) {
            hc = -hc;
            vc = -vc;
            xorbit = 1;
        } else if (hc == 0 && vc < 0) {
            vc = -vc;
            xorbit = 1;
        }
        // (hc, vc): (1,1) 13, (1,0) 12, (1,-1) 11, (0,1) 10, (0,0) 9
        ctx = hc == 0 ? (vc == 0 ? 9 : 10) : (vc == 1 ? 13 : vc == 0 ? 12 : 11);
    }
    int mr_ctx(uint32_t x, uint32_t y) {
        uint8_t f = F(x, y);
        if (f & F_MU) return CTX_MAG + 2;
        return pattern(x, y) ? CTX_MAG + 1 : CTX_MAG;
    }

    void set_sig(uint32_t x, uint32_t y, uint32_t neg, int32_t oneplushalf) {
        data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
        F(x, y) |= (uint8_t)(F_SIG | (neg ? F_NEG : 0));
    }

    void sigpass(int bpno_plus_one, bool raw) {
        int32_t one = 1 << bpno_plus_one, half = one >> 1, oneplushalf = one | half;
        for (uint32_t k = 0; k < h; k += 4)
            for (uint32_t x = 0; x < w; ++x)
                for (uint32_t y = k; y < k + 4 && y < h; ++y) {
                    uint8_t f = F(x, y);
                    if ((f & (F_SIG | F_PI)) || !pattern(x, y)) continue;
                    if (raw) {
                        if (mqc.raw_decode()) set_sig(x, y, mqc.raw_decode(), oneplushalf);
                    } else if (mqc.decode(zc_ctx(x, y))) {
                        int ctx;
                        uint32_t xb;
                        sc_ctx(x, y, ctx, xb);
                        set_sig(x, y, mqc.decode(ctx) ^ xb, oneplushalf);
                    }
                    F(x, y) |= F_PI;
                }
    }

    void refpass(int bpno_plus_one, bool raw) {
        int32_t poshalf = (1 << bpno_plus_one) >> 1;
        for (uint32_t k = 0; k < h; k += 4)
            for (uint32_t x = 0; x < w; ++x)
                for (uint32_t y = k; y < k + 4 && y < h; ++y) {
                    uint8_t f = F(x, y);
                    if ((f & (F_SIG | F_PI)) != F_SIG) continue;
                    uint32_t v = raw ? mqc.raw_decode() : mqc.decode(mr_ctx(x, y));
                    int32_t& d = data[(size_t)y * w + x];
                    d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
                    F(x, y) |= F_MU;
                }
    }

    void clnpass(int bpno_plus_one, uint32_t cblksty) {
        int32_t one = 1 << bpno_plus_one, half = one >> 1, oneplushalf = one | half;
        for (uint32_t k = 0; k < h; k += 4)
            for (uint32_t x = 0; x < w; ++x) {
                uint32_t y = k;
                if (k + 4 <= h) {
                    bool rl = true;
                    for (uint32_t r = k; r < k + 4 && rl; ++r)
                        if ((F(x, r) & (F_SIG | F_PI)) || pattern(x, r)) rl = false;
                    if (rl) {
                        if (!mqc.decode(CTX_AGG)) continue;
                        uint32_t runlen = mqc.decode(CTX_UNI) << 1;
                        runlen |= mqc.decode(CTX_UNI);
                        y = k + runlen;
                        int ctx;
                        uint32_t xb;
                        sc_ctx(x, y, ctx, xb);
                        set_sig(x, y, mqc.decode(ctx) ^ xb, oneplushalf);
                        ++y;
                    }
                }
                for (; y < k + 4 && y < h; ++y) {
                    uint8_t f = F(x, y);
                    if (f & (F_SIG | F_PI)) continue;
                    if (!mqc.decode(zc_ctx(x, y))) continue;
                    int ctx;
                    uint32_t xb;
                    sc_ctx(x, y, ctx, xb);
                    set_sig(x, y, mqc.decode(ctx) ^ xb, oneplushalf);
                }
            }
        for (uint32_t y = 0; y < h; ++y)
            for (uint32_t x = 0; x < w; ++x) F(x, y) &= (uint8_t)~F_PI;
        if (cblksty & CBLK_SEGSYM) {
            for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
        }
    }

    // opj_t1_decode_cblk; false where OpenJPEG refuses the code-block
    bool decode_cblk(Cblk& cb, uint32_t bandno, uint32_t roishift, uint32_t cblksty,
                     std::vector<uint8_t>& buf) {
        orient = (int)bandno;
        vsc = (cblksty & CBLK_VSC) != 0;
        w = (uint32_t)(cb.x1 - cb.x0);
        h = (uint32_t)(cb.y1 - cb.y0);
        fs = w + 2;
        data.assign((size_t)w * h, 0);
        flags.assign((size_t)(h + 2) * fs, 0);

        int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
        if (bpno_plus_one >= 31) return false;
        uint32_t passtype = 2;
        mqc.resetstates();
        mqc.setstate(CTX_UNI, 0, 46);
        mqc.setstate(CTX_AGG, 0, 3);
        mqc.setstate(CTX_ZC, 0, 4);
        if (cb.chunks.empty()) return true;

        size_t total = 0;
        for (auto& ch : cb.chunks) total += ch.len;
        buf.resize(total + 2);
        size_t off = 0;
        for (auto& ch : cb.chunks) {
            memcpy(buf.data() + off, ch.data, ch.len);
            off += ch.len;
        }
        size_t index = 0;
        for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
            Seg& seg = cb.segs[segno];
            bool raw = (bpno_plus_one <= (int32_t)cb.numbps - 4) && passtype < 2 &&
                       (cblksty & CBLK_LAZY);
            // the synthetic 0xFF 0xFF marker after the segment
            uint8_t saved[2] = {buf[index + seg.len], buf[index + seg.len + 1]};
            buf[index + seg.len] = 0xff;
            buf[index + seg.len + 1] = 0xff;
            if (raw) mqc.raw_init_dec(buf.data() + index);
            else mqc.init_dec(buf.data() + index, seg.len);
            for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1;
                 ++passno) {
                if (passtype == 0) sigpass(bpno_plus_one, raw);
                else if (passtype == 1) refpass(bpno_plus_one, raw);
                else clnpass(bpno_plus_one, cblksty);
                if ((cblksty & CBLK_RESET) && !raw) {
                    mqc.resetstates();
                    mqc.setstate(CTX_UNI, 0, 46);
                    mqc.setstate(CTX_AGG, 0, 3);
                    mqc.setstate(CTX_ZC, 0, 4);
                }
                if (++passtype == 3) {
                    passtype = 0;
                    bpno_plus_one--;
                }
            }
            buf[index + seg.len] = saved[0];
            buf[index + seg.len + 1] = saved[1];
            index += seg.len;
        }
        return true;
    }
};

// ------------------------------------------------------------------ HT block decoder

// the MagSgn and SigProp streams: bytes forward, then fill bytes; a byte
// after 0xFF carries 7 bits (ORed over, as OpenJPEG's frwd_read does)
struct HtFwd {
    const uint8_t* p;
    int64_t size;
    uint64_t tmp = 0;
    uint32_t bits = 0, fill;
    bool unstuff = false;
    HtFwd(const uint8_t* d, int64_t n, uint32_t x) : p(d), size(n), fill(x) {}
    void feed() {
        uint64_t d = size-- > 0 ? *p++ : fill;
        tmp |= d << bits;
        bits += 8 - (unstuff ? 1 : 0);
        unstuff = (d & 0xff) == 0xff;
    }
    uint32_t fetch() {
        while (bits <= 32) feed();
        return (uint32_t)tmp;
    }
    void advance(uint32_t n) {
        tmp >>= n;
        bits -= n;
    }
};

// the VLC and MagRef streams: bytes backward, then zeros; after a byte above
// 0x8F a byte whose low 7 bits are all ones carries 7 (rev_read)
struct HtRev {
    const uint8_t* p;
    int64_t size;
    uint64_t tmp = 0;
    uint32_t bits = 0;
    bool unstuff;
    HtRev(const uint8_t* last, int64_t n, bool u) : p(last), size(n), unstuff(u) {}
    void feed() {
        uint64_t d = 0;
        if (size > 0) {
            d = *p--;
            --size;
        }
        uint32_t db = 8 - ((unstuff && (d & 0x7f) == 0x7f) ? 1 : 0);
        tmp |= d << bits;
        bits += db;
        unstuff = d > 0x8f;
    }
    uint32_t fetch() {
        while (bits <= 32) feed();
        return (uint32_t)tmp;
    }
    void advance(uint32_t n) {
        tmp >>= n;
        bits -= n;
    }
};

// the MEL stream: bytes forward, most significant bit first, the last byte
// ORed with 0x0F, then 0xFF; after 0xFF a byte's top bit is dropped
struct HtMel {
    const uint8_t* p;
    int64_t size;
    uint32_t byte = 0, nbits = 0;
    bool unstuff = false;
    int k = 0;
    uint32_t zeros = 0;
    bool one = false;
    HtMel(const uint8_t* d, int64_t n) : p(d), size(n) {}
    uint32_t bit() {
        if (nbits == 0) {
            uint32_t d = size > 0 ? *p : 0xff;
            if (size == 1) d |= 0xf;
            if (size-- > 0) ++p;
            nbits = unstuff ? 7 : 8;
            byte = d;
            unstuff = d == 0xff;
        }
        return (byte >> --nbits) & 1;
    }
    uint32_t event() {
        static const int EXP[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
        while (zeros == 0 && !one) {
            int e = EXP[k];
            if (bit()) {
                zeros = 1u << e;
                k = k + 1 < 12 ? k + 1 : 12;
            } else {
                uint32_t r = 0;
                for (int i = 0; i < e; ++i) r = r << 1 | bit();
                zeros = r;
                one = true;
                k = k - 1 > 0 ? k - 1 : 0;
            }
        }
        if (zeros) {
            --zeros;
            return 0;
        }
        one = false;
        return 1;
    }
};

// UVLC prefixes by the next three bits: length | suffix length << 2 | value << 5
const uint8_t UVLC_PREFIX[8] = {3 | (5 << 2) | (5 << 5), 1 | (1 << 5), 2 | (2 << 5), 1 | (1 << 5),
                                3 | (1 << 2) | (3 << 5), 1 | (1 << 5), 2 | (2 << 5), 1 | (1 << 5)};

// u_q of a quad pair from the VLC stream (decode_init_uvlc /
// decode_noninit_uvlc): mode is u_off of the two quads (1, 2, 3), plus one
// for the first quad row when the MEL event says both exceed 2 (4)
void uvlc_decode(HtRev& vlc, uint32_t mode, bool initial, uint32_t u[2]) {
    uint32_t v = vlc.fetch(), used = 0;
    auto prefix = [&](void) {
        uint32_t d = UVLC_PREFIX[v & 7];
        v >>= d & 3;
        used += d & 3;
        return d;
    };
    auto suffix = [&](uint32_t d) {
        uint32_t n = (d >> 2) & 7;
        uint32_t x = (d >> 5) + (v & ((1u << n) - 1));
        v >>= n;
        used += n;
        return x;
    };
    u[0] = u[1] = 0;
    if (mode == 1 || mode == 2) {
        uint32_t x = suffix(prefix());
        u[mode - 1] = x;
    } else if (mode == 3 && initial) {
        uint32_t d1 = prefix();
        if ((d1 & 3) > 2) {
            u[1] = (v & 1) + 1;
            v >>= 1;
            ++used;
            u[0] = suffix(d1);
        } else {
            uint32_t d2 = prefix();
            u[0] = suffix(d1);
            u[1] = suffix(d2);
        }
    } else if (mode >= 3) {
        uint32_t d1 = prefix(), d2 = prefix();
        u[0] = suffix(d1);
        u[1] = suffix(d2);
        if (mode == 4) {
            u[0] += 2;
            u[1] += 2;
        }
    }
    vlc.advance(used);
}

[[noreturn]] void ht_fail(const char* what) { FAIL("Malformed HT codeblock. %s", what); }

// opj_t1_ht_decode_cblk: the code-block's samples, sign-magnitude with the
// bin centre, turned into the MQ path's fixed point (two's complement, one
// bit below the lowest decoded bit-plane)
void ht_decode_cblk(std::vector<int32_t>& data, uint32_t w, uint32_t h, const Cblk& cb,
                    uint32_t roishift, uint32_t cblksty, std::vector<uint8_t>& buf) {
    data.assign((size_t)w * h, 0);
    if (roishift) FAIL("We do not support ROI in decoding HT codeblocks");
    if (cb.chunks.empty()) return;
    size_t total = 0;
    for (auto& ch : cb.chunks) total += ch.len;
    buf.resize(total);
    size_t off = 0;
    for (auto& ch : cb.chunks) {
        memcpy(buf.data() + off, ch.data, ch.len);
        off += ch.len;
    }
    const uint8_t* coded = buf.data();
    uint32_t num_passes = cb.numsegs > 0 ? cb.segs[0].real_num_passes : 0;
    num_passes += cb.numsegs > 1 ? cb.segs[1].real_num_passes : 0;
    uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
    uint32_t lengths2 = num_passes > 1 ? cb.segs[1].len : 0;
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // OpenJPEG warns
    if (num_passes > 3)
        FAIL("We do not support more than 3 coding passes in an HT codeblock; This codeblocks "
             "has %u passes.", num_passes);
    if (cb.Mb > 30)
        FAIL("32 bits are not enough to decode this codeblock, since the number of bitplane, "
             "%u, is larger than 30.", cb.Mb);
    uint32_t zero_bplanes = (cb.Mb + 1) - cb.numbps;
    if (zero_bplanes > cb.Mb)
        FAIL("Malformed HT codeblock. Decoding this codeblock is stopped. There are %u zero "
             "bitplanes in %u bitplanes.", zero_bplanes, cb.Mb);
    if (zero_bplanes == cb.Mb && num_passes > 1) num_passes = 1;  // OpenJPEG warns
    uint32_t p = cb.numbps, mmsbp2 = zero_bplanes + 1;
    if (lengths1 < 2 || lengths1 > total || (uint64_t)lengths1 + lengths2 > total)
        ht_fail("Invalid codeblock length values.");
    int64_t lcup = lengths1;
    int64_t scup = ((int64_t)coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xf);
    if (scup < 2 || scup > lcup || scup > 4079)
        ht_fail("One of the following condition is not met: 2 <= Scup <= min(Lcup, 4079)");
    // mel_init reads the stream's first bytes up to a 4-byte boundary of
    // the code-block buffer (aligned) and refuses a byte above 0x8F after
    // an 0xFF among them
    {
        int64_t pos = lcup - scup, size = scup - 1;
        int num = 4 - (int)(pos & 3);
        bool unstuff = false;
        for (int i = 0; i < num; ++i) {
            if (unstuff && coded[pos] > 0x8f) ht_fail("Incorrect MEL segment sequence.");
            uint32_t d = size > 0 ? coded[pos] : 0xff;
            if (size == 1) d |= 0xf;
            if (size-- > 0) ++pos;
            unstuff = (d & 0xff) == 0xff;
        }
    }
    HtMel mel(coded + lcup - scup, scup - 1);
    // the VLC stream starts in the high nibble of the byte before Scup's last
    HtRev vlc(coded + lcup - 3, scup - 2, (coded[lcup - 2] | 0xf) > 0x8f);
    vlc.tmp = coded[lcup - 2] >> 4;
    vlc.bits = 4 - ((vlc.tmp & 7) == 7 ? 1 : 0);
    HtFwd magsgn(coded, lcup - scup, 0xff);

    const uint32_t qw = (w + 1) / 2, qh = (h + 1) / 2;
    std::vector<uint32_t> dec((size_t)(2 * qw) * (2 * qh), 0);  // sign-magnitude
    const size_t ds = 2 * (size_t)qw;
    std::vector<uint8_t> rho_prev(qw + 1, 0), rho_cur(qw + 1, 0);
    std::vector<uint32_t> e_prev(2 * qw + 4, 0), e_cur(2 * qw + 4, 0);  // offset by 1
    std::vector<uint16_t> tq(qw + 1);
    std::vector<uint32_t> uq(qw + 1);
    for (uint32_t qy = 0; qy < qh; ++qy) {
        const bool initial = qy == 0;
        const uint16_t* tbl = initial ? vlc_tbl0 : vlc_tbl1;
        std::fill(rho_cur.begin(), rho_cur.end(), 0);
        for (uint32_t qx = 0; qx < qw; qx += 2) {
            uint16_t t[2] = {0, 0};
            for (int j = 0; j < 2; ++j) {
                uint32_t x = qx + j;
                if (x >= qw) break;
                uint32_t c;
                if (initial) {
                    uint32_t l = x ? rho_cur[x - 1] : 0;
                    c = ((l & 1) | ((l >> 1) & 1)) | (((l >> 2) & 1) << 1) | (((l >> 3) & 1) << 2);
                } else {
                    uint32_t n = (rho_prev[x] >> 1) & 1, ne = (rho_prev[x] >> 3) & 1;
                    uint32_t nf = (rho_prev[x + 1] >> 1) & 1;
                    uint32_t nw = x ? (rho_prev[x - 1] >> 3) & 1 : 0;
                    uint32_t l = x ? rho_cur[x - 1] : 0;
                    uint32_t ww = (l >> 2) & 1, sw = (l >> 3) & 1;
                    c = (n | nw) | ((ww | sw) << 1) | ((ne | nf) << 2);
                }
                uint16_t e = tbl[(c << 7) | (vlc.fetch() & 0x7f)];
                if (c == 0 && !mel.event()) e = 0;
                vlc.advance(e & 7);
                t[j] = e;
                rho_cur[x] = (uint8_t)((e >> 4) & 0xf);
            }
            uint32_t mode = ((t[0] >> 3) & 1) | (((t[1] >> 3) & 1) << 1);
            if (initial && mode == 3 && mel.event()) mode = 4;
            uint32_t u[2];
            uvlc_decode(vlc, mode, initial, u);
            for (int j = 0; j < 2 && qx + j < qw; ++j) {
                tq[qx + j] = t[j];
                uq[qx + j] = u[j];
            }
        }
        // the exponents of the quad row above decide kappa; then MagSgn
        std::fill(e_cur.begin(), e_cur.end(), 0);
        for (uint32_t x = 0; x < qw; ++x) {
            uint32_t t = tq[x], rho = (t >> 4) & 0xf;
            uint32_t kappa = 1;
            if (!initial && (rho & (rho - 1))) {
                uint32_t emax = 0;
                for (uint32_t k = 2 * x; k < 2 * x + 4; ++k) emax = std::max(emax, e_prev[k]);
                kappa = emax > 2 ? emax - 1 : 1;
            }
            uint32_t U = uq[x] + kappa;
            if (U > mmsbp2) {
                if (initial) ht_fail("Decoding this codeblock is stopped. U_q is larger than "
                                     "zero bitplanes + 1 ");
                ht_fail("Decoding this codeblock is stopped. U_q islarger than bitplanes + 1 ");
            }
            if ((rho & 0xa && 2 * qy + 1 >= h) || (rho & 0xc && 2 * x + 1 >= w))
                ht_fail("VLC code produces significant samples outside the codeblock area.");
            for (uint32_t n = 0; n < 4; ++n) {
                if (!((rho >> n) & 1)) continue;
                uint32_t ms = magsgn.fetch();
                uint32_t m = U - ((t >> (12 + n)) & 1);
                magsgn.advance(m);
                uint32_t v = (m ? ms & (0xffffffffu >> (32 - m)) : 0) | (((t >> (8 + n)) & 1) << m);
                v |= 1;
                uint32_t yy = 2 * qy + (n & 1), xx = 2 * x + (n >> 1);
                dec[yy * ds + xx] = (ms << 31) | ((v + 2) << (p - 1));
                if (n & 1) {
                    uint32_t bl = 32 - (uint32_t)__builtin_clz(v);
                    e_cur[xx + 1] = bl;
                }
            }
        }
        std::swap(rho_prev, rho_cur);
        std::swap(e_prev, e_cur);
    }

    if (num_passes > 1) {
        // significance after the cleanup pass, then SigProp (groups of 4
        // columns in stripes of 4 rows; the signs of the group's new samples
        // follow its significance bits) and MagRef
        std::vector<uint8_t> sig((size_t)(w + 2) * (h + 2), 0);
        auto S = [&](int64_t y, int64_t x) -> uint8_t& {
            return sig[(size_t)(y + 1) * (w + 2) + x + 1];
        };
        for (uint32_t y = 0; y < h; ++y)
            for (uint32_t x = 0; x < w; ++x) S(y, x) = dec[y * ds + x] ? 1 : 0;
        const bool causal = (cblksty & CBLK_VSC) != 0;
        if (num_passes > 2) {
            HtRev mr(coded + lengths1 + lengths2 - 1, lengths2, true);
            uint32_t half = 1u << (p - 2);
            for (uint32_t y0 = 0; y0 < h; y0 += 4)
                for (uint32_t x = 0; x < w; ++x)
                    for (uint32_t y = y0; y < y0 + 4 && y < h; ++y) {
                        if (!S(y, x)) continue;
                        uint32_t b = mr.fetch() & 1;
                        mr.advance(1);
                        uint32_t& d = dec[y * ds + x];
                        d ^= (1 - b) << (p - 1);
                        d |= half;
                    }
        }
        HtFwd sp(coded + lengths1, lengths2, 0);
        uint32_t val = 3u << (p - 2);
        std::vector<std::pair<uint32_t, uint32_t>> fresh;
        for (uint32_t y0 = 0; y0 < h; y0 += 4)
            for (uint32_t x0 = 0; x0 < w; x0 += 4) {
                fresh.clear();
                for (uint32_t x = x0; x < x0 + 4 && x < w; ++x)
                    for (uint32_t y = y0; y < y0 + 4 && y < h; ++y) {
                        if (S(y, x)) continue;
                        const int64_t Y = y, X = x;
                        bool below = !(causal && (y & 3) == 3);
                        bool any = S(Y - 1, X - 1) || S(Y - 1, X) || S(Y - 1, X + 1) ||
                                   S(Y, X - 1) || S(Y, X + 1);
                        if (below) any = any || S(Y + 1, X - 1) || S(Y + 1, X) || S(Y + 1, X + 1);
                        if (!any) continue;
                        uint32_t b = sp.fetch() & 1;
                        sp.advance(1);
                        if (b) {
                            S(y, x) = 2;
                            fresh.emplace_back(y, x);
                        }
                    }
                for (auto& yx : fresh) {
                    uint32_t sgn = sp.fetch() & 1;
                    sp.advance(1);
                    dec[yx.first * ds + yx.second] = (sgn << 31) | val;
                }
            }
    }
    for (uint32_t y = 0; y < h; ++y)
        for (uint32_t x = 0; x < w; ++x) {
            uint32_t v = dec[y * ds + x];
            int32_t mag = (int32_t)(v & 0x7fffffffu);
            data[(size_t)y * w + x] = (v >> 31) ? -mag : mag;
        }
}

// ------------------------------------------------------------------ inverse DWT

// 5/3, integers (opj_idwt53_h / _v): one line of sn low then dn high samples
void idwt53_line(int32_t* x, int32_t sn, int32_t dn, int cas, std::vector<int32_t>& tmp) {
    int32_t len = sn + dn;
    if (cas == 0) {
        if (len <= 1) return;
    } else if (len == 1) {
        x[0] /= 2;
        return;
    } else if (len == 0) {
        return;
    }
    tmp.resize((size_t)len);
    int32_t* X = tmp.data();
    for (int32_t i = 0; i < sn; ++i) X[cas + 2 * i] = x[i];
    for (int32_t i = 0; i < dn; ++i) X[1 - cas + 2 * i] = x[sn + i];
    auto at = [&](int32_t k) { return X[k < 0 ? -k : k >= len ? 2 * (len - 1) - k : k]; };
    for (int32_t k = cas; k < len; k += 2) {
        uint32_t s = (uint32_t)at(k - 1) + (uint32_t)at(k + 1) + 2u;
        X[k] = (int32_t)((uint32_t)X[k] - (uint32_t)((int32_t)s >> 2));
    }
    for (int32_t k = 1 - cas; k < len; k += 2) {
        uint32_t s = (uint32_t)at(k - 1) + (uint32_t)at(k + 1);
        X[k] = (int32_t)((uint32_t)X[k] + (uint32_t)((int32_t)s >> 1));
    }
    memcpy(x, X, (size_t)len * sizeof(int32_t));
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f, DWT_GAMMA = 0.882911075f,
            DWT_DELTA = 0.443506852f, DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

// opj_v8dwt_decode_step2 on one lane: w[a + 2i] += (w[b + 2i - ...] + ...) * c
void step2(float* X, int32_t l_off, int32_t w_off, uint32_t end, uint32_t m, float c) {
    // fl starts at X[l_off], fw at X[w_off]; fw[-1] is updated
    float* fl = X + l_off;
    float* fw = X + w_off;
    uint32_t imax = end < m ? end : m;
    for (uint32_t i = 0; i < imax; ++i) {
        fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        c += c;
        fw[-1] = fw[-1] + fl[0] * c;
    }
}

void idwt97_line(float* x, int32_t sn, int32_t dn, int cas, std::vector<float>& tmp) {
    int32_t len = sn + dn;
    tmp.assign((size_t)len + 2, 0.0f);
    float* X = tmp.data();
    for (int32_t i = 0; i < sn; ++i) X[cas + 2 * i] = x[i];
    for (int32_t i = 0; i < dn; ++i) X[1 - cas + 2 * i] = x[sn + i];
    int32_t a, b;
    bool go = true;
    if (cas == 0) {
        if (!((dn > 0) || (sn > 1))) go = false;
        a = 0;
        b = 1;
    } else {
        if (!((sn > 0) || (dn > 1))) go = false;
        a = 1;
        b = 0;
    }
    if (go) {
        for (int32_t i = 0; i < sn; ++i) X[a + 2 * i] *= DWT_K;
        for (int32_t i = 0; i < dn; ++i) X[b + 2 * i] *= DWT_TWO_INVK;
        auto mn = [](int32_t p, int32_t q) { return (uint32_t)(p < q ? p : q); };
        step2(X, b, a + 1, (uint32_t)sn, mn(sn, dn - a), -DWT_DELTA);
        step2(X, a, b + 1, (uint32_t)dn, mn(dn, sn - b), -DWT_GAMMA);
        step2(X, b, a + 1, (uint32_t)sn, mn(sn, dn - a), -DWT_BETA);
        step2(X, a, b + 1, (uint32_t)dn, mn(dn, sn - b), -DWT_ALPHA);
    }
    memcpy(x, X, (size_t)len * sizeof(float));
}

void idwt_tile(TileComp& tc, uint32_t numres, bool reversible) {
    if (numres > tc.numresolutions) numres = tc.numresolutions;
    Resolution* tr = &tc.res[0];
    uint32_t rw = (uint32_t)(tr->x1 - tr->x0), rh = (uint32_t)(tr->y1 - tr->y0);
    const Resolution& top = tc.res[tc.numresolutions - 1];
    uint32_t w = (uint32_t)(top.x1 - top.x0);
    if (numres <= 1 || (reversible && w == 0)) return;
    std::vector<int32_t> itmp, icol;
    std::vector<float> ftmp, fcol;
    while (--numres) {
        ++tr;
        int32_t hsn = (int32_t)rw, vsn = (int32_t)rh;
        rw = (uint32_t)(tr->x1 - tr->x0);
        rh = (uint32_t)(tr->y1 - tr->y0);
        int32_t hdn = (int32_t)rw - hsn, vdn = (int32_t)rh - vsn;
        int hcas = tr->x0 % 2, vcas = tr->y0 % 2;
        if (hcas < 0) hcas = -hcas;
        if (vcas < 0) vcas = -vcas;
        for (uint32_t j = 0; j < rh; ++j) {
            int32_t* row = tc.data.data() + (size_t)j * w;
            if (reversible) idwt53_line(row, hsn, hdn, hcas, itmp);
            else idwt97_line(reinterpret_cast<float*>(row), hsn, hdn, hcas, ftmp);
        }
        icol.resize(rh);
        fcol.resize(rh);
        for (uint32_t i = 0; i < rw; ++i) {
            int32_t* base = tc.data.data() + i;
            for (uint32_t j = 0; j < rh; ++j) icol[j] = base[(size_t)j * w];
            if (reversible) {
                idwt53_line(icol.data(), vsn, vdn, vcas, itmp);
            } else {
                idwt97_line(reinterpret_cast<float*>(icol.data()), vsn, vdn, vcas, ftmp);
            }
            for (uint32_t j = 0; j < rh; ++j) base[(size_t)j * w] = icol[j];
        }
    }
}

// ------------------------------------------------------------------ the decoder

struct Decoder {
    const uint8_t* s;
    size_t n, pos = 0;
    uint32_t ihdr_w, ihdr_h;

    // image
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, numcomps = 0;
    std::vector<Comp> comps;
    bool allow_different_bit_depth_sign = false;
    // tiling
    uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    Tcp default_tcp;
    std::vector<Tcp> tcps;
    // PPM
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_markers;
    std::vector<bool> ppm_present;
    std::vector<uint8_t> ppm_buffer;
    size_t ppm_pos = 0;

    uint32_t state = ST_NONE;
    uint32_t current_tile = 0;
    uint32_t sot_length = 0;
    bool last_tile_part = false, can_decode = false;

    // the current tile
    uint32_t ttx0, tty0, ttx1, tty1;
    std::vector<TileComp> tile;

    Decoder(const uint8_t* p, size_t len, uint32_t iw, uint32_t ih)
        : s(p), n(len), ihdr_w(iw), ihdr_h(ih) {}

    size_t left() const { return n - pos; }
    size_t read(uint8_t* dst, size_t k) {
        size_t m = k < left() ? k : left();
        memcpy(dst, s + pos, m);
        pos += m;
        return m;
    }
    bool read2(uint32_t& v) {
        uint8_t b[2];
        if (read(b, 2) != 2) return false;
        v = be(b, 2);
        return true;
    }
    Tcp& cur_tcp() { return (state == ST_TPH) ? tcps[current_tile] : default_tcp; }

    // marker table: allowed states
    uint32_t states_of(uint32_t id) {
        switch (id) {
            case M_SOT: return ST_MH | ST_TPHSOT;
            case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC:
            case M_COM: case M_MCT: case M_MCC: case M_MCO:
                return ST_MH | ST_TPH;
            case M_SIZ: return ST_MHSIZ;
            case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD: case M_CAP:
            case M_CPF:
                return ST_MH;
            case M_PLT: case M_PPT: return ST_TPH;
            case M_SOP: return 0;
            default: return ST_MH | ST_TPH;  // unknown
        }
    }
    bool known(uint32_t id) {
        switch (id) {
            case M_SOT: case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC:
            case M_SIZ: case M_TLM: case M_PLM: case M_PLT: case M_PPM: case M_PPT: case M_SOP:
            case M_CRG: case M_COM: case M_MCT: case M_CBD: case M_CAP: case M_CPF: case M_MCC:
            case M_MCO:
                return true;
            default: return false;
        }
    }

    void handle(uint32_t id, const uint8_t* p, uint32_t size) {
        switch (id) {
            case M_SOT: read_sot(p, size); break;
            case M_COD: read_cod(p, size); break;
            case M_COC: read_coc(p, size); break;
            case M_RGN: read_rgn(p, size); break;
            case M_QCD: read_qcd(p, size); break;
            case M_QCC: read_qcc(p, size); break;
            case M_POC: read_poc(p, size); break;
            case M_SIZ: read_siz(p, size); break;
            case M_TLM: read_tlm(p, size); break;
            case M_PLM: if (size < 1) FAIL("Error reading PLM marker"); break;
            case M_PLT: read_plt(p, size); break;
            case M_PPM: read_ppm(p, size); break;
            case M_PPT: read_ppt(p, size); break;
            case M_CRG: if (size != numcomps * 4) FAIL("Error reading CRG marker"); break;
            case M_COM: break;
            case M_CAP: case M_CPF: break;  // read, never checked
            case M_MCT: read_mct(p, size); break;
            case M_MCC: read_mcc(p, size); break;
            case M_MCO: read_mco(p, size); break;
            case M_CBD: read_cbd(p, size); break;
            default: FAIL("Not sure how that happened.");
        }
    }

    // ---------------------------------------------------------------- marker segments

    void read_siz(const uint8_t* p, uint32_t size) {
        if (size < 36) FAIL("Error with SIZ marker size");
        uint32_t rem = size - 36;
        if (rem % 3) FAIL("Error with SIZ marker size");
        uint32_t nb = rem / 3;
        x1 = be(p + 2, 4);
        y1 = be(p + 6, 4);
        x0 = be(p + 10, 4);
        y0 = be(p + 14, 4);
        tdx = be(p + 18, 4);
        tdy = be(p + 22, 4);
        tx0 = be(p + 26, 4);
        ty0 = be(p + 30, 4);
        uint32_t nc = be(p + 34, 2);
        if (nc >= 16385) FAIL("Error with SIZ marker: number of component is illegal -> %u", nc);
        numcomps = nc;
        if (numcomps != nb)
            FAIL("Error with SIZ marker: number of component is not compatible with the "
                 "remaining number of parameters ( %u vs %u)", numcomps, nb);
        if (x0 >= x1 || y0 >= y1) FAIL("Error with SIZ marker: negative or zero image size");
        if (tdx == 0 || tdy == 0) FAIL("Error with SIZ marker: invalid tile size");
        uint32_t ltx1 = uadds(tx0, tdx), lty1 = uadds(ty0, tdy);
        if (tx0 > x0 || ty0 > y0 || ltx1 <= x0 || lty1 <= y0)
            FAIL("Error with SIZ marker: illegal tile offset");
        if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != x1 - x0 || ihdr_h != y1 - y0))
            FAIL("Error with SIZ marker: IHDR w(%u) h(%u) vs. SIZ w(%u) h(%u)", ihdr_w, ihdr_h,
                 x1 - x0, y1 - y0);
        comps.assign(numcomps, Comp());
        const uint8_t* q = p + 36;
        for (uint32_t i = 0; i < numcomps; ++i, q += 3) {
            comps[i].prec = (q[0] & 0x7f) + 1u;
            comps[i].sgnd = q[0] >> 7;
            comps[i].dx = q[1];
            comps[i].dy = q[2];
            if (comps[i].dx < 1 || comps[i].dy < 1)
                FAIL("Invalid values for comp = %u : dx=%u dy=%u", i, comps[i].dx, comps[i].dy);
            if (comps[i].prec > 31)
                FAIL("Invalid values for comp = %u : prec=%u (OpenJpeg only supports up to 31)",
                     i, comps[i].prec);
        }
        tw = uceildiv(x1 - tx0, tdx);
        th = uceildiv(y1 - ty0, tdy);
        if (tw == 0 || th == 0 || tw > 65535 / th)
            FAIL("Invalid number of tiles : %u x %u (maximum fixed by jpeg2000 norm is 65535 "
                 "tiles)", tw, th);
        default_tcp.tccps.assign(numcomps, Tccp());
        for (uint32_t i = 0; i < numcomps; ++i)  // from SIZ, before any CBD or MCO
            default_tcp.tccps[i].dc_level_shift = comps[i].sgnd ? 0 : 1 << (comps[i].prec - 1);
        tcps.assign((size_t)tw * th, Tcp());
        state = ST_MH;
    }

    // ---------------------------------------------------------------- Part 2

    void read_mct(const uint8_t* p, uint32_t size) {
        Tcp& tcp = cur_tcp();
        if (size < 2) FAIL("Error reading MCT marker");
        if (be(p, 2) != 0) return;  // "Cannot take in charge mct data within multiple MCT records"
        if (size <= 6) FAIL("Error reading MCT marker");
        uint32_t imct = be(p + 2, 2), indix = imct & 0xff;
        MctRecord* rec = nullptr;
        for (auto& r : tcp.mct_records)
            if (r.index == indix) {
                rec = &r;
                break;
            }
        if (!rec) {
            tcp.mct_records.emplace_back();
            rec = &tcp.mct_records.back();
        }
        rec->data.clear();
        rec->index = indix;
        rec->element_type = (imct >> 10) & 3;
        if (be(p + 4, 2) != 0) return;  // "Cannot take in charge multiple MCT markers"
        rec->data.assign(p + 6, p + size);
    }

    void read_mcc(const uint8_t* p, uint32_t size) {
        Tcp& tcp = cur_tcp();
        if (size < 2) FAIL("Error reading MCC marker");
        if (be(p, 2) != 0) return;  // "Cannot take in charge multiple data spanning"
        if (size < 7) FAIL("Error reading MCC marker");
        uint32_t indix = p[2];
        MccRecord* rec = nullptr;
        for (uint32_t i = 0; i < tcp.nb_mcc; ++i)
            if (tcp.mcc_slots[i].index == indix) {
                rec = &tcp.mcc_slots[i];
                break;
            }
        bool fresh = rec == nullptr;
        if (fresh) {  // the next slot, counted only once the segment is read
            if (tcp.nb_mcc == tcp.mcc_slots.size()) tcp.mcc_slots.emplace_back();
            rec = &tcp.mcc_slots[tcp.nb_mcc];
        }
        rec->index = indix;
        if (be(p + 3, 2) != 0) return;  // "Cannot take in charge multiple data spanning"
        uint32_t nb_collections = be(p + 5, 2);
        if (nb_collections > 1) return;  // "Cannot take in charge multiple collections"
        const uint8_t* q = p + 7;
        size -= 7;
        for (uint32_t i = 0; i < nb_collections; ++i) {
            if (size < 3) FAIL("Error reading MCC marker");
            if (q[0] != 1) return;  // "... other than array decorrelation"
            uint32_t n = be(q + 1, 2);
            q += 3;
            size -= 3;
            uint32_t nbytes = 1 + (n >> 15);
            rec->nb_comps = n & 0x7fff;
            if (size < nbytes * rec->nb_comps + 2) FAIL("Error reading MCC marker");
            size -= nbytes * rec->nb_comps + 2;
            for (uint32_t j = 0; j < rec->nb_comps; ++j, q += nbytes)
                if (be(q, (int)nbytes) != j) return;  // "... with indix shuffle"
            n = be(q, 2);
            q += 2;
            nbytes = 1 + (n >> 15);
            if ((n & 0x7fff) != rec->nb_comps) return;  // "... without same number of indixes"
            if (size < nbytes * rec->nb_comps + 3) FAIL("Error reading MCC marker");
            size -= nbytes * rec->nb_comps + 3;
            for (uint32_t j = 0; j < rec->nb_comps; ++j, q += nbytes)
                if (be(q, (int)nbytes) != j) return;  // "... with indix shuffle"
            uint32_t t = be(q, 3);  // reversibility, offset and decorrelation arrays
            q += 3;
            rec->deco = rec->offset = -1;
            for (int which = 0; which < 2; ++which) {
                uint32_t want = which == 0 ? t & 0xff : (t >> 8) & 0xff;
                if (want == 0) continue;
                int32_t found = -1;
                for (size_t j = 0; j < tcp.mct_records.size(); ++j)
                    if (tcp.mct_records[j].index == want) {
                        found = (int32_t)j;
                        break;
                    }
                if (found < 0) FAIL("Error reading MCC marker");
                (which == 0 ? rec->deco : rec->offset) = found;
            }
        }
        if (size != 0) FAIL("Error reading MCC marker");
        if (fresh) ++tcp.nb_mcc;
    }

    // an MCT array's elements as int32 (j2k_mct_read_functions_to_int32: 16-bit
    // values unsigned, floats truncated as x86 converts them)
    static int32_t mct_int32(const uint8_t* d, uint32_t type) {
        auto trunc = [](double v) -> int32_t {
            if (!(v > -2147483649.0 && v < 2147483648.0)) return INT32_MIN;
            return (int32_t)v;
        };
        switch (type) {
            case 0: return (int32_t)be(d, 2);
            case 1: return (int32_t)be(d, 4);
            case 2: {
                uint32_t b = be(d, 4);
                float f;
                memcpy(&f, &b, 4);
                return trunc(f);
            }
            default: {
                uint64_t b = (uint64_t)be(d, 4) << 32 | be(d + 4, 4);
                double f;
                memcpy(&f, &b, 8);
                return trunc(f);
            }
        }
    }

    // opj_j2k_add_mct: only the first MCC record is ever compared with the index
    void add_mct(Tcp& tcp, uint32_t index) {
        static const uint32_t ELEMENT_SIZE[4] = {2, 4, 4, 8};
        if (tcp.nb_mcc == 0 || tcp.mcc_slots[0].index != index) return;  // discarded
        const MccRecord& rec = tcp.mcc_slots[0];
        if (rec.nb_comps != numcomps) return;
        if (rec.deco >= 0) {
            const MctRecord& m = tcp.mct_records[rec.deco];
            if (m.data.size() != (size_t)ELEMENT_SIZE[m.element_type] * numcomps * numcomps)
                FAIL("Error reading MCO marker (decorrelation array size)");
        }
        if (rec.offset >= 0) {
            const MctRecord& m = tcp.mct_records[rec.offset];
            uint32_t es = ELEMENT_SIZE[m.element_type];
            if (m.data.size() != (size_t)es * numcomps)
                FAIL("Error reading MCO marker (offset array size)");
            for (uint32_t i = 0; i < numcomps; ++i)
                tcp.tccps[i].dc_level_shift = mct_int32(m.data.data() + (size_t)i * es,
                                                         m.element_type);
        }
    }

    void read_mco(const uint8_t* p, uint32_t size) {
        Tcp& tcp = cur_tcp();
        if (size < 1) FAIL("Error reading MCO marker");
        uint32_t nb_stages = p[0];
        if (nb_stages > 1) return;  // "Cannot take in charge multiple transformation stages."
        if (size != nb_stages + 1) FAIL("Error reading MCO marker");
        for (auto& tc : tcp.tccps) tc.dc_level_shift = 0;
        for (uint32_t i = 0; i < nb_stages; ++i) add_mct(tcp, p[1 + i]);
    }

    void read_cbd(const uint8_t* p, uint32_t size) {
        if (size != numcomps + 2) FAIL("Crror reading CBD marker");
        if (be(p, 2) != numcomps) FAIL("Crror reading CBD marker");
        for (uint32_t i = 0; i < numcomps; ++i) {
            comps[i].sgnd = (p[2 + i] >> 7) & 1;
            comps[i].prec = (p[2 + i] & 0x7fu) + 1;
            if (comps[i].prec > 31)
                FAIL("Invalid values for comp = %u : prec=%u (should be between 1 and 38 "
                     "according to the JPEG2000 norm. OpenJPEG only supports up to 31)", i,
                     comps[i].prec);
        }
    }

    void read_SPCod_SPCoc(uint32_t compno, const uint8_t*& p, uint32_t& size) {
        Tccp& tccp = cur_tcp().tccps[compno];
        if (size < 5) FAIL("Error reading SPCod SPCoc element");
        tccp.numresolutions = p[0] + 1u;
        if (tccp.numresolutions > (uint32_t)MAXRLVLS)
            FAIL("Invalid value for numresolutions : %u, max value is set in openjpeg.h at %d",
                 tccp.numresolutions, MAXRLVLS);
        tccp.cblkw = p[1] + 2u;
        tccp.cblkh = p[2] + 2u;
        if (tccp.cblkw > 10 || tccp.cblkh > 10 || tccp.cblkw + tccp.cblkh > 12)
            FAIL("Error reading SPCod SPCoc element, Invalid cblk w/h");
        tccp.cblksty = p[3];
        if (tccp.cblksty & CBLK_HTMIXED)
            FAIL("Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style found");
        tccp.qmfbid = p[4];
        if (tccp.qmfbid > 1) FAIL("Error reading SPCod SPCoc element, Invalid transformation found");
        p += 5;
        size -= 5;
        if (tccp.csty & CP_CSTY_PRT) {
            if (size < tccp.numresolutions) FAIL("Error reading SPCod SPCoc element");
            for (uint32_t i = 0; i < tccp.numresolutions; ++i) {
                uint32_t t = p[i];
                if (i != 0 && ((t & 0xf) == 0 || (t >> 4) == 0)) FAIL("Invalid precinct size");
                tccp.prcw[i] = t & 0xf;
                tccp.prch[i] = t >> 4;
            }
            p += tccp.numresolutions;
            size -= tccp.numresolutions;
        } else {
            for (uint32_t i = 0; i < tccp.numresolutions; ++i) tccp.prcw[i] = tccp.prch[i] = 15;
        }
    }

    void read_cod(const uint8_t* p, uint32_t size) {
        Tcp& tcp = cur_tcp();
        if (tcp.cod) FAIL("COD marker already read. No more than one COD marker per tile.");
        tcp.cod = true;
        if (size < 5) FAIL("Error reading COD marker");
        tcp.csty = p[0];
        if (tcp.csty & ~(CP_CSTY_PRT | CP_CSTY_SOP | CP_CSTY_EPH))
            FAIL("Unknown Scod value in COD marker");
        tcp.prg = p[1];
        if (tcp.prg > 4) tcp.prg = -1;  // OPJ_PROG_UNKNOWN
        tcp.numlayers = be(p + 2, 2);
        if (tcp.numlayers < 1)
            FAIL("Invalid number of layers in COD marker : %u not in range [1-65535]",
                 tcp.numlayers);
        tcp.num_layers_to_decode = tcp.numlayers;
        tcp.mct = p[4];
        if (tcp.mct > 1) FAIL("Invalid multiple component transformation");
        p += 5;
        size -= 5;
        for (auto& tc : tcp.tccps) tc.csty = tcp.csty & CP_CSTY_PRT;
        read_SPCod_SPCoc(0, p, size);
        if (size != 0) FAIL("Error reading COD marker");
        const Tccp& ref = tcp.tccps[0];
        for (uint32_t i = 1; i < numcomps; ++i) {
            Tccp& t = tcp.tccps[i];
            t.numresolutions = ref.numresolutions;
            t.cblkw = ref.cblkw;
            t.cblkh = ref.cblkh;
            t.cblksty = ref.cblksty;
            t.qmfbid = ref.qmfbid;
            memcpy(t.prcw, ref.prcw, sizeof t.prcw);
            memcpy(t.prch, ref.prch, sizeof t.prch);
        }
    }

    void read_coc(const uint8_t* p, uint32_t size) {
        Tcp& tcp = cur_tcp();
        uint32_t room = numcomps <= 256 ? 1 : 2;
        if (size < room + 1) FAIL("Error reading COC marker");
        size -= room + 1;
        uint32_t compno = be(p, (int)room);
        p += room;
        if (compno >= numcomps) FAIL("Error reading COC marker (bad number of components)");
        tcp.tccps[compno].csty = p[0];
        p += 1;
        read_SPCod_SPCoc(compno, p, size);
        if (size != 0) FAIL("Error reading COC marker");
    }

    void read_SQcd_SQcc(uint32_t compno, const uint8_t*& p, uint32_t& size) {
        Tcp& tcp = cur_tcp();
        if (compno >= numcomps) FAIL("Error reading SQcd or SQcc element");
        Tccp& tccp = tcp.tccps[compno];
        if (size < 1) FAIL("Error reading SQcd or SQcc element");
        size -= 1;
        uint32_t t = p[0];
        p += 1;
        tccp.qntsty = t & 0x1f;
        tccp.numgbits = t >> 5;
        uint32_t num_band;
        if (tccp.qntsty == 1) num_band = 1;
        else num_band = tccp.qntsty == 0 ? size : size / 2;
        if (tccp.qntsty == 0) {
            for (uint32_t b = 0; b < num_band; ++b) {
                uint32_t v = p[b];
                if (b < (uint32_t)MAXBANDS) {
                    tccp.stepsizes[b].expn = (int32_t)(v >> 3);
                    tccp.stepsizes[b].mant = 0;
                }
            }
            p += num_band;
            if (size < num_band) FAIL("Error reading SQcd or SQcc element");
            size -= num_band;
        } else {
            if (size < 2 * num_band) FAIL("Error reading SQcd or SQcc element");
            for (uint32_t b = 0; b < num_band; ++b) {
                uint32_t v = be(p + 2 * b, 2);
                if (b < (uint32_t)MAXBANDS) {
                    tccp.stepsizes[b].expn = (int32_t)(v >> 11);
                    tccp.stepsizes[b].mant = (int32_t)(v & 0x7ff);
                }
            }
            p += 2 * num_band;
            size -= 2 * num_band;
        }
        if (tccp.qntsty == 1) {
            for (int b = 1; b < MAXBANDS; ++b) {
                int32_t e = tccp.stepsizes[0].expn - (b - 1) / 3;
                tccp.stepsizes[b].expn = e > 0 ? e : 0;
                tccp.stepsizes[b].mant = tccp.stepsizes[0].mant;
            }
        }
    }

    void read_qcd(const uint8_t* p, uint32_t size) {
        read_SQcd_SQcc(0, p, size);
        if (size != 0) FAIL("Error reading QCD marker");
        Tcp& tcp = cur_tcp();
        for (uint32_t i = 1; i < numcomps; ++i) {
            tcp.tccps[i].qntsty = tcp.tccps[0].qntsty;
            tcp.tccps[i].numgbits = tcp.tccps[0].numgbits;
            memcpy(tcp.tccps[i].stepsizes, tcp.tccps[0].stepsizes, sizeof(tcp.tccps[0].stepsizes));
        }
    }

    void read_qcc(const uint8_t* p, uint32_t size) {
        uint32_t compno;
        if (numcomps <= 256) {
            if (size < 1) FAIL("Error reading QCC marker");
            compno = p[0];
            p += 1;
            size -= 1;
        } else {
            if (size < 2) FAIL("Error reading QCC marker");
            compno = be(p, 2);
            p += 2;
            size -= 2;
        }
        if (compno >= numcomps)
            FAIL("Invalid component number: %u, regarding the number of components %u", compno,
                 numcomps);
        read_SQcd_SQcc(compno, p, size);
        if (size != 0) FAIL("Error reading QCC marker");
    }

    void read_rgn(const uint8_t* p, uint32_t size) {
        uint32_t room = numcomps <= 256 ? 1 : 2;
        if (size != 2 + room) FAIL("Error reading RGN marker");
        Tcp& tcp = cur_tcp();
        uint32_t compno = be(p, (int)room);
        if (compno >= numcomps)
            FAIL("bad component number in RGN (%u when there are only %u)", compno, numcomps);
        tcp.tccps[compno].roishift = p[room + 1];
    }

    void read_poc(const uint8_t* p, uint32_t size) {
        uint32_t room = numcomps <= 256 ? 1 : 2;
        uint32_t chunk = 5 + 2 * room;
        uint32_t nb = size / chunk;
        if (nb == 0 || size % chunk) FAIL("Error reading POC marker");
        Tcp& tcp = cur_tcp();
        uint32_t old = tcp.POC ? tcp.numpocs + 1 : 0;
        uint32_t cur = nb + old;
        if (cur >= 32) FAIL("Too many POCs %u", cur);
        tcp.POC = true;
        for (uint32_t i = old; i < cur; ++i) {
            Poc& poc = tcp.pocs[i];
            poc.resno0 = p[0];
            p += 1;
            poc.compno0 = be(p, (int)room);
            p += room;
            poc.layno1 = be(p, 2);
            if (poc.layno1 > tcp.numlayers) poc.layno1 = tcp.numlayers;
            p += 2;
            poc.resno1 = p[0];
            p += 1;
            poc.compno1 = be(p, (int)room);
            p += room;
            poc.prg = p[0];
            p += 1;
            if (poc.compno1 > numcomps) poc.compno1 = numcomps;
        }
        tcp.numpocs = cur - 1;
    }

    void read_tlm(const uint8_t* p, uint32_t size) {
        if (size < 2) FAIL("Error reading TLM marker");
        size -= 2;
        uint32_t stlm = p[1];
        uint32_t st = (stlm >> 4) & 3;
        if (st == 3) FAIL("opj_j2k_read_tlm(): ST = 3 is invalid");
        uint32_t sp = (stlm >> 6) & 1;
        uint32_t q = (sp + 1) * 2 + st;
        if (size % q) FAIL("Error reading TLM marker");
    }

    void read_plt(const uint8_t* p, uint32_t size) {
        if (size < 1) FAIL("Error reading PLT marker");
        uint32_t len = 0;
        for (uint32_t i = 1; i < size; ++i) {
            len |= p[i] & 0x7fu;
            if (p[i] & 0x80) len <<= 7;
            else len = 0;
        }
        if (len != 0) FAIL("Error reading PLT marker");
    }

    void read_ppm(const uint8_t* p, uint32_t size) {
        if (size < 2) FAIL("Error reading PPM marker");
        ppm = true;
        uint32_t z = p[0];
        if (ppm_markers.size() <= z) {
            ppm_markers.resize(z + 1);
            ppm_present.resize(z + 1, false);
        }
        if (ppm_present[z]) FAIL("Zppm %u already read", z);
        ppm_present[z] = true;
        ppm_markers[z].assign(p + 1, p + size);
    }

    void read_ppt(const uint8_t* p, uint32_t size) {
        if (size < 2) FAIL("Error reading PPT marker");
        if (ppm)
            FAIL("Error reading PPT marker: packet header have been previously found in the "
                 "main header (PPM marker).");
        Tcp& tcp = tcps[current_tile];
        tcp.ppt = true;
        uint32_t z = p[0];
        if (tcp.ppt_markers.size() <= z) {
            tcp.ppt_markers.resize(z + 1);
            tcp.ppt_present.resize(z + 1, false);
        }
        if (tcp.ppt_present[z]) FAIL("Zppt %u already read", z);
        tcp.ppt_present[z] = true;
        tcp.ppt_markers[z].assign(p + 1, p + size);
    }

    void merge_ppm() {
        if (!ppm) return;
        uint32_t remaining = 0;
        ppm_buffer.clear();
        for (size_t i = 0; i < ppm_markers.size(); ++i) {
            if (!ppm_present[i]) continue;
            const uint8_t* d = ppm_markers[i].data();
            uint32_t dsz = (uint32_t)ppm_markers[i].size();
            if (remaining >= dsz) {
                ppm_buffer.insert(ppm_buffer.end(), d, d + dsz);
                remaining -= dsz;
                dsz = 0;
            } else {
                ppm_buffer.insert(ppm_buffer.end(), d, d + remaining);
                d += remaining;
                dsz -= remaining;
                remaining = 0;
            }
            while (dsz > 0) {
                if (dsz < 4) FAIL("Not enough bytes to read Nppm");
                uint32_t nppm = be(d, 4);
                d += 4;
                dsz -= 4;
                if (dsz >= nppm) {
                    ppm_buffer.insert(ppm_buffer.end(), d, d + nppm);
                    dsz -= nppm;
                    d += nppm;
                } else {
                    ppm_buffer.insert(ppm_buffer.end(), d, d + dsz);
                    remaining = nppm - dsz;
                    dsz = 0;
                }
            }
        }
        if (remaining != 0) FAIL("Corrupted PPM markers");
        ppm_pos = 0;
    }

    void read_sot(const uint8_t* p, uint32_t size) {
        if (size != 8) FAIL("Error reading SOT marker");
        uint32_t tileno = be(p, 2), tot_len = be(p + 2, 4), part = p[6], num_parts = p[7];
        current_tile = tileno;
        if (tileno >= tw * th) FAIL("Invalid tile number %u", tileno);
        Tcp& tcp = tcps[tileno];
        if (tcp.current_tile_part + 1 != (int32_t)part)
            FAIL("Invalid tile part index for tile number %u. Got %u, expected %d", tileno, part,
                 tcp.current_tile_part + 1);
        tcp.current_tile_part = (int32_t)part;
        if (tot_len != 0 && tot_len < 14 && tot_len != 12)
            FAIL("Psot value is not correct regards to the JPEG2000 norm: %u.", tot_len);
        if (!tot_len) last_tile_part = true;
        if (tcp.nb_tile_parts != 0 && part >= tcp.nb_tile_parts) {
            last_tile_part = true;
            FAIL("In SOT marker, TPSot (%u) is not valid regards to the previous number of "
                 "tile-part (%u), giving up", part, tcp.nb_tile_parts);
        }
        if (num_parts != 0) {
            if (tcp.nb_tile_parts && part >= tcp.nb_tile_parts) {
                last_tile_part = true;
                FAIL("In SOT marker, TPSot (%u) is not valid", part);
            }
            if (part >= num_parts) {
                last_tile_part = true;
                FAIL("In SOT marker, TPSot (%u) is not valid regards to the current number of "
                     "tile-part (header) (%u), giving up", part, num_parts);
            }
            tcp.nb_tile_parts = num_parts;
        }
        if (tcp.nb_tile_parts && tcp.nb_tile_parts == part + 1) can_decode = true;
        sot_length = last_tile_part ? 0 : tot_len - 12;
        state = ST_TPH;
    }

    void read_sod() {
        Tcp& tcp = tcps[current_tile];
        if (last_tile_part) {
            sot_length = (uint32_t)(left() - 2);
        } else if (sot_length >= 2) {
            sot_length -= 2;
        }
        bool pb = false;
        if (sot_length) {
            if ((size_t)sot_length > left())
                FAIL("Tile part length size inconsistent with stream length");
            tcp.has_data = true;
        } else {
            pb = true;
        }
        size_t got = 0;
        if (!pb) {
            size_t m = sot_length < left() ? sot_length : left();
            tcp.data.insert(tcp.data.end(), s + pos, s + pos + m);
            pos += m;
            got = m;
        }
        state = got != sot_length ? ST_NEOC : ST_TPHSOT;
    }

    void read_unk(uint32_t& out) {
        for (;;) {
            uint32_t m;
            if (!read2(m)) FAIL("Stream too short");
            if (m >= 0xff00) {
                if (!(state & states_of(m))) FAIL("Marker is not compliant with its position");
                if (known(m)) {
                    out = m;
                    return;
                }
            }
        }
    }

    void read_main_header() {
        state = ST_MHSOC;
        uint32_t m;
        if (!read2(m) || m != M_SOC) FAIL("Expected a SOC marker");
        state = ST_MHSIZ;
        if (!read2(m)) FAIL("Stream too short");
        bool has_siz = false, has_cod = false, has_qcd = false;
        std::vector<uint8_t> seg;
        while (m != M_SOT) {
            if (m < 0xff00) FAIL("A marker ID was expected (0xff--) instead of %.8x", m);
            if (!known(m)) {
                read_unk(m);
                if (m == M_SOT) break;
            }
            if (m == M_SIZ) has_siz = true;
            else if (m == M_COD) has_cod = true;
            else if (m == M_QCD) has_qcd = true;
            if (!(state & states_of(m))) FAIL("Marker is not compliant with its position");
            uint32_t msize;
            if (!read2(msize)) FAIL("Stream too short");
            if (msize < 2) FAIL("Invalid marker size");
            msize -= 2;
            seg.resize(msize + 1);
            if (read(seg.data(), msize) != msize) FAIL("Stream too short");
            handle(m, seg.data(), msize);
            if (!read2(m)) FAIL("Stream too short");
        }
        if (!has_siz) FAIL("required SIZ marker not found in main header");
        if (!has_cod) FAIL("required COD marker not found in main header");
        if (!has_qcd) FAIL("required QCD marker not found in main header");
        merge_ppm();
        // copy the default coding parameters into each tile's
        for (auto& t : tcps) {
            t = default_tcp;
            t.cod = false;
            t.ppt = false;
            t.current_tile_part = -1;
        }
        state = ST_TPHSOT;
    }

    // opj_j2k_read_tile_header; false: no more tiles
    bool read_tile_header() {
        uint32_t cur = M_SOT;
        if (state == ST_EOC) cur = M_EOC;
        else if (state != ST_TPHSOT) FAIL("codestream ends inside a tile-part");
        std::vector<uint8_t> seg;
        while (!can_decode && cur != M_EOC) {
            while (cur != M_SOD) {
                if (left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                uint32_t msize;
                if (!read2(msize)) FAIL("Stream too short");
                if (msize < 2) FAIL("Inconsistent marker size");
                if (cur == 0x8080 && left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                if ((state & ST_TPH) && sot_length != 0) {
                    if (sot_length < msize + 2) FAIL("Sot length is less than marker size + marker ID");
                    sot_length -= msize + 2;
                }
                msize -= 2;
                if (!(state & states_of(cur))) FAIL("Marker is not compliant with its position");
                seg.resize(msize + 1);
                if (read(seg.data(), msize) != msize) FAIL("Stream too short");
                if (!known(cur)) FAIL("Not sure how that happened.");
                handle(cur, seg.data(), msize);
                if (!read2(cur)) FAIL("Stream too short");
            }
            if (left() == 0 && state == ST_NEOC) break;
            read_sod();
            if (!can_decode) {
                if (!read2(cur)) FAIL("Stream too short");
            }
        }
        if (cur == M_EOC && state != ST_EOC) {
            current_tile = 0;
            state = ST_EOC;
        }
        if (!can_decode) {
            while (current_tile < tw * th && !tcps[current_tile].has_data) ++current_tile;
            if (current_tile == tw * th) return false;
        }
        Tcp& tcp = tcps[current_tile];
        // opj_j2k_merge_ppt
        if (tcp.ppt_merged) FAIL("opj_j2k_merge_ppt() has already been called");
        if (tcp.ppt) {
            tcp.ppt_buffer.clear();
            for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
                if (tcp.ppt_present[i])
                    tcp.ppt_buffer.insert(tcp.ppt_buffer.end(), tcp.ppt_markers[i].begin(),
                                          tcp.ppt_markers[i].end());
            tcp.ppt_merged = true;
            tcp.ppt_pos = 0;
        }
        init_tile(current_tile);
        state |= ST_DATA;
        return true;
    }

    // ---------------------------------------------------------------- tile geometry

    void init_tile(uint32_t tileno) {
        Tcp& tcp = tcps[tileno];
        uint32_t p = tileno % tw, q = tileno / tw;
        uint32_t ltx0 = tx0 + p * tdx, lty0 = ty0 + q * tdy;
        ttx0 = ltx0 > x0 ? ltx0 : x0;
        tty0 = lty0 > y0 ? lty0 : y0;
        uint32_t e = uadds(ltx0, tdx);
        ttx1 = e < x1 ? e : x1;
        e = uadds(lty0, tdy);
        tty1 = e < y1 ? e : y1;
        tile.assign(numcomps, TileComp());
        for (uint32_t c = 0; c < numcomps; ++c) {
            TileComp& tc = tile[c];
            const Tccp& tccp = tcp.tccps[c];
            tc.x0 = (int32_t)uceildiv(ttx0, comps[c].dx);
            tc.y0 = (int32_t)uceildiv(tty0, comps[c].dy);
            tc.x1 = (int32_t)uceildiv(ttx1, comps[c].dx);
            tc.y1 = (int32_t)uceildiv(tty1, comps[c].dy);
            tc.numresolutions = tccp.numresolutions;
            if (tc.numresolutions == 0) FAIL("tile component without resolutions");
            tc.res.assign(tc.numresolutions, Resolution());
            uint32_t level = tc.numresolutions;
            const Stepsize* step = tccp.stepsizes;
            for (uint32_t r = 0; r < tc.numresolutions; ++r) {
                Resolution& res = tc.res[r];
                --level;
                res.x0 = ceildivpow2(tc.x0, (int)level);
                res.y0 = ceildivpow2(tc.y0, (int)level);
                res.x1 = ceildivpow2(tc.x1, (int)level);
                res.y1 = ceildivpow2(tc.y1, (int)level);
                uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
                int32_t tlprcx = floordivpow2(res.x0, (int)pdx) << pdx;
                int32_t tlprcy = floordivpow2(res.y0, (int)pdy) << pdy;
                uint64_t brx = (uint64_t)(uint32_t)ceildivpow2(res.x1, (int)pdx) << pdx;
                uint64_t bry = (uint64_t)(uint32_t)ceildivpow2(res.y1, (int)pdy) << pdy;
                if (brx > 0x7fffffffu || bry > 0x7fffffffu) FAIL("Integer overflow");
                res.pw = res.x0 == res.x1 ? 0 : (uint32_t)(((int32_t)brx - tlprcx) >> pdx);
                res.ph = res.y0 == res.y1 ? 0 : (uint32_t)(((int32_t)bry - tlprcy) >> pdy);
                uint64_t nprec = (uint64_t)res.pw * res.ph;
                if (nprec > (1u << 24)) FAIL("Size of tile data exceeds system limits");
                int32_t tlcbgx, tlcbgy;
                uint32_t cbgw, cbgh;
                if (r == 0) {
                    tlcbgx = tlprcx;
                    tlcbgy = tlprcy;
                    cbgw = pdx;
                    cbgh = pdy;
                    res.numbands = 1;
                } else {
                    tlcbgx = ceildivpow2(tlprcx, 1);
                    tlcbgy = ceildivpow2(tlprcy, 1);
                    cbgw = pdx - 1;
                    cbgh = pdy - 1;
                    res.numbands = 3;
                }
                uint32_t cblkw = tccp.cblkw < cbgw ? tccp.cblkw : cbgw;
                uint32_t cblkh = tccp.cblkh < cbgh ? tccp.cblkh : cbgh;
                for (uint32_t b = 0; b < res.numbands; ++b, ++step) {
                    Band& band = res.bands[b];
                    if (r == 0) {
                        band.bandno = 0;
                        band.x0 = ceildivpow2(tc.x0, (int)level);
                        band.y0 = ceildivpow2(tc.y0, (int)level);
                        band.x1 = ceildivpow2(tc.x1, (int)level);
                        band.y1 = ceildivpow2(tc.y1, (int)level);
                    } else {
                        band.bandno = b + 1;
                        int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
                        band.x0 = ceildivpow2_64(tc.x0 - (xob << level), (int)level + 1);
                        band.y0 = ceildivpow2_64(tc.y0 - (yob << level), (int)level + 1);
                        band.x1 = ceildivpow2_64(tc.x1 - (xob << level), (int)level + 1);
                        band.y1 = ceildivpow2_64(tc.y1 - (yob << level), (int)level + 1);
                    }
                    if (band.empty()) continue;
                    int32_t log2_gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                                        : band.bandno == 3 ? 2 : 1;
                    int32_t Rb = (int32_t)comps[c].prec + log2_gain;
                    band.stepsize = (float)((1.0 + step->mant / 2048.0) *
                                            pow(2.0, (int32_t)(Rb - step->expn))) * 1.0f;
                    band.numbps = step->expn + (int32_t)tccp.numgbits - 1;
                    band.precincts.assign((size_t)nprec, Precinct());
                    for (uint32_t pn = 0; pn < nprec; ++pn) {
                        Precinct& prc = band.precincts[pn];
                        int32_t cbgxs = tlcbgx + (int32_t)(pn % res.pw) * (1 << cbgw);
                        int32_t cbgys = tlcbgy + (int32_t)(pn / res.pw) * (1 << cbgh);
                        int32_t cbgxe = cbgxs + (1 << cbgw), cbgye = cbgys + (1 << cbgh);
                        prc.x0 = cbgxs > band.x0 ? cbgxs : band.x0;
                        prc.y0 = cbgys > band.y0 ? cbgys : band.y0;
                        prc.x1 = cbgxe < band.x1 ? cbgxe : band.x1;
                        prc.y1 = cbgye < band.y1 ? cbgye : band.y1;
                        int32_t tlcx = floordivpow2(prc.x0, (int)cblkw) << cblkw;
                        int32_t tlcy = floordivpow2(prc.y0, (int)cblkh) << cblkh;
                        int32_t brcx = ceildivpow2(prc.x1, (int)cblkw) << cblkw;
                        int32_t brcy = ceildivpow2(prc.y1, (int)cblkh) << cblkh;
                        prc.cw = brcx > tlcx ? (uint32_t)((brcx - tlcx) >> cblkw) : 0;
                        prc.ch = brcy > tlcy ? (uint32_t)((brcy - tlcy) >> cblkh) : 0;
                        uint64_t ncb = (uint64_t)prc.cw * prc.ch;
                        if (ncb > (1u << 24)) FAIL("Size of tile data exceeds system limits");
                        prc.cblks.resize((size_t)ncb);
                        for (uint32_t k = 0; k < ncb; ++k) {
                            Cblk& cb = prc.cblks[k];
                            int32_t cxs = tlcx + (int32_t)(k % prc.cw) * (1 << cblkw);
                            int32_t cys = tlcy + (int32_t)(k / prc.cw) * (1 << cblkh);
                            int32_t cxe = cxs + (1 << cblkw), cye = cys + (1 << cblkh);
                            cb.x0 = cxs > prc.x0 ? cxs : prc.x0;
                            cb.y0 = cys > prc.y0 ? cys : prc.y0;
                            cb.x1 = cxe < prc.x1 ? cxe : prc.x1;
                            cb.y1 = cye < prc.y1 ? cye : prc.y1;
                        }
                        prc.incl.build(prc.cw, prc.ch);
                        prc.imsb.build(prc.cw, prc.ch);
                    }
                }
            }
        }
    }

    // ---------------------------------------------------------------- tier-2

    struct Pi {
        struct Res {
            uint32_t pdx, pdy, pw, ph;
        };
        struct PComp {
            uint32_t dx, dy, numresolutions;
            std::vector<Res> res;
        };
        std::vector<PComp> comps;
        uint32_t tx0, ty0, tx1, ty1;
        uint32_t step_p, step_c, step_r, step_l;
        std::vector<int16_t>* include;
        // poc
        uint32_t resno0 = 0, compno0 = 0, layno0 = 0, precno0 = 0;
        uint32_t resno1 = 0, compno1 = 0, layno1 = 0, precno1 = 0;
        int32_t prg = 0;
        bool first = true;
        uint32_t compno = 0, resno = 0, precno = 0, layno = 0, x = 0, y = 0, dx = 0, dy = 0;
        int stage = 0;  // resume point
    };

    void init_pi_dxdy(Pi& pi, bool one_comp) {
        pi.dx = 0;
        pi.dy = 0;
        uint32_t c0 = one_comp ? pi.compno : 0, c1 = one_comp ? pi.compno + 1 : numcomps;
        for (uint32_t c = c0; c < c1; ++c) {
            const auto& comp = pi.comps[c];
            for (uint32_t r = 0; r < comp.numresolutions; ++r) {
                const auto& res = comp.res[r];
                uint32_t sh = res.pdx + comp.numresolutions - 1 - r;
                if (sh < 32 && comp.dx <= 0xffffffffu / (1u << sh)) {
                    uint32_t d = comp.dx * (1u << sh);
                    pi.dx = !pi.dx ? d : (pi.dx < d ? pi.dx : d);
                }
                sh = res.pdy + comp.numresolutions - 1 - r;
                if (sh < 32 && comp.dy <= 0xffffffffu / (1u << sh)) {
                    uint32_t d = comp.dy * (1u << sh);
                    pi.dy = !pi.dy ? d : (pi.dy < d ? pi.dy : d);
                }
            }
        }
    }

    // the position test and precinct index of RPCL / PCRL / CPRL; false: skip
    bool pos_precinct(Pi& pi) {
        const auto& comp = pi.comps[pi.compno];
        if (pi.resno >= comp.numresolutions) return false;
        const auto& res = comp.res[pi.resno];
        uint32_t levelno = comp.numresolutions - 1 - pi.resno;
        if ((uint32_t)(((uint64_t)comp.dx << levelno) >> levelno) != comp.dx ||
            (uint32_t)(((uint64_t)comp.dy << levelno) >> levelno) != comp.dy)
            return false;
        uint32_t trx0 = uint64_ceildiv_u32(pi.tx0, (uint64_t)comp.dx << levelno);
        uint32_t try0 = uint64_ceildiv_u32(pi.ty0, (uint64_t)comp.dy << levelno);
        uint32_t trx1 = uint64_ceildiv_u32(pi.tx1, (uint64_t)comp.dx << levelno);
        uint32_t try1 = uint64_ceildiv_u32(pi.ty1, (uint64_t)comp.dy << levelno);
        uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
        if (rpx >= 64 || rpy >= 64) return false;
        if ((uint32_t)(((uint64_t)comp.dx << rpx) >> rpx) != comp.dx ||
            (uint32_t)(((uint64_t)comp.dy << rpy) >> rpy) != comp.dy)
            return false;
        if (!(((uint64_t)pi.y % ((uint64_t)comp.dy << rpy) == 0) ||
              ((pi.y == pi.ty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
            return false;
        if (!(((uint64_t)pi.x % ((uint64_t)comp.dx << rpx) == 0) ||
              ((pi.x == pi.tx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
            return false;
        if (res.pw == 0 || res.ph == 0) return false;
        if (trx0 == trx1 || try0 == try1) return false;
        uint32_t prci = (uint64_ceildiv_u32(pi.x, (uint64_t)comp.dx << levelno) >> res.pdx) -
                        (trx0 >> res.pdx);
        uint32_t prcj = (uint64_ceildiv_u32(pi.y, (uint64_t)comp.dy << levelno) >> res.pdy) -
                        (try0 >> res.pdy);
        pi.precno = prci + prcj * res.pw;
        return true;
    }

    // a packet not iterated before: mark it and return true
    int take(Pi& pi) {
        uint64_t index = (uint64_t)pi.layno * pi.step_l + (uint64_t)pi.resno * pi.step_r +
                         (uint64_t)pi.compno * pi.step_c + (uint64_t)pi.precno * pi.step_p;
        if (index >= pi.include->size()) return -1;  // "Invalid access to pi->include"
        if (!(*pi.include)[index]) {
            (*pi.include)[index] = 1;
            return 1;
        }
        return 0;
    }

    // opj_pi_next for every progression order, written as resumable loops
    bool pi_next(Pi& pi) {
        if (pi.compno0 >= numcomps || pi.compno1 >= numcomps + 1) return false;
        bool resume = !pi.first;
        pi.first = false;
        switch (pi.prg) {
            case 0:  // LRCP
                if (resume) goto lrcp_skip;
                for (pi.layno = pi.layno0; pi.layno < pi.layno1; pi.layno++)
                    for (pi.resno = pi.resno0; pi.resno < pi.resno1; pi.resno++)
                        for (pi.compno = pi.compno0; pi.compno < pi.compno1; pi.compno++) {
                            if (pi.resno >= pi.comps[pi.compno].numresolutions) continue;
                            {
                                const auto& res = pi.comps[pi.compno].res[pi.resno];
                                pi.precno1 = res.pw * res.ph;
                            }
                            for (pi.precno = pi.precno0; pi.precno < pi.precno1; pi.precno++) {
                                {
                                    int t = take(pi);
                                    if (t < 0) return false;
                                    if (t) return true;
                                }
                            lrcp_skip:;
                            }
                        }
                return false;
            case 1:  // RLCP
                if (resume) goto rlcp_skip;
                for (pi.resno = pi.resno0; pi.resno < pi.resno1; pi.resno++)
                    for (pi.layno = pi.layno0; pi.layno < pi.layno1; pi.layno++)
                        for (pi.compno = pi.compno0; pi.compno < pi.compno1; pi.compno++) {
                            if (pi.resno >= pi.comps[pi.compno].numresolutions) continue;
                            {
                                const auto& res = pi.comps[pi.compno].res[pi.resno];
                                pi.precno1 = res.pw * res.ph;
                            }
                            for (pi.precno = pi.precno0; pi.precno < pi.precno1; pi.precno++) {
                                {
                                    int t = take(pi);
                                    if (t < 0) return false;
                                    if (t) return true;
                                }
                            rlcp_skip:;
                            }
                        }
                return false;
            case 2:  // RPCL
                if (resume) goto rpcl_skip;
                init_pi_dxdy(pi, false);
                if (pi.dx == 0 || pi.dy == 0) return false;
                for (pi.resno = pi.resno0; pi.resno < pi.resno1; pi.resno++)
                    for (pi.y = pi.ty0; pi.y < pi.ty1; pi.y += pi.dy - (pi.y % pi.dy))
                        for (pi.x = pi.tx0; pi.x < pi.tx1; pi.x += pi.dx - (pi.x % pi.dx))
                            for (pi.compno = pi.compno0; pi.compno < pi.compno1; pi.compno++) {
                                if (!pos_precinct(pi)) continue;
                                for (pi.layno = pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                    {
                                        int t = take(pi);
                                        if (t < 0) return false;
                                        if (t) return true;
                                    }
                                rpcl_skip:;
                                }
                            }
                return false;
            case 3:  // PCRL
                if (resume) goto pcrl_skip;
                init_pi_dxdy(pi, false);
                if (pi.dx == 0 || pi.dy == 0) return false;
                for (pi.y = pi.ty0; pi.y < pi.ty1; pi.y += pi.dy - (pi.y % pi.dy))
                    for (pi.x = pi.tx0; pi.x < pi.tx1; pi.x += pi.dx - (pi.x % pi.dx))
                        for (pi.compno = pi.compno0; pi.compno < pi.compno1; pi.compno++)
                            for (pi.resno = pi.resno0;
                                 pi.resno < std::min(pi.resno1, pi.comps[pi.compno].numresolutions);
                                 pi.resno++) {
                                if (!pos_precinct(pi)) continue;
                                for (pi.layno = pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                    {
                                        int t = take(pi);
                                        if (t < 0) return false;
                                        if (t) return true;
                                    }
                                pcrl_skip:;
                                }
                            }
                return false;
            case 4:  // CPRL
                if (resume) goto cprl_skip;
                for (pi.compno = pi.compno0; pi.compno < pi.compno1; pi.compno++) {
                    init_pi_dxdy(pi, true);
                    if (pi.dx == 0 || pi.dy == 0) return false;
                    for (pi.y = pi.ty0; pi.y < pi.ty1; pi.y += pi.dy - (pi.y % pi.dy))
                        for (pi.x = pi.tx0; pi.x < pi.tx1; pi.x += pi.dx - (pi.x % pi.dx))
                            for (pi.resno = pi.resno0;
                                 pi.resno < std::min(pi.resno1, pi.comps[pi.compno].numresolutions);
                                 pi.resno++) {
                                if (!pos_precinct(pi)) continue;
                                for (pi.layno = pi.layno0; pi.layno < pi.layno1; pi.layno++) {
                                    {
                                        int t = take(pi);
                                        if (t < 0) return false;
                                        if (t) return true;
                                    }
                                cprl_skip:;
                                }
                            }
                }
                return false;
            default:
                return false;
        }
    }

    void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
        if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
        Seg& seg = cb.segs[index];
        seg = Seg();
        if (cblksty & CBLK_TERMALL) {
            seg.maxpasses = 1;
        } else if (cblksty & CBLK_LAZY) {
            if (first) seg.maxpasses = 10;
            else {
                uint32_t prev = cb.segs[index - 1].maxpasses;
                seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
            }
        } else {
            seg.maxpasses = 109;
        }
    }

    static uint32_t getnumpasses(Bio& bio) {
        uint32_t n;
        if (!bio.read(1)) return 1;
        if (!bio.read(1)) return 2;
        if ((n = bio.read(2)) != 3) return 3 + n;
        if ((n = bio.read(5)) != 31) return 6 + n;
        return 37 + bio.read(7);
    }

    // opj_t2_decode_packet: header then body; returns the bytes read from src
    size_t decode_packet(Tcp& tcp, Pi& pi, const uint8_t* src, size_t max_len) {
        Resolution& res = tile[pi.compno].res[pi.resno];
        uint32_t cblksty = tcp.tccps[pi.compno].cblksty;
        if (pi.layno == 0) {
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                if (pi.precno >= band.precincts.size()) FAIL("Invalid precinct");
                Precinct& prc = band.precincts[pi.precno];
                prc.incl.reset();
                prc.imsb.reset();
                for (auto& cb : prc.cblks) {
                    cb.numsegs = 0;
                    cb.real_num_segs = 0;
                }
            }
        }
        const uint8_t* cur = src;
        if (tcp.csty & CP_CSTY_SOP) {
            if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
        }
        // where the header is read from
        const uint8_t* hdr;
        size_t hdr_len;
        if (ppm) {
            hdr = ppm_buffer.data() + ppm_pos;
            hdr_len = ppm_buffer.size() - ppm_pos;
        } else if (tcp.ppt) {
            hdr = tcp.ppt_buffer.data() + tcp.ppt_pos;
            hdr_len = tcp.ppt_buffer.size() - tcp.ppt_pos;
        } else {
            hdr = cur;
            hdr_len = (size_t)(src + max_len - cur);
        }
        Bio bio(hdr, hdr_len);
        uint32_t present = bio.read(1);
        bool has_data = present != 0;
        if (present) {
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                Precinct& prc = band.precincts[pi.precno];
                for (uint32_t k = 0; k < prc.cblks.size(); ++k) {
                    Cblk& cb = prc.cblks[k];
                    uint32_t included;
                    if (!cb.numsegs) included = tgt_decode(bio, prc.incl, k, (int32_t)pi.layno + 1);
                    else included = bio.read(1);
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (!cb.numsegs) {
                        uint32_t i = 0;
                        while (!tgt_decode(bio, prc.imsb, k, (int32_t)i)) ++i;
                        cb.Mb = (uint32_t)band.numbps;
                        cb.numbps = (uint32_t)band.numbps + 1 - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = getnumpasses(bio);
                    uint32_t increment = 0;
                    while (bio.read(1)) ++increment;
                    cb.numlenbits += increment;
                    uint32_t segno = 0;
                    if (!cb.numsegs) {
                        init_seg(cb, 0, cblksty, true);
                    } else {
                        segno = cb.numsegs - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                            ++segno;
                            init_seg(cb, segno, cblksty, false);
                        }
                    }
                    int32_t npass = (int32_t)cb.numnewpasses;
                    do {
                        Seg& sg = cb.segs[segno];
                        if (cblksty & CBLK_HT) {
                            // the cleanup pass alone in the first segment,
                            // the rest in the next
                            sg.numnewpasses = segno == 0 ? 1u : (uint32_t)npass;
                        } else {
                            int32_t room = (int32_t)(sg.maxpasses - sg.numpasses);
                            sg.numnewpasses = (uint32_t)(room < npass ? room : npass);
                        }
                        uint32_t fl = 0;
                        for (uint32_t v = sg.numnewpasses; v > 1; v >>= 1) ++fl;
                        uint32_t bits = cb.numlenbits + fl;
                        if (bits > 32) FAIL("Invalid bit number %u in opj_t2_read_packet_header()", bits);
                        sg.newlen = bio.read(bits);
                        npass -= (int32_t)sg.numnewpasses;
                        if (npass > 0) {
                            ++segno;
                            init_seg(cb, segno, cblksty, false);
                        }
                    } while (npass > 0);
                }
            }
        }
        bio.inalign();
        const uint8_t* h = hdr + bio.numbytes();
        if (tcp.csty & CP_CSTY_EPH) {  // a missing SOP only warns; a missing EPH fails
            if (hdr_len - (size_t)(h - hdr) < 2) FAIL("Not enough space for required EPH marker");
            if (h[0] != 0xff || h[1] != 0x92) FAIL("Expected EPH marker");
            h += 2;
        }
        size_t hlen = (size_t)(h - hdr);
        if (ppm) ppm_pos += hlen;
        else if (tcp.ppt) tcp.ppt_pos += hlen;
        else cur += hlen;
        if (!has_data) return (size_t)(cur - src);

        // opj_t2_read_packet_data
        const uint8_t* end = src + max_len;
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& prc = band.precincts[pi.precno];
            for (auto& cb : prc.cblks) {
                if (!cb.numnewpasses) continue;
                uint32_t si;
                if (!cb.numsegs) {
                    si = 0;
                    ++cb.numsegs;
                } else {
                    si = cb.numsegs - 1;
                    if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                        ++si;
                        ++cb.numsegs;
                    }
                }
                do {
                    Seg& sg = cb.segs[si];
                    if ((size_t)(end - cur) < sg.newlen)
                        FAIL("read: segment too long (%u) with max (%u) for codeblock",
                             sg.newlen, (uint32_t)(end - cur));
                    cb.chunks.push_back(Chunk{cur, sg.newlen});
                    cur += sg.newlen;
                    sg.len += sg.newlen;
                    sg.numpasses += sg.numnewpasses;
                    cb.numnewpasses -= sg.numnewpasses;
                    sg.real_num_passes = sg.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++si;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                cb.real_num_segs = cb.numsegs;
            }
        }
        return (size_t)(cur - src);
    }

    void t2_decode(uint32_t tileno) {
        Tcp& tcp = tcps[tileno];
        // opj_get_all_encoding_parameters
        uint32_t max_prec = 0, max_res = 0;
        std::vector<Pi::PComp> pcomps(numcomps);
        for (uint32_t c = 0; c < numcomps; ++c) {
            const Tccp& tccp = tcp.tccps[c];
            auto& pc = pcomps[c];
            pc.dx = comps[c].dx;
            pc.dy = comps[c].dy;
            pc.numresolutions = tccp.numresolutions;
            pc.res.resize(tccp.numresolutions);
            if (tccp.numresolutions > max_res) max_res = tccp.numresolutions;
            for (uint32_t r = 0; r < tccp.numresolutions; ++r) {
                const Resolution& res = tile[c].res[r];
                pc.res[r] = Pi::Res{tccp.prcw[r], tccp.prch[r], res.pw, res.ph};
                if (res.pw * res.ph > max_prec) max_prec = res.pw * res.ph;
            }
        }
        uint32_t step_p = 1, step_c = max_prec * step_p, step_r = numcomps * step_c,
                 step_l = max_res * step_r;
        std::vector<int16_t> include;
        if (step_l > 0xffffffffu / (tcp.numlayers + 1u)) FAIL("include array too large");
        include.assign((size_t)(tcp.numlayers + 1u) * step_l, 0);
        uint32_t bound = tcp.numpocs + 1;
        const uint8_t* cur = tcp.data.data();
        size_t max_len = tcp.data.size();
        for (uint32_t pino = 0; pino < bound; ++pino) {
            Pi pi;
            pi.comps = pcomps;
            pi.tx0 = ttx0;
            pi.ty0 = tty0;
            pi.tx1 = ttx1;
            pi.ty1 = tty1;
            pi.step_p = step_p;
            pi.step_c = step_c;
            pi.step_r = step_r;
            pi.step_l = step_l;
            pi.include = &include;
            if (tcp.POC) {
                const Poc& poc = tcp.pocs[pino];
                pi.prg = poc.prg;
                pi.resno0 = poc.resno0;
                pi.compno0 = poc.compno0;
                pi.resno1 = poc.resno1;
                pi.compno1 = poc.compno1;
                pi.layno1 = poc.layno1 < tcp.numlayers ? poc.layno1 : tcp.numlayers;
            } else {
                pi.prg = tcp.prg;
                pi.resno1 = max_res;
                pi.compno1 = numcomps;
                pi.layno1 = tcp.numlayers;
            }
            pi.precno1 = max_prec;
            if (pi.prg == -1) FAIL("unknown progression order");
            std::vector<bool> first_pass_failed(numcomps, true);
            while (pi_next(pi)) {
                bool skip;
                if (pi.layno >= tcp.num_layers_to_decode) skip = true;
                else if (pi.resno >= tile[pi.compno].numresolutions) skip = true;
                else {
                    skip = true;
                    const Resolution& res = tile[pi.compno].res[pi.resno];
                    for (uint32_t b = 0; b < res.numbands; ++b)
                        if (!res.bands[b].empty()) skip = false;
                }
                size_t got = decode_packet(tcp, pi, cur, max_len);
                if (!skip) {
                    first_pass_failed[pi.compno] = false;
                    if (pi.resno > comps[pi.compno].resno_decoded)
                        comps[pi.compno].resno_decoded = pi.resno;
                }
                if (first_pass_failed[pi.compno] && comps[pi.compno].resno_decoded == 0)
                    comps[pi.compno].resno_decoded = tile[pi.compno].numresolutions - 1;
                cur += got;
                max_len -= got;
            }
        }
    }

    // ---------------------------------------------------------------- tile decoding

    void decode_tile(uint32_t tileno) {
        Tcp& tcp = tcps[tileno];
        if (!tcp.has_data) FAIL("tile %u has no data", tileno);
        for (uint32_t c = 0; c < numcomps; ++c) {
            TileComp& tc = tile[c];
            const Resolution& top = tc.res[tc.numresolutions - 1];
            tc.data.assign((size_t)(top.x1 - top.x0) * (size_t)(top.y1 - top.y0), 0);
        }
        t2_decode(tileno);
        // tier-1
        T1 t1;
        std::vector<uint8_t> buf;
        for (uint32_t c = 0; c < numcomps; ++c) {
            TileComp& tc = tile[c];
            const Tccp& tccp = tcp.tccps[c];
            const Resolution& top = tc.res[tc.numresolutions - 1];
            size_t tile_w = (size_t)(top.x1 - top.x0);
            for (uint32_t r = 0; r < tc.numresolutions; ++r) {
                Resolution& res = tc.res[r];
                for (uint32_t b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    if (band.empty()) continue;
                    for (auto& prc : band.precincts)
                        for (auto& cb : prc.cblks) {
                            if (tccp.cblksty & CBLK_HT) {
                                t1.w = (uint32_t)(cb.x1 - cb.x0);
                                t1.h = (uint32_t)(cb.y1 - cb.y0);
                                ht_decode_cblk(t1.data, t1.w, t1.h, cb, (uint32_t)tccp.roishift,
                                               tccp.cblksty, buf);
                            } else if (!t1.decode_cblk(cb, band.bandno, (uint32_t)tccp.roishift,
                                                       tccp.cblksty, buf)) {
                                FAIL("opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
                            }
                            int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                            uint32_t cw = t1.w, ch = t1.h;
                            int32_t* d = t1.data.data();
                            if (tccp.roishift) {
                                if (tccp.roishift >= 31) {
                                    for (size_t i = 0; i < (size_t)cw * ch; ++i) d[i] = 0;
                                } else {
                                    int32_t thresh = 1 << tccp.roishift;
                                    for (size_t i = 0; i < (size_t)cw * ch; ++i) {
                                        int32_t v = d[i], mag = v < 0 ? -v : v;
                                        if (mag >= thresh) {
                                            mag >>= tccp.roishift;
                                            d[i] = v < 0 ? -mag : mag;
                                        }
                                    }
                                }
                            }
                            int32_t* dst = tc.data.data() + (size_t)y * tile_w + x;
                            if (tccp.qmfbid == 1) {
                                for (uint32_t j = 0; j < ch; ++j)
                                    for (uint32_t i = 0; i < cw; ++i)
                                        dst[(size_t)j * tile_w + i] = d[(size_t)j * cw + i] / 2;
                            } else {
                                const float stepsize = 0.5f * band.stepsize;
                                float* fdst = reinterpret_cast<float*>(dst);
                                for (uint32_t j = 0; j < ch; ++j)
                                    for (uint32_t i = 0; i < cw; ++i)
                                        fdst[(size_t)j * tile_w + i] =
                                            (float)d[(size_t)j * cw + i] * stepsize;
                            }
                        }
                }
            }
        }
        // inverse DWT
        for (uint32_t c = 0; c < numcomps; ++c)
            idwt_tile(tile[c], comps[c].resno_decoded + 1, tcp.tccps[c].qmfbid == 1);
        // inverse MCT
        if (tcp.mct != 0 && numcomps >= 3) {
            uint32_t mr = tile[0].numresolutions;
            if (mr != tile[1].numresolutions || mr != tile[2].numresolutions)
                FAIL("Tiles don't all have the same dimension. Skip the MCT step.");
            const Resolution& r0 = tile[0].res[mr - 1];
            const Resolution& r1 = tile[1].res[mr - 1];
            const Resolution& r2 = tile[2].res[mr - 1];
            if (r0.x0 != r1.x0 || r0.x1 != r1.x1 || r0.y0 != r1.y0 || r0.y1 != r1.y1 ||
                r0.x0 != r2.x0 || r0.x1 != r2.x1 || r0.y0 != r2.y0 || r0.y1 != r2.y1)
                FAIL("Tiles don't all have the same dimension. Skip the MCT step.");
            size_t n = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
            if (tcp.tccps[0].qmfbid == 1) {
                int32_t *c0 = tile[0].data.data(), *c1 = tile[1].data.data(),
                        *c2 = tile[2].data.data();
                for (size_t i = 0; i < n; ++i) {
                    int32_t y = c0[i], u = c1[i], v = c2[i];
                    int32_t g = y - ((u + v) >> 2);
                    int32_t r = v + g, b = u + g;
                    c0[i] = r;
                    c1[i] = g;
                    c2[i] = b;
                }
            } else {
                float* c0 = reinterpret_cast<float*>(tile[0].data.data());
                float* c1 = reinterpret_cast<float*>(tile[1].data.data());
                float* c2 = reinterpret_cast<float*>(tile[2].data.data());
                for (size_t i = 0; i < n; ++i) {
                    float y = c0[i], u = c1[i], v = c2[i];
                    float r = y + (v * 1.402f);
                    float g = y - (u * 0.34413f) - (v * (0.71414f));
                    float b = y + (u * 1.772f);
                    c0[i] = r;
                    c1[i] = g;
                    c2[i] = b;
                }
            }
        }
        // DC level shift and clamp
        for (uint32_t c = 0; c < numcomps; ++c) {
            TileComp& tc = tile[c];
            const Tccp& tccp = tcp.tccps[c];
            uint32_t rd = comps[c].resno_decoded < tc.numresolutions ? comps[c].resno_decoded
                                                                     : tc.numresolutions - 1;
            const Resolution& res = tc.res[rd];
            const Resolution& top = tc.res[tc.numresolutions - 1];
            uint32_t width = (uint32_t)(res.x1 - res.x0), height = (uint32_t)(res.y1 - res.y0);
            uint32_t stride = (uint32_t)(top.x1 - top.x0) - width;
            int32_t mn, mx;
            if (comps[c].sgnd) {
                mn = -(1 << (comps[c].prec - 1));
                mx = (1 << (comps[c].prec - 1)) - 1;
            } else {
                mn = 0;
                mx = (int32_t)((1u << comps[c].prec) - 1);
            }
            int32_t* ptr = tc.data.data();
            int32_t shift = tccp.dc_level_shift;
            for (uint32_t j = 0; j < height; ++j) {
                for (uint32_t i = 0; i < width; ++i, ++ptr) {
                    if (tccp.qmfbid == 1) {  // an int32 sum, wrapping (OpenJPEG's TODO)
                        int32_t v = (int32_t)((uint32_t)*ptr + (uint32_t)shift);
                        *ptr = v < mn ? mn : v > mx ? mx : v;
                    } else {
                        float f;
                        memcpy(&f, ptr, 4);
                        if (f > (float)INT32_MAX) *ptr = mx;
                        else if (f < (float)INT32_MIN) *ptr = mn;
                        else {
                            int64_t v = (int64_t)lrintf(f) + shift;
                            *ptr = (int32_t)(v < mn ? mn : v > mx ? mx : v);
                        }
                    }
                }
                ptr += stride;
            }
        }
        tcp.data.clear();
        tcp.data.shrink_to_fit();
        tcp.has_data = false;
        can_decode = false;
        state &= ~ST_DATA;
        if (left() == 0 && state == ST_NEOC) return;
        if (state != ST_EOC) {
            uint32_t m;
            if (!read2(m)) FAIL("Stream too short");
            if (m == M_EOC) {
                current_tile = 0;
                state = ST_EOC;
            } else if (m != M_SOT) {
                if (left() == 0) {
                    state = ST_NEOC;
                    return;
                }
                FAIL("Stream too short, expected SOT");
            }
        }
    }
};

// ------------------------------------------------------------------ Pillow's unpack

struct Unpack {
    uint8_t* out8;    // [ysize][xsize][4]
    uint16_t* out16;  // [ysize][xsize] for I;16
    uint32_t xsize, ysize;
    const int32_t* ycc;  // R_Cr, G_Cb, G_Cr, B_Cb: 4 x 256

    std::vector<uint8_t> tilebuf;

    // the tile data as opj_decode_tile_data hands it over
    void build_tile(Decoder& d, size_t min_size) {
        size_t total = 0;
        std::vector<size_t> sizes(d.numcomps);
        for (uint32_t c = 0; c < d.numcomps; ++c) {
            uint32_t csz = (d.comps[c].prec + 7) >> 3;
            if (csz == 3) csz = 4;
            TileComp& tc = d.tile[c];
            uint32_t rd = d.comps[c].resno_decoded < tc.numresolutions ? d.comps[c].resno_decoded
                                                                       : tc.numresolutions - 1;
            const Resolution& res = tc.res[rd];
            sizes[c] = (size_t)(res.x1 - res.x0) * (size_t)(res.y1 - res.y0) * csz;
            total += sizes[c];
        }
        tilebuf.assign(total > min_size ? total : min_size, 0);
        uint8_t* p = tilebuf.data();
        for (uint32_t c = 0; c < d.numcomps; ++c) {
            uint32_t csz = (d.comps[c].prec + 7) >> 3;
            if (csz == 3) csz = 4;
            TileComp& tc = d.tile[c];
            uint32_t rd = d.comps[c].resno_decoded < tc.numresolutions ? d.comps[c].resno_decoded
                                                                       : tc.numresolutions - 1;
            const Resolution& res = tc.res[rd];
            const Resolution& top = tc.res[tc.numresolutions - 1];
            uint32_t width = (uint32_t)(res.x1 - res.x0), height = (uint32_t)(res.y1 - res.y0);
            size_t stride = (size_t)(top.x1 - top.x0);
            for (uint32_t j = 0; j < height; ++j)
                for (uint32_t i = 0; i < width; ++i) {
                    int32_t v = tc.data[(size_t)j * stride + i];
                    if (csz == 1) {
                        *p++ = (uint8_t)(v & 0xff);
                    } else if (csz == 2) {
                        uint16_t h = (uint16_t)(v & 0xffff);
                        memcpy(p, &h, 2);
                        p += 2;
                    } else {
                        memcpy(p, &v, 4);
                        p += 4;
                    }
                }
        }
    }

    uint32_t word(const uint8_t* p, int csiz) {
        if (csiz == 1) return *p;
        if (csiz == 2) {
            uint16_t v;
            memcpy(&v, p, 2);
            return v;
        }
        uint32_t v;
        memcpy(&v, p, 4);
        return v;
    }

    struct CompInfo {
        int shift, offset, csiz;
        uint32_t dx, dy;
    };
    static CompInfo info(const Comp& c, int depth) {
        CompInfo k;
        k.shift = depth - (int)c.prec;
        k.offset = c.sgnd ? 1 << (c.prec - 1) : 0;
        k.csiz = (int)((c.prec + 7) >> 3);
        if (k.csiz == 3) k.csiz = 4;
        if (k.shift < 0) k.offset += 1 << (-k.shift - 1);
        k.dx = c.dx;
        k.dy = c.dy;
        return k;
    }
    static uint32_t shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

    void ycbcr_row(uint8_t* row, uint32_t w) {
        for (uint32_t x = 0; x < w; ++x, row += 4) {
            int y = row[0], cb = row[1], cr = row[2];
            int r = y + (ycc[cr] >> 6);
            int g = y + ((ycc[256 + cb] + ycc[512 + cr]) >> 6);
            int b = y + (ycc[768 + cb] >> 6);
            row[0] = (uint8_t)(r <= 0 ? 0 : r >= 255 ? 255 : r);
            row[1] = (uint8_t)(g <= 0 ? 0 : g >= 255 ? 255 : g);
            row[2] = (uint8_t)(b <= 0 ? 0 : b >= 255 ? 255 : b);
        }
    }

    enum Kind { GRAY_L, GRAY_I, GRAY_RGB, GRAYA_LA, SRGB_RGB, SYCC_RGB, SRGBA_RGBA, SYCCA_RGBA };

    void unpack(Decoder& d, Kind kind, uint32_t tx0, uint32_t ty0, uint32_t tx1, uint32_t ty1) {
        uint32_t x0 = tx0 - d.x0, y0 = ty0 - d.y0, w = tx1 - tx0, h = ty1 - ty0;
        const uint8_t* td = tilebuf.data();
        switch (kind) {
            case GRAY_L:
            case GRAY_I:
            case GRAY_RGB: {
                CompInfo k = info(d.comps[0], kind == GRAY_I ? 16 : 8);
                for (uint32_t y = 0; y < h; ++y) {
                    const uint8_t* data = td + (size_t)k.csiz * y * w;
                    for (uint32_t x = 0; x < w; ++x) {
                        uint32_t v = shift(k.offset + word(data + (size_t)x * k.csiz, k.csiz),
                                           k.shift);
                        size_t o = (size_t)(y0 + y) * xsize + x0 + x;
                        if (kind == GRAY_I) out16[o] = (uint16_t)v;
                        else if (kind == GRAY_L) out8[4 * o] = (uint8_t)v;
                        else {
                            out8[4 * o] = out8[4 * o + 1] = out8[4 * o + 2] = (uint8_t)v;
                            out8[4 * o + 3] = 0xff;
                        }
                    }
                }
                break;
            }
            case GRAYA_LA: {
                CompInfo k = info(d.comps[0], 8), a = info(d.comps[1], 8);
                const uint8_t* at = td + (size_t)k.csiz * w * h;
                for (uint32_t y = 0; y < h; ++y) {
                    const uint8_t* data = td + (size_t)k.csiz * y * w;
                    const uint8_t* adata = at + (size_t)a.csiz * y * w;
                    for (uint32_t x = 0; x < w; ++x) {
                        uint32_t v = shift(k.offset + word(data + (size_t)x * k.csiz, k.csiz),
                                           k.shift);
                        uint32_t av = shift(a.offset + word(adata + (size_t)x * a.csiz, a.csiz),
                                            a.shift);
                        size_t o = 4 * ((size_t)(y0 + y) * xsize + x0 + x);
                        out8[o] = out8[o + 1] = out8[o + 2] = (uint8_t)v;
                        out8[o + 3] = (uint8_t)av;
                    }
                }
                break;
            }
            default: {
                int nc = (kind == SRGB_RGB || kind == SYCC_RGB) ? 3 : 4;
                CompInfo k[4];
                const uint8_t* cdata[4];
                const uint8_t* cptr = td;
                for (int c = 0; c < nc; ++c) {
                    k[c] = info(d.comps[c], 8);
                    cdata[c] = cptr;
                    cptr += (size_t)k[c].csiz * (w / k[c].dx) * (h / k[c].dy);
                }
                bool ycc_conv = kind == SYCC_RGB || kind == SYCCA_RGBA;
                for (uint32_t y = 0; y < h; ++y) {
                    const uint8_t* data[4];
                    for (int c = 0; c < nc; ++c)
                        data[c] = cdata[c] + (size_t)k[c].csiz * (y / k[c].dy) * (w / k[c].dx);
                    uint8_t* row = out8 + 4 * ((size_t)(y0 + y) * xsize + x0);
                    for (uint32_t x = 0; x < w; ++x) {
                        for (int c = 0; c < nc; ++c) {
                            uint32_t v = word(data[c] + (size_t)(x / k[c].dx) * k[c].csiz, k[c].csiz);
                            row[4 * x + c] = (uint8_t)shift(k[c].offset + v, k[c].shift);
                        }
                        if (nc == 3) row[4 * x + 3] = 0xff;
                    }
                    if (ycc_conv) ycbcr_row(row, w);
                }
                break;
            }
        }
    }
};

}  // namespace

// Decode the codestream at data[start:size] (a J2K file, or the stream after
// a JP2 file's boxes, which OpenJPEG reads to the end of the file) into the
// image of Pillow's mode ``mode`` (L, P, PA, I;16, LA, RGB, RGBA, CMYK):
// out8 holds [ysize][xsize][4] bytes, out16 [ysize][xsize] for I;16.
// color_space is OpenJPEG's (from the JP2 colr box; 0 for a raw codestream);
// ihdr_w / ihdr_h the JP2 image header's size (0 for a raw codestream);
// ycc the four YCbCr tables of Pillow's ConvertYCbCr.c. Returns 0, or
// 1 (data OpenJPEG or Pillow refuses) with a message in err.
extern "C" int akr_j2k_decode(const uint8_t* data, int64_t size, int64_t start, int32_t ihdr_w,
                              int32_t ihdr_h, int32_t color_space, const char* mode,
                              int32_t xsize, int32_t ysize, uint8_t* out8, uint16_t* out16,
                              const int32_t* ycc, char* err, int32_t errlen) {
    try {
        if (start < 0 || start > size) FAIL("codestream outside the file");
        Decoder d(data + start, (size_t)(size - start), (uint32_t)ihdr_w, (uint32_t)ihdr_h);
        d.read_main_header();

        // Pillow: the image must be something it can handle
        if (d.numcomps < 1 || d.numcomps > 4 || color_space == CS_UNKNOWN)
            FAIL("%u components in colour space %d (Pillow handles 1-4 in a known space)",
                 d.numcomps, color_space);
        int subsampling = -1;
        for (uint32_t c = 0; c < d.numcomps; ++c)
            if (d.comps[c].dx != 1 || d.comps[c].dy != 1) {
                subsampling = (int)c;
                break;
            }
        int cs = color_space;
        if (cs == CS_UNSPECIFIED) {
            if (d.numcomps <= 2) cs = CS_GRAY;
            else cs = (subsampling == 1 || subsampling == 2) ? CS_SYCC : CS_SRGB;
        }
        struct Entry {
            const char* mode;
            int cs;
            uint32_t ncomp;
            bool sub;
            Unpack::Kind kind;
        };
        static const Entry table[] = {
            {"L", CS_GRAY, 1, false, Unpack::GRAY_L},
            {"P", CS_SRGB, 1, false, Unpack::GRAY_L},
            {"PA", CS_SRGB, 2, false, Unpack::GRAYA_LA},
            {"I;16", CS_GRAY, 1, false, Unpack::GRAY_I},
            {"I;16B", CS_GRAY, 1, false, Unpack::GRAY_I},
            {"LA", CS_GRAY, 2, false, Unpack::GRAYA_LA},
            {"RGB", CS_GRAY, 1, false, Unpack::GRAY_RGB},
            {"RGB", CS_GRAY, 2, false, Unpack::GRAY_RGB},
            {"RGB", CS_SRGB, 3, true, Unpack::SRGB_RGB},
            {"RGB", CS_SYCC, 3, true, Unpack::SYCC_RGB},
            {"RGB", CS_SRGB, 4, true, Unpack::SRGB_RGB},
            {"RGB", CS_SYCC, 4, true, Unpack::SYCC_RGB},
            {"RGBA", CS_GRAY, 1, false, Unpack::GRAY_RGB},
            {"RGBA", CS_GRAY, 2, false, Unpack::GRAYA_LA},
            {"RGBA", CS_SRGB, 3, true, Unpack::SRGB_RGB},
            {"RGBA", CS_SYCC, 3, true, Unpack::SYCC_RGB},
            {"RGBA", CS_SRGB, 4, true, Unpack::SRGBA_RGBA},
            {"RGBA", CS_SYCC, 4, true, Unpack::SYCCA_RGBA},
            {"CMYK", CS_CMYK, 4, true, Unpack::SRGBA_RGBA},
        };
        const Entry* entry = nullptr;
        for (const auto& e : table)
            if (cs == e.cs && d.numcomps == e.ncomp && (e.sub || subsampling == -1) &&
                strcmp(mode, e.mode) == 0) {
                entry = &e;
                break;
            }
        if (!entry)
            FAIL("no unpacker for mode %s, colour space %d, %u components, subsampling %d", mode,
                 cs, d.numcomps, subsampling);

        Unpack u{out8, out16, (uint32_t)xsize, (uint32_t)ysize, ycc, {}};
        size_t width_sum = 0;
        for (uint32_t c = 0; c < d.numcomps; ++c) {
            uint32_t csz = (d.comps[c].prec + 7) >> 3;
            width_sum += csz == 3 ? 4 : csz;
        }
        while (d.read_tile_header()) {
            uint32_t tx0 = d.ttx0, ty0 = d.tty0, tx1 = d.ttx1, ty1 = d.tty1;
            if (tx0 >= tx1 || ty0 >= ty1 || tx0 < d.x0 || ty0 < d.y0 ||
                (int64_t)(tx1 - d.x0) > xsize || (int64_t)(ty1 - d.y0) > ysize)
                FAIL("tile %u lies outside the image", d.current_tile);
            uint32_t tileno = d.current_tile;
            d.decode_tile(tileno);
            u.build_tile(d, (size_t)(tx1 - tx0) * (ty1 - ty0) * width_sum);
            u.unpack(d, entry->kind, tx0, ty0, tx1, ty1);
        }
        return AKR_OK;
    } catch (const Failure& f) {
        snprintf(err, (size_t)errlen, "%s", f.msg.c_str());
        return AKR_BROKEN;
    } catch (const std::bad_alloc&) {
        snprintf(err, (size_t)errlen, "out of memory");
        return AKR_BROKEN;
    }
}
