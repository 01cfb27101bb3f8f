// The CCITT decoders of TIFF compressions 2 (CCITT RLE), 32771 (RLEW),
// 3 (Group 3: MH, or MR with T4Options bit 0) and 4 (Group 4: MMR), for
// akari_torch/core/tiff.py.
//
// The JAX package reads textures through PIL, which hands these
// compressions to libtiff 4.7.1 (tif_fax3.c, tif_fax3.h). This follows
// libtiff's decoder step for step, so that a strip decodes, or fails, as it
// does there:
//
// - the code tables of ITU-T T.4 / T.6, looked up as libtiff's generated
//   tables are: 7 bits for the 2-D mode codes (seven zeros an EOL), 12 for
//   white runs and 13 for black (eleven zeros an EOL); a pattern no code
//   starts is a bad code word, which ends the row;
// - bits read least significant first through a bit-reversal table (the
//   caller reverses fill order 2 first); at the end of the data a code is
//   padded with zeros while bits are left, and the end is reached when none
//   are;
// - a row's runs cleaned up to the width as libtiff's CLEANUP_RUNS does
//   (too long: runs dropped from the end; too short: the rest in the
//   colour that comes next), and filled into the row bit by bit (white
//   clears, black sets), the row's spare bits left as they were;
// - Group 3 rows found by their EOLs; when the data ends while skipping
//   the fill bits of an EOL, libtiff takes the data for Group 3 without
//   EOLs ("Try to decode (read) fax Group 3 data without EOL") and decodes
//   it again from the strip's first bit, from the row it had reached on,
//   for the rest of the image;
// - RLE rows byte-aligned, RLEW rows aligned to 16 bits in memory (libtiff
//   reads the strip where the file is mapped, so it is the byte's file
//   offset that counts);
// - the ends: Group 3 and RLE fail (-1) where the data ends inside a row;
//   Group 4 decodes until an EOL or the end of the data, and succeeds if
//   it decoded a row before that, leaving the rows after it unwritten;
//   run arrays that would overflow fail.
//
// C ABI (ctypes):
//   int akr_fax_strip(const uint8_t* src, int64_t size, int64_t offset,
//                     int32_t kind, int32_t width, int32_t rows,
//                     int32_t rowbytes, int32_t* state, uint32_t* runs,
//                     uint8_t* out);
//     kind: 0 RLE, 1 RLEW, 2 Group 3 1-D, 3 Group 3 2-D, 4 Group 4;
//     offset: the strip's file offset (RLEW alignment); state[0]: libtiff's
//     no-EOL flag, kept from strip to strip of one image (in and out);
//     state[1] (out): the rows written (fewer than ``rows`` only where a
//     Group 4 strip ends early and succeeds); runs: libtiff's two run arrays,
//     2 * fax_runs(width, kind) zeros before an image's first strip and
//     kept from strip to strip (libtiff resets only the reference row's
//     first two runs at a strip's start, and a corrupt row can read the
//     runs a row of an earlier strip left); out: rows x rowbytes bytes, which
//     libtiff fills into (the caller's buffer keeps what it held).
//     Returns 1, or a negative code: -1 the data ends (Group 3, RLE) or no
//     row decoded (Group 4), -2 a run array overflows, -3 a Group 4 row
//     wider than the room left.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>
#include <utility>

namespace {

enum State : uint8_t {
    S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
    S_MakeUp, S_EOL
};

struct Ent {
    uint8_t state = S_Null, width = 0;
    int32_t param = 0;
};

const char* kWhiteTerm[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* kWhiteMakeUp[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000", "010011011"};
const char* kBlackTerm[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* kBlackMakeUp[] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* kExtMakeUp[] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states.c's FillTable: the code (read least significant bit first)
// and every pattern of the table's width that starts with it
void fill(Ent* t, int size, const char* code, int state, int param) {
    int width = int(strlen(code)), rev = 0;
    for (int i = 0; i < width; i++) rev |= (code[i] == '1') << i;
    for (int c = rev; c < (1 << size); c += 1 << width)
        t[c] = Ent{uint8_t(state), uint8_t(width), param};
}

struct Tables {
    Ent main[128], white[4096], black[8192];
    uint8_t rev[256];
    Tables() {
        fill(main, 7, "0001", S_Pass, 0);
        fill(main, 7, "001", S_Horiz, 0);
        fill(main, 7, "1", S_V0, 0);
        fill(main, 7, "011", S_VR, 1);
        fill(main, 7, "000011", S_VR, 2);
        fill(main, 7, "0000011", S_VR, 3);
        fill(main, 7, "010", S_VL, 1);
        fill(main, 7, "000010", S_VL, 2);
        fill(main, 7, "0000010", S_VL, 3);
        fill(main, 7, "0000001", S_Ext, 0);
        fill(main, 7, "0000000", S_EOL, 0);
        for (int i = 0; i < 27; i++) fill(white, 12, kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
        for (int i = 0; i < 13; i++) fill(white, 12, kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
        for (int i = 0; i < 64; i++) fill(white, 12, kWhiteTerm[i], S_TermW, i);
        fill(white, 12, "00000000000", S_EOL, 0);
        for (int i = 0; i < 27; i++) fill(black, 13, kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
        for (int i = 0; i < 13; i++) fill(black, 13, kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
        for (int i = 0; i < 64; i++) fill(black, 13, kBlackTerm[i], S_TermB, i);
        fill(black, 13, "00000000000", S_EOL, 0);
        for (int i = 0; i < 256; i++) {
            int r = 0;
            for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
            rev[i] = uint8_t(r);
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; runs that
// pass the row's end are cut in the array itself
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
    static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int k = 0; k < 2; k++) {
            uint32_t run = runs[k];
            if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
            if (!run) continue;
            uint8_t* cp = buf + (x >> 3);
            uint32_t bx = x & 7;
            if (run > 8 - bx) {
                if (bx) {
                    if (k) *cp++ |= uint8_t(0xff >> bx);
                    else *cp++ &= uint8_t(0xff << (8 - bx));
                    run -= 8 - bx;
                }
                uint32_t n = run >> 3;
                if (n) {
                    memset(cp, k ? 0xff : 0x00, n);
                    cp += n;
                    run &= 7;
                }
                if (run) {
                    if (k) cp[0] = uint8_t((cp[0] | (0xff00 >> run)) & 0xff);
                    else cp[0] &= uint8_t(0xff >> run);
                }
            } else {
                if (k) cp[0] |= uint8_t(masks[run] >> bx);
                else cp[0] &= uint8_t(~(masks[run] >> bx));
            }
            x += runs[k];
        }
    }
}

enum Kind { RLE = 0, RLEW = 1, G3_1D = 2, G3_2D = 3, G4 = 4 };

struct Decoder {
    const Tables& T = tables();
    const uint8_t *start, *cp, *ep;
    int64_t offset;
    uint32_t acc = 0;
    int avail = 0;
    int eolcnt = 0;
    int noeol;
    int lastx;
    uint32_t nruns;
    uint32_t *cur, *ref;
    // row state
    int a0 = 0, run_length = 0, b1 = 0;
    uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
    const Ent* ent = nullptr;

    // NeedBits8 / NeedBits16: false at the end of the data with no bits left
    bool need8(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) return false;
                avail = n;
            } else {
                acc |= uint32_t(T.rev[*cp++]) << avail;
                avail += 8;
            }
        }
        return true;
    }
    bool need16(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) return false;
                avail = n;
            } else {
                acc |= uint32_t(T.rev[*cp++]) << avail;
                if ((avail += 8) < n) {
                    if (cp >= ep) {
                        avail = n;
                    } else {
                        acc |= uint32_t(T.rev[*cp++]) << avail;
                        avail += 8;
                    }
                }
            }
        }
        return true;
    }
    uint32_t bits(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc >>= n;
    }
    bool lookup(const Ent* tab, int wid, bool wide) {
        if (!(wide ? need16(wid) : need8(wid))) return false;
        ent = tab + bits(wid);
        clr(ent->width);
        return true;
    }
};

}  // namespace

// Fax3SetupState: the runs a row can hold (twice as many for 2-D codes)
extern "C" int64_t akr_fax_runs(int32_t width, int32_t kind) {
    int64_t n = (int64_t(width) + 1 + 31) / 32 * 32;
    return kind == G3_2D || kind == G4 ? 2 * n : n;
}

extern "C" int akr_fax_strip(const uint8_t* src, int64_t size, int64_t offset, int32_t kind,
                             int32_t width, int32_t rows, int32_t rowbytes, int32_t* state,
                             uint32_t* runs, uint8_t* out) {
    Decoder d;
    d.start = d.cp = src;
    d.ep = src + size;
    d.offset = offset;
    d.noeol = state[0];
    d.lastx = width;
    const bool two_d = kind == G3_2D || kind == G4;
    d.nruns = uint32_t(akr_fax_runs(width, kind));
    d.cur = runs;
    d.ref = two_d ? runs + d.nruns : nullptr;
    if (d.ref) {
        d.ref[0] = uint32_t(width);
        d.ref[1] = 0;
    }
    const int lastx = width;
    int line = 0;
    state[1] = 0;
    uint8_t* buf = out;
    int64_t occ = int64_t(rows) * rowbytes;

    // the macros of tif_fax3.h as lambdas; each returns false where the
    // macro would jump to an error label (the caller knows which)
    int error = 0;  // set where libtiff returns -1 from inside a macro
    auto setvalue = [&](int x) -> bool {
        if (d.pa >= d.thisrun + d.nruns) {
            error = -2;
            return false;
        }
        *d.pa++ = uint32_t(d.run_length + x);
        d.a0 += x;
        d.run_length = 0;
        return true;
    };
    auto cleanup_runs = [&]() -> bool {
        if (d.run_length && !setvalue(0)) return false;
        if (d.a0 != lastx) {
            while (d.a0 > lastx && d.pa > d.thisrun) d.a0 -= int(*--d.pa);
            if (d.a0 < lastx) {
                if (d.a0 < 0) d.a0 = 0;
                if (((d.pa - d.thisrun) & 1) && !setvalue(0)) return false;
                if (!setvalue(lastx - d.a0)) return false;
            } else if (d.a0 > lastx) {
                if (!setvalue(lastx) || !setvalue(0)) return false;
            }
        }
        return true;
    };
    // EXPAND1D: 0 done (runs cleaned), 1 end of data (runs cleaned), -1 error
    auto expand1d = [&]() -> int {
        for (;;) {
            for (;;) {
                if (!d.lookup(d.T.white, 12, true)) goto eof1d;
                switch (d.ent->state) {
                    case S_EOL: d.eolcnt = 1; goto done1d;
                    case S_TermW:
                        if (!setvalue(d.ent->param)) return -1;
                        goto done_white;
                    case S_MakeUpW: case S_MakeUp:
                        d.a0 += d.ent->param;
                        d.run_length += d.ent->param;
                        break;
                    default: goto done1d;  // unexpected("WhiteTable")
                }
            }
        done_white:
            if (d.a0 >= lastx) goto done1d;
            for (;;) {
                if (!d.lookup(d.T.black, 13, true)) goto eof1d;
                switch (d.ent->state) {
                    case S_EOL: d.eolcnt = 1; goto done1d;
                    case S_TermB:
                        if (!setvalue(d.ent->param)) return -1;
                        goto done_black;
                    case S_MakeUpB: case S_MakeUp:
                        d.a0 += d.ent->param;
                        d.run_length += d.ent->param;
                        break;
                    default: goto done1d;  // unexpected("BlackTable")
                }
            }
        done_black:
            if (d.a0 >= lastx) goto done1d;
            if (*(d.pa - 1) == 0 && *(d.pa - 2) == 0) d.pa -= 2;
        }
    eof1d:
        return cleanup_runs() ? 1 : -1;
    done1d:
        return cleanup_runs() ? 0 : -1;
    };
    auto check_b1 = [&]() -> bool {
        if (d.pa != d.thisrun)
            while (d.b1 <= d.a0 && d.b1 < lastx) {
                if (d.pb + 1 >= d.ref + d.nruns) {
                    error = -2;
                    return false;
                }
                d.b1 += int(d.pb[0] + d.pb[1]);
                d.pb += 2;
            }
        return true;
    };
    // EXPAND2D: as expand1d
    auto expand2d = [&]() -> int {
        while (d.a0 < lastx) {
            if (d.pa >= d.thisrun + d.nruns) {
                error = -2;
                return -1;
            }
            if (!d.lookup(d.T.main, 7, false)) goto eof2d;
            switch (d.ent->state) {
                case S_Pass:
                    if (!check_b1()) return -1;
                    if (d.pb + 1 >= d.ref + d.nruns) {
                        error = -2;
                        return -1;
                    }
                    d.b1 += int(*d.pb++);
                    d.run_length += d.b1 - d.a0;
                    d.a0 = d.b1;
                    d.b1 += int(*d.pb++);
                    break;
                case S_Horiz: {
                    bool black_first = (d.pa - d.thisrun) & 1;
                    for (int half = 0; half < 2; half++) {
                        bool black = black_first != (half == 1);
                        for (;;) {
                            if (!d.lookup(black ? d.T.black : d.T.white, black ? 13 : 12, true))
                                goto eof2d;
                            int st = d.ent->state;
                            if (st == (black ? S_TermB : S_TermW)) {
                                if (!setvalue(d.ent->param)) return -1;
                                break;
                            }
                            if (st == (black ? S_MakeUpB : S_MakeUpW) || st == S_MakeUp) {
                                d.a0 += d.ent->param;
                                d.run_length += d.ent->param;
                                continue;
                            }
                            goto eol2d;  // unexpected
                        }
                    }
                    if (!check_b1()) return -1;
                    break;
                }
                case S_V0:
                    if (!check_b1() || !setvalue(d.b1 - d.a0)) return -1;
                    if (d.pb >= d.ref + d.nruns) {
                        error = -2;
                        return -1;
                    }
                    d.b1 += int(*d.pb++);
                    break;
                case S_VR:
                    if (!check_b1() || !setvalue(d.b1 - d.a0 + d.ent->param)) return -1;
                    if (d.pb >= d.ref + d.nruns) {
                        error = -2;
                        return -1;
                    }
                    d.b1 += int(*d.pb++);
                    break;
                case S_VL:
                    if (!check_b1()) return -1;
                    if (d.b1 < d.a0 + d.ent->param) goto eol2d;  // unexpected("VL")
                    if (!setvalue(d.b1 - d.a0 - d.ent->param)) return -1;
                    d.b1 -= int(*--d.pb);
                    break;
                case S_Ext:
                    *d.pa++ = uint32_t(lastx - d.a0);
                    goto eol2d;
                case S_EOL:
                    *d.pa++ = uint32_t(lastx - d.a0);
                    if (!d.need8(4)) goto eof2d;
                    d.clr(4);
                    d.eolcnt = 1;
                    goto eol2d;
                default:
                    goto eol2d;  // unexpected("MainTable")
            }
        }
        if (d.run_length) {
            if (d.run_length + d.a0 < lastx) {
                if (!d.need8(1)) goto eof2d;
                if (!d.bits(1)) goto eol2d;  // badMain2d
                d.clr(1);
            }
            if (!setvalue(0)) return -1;
        }
    eol2d:
        return cleanup_runs() ? 0 : -1;
    eof2d:
        return cleanup_runs() ? 1 : -1;
    };
    // SYNC_EOL: 0 synced, 1 end of data, 2 no EOL found (retry without)
    auto sync_eol = [&]() -> int {
        if (d.noeol) return 0;
        if (d.eolcnt == 0) {
            for (;;) {
                if (!d.need16(11)) return 1;
                if (d.bits(11) == 0) break;
                d.clr(1);
            }
        }
        for (;;) {
            if (!d.need8(8)) return 2;
            if (d.bits(8)) break;
            d.clr(8);
        }
        while (d.bits(1) == 0) d.clr(1);
        d.clr(1);
        d.eolcnt = 0;
        return 0;
    };
    auto restart = [&]() {  // the strip again from its first bit, without EOLs
        d.noeol = 1;
        d.cp = d.start;
        d.acc = 0;
        d.avail = 0;
    };
    auto finish = [&](int rc) {
        state[0] = d.noeol;
        state[1] = line;
        return rc;
    };

    if (kind == RLE || kind == RLEW) {
        d.thisrun = d.cur;
        while (occ > 0) {
            d.a0 = 0;
            d.run_length = 0;
            d.pa = d.thisrun;
            int rc = expand1d();
            if (rc < 0) return finish(error);
            fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
            if (rc == 1) return finish(-1);
            if (kind == RLE) {
                d.clr(d.avail & 7);
            } else {
                d.clr(d.avail & 15);
                if (d.avail == 0 && ((d.offset + (d.cp - d.start)) & 1)) d.cp++;
            }
            buf += rowbytes;
            occ -= rowbytes;
            line++;
        }
        return finish(1);
    }
    if (kind == G3_1D) {
        d.thisrun = d.cur;
        while (occ > 0) {
            d.a0 = 0;
            d.run_length = 0;
            d.pa = d.thisrun;
            int s = sync_eol();
            if (s == 2) {
                restart();
                continue;
            }
            if (s == 1) {
                if (!cleanup_runs()) return finish(error);
                fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
                return finish(-1);
            }
            int rc = expand1d();
            if (rc < 0) return finish(error);
            fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
            if (rc == 1) return finish(-1);
            buf += rowbytes;
            occ -= rowbytes;
            line++;
        }
        return finish(1);
    }
    if (kind == G3_2D) {
        while (occ > 0) {
            d.a0 = 0;
            d.run_length = 0;
            d.pa = d.thisrun = d.cur;
            int s = sync_eol();
            if (s == 2) {
                restart();
                continue;
            }
            int rc;
            if (s == 1 || !d.need8(1)) {
                if (!cleanup_runs()) return finish(error);
                rc = 1;
            } else {
                bool is1d = d.bits(1);
                d.clr(1);
                d.pb = d.ref;
                d.b1 = int(*d.pb++);
                rc = is1d ? expand1d() : expand2d();
                if (rc < 0) return finish(error);
            }
            fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
            if (rc == 1) return finish(-1);
            if (d.pa < d.thisrun + d.nruns && !setvalue(0)) return finish(error);
            std::swap(d.cur, d.ref);
            buf += rowbytes;
            occ -= rowbytes;
            line++;
        }
        return finish(1);
    }
    // Group 4
    const int first = line;
    while (occ > 0) {
        d.a0 = 0;
        d.run_length = 0;
        d.pa = d.thisrun = d.cur;
        d.pb = d.ref;
        d.b1 = int(*d.pb++);
        int rc = expand2d();
        if (rc < 0) return finish(error);
        if (rc == 1 || d.eolcnt) {
            // EOFG4: skip the EOFB's 13 bits as far as they are there
            d.need16(13);
            d.clr(13);
            if ((lastx + 7) >> 3 > occ) return finish(-3);
            fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
            const int rc_eof = line != first ? 1 : -1;
            line++;  // the row the codes ended in is written too
            return finish(rc_eof);
        }
        if ((lastx + 7) >> 3 > occ) return finish(-3);
        fill_runs(buf, d.thisrun, d.pa, uint32_t(lastx));
        if (!setvalue(0)) return finish(error);
        std::swap(d.cur, d.ref);
        buf += rowbytes;
        occ -= rowbytes;
        line++;
    }
    return finish(1);
}
