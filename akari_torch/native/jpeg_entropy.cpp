// Huffman entropy decoding of one JPEG scan, baseline / extended sequential
// and progressive (ITU-T T.81 Annexes F and G), for akari_torch/core/jpeg.py.
//
// The decoder follows the behaviour of libjpeg-turbo's jdhuff.c and
// jdphuff.c, which PIL uses: the same bit reader (0xFF00 stuffing, padding
// 0xFF bytes before a marker, zero bits supplied once a marker is reached,
// after which the rest of the restart interval is left undecoded), the same
// EOB-run and successive-approximation rules, and coefficients written in
// natural order into int16 planes of [rows, row_blocks, 64] blocks.
// Dequantisation, the IDCT, upsampling and colour conversion stay in numpy
// (akari_torch/core/jpeg.py).
//
// C ABI (ctypes):
//   int akr_jpeg_scan(const uint8_t* data, int64_t size, int64_t start,
//                     int32_t n_comp, int16_t* const* planes,
//                     const int32_t* geom, const uint8_t* huff,
//                     int32_t mcus_x, int32_t mcus_y,
//                     int32_t ss, int32_t se, int32_t ah, int32_t al,
//                     int32_t progressive, int32_t restart_interval,
//                     int64_t* end_pos);
//   geom: 5 int32 per scan component: h, v (its blocks across and down an
//     MCU of an interleaved scan), row_blocks (its plane's width in
//     blocks), blocks_x, blocks_y (its own extent in blocks, the MCU grid
//     of a one-component scan).
//   huff: per scan component a DC then an AC table, each 16 code-length
//     counts then 256 symbol bytes (T.81 B.2.4.2).
//   start: the first byte of entropy-coded data; *end_pos receives the
//     first byte the scan did not consume (a marker, or padding before it).
// Returns 0, or one of the AKR_JPEG_* codes below.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>

namespace {

enum {
    AKR_JPEG_OK = 0,
    AKR_JPEG_TRUNCATED = 1,   // the file ends inside entropy-coded data
    AKR_JPEG_BAD_CODE = 2,    // a bit pattern that no Huffman code matches
    AKR_JPEG_BAD_RESTART = 3, // a restart marker missing or out of sequence
    AKR_JPEG_BAD_TABLE = 4,   // a Huffman table that is not a prefix code
};

// Zig-zag index -> natural index, with 16 extra entries so that a corrupt
// run past coefficient 63 writes coefficient 63 (as libjpeg's table does).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;  // bits resolved by one table lookup

struct Huff {
    int32_t maxcode[18];    // largest code of each length, -1 if none
    int32_t valoffset[17];  // symbol index of a code of each length, minus the code
    uint8_t vals[256];
    uint16_t look[1 << kLook];  // (length << 8) | symbol; length 0: longer code
};

// T.81 C.2 / F.2.2.3 decoding tables; false if the counts do not form a
// prefix code with no all-ones code (libjpeg's JERR_BAD_HUFF_TABLE), or a
// DC symbol exceeds 15. The counts of each length are checked before its
// codes are written, so the lookahead table is never indexed past its end.
bool build_huff(const uint8_t* spec, bool is_dc, Huff& h) {
    const uint8_t* counts = spec;
    std::memcpy(h.vals, spec + 16, 256);
    int n = 0;
    for (int l = 0; l < 16; ++l) n += counts[l];
    if (n > 256) return false;
    if (is_dc)
        for (int i = 0; i < n; ++i)
            if (h.vals[i] > 15) return false;
    std::memset(h.look, 0, sizeof(h.look));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        int c = counts[l - 1];
        // the codes of length l must fit in l bits, and, as in libjpeg's
        // jpeg_make_d_derived_tbl, not reach the all-ones code
        if (code + c >= (1 << l)) return false;
        if (c) {
            h.valoffset[l] = k - code;
            for (int i = 0; i < c; ++i, ++k, ++code) {
                if (l <= kLook) {
                    int shift = kLook - l;
                    for (int j = 0; j < (1 << shift); ++j)
                        h.look[(code << shift) | j] = uint16_t((l << 8) | h.vals[k]);
                }
            }
            h.maxcode[l] = code - 1;
        } else {
            h.maxcode[l] = -1;
            h.valoffset[l] = 0;
        }
        code <<= 1;
    }
    h.maxcode[17] = 0x7FFFFFFF;
    return true;
}

struct Reader {
    const uint8_t* d;
    int64_t size, pos;
    uint64_t buf = 0;       // bits, most significant first, in the low `bits`
    int bits = 0;           // real bits held
    bool marker = false;    // a marker ends the segment; pos is its code byte
    bool insufficient = false;  // bits past the marker were needed
    bool eof = false;

    // Read bytes until at least 57 bits are held, a marker is reached or
    // the file ends.
    void fill() {
        while (bits <= 56 && !marker) {
            if (pos >= size) {
                eof = true;
                return;
            }
            uint32_t c = d[pos];
            if (c == 0xFF) {
                int64_t p = pos + 1;
                while (p < size && d[p] == 0xFF) ++p;  // padding before a marker
                if (p >= size) {
                    eof = true;
                    return;
                }
                if (d[p] != 0) {
                    marker = true;
                    pos = p;
                    return;
                }
                pos = p + 1;  // FF 00: a data byte 0xFF
            } else {
                ++pos;
            }
            buf = (buf << 8) | c;
            bits += 8;
        }
    }

    // The next n (<= 16) bits without consuming them; zeros past a marker.
    // Returns false when the file ends first.
    bool peek(int n, uint32_t& v) {
        if (bits < n) {
            fill();
            if (bits < n && eof) return false;
        }
        if (bits >= n)
            v = uint32_t(buf >> (bits - n)) & ((1u << n) - 1);
        else
            v = uint32_t(buf << (n - bits)) & ((1u << n) - 1);
        return true;
    }

    void skip(int n) {
        if (n > bits) {
            insufficient = true;  // libjpeg's JWRN_HIT_MARKER: zeros were used
            bits = 0;
        } else {
            bits -= n;
        }
    }

    bool get(int n, int32_t& v) {  // 1 <= n <= 16
        uint32_t u;
        if (!peek(n, u)) return false;
        skip(n);
        v = int32_t(u);
        return true;
    }

    // Huffman symbol; -1 at the end of the file, -2 for a bad code.
    int decode(const Huff& h) {
        uint32_t v;
        if (!peek(kLook, v)) {
            // near the end of the file: try the codes bit by bit
            if (!peek(1, v)) return -1;
        } else {
            uint16_t e = h.look[v];
            if (e) {
                skip(e >> 8);
                return e & 0xFF;
            }
        }
        int32_t code = 0;
        for (int l = 1; l <= 16; ++l) {
            int32_t b;
            if (!get(1, b)) return -1;
            code = (code << 1) | b;
            if (code <= h.maxcode[l]) return h.vals[(code + h.valoffset[l]) & 0xFF];
        }
        return -2;
    }

    // Find the next marker from pos, as libjpeg's next_marker does
    // (skipping stray bytes and FF 00 pairs); false at the end of the file.
    bool next_marker() {
        for (;;) {
            while (pos < size && d[pos] != 0xFF) ++pos;
            while (pos < size && d[pos] == 0xFF) ++pos;
            if (pos >= size) return false;
            if (d[pos] != 0) return true;
            ++pos;
        }
    }
};

inline int32_t extend(int32_t r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

}  // namespace

extern "C" int akr_jpeg_scan(const uint8_t* data, int64_t size, int64_t start,
                             int32_t n_comp, int16_t* const* planes,
                             const int32_t* geom, const uint8_t* huff,
                             int32_t mcus_x, int32_t mcus_y, int32_t ss,
                             int32_t se, int32_t ah, int32_t al,
                             int32_t progressive, int32_t restart_interval,
                             int64_t* end_pos) {
    Huff dc[4], ac[4];
    for (int c = 0; c < n_comp; ++c) {
        if (!build_huff(huff + c * 544, true, dc[c]) ||
            !build_huff(huff + c * 544 + 272, false, ac[c]))
            return AKR_JPEG_BAD_TABLE;
    }
    Reader rd{data, size, start};
    const bool interleaved = n_comp > 1;
    const int64_t n_mcus = interleaved
        ? int64_t(mcus_x) * mcus_y
        : int64_t(geom[3]) * geom[4];
    int32_t last_dc[4] = {0, 0, 0, 0};
    uint32_t eobrun = 0;
    int restart_num = 0;
    const int32_t p1 = 1 << al;     // 1 in the bit position being coded
    const int32_t m1 = -1 * p1;     // -1 in that position
    int rc = AKR_JPEG_OK;

    // one block of component c; false stops the scan with rc set
    auto block = [&](int c, int16_t* blk) -> bool {
        int s;
        int32_t r;
        if (!progressive) {
            if ((s = rd.decode(dc[c])) < 0) goto fail;
            if (s) {
                if (!rd.get(s, r)) goto fail;
                s = extend(r, s);
            }
            last_dc[c] = int32_t(uint32_t(s) + uint32_t(last_dc[c]));
            blk[0] = int16_t(last_dc[c]);
            for (int k = 1; k < 64; ++k) {
                if ((s = rd.decode(ac[c])) < 0) goto fail;
                int run = s >> 4;
                s &= 15;
                if (s) {
                    k += run;
                    if (!rd.get(s, r)) goto fail;
                    blk[kNatural[k]] = int16_t(extend(r, s));
                } else {
                    if (run != 15) break;
                    k += 15;
                }
            }
            return true;
        }
        if (ss == 0) {  // DC scans, interleaved or not
            if (ah == 0) {
                if ((s = rd.decode(dc[c])) < 0) goto fail;
                if (s) {
                    if (!rd.get(s, r)) goto fail;
                    s = extend(r, s);
                }
                last_dc[c] = int32_t(uint32_t(s) + uint32_t(last_dc[c]));
                blk[0] = int16_t(uint32_t(last_dc[c]) << al);
            } else {
                if (!rd.get(1, r)) goto fail;
                if (r) blk[0] = int16_t(blk[0] | p1);
            }
            return true;
        }
        if (ah == 0) {  // AC first pass
            if (eobrun > 0) {
                --eobrun;
                return true;
            }
            for (int k = ss; k <= se; ++k) {
                if ((s = rd.decode(ac[c])) < 0) goto fail;
                int run = s >> 4;
                s &= 15;
                if (s) {
                    k += run;
                    if (!rd.get(s, r)) goto fail;
                    blk[kNatural[k]] = int16_t(uint32_t(extend(r, s)) << al);
                } else if (run == 15) {
                    k += 15;
                } else {
                    eobrun = 1u << run;
                    if (run) {
                        if (!rd.get(run, r)) goto fail;
                        eobrun += r;
                    }
                    --eobrun;
                    break;
                }
            }
            return true;
        }
        {  // AC refinement (G.1.2.3), as jdphuff.c decode_mcu_AC_refine
            int k = ss;
            if (eobrun == 0) {
                for (; k <= se; ++k) {
                    if ((s = rd.decode(ac[c])) < 0) goto fail;
                    int run = s >> 4;
                    s &= 15;
                    int32_t val = 0;
                    if (s) {
                        if (!rd.get(1, r)) goto fail;
                        val = r ? p1 : m1;
                    } else if (run != 15) {
                        eobrun = 1u << run;
                        if (run) {
                            if (!rd.get(run, r)) goto fail;
                            eobrun += r;
                        }
                        break;
                    }
                    do {
                        int16_t* co = blk + kNatural[k];
                        if (*co != 0) {
                            if (!rd.get(1, r)) goto fail;
                            if (r && (*co & p1) == 0)
                                *co = int16_t(*co >= 0 ? *co + p1 : *co + m1);
                        } else if (--run < 0) {
                            break;
                        }
                        ++k;
                    } while (k <= se);
                    if (val) blk[kNatural[k]] = int16_t(val);
                }
            }
            if (eobrun > 0) {
                for (; k <= se; ++k) {
                    int16_t* co = blk + kNatural[k];
                    if (*co != 0) {
                        if (!rd.get(1, r)) goto fail;
                        if (r && (*co & p1) == 0)
                            *co = int16_t(*co >= 0 ? *co + p1 : *co + m1);
                    }
                }
                --eobrun;
            }
            return true;
        }
    fail:
        rc = rd.eof ? AKR_JPEG_TRUNCATED : AKR_JPEG_BAD_CODE;
        return false;
    };

    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart_interval && m > 0 && m % restart_interval == 0) {
            // drop the bits left, then the RSTn marker must follow
            rd.bits = 0;
            rd.buf = 0;
            if (!rd.marker) {
                if (!rd.next_marker()) {
                    rc = AKR_JPEG_TRUNCATED;
                    break;
                }
            }
            if (rd.d[rd.pos] != 0xD0 + restart_num) {
                rc = AKR_JPEG_BAD_RESTART;
                break;
            }
            ++rd.pos;
            rd.marker = false;
            rd.insufficient = false;
            restart_num = (restart_num + 1) & 7;
            for (int c = 0; c < 4; ++c) last_dc[c] = 0;
            eobrun = 0;
        }
        if (rd.insufficient) continue;  // out of data until the next restart
        if (interleaved) {
            int64_t my = m / mcus_x, mx = m % mcus_x;
            for (int c = 0; c < n_comp; ++c) {
                const int32_t* g = geom + 5 * c;
                for (int v = 0; v < g[1]; ++v)
                    for (int u = 0; u < g[0]; ++u) {
                        int64_t by = my * g[1] + v, bx = mx * g[0] + u;
                        if (!block(c, planes[c] + (by * g[2] + bx) * 64)) goto done;
                    }
            }
        } else {
            int64_t by = m / geom[3], bx = m % geom[3];
            if (!block(0, planes[0] + (by * geom[2] + bx) * 64)) goto done;
        }
    }
done:
    // the first byte not consumed: the FF before a marker already reached
    *end_pos = rd.marker ? rd.pos - 1 : rd.pos;
    return rc;
}
