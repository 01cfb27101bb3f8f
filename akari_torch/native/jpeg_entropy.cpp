// Huffman entropy decoding of one JPEG scan, baseline / extended sequential
// and progressive (ITU-T T.81 Annexes F and G) and lossless (Annex H), for
// akari_torch/core/jpeg.py.
//
// The decoder follows the behaviour of libjpeg-turbo's jdhuff.c, jdphuff.c,
// jdlhuff.c and jddiffct.c, which PIL uses, over corrupt data as well:
// - the bit reader: 0xFF00 stuffing, padding 0xFF bytes before a marker,
//   zero bits supplied once a marker is reached; the MCU in which the data
//   ran out is decoded from those zeros, the rest of its restart interval
//   is left as it was (zero coefficients, or what earlier scans left; a
//   lossless row reads as zero differences from a reset predictor);
// - a bit pattern that no code matches: 17 bits consumed, symbol 0
//   (jpeg_huff_decode's JWRN_HUFF_BAD_CODE);
// - restart markers read as read_restart_marker and jpeg_resync_to_restart
//   (jdmarker.c) read them, a wrong one skipped or left unread; with
//   ``strict_restart`` any marker but the expected RSTn fails the scan, as
//   libtiff's old-style JPEG source manager's resync_to_restart does;
// - the same EOB-run and successive-approximation rules, and coefficients
//   written in natural order into int16 planes of [rows, row_blocks, 64].
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
//                     int64_t* end_pos, int32_t* last_good,
//                     int32_t strict_restart);
//   geom: 6 int32 per scan component: h, v (its blocks across and down an
//     MCU of an interleaved scan), row_blocks (its plane's width in
//     blocks), blocks_x, blocks_y (its own extent in blocks, the MCU grid
//     of a one-component scan), v_samp (its vertical sampling factor).
//   huff: per scan component a DC then an AC table, each 16 code-length
//     counts then 256 symbol bytes (T.81 B.2.4.2).
//   start: the first byte of entropy-coded data; *end_pos receives the
//     first byte the scan did not consume (a marker, or padding before it).
//   *last_good: libjpeg's last_good_iMCU_row, the MCU row (of the frame's
//     MCU rows) of the last MCU begun with data left, kept across scans.
//   int akr_jpeg_lossless(const uint8_t* data, int64_t size, int64_t start,
//                         int32_t n_comp, uint8_t* const* planes,
//                         const int32_t* geom, const uint8_t* huff,
//                         int32_t mcus_x, int32_t mcus_y, int32_t psv,
//                         int32_t pt, int32_t restart_interval,
//                         int64_t* end_pos);
//   geom: 6 int32 per scan component, as above, a block being one sample;
//     planes: uint8 [blocks_y, blocks_x] samples; huff: one DC table per
//     component.
// Returns 0, or one of the AKR_JPEG_* codes below.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
    AKR_JPEG_OK = 0,
    AKR_JPEG_TRUNCATED = 1,   // the file ends inside entropy-coded data
    AKR_JPEG_BAD_TABLE = 4,   // a Huffman table that is not a prefix code
    AKR_JPEG_BAD_RESTART = 5, // strict_restart: another marker where an RSTn is due
};

// Zig-zag index -> natural index, with 16 extra entries so that a corrupt
// run past coefficient 63 writes coefficient 63 (as libjpeg's table does).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 8;  // bits resolved by one table lookup (HUFF_LOOKAHEAD)

struct Huff {
    int32_t maxcode[18];    // largest code of each length, -1 if none
    int32_t valoffset[17];  // symbol index of a code of each length, minus the code
    uint8_t vals[256];
    uint16_t look[1 << kLook];  // (length << 8) | symbol; length 0: longer code
};

// T.81 C.2 / F.2.2.3 decoding tables; false if the counts do not form a
// prefix code with no all-ones code (libjpeg's JERR_BAD_HUFF_TABLE), or a
// symbol exceeds max_symbol (15 for a lossy DC table, 16 for a lossless
// one, 255 for AC). The counts of each length are checked before its codes
// are written, so the lookahead table is never indexed past its end.
bool build_huff(const uint8_t* spec, int max_symbol, Huff& h) {
    const uint8_t* counts = spec;
    std::memcpy(h.vals, spec + 16, 256);
    int n = 0;
    for (int l = 0; l < 16; ++l) n += counts[l];
    if (n > 256) return false;
    for (int i = 0; i < n; ++i)
        if (h.vals[i] > max_symbol) return false;
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
    // False when the reader had to fill and met the end of the file first,
    // where libjpeg's suspending source, and so Pillow, gives up (whether
    // or not n bits were held): the file is truncated.
    bool peek(int n, uint32_t& v) {
        if (bits < n) {
            fill();
            if (eof) return false;
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

    // Huffman symbol, as libjpeg's HUFF_DECODE: an 8-bit lookahead, then
    // bit by bit; -1 when the file ends. A bit pattern no code matches
    // takes 17 bits and reads as symbol 0 (JWRN_HUFF_BAD_CODE).
    int decode(const Huff& h) {
        if (bits < kLook) {
            fill();
            if (eof) return -1;
        }
        if (bits >= kLook) {
            uint16_t e = h.look[uint32_t(buf >> (bits - kLook)) & ((1u << kLook) - 1)];
            if (e) {
                bits -= e >> 8;
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
        int32_t b;
        if (!get(1, b)) return -1;  // the sentinel length 17
        return 0;
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

    // libjpeg's process_restart / read_restart_marker with Pillow's
    // resynchronisation, jpeg_resync_to_restart: the bits left are
    // dropped; the expected RSTn (or a restart too far off) is consumed; a
    // marker below SOF0 or one of the two restarts before it is skipped to
    // the next marker, which is judged again; any other marker (the next
    // two restarts, a non-restart marker) is left unread, so the segment
    // reads as out of data. The out-of-data flag is cleared only when the
    // marker was consumed. False when the file ends first.
    bool restart(int& next_num, bool strict = false, bool* bad = nullptr) {
        bits = 0;
        buf = 0;
        if (!marker) {
            if (!next_marker()) return false;
            marker = true;
        }
        const int want = next_num;
        if (strict && d[pos] != 0xD0 + want) {
            *bad = true;
            return false;
        }
        for (;;) {
            const int m = d[pos];
            int action;
            if (m < 0xC0)
                action = 2;
            else if (m < 0xD0 || m > 0xD7)
                action = 3;
            else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7))
                action = 3;
            else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7))
                action = 2;
            else
                action = 1;
            if (action == 1) {
                ++pos;
                marker = false;
                break;
            }
            if (action == 3) break;
            ++pos;
            if (!next_marker()) return false;
        }
        next_num = (next_num + 1) & 7;
        if (!marker) insufficient = false;
        return true;
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
                             int64_t* end_pos, int32_t* last_good,
                             int32_t strict_restart) {
    Huff dc[4], ac[4];
    for (int c = 0; c < n_comp; ++c) {
        if (!build_huff(huff + c * 544, 15, dc[c]) ||
            !build_huff(huff + c * 544 + 272, 255, ac[c]))
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
        rc = AKR_JPEG_TRUNCATED;  // decode and get fail only at the end of the file
        return false;
    };

    // an MCU row of a one-component scan spans v_samp block rows
    const int64_t rows_per_imcu = interleaved ? 1 : geom[5];
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart_interval && m > 0 && m % restart_interval == 0) {
            bool bad = false;
            if (!rd.restart(restart_num, strict_restart != 0, &bad)) {
                rc = bad ? AKR_JPEG_BAD_RESTART : AKR_JPEG_TRUNCATED;
                break;
            }
            for (int c = 0; c < 4; ++c) last_dc[c] = 0;
            eobrun = 0;
        }
        if (rd.insufficient) continue;  // out of data until the next restart
        *last_good = int32_t(interleaved ? m / mcus_x : m / geom[3] / rows_per_imcu);
        if (interleaved) {
            int64_t my = m / mcus_x, mx = m % mcus_x;
            for (int c = 0; c < n_comp; ++c) {
                const int32_t* g = geom + 6 * c;
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

// Lossless (SOF3) scan: the Huffman-coded sample differences (H.1.2.2,
// category 16 meaning 32768 with no extra bits), undone row by row as
// jddiffct.c and jdlossls.c undo them. The first row of the scan, and of
// each restart interval, predicts its first sample from 2^(8 - Pt - 1) and
// the rest from the left (Ra); later rows take predictor psv, their first
// sample from above (Rb). A restart, or a row begun out of data (whose
// differences read as zero), puts every component back on the first-row
// rule for the next row it undoes, which is the first sample row of the
// iMCU row being read. Predictions are 16-bit (& 0xFFFF); the output is
// the low 8 bits of the sample shifted left by Pt.
extern "C" int akr_jpeg_lossless(const uint8_t* data, int64_t size, int64_t start,
                                 int32_t n_comp, uint8_t* const* planes,
                                 const int32_t* geom, const uint8_t* huff,
                                 int32_t mcus_x, int32_t mcus_y, int32_t psv,
                                 int32_t pt, int32_t restart_interval,
                                 int64_t* end_pos) {
    Huff tbl[4];
    for (int c = 0; c < n_comp; ++c)
        if (!build_huff(huff + c * 272, 16, tbl[c])) return AKR_JPEG_BAD_TABLE;
    Reader rd{data, size, start};
    const bool interleaved = n_comp > 1;
    // MCUs of a row: interleaved, the frame's MCU columns; else one sample each
    const int64_t per_row = interleaved ? mcus_x : geom[3];
    const int32_t n_imcu = mcus_y;
    const int32_t initial = 1 << (8 - pt - 1);
    std::vector<std::vector<int32_t>> diff(n_comp), undiff(n_comp);
    int32_t row_len[4], vs[4];
    bool first_row[4];
    for (int c = 0; c < n_comp; ++c) {
        const int32_t* g = geom + 6 * c;
        vs[c] = g[5];
        row_len[c] = interleaved ? int32_t(mcus_x * g[0]) : g[3];
        diff[c].assign(size_t(vs[c]) * row_len[c], 0);
        undiff[c].assign(size_t(vs[c]) * g[3], 0);
        first_row[c] = true;
    }
    int restart_num = 0;
    int64_t rows_to_go = restart_interval ? restart_interval / per_row : 0;
    int rc = AKR_JPEG_OK;
    for (int32_t r = 0; r < n_imcu && rc == AKR_JPEG_OK; ++r) {
        const bool last = r == n_imcu - 1;
        // MCU rows of this iMCU row
        int32_t mcu_rows = 1;
        if (!interleaved) {
            const int32_t h = geom[4], v = geom[5];
            mcu_rows = last ? (h % v ? h % v : v) : v;
        }
        for (int32_t y = 0; y < mcu_rows; ++y) {
            if (restart_interval) {
                if (rows_to_go == 0) {
                    if (!rd.restart(restart_num)) {
                        rc = AKR_JPEG_TRUNCATED;
                        break;
                    }
                    for (int c = 0; c < n_comp; ++c) first_row[c] = true;
                    rows_to_go = restart_interval / per_row;
                }
            }
            if (rd.insufficient) {  // zero differences, predictors reset
                for (int c = 0; c < n_comp; ++c) {
                    if (interleaved)
                        std::fill(diff[c].begin(), diff[c].end(), 0);
                    else
                        std::fill(diff[c].begin() + size_t(y) * row_len[c],
                                  diff[c].begin() + size_t(y + 1) * row_len[c], 0);
                    first_row[c] = true;
                }
            } else {
                for (int64_t mx = 0; mx < per_row && rc == AKR_JPEG_OK; ++mx) {
                    for (int c = 0; c < n_comp; ++c) {
                        const int32_t h = interleaved ? geom[6 * c] : 1;
                        const int32_t v = interleaved ? geom[6 * c + 1] : 1;
                        for (int32_t yy = 0; yy < v; ++yy)
                            for (int32_t xx = 0; xx < h; ++xx) {
                                int s = rd.decode(tbl[c]);
                                if (s < 0) {
                                    rc = AKR_JPEG_TRUNCATED;
                                    goto row_done;
                                }
                                int32_t val = 0;
                                if (s == 16) {
                                    val = 32768;
                                } else if (s) {
                                    int32_t bitsv;
                                    if (!rd.get(s, bitsv)) {
                                        rc = AKR_JPEG_TRUNCATED;
                                        goto row_done;
                                    }
                                    val = extend(bitsv, s);
                                }
                                const int32_t row = interleaved ? yy : y;
                                diff[c][size_t(row) * row_len[c] + mx * h + xx] = val;
                            }
                    }
                }
            }
        row_done:
            if (rc != AKR_JPEG_OK) break;
            if (restart_interval) --rows_to_go;
        }
        if (rc != AKR_JPEG_OK) break;
        // undo the differences of the component rows of this iMCU row
        for (int c = 0; c < n_comp; ++c) {
            const int32_t* g = geom + 6 * c;
            const int32_t w = g[3], v = g[5];
            const int32_t rows = last ? (g[4] % v ? g[4] % v : v) : v;
            for (int32_t row = 0, prev = v - 1; row < rows; prev = row, ++row) {
                const int32_t* dd = diff[c].data() + size_t(row) * row_len[c];
                const int32_t* up = undiff[c].data() + size_t(prev) * w;
                int32_t* out = undiff[c].data() + size_t(row) * w;
                if (first_row[c]) {
                    int32_t ra = (dd[0] + initial) & 0xFFFF;
                    out[0] = ra;
                    for (int32_t x = 1; x < w; ++x) out[x] = ra = (dd[x] + ra) & 0xFFFF;
                    first_row[c] = false;
                } else {
                    int32_t rb = up[0], rc_ = 0;
                    int32_t ra = (dd[0] + rb) & 0xFFFF;
                    out[0] = ra;
                    for (int32_t x = 1; x < w; ++x) {
                        rc_ = rb;
                        rb = up[x];
                        int64_t p;
                        switch (psv) {
                            case 1: p = ra; break;
                            case 2: p = rb; break;
                            case 3: p = rc_; break;
                            case 4: p = int64_t(ra) + rb - rc_; break;
                            case 5: p = ra + ((int64_t(rb) - rc_) >> 1); break;
                            case 6: p = rb + ((int64_t(ra) - rc_) >> 1); break;
                            default: p = (int64_t(ra) + rb) >> 1; break;
                        }
                        out[x] = ra = int32_t((dd[x] + p) & 0xFFFF);
                    }
                }
                uint8_t* dst = planes[c] + (int64_t(r) * v + row) * w;
                for (int32_t x = 0; x < w; ++x) dst[x] = uint8_t(out[x] << pt);
            }
        }
    }
    *end_pos = rd.marker ? rd.pos - 1 : rd.pos;
    return rc;
}
