// Arithmetic entropy decoding of one JPEG scan, sequential (SOF9) and
// progressive (SOF10), for akari_torch/core/jpeg.py: the QM decoder of
// ITU-T T.81 Annex D and the coefficient models of Annexes F.1.4.4 and
// G.1.3, as libjpeg-turbo's jdarith.c decodes them for PIL:
// - statistics: 64 DC bins per table, conditioned on the last difference
//   (L and U from the DAC segment, 0 and 1 by default), 256 AC bins per
//   table (K, 5 by default), reset at the start of each scan and at each
//   restart, with the DC predictions and contexts and the decoder itself;
// - the decoder reads zero bytes once it reaches a marker (T.81 D.2.6);
// - a magnitude past 15 bits or a run past the end of the band
//   (JWRN_ARITH_BAD_CODE) leaves the rest of the restart interval
//   undecoded, except that DC refinement scans go on;
// - restart markers read as read_restart_marker and Pillow's resync,
//   jpeg_resync_to_restart, read them (a wrong one skipped or left
//   unread: see jpeg_entropy.cpp).
// Coefficients are written in natural order into int16 planes of [rows,
// row_blocks, 64] blocks; the rest of the decode is the Huffman path's.
//
// C ABI (ctypes):
//   int akr_jpeg_arith_scan(const uint8_t* data, int64_t size, int64_t start,
//                           int32_t n_comp, int16_t* const* planes,
//                           const int32_t* geom, const uint8_t* tables,
//                           const uint8_t* cond,
//                           int32_t mcus_x, int32_t mcus_y,
//                           int32_t ss, int32_t se, int32_t ah, int32_t al,
//                           int32_t progressive, int32_t restart_interval,
//                           int64_t* end_pos);
//   geom: 6 int32 per scan component, as akr_jpeg_scan's.
//   tables: per scan component its DC then its AC table number (0-15).
//   cond: L[16], U[16] (per DC table), K[16] (per AC table).
// Returns 0, or 1 when the file ends inside the scan.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS, packed
// as jaricom.c packs them (Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS);
// entry 113 is the fixed 0.5 estimate of T.851 used for signs.
#define V(qe, nl, nm, sw) ((int32_t(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
const int32_t kQe[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

struct Arith {
    const uint8_t* d;
    int64_t size, pos;
    int64_t c = 0;     // C register: base of the interval and input bits
    int64_t a = 0;     // A register: the interval's size
    int ct = -16;      // bits left in C; -16: two bytes to read; -1: error
    bool marker = false;  // a marker was reached; pos is its code byte
    bool eof = false;

    int byte() {
        if (pos >= size) {
            eof = true;
            return 0;
        }
        return d[pos++];
    }

    // One binary decision in statistics bin *st (jdarith.c arith_decode).
    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                int data = 0;
                if (!marker) {
                    data = byte();
                    if (data == 0xFF) {
                        do data = byte();
                        while (data == 0xFF && !eof);
                        if (data == 0) {
                            data = 0xFF;
                        } else if (!eof) {
                            marker = true;  // zeros from here on
                            --pos;
                            data = 0;
                        }
                    }
                }
                c = (c << 8) | data;
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;  // two bytes in: A = 0x10000 below
            }
            a <<= 1;
        }
        int sv = *st;
        int32_t qe = kQe[sv & 0x7F];
        const int nl = qe & 0xFF;
        qe >>= 8;
        const int nm = qe & 0xFF;
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = uint8_t((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = uint8_t((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = uint8_t((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = uint8_t((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    bool next_marker() {
        for (;;) {
            while (pos < size && d[pos] != 0xFF) ++pos;
            while (pos < size && d[pos] == 0xFF) ++pos;
            if (pos >= size) return false;
            if (d[pos] != 0) return true;
            ++pos;
        }
    }

    // read_restart_marker with jpeg_resync_to_restart, as in
    // jpeg_entropy.cpp's Reader::restart; then the decoder starts afresh.
    bool restart(int& next_num) {
        if (!marker) {
            if (!next_marker()) return false;
            marker = true;
        }
        const int want = next_num;
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
        c = a = 0;
        ct = -16;
        return true;
    }
};

}  // namespace

extern "C" int akr_jpeg_arith_scan(const uint8_t* data, int64_t size, int64_t start,
                                   int32_t n_comp, int16_t* const* planes,
                                   const int32_t* geom, const uint8_t* tables,
                                   const uint8_t* cond, int32_t mcus_x, int32_t mcus_y,
                                   int32_t ss, int32_t se, int32_t ah, int32_t al,
                                   int32_t progressive, int32_t restart_interval,
                                   int64_t* end_pos) {
    uint8_t dcs[16][64], acs[16][256];  // the bins of the tables in use are reset below
    uint8_t fixed_bin = 113;
    Arith e{data, size, start};
    const bool interleaved = n_comp > 1;
    const int64_t n_mcus = interleaved ? int64_t(mcus_x) * mcus_y : int64_t(geom[3]) * geom[4];
    const bool dc_scan = !progressive || (ss == 0 && ah == 0);
    const bool ac_scan = !progressive || ss != 0;
    int32_t last_dc[4] = {0, 0, 0, 0};
    int dc_context[4] = {0, 0, 0, 0};
    const int32_t p1 = 1 << al, m1 = -1 * p1;

    auto reset_stats = [&]() {
        for (int ci = 0; ci < n_comp; ++ci) {
            if (dc_scan) {
                std::memset(dcs[tables[2 * ci]], 0, 64);
                last_dc[ci] = 0;
                dc_context[ci] = 0;
            }
            if (ac_scan) std::memset(acs[tables[2 * ci + 1]], 0, 256);
        }
    };
    reset_stats();

    // F.1.4.4.1: the next DC difference of component ci; false on a bad code
    auto dc_diff = [&](int ci, int32_t& diff) -> bool {
        const int tbl = tables[2 * ci];
        uint8_t* st = dcs[tbl] + dc_context[ci];
        if (e.decode(st) == 0) {
            dc_context[ci] = 0;
            diff = 0;
            return true;
        }
        const int sign = e.decode(st + 1);
        st += 2 + sign;
        int m = e.decode(st);
        if (m != 0) {
            st = dcs[tbl] + 20;
            while (e.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    e.ct = -1;  // magnitude overflow
                    return false;
                }
                st += 1;
            }
        }
        if (m < int((1L << cond[tbl]) >> 1))
            dc_context[ci] = 0;
        else if (m > int((1L << cond[16 + tbl]) >> 1))
            dc_context[ci] = 12 + sign * 4;
        else
            dc_context[ci] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (e.decode(st)) v |= m;
        v += 1;
        diff = sign ? -v : v;
        return true;
    };

    // F.1.4.4.2 / G.1.3.2: a nonzero AC value at index k of table tbl, st
    // at its S0 bin's base (SE); false on a bad code
    auto ac_value = [&](int tbl, int k, uint8_t* st, int32_t& out) -> bool {
        const int sign = e.decode(&fixed_bin);
        st += 2;
        int m = e.decode(st);
        if (m != 0) {
            if (e.decode(st)) {
                m <<= 1;
                st = acs[tbl] + (k <= cond[32 + tbl] ? 189 : 217);
                while (e.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        e.ct = -1;
                        return false;
                    }
                    st += 1;
                }
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (e.decode(st)) v |= m;
        v += 1;
        out = sign ? -v : v;
        return true;
    };

    // one block of scan component ci; false stops the MCU (error state)
    auto block = [&](int ci, int16_t* blk) -> bool {
        const int ac_tbl = tables[2 * ci + 1];
        if (!progressive) {
            int32_t diff;
            if (!dc_diff(ci, diff)) return false;
            last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
            blk[0] = int16_t(last_dc[ci]);
            for (int k = 1; k <= 63; ++k) {
                uint8_t* st = acs[ac_tbl] + 3 * (k - 1);
                if (e.decode(st)) break;  // EOB
                while (e.decode(st + 1) == 0) {
                    st += 3;
                    if (++k > 63) {
                        e.ct = -1;  // spectral overflow
                        return false;
                    }
                }
                int32_t v;
                if (!ac_value(ac_tbl, k, st, v)) return false;
                blk[kNatural[k]] = int16_t(v);
            }
            return true;
        }
        if (ss == 0 && ah == 0) {
            int32_t diff;
            if (!dc_diff(ci, diff)) return false;
            last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
            blk[0] = int16_t(uint32_t(last_dc[ci]) << al);
            return true;
        }
        if (ss == 0) {  // DC refinement: one bit at the fixed estimate
            if (e.decode(&fixed_bin)) blk[0] = int16_t(blk[0] | p1);
            return true;
        }
        if (ah == 0) {
            for (int k = ss; k <= se; ++k) {
                uint8_t* st = acs[ac_tbl] + 3 * (k - 1);
                if (e.decode(st)) break;
                while (e.decode(st + 1) == 0) {
                    st += 3;
                    if (++k > se) {
                        e.ct = -1;
                        return false;
                    }
                }
                int32_t v;
                if (!ac_value(ac_tbl, k, st, v)) return false;
                blk[kNatural[k]] = int16_t(uint32_t(v) << al);
            }
            return true;
        }
        int kex = se;  // EOBx: the previous stage's last nonzero index
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = acs[ac_tbl] + 3 * (k - 1);
            if (k > kex)
                if (e.decode(st)) break;
            for (;;) {
                int16_t* co = blk + kNatural[k];
                if (*co) {
                    if (e.decode(st + 2)) *co = int16_t(*co < 0 ? *co + m1 : *co + p1);
                    break;
                }
                if (e.decode(st + 1)) {
                    *co = int16_t(e.decode(&fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) {
                    e.ct = -1;
                    return false;
                }
            }
        }
        return true;
    };

    const bool dc_refine = progressive && ss == 0 && ah != 0;
    int restart_num = 0;
    int rc = 0;
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart_interval && m > 0 && m % restart_interval == 0) {
            if (!e.restart(restart_num)) {
                rc = 1;
                break;
            }
            reset_stats();
        }
        if (e.ct == -1 && !dc_refine) continue;  // after a bad code
        if (interleaved) {
            const int64_t my = m / mcus_x, mx = m % mcus_x;
            for (int c = 0; c < n_comp; ++c) {
                const int32_t* g = geom + 6 * c;
                for (int v = 0; v < g[1]; ++v)
                    for (int u = 0; u < g[0]; ++u) {
                        const int64_t by = my * g[1] + v, bx = mx * g[0] + u;
                        if (!block(c, planes[c] + (by * g[2] + bx) * 64)) goto mcu_done;
                    }
            }
        } else {
            const int64_t by = m / geom[3], bx = m % geom[3];
            block(0, planes[0] + (by * geom[2] + bx) * 64);
        }
    mcu_done:
        if (e.eof) {
            rc = 1;
            break;
        }
    }
    *end_pos = e.marker ? e.pos - 1 : e.pos;
    return rc;
}
