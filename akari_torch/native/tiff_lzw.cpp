// LZW decoding of one TIFF strip or tile for akari_torch/core/tiff.py.
//
// The JAX package reads compressed TIFFs through PIL, which hands them to
// libtiff; the decoder follows libtiff's tif_lzw.c:
//
// - LZWDecode, the TIFF 6.0 form: codes taken most significant bit first,
//   9 to 12 bits wide, the width growing one code early (when the next
//   free entry reaches the code mask less one); code 256 clears the
//   table, 257 ends the data. A code equal to the next free entry
//   repeats the last string's first byte; a code past it, or a literal
//   code once the table is full (5,119 entries, CSIZE), is corrupt. The
//   previous string starts as the entry of code 0, as libtiff's
//   LZWPreDecode sets it, so data that does not open with a clear code
//   still decodes.
// - LZWDecodeCompat, the old bit-reversed form (libtiff picks it when the
//   data's first byte is 0 and the second's lowest bit is set): codes
//   taken least significant bit first and the width growing when the next
//   free entry passes the code mask.
//
// Decoding stops once ``occ`` bytes are written (a string longer than the
// room left is cut); input that ends, or an end code, before then is the
// "Not enough data" error libtiff returns.
//
// C ABI (ctypes):
//   int akr_tiff_lzw(const uint8_t* src, int64_t size, uint8_t* dst,
//                    int64_t occ, int32_t compat);
// Returns 0 when ``dst`` is full, 1 when the data ends first, 2 on a code
// libtiff rejects.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>

namespace {

constexpr int kBitsMin = 9;
constexpr int kBitsMax = 12;
constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;  // libtiff's CSIZE

enum { kDone = 0, kShort = 1, kCorrupt = 2 };

struct Entry {
    int32_t next;      // previous entry of the string, -1 at its first byte
    uint16_t length;
    uint8_t value;
    uint8_t firstchar;
};

struct Bits {
    const uint8_t* p;
    uint64_t left;  // bits not yet taken
    uint64_t data;
    int count;
    bool msb;

    // the next code of ``nbits`` bits, or -1 when fewer bits are left
    // (libtiff's NextCode treats that as an end code)
    int get(int nbits) {
        if (left < uint64_t(nbits)) return -1;
        left -= nbits;
        while (count < nbits) {
            data = msb ? (data << 8) | *p++ : data | (uint64_t(*p++) << count);
            count += 8;
        }
        count -= nbits;
        const uint64_t mask = (1u << nbits) - 1;
        if (msb) return int((data >> count) & mask);
        const int code = int(data & mask);
        data >>= nbits;
        return code;
    }
};

}  // namespace

extern "C" int akr_tiff_lzw(const uint8_t* src, int64_t size, uint8_t* dst, int64_t occ,
                            int32_t compat) {
    // entries from the next free one up are written before any code reads
    // them (a code past the next free entry is refused), so a clear code
    // only resets the next free entry, as libtiff's decoder does
    static thread_local Entry table[kCsize];
    Entry* const tab = table;  // one thread-local lookup, not one an access
    for (int c = 0; c < 256; ++c) tab[c] = Entry{-1, 1, uint8_t(c), uint8_t(c)};
    Bits in{src, uint64_t(size) * 8, 0, 0, compat == 0};
    const int early = compat ? 0 : 1;  // the new form grows one code early
    int nbits = kBitsMin;
    int maxcode = (1 << nbits) - 1 - early;
    int free_ent = kFirst;
    int old = 0;  // LZWPreDecode: dec_oldcodep = &dec_codetab[0]
    uint8_t* op = dst;
    int64_t room = occ;

    auto grow = [&]() {
        if (++free_ent > maxcode) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxcode = (1 << nbits) - 1 - early;
            if (free_ent >= kCsize) free_ent = -1;  // full: only clear or end codes follow
        }
    };
    // write the string of ``code`` (length ``len``), cut to the room left
    auto emit = [&](int code) {
        int len = tab[code].length;
        if (len > room) {
            int c = code;
            while (tab[c].length > room) c = tab[c].next;
            for (int64_t k = room - 1; k >= 0; --k) {
                op[k] = tab[c].value;
                c = tab[c].next;
            }
            op += room;
            room = 0;
            return;
        }
        int c = code;
        for (int k = len - 1; k >= 0; --k) {
            op[k] = tab[c].value;
            c = tab[c].next;
        }
        op += len;
        room -= len;
    };

    while (room > 0) {
        int code = in.get(nbits);
        if (code < 0 || code == kEoi) break;
        if (code == kClear) {
            free_ent = kFirst;
            nbits = kBitsMin;
            maxcode = (1 << nbits) - 1 - early;
            do {
                code = in.get(nbits);
            } while (code == kClear);
            if (code < 0 || code == kEoi) break;
            if (code > kClear) return kCorrupt;
            *op++ = uint8_t(code);
            --room;
            old = code;
            continue;
        }
        if (free_ent < 0) return kCorrupt;  // table full
        if (code >= free_ent) {
            if (code != free_ent) return kCorrupt;
            tab[free_ent].value = tab[old].firstchar;  // KwKwK
        } else {
            tab[free_ent].value = tab[code].firstchar;
        }
        tab[free_ent].next = old;
        tab[free_ent].firstchar = tab[old].firstchar;
        tab[free_ent].length = uint16_t(tab[old].length + 1);
        grow();
        old = code;
        if (code < 256) {
            *op++ = uint8_t(code);
            --room;
        } else {
            emit(code);
        }
    }
    return room > 0 ? kShort : kDone;
}
