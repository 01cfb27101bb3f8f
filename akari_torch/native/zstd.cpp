// Zstandard decoding of one TIFF strip or tile for akari_torch/core/tiff.py.
//
// The JAX package reads ZSTD-compressed TIFFs through PIL, which hands them
// to libtiff; libtiff's ZSTDDecode (tif_zstd.c) feeds the whole strip to
// libzstd's ZSTD_decompressStream with room for ``occ`` bytes, once, and
// fails unless the room is filled. The format is RFC 8878's; the checks
// are libzstd's, so that a strip decodes (or fails) here as there:
//
// - the first frame only (ZSTD_decompressStream ends its call at a frame's
//   end): a skippable frame first leaves the room empty, an unknown magic
//   number, a reserved header bit, a dictionary id or a window over
//   128 MiB + 1 is an error; a frame that ends before the room is full is
//   "not enough data", as is input that ends first;
// - blocks are decoded whole, and decoding stops once a block takes the
//   output past ``occ`` (a block after an output that fills the room
//   exactly is still decoded, and the checksum checked after a last block
//   that does so); a raw block cut short yields what it holds;
// - a block: raw, RLE or compressed, at most min(window, 128 KiB) in and
//   out; reserved type 3 is an error;
// - literals: raw, RLE, or Huffman-coded in 1 or 4 streams, the weights
//   given directly or FSE-compressed (HUF_readStats), or the previous
//   block's table (treeless); every stream must end exactly (libzstd's
//   fast 4-stream decoders do not check this: return code 3);
// - sequences: predefined, RLE, FSE-compressed (FSE_readNCount) or repeat
//   tables, the three repeat offsets (1, 4, 8 at the frame's start), the
//   bit stream ending exactly; a literal length past the literals, a match
//   before the frame's first byte, or more than the block's room, is an
//   error;
// - the frame content size, when given, must equal the output; XXH64 (its
//   low 32 bits) is checked when the frame asks for it.
//
// When the frame gives its content size, that size fits the room and the
// whole frame is in the strip, libzstd decodes it in one pass and skips the
// window limit, as here.
//
// C ABI (ctypes):
//   int akr_zstd_decode(const uint8_t* src, int64_t size, uint8_t* dst,
//                       int64_t occ);
// Returns 0 when ``dst`` holds ``occ`` bytes, 1 when the data ends first
// (libtiff: "Not enough data"), 2 on data libzstd rejects, 3 on a 4-stream
// Huffman literal stream that does not end exactly (see huffman_stream).
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kShort = 1, kCorrupt = 2, kStreamEnd = 3 };

struct Corrupt {};
struct StreamEnd {};  // a 4-stream Huffman literal stream that does not end exactly

[[noreturn]] void fail() { throw Corrupt{}; }

uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
uint64_t le64(const uint8_t* p) { return le32(p) | (uint64_t(le32(p + 4)) << 32); }
int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t merge(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        do {
            v1 = round64(v1, le64(p));
            v2 = round64(v2, le64(p + 8));
            v3 = round64(v3, le64(p + 16));
            v4 = round64(v4, le64(p + 24));
            p += 32;
        } while (end - p >= 32);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge(merge(merge(merge(h, v1), v2), v3), v4);
    } else {
        h = P5;
    }
    h += n;
    for (; end - p >= 8; p += 8) h = rotl(h ^ round64(0, le64(p)), 27) * P1 + P4;
    if (end - p >= 4) {
        h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ------------------------------------------------------ backward bit stream

// libzstd's BIT_DStream_t on a 64-bit host, with its reload statuses: the
// FSE weight decoder stops on them. Reading past the stream's start (only
// in data that then fails a check) gives whatever libzstd's register holds.
enum Status { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };

struct BitIn {
    uint64_t container = 0;
    unsigned consumed = 0;
    const uint8_t* ptr = nullptr;
    const uint8_t* start = nullptr;
    const uint8_t* limit = nullptr;

    void init(const uint8_t* src, size_t n) {
        if (n < 1) fail();
        start = src;
        limit = src + 8;
        const uint8_t last = src[n - 1];
        if (!last) fail();
        if (n >= 8) {
            ptr = src + n - 8;
            container = le64(ptr);
            consumed = 8 - highbit(last);
        } else {
            ptr = src;
            container = 0;
            for (size_t i = 0; i < n; ++i) container |= uint64_t(src[i]) << (8 * i);
            consumed = 8 - highbit(last) + unsigned(8 - n) * 8;
        }
    }
    uint64_t look(unsigned nb) const {  // BIT_getMiddleBits
        const unsigned at = (64u - consumed - nb) & 63u;
        return nb ? (container >> at) & ((uint64_t(1) << nb) - 1) : 0;
    }
    uint64_t look_fast(unsigned nb) const {  // BIT_lookBitsFast, nb >= 1
        return (container << (consumed & 63u)) >> ((64u - nb) & 63u);
    }
    uint64_t read(unsigned nb) {
        const uint64_t v = look(nb);
        consumed += nb;
        return v;
    }
    Status reload() {
        if (consumed > 64) return kOverflow;
        if (ptr >= limit) {
            ptr -= consumed >> 3;
            consumed &= 7;
            container = le64(ptr);
            return kUnfinished;
        }
        if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
        unsigned nb = consumed >> 3;
        Status s = kUnfinished;
        if (ptr - nb < start) {
            nb = unsigned(ptr - start);
            s = kEndOfBuffer;
        }
        ptr -= nb;
        consumed -= nb * 8;
        container = le64(ptr);
        return s;
    }
};

// ------------------------------------------------------------------- FSE

struct FseCell {
    uint16_t next;   // newState, before the low bits are added
    uint8_t nb;      // bits to read
    uint8_t sym;
};

struct Fse {
    unsigned log = 0;
    bool fast = true;
    std::vector<FseCell> cells;
};

// FSE_readNCount: the normalized counts; returns the header's size.
size_t read_ncount(const uint8_t* src, size_t n, unsigned max_sv, std::vector<int16_t>& norm,
                   unsigned& out_max_sv, unsigned& log) {
    if (n < 8) {
        uint8_t buf[8] = {0};
        std::memcpy(buf, src, n);
        const size_t got = read_ncount(buf, 8, max_sv, norm, out_max_sv, log);
        if (got > n) fail();
        return got;
    }
    const uint8_t* const istart = src;
    const uint8_t* const iend = src + n;
    const uint8_t* ip = src;
    const unsigned max_sv1 = max_sv + 1;
    norm.assign(max_sv1, 0);
    uint32_t bits = le32(ip);
    int nb = (bits & 0xF) + 5;
    if (nb > 15) fail();
    bits >>= 4;
    int count_bits = 4;
    log = nb;
    int remaining = (1 << nb) + 1;
    int threshold = 1 << nb;
    nb++;
    unsigned charnum = 0;
    bool previous0 = false;
    auto advance = [&]() {
        if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
            ip += count_bits >> 3;
            count_bits &= 7;
        } else {
            count_bits -= int(8 * (iend - 4 - ip));
            count_bits &= 31;
            ip = iend - 4;
        }
        bits = le32(ip) >> count_bits;
    };
    for (;;) {
        if (previous0) {
            int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
            while (repeats >= 12) {
                charnum += 3 * 12;
                if (ip <= iend - 7) {
                    ip += 3;
                } else {
                    count_bits -= int(8 * (iend - 7 - ip));
                    count_bits &= 31;
                    ip = iend - 4;
                }
                bits = le32(ip) >> count_bits;
                repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
            }
            charnum += 3 * repeats;
            bits >>= 2 * repeats;
            count_bits += 2 * repeats;
            charnum += bits & 3;
            count_bits += 2;
            if (charnum >= max_sv1) break;
            advance();
        }
        {
            const int max = (2 * threshold - 1) - remaining;
            int count;
            if (int(bits & (threshold - 1)) < max) {
                count = bits & (threshold - 1);
                count_bits += nb - 1;
            } else {
                count = bits & (2 * threshold - 1);
                if (count >= threshold) count -= max;
                count_bits += nb;
            }
            count--;
            if (count >= 0)
                remaining -= count;
            else
                remaining += count;
            norm[charnum++] = int16_t(count);
            previous0 = !count;
            if (remaining < threshold) {
                if (remaining <= 1) break;
                nb = highbit(remaining) + 1;
                threshold = 1 << (nb - 1);
            }
            if (charnum >= max_sv1) break;
            advance();
        }
    }
    if (remaining != 1) fail();
    if (charnum > max_sv1) fail();
    if (count_bits > 32) fail();
    out_max_sv = charnum - 1;
    ip += (count_bits + 7) >> 3;
    return size_t(ip - istart);
}

// FSE_buildDTable / ZSTD_buildFSETable: the symbols spread over the table.
void build_fse(const std::vector<int16_t>& norm, unsigned max_sv, unsigned log, Fse& t) {
    const unsigned size = 1u << log;
    t.log = log;
    t.fast = true;
    t.cells.assign(size, FseCell{0, 0, 0});
    std::vector<uint16_t> next(max_sv + 1);
    unsigned high = size - 1;
    const int large = 1 << (log - 1);
    for (unsigned s = 0; s <= max_sv; ++s) {
        if (norm[s] == -1) {
            t.cells[high--].sym = uint8_t(s);
            next[s] = 1;
        } else {
            if (norm[s] >= large) t.fast = false;
            next[s] = uint16_t(norm[s]);
        }
    }
    const unsigned mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
    unsigned pos = 0;
    for (unsigned s = 0; s <= max_sv; ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            t.cells[pos].sym = uint8_t(s);
            pos = (pos + step) & mask;
            while (pos > high) pos = (pos + step) & mask;
        }
    }
    if (pos != 0) fail();
    for (unsigned u = 0; u < size; ++u) {
        const unsigned s = t.cells[u].sym;
        const unsigned ns = next[s]++;
        const unsigned nb = log - highbit(ns);
        t.cells[u].nb = uint8_t(nb);
        t.cells[u].next = uint16_t((ns << nb) - size);
    }
}

// --------------------------------------------------------------- Huffman

struct Huffman {
    unsigned log = 0;
    std::vector<uint8_t> sym, nb;  // 1 << log entries
};

// FSE_decompress_wksp on the Huffman weights (at most 255, table log <= 6).
size_t fse_weights(const uint8_t* src, size_t n, uint8_t* out) {
    std::vector<int16_t> norm;
    unsigned max_sv = 0, log = 0;
    const size_t hsize = read_ncount(src, n, 255, norm, max_sv, log);
    if (log > 6) fail();
    Fse t;
    build_fse(norm, max_sv, log, t);
    BitIn in;
    in.init(src + hsize, n - hsize);
    const size_t omax = 255, olimit = omax - 3;
    unsigned s1 = unsigned(in.read(log));
    in.reload();
    unsigned s2 = unsigned(in.read(log));
    in.reload();
    if (in.reload() == kOverflow) fail();
    size_t op = 0;
    auto emit = [&](unsigned& st) {
        const FseCell& c = t.cells[st];
        out[op++] = c.sym;
        const unsigned low = unsigned(t.fast && c.nb ? in.look_fast(c.nb) : in.look(c.nb));
        in.consumed += c.nb;
        st = c.next + low;
    };
    while ((in.reload() == kUnfinished) & (op < olimit)) {
        emit(s1);
        emit(s2);
        emit(s1);
        emit(s2);
    }
    for (;;) {
        if (op > omax - 2) fail();
        emit(s1);
        if (in.reload() == kOverflow) {
            emit(s2);
            break;
        }
        if (op > omax - 2) fail();
        emit(s2);
        if (in.reload() == kOverflow) {
            emit(s1);
            break;
        }
    }
    return op;
}

// HUF_readStats + HUF_readDTableX1: the table; returns the header's size.
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h) {
    if (n < 1) fail();
    uint8_t w[256];
    std::memset(w, 0, sizeof(w));
    size_t isize = src[0], osize;
    if (isize >= 128) {
        osize = isize - 127;
        isize = (osize + 1) / 2;
        if (isize + 1 > n) fail();
        for (size_t k = 0; k < osize; k += 2) {
            w[k] = src[1 + k / 2] >> 4;
            w[k + 1] = src[1 + k / 2] & 15;
        }
    } else {
        if (isize + 1 > n) fail();
        osize = fse_weights(src + 1, isize, w);
    }
    uint32_t rank[16] = {0};
    uint32_t total = 0;
    for (size_t k = 0; k < osize; ++k) {
        if (w[k] > 12) fail();
        rank[w[k]]++;
        total += (1u << w[k]) >> 1;
    }
    if (total == 0) fail();
    const unsigned log = highbit(total) + 1;
    if (log > 12) fail();
    const uint32_t rest = (1u << log) - total;
    if ((1u << highbit(rest)) != rest) fail();
    const unsigned last = highbit(rest) + 1;
    w[osize] = uint8_t(last);
    rank[last]++;
    if (rank[1] < 2 || (rank[1] & 1)) fail();
    const size_t nsym = osize + 1;
    uint32_t start[16] = {0};
    for (unsigned k = 1, pos = 0; k <= log; ++k) {
        start[k] = pos;
        pos += rank[k] << (k - 1);
    }
    h.log = log;
    h.sym.assign(size_t(1) << log, 0);
    h.nb.assign(size_t(1) << log, 0);
    for (size_t s = 0; s < nsym; ++s) {
        if (!w[s]) continue;
        const uint32_t len = (1u << w[s]) >> 1;
        for (uint32_t i = 0; i < len; ++i) {
            h.sym[start[w[s]] + i] = uint8_t(s);
            h.nb[start[w[s]] + i] = uint8_t(log + 1 - w[s]);
        }
        start[w[s]] += len;
    }
    return isize + 1;
}

// A plain backward reader for the Huffman and sequence streams: bits past
// the stream's start read as zeros, and the stream must end exactly, so a
// stream libzstd reads past fails here too.
struct Bits {
    const uint8_t* src = nullptr;
    size_t n = 0;
    int64_t pos = 0;  // bits left to read
    void init(const uint8_t* s, size_t size) {
        if (size < 1 || !s[size - 1]) fail();
        src = s;
        n = size;
        pos = int64_t(8 * (size - 1)) + highbit(s[size - 1]);
    }
    uint64_t load(int64_t byte) const {
        if (byte + 8 <= int64_t(n)) return le64(src + byte);
        uint64_t v = 0;
        for (int64_t i = 0; byte + i < int64_t(n); ++i) v |= uint64_t(src[byte + i]) << (8 * i);
        return v;
    }
    uint64_t peek(unsigned nb) const {  // nb <= 57
        if (!nb || pos <= 0) return 0;
        const int64_t lo = pos - nb;
        if (lo >= 0) return (load(lo >> 3) >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
        return (load(0) & ((uint64_t(1) << pos) - 1)) << -lo;
    }
    uint64_t read(unsigned nb) {
        const uint64_t v = peek(nb);
        pos -= nb;
        return v;
    }
    bool at_end() const { return pos == 0; }
};

// One Huffman stream of ``count`` symbols. libzstd's fast 4-stream loops
// check neither a stream's last byte nor where it ends, reading on through
// the bytes before it; the port refuses such streams (StreamEnd).
void huffman_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out, size_t count,
                    bool four) {
    if (four && (n < 1 || !src[n - 1])) throw StreamEnd{};
    Bits in;
    in.init(src, n);
    for (size_t i = 0; i < count; ++i) {
        const uint64_t v = in.peek(h.log);
        out[i] = h.sym[v];
        in.pos -= h.nb[v];
    }
    if (!in.at_end()) {
        if (four) throw StreamEnd{};
        fail();
    }
}

// ------------------------------------------------------------- sequences

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                                  12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                                  48, 64, 0x80, 0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000,
                                  0x4000, 0x8000, 0x10000};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003, 0x2003,
    0x4003, 0x8003, 0x10003};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqTable {
    Fse fse;  // symbols are codes
};

void default_table(const int16_t* dist, unsigned n, unsigned log, SeqTable& t) {
    std::vector<int16_t> norm(dist, dist + n);
    build_fse(norm, n - 1, log, t.fse);
}

// ZSTD_buildSeqTable: returns the bytes its description took.
size_t seq_table(int mode, const uint8_t* src, size_t n, unsigned max_code, unsigned max_log,
                 const SeqTable& def, bool have_repeat, SeqTable& cur) {
    switch (mode) {
        case 0:
            cur = def;
            return 0;
        case 1: {
            if (!n) fail();
            if (src[0] > max_code) fail();
            cur.fse.log = 0;
            cur.fse.cells.assign(1, FseCell{0, 0, src[0]});
            return 1;
        }
        case 2: {
            std::vector<int16_t> norm;
            unsigned max_sv = 0, log = 0;
            const size_t hsize = read_ncount(src, n, max_code, norm, max_sv, log);
            if (log > max_log) fail();
            build_fse(norm, max_sv, log, cur.fse);
            return hsize;
        }
        default:
            if (!have_repeat) fail();
            return 0;
    }
}

struct Frame {
    const uint8_t* lits = nullptr;
    std::vector<uint8_t> lit_buf;
    Huffman huf;
    bool have_huf = false;
    SeqTable ll, of, ml, ll_def, of_def, ml_def;
    bool have_tables = false;
    uint64_t rep[3] = {1, 4, 8};
    size_t block_max = 0;
    Frame() {
        default_table(kLLDefault, 36, 6, ll_def);
        default_table(kMLDefault, 53, 6, ml_def);
        default_table(kOFDefault, 29, 5, of_def);
    }
};

// ZSTD_decodeLiteralsBlock: fills f.lit_buf; returns the section's size.
size_t literals(Frame& f, const uint8_t* src, size_t n, size_t room, size_t& lit_size) {
    if (n < 2) fail();
    const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    const size_t write_max = room < f.block_max ? room : f.block_max;
    if (type == 2 || type == 3) {
        if (type == 3 && !f.have_huf) fail();
        if (n < 5) fail();
        const uint32_t lhc = le32(src);
        size_t lh, lsize, csize;
        bool single = false;
        if (sf < 2) {
            single = sf == 0;
            lh = 3;
            lsize = (lhc >> 4) & 0x3FF;
            csize = (lhc >> 14) & 0x3FF;
        } else if (sf == 2) {
            lh = 4;
            lsize = (lhc >> 4) & 0x3FFF;
            csize = lhc >> 18;
        } else {
            lh = 5;
            lsize = (lhc >> 4) & 0x3FFFF;
            csize = (lhc >> 22) + (size_t(src[4]) << 10);
        }
        if (lsize > f.block_max) fail();
        if (!single && lsize < 6) fail();
        if (csize + lh > n) fail();
        if (write_max < lsize) fail();
        const uint8_t* cs = src + lh;
        size_t cn = csize;
        if (type == 2) {
            Huffman h;
            const size_t hs = read_huffman(cs, cn, h);
            if (hs >= cn) fail();
            f.huf = std::move(h);
            cs += hs;
            cn -= hs;
        }
        f.lit_buf.assign(lsize, 0);
        if (single) {
            huffman_stream(f.huf, cs, cn, f.lit_buf.data(), lsize, false);
        } else {
            if (cn < 10) fail();
            const size_t l1 = le16(cs), l2 = le16(cs + 2), l3 = le16(cs + 4);
            if (l1 + l2 + l3 + 6 > cn) fail();
            const size_t l4 = cn - 6 - l1 - l2 - l3;
            const size_t seg = (lsize + 3) / 4;
            const uint8_t* p = cs + 6;
            huffman_stream(f.huf, p, l1, f.lit_buf.data(), seg, true);
            huffman_stream(f.huf, p + l1, l2, f.lit_buf.data() + seg, seg, true);
            huffman_stream(f.huf, p + l1 + l2, l3, f.lit_buf.data() + 2 * seg, seg, true);
            huffman_stream(f.huf, p + l1 + l2 + l3, l4, f.lit_buf.data() + 3 * seg,
                           lsize - 3 * seg, true);
        }
        f.have_huf = true;
        lit_size = lsize;
        return lh + csize;
    }
    size_t lh, lsize;
    if (sf == 0 || sf == 2) {
        lh = 1;
        lsize = src[0] >> 3;
    } else if (sf == 1) {
        lh = 2;
        if (type == 1 && n < 3) fail();
        lsize = le16(src) >> 4;
    } else {
        lh = 3;
        if (n < (type == 1 ? 4u : 3u)) fail();
        lsize = le24(src) >> 4;
    }
    if (lsize > f.block_max) fail();
    if (write_max < lsize) fail();
    if (type == 0) {
        if (lh + lsize > n) fail();
        f.lit_buf.assign(src + lh, src + lh + lsize);
        lit_size = lsize;
        return lh + lsize;
    }
    f.lit_buf.assign(lsize, src[lh]);
    lit_size = lsize;
    return lh + 1;
}

// ZSTD_decompressBlock_internal: appends the block's output to ``out``.
void compressed_block(Frame& f, const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                      size_t room) {
    size_t lit_size = 0;
    const size_t lh = literals(f, src, n, room, lit_size);
    const uint8_t* ip = src + lh;
    const uint8_t* const iend = src + n;
    if (ip + 1 > iend) fail();
    size_t nseq = *ip++;
    if (nseq > 0x7F) {
        if (nseq == 0xFF) {
            if (ip + 2 > iend) fail();
            nseq = le16(ip) + 0x7F00;
            ip += 2;
        } else {
            if (ip >= iend) fail();
            nseq = ((nseq - 0x80) << 8) + *ip++;
        }
    }
    const size_t cap = room < f.block_max ? room : f.block_max;
    const size_t start = out.size();
    const uint8_t* lit = f.lit_buf.data();
    const uint8_t* const lit_end = lit + lit_size;
    if (nseq == 0) {
        if (ip != iend) fail();
    } else {
        if (ip + 1 > iend) fail();
        if (*ip & 3) fail();
        const int llm = *ip >> 6, ofm = (*ip >> 4) & 3, mlm = (*ip >> 2) & 3;
        ip++;
        ip += seq_table(llm, ip, size_t(iend - ip), 35, 9, f.ll_def, f.have_tables, f.ll);
        ip += seq_table(ofm, ip, size_t(iend - ip), 31, 8, f.of_def, f.have_tables, f.of);
        ip += seq_table(mlm, ip, size_t(iend - ip), 52, 9, f.ml_def, f.have_tables, f.ml);
        Bits in;
        in.init(ip, size_t(iend - ip));
        f.have_tables = true;
        uint64_t sll = in.read(f.ll.fse.log), sof = in.read(f.of.fse.log),
                 sml = in.read(f.ml.fse.log);
        uint64_t rep[3] = {f.rep[0], f.rep[1], f.rep[2]};
        for (size_t k = 0; k < nseq; ++k) {
            const FseCell& cll = f.ll.fse.cells[sll];
            const FseCell& cof = f.of.fse.cells[sof];
            const FseCell& cml = f.ml.fse.cells[sml];
            const unsigned ofc = cof.sym;
            uint64_t ll = kLLBase[cll.sym], ml = kMLBase[cml.sym], offset;
            if (ofc > 1) {
                offset = (uint64_t(1) << ofc) - 3 + in.read(ofc);
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                const unsigned ll0 = kLLBase[cll.sym] == 0;
                if (ofc == 0) {
                    offset = rep[ll0];
                    rep[1] = rep[!ll0];
                    rep[0] = offset;
                } else {
                    const uint64_t idx = 1 + ll0 + in.read(1);
                    uint64_t t = idx == 3 ? rep[0] - 1 : rep[idx];
                    t -= !t;
                    if (idx != 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset = t;
                }
            }
            ml += in.read(kMLBits[cml.sym]);
            ll += in.read(kLLBits[cll.sym]);
            if (k + 1 < nseq) {
                sll = cll.next + in.read(cll.nb);
                sml = cml.next + in.read(cml.nb);
                sof = cof.next + in.read(cof.nb);
            }
            // ZSTD_execSequence
            if (ll > uint64_t(lit_end - lit)) fail();
            if ((out.size() - start) + ll + ml > cap) fail();
            out.insert(out.end(), lit, lit + ll);
            lit += ll;
            if (offset > out.size()) fail();
            size_t from = out.size() - offset;
            for (uint64_t i = 0; i < ml; ++i) out.push_back(out[from++]);
        }
        if (!in.at_end()) fail();
        f.rep[0] = rep[0];
        f.rep[1] = rep[1];
        f.rep[2] = rep[2];
    }
    if (size_t(lit_end - lit) > cap - (out.size() - start)) fail();
    out.insert(out.end(), lit, lit_end);
}

int decode(const uint8_t* src, size_t n, uint8_t* dst, size_t occ) {
    if (n < 4) return kShort;
    const uint32_t magic = le32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return kShort;  // the room stays empty
    if (magic != 0xFD2FB528u) return kCorrupt;
    if (n < 5) return kShort;
    const uint8_t fhd = src[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
              did_flag = fhd & 3;
    const size_t did_size[4] = {0, 1, 2, 4};
    const size_t fcs_size = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
    const size_t hsize = 5 + (single ? 0 : 1) + did_size[did_flag] + fcs_size;
    if (n < hsize) return kShort;
    if (fhd & 0x08) return kCorrupt;
    size_t p = 5;
    uint64_t window = 0;
    if (!single) {
        const unsigned wlog = 10 + (src[p] >> 3);
        if (wlog > 31) return kCorrupt;
        const uint64_t base = uint64_t(1) << wlog;
        window = base + (base >> 3) * (src[p] & 7);
        p++;
    }
    uint32_t dict = 0;
    if (did_flag == 1) dict = src[p];
    if (did_flag == 2) dict = le16(src + p);
    if (did_flag == 3) dict = le32(src + p);
    p += did_size[did_flag];
    bool fcs_known = fcs_size > 0;
    uint64_t fcs = 0;
    if (fcs_size == 1) fcs = src[p];
    if (fcs_size == 2) fcs = le16(src + p) + 256;
    if (fcs_size == 4) fcs = le32(src + p);
    if (fcs_size == 8) fcs = le64(src + p);
    p += fcs_size;
    if (single) window = fcs;
    if (dict) return kCorrupt;
    // the one-pass shortcut: the whole frame here and its content fitting the room
    bool one_pass = false;
    if (fcs_known && fcs <= occ) {
        size_t q = p;
        for (;;) {
            if (n - q < 3) break;
            const uint32_t bh = le24(src + q);
            const int type = (bh >> 1) & 3;
            if (type == 3) break;
            const size_t size = type == 1 ? 1 : bh >> 3;
            q += 3;
            if (n - q < size) break;
            q += size;
            if (bh & 1) {
                one_pass = !checksum || n - q >= 4;
                break;
            }
        }
    }
    const size_t block_max = window < (128u << 10) ? size_t(window) : (128u << 10);
    if (!one_pass && (window < 1024 ? 1024 : window) > (uint64_t(1) << 27) + 1) return kCorrupt;
    Frame f;
    f.block_max = block_max;
    std::vector<uint8_t> out;
    const uint64_t limit = fcs_known ? fcs : UINT64_MAX;
    auto finish = [&]() {
        if (out.size() < occ) return kShort;
        std::memcpy(dst, out.data(), occ);
        return kOk;
    };
    for (;;) {
        if (n - p < 3) return finish();
        const uint32_t bh = le24(src + p);
        const bool last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        p += 3;
        if (type == 3) return kCorrupt;
        // one pass: raw and RLE blocks bounded by the room only
        if ((type == 2 || (type == 0 && !one_pass)) && size > block_max) return kCorrupt;
        const uint64_t bound = one_pass ? occ : limit;
        const size_t room = out.size() < bound ? size_t(bound - out.size()) : 0;
        if (type == 0) {
            const size_t have = n - p < size ? n - p : size;
            if (have > room) return kCorrupt;
            out.insert(out.end(), src + p, src + p + have);
            p += have;
            if (have < size) return finish();
        } else if (type == 1) {
            if (n - p < 1) return finish();
            if (size > room || (!one_pass && size > block_max)) return kCorrupt;
            out.insert(out.end(), size, src[p]);
            p += 1;
        } else {
            if (n - p < size) return finish();
            try {
                compressed_block(f, src + p, size, out, room);
            } catch (const Corrupt&) {
                return kCorrupt;
            } catch (const StreamEnd&) {
                return kStreamEnd;
            }
            p += size;
        }
        if (last) break;
        if (!one_pass && out.size() > occ) return finish();
    }
    if (fcs_known && out.size() != fcs) return kCorrupt;
    if (!one_pass && out.size() > occ) return finish();
    if (checksum) {
        if (n - p < 4) return finish();
        if (le32(src + p) != uint32_t(xxh64(out.data(), out.size()))) return kCorrupt;
    }
    return finish();
}

}  // namespace

extern "C" int akr_zstd_decode(const uint8_t* src, int64_t size, uint8_t* dst, int64_t occ) {
    try {
        return decode(src, size_t(size), dst, size_t(occ));
    } catch (const Corrupt&) {
        return kCorrupt;
    } catch (...) {
        return kCorrupt;
    }
}
