// Lossless WebP (VP8L, RFC 9649 sections 3-5) decoding for
// akari_torch/core/webp.py.
//
// The JAX package reads WebP through PIL, which hands the file to libwebp's
// WebPAnimDecoder. The decoder follows libwebp's src/dec/vp8l_dec.c and
// src/utils/huffman_utils.c (BSD licence, Copyright 2012 Google Inc.), so
// that it accepts and refuses what libwebp does:
//
// - the bit reader: a 64-bit window refilled byte by byte, reads past the
//   data's end flagged once more bits are taken than the data holds (at
//   least 64), the window then re-read from its start;
// - prefix codes in two-level tables (8 root bits): a code whose lengths
//   are not complete is refused unless it has one symbol, which then takes
//   no bits; simple codes of one or two symbols; code lengths through the
//   code-length code (repeat codes 16, 17 and 18; code 16 repeats the last
//   non-zero length, 8 at first) up to ``max_symbol``;
// - the meta prefix image and its groups, every group's codes read and
//   checked whether or not a pixel uses it;
// - LZ77 copies with the 120 plane codes (a distance below 1 taken as 1),
//   the colour cache (hash 0x1e35a7bd, every decoded pixel inserted in
//   order);
// - transforms read in order (each type at most once) and undone in
//   reverse: the 14 predictors (modes 14 and 15 predict opaque black, as
//   libwebp's padding entries do), cross-colour, subtract-green and colour
//   indexing (delta-coded palette padded with zeros to 2, 4, 16 or 256
//   entries, pixels bundled at 1, 2 or 4 bits for 16 colours or fewer).
//
// An image stream that ends before its last pixel, or whose last code runs
// past the data, is refused, as libwebp refuses it. The one exception is
// libwebp's: the alpha plane of a lossy image (an ALPH chunk) whose only
// transform is colour indexing and whose red, blue and alpha codes are
// one-symbol codes without a colour cache is decoded byte-wise, and there a
// code that runs past the data is accepted if it completes the plane.
//
// C ABI (ctypes):
//   int akr_vp8l_decode(const uint8_t* data, int64_t size, int32_t width,
//                       int32_t height, int32_t alpha, uint32_t* argb);
//   alpha = 0: ``data`` is a VP8L chunk's payload from its 5-byte header,
//     whose size must be width x height; ``argb`` receives the pixels as
//     0xAARRGGBB.
//   alpha = 1: ``data`` is the headerless image stream of an ALPH chunk at
//     width x height; only whether it decodes is returned (``argb`` may be
//     null).
// Returns 0, 1 for a header that is not a VP8L header of that size, 2 for
// a bitstream libwebp refuses.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kBadHeader = 1, kBadStream = 2 };

constexpr int kNumLiteral = 256;
constexpr int kNumLength = 24;
constexpr int kNumDistance = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kRootBits = 8;        // HUFFMAN_TABLE_BITS
constexpr int kLengthsRootBits = 7;  // LENGTHS_TABLE_BITS
constexpr int kMaxCodeLength = 15;
constexpr uint32_t kHashMul = 0x1e35a7bdu;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, kNumLiteral, kNumLiteral, kNumLiteral,
                              kNumDistance};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

// RFC 9649 section 4.2.2: the (dx, dy) of plane codes 1-120.
const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

// libwebp's VP8LBitReader (slow refill path; the fast path reads the same bits).
struct BitReader {
    uint64_t val = 0;
    const uint8_t* buf = nullptr;
    size_t len = 0, pos = 0;
    int bit_pos = 0;
    bool eos = false;

    void init(const uint8_t* start, size_t length) {
        buf = start;
        len = length;
        val = 0;
        const size_t n = length < 8 ? length : 8;
        for (size_t i = 0; i < n; ++i) val |= uint64_t(start[i]) << (8 * i);
        pos = n;
        bit_pos = 0;
        eos = false;
    }
    uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
    bool end_of_stream() const { return eos || (pos == len && bit_pos > 64); }
    void set_eos() {
        eos = true;
        bit_pos = 0;
    }
    void shift_bytes() {
        while (bit_pos >= 8 && pos < len) {
            val >>= 8;
            val |= uint64_t(buf[pos]) << 56;
            ++pos;
            bit_pos -= 8;
        }
        if (end_of_stream()) set_eos();
    }
    void fill() {
        if (bit_pos >= 32) shift_bytes();
    }
    uint32_t read(int n) {
        if (!eos && n <= 24) {
            const uint32_t v = prefetch() & ((1u << n) - 1);
            bit_pos += n;
            shift_bytes();
            return v;
        }
        set_eos();
        return 0;
    }
};

struct HCode {
    uint8_t bits;    // code length, or root bits plus the second table's bits
    uint16_t value;  // symbol, or the offset of the second table
};
using Table = std::vector<HCode>;

uint32_t next_key(uint32_t key, int len) {
    uint32_t step = 1u << (len - 1);
    while (key & step) step >>= 1;
    return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
    do {
        end -= step;
        table[end] = code;
    } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
    int left = 1 << (len - root_bits);
    while (len < kMaxCodeLength) {
        left -= count[len];
        if (left <= 0) break;
        ++len;
        left <<= 1;
    }
    return len - root_bits;
}

// huffman_utils.c BuildHuffmanTable: false where libwebp returns 0.
bool build_table(const int* lengths, int n, int root_bits, Table* out) {
    int count[kMaxCodeLength + 1] = {0};
    int offset[kMaxCodeLength + 1];
    for (int s = 0; s < n; ++s) {
        if (lengths[s] > kMaxCodeLength) return false;
        ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    offset[1] = 0;
    for (int len = 1; len < kMaxCodeLength; ++len) {
        if (count[len] > (1 << len)) return false;
        offset[len + 1] = offset[len] + count[len];
    }
    std::vector<uint16_t> sorted(n);
    for (int s = 0; s < n; ++s)
        if (lengths[s] > 0) sorted[offset[lengths[s]]++] = uint16_t(s);
    const int root_size = 1 << root_bits;
    Table& t = *out;
    if (offset[kMaxCodeLength] == 1) {  // one symbol: no bits
        t.assign(root_size, HCode{0, sorted[0]});
        return true;
    }
    t.assign(root_size, HCode{0, 0});
    int table = 0, table_bits = root_bits, table_size = root_size;
    uint32_t low = 0xffffffffu, key = 0;
    const uint32_t mask = uint32_t(root_size - 1);
    int num_nodes = 1, num_open = 1, sym = 0;
    int len, step;
    for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
        num_open <<= 1;
        num_nodes += num_open;
        num_open -= count[len];
        if (num_open < 0) return false;
        for (; count[len] > 0; --count[len]) {
            replicate(&t[key], step, table_size, HCode{uint8_t(len), sorted[sym++]});
            key = next_key(key, len);
        }
    }
    for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
        num_open <<= 1;
        num_nodes += num_open;
        num_open -= count[len];
        if (num_open < 0) return false;
        for (; count[len] > 0; --count[len]) {
            if ((key & mask) != low) {
                table += table_size;
                table_bits = next_table_bits(count, len, root_bits);
                table_size = 1 << table_bits;
                t.resize(size_t(table + table_size));
                low = key & mask;
                t[low] = HCode{uint8_t(table_bits + root_bits), uint16_t(table - int(low))};
            }
            replicate(&t[table + (key >> root_bits)], step, table_size,
                      HCode{uint8_t(len - root_bits), sorted[sym++]});
            key = next_key(key, len);
        }
    }
    return num_nodes == 2 * offset[kMaxCodeLength] - 1;
}

int read_symbol(const HCode* table, BitReader& br) {
    uint32_t val = br.prefetch();
    table += val & ((1u << kRootBits) - 1);
    const int nbits = table->bits - kRootBits;
    if (nbits > 0) {
        br.bit_pos += kRootBits;
        val = br.prefetch();
        table += table->value;
        table += val & ((1u << nbits) - 1);
    }
    br.bit_pos += table->bits;
    return table->value;
}

struct Group {
    Table codes[5];
};

struct Meta {
    int bits = 0;                 // prefix-image subsampling, 0 for one group
    int xsize = 0;                // prefix image width
    std::vector<uint32_t> image;  // group index per block (into ``groups``)
    std::vector<Group> groups;
    int cache_bits = 0;
    bool all_rba_single = true;  // over the groups libwebp keeps
};

struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
};

uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
    const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                            sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                            sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                            sub3(a & 0xff, b & 0xff, c & 0xff);
    return pa_minus_pb <= 0 ? a : b;
}

uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) - int((c2 >> s) & 0xff);
        out |= clip255(uint32_t(v)) << s;
    }
    return out;
}

uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
        out |= clip255(uint32_t(a + (a - b) / 2)) << s;
    }
    return out;
}

// left = the decoded pixel before, top = the decoded pixel above (top[-1],
// top[1] its neighbours; top[1] of a row's last pixel is the row's first).
uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
    switch (mode) {
        case 1: return left;
        case 2: return top[0];
        case 3: return top[1];
        case 4: return top[-1];
        case 5: return average2(average2(left, top[1]), top[0]);
        case 6: return average2(left, top[-1]);
        case 7: return average2(left, top[0]);
        case 8: return average2(top[-1], top[0]);
        case 9: return average2(top[0], top[1]);
        case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
        case 11: return select(top[0], left, top[-1]);
        case 12: return add_sub_full(left, top[0], top[-1]);
        case 13: return add_sub_half(left, top[0], top[-1]);
        default: return 0xff000000u;  // 0, and libwebp's padding entries 14 and 15
    }
}

int delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class Decoder {
  public:
    Decoder(const uint8_t* data, size_t size) { br_.init(data, size); }

    // A level-0 stream of xsize x ysize: transforms, cache, codes, then the
    // pixels. ``argb`` (xsize x ysize) receives them unless null.
    int decode(int xsize, int ysize, bool alpha, uint32_t* argb) {
        int width = xsize;  // narrowed by a bundling colour-indexing transform
        while (br_.read(1)) {
            if (!read_transform(&width, ysize)) return kBadStream;
        }
        Meta meta;
        if (!read_header(width, ysize, true, &meta)) return kBadStream;
        const bool bytewise = alpha && transforms_.size() == 1 &&
                              transforms_[0].type == COLOR_INDEXING && meta.cache_bits == 0 &&
                              meta.all_rba_single;
        if (bytewise) return decode_alpha_bytes(width, ysize, meta) ? kOk : kBadStream;
        std::vector<uint32_t> px(size_t(width) * ysize);
        if (!decode_pixels(width, ysize, meta, px.data())) return kBadStream;
        if (argb == nullptr) return kOk;
        for (size_t n = transforms_.size(); n-- > 0;) px = inverse(transforms_[n], px);
        std::memcpy(argb, px.data(), px.size() * sizeof(uint32_t));
        return kOk;
    }

    BitReader br_;

  private:
    std::vector<Transform> transforms_;
    unsigned seen_ = 0;

    bool read_transform(int* xsize, int ysize) {
        const int type = int(br_.read(2));
        if (seen_ & (1u << type)) return false;
        seen_ |= 1u << type;
        Transform t{type, 0, *xsize, ysize, {}};
        if (type == PREDICTOR || type == CROSS_COLOR) {
            t.bits = 2 + int(br_.read(3));
            if (!sub_image(subsample(t.xsize, t.bits), subsample(ysize, t.bits), &t.data))
                return false;
        } else if (type == COLOR_INDEXING) {
            const int num_colors = int(br_.read(8)) + 1;
            t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
            *xsize = subsample(t.xsize, t.bits);
            std::vector<uint32_t> pal;
            if (!sub_image(num_colors, 1, &pal)) return false;
            t.data.assign(size_t(1) << (8 >> t.bits), 0u);  // transparent black past the end
            auto* out = reinterpret_cast<uint8_t*>(t.data.data());
            const auto* in = reinterpret_cast<const uint8_t*>(pal.data());
            std::memcpy(out, in, 4);
            for (int i = 4; i < 4 * num_colors; ++i) out[i] = uint8_t(in[i] + out[i - 4]);
        }
        transforms_.push_back(std::move(t));
        return true;
    }

    bool sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
        Meta meta;
        if (!read_header(xsize, ysize, false, &meta)) return false;
        out->assign(size_t(xsize) * ysize, 0u);
        return decode_pixels(xsize, ysize, meta, out->data()) && !br_.eos;
    }

    // The colour cache bits and the prefix codes (ReadHuffmanCodes).
    bool read_header(int xsize, int ysize, bool level0, Meta* meta) {
        if (br_.read(1)) {
            meta->cache_bits = int(br_.read(4));
            if (meta->cache_bits < 1 || meta->cache_bits > kMaxCacheBits) return false;
        }
        int num_groups = 1;
        std::vector<int> mapping;  // group as coded -> index in meta->groups, -1 unused
        if (level0 && br_.read(1)) {
            meta->bits = 2 + int(br_.read(3));
            meta->xsize = subsample(xsize, meta->bits);
            const int ys = subsample(ysize, meta->bits);
            std::vector<uint32_t> img;
            if (!sub_image(meta->xsize, ys, &img)) return false;
            for (auto& v : img) {
                v = (v >> 8) & 0xffff;
                if (int(v) >= num_groups) num_groups = int(v) + 1;
            }
            mapping.assign(size_t(num_groups), -1);
            for (auto v : img) mapping[v] = 0;
            int used = 0;
            for (auto& m : mapping)
                if (m == 0) m = used++;
            for (auto& v : img) v = uint32_t(mapping[v]);
            meta->image = std::move(img);
            meta->groups.resize(size_t(used));
        } else {
            mapping.assign(1, 0);
            meta->groups.resize(1);
        }
        if (br_.eos) return false;
        // libwebp keeps every group unless there are more than 1000 or more
        // than pixels; whether the alpha plane decodes byte-wise looks at
        // the groups it keeps.
        const bool keeps_all = !(num_groups > 1000 || int64_t(num_groups) > int64_t(xsize) * ysize);
        const int max_alphabet = kAlphabet[0] + (meta->cache_bits ? 1 << meta->cache_bits : 0);
        std::vector<int> lengths(size_t(max_alphabet > 256 ? max_alphabet : 256), 0);
        for (int g = 0; g < num_groups; ++g) {
            Group* grp = mapping[g] >= 0 ? &meta->groups[size_t(mapping[g])] : nullptr;
            bool rba_single = true;
            for (int j = 0; j < 5; ++j) {
                int alphabet = kAlphabet[j];
                if (j == 0 && meta->cache_bits) alphabet += 1 << meta->cache_bits;
                Table t;
                if (!read_code(alphabet, lengths.data(), &t)) return false;
                if (j == RED || j == BLUE || j == ALPHA) rba_single &= t[0].bits == 0;
                if (grp) grp->codes[j] = std::move(t);
            }
            if (grp || keeps_all) meta->all_rba_single &= rba_single;
        }
        return true;
    }

    bool read_code(int alphabet, int* lengths, Table* table) {
        std::memset(lengths, 0, sizeof(int) * size_t(alphabet));
        bool ok;
        if (br_.read(1)) {  // simple code
            const int num_symbols = int(br_.read(1)) + 1;
            const int first_bits = br_.read(1) ? 8 : 1;
            lengths[br_.read(first_bits)] = 1;
            if (num_symbols == 2) lengths[br_.read(8)] = 1;
            ok = true;
        } else {
            int cl_lengths[19] = {0};
            const int num_codes = int(br_.read(4)) + 4;
            for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = int(br_.read(3));
            ok = read_code_lengths(cl_lengths, alphabet, lengths);
        }
        return ok && !br_.eos && build_table(lengths, alphabet, kRootBits, table);
    }

    bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
        Table t;
        if (!build_table(cl_lengths, 19, kLengthsRootBits, &t)) return false;
        int max_symbol;
        if (br_.read(1)) {
            const int nbits = 2 + 2 * int(br_.read(3));
            max_symbol = 2 + int(br_.read(nbits));
            if (max_symbol > num_symbols) return false;
        } else {
            max_symbol = num_symbols;
        }
        int prev = 8;
        for (int symbol = 0; symbol < num_symbols;) {
            if (max_symbol-- == 0) break;
            br_.fill();
            const HCode& p = t[br_.prefetch() & ((1u << kLengthsRootBits) - 1)];
            br_.bit_pos += p.bits;
            const int code_len = p.value;
            if (code_len < 16) {
                lengths[symbol++] = code_len;
                if (code_len != 0) prev = code_len;
            } else {
                const int slot = code_len - 16;
                static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
                int repeat = int(br_.read(kExtra[slot])) + kOffset[slot];
                if (symbol + repeat > num_symbols) return false;
                const int v = code_len == 16 ? prev : 0;
                while (repeat-- > 0) lengths[symbol++] = v;
            }
        }
        return true;
    }

    int copy_value(int symbol) {  // GetCopyDistance / GetCopyLength
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra;
        return offset + int(br_.read(extra)) + 1;
    }

    static int plane_distance(int xsize, int code) {
        if (code > 120) return code - 120;
        const int dist = kPlane[code - 1][1] * xsize + kPlane[code - 1][0];
        return dist >= 1 ? dist : 1;
    }

    static const Group& group_at(const Meta& m, int x, int y) {
        if (m.bits == 0) return m.groups[0];
        return m.groups[m.image[size_t(m.xsize) * (y >> m.bits) + (x >> m.bits)]];
    }

    // DecodeImageData: every code that runs past the data is refused.
    bool decode_pixels(int width, int height, const Meta& m, uint32_t* data) {
        const int64_t end = int64_t(width) * height;
        const int cache_size = m.cache_bits ? 1 << m.cache_bits : 0;
        std::vector<uint32_t> cache(size_t(cache_size), 0u);
        const int shift = 32 - m.cache_bits;
        const int mask = m.bits ? (1 << m.bits) - 1 : ~0;
        int64_t pos = 0, cached = 0;
        int col = 0, row = 0;
        const Group* g = end > 0 ? &group_at(m, 0, 0) : nullptr;
        auto insert = [&]() {
            if (cache_size)
                for (; cached < pos; ++cached) cache[(data[cached] * kHashMul) >> shift] = data[cached];
        };
        while (pos < end) {
            if ((col & mask) == 0) g = &group_at(m, col, row);
            br_.fill();
            const int code = read_symbol(g->codes[GREEN].data(), br_);
            if (br_.end_of_stream()) break;
            if (code < kNumLiteral) {
                const int red = read_symbol(g->codes[RED].data(), br_);
                br_.fill();
                const int blue = read_symbol(g->codes[BLUE].data(), br_);
                const int alpha = read_symbol(g->codes[ALPHA].data(), br_);
                if (br_.end_of_stream()) break;
                data[pos++] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                              (uint32_t(code) << 8) | uint32_t(blue);
                if (++col >= width) {
                    col = 0;
                    ++row;
                }
            } else if (code < kNumLiteral + kNumLength) {
                const int length = copy_value(code - kNumLiteral);
                const int dist_symbol = read_symbol(g->codes[DIST].data(), br_);
                br_.fill();
                const int dist = plane_distance(width, copy_value(dist_symbol));
                if (br_.end_of_stream()) break;
                if (pos < dist || end - pos < length) return false;
                for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
                col += length;
                while (col >= width) {
                    col -= width;
                    ++row;
                }
                if (col & mask) g = &group_at(m, col, row);
            } else if (code < kNumLiteral + kNumLength + cache_size) {
                insert();
                data[pos++] = cache[size_t(code - kNumLiteral - kNumLength)];
                if (++col >= width) {
                    col = 0;
                    ++row;
                }
            } else {
                return false;
            }
            insert();
        }
        br_.eos = br_.end_of_stream();
        return !br_.eos;
    }

    // DecodeAlphaData: green codes only, no cache; a code that runs past the
    // data still counts if the plane is then complete.
    bool decode_alpha_bytes(int width, int height, const Meta& m) {
        const int64_t end = int64_t(width) * height;
        const int mask = m.bits ? (1 << m.bits) - 1 : ~0;
        int64_t pos = 0;
        int col = 0, row = 0;
        const Group* g = end > 0 ? &group_at(m, 0, 0) : nullptr;
        while (!br_.eos && pos < end) {
            if ((col & mask) == 0) g = &group_at(m, col, row);
            br_.fill();
            const int code = read_symbol(g->codes[GREEN].data(), br_);
            if (code < kNumLiteral) {
                ++pos;
                if (++col >= width) {
                    col = 0;
                    ++row;
                }
            } else if (code < kNumLiteral + kNumLength) {
                const int length = copy_value(code - kNumLiteral);
                const int dist_symbol = read_symbol(g->codes[DIST].data(), br_);
                br_.fill();
                const int dist = plane_distance(width, copy_value(dist_symbol));
                if (!(pos >= dist && end - pos >= length)) return false;
                pos += length;
                col += length;
                while (col >= width) {
                    col -= width;
                    ++row;
                }
                if (pos < end && (col & mask)) g = &group_at(m, col, row);
            } else {
                return false;
            }
            br_.eos = br_.end_of_stream();
        }
        br_.eos = br_.end_of_stream();
        return !(br_.eos && pos < end);
    }

    static std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in) {
        const int w = t.xsize, h = t.ysize;
        if (t.type == SUBTRACT_GREEN) {
            for (auto& p : in) {
                const uint32_t gg = (p >> 8) & 0xff;
                p = (p & 0xff00ff00u) | ((((p >> 16) + gg) & 0xff) << 16) | ((p + gg) & 0xff);
            }
            return std::move(in);
        }
        if (t.type == PREDICTOR) {
            uint32_t* px = in.data();
            const int tiles = subsample(w, t.bits);
            px[0] = add_pixels(px[0], 0xff000000u);
            for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
            for (int y = 1; y < h; ++y) {
                uint32_t* row = px + size_t(y) * w;
                const uint32_t* top = row - w;
                const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
                row[0] = add_pixels(row[0], top[0]);
                for (int x = 1; x < w; ++x) {
                    const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
                    row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
                }
            }
            return std::move(in);
        }
        if (t.type == CROSS_COLOR) {
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < h; ++y) {
                uint32_t* row = in.data() + size_t(y) * w;
                const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
                for (int x = 0; x < w; ++x) {
                    const uint32_t c = codes[x >> t.bits];
                    const int8_t g2r = int8_t(c & 0xff), g2b = int8_t((c >> 8) & 0xff),
                                 r2b = int8_t((c >> 16) & 0xff);
                    const uint32_t argb = row[x];
                    const int8_t green = int8_t(argb >> 8);
                    int red = int((argb >> 16) & 0xff) + delta(g2r, green);
                    red &= 0xff;
                    int blue = int(argb & 0xff) + delta(g2b, green) + delta(r2b, int8_t(red));
                    blue &= 0xff;
                    row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
                }
            }
            return std::move(in);
        }
        // colour indexing: packed indices (in green) -> palette entries
        const int in_w = subsample(w, t.bits);
        const int bits_per_pixel = 8 >> t.bits;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int count_mask = (1 << t.bits) - 1;
        std::vector<uint32_t> out(size_t(w) * h);
        for (int y = 0; y < h; ++y) {
            const uint32_t* src = in.data() + size_t(y) * in_w;
            uint32_t* dst = out.data() + size_t(y) * w;
            uint32_t packed = 0;
            for (int x = 0; x < w; ++x) {
                if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
                dst[x] = t.data[packed & bit_mask];
                packed >>= bits_per_pixel;
            }
        }
        return out;
    }
};

}  // namespace

extern "C" int akr_vp8l_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                               int32_t alpha, uint32_t* argb) {
    if (width <= 0 || height <= 0 || size < 0) return kBadHeader;
    Decoder dec(data, size_t(size));
    if (!alpha) {  // ReadImageInfo
        BitReader& br = dec.br_;
        if (size < 5 || br.read(8) != 0x2f) return kBadHeader;
        const int w = int(br.read(14)) + 1, h = int(br.read(14)) + 1;
        br.read(1);  // alpha hint
        if (br.read(3) != 0 || br.eos || w != width || h != height) return kBadHeader;
    }
    return dec.decode(width, height, alpha != 0, alpha ? nullptr : argb);
}
