// LZW decoding of one GIF frame for akari_torch/core/image_formats.py.
//
// The decoder follows PIL's GifDecode.c, which the JAX package reads GIFs
// through: data sub-blocks are read as they come (a zero-length block is
// skipped and the next byte read as another block length), codes are
// taken least significant bit first, a clear code restarts the table, the
// code size grows when the next free entry reaches the code mask and stops
// at 12 bits, a full table (4,096 entries) takes no more entries, a code
// equal to the next free entry repeats the last string's first byte, and
// decoding ends as soon as the frame's last row is written. Rows follow
// the four interlace passes when the frame is interlaced.
//
// PIL feeds the decoder the file from ``start`` in reads of ``chunk``
// bytes (ImageFile.MAXBLOCK), one more each time the decoder stops for
// data: a sub-block is started only once it is wholly read, and an end
// code before the frame is full stops the decoder too, after which PIL
// reads on and the decoding goes on past the end code. When no read is
// left, PIL finds the file truncated.
//
// C ABI (ctypes):
//   int akr_gif_lzw(const uint8_t* data, int64_t size, int64_t start,
//                   int64_t chunk, int32_t bits, int32_t xsize,
//                   int32_t ysize, int32_t interlace, uint8_t* frame);
//   start: the first sub-block length byte after the LZW minimum code
//     size ``bits``; frame: [ysize, xsize] indices, written in place.
// Returns 0 when the frame is full, 1 when PIL would find the file
// truncated, 2 on a code PIL's decoder rejects.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>

namespace {

constexpr int kTable = 4096;   // GIFTABLE
constexpr int kBuffer = 4096;  // GIFBUFFER
constexpr int kMaxBits = 12;   // GIFBITS

enum { kDone = 0, kTruncated = 1, kBroken = 2 };

}  // namespace

extern "C" int akr_gif_lzw(const uint8_t* data, int64_t size, int64_t start, int64_t chunk,
                           int32_t bits, int32_t xsize, int32_t ysize, int32_t interlace,
                           uint8_t* frame) {
    if (bits < 0 || bits > kMaxBits || xsize <= 0 || ysize <= 0 || chunk <= 0) return kBroken;
    static thread_local uint8_t table_data[kTable];
    static thread_local uint16_t table_link[kTable];
    static thread_local uint8_t buffer[kBuffer];

    const int clear = 1 << bits, end = clear + 1;
    int next = 0, codesize = 0, codemask = 0;
    int lastcode = 0;
    uint8_t lastdata = 0;
    int bufferindex = kBuffer;
    uint32_t bitbuffer = 0;
    int bitcount = 0, blocksize = 0;
    int64_t pos = start;
    int state = 1;  // 1: (re)start the table, 2: after a clear, 3: decoding

    // bytes PIL has read so far end at ``avail``; one more read of ``chunk``
    // bytes, or false when the file has no more
    int64_t avail = start;
    auto read_more = [&]() -> bool {
        if (avail >= size) return false;
        avail = avail + chunk < size ? avail + chunk : size;
        return true;
    };
    if (!read_more()) return kTruncated;

    int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
    uint8_t* out = frame;

    // next row; false once the frame is full (PIL's NEWLINE macro)
    auto newline = [&]() -> bool {
        x = 0;
        y += step;
        while (y >= ysize) {
            switch (pass) {
                case 1: y = 4; pass = 2; break;
                case 2: step = 4; y = 2; pass = 3; break;
                case 3: step = 2; y = 1; pass = 0; break;
                default: return false;
            }
        }
        out = frame + static_cast<int64_t>(y) * xsize;
        return true;
    };

    for (;;) {
        if (state == 1) {
            next = clear + 2;
            codesize = bits + 1;
            codemask = (1 << codesize) - 1;
            bufferindex = kBuffer;
            state = 2;
        }
        const uint8_t* p;
        int n;
        if (bufferindex < kBuffer) {
            n = kBuffer - bufferindex;
            p = buffer + bufferindex;
            bufferindex = kBuffer;
        } else {
            while (bitcount < codesize) {
                if (blocksize > 0) {  // inside a sub-block read whole
                    bitbuffer |= static_cast<uint32_t>(data[pos++]) << bitcount;
                    bitcount += 8;
                    --blocksize;
                } else {
                    while (pos >= avail || avail - pos < data[pos] + 1) {
                        if (!read_more()) return kTruncated;
                    }
                    blocksize = data[pos++];
                }
            }
            int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
            bitbuffer >>= codesize;
            bitcount -= codesize;
            if (c == clear) {
                if (state != 2) state = 1;
                continue;
            }
            if (c == end) {
                if (!read_more()) return kTruncated;
                continue;
            }
            n = 1;
            p = &lastdata;
            if (state == 2) {
                if (c > clear) return kBroken;
                lastdata = static_cast<uint8_t>(c);
                lastcode = c;
                state = 3;
            } else {
                const int thiscode = c;
                if (c > next) return kBroken;
                if (c == next) {
                    if (bufferindex <= 0) return kBroken;
                    buffer[--bufferindex] = lastdata;
                    c = lastcode;
                }
                while (c >= clear) {
                    if (bufferindex <= 0 || c >= kTable) return kBroken;
                    buffer[--bufferindex] = table_data[c];
                    c = table_link[c];
                }
                lastdata = static_cast<uint8_t>(c);
                if (next < kTable) {
                    table_data[next] = static_cast<uint8_t>(c);
                    table_link[next] = static_cast<uint16_t>(lastcode);
                    if (next == codemask && codesize < kMaxBits) {
                        ++codesize;
                        codemask = (1 << codesize) - 1;
                    }
                    ++next;
                }
                lastcode = thiscode;
            }
        }
        for (int i = 0; i < n; ++i) {
            out[x] = p[i];
            if (++x >= xsize && !newline()) return kDone;
        }
    }
}
