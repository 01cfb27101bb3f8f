// The run-length decoders of SGI and PCX images, for akari_torch/core/sgi.py
// and akari_torch/core/pcx.py.
//
// The JAX package reads textures through PIL; these follow its C decoders
// step for step, faults included, so that a file decodes (or fails) here
// exactly as there.
//
// akr_sgi_rle (SgiRleDecode.c): ``buf`` is the file after its 512-byte
// header, the start and length tables first (4 bytes big-endian each,
// channel-major). Row y (bottom-up) of channel c starts at table entry
// y + c * ysize, an offset from the start of the file; its length counts
// the packets to read at most. A packet's low 7 bits count the samples
// (1 or 2 bytes each, the 16-bit count's low byte the one read), the high
// bit marks a copy, else one sample repeated; a count of 0 ends the row;
// a nonzero packet as the last one allowed stops the whole decode (the rows
// not yet stored stay zero). A row that would pass ``xsize`` samples, or
// read at or past the last byte of the buffer, is an overrun. The row
// buffer is shared by every row and channel and never cleared, so a row
// that ends early keeps the samples of the row before.
//
// akr_pcx_rle (PcxDecode.c): a byte with its top two bits set is a run of
// its low six bits' count of the next byte, any other byte a literal; a
// line holds ``line`` bytes (planes x stride). A run that passes the
// line's end is cut there and flags an overrun (PIL raises at the end),
// and the data ending before the last line is a truncated file. Each full
// line has its planes moved as PIL moves them before unpacking: for 2 or
// 4 planes of 1 bit (``bits`` 2 or 4) to ceil(xsize / 8) bytes apart, else
// to ``xsize`` apart when the line over ``xsize`` makes more than one plane
// of more than ``xsize`` bytes.
//
// C ABI (ctypes):
//   int akr_sgi_rle(const uint8_t* buf, int64_t size, int32_t xsize,
//                   int32_t ysize, int32_t zsize, int32_t bpc, uint8_t* out);
//     out: ysize x (xsize * zsize * bpc) bytes, top row first, zeroed by
//     the caller; returns 0, or 1 on an overrun.
//   int akr_pcx_rle(const uint8_t* src, int64_t size, int32_t xsize,
//                   int32_t bits, int32_t line, int32_t ysize, uint8_t* out);
//     out: ysize x line bytes; returns 0, 1 when the data ends first, 2 on
//     an overrun.
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

// expandrow / expandrow2: 0 when the row ends, 1 to stop decoding, -1 on an
// overrun. ``end`` is the index of the buffer's last byte.
int expand_row(uint8_t* dest, const uint8_t* buf, int64_t src, int32_t n, int z, int bpc,
               int xsize, int64_t end) {
    int x = 0;
    for (; n > 0; n--) {
        uint8_t pixel;
        if (bpc == 1) {
            if (src > end) return -1;
            pixel = buf[src++];
        } else {
            if (src + 1 > end) return -1;
            pixel = buf[src + 1];
            src += 2;
        }
        if (n == 1 && pixel != 0) return 1;
        int count = pixel & 0x7F;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (src + int64_t(bpc) * count > end) return -1;
            while (count--) {
                std::memcpy(dest, buf + src, bpc);
                src += bpc;
                dest += z * bpc;
            }
        } else {
            if (src + (bpc == 1 ? 0 : 2) > end) return -1;
            while (count--) {
                std::memcpy(dest, buf + src, bpc);
                dest += z * bpc;
            }
            src += bpc;
        }
    }
    return 0;
}

}  // namespace

extern "C" int akr_sgi_rle(const uint8_t* buf, int64_t size, int32_t xsize, int32_t ysize,
                           int32_t zsize, int32_t bpc, uint8_t* out) {
    const int64_t tablen = int64_t(zsize) * ysize;
    if (size < 8 * tablen) return 1;
    const int64_t row_bytes = int64_t(xsize) * zsize * bpc;
    std::vector<uint8_t> row(row_bytes, 0);
    for (int64_t y = 0; y < ysize; ++y) {
        for (int c = 0; c < zsize; ++c) {
            const int64_t k = y + int64_t(c) * ysize;
            uint32_t start = be32(buf + 4 * k);
            const uint32_t length = be32(buf + 4 * tablen + 4 * k);
            if (start < 512) return 1;
            start -= 512;
            // PIL passes the unsigned length as an int: one past INT_MAX reads no packet
            const int status = expand_row(row.data() + int64_t(c) * bpc, buf, start,
                                          static_cast<int32_t>(length), zsize, bpc, xsize,
                                          size - 1);
            if (status == -1) return 1;
            if (status == 1) return 0;
        }
        std::memcpy(out + (ysize - 1 - y) * row_bytes, row.data(), row_bytes);
    }
    return 0;
}

extern "C" int akr_pcx_rle(const uint8_t* src, int64_t size, int32_t xsize, int32_t bits,
                           int32_t line, int32_t ysize, uint8_t* out) {
    std::vector<uint8_t> buf(line, 0);
    int64_t p = 0;
    int x = 0, y = 0;
    bool overrun = false;
    int plane = xsize, bands = 0, stride = 0;
    if (bits == 2 || bits == 4) {
        plane = (xsize + 7) / 8;
        bands = bits;
        stride = line / bits;
    } else {
        bands = line / xsize;
        if (bands) stride = line / bands;
    }
    for (;;) {
        if (p >= size) return 1;
        if ((src[p] & 0xC0) == 0xC0) {
            if (size - p < 2) return 1;
            int n = src[p] & 0x3F;
            while (n > 0) {
                if (x >= line) {
                    overrun = true;
                    break;
                }
                buf[x++] = src[p + 1];
                n--;
            }
            p += 2;
        } else {
            buf[x++] = src[p++];
        }
        if (x >= line) {
            if (stride > plane) {
                for (int i = 1; i < bands; ++i)
                    std::memmove(&buf[int64_t(i) * plane], &buf[int64_t(i) * stride], plane);
            }
            std::memcpy(out + int64_t(y) * line, buf.data(), line);
            x = 0;
            if (++y >= ysize) return overrun ? 2 : 0;
        }
    }
}
