// The run-length decoders of SGI and PCX images and of ThunderScan TIFF
// strips, for akari_torch/core/sgi.py, akari_torch/core/pcx.py and
// akari_torch/core/tiff.py.
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
// akr_thunder (libtiff 4.7.1's tif_thunder.c, through which PIL reads
// compression 32809): 4-bit pixels, two a byte, high nibble first; each
// row starts from a last pixel of 0 and reads on from where the row before
// stopped. A byte's top two bits choose: 00 a run of its low six bits'
// count of the last pixel; 01 three 2-bit deltas (0, +1, skip, -1); 10 two
// 3-bit deltas (0, +1, +2, +3, skip, -3, -2, -1); 11 a raw pixel (the low
// four bits). Deltas wrap in four bits; pixels past the row's width are
// dropped, except that a run that passes it writes nothing and leaves the
// row over-full ("Too much data"), and a row the data ends in is "Not
// enough data": both fail the strip. The byte handling of runs follows
// libtiff's, odd starts and runs of 0 included.
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
//   int akr_thunder(const uint8_t* src, int64_t size, int32_t width,
//                   int32_t rows, int32_t rowbytes, uint8_t* out);
//     out: rows x rowbytes bytes; returns 0, 1 when the data ends in a row
//     (libtiff: not enough data), 2 when a run overfills one (too much).
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

extern "C" int akr_thunder(const uint8_t* src, int64_t size, int32_t width, int32_t rows,
                           int32_t rowbytes, uint8_t* out) {
    static const int two[4] = {0, 1, 0, -1};
    static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    int64_t pos = 0;
    const int64_t maxpixels = width;
    for (int32_t y = 0; y < rows; y++) {
        uint8_t* op = out + int64_t(y) * rowbytes;
        unsigned lastpixel = 0;
        int64_t npixels = 0;
        auto set = [&](unsigned v) {  // SETPIXEL
            lastpixel = v & 0xf;
            if (npixels < maxpixels) {
                if (npixels++ & 1) *op++ |= uint8_t(lastpixel);
                else op[0] = uint8_t(lastpixel << 4);
            }
        };
        while (pos < size && npixels < maxpixels) {
            int n = src[pos++], delta;
            switch (n & 0xc0) {
                case 0x00:  // a run of the last pixel
                    if (npixels & 1) {
                        op[0] |= uint8_t(lastpixel);
                        lastpixel = *op++;
                        npixels++;
                        n--;
                    } else {
                        lastpixel |= lastpixel << 4;
                    }
                    npixels += n;
                    if (npixels <= maxpixels)
                        for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
                    if (n == -1) *--op &= 0xf0;
                    lastpixel &= 0xf;
                    break;
                case 0x40:  // three 2-bit deltas, 2 a skip
                    if ((delta = (n >> 4) & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
                    if ((delta = (n >> 2) & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
                    if ((delta = n & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
                    break;
                case 0x80:  // two 3-bit deltas, 4 a skip
                    if ((delta = (n >> 3) & 7) != 4) set(unsigned(int(lastpixel) + three[delta]));
                    if ((delta = n & 7) != 4) set(unsigned(int(lastpixel) + three[delta]));
                    break;
                default:  // a raw pixel
                    set(unsigned(n));
                    break;
            }
        }
        if (npixels != maxpixels) return npixels < maxpixels ? 1 : 2;
    }
    return 0;
}
