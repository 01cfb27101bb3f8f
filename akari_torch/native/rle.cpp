// The run-length decoders of SGI, PCX, Sun raster and FLI / FLC images and
// of ThunderScan TIFF strips, for akari_torch/core/sgi.py, pcx.py, sun.py,
// fli.py and tiff.py.
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
// akr_sun_rle (SunRleDecode.c): 0x80 0x00 is one 0x80 byte, 0x80 n v
// (n > 0) n + 1 bytes v, any other byte itself. The stream is the image's
// rows back to back, each (depth * width + 7) / 8 bytes: the 16-bit row
// padding of raw Sun rasters is not skipped, and a run continues across
// rows. Decoding stops when the image is full; data that ends before is a
// truncated file.
//
// akr_fli_frame (FliDecode.c): one call of PIL's decoder on ``buf``, the
// bytes ImageFile.load has read from the frame's offset so far, into the
// frame buffer ``im`` (ysize x xsize indices, kept between calls). Fewer
// than 4 bytes, or fewer than the frame size (rounded up to even), return
// 0 (PIL reads more). Otherwise the frame chunk (type 0xF1FA) is walked
// subchunk by subchunk, each one needing 10 bytes left: colour (4, 11)
// and stamp (18) chunks are skipped, black (13) clears the buffer, COPY
// (16) copies xsize * ysize bytes (or returns the bytes before its chunk
// when the buffer holds fewer), BRUN (15) runs every line (packet count
// byte ignored; a count with its top bit set copies 256 - count bytes,
// else repeats the next byte; a packet that passes the line's end stops
// it, and a line not filled exactly is an overrun), LC (12) and SS2 (7)
// patch lines (a packet past the line's end stops the chunk's lines; lines
// left over are an overrun; SS2's flag words skip lines or set a line's
// last byte). Every read is bounded by the end of the buffer, not of the
// subchunk; a subchunk size of 0 is a broken stream, one past the buffer
// an overrun. Sizes are unsigned 32-bit.
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
//   int akr_sun_rle(const uint8_t* src, int64_t size, int64_t total,
//                   uint8_t* out);
//     out: ``total`` bytes (the rows back to back); returns 0, or 1 when the
//     data ends first.
//   int64_t akr_fli_frame(const uint8_t* buf, int64_t bytes, int32_t xsize,
//                         int32_t ysize, uint8_t* im);
//     returns -1 at the end of the frame, the bytes consumed (>= 0) where
//     PIL reads more, or -2 (overrun), -3 (unrecognised data), -4 (broken
//     stream).
//     out: rows x rowbytes bytes; returns 0, 1 when the data ends in a row
//     (libtiff: not enough data), 2 when a run overfills one (too much).
//
// Build: akari_torch/native/loader.py (g++ -O3 -shared -fPIC -std=c++17).

#include <climits>
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

extern "C" int akr_sun_rle(const uint8_t* src, int64_t size, int64_t total, uint8_t* out) {
    int64_t p = 0, x = 0;
    while (x < total) {
        if (p >= size) return 1;
        if (src[p] == 0x80) {
            if (size - p < 2) return 1;
            if (src[p + 1] == 0) {
                out[x++] = 0x80;
                p += 2;
            } else {
                if (size - p < 3) return 1;
                int64_t n = int64_t(src[p + 1]) + 1;
                if (n > total - x) n = total - x;
                std::memset(out + x, src[p + 2], size_t(n));
                x += n;
                p += 3;
            }
        } else {
            out[x++] = src[p++];
        }
    }
    return 0;
}

namespace {

inline int fli16(const uint8_t* p) { return p[0] + (int(p[1]) << 8); }

inline int64_t fli32(const uint8_t* p) {
    return int64_t(uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
                   (uint32_t(p[3]) << 24));
}

}  // namespace

extern "C" int64_t akr_fli_frame(const uint8_t* buf, int64_t bytes, int32_t xsize, int32_t ysize,
                                 uint8_t* im) {
    const int64_t OVERRUN = -2, UNKNOWN = -3, BROKEN = -4;
    if (bytes < 4) return 0;
    const uint8_t* ptr = buf;
    int64_t framesize = fli32(ptr);
    if (bytes + (bytes % 2) < framesize) return 0;
    if (bytes < 8) return OVERRUN;
    if (fli16(ptr + 4) != 0xF1FA) return UNKNOWN;
    int chunks = fli16(ptr + 6);
    ptr += 16;
    bytes -= 16;
#define FLI_OOB(off) \
    if ((data + (off)) > ptr + bytes) return OVERRUN;
    for (int c = 0; c < chunks; c++) {
        if (bytes < 10) return OVERRUN;
        const uint8_t* data = ptr + 6;
        int x = 0, y, i = 0;
        switch (fli16(ptr + 4)) {
            case 4:
            case 11:
            case 18:
                break;
            case 7: {  // SS2, word delta
                int lines = fli16(data), l;
                data += 2;
                for (l = y = 0; l < lines && y < ysize; l++, y++) {
                    uint8_t* line = im + int64_t(y) * xsize;
                    FLI_OOB(2)
                    int packets = fli16(data), p;
                    data += 2;
                    while (packets & 0x8000) {
                        if (packets & 0x4000) {
                            y += 65536 - packets;
                            if (y >= ysize) return OVERRUN;
                            line = im + int64_t(y) * xsize;
                        } else {
                            line[xsize - 1] = uint8_t(packets);
                        }
                        FLI_OOB(2)
                        packets = fli16(data);
                        data += 2;
                    }
                    for (p = x = 0; p < packets; p++) {
                        FLI_OOB(2)
                        x += data[0];
                        if (data[1] >= 128) {
                            FLI_OOB(4)
                            i = 256 - data[1];
                            if (x + i + i > xsize) break;
                            for (int j = 0; j < i; j++) {
                                line[x++] = data[2];
                                line[x++] = data[3];
                            }
                            data += 4;
                        } else {
                            i = 2 * int(data[1]);
                            if (x + i > xsize) break;
                            FLI_OOB(2 + i)
                            std::memcpy(line + x, data + 2, size_t(i));
                            data += 2 + i;
                            x += i;
                        }
                    }
                    if (p < packets) break;
                }
                if (l < lines) return OVERRUN;
                break;
            }
            case 12: {  // LC, byte delta
                y = fli16(data);
                int ymax = y + fli16(data + 2);
                data += 4;
                for (; y < ymax && y < ysize; y++) {
                    uint8_t* out = im + int64_t(y) * xsize;
                    FLI_OOB(1)
                    int packets = *data++, p;
                    for (p = x = 0; p < packets; p++, x += i) {
                        FLI_OOB(2)
                        x += data[0];
                        if (data[1] & 0x80) {
                            i = 256 - data[1];
                            if (x + i > xsize) break;
                            FLI_OOB(3)
                            std::memset(out + x, data[2], size_t(i));
                            data += 3;
                        } else {
                            i = data[1];
                            if (x + i > xsize) break;
                            FLI_OOB(2 + i)
                            std::memcpy(out + x, data + 2, size_t(i));
                            data += i + 2;
                        }
                    }
                    if (p < packets) break;
                }
                if (y < ymax) return OVERRUN;
                break;
            }
            case 13:  // BLACK
                std::memset(im, 0, size_t(int64_t(xsize) * ysize));
                break;
            case 15:  // BRUN
                for (y = 0; y < ysize; y++) {
                    uint8_t* out = im + int64_t(y) * xsize;
                    data += 1;
                    for (x = 0; x < xsize; x += i) {
                        FLI_OOB(2)
                        if (data[0] & 0x80) {
                            i = 256 - data[0];
                            if (x + i > xsize) break;
                            FLI_OOB(i + 1)
                            std::memcpy(out + x, data + 1, size_t(i));
                            data += i + 1;
                        } else {
                            i = data[0];
                            if (x + i > xsize) break;
                            std::memset(out + x, data[1], size_t(i));
                            data += 2;
                        }
                    }
                    if (x != xsize) return OVERRUN;
                }
                break;
            case 16:  // COPY
                if (INT32_MAX / xsize < ysize) return OVERRUN;
                if (data + int64_t(xsize) * ysize > ptr + bytes) return ptr - buf;
                std::memcpy(im, data, size_t(int64_t(xsize) * ysize));
                break;
            default:
                return UNKNOWN;
        }
        int64_t advance = fli32(ptr);
        if (advance == 0) return BROKEN;
        if (advance > bytes) return OVERRUN;
        ptr += advance;
        bytes -= advance;
    }
#undef FLI_OOB
    return -1;
}
