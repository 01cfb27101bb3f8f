"""Image read/write without PIL (``akari_tpu/core/image.py``).

Writers: ``write_png`` encodes an 8-bit sRGB PNG with the standard library
only (``zlib`` + ``struct``): one IHDR, one IDAT whose scanlines take the
filter the PNG specification's heuristic picks, one IEND. ``write_hdr`` writes a Radiance ``.hdr`` (RGBE,
flat scanlines) and ``write_hdr_npy`` keeps the linear float image.

Readers (``read_image``): ``.npy`` (linear float) and ``.hdr`` (RGBE, flat
or new-RLE scanlines, the reference's codec) by extension; any other file
by its signature, as PIL chooses (``decode_image``): PNG through the
decoder below (every colour type and bit depth, interlaced or not), JPEG
through ``core/jpeg.py`` (baseline, extended sequential and progressive,
Huffman or arithmetic, and lossless; grey, three and four components), BMP, DIB, GIF, PNM
(P1-P6, PFM and PIL's P0CMYK / PyP / PyRGBA / PyCMYK), PSD and TGA
through ``core/image_formats.py``, TIFF (PIL's six header prefixes; raw,
PackBits, LZW, Deflate, JPEG, LZMA, ZSTD, CCITT RLE / RLEW / Group 3 /
Group 4, ThunderScan and old-style JPEG) through ``core/tiff.py``, Lab PSDs and
TIFFs through LittleCMS's Lab -> sRGB transform (``core/lcms.py``), WebP (lossless, lossy, with alpha, the first
frame of an animation) through ``core/webp.py``, and the game-texture
formats: DDS (BC1-BC7, the DX10 header, the uncompressed mask, luminance
and palette forms) through ``core/dds.py``, BLP (JPEG, palette or DXT) through
``core/blp.py`` and FTEX (DXT1 or raw) through ``core/ftex.py``, the blocks
decoded by ``native/bcn.cpp``; ICO / CUR through ``core/ico.py``, QOI
through ``core/qoi.py``, SGI through ``core/sgi.py`` and PCX through
``core/pcx.py`` (DCX too); and JPEG 2000 (JP2 files and raw J2K
codestreams, every Part-1 form OpenJPEG 2.5 decodes) through
``core/jpeg2000.py``; ICNS through ``core/icns.py``; IM and IM Tools
through ``core/im.py``, IPTC/NAA through ``core/iptc.py``, PhotoCD
through ``core/pcd.py``, SPIDER through ``core/spider.py``, MSP and XBM
through ``core/image_formats.py``; FITS through ``core/fits.py``, FLI / FLC
(frame 0) through ``core/fli.py``, Sun rasters through ``core/sun.py``, XPM
through ``core/xpm.py``, and GBR, McIdas, PIXAR and XV thumbnails through
``core/rasters.py``; and AVIF (a still image's primary AV1 item, a
``grid`` of them, or frame 0 of an ``avis`` sequence, in every tool PIL's
writer uses at any speed and with its options: 4:2:0, 4:2:2, 4:4:4 and
grey, 64 and 128 superblocks, tiles, palettes, filter intra, CfL, lossless
frames, quantizer matrices, the deblocking filter, CDEF, loop restoration,
film grain as dav1d applies it; alpha, premultiplied too; libavif's YUV ->
RGB) through ``core/avif.py`` and ``native/av1_decode.cpp``. Five of them
(IM, IMT, IPTC, PCD, SPIDER) have no
signature: PIL runs their header parse on every file that reaches them in
its order, and so does ``decode_image``. Others have a signature so weak
that files of other formats pass it (GBR: two big-endian words; FLI: two
16-bit fields; McIdas: eight bytes): their header parses are gates too,
and come before ICO, IM, TIFF, TGA and others in PIL's order. The
reference reads them with PIL, which the card's machine does not have; the
pixels equal PIL's ``convert("RGB")``. Other formats PIL opens (EPS, WMF,
MPEG and the BUFR / GRIB / HDF5 stubs, which load no pixels here) raise an
error naming the formats read here, and so do the AVIF forms still to be
ported: AV1 frames with superres, segmentation, delta q / delta lf, intra
block copy or more than 8 bits, non-key or hidden frames, frames or
planes whose size differs from their ``ispe`` or track header (libavif
scales them), and the chromaticity-derived nclx matrix.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from .image_formats import _check_size, note_band, note_mode
from .spectrum import linear_to_srgb, srgb_to_linear, to_uint8_srgb

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# BmpImagePlugin._dib_accept: the first u32 (little-endian) is a header size
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def _filter_rows(px, bpp):
    """[h, stride] uint8 -> [h, 1 + stride] filtered scanlines. Each row
    takes the filter whose output has the least sum of absolute values as
    signed bytes (the PNG specification's suggested heuristic, which zlib
    based encoders such as libpng use), so rows mix all five types."""
    x = px.astype(np.int16)
    zero_col = np.zeros((x.shape[0], bpp), np.int16)
    left = np.concatenate([zero_col, x[:, :-bpp]], axis=1)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]], axis=0)
    up_left = np.concatenate([zero_col, up[:, :-bpp]], axis=1)
    cand = np.stack([
        x, x - left, x - up, x - ((left + up) >> 1), x - _paeth(left, up, up_left),
    ]).astype(np.uint8)  # [5, h, stride], mod 256
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)  # [5, h]
    kind = cost.argmin(axis=0)
    rows = np.take_along_axis(cand, kind[None, :, None], axis=0)[0]
    return np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(rgb8):
    """[H, W, 3] uint8 -> PNG file bytes (filters chosen per scanline)."""
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got shape {rgb8.shape}")
    raw = _filter_rows(rgb8.reshape(h, w * 3), 3).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img_linear):
    """[H,W,3] linear float -> sRGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8_srgb(np.asarray(img_linear))))


def write_hdr_npy(path, img_linear):
    np.save(path, np.asarray(img_linear, dtype=np.float32))


# --------------------------------------------------------------------------
# PNG decoding

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, h, stride, bpp):
    """Undo the per-scanline filters of one (sub-)image: ``raw`` holds
    ``h`` rows of ``1 + stride`` bytes; ``bpp`` is the filters' byte step,
    the bytes of one pixel rounded up to 1; returns [h, stride] uint8.

    Pixel (y, x) depends on its left, upper and upper-left neighbours only,
    so every pixel of an anti-diagonal y + x = d is decoded at once: h + w
    - 1 vectorised steps, whatever filters the rows use."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kind = rows[:, 0].astype(np.int64)
    bad = np.flatnonzero(kind > 4)
    if bad.size:
        raise ValueError(f"PNG filter type {kind[bad[0]]} on row {bad[0]}")
    w = stride // bpp
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    # skewed: filt[d, y] is the filtered pixel (y, d - y)
    filt = np.zeros((h + w - 1, h, bpp), np.int16)
    filt[ys + xs, ys] = rows[:, 1:].reshape(h, w, bpp)
    # out[d + 2, y + 1] is the decoded pixel (y, d - y); the padding row
    # and columns, and the slots off the image, read as zero neighbours
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    zero = np.zeros((h, bpp), np.int16)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[d + 1, y0 + 1:y1 + 1]   # left: (y, x - 1)
        b = out[d + 1, y0:y1]           # up: (y - 1, x)
        c = out[d, y0:y1]               # up-left: (y - 1, x - 1)
        pred = np.stack([zero[:y1 - y0], a, b, (a + b) >> 1, _paeth(a, b, c)])
        pred = np.take_along_axis(pred, kind[None, y0:y1, None], axis=0)[0]
        out[d + 2, y0 + 1:y1 + 1] = (filt[d, y0:y1] + pred) & 0xFF
    return out[ys + xs + 2, ys + 1].reshape(h, stride).astype(np.uint8)


def _samples(rows, h, w, depth, ch):
    """[h, stride] unfiltered bytes -> [h, w, ch] samples: uint8, or
    uint16 for 16-bit images; sub-byte samples unpacked MSB first."""
    if depth == 8:
        return rows.reshape(h, w, ch)
    if depth == 16:
        return rows.reshape(h, w, ch, 2).astype(np.uint16) @ np.uint16([256, 1])
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, ch)


def _to_rgb8(px, ctype, depth, palette):
    """[H, W, ch] samples -> [H, W, 3] uint8, as PIL's ``convert("RGB")``:
    16-bit colour keeps the high byte; 16-bit grey (PIL's I;16) is
    clipped at 255; 1/2/4-bit grey scales to 0..255; palette indices past
    PLTE read black; alpha and tRNS are dropped."""
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return lut[px[..., 0]]
    if ctype == 0 and depth == 16:
        grey = np.minimum(px[..., 0], 255).astype(np.uint8)
    elif depth == 16:
        px = (px >> 8).astype(np.uint8)
    elif ctype == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        if not (ctype == 0 and depth == 16):
            grey = px[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")  # PngImagePlugin.is_cid


def decode_png(data, what="PNG"):
    """PNG file bytes -> [H, W, 3] uint8 RGB, the pixels of PIL's
    ``convert("RGB")``: every colour type and bit depth of the PNG
    specification, interlaced (Adam7) or not. As ``PngImageFile._open``,
    every chunk before the first IDAT must have a type of four word
    characters and its CRC (PIL refuses the file otherwise)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if not idat:
            if not _CHUNK_TYPE.match(tag):
                raise ValueError(f"{what}: broken PNG file (chunk {tag!r})")
            if tag != b"IDAT" and data[pos + 8 + length:pos + 12 + length] != struct.pack(
                    ">I", zlib.crc32(tag + body)):
                raise ValueError(f"{what}: broken PNG file (bad or missing checksum in "
                                 f"{tag!r})")
        if tag == b"IHDR":
            if len(body) < 13:
                raise ValueError(f"{what}: PNG IHDR chunk is truncated")
            hdr = struct.unpack(">IIBBBBB", body[:13])
            _check_size(hdr[0], hdr[1], what, "PNG")  # before any image data is read
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{what}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype] or interlace > 1:
        raise ValueError(
            f"{what}: PNG of bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} is not a PNG form"
        )
    if ctype == 3 and palette is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    note_mode({1: "1", 16: "I;16"}.get(depth, "L") if ctype == 0
              else {2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ctype])
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    need = sum(ph * (1 + -(-pw * depth * ch // 8)) for ph, pw in sizes if ph > 0 and pw > 0)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"{what}: corrupt PNG image data ({e})") from None
    if len(raw) < need:
        raise ValueError(f"{what}: PNG image data is truncated ({len(raw)} of {need} bytes)")
    px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for (x0, y0, dx, dy), (ph, pw) in zip(passes, sizes):
        if ph <= 0 or pw <= 0:
            continue  # an empty Adam7 pass holds no bytes at all
        stride = -(-pw * depth * ch // 8)
        rows = _unfilter(raw[off:off + ph * (1 + stride)], ph, stride, bpp)
        px[y0::dy, x0::dx] = _samples(rows, ph, pw, depth, ch)
        off += ph * (1 + stride)
    if ctype == 3 or (ctype == 0 and depth == 16):
        note_band(px[..., 0], "<" if depth == 16 else None)
    return _to_rgb8(px, ctype, depth, palette)


# --------------------------------------------------------------------------
# Radiance .hdr (RGBE): flat and new-RLE scanlines


def _rgbe_to_float(rgbe):
    """[..., 4] uint8 RGBE -> [..., 3] float32 linear."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)), 0.0)
    return (rgbe[..., :3] + 0.5) * scale[..., None] * (e > 0.0)[..., None]


def _float_to_rgbe(img):
    """[..., 3] float32 -> [..., 4] uint8 RGBE (max-component exponent)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = img.max(axis=-1)
    mant, expo = np.frexp(maxc)
    # v * 256/2^e for each channel, rounded down (Radiance convention)
    scale = np.where(maxc > 1e-32, np.ldexp(256.0, -expo), 0.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, expo + 128, 0).astype(np.uint8)
    return rgbe


def _read_hdr(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance .hdr file")
    # header: lines until the blank line; then the resolution line
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    out = np.empty((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        is_rle = (
            8 <= w <= 0x7FFF
            and buf[p] == 2 and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w
        )
        if not is_rle:
            # flat scanline: w RGBE pixels verbatim
            out[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for c in range(4):  # each component RLE'd separately
            x = 0
            while x < w:
                count = int(buf[p])
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[p + 1]
                    x += count - 128
                    p += 2
                else:  # literal
                    out[y, x:x + count, c] = buf[p + 1:p + 1 + count]
                    x += count
                    p += 1 + count
            if x != w:
                raise ValueError(f"{path}: RLE overrun at row {y}")
    return _rgbe_to_float(out)


def write_hdr(path, img_linear):
    """[H,W,3] linear float -> Radiance .hdr (flat scanlines, no RLE)."""
    img = np.asarray(img_linear, np.float32)
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img.reshape(h, w, 3))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _accepted(data):
    """The formats PIL would try to open ``data`` as, in the order
    ``Image.open`` tries them: the plugins of ``Image.preinit`` (BMP, DIB,
    GIF, JPEG, PNM, PNG) whose signature matches, then ``Image.ID``'s order.
    A plugin with a signature is listed when its ``_accept`` takes
    ``data``; the five without one (IM, IMT and IPTC between ICO and TIFF,
    PCD after MSP, SPIDER between SGI and TGA) are listed always, as PIL
    runs their header parse on every file that reaches them (``_GATES``);
    TGA, which has none either, by the sanity of its header."""
    from .avif import AVIF_MAJOR_BRANDS
    from .image_formats import tga_header
    from .jpeg2000 import J2K_SIGNATURE, JP2_SIGNATURE
    from .pcx import DCX_MAGIC
    from .tiff import PREFIXES as TIFF_PREFIXES

    head = data[:16]
    checks = (
        ("BMP", head[:2] == b"BM"),
        ("DIB", len(head) >= 4 and int.from_bytes(head[:4], "little") in DIB_HEADER_SIZES),
        ("GIF", head[:6] in (b"GIF87a", b"GIF89a")),
        ("JPEG", head[:3] == JPEG_SIGNATURE),
        ("PNM", head[:1] == b"P" and len(head) >= 2 and head[1:2] in b"0123456fy"),
        ("PNG", head[:8] == PNG_SIGNATURE),
        ("AVIF", head[4:8] == b"ftyp" and head[8:12] in AVIF_MAJOR_BRANDS),
        ("BLP", head[:4] in (b"BLP1", b"BLP2")),
        ("CUR", head[:4] == b"\0\0\2\0"),
        ("PCX", len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)),
        ("DCX", len(head) >= 4 and int.from_bytes(head[:4], "little") == DCX_MAGIC),
        ("DDS", head[:4] == b"DDS "),
        ("FITS", head.startswith(b"SIMPLE")),
        ("FLI", len(head) >= 16 and struct.unpack_from("<H", head, 4)[0] in (0xAF11, 0xAF12)
         and struct.unpack_from("<H", head, 14)[0] in (0, 3)),
        ("FTEX", head[:4] == b"FTEX"),
        ("GBR", len(head) >= 8 and struct.unpack_from(">I", head)[0] >= 20
         and struct.unpack_from(">I", head, 4)[0] in (1, 2)),
        ("JPEG2000", head[:4] == J2K_SIGNATURE or head[:12] == JP2_SIGNATURE),
        ("ICNS", head[:4] == b"icns"),
        ("ICO", head[:4] == b"\0\0\1\0"),
        ("IM", None), ("IMT", None), ("IPTC", None),
        ("MCIDAS", head.startswith(b"\0\0\0\0\0\0\0\4")),
        ("TIFF", head[:4] in TIFF_PREFIXES),
        ("MSP", head[:4] in (b"DanM", b"LinS")),
        ("PCD", None),
        ("PIXAR", head.startswith(b"\x80\xe8\0\0")),
        ("PSD", head[:4] == b"8BPS"),
        ("QOI", head[:4] == b"qoif"),
        ("SGI", head[:2] == b"\x01\xda"),
        ("SPIDER", None),
        ("SUN", head[:4] == b"\x59\xa6\x6a\x95"),
        ("TGA", tga_header(data) is not None),
        ("WebP", head[:4] == b"RIFF" and head[8:12] == b"WEBP"
         and head[12:16] in (b"VP8 ", b"VP8L", b"VP8X")),
        ("XBM", head.lstrip().startswith(b"#define")),
        ("XPM", head.startswith(b"/* XPM */")),
        ("XVThumb", head.startswith(b"P7 332")),
    )
    return [fmt for fmt, ok in checks if ok is not False]


# the formats whose plugin's open can fail after its signature (or, for the
# five without one, on any file) -> (module of core/, their plugin's header
# parse): NextFormat where PIL tries the next format, ValueError where its
# open fails
_GATES = {"AVIF": ("avif", "avif_header"),
          "IM": ("im", "im_header"), "IMT": ("im", "imt_header"),
          "IPTC": ("iptc", "iptc_header"), "PCD": ("pcd", "pcd_header"),
          "SPIDER": ("spider", "spider_header"), "FITS": ("fits", "fits_header"),
          "FLI": ("fli", "fli_header"), "GBR": ("rasters", "gbr_header"),
          "MCIDAS": ("rasters", "mcidas_header"), "PIXAR": ("rasters", "pixar_header"),
          "SUN": ("sun", "sun_header"), "XPM": ("xpm", "xpm_header"),
          "XVThumb": ("rasters", "xvthumb_header")}
_NO_SIGNATURE = ("IM", "IMT", "IPTC", "PCD", "SPIDER")


def image_format(data):
    """The format PIL would open ``data`` as, or None: by signature (TGA
    by the sanity of its header), then, for the formats of ``_GATES`` (IM,
    IMT, IPTC, PCD and SPIDER, which have none, and those whose open can
    fail after their signature matched), by their header parse. None also
    where one of those parses makes PIL's open fail. A file whose header
    the format of its signature cannot parse goes on to the next format
    that accepts it, as in PIL (``decode_image``)."""
    import importlib

    from .image_formats import NextFormat

    for fmt in _accepted(data):
        if fmt not in _GATES:
            return fmt
        module, name = _GATES[fmt]
        try:
            getattr(importlib.import_module(f".{module}", __package__), name)(data)
            return fmt
        except NextFormat:
            continue
        except ValueError:
            return None
    return None


# format -> (module of core/, decoder)
_DECODERS = {
    "PNG": ("image", "decode_png"), "JPEG": ("jpeg", "decode_jpeg"),
    "AVIF": ("avif", "decode_avif"),
    "BMP": ("image_formats", "decode_bmp"),
    "DIB": ("image_formats", "decode_dib_file"), "ICNS": ("icns", "decode_icns"),
    "GIF": ("image_formats", "decode_gif"), "PNM": ("image_formats", "decode_pnm"),
    "PSD": ("image_formats", "decode_psd"), "TGA": ("image_formats", "decode_tga"),
    "TIFF": ("tiff", "decode_tiff"), "WebP": ("webp", "decode_webp"),
    "DDS": ("dds", "decode_dds"), "BLP": ("blp", "decode_blp"), "FTEX": ("ftex", "decode_ftex"),
    "ICO": ("ico", "decode_ico"), "CUR": ("ico", "decode_cur"), "QOI": ("qoi", "decode_qoi"),
    "SGI": ("sgi", "decode_sgi"), "PCX": ("pcx", "decode_pcx"),
    "JPEG2000": ("jpeg2000", "decode_jpeg2000"), "DCX": ("pcx", "decode_dcx"),
    "IM": ("im", "decode_im"), "IMT": ("im", "decode_imt"), "IPTC": ("iptc", "decode_iptc"),
    "MSP": ("image_formats", "decode_msp"), "PCD": ("pcd", "decode_pcd"),
    "SPIDER": ("spider", "decode_spider"), "XBM": ("image_formats", "decode_xbm"),
    "FITS": ("fits", "decode_fits"), "FLI": ("fli", "decode_fli"),
    "GBR": ("rasters", "decode_gbr"), "MCIDAS": ("rasters", "decode_mcidas"),
    "PIXAR": ("rasters", "decode_pixar"), "SUN": ("sun", "decode_sun"),
    "XPM": ("xpm", "decode_xpm"), "XVThumb": ("rasters", "decode_xvthumb"),
}


def decode_with_mode(data, what="image"):
    """``decode_with_format``'s format and pixels, PIL's mode of the file
    (``Image.open(...).mode``) between them, as the decoder that read it
    noted it (``image_formats.note_mode``; formats that note none open as
    RGB or RGBA in PIL: WebP, QOI, FTEX, PCD, PIXAR), and last the bytes
    ``Image.merge`` would copy from its first band where the decoder noted
    them (``note_band``: palette indices, 16-bit samples' bytes), else
    None: (format, mode, pixels, band)."""
    import importlib

    from .image_formats import _MODE, NextFormat

    gave_up = []
    for fmt in _accepted(data):
        module, name = _DECODERS[fmt]
        box = {}
        token = _MODE.set(box)
        try:
            px = getattr(importlib.import_module(f".{module}", __package__), name)(data, what)
        except NextFormat as e:  # as PIL, try the next format that accepts the file
            if fmt not in _NO_SIGNATURE:
                gave_up.append(str(e).removeprefix(f"{what}: "))
            continue
        finally:
            _MODE.reset(token)
        return fmt, box.get("mode", "RGB"), px, box.get("band")
    tried = f"; PIL gives up on it: {'; '.join(gave_up)}" if gave_up else ""
    raise ValueError(f"{what}: unsupported image format (the port reads PNG, JPEG, BMP, DIB, "
                     "GIF, PNM (P1-P6, PFM and PIL's P0CMYK / Py modes), PSD, TGA, TIFF (every "
                     "compression PIL reads: raw, PackBits, LZW, Deflate, JPEG, old-style JPEG, "
                     "LZMA, ZSTD, CCITT and ThunderScan; Lab too), WebP, AVIF (8-bit still "
                     "images, grids and frame 0 of sequences, without AV1 superres, "
                     "segmentation, delta q / lf or intra block copy), DDS, "
                     "BLP, FTEX, ICO, CUR, QOI, SGI, PCX, DCX, JPEG 2000 (JP2 and J2K, Parts 1, 2 "
                     "and 15), ICNS, IM, IMT, IPTC, MSP, PCD, SPIDER, XBM, FITS, FLI / FLC, GBR, "
                     "MCIDAS, PIXAR, SUN, XPM, XVThumb, .hdr and .npy; not EPS, WMF, MPEG or the "
                     f"BUFR / GRIB / HDF5 stubs, which load no pixels here){tried}")


def decode_with_format(data, what="image"):
    """``decode_image``, and the format the file was read as (PIL's
    ``Image.open(...).format``, with PIL's PPM and WEBP named PNM and WebP)."""
    fmt, _, px, _ = decode_with_mode(data, what)
    return fmt, px


def decode_image(data, what="image"):
    """File bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")``: PNG, JPEG, BMP, DIB, GIF, PNM, PSD, TGA, TIFF, WebP,
    AVIF, DDS, BLP, FTEX, ICO, CUR, QOI, SGI, PCX, DCX, JPEG 2000, ICNS, IM,
    IMT, IPTC, MSP, PCD, SPIDER, XBM, FITS, FLI, GBR, MCIDAS, PIXAR, SUN, XPM
    and XVThumb, told apart as PIL tells them (the
    formats of ``_accepted`` in PIL's order, each header parse deciding, as
    in PIL, whether the next is tried). Other formats, and forms a decoder
    refuses (AVIF with AV1 superres or segmentation among them), raise
    ``ValueError`` naming them."""
    return decode_with_format(data, what)[1]


def read_image(path, to_linear=True):
    """Read an 8-bit image (sRGB -> linear float), .hdr (RGBE) or .npy
    (linear).

    Returns [H, W, 3] float32. The 8-bit formats are told apart as PIL
    tells them (``decode_image``: by signature, and for IM, IMT, IPTC,
    PhotoCD and SPIDER by their header parse), TIFF in every compression PIL
    reads (the CCITT fax codes, ThunderScan and old-style JPEG among them),
    JPEG 2000 (Parts 1, 2 and 15), Lab through LittleCMS's transform, DCX,
    MSP and XBM, FITS, FLI / FLC, GBR, McIdas, PIXAR, Sun raster, XPM and
    XV thumbnails, and AVIF still images; other formats, and forms the
    decoders refuse (AVIF frames with AV1 superres among them),
    raise ``ValueError`` naming the format.
    """
    path = str(path)
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]
    if path.endswith(".hdr"):
        return _read_hdr(path)
    with open(path, "rb") as f:
        data = f.read()
    px = decode_image(data, path)
    raw = px.astype(np.float32) / 255.0
    return srgb_to_linear(raw).astype(np.float32) if to_linear else raw


# Post-processing chain (ref: image.hpp PostProcessor / GammaCorrection /
# PostProcessingPipeline), as the reference composes it.

def gamma_correction(img, gamma=1.0 / 2.4):
    return linear_to_srgb(img)


def identity(img):
    return img


def pipeline(*stages):
    def run(img):
        for s in stages:
            img = s(img)
        return img

    return run
