"""TIFF decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path).convert("RGB")``,
``akari_tpu/core/image.py``), which the card's machine does not have.
``decode_tiff`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of the same TIFF file read from its path, and raises
``ValueError`` naming the form where PIL refuses the file or reads it only
as a form this module does not decode.

PIL parses the first image file directory (IFD) itself, classic or
BigTIFF (a big-endian BigTIFF's header it reads as a classic one's), and
picks a mode and a raw mode from the tags (``TiffImagePlugin._setup``;
``OPEN_INFO`` below is a copy of its table's keys). Then:

- an uncompressed file is read by PIL's own raw decoder, strip by strip or
  tile by tile as PIL lays out its tiles (sorted by offset, edge tiles
  cropped, planar configuration 2 one band a plane, a single strip of the
  mode's own layout mapped from the file at the orientation-swapped size);
- a compressed file goes to libtiff (4.7.1 under Pillow 12.1), which reads
  the directory again by its own rules (``_libtiff_directory``: the size,
  strip and sample tags strictly, the strip arrays to their count, byte
  counts limited or estimated, the samples of a directory PIL stopped
  reading early) and decodes PackBits, LZW (``akari_torch/native/
  tiff_lzw.cpp``: the TIFF 6.0 and the old bit-reversed codes), Deflate
  (``zlib``), LZMA (Python's ``lzma``: one .xz stream a strip, as
  ``tif_lzma.c`` reads it), ZSTD (``akari_torch/native/zstd.cpp``, the
  first Zstandard frame of a strip as libzstd's streaming decoder reads it
  for ``tif_zstd.c``), JPEG (``core/jpeg.py``: the ``JPEGTables`` stream, then
  each strip's stream, YCbCr to RGB by libjpeg), the CCITT codes of
  ``tif_fax3.c`` (``akari_torch/native/fax3.cpp``: RLE, RLEW, Group 3 MH
  and MR, Group 4, their run arrays and no-EOL state kept from strip to
  strip), ThunderScan (``native/rle.cpp``, ``tif_thunder.c``) and
  old-style JPEG (``core/tiff_ojpeg.py``: ``tif_ojpeg.c``'s stream, decoded
  raw and converted by the RGBA reader below), with fill order 2,
  horizontal (8, 16, 32-bit) and floating-point prediction, and its
  samples in the host's (little-endian) byte order, which PIL's raw modes
  then read (a big-endian 32-bit or signed 16-bit file thus reads
  byte-swapped, as in PIL); separate RGBA planes are un-premultiplied
  when libtiff's first extra sample is unspecified or associated;
- YCbCr that is not JPEG-compressed goes through libtiff's RGBA reader
  (``TIFFRGBAImage``): hs x vs luma samples and one Cb and one Cr a block,
  the chroma repeated over the block, ``tif_color.c``'s tables in float32.

The pixels are then converted as ``convert("RGB")`` converts PIL's mode:
bilevel, grey at 1, 2, 4, 8, 12, 16 and 32 bits (integer and float,
clipped to 0..255, float truncated; PIL inverts min-is-white only below
16 bits), grey with alpha, palette (``ColorMap`` entries // 256), RGB and
RGBA at 8 and 16 bits (the high byte; associated alpha un-premultiplied
as PIL's ``RGBa`` unpackers do), CMYK (PIL's cmyk2rgb), YCbCr, and 8-bit
CIELab (photometric 8): PIL's ``LAB`` unpacker flips the top bit of the
signed a and b bytes of interleaved samples, its band unpackers take the
planes of planar configuration 2 as stored, and ``convert("RGB")`` is
LittleCMS 2.17's Lab -> sRGB transform (``core/lcms.py``); a JPEG-
compressed Lab file's components pass through libjpeg unconverted; and
last turned by the ``Orientation`` tag as PIL's ``exif_transpose``.

Refused, each with a ``ValueError`` naming it: the SGILog, SGILog24 and
WebP compressions (PIL refuses them: its ``OPEN_INFO`` has no LogL /
LogLuv photometric, libtiff's LogLuv decoder takes no other, and its
libtiff has no WebP codec); any tag combination PIL's ``OPEN_INFO`` lacks
(Lab at 16 bits or with extra samples among them), and every file PIL or
libtiff refuses; and the forms PIL reads from libtiff's memory as it
stands, which the port cannot reproduce: one-band images in planar
configuration 2 (written as RGBA bands), YCbCr that is not JPEG with a
predictor or 4x4 subsampling, YCbCr, JPEG or old-style JPEG strips that
fail to decode (libtiff's RGBA reader and libjpeg go on over a stale or
partly written buffer: corrupt or short entropy-coded data, a JPEG strip
narrower than the image), and Group 4 strips whose codes end early
(libtiff succeeds once a row is decoded and leaves the rows after it
unwritten).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from itertools import groupby

import numpy as np

from . import lcms, tiff_ojpeg
from .image_formats import _check_size, _cmyk_to_rgb, _f_to_grey, note_band, note_mode

# PIL's TiffImagePlugin.PREFIXES: the two orders, BigTIFF, and two
# "invalid" headers PIL opens as classic TIFF
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
            b"II\x2b\x00")

# raw, CCITT RLE, Group 3, Group 4, LZW, old-style JPEG, JPEG, Deflate (two
# codes), CCITT RLEW, PackBits, ThunderScan, LZMA, ZSTD
_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32946, 32771, 32773, 32809, 34925, 50000)
# the codes whose strips libtiff runs through its predictor
_PREDICTED = (5, 8, 32946, 34925, 50000)
_FAX = {2: "CCITT RLE", 32771: "CCITT RLEW", 3: "CCITT Group 3", 4: "CCITT Group 4"}
_LOGLUV = ("-compressed TIFF (PIL refuses it: its OPEN_INFO has no LogL or LogLuv "
           "photometric, and libtiff's LogLuv decoder takes no other)")
_REFUSED_COMPRESSIONS = {
    34676: "SGILog" + _LOGLUV, 34677: "SGILog24" + _LOGLUV,
    50001: "WebP-compressed TIFF (PIL refuses it: its libtiff is built without the WebP "
           "codec)",
}
T4_OPTIONS = 292

# tag type -> (bytes a value, struct code); PIL's ImageFileDirectory_v2
# loaders (other types are skipped, as PIL skips them)
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "L"), 5: (8, "LL"), 6: (1, "b"),
          7: (1, "B"), 8: (2, "h"), 9: (4, "l"), 10: (8, "ll"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "L"), 16: (8, "Q")}
_BYTES_TYPES = (1, 2, 7)
# libtiff's TIFFDataWidth of every type it knows
_WIDTHS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
           16: 8, 17: 8, 18: 8}
# tags PIL reads as one value (TiffTags length 1); the others are tuples
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323, 347}

(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS, ORIENTATION,
 SAMPLES, ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH,
 TILE_OFFSETS, TILE_BYTES, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES, YCBCR_COEFFICIENTS,
 YCBCR_SUBSAMPLING, REFERENCE_BW) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
    338, 339, 347, 529, 530, 532)


def _open_info():
    """PIL's OPEN_INFO, (byte order, photometric, sample format, fill order,
    bits per sample, extra samples) -> (mode, raw mode), for the keys this
    module decodes."""
    both = [
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"), (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"), (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"), (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
        (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
        (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"), (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"), (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
        (5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"),
        (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    ordered = [  # (photometric, sample format, fill, bits, extra, mode, II raw mode, MM raw mode)
        (2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L", "RGB;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (), "RGBA", "RGBA;16L", "RGBA;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (0,), "RGB", "RGBX;16L", "RGBX;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (1,), "RGBA", "RGBa;16L", "RGBa;16B"),
        (2, (1,), 1, (16, 16, 16, 16), (2,), "RGBA", "RGBA;16L", "RGBA;16B"),
        (5, (1,), 1, (16, 16, 16, 16), (), "CMYK", "CMYK;16L", "CMYK;16B"),
        (1, (2,), 1, (16,), (), "I", "I;16S", "I;16BS"),
        (0, (3,), 1, (32,), (), "F", "F;32F", "F;32BF"),
        (1, (2,), 1, (32,), (), "I", "I;32S", "I;32BS"),
        (1, (3,), 1, (32,), (), "F", "F;32F", "F;32BF"),
    ]
    info = {}
    for photo, fmt, fill, bits, extra, mode, raw in both:
        for order in (b"II", b"MM"):
            info[order, photo, fmt, fill, bits, extra] = (mode, raw)
    for photo, fmt, fill, bits, extra, mode, raw_ii, raw_mm in ordered:
        info[b"II", photo, fmt, fill, bits, extra] = (mode, raw_ii)
        info[b"MM", photo, fmt, fill, bits, extra] = (mode, raw_mm)
    info[b"II", 1, (1,), 1, (12,), ()] = ("I;16", "I;12")
    info[b"II", 0, (1,), 1, (16,), ()] = ("I;16", "I;16")
    info[b"II", 1, (1,), 1, (16,), ()] = ("I;16", "I;16")
    info[b"MM", 1, (1,), 1, (16,), ()] = ("I;16B", "I;16B")
    info[b"II", 1, (1,), 2, (16,), ()] = ("I;16", "I;16R")
    info[b"II", 1, (1,), 1, (32,), ()] = ("I", "I;32N")
    return info


OPEN_INFO = _open_info()
MAX_SAMPLES = max(len(k[4]) for k in OPEN_INFO)
# PIL's Image._MAPMODES: a single raw strip of these modes is mapped from the file
_MAP_MODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2,
          "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}
_MAP_PIXEL_BYTES = {"L": 1, "P": 1, "I;16": 2, "I;16B": 2}  # the others: 4


class _Ifd:
    """The first IFD, read as PIL's ImageFileDirectory_v2 reads it."""

    def __init__(self, data, what):
        self.order = data[:2]
        self.endian = ">" if self.order == b"MM" else "<"
        self.bigtiff = data[2] == 43
        head = 16 if self.bigtiff else 8
        if len(data) < head:
            raise ValueError(f"{what}: TIFF header is truncated")
        first = self._unpack("Q" if self.bigtiff else "L", data, head - (8 if self.bigtiff else 4))
        if not first:
            raise ValueError(f"{what}: TIFF without an image (no more images in TIFF file)")
        self.raw = {}  # tag -> (type, bytes)
        self.sizes = []  # each entry's bytes of values (None: a type libtiff does not know)
        self.entries_all = {}  # tag -> (type, count, inline field) as libtiff reads them
        self.data = data
        self.entries = 0
        self.complete = False
        fmt, size = ("HHQ8s", 20) if self.bigtiff else ("HHL4s", 12)
        pos = first
        count_bytes = 8 if self.bigtiff else 2
        if pos + count_bytes > len(data):
            return  # PIL warns and reads no tags
        n = self._unpack("Q" if self.bigtiff else "H", data, pos)
        pos += count_bytes
        self.entries = n
        self.complete = pos + n * size <= len(data)
        stopped = False  # PIL stops at a tag whose values run past the end of the file
        for _ in range(n):
            if pos + size > len(data):
                break  # PIL: corrupt EXIF data, the tags read so far kept
            tag, typ, count, inline = struct.unpack_from(self.endian + fmt, data, pos)
            pos += size
            self.sizes.append(count * _WIDTHS[typ] if typ in _WIDTHS else None)
            self.entries_all.setdefault(tag, (typ, count, inline))
            if stopped or typ not in _TYPES:
                continue
            nbytes = count * _TYPES[typ][0]
            if nbytes > len(inline):
                at = self._unpack("Q" if self.bigtiff else "L", inline, 0)
                body = data[at:at + nbytes]
                if len(body) != nbytes:
                    stopped = True
                    continue
            else:
                body = inline[:nbytes]
            if not body:
                continue  # PIL skips a tag of no values
            self.raw[tag] = (typ, body)

    def _unpack(self, code, buf, pos):
        return struct.unpack_from(self.endian + code, buf, pos)[0]

    def __contains__(self, tag):
        return tag in self.raw

    def get(self, tag, default=None):
        if tag not in self.raw:
            return default
        typ, body = self.raw[tag]
        if typ in _BYTES_TYPES:
            return bytes(body)
        size, code = _TYPES[typ]
        vals = struct.unpack(f"{self.endian}{len(body) // size * len(code)}{code[0]}", body)
        if typ in (5, 10):
            vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
        return vals[0] if tag in _SINGLE else tuple(vals)

    def lenient(self, tag, default, count):
        """A tag of ``count`` values as libtiff reads a codec's or an
        optional tag: ignored (with a warning) where its type is not an
        integer type, its count another, or its values past the end."""
        if self.entries_all.get(tag, (0, count))[1] != count:
            return default
        try:
            return self.lt(tag, default, count)
        except ValueError:
            return default

    def lt(self, tag, default=None, limit=None):
        """The integer values of ``tag`` as libtiff reads them from the
        whole directory (PIL's parse may have stopped short of the tag):
        the first ``limit`` values at most; a non-integer type or values
        past the end of the file raise."""
        if tag not in self.entries_all:
            return default
        typ, count, inline = self.entries_all[tag]
        if typ not in _INT_CODES:
            raise ValueError(f"TIFF tag {tag} of type {typ} (libtiff: incompatible type)")
        width = _WIDTHS[typ]
        n = count if limit is None else min(count, limit)
        if count * width <= len(inline):
            body = inline[:n * width]
        else:
            at = self._unpack("Q" if self.bigtiff else "L", inline, 0)
            body = self.data[at:at + n * width]
            if len(body) != n * width:
                raise ValueError(f"TIFF tag {tag}'s values run past the end of the file")
        return struct.unpack(f"{self.endian}{n}{_INT_CODES[typ]}", body)


# --------------------------------------------------------------------------
# PIL's unpackers: raw mode -> (bits a pixel, function of rows [n, nbytes]
# uint8 and the pixel count w -> [n, w, C] in the mode's storage: one
# channel for 1, L, P, I;16, I and F; four for LA (L, -, -, A), PA, RGB
# (R, G, B, 255), RGBA and CMYK)

_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _sub_byte(rows, w, bits):
    """[n, nbytes] -> [n, w] samples of ``bits`` bits, most significant first."""
    unpacked = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(rows.shape[0], w, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(-1, dtype=np.uint8)


def _bytes(rows, w, k):
    return rows[:, :w * k].reshape(rows.shape[0], w, k)


def _words(rows, w, k, dtype):
    size = np.dtype(dtype).itemsize
    return np.ascontiguousarray(rows[:, :w * k * size]).view(dtype).reshape(rows.shape[0], w, k)


def _four(chans, alpha=None):
    """[n, w, c<=4] uint8 -> [n, w, 4], the missing channels 0 and the
    fourth ``alpha`` where given."""
    n, w, c = chans.shape
    out = np.zeros((n, w, 4), np.uint8)
    out[..., :c] = chans
    if alpha is not None:
        out[..., 3] = alpha
    return out


def _unpremultiply(rgb, a):
    """PIL's RGBa unpackers: a = 0 -> 0, a = 255 as stored, else
    min(255, v * 255 // a)."""
    a16 = a.astype(np.int32)[..., None]
    v = np.minimum(255, rgb.astype(np.int32) * 255 // np.maximum(a16, 1))
    v = np.where(a16 == 255, rgb, v)
    out = np.concatenate([v, a16], axis=-1).astype(np.uint8)
    out[a == 0] = 0
    return out


def _grey_levels(bits, invert):
    scale = 255 // ((1 << bits) - 1)

    def fn(rows, w):
        v = _sub_byte(rows, w, bits) * np.uint8(scale)
        return (255 - v if invert else v)[..., None]
    return fn


def _reversed(fn):
    return lambda rows, w: fn(_BITREV[rows], w)


def _rgbx(k, alpha):
    def fn(rows, w):
        px = _bytes(rows, w, k)
        return _four(px[..., :3], px[..., 3] if alpha else 255)
    return fn


def _rgba_premultiplied(k):
    def fn(rows, w):
        px = _bytes(rows, w, k)
        return _unpremultiply(px[..., :3], px[..., 3])
    return fn


def _wide(k, big, alpha=None, premultiplied=False, cmyk=False):
    """16-bit samples: PIL keeps each sample's high byte."""
    def fn(rows, w):
        hi = _bytes(rows, w, 2 * k)[..., 0 if big else 1::2]
        if premultiplied:
            return _unpremultiply(hi[..., :3], hi[..., 3])
        if cmyk or alpha == "A":
            return hi[..., :4].copy()
        return _four(hi[..., :3], 255)
    return fn


def _i12(rows, w):
    """PIL's I;12: two samples in three bytes, the first most significant."""
    n = rows.shape[0]
    pairs = -(-w // 2)
    b = np.zeros((n, 3 * pairs), np.uint16)
    b[:, :min(rows.shape[1], 3 * pairs)] = rows[:, :3 * pairs]
    b = b.reshape(n, pairs, 3)
    out = np.stack([b[..., 0] << 4 | b[..., 1] >> 4, (b[..., 1] & 15) << 8 | b[..., 2]], -1)
    return out.reshape(n, 2 * pairs)[:, :w, None].astype(np.int64)


def _band(k, wide=False):
    """One plane into channel ``k`` (PIL's band unpackers; 16-bit planes
    keep the high byte of the host-order sample)."""
    def fn(rows, w):
        v = _bytes(rows, w, 2)[..., 1] if wide else rows[:, :w]
        out = np.zeros(v.shape + (4,), np.uint8)
        out[..., k] = v
        return out
    return fn


_UNPACKERS = {
    "1": (1, lambda rows, w: (_sub_byte(rows, w, 1) * np.uint8(255))[..., None]),
    "1;I": (1, lambda rows, w: (255 - _sub_byte(rows, w, 1) * np.uint8(255))[..., None]),
    "L;2": (2, _grey_levels(2, False)), "L;2I": (2, _grey_levels(2, True)),
    "L;4": (4, _grey_levels(4, False)), "L;4I": (4, _grey_levels(4, True)),
    "L": (8, lambda rows, w: rows[:, :w, None]),
    "L;I": (8, lambda rows, w: 255 - rows[:, :w, None]),
    "P;1": (1, lambda rows, w: _sub_byte(rows, w, 1)[..., None]),
    "P;2": (2, lambda rows, w: _sub_byte(rows, w, 2)[..., None]),
    "P;4": (4, lambda rows, w: _sub_byte(rows, w, 4)[..., None]),
    "P": (8, lambda rows, w: rows[:, :w, None]),
    "PX": (16, lambda rows, w: _bytes(rows, w, 2)[..., :1]),
    "LA": (16, lambda rows, w: _four(_bytes(rows, w, 2)[..., :1], _bytes(rows, w, 2)[..., 1])),
    "PA": (16, lambda rows, w: _four(_bytes(rows, w, 2)[..., :1], _bytes(rows, w, 2)[..., 1])),
    "I;16": (16, lambda rows, w: _words(rows, w, 1, "<u2").astype(np.int64)),
    "I;16N": (16, lambda rows, w: _words(rows, w, 1, "<u2").astype(np.int64)),
    "I;16B": (16, lambda rows, w: _words(rows, w, 1, ">u2").astype(np.int64)),
    "I;12": (12, _i12),
    "I;16S": (16, lambda rows, w: _words(rows, w, 1, "<i2").astype(np.int64)),
    "I;16BS": (16, lambda rows, w: _words(rows, w, 1, ">i2").astype(np.int64)),
    "I;32N": (32, lambda rows, w: _words(rows, w, 1, "<i4").astype(np.int64)),
    "I;32S": (32, lambda rows, w: _words(rows, w, 1, "<i4").astype(np.int64)),
    "I;32BS": (32, lambda rows, w: _words(rows, w, 1, ">i4").astype(np.int64)),
    "F;32F": (32, lambda rows, w: _words(rows, w, 1, "<f4").astype(np.float32)),
    "F;32BF": (32, lambda rows, w: _words(rows, w, 1, ">f4").astype(np.float32)),
    "RGB": (24, lambda rows, w: _four(_bytes(rows, w, 3), 255)),
    "LAB": (24, lambda rows, w: _four(_bytes(rows, w, 3) ^ np.uint8([0, 128, 128]), 255)),
    "RGBX": (32, _rgbx(4, False)), "RGBXX": (40, _rgbx(5, False)),
    "RGBXXX": (48, _rgbx(6, False)),
    "RGBA": (32, _rgbx(4, True)), "RGBAX": (40, _rgbx(5, True)), "RGBAXX": (48, _rgbx(6, True)),
    "RGBa": (32, _rgba_premultiplied(4)), "RGBaX": (40, _rgba_premultiplied(5)),
    "RGBaXX": (48, _rgba_premultiplied(6)),
    "CMYK": (32, lambda rows, w: _bytes(rows, w, 4).copy()),
    "CMYKX": (40, lambda rows, w: _bytes(rows, w, 5)[..., :4].copy()),
    "CMYKXX": (48, lambda rows, w: _bytes(rows, w, 6)[..., :4].copy()),
}
for _order, _big in (("L", False), ("B", True), ("N", False)):
    _UNPACKERS[f"RGB;16{_order}"] = (48, _wide(3, _big))
    _UNPACKERS[f"RGBX;16{_order}"] = (64, _wide(4, _big))
    _UNPACKERS[f"RGBA;16{_order}"] = (64, _wide(4, _big, alpha="A"))
    _UNPACKERS[f"RGBa;16{_order}"] = (64, _wide(4, _big, premultiplied=True))
    _UNPACKERS[f"CMYK;16{_order}"] = (64, _wide(4, _big, cmyk=True))
for _name in ("1", "1;I", "L;2", "L;2I", "L;4", "L;4I", "L", "L;I", "P;1", "P;2", "P;4", "P",
              "RGB"):
    _bits, _fn = _UNPACKERS[_name]
    _UNPACKERS[_name.replace(";I", ";IR") if ";I" in _name else f"{_name};R"] = (
        _bits, _reversed(_fn))
# planar configuration 2 in PIL's raw decoder: the raw mode's k-th letter
# names the band (the 16-bit raw modes' letters read 8-bit planes)
_RAW_BANDS = {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3, "L": 0, "P": 0}


def _raw_band(mode, rawmode):
    """The band a planar raw mode letter fills (in mode LAB: L, A, B)."""
    return "LAB".index(rawmode) if mode == "LAB" else _RAW_BANDS[rawmode]


def _unpacker(mode, rawmode, what):
    if mode == "LAB" and len(rawmode) == 1:
        return 8, _band(_raw_band(mode, rawmode))
    if len(rawmode) == 1 and rawmode in _RAW_BANDS:
        if mode in ("1", "L", "P", "I;16", "I;16B", "I", "F") and rawmode not in "LP":
            raise ValueError(f"{what}: TIFF planar raw mode {rawmode!r} in mode {mode} "
                             "(PIL has no unpacker for it)")
        if rawmode in "LP":
            return 8, _UNPACKERS["L"][1]
        if mode in ("LA", "PA") and rawmode == "A":
            raise ValueError(f"{what}: planar TIFF alpha band in mode {mode} (PIL has no "
                             "unpacker for it)")
        return 8, _band(_RAW_BANDS[rawmode])
    if rawmode not in _UNPACKERS:  # PIL has no I;16R either
        raise ValueError(f"{what}: TIFF raw mode {rawmode!r} in mode {mode} (PIL has no "
                         "unpacker for it)")
    return _UNPACKERS[rawmode]


# --------------------------------------------------------------------------
# libtiff's codecs, predictors and byte order


def _lzw(raw, size, compat, what):
    from ..native.loader import load

    out = np.empty(size, np.uint8)
    rc = load("tiff").akr_tiff_lzw(raw, len(raw), out.ctypes.data_as(ctypes.c_void_p), size,
                                   int(compat))
    if rc == 1:
        raise ValueError(f"{what}: TIFF LZW data ends early (libtiff: not enough data)")
    if rc:
        raise ValueError(f"{what}: corrupt TIFF LZW data (libtiff: code not yet in table)")
    return out


def _inflate(raw, size, what):
    try:
        out = zlib.decompressobj().decompress(raw, size)
    except zlib.error as e:
        raise ValueError(f"{what}: corrupt TIFF Deflate data ({e})") from None
    if len(out) < size:
        raise ValueError(f"{what}: TIFF Deflate data ends early (libtiff: not enough data)")
    return np.frombuffer(out, np.uint8)


def _unxz(raw, size, what):
    """libtiff's LZMADecode: one .xz stream (liblzma's stream decoder) into
    ``size`` bytes in one call; the output written before liblzma reports
    an error counts, and less than ``size`` is "Not enough data"."""
    try:
        import lzma
    except ImportError as e:
        raise ValueError(f"{what}: LZMA-compressed TIFF needs Python's lzma module, which "
                         f"this Python lacks ({e})") from None

    def run(k):  # the output of the first k bytes, or None where liblzma fails on them
        try:
            return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw[:k], size)
        except lzma.LZMAError:
            return None

    out = run(len(raw))
    if out is None:
        # Python drops a call's output on an error: find the longest input
        # liblzma takes without one, and keep what it gives
        lo, hi = 0, len(raw)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if run(mid) is not None else (lo, mid)
        out = run(lo)
        if len(out) < size:
            raise ValueError(f"{what}: corrupt TIFF LZMA data (liblzma rejects it before the "
                             "strip is full, or in the step that fills it, whose output "
                             "Python's lzma drops)")
    if len(out) < size:
        raise ValueError(f"{what}: TIFF LZMA data ends early (libtiff: not enough data)")
    return np.frombuffer(out, np.uint8)


def _zstd(raw, size, what):
    from ..native.loader import load

    out = np.empty(size, np.uint8)
    rc = load("zstd").akr_zstd_decode(raw, len(raw), out.ctypes.data_as(ctypes.c_void_p), size)
    if rc == 1:
        raise ValueError(f"{what}: TIFF ZSTD data ends early (libtiff: not enough data)")
    if rc == 3:
        raise ValueError(f"{what}: corrupt TIFF ZSTD data: a Huffman literal stream does not "
                         "end where its size says (libzstd's fast decoder reads on; the port "
                         "refuses it)")
    if rc:
        raise ValueError(f"{what}: corrupt TIFF ZSTD data (libzstd rejects it)")
    return out


def _thunder(raw, rows, width, row_bytes, what):
    """libtiff's ThunderDecodeRow (``native/rle.cpp``)."""
    from ..native.loader import load

    out = np.zeros(rows * row_bytes, np.uint8)
    rc = load("rle").akr_thunder(raw, len(raw), width, rows, row_bytes,
                                 out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"{what}: ThunderScan TIFF data ends early or overfills a row "
                         f"(libtiff: {'not enough' if rc == 1 else 'too much'} data)")
    return out


def _unpackbits(raw, size, what):
    """libtiff's PackBitsDecode over a whole strip: a no-op byte (128)
    skipped, a packet cut to the room left (runs cross rows), and the data
    ending before the strip is full an error."""
    out = bytearray(size)
    o, i, n_raw = 0, 0, len(raw)
    while i < n_raw and o < size:
        n = raw[i] - 256 if raw[i] > 127 else raw[i]
        i += 1
        if n == -128:
            continue
        if n < 0:
            k = min(1 - n, size - o)
            if i >= n_raw:
                break
            out[o:o + k] = raw[i:i + 1] * k
            i += 1
        else:
            k = min(n + 1, size - o)
            if n_raw - i < k:
                break
            out[o:o + k] = raw[i:i + k]
            i += k
        o += k
    if o < size:
        raise ValueError(f"{what}: TIFF PackBits data ends early (libtiff: not enough data)")
    return np.frombuffer(bytes(out), np.uint8)


def _predict(buf, rows, row_bytes, predictor, bits, stride, swab):
    """Undo libtiff's predictor on ``rows`` rows of ``row_bytes`` bytes
    (``stride`` samples a pixel) and return the samples in the host's byte
    order: horAcc8/16/32 (sums in the sample's own width) or fpAcc (the
    bytes summed then regrouped, most significant plane first)."""
    b = buf[:rows * row_bytes].reshape(rows, row_bytes)
    if predictor == 3:
        nb = bits // 8
        acc = b.reshape(rows, -1, stride).cumsum(axis=1, dtype=np.uint8).reshape(rows, row_bytes)
        wc = row_bytes // nb
        planes = acc[:, :wc * nb].reshape(rows, nb, wc)
        return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).reshape(rows, -1)
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[bits]
    nb = bits // 8
    n = row_bytes // nb
    v = np.ascontiguousarray(b[:, :n * nb]).view(np.dtype(dtype).newbyteorder(">" if swab else "<"))
    if predictor == 2:
        w = n // stride
        head = v[:, :w * stride].reshape(rows, w, stride).cumsum(axis=1, dtype=dtype)
        v = np.concatenate([head.reshape(rows, -1), v[:, w * stride:].astype(dtype)], axis=1)
    return np.ascontiguousarray(v.astype(np.dtype(dtype).newbyteorder("<"))).view(
        np.uint8).reshape(rows, -1)


_INT_CODES = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 16: "Q", 17: "q"}
# tags libtiff's TIFFReadDirectory reads strictly (one value of an integer
# type in range, else the directory fails): tag -> (largest value, allowed values)
_STRICT = {WIDTH: (0xFFFFFFFF, None), LENGTH: (0xFFFFFFFF, None), TILE_WIDTH: (0xFFFFFFFF, None),
           TILE_LENGTH: (0xFFFFFFFF, None), ROWS_PER_STRIP: (0xFFFFFFFF, None),
           PLANAR: (0xFFFF, (1, 2)), SAMPLES: (0xFFFF, None)}


def _libtiff_directory(ifd, spp, what):
    """The checks by which libtiff's TIFFReadDirectory refuses a directory
    PIL's parser reads: the entry table cut short; the size, strip, planar
    and sample-count tags not one integer in range (RowsPerStrip and
    SamplesPerPixel not 0); Compression, BitsPerSample and SampleFormat not
    one value or one a sample, all equal; ExtraSamples more than the
    samples or of a kind past 2 (but Corel Draw's 999)."""
    if not ifd.complete:
        raise ValueError(f"{what}: TIFF directory is cut short (libtiff cannot read it)")

    def values(tag, limit=None):
        try:
            return ifd.lt(tag, limit=limit)
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None

    for tag, (top, allowed) in _STRICT.items():
        v = values(tag, 2)
        if v is not None and (len(v) != 1 or not 0 <= v[0] <= top
                              or (allowed and v[0] not in allowed)
                              or (tag in (ROWS_PER_STRIP, SAMPLES) and v[0] == 0)):
            raise ValueError(f"{what}: TIFF tag {tag} holds {v} (libtiff refuses it)")
    for tag in (COMPRESSION, BITS, SAMPLE_FORMAT):
        v = values(tag, 1 if ifd.entries_all.get(tag, (0, 1))[1] == 1 else None)
        if v is None:
            continue
        count = ifd.entries_all[tag][1]
        if count != 1 and (count < spp or len(set(v[:spp])) != 1):
            raise ValueError(f"{what}: TIFF tag {tag} holds {v} for {spp} samples "
                             "(libtiff refuses it)")
        if not 0 <= v[0] <= 0xFFFF or (tag == SAMPLE_FORMAT and not 1 <= v[0] <= 6):
            raise ValueError(f"{what}: TIFF tag {tag} holds {v} (libtiff refuses it)")
    v = values(EXTRA_SAMPLES, 8)
    if v is not None and (ifd.entries_all[EXTRA_SAMPLES][1] > spp
                          or any(x not in (0, 1, 2, 999) for x in v)):
        raise ValueError(f"{what}: TIFF ExtraSamples {v} for {spp} samples (libtiff "
                         "refuses it)")
    bits = values(BITS, 1)
    if ifd.lenient(PHOTOMETRIC, None, 1) == (3,) and (bits or (1,))[0] < 8:
        cmap = ifd.entries_all.get(COLORMAP)  # ignored unless BitsPerSample was read
        if bits is None or cmap is None or cmap[1] != 3 << bits[0]:
            raise ValueError(f"{what}: palette TIFF whose ColorMap libtiff cannot take "
                             "(libtiff: missing required Colormap)")
    for tag, what_tag in ((WIDTH, "ImageWidth"), (LENGTH, "ImageLength")):
        if values(tag, 1) != (ifd.get(tag),):
            raise ValueError(f"{what}: TIFF {what_tag} as libtiff reads it differs from PIL's")


class _Libtiff:
    """The strips or tiles of a compressed file as libtiff's
    TIFFReadEncodedStrip / TIFFReadEncodedTile return them."""

    def __init__(self, data, ifd, comp, bits, spp, planar, width, height, what):
        self.data, self.ifd, self.comp, self.what = data, ifd, comp, what
        self.bits, self.spp, self.planar = bits, spp, planar
        self.swab = ifd.order == b"MM"
        self.fill = ifd.lt(FILL_ORDER, (1,), 1)[0]
        self.predictor = ifd.lt(PREDICTOR, (1,), 1)[0] if comp in _PREDICTED else 1
        self.compat = None
        self.fax = None  # (kind, state, run arrays) of a CCITT image
        self.width = width
        fmt = ifd.get(SAMPLE_FORMAT, (1,))
        fmt = fmt[0] if isinstance(fmt, tuple) else fmt
        if self.predictor == 2 and bits not in (8, 16, 32, 64):
            raise ValueError(f"{what}: TIFF horizontal predictor on {bits}-bit samples "
                             "(libtiff refuses it)")
        if self.predictor == 3 and (fmt != 3 or bits not in (16, 24, 32, 64)):
            raise ValueError(f"{what}: TIFF floating-point predictor on {bits}-bit samples "
                             f"of format {fmt} (libtiff refuses it)")
        if self.predictor not in (1, 2, 3):
            raise ValueError(f"{what}: TIFF predictor {self.predictor} (libtiff refuses it)")
        self.tiled = TILE_WIDTH in ifd.entries_all  # libtiff: a TileWidth tag makes it tiled
        per = spp if planar == 1 else 1
        if self.tiled:
            self.tw, self.tl = ifd.lt(TILE_WIDTH, (0,), 1)[0], ifd.lt(TILE_LENGTH, (0,), 1)[0]
            if self.tw <= 0 or self.tl <= 0:
                raise ValueError(f"{what}: TIFF tiles of {self.tw} x {self.tl} (libtiff: zero "
                                 "number of tiles)")
            self.row_bytes = -(-self.tw * bits * per // 8)
            self.across = -(-width // self.tw)
            self.per_plane = self.across * -(-height // self.tl)
            offsets = TILE_OFFSETS if TILE_OFFSETS in ifd.entries_all else STRIP_OFFSETS
            counts = TILE_BYTES if TILE_BYTES in ifd.entries_all else STRIP_BYTES
            if offsets not in ifd.entries_all:
                raise ValueError(f"{what}: tiled TIFF without TileOffsets (libtiff refuses it)")
        else:
            if STRIP_OFFSETS not in ifd.entries_all:
                raise ValueError(f"{what}: TIFF without StripOffsets (libtiff refuses it)")
            rps = ifd.lt(ROWS_PER_STRIP, (0xFFFFFFFF,), 1)[0]
            self.rps = rps if 0 < rps < height else height
            if rps == 0:
                raise ValueError(f"{what}: TIFF RowsPerStrip 0 (libtiff refuses it)")
            self.row_bytes = -(-width * bits * per // 8)
            self.per_plane = -(-height // self.rps)
            offsets, counts = STRIP_OFFSETS, STRIP_BYTES
        n = self.per_plane * (spp if planar == 2 else 1)
        self.per_block_bytes = self.row_bytes * (self.tl if self.tiled else self.rps)
        try:  # libtiff reads the first n values and pads short arrays with zeros
            offs = ifd.lt(offsets, limit=n)
            cnt = ifd.lt(counts, limit=n)
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
        if any(v < 0 for v in offs + (cnt or ())):
            raise ValueError(f"{what}: negative TIFF strip offsets or byte counts")
        self.offsets = (offs + (0,) * n)[:n]
        if cnt is not None:
            self.counts = list((cnt + (0,) * n)[:n])
            if (n == 1 and not self.tiled and self.offsets[0] and not self.counts[0]):
                self._estimate(n)
        else:
            if (planar == 1 and n > 1) or (planar == 2 and n != spp):
                raise ValueError(f"{what}: TIFF of {n} strips or tiles without their byte "
                                 "counts (libtiff: missing required StripByteCounts)")
            self._estimate(n)

    def _estimate(self, n):
        """libtiff's EstimateStripByteCounts for a compressed file."""
        ifd, size = self.ifd, len(self.data)
        space = (16 + 8 + ifd.entries * 20 + 8) if ifd.bigtiff else (8 + 2 + ifd.entries * 12 + 4)
        for nbytes in ifd.sizes:
            if nbytes is None:
                raise ValueError(f"{self.what}: TIFF tag of a type libtiff cannot size")
            if nbytes > (8 if ifd.bigtiff else 4):
                space += nbytes
        space = size if size < space else size - space
        if self.planar == 2:
            space //= self.spp
        self.counts = [space] * n
        last = self.offsets[-1]
        if last + space > size:
            self.counts[-1] = 0 if last >= size else size - last

    def stream(self, index):
        """Strip or tile ``index`` as stored (fill order 2 reversed)."""
        off, cnt = self.offsets[index], self.counts[index]
        size = self.per_block_bytes
        if cnt > 1 << 20 and size and (cnt - 4096) // 10 > size:
            cnt = size * 10 + 4096  # TIFFFillStrip: too large a byte count is limited
        if cnt <= 0:
            raise ValueError(f"{self.what}: TIFF strip or tile {index} of 0 bytes (libtiff: "
                             "invalid byte count)")
        if off + cnt > len(self.data):
            raise ValueError(f"{self.what}: TIFF strip or tile {index} runs past the end of "
                             "the file (libtiff: read error)")
        raw = self.data[off:off + cnt]
        if self.fill == 2:
            raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    def _fax(self, index, raw, size):
        """libtiff's Fax3Decode1D / 2D, Fax4Decode or Fax3DecodeRLE over one
        strip or tile (``native/fax3.cpp``)."""
        from ..native.loader import load

        name = _FAX[self.comp]
        if self.bits != 1:
            raise ValueError(f"{self.what}: {name} TIFF of {self.bits}-bit samples (libtiff: "
                             "Bits/sample must be 1 for Group 3/4 encoding/decoding)")
        if self.spp != 1 and self.planar == 1:
            raise ValueError(f"{self.what}: {name} TIFF of {self.spp} samples per pixel "
                             "(libtiff: Samples/pixel shall be 1 for Group 3/4)")
        lib = load("fax3")
        width = self.tw if self.tiled else self.width
        if self.fax is None:
            two_d = self.comp == 3 and self.ifd.lenient(T4_OPTIONS, (0,), 1)[0] & 1
            kind = {2: 0, 32771: 1, 4: 4}.get(self.comp, 3 if two_d else 2)
            # libtiff's no-EOL flag and run arrays live from strip to strip
            self.fax = (kind, (ctypes.c_int32 * 2)(0, 0),
                        np.zeros(2 * lib.akr_fax_runs(width, kind), np.uint32))
        kind, state, runs = self.fax
        rows = size // self.row_bytes
        out = np.zeros(size, np.uint8)
        rc = lib.akr_fax_strip(raw, len(raw), self.offsets[index], kind, width, rows,
                               self.row_bytes, state, runs.ctypes.data_as(ctypes.c_void_p),
                               out.ctypes.data_as(ctypes.c_void_p))
        if rc == -2:
            raise ValueError(f"{self.what}: corrupt {name} TIFF data (libtiff: buffer overflow "
                             "of its run arrays)")
        if rc == -3:
            raise ValueError(f"{self.what}: corrupt {name} TIFF data (libtiff: buffer overrun "
                             "detected)")
        if rc < 0:
            raise ValueError(f"{self.what}: {name} TIFF data ends early or is corrupt (libtiff: "
                             "premature EOF)")
        if state[1] < rows:
            raise ValueError(f"{self.what}: {name} TIFF strip whose codes end after row "
                             f"{state[1]} of {rows} is not supported (libtiff leaves the rows "
                             "after it as PIL's buffer held them)")
        return out

    def block(self, index, rows):
        """Strip or tile ``index`` decoded: [rows, row_bytes] uint8 in the
        host's byte order."""
        size = rows * self.row_bytes
        buf = self.block_bytes(index, size)
        if self.predictor != 1 or (self.swab and self.bits in (16, 32, 64)):
            stride = self.spp if self.planar == 1 else 1
            return _predict(buf, rows, self.row_bytes, self.predictor, self.bits, stride,
                            self.swab)
        return buf[:size].reshape(rows, self.row_bytes)

    def block_bytes(self, index, size):
        """The first ``size`` decoded bytes of strip or tile ``index``."""
        raw = self.stream(index)
        if self.comp in _FAX:
            return self._fax(index, raw, size)
        if self.comp == 6:
            return self.ojpeg.block(index, size // self.row_bytes, self.rps)
        if self.comp == 32809:
            if self.bits != 4:
                raise ValueError(f"{self.what}: ThunderScan TIFF of {self.bits}-bit samples "
                                 "(libtiff: the Thunder decoder only supports 4 bits per "
                                 "sample)")
            if self.tiled:
                raise ValueError(f"{self.what}: tiled ThunderScan TIFF (libtiff: ThunderScan "
                                 "tile decoding is not implemented)")
            return _thunder(raw, size // self.row_bytes, self.width, self.row_bytes, self.what)
        if self.comp == 5:
            if self.compat is None:  # libtiff decides by the first strip it decodes
                self.compat = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
            buf = _lzw(raw, size, self.compat, self.what)
        elif self.comp in (8, 32946):
            buf = _inflate(raw, size, self.what)
        elif self.comp == 34925:
            buf = _unxz(raw, size, self.what)
        elif self.comp == 50000:
            buf = _zstd(raw, size, self.what)
        else:
            buf = _unpackbits(raw, size, self.what)
        return buf[:size]


# --------------------------------------------------------------------------
# decoding


def decode_tiff(data, what="TIFF"):
    """TIFF file bytes -> [H, W, 3] uint8 RGB, the pixels of PIL's
    ``Image.open(...).convert("RGB")`` (see the module docstring)."""
    data = bytes(data)
    if data[:4] not in PREFIXES:
        raise ValueError(f"{what}: not a TIFF file")
    ifd = _Ifd(data, what)
    try:
        return _decode(data, ifd, what)
    except (struct.error, TypeError, IndexError, KeyError, OverflowError) as e:
        raise ValueError(f"{what}: TIFF PIL cannot read ({type(e).__name__}: {e})") from None


def _decode(data, ifd, what):
    if 0xBC01 in ifd:
        raise ValueError(f"{what}: Windows Media Photo in TIFF (PIL refuses it)")
    comp = ifd.get(COMPRESSION, 1)
    if comp in _REFUSED_COMPRESSIONS:
        raise ValueError(f"{what}: {_REFUSED_COMPRESSIONS[comp]}")
    if comp not in _COMPRESSIONS:
        raise ValueError(f"{what}: TIFF compression {comp!r} (PIL refuses it)")
    planar = ifd.get(PLANAR, 1)
    photo = ifd.get(PHOTOMETRIC, 0)
    fill = ifd.get(FILL_ORDER, 1)
    if WIDTH not in ifd or LENGTH not in ifd:
        if data[:4] == b"MM\x00\x2b":
            raise ValueError(f"{what}: big-endian BigTIFF is not supported (PIL reads its "
                             "header as a classic TIFF's and finds no image there)")
        raise ValueError(f"{what}: TIFF without ImageWidth or ImageLength (PIL: missing "
                         "dimensions)")
    xsize, ysize = ifd.get(WIDTH), ifd.get(LENGTH)
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError(f"{what}: TIFF of invalid dimensions {xsize!r} x {ysize!r}")
    if comp == 6:
        photo = 6  # PIL: "old style jpeg compression images most certainly are YCbCr"
    orientation = ifd.get(ORIENTATION)
    swapped = orientation in (5, 6, 7, 8)
    _check_size(*((ysize, xsize) if swapped else (xsize, ysize)), what, "TIFF")
    sample_format = ifd.get(SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = ifd.get(BITS, (1,))
    extra = ifd.get(EXTRA_SAMPLES, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = ifd.get(SAMPLES, 3 if comp == 6 else 1)
    if spp > MAX_SAMPLES:
        raise ValueError(f"{what}: TIFF of {spp} samples per pixel (PIL refuses more than "
                         f"{MAX_SAMPLES})")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{what}: TIFF of {spp} samples and bits per sample {bps} (PIL: "
                         "unknown data organization)")
    key = (ifd.order, photo, sample_format, fill, bps, extra)
    if key not in OPEN_INFO:
        raise ValueError(f"{what}: TIFF of photometric {photo}, sample format {sample_format}, "
                         f"fill order {fill}, bits {bps}, extra samples {extra} in "
                         f"{'big' if ifd.order == b'MM' else 'little'}-endian order (PIL: "
                         "unknown pixel mode)")
    mode, rawmode = OPEN_INFO[key]
    note_mode(mode)
    palette = None
    if mode in ("P", "PA"):
        cmap = ifd.get(COLORMAP)
        if cmap is None:
            raise ValueError(f"{what}: palette TIFF without a ColorMap (PIL refuses it)")
        cmap = np.array([(int(v) // 256) & 255 for v in cmap], np.uint8)
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = cmap[:3 * n].reshape(3, n).T[:256]
    if comp == 1:
        px = _raw_image(data, ifd, mode, rawmode, xsize, ysize, planar, bps, bps_count, swapped,
                        what)
    else:
        px = _compressed_image(data, ifd, comp, photo, mode, key, rawmode, xsize, ysize, bps, spp,
                               what)
    if mode in ("P", "I;16", "I;16B"):
        note_band(_orient(px[..., :1], orientation)[..., 0],
                  None if mode == "P" else "<" if mode == "I;16" else ">")
    return _orient(_to_rgb(px, mode, palette), orientation)


def _new_image(mode, ysize, xsize):
    """A zeroed image in the mode's storage (RGB's fourth byte 255)."""
    dtype = np.float32 if mode == "F" else np.int64 if mode in ("I;16", "I;16B", "I") else np.uint8
    px = np.zeros((ysize, xsize, 4 if _BANDS[mode] > 1 else 1), dtype)
    if mode == "RGB":
        px[..., 3] = 255
    return px


def _raw_image(data, ifd, mode, rawmode, xsize, ysize, planar, bps, bps_count, swapped, what):
    """PIL's own decoding of an uncompressed file: its tile list, sorted by
    offset, each tile read by the raw decoder."""
    if STRIP_OFFSETS in ifd:
        offsets = ifd.get(STRIP_OFFSETS)
        h = ifd.get(ROWS_PER_STRIP, ysize)
        w = xsize
    elif TILE_OFFSETS in ifd:
        offsets = ifd.get(TILE_OFFSETS)
        w, h = ifd.get(TILE_WIDTH), ifd.get(TILE_LENGTH)
        if not isinstance(w, int) or not isinstance(h, int):
            raise ValueError(f"{what}: TIFF of invalid tile dimensions {w!r} x {h!r}")
    else:
        raise ValueError(f"{what}: TIFF without strip or tile offsets (PIL: unknown data "
                         "organization)")
    if not isinstance(offsets, tuple):
        offsets = (offsets,)
    if w == xsize and h == ysize and planar != 2:
        offsets = offsets[-1:]  # every tile covers the image: PIL keeps the last
    tiles = []
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(bps) / 8 if x + w > xsize else 0
        tile_rawmode = rawmode
        if planar == 2:
            tile_rawmode = rawmode[layer]
            stride /= bps_count
        tiles.append((offset, (x, y, min(x + w, xsize), min(y + h, ysize)), tile_rawmode,
                      int(stride)))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    px = _new_image(mode, ysize, xsize)
    if (len(tiles) == 1 and tiles[0][2] == mode and mode in _MAP_MODES):
        # PIL maps a single strip or tile of the mode's own layout from the
        # file, at its size after the orientation's swap
        offset, stride = tiles[0][0], tiles[0][3]
        h_map, w_map = (xsize, ysize) if swapped else (ysize, xsize)
        nbytes = stride if stride > 0 else w_map * _MAP_PIXEL_BYTES.get(mode, 4)
        if offset < 0 or offset + h_map * nbytes > len(data):
            raise ValueError(f"{what}: TIFF image data is truncated (PIL: buffer is not large "
                             "enough)")
        rows = np.frombuffer(data, np.uint8, h_map * nbytes, offset).reshape(h_map, nbytes)
        if mode in ("RGBA", "CMYK"):
            return _bytes(rows, w_map, 4).copy()
        return _UNPACKERS[mode][1](rows, w_map)
    tiles.sort(key=lambda t: t[0])
    tiles = [list(g)[-1] for _, g in groupby(tiles, lambda t: (t[1], t[2], t[3]))]
    err = None
    for offset, (x0, y0, x1, y1), tile_rawmode, stride in tiles:
        bits, fn = _unpacker(mode, tile_rawmode, what)
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0 or x0 < 0 or y0 < 0:
            raise ValueError(f"{what}: TIFF tile {x0, y0, x1, y1} outside the image (PIL: tile "
                             "cannot extend outside image)")
        nbytes = (tw * bits + 7) // 8
        skip = stride - nbytes if stride else 0
        if skip < 0:
            err = f"{what}: TIFF tile rows of {stride} bytes hold fewer than {nbytes} (PIL's " \
                  "raw decoder refuses the tile)"
            continue
        err = None
        need = th * nbytes + (th - 1) * skip
        if offset < 0 or len(data) - offset < need:
            raise ValueError(f"{what}: TIFF image data is truncated")
        step = nbytes + skip
        buf = np.frombuffer(data, np.uint8, min(th * step, len(data) - offset), offset)
        if len(buf) < th * step:
            buf = np.concatenate([buf, np.zeros(th * step - len(buf), np.uint8)])
        vals = fn(buf.reshape(th, step)[:, :nbytes], tw)
        if vals.shape[-1] == 4 and len(tile_rawmode) == 1:
            k = _raw_band(mode, tile_rawmode)
            px[y0:y1, x0:x1, k] = vals[..., k]
        else:
            px[y0:y1, x0:x1] = vals
    if err:
        raise ValueError(err)
    return px


def _compressed_image(data, ifd, comp, photo, mode, key, rawmode, xsize, ysize, bps, spp,
                      what):
    """libtiff's decoding as PIL's TiffDecode.c drives it."""
    if data[:4] in (b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b"):
        raise ValueError(f"{what}: compressed TIFF with the header {data[:4]!r} (libtiff "
                         "refuses it)")
    if data[:4] == b"II\x2b\x00" and data[4:8] != b"\x08\x00\x00\x00":
        raise ValueError(f"{what}: BigTIFF header with {data[4:8]!r} (libtiff refuses it)")
    _libtiff_directory(ifd, spp, what)
    lt_comp = ifd.lt(COMPRESSION, (1,), 1)[0]
    if lt_comp != comp:  # PIL keeps a repeated tag's last entry, libtiff its first
        raise ValueError(f"{what}: TIFF whose compression libtiff reads as {lt_comp} and PIL as "
                         f"{comp} (a repeated Compression tag) is not supported")
    if key[3] == 2:  # libtiff reverses the bits; PIL reads the fill order 1 mode
        mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
    planar = ifd.lt(PLANAR, (1,), 1)[0]  # libtiff's, as PIL's decoder asks libtiff
    if photo == 6 and comp == 7 and ifd.get(PLANAR, 1) == 1:
        rawmode = "RGB"
    elif rawmode == "I;16":
        rawmode = "I;16N"
    elif rawmode.endswith((";16B", ";16L")):
        rawmode = rawmode[:-1] + "N"
    # libtiff decodes from its own reading of the directory, which may hold
    # tags past the one PIL's parse stopped at
    bits = ifd.lt(BITS, (1,), 1)[0]
    lt_spp = tiff_ojpeg.libtiff_samples(ifd) if comp == 6 else ifd.lt(SAMPLES, (1,), 1)[0]
    if lt_spp != spp or bits != bps[0]:
        raise ValueError(f"{what}: TIFF whose samples libtiff reads otherwise than PIL (a tag "
                         "before them runs past the end of the file, or an old-style JPEG "
                         "whose SamplesPerPixel each takes otherwise)")
    lt = _Libtiff(data, ifd, comp, bits, spp, planar, xsize, ysize, what)
    if comp == 6:
        lt.ojpeg = tiff_ojpeg.OJpeg(data, ifd, lt, xsize, ysize, what)
        if tiff_ojpeg.libtiff_photometric(ifd) == 6:  # PIL reads libtiff's YCbCr as RGBA
            return _ycbcr_rgba(lt, ifd, xsize, ysize, planar, spp, bits, what,
                               lt.ojpeg.sampling)
    elif comp == 7:
        return _jpeg_image(lt, ifd, photo, mode, rawmode, xsize, ysize, planar, spp, what)
    if photo == 6 and comp != 6:
        return _ycbcr_rgba(lt, ifd, xsize, ysize, planar, spp, bits, what)
    ubits, fn = _unpacker(mode, rawmode, what)
    planes, unpack = 1, [fn]
    if planar == 2:
        if bits not in (8, 16):
            raise ValueError(f"{what}: planar TIFF of {bits}-bit samples (PIL's libtiff reader "
                             "refuses it)")
        if _BANDS[mode] == 1:
            raise ValueError(f"{what}: planar TIFF in mode {mode} (PIL's libtiff reader "
                             "writes one-band planes as RGBA bands)")
        planes = _BANDS[mode]
        unpack = [_band(k, bits == 16) for k in range(planes)]
    row_size = (xsize * ubits // planes + 7) // 8
    rps_tag = ifd.lt(ROWS_PER_STRIP, (0xFFFFFFFF,), 1)[0]
    if not lt.tiled and 2 ** 31 <= rps_tag < 0xFFFFFFFF:
        raise ValueError(f"{what}: TIFF of {rps_tag} rows a strip (PIL's libtiff decoder "
                         "takes the count as a negative int and refuses it)")
    if not lt.tiled and lt.row_bytes < row_size:
        raise ValueError(f"{what}: TIFF rows of {lt.row_bytes} bytes, fewer than PIL's raw mode "
                         f"{rawmode} reads")
    px = _new_image(mode, ysize, xsize)

    def put(vals, plane, y0, x0):
        if planes > 1:
            px[y0:y0 + vals.shape[0], x0:x0 + vals.shape[1], plane] = vals[..., plane]
        else:
            px[y0:y0 + vals.shape[0], x0:x0 + vals.shape[1]] = vals

    if lt.tiled:
        for y in range(0, ysize, lt.tl):
            for plane in range(planes):
                for x in range(0, xsize, lt.tw):
                    index = (y // lt.tl) * lt.across + x // lt.tw + plane * lt.per_plane
                    if index >= len(lt.offsets):
                        raise ValueError(f"{what}: TIFF tile {index} out of range")
                    rows = lt.block(index, lt.tl)
                    th, tw = min(lt.tl, ysize - y), min(lt.tw, xsize - x)
                    put(unpack[plane](rows[:th], tw), plane, y, x)
    else:
        for y in range(0, ysize, lt.rps):
            for plane in range(planes):
                index = y // lt.rps + plane * lt.per_plane
                if index >= len(lt.offsets):
                    raise ValueError(f"{what}: TIFF strip {index} out of range")
                rows = lt.block(index, min(lt.rps, ysize - y))
                put(unpack[plane](rows, xsize), plane, y, 0)
    if planes > 3 and mode == "RGBA":
        # PIL un-premultiplies separate RGBA planes whose first extra sample
        # libtiff reads as unspecified (also when the tag is missing) or
        # associated alpha
        extra = ifd.lt(EXTRA_SAMPLES, (0,), 1)
        if extra[0] in (0, 1):
            px = _unpremultiply(px[..., :3], px[..., 3])
    return px


def _jpeg_image(lt, ifd, photo, mode, rawmode, xsize, ysize, planar, spp, what):
    """JPEG compression (7) as libtiff's tif_jpeg.c decodes it for PIL: the
    ``JPEGTables`` stream read first, then each strip or tile a JPEG whose
    width is the segment's and whose height is at least the segment's (a
    last strip may be taller); YCbCr converted to RGB by libjpeg, every
    other photometric passed through as its components (all sampled 1x1)."""
    from .jpeg import _ycc_to_rgb, decode_components, jpeg_tables

    if planar != 1 or lt.bits != 8 or photo not in (0, 1, 2, 5, 6, 8):
        raise ValueError(f"{what}: JPEG-compressed TIFF of photometric {photo}, {lt.bits}-bit "
                         f"samples, planar configuration {planar} is not supported")
    # the tables stream, like each strip, ends in libtiff's fake EOI
    tables = (jpeg_tables(bytes(ifd.get(JPEG_TABLES)) + b"\xff\xd9", what)
              if JPEG_TABLES in ifd else None)
    if photo == 6:
        space, sampling = "YCbCr", tuple((tuple(ifd.get(YCBCR_SUBSAMPLING, (2, 2))) + (2, 2))[:2])
    else:
        space, sampling = "raw", (1, 1)
    fn = _unpacker(mode, rawmode, what)[1]
    px = _new_image(mode, ysize, xsize)
    seg_w = lt.tw if lt.tiled else xsize
    ys = range(0, ysize, lt.tl if lt.tiled else lt.rps)
    xs = range(0, xsize, lt.tw) if lt.tiled else range(0, 1)
    for y in ys:
        for x in xs:
            if lt.tiled:
                index, seg_h = (y // lt.tl) * lt.across + x // lt.tw, lt.tl
                last = False
            else:
                index, seg_h = y // lt.rps, min(lt.rps, ysize - y)
                last = y + seg_h >= ysize
            # libtiff's std_fill_input_buffer feeds libjpeg a fake EOI marker
            # where a strip's data ends: read on as from a marker
            comps, _, frame = decode_components(lt.stream(index) + b"\xff\xd9", what, tables,
                                                space, strip=True)
            sf = [(c["h"], c["v"]) for c in frame["comps"]]
            if len(sf) != spp:
                raise ValueError(f"{what}: TIFF JPEG strip of {len(sf)} components, {spp} "
                                 "samples per pixel (libtiff: improper JPEG component count)")
            if sf[0] != sampling or any(f != (1, 1) for f in sf[1:]):
                raise ValueError(f"{what}: TIFF JPEG strip sampled {sf}, expected {sampling} "
                                 "then 1x1 (libtiff: improper JPEG sampling factors)")
            if frame["w"] != seg_w or frame["h"] < seg_h or (frame["h"] > seg_h and not last):
                raise ValueError(f"{what}: TIFF JPEG strip of {frame['w']} x {frame['h']}, "
                                 f"expected {seg_w} x {seg_h} (libtiff: improper JPEG strip "
                                 "size)")
            if space == "YCbCr":
                rows = _ycc_to_rgb(*comps)[:seg_h]
            else:
                rows = np.stack(comps, axis=-1)[:seg_h]
            n = min(seg_h, ysize - y)
            tw = min(seg_w, xsize - x)
            vals = fn(np.ascontiguousarray(rows[:n]).reshape(n, -1), seg_w)
            px[y:y + n, x:x + tw] = vals[:, :tw]
    return px


# --------------------------------------------------------------------------
# YCbCr through libtiff's RGBA reader (tif_getimage.c, tif_color.c)


def _f32(x):
    return np.float32(x)


def _ycbcr_tables(luma, ref):
    """tif_color.c TIFFYCbCrToRGBInit in float32: Cr_r, Cb_b, Cr_g, Cb_g,
    Y [256] int64."""
    def fix(v):
        return int(np.float64(np.float32(v) * np.float32(65536)) + 0.5)

    def clampf(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    lr, lg, lb = (_f32(v) for v in luma)
    f1 = _f32(2) - _f32(2) * lr
    d1 = fix(clampf(f1, _f32(0), _f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clampf(f2, _f32(0), _f32(2)))
    f3 = _f32(2) - _f32(2) * lb
    d3 = fix(clampf(f3, _f32(0), _f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clampf(f4, _f32(0), _f32(2)))
    ref = [_f32(v) for v in ref]

    def code2v(c, rb, rw, cr):
        den = (rw - rb) if (rw - rb) != 0 else _f32(1)
        return (_f32(c) - rb) * _f32(cr) / den

    def clampw(v, lo, hi):
        return int(lo if v < lo else hi if v > hi else v)

    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, ref[4] - _f32(128), ref[5] - _f32(128), 127), -128.0 * 32, 128.0 * 32)
        cb = clampw(code2v(x, ref[2] - _f32(128), ref[3] - _f32(128), 127), -128.0 * 32, 128.0 * 32)
        tabs[0, i] = (d1 * cr + 32768) >> 16
        tabs[1, i] = (d3 * cb + 32768) >> 16
        tabs[2, i] = d2 * cr
        tabs[3, i] = d4 * cb + 32768
        tabs[4, i] = clampw(code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32)
    return tabs


def _ycbcr_to_rgb(y, cb, cr, tabs):
    """TIFFYCbCrtoRGB on uint8 arrays."""
    yv = tabs[4][y]
    r = np.clip(yv + tabs[0][cr], 0, 255)
    g = np.clip(yv + ((tabs[3][cb] + tabs[2][cr]) >> 16), 0, 255)
    b = np.clip(yv + tabs[1][cb], 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _ycbcr_rgba(lt, ifd, xsize, ysize, planar, spp, bits, what, sampling=None):
    """PIL's _decodeAsRGBA: TIFFRGBAImageGet over blocks of RowsPerStrip (or
    TileLength) rows, for 8-bit 3-sample contiguous YCbCr: each strip or
    tile holds blocks of hs x vs luma samples and one Cb and one Cr, the
    chroma repeated over its block (tif_getimage.c putcontig8bitYCbCr*).
    The orientation is left to PIL's transpose, as for the other forms.
    ``sampling``: the subsampling libtiff's codec gives (old-style JPEG),
    else the tag's."""
    if spp != 3 or bits != 8:
        raise ValueError(f"{what}: YCbCr TIFF of {spp} x {bits}-bit samples (libtiff's RGBA "
                         "reader refuses it)")
    hs, vs = sampling or (tuple(ifd.get(YCBCR_SUBSAMPLING, (2, 2))) + (2, 2))[:2]
    if planar == 2 and (hs, vs) != (1, 1):
        raise ValueError(f"{what}: YCbCr TIFF in planes subsampled {hs}x{vs} (libtiff's RGBA "
                         "reader takes planes 1x1 only)")
    if (hs, vs) not in ((4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
        raise ValueError(f"{what}: YCbCr TIFF subsampled {hs}x{vs} is not supported (libtiff "
                         "reads 4x4 with a short buffer and refuses the others)")
    luma = ifd.get(YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))
    ref = ifd.get(REFERENCE_BW, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if len(luma) != 3 or len(ref) != 6:
        raise ValueError(f"{what}: YCbCr TIFF with coefficients {luma} and reference "
                         f"black and white {ref}")
    if lt.predictor != 1:
        raise ValueError(f"{what}: YCbCr TIFF with predictor {lt.predictor} that is not "
                         "JPEG-compressed is not supported (libtiff differences its "
                         "subsampled blocks as pixels)")
    block_rows = lt.tl if lt.tiled else ifd.lt(ROWS_PER_STRIP, (0xFFFFFFFF,), 1)[0]
    if (2 ** 31 - 1) // (xsize * 4) < (ysize if block_rows == 0xFFFFFFFF else block_rows):
        raise ValueError(f"{what}: YCbCr TIFF of {block_rows} rows a block {xsize} wide (PIL: "
                         "its RGBA buffer's size overflows, decoder error -9)")
    tabs = _ycbcr_tables(luma, ref)
    unit = hs * vs + 2
    bw, bh = (lt.tw, lt.tl) if lt.tiled else (xsize, lt.rps)

    def block(index, rows):
        if planar == 2:  # one plane each of Y, Cb and Cr
            y, cb, cr = (lt.block_bytes(index + k * lt.per_plane, rows * bw).reshape(rows, bw)
                         for k in range(3))
            return _ycbcr_to_rgb(y, cb, cr, tabs)
        nby, nbx = -(-rows // vs), -(-bw // hs)
        if lt.comp == 6:
            raw = lt.ojpeg.block(index, rows, lt.rps).reshape(nby, nbx, unit)
        else:
            raw = lt.block_bytes(index, nby * nbx * unit).reshape(nby, nbx, unit)
        y = raw[..., :hs * vs].reshape(nby, nbx, vs, hs).transpose(0, 2, 1, 3)
        y = y.reshape(nby * vs, nbx * hs)
        cb = np.repeat(np.repeat(raw[..., hs * vs], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(raw[..., hs * vs + 1], vs, 0), hs, 1)
        return _ycbcr_to_rgb(y, cb, cr, tabs)

    px = np.zeros((ysize, xsize, 4), np.uint8)
    px[..., 3] = 255
    for y0 in range(0, ysize, bh):
        n = min(bh, ysize - y0)
        if lt.tiled:
            band = np.zeros((bh, lt.across * bw, 3), np.uint8)
            for i in range(lt.across):
                band[:, i * bw:(i + 1) * bw] = block((y0 // bh) * lt.across + i, bh)[:bh, :bw]
            rgb = band[:n, :xsize]
        else:
            rgb = block(y0 // bh, n)[:n, :xsize]
        px[y0:y0 + n, :, :3] = rgb
    return px


# --------------------------------------------------------------------------
# convert("RGB") and exif_transpose


def _to_rgb(px, mode, palette):
    if mode in ("1", "L"):
        grey = px[..., 0]
    elif mode == "LA":
        grey = px[..., 0]
    elif mode in ("P", "PA"):
        return palette[px[..., 0]]
    elif mode in ("I;16", "I;16B", "I"):
        grey = np.clip(px[..., 0], 0, 255).astype(np.uint8)
    elif mode == "F":
        grey = _f_to_grey(px[..., 0])
    elif mode == "CMYK":
        return _cmyk_to_rgb(px)
    elif mode == "LAB":
        return lcms.lab8_to_rgb8(px[..., :3])
    else:
        return np.ascontiguousarray(px[..., :3])
    return np.repeat(grey[..., None], 3, axis=-1)


def _orient(rgb, orientation):
    """PIL's exif_transpose for orientations 2-8."""
    if orientation == 2:
        rgb = rgb[:, ::-1]
    elif orientation == 3:
        rgb = rgb[::-1, ::-1]
    elif orientation == 4:
        rgb = rgb[::-1]
    elif orientation == 5:
        rgb = rgb.transpose(1, 0, 2)
    elif orientation == 6:
        rgb = rgb.transpose(1, 0, 2)[:, ::-1]
    elif orientation == 7:
        rgb = rgb.transpose(1, 0, 2)[::-1, ::-1]
    elif orientation == 8:
        rgb = rgb.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(rgb)
