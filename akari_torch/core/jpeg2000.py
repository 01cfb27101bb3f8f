"""JPEG 2000 decoding without PIL: JP2 files and raw J2K codestreams.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``), which decodes JPEG 2000
with its bundled OpenJPEG 2.5 tile by tile and unpacks each tile itself
(``Jpeg2KDecode.c``); the card's machine has no PIL. ``decode_jpeg2000``
returns the [H, W, 3] uint8 pixels of PIL's ``convert("RGB")``:

- the header is read as ``Jpeg2KImagePlugin`` reads it: the size and mode
  from the SIZ segment of a codestream (``L``, ``I;16`` above 8 bits, ``LA``,
  ``RGB``, ``RGBA`` by component count) or from a JP2 file's ``ihdr`` box,
  ``CMYK`` from a ``colr`` box of enumerated colour space 12, ``P`` / ``PA``
  from a ``pclr`` box of at most 8-bit entries, whose colours PIL adds to its
  palette one by one, merging repeats; a header the plugin cannot parse
  makes PIL try the formats after JPEG 2000 (``NextFormat``);
- the JP2 boxes are checked as OpenJPEG checks them (signature, ``ftyp``,
  ``jp2h`` with ``ihdr``, ``colr``, ``bpcc``, ``pclr``, ``cmap``, ``cdef``;
  the codestream box), and the ``colr`` box gives OpenJPEG's colour space;
- ``akari_torch/native/j2k_decode.cpp`` decodes the codestream as OpenJPEG
  does and unpacks each tile as Pillow does, per mode and colour space;
  the palette, CMYK (``image_formats._cmyk_to_rgb``) and 16-bit grey (PIL's
  ``I;16``, clipped at 255) are converted to RGB here.

HTJ2K (JPEG 2000 Part 15) code-blocks are read as OpenJPEG's ``ht_dec.c``
reads them, with its VLC tables compiled in (``j2k_ht_tables.h``):

- tier 2 gives a code-block's first segment the cleanup pass alone and the
  next segment every other pass of the packet, its length in Lblock +
  floor(log2(passes)) bits; placeholder passes are not understood: with an
  empty second segment the block is read as its cleanup pass (OpenJPEG
  warns), with data there it is refused (more than 3 passes);
- the cleanup pass (MEL, VLC / UVLC, MagSgn), then SigProp (stripes of 4
  rows, groups of 4 columns whose signs follow their significance bits) and
  MagRef; the samples leave at the MQ path's fixed point (the band's
  bit-planes ``Mb`` above the zero bit-planes, the bin centre set), so the
  same dequantisation follows;
- OpenJPEG's limits: more than 3 passes, ``Mb`` above 30, more zero
  bit-planes than ``Mb``, bad segment lengths, Scup outside [2, min(Lcup,
  4079)], an 0xFF then a byte above 0x8F at the MEL stream's start, U_q above
  the zero bit-planes + 1, significant samples outside the block and an ROI
  shift refuse the file; a second segment of no bytes, or zero bit-planes
  equal to ``Mb``, leave the cleanup pass alone; the mixed HT style (0x80)
  is refused when COD / COC is read;
- a Part-15 JP2 (brand ``jph ``) is read like any JP2, as PIL reads it.

The Part-2 MCT, MCC, MCO and CBD markers are read as OpenJPEG reads them:
their size and index checks refuse what OpenJPEG refuses, and what it skips
with a warning is skipped; an MCO zeroes every component's DC level shift
and then takes the offsets of an MCC's offset array (only the first MCC
record is matched, as in ``opj_j2k_add_mct``); a CBD sets the precision and
sign, the DC level shift staying SIZ's. COD transform 2 is refused, as
OpenJPEG refuses it. A reversible DC level shift adds in 32 bits, wrapping.

Where OpenJPEG or Pillow refuses a file (a truncated or corrupt codestream,
a mode Pillow has no unpacker for) the port raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, _cmyk_to_rgb, note_band, note_mode

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's colour spaces (opj_image_t.color_space) by JP2 enumerated colour
# space; any other (an ICC profile, CIELab, no colr box) is read as PIL reads
# a raw codestream's, unspecified
_CS_UNSPECIFIED = 0
_ENUMCS = {16: 1, 17: 2, 18: 3, 24: 4, 12: 5}  # sRGB, grey, sYCC, e-sYCC, CMYK

def ycbcr_tables():
    """Pillow's ConvertYCbCr.c tables R_Cr, G_Cb, G_Cr, B_Cb ([4, 256] int32):
    ``(int)(c * 64 * (i - 128) + 0.5)``, truncated toward zero as C casts."""
    x = np.arange(256, dtype=np.float64) - 128.0
    coef = np.array([1.402, -0.34414, -0.71414, 1.772])[:, None]
    return np.trunc(coef * 64.0 * x + 0.5).astype(np.int32)


_YCC = ycbcr_tables()


# ------------------------------------------------------------------ PIL's header parse

class _Syntax(Exception):
    """The plugin's SyntaxError / struct.error / IndexError: PIL tries the next format."""


class _Short(Exception):
    """The plugin's OSError from a short read: PIL raises it."""


class _BoxReader:
    """``Jpeg2KImagePlugin.BoxReader`` over ``data`` from ``pos``."""

    def __init__(self, data, pos=0, length=-1):
        self.data, self.pos = data, pos
        self.has_length, self.length = length >= 0, length
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.pos + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read_bytes(self, n):
        if not self._can_read(n):
            raise _Syntax("Not enough data in header")
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise _Short(f"Expected to read {n} bytes but only got {len(out)}.")
        if self.remaining > 0:
            self.remaining -= n
        return out

    def read_fields(self, fmt):
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def read_boxes(self):
        size = self.remaining
        return _BoxReader(self.read_bytes(size), 0, size)

    def has_next_box(self):
        return self.pos + self.remaining < self.length if self.has_length else True

    def next_box_type(self):
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.read_fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read_fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _Syntax("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _getcolor(palette, colors, mode, color):
    """``ImagePalette.getcolor`` of a tuple: a colour PIL has seen keeps its
    index; a new one takes index ``len(palette) // len(mode)`` and is written
    there, or appended."""
    if mode == "RGB" and len(color) == 4:
        if color[3] != 255:
            raise ValueError("cannot add non-opaque RGBA color to RGB palette")
        color = color[:3]
    elif mode == "RGBA" and len(color) == 3:
        color += (255,)
    if color in colors:
        return
    n = len(mode)
    index = len(palette) // n
    if index >= 256:
        raise ValueError("cannot allocate more than 256 colors")
    colors[color] = index
    if index * n < len(palette):
        palette[:] = palette[:index * n] + bytes(color) + palette[index * n + n:]
    else:
        palette += bytes(color)


def _parse_jp2_header(data):
    """``_parse_jp2_header`` from the byte after the signature box: (size,
    mode, palette (mode, bytes) or None, position after the jp2h box)."""
    reader = _BoxReader(data, 12)
    while True:  # ends at jp2h, or raises when the boxes run out
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            max_bitdepth = max((0,) + header.read_fields(">" + "B" * npc))
            if max_bitdepth <= 8:
                pmode = "RGBA" if npc == 4 else "RGB"
                raw, colors = bytearray(), {}
                for _ in range(ne):
                    _getcolor(raw, colors, pmode, header.read_fields(">" + "B" * npc))
                palette = (pmode, bytes(raw))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _Syntax("Malformed JP2 header")
    return size, mode, palette, reader.pos


def _parse_comment(data, pos):
    """``Jpeg2KImageFile._parse_comment``: walk the marker segments after SIZ
    until SOT, EOC or a COM segment (its reads can fail as PIL's do)."""
    seen = set()
    while True:
        marker = data[pos:pos + 2]
        pos += len(marker)
        if not marker:
            return
        if len(marker) < 2:
            raise _Syntax("marker cut short")  # IndexError
        if marker[1] in (0x90, 0xD9):
            return
        hdr = data[pos:pos + 2]
        pos += len(hdr)
        if len(hdr) < 2:
            raise _Syntax("marker length cut short")  # struct.error
        length = hdr[0] << 8 | hdr[1]
        if marker[1] == 0x64:
            return
        pos = max(pos + length - 2, 0)
        if pos in seen:  # a zero length that steps back forever
            raise ValueError("marker segments that loop")
        seen.add(pos)


def _parse_codestream(data):
    """``_parse_codestream``: (size, mode) from the SIZ segment after the
    four-byte signature; the comment walk follows."""
    hdr = data[4:6]
    if len(hdr) < 2:
        raise _Syntax("SIZ length cut short")
    lsiz = hdr[0] << 8 | hdr[1]
    body = data[6:] if lsiz - 2 < 0 else data[6:6 + lsiz - 2]
    siz = hdr + body
    if len(siz) < 38:
        raise _Syntax("SIZ segment cut short")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    if csiz == 1:
        if len(siz) < 39:
            raise _Syntax("SIZ segment cut short")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _Syntax("unable to determine J2K image mode")
    _parse_comment(data, 6 + len(body))
    return (xsiz - xosiz, ysiz - yosiz), mode


def pil_header(data):
    """The size, mode and palette PIL's plugin reads from ``data`` (a J2K or
    JP2 file); raises ``_Syntax`` where PIL tries the next format."""
    if data[:4] == J2K_SIGNATURE:
        size, mode = _parse_codestream(data)
        return size, mode, None
    size, mode, palette, pos = _parse_jp2_header(data)
    if data[pos:pos + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
        hdr = data[pos + 12:pos + 14]
        if len(hdr) < 2:
            raise _Syntax("SIZ length cut short")
        _parse_comment(data, pos + 14 + (hdr[0] << 8 | hdr[1]) - 2)
    return size, mode, palette


# ------------------------------------------------------------------ OpenJPEG's JP2 boxes

_SIGNATURE, _FILE_TYPE, _HEADER, _CODESTREAM, _UNKNOWN = 1, 2, 4, 8, 0x7FFFFFFF


class _Jp2:
    """``opj_jp2_read_header_procedure`` and the box handlers: the offset of
    the codestream, the ihdr size and the colour space OpenJPEG gives the
    image. Raises ``ValueError`` where OpenJPEG fails."""

    def __init__(self, data):
        self.data = data
        self.state = 0
        self.has_jp2h = self.has_ihdr = self.has_colr = False
        self.ihdr = None   # (w, h, numcomps, bpc)
        self.enumcs = 0
        self.pclr = None   # number of palette columns
        self.cmap = self.cdef = False

    def fail(self, msg):
        raise ValueError(f"OpenJPEG: {msg}")

    def read(self):
        data, pos = self.data, 0
        while True:
            hdr = data[pos:pos + 8]
            if len(hdr) != 8:
                pos = len(data)
                break
            length, btype = struct.unpack(">I4s", hdr)
            nread, pos = 8, pos + 8
            if length == 0:
                length = len(data) - pos + 8
            elif length == 1:
                xl = data[pos:pos + 8]
                if len(xl) != 8:
                    pos = len(data)
                    break
                high, length = struct.unpack(">II", xl)
                nread, pos = 16, pos + 8
                if high:
                    self.fail("Cannot handle box sizes higher than 2^32")
            if btype == b"jp2c":
                if self.state & _HEADER:
                    self.state |= _CODESTREAM
                    return pos
                self.fail("bad placed jpeg codestream")
            if length == 0:
                self.fail("Cannot handle box of undefined sizes")
            if length < nread:
                self.fail(f"invalid box size {length}")
            size = length - nread
            handler = {b"jP  ": self.read_jp, b"ftyp": self.read_ftyp,
                       b"jp2h": self.read_jp2h}.get(btype)
            if handler is None and btype in self.IMG_BOXES:
                if self.state & _HEADER:
                    handler = self.IMG_BOXES[btype].__get__(self)
                else:
                    self.state |= _UNKNOWN
                    if size > len(data) - pos:
                        self.fail("Problem with skipping JPEG2000 box, stream error")
                    pos += size
                    continue
            if handler is not None:
                if size > len(data) - pos:
                    self.fail(f"Invalid box size {size} for box {btype!r}")
                handler(data[pos:pos + size])
                pos += size
                continue
            if not self.state & _SIGNATURE:
                self.fail("Malformed JP2 file format: first box must be JPEG 2000 signature box")
            if not self.state & _FILE_TYPE:
                self.fail("Malformed JP2 file format: second box must be file type box")
            self.state |= _UNKNOWN
            if size > len(data) - pos:
                self.fail("Problem with skipping JPEG2000 box, stream error")
            pos += size
        if not self.has_jp2h:
            self.fail("JP2H box missing. Required.")
        if not self.has_ihdr:
            self.fail("IHDR box_missing. Required.")
        return pos

    def read_jp(self, b):
        if self.state != 0:
            self.fail("The signature box must be the first box in the file.")
        if len(b) != 4:
            self.fail("Error with JP signature Box size")
        if b != b"\r\n\x87\n":
            self.fail("Error with JP Signature : bad magic number")
        self.state |= _SIGNATURE

    def read_ftyp(self, b):
        if self.state != _SIGNATURE:
            self.fail("The ftyp box must be the second box in the file.")
        if len(b) < 8 or (len(b) - 8) % 4:
            self.fail("Error with FTYP signature Box size")
        self.state |= _FILE_TYPE

    def read_jp2h(self, b):
        if (self.state & _FILE_TYPE) != _FILE_TYPE:
            self.fail("The  box must be the first box in the file.")
        has_ihdr, pos = False, 0
        while pos < len(b):
            left = len(b) - pos
            if left < 8:
                self.fail("Cannot handle box of less than 8 bytes")
            length, btype = struct.unpack(">I4s", b[pos:pos + 8])
            nread = 8
            if length == 1:
                if left < 16:
                    self.fail("Cannot handle XL box of less than 16 bytes")
                high, length = struct.unpack(">II", b[pos + 8:pos + 16])
                nread = 16
                if high:
                    self.fail("Cannot handle box sizes higher than 2^32")
                if length == 0:
                    self.fail("Cannot handle box of undefined sizes")
            elif length == 0:
                self.fail("Cannot handle box of undefined sizes")
            if length < nread:
                self.fail("Box length is inconsistent.")
            if length > left:
                self.fail("Stream error while reading JP2 Header box: box length is inconsistent.")
            handler = self.IMG_BOXES.get(btype)
            if handler is not None:
                handler(self, b[pos + nread:pos + length])
            if btype == b"ihdr":
                has_ihdr = True
            pos += length
        if not has_ihdr:
            self.fail("Stream error while reading JP2 Header box: no 'ihdr' box.")
        self.state |= _HEADER
        self.has_jp2h = True

    def read_ihdr(self, b):
        if self.ihdr is not None:
            return  # "Ignoring ihdr box. First ihdr box already read"
        if len(b) != 14:
            self.fail("Bad image header box (bad size)")
        h, w, nc, bpc = struct.unpack(">IIHB", b[:11])
        if not 1 <= nc <= 16384:
            self.fail("Invalid number of components (ihdr)")
        self.ihdr = (w, h, nc, bpc)
        self.has_ihdr = True

    def read_colr(self, b):
        if len(b) < 3:
            self.fail("Bad COLR header box (bad size)")
        if self.has_colr:
            return  # only the first colour specification box counts
        meth = b[0]
        if meth == 1:
            if len(b) < 7:
                self.fail(f"Bad COLR header box (bad size: {len(b)})")
            self.enumcs = struct.unpack(">I", b[3:7])[0]
            self.has_colr = True
        elif meth == 2:
            self.has_colr = True

    def read_bpcc(self, b):
        if self.ihdr is None or len(b) != self.ihdr[2]:
            self.fail("Bad BPCC header box (bad size)")

    def read_pclr(self, b):
        if self.pclr is not None or len(b) < 3:
            self.fail("Invalid PCLR box")
        ne, npc = struct.unpack(">HB", b[:3])
        if ne == 0 or ne > 1024:
            self.fail(f"Invalid PCLR box. Reports {ne} entries")
        if npc == 0:
            self.fail("Invalid PCLR box. Reports 0 palette columns")
        if len(b) < 3 + npc:
            self.fail("Invalid PCLR box")
        nbytes = [min(((b[3 + i] & 0x7F) + 1 + 7) >> 3, 4) for i in range(npc)]
        if len(b) < 3 + npc + ne * sum(nbytes):
            self.fail("Invalid PCLR box")
        self.pclr = npc

    def read_cmap(self, b):
        if self.pclr is None:
            self.fail("Need to read a PCLR box before the CMAP box.")
        if self.cmap:
            self.fail("Only one CMAP box is allowed.")
        if len(b) < self.pclr * 4:
            self.fail("Insufficient data for CMAP box.")
        self.cmap = True

    def read_cdef(self, b):
        if self.cdef:
            self.fail("Only one CDEF box is allowed.")
        if len(b) < 2:
            self.fail("Insufficient data for CDEF box.")
        n = struct.unpack(">H", b[:2])[0]
        if n == 0:
            self.fail("Number of channel description is equal to zero in CDEF box.")
        if len(b) < 2 + 6 * n:
            self.fail("Insufficient data for CDEF box.")
        self.cdef = True

    IMG_BOXES = {b"ihdr": read_ihdr, b"colr": read_colr, b"bpcc": read_bpcc,
                 b"pclr": read_pclr, b"cmap": read_cmap, b"cdef": read_cdef}


# ------------------------------------------------------------------ decoding

def _palette_lut(palette):
    """PIL's palette of a ``P`` image as a [256, 3] table: the entries PIL
    put, then black."""
    pmode, raw = palette
    lut = np.zeros((256, 3), np.uint8)
    step = 4 if pmode == "RGBA" else 3
    n = min(len(raw) // step, 256)
    if n:
        lut[:n] = np.frombuffer(raw, np.uint8, n * step).reshape(n, step)[:, :3]
    return lut


def decode_jpeg2000(data, what="JPEG 2000"):
    from ..native.loader import load

    data = bytes(data)
    if data[:4] != J2K_SIGNATURE and data[:12] != JP2_SIGNATURE:
        raise NextFormat(f"{what}: not a JPEG 2000 file")
    try:
        (w, h), mode, palette = pil_header(data)
    except _Syntax as e:
        raise NextFormat(f"{what}: {e}") from None
    except (_Short, ValueError) as e:
        raise ValueError(f"{what}: JPEG 2000 header: {e}") from None
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: JPEG 2000 of size {w} x {h}")
    _check_size(w, h, what, "JPEG 2000")
    note_mode(mode)
    if data[:4] == J2K_SIGNATURE:
        start, ihdr_w, ihdr_h, cs = 0, 0, 0, _CS_UNSPECIFIED
    else:
        try:
            jp2 = _Jp2(data)
            start = jp2.read()
        except ValueError as e:
            raise ValueError(f"{what}: broken JPEG 2000 file ({e})") from None
        ihdr_w, ihdr_h = jp2.ihdr[0], jp2.ihdr[1]
        cs = _ENUMCS.get(jp2.enumcs, _CS_UNSPECIFIED)
    px = np.zeros((h, w, 4), np.uint8)
    grey16 = np.zeros((h, w), np.uint16) if mode == "I;16" else None
    err = ctypes.create_string_buffer(512)
    rc = load("j2k").akr_j2k_decode(
        data, len(data), start, ihdr_w, ihdr_h, cs, mode.encode(), w, h,
        px.ctypes.data_as(ctypes.c_void_p),
        grey16.ctypes.data_as(ctypes.c_void_p) if grey16 is not None else None,
        _YCC.ctypes.data_as(ctypes.c_void_p), err, len(err))
    if rc:
        msg = err.value.decode(errors="replace")
        raise ValueError(f"{what}: broken JPEG 2000 data (OpenJPEG / Pillow refuse it: {msg})")
    if mode == "I;16":
        note_band(grey16, "<")
        return np.repeat(np.minimum(grey16, 255).astype(np.uint8)[..., None], 3, axis=-1)
    if mode in ("P", "PA"):
        note_band(px[..., 0])
        return _palette_lut(palette)[px[..., 0]]
    if mode in ("L", "LA"):
        return np.repeat(px[..., :1], 3, axis=-1)
    if mode == "CMYK":
        return _cmyk_to_rgb(px)
    return np.ascontiguousarray(px[..., :3])
