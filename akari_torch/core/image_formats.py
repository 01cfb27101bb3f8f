"""TGA, BMP / DIB, PNM, GIF, PSD, MSP and XBM decoding without PIL.

The JAX package reads every texture with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. Each decoder here returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of the same file, and raises ``ValueError`` naming the
format and the form where PIL refuses the file (or reads it only as a
form this module does not decode, which the message says).

- TGA (``TgaImagePlugin``; no signature: ``tga_header`` accepts a file by
  the sanity of its header, as PIL does): image types 1/2/3 and their
  run-length forms 9/10/11; 1- and 8-bit grey, 16-bit grey + alpha,
  8-bit indices into a 16- or 24-bit colour map that starts at its first
  entry index; 16 (X1R5G5B5), 24 and 32-bit true colour; every origin. A
  run packet may not cross a scanline, a literal packet may.
- BMP (``BmpImagePlugin``): the OS/2 core header and the Windows INFO
  headers of 40-124 bytes, 1/4/8-bit palettes (a grey palette makes PIL
  read the indices as grey levels), 16-bit 5-5-5, bitfields of the masks
  PIL accepts, 24 and 32 bits, RLE8 and RLE4 through PIL's own decoder
  (its delta escape reads two bytes more than the escape holds), top-down
  rows. A DIB file (``DibImageFile``) is the same bitmap without the BMP
  file header, its pixels right after the header, masks and palette.
- PNM (``PpmImagePlugin``): P1-P6 with comments; ``maxval`` other than 255
  scales with Python's ``round``; a P2/P5 above 255 reads as PIL's mode
  ``I``, which ``convert("RGB")`` clips at 255 (a quirk kept for parity).
  PIL's other modes: ``Pf`` (PFM, mode ``F``: rows bottom up,
  little-endian under a negative scale, ``convert("RGB")`` truncating
  toward zero and clipping to 0..255, NaN to 0), ``P0CMYK`` and
  ``PyCMYK`` (cmyk2rgb), ``PyRGBA`` (the alpha dropped) and ``PyP``
  (indices into PIL's default palette, all black), each raw, at 8 or 16
  bits. Another magic (colour ``PF`` among them) makes PIL try the formats
  after PNM (``NextFormat``).
- GIF (``GifImagePlugin``): the first frame, on the logical screen (grown
  to hold the frame), the pixels outside the frame index 0, or the
  transparency index when there is one; LZW through
  ``akari_torch/native/gif_lzw.cpp``, which follows PIL's decoder and
  the reads that feed it (an early end code is read past when more of
  the file follows the bytes read so far); a
  palette whose entries are the grey ramp makes PIL read the indices as
  grey levels.
- PSD (``PsdImagePlugin``): the composite image, raw or PackBits, in
  bitmap, grey, indexed, RGB(A), CMYK (PIL inverts the samples),
  multichannel, duotone and Lab modes at 8 bits (1 for bitmap). Lab keeps
  three channels whatever the file holds, its a and b planes as stored
  (offset by 128), and ``convert("RGB")`` is LittleCMS 2.17's Lab -> sRGB
  transform (``core/lcms.py``).
- MSP (``MspImagePlugin``): Windows Paint bitmaps, white where a bit is
  set; a 32-byte header whose 16-bit words XOR to 0 (else PIL tries the
  next format). ``DanM`` (version 1): raw rows; ``LinS`` (version 2): a map
  of each row's encoded length, then the rows as runs (a zero byte, a
  count and a byte repeated) and literals (a count and that many bytes). An
  empty row is white. PIL joins the rows' output and reads it as one raw
  image, so a row that decodes to more or fewer bytes than the stride
  shifts every row after it (a literal cut by the row's end is kept short),
  and output short of the image is refused.
- XBM (``XbmImagePlugin``): the ``#define`` width and height (and the
  optional hotspot) and ``_bits[]`` within the first 512 bytes; then PIL's
  C decoder takes, after each ``x``, the next two characters as hex
  digits (any other character reads 0; ``0x1,`` is 0x10), bits least
  significant first, white where set.

Palette indices past a palette's end read black, as PIL's conversion
gives them; 5- and 6-bit channels expand as PIL's unpackers do, v * 255 //
31 (or 63).
"""

from __future__ import annotations

import contextvars
import re
import struct

import numpy as np

from .lcms import lab8_to_rgb8

# PIL refuses images of more pixels than this (2 * Image.MAX_IMAGE_PIXELS,
# its DecompressionBombError)
MAX_PIXELS = 2 * 89_478_485
# the bytes PIL reads at a time to feed a decoder (ImageFile.MAXBLOCK)
PIL_READ_BLOCK = 65536


class NextFormat(ValueError):
    """A plugin's header parse failed the way ``Image.open`` catches
    (``SyntaxError``, ``IndexError``, ``TypeError``, ``struct.error``), so
    PIL goes on to try the formats after it; ``decode_image`` does too."""


# the box ``note_mode`` fills for ``core/image.py::decode_with_mode``
_MODE = contextvars.ContextVar("akari_pil_mode", default=None)


def note_mode(mode):
    """Record ``mode``, PIL's ``Image.open(...).mode`` of the image being
    decoded, for ``core/image.py::decode_with_mode``. The first note of a
    decode stands: a decoder of embedded data (a TIFF's JPEG strips, an
    ICO's DIB) called after its container noted the mode changes nothing."""
    box = _MODE.get()
    if box is not None and "mode" not in box:
        box["mode"] = mode


def note_band(values, order=None):
    """Record the bytes PIL's C ``Image.merge`` copies from the image being
    decoded when it is one band of a merge (an IPTC band): the first W
    bytes of each row of its loaded core, [H, W] uint8. ``values`` are
    those bytes (palette indices, or grey levels under a colour map PIL
    attached), or (``order`` "<" or ">") [H, W] 16-bit samples stored in
    that byte order. The first note of a decode stands."""
    box = _MODE.get()
    if box is None or "band" in box:
        return
    v = np.asarray(values)
    if order is not None:
        h, w = v.shape
        v = np.ascontiguousarray(v.astype(order + "u2")).view(np.uint8).reshape(h, 2 * w)[:, :w]
    box["band"] = v


def _check_size(w, h, what, form):
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{what}: {form} of size {w} x {h}"
                         + (" (more pixels than PIL opens)" if w > 0 and h > 0 else ""))


def _u16(b, o):
    return b[o] | b[o + 1] << 8


def _u32(b, o):
    return int.from_bytes(b[o:o + 4], "little")


def _expand(v, bits):
    """n-bit channel values -> 0..255 as PIL's BGR;15 / BGR;16 unpackers."""
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _lut(entries):
    """[n, 3] uint8 palette -> [256, 3] lookup, past the end black."""
    lut = np.zeros((256, 3), np.uint8)
    n = min(len(entries), 256)
    lut[:n] = entries[:n]
    return lut


def _grey(v):
    return np.repeat(np.asarray(v, np.uint8)[..., None], 3, axis=-1)


def _bits(rows, w):
    """[h, stride] bytes -> [h, w] 0/1, MSB first."""
    return np.unpackbits(rows, axis=1)[:, :w]


def _word15(words):
    """uint16 X1R5G5B5 -> [..., 3] RGB (PIL's BGR;15 / BGRA;15Z)."""
    return np.stack([_expand((words >> 10) & 31, 5), _expand((words >> 5) & 31, 5),
                     _expand(words & 31, 5)], axis=-1)


# --------------------------------------------------------------------------
# TGA

_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
              (2, 24): "BGR", (2, 32): "BGRA"}


def tga_header(data):
    """The TGA header fields if PIL's TGA plugin accepts ``data`` (it has
    no signature), else None."""
    if len(data) < 18:
        return None
    id_len, cmtype, imtype = data[0], data[1], data[2]
    w, h, depth, flags = _u16(data, 12), _u16(data, 14), data[16], data[17]
    if (cmtype not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32)
            or imtype not in (1, 2, 3, 9, 10, 11)):
        return None
    return dict(id_len=id_len, cmtype=cmtype, imtype=imtype, cm_start=_u16(data, 3),
                cm_len=_u16(data, 5), cm_depth=data[7], w=w, h=h, depth=depth, flags=flags)


def _tga_rle(data, pos, unit, line, total, what):
    """TGA run-length packets from ``pos`` -> ``total`` bytes of scanlines
    of ``line`` bytes, as PIL's TgaRleDecode: a run packet that crosses a
    scanline is an overrun, a literal packet continues on the next."""
    out = bytearray(total)
    n_data = len(data)
    x = 0  # bytes written
    while x < total:
        if pos >= n_data:
            raise ValueError(f"{what}: TGA run-length data is truncated")
        head = data[pos]
        n = unit * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + unit > n_data:
                raise ValueError(f"{what}: TGA run-length data is truncated")
            if x % line + n > line:
                raise ValueError(f"{what}: TGA run packet crosses a scanline (PIL refuses it)")
            out[x:x + n] = data[pos + 1:pos + 1 + unit] * (n // unit)
            pos += 1 + unit
        else:
            if pos + 1 + n > n_data:
                raise ValueError(f"{what}: TGA run-length data is truncated")
            k = min(n, total - x)
            out[x:x + k] = data[pos + 1:pos + 1 + k]
            pos += 1 + n
        x += n
    return np.frombuffer(bytes(out), np.uint8)


def decode_tga(data, what="TGA"):
    hd = tga_header(data)
    if hd is None:
        raise ValueError(f"{what}: not a TGA file")
    imtype, depth, w, h = hd["imtype"], hd["depth"], hd["w"], hd["h"]
    _check_size(w, h, what, "TGA")
    kind = imtype & 7
    form = f"TGA image type {imtype} at {depth} bits"
    pos = 18 + hd["id_len"]
    lut = None
    if hd["cmtype"]:
        start, size, mdepth = hd["cm_start"], hd["cm_len"], hd["cm_depth"]
        if mdepth not in (16, 24):
            raise ValueError(f"{what}: TGA colour map of {mdepth}-bit entries (PIL reads 16 "
                             "and 24)")
        unit = mdepth // 8
        raw = data[pos:pos + unit * size]
        pos += unit * size
        if start + len(raw) // unit > 256:
            raise ValueError(f"{what}: TGA colour map of {start + size} entries past 256")
        ent = np.frombuffer(raw[:len(raw) // unit * unit], np.uint8).reshape(-1, unit)
        ent = (_word15(ent[:, 0].astype(np.uint16) | ent[:, 1].astype(np.uint16) << 8)
               if unit == 2 else ent[:, ::-1])
        lut = _lut(np.concatenate([np.zeros((start, 3), np.uint8), ent]))
    mode = _TGA_MODES.get((kind, depth))
    if mode is None:
        raise ValueError(f"{what}: {form} is not a form PIL reads")
    note_mode({"BGRA;15Z": "RGB", "BGR": "RGB", "BGRA": "RGBA"}.get(mode, mode))
    if mode == "P" and lut is None:
        raise ValueError(f"{what}: {form} without a colour map (PIL refuses it)")
    if lut is not None and mode not in ("P", "L", "LA"):
        raise ValueError(f"{what}: {form} with a colour map (PIL refuses it)")
    line = (w * depth + 7) // 8
    total = line * h
    if imtype & 8 and depth == 1:
        raise ValueError(f"{what}: {form} (PIL's run-length decoder takes 0 bytes a pixel at "
                         "1 bit and never fills the image)")
    if imtype & 8:
        flat = _tga_rle(data, pos, (depth + 7) // 8, line, total, what)
    else:
        if len(data) - pos < total:
            raise ValueError(f"{what}: TGA image data is truncated")
        flat = np.frombuffer(data, np.uint8, total, pos)
    rows = flat.reshape(h, line)
    if not hd["flags"] & 0x20:
        rows = rows[::-1]
    if mode == "1":
        rgb = _grey(_bits(rows, w) * np.uint8(255))
    elif mode in ("P", "L", "LA"):
        # a colour map turns PIL's grey image into a palette image
        grey = rows.reshape(h, w, 2)[..., 0] if mode == "LA" else rows
        if lut is not None:
            note_band(grey[:, ::-1] if hd["flags"] & 0x10 else grey)
        rgb = _grey(grey) if lut is None else lut[grey]
    elif mode == "BGRA;15Z":
        rgb = _word15(rows.reshape(h, w, 2).astype(np.uint16) @ np.uint16([1, 256]))
    else:
        rgb = rows.reshape(h, w, depth // 8)[..., 2::-1]
    if hd["flags"] & 0x10:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)


# --------------------------------------------------------------------------
# BMP

_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_BMP_RAWBITS = {"P;1": 1, "P;4": 4, "P": 8, "1": 1, "L": 8, "BGR;15": 16, "BGR;16": 16,
                "BGR": 24}


def _bmp_rle(data, pos, w, h, rle4, what):
    """PIL's BmpRleDecoder, step for step: indices in file row order and
    the position after them. Runs stop at the row's end; absolute packets
    do not; a delta escape consumes four bytes and advances by the last
    two; absolute packets end on an even file offset."""
    out = bytearray()
    x, need, n_data = 0, w * h, len(data)
    while len(out) < need:
        if pos + 2 > n_data:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                out += (pair * (count // 2 + 1))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n_data:
                break
            if pos + 4 > n_data:
                raise ValueError(f"{what}: BMP RLE delta escape past the end of the file")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            n = byte // 2 if rle4 else byte
            chunk = data[pos:pos + n]
            pos += len(chunk)
            if rle4:
                nib = np.frombuffer(chunk, np.uint8)
                out += np.stack([nib >> 4, nib & 0x0F], axis=1).tobytes()
            else:
                out += chunk
            if len(chunk) < n:
                break
            x += byte
            pos += pos & 1
    return out


def _bmp_unpack(rows, w, rawmode, lut):
    """[h, row bytes] -> [h, w, 3] for one of PIL's BMP raw modes, and the
    palette indices (None for the other modes)."""
    h = rows.shape[0]
    if rawmode == "P;1":
        idx = _bits(rows, w)
        return lut[idx], idx
    if rawmode == "P;4":
        idx = np.stack([rows >> 4, rows & 0x0F], axis=2).reshape(h, -1)[:, :w]
        return lut[idx], idx
    if rawmode == "P":
        return lut[rows[:, :w]], rows[:, :w]
    return _bmp_pixels(rows, w, rawmode), None


def _bmp_pixels(rows, w, rawmode):
    h = rows.shape[0]
    if rawmode == "1":
        return _grey(_bits(rows, w) * np.uint8(255))
    if rawmode == "L":
        return _grey(rows[:, :w])
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16) @ np.uint16([1, 256])
        if rawmode == "BGR;15":
            return _word15(v)
        return np.stack([_expand(v >> 11, 5), _expand((v >> 5) & 63, 6), _expand(v & 31, 5)],
                        axis=-1)
    k = len(rawmode)
    px = rows[:, :k * w].reshape(h, w, k)
    return px[..., [rawmode.index(c) for c in "RGB"]]


def decode_bmp(data, what="BMP"):
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{what}: not a BMP file")
    return decode_dib(data, 14, _u32(data, 10), what)[0]


def decode_dib_file(data, what="DIB"):
    """A DIB file (``DibImageFile``): a BMP without its file header, its
    pixels right after the header, the bitfield masks and the palette.
    Where ``Image.open`` catches the plugin's error (masks cut short: a
    ``struct.error``; a size of 0) PIL tries the formats after DIB."""
    return decode_dib(data, 0, 0, what, "DIB")[0]


def decode_dib(data, pos, offset, what, form="BMP", halve=False):
    """The device-independent bitmap whose header starts at ``pos`` of the
    file ``data``, as PIL's ``BmpImageFile._bitmap`` reads it: the pixels
    at ``offset``, or right after the header and palette when ``offset``
    is 0 (a DIB in an ICO or CUR file). ``halve`` keeps the first half of
    the stored rows (the XOR image of an icon; the AND mask follows).
    Returns the [H, W, 3] pixels and the offset of the pixel data."""
    if len(data) < pos + 4:
        raise ValueError(f"{what}: {form} header is truncated")
    hsize = _u32(data, pos)
    if hsize not in (12, 40, 52, 56, 64, 108, 124):
        raise ValueError(f"{what}: {form} header of {hsize} bytes (PIL reads 12, 40, 52, 56, "
                         "64, 108 and 124)")
    head = data[pos + 4:pos + hsize]
    if len(head) < hsize - 4:
        raise ValueError(f"{what}: {form} header is truncated")
    pos += hsize
    direction = -1
    masks = None
    if hsize == 12:
        w, h, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, pad = 0, 0, 3
    else:
        flip = head[7] == 0xFF
        direction = 1 if flip else -1
        w = _u32(head, 0)
        h = (1 << 32) - _u32(head, 4) if flip else _u32(head, 4)
        bits, compression, colors = _u16(head, 10), _u32(head, 12), _u32(head, 28)
        pad = 4
        if compression == 3:
            if len(head) >= 48:
                masks = [_u32(head, 36 + 4 * i) for i in range(3)]
                masks.append(_u32(head, 48) if len(head) >= 52 else 0)
            else:
                if len(data) < pos + 12:
                    raise (NextFormat if form == "DIB" else ValueError)(
                        f"{what}: {form} bitfield masks are truncated")
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    if form == "DIB" and (w <= 0 or h <= 0):  # PIL: not an image its plugin identifies
        raise NextFormat(f"{what}: DIB of size {w} x {h}")
    _check_size(w, h, what, form)
    if halve:
        h //= 2
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    rawmode = _BMP_RAW.get(bits)
    if rawmode is None:
        raise ValueError(f"{what}: BMP of {bits} bits per pixel (PIL reads 1, 4, 8, 16, 24 "
                         "and 32)")
    rle = False
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        rawmode = _BMP_MASKS.get(key)
        if rawmode is None:
            raise ValueError(f"{what}: BMP bitfields {bits}-bit with masks "
                             f"{', '.join(hex(m) for m in key[1])} (PIL refuses the layout)")
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise ValueError(f"{what}: BMP compression {compression} (PIL reads none, RLE8, RLE4 "
                         "and bitfields)")
    lut = None
    grey = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{what}: BMP palette of {colors} colours")
        pal = data[pos:pos + pad * colors]
        pos += len(pal)
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad:i * pad + 3] == bytes([v & 255]) * 3 for i, v in enumerate(ramp)):
            grey = "1" if colors == 2 else "L"
            rawmode = grey
        else:
            n = len(pal) // pad
            if n > 256:
                raise ValueError(f"{what}: BMP palette of {n} colours (PIL refuses more than 256)")
            lut = _lut(np.frombuffer(pal[:n * pad], np.uint8).reshape(n, pad)[:, 2::-1])
    note_mode(grey or ("P" if bits <= 8 else "RGB"))
    start = offset or pos
    if rle:
        if bits > 8 or grey == "1":
            raise ValueError(f"{what}: BMP RLE{8 if compression == 1 else 4} at {bits} bits "
                             "(PIL refuses it)")
        idx = _bmp_rle(data, start, w, h, compression == 2, what)
        if len(idx) < w * h:
            raise ValueError(f"{what}: {form} RLE image data ends early (PIL: not enough image "
                             "data)")
        rows = np.frombuffer(bytes(idx[:w * h]), np.uint8).reshape(h, w)
        rgb, idx = (_grey(rows), None) if grey == "L" else (lut[rows], rows)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        row_bytes = (w * _BMP_RAWBITS.get(rawmode, 32) + 7) // 8
        if stride < row_bytes:
            raise ValueError(f"{what}: BMP rows of {stride} bytes hold fewer than {row_bytes} "
                             f"(PIL reads the {bits}-bit grey palette as 8-bit data)")
        if len(data) < start + (h - 1) * stride + row_bytes:
            raise ValueError(f"{what}: {form} image data is truncated")
        buf = np.frombuffer(data, np.uint8, len(data) - start, start)
        buf = np.concatenate([buf, np.zeros(h * stride - len(buf) if len(buf) < h * stride
                                            else 0, np.uint8)])
        rgb, idx = _bmp_unpack(buf[:h * stride].reshape(h, stride), w, rawmode, lut)
    if direction < 0:
        rgb = rgb[::-1]
    if idx is not None:
        note_band(idx[::direction])
    return np.ascontiguousarray(rgb), start


# --------------------------------------------------------------------------
# PNM

_PNM_WHITESPACE = b" \t\n\x0b\x0c\r"


def _pnm_token(data, pos, what):
    """PIL's PpmImageFile._read_token: skips whitespace and comments (a
    comment runs to CR or LF, and may split a token), at most 10 bytes."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _PNM_WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError(f"{what}: PNM header ends early")
    if len(token) > 10:
        raise ValueError(f"{what}: PNM header token {token[:11]!r} too long")
    return token, pos


def _strip_comments(block):
    """PIL's PpmPlainDecoder._ignore_comments on one block."""
    while True:
        start = block.find(b"#")
        if start == -1:
            return block
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e != -1]
        if not ends:
            return block[:start]
        block = block[:start] + block[min(ends) + 1:]


def _pnm_int(tok, what):
    try:
        return int(tok)
    except ValueError:
        raise ValueError(f"{what}: PNM value {tok!r} is not a number") from None


# PIL's PpmImagePlugin.MODES: magic -> mode
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA",
              b"PyCMYK": "CMYK"}
_PNM_BANDS = {"L": 1, "RGB": 3, "P": 1, "RGBA": 4, "CMYK": 4}


def _f_to_grey(v):
    """PIL's mode F -> 8 bits (``convert("RGB")`` goes through L): 255 from
    255 up, truncated toward zero between, 0 at 0 and below and for NaN."""
    with np.errstate(invalid="ignore"):
        grey = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.nan_to_num(v)), 0))
    return grey.astype(np.uint8)


def decode_pnm(data, what="PNM"):
    magic = b""
    pos = 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in _PNM_WHITESPACE:
            break
        magic += c
    mode = _PNM_MODES.get(magic)
    if mode is None:  # PIL: "not a PPM file", a SyntaxError
        raise NextFormat(f"{what}: PNM magic {magic!r} (PIL reads P1-P6, Pf, P0CMYK, PyP, "
                         "PyRGBA and PyCMYK)")
    if mode in ("1", "F"):
        note_mode(mode)
    tok, pos = _pnm_token(data, pos, what)
    w = _pnm_int(tok, what)
    tok, pos = _pnm_token(data, pos, what)
    h = _pnm_int(tok, what)
    _check_size(w, h, what, "PNM")
    if mode == "1":
        if magic == b"P4":
            line = (w + 7) // 8
            if len(data) - pos < line * h:
                raise ValueError(f"{what}: PBM image data is truncated")
            rows = np.frombuffer(data, np.uint8, line * h, pos).reshape(h, line)
            return _grey((1 - _bits(rows, w)) * np.uint8(255))
        n = w * h
        digits = b"".join(_strip_comments(data[pos:]).split())
        bad = digits.translate(None, b"01")
        if bad:
            raise ValueError(f"{what}: PBM plain data holds {bad[:1]!r}")
        if len(digits) < n:
            raise ValueError(f"{what}: PBM plain data holds {len(digits)} of {n} pixels")
        v = np.frombuffer(digits[:n], np.uint8).reshape(h, w)
        return _grey(np.where(v == ord("1"), 0, 255).astype(np.uint8))
    tok, pos = _pnm_token(data, pos, what)
    if mode == "F":
        return _grey(_f_to_grey(_pfm_samples(data, pos, w, h, tok, what)))
    maxval = _pnm_int(tok, what)
    if not 0 < maxval < 65536:
        raise ValueError(f"{what}: PNM maxval {maxval} (PIL reads 1-65535)")
    note_mode("I" if mode == "L" and maxval > 255 else mode)
    bands = _PNM_BANDS[mode]
    n = w * h * bands
    # PIL's mode I for grey above 255: samples scale to 0..65535, and
    # convert("RGB") clips them at 255
    out_max = 65535 if mode == "L" and maxval > 255 else 255
    if magic not in (b"P2", b"P3"):
        wide = maxval > 255
        nbytes = n * (2 if wide else 1)
        if len(data) - pos < nbytes:
            raise ValueError(f"{what}: PNM image data is truncated")
        v = np.frombuffer(data, ">u2" if wide else np.uint8, n, pos).astype(np.int64)
        if not (maxval == 255 or (maxval == 65535 and mode == "L")):
            v = np.minimum(out_max, np.rint(v / maxval * out_max)).astype(np.int64)
    else:
        block = _strip_comments(data[pos:])
        toks = block.split()
        if toks and not block[-1:].isspace() and len(toks[-1]) > 10:
            raise ValueError(f"{what}: PNM value {toks[-1][:11]!r} too long")
        for t in toks[:n]:
            if len(t) > 10:
                raise ValueError(f"{what}: PNM value {t[:11]!r} too long")
        if len(toks) < n:
            raise ValueError(f"{what}: PNM plain data holds {len(toks)} of {n} samples")
        v = np.array([_pnm_int(t, what) for t in toks[:n]], np.int64)
        if (v < 0).any() or (v > maxval).any():
            raise ValueError(f"{what}: PNM sample outside 0..{maxval}")
        v = np.rint(v / maxval * out_max).astype(np.int64)
    v = np.minimum(v, 255).astype(np.uint8).reshape(h, w, bands)
    if mode == "CMYK":
        return _cmyk_to_rgb(v)
    if mode == "P":  # no palette in the file: PIL's default palette is black
        note_band(v[..., 0])
        return np.zeros((h, w, 3), np.uint8)
    return np.ascontiguousarray(np.repeat(v, 3, axis=2) if bands == 1 else v[..., :3])


def _pfm_samples(data, pos, w, h, tok, what):
    """The float32 samples of a ``Pf`` file, top row first: its scale token
    (PIL's ``float``) must be finite and non-zero; negative means
    little-endian; rows run bottom up."""
    try:
        scale = float(tok)
    except ValueError:
        raise ValueError(f"{what}: PFM scale {tok!r} is not a number") from None
    if scale == 0.0 or not np.isfinite(scale):
        raise ValueError(f"{what}: PFM scale {scale} (PIL: scale must be finite and non-zero)")
    if len(data) - pos < 4 * w * h:
        raise ValueError(f"{what}: PFM image data is truncated")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, pos)
    return v.reshape(h, w)[::-1]


# --------------------------------------------------------------------------
# GIF


def _gif_blocks(data, pos, what):
    """Skip data sub-blocks from ``pos`` to after their terminator."""
    while True:
        if pos >= len(data):
            raise ValueError(f"{what}: GIF sub-blocks are truncated")
        n = data[pos]
        pos += 1
        if not n:
            return pos
        pos += n


def _gif_palette(data, pos, flags, what):
    """(palette [n, 3] or None for the grey ramp, next position)."""
    n = 1 << ((flags & 7) + 1)
    raw = data[pos:pos + 3 * n]
    ent = np.frombuffer(raw[:len(raw) // 3 * 3], np.uint8).reshape(-1, 3)
    if len(raw) % 3:
        raise ValueError(f"{what}: GIF palette is truncated")
    ramp = bool((ent == np.arange(len(ent))[:, None]).all())
    return (None if ramp else ent), pos + 3 * n


def decode_gif(data, what="GIF"):
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{what}: not a GIF file")
    sw, sh, flags = _u16(data, 6), _u16(data, 8), data[10]
    pos = 13
    palette = None
    if flags & 0x80:
        palette, pos = _gif_palette(data, pos, flags, what)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{what}: GIF without an image")
        c = data[pos]
        pos += 1
        if c == 0x21:  # extension
            if pos >= len(data):
                raise ValueError(f"{what}: GIF extension is truncated")
            label = data[pos]
            pos += 1
            n = data[pos] if pos < len(data) else 0
            block = data[pos + 1:pos + 1 + n] if n else None
            if label == 0xF9 and block is not None:
                if not block or len(block) < (4 if block[0] & 1 else 3):
                    raise ValueError(f"{what}: GIF graphic control extension is short")
                transparency = block[3] if block[0] & 1 else None
            pos = _gif_blocks(data, pos, what)
        elif c == 0x2C:  # image descriptor
            if pos + 9 > len(data):
                raise ValueError(f"{what}: GIF image descriptor is truncated")
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if fflags & 0x80:
                palette, pos = _gif_palette(data, pos, fflags, what)
            if pos >= len(data):
                raise ValueError(f"{what}: GIF image data is truncated")
            bits = data[pos]
            pos += 1
            break
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    _check_size(w, h, what, "GIF")
    if fw <= 0 or fh <= 0:
        raise ValueError(f"{what}: GIF frame of {fw} x {fh} on a {w} x {h} screen")
    if bits > 12:
        raise ValueError(f"{what}: GIF LZW minimum code size {bits}")
    idx = np.full((h, w), transparency or 0, np.uint8)
    frame = np.ascontiguousarray(idx[y0:y0 + fh, x0:x0 + fw])
    _gif_lzw(data, pos, bits, frame, bool(fflags & 0x40), what)
    idx[y0:y0 + fh, x0:x0 + fw] = frame
    note_mode("L" if palette is None else "P")
    note_band(idx)
    if palette is None:
        return _grey(idx)
    return _lut(palette)[idx]


def _gif_lzw(data, pos, bits, frame, interlace, what):
    import ctypes

    from ..native.loader import load

    lib = load("gif")
    rc = lib.akr_gif_lzw(data, len(data), pos, PIL_READ_BLOCK, bits, frame.shape[1],
                         frame.shape[0], int(interlace), frame.ctypes.data_as(ctypes.c_void_p))
    if rc == 1:
        raise ValueError(f"{what}: GIF image data is truncated")
    if rc == 2:
        raise ValueError(f"{what}: GIF LZW data is corrupt")


# --------------------------------------------------------------------------
# PSD

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}
_PSD_NAMES = {0: "bitmap", 1: "grey", 2: "indexed", 3: "RGB", 4: "CMYK", 7: "multichannel",
              8: "duotone", 9: "Lab"}


def _packbits(data, pos, line, rows):
    """PIL's PackbitsDecode for ``rows`` scanlines of ``line`` bytes from
    ``pos``: no-op 128 bytes skipped, the part of a packet past its
    scanline's end dropped; None if the data ends first."""
    out = bytearray()
    n_data = len(data)
    for _ in range(rows):
        row = bytearray()
        while len(row) < line:
            if pos >= n_data:
                return None
            head = data[pos]
            if head == 0x80:
                pos += 1
                continue
            if head & 0x80:
                if pos + 2 > n_data:
                    return None
                row += data[pos + 1:pos + 2] * (257 - head)
                pos += 2
            else:
                if pos + head + 2 > n_data:
                    return None
                row += data[pos + 1:pos + head + 2]
                pos += head + 2
        out += row[:line]
    return out


def _cmyk_to_rgb(cmyk):
    """PIL's cmyk2rgb: nk = 255 - k, channel = nk - c * nk / 255 rounded
    as its MULDIV255."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - ((t >> 8) + t >> 8), 0, 255).astype(np.uint8)


def decode_psd(data, what="PSD"):
    if data[:4] != b"8BPS" or len(data) < 26:
        raise ValueError(f"{what}: not a PSD file")
    version, channels, h, w, bits, mode = struct.unpack_from(">H6xHIIHH", data, 4)
    if version != 1:
        raise ValueError(f"{what}: PSD version {version} (large document format)")
    name = _PSD_NAMES.get(mode, f"colour mode {mode}")
    if (mode, bits) not in _PSD_MODES:
        raise ValueError(f"{what}: PSD {name} at {bits} bits (PIL reads 8 bits, 1 for bitmap)")
    pmode, need = _PSD_MODES[(mode, bits)]
    note_mode(pmode)
    if need > channels:
        raise ValueError(f"{what}: PSD {name} with {channels} channels")
    _check_size(w, h, what, "PSD")
    pos = 26
    size = int.from_bytes(data[pos:pos + 4], "big")
    pos += 4
    lut = None
    if size and pmode == "P" and size == 768:
        lut = np.frombuffer(data[pos:pos + 768], np.uint8).reshape(3, 256).T
    pos += size
    size = int.from_bytes(data[pos:pos + 4], "big")
    pos += 4
    end = pos + size
    while pos < end:  # image resources, entry by entry as PIL walks them
        n = data[pos + 6] if pos + 6 < len(data) else 0
        pos += 7 + n + (0 if n & 1 else 1)
        size = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4 + size + (size & 1)
        if pos > len(data):
            raise ValueError(f"{what}: PSD image resources are truncated")
    size = int.from_bytes(data[pos:pos + 4], "big")
    pos += 4 + size
    if pos + 2 > len(data):
        raise ValueError(f"{what}: PSD image data is truncated")
    compression = int.from_bytes(data[pos:pos + 2], "big")
    pos += 2
    if pmode == "RGB" and channels == 4:
        need = 4
    line = (w + 7) // 8 if pmode == "1" else w
    planes = []
    if compression == 0:
        for c in range(need):
            start = pos + c * w * h
            if len(data) < start + line * h:
                raise ValueError(f"{what}: PSD image data is truncated")
            planes.append(np.frombuffer(data, np.uint8, line * h, start).reshape(h, line))
    elif compression == 1:
        counts = np.frombuffer(data[pos:pos + 2 * need * h], ">u2").astype(np.int64)
        if len(counts) < need * h:
            raise ValueError(f"{what}: PSD row byte counts are truncated")
        start = pos + 2 * need * h
        for c in range(need):
            rows = _packbits(data, start, line, h)
            if rows is None:
                raise ValueError(f"{what}: PSD PackBits data is truncated")
            planes.append(np.frombuffer(bytes(rows), np.uint8).reshape(h, line))
            start += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"{what}: PSD compression {compression} (PIL reads raw and PackBits)")
    if pmode == "1":
        return _grey(_bits(planes[0], w) * np.uint8(255))
    if pmode == "L":
        return _grey(planes[0])
    if pmode == "P":
        note_band(planes[0])
        return (lut if lut is not None else np.zeros((256, 3), np.uint8))[planes[0]]
    if pmode == "CMYK":
        return _cmyk_to_rgb(255 - np.stack(planes, axis=-1))
    if pmode == "LAB":
        return lab8_to_rgb8(np.stack(planes, axis=-1))
    return np.ascontiguousarray(np.stack(planes[:3], axis=-1))


# --------------------------------------------------------------------------
# MSP


def decode_msp(data, what="MSP"):
    data = bytes(data)
    if data[:4] not in (b"DanM", b"LinS"):
        raise ValueError(f"{what}: not an MSP file")
    if len(data) < 32:
        raise NextFormat(f"{what}: MSP header cut short")
    words = np.frombuffer(data, "<u2", 16)
    if np.bitwise_xor.reduce(words):
        raise NextFormat(f"{what}: bad MSP checksum")
    w, h = _u16(data, 4), _u16(data, 6)
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: MSP image of size {w} x {h}")
    _check_size(w, h, what, "MSP")
    stride = (w + 7) // 8
    note_mode("1")
    if data[:4] == b"DanM":
        if len(data) - 32 < h * stride:
            raise ValueError(f"{what}: MSP data is truncated (PIL: image file is truncated)")
        rows = np.frombuffer(data, np.uint8, h * stride, 32).reshape(h, stride)
    else:
        if len(data) - 32 < 2 * h:
            raise ValueError(f"{what}: truncated MSP file in row map")
        rowmap = np.frombuffer(data, "<u2", h, 32)
        out, pos = bytearray(), 32 + 2 * h
        for y, rowlen in enumerate(rowmap.tolist()):
            if rowlen == 0:
                out += b"\xff" * stride
                continue
            row = data[pos:pos + rowlen]
            pos += rowlen
            if len(row) != rowlen:
                raise ValueError(f"{what}: truncated MSP file, expected {rowlen} bytes on row {y}")
            idx = 0
            while idx < rowlen:
                runtype = row[idx]
                idx += 1
                if runtype == 0:
                    if idx + 2 > rowlen:
                        raise ValueError(f"{what}: corrupted MSP file in row {y}")
                    out += row[idx + 1:idx + 2] * row[idx]
                    idx += 2
                else:
                    out += row[idx:idx + runtype]
                    idx += runtype
        if len(out) < h * stride:
            raise ValueError(f"{what}: MSP rows decode to {len(out)} bytes of {h * stride} (PIL: "
                             "not enough image data)")
        rows = np.frombuffer(bytes(out), np.uint8, h * stride).reshape(h, stride)
    return _grey(_bits(rows, w) * np.uint8(255))


# --------------------------------------------------------------------------
# XBM

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _k, _c in enumerate(b"0123456789"):
    _HEX[_c] = _k
for _k, _c in enumerate(b"abcdef"):
    _HEX[_c] = _HEX[_c - 32] = 10 + _k


def decode_xbm(data, what="XBM"):
    data = bytes(data)
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NextFormat(f"{what}: not an XBM file (no width, height and _bits[] in its first "
                         "512 bytes)")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: XBM image of size {w} x {h}")
    _check_size(w, h, what, "XBM")
    note_mode("1")
    stride = (w + 7) // 8
    body = np.frombuffer(data, np.uint8, offset=m.end())
    xs = np.flatnonzero(body == ord("x"))
    xs = xs[xs + 3 <= len(body)]             # an x needs its two digits
    if len(xs) and np.diff(xs).min(initial=3) < 3:
        keep, nxt = [], 0                    # each value skips the 3 bytes it read
        for p in xs.tolist():
            if p >= nxt:
                keep.append(p)
                nxt = p + 3
        xs = np.array(keep, np.int64)
    if len(xs) < h * stride:
        raise ValueError(f"{what}: XBM holds {len(xs)} of {h * stride} values (PIL: image file "
                         "is truncated)")
    xs = xs[:h * stride]
    vals = (_HEX[body[xs + 1]] << 4) + _HEX[body[xs + 2]]
    bits = np.unpackbits(vals.reshape(h, stride), axis=1, bitorder="little")[:, :w]
    return _grey(bits * np.uint8(255))
