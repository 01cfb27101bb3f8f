"""IFUNC IM and IM Tools (IMT) decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_im`` and ``decode_imt`` return the [H, W, 3] uint8 pixels of
PIL's ``convert("RGB")`` of the same file. Neither format has a signature:
PIL runs each plugin's header parse on every file that reaches it, and
``im_header`` / ``imt_header`` are those parses, raising ``NextFormat``
where PIL goes on to the next format and ``ValueError`` where its open
fails.

IM (``ImImagePlugin``): a text header of ``key: value`` lines (at most 100
bytes each, ``\\r`` skipped; a newline among the first 100 bytes, and at
least one of PIL's nine tags), ended by a ``\\0`` or ``\\x1a`` byte; the
data starts after the first ``\\x1a``. No ``Image type`` means ``L``, no
``Image size`` 512 x 512. Every ``Image type`` of PIL's table: bilevel,
grey, 2- and 4-bit indices, RGB (packed, or planar within each row: the
``;L`` modes), RGBA / RGBX / CMYK / YCbCr / LA planar, the three-plane
``RGB3`` / ``RYB3`` (green, red, blue planes), 8 / 16 / 32-bit integers
and floats (``F;n`` of any other n through PIL's ``bit`` decoder: LSB-first
bit fields, each row starting on a byte), ``I;16`` in both byte orders;
and a value outside the table naming a PIL mode (read with raw mode
``L``). The rows are stored bottom up. A ``Lut`` tag puts 768 bytes (a
planar R, G, B table) before the data: a palette for grey and index images
when it is not grey; a grey one PIL keeps as an attribute and never applies
to the pixels, as here. Only frame 0 of a file of several is read.

IMT (``ImtImagePlugin``): ``key value`` lines, ``*`` comments, the data
after a ``\\x0c`` byte; only ``pixel n8`` gives a mode (8-bit grey), so a
header without it makes PIL try the next format.
"""

from __future__ import annotations

import io
import re

import numpy as np

from .image_formats import (NextFormat, _check_size, _cmyk_to_rgb, _f_to_grey, _grey, note_band,
                            note_mode)

# ImImagePlugin's tags, its table of image types and its line parse
_COMMENT, _FRAMES, _LUT, _SCALE, _SIZE, _MODE = (
    "Comment", "File size (no of images)", "Lut", "Scale (x,y)", "Image size (x*y)",
    "Image type")
_TAGS = {_COMMENT, "Date", "Digitalization equipment", _FRAMES, _LUT, "Name", _SCALE, _SIZE,
         _MODE}
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# the planar raw modes (each row the bands' rows in turn) -> their bands
_PLANES = {"RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2,
           "PA;L": 2}


def _number(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def im_header(data, what="IM"):
    """``ImImageFile._open`` on ``data``: (mode, raw mode, size, offset of
    the pixel data, palette [256, 3] or None)."""
    fp = io.BytesIO(data)
    if b"\n" not in fp.read(100):
        raise NextFormat(f"{what}: not an IM file (no newline in its first 100 bytes)")
    fp.seek(0)
    n = 0
    info = {_MODE: "L", _SIZE: (512, 512), _FRAMES: 1}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise NextFormat(f"{what}: not an IM file (a header line of {len(s)} bytes)")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise NextFormat(f"{what}: not an IM file (header line {s[:40]!r})")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (_FRAMES, _SCALE, _SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as e:  # PIL's open fails on it
                raise ValueError(f"{what}: IM header {k!r}: {e}") from None
            if len(v) == 1:
                v = v[0]
        elif k == _MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == _COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in _TAGS
    if not n:
        raise NextFormat(f"{what}: not an IM file (none of its tags)")
    size, mode = info[_SIZE], info[_MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise NextFormat(f"{what}: IM file truncated before its data")
    palette = None
    if _LUT in info:
        lut = fp.read(768)
        greyscale = linear = True
        try:
            for i in range(256):
                if lut[i] == lut[i + 256] == lut[i + 512]:
                    linear = linear and lut[i] == i
                else:
                    greyscale = False
        except IndexError:
            raise NextFormat(f"{what}: IM lookup table cut short") from None
        if len(lut) < 768:   # the file ends in the table: no pixel data for PIL's load
            raise ValueError(f"{what}: IM lookup table cut short (PIL: image file is truncated)")
        if mode in ("L", "LA", "P", "PA") and not greyscale:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.frombuffer(lut, np.uint8).reshape(3, 256).T
    if not isinstance(size, tuple):
        raise NextFormat(f"{what}: IM size {size!r} is not a pair")
    if not mode:
        raise NextFormat(f"{what}: IM header gives no image type")
    if size[0] <= 0 or size[1] <= 0:
        raise NextFormat(f"{what}: IM size {size[0]} x {size[1]}")
    return mode, rawmode, size, fp.tell(), palette


def _rows(data, pos, h, stride, what, form):
    """h rows of stride bytes from pos, stored bottom up -> [h, stride]."""
    if len(data) - pos < h * stride:
        raise ValueError(f"{what}: {form} data is truncated (PIL: image file is truncated)")
    return np.frombuffer(data, np.uint8, h * stride, pos).reshape(h, stride)[::-1]


def _ycbcr_to_rgb(ycc):
    """PIL's YCbCr -> RGB (``ConvertYCbCr.c``, the tables of
    ``jpeg2000.ycbcr_tables``)."""
    from .jpeg2000 import ycbcr_tables

    r_cr, g_cb, g_cr, b_cb = ycbcr_tables()
    y, cb, cr = (ycc[..., k].astype(np.int32) for k in range(3))
    rgb = np.stack([y + (r_cr[cr] >> 6), y + ((g_cb[cb] + g_cr[cr]) >> 6),
                    y + (b_cb[cb] >> 6)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _bit_fields(data, pos, w, h, bits, what):
    """PIL's ``bit`` decoder (fill 3, pad 8): ``bits``-bit unsigned fields,
    least significant bit first, each row from a fresh byte, rows bottom
    up -> [h, w] float32."""
    stride = (w * bits + 7) // 8
    rows = _rows(data, pos, h, stride, what, f"IM F;{bits}")[::-1].copy()   # file order
    # a new row resets the bit count but not the bit buffer: the bits a
    # row leaves unread are OR-ed into the next row's first byte
    spare = 8 * stride - w * bits
    if spare:
        for y in range(1, h):
            rows[y, 0] |= rows[y - 1, -1] >> (8 - spare)
    rows = rows[::-1]
    lsb = np.unpackbits(rows, axis=1, bitorder="little")[:, :w * bits].reshape(h, w, bits)
    vals = (lsb.astype(np.uint64) << np.arange(bits, dtype=np.uint64)).sum(-1)
    return vals.astype(np.float32)


def _unpack(mode, rawmode, data, pos, w, h, palette, what):
    """The raw tile of (mode, raw mode) at pos -> RGB, or ValueError where
    PIL has no unpacker for the pair."""
    form = f"IM {mode} image (raw mode {rawmode})"
    if rawmode in ("RGB;T", "RYB;T"):
        if mode not in ("RGB", "RGBA", "RGBX"):
            raise ValueError(f"{what}: {form}: PIL has no unpacker for it")
        planes = [_rows(data, pos + k * w * h, h, w, what, form) for k in range(3)]
        return np.stack([planes[1], planes[0], planes[2]], axis=-1)   # G, R, B planes
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        bits = int(rawmode[2:])
        if mode != "F" or not 1 <= bits < 32:
            raise ValueError(f"{what}: {form}: PIL's bit decoder refuses it")
        return _grey(_f_to_grey(_bit_fields(data, pos, w, h, bits, what)))
    if rawmode in _PLANES and (mode, rawmode) in (
            ("RGB", "RGB;L"), ("RGB", "RGBA;L"), ("RGB", "RGBX;L"), ("RGBA", "RGBA;L"),
            ("RGBX", "RGB;L"), ("RGBX", "RGBX;L"), ("CMYK", "CMYK;L"), ("YCbCr", "YCbCr;L"),
            ("LA", "LA;L"), ("PA", "PA;L")):
        k = _PLANES[rawmode]
        px = _rows(data, pos, h, k * w, what, form).reshape(h, k, w).transpose(0, 2, 1)
        if mode == "CMYK":
            return _cmyk_to_rgb(px)
        if mode == "YCbCr":
            return _ycbcr_to_rgb(px)
        if mode == "LA":
            return _grey(px[..., 0])
        if mode == "PA":
            return palette[px[..., 0]]
        return np.ascontiguousarray(px[..., :3])
    if (mode, rawmode) in (("RGB", "RGB"), ("RGBX", "RGB")):
        return _rows(data, pos, h, 3 * w, what, form).reshape(h, w, 3).copy()
    if (mode, rawmode) == ("1", "1"):
        rows = _rows(data, pos, h, (w + 7) // 8, what, form)
        return _grey(np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255))
    if (mode, rawmode) == ("L", "L"):
        return _grey(_rows(data, pos, h, w, what, form))
    if (mode, rawmode) == ("LAB", "L"):
        from .lcms import lab8_to_rgb8

        lab = np.zeros((h, w, 3), np.uint8)
        lab[..., 0] = _rows(data, pos, h, w, what, form)
        return lab8_to_rgb8(lab)
    if mode == "P" and rawmode in ("L", "P", "P;2", "P;4"):
        bits = {"P;2": 2, "P;4": 4}.get(rawmode, 8)
        rows = _rows(data, pos, h, (w * bits + 7) // 8, what, form)
        if bits < 8:
            fields = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
            rows = (fields << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, np.uint8)
        note_band(rows[:, :w])
        if palette is None:   # no palette: PIL's default one, all black
            return np.zeros((h, w, 3), np.uint8)
        return palette[rows[:, :w]]
    ints = {("I", "I;16"): "<u2", ("I", "I;16B"): ">u2", ("I", "I;32"): "<i4",
            ("I", "I;32S"): "<i4", ("I;16", "I;16"): "<u2", ("I;16", "I;16B"): ">u2",
            ("I;16L", "I;16L"): "<u2", ("I;16B", "I;16B"): ">u2"}
    floats = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4",
              "F;32F": "<f4"}
    if (mode, rawmode) in ints or (mode == "F" and rawmode in floats):
        dt = np.dtype(ints.get((mode, rawmode)) or floats[rawmode])
        rows = _rows(data, pos, h, w * dt.itemsize, what, form)
        v = np.ascontiguousarray(rows).view(dt)
        if mode in ("I;16", "I;16L", "I;16B"):
            note_band(v, ">" if mode == "I;16B" else "<")
        if mode == "F":
            return _grey(_f_to_grey(v.astype(np.float32)))
        return _grey(np.clip(v, 0, 255))
    raise ValueError(f"{what}: {form}: PIL has no unpacker for it (unknown raw mode)")


def decode_im(data, what="IM"):
    data = bytes(data)
    mode, rawmode, size, pos, palette = im_header(data, what)
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"{what}: IM size {size!r} (PIL opens it and cannot load it)")
    w, h = size
    _check_size(w, h, what, "IM")
    note_mode(mode)
    return _unpack(mode, rawmode, data, pos, w, h, palette, what)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_header(data, what="IMT"):
    """``ImtImageFile._open`` on ``data``: (width, height, offset of the
    pixel data or None when the header has no ``\\x0c``)."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise NextFormat(f"{what}: not an IM Tools file (no newline in its first 100 bytes)")
    size, mode, offset = (0, 0), "", None
    xsize = ysize = 0
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)   # the tile: this size and mode
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError as e:  # PIL's open fails on it
            raise ValueError(f"{what}: IM Tools header {k.decode()}: {e}") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NextFormat(f"{what}: not an IM Tools image (mode {mode!r}, size {size})")
    return size, offset


def decode_imt(data, what="IMT"):
    data = bytes(data)
    (w, h), pos = imt_header(data, what)
    if pos is None:
        raise ValueError(f"{what}: IM Tools header without image data (PIL: cannot load this "
                         "image)")
    _check_size(w, h, what, "IM Tools")
    note_mode("L")
    if len(data) - pos < w * h:
        raise ValueError(f"{what}: IM Tools data is truncated (PIL: image file is truncated)")
    return _grey(np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w))
