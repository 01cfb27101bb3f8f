"""Sun raster decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_sun`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a Sun raster (``SunImagePlugin``), and
``sun_header`` is the plugin's header parse, which raises ``NextFormat``
where PIL tries the formats after SUN and ``ValueError`` where its open
fails.

- The 32-byte header: eight big-endian words, the magic 0x59A66A95, width,
  height, depth, data length (ignored), file type, palette type, palette
  length. Depth 1 (``1;I``: a set bit is black), 4 (``L;4``: each nibble
  times 17), 8 (grey), 24 (RGB for file type 3, else BGR) and 32 (RGBX /
  BGRX); other depths make PIL try the next format, as do a palette longer
  than 1,024 bytes, a palette type other than 1 under a non-empty palette,
  file types other than 0-5 and an empty image.
- A palette (stored as PIL's ``RGB;L``: the n = length // 3 reds, then the
  greens, then the blues; spare bytes unread) turns depth 8 into ``P`` and
  depth 4 into ``P;4``; indices past its end read black; more than 256
  entries fail PIL's load ("invalid palette size"). A palette under depth
  1, 24 or 32 leaves a mode PIL cannot load with a palette (refused).
- File types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits (the last row
  need not hold its padding); type 2 is run-length coded
  (``native/rle.cpp::akr_sun_rle``, PIL's ``SunRleDecode.c``): 0x80 0x00 is
  one 0x80, 0x80 n v is n + 1 bytes v, across rows, and its rows are read
  unpadded, (depth * width + 7) // 8 bytes each, as PIL reads them. Data
  that ends before the image is full is refused (PIL: image file is
  truncated); data past it is ignored.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import NextFormat, _bits, _check_size, _grey, note_band, note_mode

MAGIC = 0x59A66A95


def sun_header(data, what="SUN"):
    """``SunImageFile._open`` on ``data``: (width, height, depth, file type,
    palette [n, 3] or None, offset of the data)."""
    if len(data) < 32 or struct.unpack_from(">I", data)[0] != MAGIC:
        raise NextFormat(f"{what}: not a Sun raster")
    w, h, depth, _, file_type, palette_type, palette_length = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise NextFormat(f"{what}: Sun raster of depth {depth} (PIL: Unsupported Mode/Bit "
                         "Depth)")
    palette = None
    if palette_length:
        if palette_length > 1024:
            raise NextFormat(f"{what}: Sun raster palette of {palette_length} bytes (PIL: "
                             "Unsupported Color Palette Length)")
        if palette_type != 1:
            raise NextFormat(f"{what}: Sun raster palette type {palette_type} (PIL: "
                             "Unsupported Palette Type)")
        raw = data[32:32 + palette_length]
        n = len(raw) // 3
        palette = np.frombuffer(raw, np.uint8, 3 * n).reshape(3, n).T
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise NextFormat(f"{what}: Sun raster file type {file_type} (PIL: Unsupported Sun "
                         "Raster file type)")
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: Sun raster of size {w} x {h}")
    _check_size(w, h, what, "Sun raster")
    return w, h, depth, file_type, palette, 32 + palette_length


def decode_sun(data, what="SUN"):
    from ..native.loader import load

    data = bytes(data)
    w, h, depth, file_type, palette, offset = sun_header(data, what)
    if palette is not None and depth not in (4, 8):
        raise ValueError(f"{what}: Sun raster of depth {depth} with a palette (PIL: "
                         "unrecognized image mode)")
    if palette is not None and len(palette) > 256:
        raise ValueError(f"{what}: Sun raster palette of {len(palette)} colours (PIL: invalid "
                         "palette size)")
    note_mode({1: "1", 24: "RGB", 32: "RGB"}.get(depth, "L" if palette is None else "P"))
    line = (w * depth + 7) // 8
    if file_type == 2:
        rows = np.zeros((h, line), np.uint8)
        body = data[offset:]
        if load("rle").akr_sun_rle(body, len(body), h * line,
                                   rows.ctypes.data_as(ctypes.c_void_p)):
            raise ValueError(f"{what}: Sun raster run-length data is truncated (PIL: image file "
                             "is truncated)")
    else:
        stride = (w * depth + 15) // 16 * 2
        if len(data) - offset < (h - 1) * stride + line:
            raise ValueError(f"{what}: Sun raster data is truncated (PIL: image file is "
                             "truncated)")
        buf = np.frombuffer(data, np.uint8, min(len(data) - offset, h * stride), offset)
        rows = np.zeros(h * stride, np.uint8)
        rows[:len(buf)] = buf
        rows = rows.reshape(h, stride)[:, :line]
    if depth == 1:
        return _grey((1 - _bits(rows, w)) * np.uint8(255))
    if depth == 4:
        idx = np.stack([rows >> 4, rows & 15], axis=-1).reshape(h, -1)[:, :w]
        if palette is None:
            return _grey(idx * np.uint8(17))
    elif depth == 8:
        idx = rows
    else:
        px = rows.reshape(h, w, depth // 8)[..., :3]
        return np.ascontiguousarray(px if file_type == 3 else px[..., ::-1])
    if palette is None:
        return _grey(idx)
    note_band(idx)
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(palette)] = palette
    return lut[idx]
