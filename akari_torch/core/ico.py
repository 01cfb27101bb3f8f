"""ICO and CUR decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_ico`` and ``decode_cur`` return the [H, W, 3] uint8 pixels of
PIL's ``convert("RGB")`` of the same file, and raise ``ValueError`` where
PIL refuses it.

- ICO (``IcoImagePlugin``): PIL sorts the directory by colour depth (the
  entry's bit count, else the bits its colour count needs, else 256), then,
  a stable sort, by area, largest first, and reads the first entry. A PNG
  entry decodes at the PNG's own size (``decode_png``). A DIB entry
  decodes as a BMP without its file header (``decode_dib``), the first
  half of its rows; the AND mask (or, when the directory says 32 bits, the
  fourth byte of each pixel) becomes the alpha that ``convert("RGB")``
  drops, but PIL still reads it and refuses the file when it is short.
- CUR (``CurImagePlugin``): PIL keeps the first directory entry, or a later
  one larger in both width and height bytes (0 is not read as 256), and
  reads its DIB, the first half of its rows. A PNG entry is refused, as
  PIL's BMP reader refuses a PNG header.

A directory that ends early, or that holds no entry, makes PIL give up on
the format without an error and try the formats after it; so does this
module (``NextFormat``).
"""

from __future__ import annotations

import struct
from math import ceil, log

from .image import PNG_SIGNATURE, decode_png
from .image_formats import NextFormat, _check_size, _u32, decode_dib, note_mode


def _entries(data, what, form):
    if len(data) < 6:
        raise NextFormat(f"{what}: {form} header is truncated")
    n = data[4] | data[5] << 8
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NextFormat(f"{what}: {form} directory is truncated at entry {i} of {n}")
        entries.append(s)
    if not entries:
        raise NextFormat(f"{what}: {form} without entries")
    return entries


def decode_ico(data, what="ICO"):
    data = bytes(data)
    if data[:4] != b"\0\0\1\0":
        raise ValueError(f"{what}: not an ICO file")
    heads = []
    for s in _entries(data, what, "ICO"):
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        (bpp,) = struct.unpack_from("<H", s, 6)
        depth = bpp or (colors != 0 and ceil(log(colors, 2))) or 256
        heads.append((w * h, depth, bpp, _u32(s, 8), _u32(s, 12)))
    heads.sort(key=lambda e: e[1])
    heads.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = heads[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:], what)
    if len(data) < offset + 4:
        raise NextFormat(f"{what}: ICO entry at {offset} past the end of the file")
    note_mode("RGBA")   # PIL converts a DIB entry to RGBA to put its mask in
    rgb, start = decode_dib(data, offset, 0, what, "ICO", halve=True)
    h, w = rgb.shape[:2]
    # the alpha PIL reads and convert("RGB") drops: it must be all there
    if bpp == 32:
        if len(data) - start < 4 * w * h:
            raise ValueError(f"{what}: ICO alpha is truncated (PIL: buffer is not large "
                             "enough)")
    else:
        stride = -(-w // 32) * 4
        mask_at = offset + size - stride * h
        if mask_at < 0:
            raise ValueError(f"{what}: ICO AND mask before the start of the file")
        if min(len(data) - mask_at, stride * h) < (h - 1) * stride + -(-w // 8):
            raise ValueError(f"{what}: ICO AND mask is truncated (PIL: not enough image data)")
    return rgb


def decode_cur(data, what="CUR"):
    data = bytes(data)
    if data[:4] != b"\0\0\2\0":
        raise ValueError(f"{what}: not a CUR file")
    if len(data) < 6:
        raise NextFormat(f"{what}: CUR header is truncated")
    n = data[4] | data[5] << 8
    m = b""
    try:
        for i in range(n):
            s = data[6 + 16 * i:22 + 16 * i]
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            raise NextFormat(f"{what}: CUR without entries")
        (offset,) = struct.unpack_from("<I", m, 12)
    except (IndexError, struct.error):
        raise NextFormat(f"{what}: CUR directory is truncated") from None
    if len(data) < offset + 4:
        raise NextFormat(f"{what}: CUR entry at {offset} past the end of the file")
    if data[offset:offset + 8] == PNG_SIGNATURE:
        raise ValueError(f"{what}: CUR with a PNG entry (PIL reads it as a bitmap header and "
                         "refuses it)")
    rgb, _ = decode_dib(data, offset, 0, what, "CUR", halve=True)
    _check_size(rgb.shape[1], rgb.shape[0], what, "CUR")
    return rgb
