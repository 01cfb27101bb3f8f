"""GIMP brush (GBR), McIdas area, PIXAR and XV thumbnail decoding without
PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. Each ``decode_*`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of the same file, read from a path as the JAX package
reads it; each ``*_header`` is its plugin's open, raising ``NextFormat``
where PIL tries the formats after it and ``ValueError`` where its open
fails.

- GBR (``GbrImagePlugin``): big-endian header size (20 or more), version
  (1 or 2), width, height and depth (1: ``L``; 4: ``RGBA``, the alpha
  dropped), for version 2 ``GIMP`` and the spacing, then a comment of
  header size - 20 (- 28 for version 2) bytes (a negative length reads the
  rest of the file, so the load finds no data) and the pixels. Its
  signature is two words, so its open is a gate for the formats after it:
  a file of another format whose header fails it goes on, and one whose
  size passes PIL's pixel limit (checked in the open) fails the open.
- McIdas (``McIdasImagePlugin``): the 256-byte area directory of 64
  big-endian signed words; w[11] 1 / 2 / 4 bytes an element to ``L`` /
  ``I;16B`` / ``I`` (big-endian), the size w[10] x w[9], the data at
  w[34] + w[15], lines w[15] + w[10] * w[11] * w[14] bytes apart. ``L``
  and ``I;16B`` are memory-mapped from a path: the lines may overlap (a
  stride short of a line; the last may then run past the end of the file
  into the zeros of the map's last page), a stride of 0 or less means
  lines back to back, and a map past the end of the file, or a negative
  offset, fails the load; where the strided map would pass the end, PIL's raw decoder reads
  instead (a stride short of a line fails there). ``I`` is always decoded.
  ``convert("RGB")`` clips ``I;16B`` and ``I`` to 0..255.
- PIXAR (``PixarImagePlugin``): the magic ``\\x80\\xe8\\0\\0``, the 16-bit
  width at 418 and height at 416; only the channel / depth pair (14, 2) at
  424 sets a mode (RGB), any other leaves none and PIL tries the next
  format; the RGB pixels are "dumped" from byte 1024.
- XV thumbnail (``XVThumbImagePlugin``): ``P7 332`` and the rest of its
  line, ``#`` lines, then a line whose first two fields are the width and
  height (fewer than two, or fields that are not integers, fail the open);
  the indices follow it, into the RGB332 palette built with PIL's integer
  divisions (r * 255 // 7, g * 255 // 7, b * 255 // 3).
"""

from __future__ import annotations

import struct

import numpy as np

from .image_formats import NextFormat, _check_size, _grey, note_band, note_mode

# ------------------------------------------------------------------ GBR


def gbr_header(data, what="GBR"):
    """``GbrImageFile._open``: (width, height, depth, offset of the pixels
    or None where a negative comment length read the rest of the file)."""
    head = data[:20]
    if len(head) < 20:
        raise NextFormat(f"{what}: GIMP brush header cut short")
    size, version, w, h, depth = struct.unpack(">5I", head)
    if size < 20 or version not in (1, 2) or w == 0 or h == 0:
        raise NextFormat(f"{what}: not a GIMP brush (header size {size}, version {version}, "
                         f"size {w} x {h})")
    if depth not in (1, 4):
        raise NextFormat(f"{what}: GIMP brush of depth {depth} (PIL: Unsupported GIMP brush "
                         "color depth)")
    pos = 20
    if version == 2:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise NextFormat(f"{what}: not a GIMP brush (bad magic number)")
        pos = 28
    comment = size - pos
    _check_size(w, h, what, "GIMP brush")
    return w, h, depth, pos + comment if comment >= 0 else None


def decode_gbr(data, what="GBR"):
    data = bytes(data)
    w, h, depth, pos = gbr_header(data, what)
    note_mode("L" if depth == 1 else "RGBA")
    if pos is None or len(data) - pos < w * h * depth:
        raise ValueError(f"{what}: GIMP brush data is truncated (PIL: not enough image data)")
    px = np.frombuffer(data, np.uint8, w * h * depth, pos).reshape(h, w, depth)
    return _grey(px[..., 0]) if depth == 1 else np.ascontiguousarray(px[..., :3])


# ------------------------------------------------------------------ McIdas

_MCIDAS = {1: ("L", ">u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def mcidas_header(data, what="MCIDAS"):
    """``McIdasImageFile._open``: (mode, big-endian dtype, width, height,
    offset, stride)."""
    if len(data) < 256 or data[:8] != b"\0\0\0\0\0\0\0\4":
        raise NextFormat(f"{what}: not an McIdas area file")
    wd = (0,) + struct.unpack(">64i", data[:256])
    if wd[11] not in _MCIDAS:
        raise NextFormat(f"{what}: McIdas of {wd[11]} bytes an element (PIL: unsupported "
                         "McIdas format)")
    mode, dtype = _MCIDAS[wd[11]]
    w, h = wd[10], wd[9]
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: McIdas area of size {w} x {h}")
    _check_size(w, h, what, "McIdas area")
    return mode, dtype, w, h, wd[34] + wd[15], wd[15] + w * wd[11] * wd[14]


def decode_mcidas(data, what="MCIDAS"):
    data = bytes(data)
    mode, dtype, w, h, offset, stride = mcidas_header(data, what)
    note_mode(mode)
    line, n = w * np.dtype(dtype).itemsize, len(data)
    if mode != "I" and offset + h * stride <= n:   # ImageFile.load's memory map
        if offset < 0:
            raise ValueError(f"{what}: McIdas data at {offset} (PIL: Tile offset cannot be "
                             "negative)")
        step = stride if stride > 0 else line
        if offset + h * step > n:
            raise ValueError(f"{what}: McIdas data is truncated (PIL: buffer is not large "
                             "enough)")
    else:   # the raw decoder
        step = stride or line
        if offset < 0 or step < line:
            raise ValueError(f"{what}: McIdas lines {stride} bytes apart from {offset} (PIL "
                             "cannot decode them)")
        if offset + (h - 1) * step + line > n:
            raise ValueError(f"{what}: McIdas data is truncated (PIL: image file is truncated)")
    # overlapping lines of the map may read past the end of the file: zeros
    buf = np.frombuffer(data + bytes(line), np.uint8)[offset:]
    rows = np.lib.stride_tricks.as_strided(buf, (h, line), (step, 1))
    v = np.ascontiguousarray(rows).view(dtype).reshape(h, w)
    if mode == "I;16B":
        note_band(v, ">")
    return _grey(np.clip(v, 0, 255))


# ------------------------------------------------------------------ PIXAR


def pixar_header(data, what="PIXAR"):
    """``PixarImageFile._open``: (width, height)."""
    if data[:4] != b"\x80\xe8\0\0" or len(data) < 428:
        raise NextFormat(f"{what}: not a PIXAR file")
    h, w = struct.unpack_from("<HH", data, 416)
    pair = struct.unpack_from("<HH", data, 424)
    if pair != (14, 2) or w == 0 or h == 0:
        raise NextFormat(f"{what}: PIXAR of channels / depth {pair}, size {w} x {h} (PIL sets "
                         "a mode for (14, 2) only)")
    _check_size(w, h, what, "PIXAR")
    return w, h


def decode_pixar(data, what="PIXAR"):
    data = bytes(data)
    w, h = pixar_header(data, what)
    if len(data) - 1024 < 3 * w * h:
        raise ValueError(f"{what}: PIXAR data is truncated (PIL: image file is truncated)")
    return np.frombuffer(data, np.uint8, 3 * w * h, 1024).reshape(h, w, 3).copy()


# ------------------------------------------------------------------ XV thumbnails


def _rgb332():
    i = np.arange(256)
    r, g, b = i >> 5, (i >> 2) & 7, i & 3
    return np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3], axis=-1).astype(np.uint8)


RGB332 = _rgb332()


def xvthumb_header(data, what="XVThumb"):
    """``XVThumbImageFile._open``: (width, height, offset of the data)."""
    if not data.startswith(b"P7 332"):
        raise NextFormat(f"{what}: not an XV thumbnail file")
    end = data.find(b"\n", 6)
    pos = len(data) if end < 0 else end + 1
    while True:
        end = data.find(b"\n", pos)
        line = data[pos:] if end < 0 else data[pos:end + 1]
        pos += len(line)
        if not line:
            raise NextFormat(f"{what}: Unexpected EOF reading XV thumbnail file")
        if line[0] != 35:   # not a comment
            break
    try:
        w, h = (int(f) for f in line.strip().split(maxsplit=2)[:2])
    except ValueError as e:
        raise ValueError(f"{what}: XV thumbnail: {e} (PIL's open fails)") from None
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: XV thumbnail of size {w} x {h}")
    _check_size(w, h, what, "XV thumbnail")
    return w, h, pos


def decode_xvthumb(data, what="XVThumb"):
    data = bytes(data)
    w, h, pos = xvthumb_header(data, what)
    note_mode("P")
    if len(data) - pos < w * h:
        raise ValueError(f"{what}: XV thumbnail data is truncated (PIL: buffer is not large "
                         "enough)")
    idx = np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)
    note_band(idx)
    return RGB332[idx]
