"""FLI / FLC decoding without PIL (the first frame).

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_fli`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of an Autodesk FLI / FLC animation, its frame 0
(``FliImagePlugin``); ``fli_header`` is the plugin's open, which raises
``NextFormat`` where PIL tries the formats after FLI and ``ValueError``
where its open fails. The signature (two 16-bit fields) is weak, so the
open is a gate for the formats PIL tries after it (ICO, IM, TIFF, TGA ...).

- The 128-byte header: the magic 0xAF11 (FLI) or 0xAF12 (FLC) at 4, the
  frame count at 6 (0 makes PIL try the next format), the size at 8 and
  10, flags 0 or 3 at 14, and bytes 20-21, 42-79 and 88-127 zero.
- The palette: the grey ramp, patched by the first colour chunk (type 4,
  8-bit, or 11, 6-bit shifted left by 2 and kept to 8 bits) among the
  subchunks of the chunk at 128 (or of the chunk after it, when the one at
  128 is a 0xF100 prefix chunk): packets of a skip and a count (0 is 256),
  from the index the skips add up to. Reads past the end, or past entry
  255, make PIL try the next format.
- Frame 0: PIL reads the chunk at byte 128 as the frame (a prefix chunk
  there is not skipped, and fails the load as data of an unknown kind)
  into a zeroed buffer, fed by ``ImageFile.load`` in reads of the frame's
  size; ``native/rle.cpp::akr_fli_frame`` is one call of PIL's
  ``FliDecode.c`` (chunk types 4, 7 SS2, 11, 12 LC, 13 black, 15 BRUN, 16
  copy, 18 stamp; its bounds checks, and where a packet past a line's end
  stops the chunk). An overrun, an unknown chunk or a broken chunk size
  fail the load, as does a file that ends before the frame.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, note_band, note_mode

_ERRORS = {-2: "buffer overrun", -3: "unrecognized data stream contents",
           -4: "broken data stream"}


def _i16(data, pos):
    if pos + 2 > len(data):
        raise NextFormat("FLI field past the end of the file")
    return struct.unpack_from("<H", data, pos)[0]


def _i32(data, pos):
    if pos + 4 > len(data):
        raise NextFormat("FLI field past the end of the file")
    return struct.unpack_from("<I", data, pos)[0]


def _palette(data, pos, shift, palette):
    """``FliImageFile._palette`` from ``pos``: patches ``palette``."""
    i, count = 0, _i16(data, pos)
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        if len(s) < 2:
            raise NextFormat("FLI colour packet cut short")
        i, n = i + s[0], s[1] or 256
        s = data[pos + 2:pos + 2 + 3 * n]
        pos += 2 + 3 * n
        if len(s) % 3:
            raise NextFormat("FLI colour packet cut inside an entry")
        if i + len(s) // 3 > 256:
            raise NextFormat("FLI colour packet past entry 255")
        palette[i:i + len(s) // 3] = (np.frombuffer(s, np.uint8).reshape(-1, 3).astype(np.int32)
                                      << shift) & 255
        i += len(s) // 3


def fli_header(data, what="FLI"):
    """``FliImageFile._open`` on ``data``: (width, height, palette [256,
    3] uint8, frame size)."""
    try:
        head = data[:128]
        if not (len(head) == 128 and _i16(head, 4) in (0xAF11, 0xAF12)
                and _i16(head, 14) in (0, 3) and head[20:22] == bytes(2)
                and head[42:80] == bytes(38) and head[88:] == bytes(40)):
            raise NextFormat("not an FLI/FLC file")
        n_frames, w, h = _i16(head, 6), _i16(head, 8), _i16(head, 10)
        palette = np.repeat(np.arange(256, dtype=np.int32)[:, None], 3, axis=1)
        pos = 128
        if _i16(data, pos + 4) == 0xF100:   # a prefix chunk: its palette comes after it
            pos += _i32(data, pos)
        if _i16(data, pos + 4) == 0xF1FA:
            chunks = _i16(data, pos + 6)
            pos += 16
            size = None
            for _ in range(chunks):
                if size is not None:
                    pos += size - 6
                kind = _i16(data, pos + 4)
                if kind in (4, 11):
                    _palette(data, pos + 6, 2 if kind == 11 else 0, palette)
                    break
                size = _i32(data, pos)
                pos += 6
                if not size:
                    break
        if not n_frames:
            raise NextFormat("FLI of no frames (PIL: attempt to seek outside sequence)")
        frame_size = _i32(data, 128)  # PIL: missing frame size
    except NextFormat as e:
        raise NextFormat(f"{what}: {e}") from None
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: FLI of size {w} x {h}")
    _check_size(w, h, what, "FLI")
    return w, h, palette.astype(np.uint8), frame_size


def decode_fli(data, what="FLI"):
    from ..native.loader import load

    data = bytes(data)
    w, h, palette, frame_size = fli_header(data, what)
    note_mode("P")
    im = np.zeros((h, w), np.uint8)
    ptr = im.ctypes.data_as(ctypes.c_void_p)
    pos, buf = 128, b""
    while True:   # ImageFile.load: reads of the frame's size fed to the decoder
        s = data[pos:pos + frame_size]
        pos += len(s)
        if not s:
            raise ValueError(f"{what}: FLI frame 0 is truncated (PIL: image file is truncated)")
        buf += s
        n = load("rle").akr_fli_frame(buf, len(buf), w, h, ptr)
        if n == -1:
            break
        if n < -1:
            raise ValueError(f"{what}: FLI frame 0: {_ERRORS[n]} (PIL fails to load it)")
        buf = buf[n:]
    note_band(im)
    return palette[im]
