"""FTEX (Independence War 2 texture) decoding without PIL.

``decode_ftex`` returns the [H, W, 3] uint8 pixels of PIL's
``Image.open(path).convert("RGB")`` of an FTEX (``.ftc`` / ``.ftu``) file,
following ``PIL/FtexImagePlugin.py`` (Pillow 12.1.0): a header of signed
32-bit fields (version, width, height, mipmap count, format count, which
must be 1), one format entry (0: DXT1 blocks, decoded by
``akari_torch/native/bcn.cpp`` as PIL's ``bcn`` decoder; 1: raw RGB) and
its offset, where mip 0's size and bytes start. A negative mip size reads
to the end of the file, as Python's ``read`` does; data shorter than the
image needs is refused ("image file is truncated"), as is every other form
PIL refuses, with a ``ValueError`` naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from .dds import decode_blocks, to_rgb
from .image_formats import _check_size


def decode_ftex(data, what="FTEX"):
    """FTEX file bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")`` of mip 0."""
    data = bytes(data)
    if data[:4] != b"FTEX":
        raise ValueError(f"{what}: not an FTEX file")
    if len(data) < 32:
        raise ValueError(f"{what}: FTEX header is truncated")
    _, w, h, _, n_formats, fmt, where = struct.unpack_from("<7i", data, 4)
    if n_formats != 1:
        raise ValueError(f"{what}: FTEX of {n_formats} formats (PIL reads one)")
    if where < 0 or where + 4 > len(data):
        raise ValueError(f"{what}: FTEX format offset {where} outside the file")
    (size,) = struct.unpack_from("<i", data, where)
    start = where + 4
    mip = memoryview(data)[start:] if size < 0 else memoryview(data)[start:start + size]
    if fmt not in (0, 1):
        raise ValueError(f"{what}: FTEX format {fmt} (PIL reads 0, DXT1, and 1, raw RGB)")
    form = "FTEX DXT1" if fmt == 0 else "FTEX RGB"
    _check_size(w, h, what, form)
    if fmt == 0:
        return to_rgb(decode_blocks("BC1", mip, w, h, what, "FTEX"))
    need = w * h * 3
    if len(mip) < need:
        raise ValueError(f"{what}: FTEX RGB image data is truncated ({len(mip)} of {need} bytes)")
    return np.frombuffer(mip, np.uint8, need).reshape(h, w, 3).copy()
