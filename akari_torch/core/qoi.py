"""QOI decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_qoi`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a QOI file (``QoiImagePlugin``): the 14-byte header
(width and height big-endian; the channels and colour-space bytes change
no pixel), then the op stream, decoded by ``akari_torch/native/qoi.cpp`` as
PIL's ``QoiDecoder`` decodes it. Data that ends before the last pixel is
refused, as PIL refuses it; the end marker is never read. A header shorter
than 13 bytes makes PIL try the formats after QOI (``NextFormat``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .image_formats import NextFormat, _check_size


def decode_qoi(data, what="QOI"):
    from ..native.loader import load

    data = bytes(data)
    if data[:4] != b"qoif":
        raise ValueError(f"{what}: not a QOI file")
    if len(data) < 13:
        raise NextFormat(f"{what}: QOI header is truncated")
    w, h = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    _check_size(w, h, what, "QOI")
    rgb = np.empty((h, w, 3), np.uint8)
    rc = load("qoi").akr_qoi_decode(data, len(data), 14, w * h,
                                    rgb.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise ValueError(f"{what}: QOI data ends before the last pixel (PIL: short read)")
    return rgb
