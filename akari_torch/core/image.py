"""Image output without PIL (``akari_tpu/core/image.py`` writers).

``write_png`` encodes an 8-bit sRGB PNG with the standard library only
(``zlib`` + ``struct``): one IHDR, one IDAT with filter type 0 on every
scanline, one IEND. ``write_hdr_npy`` keeps the linear float image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .spectrum import to_uint8_srgb


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def encode_png(rgb8):
    """[H, W, 3] uint8 -> PNG file bytes."""
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got shape {rgb8.shape}")
    # every scanline is prefixed with filter type 0 (None)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img_linear):
    """[H,W,3] linear float -> sRGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8_srgb(np.asarray(img_linear))))


def write_hdr_npy(path, img_linear):
    np.save(path, np.asarray(img_linear, dtype=np.float32))
