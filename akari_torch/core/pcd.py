"""Kodak PhotoCD (PCD) decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_pcd`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a PhotoCD file (``PcdImagePlugin``): the 768 x 512
base image only.

The format has no signature at the start: PIL opens any file holding
``PCD_`` at byte 2048 (``pcd_header``; a file too short for the orientation
byte at 2048 + 1538 makes PIL try the next format). The low two bits of
that byte rotate the image: 1 by 90 degrees counter-clockwise, 3 by 270.
The pixels start at 96 x 2048 bytes, 256 chunks of 2304 bytes: two rows of
768 luma bytes, then 384 bytes of each chroma, shared by a 2 x 2 block.
Pillow's ``pcd`` decoder unpacks them as Photo YCC (raw mode ``YCC;P``),
converted to RGB by five tables of its ``UnpackYCC.c``, which probing PIL
12.1.0 recovered exactly (on every (Y, C1, C2) triple): each entry is
``(int)(k * (v - offset) + 0.5)``, luma ``L = 1.3584 v``, red ``L + 1.8215
(C2 - 137)``, blue ``L + 2.2179 (C1 - 156)``, green ``L - 0.9271 (C2 - 137)
- 0.4303 (C1 - 156)``, each sum clipped to 0..255.
"""

from __future__ import annotations

import numpy as np

from .image_formats import NextFormat

W, H = 768, 512
DATA_OFFSET = 96 * 2048
CHUNK = 3 * W


def _table(k, offset):
    """A table as Pillow's: ``(int)(k * (v - offset) + 0.5)``, the cast
    truncating toward zero."""
    return np.trunc(k * (np.arange(256) - offset) + 0.5).astype(np.int32)


_L = _table(1.3584, 0)
_CR, _GR = _table(1.8215, 137), _table(-0.9271, 137)
_CB, _GB = _table(2.2179, 156), _table(-0.4303, 156)


def ycc_to_rgb(y, c1, c2):
    """Photo YCC bytes (any shape) -> [..., 3] uint8 RGB, Pillow's
    ``ImagingUnpackYCC``."""
    lum = _L[y]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pcd_header(data, what="PCD"):
    """``PcdImageFile._open``: the orientation (the low two bits of byte
    2048 + 1538)."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise NextFormat(f"{what}: not a PCD file (no PCD_ at byte 2048)")
    if len(s) < 1539:
        raise NextFormat(f"{what}: PCD header cut short before its orientation byte")
    return s[1538] & 3


def decode_pcd(data, what="PCD"):
    data = bytes(data)
    orientation = pcd_header(data, what)
    need = DATA_OFFSET + (H // 2) * CHUNK
    if len(data) < need:
        raise ValueError(f"{what}: PCD image data is truncated ({len(data)} of {need} bytes; "
                         "PIL: image file is truncated)")
    chunks = np.frombuffer(data, np.uint8, (H // 2) * CHUNK, DATA_OFFSET).reshape(H // 2, CHUNK)
    y = chunks[:, :2 * W].reshape(H, W)
    c1 = np.repeat(np.repeat(chunks[:, 2 * W:2 * W + W // 2], 2, axis=0), 2, axis=1)
    c2 = np.repeat(np.repeat(chunks[:, 2 * W + W // 2:], 2, axis=0), 2, axis=1)
    rgb = ycc_to_rgb(y, c1, c2)
    if orientation in (1, 3):   # Image.rotate(90 / 270, expand=True): counter-clockwise
        rgb = np.ascontiguousarray(np.rot90(rgb, orientation))
    return rgb
