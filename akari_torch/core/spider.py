"""SPIDER decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_spider`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a SPIDER file (``SpiderImagePlugin``).

The format has no signature: PIL reads the first 27 floats of every file
that reaches the plugin, big-endian first, then little-endian
(``spider_header``), and takes them for a header when labels 1, 2, 5, 12,
13, 22 and 23 are integers, ``iform`` (label 5) is one of 1, 3, -11, -12,
-21, -22, and the header's bytes (label 22) equal its records times their
length (labels 13 and 23). Only a 2D image (``iform`` 1) opens: a single
image (labels 24 and 27 zero: the data after the header), or a stack
(label 24 above zero, 27 zero: its first image, after a second header).
An image inside a stack opened directly fails in PIL (the plugin reads an
offset it has not set), and so do labels 24, 26 and 27 that are NaN or
infinite (``int`` of them raises); any other form makes PIL try the next
format (``NextFormat``). The pixels are 32-bit floats in the header's byte
order, width label 12, height label 2, read to 8 bits as PIL converts mode
``F`` (``image_formats._f_to_grey``).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, _f_to_grey, _grey, note_mode

IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f):
    return math.isfinite(f) and f == int(f)


def _header_len(t):
    """``isSpiderHeader``: the header's bytes, or 0 when ``t`` is not one."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labbyt = int(h[22])
    if labbyt != int(h[13]) * int(h[23]):
        return 0
    return labbyt


def spider_header(data, what="SPIDER"):
    """``SpiderImageFile._open``: (width, height, offset, byte order)."""
    if len(data) < 108:
        raise NextFormat(f"{what}: not a valid Spider file (shorter than its 27 labels)")
    for order in ">", "<":
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = _header_len(t)
        if hdrlen:
            break
    else:
        raise NextFormat(f"{what}: not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NextFormat(f"{what}: not a Spider 2D image (iform {int(h[5])})")
    w, ht = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])   # the stack's image count
    except (ValueError, OverflowError) as e:   # PIL's open fails on it
        raise ValueError(f"{what}: Spider stack labels: {e}") from None
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise ValueError(f"{what}: Spider image {imgnumber} of a stack opened on its own (PIL's "
                         "open fails: no stack offset)")
    else:
        raise NextFormat(f"{what}: inconsistent Spider stack header values")
    if w <= 0 or ht <= 0:
        raise NextFormat(f"{what}: Spider image of size {w} x {ht}")
    return w, ht, offset, order


def decode_spider(data, what="SPIDER"):
    data = bytes(data)
    w, h, offset, order = spider_header(data, what)
    _check_size(w, h, what, "Spider image")
    note_mode("F")
    if offset < 0:
        raise ValueError(f"{what}: Spider header of {offset} bytes (PIL cannot seek there)")
    if len(data) - offset < 4 * w * h:
        raise ValueError(f"{what}: Spider image data is truncated (PIL: image file is truncated)")
    v = np.frombuffer(data, order + "f4", w * h, offset).reshape(h, w)
    return _grey(_f_to_grey(v.astype(np.float32)))
