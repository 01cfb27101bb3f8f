"""ICNS (Mac OS icon) decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_icns`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of an ICNS file, read as Pillow 12.1's
``IcnsImagePlugin`` reads it:

- the block walk (``IcnsFile``): the 8-byte file header, then block
  headers (a type and a length that counts its own 8 bytes) up to the
  header's file length, a later block of a type replacing an earlier one;
  a block header past the end of the file, a length of 0 (or one that
  wraps negative), and a file without any icon type PIL knows make PIL
  try the formats after ICNS (``NextFormat``);
- the size read is the largest (width, height, scale) of ``SIZES`` with a
  block present (``bestsize``); every block of that size is read, in the
  table's order, so a damaged block of it refuses the file even where a
  PNG of the same size would be returned;
- ``ic07``-``ic14`` and ``icp4``-``icp6``: a PNG (read from the block's
  start to its IEND, whatever the block's length: ``decode_png``) or a
  JPEG 2000 codestream or JP2 file (the block's bytes: ``decode_jpeg2000``),
  which PIL converts to RGBA and then to RGB; its size must be one PIL
  accepts for the file (one of the file's sizes divided by a whole scale);
- ``it32`` (after four zero bytes), ``ih32``, ``il32``, ``is32``: 24-bit
  pixels, raw when the block holds exactly width x height x 3 bytes, else
  three channels of PackBits-like runs (a byte n < 128 copies n + 1
  bytes, n >= 128 repeats the next byte n - 125 times) read on from the
  block's start past its end if need be; a channel that ends short or
  overruns by a run is refused, as PIL refuses it;
- ``t8mk``, ``h8mk``, ``l8mk``, ``s8mk``: the 8-bit mask, width x height
  bytes from the block's start; PIL reads it as alpha, which
  ``convert("RGB")`` drops, but refuses the file when it is short.
"""

from __future__ import annotations

import struct

import numpy as np

from .image import PNG_SIGNATURE, decode_png
from .image_formats import NextFormat, note_mode

MAGIC = b"icns"
_J2K_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# IcnsFile.SIZES: (width, height, scale) -> the block types read, in order
SIZES = {
    (512, 512, 2): ((b"ic10", "image"),),
    (512, 512, 1): ((b"ic09", "image"),),
    (256, 256, 2): ((b"ic14", "image"),),
    (256, 256, 1): ((b"ic08", "image"),),
    (128, 128, 2): ((b"ic13", "image"),),
    (128, 128, 1): ((b"ic07", "image"), (b"it32", "rgb32t"), (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "image"),),
    (32, 32, 2): ((b"ic12", "image"),),
    (48, 48, 1): ((b"ih32", "rgb32"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "image"), (b"il32", "rgb32"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "image"),),
    (16, 16, 1): ((b"icp4", "image"), (b"is32", "rgb32"), (b"s8mk", "mask")),
}


def blocks(data, what="ICNS"):
    """``IcnsFile.__init__``'s walk: block type -> (start, length)."""
    if len(data) < 8 or data[:4] != MAGIC:
        raise NextFormat(f"{what}: not an ICNS file")
    (filesize,) = struct.unpack_from(">I", data, 4)
    found, i = {}, 8
    while i < filesize:
        if len(data) < i + 8:
            raise NextFormat(f"{what}: ICNS block header at {i} past the end of the file")
        kind, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise NextFormat(f"{what}: ICNS block {kind!r} of length 0 (PIL: invalid block "
                             "header)")
        i += 8
        found[kind] = (i, size - 8)
        i += size - 8
    return found


def _rgb32(data, start, length, side, what):
    """``read_32``: [side, side, 3] from the raw bytes or the channel runs."""
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError(f"{what}: ICNS 24-bit icon is truncated (PIL: not enough image "
                             "data)")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3)
    rgb = np.empty((3, n), np.uint8)
    pos, end = start, len(data)
    for band in range(3):
        parts, left = [], n
        while left > 0:
            if pos >= end:
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                parts.append(data[pos:pos + 1] * count)
                pos = min(pos + 1, end)
            else:
                count = b + 1
                parts.append(data[pos:pos + count])
                pos = min(pos + count, end)
            left -= count
        if left != 0:
            raise ValueError(f"{what}: ICNS 24-bit icon channel {band} ends with {left} bytes "
                             "left (PIL: error reading channel)")
        chan = b"".join(parts)
        if len(chan) < n:
            raise ValueError(f"{what}: ICNS 24-bit icon channel {band} is truncated (PIL: "
                             "buffer is not large enough)")
        rgb[band] = np.frombuffer(chan, np.uint8)
    return np.ascontiguousarray(rgb.T.reshape(side, side, 3))


def _image(data, start, length, what):
    """``read_png_or_jpeg2000``: the PNG or JPEG 2000 payload's pixels."""
    from .jpeg2000 import decode_jpeg2000

    sig = data[start:start + 12]
    if sig.startswith(PNG_SIGNATURE):
        return decode_png(data[start:], what)
    if sig.startswith(_J2K_SIGNATURES) or sig == _JP2_SIGNATURE:
        payload = data[start:start + length] if length >= 0 else data[start:]
        try:
            return decode_jpeg2000(payload, what)
        except NextFormat as e:  # read here by the plugin itself, not by Image.open
            raise ValueError(f"{e} (in an ICNS icon)") from None
    raise ValueError(f"{what}: ICNS icon {sig[:4]!r} is neither PNG nor JPEG 2000 (PIL: "
                     "unsupported icon subimage format)")


def decode_icns(data, what="ICNS"):
    data = bytes(data)
    note_mode("RGBA")   # ICNS opens as RGBA whatever its icon holds
    found = blocks(data, what)
    sizes = [size for size, kinds in SIZES.items() if any(k in found for k, _ in kinds)]
    if not sizes:
        raise NextFormat(f"{what}: ICNS without an icon PIL reads (PIL: no 32bit icon "
                         "resources found)")
    best = max(sizes)
    side = best[0] * best[2]
    image = rgb = None
    for kind, reader in SIZES[best]:
        if kind not in found:
            continue
        start, length = found[kind]
        if reader == "image":
            image = _image(data, start, length, what)
        elif reader == "mask":
            if len(data) - start < side * side:
                raise ValueError(f"{what}: ICNS mask {kind!r} is truncated (PIL: buffer is not "
                                 "large enough)")
        else:
            if reader == "rgb32t":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{what}: ICNS it32 icon without its four zero bytes (PIL: "
                                     "unknown signature)")
                start, length = start + 4, length - 4
            rgb = _rgb32(data, start, length, side, what)
    if image is None:
        if rgb is None:
            raise ValueError(f"{what}: ICNS of a mask without its icon (PIL: KeyError 'RGB')")
        return rgb
    h, w = image.shape[:2]
    # IcnsImageFile.size's setter: one of the file's sizes over a whole scale
    if not any((s[1] * s[2]) / h == (s[0] * s[2]) // w for s in sizes):
        raise ValueError(f"{what}: ICNS icon of {w} x {h} in a {side} x {side} entry (PIL: not "
                         "one of the allowed sizes of this image)")
    return image
