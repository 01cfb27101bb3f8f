"""DDS (DirectDraw Surface) decoding without PIL.

The JAX package reads every texture with PIL (``Image.open(path)
.convert("RGB")``); ``decode_dds`` returns the [H, W, 3] uint8 pixels of
that call for a DDS file, following ``PIL/DdsImagePlugin.py`` (Pillow
12.1.0) line for line, and raises ``ValueError`` naming the form wherever
PIL refuses the file:

- the ``DDS `` magic and a header size of exactly 124 (with all 120
  header bytes present);
- the pixel format's flags in PIL's order: ``RGB`` (with or without
  ``ALPHAPIXELS``: the uncompressed mask forms), then ``LUMINANCE`` (L at
  8 bits, LA at 16 bits with ``ALPHAPIXELS``), then ``PALETTEINDEXED8`` (a
  1,024-byte RGBA palette), then ``FOURCC``: ``DXT1`` / ``DXT3`` /
  ``DXT5``, ``BC4U`` / ``ATI1``, ``BC5U`` / ``ATI2``, ``BC5S`` and ``DX10``,
  whose DXGI codes PIL reads are BC1-BC5 typeless / unorm, BC5 snorm, BC6H
  UF16 / SF16, BC7 typeless / unorm / srgb and R8G8B8A8 typeless / unorm /
  srgb;
- the top level of the image only: mip levels, cube faces past the first
  and array slices follow it and are never read (PIL ignores the caps).

PIL's DDS reader never seeks to the offsets of its tiles (``load_seek``
is a no-op), so the pixel data begins where the header reads stopped:
byte 128, after the palette for ``P``, after the 20 DX10 bytes for DX10.
Blocks decode in ``akari_torch/native/bcn.cpp`` (Pillow's ``bcn``
decoder); a payload shorter than the blocks or pixels the size needs is
refused as PIL refuses it ("image file is truncated"). The mask forms
(PIL's ``DdsRgbDecoder``) scale each channel by ``int(v / max * 255)`` in
floating point and pad a short payload with zeros rather than failing.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import _check_size, note_band, note_mode

MAGIC = b"DDS "
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000

# FourCC -> the block form (PIL's DXT1 / DXT3 / DXT5 are BC1 / BC2 / BC3)
FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4",
           b"BC5S": "BC5S", b"BC5U": "BC5", b"ATI2": "BC5"}
# DXGI code of a DX10 header -> the block form ("RGBA": uncompressed R8G8B8A8)
DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4",
        80: "BC4", 82: "BC5", 83: "BC5", 84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7",
        98: "BC7", 99: "BC7", 27: "RGBA", 28: "RGBA", 29: "RGBA"}
# block form -> (entry point of bcn.cpp, block bytes, output channels, signed)
BLOCKS = {"BC1": ("akr_bc1", 8, 4, None), "BC2": ("akr_bc2", 16, 4, None),
          "BC3": ("akr_bc3", 16, 4, None), "BC4": ("akr_bc4", 8, 1, None),
          "BC5": ("akr_bc5", 16, 3, 0),
          "BC5S": ("akr_bc5", 16, 3, 1), "BC6H": ("akr_bc6h", 16, 3, 0),
          "BC6HS": ("akr_bc6h", 16, 3, 1), "BC7": ("akr_bc7", 16, 4, None)}


def decode_blocks(fmt, payload, w, h, what, container="DDS"):
    """The BCn blocks of a w x h image -> [h, w, C] uint8 in PIL's mode for
    ``fmt`` (RGBA, L or RGB; ``BLOCKS``); raises ValueError when the payload
    holds fewer bytes than the blocks the size needs."""
    from ..native.loader import load

    fn, block, ch, sign = BLOCKS[fmt]
    need = -(-w // 4) * -(-h // 4) * block
    if len(payload) < need:
        raise ValueError(f"{what}: {container} {fmt} image data is truncated ({len(payload)} "
                         f"of {need} bytes)")
    out = np.empty((h, w, ch), np.uint8)
    args = (bytes(payload[:need]), need, w, h) + (() if sign is None else (sign,))
    getattr(load("bcn"), fn)(*args, out.ctypes.data_as(ctypes.c_void_p))
    return out


def to_rgb(px):
    """[H, W, C] pixels of mode L (1), RGB (3) or RGBA (4) -> [H, W, 3], as
    ``convert("RGB")``: grey replicated, alpha dropped."""
    if px.shape[-1] == 1:
        return np.repeat(px, 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _raw(data, pos, w, h, ch, what, form):
    """PIL's raw decoder: w * h * ch bytes from ``pos`` -> [h, w, ch]."""
    need = w * h * ch
    if len(data) - pos < need:
        raise ValueError(f"{what}: DDS {form} image data is truncated "
                         f"({max(0, len(data) - pos)} of {need} bytes)")
    return np.frombuffer(data, np.uint8, need, pos).reshape(h, w, ch)


def _mask_pixels(data, pos, w, h, bitcount, masks):
    """PIL's ``DdsRgbDecoder``: ``bitcount // 8`` little-endian bytes a
    pixel from ``pos`` (zeros past the end of the data), each mask's bits
    shifted down by its trailing zeros and scaled by int(v / max * 255)."""
    n, nb = w * h, bitcount // 8
    words = np.zeros(n, np.uint32)
    if nb:
        raw = np.zeros(n * nb, np.uint8)
        got = np.frombuffer(data, np.uint8, max(0, min(n * nb, len(data) - pos)), pos)
        raw[:got.size] = got
        raw = raw.reshape(n, nb)[:, :4].astype(np.uint32)  # the masks are 32-bit
        for k in range(raw.shape[1]):
            words |= raw[:, k] << np.uint32(8 * k)
    out = np.zeros((n, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if mask == 0:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (words & np.uint32(mask)) >> np.uint32(shift)
        out[:, c] = (v.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def decode_dds(data, what="DDS"):
    """DDS file bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")`` of the top level."""
    data = bytes(data)
    if data[:4] != MAGIC:
        raise ValueError(f"{what}: not a DDS file")
    if len(data) < 8:
        raise ValueError(f"{what}: DDS without a header size")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise ValueError(f"{what}: DDS header size {header_size} (PIL reads 124 only)")
    if len(data) < 128:
        raise ValueError(f"{what}: DDS header is incomplete ({len(data) - 8} of 120 bytes)")
    _, height, width = struct.unpack_from("<3I", data, 8)
    pf_flags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    pos = 128
    if pf_flags & RGB:
        n = 4 if pf_flags & ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", data, 92)
        _check_size(width, height, what, f"DDS {'RGBA' if n == 4 else 'RGB'} masks")
        return to_rgb(_mask_pixels(data, pos, width, height, bitcount, masks))
    if pf_flags & LUMINANCE:
        if bitcount == 8:
            ch = 1
        elif bitcount == 16 and pf_flags & ALPHAPIXELS:
            ch = 2
        else:
            raise ValueError(f"{what}: DDS luminance of {bitcount} bits a pixel (pixel format "
                             f"flags {pf_flags:#x}) is not a form PIL reads")
        form = "L" if ch == 1 else "LA"
        _check_size(width, height, what, f"DDS {form}")
        note_mode(form)
        return to_rgb(_raw(data, pos, width, height, ch, what, form)[..., :1])
    if pf_flags & PALETTEINDEXED8:
        palette = np.zeros((256, 4), np.uint8)
        pal = np.frombuffer(data, np.uint8, min(1024, len(data) - pos) // 4 * 4, pos)
        palette[:pal.size // 4] = pal.reshape(-1, 4)
        pos += 1024
        _check_size(width, height, what, "DDS palette")
        idx = _raw(data, pos, width, height, 1, what, "palette")[..., 0]
        note_band(idx)
        return palette[idx, :3]
    if not pf_flags & FOURCC:
        raise ValueError(f"{what}: DDS of pixel format flags {pf_flags:#x} (none PIL reads)")
    if fourcc == b"DX10":
        if len(data) < pos + 4:
            raise ValueError(f"{what}: DDS DX10 header is truncated")
        (dxgi,) = struct.unpack_from("<I", data, pos)
        pos += 20
        fmt = DXGI.get(dxgi)
        if fmt is None:
            raise ValueError(f"{what}: DDS of DXGI format {dxgi} (PIL does not read it)")
        if fmt == "RGBA":
            _check_size(width, height, what, "DDS R8G8B8A8")
            return to_rgb(_raw(data, pos, width, height, 4, what, "R8G8B8A8"))
    else:
        fmt = FOURCCS.get(fourcc)
        if fmt is None:
            raise ValueError(f"{what}: DDS of FourCC {fourcc!r} (PIL does not read it)")
    _check_size(width, height, what, f"DDS {fmt}")
    note_mode("L" if fmt == "BC4" else "RGB")
    return to_rgb(decode_blocks(fmt, memoryview(data)[pos:], width, height, what))
