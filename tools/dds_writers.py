"""PIL-free writers of DDS, BLP and FTEX textures and of their BCn blocks
(NumPy, vectorised over blocks).

Encoders of real images (``chip_smoke.py`` writes the 2048^2 config-3
albedo with them on the card's machine, which has no PIL):

- ``bc1_encode``: per block the bounding box of its colours as the
  endpoints, quantised to 5:6:5 (c0 >= c1, the 4-colour mode unless the
  two quantise alike), each pixel the nearest of the four colours PIL's
  decoder makes of them;
- ``bc7_mode6_encode``: BC7 mode 6 (one subset, 7-bit RGBA endpoints with
  a p-bit each, 4-bit indices), the bounding box again, each pixel the
  weight nearest its projection on the endpoints' line, endpoints swapped
  where pixel 0's index would need its fourth bit;
- ``mip_levels``: a full mip chain by 2x2 box filtering down to 1x1.

Drawn blocks for the decoder's tests: ``random_blocks`` (any BCn form),
``bc7_blocks`` (a chosen mode, partition, rotation and index selection)
and ``bc6h_blocks`` (a chosen mode code, the reserved ones included), the
rest of each block random; ``set_fields`` packs bit fields into blocks.

Containers: ``dds_bytes`` (the 124-byte header, FourCC or mask pixel
formats, an optional DX10 header, mip levels after the top one),
``blp1_bytes`` / ``blp2_bytes`` (JPEG, palette or DXT content, the
palette and mip tables PIL reads) and ``ftex_bytes``.
"""

from __future__ import annotations

import struct

import numpy as np

# DDS header flags, caps and pixel format flags (Microsoft's DDS_HEADER)
DDSD_CAPS, DDSD_HEIGHT, DDSD_WIDTH, DDSD_PIXELFORMAT = 0x1, 0x2, 0x4, 0x1000
DDSD_MIPMAPCOUNT, DDSD_LINEARSIZE = 0x20000, 0x80000
DDSCAPS_COMPLEX, DDSCAPS_TEXTURE, DDSCAPS_MIPMAP = 0x8, 0x1000, 0x400000
DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000
BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16, "BC6H": 16, "BC7": 16}
# BC7: (subsets, partition bits, rotation bits, index-selection bits) of modes 0-7
BC7_MODES = ((3, 4, 0, 0), (2, 6, 0, 0), (3, 6, 0, 0), (2, 6, 0, 0), (1, 0, 2, 1),
             (1, 0, 2, 0), (1, 0, 0, 0), (2, 6, 0, 0))
# BC6H: the mode codes, 2 bits (0, 1) or 5 bits; the last four are reserved
BC6H_CODES = ((0, 2), (1, 2), (2, 5), (6, 5), (10, 5), (14, 5), (18, 5), (22, 5), (26, 5),
              (30, 5), (3, 5), (7, 5), (11, 5), (15, 5), (19, 5), (23, 5), (27, 5), (31, 5))
BC7_WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], np.int32)


def set_fields(bits, fields, pos=0):
    """Write ``fields`` [(values [n] or a scalar, bit count), ...] into the
    [n, 128] 0/1 array ``bits`` from bit ``pos`` on, least significant bit
    first; returns the bit after them."""
    n = bits.shape[0]
    for vals, nb in fields:
        v = np.broadcast_to(np.asarray(vals, np.int64), (n,))
        bits[:, pos:pos + nb] = (v[:, None] >> np.arange(nb)) & 1
        pos += nb
    return pos


def bits_to_blocks(bits):
    """[n, 128] 0/1 -> [n, 16] uint8 blocks (bit 0 the low bit of byte 0)."""
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def random_blocks(r, n, form):
    """n random blocks of ``form`` (``BLOCK_BYTES``) -> bytes."""
    return r.integers(0, 256, (n, BLOCK_BYTES[form]), dtype=np.uint8).tobytes()


def bc7_blocks(r, n, mode, partition=None, rotation=None, index_sel=None):
    """n BC7 blocks of ``mode`` (0-7; 8 gives the reserved all-zero first
    byte), the partition, rotation and index selection given or random, the
    rest random -> bytes."""
    bits = r.integers(0, 2, (n, 128), dtype=np.uint8)
    if mode == 8:
        bits[:, :8] = 0
        return bits_to_blocks(bits).tobytes()
    _, pb, rb, isb = BC7_MODES[mode]
    fields = [(1 << mode, mode + 1)]
    for value, nb in ((partition, pb), (rotation, rb), (index_sel, isb)):
        fields.append((r.integers(0, 1 << nb, n) if value is None else value, nb))
    set_fields(bits, fields)
    return bits_to_blocks(bits).tobytes()


def bc6h_blocks(r, n, code):
    """n BC6H blocks whose mode bits are ``code`` (an entry of
    ``BC6H_CODES``), the rest random -> bytes."""
    bits = r.integers(0, 2, (n, 128), dtype=np.uint8)
    set_fields(bits, [code])
    return bits_to_blocks(bits).tobytes()


def _block_pixels(img):
    """[H, W, C] -> [n, 16, C] int32 blocks (row-major within a block,
    blocks row-major), the edge blocks padded by repeating the last row and
    column."""
    h, w, c = img.shape
    ph, pw = -(-h // 4) * 4, -(-w // 4) * 4
    img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge").astype(np.int32)
    return img.reshape(ph // 4, 4, pw // 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c)


def _expand565(c):
    """uint 5:6:5 words [n] -> [n, 3] int32, high bits replicated."""
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)], axis=-1)


def _nearest(px, palette):
    """[n, 16, 3] pixels, [n, k, 3] colours -> [n, 16] index of the nearest."""
    d = px[:, :, None, :] - palette[:, None, :, :]
    return (d * d).sum(-1).argmin(-1)


def bc1_encode(rgb, chunk=65536):
    """[H, W, 3] uint8 -> BC1 blocks (bytes), as the module docstring says."""
    px = _block_pixels(np.asarray(rgb, np.uint8)[..., :3])
    out = np.zeros(len(px), [("c0", "<u2"), ("c1", "<u2"), ("lut", "<u4")])
    for s in range(0, len(px), chunk):
        p = px[s:s + chunk]
        hi, lo = p.max(axis=1), p.min(axis=1)
        c0 = ((hi[:, 0] >> 3) << 11) | ((hi[:, 1] >> 2) << 5) | (hi[:, 2] >> 3)
        c1 = ((lo[:, 0] >> 3) << 11) | ((lo[:, 1] >> 2) << 5) | (lo[:, 2] >> 3)
        e0, e1 = _expand565(c0), _expand565(c1)
        palette = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], axis=1)
        idx = np.where((c0 == c1)[:, None], 0, _nearest(p, palette))
        out["c0"][s:s + chunk], out["c1"][s:s + chunk] = c0, c1
        out["lut"][s:s + chunk] = (idx.astype(np.uint32) << (2 * np.arange(16, dtype=np.uint32))
                                   ).sum(axis=1, dtype=np.uint32)
    return out.tobytes()


def bc7_mode6_encode(rgb, chunk=32768):
    """[H, W, 3] uint8 -> BC7 mode-6 blocks (bytes), alpha 255."""
    px = _block_pixels(np.asarray(rgb, np.uint8)[..., :3])
    blocks = np.zeros((len(px), 16), np.uint8)
    w = BC7_WEIGHTS4
    for s in range(0, len(px), chunk):
        p = px[s:s + chunk]
        n = len(p)
        v0 = np.maximum(p.min(axis=1) - 1, 0) >> 1   # 7-bit endpoints with p-bit 1
        v1 = p.max(axis=1) >> 1
        e0, e1 = 2 * v0 + 1, 2 * v1 + 1
        axis = (e1 - e0).astype(np.float32)               # the weight of each pixel's
        t = ((p - e0[:, None, :]) * axis[:, None, :]).sum(-1) * 64.0 / np.maximum(
            (axis * axis).sum(-1), 1.0)[:, None]          # projection on the line
        idx = np.searchsorted((w[1:] + w[:-1]) / 2.0, t)
        swap = idx[:, 0] >= 8                           # pixel 0 has three index bits
        v0[swap], v1[swap] = v1[swap].copy(), v0[swap].copy()
        idx[swap] = 15 - idx[swap]
        bits = np.zeros((n, 128), np.uint8)
        fields = [(1 << 6, 7)]
        for c in range(3):
            fields += [(v0[:, c], 7), (v1[:, c], 7)]
        fields += [(127, 7), (127, 7), (1, 1), (1, 1)]  # alpha 127 and p-bits 1: 255
        fields += [(idx[:, 0], 3)] + [(idx[:, k], 4) for k in range(1, 16)]
        set_fields(bits, fields)
        blocks[s:s + chunk] = bits_to_blocks(bits)
    return blocks.tobytes()


def mip_levels(rgb):
    """[H, W, 3] uint8 -> [level 0 (the image), level 1, ..., 1x1], each a
    2x2 box filter of the one before (an odd edge is dropped)."""
    levels = [np.asarray(rgb, np.uint8)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        a = levels[-1].astype(np.uint16)
        h, w = max(1, a.shape[0] // 2), max(1, a.shape[1] // 2)
        ys = (np.arange(h)[:, None] * 2 + np.array([0, 1])).clip(0, a.shape[0] - 1)
        xs = (np.arange(w)[:, None] * 2 + np.array([0, 1])).clip(0, a.shape[1] - 1)
        box = a[ys[:, None, :, None], xs[None, :, None, :]]  # [h, w, 2, 2, 3]
        levels.append(((box.sum(axis=(2, 3)) + 2) // 4).astype(np.uint8))
    return levels


def dds_header(width, height, *, fourcc=b"", pf_flags=None, bitcount=0, masks=(0, 0, 0, 0),
               mips=1, dxgi=None, linear_size=0, caps2=0, array_size=1, header_size=124):
    """The DDS magic, the 124-byte header and, for ``dxgi``, the DX10
    header (FourCC ``DX10``). ``pf_flags`` defaults to FOURCC."""
    if dxgi is not None:
        fourcc = b"DX10"
    flags = DDSD_CAPS | DDSD_HEIGHT | DDSD_WIDTH | DDSD_PIXELFORMAT
    flags |= (DDSD_MIPMAPCOUNT if mips > 1 else 0) | (DDSD_LINEARSIZE if linear_size else 0)
    caps = DDSCAPS_TEXTURE | (DDSCAPS_COMPLEX | DDSCAPS_MIPMAP if mips > 1 else 0)
    pf = DDPF_FOURCC if pf_flags is None else pf_flags
    out = (b"DDS " + struct.pack("<7I", header_size, flags, height, width, linear_size, 0, mips)
           + bytes(44) + struct.pack("<I", 32) + struct.pack("<I4sI", pf, fourcc.ljust(4, b"\0"),
                                                             bitcount)
           + struct.pack("<4I", *masks) + struct.pack("<5I", caps, caps2, 0, 0, 0))
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, array_size, 0)
    return out


def dds_bytes(width, height, levels, **header):
    """A DDS file: ``dds_header(width, height, mips=len(levels), ...)`` and
    the levels' bytes, the top level first."""
    return dds_header(width, height, mips=len(levels), **header) + b"".join(levels)


def dds_albedo(rgb, form):
    """[H, W, 3] uint8 -> a DDS of its full mip chain as ``form``: "BC1"
    (FourCC DXT1) or "BC7" (DX10, BC7_UNORM_SRGB), each level encoded by
    ``bc1_encode`` / ``bc7_mode6_encode``."""
    enc, kw = {"BC1": (bc1_encode, dict(fourcc=b"DXT1")),
               "BC7": (bc7_mode6_encode, dict(dxgi=99))}[form]
    levels = [enc(level) for level in mip_levels(rgb)]
    h, w = np.asarray(rgb).shape[:2]
    return dds_bytes(w, h, levels, linear_size=len(levels[0]), **kw)


def _mip_table(start, mips):
    """The 16 offsets and 16 lengths of BLP mips stored from ``start`` on."""
    offsets, lengths, pos = [0] * 16, [0] * 16, start
    for i, m in enumerate(mips[:16]):
        offsets[i], lengths[i] = pos, len(m)
        pos += len(m)
    return struct.pack("<16I", *offsets) + struct.pack("<16I", *lengths)


def blp1_bytes(width, height, mips, *, compression=1, alpha=0, encoding=5, jpeg_header=b"",
               palette=None):
    """A BLP1 file: ``compression`` 0 (JPEG: ``jpeg_header``, the stream's
    shared head, before the mips) or 1 (``palette``, 256 BGRA entries, then
    the mips' indices); ``alpha`` the alpha bit depth."""
    head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, width, height, encoding, 0)
    if compression == 0:
        body = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        body = bytes(np.asarray(palette if palette is not None else np.zeros((256, 4)),
                                np.uint8).reshape(-1)[:1024].tobytes()).ljust(1024, b"\0")
    start = len(head) + 128 + len(body)
    return head + _mip_table(start, mips) + body + b"".join(mips)


def blp2_bytes(width, height, mips, *, encoding=2, alpha_depth=0, alpha_encoding=0,
               palette=None, compression=1):
    """A BLP2 file: ``encoding`` 1 (palette indices) or 2 (DXT blocks,
    ``alpha_encoding`` 0 / 1 / 7 for DXT1 / DXT3 / DXT5), the 1,024-byte
    palette (zeros unless given), then the mips."""
    head = b"BLP2" + struct.pack("<i4B", compression, encoding & 0xFF, alpha_depth & 0xFF,
                                 alpha_encoding & 0xFF, 1 if len(mips) > 1 else 0)
    head += struct.pack("<II", width, height)
    pal = (np.zeros((256, 4), np.uint8) if palette is None
           else np.asarray(palette, np.uint8)).reshape(-1)[:1024].tobytes().ljust(1024, b"\0")
    start = len(head) + 128 + 1024
    return head + _mip_table(start, mips) + pal + b"".join(mips)


def ftex_bytes(width, height, fmt, mips, version=1):
    """An FTEX file of one format (``fmt`` 0 DXT1 blocks, 1 raw RGB): the
    header, the format directory, then each mip as its size and bytes."""
    head = struct.pack("<4s5i", b"FTEX", version, width, height, len(mips), 1)
    head += struct.pack("<2i", fmt, len(head) + 8)
    return head + b"".join(struct.pack("<i", len(m)) + m for m in mips)
