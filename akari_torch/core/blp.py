"""BLP (Blizzard Mipmap) decoding without PIL.

``decode_blp`` returns the [H, W, 3] uint8 pixels of PIL's
``Image.open(path).convert("RGB")`` of a BLP file, following
``PIL/BlpImagePlugin.py`` (Pillow 12.1.0), and raises ``ValueError``
naming the form wherever PIL refuses it. Only mip 0 is read:

- BLP1 (``compression`` 0): a JPEG stream, the shared header after the
  mip tables followed by mip 0's data (read from the mip table's offset,
  or straight on when that offset lies behind), decoded by the port's
  JPEG decoder; PIL stores its RGB bytes as BGR, so red and blue swap, and
  a four-component JPEG is read as CMYK even where its Adobe marker says
  YCCK;
- BLP1 (``compression`` 1, encoding 4 or 5): 256 BGRA palette entries,
  then mip 0's indices straight after them (PIL ignores the offset);
- BLP2 (``compression`` 1): after the 1,024-byte palette, mip 0 at its
  offset, as palette indices (encoding 1) or DXT1 / DXT3 / DXT5 blocks
  (encoding 2, alpha encoding 0 / 1 / 7).

PIL decodes BLP2's DXT blocks with the plugin's own Python, not its C
``bcn`` decoder, and the two differ: the 5:6:5 endpoints expand by a
plain shift (no replicated high bits), and a block row yields four rows of
``4 * ceil(W / 4)`` pixels of 4 bytes (DXT1 without alpha: 3) that PIL
then reads as a stream of W-pixel rows of the image's mode (RGB, or RGBA
with alpha): a width that is not a multiple of 4, or DXT3 / DXT5 blocks in
an image without alpha, shift the stream against the rows, and the port
reads the same stream the same way. The palette forms give the stream of
RGB (or RGBA) entries likewise; a stream shorter than the image is
refused ("not enough image data").
"""

from __future__ import annotations

import struct

import numpy as np

from .image_formats import _check_size, note_mode


def _take(data, pos, n, what):
    """PIL's ``_safe_read``: n bytes from ``pos`` or a refusal."""
    if n <= 0:
        return b""
    if pos + n > len(data):
        raise ValueError(f"{what}: BLP is truncated (needs {n} bytes at {pos}, the file has "
                         f"{len(data)})")
    return data[pos:pos + n]


def _unpack565(c):
    """uint 5:6:5 words -> [..., 3] int32 as the plugin's ``unpack_565``."""
    c = c.astype(np.int32)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _dxt_colours(blocks, three_colour):
    """[n, 8] colour blocks -> ([n, 16, 3] RGB, [n, 16] whether index 3 of
    a 3-colour block), as the plugin's ``decode_dxt1/3/5``."""
    c0 = blocks[:, 0].astype(np.int32) | (blocks[:, 1].astype(np.int32) << 8)
    c1 = blocks[:, 2].astype(np.int32) | (blocks[:, 3].astype(np.int32) << 8)
    bits = blocks[:, 4:8].astype(np.uint32) @ np.array([1, 1 << 8, 1 << 16, 1 << 24], np.uint32)
    code = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    e0, e1 = _unpack565(c0), _unpack565(c1)
    four = (c0 > c1) | (not three_colour)
    p2 = np.where(four[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(four[:, None], (2 * e1 + e0) // 3, 0)
    pal = np.stack([e0, e1, p2, p3], axis=1)  # [n, 4, 3]
    rgb = np.take_along_axis(pal, code[..., None].astype(np.int64), axis=1)
    return rgb, (code == 3) & ~four[:, None]


def _dxt_stream(rows, bx, kind, alpha):
    """[by, bx * block bytes] block rows -> the plugin's byte stream: each
    block row as four pixel rows of 4 * bx pixels."""
    by = rows.shape[0]
    blocks = rows.reshape(by * bx, -1)
    if kind == 0:
        rgb, clear = _dxt_colours(blocks, True)
        a = np.where(clear, 0, 255)
    else:
        rgb, _ = _dxt_colours(blocks[:, 8:], False)
        if kind == 1:
            nib = (blocks[:, np.arange(16) // 2] >> (4 * (np.arange(16) % 2))) & 0xF
            a = nib.astype(np.int32) * 17
        else:
            a0, a1 = blocks[:, 0].astype(np.int32), blocks[:, 1].astype(np.int32)
            word = blocks[:, 2:8].astype(np.uint64) @ (np.uint64(1) << (8 * np.arange(6,
                                                                           dtype=np.uint64)))
            code = ((word[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & 7).astype(np.int32)
            a0, a1 = a0[:, None], a1[:, None]
            eight = ((8 - code) * a0 + (code - 1) * a1) // 7
            six = np.where(code == 6, 0, np.where(code == 7, 255,
                                                  ((6 - code) * a0 + (code - 1) * a1) // 5))
            a = np.where(code == 0, a0, np.where(code == 1, a1, np.where(a0 > a1, eight, six)))
    px = np.concatenate([rgb, a[..., None]], axis=-1) if (alpha or kind) else rgb
    px = px.astype(np.uint8).reshape(by, bx, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.reshape(-1)


def _palette(data, pos, what):
    """256 BGRA entries -> [256, 4] RGBA (PIL reads all 256 or refuses)."""
    pal = np.frombuffer(_take(data, pos, 1024, what), np.uint8).reshape(256, 4)
    return pal[:, [2, 1, 0, 3]]


def _image(stream, w, h, ch, what):
    """PIL's ``set_as_raw``: the first h rows of w pixels of ``ch`` bytes of
    the stream -> [h, w, 3]."""
    need = w * h * ch
    if stream.size < need:
        raise ValueError(f"{what}: BLP holds {stream.size} bytes of pixels, the image "
                         f"{need} (not enough image data)")
    return np.ascontiguousarray(stream[:need].reshape(h, w, ch)[..., :3])


def decode_blp(data, what="BLP"):
    """BLP1 / BLP2 file bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")`` of mip 0."""
    data = bytes(data)
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError(f"{what}: not a BLP file")
    note_mode("RGB")   # PIL opens BLP as RGB or RGBA, whatever its mip 0 holds
    head = 28 if magic == b"BLP1" else 20
    if len(data) < head:
        raise ValueError(f"{what}: {magic.decode()} header is truncated")
    (compression,) = struct.unpack_from("<i", data, 4)
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        (encoding,) = struct.unpack_from("<i", data, 20)
    else:
        encoding, alpha_depth, alpha_encoding = struct.unpack_from("<3b", data, 8)
        alpha = alpha_depth != 0
    w, h = struct.unpack_from("<II", data, 12)
    form = f"{magic.decode()} {'JPEG' if magic == b'BLP1' and compression == 0 else 'image'}"
    _check_size(w, h, what, form)
    ch = 4 if alpha else 3
    offsets = struct.unpack("<16I", _take(data, head, 64, what))
    lengths = struct.unpack("<16I", _take(data, head + 64, 64, what))
    pos = head + 128
    if magic == b"BLP1":
        if compression == 0:
            return _blp1_jpeg(data, pos, offsets[0], lengths[0], w, h, what)
        if compression != 1:
            raise ValueError(f"{what}: BLP1 compression {compression} (PIL reads 0 and 1)")
        if encoding not in (4, 5):
            raise ValueError(f"{what}: BLP1 palette encoding {encoding} (PIL reads 4 and 5)")
        pal = _palette(data, pos, what)
        idx = np.frombuffer(_take(data, pos + 1024, lengths[0], what), np.uint8)
        return _image(pal[idx, :ch].reshape(-1), w, h, ch, what)
    pal = _palette(data, pos, what)
    if compression != 1:
        raise ValueError(f"{what}: BLP2 compression {compression} (PIL reads 1)")
    if encoding == 1:
        idx = np.frombuffer(_take(data, offsets[0], lengths[0], what), np.uint8)
        return _image(pal[idx, :ch].reshape(-1), w, h, ch, what)
    if encoding != 2:
        raise ValueError(f"{what}: BLP2 encoding {encoding} (PIL reads 1 and 2)")
    kind = {0: 0, 1: 1, 7: 2}.get(alpha_encoding)
    if kind is None:
        raise ValueError(f"{what}: BLP2 DXT alpha encoding {alpha_encoding} (PIL reads 0, 1 "
                         "and 7)")
    bx, by = -(-w // 4), -(-h // 4)
    size = bx * (8 if kind == 0 else 16)
    rows = np.frombuffer(_take(data, offsets[0], size * by, what), np.uint8).reshape(by, size)
    return _image(_dxt_stream(rows, bx, kind, alpha), w, h, ch, what)


def _blp1_jpeg(data, pos, offset, length, w, h, what):
    """BLP1's JPEG content -> [h, w, 3]: PIL's RGB bytes of the stream,
    read as BGR rows of the BLP's width."""
    from .jpeg import components_to_rgb, decode_components

    (size,) = struct.unpack("<I", _take(data, pos, 4, what))
    header = _take(data, pos + 4, size, what)
    pos += 4 + size
    pos += max(0, offset - pos)  # a mip offset behind the header is not sought
    if pos > len(data):
        raise ValueError(f"{what}: BLP1 mip offset {offset} past the end of the file")
    comps, space, _ = decode_components(header + _take(data, pos, length, what),
                                        f"{what}: BLP1 JPEG")
    # PIL tells libjpeg a four-component stream is CMYK: YCCK is not converted
    rgb = components_to_rgb(comps, "CMYK" if space == "YCCK" else space)
    stream_px = rgb.reshape(-1)
    need = w * h * 3
    if stream_px.size < need:
        raise ValueError(f"{what}: BLP1 JPEG of {rgb.shape[1]} x {rgb.shape[0]} holds fewer "
                         f"pixels than the image's {w} x {h} (not enough image data)")
    return np.ascontiguousarray(stream_px[:need].reshape(h, w, 3)[..., ::-1])
