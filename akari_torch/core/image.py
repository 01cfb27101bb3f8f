"""Image read/write without PIL (``akari_tpu/core/image.py``).

Writers: ``write_png`` encodes an 8-bit sRGB PNG with the standard library
only (``zlib`` + ``struct``): one IHDR, one IDAT whose scanlines take the
filter the PNG specification's heuristic picks, one IEND. ``write_hdr`` writes a Radiance ``.hdr`` (RGBE,
flat scanlines) and ``write_hdr_npy`` keeps the linear float image.

Readers (``read_image``): ``.npy`` (linear float), ``.hdr`` (RGBE, flat
or new-RLE scanlines, the reference's codec) and PNG through the decoder
below. The reference reads PNG and JPEG with PIL, which the card's
machine does not have; the port decodes 8-bit, non-interlaced PNGs of
colour type 0 (grey), 2 (RGB) and 6 (RGBA, alpha dropped) with all five
scanline filters, and refuses any other PNG form and JPEG with an error
naming the format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .spectrum import srgb_to_linear, to_uint8_srgb

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def _filter_rows(px, bpp):
    """[h, stride] uint8 -> [h, 1 + stride] filtered scanlines. Each row
    takes the filter whose output has the least sum of absolute values as
    signed bytes (the PNG specification's suggested heuristic, which zlib
    based encoders such as libpng use), so rows mix all five types."""
    x = px.astype(np.int16)
    zero_col = np.zeros((x.shape[0], bpp), np.int16)
    left = np.concatenate([zero_col, x[:, :-bpp]], axis=1)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]], axis=0)
    up_left = np.concatenate([zero_col, up[:, :-bpp]], axis=1)
    cand = np.stack([
        x, x - left, x - up, x - ((left + up) >> 1), x - _paeth(left, up, up_left),
    ]).astype(np.uint8)  # [5, h, stride], mod 256
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)  # [5, h]
    kind = cost.argmin(axis=0)
    rows = np.take_along_axis(cand, kind[None, :, None], axis=0)[0]
    return np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(rgb8):
    """[H, W, 3] uint8 -> PNG file bytes (filters chosen per scanline)."""
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got shape {rgb8.shape}")
    raw = _filter_rows(rgb8.reshape(h, w * 3), 3).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (
        PNG_SIGNATURE
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


# --------------------------------------------------------------------------
# PNG decoding

_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, h, stride, bpp):
    """Undo the per-scanline filters of a non-interlaced 8-bit image:
    ``raw`` is the inflated IDAT stream of ``h`` rows of ``1 + stride``
    bytes; returns [h, stride] uint8.

    Pixel (y, x) depends on its left, upper and upper-left neighbours only,
    so every pixel of an anti-diagonal y + x = d is decoded at once: h + w
    - 1 vectorised steps, whatever filters the rows use."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kind = rows[:, 0].astype(np.int64)
    bad = np.flatnonzero(kind > 4)
    if bad.size:
        raise ValueError(f"PNG filter type {kind[bad[0]]} on row {bad[0]}")
    w = stride // bpp
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    # skewed: filt[d, y] is the filtered pixel (y, d - y)
    filt = np.zeros((h + w - 1, h, bpp), np.int16)
    filt[ys + xs, ys] = rows[:, 1:].reshape(h, w, bpp)
    # out[d + 2, y + 1] is the decoded pixel (y, d - y); the padding row
    # and columns, and the slots off the image, read as zero neighbours
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    zero = np.zeros((h, bpp), np.int16)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[d + 1, y0 + 1:y1 + 1]   # left: (y, x - 1)
        b = out[d + 1, y0:y1]           # up: (y - 1, x)
        c = out[d, y0:y1]               # up-left: (y - 1, x - 1)
        pred = np.stack([zero[:y1 - y0], a, b, (a + b) >> 1, _paeth(a, b, c)])
        pred = np.take_along_axis(pred, kind[None, y0:y1, None], axis=0)[0]
        out[d + 2, y0 + 1:y1 + 1] = (filt[d, y0:y1] + pred) & 0xFF
    return out[ys + xs + 2, ys + 1].reshape(h, stride).astype(np.uint8)


def decode_png(data, what="PNG"):
    """PNG file bytes -> [H, W, 3] uint8 RGB (grey replicated, alpha
    dropped, as PIL's ``convert("RGB")`` does)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{what}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{what}: PNG of bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} is not supported (8-bit, colour type 0, 2 or 6, "
            "non-interlaced only)"
        )
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


# --------------------------------------------------------------------------
# Radiance .hdr (RGBE): flat and new-RLE scanlines


def _rgbe_to_float(rgbe):
    """[..., 4] uint8 RGBE -> [..., 3] float32 linear."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)), 0.0)
    return (rgbe[..., :3] + 0.5) * scale[..., None] * (e > 0.0)[..., None]


def _float_to_rgbe(img):
    """[..., 3] float32 -> [..., 4] uint8 RGBE (max-component exponent)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = img.max(axis=-1)
    mant, expo = np.frexp(maxc)
    # v * 256/2^e for each channel, rounded down (Radiance convention)
    scale = np.where(maxc > 1e-32, np.ldexp(256.0, -expo), 0.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, expo + 128, 0).astype(np.uint8)
    return rgbe


def _read_hdr(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance .hdr file")
    # header: lines until the blank line; then the resolution line
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    out = np.empty((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        is_rle = (
            8 <= w <= 0x7FFF
            and buf[p] == 2 and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w
        )
        if not is_rle:
            # flat scanline: w RGBE pixels verbatim
            out[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for c in range(4):  # each component RLE'd separately
            x = 0
            while x < w:
                count = int(buf[p])
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[p + 1]
                    x += count - 128
                    p += 2
                else:  # literal
                    out[y, x:x + count, c] = buf[p + 1:p + 1 + count]
                    x += count
                    p += 1 + count
            if x != w:
                raise ValueError(f"{path}: RLE overrun at row {y}")
    return _rgbe_to_float(out)


def write_hdr(path, img_linear):
    """[H,W,3] linear float -> Radiance .hdr (flat scanlines, no RLE)."""
    img = np.asarray(img_linear, np.float32)
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img.reshape(h, w, 3))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_image(path, to_linear=True):
    """Read a PNG (sRGB -> linear float), .hdr (RGBE) or .npy (linear).

    Returns [H, W, 3] float32. JPEG and PNG forms the decoder does not
    handle raise ``ValueError`` naming the format.
    """
    path = str(path)
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]
    if path.endswith(".hdr"):
        return _read_hdr(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == JPEG_SIGNATURE:
        raise ValueError(
            f"{path}: JPEG images are not supported (the port decodes PNG, "
            ".hdr and .npy)"
        )
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: unsupported image format (PNG, .hdr or .npy)")
    raw = decode_png(data, path).astype(np.float32) / 255.0
    return srgb_to_linear(raw).astype(np.float32) if to_linear else raw
