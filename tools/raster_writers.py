"""Writers, with numpy only (no PIL), for the image formats of
``akari_torch/core/im.py``, ``iptc.py``, ``pcd.py``, ``spider.py`` and the
DCX / MSP / XBM decoders: the forms Pillow cannot write (IM Tools, IPTC/NAA,
PhotoCD, DCX, version-2 MSP, SPIDER stacks, IM's every image type) and the
2048^2 IM and DCX albedos ``chip_smoke.py`` writes on a machine without
PIL. The tests read every file back through PIL and hold the port to it.
"""

from __future__ import annotations

import struct

import numpy as np

# ------------------------------------------------------------------ IM


def im_bytes(body, image_type, size, lut=None, lines=(), crlf=True, pad=True):
    """An IM file: ``Image type: <image_type>`` and ``Image size (x*y):
    W*H`` lines, then ``lines`` (more ``key: value`` lines), ``Lut: 1``
    when ``lut`` (768 bytes) is given; the header padded with zero bytes to
    511 bytes as PIL's writer pads it (``pad``), then ``\\x1a``, the table and
    ``body``, the raw pixel bytes (rows bottom up, see ``im_rows``)."""
    eol = b"\r\n" if crlf else b"\n"
    head = b"Image type: " + image_type.encode("latin-1") + eol
    head += b"Image size (x*y): %d*%d" % tuple(size) + eol
    for line in lines:
        head += line + eol
    if lut is not None:
        head += b"Lut: 1" + eol
    if pad:
        head += b"\0" * max(0, 511 - len(head))
    return head + b"\x1a" + (b"" if lut is None else bytes(lut)) + bytes(body)


def im_rows(planes, bits=8):
    """[k, H, W] planes (uint8, or uint16 / int32 / float32 of a byte
    order the caller picked) -> IM raw bytes: rows bottom up, each row the
    k planes' rows one after the other (PIL's ``;L`` raw modes; k = 1 for
    packed data); ``bits`` 1, 2 or 4 packs uint8 values MSB first."""
    planes = np.asarray(planes)
    if bits < 8:
        k, h, w = planes.shape
        fields = (planes[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        planes = np.packbits(fields.reshape(k, h, w * bits).astype(np.uint8), axis=2)
    return np.ascontiguousarray(planes[:, ::-1].transpose(1, 0, 2)).tobytes()


def im_bit_rows(values, bits):
    """[H, W] unsigned values -> PIL's ``bit`` decoder's bytes for ``F;bits``
    (rows bottom up, each from a fresh byte, fields least significant bit
    first; the bits a row leaves spare are zero)."""
    v = np.asarray(values, np.uint64)[::-1]
    h, w = v.shape
    fields = ((v[..., None] >> np.arange(bits, dtype=np.uint64)) & 1).astype(np.uint8)
    return np.packbits(fields.reshape(h, w * bits), axis=1, bitorder="little").tobytes()


def im_rgb(px):
    """[H, W, 3] uint8 -> an ``RGB image`` IM file (planar rows, raw mode
    ``RGB;L``), as PIL writes RGB: the 2048^2 albedo of ``chip_smoke.py``."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    return im_bytes(im_rows(np.moveaxis(px, -1, 0)), "RGB image", (w, h),
                    lines=(b"File size (no of images): 1",))


# ------------------------------------------------------------------ IM Tools


def imt_bytes(grey, lines=None, comment=True):
    """[H, W] uint8 -> an IM Tools file: ``width``, ``height`` and ``pixel
    n8`` lines (``lines`` replaces them), a ``*`` comment, ``\\x0c`` and the
    rows."""
    grey = np.asarray(grey, np.uint8)
    h, w = grey.shape
    if lines is None:
        lines = [b"width %d" % w, b"height %d" % h, b"pixel n8"]
    head = (b"* written by raster_writers\n" if comment else b"") + b"\n".join(lines) + b"\n"
    return head + b"\x0c" + grey.tobytes()


# ------------------------------------------------------------------ IPTC/NAA


def iptc_field(record, dataset, data, extended=None):
    """One IPTC field: ``0x1C``, record, dataset, the length: 15 bits, or
    (``extended`` k, 1-4) as PIL reads an extended length: ``128 + k`` in the
    length's first byte, its second byte unused, then k bytes of length."""
    n = len(data)
    if extended is None and n < 0x8000:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", n) + data
    k = extended or 4
    return bytes([0x1C, record, dataset, 0x80 | k, 0]) + n.to_bytes(k, "big") + data


def iptc_bytes(layers, component, size, compression, blob, band=None, chunk=8000,
               extra=(), tail=b""):
    """An IPTC/NAA image: the ``(3, 60)`` layers / component, ``(3, 20)``
    and ``(3, 30)`` width and height, ``(3, 120)`` compression (1 raw, 5
    JPEG), the ``(3, 65)`` band when given, ``extra`` fields, then ``blob``
    in ``(8, 10)`` fields of ``chunk`` bytes, then ``tail``."""
    w, h = size
    out = iptc_field(3, 60, bytes([layers, component]))
    out += iptc_field(3, 20, struct.pack(">H", w)) + iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 120, bytes([compression]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    for f in extra:
        out += f
    for i in range(0, max(len(blob), 1), chunk):
        out += iptc_field(8, 10, blob[i:i + chunk])
    return out + tail


# ------------------------------------------------------------------ PhotoCD


def pcd_bytes(y, c1, c2, orientation=0):
    """[512, 768] luma and [256, 384] chroma planes -> a PhotoCD file PIL
    reads: ``PCD_`` at byte 2048, the orientation at 2048 + 1538, the base
    image at 96 x 2048 bytes in chunks of two luma rows and one row of each
    chroma."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    y = np.asarray(y, np.uint8).reshape(256, 2 * 768)
    chunks = np.concatenate([y, np.asarray(c1, np.uint8), np.asarray(c2, np.uint8)], axis=1)
    return bytes(head) + chunks.tobytes()


# ------------------------------------------------------------------ SPIDER


def spider_header(w, h, order=">", istack=0, maxim=0, imgnum=0, labels=None):
    """A SPIDER header for a w x h image (``iform`` 1): whole 4w-byte
    records holding at least 256 bytes; ``labels`` {1-based index: value}
    overrides labels."""
    lenbyt = 4 * w
    labrec = -(-256 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float64)
    lab = {1: 1, 2: h, 3: h, 5: 1, 12: w, 13: labrec, 22: labbyt, 23: lenbyt, 24: istack,
           26: maxim, 27: imgnum}
    lab.update(labels or {})
    for i, v in lab.items():
        hdr[i - 1] = v
    return hdr.astype(order + "f4").tobytes()


def spider_bytes(values, order=">", stack=0, labels=None):
    """[H, W] float32 -> a SPIDER image, or (``stack`` n > 0) a stack of n
    images: the stack header, then each image's header and data (the
    first image ``values``, the others its negation and its double)."""
    v = np.asarray(values, np.float32)
    h, w = v.shape
    data = v.astype(order + "f4").tobytes()
    if not stack:
        return spider_header(w, h, order, labels=labels) + data
    out = spider_header(w, h, order, istack=2, maxim=stack, labels=labels)
    for k in range(stack):
        img = [v, -v, 2 * v][k % 3].astype(order + "f4").tobytes()
        out += spider_header(w, h, order, imgnum=k + 1) + img
    return out


# ------------------------------------------------------------------ DCX


def dcx_bytes(pages, offsets=None):
    """PCX files -> a DCX: the magic number, the page offsets (``offsets``
    replaces them) ended by a zero, the pages."""
    table = 4 + 4 * (len(pages) + 1)
    if offsets is None:
        offsets, pos = [], table
        for p in pages:
            offsets.append(pos)
            pos += len(p)
    head = struct.pack("<I", 0x3ADE68B1) + b"".join(struct.pack("<I", o) for o in offsets)
    return head + b"\0\0\0\0" + b"".join(pages)


# ------------------------------------------------------------------ MSP


def msp_header(version, w, h, checksum=True):
    """The 32-byte MSP header: the magic (``DanM`` version 1, ``LinS``
    version 2), the size, aspect and printer words, and a checksum word that
    makes the 16 words XOR to 0 (``checksum``)."""
    words = [0] * 16
    words[0], words[1] = struct.unpack("<2H", b"DanM" if version == 1 else b"LinS")
    words[2:8] = [w, h, 1, 1, 1, 1]
    x = 0
    for v in words:
        x ^= v
    words[12] = x if checksum else x ^ 1
    return struct.pack("<16H", *words)


def msp_runs(row, r=None):
    """One row of packed bytes -> MSP version-2 data: runs of 3 or more
    equal bytes as (0, count, byte), the rest as literals (count, bytes);
    counts up to 255, shorter when ``r`` draws them."""
    row = bytes(row)
    out, i, lit = bytearray(), 0, bytearray()
    most = 255 if r is None else int(r.integers(1, 256))

    def flush():
        for k in range(0, len(lit), most):
            part = lit[k:k + most]
            out.append(len(part))
            out.extend(part)
        lit.clear()

    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < most:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([0, j - i, row[i]])
        else:
            lit.extend(row[i:j])
        i = j
    flush()
    return bytes(out)


def msp_bytes(bits, version=2, rows=None, r=None, checksum=True):
    """[H, W] 0/1 (1 white) -> an MSP file: version 1 raw rows, or version
    2 a row map and ``msp_runs`` rows (``rows`` replaces the encoded rows:
    a list of bytes, an empty one meaning a white row)."""
    bits = np.asarray(bits, np.uint8)
    h, w = bits.shape
    packed = np.packbits(bits, axis=1)
    head = msp_header(version, w, h, checksum)
    if version == 1:
        return head + packed.tobytes()
    if rows is None:
        rows = [msp_runs(p, r) for p in packed]
    return head + struct.pack(f"<{h}H", *(len(x) for x in rows)) + b"".join(rows)


# ------------------------------------------------------------------ XBM


def xbm_bytes(bits, name="img", hotspot=None, per_line=12, upper=False, sep=b", "):
    """[H, W] 0/1 (1 white) -> an X11 bitmap: the ``#define`` lines, the
    optional hotspot, ``static char <name>_bits[] = {`` and the bytes as
    ``0x..`` values, bits least significant first."""
    bits = np.asarray(bits, np.uint8)
    h, w = bits.shape
    vals = np.packbits(bits, axis=1, bitorder="little").ravel()
    out = b"#define %s_width %d\n#define %s_height %d\n" % (name.encode(), w, name.encode(), h)
    if hotspot is not None:
        out += b"#define %s_x_hot %d\n#define %s_y_hot %d\n" % (
            name.encode(), hotspot[0], name.encode(), hotspot[1])
    out += b"static char %s_bits[] = {\n" % name.encode()
    fmt = "0x%02X" if upper else "0x%02x"
    items = [(fmt % v).encode() for v in vals.tolist()]
    lines = [sep.join(items[i:i + per_line]) for i in range(0, len(items), per_line)]
    return out + (sep.strip() + b"\n").join(lines) + b"\n};\n"
