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


# ------------------------------------------------------------------ SUN


def sun_rows(px, depth, file_type=1, pad=True):
    """[H, W] values (depth 1, 4, 8) or [H, W, 3] RGB (24, 32) -> the rows
    of a Sun raster: bits and nibbles most significant first, 24 and 32
    bits in RGB / RGBX order for file type 3 and BGR / BGRX otherwise (X
    zero), each row padded to 16 bits (``pad``)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    if depth == 1:
        rows = np.packbits(px & 1, axis=1)
    elif depth == 4:
        nib = np.zeros((h, w + (w & 1)), np.uint8)
        nib[:, :w] = px & 15
        rows = (nib[:, 0::2] << 4) | nib[:, 1::2]
    elif depth == 8:
        rows = px
    else:
        order = [0, 1, 2] if file_type == 3 else [2, 1, 0]
        chans = [px[..., k] for k in order]
        if depth == 32:
            chans.append(np.zeros((h, w), np.uint8))
        rows = np.stack(chans, axis=-1).reshape(h, -1)
    if pad and rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], axis=1)
    return rows


def sun_rle(data, most=256):
    """Bytes -> Sun's run-length code, with numpy only: runs of three or
    more equal bytes (and any run of 0x80) as ``0x80, n - 1, byte`` (n up to
    ``most`` <= 256), a single 0x80 as ``0x80, 0``, other bytes as
    themselves. Runs cross rows as the stream does."""
    d = np.frombuffer(bytes(data), np.uint8)
    if not len(d):
        return b""
    starts = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
    lens = np.diff(np.append(starts, len(d)))
    pieces = -(-lens // most)
    run = np.repeat(np.arange(len(starts)), pieces)
    k = np.arange(len(run)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    plen = np.minimum(most, lens[run] - k * most)
    val = d[starts[run]]
    esc = (plen >= 3) | ((val == 0x80) & (plen == 2))
    lit80 = (val == 0x80) & (plen == 1)
    size = np.where(esc, 3, np.where(lit80, 2, plen))
    off = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    e = np.flatnonzero(esc)
    out[off[e]], out[off[e] + 1], out[off[e] + 2] = 0x80, plen[e] - 1, val[e]
    out[off[lit80]] = 0x80
    lit = np.flatnonzero(~esc & ~lit80)
    out[off[lit]] = val[lit]
    two = lit[plen[lit] == 2]
    out[off[two] + 1] = val[two]
    return out.tobytes()


def sun_bytes(px, depth, file_type=1, palette=None, body=None, most=256):
    """A Sun raster file: the 32-byte header (magic, width, height,
    depth, data length, file type, palette type 1 under a palette, palette
    length), the palette (``palette`` [n, 3] written as PIL's ``RGB;L``: the
    n reds, then greens, then blues; or raw bytes) and ``sun_rows`` of
    ``px``, run-length coded by ``sun_rle`` (runs of up to ``most``) for
    file type 2 (rows unpadded there, as PIL reads them); ``body`` replaces
    the data."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    if body is None:
        rows = sun_rows(px, depth, file_type, pad=file_type != 2)
        body = rows.tobytes() if file_type != 2 else sun_rle(rows.tobytes(), most)
    pal = b""
    if palette is not None:
        pal = palette if isinstance(palette, bytes) else \
            np.asarray(palette, np.uint8).T.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type, 1 if pal else 0,
                       len(pal))
    return head + pal + bytes(body)


# ------------------------------------------------------------------ FLI / FLC


def fli_chunk(kind, payload):
    """One subchunk of a frame: its size (6 + payload), type, payload."""
    return struct.pack("<IH", 6 + len(payload), kind) + bytes(payload)


def fli_frame(chunks):
    """A frame chunk: size, type (0xF1FA), the subchunk count, 8 reserved
    bytes, then ``chunks`` (subchunk bytes)."""
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body


def fli_bytes(w, h, frames, magic=0xAF12, n_frames=None, flags=3, prefix=None):
    """An FLI (``magic`` 0xAF11) or FLC (0xAF12) file: the 128-byte header
    (its reserved ranges zero, as PIL checks them), an optional prefix
    chunk (``prefix`` payload, type 0xF100) and the ``frames`` (frame chunk
    bytes)."""
    body = b"".join(frames)
    if prefix is not None:
        body = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix + body
    n = len(frames) if n_frames is None else n_frames
    head = struct.pack("<IHHHHHHI", 128 + len(body), magic, n, w, h, 8, flags, 5)
    return head + bytes(128 - len(head)) + body


def fli_colour(entries, kind=4):
    """A colour chunk payload (type 4: 8-bit components, 11: 6-bit):
    ``entries`` [(skip, [[r, g, b], ...]), ...] packets; 256 colours are
    written with a count of 0."""
    out = struct.pack("<H", len(entries))
    for skip, cols in entries:
        cols = np.asarray(cols, np.uint8).reshape(-1, 3)
        out += bytes([skip, len(cols) & 255]) + cols.tobytes()
    return out


def fli_brun(idx, most=127):
    """[H, W] indices -> a BRUN chunk payload, with numpy only: per line a
    packet-count byte, then the line cut into pieces of ``most`` (<= 127)
    pixels, each a run (count, byte) where its pixels are equal, else a
    literal (-count, bytes)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    seg = np.minimum(most, w - np.arange(0, w, most))
    n = len(seg)
    blocks = np.zeros((h, n * most), np.uint8)
    blocks[:, :w] = idx
    blocks = blocks.reshape(h, n, most)
    valid = np.arange(most)[None, :] < seg[:, None]
    run = ((blocks == blocks[:, :, :1]) | ~valid).all(axis=2)
    size = np.where(run, 2, seg[None, :] + 1)
    row_start = np.cumsum(1 + size.sum(axis=1)) - (1 + size.sum(axis=1))
    off = row_start[:, None] + 1 + np.cumsum(size, axis=1) - size
    out = np.zeros(int(row_start[-1] + 1 + size[-1].sum()), np.uint8)
    out[row_start] = n & 255
    out[off] = np.where(run, seg[None, :], 256 - seg[None, :])
    out[off[run] + 1] = blocks[run][:, 0]
    y, s, j = np.nonzero(~run[:, :, None] & valid[None])
    out[off[y, s] + 1 + j] = blocks[y, s, j]
    return out.tobytes()


def fli_lc(new, old, r=None):
    """[H, W] indices over the previous frame ``old`` -> an LC (byte delta)
    payload: the first changed line, the line count, then per line a packet
    count and packets (skip, count, bytes) / (skip, -count, byte)."""
    new, old = np.asarray(new, np.uint8), np.asarray(old, np.uint8)
    changed = np.flatnonzero((new != old).any(axis=1))
    if not len(changed):
        return struct.pack("<HH", 0, 0)
    y0, y1 = int(changed[0]), int(changed[-1]) + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        row, prev, w = new[y], old[y], new.shape[1]
        packets, x, line = 0, 0, bytearray()
        while x < w:
            skip = 0
            while x < w and row[x] == prev[x] and skip < 255:
                x, skip = x + 1, skip + 1
            if x >= w:
                break
            most = 127 if r is None else int(r.integers(1, 128))
            j = x
            while j < w and row[j] == row[x] and j - x < most:
                j += 1
            if j - x >= 3:
                line += bytes([skip, 256 - (j - x), row[x]])
            else:
                j = min(w, x + most)
                line += bytes([skip, j - x]) + row[x:j].tobytes()
            packets += 1
            x = j
        out += bytes([packets]) + line
    return bytes(out)


def fli_ss2(new, old, r=None):
    """[H, W] indices (W even) over ``old`` -> an SS2 (word delta) payload:
    the line count, then per coded line its packet count word (after a
    line-skip word when lines are skipped), packets (skip, count, words) /
    (skip, -count, word)."""
    new, old = np.asarray(new, np.uint8), np.asarray(old, np.uint8)
    h, w = new.shape
    out, lines, skip_lines = bytearray(), 0, 0
    for y in range(h):
        if (new[y] == old[y]).all():
            skip_lines += 1
            continue
        if skip_lines:
            out += struct.pack("<H", 65536 - skip_lines)
            skip_lines = 0
        words = new[y].reshape(-1, 2)
        same = (new[y] == old[y]).reshape(-1, 2).all(axis=1)
        packets, x, line = 0, 0, bytearray()
        while x < len(words):
            skip = 0
            while x < len(words) and same[x] and skip < 127:
                x, skip = x + 1, skip + 1
            if x >= len(words):
                break
            most = 127 if r is None else int(r.integers(1, 128))
            j = x
            while j < len(words) and (words[j] == words[x]).all() and j - x < most:
                j += 1
            if j - x >= 2:
                line += bytes([2 * skip, 256 - (j - x)]) + words[x].tobytes()
            else:
                j = min(len(words), x + most)
                line += bytes([2 * skip, j - x]) + words[x:j].tobytes()
            packets += 1
            x = j
        out += struct.pack("<H", packets) + line
        lines += 1
    return struct.pack("<H", lines) + bytes(out)


# ------------------------------------------------------------------ FITS


def fits_card(key, value=None, comment=None):
    """One 80-byte header card: the keyword in 8 columns, ``= value``."""
    card = f"{key:<8}"
    if value is not None:
        card += "= " + (f"{value:>20}" if not str(value).startswith("'") else str(value))
    if comment:
        card += " / " + comment
    return card.ljust(80)[:80].encode("ascii")


def fits_unit(cards):
    """Cards -> a header unit: ``END`` and spaces to a multiple of 2880."""
    head = b"".join(cards) + fits_card("END")
    return head + b" " * (-len(head) % 2880)


def fits_bytes(values, bitpix, naxis=2, cards=()):
    """[H, W] values -> a FITS file: SIMPLE, BITPIX, NAXIS, NAXIS1 (width)
    and NAXIS2 (height) (NAXIS 1: the H values of a column), ``cards``,
    then the big-endian data (rows as given: FITS stores the bottom row
    first), zero-padded to 2880 bytes."""
    v = np.asarray(values)
    h, w = v.shape
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    axes = [("NAXIS1", w), ("NAXIS2", h)] if naxis == 2 else [("NAXIS1", h)]
    head = [fits_card("SIMPLE", "T"), fits_card("BITPIX", bitpix), fits_card("NAXIS", naxis)]
    head += [fits_card(k, n) for k, n in axes] + list(cards)
    body = v.astype(dtype).tobytes()
    return fits_unit(head) + body + bytes(-len(body) % 2880)


def fits_gzip_bytes(values, zbitpix, pad=True):
    """[H, W] values -> a FITS file PIL reads through its ``GZIP_1``
    route: an empty primary unit (NAXIS 0) and a BINTABLE extension with
    ZIMAGE = T, ZCMPTYPE = 'GZIP_1  ', ZBITPIX, ZNAXIS1 / ZNAXIS2, and a
    gzip stream of one big-endian 4-byte word a pixel, rows as given (PIL
    reverses them), zero-padded to 2880 bytes (``pad``; PIL needs no
    padding)."""
    import gzip

    v = np.asarray(values)
    h, w = v.shape
    z = gzip.compress(v.astype(">i4").tobytes(), 6, mtime=0)
    prim = fits_unit([fits_card("SIMPLE", "T"), fits_card("BITPIX", 8), fits_card("NAXIS", 0)])
    ext = fits_unit([fits_card("XTENSION", "'BINTABLE'"), fits_card("BITPIX", 8),
                     fits_card("NAXIS", 2), fits_card("NAXIS1", 8), fits_card("NAXIS2", 0),
                     fits_card("ZIMAGE", "T"), fits_card("ZCMPTYPE", "'GZIP_1  '"),
                     fits_card("ZBITPIX", zbitpix), fits_card("ZNAXIS", 2),
                     fits_card("ZNAXIS1", w), fits_card("ZNAXIS2", h)])
    return prim + ext + z + bytes(-len(z) % 2880 if pad else 0)


# ------------------------------------------------------------------ GBR, McIdas, PIXAR, XV


def gbr_bytes(px, version=2, comment=b"brush", spacing=10, header_size=None):
    """[H, W] grey or [H, W, 4] RGBA -> a GIMP brush: header size, version,
    width, height, depth (1 or 4), for version 2 ``GIMP`` and the spacing,
    the comment and its NUL, then the pixels."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else px.shape[2]
    name = bytes(comment) + b"\0"
    fixed = 20 if version == 1 else 28
    size = fixed + len(name) if header_size is None else header_size
    head = struct.pack(">5I", size, version, w, h, depth)
    if version != 1:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + name + px.tobytes()


def mcidas_bytes(values, nbytes, prefix=b"", bands=1, offset=256, words=None):
    """[H, W] values -> a McIdas area: the 256-byte directory of 64
    big-endian words (w[2] = 4, lines w[9], elements w[10], bytes per
    element w[11], bands w[14], line prefix length w[15], data offset
    w[34]; ``words`` {1-based index: value} overrides them), then each line
    as its prefix, its big-endian samples and ``bands`` - 1 more bands
    (the samples reversed)."""
    v = np.asarray(values)
    h, w = v.shape
    d = [0] * 65
    d[2], d[9], d[10], d[11], d[14], d[15], d[34] = 4, h, w, nbytes, bands, len(prefix), offset
    for k, val in (words or {}).items():
        d[k] = val
    head = struct.pack(">64i", *d[1:])
    rows = v.astype({1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]).view(np.uint8).reshape(h, -1)
    parts = [np.tile(np.frombuffer(bytes(prefix), np.uint8), (h, 1)), rows]
    parts += [rows[::-1]] * (bands - 1)
    return head + bytes(max(0, offset - 256)) + np.concatenate(parts, axis=1).tobytes()


def pixar_bytes(px, mode=(14, 2), fill=0):
    """[H, W, 3] RGB -> a PIXAR raster: the magic, the 16-bit width at
    418 and height at 416, the channel / depth pair at 424, the header
    filled to 1024 bytes with ``fill``, then the RGB pixels."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    head = bytearray([fill]) * 1024
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + px.tobytes()


def xvthumb_bytes(idx, comments=(b"#XVVERSION:Version 2.28",), first=b" \n", size=None):
    """[H, W] RGB332 indices -> an XV thumbnail: ``P7 332``, the rest of
    the first line, ``#`` comment lines, ``#END_OF_COMMENTS``, the size line
    (``size`` replaces it) and the bytes."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    head = b"P7 332" + first + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
    head += (b"%d %d 255\n" % (w, h)) if size is None else size
    return head + idx.tobytes()


def rgb332(px):
    """[H, W, 3] RGB -> the nearest-below RGB332 index of each pixel."""
    px = np.asarray(px, np.uint16)
    return ((px[..., 0] * 8 // 256) << 5 | (px[..., 1] * 8 // 256) << 2
            | px[..., 2] * 4 // 256).astype(np.uint8)


# ------------------------------------------------------------------ XPM


def xpm_keys(n, bpp):
    """n distinct keys of ``bpp`` printable characters (no quote or
    backslash)."""
    alphabet = bytes(range(35, 127)).replace(b"\\", b"")
    keys = []
    for i in range(n):
        k, v = b"", i
        for _ in range(bpp):
            k = alphabet[v % len(alphabet):v % len(alphabet) + 1] + k
            v //= len(alphabet)
        keys.append(k)
    return keys


def xpm_bytes(idx, colours, bpp=None, keys=None, pixels_comment=True, colour_lines=None,
              rows=None):
    """[H, W] indices into ``colours`` ([n, 3] RGB, or strings such as
    ``None``) -> an XPM file: ``/* XPM */``, the C array, the values line,
    one ``"<key> c #rrggbb",`` line a colour (``colour_lines`` replaces
    them), an optional ``/* pixels */`` line and one quoted row a line
    (``rows`` replaces them)."""
    idx = np.asarray(idx)
    h, w = idx.shape
    n = len(colours)
    bpp = bpp or max(1, int(np.ceil(np.log(max(n, 2)) / np.log(90))))
    keys = keys or xpm_keys(n, bpp)
    out = b"/* XPM */\nstatic char *img[] = {\n"
    out += b'"%d %d %d %d",\n' % (w, h, n, bpp)
    if colour_lines is None:
        colour_lines = []
        for k, c in zip(keys, colours):
            spec = c if isinstance(c, bytes) else b"#%02x%02x%02x" % tuple(int(x) for x in c)
            colour_lines.append(b'"' + k + b" c " + spec + b'",')
    out += b"\n".join(colour_lines) + b"\n"
    if pixels_comment:
        out += b"/* pixels */\n"
    if rows is None:
        table = np.array(keys, dtype=f"S{bpp}")
        rows = [b'"' + table[r].tobytes() + b'",' for r in idx]
    out += b"\n".join(rows) + b"\n};\n"
    return out
