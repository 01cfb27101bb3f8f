"""Writers of QOI, SGI and PCX files, and a reader of the block modes of a
Zstandard frame, for the PyTorch port's decoder tests and ``chip_smoke.py``.

Pillow writes QOI, SGI (raw only), PCX and ICO; these writers need no PIL, so
the smoke can write the 2048^2 config-3 albedo in each form on a machine
without it, and they write what Pillow cannot:

- ``qoi_bytes``: every op of the QOI specification (RUN, INDEX, DIFF, LUMA,
  RGB, RGBA), the op a pixel takes drawn from ``r`` among those that fit;
  with ``index=False`` the ops need only the previous pixel (no INDEX), and
  the encoder is vectorised for large images;
- ``sgi_bytes``: raw or RLE (runs of 3 or more equal samples, copies of
  the samples between them, up to 127 a packet), 1 or 2 bytes a sample, L /
  RGB / RGBA;
- ``pcx_bytes``: 1-bit with 1, 2 or 4 planes, 8-bit grey or palette, 24-bit
  in three planes, RLE over each line (runs of up to 63, a byte of 0xC0 or
  more as a run of one), the header's bytes per line chosen freely;
- ``icon_bytes`` / ``dib_entry``: ICO and CUR files of any entry set,
  PNG or DIB entries at 1, 4, 8, 24 and 32 bits with their AND masks;
- ``zstd_modes``: the block types, literals modes and sequence table modes
  of the first frame of a Zstandard stream, to check which a file holds.

The LZMA TIFF writer is ``tiff_bytes(..., compression=34925)`` of
``tools/make_torch_port_image_fixtures.py`` (Python's ``lzma``).
"""

from __future__ import annotations

import struct

import numpy as np


# ------------------------------------------------------------------- QOI

def _qoi_fast(px):
    """[n, 3] pixels -> op bytes with RUN, DIFF, LUMA and RGB only."""
    prev = np.concatenate([np.zeros((1, 3), np.uint8), px[:-1]])
    same = (px == prev).all(axis=1)
    d = (px.astype(np.int16) - prev).astype(np.int8).astype(np.int16)  # wrapped differences
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    diff = (d >= -2).all(axis=1) & (d <= 1).all(axis=1)
    luma = ~diff & (dg >= -32) & (dg <= 31) & (abs(dr - dg + 0.5) <= 8) & (abs(db - dg + 0.5) <= 8)
    # runs: maximal stretches of `same`, cut into chunks of 62
    edge = np.flatnonzero(np.diff(np.concatenate([[0], same.astype(np.int8), [0]])))
    starts, ends = edge[0::2], edge[1::2]
    lens = ends - starts
    chunks = -(-lens // 62)
    c_start = np.repeat(starts, chunks) + 62 * (np.arange(chunks.sum()) - np.repeat(
        np.cumsum(chunks) - chunks, chunks))
    c_len = np.minimum(np.repeat(ends, chunks) - c_start, 62)
    pos = np.flatnonzero(~same)
    size = np.where(diff[pos], 1, np.where(luma[pos], 2, 4))
    ev_pos = np.concatenate([pos, c_start])
    ev_size = np.concatenate([size, np.ones(len(c_start), np.int64)])
    order = np.argsort(ev_pos, kind="stable")
    off = np.zeros(len(order) + 1, np.int64)
    off[1:] = np.cumsum(ev_size[order])
    out = np.zeros(off[-1], np.uint8)
    at = np.empty(len(order), np.int64)
    at[order] = off[:-1]
    p_at = at[:len(pos)]
    k = diff[pos]
    out[p_at[k]] = (0x40 | (dr[pos][k] + 2) << 4 | (dg[pos][k] + 2) << 2 | (db[pos][k] + 2))
    k = luma[pos]
    out[p_at[k]] = 0x80 | (dg[pos][k] + 32)
    out[p_at[k] + 1] = ((dr[pos][k] - dg[pos][k] + 8) << 4 | (db[pos][k] - dg[pos][k] + 8))
    k = ~diff[pos] & ~luma[pos]
    out[p_at[k]] = 0xFE
    for c in range(3):
        out[p_at[k] + 1 + c] = px[pos[k], c]
    out[at[len(pos):]] = 0xC0 | (c_len - 1)
    return out.tobytes()


def qoi_bytes(px, channels=None, colorspace=0, r=None, index=True, end=True):
    """[H, W, 3 or 4] uint8 -> a QOI file. ``channels`` (the header byte)
    defaults to the array's; ``r`` draws the op among those that fit (an
    RGB or RGBA op may always stand in); ``end`` appends the end marker."""
    px = np.ascontiguousarray(px, np.uint8)
    h, w, c = px.shape
    head = b"qoif" + struct.pack(">IIBB", w, h, channels or c, colorspace)
    tail = b"\0" * 7 + b"\1" if end else b""
    if not index:
        assert c == 3
        return head + _qoi_fast(px.reshape(-1, 3)) + tail
    flat = px.reshape(-1, c)
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    out = bytearray()
    run = 0
    for i in range(len(flat)):
        p = tuple(int(v) for v in flat[i]) + ((255,) if c == 3 else ())
        if p == prev and (r is None or r.random() < 0.9):
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        slot = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        pick = r.random() if r is not None else 0.0
        if seen[slot] == p and pick < 0.8:
            out.append(slot)
        elif p[3] != prev[3] or pick > 0.95:
            out += bytes([0xFF, *p])
        else:
            d = [((p[k] - prev[k] + 128) % 256) - 128 for k in range(3)]
            dg = d[1]
            if all(-2 <= v <= 1 for v in d) and pick < 0.85:
                out.append(0x40 | (d[0] + 2) << 4 | (d[1] + 2) << 2 | (d[2] + 2))
            elif -32 <= dg <= 31 and -8 <= d[0] - dg <= 7 and -8 <= d[2] - dg <= 7 and pick < 0.9:
                out += bytes([0x80 | (dg + 32), (d[0] - dg + 8) << 4 | (d[2] - dg + 8)])
            else:
                out += bytes([0xFE, *p[:3]])
        seen[slot] = p
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return head + bytes(out) + tail


# ---------------------------------------------------------- run lengths

def _spans(lines, min_run):
    """[n, w] samples -> per line the spans (line, start, length, is_run):
    stretches of ``min_run`` or more equal samples are runs, the samples
    between them copies."""
    n, w = lines.shape
    change = np.ones((n, w), bool)
    change[:, 1:] = lines[:, 1:] != lines[:, :-1]
    seg = np.cumsum(change.ravel()) - 1                # segment id a sample
    starts = np.flatnonzero(change.ravel())
    seg_len = np.diff(np.append(starts, n * w))
    is_run = (seg_len >= min_run)[seg].reshape(n, w)
    # spans: runs stay whole segments; copies merge consecutive non-run samples
    brk = np.ones((n, w), bool)
    brk[:, 1:] = change[:, 1:] | is_run[:, 1:] | is_run[:, :-1]
    s = np.flatnonzero(brk.ravel())
    length = np.diff(np.append(s, n * w))
    return s // w, s % w, length, is_run.ravel()[s]


def _chunk(line, start, length, is_run, most):
    """Cut spans into packets of at most ``most`` samples."""
    k = -(-length // most)
    first = np.repeat(np.cumsum(k) - k, k)
    part = np.arange(k.sum()) - first
    p_start = np.repeat(start, k) + most * part
    p_len = np.minimum(np.repeat(start + length, k) - p_start, most)
    return np.repeat(line, k), p_start, p_len, np.repeat(is_run, k)


def _sgi_rle(lines, bpc, most=127):
    """[n, w] samples (bpc bytes each) -> per line the RLE bytes and their
    lengths (packets, then a zero count)."""
    n, w = lines.shape
    line, start, length, is_run = _chunk(*_spans(lines, 3), most)
    atoms = np.where(is_run, 2, 1 + length)              # count atom + samples
    ends = np.bincount(line, atoms, n).astype(np.int64) + 1   # and the zero count
    p_off = np.cumsum(atoms) - atoms + line               # a terminator each line before
    total = int(ends.sum())
    out = np.zeros((total, bpc), np.uint8)
    out[p_off, -1] = np.where(is_run, length, 0x80 | length)
    samples = lines.astype(np.uint16 if bpc == 2 else np.uint8)

    def put(at, vals):
        if bpc == 2:
            out[at, 0], out[at, 1] = vals >> 8, vals & 255
        else:
            out[at, 0] = vals

    put(p_off[is_run] + 1, samples[line[is_run], start[is_run]])
    cp = ~is_run
    k = length[cp]
    rep = np.repeat(np.arange(cp.sum()), k)
    j = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    put(p_off[cp][rep] + 1 + j, samples[line[cp][rep], start[cp][rep] + j])
    return out.reshape(-1).tobytes(), ends * bpc


def sgi_bytes(planes, bpc=1, rle=True, dimension=None, name=b""):
    """[z, h, w] samples (z 1, 3 or 4; rows top-down) -> an SGI file,
    stored bottom-up: raw planes, or RLE rows with start and length
    tables."""
    planes = np.asarray(planes)
    z, h, w = planes.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll", 474, int(rle), bpc, dim, w, h, z, 0, 255 * bpc)
    head = (head + bytes(4) + name[:79].ljust(80, b"\0") + bytes(4)).ljust(512, b"\0")
    rows = planes[:, ::-1].reshape(z * h, w)            # channel-major, bottom row first
    if not rle:
        dt = ">u2" if bpc == 2 else np.uint8
        return head + rows.astype(dt).tobytes()
    body, lens = _sgi_rle(rows, bpc)
    starts = 512 + 8 * z * h + np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (head + starts.astype(">u4").tobytes() + lens.astype(">u4").tobytes() + body)


def _pcx_rle(lines, most=63):
    """[n, line] bytes -> PCX RLE: runs of up to ``most``, a single byte
    below 0xC0 as itself, any other as a run of one."""
    n, w = lines.shape
    change = np.ones((n, w), bool)
    change[:, 1:] = lines[:, 1:] != lines[:, :-1]
    s = np.flatnonzero(change.ravel())
    length = np.diff(np.append(s, n * w))
    line, start, plen, _ = _chunk(s // w, s % w, length, np.zeros(len(s), bool), most)
    val = lines[line, start]
    single = (plen == 1) & (val < 0xC0)
    size = np.where(single, 1, 2)
    off = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[off[single]] = val[single]
    out[off[~single]] = 0xC0 | plen[~single]
    out[off[~single] + 1] = val[~single]
    return out.tobytes()


def pcx_bytes(px, bits, planes, palette=None, vga=None, version=5, bytes_per_line=None,
              stride=None, box=(0, 0)):
    """A PCX file of ``px``: [H, W] indices or levels (bits 1 or 8), or
    [H, W, 3] RGB (bits 8, 3 planes). ``palette``: 16 x 3 header colours;
    ``vga``: 256 x 3 colours after a 0x0C byte at the end of the file;
    ``stride``: the bytes a plane a line as stored (default (W * bits + 7)
    // 8, made even); ``bytes_per_line``: the header's value (default the
    stride)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    natural = (w * bits + 7) // 8
    stride = stride or natural + natural % 2
    if bits == 1:
        plane_rows = [np.packbits((px >> p) & 1, axis=1) for p in range(planes)]
    elif planes == 3:
        plane_rows = [px[..., c] for c in range(3)]
    else:
        plane_rows = [px]
    line = np.zeros((h, planes * stride), np.uint8)
    for p, rows in enumerate(plane_rows):
        line[:, p * stride:p * stride + rows.shape[1]] = rows
    x0, y0 = box
    pal = np.zeros((16, 3), np.uint8) if palette is None else np.asarray(palette, np.uint8)
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1,
                       72, 72)
    head += pal.tobytes() + b"\0" + bytes([planes])
    head += struct.pack("<HH", bytes_per_line if bytes_per_line is not None else stride, 1)
    head = head.ljust(128, b"\0")
    tail = b"" if vga is None else b"\x0c" + np.asarray(vga, np.uint8).tobytes()
    return head + _pcx_rle(line) + tail


# ---------------------------------------------------------------- ICO / CUR

def dib_entry(samples, bits, palette=b"", mask=None, header=40):
    """An icon's DIB: the bitmap header with the doubled height, the
    ``palette`` (BGRX quads), ``samples`` ([H, W] indices, or [H, W, k]
    stored BGR(X) bytes) bottom-up, then the AND mask ([H, W] 0/1, zero by
    default), each row padded to 32 bits."""
    from tools.make_torch_port_image_fixtures import bmp_bytes, bmp_rows

    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    colors = len(palette) // 4 if bits <= 8 else 0
    dib = bmp_bytes(w, 2 * h, bits, bmp_rows(samples, bits), header=header, palette=palette,
                    colors=colors)[14:]
    m = np.zeros((h, w), np.uint8) if mask is None else np.asarray(mask, np.uint8)
    return dib + bmp_rows(m, 1)


def icon_bytes(entries, kind=1):
    """An ICO (``kind`` 1) or CUR (2) file of ``entries``: (width byte,
    height byte, colour count, bit count, image bytes), 0 standing for
    256; the bit count field holds a CUR's hotspot y instead."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    at = 6 + 16 * len(entries)
    dirs, body = b"", b""
    for w, h, colors, bpp, data in entries:
        dirs += struct.pack("<BBBBHHII", w, h, colors, 0, 1, bpp, len(data), at + len(body))
        body += data
    return head + dirs + body


# --------------------------------------------------------------- Zstandard

def zstd_modes(data):
    """The first frame of a Zstandard stream -> a set of the modes it holds:
    ``block:raw|rle|compressed``, ``lit:raw|rle|huf1|huf4|treeless1|treeless4``
    (and ``weights:direct|fse``), ``seq:none``, and
    ``ll|of|ml:predefined|rle|fse|repeat``; plus ``checksum`` and
    ``content_size`` when the header has them."""
    modes = set()
    fhd = data[4]
    single, did = (fhd >> 5) & 1, fhd & 3
    fcs = (fhd >> 6) and 1 << (fhd >> 6) or single
    p = 5 + (not single) + (0, 1, 2, 4)[did] + fcs
    if fhd & 4:
        modes.add("checksum")
    if fcs:
        modes.add("content_size")
    while True:
        bh = int.from_bytes(data[p:p + 3], "little")
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        modes.add("block:" + ("raw", "rle", "compressed", "reserved")[kind])
        if kind == 2:
            b = data[p:p + size]
            lt, sf = b[0] & 3, (b[0] >> 2) & 3
            if lt in (2, 3):
                lh = (3, 3, 4, 5)[sf]
                v = int.from_bytes(b[:lh], "little")
                csize = (v >> 14) & 0x3FF if sf < 2 else v >> (18 if sf == 2 else 22)
                streams = "1" if sf == 0 else "4"
                modes.add("lit:" + ("huf" if lt == 2 else "treeless") + streams)
                if lt == 2:
                    modes.add("weights:" + ("direct" if b[lh] >= 128 else "fse"))
                q = lh + csize
            else:
                modes.add("lit:" + ("raw", "rle")[lt])
                lh = 1 if sf in (0, 2) else sf
                n = b[0] >> 3 if lh == 1 else int.from_bytes(b[:lh], "little") >> 4
                q = lh + (n if lt == 0 else 1)
            nseq = b[q]
            q += 1 + (nseq >= 0x80) + (nseq == 0xFF)
            if nseq == 0:
                modes.add("seq:none")
            else:
                m = b[q]
                for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                    modes.add(f"{name}:" + ("predefined", "rle", "fse", "repeat")[(m >> shift) & 3])
        p += 1 if kind == 1 else size
        if last:
            return modes
