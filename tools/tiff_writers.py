"""Writers of the TIFF strips libtiff decodes and Pillow cannot write in
full: CCITT fax codes, ThunderScan and old-style JPEG, for the PyTorch
port's decoder tests and ``chip_smoke.py``. numpy and the standard library
only: the smoke runs them where there is no PIL.

- ``fax_strip``: bilevel rows (1 = a set bit, a "black" run) as modified
  Huffman (MH, ITU-T T.4 one-dimensional), modified READ (MR, T.4
  two-dimensional, every ``k``-th row 1-D) or MMR (T.6) codes, in the
  framings of TIFF compressions 2 (CCITT RLE: rows byte-aligned, no EOL),
  32771 (RLEW: rows aligned to 16 bits), 3 (an EOL before every row, with
  its 1-D / 2-D tag bit under MR, EOLs byte-aligned with fill bits, an
  optional RTC) and 4 (an optional EOFB); codes as libtiff's encoder picks
  them (``Fax3Encode2DRow``), or with ``r`` drawn among the codes that
  describe the same row (pass mode where vertical would do, horizontal
  where either would, make-up runs of 2560 and zero-length terminating
  runs), and fill order 2;
- ``thunder_rows``: ThunderScan 4-bit rows, each pixel coded by an opcode
  drawn from ``r`` among those that reach it (runs, 2-bit deltas, 3-bit
  deltas with their skip codes, raw pixels), or greedily without ``r``;
- ``ojpeg_tiff``: a baseline JPEG wrapped as an old-style JPEG TIFF
  (compression 6), either with JPEGInterchangeFormat / Length pointing at
  the stream (the "513 form") or as the tables-only form libtiff rebuilds
  a stream from: JPEGQTables, JPEGDCTables and JPEGACTables, each strip
  the entropy-coded data of its restart interval.

``tiff_bytes`` of ``tools/make_torch_port_image_fixtures.py`` assembles
the file around the strips (``blocks=``).
"""

from __future__ import annotations

import bisect
import struct

import numpy as np

# ------------------------------------------------------------------ CCITT

# T.4 tables 2/T.4 and 3/T.4: terminating codes of runs 0-63, make-up codes
# of 64-1728, and the extended make-up codes of 1792-2560 both colours share
WHITE_TERMINATING = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
BLACK_TERMINATING = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 "
    "000011001011 000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 "
    "000001010101 000001010110 000001010111 000001100100 000001100101 000001010010 "
    "000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
EXTENDED_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()
EOL = "000000000001"
# T.4 table 4/T.4: the two-dimensional mode codes
PASS, HORIZONTAL = "0001", "001"
VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
            -3: "0000010"}  # a1 - b1
EXTENSION = "0000001"  # + 3 bits: the uncompressed mode of T.4 Annex A is 0000001111


def _run_codes(run, black, r=None):
    """The codes of one run: make-ups of 2560 while at least 2624 are
    left, one make-up, then a terminating code (libtiff's putspan); with
    ``r``, sometimes a 2560 make-up more where the rest allows it, or a
    make-up ending on a terminating code of 0."""
    term = BLACK_TERMINATING if black else WHITE_TERMINATING
    makeup = (BLACK_MAKEUP if black else WHITE_MAKEUP) + EXTENDED_MAKEUP
    out = []
    while run >= 2624 or (r is not None and run >= 2560 and r.random() < 0.3):
        out.append(EXTENDED_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        out.append(makeup[run // 64 - 1])
        run %= 64
    out.append(term[run])
    return out


def _changes(row):
    """The changing elements of a row of 0 / 1: the columns whose pixel
    differs from the one before (an imaginary 0 before column 0), then the
    width twice (libtiff's finddiff runs into the row's end)."""
    row = np.asarray(row, np.int8)
    w = len(row)
    prev = np.concatenate([[0], row[:-1]])
    return np.concatenate([np.flatnonzero(row != prev), [w, w]]).tolist()


def _mh_row(row, r=None):
    ch = _changes(row)
    edges = [0] + [c for c in ch if c < len(row)] + [len(row)]
    out = []
    for i in range(len(edges) - 1):
        out += _run_codes(edges[i + 1] - edges[i], i & 1, r)
    return out


def _next(ch, after, colour):
    """The first changing element of ``ch`` past column ``after`` (-1: from
    the row's start) that turns to ``colour``: changes alternate 0 -> 1 at
    even positions of the list, 1 -> 0 at odd ones; the width where none."""
    i = bisect.bisect_right(ch, after)
    if i < len(ch) - 2 and (i & 1) != (0 if colour else 1):
        i += 1
    return ch[min(i, len(ch) - 1)]


def _mr_row(row, ref, r=None):
    """Two-dimensional codes of ``row`` against the reference row ``ref``
    (T.4 4.2.1.3), a0 starting before column 0 as white."""
    w = len(row)
    cur, refc = _changes(row), _changes(ref)
    out = []
    a0, colour = -1, 0
    while True:
        a1 = _next(cur, a0, 1 - colour)
        b1 = _next(refc, a0, 1 - colour)
        b2 = _next(refc, b1, colour) if b1 < w else w
        if b2 < a1:
            out.append(PASS)
            a0 = b2
        elif abs(a1 - b1) <= 3 and not (r is not None and r.random() < 0.15):
            out.append(VERTICAL[a1 - b1])
            a0, colour = a1, 1 - colour
        else:
            a2 = _next(cur, a1, colour) if a1 < w else w
            out.append(HORIZONTAL)
            out += _run_codes(a1 - max(a0, 0), colour, r)
            out += _run_codes(a2 - a1, 1 - colour, r)
            a0 = a2
        if a0 >= w:
            return out


def _pack(bitstring, fill):
    b = np.frombuffer(bitstring.encode(), np.uint8) - 48
    out = np.packbits(b)
    if fill == 2:
        out = np.packbits(np.unpackbits(out).reshape(-1, 8)[:, ::-1])
    return out.tobytes()


def fax_strip(rows, compression, two_d=False, k=4, fill_bits=False, rtc=False, eofb=False,
              fill=1, r=None):
    """Rows [h, w] of 0 / 1 as the data of one strip of ``compression`` 2,
    3, 4 or 32771 (module docstring). Compression 3 is MH, or MR with
    ``two_d`` (T4Options bit 0), a 1-D row every ``k`` rows (``r``:
    drawn); ``fill_bits`` (T4Options bit 2) pads before each EOL so that
    it ends on a byte boundary."""
    rows = np.asarray(rows, np.uint8)
    h, w = rows.shape
    parts = []
    ref = np.zeros(w, np.uint8)
    for y in range(h):
        row = rows[y]
        if compression in (2, 32771):
            bits = "".join(_mh_row(row, r))
            unit = 8 if compression == 2 else 16
            parts.append(bits + "0" * (-len(bits) % unit))
        elif compression == 4:
            parts.append("".join(_mr_row(row, ref, r)))
        else:
            one_d = not two_d or (y % k == 0 if r is None else r.random() < 1 / k)
            codes = _mh_row(row, r) if one_d else _mr_row(row, ref, r)
            eol = EOL + (("1" if one_d else "0") if two_d else "")
            if fill_bits:
                done = sum(map(len, parts))
                eol = "0" * (-(done + 12) % 8) + eol
            parts.append(eol + "".join(codes))
        ref = row
    if compression == 3 and rtc:
        parts.append((EOL + ("1" if two_d else "")) * 6)
    if compression == 4 and eofb:
        parts.append(EOL * 2)
    bits = "".join(parts)
    return _pack(bits + "0" * (-len(bits) % 8), fill)


def _fax_job(job):
    rows, compression, kw = job
    return fax_strip(rows, compression, **kw)


def fax_strips(rows, compression, rows_per_strip, mapper=map, **kw):
    """``fax_strip`` over strips of ``rows_per_strip`` rows, ``mapper``
    spreading them over processes."""
    jobs = [(rows[y:y + rows_per_strip], compression, kw)
            for y in range(0, len(rows), rows_per_strip)]
    return list(mapper(_fax_job, jobs))


def fax_options(two_d=False, fill_bits=False):
    """The T4Options (292) value; bit 1, uncompressed mode allowed, libtiff
    ignores."""
    return int(two_d) | int(fill_bits) << 2


# ------------------------------------------------------------- ThunderScan

def _thunder_row(row, r=None):
    """One row of 4-bit pixels as ThunderScan bytes, the last pixel 0 at
    the row's start."""
    out = []
    w = len(row)
    last, i = 0, 0
    while i < w:
        row_i = int(row[i])
        m = 0
        while i + m < w and m < 63 and int(row[i + m]) == last:
            m += 1
        opts = []
        if m >= 1:
            opts.append("run")
        d2 = []  # the 2-bit deltas that follow
        prev = last
        for k in range(3):
            if i + k < w and (int(row[i + k]) - prev) % 16 in (0, 1, 15):
                d2.append((int(row[i + k]) - prev) % 16)
                prev = int(row[i + k])
            else:
                break
        if d2:
            opts.append("d2")
        d3 = []
        prev = last
        for k in range(2):
            if i + k < w and (int(row[i + k]) - prev) % 16 in (0, 1, 2, 3, 13, 14, 15):
                d3.append((int(row[i + k]) - prev) % 16)
                prev = int(row[i + k])
            else:
                break
        if d3:
            opts.append("d3")
        opts.append("raw")
        if r is None:
            op = "run" if m >= 2 else "d2" if len(d2) == 3 else "d3" if len(d3) == 2 else (
                "d2" if d2 else "raw")
        else:
            op = opts[r.integers(len(opts))]
        if op == "run":
            n = m if r is None else int(r.integers(1, m + 1))
            out.append(n)
            i += n
        elif op == "d2":
            k = len(d2) if r is None else int(r.integers(1, len(d2) + 1))
            codes = [{0: 0, 1: 1, 15: 3}[d] for d in d2[:k]]
            slots = [2, 2, 2]
            at = sorted(r.choice(3, k, replace=False)) if r is not None else range(k)
            for j, c in zip(at, codes):
                slots[j] = c
            out.append(0x40 | slots[0] << 4 | slots[1] << 2 | slots[2])
            i += k
            last = int(row[i - 1])
        elif op == "d3":
            k = len(d3) if r is None else int(r.integers(1, len(d3) + 1))
            codes = [{0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}[d] for d in d3[:k]]
            slots = [4, 4]
            at = sorted(r.choice(2, k, replace=False)) if r is not None else range(k)
            for j, c in zip(at, codes):
                slots[j] = c
            out.append(0x80 | slots[0] << 3 | slots[1])
            i += k
            last = int(row[i - 1])
        else:
            hi = 0 if r is None else int(r.integers(0, 4)) << 4  # bits libtiff ignores
            out.append(0xC0 | hi | row_i)
            last = row_i
            i += 1
        if r is not None and r.random() < 0.05:  # a run of 0 or an all-skip delta byte
            out.append([0x00, 0x40 | 0x2A, 0x80 | 0x24][r.integers(3)])
    return bytes(out)


def thunder_rows(px, r=None):
    """[h, w] 4-bit pixels -> ThunderScan strip bytes (module docstring)."""
    return b"".join(_thunder_row(row, r) for row in np.asarray(px).tolist())


def thunder_strips(px, rows_per_strip, mapper=map):
    """Greedy ``thunder_rows`` over strips, ``mapper`` spreading them over
    processes."""
    return list(mapper(thunder_rows, [px[y:y + rows_per_strip]
                                      for y in range(0, len(px), rows_per_strip)]))


# ----------------------------------------------------------- old-style JPEG

def jpeg_parts(data):
    """A baseline JPEG's pieces: the DQT and DHT segments (whole, with
    their markers), the SOF0 and SOS bodies, the restart interval, the
    offset of the entropy-coded data and that data up to EOI."""
    parts = {"dqt": [], "dht": [], "dri": 0}
    pos = 2
    while True:
        code = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if code == 0xDB:
            parts["dqt"].append(data[pos:pos + 2 + n])
        elif code == 0xC4:
            parts["dht"].append(data[pos:pos + 2 + n])
        elif code == 0xC0:
            parts["sof"] = body
        elif code == 0xDD:
            parts["dri"] = struct.unpack(">H", body)[0]
        elif code == 0xDA:
            parts["sos"] = body
            parts["scan_at"] = pos + 2 + n
            end = data.rindex(b"\xff\xd9")
            parts["scan"] = data[pos + 2 + n:end]
            return parts
        pos += 2 + n


def restart_intervals(scan):
    """Entropy-coded data -> its restart intervals (the RSTn markers
    dropped; 0xFF00 stuffing kept)."""
    out, start, i = [], 0, 0
    while i < len(scan) - 1:
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
            out.append(scan[start:i])
            start = i = i + 2
            continue
        i += 1
    out.append(scan[start:])
    return out


def _tables(parts):
    """JPEGQTables / DCTables / ACTables bodies, one for each table id of
    the SOF's components, in component order (ids 0, 1, ...)."""
    qt, dc, ac = {}, {}, {}
    for seg in parts["dqt"]:
        body, p = seg[4:], 0
        while p < len(body):
            qt[body[p] & 15] = body[p + 1:p + 65]
            p += 65
    for seg in parts["dht"]:
        body, p = seg[4:], 0
        while p < len(body):
            tc, n = body[p], sum(body[p + 1:p + 17])
            (dc if tc >> 4 == 0 else ac)[tc & 15] = body[p + 1:p + 17 + n]
            p += 17 + n
    return qt, dc, ac


def tiff_container(payload, tags, order="<"):
    """A classic TIFF: ``payload`` at offset 8, then the IFD of ``tags``
    ({tag: (type, values)}; values of type 3, 4 or 5; offsets into the
    payload given as ``("at", k)`` are made absolute)."""
    codes = {3: "H", 4: "L", 5: "LL"}
    head = 8
    body = payload + bytes(len(payload) & 1)
    ifd_at = head + len(body)
    n = len(tags)
    data_at = ifd_at + 2 + 12 * n + 4
    ifd, extra = struct.pack(order + "H", n), b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        vals = [head + v[1] if isinstance(v, tuple) else v for v in vals]
        if typ == 5:
            vals = [x for pair in vals for x in pair]
        packed = struct.pack(f"{order}{len(vals)}{codes[typ][0]}", *vals)
        count = len(vals) // (2 if typ == 5 else 1)
        if len(packed) <= 4:
            inline = packed.ljust(4, b"\0")
        else:
            inline = struct.pack(order + "L", data_at + len(extra))
            extra += packed + bytes(len(packed) & 1)
        ifd += struct.pack(order + "HHL", tag, typ, count) + inline
    ifd += bytes(4)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(order + "H", 42)
    return magic + struct.pack(order + "L", ifd_at) + body + ifd + extra


def ojpeg_tiff(jpeg, form="interchange", rows_per_strip=None, photometric=6, subsampling=True,
               restart_tag=None, tags=None, omit=(), order="<"):
    """A baseline JPEG as an old-style JPEG TIFF (compression 6):

    - ``form="interchange"``: JPEGInterchangeFormat at the stream, its
      length the whole stream's; the strips are the
      stream's restart intervals, grouped ``rows_per_strip`` rows a strip,
      inside the stream (as old scanners wrote them);
    - ``form="header"``: the same, JPEGInterchangeFormatLength covering the
      markers up to the scan only, so that libtiff reads the entropy-coded
      data from the strips (and puts a restart marker between them);
    - ``form="tables"``: no interchange stream; JPEGQTables, JPEGDCTables
      and JPEGACTables point at the tables, each strip holds its restart
      intervals' data (libtiff makes the restart interval a strip's MCUs
      when there is more than one strip; ``restart_tag`` writes
      JPEGRestartInterval);
    - ``form="stream"``: the whole stream as the one strip.

    With several strips, the JPEG must have a restart marker at the end of
    each strip's rows. ``subsampling`` writes YCbCrSubsampling from the
    frame (with 3 components)."""
    parts = jpeg_parts(jpeg)
    sof = parts["sof"]
    h, w = struct.unpack(">HH", sof[1:5])
    nc = sof[5]
    comps = [sof[6 + 3 * k:9 + 3 * k] for k in range(nc)]
    hs, vs = comps[0][1] >> 4, comps[0][1] & 15
    rps = rows_per_strip or h
    intervals = restart_intervals(parts["scan"])
    nstrips = -(-h // rps)
    if nstrips > 1:
        per = len(intervals) // nstrips
        if per * nstrips != len(intervals):
            raise ValueError(f"{len(intervals)} restart intervals for {nstrips} strips")
        groups = [intervals[k * per:(k + 1) * per] for k in range(nstrips)]
        strips = [b"".join(g[j] + (bytes([0xFF, 0xD0 + (k * per + j) % 8]) if j < per - 1
                                   else b"") for j in range(per)) for k, g in enumerate(groups)]
    else:
        strips = [parts["scan"]]
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * nc), 259: (3, [6]),
         262: (3, [photometric]), 277: (3, [nc]), 278: (4, [rps]), 512: (3, [1])}
    if subsampling and nc == 3:
        t[530] = (3, [hs, vs])
    if restart_tag is not None:
        t[515] = (3, [restart_tag])
    if form in ("interchange", "header"):
        payload = jpeg
        t[513] = (4, [("at", 0)])
        t[514] = (4, [len(jpeg) if form == "interchange" else parts["scan_at"]])
        offs, pos = [], parts["scan_at"]
        if form == "header":
            payload = jpeg[:parts["scan_at"]]
            pos = len(payload)
            payload += b"".join(strips)
        for s in strips:
            offs.append(("at", pos))
            pos += len(s) + (2 if form == "interchange" else 0)  # the RSTn between
        t[273], t[279] = (4, offs), (4, [len(s) for s in strips])
    elif form == "tables":
        qt, dc, ac = _tables(parts)
        payload, at = b"", {}
        for name, tab in (("q", qt), ("d", dc), ("a", ac)):
            for k in sorted(tab):
                at[name, k] = len(payload)
                payload += tab[k]
        ids = [c[2] for c in comps]
        sel = parts["sos"][1:1 + 2 * nc]
        t[519] = (4, [("at", at["q", q]) for q in ids])
        t[520] = (4, [("at", at["d", sel[2 * k + 1] >> 4]) for k in range(nc)])
        t[521] = (4, [("at", at["a", sel[2 * k + 1] & 15]) for k in range(nc)])
        offs = []
        for s in strips:
            offs.append(("at", len(payload)))
            payload += s
        t[273], t[279] = (4, offs), (4, [len(s) for s in strips])
    else:
        payload = jpeg
        t[273], t[279] = (4, [("at", 0)]), (4, [len(jpeg)])
    t.update(tags or {})
    for k in omit:
        t.pop(k, None)
    return tiff_container(payload, t, order)
