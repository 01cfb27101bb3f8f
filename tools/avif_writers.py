"""AVIF container edits for the AVIF tests: a small ISO BMFF box rewriter.

``Avif.parse`` splits a file (PIL's writer's layout: ``ftyp``, ``meta``,
``mdat``) into its ``ftyp`` body, the ``meta`` boxes (``hdlr``, ``pitm``,
``iinf`` entries, ``iref`` entries, the ``ipco`` properties and the
``ipma`` associations, ``idat``) and each item's bytes; ``Avif.build``
writes it back with the sizes and the ``iloc`` offsets recomputed, so a
test can drop, duplicate or add properties, boxes and items, move an item
into ``idat`` (construction method 1), or cut the ``mdat``. Numpy and the
standard library only.

    from tools.avif_writers import Avif, box, full_box
    a = Avif.parse(open("x.avif", "rb").read())
    a.props.append((b"zzzz", b"\\0"))
    a.assoc[a.primary].append((len(a.props), True))
    data = a.build()
"""

from __future__ import annotations

import struct


def box(typ, body):
    return struct.pack(">I4s", 8 + len(body), typ) + body


def full_box(typ, version, flags, body):
    return box(typ, bytes([version]) + flags.to_bytes(3, "big") + body)


def boxes(b, start, end):
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", b, pos)
        hdr = 8
        if size == 1:
            size, hdr = struct.unpack_from(">Q", b, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        yield typ, pos + hdr, pos + size
        pos += size


class Avif:
    """An AVIF file as editable parts."""

    def __init__(self):
        self.ftyp = b"avif\0\0\0\0avifmif1miafMA1B"
        self.hdlr = b"\0" * 4 + b"pict" + b"\0" * 13
        self.primary = 1
        self.pitm_version = 0
        self.infe = []      # [(item id, type, name, flags)]
        self.iref = []      # [(type, from id, [to ids])]
        self.props = []     # [(type, body)]
        self.assoc = {}     # item id -> [(property index (1-based), essential)]
        self.items = {}     # item id -> bytes
        self.in_idat = set()  # items stored in idat (construction method 1)
        self.extra_meta = []  # extra boxes appended to meta: [(type, body)]
        self.iloc_version = 0

    @classmethod
    def parse(cls, data):
        a = cls()
        top = {t: (s, e) for t, s, e in boxes(data, 0, len(data))}
        a.ftyp = data[top[b"ftyp"][0]:top[b"ftyp"][1]]
        ms, me = top[b"meta"]
        locs = {}
        for t, s, e in boxes(data, ms + 4, me):
            if t == b"hdlr":
                a.hdlr = data[s:e]
            elif t == b"pitm":
                a.pitm_version = data[s]
                a.primary = struct.unpack_from(">H" if data[s] == 0 else ">I", data, s + 4)[0]
            elif t == b"iinf":
                v = data[s]
                for t2, s2, e2 in boxes(data, s + (6 if v == 0 else 8), e):
                    iv = data[s2]
                    flags = int.from_bytes(data[s2 + 1:s2 + 4], "big")
                    p = s2 + 4
                    iid = struct.unpack_from(">H" if iv == 2 else ">I", data, p)[0]
                    p += 2 if iv == 2 else 4
                    typ = data[p + 2:p + 6]
                    name = data[p + 6:e2]
                    a.infe.append((iid, typ, name, flags))
            elif t == b"iref":
                v = data[s]
                k = 2 if v == 0 else 4
                for t2, s2, e2 in boxes(data, s + 4, e):
                    src = int.from_bytes(data[s2:s2 + k], "big")
                    n = struct.unpack_from(">H", data, s2 + k)[0]
                    dst = [int.from_bytes(data[s2 + k + 2 + i * k:s2 + k + 2 + (i + 1) * k], "big")
                           for i in range(n)]
                    a.iref.append((t2, src, dst))
            elif t == b"iprp":
                for t2, s2, e2 in boxes(data, s, e):
                    if t2 == b"ipco":
                        a.props = [(t3, data[s3:e3]) for t3, s3, e3 in boxes(data, s2, e2)]
                    elif t2 == b"ipma":
                        v, flags = data[s2], int.from_bytes(data[s2 + 1:s2 + 4], "big")
                        p = s2 + 4
                        n = struct.unpack_from(">I", data, p)[0]
                        p += 4
                        for _ in range(n):
                            iid = int.from_bytes(data[p:p + (2 if v < 1 else 4)], "big")
                            p += 2 if v < 1 else 4
                            na = data[p]
                            p += 1
                            lst = []
                            for _ in range(na):
                                if flags & 1:
                                    x = struct.unpack_from(">H", data, p)[0]
                                    p += 2
                                    lst.append((x & 0x7FFF, bool(x >> 15)))
                                else:
                                    lst.append((data[p] & 0x7F, bool(data[p] >> 7)))
                                    p += 1
                            a.assoc[iid] = lst
            elif t == b"iloc":
                v = data[s]
                p = s + 4
                osz, lsz, bsz = data[p] >> 4, data[p] & 15, data[p + 1] >> 4
                isz = data[p + 1] & 15 if v in (1, 2) else 0
                p += 2
                n = struct.unpack_from(">H" if v < 2 else ">I", data, p)[0]
                p += 2 if v < 2 else 4

                def rd(k):
                    nonlocal p
                    x = int.from_bytes(data[p:p + k], "big") if k else 0
                    p += k
                    return x

                for _ in range(n):
                    iid = rd(2 if v < 2 else 4)
                    method = rd(2) & 15 if v in (1, 2) else 0
                    rd(2)
                    base = rd(bsz)
                    ext = []
                    for _ in range(rd(2)):
                        if isz:
                            rd(isz)
                        ext.append((method, base + rd(osz), rd(lsz)))
                    locs[iid] = ext
            elif t == b"idat":
                top[b"idat"] = (s, e)
        for iid, ext in locs.items():
            parts = []
            for method, off, ln in ext:
                if method == 1:
                    off += top[b"idat"][0]
                parts.append(data[off:off + ln])
            a.items[iid] = b"".join(parts)
            if ext and ext[0][0] == 1:
                a.in_idat.add(iid)
        return a

    def _meta(self, mdat_start):
        """The meta box for an mdat payload starting at ``mdat_start``."""
        out = [box(b"hdlr", self.hdlr)]
        if self.primary is not None:
            out.append(full_box(b"pitm", self.pitm_version, 0,
                                struct.pack(">H" if self.pitm_version == 0 else ">I",
                                            self.primary)))
        # iloc: items in mdat in id order, then those in idat
        entries = []
        pos, ipos = mdat_start, 0
        for iid in sorted(self.items):
            ln = len(self.items[iid])
            if iid in self.in_idat:
                entries.append((iid, 1, ipos, ln))
                ipos += ln
            else:
                entries.append((iid, 0, pos, ln))
                pos += ln
        v = 1 if self.in_idat or self.iloc_version == 1 else self.iloc_version
        body = bytes([0x44, 0x00])
        body += struct.pack(">H" if v < 2 else ">I", len(entries))
        for iid, method, off, ln in entries:
            body += struct.pack(">H" if v < 2 else ">I", iid)
            if v in (1, 2):
                body += struct.pack(">H", method)
            body += struct.pack(">HH", 0, 1) + struct.pack(">II", off, ln)
        out.append(full_box(b"iloc", v, 0, body))
        infe = b"".join(full_box(b"infe", 2, flags, struct.pack(">HH", iid, 0) + typ + name)
                        for iid, typ, name, flags in self.infe)
        out.append(full_box(b"iinf", 0, 0, struct.pack(">H", len(self.infe)) + infe))
        if self.iref:
            refs = b"".join(box(t, struct.pack(">HH", src, len(dst))
                                + b"".join(struct.pack(">H", d) for d in dst))
                            for t, src, dst in self.iref)
            out.append(full_box(b"iref", 0, 0, refs))
        ipco = box(b"ipco", b"".join(box(t, b) for t, b in self.props))
        ipma = struct.pack(">I", len(self.assoc))
        for iid in sorted(self.assoc):
            lst = self.assoc[iid]
            ipma += struct.pack(">HB", iid, len(lst))
            ipma += bytes((0x80 if ess else 0) | idx for idx, ess in lst)
        out.append(box(b"iprp", ipco + full_box(b"ipma", 0, 0, ipma)))
        if self.in_idat:
            out.append(box(b"idat", b"".join(self.items[i] for i in sorted(self.items)
                                             if i in self.in_idat)))
        out += [box(t, b) for t, b in self.extra_meta]
        return full_box(b"meta", 0, 0, b"".join(out))

    def build(self, cut=None):
        """The file's bytes (``cut``: keep only its first ``cut`` bytes)."""
        head = box(b"ftyp", self.ftyp)
        payload = b"".join(self.items[i] for i in sorted(self.items) if i not in self.in_idat)
        start = len(head) + len(self._meta(0)) + 8
        data = head + self._meta(start) + box(b"mdat", payload)
        return data if cut is None else data[:cut]


# --------------------------------------------------------------------------
# image sequences (PIL's ``save_all`` layout: ftyp, meta, moov, mdat)

CONTAINERS = (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf", b"edts", b"tref")


def tree(data, start, end):
    """The boxes of data[start:end] as [type, body] lists, the bodies of
    ``CONTAINERS`` as lists of their boxes."""
    out = []
    for t, s, e in boxes(data, start, end):
        out.append([t, tree(data, s, e) if t in CONTAINERS else bytes(data[s:e])])
    return out


def flatten(nodes):
    return b"".join(box(t, flatten(v) if isinstance(v, list) else v) for t, v in nodes)


def find(nodes, *path, index=0):
    """The ``index``-th node of type path[0] in ``nodes``, then down the
    path (the first of each later type)."""
    hits = [n for n in nodes if n[0] == path[0]]
    node = hits[index]
    return node if len(path) == 1 else find(node[1], *path[1:])


def _shift_iloc(meta, delta):
    """meta's body with every iloc extent offset (construction method 0)
    moved by ``delta``."""
    meta = bytearray(meta)
    for t, s, e in boxes(meta, 4, len(meta)):
        if t != b"iloc":
            continue
        v = meta[s]
        p = s + 4
        osz, lsz, bsz = meta[p] >> 4, meta[p] & 15, meta[p + 1] >> 4
        isz = meta[p + 1] & 15 if v in (1, 2) else 0
        p += 2
        n = int.from_bytes(meta[p:p + (2 if v < 2 else 4)], "big")
        p += 2 if v < 2 else 4
        for _ in range(n):
            p += 2 if v < 2 else 4
            method = int.from_bytes(meta[p:p + 2], "big") & 15 if v in (1, 2) else 0
            p += 2 if v in (1, 2) else 0
            p += 2 + bsz
            count = int.from_bytes(meta[p:p + 2], "big")
            p += 2
            for _ in range(count):
                p += isz
                if method == 0 and osz:
                    off = int.from_bytes(meta[p:p + osz], "big") + delta
                    meta[p:p + osz] = off.to_bytes(osz, "big")
                p += osz + lsz
    return bytes(meta)


class Sequence:
    """An ``avis`` file as its top-level boxes, ``moov`` as a tree to edit;
    ``build`` writes it back with the ``stco`` / ``co64`` entries and the
    ``iloc`` offsets moved with the ``mdat``."""

    def __init__(self, data):
        self.top = []
        for t, s, e in boxes(data, 0, len(data)):
            self.top.append([t, tree(data, s, e) if t == b"moov" else bytes(data[s:e])])
        self.old_mdat = self._mdat_start()

    def _mdat_start(self):
        pos = 0
        for t, v in self.top:
            size = 8 + len(flatten(v) if isinstance(v, list) else v)
            if t == b"mdat":
                return pos + 8
            pos += size
        return pos

    def moov(self):
        return find(self.top, b"moov")[1]

    def build(self):
        delta = self._mdat_start() - self.old_mdat
        for t, v in self.top:
            if t == b"moov":
                for trak in [n for n in v if n[0] == b"trak"]:
                    try:
                        stbl = find(trak[1], b"mdia", b"minf", b"stbl")[1]
                    except IndexError:
                        continue
                    for node in stbl:
                        if node[0] in (b"stco", b"co64"):
                            k = 4 if node[0] == b"stco" else 8
                            body = bytearray(node[1])
                            n = struct.unpack_from(">I", body, 4)[0]
                            for i in range(n):
                                p = 8 + i * k
                                if p + k <= len(body):
                                    off = int.from_bytes(body[p:p + k], "big") + delta
                                    body[p:p + k] = (off % (1 << (8 * k))).to_bytes(k, "big")
                            node[1] = bytes(body)
        out = []
        for t, v in self.top:
            if t == b"meta" and delta:
                v = _shift_iloc(v, delta)
            out.append(box(t, flatten(v) if isinstance(v, list) else v))
        self.old_mdat = self._mdat_start()
        return b"".join(out)


def grid(tiles, rows, cols, width, height, ispe=None, version=0, flags=None, extra=b"",
         order=None):
    """A ``grid`` image (item 1, primary) of ``tiles``: files of PIL's writer,
    rows x cols of them in raster order, each's colour item (and its alpha
    item, which make a second grid, item 100, auxiliary to the first) with
    its properties. ``width`` x ``height`` is the output size; ``ispe`` the
    grid's ispe (the output size by default); ``version``, ``flags`` (bit 0:
    32-bit sizes) and ``extra`` bytes edit the ImageGrid box; ``order``
    lists the tiles' places in the dimg reference (all of them in order by
    default)."""
    parts = [Avif.parse(t) for t in tiles]
    t0 = parts[0]
    g = Avif()
    g.ftyp, g.hdlr = t0.ftyp, t0.hdlr
    big = flags if flags is not None else int(width > 65535 or height > 65535)
    body = bytes([version, big, rows - 1, cols - 1])
    body += struct.pack(">II" if big & 1 else ">HH", width, height) + extra
    g.items = {1: body}
    g.infe = [(1, b"grid", b"\0", 0)]
    g.props, g.assoc = [], {}

    def copy_item(a, src, dst):
        g.items[dst] = a.items[src]
        g.infe.append((dst, b"av01", b"\0", 1))
        g.assoc[dst] = []
        for idx, ess in a.assoc[src]:
            g.props.append(a.props[idx - 1])
            g.assoc[dst].append((len(g.props), ess))

    for k, a in enumerate(parts):
        copy_item(a, a.primary, 2 + k)
    g.props.append((b"ispe", b"\0" * 4 + struct.pack(">II", *(ispe or (width, height)))))
    g.assoc[1] = [(len(g.props), False)]
    n = len(parts)
    g.iref = [(b"dimg", 1, [2 + k for k in (range(n) if order is None else order)])]
    alphas = [next((s for t, s, d in a.iref if t == b"auxl" and d == [a.primary]), None)
              for a in parts]
    if all(alphas):
        for k, a in enumerate(parts):
            copy_item(a, alphas[k], 101 + k)
        g.items[100] = body
        g.infe.append((100, b"grid", b"\0", 1))
        aux = [(i, e) for i, e in g.assoc[101] if g.props[i - 1][0] == b"auxC"]
        g.assoc[100] = [g.assoc[1][0]] + aux
        g.iref += [(b"dimg", 100, [101 + k for k in (range(n) if order is None else order)]),
                   (b"auxl", 100, [1])]
    return g.build()
