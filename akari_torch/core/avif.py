"""AVIF decoding without PIL: a still image's primary AV1 item, as PIL 12.1.0
reads it through libavif 1.3.0 (``Image.open(path).convert("RGB")``).

``decode_avif`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")``. Where libavif's parse (``avifDecoderParse``, PIL's
open) fails with a result PIL raises as ``SyntaxError`` (an invalid
``ftyp``, a failed BMFF parse, truncated data), it raises ``NextFormat``,
and ``decode_image`` goes on to the formats after AVIF as ``Image.open``
does; where PIL's open or load fails otherwise, ``ValueError``:

- the container (ISO BMFF / HEIF, as libavif parses a still image):
  ``ftyp`` first, with an ``avif`` brand (an ``avis`` brand makes libavif
  read tracks); one ``meta`` (version 0, ``hdlr`` ``pict`` first with a
  zero ``pre_defined`` and a terminated name; ``pitm``, ``iinf`` / ``infe``
  v2-3, ``iloc`` v0-2 with construction methods 0 and 1 (``idat``),
  ``iref``, ``iprp`` of ``ipco`` then ``ipma`` boxes only, each once;
  boxes inside their parents); the properties ``av1C``, ``ispe``,
  ``pixi`` (optional: PIL runs libavif without its strict checks; one
  depth for every plane, that of the ``av1C``), ``colr`` (one nclx, with
  zero reserved bits, and one ICC profile, which PIL's ``convert`` does not
  apply), ``auxC`` (the alpha URNs), ``irot`` / ``imir`` / ``clap`` (each
  essential; PIL turns the first two into an EXIF orientation and applies
  none of them to the pixels) and ``pasp``; an item with an unknown
  essential property is skipped; an Exif item's TIFF-header offset;
  libavif's size limits and PIL's pixel limit;
- the primary item's AV1 OBUs, decoded by ``native/av1_decode.cpp`` (bit
  for bit dav1d 1.5.1's planes), and the alpha item's, which decides PIL's
  mode (``RGBA``) and, for a premultiplied image (``prem``), is divided out
  of the colour as libavif does (``unpremultiply``);
- YUV -> RGB as ``avifImageYUVToRGB`` runs it (``yuv_to_rgb``): libyuv's
  fixed point for BT.601 / BT.470BG / unspecified, BT.709 and BT.2020 NCL
  with its bilinear chroma upsampling, libavif's float route for FCC,
  SMPTE 240M, IPT-C2, YCgCo (full range) and identity (4:4:4), either
  range; the nclx of the ``colr`` property, else the sequence header's.

Refused with a ``ValueError`` naming the form (``ROADMAP.md``, slice 23):
AV1 tools outside the decoder (loop restoration, CDEF, superres, film
grain, segmentation, delta q / lf, quantizer matrices, intra block copy),
bit depths above 8, ``grid`` items, ``avis`` sequences, a frame or alpha
plane whose size differs from its ``ispe`` (libavif scales it), the
chromaticity-derived nclx matrix, and AV1 streams whose transforms leave
the 16-bit range the specification requires (dav1d's x86 assembly, which
PIL runs, saturates its lanes there).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, note_mode

AVIF_MAJOR_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")  # PIL's _accept
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# libavif's decoder defaults (avif.h)
IMAGE_SIZE_LIMIT = 16384 * 16384
IMAGE_DIMENSION_LIMIT = 32768
# properties libavif parses (others are opaque, and skip their item when essential)
KNOWN_PROPERTIES = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir",
                    b"pixi", b"a1op", b"lsel", b"a1lx", b"clli", b"altr", b"mdcv", b"cclv",
                    b"amve", b"reve", b"ndwt")
# libyuv's constants per (matrix, full range): yg, yb, ub, ug, vg, vr
_BT601 = {1: (16320, 32, 113, 22, 46, 90), 0: (18997, -1160, 128, 25, 52, 102)}
_LIBYUV = {
    2: _BT601, 5: _BT601, 6: _BT601,
    1: {1: (16320, 32, 119, 12, 30, 101), 0: (18997, -1160, 128, 14, 34, 115)},
    9: {1: (16320, 32, 120, 11, 37, 94), 0: (19003, -1160, 128, 12, 42, 107)},
}
# libavif's kr, kb for the matrices it converts itself (IPT-C2 falls back to BT.601's)
_FLOAT_KRKB = {4: (0.30, 0.11), 7: (0.212, 0.087), 15: (0.299, 0.114)}
# the matrices libavif converts on a monochrome image (YCgCo at full range only)
_MONO_MATRICES = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15)
_MATRIX_NAMES = {0: "identity (GBR)", 3: "reserved", 4: "FCC", 7: "SMPTE 240M",
                 8: "YCgCo", 10: "BT.2020 constant luminance", 11: "SMPTE 2085",
                 12: "chromaticity-derived non-constant luminance",
                 13: "chromaticity-derived constant luminance", 14: "ICtCp",
                 15: "IPT-C2", 16: "YCgCo-Re", 17: "YCgCo-Ro"}


# akr_av1_probe's values and akr_av1_decode's counts (native/av1_decode.cpp)
INFO_NAMES = ("width", "height", "bit_depth", "mono", "ssx", "ssy", "full_range", "primaries",
              "transfer", "matrix", "chroma_position", "profile", "sb128", "tx_mode",
              "screen_content", "tile_cols", "tile_rows", "lossless", "lf_levels", "base_q_idx")
STAT_NAMES = ("blocks", "palette_y", "palette_uv", "filter_intra", "cfl", "tx_split",
              "tx_type_not_dct", "angle_delta")


class _Bad(Exception):
    """libavif's parse failed with a result PIL raises as ``SyntaxError`` at
    open (INVALID_FTYP, BMFF_PARSE_FAILED, TRUNCATED_DATA, NO_CONTENT), so
    PIL goes on to the next format."""


class _Fail(Exception):
    """libavif's parse failed with a result PIL raises as another exception
    (RuntimeError, ValueError), so PIL's open fails."""


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def _boxes(b, start, end, top=False):
    """(type, body start, body end, cut) of the boxes in b[start:end]; a
    box running past ``end`` is an error but at the top level (``cut``)."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise _Bad("a truncated box header")
        size, typ = _u32(b, pos), bytes(b[pos + 4:pos + 8])
        hdr = 8
        if size == 1:
            if end - pos < 16:
                raise _Bad("a truncated box header")
            size, hdr = struct.unpack_from(">Q", b, pos + 8)[0], 16
        elif size == 0:
            if not top:
                raise _Bad(f"box {typ!r} of size 0 inside another box")
            size = end - pos
        if size < hdr:
            raise _Bad(f"box {typ!r} of size {size}")
        if pos + size > end and not top:
            raise _Bad(f"box {typ!r} runs past its parent")
        yield typ, pos + hdr, min(pos + size, end), pos + size > end
        pos += size


def _full(b, s, e, versions=None, what="box"):
    if e - s < 4:
        raise _Bad(f"a truncated {what}")
    version, flags = b[s], int.from_bytes(b[s + 1:s + 4], "big")
    if versions is not None and version not in versions:
        raise _Bad(f"{what} version {version}")
    return version, flags, s + 4


def _need(s, n, e, what):
    if s + n > e:
        raise _Bad(f"a truncated {what}")


def _string(b, s, e, what):
    z = bytes(b[s:e]).find(b"\0")
    if z < 0:
        raise _Bad(f"a {what} string without its terminator")
    return bytes(b[s:s + z]), s + z + 1


class _Item:
    def __init__(self, iid):
        self.id = iid
        self.type = None
        self.extents = None  # [(method, offset, length)]
        self.props = []      # [(type, parsed, essential)]
        self.aux_for = None
        self.premultiplied_by = None
        self.describes = None
        self.unsupported_essential = False

    def prop(self, typ):
        for t, v, _ in self.props:
            if t == typ:
                return v
        return None


def _parse_property(typ, b, s, e):
    if typ == b"ispe":
        _, _, p = _full(b, s, e, (0,), "ispe")
        _need(p, 8, e, "ispe")
        return (_u32(b, p), _u32(b, p + 4))
    if typ == b"av1C":
        _need(s, 4, e, "av1C")
        if b[s] != 0x81:
            raise _Bad("an av1C with a bad marker or version")
        return bytes(b[s:e])
    if typ == b"pixi":
        _, _, p = _full(b, s, e, (0,), "pixi")
        _need(p, 1, e, "pixi")
        n = b[p]
        if n == 0 or n > 4:
            raise _Fail(f"Not implemented (pixi of {n} channels)")
        _need(p + 1, n, e, "pixi")
        depths = tuple(b[p + 1:p + 1 + n])
        if any(d != depths[0] for d in depths):  # libavif reads one depth for every plane
            raise _Fail(f"Not implemented (pixi depths {depths})")
        return depths
    if typ == b"colr":
        _need(s, 4, e, "colr")
        kind = bytes(b[s:s + 4])
        if kind == b"nclx":
            _need(s + 4, 7, e, "colr")
            if b[s + 10] & 0x7F:
                raise _Bad("an nclx colr with nonzero reserved bits")
            return ("nclx", _u16(b, s + 4), _u16(b, s + 6), _u16(b, s + 8), b[s + 10] >> 7)
        if kind in (b"rICC", b"prof"):
            return ("icc", bytes(b[s + 4:e]))
        return ("other", kind)
    if typ == b"auxC":
        _, _, p = _full(b, s, e, (0,), "auxC")
        return _string(b, p, e, "auxC")[0]
    if typ == b"irot":
        _need(s, 1, e, "irot")
        return b[s] & 3
    if typ == b"imir":
        _need(s, 1, e, "imir")
        return b[s] & 1
    if typ == b"clap":
        _need(s, 32, e, "clap")
        return struct.unpack_from(">8I", b, s)
    if typ == b"pasp":
        _need(s, 8, e, "pasp")
        return struct.unpack_from(">2I", b, s)
    return bytes(b[s:e])


class Container:
    """The parse of an AVIF file, as far as libavif's avifDecoderParse goes."""

    def __init__(self, data):
        self.data = data
        self.items = {}
        self.primary = None
        self.idat = None
        self.sequence = False
        self._parse()

    def _parse(self):
        b = self.data
        n = len(b)
        seen_ftyp = meta = None
        moov = False
        for i, (typ, s, e, cut) in enumerate(_boxes(b, 0, n, top=True)):
            if i == 0:
                if typ != b"ftyp":
                    raise _Bad("the first box is not ftyp")
                if cut or e - s < 8 or (e - s - 8) % 4:
                    raise _Bad("a bad ftyp")
                brands = [bytes(b[s:s + 4])] + [bytes(b[p:p + 4]) for p in range(s + 8, e, 4)]
                if b"avif" not in brands and b"avis" not in brands:
                    raise _Bad("Invalid ftyp")
                seen_ftyp = brands
                if b"avis" in brands:  # libavif reads the tracks, not the items
                    self.sequence = True
                continue
            if typ == b"meta":
                if meta is not None:
                    raise _Bad("a second meta box")
                if cut:
                    raise _Bad("a truncated meta box")
                meta = (s, e)
            elif typ == b"moov":
                moov = True
        if seen_ftyp is None:
            raise _Bad("no ftyp")
        if self.sequence:
            if moov:
                raise ValueError("an AVIF image sequence (avis; frame 0 of a sequence is not "
                                 "read by the port)")
            raise _Bad("an avis file without tracks")
        if meta is None:
            raise _Bad("no meta box")
        self._parse_meta(*meta)

    def _parse_meta(self, s, e):
        b = self.data
        _, _, p = _full(b, s, e, (0,), "meta")
        seen = set()
        first = True
        pending = {}
        for typ, bs, be, _ in _boxes(b, p, e):
            if first and typ != b"hdlr":
                raise _Bad("the first box of meta is not hdlr")
            first = False
            if typ in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
                if typ in seen:
                    raise _Bad(f"a second {typ!r} box")
                seen.add(typ)
                pending[typ] = (bs, be)
        if first:
            raise _Bad("an empty meta box")
        hs, he = pending[b"hdlr"]
        _, _, q = _full(b, hs, he, (0,), "hdlr")
        _need(q, 8, he, "hdlr")
        if _u32(b, q) != 0:
            raise _Bad("hdlr with a nonzero pre_defined")
        if bytes(b[q + 4:q + 8]) != b"pict":
            raise _Bad("hdlr of a handler other than pict")
        _need(q + 8, 12, he, "hdlr")
        _string(b, q + 20, he, "hdlr name")
        if b"idat" in pending:
            self.idat = pending[b"idat"]
        if b"iinf" in pending:
            self._parse_iinf(*pending[b"iinf"])
        if b"iloc" in pending:
            self._parse_iloc(*pending[b"iloc"])
        if b"pitm" in pending:
            ps, pe = pending[b"pitm"]
            v, _, q = _full(b, ps, pe, (0, 1), "pitm")
            _need(q, 2 if v == 0 else 4, pe, "pitm")
            self.primary = _u16(b, q) if v == 0 else _u32(b, q)
        if b"iprp" in pending:
            self._parse_iprp(*pending[b"iprp"])
        if b"iref" in pending:
            self._parse_iref(*pending[b"iref"])

    def _item(self, iid):
        if iid not in self.items:
            self.items[iid] = _Item(iid)
        return self.items[iid]

    def _parse_iinf(self, s, e):
        b = self.data
        v, _, p = _full(b, s, e, None, "iinf")
        _need(p, 2 if v == 0 else 4, e, "iinf")
        count = _u16(b, p) if v == 0 else _u32(b, p)
        p += 2 if v == 0 else 4
        found = 0
        for typ, bs, be, _ in _boxes(b, p, e):
            if typ != b"infe":
                continue
            found += 1
            iv, _, q = _full(b, bs, be, (2, 3), "infe")
            _need(q, 8 if iv == 2 else 10, be, "infe")
            iid = _u16(b, q) if iv == 2 else _u32(b, q)
            q += 2 if iv == 2 else 4
            q += 2  # item_protection_index
            typ4 = bytes(b[q:q + 4])
            q += 4
            _string(b, q, be, "item name")
            item = self._item(iid)
            if item.type is not None:
                raise _Bad(f"a second infe for item {iid}")
            item.type = typ4  # libavif reads a hidden primary item too
        if found != count:
            raise _Bad(f"iinf lists {count} entries and holds {found}")

    def _parse_iloc(self, s, e):
        b = self.data
        v, _, p = _full(b, s, e, (0, 1, 2), "iloc")
        _need(p, 2, e, "iloc")
        osz, lsz, bsz = b[p] >> 4, b[p] & 15, b[p + 1] >> 4
        isz = (b[p + 1] & 15) if v in (1, 2) else 0
        for k in (osz, lsz, bsz, isz):
            if k not in (0, 4, 8):
                raise _Bad(f"iloc field size {k}")
        p += 2
        _need(p, 2 if v < 2 else 4, e, "iloc")
        count = _u16(b, p) if v < 2 else _u32(b, p)
        p += 2 if v < 2 else 4

        def rd(k):
            nonlocal p
            _need(p, k, e, "iloc")
            x = int.from_bytes(b[p:p + k], "big") if k else 0
            p += k
            return x

        seen = set()
        for _ in range(count):
            iid = rd(2 if v < 2 else 4)
            if iid in seen:
                raise _Bad(f"a second iloc entry for item {iid}")
            seen.add(iid)
            method = rd(2) & 15 if v in (1, 2) else 0
            if method not in (0, 1):
                raise _Bad(f"iloc construction method {method}")
            rd(2)  # data_reference_index, which libavif ignores
            base = rd(bsz)
            n_ext = rd(2)
            if n_ext == 0:
                raise _Bad(f"item {iid} without extents")
            ext = []
            for _ in range(n_ext):
                if isz:
                    rd(isz)
                off, length = rd(osz), rd(lsz)
                ext.append((method, base + off, length))
            self._item(iid).extents = ext

    def _parse_iprp(self, s, e):
        b = self.data
        boxes = list(_boxes(b, s, e))
        if not boxes or boxes[0][0] != b"ipco":
            raise _Bad("iprp without ipco first")
        props = []
        for typ, bs, be, _ in _boxes(b, boxes[0][1], boxes[0][2]):
            props.append((typ, _parse_property(typ, b, bs, be)))
        assoc = set()
        seen_ipma = set()
        for typ, bs, be, _ in boxes[1:]:
            if typ != b"ipma":
                raise _Bad(f"a {typ!r} box in iprp")
            v, flags, p = _full(b, bs, be, None, "ipma")
            if (v, flags) in seen_ipma:
                raise _Bad("a second ipma of the same version and flags")
            seen_ipma.add((v, flags))
            _need(p, 4, be, "ipma")
            count = _u32(b, p)
            p += 4
            for _ in range(count):
                k = 2 if v < 1 else 4
                _need(p, k + 1, be, "ipma")
                iid = int.from_bytes(b[p:p + k], "big")
                p += k
                if iid in assoc:
                    raise _Bad(f"item {iid} in a second ipma entry")
                assoc.add(iid)
                na = b[p]
                p += 1
                item = self._item(iid)
                for _ in range(na):
                    if flags & 1:
                        _need(p, 2, be, "ipma")
                        x = _u16(b, p)
                        p += 2
                        essential, idx = x >> 15, x & 0x7FFF
                    else:
                        _need(p, 1, be, "ipma")
                        essential, idx = b[p] >> 7, b[p] & 0x7F
                        p += 1
                    if idx == 0:
                        continue
                    if idx > len(props):
                        raise _Bad(f"ipma property index {idx} of {len(props)}")
                    ptype, pval = props[idx - 1]
                    if ptype in (b"a1op", b"lsel") and not essential:
                        raise _Bad(f"a non-essential {ptype!r}")
                    if ptype == b"a1lx" and essential:
                        raise _Bad("an essential a1lx")
                    if ptype in (b"irot", b"imir", b"clap") and not essential:
                        raise _Bad(f"a non-essential {ptype!r}")
                    if ptype == b"colr" and pval[0] in ("nclx", "icc") and any(
                            t == b"colr" and v[0] == pval[0] for t, v, _ in item.props):
                        raise _Bad(f"a second {pval[0]} colr on item {iid}")
                    if essential and ptype not in KNOWN_PROPERTIES:
                        item.unsupported_essential = True
                    item.props.append((ptype, pval, bool(essential)))

    def _parse_iref(self, s, e):
        b = self.data
        v, _, p = _full(b, s, e, (0, 1), "iref")
        k = 2 if v == 0 else 4
        for typ, bs, be, _ in _boxes(b, p, e):
            _need(bs, k + 2, be, "iref")
            src = int.from_bytes(b[bs:bs + k], "big")
            n = _u16(b, bs + k)
            q = bs + k + 2
            _need(q, n * k, be, "iref")
            dst = [int.from_bytes(b[q + i * k:q + (i + 1) * k], "big") for i in range(n)]
            item = self._item(src)
            if typ == b"auxl" and dst:
                item.aux_for = dst[0]
            elif typ == b"prem" and dst:
                item.premultiplied_by = dst[0]
            elif typ == b"cdsc" and dst:
                item.describes = dst[0]

    def item_data(self, item):
        b = self.data
        out = []
        for method, off, length in item.extents:
            if method == 1:
                if self.idat is None:
                    raise _Bad("an idat item without idat")
                s, e = self.idat
                if off + length > e - s:
                    raise _Bad("an idat extent past its box")
                out.append(bytes(b[s + off:s + off + length]))
            else:
                if off + length > len(b):
                    raise _Bad("Truncated data (an AVIF item extent past the end of the file)")
                out.append(bytes(b[off:off + length]))
        return b"".join(out)


def _validate(item, what_item):
    """libavif's avifDecoderItemValidateProperties with PIL's strict flags
    (none): an av1C, and a pixi (which may be absent) of the av1C's depth."""
    av1c = item.prop(b"av1C")
    if av1c is None:
        raise _Bad(f"{what_item} without av1C")
    pixi = item.prop(b"pixi")
    high, twelve = (av1c[2] >> 6) & 1, (av1c[2] >> 5) & 1
    depth = 12 if twelve else 10 if high else 8
    if pixi is not None:
        if pixi[0] != depth:
            raise _Bad(f"{what_item}: a pixi depth of {pixi[0]} and an av1C depth of {depth}")


def _check_exif(c, primary):
    """libavif's Exif checks (avifDecoderFindMetadata): the first Exif item
    describing the primary item holds a 4-byte offset that must point at
    its first TIFF header."""
    for it in c.items.values():
        if it.type != b"Exif" or it.describes != primary or it.extents is None:
            continue
        data = c.item_data(it)
        if len(data) < 4:
            raise _Fail("Invalid Exif payload")
        body = data[4:]
        for off in range(max(0, len(body) - 4)):
            if body[off:off + 4] in (b"MM\0*", b"II*\0"):
                break
        else:
            raise _Fail("an Exif item without a TIFF header")
        if _u32(data, 0) != off:
            raise _Fail("Invalid Exif payload")
        return


def parse(data):
    """The parse of ``data`` as far as libavif's avifDecoderParse: the
    primary item, its alpha item (or None), and the primary item's nclx
    colour (matrix, full range) or None. Raises ``_Bad``, or ``ValueError``
    for the forms the port does not read."""
    c = Container(data)
    item = c.items.get(c.primary) if c.primary is not None else None
    if item is None or item.type not in (b"av01", b"grid") or item.unsupported_essential:
        raise _Fail("Missing or empty image item")
    if item.type == b"grid":
        raise ValueError("an AVIF grid image (a primary item of type grid)")
    if item.extents is None or not sum(length for _, _, length in item.extents):
        raise _Fail("Missing or empty image item")
    ispe = item.prop(b"ispe")
    if ispe is None:
        raise _Bad("the primary item has no ispe")
    _validate(item, "the primary item")
    alpha = None
    for it in c.items.values():
        if (it.aux_for == c.primary and it.type in (b"av01", b"grid") and it.extents
                and it.prop(b"auxC") in ALPHA_URNS and not it.unsupported_essential):
            alpha = it
            break
    if alpha is not None:
        if alpha.type == b"grid":
            raise ValueError("an AVIF grid alpha item")
        if alpha.prop(b"ispe") is None:
            raise _Bad("the alpha item has no ispe")
        _validate(alpha, "the alpha item")
    for it in (item, alpha):
        if it is None:
            continue
        total = sum(length for method, _, length in it.extents if method == 0)
        if total > len(data):
            raise _Bad("an item larger than the file")
    w, h = ispe
    if w == 0 or h == 0 or w > IMAGE_DIMENSION_LIMIT or h > IMAGE_DIMENSION_LIMIT \
            or w * h > IMAGE_SIZE_LIMIT:
        raise _Bad(f"an ispe of {w} x {h}")
    _check_exif(c, c.primary)
    nclx = None
    for t, v, _ in item.props:
        if t == b"colr" and v[0] == "nclx":
            nclx = v
            break
    return c, item, alpha, nclx


def _native():
    from ..native.loader import load

    return load("av1")


def _decode_planes(obus, what, stats=None, size=None):
    """Decode the OBUs: (Y, U, V) and the header values; ``size`` (the
    item's ``ispe``), when given, must be the frame's, which is checked
    before the planes are allocated (libavif scales a frame of another
    size; the port refuses it)."""
    lib = _native()
    info = (ctypes.c_int32 * 20)()
    err = ctypes.create_string_buffer(256)
    if lib.akr_av1_probe(obus, len(obus), info, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    w, h, depth, mono, ssx, ssy = info[:6]
    if size is not None and (w, h) != tuple(size):
        raise ValueError(f"{what}: an AV1 frame of {w} x {h} in an AVIF item of "
                         f"{size[0]} x {size[1]}")
    y = np.zeros((h, w), np.uint8)
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    u = np.zeros((ch, cw), np.uint8)
    v = np.zeros((ch, cw), np.uint8)
    st = np.zeros(8, np.int64)
    if lib.akr_av1_decode(obus, len(obus), y.ctypes.data, u.ctypes.data, v.ctypes.data,
                          st.ctypes.data, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    if stats is not None:
        stats.update(zip(STAT_NAMES, st.tolist()))
    return (y, u, v), list(info)


def _parse_or_raise(data, what):
    try:
        return parse(data)
    except _Bad as e:
        raise NextFormat(f"{what}: not an AVIF file libavif parses ({e})") from None
    except (_Fail, ValueError) as e:
        raise ValueError(f"{what}: {e}") from None


def avif_header(data, what="image"):
    """libavif's parse of ``data`` as PIL's open runs it (a gate of
    ``core/image.py``): the (width, height) of the primary item's ``ispe``;
    ``NextFormat`` where PIL's open gives up on the file and goes on,
    ``ValueError`` where it fails."""
    _, item, _, _ = _parse_or_raise(data, what)
    return item.prop(b"ispe")


def _item_obus(c, item, what):
    try:
        return c.item_data(item)
    except _Bad as e:
        raise ValueError(f"{what}: {e}") from None


def avif_frame_info(data, what="image"):
    """The primary item's frame header values (``INFO_NAMES``), read from
    its OBUs without decoding the tiles."""
    c, item, _, _ = _parse_or_raise(data, what)
    obus = _item_obus(c, item, what)
    info = (ctypes.c_int32 * 20)()
    err = ctypes.create_string_buffer(256)
    if _native().akr_av1_probe(obus, len(obus), info, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    return dict(zip(INFO_NAMES, info))


def avif_planes(data, what="image", stats=None):
    """The primary item's decoded planes (Y, U, V as [H, W] uint8; U and V
    of the chroma size, zeros for a monochrome image), as dav1d gives them
    to libavif, and the frame's header values (``INFO_NAMES``); ``stats``,
    a dict, receives what the frame used (``STAT_NAMES``)."""
    c, item, _, _ = _parse_or_raise(data, what)
    planes, info = _decode_planes(_item_obus(c, item, what), what, stats)
    return planes, dict(zip(INFO_NAMES, info))


def _float_route(y, u, v, ssx, ssy, mode, full, kr, kb):
    """libavif's own YUV -> RGB (reformat.c, avifImageYUVAnyToRGBAnySlow and
    its 8-bit fast paths, which give the same bits): float32 lookups of
    (x - bias) / range, chroma upsampled bilinearly with weights 9, 3, 3, 1
    / 16 summed in that order (the column neighbour before the row
    neighbour; edge samples repeated), then R, G, B by the matrix's kr, kb
    (or identity, or YCgCo), clamped to [0, 1] and truncated from
    0.5 + 255 x."""
    f32 = np.float32
    i = np.arange(256, dtype=f32)
    if full:
        by, ry, buv, ruv = f32(0), f32(255), f32(128), f32(255)
    else:
        by, ry, buv, ruv = f32(16), f32(219), f32(128), f32(224)
    if mode == "identity":
        buv, ruv = by, ry
    ty, tuv = (i - by) / ry, (i - buv) / ruv
    h, w = y.shape
    yf = ty[y]
    if mode == "grey":
        return np.repeat((f32(0.5) + np.clip(yf, f32(0), f32(1)) * f32(255)).astype(np.uint8)[..., None],
                         3, axis=-1)
    jj, ii = np.arange(h)[:, None], np.arange(w)[None, :]
    cj, ci = jj >> ssy, ii >> ssx
    if ssx or ssy:
        adjc = np.where((ii == 0) | ((ii == w - 1) & (ii % 2 == 1)), 0, np.where(ii % 2 == 1, 1, -1))
        adjr = (np.where((jj == 0) | ((jj == h - 1) & (jj % 2 == 1)), 0,
                         np.where(jj % 2 == 1, 1, -1)) if ssy else np.zeros_like(jj))

        def up(p):
            return (tuv[p[cj, ci]] * f32(9 / 16) + tuv[p[cj, ci + adjc]] * f32(3 / 16)
                    + tuv[p[cj + adjr, ci]] * f32(3 / 16) + tuv[p[cj + adjr, ci + adjc]] * f32(1 / 16))

        cb, cr = up(u), up(v)
    else:
        cb, cr = tuv[u], tuv[v]
    if mode == "identity":
        g, b, r = yf, cb, cr
    elif mode == "ycgco":
        t = yf - cb
        g, b, r = yf + cb, t - cr, t + cr
    else:
        kr, kb = f32(kr), f32(kb)
        kg = f32(1) - kr - kb
        r = yf + (f32(2) * (f32(1) - kr)) * cr
        b = yf + (f32(2) * (f32(1) - kb)) * cb
        g = yf - ((f32(2) * ((kr * (f32(1) - kr) * cr) + (kb * (f32(1) - kb) * cb))) / kg)
    return np.stack([(f32(0.5) + np.clip(c, f32(0), f32(1)) * f32(255)).astype(np.uint8)
                     for c in (r, g, b)], -1)


def yuv_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, has_alpha, what="image"):
    """[H, W, 3] uint8 from 8-bit planes, as libavif 1.3.0's
    avifImageYUVToRGB gives them to PIL (RGB, or RGBA when the image has
    alpha): libyuv's fixed point for the matrices it has (BT.601 /
    BT.470BG / unspecified, BT.709, BT.2020 NCL; ``native/av1_decode.cpp``),
    libavif's float route for FCC, SMPTE 240M, IPT-C2 (BT.601's kr, kb),
    YCgCo (full range) and identity (4:4:4); a monochrome image's grey
    through libyuv's grey rows or that float route (which agree but for
    libyuv's BT.601 / BT.709 constants in an RGBA limited-range image).
    Other matrices raise ``ValueError`` (PIL's conversion fails on them, but
    for the chromaticity-derived one, which the port does not read)."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    name = f"{mc} ({_MATRIX_NAMES.get(mc, 'reserved')})"
    if mc == 12 and (not mono or (has_alpha and not full)):
        raise ValueError(f"{what}: the AVIF nclx matrix {name}, which the port does not convert")
    if mono:
        if mc not in _MONO_MATRICES or (mc == 8 and not full):
            raise ValueError(f"{what}: the AVIF nclx matrix {name} on a monochrome image")
        if full or not (has_alpha and mc in (0, 1, 2, 5, 6)):
            return _float_route(y, u, v, 0, 0, "grey", full, 0, 0)
        k = _LIBYUV[6][0]
    elif mc in _LIBYUV:
        k = _LIBYUV[mc][1 if full else 0]
    elif mc in _FLOAT_KRKB:
        return _float_route(y, u, v, ssx, ssy, "yuv", full, *_FLOAT_KRKB[mc])
    elif mc == 8 and full:
        return _float_route(y, u, v, ssx, ssy, "ycgco", full, 0, 0)
    elif mc == 0 and not ssx and not ssy:
        return _float_route(y, u, v, 0, 0, "identity", full, 0, 0)
    else:
        raise ValueError(f"{what}: the AVIF nclx matrix {name}"
                         + (" on subsampled chroma" if mc == 0 else "")
                         + (" at limited range" if mc == 8 else ""))
    rgb = np.zeros((h, w, 3), np.uint8)
    _native().akr_yuv_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, ssx, ssy,
                             mono, (ctypes.c_int32 * 6)(*k), rgb.ctypes.data)
    return rgb


def unpremultiply(rgb, alpha):
    """libavif's un-premultiplication of 8-bit RGBA (libyuv's
    ARGBUnattenuate as its AVX2 row runs it): c * 257 * (65536 / a) >> 16
    in 16-bit lanes (a result of 32768 or more packs to 0), 255 at most;
    a = 255 leaves the colour, a = 0 makes it black."""
    a = alpha.astype(np.int64)[..., None]
    inv = np.array([0, 0xFFFF] + [0x10000 // k for k in range(2, 256)], np.int64)
    v = (rgb.astype(np.int64) * 257 * inv[a]) >> 16
    v = np.where(v >= 32768, 0, np.minimum(v, 255))
    v = np.where(a == 255, rgb, np.where(a == 0, 0, v))
    return v.astype(np.uint8)


def decode_avif(data, what="image"):
    """AVIF file bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")``."""
    c, item, alpha, nclx = _parse_or_raise(data, what)
    w, h = item.prop(b"ispe")
    _check_size(w, h, what, "AVIF")
    note_mode("RGBA" if alpha is not None else "RGB")
    (y, u, v), info = _decode_planes(_item_obus(c, item, what), what, size=(w, h))
    _, _, _, mono, ssx, ssy, full, cp, tc, mc = info[:10]
    if nclx is not None:
        _, cp, tc, mc, full = nclx
    rgb = yuv_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, alpha is not None, what)
    if alpha is not None:
        (a, _, _), ainfo = _decode_planes(_item_obus(c, alpha, what), what, size=(w, h))
        if item.premultiplied_by == alpha.id:
            if not ainfo[6]:  # libavif's avifLimitedToFullY
                a = np.clip(((a.astype(np.int64) - 16) * 255 / 219).astype(np.int64), 0, 255)
            rgb = unpremultiply(rgb, a)
    return rgb
