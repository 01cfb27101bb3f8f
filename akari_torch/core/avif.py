"""AVIF decoding without PIL: a still image's primary AV1 item, a ``grid``
of them, or frame 0 of an ``avis`` sequence, as PIL 12.1.0 reads it
through libavif 1.3.0 (``Image.open(path).convert("RGB")``).

``decode_avif`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")``. Where libavif's parse (``avifDecoderParse``, PIL's
open) fails with a result PIL raises as ``SyntaxError`` (an invalid
``ftyp``, a failed BMFF parse, truncated data), it raises ``NextFormat``,
and ``decode_image`` goes on to the formats after AVIF as ``Image.open``
does; where PIL's open or load fails otherwise, ``ValueError``:

- the container (ISO BMFF / HEIF, as libavif parses it): ``ftyp`` first,
  with an ``avif`` or ``avis`` brand; the source libavif picks by default
  (the major brand's: ``avif`` the items, ``avis`` the tracks; another
  major brand the tracks where there are any); one ``meta`` (version 0,
  ``hdlr`` ``pict`` first with a zero ``pre_defined`` and a terminated
  name; ``pitm``, ``iinf`` / ``infe`` v2-3, ``iloc`` v0-2 with
  construction methods 0 and 1 (``idat``), ``iref`` (v0-1; others
  skipped), ``iprp`` of ``ipco`` then ``ipma`` boxes only, each once;
  boxes inside their parents; item ID 0 refused); the properties
  ``av1C``, ``ispe`` (every image item's checked), ``pixi`` (optional:
  PIL runs libavif without its strict checks; one depth for every plane,
  that of the ``av1C``), ``colr`` (one nclx, with zero reserved bits, and
  one ICC profile, which PIL's ``convert`` does not apply; without an
  nclx, libavif reads the colour item's sequence header at parse),
  ``auxC`` (the alpha URNs), ``irot`` / ``imir`` / ``clap`` (each
  essential; PIL turns the first two into an EXIF orientation and applies
  none of them to the pixels) and ``pasp``; an item with an unknown
  essential property is skipped; an Exif item's TIFF-header offset;
  libavif's size limits and PIL's pixel limit;
- ``grid`` items (libavif's ImageGrid: version 0, 16- or 32-bit output
  size, tiles in ``dimg`` order, of one av1C, size, depth, subsampling and
  range, at least 64 x 64, even where chroma is subsampled, covering the
  output without a row or column past it), composed as libavif composes
  them and cropped to the output size, for the colour and the alpha; a
  grid whose ``ispe`` is not its output size is read as PIL reads it;
- ``avis`` tracks (``moov`` / ``trak``: ``tkhd``, ``edts`` / ``elst``,
  ``tref`` ``auxl`` / ``prem``, ``mdia`` / ``mdhd`` / ``hdlr``, ``stbl``
  with ``stsd`` (the ``av01`` entry's ``av1C``, ``colr``, ``auxi``),
  ``stco`` / ``co64``, ``stsc``, ``stsz``, ``stss``, ``stts``), every
  sample laid out as libavif lays it out, sample 0 of the colour track
  and of its alpha track decoded;
- the AV1 OBUs, decoded by ``native/av1_decode.cpp`` (bit for bit dav1d
  1.5.1's planes, uint8 at 8 bits and uint16 at 10 and 12, film grain
  applied; segmentation, delta q / lf, intra block copy and superres with
  loop restoration among the tools; a key frame hidden in a sequence's
  sample 0 and shown by ``show_existing_frame``; a sample whose shown frame
  is an inter or intra-only frame decoded through the frames before it:
  motion vector prediction with temporal candidates, compound and
  inter-intra masks, OBMC, local and global warps, the dual filters), and
  the alpha's, which decides PIL's mode
  (``RGBA``) and, for a premultiplied image (``prem``), is divided out of
  the colour as libavif does (``unpremultiply``);
- a frame, alpha plane or track whose size differs from its ``ispe`` or
  ``tkhd``, scaled to it as libavif's avifImageScale does (libyuv's
  ScalePlane, or ScalePlane_16 above 8 bits, with the box filter,
  ``scale_plane``; a source side over 16384 refused, an alpha plane then
  not the colour's size failing the decode);
- YUV -> RGB as ``avifImageYUVToRGB`` runs it (``yuv_to_rgb``): libyuv's
  fixed point for BT.601 / BT.470BG / unspecified, BT.709 and BT.2020 NCL
  with its bilinear chroma upsampling, libavif's float route for FCC,
  SMPTE 240M, IPT-C2, the chromaticity-derived matrix 12 (kr, kb from the
  primaries), YCgCo (full range) and identity (4:4:4), either range; the
  nclx of the ``colr`` property, else the sequence header's; at 10 and 12
  bits libavif's routes to PIL's 8-bit pixels (``yuv_to_rgb_alpha``: the
  planes shifted to 8 bits for libyuv's 8-bit rows, libyuv's own 10-bit
  and 12-bit rows for some RGBA images, libavif's float route at the
  planes' depth), the alpha reduced to 8 bits as each route reduces it.

The 10- and 12-bit, superres, hidden-frame, intra-only and inter-frame-0
files are made here by header rewrites of PIL's writer's files
(``tools/av1_rewrite.py``: ``splice_frames`` puts the frames of samples 1
to n - 1 of a sequence into sample 0 behind its hidden key frame).
Refused with a ``ValueError`` naming the form (``ROADMAP.md``, slice 27):
a palette above 8 bits; switch frames, frame ids on an inter frame and
references of another size (scaled prediction, superres on an inter
frame); the inter tools no file made here holds (segment ids predicted
from the previous map, a frame size taken from a reference,
frame_refs_short_signaling, error-resilient inter frames, global motion of
type TRANSLATION); a hidden key frame no later frame may show, a sample
whose frames are all hidden, and AV1 streams whose transforms leave the
range the specification requires (dav1d's x86 assembly, which PIL runs,
saturates its lanes there). An inter frame whose reference slots hold no
frame fails, as it does in PIL; a sequence header that differs from the
one before it empties every slot first, as dav1d does.
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
# libavif's colour primaries (colr.c: rx, ry, gx, gy, bx, by, wx, wy, as
# float32), by the nclx value; BT.709's for any other
_PRIMARIES = {1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.329),
              4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
              5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.329),
              6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.329),
              7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.329),
              8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
              9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.329),
              10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
              11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
              12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.329),
              22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.329)}


def chroma_derived_krkb(cp):
    """kr, kb of the chromaticity-derived non-constant-luminance matrix (nclx
    matrix 12) from the colour primaries, in float32 in the order libavif's
    avifCalcYUVCoefficients computes them (H.273 equations 32-37)."""
    rx, ry, gx, gy, bx, by, wx, wy = (np.float32(v) for v in _PRIMARIES.get(cp, _PRIMARIES[1]))
    one = np.float32(1)
    rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), one - (wx + wy)
    with np.errstate(all="ignore"):
        den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) + bx * (ry * gz - gy * rz))
        kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                    + wz * (gx * by - bx * gy))) / den
        kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                    + wz * (rx * gy - gx * ry))) / den
    return kr, kb


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
              "screen_content", "tile_cols", "tile_rows", "lossless", "lf_levels", "base_q_idx",
              "qm_levels", "cdef_strengths", "lr_types", "film_grain", "segmentation", "delta_q",
              "delta_lf", "intrabc", "superres_denom", "hidden")
STAT_NAMES = ("blocks", "palette_y", "palette_uv", "filter_intra", "cfl", "tx_split",
              "tx_type_not_dct", "angle_delta", "segmented_blocks", "delta_q_superblocks",
              "intrabc_blocks")
# and the filters the frame ran: 8x8 blocks CDEF changed, stripes of
# restoration units filtered, planes given film grain
FILTER_NAMES = ("cdef_blocks", "lr_stripes", "grain_planes")
# and the inter frames' tools (counts over every frame of the sample): inter
# blocks, intra blocks of inter frames, skip-mode blocks, compound blocks by
# type,
# OBMC blocks, local and global warps (luma predictions), inter-intra
# (smooth masks, wedges), temporal candidates used, blocks of two filters,
# NEWMV modes, chroma predicted from several luma blocks, frames decoded,
# intra-only frames, film grain loaded from a reference, GLOBALMV blocks of
# a global motion, palettes in inter frames, lossless inter blocks
INTER_NAMES = ("inter_blocks", "intra_in_inter", "skip_mode", "compound_average",
               "compound_distance", "compound_wedge", "compound_diffwtd", "obmc", "local_warp",
               "global_warp", "interintra", "interintra_wedge", "temporal_mvs", "dual_filter",
               "new_mv", "sub8x8_chroma", "frames", "intra_only_frames", "grain_loaded",
               "global_mv", "palette_in_inter", "lossless_inter")


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
        self.dimg_for = None  # the grid this item is a tile of, and its place
        self.dimg_idx = None
        self.grid = None      # a grid item's (rows, columns, width, height, tiles)
        self.thumbnail_for = None
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


class _Track:
    def __init__(self):
        self.id = 0
        self.width = self.height = 0
        self.duration = 0
        self.aux_for = self.prem_by = None
        self.timescale = 0
        self.has_stbl = False
        self.chunks, self.stsc, self.sizes, self.descriptions = [], [], [], []
        self.all_size = 0
        self.repeating = False
        self.segment_duration = 0

    def usable(self):
        """libavif's test of a track it may read: a sample table with
        chunks, a nonzero id and an av01 sample entry."""
        return (self.has_stbl and self.id and self.chunks
                and any(f == b"av01" for f, _ in self.descriptions))


class Container:
    """The parse of an AVIF file, as far as libavif's avifDecoderParse goes."""

    def __init__(self, data):
        self.data = data
        self.items = {}
        self.primary = None
        self.idat = None
        self.tracks = []
        self.sequence = False  # libavif reads the tracks (frame 0), not the items
        self._parse()

    def _parse(self):
        b = self.data
        n = len(b)
        seen_ftyp = meta = moov = None
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
                continue
            if typ == b"meta":
                if meta is not None:
                    raise _Bad("a second meta box")
                if cut:
                    raise _Bad("a truncated meta box")
                meta = (s, e)
            elif typ == b"moov":
                if moov is not None:
                    raise _Bad("a second moov box")
                if cut:
                    raise _Bad("a truncated moov box")
                moov = (s, e)
            # libavif stops at the last box its brands need (meta for avif,
            # moov for avis): boxes after it are not read
            if ((meta is not None or b"avif" not in seen_ftyp)
                    and (moov is not None or b"avis" not in seen_ftyp)):
                break
        if seen_ftyp is None:
            raise _Bad("no ftyp")
        if b"avis" in seen_ftyp and moov is None:
            raise _Bad("an avis file without tracks")
        if b"avif" in seen_ftyp and meta is None:
            raise _Bad("no meta box")
        if meta is not None:
            self._parse_meta(*meta)
        if moov is not None:
            self._parse_moov(*moov)
        # libavif's source (AVIF_DECODER_SOURCE_AUTO): the major brand's, else
        # the tracks where there are any
        major = seen_ftyp[0]
        self.sequence = major == b"avis" or (major != b"avif" and bool(self.tracks))

    # ---- tracks (libavif's avifParseMovieBox and what it holds)

    def _parse_moov(self, s, e):
        b = self.data
        for typ, bs, be, _ in _boxes(b, s, e):
            if typ == b"trak":  # (libavif reads no field of mvhd that PIL uses)
                self.tracks.append(self._parse_trak(bs, be))

    def _parse_trak(self, s, e):
        b = self.data
        t = _Track()
        seen = set()
        for typ, bs, be, _ in _boxes(b, s, e):
            if typ in (b"tkhd", b"edts"):
                if typ in seen:
                    raise _Bad(f"a second {typ!r} in trak")
                seen.add(typ)
            if typ == b"tkhd":
                v, _, p = _full(b, bs, be, (0, 1), "tkhd")
                k = 8 if v == 1 else 4
                _need(p, 3 * k + 8 + 52 + 8, be, "tkhd")
                t.id = _u32(b, p + 2 * k)
                t.duration = int.from_bytes(b[p + 2 * k + 8:p + 3 * k + 8], "big")
                q = p + 3 * k + 8 + 52
                t.width, t.height = _u32(b, q) >> 16, _u32(b, q + 4) >> 16
                if t.width == 0 or t.height == 0:
                    raise _Bad(f"track {t.id} of size {t.width} x {t.height}")
                if (t.width > IMAGE_DIMENSION_LIMIT or t.height > IMAGE_DIMENSION_LIMIT
                        or t.width * t.height > IMAGE_SIZE_LIMIT):
                    raise _Bad(f"track {t.id} of {t.width} x {t.height}")
            elif typ == b"mdia":
                self._parse_mdia(t, bs, be)
            elif typ == b"tref":
                for rt, rs, re_, _ in _boxes(b, bs, be):
                    if rt in (b"auxl", b"prem"):
                        _need(rs, 4, re_, "tref")
                        if rt == b"auxl":
                            t.aux_for = _u32(b, rs)
                        else:
                            t.prem_by = _u32(b, rs)
            elif typ == b"edts":
                self._parse_edts(t, bs, be)
        if b"tkhd" not in seen:
            raise _Bad("trak without tkhd")
        if t.repeating and t.duration != 0xFFFFFFFF and t.segment_duration == 0:
            raise _Bad("an edit list of a zero segment duration")
        return t

    def _parse_edts(self, t, s, e):
        b = self.data
        elst = False
        for typ, bs, be, _ in _boxes(b, s, e):
            if typ != b"elst":
                continue
            if elst:
                raise _Bad("a second elst")
            elst = True
            v, flags, p = _full(b, bs, be, None, "elst")
            if not flags & 1:
                continue
            t.repeating = True
            _need(p, 4, be, "elst")
            if _u32(b, p) != 1:
                raise _Bad("an elst of other than one entry")
            if v not in (0, 1):
                raise _Bad(f"elst version {v}")
            k = 8 if v == 1 else 4
            _need(p + 4, 2 * k, be, "elst")
            t.segment_duration = int.from_bytes(b[p + 4:p + 4 + k], "big")
        if not elst:
            raise _Bad("edts without elst")

    def _parse_mdia(self, t, s, e):
        b = self.data
        for typ, bs, be, _ in _boxes(b, s, e):
            if typ == b"mdhd":
                v, _, p = _full(b, bs, be, (0, 1), "mdhd")
                _need(p, 28 if v == 1 else 16, be, "mdhd")
                t.timescale = _u32(b, p + (16 if v == 1 else 8))
            elif typ == b"hdlr":  # checked as meta's is; any handler type
                _, _, q = _full(b, bs, be, (0,), "hdlr")
                _need(q, 20, be, "hdlr")
                if _u32(b, q) != 0:
                    raise _Bad("a track hdlr with a nonzero pre_defined")
                _string(b, q + 20, be, "hdlr name")
            elif typ == b"minf":
                for mt, ms, me, _ in _boxes(b, bs, be):
                    if mt == b"stbl":
                        if t.has_stbl:
                            raise _Bad("a second stbl in a track")
                        t.has_stbl = True
                        self._parse_stbl(t, ms, me)

    def _parse_stbl(self, t, s, e):
        b = self.data

        def table(bs, be, what, width):
            _, _, p = _full(b, bs, be, (0,), what)
            _need(p, 4, be, what)
            n = _u32(b, p)
            _need(p + 4, n * width, be, what)
            return p + 4, n

        for typ, bs, be, _ in _boxes(b, s, e):
            if typ in (b"stco", b"co64"):
                k = 4 if typ == b"stco" else 8
                p, n = table(bs, be, typ.decode(), k)
                t.chunks = [int.from_bytes(b[p + i * k:p + (i + 1) * k], "big") for i in range(n)]
            elif typ == b"stsc":
                p, n = table(bs, be, "stsc", 12)
                t.stsc = [struct.unpack_from(">3I", b, p + 12 * i)[:2] for i in range(n)]
                for i, (first, _) in enumerate(t.stsc):
                    if (i == 0 and first != 1) or (i and first <= t.stsc[i - 1][0]):
                        raise _Bad("stsc entries out of order")
            elif typ == b"stsz":
                _, _, p = _full(b, bs, be, (0,), "stsz")
                _need(p, 8, be, "stsz")
                t.all_size, n = _u32(b, p), _u32(b, p + 4)
                if t.all_size == 0:
                    _need(p + 8, 4 * n, be, "stsz")
                    t.sizes = list(struct.unpack_from(f">{n}I", b, p + 8))
            elif typ == b"stss":
                table(bs, be, "stss", 4)
            elif typ == b"stts":
                table(bs, be, "stts", 8)
            elif typ == b"stsd":
                _, _, p = _full(b, bs, be, (0,), "stsd")
                _need(p, 4, be, "stsd")
                count = _u32(b, p)
                entries = _boxes(b, p + 4, be)
                for _ in range(count):
                    fmt, fs, fe, _ = next(entries, (None,) * 4)
                    if fmt is None:
                        raise _Bad(f"stsd of {count} entries holds fewer")
                    props = []
                    if fe - fs > 78:  # a VisualSampleEntry, then its boxes
                        for pt, ps, pe, _ in _boxes(b, fs + 78, fe):
                            if pt == b"auxi":  # the auxiliary type, as auxC holds it
                                _, _, q = _full(b, ps, pe, (0,), "auxi")
                                props.append((b"auxC", _string(b, q, pe, "auxi")[0]))
                            else:
                                props.append((pt, _parse_property(pt, b, ps, pe)))
                    t.descriptions.append((fmt, props))

    def track_samples(self, t):
        """libavif's avifCodecDecodeInputFillFromSampleTable: (offset, size)
        of every sample, chunk by chunk."""
        out = []
        k = 0
        for ci, off in enumerate(t.chunks):
            count = 0
            for first, per in reversed(t.stsc):
                if first <= ci + 1:
                    count = per
                    break
            if count == 0:
                raise _Bad("a chunk of no samples")
            for _ in range(count):
                if t.all_size:
                    size = t.all_size
                else:
                    if k >= len(t.sizes):
                        raise _Bad("Truncated sample table")
                    size = t.sizes[k]
                if size == 0:
                    raise _Bad("a sample of 0 bytes")
                if off + size > len(self.data):
                    raise _Bad("a sample past the end of the file")
                out.append((off, size))
                off += size
                k += 1
        return out

    def track_item(self, t):
        """A track as an item: sample 0 for its data, the av01 sample
        entry's properties and the track header's size for its ispe."""
        item = _Item(t.id)
        item.type = b"av01"
        item.extents = [(0, *self.track_samples(t)[0])]
        props = next(p for f, p in t.descriptions if f == b"av01")
        item.props = [(pt, pv, False) for pt, pv in props] + [(b"ispe", (t.width, t.height), False)]
        item.premultiplied_by = t.prem_by
        return item

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
        if iid == 0:
            raise _Bad("an item ID of 0")
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

        for _ in range(count):
            iid = rd(2 if v < 2 else 4)
            if self._item(iid).extents:  # a second entry may follow one of no extents
                raise _Bad(f"a second iloc entry for item {iid}")
            method = rd(2) & 15 if v in (1, 2) else 0
            if method not in (0, 1):
                raise _Bad(f"iloc construction method {method}")
            rd(2)  # data_reference_index, which libavif ignores
            base = rd(bsz)
            n_ext = rd(2)
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
                    if idx == 0:  # no property; libavif's parse fails on an essential one
                        if essential:
                            raise _Bad(f"item {iid} with an essential property index 0")
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
        v, _, p = _full(b, s, e, None, "iref")
        if v > 1:  # libavif skips an iref of another version
            return
        k = 2 if v == 0 else 4
        for typ, bs, be, _ in _boxes(b, p, e):
            _need(bs, k + 2, be, "iref")
            src = int.from_bytes(b[bs:bs + k], "big")
            n = _u16(b, bs + k)
            q = bs + k + 2
            _need(q, n * k, be, "iref")
            if q + n * k != be:  # libavif reads the next reference box from there
                raise _Bad(f"an iref {typ!r} box of {be - q - n * k} more bytes than its ids")
            dst = [int.from_bytes(b[q + i * k:q + (i + 1) * k], "big") for i in range(n)]
            if 0 in dst:
                raise _Bad(f"an iref {typ!r} to item ID 0")
            item = self._item(src)
            if typ == b"auxl" and dst:
                item.aux_for = dst[0]
            elif typ == b"prem" and dst:
                item.premultiplied_by = dst[0]
            elif typ == b"cdsc" and dst:
                item.describes = dst[0]
            elif typ == b"thmb" and dst:
                item.thumbnail_for = dst[0]
            elif typ == b"dimg":  # a derived image's inputs: the reference points back
                for idx, d in enumerate(dst):
                    tile = self._item(d)
                    tile.dimg_for, tile.dimg_idx = src, idx

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
    (none): an av1C, and a pixi (which may be absent) of the av1C's depth.
    A grid has no av1C of its own (its tiles are checked as they are
    read)."""
    if item.type == b"grid":
        return
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
    _check_items(c)
    if c.sequence:
        return _parse_tracks(c)
    item = c.items.get(c.primary) if c.primary is not None else None
    if item is None or item.type not in (b"av01", b"grid") or item.unsupported_essential:
        raise _Fail("Missing or empty image item")
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
        if alpha.prop(b"ispe") is None:
            raise _Bad("the alpha item has no ispe")
        _validate(alpha, "the alpha item")
    for it in (item, alpha):
        if it is not None and it.type == b"grid":
            it.grid = _grid(c, it)
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
    if nclx is None:
        _sequence_header_walk(c, item.grid[4][0] if item.grid else item)
    return c, item, alpha, nclx


def _sequence_header_walk(c, item):
    """Without an nclx colr libavif reads the colour item's data at parse
    for its AV1 sequence header. Of an item that runs past the end of the
    file, the OBUs the file holds must lead to a sequence header, or the
    parse ends (``_Bad``); an item the file holds whole is left to the
    decode."""
    b = c.data
    parts, want = [], 0
    for method, off, length in item.extents:
        want += length
        if method == 1:
            s, e = c.idat if c.idat is not None else (0, 0)
            parts.append(bytes(b[s + off:min(s + off + length, e)]))
        else:
            parts.append(bytes(b[off:off + length]))
    d = b"".join(parts)
    if len(d) == want:
        return
    pos = 0
    while pos < len(d):
        h = d[pos]
        pos += 1 + ((h >> 2) & 1)
        size = len(d) - pos
        if h & 2:
            size = shift = 0
            while True:
                if pos >= len(d) or shift > 49:
                    size = -1
                    break
                size |= (d[pos] & 0x7F) << shift
                shift += 7
                pos += 1
                if not d[pos - 1] & 0x80:
                    break
        if size < 0 or pos > len(d) or size > len(d) - pos:
            break
        if (h >> 3) & 15 == 1:
            body = d[pos:pos + size]
            err = ctypes.create_string_buffer(256)
            if _native().akr_av1_sequence_header(body, len(body), err, 256) == 0:
                return
            break
        pos += size
    raise _Bad("Truncated data (the colour item runs past the end of the file before its "
               "sequence header)")


def _check_items(c):
    """avifDecoderParse's check of every image item it would not skip (an
    av01 or grid item with data, no unknown essential property, not a
    thumbnail), whichever source it then reads: an ispe of a size within
    the limits, which only an alpha item may lack."""
    for it in c.items.values():
        if (it.type not in (b"av01", b"grid") or not it.extents or it.unsupported_essential
                or it.thumbnail_for is not None
                or not sum(length for _, _, length in it.extents)):
            continue
        ispe = it.prop(b"ispe")
        if ispe is None:
            if it.prop(b"auxC") not in ALPHA_URNS:
                raise _Bad(f"item {it.id} has no ispe")
        elif (ispe[0] == 0 or ispe[1] == 0 or max(ispe) > IMAGE_DIMENSION_LIMIT
                or ispe[0] * ispe[1] > IMAGE_SIZE_LIMIT):
            raise _Bad(f"item {it.id} of {ispe[0]} x {ispe[1]}")


def _parse_tracks(c):
    """libavif's tracks source: the first usable track that is no other's
    auxiliary is the colour, a usable track auxiliary to it the alpha (unless
    its auxi names another auxiliary type); each read from its sample 0."""
    # the meta's primary item, where there is one, needs its av1C all the same
    primary = c.items.get(c.primary) if c.primary is not None else None
    if (primary is not None and primary.type == b"av01" and not primary.unsupported_essential
            and primary.extents and sum(length for _, _, length in primary.extents)):
        if primary.prop(b"av1C") is None:
            raise _Bad("the primary item without av1C")
    color = next((t for t in c.tracks if t.usable() and not t.aux_for), None)
    if color is None:
        raise _Bad("no AV1 colour track")
    alpha = None
    for t in c.tracks:
        if t.usable() and t.aux_for == color.id:
            alpha = t
            break
    if alpha is not None:  # an auxi of another auxiliary type: no alpha
        aux = next((v for t, v in next(p for f, p in alpha.descriptions if f == b"av01")
                    if t == b"auxC"), None)
        if aux is not None and aux not in ALPHA_URNS:
            alpha = None
    item = c.track_item(color)
    _validate(item, "the colour track")
    alpha_item = None
    if alpha is not None:
        alpha_item = c.track_item(alpha)
        _validate(alpha_item, "the alpha track")
    if not color.timescale:  # PIL divides the frame's timestamp by it
        raise _Fail("division by zero (a colour track of no media timescale)")
    nclx = next((v for t, v, _ in item.props if t == b"colr" and v[0] == "nclx"), None)
    return c, item, alpha_item, nclx


def _grid(c, item):
    """The ImageGrid of a grid item (libavif's avifParseImageGridBox) and its
    tiles in ``dimg`` order, as libavif's parse checks them: (rows, columns,
    output width, output height, tiles). A bad grid box, a missing tile or
    a tile without av1C fails the open (``_Fail``); a tile's av1C whose
    fixed fields differ from the first tile's, or a tile libavif's item
    checks refuse, ends the parse (``_Bad``)."""
    b = c.item_data(item)
    if len(b) < 4 or b[0] != 0:
        raise _Fail(f"Invalid image grid (version {b[0] if b else None} or truncated)")
    rows, cols = b[2] + 1, b[3] + 1
    k = 4 if b[1] & 1 else 2
    if len(b) != 4 + 2 * k:
        raise _Fail(f"Invalid image grid (a grid box of {len(b)} bytes)")
    ow, oh = int.from_bytes(b[4:4 + k], "big"), int.from_bytes(b[4 + k:4 + 2 * k], "big")
    if (ow == 0 or oh == 0 or ow > IMAGE_DIMENSION_LIMIT or oh > IMAGE_DIMENSION_LIMIT
            or ow * oh > IMAGE_SIZE_LIMIT):
        raise _Fail(f"Invalid image grid (an output of {ow} x {oh})")
    tiles = []
    for idx in range(rows * cols):
        tile = next((it for it in c.items.values()
                     if it.dimg_for == item.id and it.dimg_idx == idx), None)
        if tile is None:
            raise _Fail(f"Invalid image grid ({rows} x {cols} without its tile {idx})")
        tiles.append(tile)
    for tile in tiles:
        if tile.type != b"av01":
            raise _Fail(f"Invalid image grid (a tile of type {tile.type!r})")
        if not tile.extents or not sum(length for _, _, length in tile.extents):
            raise _Bad("a grid tile without data")
        if sum(length for method, _, length in tile.extents if method == 0) > len(c.data):
            raise _Bad("a grid tile larger than the file")
        if tile.prop(b"ispe") is None:
            raise _Bad("a grid tile without ispe")
        if tile.prop(b"av1C") is None:
            raise _Fail("Invalid image grid (a tile without av1C)")
        _validate(tile, "a grid tile")
        if tile.prop(b"av1C")[1:3] != tiles[0].prop(b"av1C")[1:3]:
            raise _Bad("grid tiles of different av1C")
    return rows, cols, ow, oh, tiles


def _image_planes(c, item, what, size=None):
    """An image item's planes and header values: its AV1 frame at the
    size of its ``ispe`` (or ``size``), or a grid's tiles placed and cropped
    to the grid's output size as libavif composes them (tiles of one size,
    depth, subsampling and range, at least 64 x 64, even where chroma is
    subsampled, covering the output without a row or column past it)."""
    if item.type != b"grid":
        return _decode_planes(_item_obus(c, item, what), what, size=size or item.prop(b"ispe"))
    rows, cols, ow, oh, tiles = item.grid
    decoded = [_decode_planes(_item_obus(c, t, what), what, size=t.prop(b"ispe"))
               for t in tiles]
    (y0, _, _), info = decoded[0]
    th, tw = y0.shape
    mono, ssx, ssy = info[3:6]
    for _, inf in decoded:
        if inf[:7] != info[:7]:
            raise ValueError(f"{what}: Invalid image grid (mismatched tiles)")
    if tw * cols < ow or th * rows < oh or tw * (cols - 1) >= ow or th * (rows - 1) >= oh:
        raise ValueError(f"{what}: Invalid image grid (tiles of {tw} x {th} do not fit a "
                         f"{cols} x {rows} grid of {ow} x {oh})")
    if tw < 64 or th < 64:
        raise ValueError(f"{what}: Invalid image grid (tiles of {tw} x {th}, under 64)")
    if not mono and ((ssx and (ow % 2 or tw % 2)) or (ssy and (oh % 2 or th % 2))):
        raise ValueError(f"{what}: Invalid image grid (odd sizes with subsampled chroma)")
    cw, ch = (ow + ssx) >> ssx, (oh + ssy) >> ssy
    out = [np.zeros((oh, ow), y0.dtype), np.zeros((ch, cw), y0.dtype),
           np.zeros((ch, cw), y0.dtype)]
    for k, (planes, _) in enumerate(decoded):
        r, col = divmod(k, cols)
        for p, pl in enumerate(planes):
            sx, sy = (ssx, ssy) if p else (0, 0)
            y, x = (r * th) >> sy, (col * tw) >> sx
            dst = out[p][y:y + pl.shape[0], x:x + pl.shape[1]]
            dst[...] = pl[:dst.shape[0], :dst.shape[1]]
    return out, info


def _native():
    from ..native.loader import load

    return load("av1")


def scale_plane(p, width, height):
    """libyuv's ScalePlane with the box filter, as libavif's avifImageScale
    runs it (``akr_scale_plane``): an [H, W] uint8 plane to [height, width];
    a uint16 plane (a high bit depth's) through ScalePlane_16
    (``akr_scale_plane16``)."""
    wide = np.asarray(p).dtype == np.uint16
    dt = np.uint16 if wide else np.uint8
    p = np.ascontiguousarray(p, dt)
    out = np.zeros((height, width), dt)
    fn = _native().akr_scale_plane16 if wide else _native().akr_scale_plane
    fn(p.ctypes.data, p.shape[1], p.shape[0], out.ctypes.data, width, height)
    return out


def _decode_planes(obus, what, stats=None, size=None, filters=None):
    """Decode the OBUs: (Y, U, V: uint8 at 8 bits, uint16 above) and the
    header values; ``size`` (the item's ``ispe`` or the track's ``tkhd``
    size), when given and not the frame's, is the size libavif scales the
    planes to (avifImageScale: a frame more than 16384 wide or high it
    refuses, which is checked before the planes are allocated)."""
    lib = _native()
    info = (ctypes.c_int32 * len(INFO_NAMES))()
    err = ctypes.create_string_buffer(256)
    if lib.akr_av1_probe(obus, len(obus), info, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    w, h, depth, mono, ssx, ssy = info[:6]
    scale = size is not None and (w, h) != tuple(size)
    if scale and (w > 16384 or h > 16384):
        raise ValueError(f"{what}: libavif does not scale an AV1 frame of {w} x {h} to its item's "
                         f"{size[0]} x {size[1]} (a side over 16384)")
    y = np.zeros((h, w), np.uint16)
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    u = np.zeros((ch, cw), np.uint16)
    v = np.zeros((ch, cw), np.uint16)
    st = np.zeros(len(STAT_NAMES) + len(FILTER_NAMES) + len(INTER_NAMES), np.int64)
    if lib.akr_av1_decode(obus, len(obus), y.ctypes.data, u.ctypes.data, v.ctypes.data,
                          st.ctypes.data, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    if depth == 8:
        y, u, v = (p.astype(np.uint8) for p in (y, u, v))
    if stats is not None:
        stats.update(zip(STAT_NAMES, st.tolist()))
        stats.update(zip(INTER_NAMES, st[len(STAT_NAMES) + len(FILTER_NAMES):].tolist()))
    if filters is not None:
        filters.update(zip(FILTER_NAMES, st[len(STAT_NAMES):].tolist()))
    info = list(info)
    if scale:
        sw, sh = size
        cw, ch = (sw + ssx) >> ssx, (sh + ssy) >> ssy
        y = scale_plane(y, sw, sh)
        u, v = ((np.zeros((ch, cw), y.dtype),) * 2 if mono else
                (scale_plane(u, cw, ch), scale_plane(v, cw, ch)))
        info[:2] = sw, sh
    return (y, u, v), info


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
    if item.type == b"grid":
        item = item.grid[4][0]
    obus = _item_obus(c, item, what)
    info = (ctypes.c_int32 * len(INFO_NAMES))()
    err = ctypes.create_string_buffer(256)
    if _native().akr_av1_probe(obus, len(obus), info, err, 256):
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")
    return dict(zip(INFO_NAMES, info))


def avif_planes(data, what="image", stats=None, filters=None):
    """The primary item's decoded planes (Y, U, V as [H, W] uint8, uint16 at
    10 and 12 bits; U and V of the chroma size, zeros for a monochrome
    image), as dav1d gives them
    to libavif, and the frame's header values (``INFO_NAMES``); ``stats``,
    a dict, receives what the frame used (``STAT_NAMES``) and what the
    inter frames of the sample used (``INTER_NAMES``), ``filters`` what its
    loop filters did (``FILTER_NAMES``). A grid's planes are its composed
    tiles', its header values its first tile's."""
    c, item, _, _ = _parse_or_raise(data, what)
    if item.type == b"grid":
        planes, info = _image_planes(c, item, what)
    else:
        planes, info = _decode_planes(_item_obus(c, item, what), what, stats, filters=filters)
    return planes, dict(zip(INFO_NAMES, info))


def _float_route(y, u, v, ssx, ssy, mode, full, kr, kb, depth=8, unmultiply=None):
    """libavif's own YUV -> RGB (reformat.c, avifImageYUVAnyToRGBAnySlow and
    its 8-bit fast paths, which give the same bits): float32 lookups of
    (x - bias) / range (at the planes' depth: a range of 2^depth - 1, or
    219 and 224 shifted up at limited range; a chroma bias of
    2^(depth - 1)), chroma upsampled bilinearly with weights 9, 3, 3, 1 /
    16 summed in that order (the column neighbour before the row neighbour;
    edge samples repeated), then R, G, B by the matrix's kr, kb (or
    identity, or YCgCo), clamped to [0, 1] and truncated from 0.5 + 255 x.
    ``unmultiply`` (an alpha plane of ``depth`` bits) divides the clamped
    colour by the alpha in float (0 where it is 0, at most 1), as the slow
    route does for a premultiplied image."""
    f32 = np.float32
    i = np.arange(1 << depth, dtype=f32)
    s, mx = depth - 8, (1 << depth) - 1
    if full:
        by, ry, buv, ruv = f32(0), f32(mx), f32(1 << (depth - 1)), f32(mx)
    else:
        by, ry, buv, ruv = f32(16 << s), f32(219 << s), f32(1 << (depth - 1)), f32(224 << s)
    if mode == "identity":
        buv, ruv = by, ry
    ty, tuv = (i - by) / ry, (i - buv) / ruv
    h, w = y.shape
    yf = ty[y]
    if unmultiply is not None:
        a = np.clip(np.asarray(unmultiply).astype(f32) / f32(mx), f32(0), f32(1))

        def out(c):
            c = np.clip(c, f32(0), f32(1))
            c = np.where(a == 0, f32(0), np.where(a < 1, np.minimum(c / np.where(a == 0, f32(1), a),
                                                                     f32(1)), c))
            return (f32(0.5) + c * f32(255)).astype(np.uint8)
    else:
        def out(c):
            return (f32(0.5) + np.clip(c, f32(0), f32(1)) * f32(255)).astype(np.uint8)
    if mode == "grey":
        return np.repeat(out(yf)[..., None], 3, axis=-1)
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
    return np.stack([out(c) for c in (r, g, b)], -1)


def _up16(c, h, w, ssx, ssy):
    """libyuv's 16-bit chroma upsampling of its high-bit-depth ARGB rows
    (I210's ScaleRowUp2_Linear_16, I010's ScaleRowUp2_Bilinear_16: 3:1
    and 9:3:3:1 of the neighbours, rounded; the first and last columns
    the edge sample's, blended vertically only; the first row and the last
    of an even height blended horizontally only)."""
    c = c.astype(np.int64)
    if ssx:
        n = c.shape[1]
        jx = np.arange(w)
        k = (jx - 1) >> 1
        near = np.clip(np.where(jx % 2 == 1, k, k + 1), 0, n - 1)
        far = np.clip(np.where(jx % 2 == 1, k + 1, k), 0, n - 1)
        edge = (jx == 0) | (jx == w - 1)
        near = np.where(edge, np.minimum(jx >> 1, n - 1), near)
        far = np.where(edge, near, far)
    else:
        near = far = np.arange(w)
    if not ssy:
        rows = c[np.arange(h) >> ssy]
        return (3 * rows[:, near] + rows[:, far] + 2) >> 2
    m = c.shape[0]
    jy = np.arange(h)
    k = (jy - 1) >> 1
    rn = np.clip(np.where(jy % 2 == 1, k, k + 1), 0, m - 1)
    rf = np.clip(np.where(jy % 2 == 1, k + 1, k), 0, m - 1)
    redge = (jy == 0) | ((h % 2 == 0) & (jy == h - 1))
    rn = np.where(redge, jy >> 1, rn)
    rf = np.where(redge, rn, rf)
    a, b = c[rn][:, near], c[rn][:, far]
    cc, d = c[rf][:, near], c[rf][:, far]
    two = (9 * a + 3 * b + 3 * cc + d + 8) >> 4
    one = (3 * a + b + 2) >> 2
    return np.where(redge[:, None], one, two)


def _libyuv16(y, u, v, depth, ssx, ssy, k, nearest):
    """libyuv's high-bit-depth YUV -> 8-bit ARGB rows (I410 / I210 / I010,
    the bilinear filter, at 10 bits; I012 with nearest chroma at 12):
    YuvPixel10 / YuvPixel12, luma's bits repeated to 16, chroma shifted to
    8 bits with saturation, then libyuv's 8-bit arithmetic."""
    yg, yb, ub, ug, vg, vr = k
    h, w = y.shape
    if nearest:
        jj, ii = np.arange(h)[:, None] >> ssy, np.arange(w)[None, :] >> ssx
        u, v = u[jj, ii].astype(np.int64), v[jj, ii].astype(np.int64)
    elif ssx or ssy:
        u, v = _up16(u, h, w, ssx, ssy), _up16(v, h, w, ssx, ssy)
    y = y.astype(np.int64)
    y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
    ui = np.minimum(u.astype(np.int64) >> (depth - 8), 255) - 128
    vi = np.minimum(v.astype(np.int64) >> (depth - 8), 255) - 128
    y1 = ((y32 * yg) >> 16) + yb
    return np.stack([np.clip(c >> 6, 0, 255).astype(np.uint8)
                     for c in (y1 + vi * vr, y1 - (ui * ug + vi * vg), y1 + ui * ub)], -1)


def yuv_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, has_alpha, what="image", depth=8):
    """[H, W, 3] uint8 RGB from planes of ``depth`` bits (``yuv_to_rgb_alpha``
    of an image with or without alpha, its values aside)."""
    if depth == 8:
        return _yuv8_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, has_alpha, what)
    alpha = np.zeros(np.shape(y), np.uint16) if has_alpha else None
    return yuv_to_rgb_alpha(y, u, v, alpha, mono, ssx, ssy, mc, full, cp, False, what, depth)[0]


def yuv_to_rgb_alpha(y, u, v, alpha, mono, ssx, ssy, mc, full, cp, premultiplied=False,
                     what="image", depth=8):
    """[H, W, 3] uint8 RGB and the [H, W] uint8 alpha (None without one) from
    planes of ``depth`` bits (8, 10 or 12), as libavif 1.3.0's
    avifImageYUVToRGB gives them to PIL (RGB, or RGBA with alpha), the
    colour divided by a ``premultiplied`` alpha. At 8 bits: ``yuv_to_rgb``,
    the alpha as it is, ``unpremultiply``. Above 8 bits libavif shifts the
    planes to 8 bits for libyuv's 8-bit routes (libyuv's Convert16To8Plane,
    the alpha with them) but where an RGBA image takes libyuv's own
    high-bit-depth rows (10-bit colour: ``_libyuv16``, the alpha shifted;
    12-bit 4:2:0: I012 with nearest chroma, the alpha rounded) or is grey
    (the alpha rounded, a * 255 / (2^depth - 1)); it runs its float route at
    the planes' depth for the matrices libyuv does not have (the alpha
    rounded; a premultiplied image unmultiplied in float where its chroma
    is subsampled or its matrix YCgCo or identity) and a monochrome image
    without alpha."""
    has_alpha = alpha is not None
    if depth == 8:
        rgb = _yuv8_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, has_alpha, what)
        a8, unmultiplied = None if alpha is None else np.asarray(alpha).astype(np.uint8), False
    else:
        rgb, rounded, unmultiplied = _depth_to_rgb(np.asarray(y), np.asarray(u), np.asarray(v),
                                                   mono, ssx, ssy, mc, full, cp, alpha,
                                                   premultiplied, what, depth)
        a8 = None
        if has_alpha:
            a, mx = np.asarray(alpha).astype(np.int64), (1 << depth) - 1
            a8 = ((a * 255 + mx // 2) // mx if rounded else a >> (depth - 8)).astype(np.uint8)
    if premultiplied and has_alpha and not unmultiplied:
        rgb = unpremultiply(rgb, a8)
    return rgb, a8


def _depth_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, alpha, premultiplied, what, depth):
    """``yuv_to_rgb_alpha`` above 8 bits: (RGB, whether the route rounds the
    alpha to 8 bits rather than shifting it, whether it unmultiplied the
    colour itself)."""
    y, u, v = (p.astype(np.uint16) for p in (y, u, v))
    has_alpha = alpha is not None
    name = f"{mc} ({_MATRIX_NAMES.get(mc, 'reserved')})"
    lmc = (1 if cp == 2 else cp) if mc == 12 and cp in (1, 2, 5, 6, 9) else mc
    s = depth - 8
    if mono:
        if mc not in _MONO_MATRICES or (mc == 8 and not full):
            raise ValueError(f"{what}: the AVIF nclx matrix {name} on a monochrome image")
        if has_alpha and (lmc in _LIBYUV or mc == 0):
            return _yuv8_to_rgb(y >> s, u >> s, v >> s, mono, ssx, ssy, mc, full, cp, True,
                               what), True, False
        inner = premultiplied and has_alpha and mc == 8
        return _float_route(y, u, v, 0, 0, "grey", full, 0, 0, depth,
                            unmultiply=alpha if inner else None), True, inner
    if lmc in _LIBYUV:
        if has_alpha and depth == 10:
            return _libyuv16(y, u, v, 10, ssx, ssy, _LIBYUV[lmc][1 if full else 0], False), \
                False, False
        if has_alpha and ssx and ssy:
            return _libyuv16(y, u, v, 12, ssx, ssy, _LIBYUV[lmc][1 if full else 0], True), \
                True, False
        return _yuv8_to_rgb(y >> s, u >> s, v >> s, mono, ssx, ssy, mc, full, cp, has_alpha,
                           what), False, False
    if mc in _FLOAT_KRKB:
        mode, krkb = "yuv", _FLOAT_KRKB[mc]
    elif mc == 12:
        mode, krkb = "yuv", chroma_derived_krkb(cp)
    elif mc == 8 and full:
        mode, krkb = "ycgco", (0, 0)
    elif mc == 0 and not ssx and not ssy:
        mode, krkb = "identity", (0, 0)
    else:
        raise ValueError(f"{what}: the AVIF nclx matrix {name}"
                         + (" on subsampled chroma" if mc == 0 else "")
                         + (" at limited range" if mc == 8 else ""))
    inner = premultiplied and has_alpha and bool(ssx or ssy or mode != "yuv")
    rgb = _float_route(y, u, v, ssx, ssy, mode, full, *krkb, depth,
                       unmultiply=alpha if inner else None)
    return rgb, True, inner


def _yuv8_to_rgb(y, u, v, mono, ssx, ssy, mc, full, cp, has_alpha, what="image"):
    """[H, W, 3] uint8 from 8-bit planes, as libavif 1.3.0's
    avifImageYUVToRGB gives them to PIL (RGB, or RGBA when the image has
    alpha): libyuv's fixed point for the matrices it has (BT.601 /
    BT.470BG / unspecified, BT.709, BT.2020 NCL; ``native/av1_decode.cpp``),
    libavif's float route for FCC, SMPTE 240M, IPT-C2 (BT.601's kr, kb), the
    chromaticity-derived non-constant-luminance matrix (kr, kb from the
    primaries ``cp``: ``chroma_derived_krkb``; libyuv's constants of BT.709,
    BT.601 and BT.2020 where the primaries are theirs), YCgCo (full range) and
    identity (4:4:4); a monochrome image's grey through libyuv's grey rows
    or that float route (which agree but for libyuv's BT.601 / BT.709
    constants in an RGBA limited-range image). Other matrices raise
    ``ValueError``, as PIL's conversion fails on them."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    name = f"{mc} ({_MATRIX_NAMES.get(mc, 'reserved')})"
    if mc == 12 and cp in (1, 2, 5, 6, 9):
        # libavif's libyuv route takes these primaries' own matrices (BT.709's
        # for unspecified primaries)
        mc = 1 if cp == 2 else cp
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
    elif mc == 12:
        return _float_route(y, u, v, ssx, ssy, "yuv", full, *chroma_derived_krkb(cp))
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
    (y, u, v), info = _image_planes(c, item, what)
    _, _, depth, mono, ssx, ssy, full, cp, tc, mc = info[:10]
    if nclx is not None:
        _, cp, tc, mc, full = nclx
    a, prem = None, False
    if alpha is not None:
        # scaled to its own ispe (the colour's where it has none), as libavif
        # does; then its size must be the colour's
        (a, _, _), ainfo = _image_planes(c, alpha, what, size=alpha.prop(b"ispe") or (w, h))
        if a.shape != y.shape:
            raise ValueError(f"{what}: Decoding of alpha plane failed (an AVIF alpha plane of "
                             f"{a.shape[1]} x {a.shape[0]} in an image of {y.shape[1]} x "
                             f"{y.shape[0]})")
        if ainfo[2] != depth:
            raise ValueError(f"{what}: Decoding of alpha plane failed (an AVIF alpha plane of "
                             f"{ainfo[2]} bits in an image of {depth})")
        prem = item.premultiplied_by == alpha.id
        if prem and not ainfo[6]:  # libavif's avifLimitedToFullY
            s = depth - 8
            a = np.clip(((a.astype(np.int64) - (16 << s)) * ((1 << depth) - 1)
                         / (219 << s)).astype(np.int64), 0, (1 << depth) - 1)
    rgb, a = yuv_to_rgb_alpha(y, u, v, a, mono, ssx, ssy, mc, full, cp, prem, what, depth)
    if rgb.shape[:2] != (h, w):
        # a grid whose output size is not its ispe: PIL reads the first
        # h x w pixels of libavif's buffer as rows of w
        px = rgb if alpha is None else np.concatenate([rgb, a[..., None]], -1)
        if px.shape[0] * px.shape[1] < w * h:
            raise ValueError(f"{what}: image file is truncated (an AVIF grid of "
                             f"{px.shape[1]} x {px.shape[0]} in an item of {w} x {h})")
        rgb = np.ascontiguousarray(px.reshape(-1)[:w * h * px.shape[2]].reshape(h, w, -1)[..., :3])
    return rgb
