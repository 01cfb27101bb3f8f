"""JPEG decoding without PIL: baseline, extended sequential (8-bit) and
progressive JPEGs, Huffman- or arithmetic-coded, and lossless (SOF3)
JPEGs, of one, three or four components.

The JAX package reads JPEG with PIL, which decodes through libjpeg-turbo
with its default settings: the accurate integer IDCT, fancy upsampling,
no scaling, and (the whole file being read before the first row is
output) block smoothing only of progressive files whose scans leave low
AC coefficients unrefined. This module decodes to the same 8-bit pixels:

- markers (here): SOI, APPn (JFIF and Adobe APP14 decide the colour space
  as libjpeg's ``default_decompress_parms`` does), DQT (8- and 16-bit
  tables, latched per component at its first scan), DHT (Annex K's tables
  standing in for a sequential scan's missing table 0 or 1, as
  jstdhuff.c does), DAC, DRI, SOF0-3 / SOF9-10, SOS, COM, RSTn, EOI;
- the entropy decoding of each scan: Huffman (sequential, progressive and
  lossless) in ``akari_torch/native/jpeg_entropy.cpp``, arithmetic in
  ``akari_torch/native/jpeg_arith.cpp`` (both built at first use by
  ``akari_torch/native/loader.py``), writing int16 coefficient planes
  [rows, blocks, 64] in natural order, or lossless samples;
- corrupt entropy-coded data read on as libjpeg reads it: a bit pattern
  no code matches is symbol 0, a marker inside a scan leaves the rest of
  its restart interval as it was, restart markers resynchronise as
  Pillow's ``jpeg_resync_to_restart`` does, and what follows the one scan
  of a single-scan file is read only for its errors;
- block smoothing (``_smooth``, as jdcoefct.c's decompress_smooth_data),
  dequantisation and the accurate integer IDCT (``_idct_islow``), fancy
  upsampling (``_upsample``, as ``jdsample.c``; lossless files replicate)
  and the YCbCr -> RGB conversion (``_ycc_to_rgb``, as ``jdcolor.c``):
  integer numpy passes over all blocks or pixels at once.

Four-component images are CMYK or YCCK (by the Adobe marker, as libjpeg
decides), read as PIL reads them (inverted Adobe CMYK). ``jpeg_tables`` and
``decode_components`` serve the JPEG-compressed TIFF strips of
``core/tiff.py``: abbreviated streams after a tables-only stream, and the
colour space libtiff sets.

Refused with a ``ValueError`` naming the form, where PIL refuses too:
hierarchical JPEGs and arithmetic-coded lossless ones (SOF11), precisions
other than 8 bits, 2-component images, lossless files libjpeg would have
to convert from YCbCr or YCCK, a file that ends inside a scan or (with
several scans) before its EOI marker, a sequential file with a second
scan after one of every component, and a Huffman table that is not a
prefix code or holds the all-ones code. One divergence: an arithmetic-coded
file larger than Pillow's 64 KiB feed reads here, where PIL fails
(libjpeg's arithmetic decoder cannot suspend for more data).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

from .image_formats import _check_size

# zig-zag index -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# SOFn codes read here -> (mode, arithmetic-coded)
_SOF = {
    0xC0: ("sequential", False), 0xC1: ("sequential", False), 0xC2: ("progressive", False),
    0xC3: ("lossless", False), 0xC9: ("sequential", True), 0xCA: ("progressive", True),
}
# ... and those libjpeg refuses (PIL with them)
_REFUSED_SOF = {
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)", 0xCF: "arithmetic-coded hierarchical (SOF15)",
}
_NATIVE_ERRORS = {
    1: "truncated: the file ends inside entropy-coded data",
    4: "bad Huffman table",
    5: "restart marker out of place (libtiff's old-style JPEG reader: unexpected error)",
}
# T.81 Annex K.3's Huffman tables (counts, then symbols), which
# libjpeg-turbo's jstdhuff.c gives a sequential scan whose DC or AC table 0
# or 1 was never defined (Motion-JPEG frames carry none)
_STD_HUFF = {k: bytes.fromhex(v) for k, v in {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
            "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a"
            "535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
            "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4"
            "e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (1, 1): "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
            "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
            "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
            "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}.items()}
_MAX_BLOCKS_IN_MCU = 10  # libjpeg's D_MAX_BLOCKS_IN_MCU
_SAVED_COEFS = 10        # coefficients libjpeg's block smoothing looks at


def _ceil_div(a, b):
    return -(-a // b)


def _next_marker(data, pos, what):
    """libjpeg's ``next_marker``: skip stray bytes, padding 0xFF bytes and
    FF 00 pairs; return (marker code, position after the code byte)."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{what}: JPEG is truncated (no EOI marker)")
        if data[pos] != 0:
            return data[pos], pos + 1
        pos += 1


class _Short(Exception):
    """A marker segment runs past the end of the data (libjpeg suspends)."""


def _take(body, p, n):
    if p + n > len(body):
        raise _Short
    return body[p:p + n]


def _huff_spec(body, what, length=None):
    """DHT segment -> {(class, id): 272 bytes: 16 counts, 256 symbols}, as
    libjpeg's get_dht reads it from the segment's ``length`` bytes (those
    of ``body`` by default; ``_Short`` if it needs more than ``body``
    holds)."""
    length = len(body) if length is None else length
    out, p = {}, 0
    while length > 16:
        head = _take(body, p, 17)
        index, counts = head[0], head[1:]
        n = sum(counts)
        length -= 17
        if n > 256 or n > length:
            raise ValueError(f"{what}: bad JPEG Huffman table")
        vals = _take(body, p + 17, n)
        length -= n
        cls, tid = (1, index - 0x10) if index & 0x10 else (0, index)
        if tid >= 4:
            raise ValueError(f"{what}: bad JPEG Huffman table index {index:#04x}")
        out[cls, tid] = bytes(counts) + vals + bytes(256 - n)
        p += 17 + n
    if length != 0:
        raise ValueError(f"{what}: bad JPEG DHT segment")
    return out


def _quant_tables(body, what, length=None):
    """DQT segment -> {id: [64] natural-order values}, as libjpeg-turbo's
    get_dqt reads it: any precision nibble other than 0 means 16-bit
    values, and each table is read whole, past the segment's ``length``
    if it says less (an error)."""
    length = len(body) if length is None else length
    out, p = {}, 0
    while length > 0:
        n = _take(body, p, 1)[0]
        prec, tq = n >> 4, n & 15
        if tq >= 4:
            raise ValueError(f"{what}: bad JPEG quantisation table index {tq}")
        size = 128 if prec else 64
        raw = _take(body, p + 1, size)
        q = np.zeros(64, np.int64)
        q[ZIGZAG] = np.frombuffer(raw, ">u2" if prec else np.uint8, 64)
        out[tq] = q
        length -= 1 + size
        p += 1 + size
    if length != 0:
        raise ValueError(f"{what}: bad JPEG quantisation table")
    return out


def _check_cut_segment(code, body, length, frame, cond, what):
    """A segment after a single-scan frame's scan that runs past the end of
    the data: raise where libjpeg errs in the bytes it reads before it
    would suspend (which Pillow then ignores)."""
    try:
        if code == 0xC4:
            _huff_spec(body, what, length)
        elif code == 0xDB:
            _quant_tables(body, what, length)
        elif code == 0xCC:
            _dac(body, bytearray(cond), what, length)
        elif code == 0xDD and length != 2:
            raise ValueError(f"{what}: bad JPEG restart interval segment")
        elif code == 0xDA:
            ns = _take(body, 0, 1)[0]
            if length != 4 + 2 * ns or not 1 <= ns <= 4:
                raise ValueError(f"{what}: bad JPEG scan header")
            ids = [c["id"] for c in frame["comps"]]
            for i in range(ns):
                if _take(body, 1 + 2 * i, 1)[0] not in ids:
                    raise ValueError(f"{what}: JPEG scan names a component not in the frame")
    except _Short:
        pass


def _frame(code, body, what):
    if len(body) < 6:
        raise ValueError(f"{what}: bad JPEG frame header")
    precision = body[0]
    h, w, nc = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), body[5]
    if precision != 8:
        raise ValueError(f"{what}: {precision}-bit JPEG is not supported (8-bit precision only, "
                         "as PIL reads)")
    if nc not in (1, 3, 4):
        raise ValueError(f"{what}: {nc}-component JPEG is not supported (grey, 3 or 4 "
                         "components)")
    if len(body) != 6 + 3 * nc:  # libjpeg: bogus marker length
        raise ValueError(f"{what}: bad JPEG frame header length")
    if h == 0 or w == 0:
        raise ValueError(f"{what}: JPEG of size {w}x{h} (DNL heights are not supported)")
    comps = []
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
            raise ValueError(f"{what}: bad JPEG sampling factors {hs}x{vs}")
        comps.append(dict(id=cid, h=hs, v=vs, tq=tq))
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mode, arith = _SOF[code]
    size = 1 if mode == "lossless" else 8  # a lossless "block" is one sample
    for c in comps:  # libjpeg's width_in_blocks and height_in_blocks
        c["bw"] = _ceil_div(_ceil_div(w * c["h"], hmax), size)
        c["bh"] = _ceil_div(_ceil_div(h * c["v"], vmax), size)
    return dict(h=h, w=w, comps=comps, mode=mode, arith=arith, progressive=mode == "progressive",
                hmax=hmax, vmax=vmax, mcux=_ceil_div(w, size * hmax), mcuy=_ceil_div(h, size * vmax))


def _colour_space(comps, jfif, adobe_transform, lossless=False):
    """libjpeg-turbo's choice (``default_decompress_parms``): YCbCr or RGB
    for three components (RGB when a lossless file says nothing), CMYK or
    YCCK for four."""
    if len(comps) == 4:  # an Adobe transform other than 0 reads as YCCK
        return "CMYK" if adobe_transform is None or adobe_transform == 0 else "YCCK"
    if jfif:
        return "YCbCr"
    if adobe_transform is not None:
        return "RGB" if adobe_transform == 0 else "YCbCr"
    ids = [c["id"] for c in comps]
    return "RGB" if ids == [82, 71, 66] or lossless else "YCbCr"  # 'R', 'G', 'B'


def _dac(body, cond, what, length=None):
    """DAC segment (get_dac): the arithmetic conditioning L / U of DC tables
    and K of AC tables, into ``cond`` [48]: L[16], U[16], K[16]."""
    length = len(body) if length is None else length
    for i in range(0, length, 2):
        index, val = _take(body, i, 2)  # an odd length reads a byte past the segment
        if i + 2 > length:
            raise ValueError(f"{what}: bad JPEG DAC segment length")
        if index >= 32:
            raise ValueError(f"{what}: bad JPEG DAC table index {index}")
        if index >= 16:
            cond[32 + index - 16] = val
        else:
            if (val & 15) > (val >> 4):
                raise ValueError(f"{what}: bad JPEG DAC conditioning L > U ({val:#04x})")
            cond[index], cond[16 + index] = val & 15, val >> 4


def _whole(parse, body, what, *args):
    """A segment parser on a segment the file holds whole: reading past
    its end is an error."""
    try:
        return parse(body, *args, what)
    except _Short:
        raise ValueError(f"{what}: bad JPEG marker segment length") from None


def decode_jpeg(data, what="JPEG"):
    """JPEG file bytes -> [H, W, 3] uint8 RGB (grey replicated), the pixels
    of PIL's ``Image.open(...).convert("RGB")``. Four components are CMYK
    (or YCCK, converted to CMYK as libjpeg's ``ycck_cmyk_convert``), which
    PIL reads as inverted Adobe CMYK (raw mode ``CMYK;I``) and converts
    with its cmyk2rgb."""
    from .image_formats import note_mode

    comps, space, _ = decode_components(data, what)
    note_mode({"grey": "L"}.get(space, "CMYK" if len(comps) == 4 else "RGB"))
    return components_to_rgb(comps, space)


def components_to_rgb(comps, space):
    """``decode_components``' planes and colour space -> [H, W, 3] uint8 as
    PIL converts them: grey replicated, YCbCr by libjpeg's tables, CMYK
    (YCCK first converted to CMYK) inverted and through cmyk2rgb."""
    from .image_formats import _cmyk_to_rgb

    if space == "grey":
        return np.repeat(comps[0][..., None], 3, axis=-1)
    if space == "RGB":
        return np.stack(comps, axis=-1).astype(np.uint8)
    if space == "YCbCr":
        return _ycc_to_rgb(*comps)
    cmyk = np.stack(comps, axis=-1) if space == "CMYK" else _ycck_to_cmyk(*comps)
    return _cmyk_to_rgb(255 - cmyk)


def jpeg_tables(data, what="JPEG"):
    """An abbreviated tables-only stream (SOI, DQT / DHT / DRI, EOI: a TIFF's
    ``JPEGTables`` tag) -> (quantisation tables, Huffman tables, restart
    interval), which ``decode_components`` starts from."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{what}: JPEG tables without an SOI marker")
    pos, qt, huff, restart = 2, {}, {}, 0
    while True:
        code, pos = _next_marker(data, pos, what)
        if code == 0xD9:
            return qt, huff, restart
        if pos + 2 > len(data):
            raise ValueError(f"{what}: JPEG tables are truncated")
        length = int.from_bytes(data[pos:pos + 2], "big")
        if length < 2 or pos + length > len(data):
            raise ValueError(f"{what}: JPEG tables are truncated")
        body = data[pos + 2:pos + length]
        if code == 0xC4:
            huff.update(_whole(_huff_spec, body, what))
        elif code == 0xDB:
            qt.update(_whole(_quant_tables, body, what))
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{what}: bad JPEG restart interval segment")
            restart = int.from_bytes(body[:2], "big")
        elif not (0xE0 <= code <= 0xEF or code == 0xFE):
            raise ValueError(f"{what}: JPEG tables hold marker 0xFF{code:02X} (libtiff: bogus "
                             "JPEGTables field)")
        pos += length


class _Scans:
    """What the scans of one frame build up: the coefficient planes (int16
    [rows, blocks, 64] a component) or, lossless, the sample planes (uint8
    [height, width]); the quantisation tables latched at each component's
    first scan; libjpeg's progression status ``coef_bits`` and the status
    before each component's latest scan (``prev_bits``, for block
    smoothing), and ``last_good_iMCU_row``."""

    def __init__(self, frame):
        comps = frame["comps"]
        if frame["mode"] == "lossless":
            self.planes = [np.zeros((c["bh"], c["bw"]), np.uint8) for c in comps]
        else:
            self.planes = [np.zeros((frame["mcuy"] * c["v"], frame["mcux"] * c["h"], 64), np.int16)
                           for c in comps]
        self.latched = [None] * len(comps)
        self.coef_bits = [np.full(64, -1, np.int64) for _ in comps]
        self.prev_bits = [np.full(64, -1, np.int64) for _ in comps]
        self.last_good = ctypes.c_int32(0)
        self.n = 0              # scans read
        self.multiple = None    # libjpeg's has_multiple_scans, set at the first


def decode_components(data, what="JPEG", tables=None, space=None, strip=False):
    """JPEG bytes -> ([H, W] uint8 per component, after upsampling, and for
    YCbCr / YCCK before colour conversion; the colour space: "grey", "RGB",
    "YCbCr", "CMYK" or "YCCK"; the frame: its size ``h``, ``w`` and
    components' sampling factors ``comps``). ``tables`` (from ``jpeg_tables``) are in
    force before the stream's own; ``space`` overrides the colour space the
    markers give, as libtiff sets it (None: libjpeg's choice; "raw": no
    conversion). ``strip``: a TIFF strip, which libtiff takes as read once
    the one scan of a single-scan frame is (tif_jpeg.c counts a failed
    jpeg_finish_decompress as done)."""
    frame, scans, space = read_scans(data, what, tables, space, strip)
    comps = frame["comps"]
    h, w, hmax, vmax = frame["h"], frame["w"], frame["hmax"], frame["vmax"]
    if frame["mode"] == "lossless":
        if space in ("YCbCr", "YCCK"):
            raise ValueError(f"{what}: lossless JPEG in {space} is not supported (libjpeg "
                             "converts no colour in lossless mode, and PIL refuses it)")
        # libjpeg upsamples lossless components by replication (no fancy
        # upsampling without an IDCT)
        return ([_upsample(px, c["h"], c["v"], hmax, vmax, h, w, what, fancy=False)
                 for c, px in zip(comps, scans.planes)], space, frame)
    planes = scans.planes
    if frame["progressive"]:
        latch = _smoothing_latch(scans, comps)
        if latch is not None:
            planes = [_smooth(p, q, c, frame, *lt, scans.last_good.value)
                      for p, q, c, lt in zip(planes, scans.latched, comps, latch)]
    out = []
    for c, plane, q in zip(comps, planes, scans.latched):
        dh, dw = _ceil_div(h * c["v"], vmax), _ceil_div(w * c["h"], hmax)  # downsampled size
        px = _idct_islow(plane, np.zeros(64, np.int64) if q is None else q)[:dh, :dw]
        out.append(_upsample(px, c["h"], c["v"], hmax, vmax, h, w, what))
    return out, space, frame


def read_scans(data, what="JPEG", tables=None, space=None, strip=False,
               strict_restarts=False):
    """JPEG bytes -> (frame, ``_Scans`` after the last scan, colour space):
    the markers and entropy-coded data of ``decode_components`` before any
    smoothing, IDCT or upsampling (``tools/jpeg_writers.py`` reads a file's
    quantised coefficients with it). ``strict_restarts``: any marker but
    the expected RSTn at a restart fails, as under libtiff's old-style JPEG
    reader (``core/tiff_ojpeg.py``)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{what}: not a JPEG file")
    pos, qt, huff, restart = 2, {}, {}, 0
    if tables is not None:
        qt, huff, restart = dict(tables[0]), dict(tables[1]), tables[2]
    cond = bytearray([0] * 16 + [1] * 16 + [5] * 16)  # DAC: L, U, K as SOI resets them
    forced = space
    jfif, adobe_transform = False, None
    frame = scans = space = None
    while True:
        # the markers after the one scan of a single-scan frame are read by
        # jpeg_finish_decompress once every row is out: Pillow ignores a
        # file that ends there (libjpeg suspends), though not an error
        ends_ok = scans is not None and not scans.multiple
        if ends_ok and strip:
            break
        try:
            code, pos = _next_marker(data, pos, what)
        except ValueError:
            if ends_ok:
                break
            raise
        if code == 0xD9:  # EOI
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:  # stray RSTn, TEM: no length
            continue
        # what libjpeg refuses before it reads a length
        if code in _SOF and frame is not None:
            raise ValueError(f"{what}: JPEG with two frame headers")
        if code in _REFUSED_SOF:
            raise ValueError(f"{what}: {_REFUSED_SOF[code]} JPEG is not supported "
                             "(libjpeg refuses it; PIL with it)")
        if not (code in _SOF or code in (0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE)
                or 0xE0 <= code <= 0xEF):
            raise ValueError(f"{what}: unsupported JPEG marker 0xFF{code:02X}")
        if pos + 2 > len(data):
            if ends_ok:
                break
            raise ValueError(f"{what}: JPEG is truncated")
        length = int.from_bytes(data[pos:pos + 2], "big")
        if length < 2 and (0xE0 <= code <= 0xEF or code in (0xFE, 0xDC)):
            length = 2  # libjpeg skips nothing of an APPn, COM or DNL segment this short
        if length < 2:
            raise ValueError(f"{what}: bad JPEG marker segment length {length}")
        if pos + length > len(data):
            if ends_ok:
                _check_cut_segment(code, data[pos + 2:], length - 2, frame, cond, what)
                break
            raise ValueError(f"{what}: JPEG is truncated")
        body, nxt = data[pos + 2:pos + length], pos + length
        if code in _SOF:
            frame = _frame(code, body, what)
            _check_size(frame["w"], frame["h"], what, "JPEG")  # before any allocation
        elif code == 0xC4:
            huff.update(_whole(_huff_spec, body, what))
        elif code == 0xDB:
            qt.update(_whole(_quant_tables, body, what))
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{what}: bad JPEG restart interval segment")
            restart = int.from_bytes(body[:2], "big")
        elif code == 0xCC:
            _whole(_dac, body, what, cond)
        elif code == 0xE0:
            # libjpeg fixes the colour space at the first scan
            jfif |= scans is None and body[:5] == b"JFIF\0" and len(body) >= 14
        elif code == 0xEE:
            if scans is None and body[:5] == b"Adobe" and len(body) >= 12:
                adobe_transform = body[11]
        elif code == 0xDA:
            if frame is None:
                raise ValueError(f"{what}: JPEG scan before its frame header")
            if scans is None:
                scans = _Scans(frame)
                comps = frame["comps"]
                space = ("grey" if len(comps) == 1 else
                         _colour_space(comps, jfif, adobe_transform, frame["mode"] == "lossless")
                         if forced is None else forced)
            nxt = _scan(data, nxt, body, frame, scans, qt, huff, cond, restart, what,
                        strict_restarts)
        # APPn, COM, DNL: nothing that changes the pixels
        pos = nxt
    if frame is None or scans is None:
        raise ValueError(f"{what}: JPEG without a frame or a scan")
    return frame, scans, space


def _scan(data, start, body, frame, scans, qt, huff, cond, restart, what, strict=False):
    """Parse one SOS header, latch its quantisation tables, check its
    parameters as libjpeg's ``start_pass`` routines do and update the
    progression status, and decode its entropy-coded data into
    ``scans.planes``; returns the position after it."""
    from ..native.loader import load

    comps = frame["comps"]
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:  # libjpeg: bogus marker length
        raise ValueError(f"{what}: bad JPEG scan header")
    mode = frame["mode"]
    if scans.multiple is None:
        scans.multiple = mode == "progressive" or ns < len(comps)
    elif not scans.multiple:
        raise ValueError(f"{what}: JPEG with a second scan after a scan of every component "
                         "(libjpeg: EOI expected)")
    scans.n += 1
    ids = [c["id"] for c in comps]
    idx, tables = [], []
    slots = [False] * 4  # libjpeg-turbo's cur_comp_info, filled by scan position
    for i in range(ns):
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        # get_sos: the first frame component of that id whose index is a scan
        # position not yet filled (a repeated id takes the next component)
        ci = next((k for k in range(min(len(comps), 4)) if ids[k] == cs and not slots[k]), None)
        if ci is None:
            raise ValueError(f"{what}: JPEG scan names component {cs}, not in the frame "
                             "(libjpeg: invalid component ID)")
        slots[i] = True
        if mode != "lossless" and scans.latched[ci] is None:
            if comps[ci]["tq"] not in qt:
                raise ValueError(f"{what}: JPEG quantisation table {comps[ci]['tq']} undefined")
            scans.latched[ci] = qt[comps[ci]["tq"]].copy()
        idx.append(ci)
        tables.append((t >> 4, t & 15))
    ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    if ns > 1 and sum(comps[ci]["h"] * comps[ci]["v"] for ci in idx) > _MAX_BLOCKS_IN_MCU:
        raise ValueError(f"{what}: JPEG sampling factors too large for an interleaved scan")
    progressive = frame["progressive"]
    if progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        bad |= (ah != 0 and al != ah - 1) or al > 13
        if bad:
            raise ValueError(f"{what}: bad JPEG progression Ss={ss} Se={se} Ah={ah} Al={al}")
        for ci in idx:  # start_pass_phuff_decoder / jdarith.c start_pass
            for k in range(min(ss, 1), max(se, 9) + 1):
                scans.prev_bits[ci][k] = scans.coef_bits[ci][k] if scans.n > 1 else 0
            scans.coef_bits[ci][ss:se + 1] = al
    geom = []
    for ci in idx:
        c = comps[ci]
        hs, vs = (c["h"], c["v"]) if ns > 1 else (1, 1)
        row = c["bw"] if mode == "lossless" else scans.planes[ci].shape[1]
        geom += [hs, vs, row, c["bw"], c["bh"], c["v"]]
    geom = np.asarray(geom, np.int32)
    gptr = geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    ptrs = (ctypes.c_void_p * ns)(*[scans.planes[ci].ctypes.data for ci in idx])
    end = ctypes.c_int64(0)
    if mode == "lossless":
        per_row = frame["mcux"] if ns > 1 else comps[idx[0]]["bw"]
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
            raise ValueError(f"{what}: bad lossless JPEG scan: predictor Ss={ss}, Se={se}, "
                             f"Ah={ah}, point transform Al={al}")
        if restart % per_row:
            raise ValueError(f"{what}: lossless JPEG restart interval {restart} is not a "
                             f"multiple of the {per_row} MCUs of a row (libjpeg refuses it)")
        spec = b""
        for td, _ in tables:
            if (0, td) not in huff:
                raise ValueError(f"{what}: JPEG Huffman table {td} undefined")
            spec += huff[0, td]
        rc = load("jpeg").akr_jpeg_lossless(
            data, len(data), start, ns, ptrs, gptr, spec, frame["mcux"], frame["mcuy"], ss, al,
            restart, ctypes.byref(end))
    elif frame["arith"]:
        tbl = bytes(v for pair in tables for v in pair)
        rc = load("jpeg_arith").akr_jpeg_arith_scan(
            data, len(data), start, ns, ptrs, gptr, tbl, bytes(cond), frame["mcux"],
            frame["mcuy"], ss, se, ah, al, int(progressive), restart, ctypes.byref(end))
        scans.last_good.value = frame["mcuy"] - 1  # no out-of-data state in jdarith.c
    else:
        # the DC table is needed by sequential scans and first DC scans, the AC
        # table by sequential scans and AC scans; absent ones pass as zeros
        need_dc = not progressive or (ss == 0 and ah == 0)
        need_ac = not progressive or ss > 0
        spec = b""
        for (td, ta) in tables:
            for cls, tid, need in ((0, td, need_dc), (1, ta, need_ac)):
                if need and (cls, tid) not in huff:
                    if progressive or (cls, tid) not in _STD_HUFF:
                        raise ValueError(f"{what}: JPEG Huffman table {tid} undefined")
                    huff[cls, tid] = _STD_HUFF[cls, tid] + bytes(272 - len(_STD_HUFF[cls, tid]))
                spec += huff.get((cls, tid), bytes(272)) if need else bytes(272)
        rc = load("jpeg").akr_jpeg_scan(
            data, len(data), start, ns, ptrs, gptr, spec, frame["mcux"], frame["mcuy"], ss, se,
            ah, al, int(progressive), restart, ctypes.byref(end), ctypes.byref(scans.last_good),
            int(strict))
    if rc:
        raise ValueError(f"{what}: JPEG {_NATIVE_ERRORS.get(rc, f'decoder error {rc}')}")
    return end.value


# --------------------------------------------------------------------------
# Block smoothing of progressive files whose scans leave low AC coefficients
# unrefined: libjpeg-turbo's smoothing_ok and decompress_smooth_data
# (jdcoefct.c, the 2.1+ form), which PIL runs on such a file.
#
# Each of the first nine AC coefficients that is still zero and not known
# exactly is predicted from the 5x5 neighbourhood of DC values (DC01..DC25
# row by row, DC13 the block's own), limited to the bits its last scan left
# unknown; when no AC coefficient has been coded at all, the DC value is
# interpolated too, and AC03 / AC12 / AC21 / AC30 join in.


def _kernel(text):
    """'-DC01 + 13 * DC07 ...' (jdcoefct.c's expressions) -> [5, 5] int64."""
    k = np.zeros(25, np.int64)
    for sign, weight, i in re.findall(r"([+-]?)\s*(?:(\d+)\s*\*\s*)?DC(\d\d)", text):
        k[int(i) - 1] += (-1 if sign == "-" else 1) * int(weight or 1)
    return k.reshape(5, 5)


# (coef_bits index, natural position, estimate, DC-interpolation estimate)
_SMOOTH = [(1, 1, _kernel("-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15"), _kernel(
               "-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - "
               "3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - "
               "13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25")),
           (2, 8, _kernel("-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23"), _kernel(
               "-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 + "
               "13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 + "
               "3 * DC22 + 3 * DC23 + 3 * DC24 + DC25")),
           (3, 16, _kernel("-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23"), _kernel(
               "DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + "
               "2 * DC17 + 7 * DC18 + 2 * DC19 + DC23")),
           (4, 9, _kernel("DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + "
                          "DC04 - DC06 + 10 * DC07 - 10 * DC09"), _kernel(
               "-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25")),
           (5, 2, _kernel("-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15"), _kernel(
               "2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + "
               "DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19")),
           (6, 3, None, _kernel("DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19")),
           (7, 10, None, _kernel("DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19")),
           (8, 17, None, _kernel("DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19")),
           (9, 24, None, _kernel("DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19"))]
_DC_INTERP = _kernel(
    "-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 + "
    "42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - "
    "8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - "
    "6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25")


def _smoothing_latch(scans, comps):
    """libjpeg-turbo's ``smoothing_ok``: None when it would not smooth, else
    per component the latched progression status of coefficients 0-9 and
    the status before the component's latest scan (-1 after one scan)."""
    useful, latch = False, []
    for ci in range(len(comps)):
        q = scans.latched[ci]
        if q is None or np.any(q[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]] == 0):
            return None
        bits = scans.coef_bits[ci][:_SAVED_COEFS].copy()
        if bits[0] < 0:
            return None
        prev = scans.prev_bits[ci][:_SAVED_COEFS].copy() if scans.n > 1 \
            else np.full(_SAVED_COEFS, -1, np.int64)
        useful |= bool(np.any(bits[1:] != 0))
        latch.append((bits, prev))
    return latch if useful else None


def _smooth_sources(c, frame):
    """The rows and columns of the 5x5 DC neighbourhood of every block as
    decompress_smooth_data reads them ([bh, 5] rows, [bw, 5] columns), and
    each block row's iMCU row. Columns past the edge repeat the edge block;
    rows repeat it by the count of block rows in the block's own iMCU row
    (``block_rows``, smaller in the last one), so that a block row two
    before the end of a component whose last iMCU row is short reads the
    padding row below as its next-but-one."""
    v, n_imcu, bh, bw = c["v"], frame["mcuy"], c["bh"], c["bw"]
    rows, imcu = [], []
    for r in range(n_imcu):
        block_rows = v if r < n_imcu - 1 else (bh % v or v)
        total = block_rows * n_imcu
        for br in range(block_rows):
            row, i = r * v + br, r * block_rows + br
            prev = row - 1 if i > 0 else row
            pprev = row - 2 if i > 1 else prev
            nxt = row + 1 if i < total - 1 else row
            nnxt = row + 2 if i < total - 2 else nxt
            rows.append((pprev, prev, row, nxt, nnxt))
            imcu.append(r)
    cols = np.clip(np.arange(bw)[:, None] + np.arange(-2, 3)[None, :], 0, bw - 1)
    return np.asarray(rows), cols, np.asarray(imcu)


def _smooth(plane, q, c, frame, bits_now, bits_prev, last_good):
    """One component's coefficient plane after decompress_smooth_data: the
    block rows of iMCU rows past ``last_good`` (libjpeg's
    last_good_iMCU_row: the last scan ran out of data there) take the
    status before the latest scan."""
    rows, cols, imcu = _smooth_sources(c, frame)
    bh, bw = c["bh"], c["bw"]
    dc = plane[:, :, 0].astype(np.int64)
    grid = dc[rows[:, None, :, None], cols[None, :, None, :]]  # [bh, bw, 5, 5]
    ws = plane[:bh, :bw].astype(np.int64)
    q = q.astype(np.int64)
    for use_prev in (False, True):
        sel = (imcu > last_good) == use_prev
        if not sel.any():
            continue
        bits = bits_prev if use_prev else bits_now
        change_dc = bool(np.all(bits[1:] == -1))
        g, w = grid[sel], ws[sel]
        for k, pos, estimate, interp in _SMOOTH:
            al = int(bits[k])
            if al == 0 or (estimate is None and not change_dc):
                continue
            num = q[0] * np.einsum("nwij,ij->nw", g, interp if change_dc else estimate)
            mag = ((q[pos] << 7) + np.abs(num)) // (q[pos] << 8)
            if al > 0:
                mag = np.minimum(mag, (1 << al) - 1)
            w[..., pos] = np.where(w[..., pos] == 0, np.where(num >= 0, mag, -mag), w[..., pos])
        if change_dc:
            num = q[0] * np.einsum("nwij,ij->nw", g, _DC_INTERP)
            mag = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
            w[..., 0] = np.where(num >= 0, mag, -mag)
        ws[sel] = w
    out = plane.copy()
    out[:bh, :bw] = ws.astype(np.int16)  # JCOEF
    return out


# --------------------------------------------------------------------------
# Dequantisation and the accurate integer IDCT.
#
# libjpeg-turbo's jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2)
# as the reference's x86-64 build runs it, through its AVX2 routine: the
# dequantised coefficients are 16-bit products, a block whose rows 1-7
# are all zero takes the DC shortcut (each column's row-0 value << 2 in 16
# bits), the sums in0 +- in4, in7 + in3 and in5 + in1 are 16-bit, the rest
# is 32-bit, pass 1 saturates its outputs to 16 bits and pass 2 saturates
# to [-128, 127] before adding 128. On the coefficients of any stream an
# encoder writes from 8-bit pixels this equals jidctint.c's C code and its
# range-limit table; the two differ only on crafted coefficients whose
# products leave 16 bits, where this follows the reference's AVX2 build.

_F0298, _F0390, _F0541, _F0765, _F0899, _F1175 = 2446, 3196, 4433, 6270, 7373, 9633
_F1501, _F1847, _F1961, _F2053, _F2562, _F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _w16(x):
    """Wrap int32 values to 16 bits (a 16-bit lane's add or multiply)."""
    return x.astype(np.int16).astype(np.int32)


def _idct_pass(x, shift):
    """One 1-D pass along axis -2 of [..., 8, 8] int32 (16-bit values):
    the even part, the odd part and the output butterfly of jidctint.c,
    descaled by ``shift`` and saturated to 16 bits."""
    i0, i1, i2, i3, i4, i5, i6, i7 = (x[..., k, :] for k in range(8))
    tmp3 = i2 * (_F0541 + _F0765) + i6 * _F0541
    tmp2 = i2 * _F0541 + i6 * (_F0541 - _F1847)
    tmp0 = _w16(i0 + i4) << 13
    tmp1 = _w16(i0 - i4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(i7 + i3), _w16(i5 + i1)
    z3, z4 = z3 * (_F1175 - _F1961) + z4 * _F1175, z3 * _F1175 + z4 * (_F1175 - _F0390)
    o0 = i7 * (_F0298 - _F0899) + i1 * -_F0899 + z3
    o1 = i5 * (_F2053 - _F2562) + i3 * -_F2562 + z4
    o2 = i5 * -_F2562 + i3 * (_F3072 - _F2562) + z3
    o3 = i7 * -_F0899 + i1 * (_F1501 - _F0899) + z4
    bias = np.int32(1 << (shift - 1))
    out = np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                    t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=-2)
    return np.clip((out + bias) >> shift, -32768, 32767)


def _idct_islow(plane, q):
    """[R, C, 64] int16 natural-order coefficients, [64] quantisation values
    -> [8R, 8C] uint8 samples."""
    r, c = plane.shape[:2]
    coef = plane.reshape(-1, 8, 8).astype(np.int32)
    qq = q.astype(np.int16).astype(np.int32).reshape(8, 8)  # libjpeg's 16-bit table
    d = _w16(coef * qq)
    ws = _idct_pass(d, 13 - 2)  # columns: CONST_BITS - PASS1_BITS
    dc_only = ~np.any(coef[:, 1:, :] != 0, axis=(1, 2))
    ws[dc_only] = _w16(d[dc_only, :1, :] << 2)
    out = _idct_pass(ws.transpose(0, 2, 1), 13 + 2 + 3).transpose(0, 2, 1)  # rows
    px = (np.clip(out, -128, 127) + 128).astype(np.uint8)
    return px.reshape(r, c, 8, 8).transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)


# --------------------------------------------------------------------------
# Upsampling (jdsample.c) and colour conversion (jdcolor.c)


def _edge(x, axis, step):
    """x shifted by one along ``axis`` (step -1: the previous element,
    +1: the next), the edge element replicated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(px, hs, vs, hmax, vmax, h, w, what, fancy=True):
    """[dh, dw] uint8 component samples -> [h, w] uint8, as libjpeg chooses:
    h2v1 and h2v2 fancy (triangle) upsampling when the component is more
    than 2 samples wide, else replication; h1v2 fancy; other integral
    factors by replication (all of them without ``fancy``). Edge samples
    are replicated, from the component's own width and height."""
    x = px.astype(np.int32)
    dw = x.shape[1]
    if hs == hmax and vs == vmax:
        out = x
    elif not fancy and hmax % hs == 0 and vmax % vs == 0:
        out = np.repeat(np.repeat(x, vmax // vs, axis=0), hmax // hs, axis=1)
    elif hs * 2 == hmax and vs == vmax and dw > 2:
        left, right = _edge(x, 1, -1), _edge(x, 1, 1)
        out = _interleave((3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2, 1)
    elif hs == hmax and vs * 2 == vmax:
        up, down = _edge(x, 0, -1), _edge(x, 0, 1)
        out = _interleave((3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2, 0)
    elif hs * 2 == hmax and vs * 2 == vmax and dw > 2:
        rows = []
        for near in (3 * x + _edge(x, 0, -1), 3 * x + _edge(x, 0, 1)):  # column sums
            rows.append(_interleave((3 * near + _edge(near, 1, -1) + 8) >> 4,
                                    (3 * near + _edge(near, 1, 1) + 7) >> 4, 1))
        out = _interleave(rows[0], rows[1], 0)
    elif hmax % hs == 0 and vmax % vs == 0:
        out = np.repeat(np.repeat(x, vmax // vs, axis=0), hmax // hs, axis=1)
    else:
        raise ValueError(f"{what}: JPEG sampling ratio {hmax}/{hs} x {vmax}/{vs} is not "
                         "supported (integral factors only)")
    return out[:h, :w].astype(np.uint8)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycck_to_cmyk(y, cb, cr, k):
    """[H, W] uint8 Y, Cb, Cr, K -> [H, W, 4] uint8 CMYK (jdcolor.c
    ycck_cmyk_convert: the YCbCr -> RGB tables, each result inverted,
    255 - (y + ...) range-limited; K passes through)."""
    rgb = _ycc_to_rgb(y, cb, cr, clip=False)
    cmy = np.clip(255 - rgb, 0, 255).astype(np.uint8)
    return np.concatenate([cmy, k[..., None]], axis=-1)


def _ycc_to_rgb(y, cb, cr, clip=True):
    """[H, W] uint8 Y, Cb, Cr -> [H, W, 3] uint8 RGB (jdcolor.c
    ycc_rgb_convert: fixed-point tables, results clamped to 0..255)."""
    y = y.astype(np.int32)
    out = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], -1)
    return np.clip(out, 0, 255).astype(np.uint8) if clip else out
