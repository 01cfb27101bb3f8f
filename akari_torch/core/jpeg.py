"""JPEG decoding without PIL: baseline, extended sequential (8-bit) and
progressive Huffman JPEGs of one, three or four components.

The JAX package reads JPEG with PIL, which decodes through libjpeg-turbo
with its default settings: the accurate integer IDCT, fancy upsampling,
no scaling, and (the whole file being read before the first row is
output) no block smoothing of complete progressive files. This module
decodes to the same 8-bit pixels:

- markers (here): SOI, APPn (JFIF and Adobe APP14 decide the colour space
  as libjpeg's ``default_decompress_parms`` does), DQT (8- and 16-bit
  tables, latched per component at its first scan), DHT, DRI, SOF0 / SOF1
  / SOF2, SOS, COM, RSTn, EOI;
- the entropy decoding of each scan: ``akari_torch/native/jpeg_entropy.cpp``
  (built at first use by ``akari_torch/native/loader.py``), writing int16
  coefficient planes [rows, blocks, 64] in natural order;
- dequantisation and the accurate integer IDCT (``_idct_islow``), fancy
  upsampling (``_upsample``, as ``jdsample.c``) and the YCbCr -> RGB
  conversion (``_ycc_to_rgb``, as ``jdcolor.c``): integer numpy passes
  over all blocks or pixels at once.

Four-component images are CMYK or YCCK (by the Adobe marker, as libjpeg
decides), read as PIL reads them (inverted Adobe CMYK). ``jpeg_tables`` and
``decode_components`` serve the JPEG-compressed TIFF strips of
``core/tiff.py``: abbreviated streams after a tables-only stream, and the
colour space libtiff sets.

Refused with a ``ValueError`` naming the form: lossless, hierarchical and
arithmetic-coded JPEGs, precisions other than 8 bits, 2-component images, a progressive file whose scans leave some
of the first AC coefficients unrefined (libjpeg would smooth its blocks),
a file that ends before its EOI marker, a Huffman table that is not a
prefix code or holds the all-ones code (PIL refuses these too), and
corrupt entropy-coded data: a bit pattern no Huffman code matches, or
restart markers out of order (libjpeg warns and decodes on there, and
PIL loads such a file).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .image_formats import _check_size

# zig-zag index -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

_REFUSED_SOF = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)", 0xCF: "arithmetic-coded hierarchical (SOF15)",
}
_NATIVE_ERRORS = {
    1: "truncated: the file ends inside entropy-coded data",
    2: "corrupt entropy-coded data (no Huffman code matches)",
    3: "corrupt entropy-coded data (restart marker missing or out of sequence)",
    4: "bad Huffman table",
}
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


def _huff_spec(body, what):
    """DHT segment -> {(class, id): 272 bytes: 16 counts, 256 symbols}."""
    out, p = {}, 0
    while p < len(body):
        if p + 17 > len(body):
            raise ValueError(f"{what}: bad JPEG DHT segment")
        tc, th = body[p] >> 4, body[p] & 15
        counts = body[p + 1:p + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or p + 17 + n > len(body):
            raise ValueError(f"{what}: bad JPEG Huffman table")
        out[tc, th] = bytes(counts) + body[p + 17:p + 17 + n] + bytes(256 - n)
        p += 17 + n
    return out


def _quant_tables(body, what):
    """DQT segment -> {id: [64] natural-order values}; 8- and 16-bit."""
    out, p = {}, 0
    while p < len(body):
        pq, tq = body[p] >> 4, body[p] & 15
        size = 64 * (pq + 1)
        if pq > 1 or tq > 3 or p + 1 + size > len(body):
            raise ValueError(f"{what}: bad JPEG quantisation table")
        vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64, p + 1).astype(np.int64)
        q = np.zeros(64, np.int64)
        q[ZIGZAG] = vals
        out[tq] = q
        p += 1 + size
    return out


def _frame(code, body, what):
    if len(body) < 6:
        raise ValueError(f"{what}: bad JPEG frame header")
    precision = body[0]
    h, w, nc = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), body[5]
    if precision != 8:
        raise ValueError(f"{what}: {precision}-bit JPEG is not supported (8-bit precision only)")
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
    return dict(h=h, w=w, comps=comps, progressive=code == 0xC2, hmax=hmax, vmax=vmax,
                mcux=_ceil_div(w, 8 * hmax), mcuy=_ceil_div(h, 8 * vmax))


def _colour_space(comps, jfif, adobe_transform):
    """libjpeg's choice (``default_decompress_parms``): YCbCr or RGB for
    three components, CMYK or YCCK for four."""
    if len(comps) == 4:  # an Adobe transform other than 0 reads as YCCK
        return "CMYK" if adobe_transform is None or adobe_transform == 0 else "YCCK"
    if jfif:
        return "YCbCr"
    if adobe_transform is not None:
        return "RGB" if adobe_transform == 0 else "YCbCr"
    ids = [c["id"] for c in comps]
    return "RGB" if ids == [82, 71, 66] else "YCbCr"  # 'R', 'G', 'B'


def _smoothing_wanted(coef_bits, comps, latched):
    """libjpeg-turbo's ``smoothing_ok``: True when it would smooth blocks."""
    useful = False
    for ci in range(len(comps)):
        q = latched[ci]
        if q is None or np.any(q[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]] == 0):
            return False
        if coef_bits[ci][0] < 0:
            return False
        useful |= bool(np.any(coef_bits[ci][1:_SAVED_COEFS] != 0))
    return useful


def decode_jpeg(data, what="JPEG"):
    """JPEG file bytes -> [H, W, 3] uint8 RGB (grey replicated), the pixels
    of PIL's ``Image.open(...).convert("RGB")``. Four components are CMYK
    (or YCCK, converted to CMYK as libjpeg's ``ycck_cmyk_convert``), which
    PIL reads as inverted Adobe CMYK (raw mode ``CMYK;I``) and converts
    with its cmyk2rgb."""
    comps, space, _ = decode_components(data, what)
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
            huff.update(_huff_spec(body, what))
        elif code == 0xDB:
            qt.update(_quant_tables(body, what))
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{what}: bad JPEG restart interval segment")
            restart = int.from_bytes(body[:2], "big")
        elif not (0xE0 <= code <= 0xEF or code == 0xFE):
            raise ValueError(f"{what}: JPEG tables hold marker 0xFF{code:02X} (libtiff: bogus "
                             "JPEGTables field)")
        pos += length


def decode_components(data, what="JPEG", tables=None, space=None):
    """JPEG bytes -> ([H, W] uint8 per component, after upsampling, and for
    YCbCr / YCCK before colour conversion; the colour space: "grey", "RGB",
    "YCbCr", "CMYK" or "YCCK"; the frame: its size ``h``, ``w`` and
    components' sampling factors ``comps``). ``tables`` (from ``jpeg_tables``) are in
    force before the stream's own; ``space`` overrides the colour space the
    markers give, as libtiff sets it (None: libjpeg's choice; "raw": no
    conversion)."""
    from ..native.loader import load

    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{what}: not a JPEG file")
    lib = load("jpeg")
    pos, qt, huff, restart = 2, {}, {}, 0
    if tables is not None:
        qt, huff, restart = dict(tables[0]), dict(tables[1]), tables[2]
    forced = space
    jfif, adobe_transform = False, None
    frame = planes = latched = coef_bits = space = None
    n_scans = 0
    while True:
        code, pos = _next_marker(data, pos, what)
        if code == 0xD9:  # EOI
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:  # stray RSTn, TEM: no length
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{what}: JPEG is truncated")
        length = int.from_bytes(data[pos:pos + 2], "big")
        if length < 2 and (0xE0 <= code <= 0xEF or code == 0xFE):
            length = 2  # libjpeg skips nothing of an APPn or COM segment this short
        if length < 2 or pos + length > len(data):
            raise ValueError(f"{what}: JPEG is truncated")
        body, nxt = data[pos + 2:pos + length], pos + length
        if code in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{what}: JPEG with two frame headers")
            frame = _frame(code, body, what)
            _check_size(frame["w"], frame["h"], what, "JPEG")  # before any allocation
        elif code in _REFUSED_SOF:
            raise ValueError(f"{what}: {_REFUSED_SOF[code]} JPEG is not supported "
                             "(baseline, extended sequential and progressive Huffman only)")
        elif code == 0xC4:
            huff.update(_huff_spec(body, what))
        elif code == 0xDB:
            qt.update(_quant_tables(body, what))
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{what}: bad JPEG restart interval segment")
            restart = int.from_bytes(body[:2], "big")
        elif code == 0xE0:
            # libjpeg fixes the colour space at the first scan
            jfif |= planes is None and body[:5] == b"JFIF\0" and len(body) >= 14
        elif code == 0xEE:
            if planes is None and body[:5] == b"Adobe" and len(body) >= 12:
                adobe_transform = body[11]
        elif code == 0xDA:
            if frame is None:
                raise ValueError(f"{what}: JPEG scan before its frame header")
            comps = frame["comps"]
            if planes is None:
                planes = [np.zeros((frame["mcuy"] * c["v"], frame["mcux"] * c["h"], 64), np.int16)
                          for c in comps]
                latched = [None] * len(comps)
                coef_bits = [np.full(64, -1, np.int64) for _ in comps]
                space = ("grey" if len(comps) == 1 else _colour_space(comps, jfif, adobe_transform)
                         if forced is None else forced)
            nxt = _scan(lib, data, nxt, body, frame, planes, latched, coef_bits, qt, huff,
                        restart, what)
            n_scans += 1
        elif 0xE1 <= code <= 0xEF or code in (0xFE, 0xDC, 0xCC):
            pass  # APPn, COM, DNL, DAC: nothing that changes the pixels
        else:
            raise ValueError(f"{what}: unsupported JPEG marker 0xFF{code:02X}")
        pos = nxt
    if frame is None or n_scans == 0:
        raise ValueError(f"{what}: JPEG without a frame or a scan")
    comps = frame["comps"]
    if frame["progressive"] and _smoothing_wanted(coef_bits, comps, latched):
        raise ValueError(f"{what}: progressive JPEG whose scans leave AC coefficients "
                         "unrefined (block smoothing) is not supported")
    h, w, hmax, vmax = frame["h"], frame["w"], frame["hmax"], frame["vmax"]
    out = []
    for c, plane, q in zip(comps, planes, latched):
        dh, dw = _ceil_div(h * c["v"], vmax), _ceil_div(w * c["h"], hmax)  # downsampled size
        px = _idct_islow(plane, np.zeros(64, np.int64) if q is None else q)[:dh, :dw]
        out.append(_upsample(px, c["h"], c["v"], hmax, vmax, h, w, what))
    return out, space, frame


def _scan(lib, data, start, body, frame, planes, latched, coef_bits, qt, huff, restart, what):
    """Parse one SOS header, latch its quantisation tables, check its
    progression as libjpeg's ``start_pass_phuff_decoder`` does, and decode
    its entropy-coded data into ``planes``; returns the position after it."""
    comps = frame["comps"]
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:  # libjpeg: bogus marker length
        raise ValueError(f"{what}: bad JPEG scan header")
    ids = [c["id"] for c in comps]
    idx, tables = [], []
    for i in range(ns):
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        if cs not in ids:
            raise ValueError(f"{what}: JPEG scan names component {cs}, not in the frame")
        ci = ids.index(cs)
        if latched[ci] is None:
            if comps[ci]["tq"] not in qt:
                raise ValueError(f"{what}: JPEG quantisation table {comps[ci]['tq']} undefined")
            latched[ci] = qt[comps[ci]["tq"]].copy()
        idx.append(ci)
        tables.append((t >> 4, t & 15))
    ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    progressive = frame["progressive"]
    if progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        bad |= (ah != 0 and al != ah - 1) or al > 13
        if bad:
            raise ValueError(f"{what}: bad JPEG progression Ss={ss} Se={se} Ah={ah} Al={al}")
        for ci in idx:
            coef_bits[ci][ss:se + 1] = al
    if ns > 1 and sum(comps[ci]["h"] * comps[ci]["v"] for ci in idx) > _MAX_BLOCKS_IN_MCU:
        raise ValueError(f"{what}: JPEG sampling factors too large for an interleaved scan")
    # the DC table is needed by sequential scans and first DC scans, the AC
    # table by sequential scans and AC scans; absent ones pass as zeros
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss > 0
    spec = b""
    for (td, ta) in tables:
        for cls, tid, need in ((0, td, need_dc), (1, ta, need_ac)):
            if need and (cls, tid) not in huff:
                raise ValueError(f"{what}: JPEG Huffman table {tid} undefined")
            spec += huff.get((cls, tid), bytes(272)) if need else bytes(272)
    geom = []
    for ci in idx:
        c = comps[ci]
        bw = _ceil_div(frame["w"] * c["h"], 8 * frame["hmax"])  # libjpeg's width_in_blocks
        bh = _ceil_div(frame["h"] * c["v"], 8 * frame["vmax"])
        hs, vs = (c["h"], c["v"]) if ns > 1 else (1, 1)
        geom += [hs, vs, planes[ci].shape[1], bw, bh]
    geom = np.asarray(geom, np.int32)
    ptrs = (ctypes.c_void_p * ns)(*[planes[ci].ctypes.data for ci in idx])
    end = ctypes.c_int64(0)
    rc = lib.akr_jpeg_scan(
        data, len(data), start, ns, ptrs, geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        spec, frame["mcux"], frame["mcuy"], ss, se, ah, al, int(progressive), restart,
        ctypes.byref(end))
    if rc:
        raise ValueError(f"{what}: JPEG {_NATIVE_ERRORS.get(rc, f'decoder error {rc}')}")
    return end.value


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


def _upsample(px, hs, vs, hmax, vmax, h, w, what):
    """[dh, dw] uint8 component samples -> [h, w] uint8, as libjpeg chooses:
    h2v1 and h2v2 fancy (triangle) upsampling when the component is more
    than 2 samples wide, else replication; h1v2 fancy; other integral
    factors by replication. Edge samples are replicated, from the
    component's own width and height."""
    x = px.astype(np.int32)
    dw = x.shape[1]
    if hs == hmax and vs == vmax:
        out = x
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
