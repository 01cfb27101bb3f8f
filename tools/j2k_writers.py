"""Writers of the JPEG 2000 files ``Image.save(..., "JPEG2000")`` cannot
write, for the PyTorch port's decoder tests and fixtures.

- ``encode``: OpenJPEG's own encoder (the ``libopenjp2`` Pillow bundles),
  reached through ``ctypes``, with what Pillow's writer does not expose:
  code-block styles (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), progression
  order changes (POC), tile-parts, subsampled, signed and any-precision
  components, ROI shifts, SOP / EPH markers, PLT / TLM markers, guard bits;
- ``jp2``: a codestream wrapped in hand-built JP2 boxes (any ``colr``
  colour space or an ICC profile, ``pclr`` / ``cmap`` / ``cdef``, ``res ``);
- ``to_ppm`` / ``to_ppt``: a codestream written with SOP and EPH markers
  rewritten with its packet headers moved into PPM (main header) or PPT
  (tile-part header) marker segments.

Needs PIL installed (for its bundled library); numpy and ctypes otherwise.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile

import numpy as np

_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block style bits (COD / COC SPcod)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


class _Poc(ctypes.Structure):
    _fields_ = [("resno0", ctypes.c_uint32), ("compno0", ctypes.c_uint32),
                ("layno1", ctypes.c_uint32), ("resno1", ctypes.c_uint32),
                ("compno1", ctypes.c_uint32), ("layno0", ctypes.c_uint32),
                ("precno0", ctypes.c_uint32), ("precno1", ctypes.c_uint32),
                ("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5),
                ("tile", ctypes.c_uint32), ("tx0", ctypes.c_int32), ("tx1", ctypes.c_int32),
                ("ty0", ctypes.c_int32), ("ty1", ctypes.c_int32)] + [
        (n, ctypes.c_uint32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                                       "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                                       "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")]


_I = ctypes.c_int
_PATH = 4096


class _CParams(ctypes.Structure):
    """opj_cparameters_t of OpenJPEG 2.5."""
    _fields_ = [
        ("tile_size_on", _I), ("cp_tx0", _I), ("cp_ty0", _I), ("cp_tdx", _I), ("cp_tdy", _I),
        ("cp_disto_alloc", _I), ("cp_fixed_alloc", _I), ("cp_fixed_quality", _I),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", _I),
        ("prog_order", _I), ("POC", _Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", _I), ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", _I),
        ("cblockw_init", _I), ("cblockh_init", _I), ("mode", _I), ("irreversible", _I),
        ("roi_compno", _I), ("roi_shift", _I), ("res_spec", _I), ("prcw_init", _I * 33),
        ("prch_init", _I * 33), ("infile", ctypes.c_char * _PATH),
        ("outfile", ctypes.c_char * _PATH), ("index_on", _I), ("index", ctypes.c_char * _PATH),
        ("image_offset_x0", _I), ("image_offset_y0", _I), ("subsampling_dx", _I),
        ("subsampling_dy", _I), ("decod_format", _I), ("cod_format", _I),
        ("jpwl_epc_on", _I), ("jpwl_hprot_MH", _I), ("jpwl_hprot_TPH_tileno", _I * 16),
        ("jpwl_hprot_TPH", _I * 16), ("jpwl_pprot_tileno", _I * 16),
        ("jpwl_pprot_packno", _I * 16), ("jpwl_pprot", _I * 16), ("jpwl_sens_size", _I),
        ("jpwl_sens_addr", _I), ("jpwl_sens_range", _I), ("jpwl_sens_MH", _I),
        ("jpwl_sens_TPH_tileno", _I * 16), ("jpwl_sens_TPH", _I * 16), ("cp_cinema", _I),
        ("max_comp_size", _I), ("cp_rsiz", _I), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", _I),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", _I), ("rsiz", ctypes.c_uint16),
    ]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd", "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32),
                ("y1", ctypes.c_uint32), ("numcomps", ctypes.c_uint32), ("color_space", _I),
                ("comps", ctypes.POINTER(_ImageComp)), ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_lib = None
_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


def library():
    """PIL's bundled libopenjp2, bound; the parameter layout is checked
    against the encoder's defaults."""
    global _lib
    if _lib is not None:
        return _lib
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                  "pillow.libs", "libopenjp2*.so*"))
    if not libs:
        raise RuntimeError("PIL's bundled libopenjp2 was not found")
    lib = ctypes.CDLL(libs[0])
    vp = ctypes.c_void_p
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_set_default_encoder_parameters.argtypes = [ctypes.POINTER(_CParams)]
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CmptParm), _I]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
    lib.opj_create_compress.restype = vp
    lib.opj_create_compress.argtypes = [_I]
    lib.opj_setup_encoder.restype = _I
    lib.opj_setup_encoder.argtypes = [vp, ctypes.POINTER(_CParams), ctypes.POINTER(_Image)]
    lib.opj_encoder_set_extra_options.restype = _I
    lib.opj_encoder_set_extra_options.argtypes = [vp, ctypes.POINTER(ctypes.c_char_p)]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, _I]
    for name in ("opj_start_compress",):
        getattr(lib, name).restype = _I
        getattr(lib, name).argtypes = [vp, ctypes.POINTER(_Image), vp]
    for name in ("opj_encode", "opj_end_compress"):
        getattr(lib, name).restype = _I
        getattr(lib, name).argtypes = [vp, vp]
    lib.opj_set_error_handler.restype = _I
    lib.opj_set_error_handler.argtypes = [vp, _MSG, vp]
    lib.opj_stream_destroy.argtypes = [vp]
    lib.opj_destroy_codec.argtypes = [vp]
    lib.opj_set_MCT.restype = _I
    lib.opj_set_MCT.argtypes = [ctypes.POINTER(_CParams), ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32]
    p = _CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    if not (p.numresolution == 6 and p.cblockw_init == 64 and p.cblockh_init == 64
            and p.roi_compno == -1 and p.subsampling_dx == 1 and p.decod_format == -1
            and p.cod_format == -1):
        raise RuntimeError("opj_cparameters_t layout does not match this libopenjp2")
    _lib = lib
    return lib


def encode(planes, *, dx=None, dy=None, prec=8, sgnd=False, offset=(0, 0), size=None,
           irreversible=False, num_resolutions=None, cblk=(64, 64), mode=0,
           progression="LRCP", tile=None, tile_offset=(0, 0), precincts=None, rates=(0,),
           mct=0, sop=False, eph=False, roi=None, poc=(), tile_parts=None, extra=(),
           custom_mct=None):
    """Encode ``planes`` (a list of [h_c, w_c] integer arrays, one per
    component, each already at its own subsampled size) with OpenJPEG as a
    raw codestream (``jp2`` wraps one).

    ``dx`` / ``dy`` per-component subsampling; ``prec`` / ``sgnd`` one value
    or one per component; ``offset`` the image origin on the reference grid
    and ``size`` its extent (by default component 0's size times its
    subsampling);
    ``mode`` the code-block style bits; ``rates`` one compression ratio per
    layer (0: lossless); ``num_resolutions`` by default the most OpenJPEG
    takes for the tile size, up to 6; ``poc`` (resno0, compno0, layno1, resno1, compno1,
    progression, tile) tuples, tiles numbered from 1; ``tile_parts`` "R",
    "L" or "C"; ``roi`` (component, shift); ``extra`` encoder options such
    as "PLT=YES"; ``custom_mct`` (matrix, offsets) for a Part-2 transform.
    Returns the file bytes."""
    lib = library()
    n = len(planes)
    dx = dx or [1] * n
    dy = dy or [1] * n
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * n
    sgnds = sgnd if isinstance(sgnd, (list, tuple)) else [sgnd] * n
    x0, y0 = offset
    w, h = size or (planes[0].shape[1] * dx[0], planes[0].shape[0] * dy[0])
    parms = (_CmptParm * n)()
    for i, p in enumerate(planes):
        cw = -(-(x0 + w) // dx[i]) - -(-x0 // dx[i])
        ch = -(-(y0 + h) // dy[i]) - -(-y0 // dy[i])
        if p.shape != (ch, cw):
            raise ValueError(f"component {i} is {p.shape}, the grid gives {(ch, cw)}")
        parms[i].dx, parms[i].dy = dx[i], dy[i]
        parms[i].w, parms[i].h = cw, ch
        parms[i].x0, parms[i].y0 = -(-x0 // dx[i]), -(-y0 // dy[i])
        parms[i].prec, parms[i].bpp, parms[i].sgnd = precs[i], precs[i], int(bool(sgnds[i]))
    img = lib.opj_image_create(n, parms, 0)  # colour space unspecified
    if not img:
        raise RuntimeError("opj_image_create failed")
    im = img.contents
    im.x0, im.y0, im.x1, im.y1 = x0, y0, x0 + w, y0 + h
    for i, p in enumerate(planes):
        c = im.comps[i]
        flat = np.ascontiguousarray(p, np.int32).reshape(-1)
        ctypes.memmove(c.data, flat.ctypes.data, flat.nbytes)
    prm = _CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(prm))
    prm.tcp_numlayers = len(rates)
    for i, r in enumerate(rates):
        prm.tcp_rates[i] = r
    prm.cp_disto_alloc = 1
    prm.irreversible = int(irreversible)
    if num_resolutions is None:  # the most OpenJPEG allows, up to its default of 6
        side = min(tile or (w, h))
        num_resolutions = max(1, min(6, side.bit_length()))
    prm.numresolution = num_resolutions
    prm.cblockw_init, prm.cblockh_init = cblk
    prm.mode = mode
    prm.prog_order = _PROG[progression]
    prm.tcp_mct = bytes([mct])
    prm.csty = (2 if sop else 0) | (4 if eph else 0)
    if tile:
        prm.tile_size_on = 1
        prm.cp_tdx, prm.cp_tdy = tile
        prm.cp_tx0, prm.cp_ty0 = tile_offset
    if precincts:
        prm.csty |= 1
        prm.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            prm.prcw_init[i], prm.prch_init[i] = pw, ph
    if roi:
        prm.roi_compno, prm.roi_shift = roi
    for i, (r0, c0, l1, r1, c1, prg, t) in enumerate(poc):
        q = prm.POC[i]
        q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = r0, c0, l1, r1, c1
        q.prg1, q.tile = _PROG[prg], t
    prm.numpocs = len(poc)
    if tile_parts:
        prm.tp_on = b"\x01"
        prm.tp_flag = tile_parts.encode()
    if custom_mct is not None:
        matrix, offsets = custom_mct
        m = (ctypes.c_float * (n * n))(*np.asarray(matrix, np.float32).reshape(-1))
        o = (ctypes.c_int32 * n)(*offsets)
        if not lib.opj_set_MCT(ctypes.byref(prm), m, o, n):
            raise RuntimeError("opj_set_MCT failed")
    cdc = lib.opj_create_compress(0)  # OPJ_CODEC_J2K
    errors = []
    handler = _MSG(lambda msg, _: errors.append(msg.decode(errors="replace").strip()))
    lib.opj_set_error_handler(cdc, handler, None)
    try:
        if not lib.opj_setup_encoder(cdc, ctypes.byref(prm), img):
            raise RuntimeError("opj_setup_encoder failed")
        if extra:
            opts = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
            if not lib.opj_encoder_set_extra_options(cdc, opts):
                raise RuntimeError("opj_encoder_set_extra_options failed")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "out").encode()
            stream = lib.opj_stream_create_default_file_stream(path, 0)
            try:
                ok = (lib.opj_start_compress(cdc, img, stream) and lib.opj_encode(cdc, stream)
                      and lib.opj_end_compress(cdc, stream))
            finally:
                lib.opj_stream_destroy(stream)
            if not ok:
                raise RuntimeError(f"OpenJPEG failed to encode: {'; '.join(errors)}")
            with open(path, "rb") as f:
                return f.read()
    finally:
        lib.opj_destroy_codec(cdc)
        lib.opj_image_destroy(img)


def box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2(codestream, w, h, nc, bpc=7, colr=(1, 16), pclr=None, cmap=None, cdef=None, res=None,
        extra_header=(), ftyp=b"jp2 \x00\x00\x00\x00jp2 "):
    """Wrap ``codestream`` in a JP2 file: signature, ``ftyp``, ``jp2h``
    (``ihdr`` of ``w`` x ``h``, ``nc`` components of ``bpc`` (size - 1, sign
    in bit 7), then ``colr`` as (1, enumcs) or (2, icc bytes) or None,
    ``pclr`` as (bit depths, [entries, columns] array), ``cmap`` as (comp,
    mtyp, pcol) triples, ``cdef`` as (channel, type, association) triples,
    ``res `` raw body, ``extra_header`` boxes) and the codestream box."""
    hdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    if colr is not None:
        meth, v = colr
        hdr += box(b"colr", bytes([meth, 0, 0]) + (struct.pack(">I", v) if meth == 1 else v))
    if pclr is not None:
        depths, entries = pclr
        entries = np.asarray(entries)
        body = struct.pack(">HB", entries.shape[0], len(depths)) + bytes(depths)
        for row in entries:
            for d, v in zip(depths, row):
                nb = min(((d & 0x7F) + 8) >> 3, 4)
                body += int(v).to_bytes(nb, "big")
        hdr += box(b"pclr", body)
    if cmap is not None:
        hdr += box(b"cmap", b"".join(struct.pack(">HBB", *t) for t in cmap))
    if cdef is not None:
        hdr += box(b"cdef", struct.pack(">H", len(cdef))
                   + b"".join(struct.pack(">HHH", *t) for t in cdef))
    if res is not None:
        hdr += box(b"res ", res)
    for b in extra_header:
        hdr += b
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"ftyp", ftyp) + box(b"jp2h", hdr)
            + box(b"jp2c", codestream))


def _split_packets(body):
    """A tile-part body written with SOP and EPH markers -> [(header incl.
    EPH, data)] per packet (the SOP markers are dropped here)."""
    out = []
    pos = 0
    while pos < len(body):
        if body[pos:pos + 2] != b"\xff\x91":
            raise ValueError("expected an SOP marker")
        start = pos + 6
        eph = body.index(b"\xff\x92", start)
        nxt = body.find(b"\xff\x91", eph + 2)
        nxt = len(body) if nxt < 0 else nxt
        out.append((body[start:eph + 2], body[eph + 2:nxt]))
        pos = nxt
    return out


def _segments(cs):
    """The marker segments of a codestream: main header, then per tile-part
    (SOT segment, other header segments, body); EOC dropped."""
    pos = 2
    main = []
    while cs[pos:pos + 2] != b"\xff\x90":
        ln = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        main.append(cs[pos:pos + 2 + ln])
        pos += 2 + ln
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        end = pos + psot
        q = pos + 12
        segs = []
        while cs[q:q + 2] != b"\xff\x93":
            ln = struct.unpack(">H", cs[q + 2:q + 4])[0]
            segs.append(cs[q:q + 2 + ln])
            q += 2 + ln
        parts.append((cs[pos:pos + 12], segs, cs[q + 2:end]))
        pos = end
    return main, parts


def _rebuild(main, parts):
    out = b"\xff\x4f" + b"".join(main)
    for sot, segs, body in parts:
        hdr = b"".join(segs)
        psot = 12 + len(hdr) + 2 + len(body)
        out += sot[:6] + struct.pack(">I", psot) + sot[10:] + hdr + b"\xff\x93" + body
    return out + b"\xff\xd9"


def _marker_chunks(kind, payload, first_z=0, limit=65000):
    out = []
    for z, i in enumerate(range(0, len(payload), limit)):
        body = bytes([first_z + z]) + payload[i:i + limit]
        out.append(kind + struct.pack(">H", 2 + len(body)) + body)
    return out


def to_ppm(cs, split=1):
    """Move every packet header of ``cs`` (written with SOP and EPH) into
    PPM segments of the main header, ``split`` of them."""
    main, parts = _segments(cs)
    payload = b""
    new_parts = []
    for sot, segs, body in parts:
        pk = _split_packets(body)
        hdrs = b"".join(h for h, _ in pk)
        payload += struct.pack(">I", len(hdrs)) + hdrs
        new_parts.append((sot, segs, b"".join(b"\xff\x91\x00\x04" + struct.pack(">H", i & 0xffff)
                                              + d for i, (_, d) in enumerate(pk))))
    limit = -(-len(payload) // split)
    return _rebuild(main + _marker_chunks(b"\xff\x60", payload, limit=max(limit, 1)), new_parts)


def to_ppt(cs, split=1):
    """Move every packet header of ``cs`` (written with SOP and EPH) into
    PPT segments of its tile-part header, ``split`` of them per tile-part."""
    main, parts = _segments(cs)
    new_parts = []
    for sot, segs, body in parts:
        pk = _split_packets(body)
        hdrs = b"".join(h for h, _ in pk)
        limit = max(-(-len(hdrs) // split), 1)
        new_parts.append((sot, segs + _marker_chunks(b"\xff\x61", hdrs, limit=limit),
                          b"".join(b"\xff\x91\x00\x04" + struct.pack(">H", i & 0xffff) + d
                                   for i, (_, d) in enumerate(pk))))
    return _rebuild(main, new_parts)


# ---------------------------------------------------------------------------
# HTJ2K (JPEG 2000 Part 15): a writer of its own
#
# OpenJPEG 2.5 decodes HT code-blocks but has no HT encoder, so ``encode_ht``
# writes the codestream itself: the forward transforms (5/3 with the RCT,
# 9/7 with the ICT and expounded quantisation), the HT block coder (the
# cleanup pass's MEL, VLC / UVLC and MagSgn streams; SigProp and MagRef
# passes) and tier 2 (tag trees, pass counts, Lblock, segment lengths as
# OpenJPEG reads them). The VLC codewords come from inverting OpenJPEG's
# decode tables (``akari_torch/native/j2k_ht_tables.h``). Its only check is
# PIL: a reversible file reads back through PIL as its input.

_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
_HT_BOOK = None


def _ht_book():
    """[table, context, rho, u_off, emb] -> (codeword, length, e_k): the
    codeword of OpenJPEG's tables (0: the first quad row, 1: the others) that
    decodes to ``rho`` / ``u_off`` with an ``e_k`` / ``e_1`` that holds for a
    quad whose samples at the exponent U_q are ``emb``, and costs the fewest
    bits (its length, less a MagSgn bit per sample in ``e_k``); length -1
    where none does."""
    global _HT_BOOK
    if _HT_BOOK is None:
        from tools.extract_ht_tables import read_header

        book = np.full((2, 8, 16, 2, 16, 3), -1, np.int64)
        for t, tbl in enumerate(read_header()):
            for c in range(8):
                for i in range(128):
                    e = int(tbl[c << 7 | i])
                    n = e & 7
                    cw, uoff, rho, e1, ek = i & ((1 << n) - 1), e >> 3 & 1, e >> 4 & 15, \
                        e >> 8 & 15, e >> 12 & 15
                    for emb in range(16):
                        if uoff and (emb & ~rho or e1 != ek & emb):
                            continue
                        cur = book[t, c, rho, uoff, emb]
                        cost = n - bin(ek).count("1")
                        if cur[1] < 0 or cost < cur[1] - bin(int(cur[2])).count("1"):
                            book[t, c, rho, uoff, emb] = (cw, n, ek)
        _HT_BOOK = book
    return _HT_BOOK


def _bits_of(vals, lens):
    """The bits of ``vals`` (each ``lens`` long, least significant first) one
    after another, as a uint8 array."""
    vals, lens = np.asarray(vals, np.int64).ravel(), np.asarray(lens, np.int64).ravel()
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    if not lens.size:
        return np.zeros(0, np.uint8)
    starts = np.cumsum(lens) - lens
    idx = np.arange(int(lens.sum())) - np.repeat(starts, lens)
    return ((np.repeat(vals, lens) >> idx) & 1).astype(np.uint8)


def _forward_bytes(bits, pad):
    """A forward byte stream (MagSgn, SigProp): bits least significant first,
    a byte after 0xFF carries 7 (its top bit a stuffed 0); the last byte is
    filled with ``pad`` bits."""
    out, pos = bytearray(), 0
    while pos < len(bits):
        chunk = np.concatenate([bits[pos:], np.full(7, pad, np.uint8)])
        full = np.packbits(chunk[:len(chunk) - len(chunk) % 8], bitorder="little")
        n = -(-(len(bits) - pos) // 8)
        full = full[:n]
        ff = np.flatnonzero(full == 0xFF)
        if not ff.size or ff[0] == n - 1:
            out += full.tobytes()
            break
        j = int(ff[0])
        out += full[:j + 1].tobytes()
        pos += 8 * (j + 1)
        seven = np.concatenate([bits[pos:pos + 7], np.full(7, pad, np.uint8)])[:7]
        out.append(int(np.packbits(seven, bitorder="little")[0]))
        pos += 7
    return out


def _reverse_bytes(bits, nibble):
    """A reverse byte stream (VLC, MagRef) in the order it is read: bits least
    significant first; after a byte above 0x8F, 7 bits that are all ones go
    in a byte of their own (a stuffed 0 on top). ``nibble``: the first byte
    holds 4 bits above the low nibble of Scup and follows a byte above 0x8F
    (VLC); else a whole byte after one above 0x8F (MagRef)."""
    bits = np.concatenate([bits, np.zeros(16, np.uint8)])
    k = len(bits) - 16
    out, pos = bytearray(), 0
    if nibble:
        if k and bits[:3].all():
            out.append(0x7F)
            pos = 3
        else:
            out.append(0x0F | int(np.packbits(bits[:4], bitorder="little")[0]) << 4)
            pos = 4
        last8f = out[-1] > 0x8F
    else:
        last8f = True
    while pos < k:
        n = -(-(k - pos) // 8)
        full = np.packbits(bits[pos:pos + 8 * n], bitorder="little")
        prev = np.concatenate([[0x90 if last8f else 0], full[:-1]])
        stuff = np.flatnonzero((prev > 0x8F) & ((full & 0x7F) == 0x7F))
        if not stuff.size:
            out += full.tobytes()
            break
        j = int(stuff[0])
        out += full[:j].tobytes()
        out.append(0x7F)
        pos += 8 * j + 7
        last8f = False
    return out


def _mel_bytes(events):
    """The MEL byte stream of a sequence of 0 / 1 events (bits most
    significant first, 7 after a 0xFF byte; never ending in 0xFF)."""
    out, k, run, last = [], 0, 0, -1
    ones = np.flatnonzero(events)
    for i in ones:
        run += int(i) - last - 1
        last = int(i)
        while run >= 1 << _MEL_EXP[k]:
            out.append(1)
            run -= 1 << _MEL_EXP[k]
            k = min(12, k + 1)
        out.append(0)
        e = _MEL_EXP[k]
        out.extend((run >> (e - 1 - j)) & 1 for j in range(e))
        run = 0
        k = max(0, k - 1)
    run += len(events) - last - 1
    while run >= 1 << _MEL_EXP[k]:
        out.append(1)
        run -= 1 << _MEL_EXP[k]
        k = min(12, k + 1)
    if run:
        out.append(1)
    res, pos = bytearray(), 0
    while pos < len(out):
        n = 7 if res and res[-1] == 0xFF else 8
        chunk = out[pos:pos + n] + [0] * (n - len(out[pos:pos + n]))
        res.append(int("".join(map(str, chunk)), 2))
        pos += n
    if res and res[-1] == 0xFF:
        res.append(0)
    return res


_UX = np.arange(64)
_UVLC = np.stack([np.select([_UX == 1, _UX == 2, _UX <= 4], [1, 2, 4], 0),
                  np.select([_UX == 1, _UX == 2], [1, 2], 3),
                  np.select([_UX <= 2, _UX <= 4], [0, _UX - 3], _UX - 5),
                  np.select([_UX <= 2, _UX <= 4], [0, 1], 5)])


def _uvlc(x):
    """UVLC prefix (value, length) and suffix (value, length) of u >= 1."""
    return _UVLC[:, x]


def _quads(a, qh, qw):
    """[2 qh, 2 qw] -> [qh, qw, 4], samples in quad order (top-left,
    bottom-left, top-right, bottom-right)."""
    return a.reshape(qh, 2, qw, 2).transpose(0, 2, 3, 1).reshape(qh, qw, 4)


def _ht_cleanup(mu, sgn):
    """The HT cleanup segment of magnitudes ``mu`` (the bits at and above the
    cleanup bit-plane) and signs ``sgn`` of one code-block."""
    h, w = mu.shape
    qh, qw = (h + 1) // 2, (w + 1) // 2
    qw2 = qw + (qw & 1)  # whole quad pairs; the extra quad is absent
    m = np.zeros((2 * qh, 2 * qw2), np.int64)
    s = np.zeros_like(m)
    m[:h, :w], s[:h, :w] = mu, sgn
    mq, sq = _quads(m, qh, qw2), _quads(s, qh, qw2)
    sig = (mq > 0).astype(np.int64)
    bit = 1 << np.arange(4)
    rho = (sig * bit).sum(-1)
    e = np.where(mq > 0, np.frexp(np.maximum(2 * mq - 1, 1).astype(np.float64))[1], 0)
    v = np.where(mq > 0, 2 * (mq - 1) + sq, 0)
    # contexts (Part 15's significance of the neighbouring samples)
    left = np.zeros_like(sig)
    left[:, 1:] = sig[:, :-1]
    ctx = np.zeros((qh, qw2), np.int64)
    ctx[0] = (left[0, :, 0] | left[0, :, 1]) + 2 * left[0, :, 2] + 4 * left[0, :, 3]
    kappa = np.ones((qh, qw2), np.int64)
    if qh > 1:
        up = sig[:-1]
        nf = np.zeros_like(up[..., 1])
        nf[:, :-1] = up[:, 1:, 1]
        nw = np.zeros_like(nf)
        nw[:, 1:] = up[:, :-1, 3]
        ctx[1:] = ((up[..., 1] | nw) + 2 * (left[1:, :, 2] | left[1:, :, 3])
                   + 4 * (up[..., 3] | nf))
        eb = np.pad(e[:-1][..., [1, 3]].reshape(qh - 1, 2 * qw2), ((0, 0), (1, 2)))
        cols = 2 * np.arange(qw2)
        emax = np.max(np.stack([eb[:, cols + j] for j in range(4)]), 0)
        many = np.array([bin(r).count("1") > 1 for r in range(16)])[rho[1:]]
        kappa[1:] = np.where(many, np.maximum(emax - 1, 1), 1)
    big_u = np.maximum(kappa, e.max(-1))
    u = np.where(rho > 0, big_u - kappa, 0)
    uoff = (u > 0).astype(np.int64)
    emb = ((e == big_u[..., None]) * bit).sum(-1) * uoff
    table = np.ones((qh, qw2), np.int64)
    table[0] = 0
    cw, cl, ek = np.moveaxis(_ht_book()[table, ctx, rho, uoff, emb], -1, 0)
    exists = np.zeros((qh, qw2), bool)
    exists[:, :qw] = True
    need = exists & ((ctx != 0) | (rho != 0))
    if (cl[need] < 0).any():
        raise ValueError("no VLC codeword for a quad")
    cl = np.where(need, cl, 0)
    # MagSgn: m_n = U_q - e_k bits of each significant sample
    mlen = np.where(sig > 0, big_u[..., None] - ((ek[..., None] >> np.arange(4)) & 1), 0)
    magsgn = _forward_bytes(_bits_of(v & ((1 << mlen) - 1), mlen), 1)
    if magsgn and magsgn[-1] == 0xFF:
        del magsgn[-1]  # the decoder reads 0xFF past the end
    # per quad pair: MEL events and the VLC codewords then the UVLC code
    p = lambda a: a.reshape(qh, qw2 // 2, 2)  # noqa: E731
    ctx2, rho2, u2, uoff2, ex2 = p(ctx), p(rho), p(u), p(uoff), p(exists)
    row0 = (np.arange(qh) == 0)[:, None]
    both = (uoff2[..., 0] & uoff2[..., 1]).astype(bool)
    mel4 = row0 & both & (u2[..., 0] > 2) & (u2[..., 1] > 2)
    events = np.stack([np.where(ctx2[..., 0] == 0, rho2[..., 0] != 0, -1),
                       np.where(ex2[..., 1] & (ctx2[..., 1] == 0), rho2[..., 1] != 0, -1),
                       np.where(row0 & both, mel4, -1)], -1).reshape(-1)
    mel = _mel_bytes(events[events >= 0])
    x = np.where(mel4[..., None], u2 - 2, u2)
    pv, pl, sv, sl = _uvlc(np.maximum(x, 1))
    pl, sl = pl * uoff2, sl * uoff2
    one = row0 & both & ~mel4 & (x[..., 0] >= 3)  # u_q2 in {1, 2} as one bit
    first = uoff2[..., 0] > 0  # the first u coded is the first quad's
    slot_v = np.stack([p(cw)[..., 0], p(cw)[..., 1], np.where(first, pv[..., 0], pv[..., 1]),
                       np.where(one, x[..., 1] - 1, np.where(both, pv[..., 1], 0)),
                       np.where(first, sv[..., 0], sv[..., 1]),
                       np.where(both & ~one, sv[..., 1], 0)], -1)
    slot_l = np.stack([p(cl)[..., 0], p(cl)[..., 1], np.where(first, pl[..., 0], pl[..., 1]),
                       np.where(one, 1, np.where(both, pl[..., 1], 0)),
                       np.where(first, sl[..., 0], sl[..., 1]),
                       np.where(both & ~one, sl[..., 1], 0)], -1)
    vlc = _reverse_bytes(_bits_of(slot_v, slot_l), nibble=True)
    scup = len(mel) + len(vlc) + 1
    if scup > 4079:
        raise ValueError(f"MEL and VLC streams of {scup} bytes (at most 4079)")
    vlc[0] = (vlc[0] & 0xF0) | (scup & 0xF)
    return bytes(magsgn + mel + vlc[::-1]) + bytes([scup >> 4])


def _ht_refinement(mag, sgn, group, causal):
    """The SigProp then MagRef passes of bit-plane 0 (the cleanup coded
    ``mag >> 1``): the SigProp bits forward, the MagRef bits reversed from
    the end. Stripes of 4 rows, column by column; a sample is coded when one
    of its neighbours is significant by then (not the next stripe's when
    ``causal``, the VSC style); the signs of the samples that became
    significant follow each ``group`` of columns. A sample of magnitude 1
    that no significant neighbour reaches is not coded: it reads as 0."""
    h, w = mag.shape
    cur = (mag >> 1) > 0
    mr, sp = [], []
    for y0 in range(0, h, 4):
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                if cur[y, x]:
                    mr.append(mag[y, x] & 1)
    for y0 in range(0, h, 4):
        for x0 in range(0, w, group):
            new = []
            for x in range(x0, min(x0 + group, w)):
                for y in range(y0, min(y0 + 4, h)):
                    below = y + 2 if not (causal and y % 4 == 3) else y + 1
                    if cur[y, x] or not cur[max(y - 1, 0):below, max(x - 1, 0):x + 2].any():
                        continue
                    b = int(mag[y, x] & 1)
                    sp.append(b)
                    if b:
                        cur[y, x] = True
                        new.append(int(sgn[y, x]))
            sp.extend(new)
    return bytes(_forward_bytes(np.array(sp, np.uint8), 0)
                 + _reverse_bytes(np.array(mr, np.uint8), nibble=False)[::-1])


class _TagTree:
    """A tag tree over a [h, w] grid of leaf values (OpenJPEG's layout)."""

    def __init__(self, values):
        h, w = values.shape
        self.parent, self.value, levels = [], [], []
        a = values.astype(np.int64)
        while True:
            levels.append(a)
            if a.size <= 1:
                break
            hh, ww = a.shape
            b = np.full(((hh + 1) // 2, (ww + 1) // 2), 1 << 30, np.int64)
            for j in range(hh):
                for i in range(ww):
                    b[j // 2, i // 2] = min(b[j // 2, i // 2], a[j, i])
            a = b
        base = 0
        for k, lev in enumerate(levels):
            nxt = base + lev.size
            for j in range(lev.shape[0]):
                for i in range(lev.shape[1]):
                    self.value.append(int(lev[j, i]))
                    self.parent.append(-1 if k + 1 == len(levels) else
                                       nxt + (j // 2) * levels[k + 1].shape[1] + i // 2)
            base = nxt
        self.low = [0] * len(self.value)
        self.known = [False] * len(self.value)

    def encode(self, out, leaf, threshold):
        stk, node = [], leaf
        while self.parent[node] >= 0:
            stk.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        out.append(1)
                        self.known[node] = True
                    break
                out.append(0)
                low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()


def _header_bytes(bits):
    """Packet header bits (most significant first, 7 after 0xFF), padded; a
    last 0xFF is followed by 0x00 as OpenJPEG's reader expects."""
    out, pos = bytearray(), 0
    while pos < len(bits):
        n = 7 if out and out[-1] == 0xFF else 8
        chunk = bits[pos:pos + n]
        out.append(int("".join(map(str, chunk + [0] * (n - len(chunk)))), 2))
        pos += n
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def _numpasses(out, n):
    if n == 1:
        out.append(0)
    elif n == 2:
        out += [1, 0]
    elif n <= 5:
        out += [1, 1] + [(n - 3) >> 1 & 1, (n - 3) & 1]
    elif n <= 36:
        out += [1, 1, 1, 1] + [(n - 6) >> (4 - j) & 1 for j in range(5)]
    else:
        out += [1] * 9 + [(n - 37) >> (6 - j) & 1 for j in range(7)]


def _fdwt53(x):
    """One level of the reversible 5/3 along the last axis (lows then highs)."""
    n = x.shape[-1]
    if n <= 1:
        return x.copy()
    ev, od = x[..., 0::2].copy(), x[..., 1::2].copy()
    right = ev[..., 1:] if n % 2 else np.concatenate([ev[..., 1:], ev[..., -1:]], -1)
    od -= (ev[..., :od.shape[-1]] + right) >> 1
    left = np.concatenate([od[..., :1], od], -1)[..., :ev.shape[-1]]
    nxt = od if n % 2 == 0 else np.concatenate([od, od[..., -1:]], -1)
    ev += (left + nxt + 2) >> 2
    return np.concatenate([ev, od], -1)


def _fdwt97(x):
    """One level of the irreversible 9/7 along the last axis, the inverse of
    OpenJPEG's lifting (lows scaled by 1/K, highs by K/2)."""
    n = x.shape[-1]
    if n <= 1:
        return x.copy()
    ev, od = x[..., 0::2].astype(np.float64), x[..., 1::2].astype(np.float64)
    for i, c in enumerate((-1.586134342, -0.052980118, 0.882911075, 0.443506852)):
        if i % 2 == 0:  # highs from their even neighbours (mirrored at the end)
            right = ev[..., 1:] if n % 2 else np.concatenate([ev[..., 1:], ev[..., -1:]], -1)
            od += c * (ev[..., :od.shape[-1]] + right)
        else:  # lows from their odd neighbours (mirrored at both ends)
            left = np.concatenate([od[..., :1], od], -1)[..., :ev.shape[-1]]
            nxt = od if n % 2 == 0 else np.concatenate([od, od[..., -1:]], -1)
            ev += c * (left + nxt)
    k = 1.230174105
    return np.concatenate([ev / k, od * (k / 2)], -1)


def _bands(plane, levels, reversible):
    """The forward DWT of ``plane``: [(resolution, bandno, array)], lowest
    resolution first, bands HL, LH, HH in each."""
    a = plane.astype(np.int64 if reversible else np.float64)
    f = _fdwt53 if reversible else _fdwt97
    dims = [a.shape]
    for _ in range(levels):
        rh, rw = dims[-1]
        sub = f(a[:rh, :rw].T).T
        a[:rh, :rw] = f(sub)
        dims.append(((rh + 1) // 2, (rw + 1) // 2))
    out = [(0, 0, a[:dims[-1][0], :dims[-1][1]])]
    for r in range(1, levels + 1):
        rh, rw = dims[levels - r]
        lh, lw = dims[levels - r + 1]
        out += [(r, 1, a[:lh, lw:rw]), (r, 2, a[lh:rh, :lw]), (r, 3, a[lh:rh, lw:rw])]
    return out


def encode_ht(planes, *, prec=8, irreversible=False, mct=None, num_resolutions=None,
              cblk=(64, 64), precincts=None, passes=1, step=1.0, group=4, placeholders=0,
              cblk_style=0x40):
    """Encode ``planes`` (a list of [h, w] unsigned integer arrays, one per
    component) as an HTJ2K codestream: one tile, one quality layer, LRCP, two
    guard bits, Rsiz bit 14 and
    a CAP marker, HT code-blocks of ``cblk`` samples (Part 15 allows any
    w * h <= 4096, such as 128 x 32).

    ``irreversible``: the 9/7 and expounded quantisation with step
    ``step`` (else the 5/3, lossless); ``mct``: the RCT / ICT over three
    components (the default for three or four); ``precincts`` (log2 width,
    log2 height) per resolution; ``passes`` 1 (the cleanup pass codes every
    bit-plane), 2 (cleanup above bit-plane 0, then a SigProp pass) or 3
    (cleanup, SigProp and MagRef: lossless but for the samples of magnitude
    1 that SigProp cannot reach); ``group`` the columns
    whose SigProp signs follow their significance bits; ``placeholders`` HT
    sets signalled ahead of the cleanup pass (OpenJPEG refuses them);
    ``cblk_style`` the SPcod code-block style byte. Returns the bytes."""
    n = len(planes)
    h, w = planes[0].shape
    if any(p.shape != (h, w) for p in planes):
        raise ValueError("the components must be one size")
    if mct is None:
        mct = n >= 3
    levels = (num_resolutions or max(1, min(6, min(w, h).bit_length()))) - 1
    comps = [np.asarray(p, np.int64) - (1 << (prec - 1)) for p in planes]
    extra = [0] * n
    if mct:
        r, g, b = comps[:3]
        if irreversible:
            r, g, b = (c.astype(np.float64) for c in (r, g, b))
            comps[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                         -0.16875 * r - 0.331260 * g + 0.5 * b,
                         0.5 * r - 0.41869 * g - 0.08131 * b]
        else:
            comps[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
            extra[1] = extra[2] = 1
    xcb, ycb = cblk[0].bit_length() - 1, cblk[1].bit_length() - 1
    gains = (0, 1, 1, 2)
    qcds, tiles = [], []
    for c in range(n):
        bands = _bands(comps[c], levels, not irreversible)
        steps = []
        out = []
        for r, bandno, a in bands:
            if irreversible:
                expn, mant = _expounded(step, prec)
                delta = (1 + mant / 2048.0) * 2.0 ** (prec - expn)
                q = (np.sign(a) * np.floor(np.abs(a) / delta)).astype(np.int64)
            else:
                expn, mant = prec + extra[c] + gains[bandno], 0
                q = a
            mb = expn + 1  # two guard bits
            if np.abs(q).max(initial=0) >= 1 << mb:
                raise ValueError(f"a coefficient needs more than {mb} bit-planes")
            steps.append((expn, mant))
            out.append((r, bandno, q, mb))
        qcds.append(steps)
        tiles.append(out)
    body = _ht_tier2(tiles, levels, xcb, ycb, precincts, passes, group, placeholders,
                     bool(cblk_style & VSC))
    # main header
    siz = struct.pack(">HIIIIIIIIH", 0x4000, w, h, 0, 0, w, h, 0, 0, n)
    siz += b"".join(struct.pack(">BBB", prec - 1, 1, 1) for _ in range(n))
    out = b"\xff\x4f" + _seg(0xFF51, siz) + _seg(0xFF50, struct.pack(">IH", 0x00020000, 0))
    scod = 1 if precincts else 0
    cod = struct.pack(">BBHBBBBBB", scod, 0, 1, int(bool(mct)), levels, xcb - 2, ycb - 2,
                      cblk_style, 0 if irreversible else 1)
    if precincts:
        cod += bytes((pp[1] << 4) | pp[0] for pp in precincts[:levels + 1])
    out += _seg(0xFF52, cod)
    for c in range(n):
        qnt = 2 if irreversible else 0
        sq = bytes([2 << 5 | qnt])
        sq += b"".join(struct.pack(">H", e << 11 | m) if irreversible else bytes([e << 3])
                       for e, m in qcds[c])
        out += _seg(0xFF5C, sq) if c == 0 else _seg(0xFF5D, bytes([c]) + sq)
    sot = struct.pack(">HIBB", 0, 12 + 2 + len(body), 0, 1)
    return out + _seg(0xFF90, sot) + b"\xff\x93" + body + b"\xff\xd9"


def _seg(marker, payload):
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _expounded(step, prec):
    """(exponent, mantissa) of a quantisation step of 2^(prec - e) (1 + m / 2048)."""
    e = prec - int(np.floor(np.log2(step)))
    m = int(round((step / 2.0 ** (prec - e) - 1) * 2048))
    if m == 2048:
        e, m = e - 1, 0
    return e, m


def _ht_tier2(tiles, levels, xcb, ycb, precincts, passes, group, placeholders, causal):
    """The packets of the tile (one layer, LRCP): per resolution and component
    each precinct's header (inclusion and zero bit-plane tag trees, pass
    counts, Lblock, the lengths of the cleanup and refinement segments as
    OpenJPEG reads them) and the code-blocks' bytes."""
    body = b""
    for r in range(levels + 1):
        for bands in tiles:
            rb = [(bandno, q, mb) for rr, bandno, q, mb in bands if rr == r]
            ppx, ppy = precincts[r] if precincts else (15, 15)
            # band-domain precinct and code-block sizes
            bpx, bpy = (ppx, ppy) if r == 0 else (ppx - 1, ppy - 1)
            cbx, cby = min(xcb, bpx), min(ycb, bpy)
            bh = max(q.shape[0] for _, q, _ in rb)
            bw = max(q.shape[1] for _, q, _ in rb)
            npx = max(1, -(-bw // (1 << bpx))) if bw else 0
            npy = max(1, -(-bh // (1 << bpy))) if bh else 0
            for py in range(npy):
                for px in range(npx):
                    bits, data = [1], b""
                    for bandno, q, mb in rb:
                        y0, x0 = py << bpy, px << bpx
                        region = q[y0:y0 + (1 << bpy), x0:x0 + (1 << bpx)]
                        if region.size == 0:
                            continue
                        ch = -(-region.shape[0] // (1 << cby))
                        cw = -(-region.shape[1] // (1 << cbx))
                        blocks, incl, msb = [], np.ones((ch, cw), np.int64), np.zeros((ch, cw),
                                                                                       np.int64)
                        for j in range(ch):
                            for i in range(cw):
                                blk = region[j << cby:(j + 1) << cby, i << cbx:(i + 1) << cbx]
                                mag, sgn = np.abs(blk), (blk < 0).astype(np.int64)
                                if not mag.any():
                                    blocks.append(None)
                                    continue
                                if passes == 1:
                                    segs = [_ht_cleanup(mag, sgn)]
                                    pc = 0
                                else:
                                    ref = _ht_refinement(mag, sgn, group, causal)
                                    segs = [_ht_cleanup(mag >> 1, sgn), ref]
                                    pc = 1
                                missing = mb - 1 - pc - placeholders
                                if missing < 0:
                                    raise ValueError("too few bit-planes for this code-block")
                                incl[j, i], msb[j, i] = 0, missing
                                blocks.append(segs)
                        ti, tz = _TagTree(incl), _TagTree(msb)
                        for k, segs in enumerate(blocks):
                            ti.encode(bits, k, 1)
                            if segs is None:
                                continue
                            tz.encode(bits, k, 999)
                            npass = 3 * placeholders + (1 if passes == 1 else passes)
                            if npass > 1 and len(segs) == 1:
                                segs = segs + [b""]
                            _numpasses(bits, npass)
                            lens = [len(s) for s in segs]
                            need = [max(1, lens[0].bit_length())]
                            if len(segs) > 1:
                                need.append(max(1, lens[1].bit_length())
                                            - (npass - 1).bit_length() + 1)
                            lblock = max(3, *need)
                            bits += [1] * (lblock - 3) + [0]
                            bits += [lens[0] >> (lblock - 1 - j) & 1 for j in range(lblock)]
                            if len(segs) > 1:
                                nb = lblock + (npass - 1).bit_length() - 1
                                bits += [lens[1] >> (nb - 1 - j) & 1 for j in range(nb)]
                            data += b"".join(segs)
                    body += _header_bytes(bits) + data
    return body


# ---------------------------------------------------------------------------
# Part-2 marker segments (MCT, MCC, MCO, CBD) to splice into a codestream

_MCT_FORMATS = {0: ">H", 1: ">i", 2: ">f", 3: ">d"}  # int16, int32, float32, float64


def mct(index, element_type, values, zmct=0, ymct=0, array_type=2):
    """An MCT segment: array ``index`` of ``values`` (element type 0-3;
    array type 1 decorrelation, 2 offset)."""
    body = b"".join(struct.pack(_MCT_FORMATS[element_type], v) for v in values)
    return _seg(0xFF74, struct.pack(">HHH", zmct, element_type << 10 | array_type << 8 | index,
                                    ymct) + body)


def mcc(index, ncomps, deco=0, offset=0, reversible=1, zmcc=0, ymcc=0, collections=1, kind=1):
    """An MCC segment: one array-decorrelation collection of components
    0..ncomps-1 in and out, using MCT arrays ``deco`` and ``offset`` (0: none)."""
    body = struct.pack(">HBHH", zmcc, index, ymcc, collections)
    if collections:
        comps = struct.pack(">H", ncomps) + bytes(range(ncomps))
        body += bytes([kind]) + comps + comps + bytes([reversible, offset, deco])
    return _seg(0xFF75, body)


def mco(*stages):
    """An MCO segment naming the MCC records of its stages."""
    return _seg(0xFF77, bytes([len(stages)]) + bytes(stages))


def cbd(*depths):
    """A CBD segment: one Ssiz-style byte per component."""
    return _seg(0xFF78, struct.pack(">H", len(depths)) + bytes(depths))


def splice_main(cs, *segments):
    """``cs`` with ``segments`` put in its main header, after SIZ."""
    siz = cs.index(b"\xff\x51")
    end = siz + 2 + struct.unpack(">H", cs[siz + 2:siz + 4])[0]
    return cs[:end] + b"".join(segments) + cs[end:]


def splice_tile(cs, *segments):
    """``cs`` with ``segments`` put in its first tile-part header (Psot grown)."""
    sot = cs.index(b"\xff\x90")
    sod = cs.index(b"\xff\x93", sot)
    add = b"".join(segments)
    psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
    return cs[:sot + 6] + struct.pack(">I", psot + len(add)) + cs[sot + 10:sod] + add + cs[sod:]
