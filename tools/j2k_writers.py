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
