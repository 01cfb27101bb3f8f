"""Old-style JPEG TIFFs (compression 6) as PIL reads them, without PIL.

PIL takes an old-style JPEG TIFF for YCbCr (``TiffImagePlugin._setup``
forces photometric 6 and, without a SamplesPerPixel tag, three samples)
and hands it to libtiff 4.7.1, whose ``tif_ojpeg.c`` rebuilds a JPEG stream
from the file and decodes it with libjpeg. This module follows it:

- the directory as libtiff fixes it for this compression: photometric RGB,
  or none, read as YCbCr; no SamplesPerPixel: three for YCbCr, one for
  grey;
- the subsampling libtiff decodes with, and its RGBA reader then takes:
  the frame's own (the YCbCrSubsampling tag's, its values cut to a byte,
  or 2 x 2, only where the stream has no frame header);
- the stream: a source of bytes that is the JPEGInterchangeFormat range
  (cut to the file), then each strip's bytes (offsets of 0 or past the end
  skipped, a byte count of 0 read to the end of the file). libtiff reads
  the markers from the start of that source (SOI, APPn and COM skipped,
  DQT tables of 65 bytes, DHT segments kept whole, DRI, SOF0 / SOF1 with
  its checks of samples, precision, size and sampling, SOS; any other
  marker an error) up to the scan; with no frame header it builds one
  from JPEGQTables, JPEGDCTables and JPEGACTables (a table each sample,
  repeated where an offset repeats the one before). It then writes SOI,
  the tables, DRI, SOF and SOS of its own and the rest of the source,
  putting an RSTn after each strip but the last and an EOI at the end.
  With more than one strip the restart interval is a strip's MCUs
  (rows per strip a multiple of 8 x the vertical subsampling); with one, the
  JPEGRestartInterval tag's or the stream's DRI;
- the decoding: libjpeg's raw output (no upsampling, no colour
  conversion: ``core/jpeg.py``'s scans and IDCT), packed into TIFF's
  YCbCr blocks (hs x vs luma samples, then Cb and Cr) for libtiff's RGBA
  reader, which repeats each block's chroma over the block and converts
  with ``tif_color.c``'s tables (``tiff._ycbcr_rgba``); a grey stream's
  samples as they are.

That is why PIL's read of an old-style JPEG TIFF differs from its read of
the same stream as a JPEG file. At 4:2:0 libjpeg upsamples chroma with its
triangle filter, and libtiff's RGBA reader repeats it over each 2 x 2 block:
near a colour edge the two differ by tens of levels (59 on the committed
2048^2 albedo). At 4:4:4 nothing is upsampled and only the conversion's
arithmetic differs: libjpeg's 16-bit fixed-point tables against
libtiff's float32 ones, at most one level apart.

Refused, naming the form: tiles, separate planes, three samples that
libtiff does not take for YCbCr, a frame other than SOF0 / SOF1 (libtiff's
SOF3 is lossless, which the raw path cannot take), libjpeg desubsampling
inside the decoder (a chroma component not sampled 1 x 1), and every
stream libtiff or libjpeg refuses. A YCbCr strip that fails to decode is
refused as well: libtiff's RGBA reader, which PIL uses here, goes on from
its buffer as it stood.
"""

from __future__ import annotations

import struct

import numpy as np

_SOI, _SOS, _DQT, _DHT, _DRI = 0xD8, 0xDA, 0xDB, 0xC4, 0xDD
JIF, JIF_LENGTH, RESTART, QTABLES, DCTABLES, ACTABLES = 513, 514, 515, 519, 520, 521


def libtiff_photometric(ifd):
    """TIFFReadDirectory's fix-up for compression 6: no photometric, or RGB,
    read as YCbCr."""
    photo = ifd.lenient(262, None, 1)
    return 6 if photo is None or photo[0] == 2 else photo[0]


def libtiff_samples(ifd):
    """SamplesPerPixel as libtiff reads it for compression 6: the tag, else
    three for YCbCr and one for grey."""
    spp = ifd.lenient(277, None, 1)
    if spp is not None:
        return spp[0]
    return 3 if libtiff_photometric(ifd) == 6 else 1


class _Source:
    """tif_ojpeg.c's input buffer: the bytes of a list of segments read in
    order, each ``(start, end, strip)``, ``strip`` the strip's index or None
    for the JPEGInterchangeFormat range."""

    def __init__(self, data, segments, what):
        self.data, self.segments, self.what = data, segments, what
        self.seg, self.pos = 0, segments[0][0] if segments else 0

    def _settle(self):
        while self.seg < len(self.segments) and self.pos >= self.segments[self.seg][1]:
            self.seg += 1
            if self.seg < len(self.segments):
                self.pos = self.segments[self.seg][0]
        return self.seg < len(self.segments)

    def peek(self):
        if not self._settle():
            raise ValueError(f"{self.what}: old-style JPEG data ends in its markers (libtiff: "
                             "premature end of JPEG data)")
        return self.data[self.pos]

    def byte(self):
        b = self.peek()
        self.pos += 1
        return b

    def word(self):
        return self.byte() << 8 | self.byte()

    def block(self, n):
        return bytes(self.byte() for _ in range(n))

    def rest(self):
        """The compressed data libtiff writes after its SOS: the rest of the
        source, an RSTn after each strip's last bytes where a strip follows
        (skipped ones included), and EOI after the last strip's. Where the
        source runs dry after an RSTn, or without strip data, libtiff's
        next read fails ("Premature end of JPEG data"): the stream then
        ends without a marker, which the decoder reads as the end of the
        data (an error once it needs more)."""
        out = bytearray()
        n_strips = sum(1 for s in self.segments if s[2] is not None)
        rst, eoi = 0, False
        for k in range(self.seg, len(self.segments)):
            start, end, strip = self.segments[k]
            part = self.data[(self.pos if k == self.seg else start):end]
            if not part:
                continue
            out += part
            # libtiff writes the RSTn or EOI once it has handed out a strip's
            # last bytes
            if strip is not None and strip + 1 < n_strips:
                out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
            eoi = strip is not None and strip + 1 == n_strips
        return bytes(out) + (b"\xff\xd9" if eoi else b"")


class OJpeg:
    """One old-style JPEG image's decoded strips (``block``)."""

    def __init__(self, data, ifd, lt, xsize, ysize, what):
        self.what = what
        if lt.tiled:
            raise ValueError(f"{what}: tiled old-style JPEG TIFF is not supported")
        spp = libtiff_samples(ifd)
        photo = libtiff_photometric(ifd)
        if spp == 3 and lt.planar != 1:
            raise ValueError(f"{what}: old-style JPEG TIFF in separate planes is not "
                             "supported")
        if spp not in (1, 3):
            raise ValueError(f"{what}: old-style JPEG TIFF of {spp} samples per pixel "
                             "(libtiff: not supported for this compression scheme)")
        if spp == 3 and photo != 6:
            raise ValueError(f"{what}: old-style JPEG TIFF of photometric {photo} with three "
                             "samples is not supported (libtiff decodes it as YCbCr)")
        if spp == 1 and photo not in (0, 1):
            raise ValueError(f"{what}: old-style JPEG TIFF of photometric {photo} with one "
                             "sample is not supported")
        self.spp, self.width, self.height = spp, xsize, ysize
        rps = ifd.lt(278, (0xFFFFFFFF,), 1)[0]
        strile_length = ysize if rps == 0xFFFFFFFF else rps
        tag_sampling = ifd.lenient(530, None, 2)
        # OJPEGVSetField keeps the tag's values as bytes
        hs, vs = ((v & 255 for v in (tag_sampling + (2, 2))[:2]) if tag_sampling else (2, 2))
        size = len(data)
        jif, jif_len = ifd.lenient(JIF, (0,), 1)[0], ifd.lenient(JIF_LENGTH, (0,), 1)[0]
        if jif >= size:
            jif = jif_len = 0
        elif jif and (jif_len == 0 or jif + jif_len > size):
            jif_len = size - jif
        segments = [(jif, jif + jif_len, None)] if jif and jif_len else []
        for k, (off, cnt) in enumerate(zip(lt.offsets, lt.counts)):
            if off == 0 or off >= size:
                segments.append((0, 0, k))  # skipped, but a strip all the same
                continue
            end = size if cnt == 0 or off + cnt > size else off + cnt
            segments.append((off, end, k))
        if spp == 3:
            # OJPEGSubsamplingCorrect: the frame header's sampling, if any
            sof = self._markers(data, segments, True)
            if sof is not None:
                hs, vs = sof
                if hs not in (1, 2, 4) or vs not in (1, 2, 4) or self.desubsample:
                    raise ValueError(f"{what}: old-style JPEG whose luma is sampled {hs}x{vs} "
                                     "or whose chroma is not sampled 1x1 is not supported "
                                     "(libjpeg would desubsample it inside the decoder)")
        else:
            hs = vs = 1
        self.sampling = (hs, vs)
        restart = ifd.lenient(RESTART, (0,), 1)[0]
        if strile_length < ysize:
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise ValueError(f"{what}: old-style JPEG TIFF sampled {hs}x{vs} (libtiff: "
                                 "invalid subsampling values)")
            if strile_length % (vs * 8):
                raise ValueError(f"{what}: old-style JPEG TIFF of {strile_length} rows a strip "
                                 f"sampled {hs}x{vs} (libtiff: incompatible vertical "
                                 "subsampling and image strip length)")
            restart = -(-xsize // (hs * 8)) * (strile_length // (vs * 8))
        self.restart = restart & 0xFFFF
        try:
            stream = self._stream(data, ifd, segments)
            self.planes = self._decode(stream, hs, vs)
        except ValueError as e:
            if spp == 1:
                raise
            raise ValueError(f"{e} (PIL reads such a file from libtiff's buffer as it stood: "
                             "its RGBA reader goes on over a strip that fails to decode)") from None

    # ---------------------------------------------------------------- markers

    def _markers(self, data, segments, correct):
        """OJPEGReadHeaderInfoSec: in ``correct`` mode (libtiff's first pass
        for the subsampling) the frame's luma sampling or None, errors
        ignored; else the tables, frame and scan, the source left after the
        scan header."""
        what = self.what
        src = _Source(data, segments, what)
        self.src = src
        self.qt, self.dc, self.ac = {}, {}, {}
        self.sof = self.sos = None
        try:
            while True:
                if src.peek() != 0xFF:
                    break
                src.byte()
                m = src.byte()
                while m == 0xFF:
                    m = src.byte()
                if m == _SOI:
                    continue
                if m == 0xFE or 0xE0 <= m <= 0xEF:
                    n = src.word()
                    if n < 2:
                        raise ValueError(f"{what}: corrupt old-style JPEG data (libtiff: "
                                         "corrupt JPEG data)")
                    src.block(n - 2)
                elif m == _DRI:
                    if src.word() != 4:
                        raise ValueError(f"{what}: corrupt DRI marker in old-style JPEG data")
                    self.restart = src.word()
                elif m == _DQT:
                    n = src.word()
                    if n <= 2:
                        raise ValueError(f"{what}: corrupt DQT marker in old-style JPEG data")
                    if correct:
                        src.block(n - 2)
                        continue
                    n -= 2
                    while n > 0:
                        if n < 65:
                            raise ValueError(f"{what}: corrupt DQT marker in old-style JPEG "
                                             "data")
                        body = src.block(65)
                        if body[0] & 15 > 3:
                            raise ValueError(f"{what}: corrupt DQT marker in old-style JPEG "
                                             "data")
                        self.qt[body[0] & 15] = b"\xff\xdb\x00\x43" + body
                        n -= 65
                elif m == _DHT:
                    n = src.word()
                    if n <= 2:
                        raise ValueError(f"{what}: corrupt DHT marker in old-style JPEG data")
                    body = src.block(n - 2)
                    if correct:
                        continue
                    o = body[0]
                    table = self.dc if o & 0xF0 == 0 else self.ac if o & 0xF0 == 16 else None
                    if table is None or o & 15 > 3:
                        raise ValueError(f"{what}: corrupt DHT marker in old-style JPEG data")
                    table[o & 15] = b"\xff\xc4" + struct.pack(">H", n) + body
                elif m in (0xC0, 0xC1, 0xC3):
                    got = self._sof(src, m, correct)
                    if correct:
                        return got
                elif m == _SOS:
                    if correct:
                        return None
                    self._sos(src)
                    break
                else:
                    raise ValueError(f"{what}: old-style JPEG data with marker 0xFF{m:02X} "
                                     "(libtiff: unknown marker type in JPEG data)")
        except ValueError:
            if correct:
                return None
            raise
        return None

    def _sof(self, src, marker, correct):
        what = self.what
        if self.sof is not None:
            raise ValueError(f"{what}: corrupt old-style JPEG data (libtiff: a second frame "
                             "header)")
        n = src.word()
        if n < 11 or (n - 8) % 3:
            raise ValueError(f"{what}: corrupt SOF marker in old-style JPEG data")
        nc = (n - 8) // 3
        if not correct and nc != self.spp:
            raise ValueError(f"{what}: old-style JPEG frame of {nc} components for {self.spp} "
                             "samples (libtiff: unexpected number of samples)")
        if src.byte() != 8:
            raise ValueError(f"{what}: old-style JPEG of a precision other than 8 bits "
                             "(libtiff: unexpected number of bits per sample)")
        y, x = src.word(), src.word()
        if not correct:
            if y < self.height:
                raise ValueError(f"{what}: old-style JPEG frame of {y} rows for {self.height} "
                                 "(libtiff: unexpected height)")
            if x != self.width:
                raise ValueError(f"{what}: old-style JPEG frame {x} wide for {self.width} "
                                 "(libtiff: unexpected width)")
        if src.byte() != nc:
            raise ValueError(f"{what}: corrupt SOF marker in old-style JPEG data")
        comps = [src.block(3) for _ in range(nc)]
        if correct:
            self.desubsample = any(c[1] != 0x11 for c in comps[1:])
            return comps[0][1] >> 4, comps[0][1] & 15
        hs, vs = self.sampling
        for k, c in enumerate(comps):
            if c[1] != ((hs << 4 | vs) if k == 0 else 0x11):
                raise ValueError(f"{what}: old-style JPEG frame sampled otherwise than "
                                 "expected (libtiff: unexpected subsampling values)")
        if marker == 0xC3:
            raise ValueError(f"{what}: lossless (SOF3) old-style JPEG is not supported")
        self.sof = (marker, y, x, comps)
        return None

    def _sos(self, src):
        what = self.what
        if self.sof is None:
            raise ValueError(f"{what}: corrupt SOS marker in old-style JPEG data (no frame "
                             "header before it)")
        if src.word() != 6 + 2 * self.spp or src.byte() != self.spp:
            raise ValueError(f"{what}: corrupt SOS marker in old-style JPEG data")
        self.sos = [src.block(2) for _ in range(self.spp)]
        src.block(3)  # Ss, Se, Ah / Al: libtiff writes 0, 63, 0

    def _tag_tables(self, data, ifd):
        """OJPEGReadHeaderInfoSecTables*: the tables from the tags, a
        segment each of the first ``spp`` offsets, shared where an offset
        repeats the one before."""
        what = self.what
        try:
            offsets = [ifd.lt(tag, (), 3) for tag in (QTABLES, DCTABLES, ACTABLES)]
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
        for tag, offs in zip((QTABLES, DCTABLES, ACTABLES), offsets):
            if ifd.entries_all.get(tag, (0, 0))[1] > 3:
                raise ValueError(f"{what}: old-style JPEG tag {tag} of more than 3 offsets "
                                 "(libtiff: incorrect count)")
            if not offs or offs[0] == 0:
                raise ValueError(f"{what}: old-style JPEG TIFF without a frame header or "
                                 "tables (libtiff: missing JPEG tables)")
        qo, do, ao = ((o + (0,) * 3)[:3] for o in offsets)
        sof_tq, tda = [], []
        for m in range(self.spp):
            # quantisation tables
            if qo[m] and (m == 0 or qo[m] != qo[m - 1]):
                if any(qo[m] == qo[n] for n in range(m - 1)):
                    raise ValueError(f"{what}: corrupt JPEGQTables tag value")
                body = data[qo[m]:qo[m] + 64]
                if len(body) != 64:
                    raise ValueError(f"{what}: old-style JPEG quantisation table past the "
                                     "end of the file")
                self.qt[m] = b"\xff\xdb\x00\x43" + bytes([m]) + body
                sof_tq.append(m)
            else:
                sof_tq.append(sof_tq[m - 1])
            td = ta = None
            for offs, cls, store, name in ((do, 0, self.dc, "DC"), (ao, 16, self.ac, "AC")):
                if offs[m] and (m == 0 or offs[m] != offs[m - 1]):
                    if any(offs[m] == offs[n] for n in range(m - 1)):
                        raise ValueError(f"{what}: corrupt JPEG{name}Tables tag value")
                    counts = data[offs[m]:offs[m] + 16]
                    q = sum(counts)
                    vals = data[offs[m] + 16:offs[m] + 16 + q]
                    if len(counts) != 16 or len(vals) != q:
                        raise ValueError(f"{what}: old-style JPEG {name} table past the end of "
                                         "the file")
                    store[m] = (b"\xff\xc4" + struct.pack(">H", 19 + q) + bytes([cls | m])
                                + counts + vals)
                    sel = m
                else:
                    sel = (tda[m - 1] >> 4) if cls == 0 else (tda[m - 1] & 15)
                if cls == 0:
                    td = sel
                else:
                    ta = sel
            tda.append(td << 4 | ta)
        hs, vs = self.sampling
        comps = [bytes([m, (hs << 4 | vs) if m == 0 else 0x11, sof_tq[m]])
                 for m in range(self.spp)]
        self.sof = (0xC0, self.height, self.width, comps)
        self.sos = [bytes([m, tda[m]]) for m in range(self.spp)]

    def _stream(self, data, ifd, segments):
        """The JPEG stream libtiff hands libjpeg (module docstring)."""
        if not segments:
            raise ValueError(f"{self.what}: old-style JPEG TIFF without data")
        self._markers(data, segments, False)
        if self.sof is None:
            self._tag_tables(data, ifd)
        marker, y, x, comps = self.sof
        out = bytearray(b"\xff\xd8")
        for table in (self.qt, self.dc, self.ac):
            for k in range(4):
                if k in table:
                    out += table[k]
        if self.restart:
            out += b"\xff\xdd\x00\x04" + struct.pack(">H", self.restart)
        out += bytes([0xFF, marker]) + struct.pack(">HBHHB", 8 + 3 * self.spp, 8, y, x, self.spp)
        out += b"".join(comps)
        # a frame header without a scan header leaves libtiff's SOS fields 0
        sos = self.sos or [bytes(2)] * self.spp
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * self.spp, self.spp) + b"".join(sos)
        out += b"\x00\x3f\x00"
        return bytes(out) + self.src.rest()

    # ---------------------------------------------------------------- decoding

    def _decode(self, stream, hs, vs):
        from .jpeg import _idct_islow, read_scans

        frame, scans, _ = read_scans(stream, self.what, space="raw", strip=True,
                                     strict_restarts=True)
        if frame["w"] != self.width:
            raise ValueError(f"{self.what}: old-style JPEG {frame['w']} wide for {self.width} "
                             "(libtiff: unexpected image width)")
        if self.spp == 3 and (frame["hmax"], frame["vmax"]) != (hs, vs):
            raise ValueError(f"{self.what}: old-style JPEG sampled {frame['hmax']}x"
                             f"{frame['vmax']}, expected {hs}x{vs} (libtiff: unexpected "
                             "subsampling factors)")
        return [_idct_islow(p, np.zeros(64, np.int64) if q is None else q)
                for p, q in zip(scans.planes, scans.latched)]

    def block(self, index, rows, rps):
        """The bytes libtiff's OJPEGDecode gives strip ``index``: ``rows``
        rows of grey samples, or (YCbCr) the TIFF blocks of ``rows`` rows
        rounded up to the vertical subsampling."""
        y0 = index * rps
        if self.spp == 1:
            return np.ascontiguousarray(self.planes[0][y0:y0 + rows, :self.width]).reshape(-1)
        hs, vs = self.sampling
        nby, nbx = -(-rows // vs), -(-self.width // hs)
        b0 = y0 // vs
        y, cb, cr = self.planes
        luma = y[b0 * vs:(b0 + nby) * vs, :nbx * hs].reshape(nby, vs, nbx, hs)
        units = np.concatenate([luma.transpose(0, 2, 1, 3).reshape(nby, nbx, hs * vs),
                                cb[b0:b0 + nby, :nbx, None], cr[b0:b0 + nby, :nbx, None]], -1)
        return units.reshape(-1)
