"""Port parity: the PIL-free image decoders (akari_torch/core/jpeg.py with
akari_torch/native/jpeg_entropy.cpp, and the PNG decoder of
akari_torch/core/image.py) against the JAX package's ``read_image``, which
reads JPEG and PNG with PIL.

Tolerance: exact. ``read_image`` of both packages gives the same float32
array bit for bit with ``to_linear`` True and False, and the port's 8-bit
pixels equal PIL's ``convert("RGB")``:

- JPEGs written by PIL: baseline at qualities 1-100 and 4:4:4 / 4:2:2 /
  4:2:0, progressive, optimized Huffman tables, restart markers, RGB kept
  (Adobe transform 0), grey, 16-bit quantisation tables (SOF1), at sizes
  that leave partial MCUs and narrow chroma planes; a hypothesis sweep of
  size, quality, subsampling, progressive and optimize;
- JPEGs built here by a small baseline encoder of the test's own
  (``_jpeg``): sampling factors PIL does not write (h1v2, 4:1:1, mixed),
  colour spaces chosen by component ids, and blocks of extreme
  coefficients (the reference's libjpeg-turbo runs its AVX2 IDCT on
  x86-64, which saturates where jidctint.c's table wraps);
- PNGs in every colour type and bit depth, with and without tRNS and
  ancillary chunks, Adam7-interlaced at 1x1, 3x2 and 33x17 (Pillow writes
  no interlaced, sub-byte grey or 16-bit colour PNG, so ``png_bytes`` builds
  them; PIL reads them);
- corrupt entropy-coded data and the forms PIL reads that the port once
  refused (``READ_ON``; the full sweeps are in
  ``tests/test_torch_image_jpeg_forms.py``);
- the refused forms raise ``ValueError`` naming themselves.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core.image import _chunk
from akari_torch.core import jpeg as port_jpeg
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import pattern, png_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
SIZES = [(1, 1), (7, 300), (33, 17), (17, 33), (64, 48)]   # (h, w)
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _same_read(path):
    """Both packages' read_image, linear and not: bit-equal."""
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return got


def _save_jpeg(tmp_path, px, name="a.jpg", mode="RGB", **kw):
    path = str(tmp_path / name)
    Image.fromarray(px).convert(mode).save(path, "JPEG", **kw)
    return path


# ------------------------------- JPEG from PIL --------------------------------

@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [1, 50, 75, 95, 100])
def test_baseline_jpeg_matches_pil(tmp_path, quality, sub, hw):
    px = pattern(*hw, seed=quality + 7 * hw[1])
    _same_read(_save_jpeg(tmp_path, px, quality=quality, subsampling=SUBSAMPLING[sub]))


QTABLES16 = [[max(1, (i * 37) % 700) for i in range(64)], [300 + i for i in range(64)]]
OPTIONS = {
    "progressive": dict(progressive=True, quality=80),
    "progressive-420-q100": dict(progressive=True, quality=100, subsampling=2),
    "optimize": dict(optimize=True, quality=60),
    "progressive-optimize": dict(progressive=True, optimize=True, quality=90, subsampling=1),
    "restart-blocks": dict(restart_marker_blocks=1, quality=70, subsampling=2),
    "restart-rows": dict(restart_marker_rows=1, quality=85),
    "keep-rgb": dict(keep_rgb=True, quality=90, subsampling=0),
    "grey": dict(mode="L", quality=75),
    "grey-progressive": dict(mode="L", progressive=True, quality=40),
    "qtables-16bit": dict(qtables=QTABLES16, subsampling=2),
    "qtables-16bit-progressive": dict(qtables=QTABLES16, progressive=True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_jpeg_options_match_pil(tmp_path, option):
    for i, hw in enumerate(SIZES):
        path = _save_jpeg(tmp_path, pattern(*hw, seed=i), name=f"{i}.jpg", **OPTIONS[option])
        _same_read(path)
    with open(path, "rb") as f:
        data = f.read()
    marker = {"qtables-16bit": b"\xff\xc1", "progressive": b"\xff\xc2", "keep-rgb": b"Adobe",
              "restart-rows": b"\xff\xdd"}.get(option)
    if marker:
        assert marker in data  # the form under test was written


@settings(derandomize=True, deadline=None, max_examples=60)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       sub=st.sampled_from([0, 1, 2]), progressive=st.booleans(), optimize=st.booleans())
def test_jpeg_sweep_matches_pil(h, w, quality, sub, progressive, optimize):
    buf = io.BytesIO()
    Image.fromarray(pattern(h, w, seed=h * 71 + w)).save(
        buf, "JPEG", quality=quality, subsampling=sub, progressive=progressive, optimize=optimize)
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(port_jpeg.decode_jpeg(data), want)


# ------------------------- JPEG built by the test ------------------------------

def _segment(code, body):
    return b"\xff" + bytes([code]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)  # byte stuffing
                self.acc = self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)  # pad with 1 bits
        return bytes(self.out)


def _jpeg(comps, h, w, q, qbits=8, app=b"", sof=0xC0, precision=8, restart=0):
    """A one-scan Huffman JPEG of ``comps`` = [(id, h, v, blocks)], blocks
    [rows, cols, 64] natural-order coefficients covering the MCU grid;
    every component uses quantisation table 0 (``q``, [64] natural order)
    and flat code tables: DC categories 0-15 at 5 bits, every AC symbol at
    8 bits."""
    out = b"\xff\xd8" + app
    qz = np.asarray(q)[port_jpeg.ZIGZAG]
    out += _segment(0xDB, bytes([0]) + bytes(qz.astype(np.uint8)) if qbits == 8
                    else bytes([0x10]) + qz.astype(">u2").tobytes())
    body = struct.pack(">BHHB", precision, h, w, len(comps))
    body += b"".join(bytes([cid, hs << 4 | vs, 0]) for cid, hs, vs, _ in comps)
    out += _segment(sof, body)
    dc_syms = list(range(16))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
    out += _segment(0xC4, bytes([0x00]) + bytes(4) + bytes([16]) + bytes(11) + bytes(dc_syms))
    out += _segment(0xC4, bytes([0x10]) + bytes(7) + bytes([len(ac_syms)]) + bytes(8)
                    + bytes(ac_syms))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([c[0], 0]) for c in comps)
                    + bytes([0, 63, 0]))
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcuy, mcux = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    bits, pred, data, n = _Bits(), [0] * len(comps), b"", 0

    def cat(v):
        return int(abs(v)).bit_length()

    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n and n % restart == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                bits, pred = _Bits(), [0] * len(comps)
            n += 1
            for ci, (_, hs, vs, blocks) in enumerate(comps):
                for v in range(vs):
                    for u in range(hs):
                        b = np.asarray(blocks[my * vs + v, mx * hs + u])[port_jpeg.ZIGZAG]
                        d = int(b[0]) - pred[ci]
                        pred[ci] = int(b[0])
                        bits.put(cat(d), 5)
                        bits.put(d if d >= 0 else d + (1 << cat(d)) - 1, cat(d))
                        nz = np.flatnonzero(b[1:]) + 1
                        k0 = 1
                        for k in nz:
                            run = k - k0
                            while run > 15:
                                bits.put(ac_syms.index(0xF0), 8)
                                run -= 16
                            s = cat(int(b[k]))
                            bits.put(ac_syms.index((run << 4) | s), 8)
                            bits.put(int(b[k]) if b[k] >= 0 else int(b[k]) + (1 << s) - 1, s)
                            k0 = k + 1
                        if k0 <= 63:
                            bits.put(ac_syms.index(0x00), 8)  # EOB
    return out + data + bits.flush() + b"\xff\xd9"


def _blocks(r, rows, cols, scale):
    """Seeded coefficient blocks whose energy falls with frequency."""
    k = np.arange(64)
    fall = scale / (1 + (k // 8 + k % 8)) ** 1.5
    return np.round(r.normal(0, 1, (rows, cols, 64)) * fall).astype(np.int64)


def _decode_both(data, tmp_path):
    path = tmp_path / "c.jpg"
    path.write_bytes(data)
    want = np.asarray(Image.open(str(path)).convert("RGB"))
    np.testing.assert_array_equal(port_jpeg.decode_jpeg(data), want)
    return _same_read(str(path))


# (h, v) of each of three components, the frame size, and an APP segment
CRAFTED = {
    "h1v2": ([(1, 2), (1, 1), (1, 1)], (37, 21), b""),
    "4:1:1": ([(4, 1), (1, 1), (1, 1)], (19, 45), b""),
    "mixed": ([(2, 2), (2, 1), (1, 2)], (29, 27), b""),
    "h2v2-narrow": ([(2, 2), (1, 1), (1, 1)], (13, 3), b""),
    "chroma-larger": ([(1, 1), (2, 2), (1, 1)], (17, 19), b""),
    "rgb-ids": ([(1, 1), (1, 1), (1, 1)], (16, 24), b""),
    "adobe-ycc": ([(1, 1), (1, 1), (1, 1)], (16, 24),
                  _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1]))),
    "adobe-rgb": ([(1, 1), (1, 1), (1, 1)], (16, 24),
                  _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))),
}


@pytest.mark.parametrize("case", list(CRAFTED))
def test_crafted_sampling_and_colour_spaces_match_pil(tmp_path, case):
    factors, (h, w), app = CRAFTED[case]
    r = np.random.default_rng(len(case))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcuy, mcux = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    ids = [82, 71, 66] if case == "rgb-ids" else [1, 2, 3]
    comps = [(cid, hs, vs, _blocks(r, mcuy * vs, mcux * hs, 300.0))
             for cid, (hs, vs) in zip(ids, factors)]
    q = r.integers(1, 12, 64)
    _decode_both(_jpeg(comps, h, w, q, app=app, restart=3 if case == "mixed" else 0), tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_extreme_coefficients_match_pil(tmp_path, seed):
    """Blocks of AC coefficients up to +-32767 (categories 11-15), row-0-only
    and DC-only blocks, 8- and 16-bit tables: the products leave 16 bits,
    where the reference's AVX2 IDCT saturates and wraps as the port's
    ``_idct_islow`` does."""
    r = np.random.default_rng(seed)
    n = 96
    blk = np.zeros((1, n, 64), np.int64)
    for i in range(n):
        mag = int(r.choice([8, 64, 1023, 4095, 32767]))
        if i % 4 == 0:
            blk[0, i, 0] = r.integers(-mag, mag + 1)
        elif i % 4 == 1:
            blk[0, i, :8] = r.integers(-mag, mag + 1, 8)
        else:
            keep = r.random(64) < r.choice([0.05, 0.3, 1.0])
            blk[0, i] = np.where(keep, r.integers(-mag, mag + 1, 64), 0)
    blk[..., 0] = blk[..., 0].clip(-16383, 16383)  # DC differences stay within category 15
    qbits = 16 if seed % 2 else 8
    q = r.integers(1, 65536 if qbits == 16 else 256, 64)
    _decode_both(_jpeg([(1, 1, 1, blk)], 8, 8 * n, q, qbits=qbits,
                       sof=0xC1 if qbits == 16 else 0xC0), tmp_path)


# ------------------------------ refused JPEG forms -----------------------------

def _pil_jpeg(**kw):
    buf = io.BytesIO()
    Image.fromarray(pattern(24, 40, 3)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _with_sof(data, code=None, precision=None):
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2))
    out = bytearray(data)
    if code is not None:
        out[i + 1] = code
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _without_refinement_scans(data):
    """A progressive file with its successive-approximation refinement
    scans of AC bands (Ah > 0) left out."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        code = data[pos + 1]
        if code == 0xD9:
            return bytes(out + data[pos:])
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        end = pos + 2 + length
        if code == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            ns = data[pos + 4]
            ss, ah = data[pos + 5 + 2 * ns], data[pos + 7 + 2 * ns] >> 4
            if ss > 0 and ah > 0:
                pos = end
                continue
        out += data[pos:end]
        pos = end
    raise AssertionError("no EOI")


def _with_dht(data, cls, counts0, symbols):
    """``data`` with a DHT segment inserted before its first scan that
    redefines table 0 of class ``cls`` (0 DC, 1 AC): ``counts0`` codes of
    length 1, which no prefix code holds past one."""
    i = data.index(b"\xff\xda")
    body = bytes([cls << 4, counts0]) + bytes(15) + bytes(symbols)
    return data[:i] + _segment(0xC4, body) + data[i:]


def _restart_out_of_sequence():
    """A file with a restart marker after every MCU whose RST1 reads RST3."""
    data = _pil_jpeg(restart_marker_blocks=1)
    i = data.index(b"\xff\xd1", data.index(b"\xff\xda"))
    return data[:i + 1] + b"\xd3" + data[i + 2:]


def _code_matching_nothing():
    """A scan whose first bits (11111) match no code of ``_jpeg``'s DC table,
    which holds 16 codes of 5 bits, 00000-01111, and no longer ones."""
    data = _jpeg([(1, 1, 1, _blocks(np.random.default_rng(0), 1, 2, 100.0))], 8, 16,
                 np.ones(64, np.int64))
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data[:start] + b"\xf8" + data[start + 1:]


# forms PIL refuses as well (libjpeg's JERR_BAD_HUFF_TABLE)
BAD_TABLES = {
    "huffman-oversubscribed-3": lambda: _with_dht(_pil_jpeg(), 0, 3, [0, 1, 2]),
    "huffman-oversubscribed-255": lambda: _with_dht(_pil_jpeg(), 1, 255, range(255)),
    "huffman-all-ones-code": lambda: _with_dht(_pil_jpeg(), 0, 2, [0, 1]),
}

# forms the port once refused and PIL reads: libjpeg resynchronises at a
# restart marker out of sequence, reads a bit pattern no code matches as
# symbol 0, decodes any bytes of a file relabelled arithmetic-coded, and
# smooths the blocks of a progressive file whose refinement scans are gone
READ_ON = {
    "restart-out-of-sequence": _restart_out_of_sequence,
    "no-matching-code": _code_matching_nothing,
    "arithmetic": lambda: _with_sof(_pil_jpeg(), code=0xC9),
    "arithmetic-progressive": lambda: _with_sof(_pil_jpeg(progressive=True), code=0xCA),
    "unrefined-progressive": lambda: _without_refinement_scans(_pil_jpeg(progressive=True)),
}

REFUSED = {
    **{form: (make, "bad Huffman table") for form, make in BAD_TABLES.items()},
    # a baseline scan header (Ss = 0, Se = 63) under SOF3: no predictor
    "lossless": (lambda: _with_sof(_pil_jpeg(), code=0xC3), "lossless"),
    "hierarchical": (lambda: _with_sof(_pil_jpeg(), code=0xC5), "hierarchical"),
    "12-bit": (lambda: _with_sof(_pil_jpeg(), precision=12), "12-bit"),
    "two-components": (lambda: _two_component_jpeg(), "2-component"),
    "truncated": (lambda: _pil_jpeg(quality=90)[:-300], "truncated"),
    "truncated-progressive": (lambda: _pil_jpeg(progressive=True)[:-200], "truncated"),
}


def _cmyk_jpeg(**kw):
    buf = io.BytesIO()
    Image.fromarray(pattern(16, 16, 4)).convert("CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def _two_component_jpeg():
    r = np.random.default_rng(2)
    return _jpeg([(1, 1, 1, _blocks(r, 2, 2, 100.0)), (2, 1, 1, _blocks(r, 2, 2, 100.0))],
                 16, 16, r.integers(1, 12, 64))


@pytest.mark.parametrize("kw", [dict(quality=90), dict(quality=30, subsampling=2),
                                dict(quality=75, progressive=True),
                                dict(quality=60, optimize=True, subsampling=1)],
                         ids=["q90", "q30-420", "progressive", "optimize-422"])
def test_cmyk_jpeg_written_by_pil_matches(tmp_path, kw):
    """PIL's CMYK JPEG (Adobe transform 0, stored inverted): libjpeg's CMYK
    read as PIL's CMYK;I and converted by its cmyk2rgb."""
    _decode_both(_cmyk_jpeg(**kw), tmp_path)


ADOBE = {
    "ycck-transform-2": _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2])),
    "ycck-transform-1": _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1])),
    "cmyk-transform-0": _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])),
    "cmyk-no-marker": b"",
    "cmyk-jfif": _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
}


@pytest.mark.parametrize("case", list(ADOBE))
def test_four_component_colour_spaces_match_pil(tmp_path, case):
    """libjpeg's colour space for four components by the Adobe marker
    (YCCK for transforms other than 0, converted as ycck_cmyk_convert),
    with sampled and interleaved components, against PIL."""
    r = np.random.default_rng(len(case))
    for factors, (h, w) in (([(1, 1)] * 4, (19, 27)), ([(2, 2), (1, 1), (1, 1), (2, 2)], (21, 17)),
                            ([(2, 1), (1, 1), (1, 1), (1, 1)], (9, 40))):
        hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
        mcuy, mcux = -(-h // (8 * vmax)), -(-w // (8 * hmax))
        comps = [(cid, hs, vs, _blocks(r, mcuy * vs, mcux * hs, 300.0))
                 for cid, (hs, vs) in zip([1, 2, 3, 4], factors)]
        _decode_both(_jpeg(comps, h, w, r.integers(1, 12, 64), app=ADOBE[case]), tmp_path)


@pytest.mark.parametrize("form", list(REFUSED))
def test_refused_jpeg_forms_name_themselves(tmp_path, form):
    make, name = REFUSED[form]
    path = tmp_path / "r.jpg"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=name) as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)


@pytest.mark.parametrize("form", list(READ_ON))
def test_forms_libjpeg_reads_on_match_pil(tmp_path, form):
    """Each once-refused form reads as PIL reads it, bit for bit."""
    _decode_both(READ_ON[form](), tmp_path)


def test_truncated_jpeg_raises_in_pil_too(tmp_path):
    """The reference raises on a stream cut inside its last scan, as the
    port does (PIL: "image file is truncated")."""
    path = tmp_path / "t.jpg"
    path.write_bytes(_pil_jpeg(quality=90)[:-300])
    with pytest.raises(OSError, match="truncated"):
        ref_image.read_image(str(path))


@pytest.mark.parametrize("form", list(BAD_TABLES))
def test_bad_huffman_tables_raise_in_pil_too(tmp_path, form):
    """The reference refuses a Huffman table that is not a prefix code, or
    that holds the all-ones code, as the port does."""
    path = tmp_path / "h.jpg"
    path.write_bytes(BAD_TABLES[form]())
    with pytest.raises(OSError):
        ref_image.read_image(str(path))


def test_jpeg_entropy_build_failure_raises(tmp_path, monkeypatch):
    """No Python entropy decoder to fall back to: a missing compiler raises."""
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-akari")
    with pytest.raises(RuntimeError, match="not found.*JPEG decoder"):
        port_jpeg.decode_jpeg(_pil_jpeg())


# ------------------------------------ PNG --------------------------------------

def _samples(h, w, ch, depth, seed):
    return np.random.default_rng(seed).integers(0, 1 << depth, (h, w, ch))


def _png_read(tmp_path, data, name="p.png"):
    path = tmp_path / name
    path.write_bytes(data)
    want = np.asarray(Image.open(str(path)).convert("RGB"))
    np.testing.assert_array_equal(port_image.decode_png(data), want)
    return _same_read(str(path))


ANCILLARY = ((b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\x00"),
             (b"tEXt", b"Comment\x00akari"), (b"iCCP", b"icc\x00\x00" + zlib.compress(b"x" * 40)))


@pytest.mark.parametrize("trns", [False, True], ids=["plain", "trns"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_matches_pil(tmp_path, depth, trns):
    n = 1 << depth
    r = np.random.default_rng(depth)
    plte = r.integers(0, 256, (n - (depth > 1), 3)).astype(np.uint8)  # one index past PLTE
    px = _samples(21, 13, 1, depth, depth + 10)
    tr = bytes(r.integers(0, 256, min(n, 5)).astype(np.uint8)) if trns else None
    _png_read(tmp_path, png_bytes(px, depth, 3, plte=plte.tobytes(), trns=tr, seed=depth))


@pytest.mark.parametrize("trns", [False, True], ids=["plain", "trns"])
def test_palette_png_written_by_pil_matches(tmp_path, trns):
    img = Image.fromarray(pattern(20, 30, 5)).convert("P")
    path = str(tmp_path / "pil.png")
    img.save(path, transparency=3) if trns else img.save(path)
    with open(path, "rb") as f:
        assert (b"tRNS" in f.read()) == trns
    _same_read(path)


FORMS = {  # name: (colour type, depth, channels)
    "grey1": (0, 1, 1), "grey2": (0, 2, 1), "grey4": (0, 4, 1), "grey8": (0, 8, 1),
    "grey16": (0, 16, 1), "rgb16": (2, 16, 3), "la8": (4, 8, 2), "la16": (4, 16, 2),
    "rgba16": (6, 16, 4), "rgb8-ancillary": (2, 8, 3), "rgba8-ancillary": (6, 8, 4),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_png_forms_match_pil(tmp_path, form):
    ctype, depth, ch = FORMS[form]
    px = _samples(19, 23, ch, depth, ctype * 31 + depth)
    if form == "grey16":  # mostly below 256, where PIL's I;16 -> RGB does not clip
        px = np.where(px % 3 == 0, px, px % 300)
    extra = ANCILLARY if "ancillary" in form else ()
    trns = struct.pack(">H", int(px[0, 0, 0])) if ctype == 0 else None
    _png_read(tmp_path, png_bytes(px, depth, ctype, trns=trns, extra=extra, seed=depth))


def test_png_la_and_grey16_written_by_pil_match(tmp_path):
    Image.fromarray(pattern(12, 9, 6)).convert("LA").save(tmp_path / "la.png")
    _same_read(str(tmp_path / "la.png"))
    grey = (np.arange(12 * 9, dtype=np.uint16).reshape(12, 9) * 611).astype(np.uint16)
    Image.fromarray(grey).save(tmp_path / "g16.png")
    assert Image.open(tmp_path / "g16.png").mode == "I;16"
    _same_read(str(tmp_path / "g16.png"))


def test_png_16bit_keeps_high_byte_and_grey16_clips_at_255(tmp_path):
    """16-bit colour keeps the high byte (0x80ff -> 128, 0xfe01 -> 254:
    truncation, not rounding); 16-bit grey opens as PIL's I;16, whose
    conversion to RGB clips at 255 (1000 -> 255), a reference quirk the
    port keeps."""
    rgb = np.array([[[0x80FF, 0xFE01, 0x00FF], [0xFFFF, 0x0100, 0x7FFF]]])
    got = _png_read(tmp_path, png_bytes(rgb, 16, 2), "rgb16.png")
    np.testing.assert_array_equal(port_image.decode_png((tmp_path / "rgb16.png").read_bytes()),
                                  [[[128, 254, 0], [255, 1, 127]]])
    assert got.shape == (1, 2, 3)
    grey = np.array([[[0], [100], [255], [256], [1000], [65535]]])
    _png_read(tmp_path, png_bytes(grey, 16, 0), "g16.png")
    np.testing.assert_array_equal(
        port_image.decode_png((tmp_path / "g16.png").read_bytes())[0, :, 0],
        [0, 100, 255, 255, 255, 255])


@pytest.mark.parametrize("hw", [(1, 1), (3, 2), (33, 17)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", ["rgb8", "palette4", "grey1", "grey16", "rgba16", "la8"])
def test_adam7_png_matches_pil(tmp_path, form, hw):
    ctype, depth, ch = {"rgb8": (2, 8, 3), "palette4": (3, 4, 1), "grey1": (0, 1, 1),
                        "grey16": (0, 16, 1), "rgba16": (6, 16, 4), "la8": (4, 8, 2)}[form]
    px = _samples(*hw, ch, depth, hw[0] * 7 + hw[1])
    if form == "grey16":
        px %= 256
    plte = np.random.default_rng(1).integers(0, 256, (16, 3)).astype(np.uint8).tobytes()
    data = png_bytes(px, depth, ctype, interlace=1, plte=plte if ctype == 3 else None, seed=hw[0])
    assert data[28] == 1  # IHDR interlace method: Adam7
    _png_read(tmp_path, data)


def test_truncated_png_raises_naming_the_file(tmp_path):
    data = png_bytes(_samples(16, 16, 3, 8, 2), 8, 2)
    cut = data[:data.index(b"IDAT") + 30] + _chunk(b"IEND", b"")
    path = tmp_path / "cut.png"
    path.write_bytes(cut)
    with pytest.raises(ValueError, match="truncated") as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)
    with pytest.raises(OSError, match="truncated"):
        ref_image.read_image(str(path))


@pytest.mark.parametrize("seed", range(4))
def test_png_chunks_before_the_image_data_need_their_crc_and_type(tmp_path, seed):
    """PIL's ``PngImageFile._open`` checks the CRC and the type (four word
    characters) of every chunk before the first IDAT and refuses the file
    when one is wrong; chunks after the image data are not checked. The
    port refuses and reads the same files: every byte of the header chunks
    of a drawn PNG (a PLTE and a tRNS among them) changed in turn, and
    bytes of the IEND after the data."""
    r = np.random.default_rng(seed)
    data = png_bytes(r.integers(0, 4, (5, 7, 1)), 8, 3,
                     plte=r.integers(0, 256, 12).astype(np.uint8).tobytes(), trns=b"\x00\x80")
    idat = data.index(b"IDAT") - 4
    picks = list(range(8, idat)) + [len(data) - 8, len(data) - 5, len(data) - 1]
    for i in picks[seed::4]:
        bad = bytearray(data)
        bad[i] ^= 1 << int(r.integers(0, 8))
        path = tmp_path / "c.png"
        path.write_bytes(bytes(bad))
        try:
            want = np.asarray(Image.open(path).convert("RGB"))
        except Exception:
            want = None
        try:
            got = port_image.decode_image(bytes(bad), "c.png")
        except ValueError:
            got = None
        assert (want is None) == (got is None), f"byte {i}: PIL {want is not None}"
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f"byte {i}")


def test_images_are_told_apart_by_signature(tmp_path):
    """A PNG named .jpg and a JPEG named .png read as what they are, as
    under PIL."""
    (tmp_path / "png.jpg").write_bytes(png_bytes(_samples(5, 6, 3, 8, 1), 8, 2))
    (tmp_path / "jpeg.png").write_bytes(_pil_jpeg())
    _same_read(str(tmp_path / "png.jpg"))
    _same_read(str(tmp_path / "jpeg.png"))


# -------------------------------- the fixtures ---------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def test_fixture_digests_are_pils_decode():
    """digests.json (written by tools/make_torch_port_image_fixtures.py and
    checked by chip_smoke.py on the card's machine, which has no PIL)
    holds the SHA-256 of PIL's decoded RGB bytes of each fixture."""
    digests = _digests()
    assert len(digests) == len(os.listdir(FIXTURES)) - 1
    total = 0
    for name, rec in digests.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        px = np.asarray(Image.open(path).convert("RGB"))
        assert list(px.shape) == rec["shape"], name
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name
    assert total < 3.2e6  # 2048^2 albedos: JPEG and lossy WebP of ~0.8 MB each, a cut
    # progressive JPEG of 0.19 MB, an irreversible JP2 of 0.42 MB and a
    # reversible J2K of 0.60 MB


def test_fixtures_decode_to_their_digests():
    """The JPEG and PNG fixtures (tests/test_torch_image_formats.py holds
    the other formats' to theirs)."""
    for name, rec in _digests().items():
        if not name.endswith((".jpg", ".png")):
            continue
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        px = (port_jpeg.decode_jpeg(data, name) if name.endswith(".jpg")
              else port_image.decode_png(data, name))
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name


# ------------------------------ PIL's pixel limit ------------------------------

def _huge_headers(n=13_380):
    """A PNG of an IHDR and an IEND and a JPEG of an SOF and an SOS header,
    both n x n with no image data: PIL reads that much before it checks."""
    png = (port_image.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", n, n, 1, 0, 0, 0, 0))
           + _chunk(b"IEND", b""))
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, n, n, 1) + bytes([1, 0x11, 0])
    sos = b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([1, 0, 0, 63, 0])
    return {"PNG": png, "JPEG": b"\xff\xd8" + sof + sos}


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_more_pixels_than_pil_opens_refused_from_the_header(fmt):
    """PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS pixels
    (178,956,970) when it opens it, before any decoding: a 13,380^2 header
    with no image data raises DecompressionBombError there, and the port
    refuses it at once, naming the limit, without decoding."""
    import time

    assert 13_380 ** 2 > 2 * Image.MAX_IMAGE_PIXELS == 178_956_970
    data = _huge_headers()[fmt]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="more pixels than PIL opens"):
        port_image.decode_image(data, "huge")
    assert time.perf_counter() - t0 < 0.5
