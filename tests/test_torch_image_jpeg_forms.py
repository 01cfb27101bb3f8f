"""Port parity: the JPEG forms PIL reads beyond baseline and progressive
Huffman files, and corrupt entropy-coded data, through
``akari_torch.core.image.read_image`` against the JAX package's
``read_image`` (PIL 12.1.0, libjpeg-turbo 3.1) on the CPU.

Tolerance: exact. Both ``read_image`` give the same float32 array bit for
bit (linear and not), and wherever PIL refuses a file the port raises a
``ValueError`` naming the file and the form:

- arithmetic-coded sequential (SOF9) and progressive (SOF10) files of
  ``tools/jpeg_writers.py`` (grey, 4:4:4, 4:2:0 and mixed sampling, odd
  sizes, restart intervals, DAC conditioning) and PIL's files relabelled
  SOF9 / SOF10, whose Huffman bytes an arithmetic decoder reads as any
  bytes;
- lossless files (SOF3: every predictor, point transforms, restarts,
  grey, RGB and 2x2 / 1x1 / 1x1 sampling), and the colour spaces libjpeg
  refuses to convert in lossless mode;
- progressive files cut after every scan k (libjpeg smooths their
  blocks), grey, 4:4:4 and 4:2:0;
- seeded corruption sweeps of baseline, progressive, restart, arithmetic
  and lossless files (at least 240 files);
- the fixtures of ``tools/make_torch_port_image_fixtures.py``'s
  ``jpeg_form_fixtures``, and that the tool still writes them;
- a sequential file without Huffman tables (libjpeg's standard tables, as
  for Motion-JPEG frames);
- the one deliberate divergence: an arithmetic-coded file larger than
  Pillow's 64 KiB feed, which PIL refuses (libjpeg's arithmetic decoder
  cannot suspend) and the port reads, equal to PIL's decode of the file
  fed whole.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core import jpeg as port_jpeg
from akari_tpu.core import image as ref_image
from tools import jpeg_writers as jw
from tools.make_torch_port_image_fixtures import jpeg_form_fixtures, pattern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _same_read(tmp_path, data, name="f.jpg", linear=(True, False)):
    """Both packages' read_image of ``data``: bit-equal, or both refuse (the
    port with a ValueError naming the file). Returns True when read."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        want = [ref_image.read_image(str(path), to_linear=lin) for lin in linear]
    except Exception:
        with pytest.raises(ValueError) as err:
            port_image.read_image(str(path))
        assert str(path) in str(err.value)
        return False
    for lin, w in zip(linear, want):
        got = port_image.read_image(str(path), to_linear=lin)
        assert got.dtype == w.dtype == np.float32 and got.shape == w.shape
        np.testing.assert_array_equal(got, w, err_msg=f"{name} to_linear={lin}")
    return True


def _pil_jpeg(px, **kw):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _relabel(data, code):
    """``data`` with its SOF0 / SOF2 / SOF3 marker changed to ``code``."""
    i = next(i for i in range(len(data) - 1)
             if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2, 0xC3))
    return data[:i + 1] + bytes([code]) + data[i + 2:]


# ------------------------------------ fixtures ------------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items()
                if k.startswith(("arith_", "lossless_")) or "_cut" in k}


FIXTURE_NAMES = sorted(_digests())


def test_jpeg_form_fixtures_are_the_tools_and_pils():
    """The tool still writes the committed arithmetic, lossless and cut
    fixtures, and digests.json holds PIL's decode of each."""
    written = jpeg_form_fixtures()
    assert sorted(written) == FIXTURE_NAMES and len(FIXTURE_NAMES) == 13
    for name, rec in _digests().items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert written[name] == data, name
        px = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_reads_as_the_reference_reads_it(tmp_path, name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        assert _same_read(tmp_path, f.read(), name)


# ------------------------------- arithmetic coding --------------------------------

SAMPLINGS = {"grey": None, "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
             "mixed": [(2, 1), (1, 1), (1, 2)]}


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_arithmetic_jpeg_matches_pil(tmp_path, sampling, mode, restart):
    r = np.random.default_rng(len(sampling) * 7 + restart)
    h, w = int(r.integers(9, 60)), int(r.integers(9, 60))
    px = pattern(h, w, h + w)
    if SAMPLINGS[sampling] is None:
        co = jw.pixel_coefficients(px[..., 0], [(1, 1)], int(r.integers(30, 95)))
        script = jw.PROGRESSION_GREY
    else:
        co = jw.pixel_coefficients(px, SAMPLINGS[sampling], int(r.integers(30, 95)))
        script = jw.PROGRESSION
    data = jw.arith_jpeg(*co, script=script if mode == "progressive" else None, restart=restart)
    assert _same_read(tmp_path, data)


# (class, table, value): DC U << 4 | L, AC K
DAC = {"dc-0-0": [(0, 0, 0x00), (0, 1, 0x00)], "dc-5-15": [(0, 0, 0xF5), (0, 1, 0xF5)],
       "ac-k1": [(1, 0, 1), (1, 1, 1)], "ac-k63-dc-2-3": [(1, 0, 63), (0, 0, 0x32)]}


@pytest.mark.parametrize("dac", list(DAC))
def test_arithmetic_conditioning_matches_pil(tmp_path, dac):
    co = jw.pixel_coefficients(pattern(31, 26, 5), [(2, 2), (1, 1), (1, 1)], 92)
    for script in (None, jw.PROGRESSION):
        assert _same_read(tmp_path, jw.arith_jpeg(*co, script=script, dac=DAC[dac]))


@pytest.mark.parametrize("seed", range(6))
def test_pil_jpeg_relabelled_arithmetic_matches_pil(tmp_path, seed):
    """PIL's Huffman files under SOF9 / SOF10: the QM decoder takes any
    bytes (a sequential file with progressive scans stays refused)."""
    r = np.random.default_rng(seed)
    px = pattern(int(r.integers(8, 50)), int(r.integers(8, 50)), seed)
    kw = dict(quality=int(r.integers(20, 100)), subsampling=int(r.integers(0, 3)))
    if seed % 2:
        kw["restart_marker_blocks"] = int(r.integers(1, 4))
    assert _same_read(tmp_path, _relabel(_pil_jpeg(px, **kw), 0xC9))
    assert _same_read(tmp_path, _relabel(_pil_jpeg(px, progressive=True, **kw), 0xCA))


def test_large_arithmetic_jpeg_reads_past_pils_feed(tmp_path):
    """The deliberate divergence: Pillow feeds libjpeg 64 KiB at a time, and
    libjpeg's arithmetic decoder cannot suspend (JERR_CANT_SUSPEND), so PIL
    refuses an arithmetic-coded file whose scan runs past the first feed;
    the port reads it, as PIL does when given the file in one block."""
    co = jw.pixel_coefficients(pattern(240, 240, 9), [(1, 1)] * 3, 95)
    data = jw.arith_jpeg(*co)
    assert len(data) > 65536
    path = tmp_path / "big.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError):
        ref_image.read_image(str(path))
    im = Image.open(io.BytesIO(data))
    im.decodermaxblock = len(data)
    np.testing.assert_array_equal(port_jpeg.decode_jpeg(data), np.asarray(im.convert("RGB")))


# ------------------------------------ lossless ------------------------------------

@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_grey_matches_pil(tmp_path, psv, pt):
    px = pattern(23, 31, psv)[..., 1]
    data = jw.lossless_jpeg([px], [(1, 1, 1)], px.shape, psv, pt)
    assert _same_read(tmp_path, data)
    np.testing.assert_array_equal(port_jpeg.decode_jpeg(data)[..., 0], px >> pt << pt)


LOSSLESS = {  # components (id, h, v), restart rows, APP segment
    "rgb-ids-123": ([(1, 1, 1), (2, 1, 1), (3, 1, 1)], 0, b""),
    "rgb-adobe-0-restarts": ([(1, 1, 1), (2, 1, 1), (3, 1, 1)], 2, ADOBE_RGB),
    "rgb-ids-RGB": ([(82, 1, 1), (71, 1, 1), (66, 1, 1)], 1, b""),
    "420-adobe-0": ([(1, 2, 2), (2, 1, 1), (3, 1, 1)], 0, ADOBE_RGB),
    "422-restarts": ([(1, 2, 1), (2, 1, 1), (3, 1, 1)], 3, b""),
    "grey-sampled-2x2-restarts": ([(1, 2, 2)], 1, b""),  # the reset lands a row early
    "cmyk": ([(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1)], 0, b""),
}


@pytest.mark.parametrize("case", list(LOSSLESS))
def test_lossless_components_match_pil(tmp_path, case):
    comps, rows, app = LOSSLESS[case]
    h, w = 19, 25
    px = np.concatenate([pattern(h, w, len(case)), pattern(h, w, 3)[..., :1]], axis=2)
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    planes = [px[::vmax // c[2], ::hmax // c[1], i] for i, c in enumerate(comps)]
    for psv in (1, 6):
        assert _same_read(tmp_path, jw.lossless_jpeg(planes, comps, (h, w), psv,
                                                     restart_rows=rows, app=app))


# ----------------------------- progressive files cut short --------------------------

CUT = {"grey": dict(), "444": dict(subsampling=0), "420": dict(subsampling=2)}


@pytest.mark.parametrize("size", [(40, 48), (17, 23), (33, 16)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", list(CUT))
def test_progressive_cut_after_every_scan_matches_pil(tmp_path, form, size):
    """A file cut after scan k = 1 .. n-1 (with an EOI): libjpeg smooths the
    blocks from the DC values around them."""
    px = pattern(*size, 11)
    data = _pil_jpeg(px if form != "grey" else px[..., 0], quality=80, progressive=True,
                     **CUT[form])
    n = jw.scan_count(data)
    assert n >= 6
    for k in range(1, n):
        assert _same_read(tmp_path, jw.cut_progressive(data, k), linear=(False,)), k


# ------------------------------- corrupt data sweeps -------------------------------

def _sweep_bases():
    px = pattern(48, 56, 21)
    co = jw.pixel_coefficients(px, [(2, 2), (1, 1), (1, 1)], 80)
    return {
        "baseline": _pil_jpeg(px, quality=80),
        "baseline-restarts": _pil_jpeg(px, quality=80, restart_marker_blocks=2),
        "progressive": _pil_jpeg(px, quality=80, progressive=True),
        "progressive-restarts": _pil_jpeg(px, quality=70, progressive=True, subsampling=2,
                                          restart_marker_blocks=3),
        "arithmetic": jw.arith_jpeg(*co, restart=4),
        "arithmetic-progressive": jw.arith_jpeg(*co, script=jw.PROGRESSION, restart=3),
        "lossless": jw.lossless_jpeg([px[..., i] for i in range(3)],
                                     [(1, 1, 1), (2, 1, 1), (3, 1, 1)], (48, 56), 4,
                                     restart_rows=6),
        "lossless-grey": jw.lossless_jpeg([px[..., 0]], [(1, 1, 1)], (48, 56), 7),
    }


@pytest.mark.parametrize("form", list(_sweep_bases()))
def test_corrupt_entropy_coded_data_reads_as_pil_reads_it(tmp_path, form):
    """Seeded changes of one to three bytes of the scan data (40 files a
    form, 320 in all): bit flips, bytes set at random, and restart markers
    renumbered or dropped. Where PIL reads the file the pixels are equal;
    where it refuses, the port raises ValueError."""
    base = _sweep_bases()[form]
    sos = base.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(base[sos + 2:sos + 4], "big")
    rsts = [i for i in range(start, len(base) - 1)
            if base[i] == 0xFF and 0xD0 <= base[i + 1] <= 0xD7]
    r = np.random.default_rng(sorted(_sweep_bases()).index(form))
    read = 0
    for t in range(40):
        data = bytearray(base)
        op = t % 4
        if op == 3 and rsts:  # a restart marker renumbered, or dropped
            i = rsts[int(r.integers(len(rsts)))]
            if r.random() < 0.5:
                data[i + 1] = 0xD0 + int(r.integers(8))
            else:
                del data[i:i + 2]
        else:
            for _ in range(int(r.integers(1, 4))):
                i = int(r.integers(start, len(data) - 2))
                data[i] = data[i] ^ (1 << int(r.integers(8))) if op == 0 else int(r.integers(256))
        read += _same_read(tmp_path, bytes(data), linear=(False,))
    assert read >= 20


def test_restart_markers_renumbered_or_dropped_match_pil(tmp_path):
    """Each resynchronisation case of jpeg_resync_to_restart: RSTn replaced
    by the next two, the two before, one far off, and a marker dropped."""
    base = _pil_jpeg(pattern(64, 64, 13), quality=85, restart_marker_blocks=1)
    sos = base.index(b"\xff\xda")
    rsts = [i for i in range(sos, len(base) - 1)
            if base[i] == 0xFF and 0xD0 <= base[i + 1] <= 0xD7]
    i = rsts[5]  # RST5
    for code in range(0xD0, 0xD8):
        assert _same_read(tmp_path, base[:i + 1] + bytes([code]) + base[i + 2:])
    assert _same_read(tmp_path, base[:i] + base[i + 2:])
    assert _same_read(tmp_path, base[:i + 1] + b"\x37" + base[i + 2:])  # not a marker


def test_sequential_jpeg_without_huffman_tables_matches_pil(tmp_path):
    """libjpeg gives a sequential scan its standard (Annex K.3) tables 0
    and 1 when the file defines none, as Motion-JPEG frames do."""
    data = _pil_jpeg(pattern(24, 40, 3), quality=70)
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    assert _same_read(tmp_path, bytes(out) + data[pos:])


def test_single_scan_file_ending_after_its_scan_matches_pil(tmp_path):
    """Pillow ignores a file that ends inside a marker segment after the one
    scan of a sequential file (jpeg_finish_decompress suspends), not an
    error there."""
    data = _pil_jpeg(pattern(24, 40, 3), quality=70)[:-2]
    assert _same_read(tmp_path, data + b"\xff\xe3\x00\x40abc")
    assert not _same_read(tmp_path, data + b"\xff\xdb\x00\x43\x07abc")  # table 7: an error


# ------------------------------------ refusals ------------------------------------

def _lossless_grey(**kw):
    px = pattern(16, 20, 4)[..., 0]
    return jw.lossless_jpeg([px], [(1, 1, 1)], px.shape, 1, **kw)


def _with_precision(data, bits):
    i = data.index(b"\xff\xc3") if b"\xff\xc3" in data else data.index(b"\xff\xc0")
    return data[:i + 4] + bytes([bits]) + data[i + 5:]


def _lossless_scan(data, ss, se=0, ahal=0):
    i = data.index(b"\xff\xda")
    n = data[i + 4]
    j = i + 5 + 2 * n
    return data[:j] + bytes([ss, se, ahal]) + data[j + 3:]


REFUSED = {
    "12-bit": (lambda: _with_precision(_pil_jpeg(pattern(8, 8, 1)), 12), "12-bit"),
    "lossless-16-bit": (lambda: _with_precision(_lossless_grey(), 16), "16-bit"),
    "hierarchical-sof5": (lambda: _relabel(_pil_jpeg(pattern(8, 8, 1)), 0xC5), "hierarchical"),
    "hierarchical-sof6": (lambda: _relabel(_pil_jpeg(pattern(8, 8, 1)), 0xC6), "hierarchical"),
    "hierarchical-sof7": (lambda: _relabel(_lossless_grey(), 0xC7), "hierarchical"),
    "hierarchical-sof13": (lambda: _relabel(_pil_jpeg(pattern(8, 8, 1)), 0xCD), "hierarchical"),
    "hierarchical-sof14": (lambda: _relabel(_pil_jpeg(pattern(8, 8, 1), progressive=True),
                                            0xCE), "hierarchical"),
    "hierarchical-sof15": (lambda: _relabel(_lossless_grey(), 0xCF), "hierarchical"),
    "arithmetic-lossless-sof11": (lambda: _relabel(_lossless_grey(), 0xCB), "SOF11"),
    "sof9-progressive-scans": (lambda: _relabel(_pil_jpeg(pattern(16, 16, 2), progressive=True),
                                                0xC9), "second scan"),
    "two-components": (lambda: jw.lossless_jpeg(
        [pattern(8, 8, 1)[..., 0]] * 2, [(1, 1, 1), (2, 1, 1)], (8, 8), 1), "2-component"),
    "cut-inside-scan": (lambda: _pil_jpeg(pattern(40, 40, 2), progressive=True)[:-150],
                        "truncated"),
    "arithmetic-cut-inside-scan": (lambda: jw.arith_jpeg(*jw.pixel_coefficients(
        pattern(24, 24, 3), [(1, 1)] * 3, 90))[:-40], "truncated"),
    "lossless-cut-inside-scan": (lambda: _lossless_grey()[:-30], "truncated"),
    "lossless-jfif-ycbcr": (lambda: jw.lossless_jpeg(
        [pattern(8, 8, 1)[..., i] for i in range(3)], [(1, 1, 1), (2, 1, 1), (3, 1, 1)], (8, 8),
        1, app=JFIF), "lossless JPEG in YCbCr"),
    "lossless-adobe-ycck": (lambda: jw.lossless_jpeg(
        [pattern(8, 8, 1)[..., i % 3] for i in range(4)], [(i + 1, 1, 1) for i in range(4)],
        (8, 8), 1, app=ADOBE_RGB[:-1] + b"\x02"), "lossless JPEG in YCCK"),
    "lossless-predictor-0": (lambda: _lossless_scan(_lossless_grey(), 0), "lossless"),
    "lossless-predictor-8": (lambda: _lossless_scan(_lossless_grey(), 8), "lossless"),
    "lossless-se-nonzero": (lambda: _lossless_scan(_lossless_grey(), 1, se=63), "lossless"),
    "lossless-restart-not-whole-rows": (lambda: _lossless_grey(restart_rows=1).replace(
        b"\xff\xdd\x00\x04\x00\x14", b"\xff\xdd\x00\x04\x00\x13"), "restart interval"),
}


@pytest.mark.parametrize("form", list(REFUSED))
def test_refused_forms_name_themselves_and_pil_refuses_them(tmp_path, form):
    make, name = REFUSED[form]
    path = tmp_path / "r.jpg"
    path.write_bytes(make())
    with pytest.raises(OSError):
        ref_image.read_image(str(path))
    with pytest.raises(ValueError, match=name) as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)
