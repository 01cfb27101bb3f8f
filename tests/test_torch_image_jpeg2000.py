"""Port parity: the PIL-free JPEG 2000 decoder (akari_torch/core/jpeg2000.py
with akari_torch/native/j2k_decode.cpp) against PIL 12.1, which reads JPEG
2000 through its bundled OpenJPEG 2.5.4 and through which the JAX package's
``read_image`` reads it.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")`` of
the file, and ``read_image`` of both packages gives the same float32 array
bit for bit:

- the fixtures of ``tests/data/torch_port_images`` (``j2k_*``, ``jp2_*`` and
  the two 2048^2 albedos; ``digests.json`` holds PIL's decode of each, which
  ``chip_smoke.py`` checks on a machine without PIL), and
  ``tools/make_torch_port_image_fixtures.py`` still writes them;
- cases drawn from a seed through every option of Pillow's writer
  (irreversible, tile_size, tile_offset, offset, num_resolutions,
  codeblock_size, precinct_size, the five progressions, quality_layers, mct,
  no_jp2, plt) and through OpenJPEG's encoder (``tools/j2k_writers.py``:
  code-block styles, POC, tile-parts, subsampling, signed and 1-16-bit
  components, ROI, SOP / EPH, PPM / PPT);
- JP2 boxes: colour spaces and ICC, ``pclr`` / ``cmap`` / ``cdef``,
  ``res ``, ``bpcc``, odd box orders and sizes, modes Pillow has no
  unpacker for (refused by both);
- seeded corruptions (bytes flipped or set, files cut) of eleven
  codestreams and JP2 files: wherever PIL reads the file the port gives its
  pixels, wherever PIL refuses it the port raises ``ValueError`` (a
  corruption that creates a Part-2 marker is read as OpenJPEG reads it);
- the HT code-block style set over Part-1 code-blocks and an HT file (read
  as PIL reads them; ``tests/test_torch_image_htj2k.py`` holds the rest of
  HTJ2K), Part-2 MCO segments read and COD transform 2 refused as OpenJPEG
  refuses it;
- Pillow's YCbCr tables, by which sYCC images are converted;
- an OBJ whose ``map_Kd`` is a JP2 or a J2K renders at 16x16 on the CPU
  bit-equal to the same OBJ on a PNG of the same pixels.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core import jpeg2000 as port_j2k
from akari_tpu.core import image as ref_image
from tools import j2k_writers as jw
from tools.make_torch_port_image_fixtures import ALBEDO_J2K, ALBEDO_JP2, jpeg2000_fixtures, pattern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")


def _pil(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))


def _outcome(data):
    """(PIL's pixels or None, the port's pixels or None, the port's error)."""
    try:
        want = _pil(data)
    except Exception:
        want = None
    try:
        return want, port_image.decode_image(data, "f"), None
    except ValueError as e:
        return want, None, str(e)


def _matches_pil(data, name="f"):
    want, got, err = _outcome(data)
    assert want is not None, f"{name}: PIL refuses it"
    assert got is not None, f"{name}: the port refuses it: {err}"
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _agrees_with_pil(data, name="f"):
    """PIL and the port give the same pixels, or both refuse the file."""
    want, got, err = _outcome(data)
    if want is None:
        assert got is None, f"{name}: PIL refuses it, the port reads it"
        return None
    assert got is not None, f"{name}: PIL reads it, the port refuses it: {err}"
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _same_read(path):
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _planes(r, h, w, n, hi=256):
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip((x * (3 + c) + y * (2 + c)) % hi + r.integers(0, max(hi // 8, 2), (h, w)),
                    0, hi - 1) for c in range(n)]


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.startswith(("j2k_", "jp2_"))
                or k in (ALBEDO_JP2, ALBEDO_J2K)}


FIXTURE_NAMES = sorted(_digests())


# ----------------------------------------- the fixtures --------------------------

def test_jpeg2000_fixtures_are_the_tools_and_pils():
    import PIL

    written = jpeg2000_fixtures()
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(written) == FIXTURE_NAMES and len(written) == 33
    for name, data in written.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
        rec = digests[name]
        assert rec["pil"] == PIL.__version__, name
        if name not in (ALBEDO_JP2, ALBEDO_J2K):  # test_fixture_digests_are_pils_decode does
            px = _pil(data)
            assert list(px.shape) == rec["shape"], name
            assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert port_image.image_format(data) == "JPEG2000"
    px = port_image.decode_image(data, name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ----------------------------------------- drawn cases ---------------------------

_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _most_resolutions(w, h, tile=None, tile_offset=(0, 0), offset=(0, 0)):
    """A number of resolutions OpenJPEG's encoder takes for every tile the
    grid cuts, the partial ones at the edges included (it aborts on some
    above that)."""
    sides = [w, h]
    if tile:
        for size, t, t0, o in ((w, tile[0], tile_offset[0], offset[0]),
                               (h, tile[1], tile_offset[1], offset[1])):
            first = min(t0 + t - o, size)
            sides += [t, first, (size - first) % t or t]
    return max(1, min(min(sides).bit_length(), 6))


def _drawn_pil_case(seed, attempt):
    """Image.save options drawn from ``seed`` (``attempt`` redraws): (image,
    kwargs)."""
    r = np.random.default_rng([1000 + seed, attempt])
    mode = ("L", "LA", "RGB", "RGBA")[seed % 4]
    h, w = (int(v) for v in r.integers(1, 48, 2))
    px = pattern(h, w, seed)
    img = Image.fromarray(px).convert(mode) if mode != "RGBA" else Image.fromarray(
        np.concatenate([px, r.integers(0, 256, (h, w, 1)).astype(np.uint8)], 2))
    kw = {"progression": _PROGRESSIONS[seed % 5], "no_jp2": bool(seed % 3 == 0),
          "irreversible": bool(r.random() < 0.5), "mct": int(mode in ("RGB", "RGBA") and
                                                            r.random() < 0.6)}
    if r.random() < 0.5:
        kw["tile_size"] = (int(r.integers(4, 33)), int(r.integers(4, 33)))
        if r.random() < 0.5:
            kw["tile_offset"] = (int(r.integers(0, 4)), int(r.integers(0, 4)))
            kw["offset"] = (kw["tile_offset"][0] + int(r.integers(0, 3)),
                            kw["tile_offset"][1] + int(r.integers(0, 3)))
    most = _most_resolutions(w, h, kw.get("tile_size"), kw.get("tile_offset", (0, 0)),
                             kw.get("offset", (0, 0)))
    kw["num_resolutions"] = int(r.integers(1, most + 1))
    if r.random() < 0.5:
        kw["codeblock_size"] = (int(2 ** r.integers(2, 7)), int(2 ** r.integers(2, 5)))
    if r.random() < 0.4:
        kw["precinct_size"] = (int(2 ** r.integers(2, 7)), int(2 ** r.integers(2, 7)))
    if r.random() < 0.6:
        kw["quality_layers"] = sorted((float(v) for v in r.uniform(2, 60, r.integers(1, 4))),
                                      reverse=True)
    kw["plt"] = bool(r.random() < 0.3)
    return img, kw


@pytest.mark.parametrize("seed", range(40))
def test_drawn_pil_writer_cases_read_as_pil(tmp_path, seed):
    for attempt in range(50):  # redraw option sets OpenJPEG's encoder refuses
        img, kw = _drawn_pil_case(seed, attempt)
        b = io.BytesIO()
        try:
            img.save(b, "JPEG2000", **kw)
            break
        except OSError:
            continue
    _matches_pil(b.getvalue(), str(kw))
    path = tmp_path / "d.jp2"
    path.write_bytes(b.getvalue())
    _same_read(str(path))


def _drawn_writer_case(seed, attempt):
    """OpenJPEG encoder settings drawn from ``seed`` (``attempt`` redraws):
    (planes, kwargs)."""
    r = np.random.default_rng([2000 + seed, attempt])
    n = (1, 2, 3, 4)[seed % 4]
    h, w = (int(v) for v in r.integers(8, 40, 2))
    prec = int(r.choice([1, 4, 7, 8, 8, 8, 10, 12, 16]))
    sgnd = bool(r.random() < 0.3)
    kw = {"prec": prec, "sgnd": sgnd, "mode": int(r.integers(0, 64)),
          "irreversible": bool(r.random() < 0.5), "progression": _PROGRESSIONS[seed % 5],
          "cblk": (int(2 ** r.integers(2, 7)), int(2 ** r.integers(2, 5))),
          "sop": bool(r.random() < 0.3)}
    kw["eph"] = kw["sop"] or bool(r.random() < 0.2)
    kw["rates"] = (0,) if not kw["irreversible"] and r.random() < 0.5 else tuple(
        sorted(r.uniform(2, 30, r.integers(1, 4)).round(1).tolist(), reverse=True))
    if n >= 3 and r.random() < 0.4 and prec >= 8:  # chroma subsampled: sYCC by Pillow's rule
        kw["dx"] = [1] + [int(r.integers(1, 3))] * (n - 1)
        kw["dy"] = [1] + [int(r.integers(1, 3))] * (n - 1)
    elif n >= 3 and not sgnd:
        kw["mct"] = int(r.random() < 0.5)
    if r.random() < 0.4:
        kw["tile"] = (int(r.integers(8, 24)), int(r.integers(8, 24)))
        kw["tile_parts"] = str(r.choice(["R", "L", "C"])) if r.random() < 0.5 else None
    if r.random() < 0.3:
        kw["roi"] = (int(r.integers(0, n)), int(r.integers(1, 8)))
    kw["num_resolutions"] = int(r.integers(1, _most_resolutions(w, h, kw.get("tile")) + 1))
    if r.random() < 0.3 and kw["num_resolutions"] > 1:
        kw["precincts"] = [(int(r.integers(2, 6)), int(r.integers(2, 6)))] * kw["num_resolutions"]
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if sgnd else (0, 1 << prec)
    dx, dy = kw.get("dx", [1] * n), kw.get("dy", [1] * n)
    planes = [p * (hi - lo) // (1 << 8) + lo if prec > 8 else p % (hi - lo) + lo
              for p in _planes(r, h, w, n)]
    planes = [p[:: dy[i], :: dx[i]] for i, p in enumerate(planes)]
    if "dx" in kw:
        kw["size"] = (w, h)
    return planes, kw


@pytest.mark.parametrize("seed", range(40))
def test_drawn_openjpeg_encoder_cases_read_as_pil(tmp_path, seed):
    for attempt in range(50):  # redraw settings OpenJPEG's encoder refuses
        planes, kw = _drawn_writer_case(seed, attempt)
        try:
            data = jw.encode(planes, **kw)
            break
        except RuntimeError:
            continue
    _agrees_with_pil(data, str(kw))
    if seed % 4 == 0:
        data = jw.jp2(data, planes[0].shape[1], planes[0].shape[0], len(planes),
                      bpc=kw["prec"] - 1 | (0x80 if kw["sgnd"] else 0),
                      colr=(1, 17) if len(planes) < 3 else (1, 16))
        _agrees_with_pil(data, "jp2 " + str(kw))


def test_packet_headers_in_ppm_and_ppt_read_as_pil():
    r = np.random.default_rng(7)
    cs = jw.encode(_planes(r, 32, 36, 3), sop=True, eph=True, rates=(10, 0), tile=(16, 16),
                   num_resolutions=3)
    want = _matches_pil(cs, "sop eph")
    for split in (1, 2, 5):
        np.testing.assert_array_equal(_matches_pil(jw.to_ppm(cs, split), "ppm"), want)
        np.testing.assert_array_equal(_matches_pil(jw.to_ppt(cs, split), "ppt"), want)


# ----------------------------------------- JP2 boxes -----------------------------

def _jp2_cases():
    r = np.random.default_rng(3)
    rgb, grey = jw.encode(_planes(r, 23, 19, 3)), jw.encode(_planes(r, 23, 19, 1))
    rgba, ga = jw.encode(_planes(r, 23, 19, 4)), jw.encode(_planes(r, 23, 19, 2))
    idx = jw.encode([r.integers(0, 12, (23, 19))])
    idxa = jw.encode([r.integers(0, 12, (23, 19)), r.integers(0, 256, (23, 19))])
    pal = r.integers(0, 256, (10, 3))
    cmap3 = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    sig = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    ft = jw.box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
    jh = jw.box(b"jp2h", jw.box(b"ihdr", struct.pack(">IIHBBBB", 23, 19, 3, 7, 7, 0, 0))
                + jw.box(b"colr", b"\x01\0\0" + struct.pack(">I", 16)))
    jc = jw.box(b"jp2c", rgb)
    return {
        "grey colr17": jw.jp2(grey, 19, 23, 1, colr=(1, 17)),
        "grey colr16": jw.jp2(grey, 19, 23, 1, colr=(1, 16)),
        "rgb colr17": jw.jp2(rgb, 19, 23, 3, colr=(1, 17)),
        "rgb colr18": jw.jp2(rgb, 19, 23, 3, colr=(1, 18)),
        "rgb colr24": jw.jp2(rgb, 19, 23, 3, colr=(1, 24)),
        "rgb colr14 lab": jw.jp2(rgb, 19, 23, 3, colr=(1, 14)),
        "rgb colr99": jw.jp2(rgb, 19, 23, 3, colr=(1, 99)),
        "rgb icc": jw.jp2(rgb, 19, 23, 3, colr=(2, b"\0" * 40)),
        "rgb no colr": jw.jp2(rgb, 19, 23, 3, colr=None),
        "rgb colr meth3": jw.jp2(rgb, 19, 23, 3, colr=(3, b"abcd")),
        "rgba cmyk": jw.jp2(rgba, 19, 23, 4, colr=(1, 12)),
        "rgba sycc": jw.jp2(rgba, 19, 23, 4, colr=(1, 18)),
        "ga colr16": jw.jp2(ga, 19, 23, 2, colr=(1, 16)),
        "P grey colr": jw.jp2(idx, 19, 23, 1, colr=(1, 17), pclr=([7, 7, 7], pal), cmap=cmap3),
        "P one column": jw.jp2(idx, 19, 23, 1, pclr=([7], pal[:, :1]), cmap=[(0, 1, 0)]),
        "P two columns": jw.jp2(idx, 19, 23, 1, pclr=([7, 7], pal[:, :2]),
                                cmap=[(0, 1, 0), (0, 1, 1)]),
        "P 16-bit palette": jw.jp2(idx, 19, 23, 1, pclr=([15, 15, 15], pal * 200), cmap=cmap3),
        "P signed palette": jw.jp2(idx, 19, 23, 1, pclr=([0x87, 7, 7], pal), cmap=cmap3),
        "P no cmap": jw.jp2(idx, 19, 23, 1, pclr=([7, 7, 7], pal)),
        "PA": jw.jp2(idxa, 19, 23, 2, pclr=([7, 7, 7], pal), cmap=cmap3,
                     cdef=[(0, 0, 1), (1, 1, 0)]),
        "cdef empty": jw.jp2(rgb, 19, 23, 3, cdef=[]),
        "res empty": jw.jp2(rgb, 19, 23, 3, res=b""),
        "res short": jw.jp2(rgb, 19, 23, 3, res=jw.box(b"resc", b"\0" * 4)),
        "ihdr wider": jw.jp2(rgb, 20, 23, 3),
        "ihdr nc4": jw.jp2(rgb, 19, 23, 4),
        "ihdr nc1": jw.jp2(rgb, 19, 23, 1),
        "ihdr nc5": jw.jp2(rgb, 19, 23, 5),
        "bpcc short": jw.jp2(rgb, 19, 23, 3, bpc=255, extra_header=[jw.box(b"bpcc", b"\7\7")]),
        "two colr": jw.jp2(rgb, 19, 23, 3, extra_header=[
            jw.box(b"colr", b"\x01\0\0" + struct.pack(">I", 17))]),
        "uuid between": sig + ft + jw.box(b"uuid", b"x" * 20) + jh + jc,
        "jp2c to the end": sig + ft + jh + struct.pack(">I", 0) + b"jp2c" + rgb,
        "jp2c XL": sig + ft + jh + struct.pack(">I", 1) + b"jp2c"
        + struct.pack(">Q", 16 + len(rgb)) + rgb,
        "trailing junk": sig + ft + jh + jc + b"junk",
        "no ftyp": sig + jh + jc,
        "jp2c first": sig + ft + jc + jh,
        "no jp2c": sig + ft + jh,
        "ftyp short": sig + jw.box(b"ftyp", b"jp2 ") + jh + jc,
        "ihdr misplaced": sig + ft + jw.box(b"ihdr", struct.pack(">IIHBBBB", 23, 19, 3, 7, 7, 0,
                                                                 0)) + jh + jc,
        "jp2h cut": sig + ft + jh[:30],
        "codestream cut": (sig + ft + jh + jc)[:-30],
    }


_JP2 = _jp2_cases()


@pytest.mark.parametrize("name", sorted(_JP2))
def test_jp2_boxes_read_as_pil_or_are_refused_by_both(name):
    _agrees_with_pil(_JP2[name], name)


def test_jp2_forms_pil_reads_are_read():
    """The cases above that PIL reads, so the parity is not all refusals."""
    read = [n for n in sorted(_JP2) if _outcome(_JP2[n])[0] is not None]
    assert len(read) >= 20, read


# ----------------------------------------- corruptions ---------------------------

def _corruption_bases():
    r = np.random.default_rng(5)
    full = _planes(r, 34, 30, 1)[0]
    sop = jw.encode(_planes(r, 32, 36, 3), sop=True, eph=True, rates=(10, 0), tile=(16, 16),
                    num_resolutions=3)
    b = io.BytesIO()
    Image.fromarray(np.stack(_planes(r, 30, 27, 3), -1).astype(np.uint8)).save(
        b, "JPEG2000", irreversible=True, quality_layers=[20, 5])
    return {
        "plain": jw.encode(_planes(r, 30, 27, 3)),
        "tiles_tileparts_layers": jw.encode(_planes(r, 30, 27, 3), tile=(16, 16),
                                            num_resolutions=3, tile_parts="R", rates=(8, 0)),
        "irreversible_sop_eph": jw.encode(_planes(r, 30, 27, 3), irreversible=True,
                                          rates=(12, 4), sop=True, eph=True),
        "bypass_termall_segsym": jw.encode(_planes(r, 30, 27, 1), cblk=(8, 8),
                                           mode=jw.BYPASS | jw.TERMALL | jw.SEGSYM),
        "plt_tlm": jw.encode(_planes(r, 30, 27, 1), extra=("PLT=YES", "TLM=YES"), tile=(16, 16),
                             num_resolutions=3),
        "sub420_roi": jw.encode([full, full[::2, ::2], full[::2, ::2]], dx=[1, 2, 2],
                                dy=[1, 2, 2], roi=(0, 4), rates=(9, 0)),
        "poc": jw.encode(_planes(r, 32, 32, 3), rates=(10, 0),
                         poc=[(0, 0, 2, 3, 3, "RLCP", 1), (3, 0, 2, 6, 3, "CPRL", 1)]),
        "ppm": jw.to_ppm(sop, 2),
        "signed16_irreversible": jw.encode([p - 30000 for p in _planes(r, 21, 25, 2, 65536)],
                                           prec=16, sgnd=True, irreversible=True, rates=(6,)),
        "jp2_pclr": jw.jp2(jw.encode([r.integers(0, 12, (23, 19))]), 19, 23, 1,
                           pclr=([7, 7, 7], r.integers(0, 256, (12, 3))),
                           cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
        "pil_jp2": b.getvalue(),
    }


_BASES = _corruption_bases()


@pytest.mark.parametrize("name", sorted(_BASES))
def test_seeded_corruptions_read_as_pil_or_are_refused(name):
    """Bytes flipped or set (headers and packet data) and files cut: the
    port reads what PIL reads, bit for bit, and refuses what PIL refuses."""
    base = _BASES[name]
    r = np.random.default_rng(sum(name.encode()))
    cases = [base[:int(c)] for c in r.integers(1, len(base), 20)]
    for _ in range(40):
        b = bytearray(base)
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(0, len(b)))
            b[pos] = b[pos] ^ (1 << int(r.integers(0, 8))) if r.random() < 0.5 else int(
                r.integers(0, 256))
        cases.append(bytes(b))
    read = 0
    for i, data in enumerate(cases):
        want, got, err = _outcome(data)
        if want is None:
            assert got is None, f"{name} case {i}: PIL refuses it, the port reads it"
        else:
            assert got is not None, f"{name} case {i}: PIL reads it, the port refuses it: {err}"
            read += 1
            np.testing.assert_array_equal(got, want, err_msg=f"{name} case {i}")
    assert read >= 3, name


def test_truncated_codestreams_are_refused_as_pil_refuses_them():
    data = open(os.path.join(FIXTURES, "j2k_pil_rgb_29x37.j2k"), "rb").read()
    for frac in (0.9, 0.6, 0.3):
        cut = data[:int(len(data) * frac)]
        with pytest.raises(Exception):
            _pil(cut)
        with pytest.raises(ValueError, match="broken JPEG 2000 data"):
            port_image.decode_image(cut)


# ----------------------------------------- HTJ2K and Part 2 -----------------------

def test_htj2k_code_blocks_are_refused_as_still_to_be_ported():
    """Once refused, now read as PIL reads them: the HT code-block style set
    over a Part-1 (MQ) codestream (the HT decoder reads its bytes as OpenJPEG
    does, or both refuse), an HT file from the HT writer, and Rsiz bit 14 or
    a CAP marker over Part-1 code-blocks (which change nothing)."""
    base = jw.encode(_planes(np.random.default_rng(9), 20, 24, 3))
    cod = base.index(b"\xff\x52")
    ht = bytearray(base)
    ht[cod + 12] |= 0x40  # SPcod code-block style: the HT block coder
    _agrees_with_pil(bytes(ht), "HT style over MQ code-blocks")
    planes = _planes(np.random.default_rng(9), 20, 24, 3)
    got = _matches_pil(jw.encode_ht(planes, cblk=(16, 8)), "HT file")
    np.testing.assert_array_equal(got, np.stack(planes, -1))
    siz = base.index(b"\xff\x51")
    rsiz = bytearray(base)
    rsiz[siz + 4] |= 0x40
    end = siz + 2 + struct.unpack(">H", base[siz + 2:siz + 4])[0]
    cap = base[:end] + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00" + base[end:]
    for data in (bytes(rsiz), cap):
        np.testing.assert_array_equal(_matches_pil(data), _pil(base))


def test_part2_multiple_component_transforms_are_refused_as_still_to_be_ported():
    """COD transform 2 (a Part-2 array-based transform) is refused, as
    OpenJPEG refuses it; an MCO segment beside transform 0 or 1 is read as
    OpenJPEG reads it (every DC level shift zeroed)."""
    r = np.random.default_rng(10)
    data = jw.encode(_planes(r, 20, 24, 3), mct=2, irreversible=True,
                     custom_mct=(np.eye(3), [0, 0, 0]))
    assert b"\xff\x74" in data and b"\xff\x77" in data  # MCT and MCO segments
    with pytest.raises(Exception):
        _pil(data)  # OpenJPEG refuses COD transform 2
    with pytest.raises(ValueError, match="Invalid multiple component transformation"):
        port_image.decode_image(data)
    for mct in (0, 1):
        base = jw.encode(_planes(r, 20, 24, 3), mct=mct)
        siz = base.index(b"\xff\x51")
        end = siz + 2 + struct.unpack(">H", base[siz + 2:siz + 4])[0]
        mco = base[:end] + b"\xff\x77\x00\x03\x00" + base[end:]
        got = _matches_pil(mco, f"MCO, transform {mct}")
        assert got.mean() < _pil(base).mean() - 60  # no DC level shift


# ----------------------------------------- Pillow's unpack -----------------------

def test_ycbcr_tables_are_pils():
    """sYCC tiles go through Pillow's ImagingConvertYCbCr2RGB, whose tables
    ``ycbcr_tables`` rebuilds: every (Cb, Cr) at several Y."""
    t = port_j2k.ycbcr_tables().astype(np.int64)
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 77, 128, 200, 254, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.frombytes("YCbCr", (256, 256), ycc.tobytes()).convert("RGB"))
        got = np.stack([y + (t[0][cr] >> 6), y + ((t[1][cb] + t[2][cr]) >> 6),
                        y + (t[3][cb] >> 6)], -1).clip(0, 255)
        np.testing.assert_array_equal(got, want, err_msg=f"Y={y}")


def test_subsampled_chroma_repeats_from_the_tile_origin_as_pillow():
    """Pillow repeats a subsampled component from each tile's origin with
    floor-divided strides; odd tile offsets and widths show it."""
    r = np.random.default_rng(11)
    full = _planes(r, 37, 41, 1)[0]
    for off, tile in (((1, 2), None), ((3, 0), (12, 10)), ((0, 0), (7, 9))):
        w, h = 41 - off[0], 37 - off[1]
        kw = dict(dx=[1, 2, 2], dy=[1, 2, 1], offset=off, size=(w, h),
                  tile=tile, tile_offset=(0, 0), num_resolutions=2)
        cw = -(-(off[0] + w) // 2) - -(-off[0] // 2)
        ch2 = -(-(off[1] + h) // 2) - -(-off[1] // 2)
        planes = [full[:h, :w], full[:ch2, :cw], full[:h, :cw][::-1]]
        _matches_pil(jw.encode(planes, **kw), str(kw))


# ----------------------------------------- no PIL, no compiler -------------------

def test_jpeg2000_decoder_needs_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('j2k_pil_rgb_29x37.j2k', 'jp2_pclr_cmap_19x23.jp2', 'jp2_cmyk_35x41.jp2',\n"
            "          'j2k_sub420_sycc_30x34.j2k', 'j2k_grey16_i16_35x41.j2k'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:6] == ["(37, 29, 3)", "(23, 19, 3)", "(41, 35, 3)",
                                          "(34, 30, 3)", "(41, 35, 3)", "[]"]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-xyz")
    with open(os.path.join(FIXTURES, "j2k_pil_rgb_29x37.j2k"), "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match=loader.SOURCES["j2k"][2]):
        port_image.decode_image(data)


def test_decoder_builds_without_fma_contraction():
    from akari_torch.native import loader

    assert "-ffp-contract=off" in loader.EXTRA_FLAGS["j2k"]
    assert not any(f.startswith(("-march", "-ffast-math", "-Ofast"))
                   for f in loader.CXX_FLAGS + loader.EXTRA_FLAGS["j2k"])


# ----------------------------------------- an albedo -----------------------------

def test_obj_map_kd_jp2_and_j2k_render_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd``: a reversible JP2 and a
    reversible J2K of the same pixels give the texture tables and a 16x16
    CPU render of the OBJ on a PNG of them."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    tex = pattern(24, 32, 9)
    planes = [tex[..., c].astype(np.int64) for c in range(3)]
    files = {"png": port_image.encode_png(tex),
             "jp2": jw.jp2(jw.encode(planes, mct=1), 32, 24, 3),
             "j2k": jw.encode(planes, mode=jw.BYPASS | jw.VSC, progression="RPCL")}
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = {}, {}
    for ext, data in files.items():
        (tmp_path / f"albedo.{ext}").write_bytes(data)
        (tmp_path / f"m_{ext}.mtl").write_text(
            f"newmtl ground\nKd 1 1 1\nmap_Kd albedo.{ext}\nnewmtl lamp\nKe 40 35 30\n")
        (tmp_path / f"m_{ext}.obj").write_text(f"mtllib m_{ext}.mtl\n" + obj)
        scene = Scene(shapes=[load_obj(str(tmp_path / f"m_{ext}.obj"))]).compile(
            intersector="dense", device="cpu")
        tables[ext] = scene.textures.images.numpy()
        frames[ext] = render(scene, cam, PathConfig(spp=4, max_depth=3)).numpy()
    assert frames["png"].mean() > 0.01 and np.isfinite(frames["png"]).all()
    for ext in files:
        np.testing.assert_array_equal(tables[ext], tables["png"], err_msg=ext)
        np.testing.assert_array_equal(frames[ext], frames["png"], err_msg=ext)
