"""Port parity: the PIL-free TGA, BMP, PNM, GIF and PSD decoders
(akari_torch/core/image_formats.py with akari_torch/native/gif_lzw.cpp)
against PIL, through which the JAX package's ``read_image`` reads them.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
and ``read_image`` of both packages gives the same float32 array bit for
bit with ``to_linear`` True and False:

- the fixtures of ``tests/data/torch_port_images`` (written by
  ``tools/make_torch_port_image_fixtures.py``; ``digests.json`` holds
  PIL's decode of each, which ``chip_smoke.py`` checks on a machine
  without PIL);
- seeded drawn files of every form the decoders read, built by the
  tool's encoders (Pillow writes few of these forms), held to PIL in-test;
- Pillow's own TGA, BMP, PPM and GIF writers;
- seeded corruptions of the fixtures (bytes changed, files cut or
  extended): wherever PIL reads the file the port gives its pixels, and
  wherever PIL refuses it the port raises ``ValueError``;
- the forms PIL refuses, each refused by the port naming the form; CCITT
  TIFFs of no valid data name the cause libtiff gives, a WebP that libwebp
  refuses is refused naming WebP, a 16-bit Lab PSD naming "Lab" and a PFM
  of scale 0 naming its scale (8-bit Lab PSDs, which PIL converts with
  LittleCMS 2.17's Lab -> sRGB transform, and PFMs of other scales read as
  PIL reads them);
- DIB files (a BMP without its file header) at every header size PIL
  reads, each bit depth, RLE, bitfields, both row orders, and PIL's other
  PNM modes (``Pf`` in both byte orders with NaN, infinities, negatives,
  values past 255 and fractions; ``P0CMYK``, ``PyP``, ``PyRGBA``,
  ``PyCMYK`` at 8 and 16 bits), held to PIL and to the JAX package;
- an OBJ whose ``map_Kd`` is a TGA renders at 16x16 on the CPU bit-equal
  to the same OBJ on a PNG of the same pixels.
"""

import hashlib
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import (
    bmp_bytes,
    bmp_rle,
    bmp_rows,
    format_fixtures,
    gif_bytes,
    lab_pnm_dib_icns_fixtures,
    pattern,
    pfm_bytes,
    pnm_bytes,
    pnm_mode_bytes,
    psd_bytes,
    tga_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
FORMATS = (".tga", ".bmp", ".pbm", ".pgm", ".ppm", ".gif", ".psd", ".dib", ".pfm", ".pnm")


def _pil(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _same_read(path):
    """Both packages' read_image, linear and not: bit-equal."""
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _matches_pil(data, tmp_path=None, name="f"):
    want = _pil(data)
    got = port_image.decode_image(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if tmp_path is not None:
        path = tmp_path / name
        path.write_bytes(data)
        _same_read(str(path))
    return got


# -------------------------------- the fixtures ---------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.endswith(FORMATS)}


FIXTURE_NAMES = sorted(_digests())


def test_format_fixtures_are_the_tools_and_pils():
    """The tool's encoders still write the committed fixtures, and
    digests.json holds PIL's decode of every one, with PIL's version."""
    import PIL

    digests = _digests()
    assert len(digests) >= 40
    written = {**format_fixtures(np.random.default_rng(11)),
               **{k: v for k, v in lab_pnm_dib_icns_fixtures().items() if k.endswith(FORMATS)}}
    for name, rec in digests.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        if not name.startswith("pil"):
            assert written[name] == data, name
        px = _pil(data)
        assert list(px.shape) == rec["shape"], name
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name
        assert rec["pil"] == PIL.__version__
    assert sorted(n for n in written if n in digests) == sorted(
        n for n in digests if not n.startswith("pil"))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ----------------------------------- TGA ----------------------------------------

def _tga_form(form, r):
    h, w = int(r.integers(1, 20)), int(r.integers(1, 20))
    imtype, depth, cm = form

    def runs(k):  # equal neighbours, so that run packets appear
        return np.repeat(r.integers(0, 256, (h, -(-w // 3), k)), 3, axis=1)[:, :w].astype(np.uint8)

    kw = dict(origin=int(r.choice([0x00, 0x10, 0x20, 0x30])),
              id_field=bytes(r.integers(0, 256, int(r.integers(0, 6))).astype(np.uint8)),
              lit_max=int(r.integers(1, 129)), seed=int(r.integers(1 << 20)))
    if cm:
        n, start = int(r.integers(2, 40)), int(r.integers(0, 200))
        idx = (start + r.integers(-2, n + 2, (h, w))).clip(0, 255).astype(np.uint8)[..., None]
        if cm == 16:
            cmap = r.integers(0, 1 << 16, n).astype("<u2").tobytes()
        else:
            cmap = r.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        return tga_bytes(idx, imtype, depth, cmap=cmap, cm_start=start, cm_len=n, cm_depth=cm,
                         **kw)
    if depth == 1:  # packed rows; the header takes the width in pixels
        data = tga_bytes(r.integers(0, 256, (h, -(-w // 8), 1)).astype(np.uint8), imtype, 1,
                         **kw)
        return data[:12] + struct.pack("<H", w) + data[14:]
    return tga_bytes(runs(depth // 8), imtype, depth, **kw)


TGA_FORMS = {"grey1": (3, 1, 0), "grey8": (3, 8, 0), "grey8-rle": (11, 8, 0),
             "grey-alpha16": (3, 16, 0), "grey-alpha16-rle": (11, 16, 0),
             "rgb15": (2, 16, 0), "rgb15-rle": (10, 16, 0), "rgb24": (2, 24, 0),
             "rgb24-rle": (10, 24, 0), "rgba32": (2, 32, 0), "rgba32-rle": (10, 32, 0),
             "cmap24": (1, 8, 24), "cmap24-rle": (9, 8, 24), "cmap16": (1, 8, 16),
             "cmap16-rle": (9, 8, 16), "grey8-with-cmap": (3, 8, 24)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("form", list(TGA_FORMS))
def test_drawn_tga_matches_pil(tmp_path, form, seed):
    r = np.random.default_rng(seed + 100 * list(TGA_FORMS).index(form))
    _matches_pil(_tga_form(TGA_FORMS[form], r), tmp_path if seed == 0 else None, "d.tga")


def test_tga_15_bit_words_expand_as_pil_does():
    """Each 5-bit channel reads v * 255 // 31 (PIL's BGRA;15Z): 0x3def is
    (123, 123, 123), 0x0001 (0, 0, 8), 0x0010 blue 131; the top bit
    (alpha) is dropped."""
    words = np.arange(1 << 16, dtype="<u2").reshape(256, 256)
    data = tga_bytes(words.view(np.uint8).reshape(256, 256, 2), 2, 16, origin=0x20)
    px = _matches_pil(data)
    assert px[0x3D, 0xEF].tolist() == [123, 123, 123]
    assert px[0, 1].tolist() == [0, 0, 8] and px[0, 0x10].tolist() == [0, 0, 131]
    np.testing.assert_array_equal(px[:128], px[128:])


def test_tga_literal_packets_cross_scanlines_and_runs_do_not():
    px = np.arange(2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 3)
    head = tga_bytes(px, 10, 24)[:18]
    crossing_literal = head + bytes([2]) + px[1].tobytes() + px[0, :1].tobytes() + bytes(
        [0x80]) + px[0, 1].tobytes()
    _matches_pil(crossing_literal)
    crossing_run = head + bytes([0x82]) + px[1, 0].tobytes() + bytes([0]) + px[0, 1].tobytes()
    with pytest.raises(OSError):
        _pil(crossing_run)
    with pytest.raises(ValueError, match="run packet crosses a scanline"):
        port_image.decode_image(crossing_run, "x.tga")


# ----------------------------------- BMP ----------------------------------------

def _bmp_form(form, r):
    h, w = int(r.integers(1, 14)), int(r.integers(1, 23))
    header = {"os2": 12, "v4": 108, "v5": 124, "v2": 52, "v3": 56}.get(form.split("-")[-1], 40)
    if form.startswith("pal"):
        bits = int(form.split("-")[0][3:])
        colors = int(r.choice([0, 2, 5, 1 << bits]))
        n = colors or 1 << bits
        pad = 3 if header == 12 else 4
        pal = r.integers(0, 256, (n, pad)).astype(np.uint8)
        if "grey" in form:  # PIL's grey test: (0, 255) for two colours, else the ramp
            pal[:, :3] = (np.array([0, 255]) if n == 2 else np.arange(n) % 256)[:, None]
        idx = r.integers(0, n + 2, (h, w)) % (1 << bits)
        if "grey" in form and bits < 8:  # PIL reads a grey palette's indices as 8-bit data
            w = min(w, 4)
            idx = idx[:, :w]
        return bmp_bytes(w, h, bits, bmp_rows(idx, bits), header=header,
                         palette=pal.tobytes(), colors=0 if header == 12 else colors)
    if form.startswith("rle"):
        rle4 = form.startswith("rle4")
        n = int(r.integers(2, 17))
        pal = r.integers(0, 256, (n, 4)).astype(np.uint8).tobytes()
        idx = np.repeat(r.integers(0, n, (h, -(-w // 2))), 2, axis=1)[:, :w]
        return bmp_bytes(w, h, 4 if rle4 else 8, bmp_rle(idx, rle4, r), compression=2 if rle4
                         else 1, palette=pal, colors=n)
    if form.startswith("bitfields"):
        bits, masks = {"bitfields565": (16, (0xF800, 0x7E0, 0x1F)),
                       "bitfields555": (16, (0x7C00, 0x3E0, 0x1F)),
                       "bitfields24": (24, (0xFF0000, 0xFF00, 0xFF)),
                       "bitfields32-xbgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
                       "bitfields32-rgba": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                       "bitfields32-bgar": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000))}[form]
        header = 108 if bits == 32 else 40
        return bmp_bytes(w, h, bits, bmp_rows(r.integers(0, 256, (h, w, bits // 8)), bits),
                         header=header, compression=3, masks=masks, masks_in_header=bits == 32)
    bits = int(form.split("-")[0][3:])
    top = "topdown" in form
    return bmp_bytes(w, -h if top else h, bits,
                     bmp_rows(r.integers(0, 256, (h, w, bits // 8)), bits, top_down=top),
                     header=header)


BMP_FORMS = ["pal1", "pal1-os2", "pal4", "pal4-v5", "pal8", "pal8-os2", "pal8-grey",
             "pal4-grey", "pal1-grey", "rle8", "rle4", "bitfields565", "bitfields555",
             "bitfields24", "bitfields32-xbgr", "bitfields32-rgba", "bitfields32-bgar",
             "rgb16", "rgb24", "rgb24-topdown", "rgb24-os2", "rgb24-v4", "rgb32",
             "rgb32-topdown-v3", "rgb24-v2"]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("form", BMP_FORMS)
def test_drawn_bmp_matches_pil(tmp_path, form, seed):
    r = np.random.default_rng(seed + 100 * BMP_FORMS.index(form))
    _matches_pil(_bmp_form(form, r), tmp_path if seed == 0 else None, "d.bmp")


def test_bmp_rle_escapes_follow_pils_decoder():
    """End of line, end of bitmap, odd absolute packets (RLE4 keeps whole
    bytes only) and a delta escape (PIL reads two bytes past it)."""
    pal = bytes(np.random.default_rng(0).integers(0, 256, 64).astype(np.uint8))
    for rle4, body in ((False, [2, 1, 0, 0, 0, 3, 1, 2, 3, 0, 0, 0, 4, 2, 0, 1]),
                       (True, [3, 0x12, 0, 0, 0, 5, 0x34, 0x56, 0x70, 0, 0, 4, 0x11, 0, 1]),
                       (False, [2, 1, 0, 2, 9, 9, 1, 1, 0, 0, 4, 3, 0, 0, 4, 5, 0, 1])):
        _matches_pil(bmp_bytes(4, 3, 4 if rle4 else 8, bytes(body),
                               compression=2 if rle4 else 1, palette=pal, colors=16))


# ----------------------------------- PNM ----------------------------------------

PNM_FORMS = {"p1": (1, 1), "p2-255": (2, 255), "p2-100": (2, 100), "p2-1000": (2, 1000),
             "p3-255": (3, 255), "p3-7": (3, 7), "p3-65535": (3, 65535), "p4": (4, 1),
             "p5-255": (5, 255), "p5-1": (5, 1), "p5-31": (5, 31), "p5-1000": (5, 1000),
             "p5-65535": (5, 65535), "p6-255": (6, 255), "p6-100": (6, 100),
             "p6-1000": (6, 1000), "p6-65535": (6, 65535)}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("form", list(PNM_FORMS))
def test_drawn_pnm_matches_pil(tmp_path, form, seed):
    kind, maxval = PNM_FORMS[form]
    r = np.random.default_rng(seed + 100 * list(PNM_FORMS).index(form))
    h, w = int(r.integers(1, 12)), int(r.integers(1, 19))
    shape = (h, w, 3) if kind in (3, 6) else (h, w)
    data = pnm_bytes(kind, r.integers(0, 2 if kind in (1, 4) else maxval + 1, shape), maxval,
                     comments=bool(seed), seed=seed * 7)
    _matches_pil(data, tmp_path if seed == 0 else None, "d.pnm")


def test_pnm_maxval_scaling_and_the_16bit_grey_clip():
    """maxval 100: 50 reads 128 (round of 127.5, to even); P6 above 255
    scales likewise (1000 of 1000 -> 255, 500 -> 128, 3 -> 1); P5 above
    255 is PIL's mode I, scaled to 65535 and clipped at 255."""
    px = _matches_pil(pnm_bytes(5, np.array([[0, 50, 100, 1, 99]]), 100))
    assert px[0, :, 0].tolist() == [0, 128, 255, 3, 252]
    px = _matches_pil(pnm_bytes(6, np.array([[[1000, 500, 3]]]), 1000))
    assert px[0, 0].tolist() == [255, 128, 1]
    px = _matches_pil(pnm_bytes(5, np.array([[0, 1, 3, 4, 500, 1000]]), 1000))
    assert px[0, :, 0].tolist() == [0, 66, 197, 255, 255, 255]


def test_pnm_header_comments_split_tokens_as_pil_reads_them():
    data = b"P5\n# c\n1#split\n2 3 2#x\n55\n" + bytes(range(36))
    _matches_pil(data)
    assert port_image.decode_image(data).shape == (3, 12, 3)


# ------------------------------ PIL's other PNM modes ------------------------------

PNM_MODES = {"p0cmyk": (b"P0CMYK", 4), "pycmyk": (b"PyCMYK", 4), "pyrgba": (b"PyRGBA", 4),
             "pyp": (b"PyP", 1)}


@pytest.mark.parametrize("maxval", [255, 1, 100, 255 + 1, 1000, 65535])
@pytest.mark.parametrize("mode", list(PNM_MODES))
def test_drawn_pnm_modes_match_pil_and_jax(tmp_path, mode, maxval):
    """P0CMYK / PyCMYK through PIL's cmyk2rgb, PyRGBA's alpha dropped, PyP
    (no palette in the file) black; raw at 8 bits, or 16 above 255; a
    maxval other than 255 scales with Python's round, samples past it
    clipped; a file cut short refused as PIL refuses it."""
    magic, bands = PNM_MODES[mode]
    r = np.random.default_rng(maxval + 7 * list(PNM_MODES).index(mode))
    h, w = int(r.integers(1, 12)), int(r.integers(1, 15))
    top = 255 if maxval < 256 else maxval  # 8-bit samples may pass a small maxval
    data = pnm_mode_bytes(magic, r.integers(0, top + 1, (h, w, bands)), maxval)
    got = _matches_pil(data, tmp_path, "m.pnm")
    if mode == "pyp":
        assert not got.any()
    with pytest.raises(Exception):
        _pil(data[:-1])
    with pytest.raises(ValueError, match="PNM image data is truncated"):
        port_image.decode_image(data[:-1], "m.pnm")


def test_pnm_cmyk_probe_value():
    data = pnm_mode_bytes(b"P0CMYK", np.array([[[10, 20, 30, 40]]]))
    assert _matches_pil(data)[0, 0].tolist() == [207, 198, 190]
    zeros16 = pnm_mode_bytes(b"P0CMYK", np.zeros((1, 2, 4), int), 65535)
    assert _matches_pil(zeros16).tolist() == [[[255, 255, 255]] * 2]


PFM_VALUES = np.float32([0.6, 254.6, 300, -3, np.nan, np.inf, -np.inf, 255, 254.99, 1e-30,
                         -0.0, 128.5, 0.0, 1.0, 0.999, 3e38, -3e38, 65535.5])


@pytest.mark.parametrize("scale", [-1.0, -0.25, 1.0, 7.5, -1e30])
@pytest.mark.parametrize("seed", range(3))
def test_drawn_pfm_matches_pil_and_jax(tmp_path, scale, seed):
    """``Pf``: rows bottom up, little-endian under a negative scale;
    ``convert("RGB")`` truncates toward zero and clips to 0..255, NaN and
    -inf to 0 and +inf to 255."""
    r = np.random.default_rng(seed * 31 + int(abs(scale) * 4) % 1000)
    h, w = int(r.integers(1, 10)), int(r.integers(1, 12))
    v = r.uniform(-40, 300, h * w).astype(np.float32)
    picks = r.random(h * w) < 0.3
    v[picks] = r.choice(PFM_VALUES, int(picks.sum()))
    got = _matches_pil(pfm_bytes(v.reshape(h, w), scale), tmp_path if seed == 0 else None,
                       "f.pfm")
    with np.errstate(invalid="ignore"):
        want = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.nan_to_num(v)), 0))
    np.testing.assert_array_equal(got[..., 0].ravel(), want.astype(np.uint8))


def test_pfm_probe_values_and_refusals(tmp_path):
    px = _matches_pil(pfm_bytes(np.float32([[0.6, 254.6, 300, -3, np.nan]])))
    assert px[0, :, 0].tolist() == [0, 254, 255, 0, 0]
    for scale in (b"0", b"-0.0", b"nan", b"inf", b"-inf"):
        data = b"Pf\n2 1\n" + scale + b"\n" + bytes(8)
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(ValueError, match="PFM scale"):
            port_image.decode_image(data, "f.pfm")
    short = pfm_bytes(np.zeros((2, 3), np.float32))[:-1]
    with pytest.raises(Exception):
        _pil(short)
    with pytest.raises(ValueError, match="PFM image data is truncated"):
        port_image.decode_image(short, "f.pfm")
    # colour PF: PIL has no such mode and no format takes the file
    colour = b"PF\n2 1\n-1.0\n" + bytes(24)
    with pytest.raises(Exception):
        _pil(colour)
    with pytest.raises(ValueError, match="unsupported image format"):
        port_image.decode_image(colour, "f.pfm")
    # another magic PIL's PNM plugin accepts: it gives up and no format takes it
    with pytest.raises(Exception):
        _pil(b"Pfoo 2 1 -1.0 " + bytes(8))
    with pytest.raises(ValueError, match="PIL gives up on it: PNM magic b'Pfoo'"):
        port_image.decode_image(b"Pfoo 2 1 -1.0 " + bytes(8), "f.pfm")


# ----------------------------------- DIB ----------------------------------------

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("form", BMP_FORMS)
def test_drawn_dib_matches_pil_and_jax(tmp_path, form, seed):
    """A DIB file is the BMP without its 14-byte file header, its pixels
    right after the header, masks and palette: every header size 12-124,
    every depth, RLE, bitfields, both row orders."""
    r = np.random.default_rng(seed + 100 * BMP_FORMS.index(form) + 7)
    data = _bmp_form(form, r)[14:]
    assert port_image.image_format(data) == "DIB"
    _matches_pil(data, tmp_path if seed == 0 else None, "d.dib")


@pytest.mark.parametrize("header", [56, 64])
def test_dib_header_sizes_56_and_64(tmp_path, header):
    r = np.random.default_rng(header)
    for bits in (1, 4, 8, 24, 32):
        if bits <= 8:
            pal = r.integers(0, 256, (1 << bits) * 4).astype(np.uint8).tobytes()
            rows = bmp_rows(r.integers(0, 1 << bits, (5, 9)), bits)
        else:
            pal, rows = b"", bmp_rows(r.integers(0, 256, (5, 9, bits // 8)), bits)
        data = bmp_bytes(9, 5, bits, rows, header=header, palette=pal,
                         colors=(1 << bits) if bits <= 8 else 0)[14:]
        _matches_pil(data, tmp_path, f"h{bits}.dib")


def test_pils_dib_writer_reads_as_pil_and_jax(tmp_path):
    for mode in ("RGB", "RGBA", "L", "P", "1"):
        b = io.BytesIO()
        Image.fromarray(pattern(7, 11, 3)).convert(mode).save(b, "DIB")
        _matches_pil(b.getvalue(), tmp_path, f"{mode}.dib")


def test_dibs_pil_gives_up_on_go_to_the_next_format():
    """Bitfield masks cut short (PIL's struct.error) and a size of 0 make
    PIL try the formats after DIB, none of which takes these files."""
    masks_cut = bmp_bytes(2, 1, 16, bytes(4), compression=3, masks=(0xF800, 0x7E0, 0x1F),
                          masks_in_header=False)[14:54 + 6]
    zero = bmp_bytes(0, 3, 24, b"")[14:]
    for data in (masks_cut, zero):
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(ValueError, match="unsupported image format.*PIL gives up on it.*DIB"):
            port_image.decode_image(data, "g.dib")
    truncated = bmp_bytes(5, 4, 24, bytes(50))[14:]
    with pytest.raises(Exception):
        _pil(truncated)
    with pytest.raises(ValueError, match="DIB image data is truncated"):
        port_image.decode_image(truncated, "t.dib")


def test_dib_routing_follows_image_preinit():
    """BMP, then DIB (a first u32 that is a header size), in PIL's order;
    other first words are not DIBs."""
    for size in (12, 40, 52, 56, 64, 108, 124):
        assert port_image.image_format(struct.pack("<I", size) + bytes(12)) == "DIB"
    for size in (0, 16, 39, 41, 123, 125):
        assert port_image.image_format(struct.pack("<I", size) + bytes(12)) != "DIB"
    assert port_image.image_format(b"BM" + bytes(14)) == "BMP"


# ----------------------------------- GIF ----------------------------------------

GIF_FORMS = ["global", "local", "interlaced", "min-code-2", "min-code-3", "min-code-5",
             "min-code-7", "clears", "offset", "offset-transparent", "grey-ramp",
             "small-blocks", "gif87a", "bigger-frame"]


def _gif_form(form, r):
    h, w = int(r.integers(1, 30)), int(r.integers(1, 30))
    bits = int(form.rsplit("-", 1)[1]) if form.startswith("min-code") else 8
    npal = 1 << max(1, bits)
    idx = r.integers(0, npal, (h, w))
    pal = r.integers(0, 256, (npal, 3))
    kw = dict(min_code=max(2, bits))
    if form == "local":
        kw["local"] = True
    elif form == "interlaced":
        kw["interlace"] = True
    elif form == "clears":
        kw["clear_every"] = int(r.integers(1, 20))
    elif form.startswith("offset"):
        kw["offset"] = (int(r.integers(0, 5)), int(r.integers(0, 5)))
        kw["screen"] = (w + kw["offset"][0] + int(r.integers(0, 4)),
                        h + kw["offset"][1] + int(r.integers(0, 4)))
        kw["background"] = int(r.integers(1, 256))
        if form == "offset-transparent":
            kw["transparency"] = int(r.integers(0, 256))
    elif form == "grey-ramp":
        pal = np.repeat(np.arange(npal)[:, None], 3, axis=1)
    elif form == "small-blocks":
        kw["block"] = int(r.integers(1, 9))
    elif form == "gif87a":
        kw["version"] = b"GIF87a"
    elif form == "bigger-frame":  # the frame outgrows the logical screen
        kw["screen"] = (max(1, w - 3), max(1, h - 2))
        kw["offset"] = (2, 1)
    return gif_bytes(idx, pal, **kw)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("form", GIF_FORMS)
def test_drawn_gif_matches_pil(tmp_path, form, seed):
    r = np.random.default_rng(seed + 100 * GIF_FORMS.index(form))
    _matches_pil(_gif_form(form, r), tmp_path if seed == 0 else None, "d.gif")


def test_gif_full_code_table_and_pils_writer():
    """A table that fills its 4,096 codes (no clear code after), and the
    GIFs Pillow writes of an image quantised to 256 and to 4 colours."""
    r = np.random.default_rng(3)
    _matches_pil(gif_bytes(r.integers(0, 4, (200, 210)), r.integers(0, 256, (4, 3)),
                           min_code=2, interlace=True))
    img = Image.fromarray(pattern(120, 90, 4))
    for colors in (256, 4):
        bio = io.BytesIO()
        img.quantize(colors).save(bio, "GIF")
        _matches_pil(bio.getvalue())


def test_gif_outside_the_frame_reads_index_0_or_the_transparency_index():
    pal = np.arange(24).reshape(8, 3) * 10 + 5
    idx = np.full((2, 3), 7)
    px = _matches_pil(gif_bytes(idx, pal, screen=(5, 4), offset=(1, 1), background=6,
                                min_code=3))
    assert px[0, 0].tolist() == pal[0].tolist() and px[1, 1].tolist() == pal[7].tolist()
    px = _matches_pil(gif_bytes(idx, pal, screen=(5, 4), offset=(1, 1), transparency=7,
                                min_code=3))
    assert (px == pal[7]).all()


def _gif_ending_early(idx, pal, cut, tail=True):
    """A GIF whose LZW stream ends (end code) after ``cut`` pixels; with
    ``tail`` the stream goes on after it with a clear code and the rest."""
    from tools.make_torch_port_image_fixtures import lzw_codes, pack_codes, sub_blocks

    head = gif_bytes(idx[:1, :1], pal)[:13 + 3 * len(pal)]
    codes, sizes = lzw_codes(idx.reshape(-1)[:cut], 8)
    if tail:
        rest, rest_sizes = lzw_codes(idx.reshape(-1)[cut:], 8)
        codes, sizes = codes + rest, sizes + [sizes[-1]] + rest_sizes[1:]
    h, w = idx.shape
    return (head + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
            + sub_blocks(pack_codes(codes, sizes)) + b";")


def test_gif_early_end_code_reads_as_pil_reads():
    """PIL feeds its decoder 64 KiB reads: an end code before the frame is
    full stops it, and where more of the file follows the bytes read so
    far PIL reads on and decodes past the end code; otherwise the file is
    truncated. The port does both."""
    r = np.random.default_rng(8)
    pal = r.integers(0, 256, (256, 3))
    big = r.integers(0, 256, (400, 420))
    px = _matches_pil(_gif_ending_early(big, pal, 20_000))
    np.testing.assert_array_equal(px, pal[big].astype(np.uint8))
    for data in (_gif_ending_early(big, pal, big.size - 5_000),
                 _gif_ending_early(big[:40], pal, 3_000),
                 _gif_ending_early(big[:40], pal, 3_000, tail=False)):
        with pytest.raises(OSError, match="truncated"):
            _pil(data)
        with pytest.raises(ValueError, match="GIF image data is truncated"):
            port_image.decode_image(data)


def test_gif_lzw_build_failure_raises(tmp_path, monkeypatch):
    """No Python LZW decoder to fall back to: a missing compiler raises."""
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-akari")
    with pytest.raises(RuntimeError, match="not found.*GIF decoder"):
        port_image.decode_image(gif_bytes(np.zeros((2, 2), int), np.zeros((4, 3), int),
                                          min_code=2))


# ----------------------------------- PSD ----------------------------------------

PSD_FORMS = {"bitmap": (0, 1, 1), "grey": (1, 8, 1), "grey-bitmap-mode-8bit": (0, 8, 1),
             "indexed": (2, 8, 1), "indexed-no-palette": (2, 8, 1), "rgb": (3, 8, 3),
             "rgba": (3, 8, 4), "rgb-extra-channels": (3, 8, 5), "cmyk": (4, 8, 4),
             "cmyk-alpha": (4, 8, 5), "multichannel": (7, 8, 3), "duotone": (8, 8, 1)}


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("form", list(PSD_FORMS))
def test_drawn_psd_matches_pil(tmp_path, form, compression):
    mode, bits, channels = PSD_FORMS[form]
    r = np.random.default_rng(list(PSD_FORMS).index(form) * 2 + compression)
    h, w = int(r.integers(1, 12)), int(r.integers(1, 20))
    line = -(-w // 8) if bits == 1 else w
    planes = np.repeat(r.integers(0, 256, (channels, h, -(-line // 3))), 3, axis=2)[..., :line]
    planes[..., ::4] = r.integers(0, 256, planes[..., ::4].shape)
    cd = r.integers(0, 256, 768).astype(np.uint8).tobytes() if form == "indexed" else b""
    data = psd_bytes(planes, mode, bits, compression, color_data=cd, seed=int(r.integers(99)))
    if bits == 1:
        data = data[:18] + struct.pack(">I", w) + data[22:]
    _matches_pil(data, tmp_path if compression else None, "d.psd")


def test_psd_cmyk_reads_as_pil_inverts_and_converts():
    """PIL stores PSD CMYK inverted: samples (255, 200, 100, 0) read as
    black; and its CMYK -> RGB rounding, over every (c, k) pair."""
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), 0)
    planes = np.stack([grid[0], grid[0][::-1], (grid[0] * 7) % 256, grid[1]]).astype(np.uint8)
    px = _matches_pil(psd_bytes(planes, 4, compression=0))
    assert px[255, 0].tolist() == [0, 0, 0]
    assert _matches_pil(psd_bytes(np.array([255, 200, 100, 0]).reshape(4, 1, 1), 4,
                                  compression=0))[0, 0].tolist() == [0, 0, 0]


# -------------------------- corruptions of the fixtures -------------------------

@pytest.mark.parametrize("seed", range(8))
def test_corrupted_files_read_as_pil_or_are_refused_as_pil_refuses(seed):
    """Seeded byte changes, cuts and tails on every format fixture: where
    PIL reads the file the pixels are equal, where it refuses it the port
    raises ValueError (never another error)."""
    r = np.random.default_rng(seed)
    base = format_fixtures(np.random.default_rng(11))
    names = sorted(base)
    read = refused = 0
    for _ in range(150):
        name = names[r.integers(len(names))]
        data = bytearray(base[name])
        op = r.integers(0, 4)
        if op == 0:
            for _ in range(r.integers(1, 4)):
                data[r.integers(0, len(data))] = r.integers(0, 256)
        elif op == 1:
            data[r.integers(0, min(len(data), 40))] = r.integers(0, 256)
        elif op == 2:
            data = data[:r.integers(0, len(data) + 1)]
        else:
            data += r.integers(0, 256, r.integers(1, 20)).astype(np.uint8).tobytes()
        data = bytes(data)
        try:
            want = _pil(data)
        except Exception:
            with pytest.raises(ValueError):
                port_image.decode_image(data, name)
            refused += 1
            continue
        np.testing.assert_array_equal(port_image.decode_image(data, name), want,
                                      err_msg=f"{name}: {data.hex()}")
        read += 1
    assert read > 30 and refused > 30


# ---------------------------------- refused forms -------------------------------

def _tga_header(imtype, depth, w=2, h=2, cmtype=0, cm_len=0, cm_depth=0):
    return struct.pack("<BBBHHBHHHHBB", 0, cmtype, imtype, 0, cm_len, cm_depth, 0, 0, w, h,
                       depth, 0)


def _psd_header(mode, bits, channels=3):
    return psd_bytes(np.zeros((channels, 2, 2), np.uint8), mode, bits, compression=0)


REFUSED = {
    "tga-cmap32": (lambda: _tga_header(1, 8, cmtype=1, cm_len=2, cm_depth=32) + bytes(12),
                   "32-bit entries"),
    "tga-cmap15": (lambda: _tga_header(1, 8, cmtype=1, cm_len=2, cm_depth=15) + bytes(8),
                   "15-bit entries"),
    "tga-indices-no-cmap": (lambda: _tga_header(1, 8) + bytes(4), "without a colour map"),
    "tga-truecolour-with-cmap": (
        lambda: _tga_header(2, 24, cmtype=1, cm_len=1, cm_depth=24) + bytes(15),
        "with a colour map"),
    "tga-grey24": (lambda: _tga_header(3, 24) + bytes(12), "type 3 at 24 bits"),
    # PIL's TGA header check takes depths 1, 8, 16, 24 and 32 only
    "tga-15bit": (lambda: _tga_header(2, 15) + bytes(8), "unsupported image format"),
    "tga-rgb8": (lambda: _tga_header(2, 8) + bytes(4), "type 2 at 8 bits"),
    "tga-rle-1bit": (lambda: _tga_header(11, 1) + bytes(8), "1 bit"),
    "tga-truncated": (lambda: _tga_header(2, 24) + bytes(11), "TGA image data is truncated"),
    "tga-rle-truncated": (lambda: _tga_header(10, 24) + bytes([0x81, 1, 2, 3]),
                          "TGA run-length data is truncated"),
    "bmp-2bit": (lambda: bmp_bytes(4, 1, 2, bytes(4), palette=bytes(16)), "2 bits per pixel"),
    "bmp-bitfields-masks": (
        lambda: bmp_bytes(2, 1, 16, bytes(4), compression=3, masks=(0xF800, 0x7E0, 0x1E),
                          masks_in_header=False), "bitfields"),
    "bmp-jpeg": (lambda: bmp_bytes(2, 1, 24, bytes(8), compression=4), "compression 4"),
    "bmp-png": (lambda: bmp_bytes(2, 1, 24, bytes(8), compression=5), "compression 5"),
    "bmp-header-16": (lambda: b"BM" + struct.pack("<IHHII", 40, 0, 0, 30, 16) + bytes(20),
                      "header of 16 bytes"),
    "bmp-rle8-ends-early": (
        lambda: bmp_bytes(4, 2, 8, bytes([4, 1, 0, 1]), compression=1, palette=bytes(16),
                          colors=4), "ends early"),
    "bmp-rle-24bit": (lambda: bmp_bytes(4, 2, 24, bytes([4, 1, 0, 1]), compression=1),
                      "RLE8 at 24 bits"),
    "bmp-palette-300": (lambda: bmp_bytes(2, 1, 8, bytes(4), palette=bytes(range(256)) * 5,
                                          colors=300), "300 colours"),
    "bmp-truncated": (lambda: bmp_bytes(5, 4, 24, bytes(50)), "truncated"),
    "pnm-pfm": (lambda: b"Pf\n2 2\n0.0\n" + bytes(16), "PFM scale 0.0"),
    "pnm-maxval-0": (lambda: b"P5 2 2 0 " + bytes(4), "maxval 0"),
    "pnm-maxval-65536": (lambda: b"P5 2 2 65536 " + bytes(8), "maxval 65536"),
    "pnm-plain-bad-token": (lambda: b"P2 2 1 255 12 x3", "not a number"),
    "pnm-plain-above-maxval": (lambda: b"P2 2 1 100 12 101 ", "outside"),
    "pbm-plain-bad-digit": (lambda: b"P1 2 2 0 1 2 0", "PBM plain data holds"),
    "pnm-truncated": (lambda: b"P6 2 2 255 " + bytes(11), "truncated"),
    "pnm-token-too-long": (lambda: b"P5 12345678901 1 255 " + bytes(4), "too long"),
    "gif-no-image": (lambda: b"GIF89a" + struct.pack("<HHBBB", 2, 2, 0, 0, 0) + b";",
                     "without an image"),
    "gif-truncated": (lambda: gif_bytes(np.arange(64).reshape(8, 8) % 4,
                                        np.zeros((4, 3), int), min_code=2)[:-12], "truncated"),
    # LZW of 2-bit pixels: a clear code (4), then code 7, above the clear code
    "gif-bad-code": (lambda: gif_bytes(np.zeros((2, 2), int), np.zeros((4, 3), int),
                                       min_code=2).split(b",")[0] + b"," + struct.pack(
        "<HHHHB", 0, 0, 2, 2, 0) + b"\x02\x01\x3c\x00;", "corrupt"),
    "psd-16bit": (lambda: _psd_header(3, 16), "RGB at 16 bits"),
    "psd-lab": (lambda: _psd_header(9, 16), "Lab at 16 bits"),
    "psd-zip": (lambda: _psd_header(3, 8)[:-14] + b"\x00\x02" + bytes(12), "compression 2"),
    "psd-channels": (lambda: _psd_header(4, 8, channels=3), "CMYK with 3 channels"),
    "psd-version-2": (lambda: b"8BPS\x00\x02" + _psd_header(3, 8)[6:], "version 2"),
    "tiff-le": (lambda: _ccitt_tiff("<", 4), "CCITT Group 4 TIFF data ends early"),
    "tiff-be": (lambda: _ccitt_tiff(">", 2), "CCITT RLE TIFF data ends early"),
    # a VP8 chunk of 0 bytes: libwebp refuses it, and so does the port's WebP decoder
    "webp": (lambda: b"RIFF" + struct.pack("<I", 40) + b"WEBPVP8 " + bytes(40),
             r"WebP file refused by libwebp's checks"),
}


def _ccitt_tiff(order, group):
    """A bilevel TIFF whose one strip of zero bytes is labelled CCITT RLE or
    Group 4: no row decodes, so libtiff, and with it PIL, refuses the
    strip, and the port names the cause."""
    from tools.make_torch_port_image_fixtures import tiff_bytes

    return tiff_bytes(np.zeros((4, 8, 1), int), 1, 0, order=order, compression=1,
                      tags={259: (3, [group])})


@pytest.mark.parametrize("form", list(REFUSED))
def test_refused_forms_name_themselves(tmp_path, form):
    make, match = REFUSED[form]
    data = make()
    path = tmp_path / f"r.{form.split('-')[0]}"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)
    with pytest.raises(Exception):
        _pil(data)


def test_lab_psd_is_read_by_pil_and_refused_by_the_port(tmp_path):
    """Once refused, now read: grey (128, 128, 128) reads (119, 119, 119),
    equal to PIL's and to the JAX package's read."""
    data = psd_bytes(np.full((3, 1, 1), 128, np.uint8), 9, compression=0)
    assert _pil(data)[0, 0].tolist() == [119, 119, 119]
    assert _matches_pil(data, tmp_path, "lab.psd")[0, 0].tolist() == [119, 119, 119]


def test_formats_are_told_apart_as_pil_tells_them(tmp_path):
    """By signature, whatever the file's name; TGA last, by its header."""
    r = np.random.default_rng(5)
    cases = {"tga.png": _tga_form((2, 24, 0), r), "bmp.tga": _bmp_form("rgb24", r),
             "gif.jpg": _gif_form("global", r), "psd.gif": _psd_header(3, 8),
             "ppm.bmp": pnm_bytes(6, r.integers(0, 256, (3, 4, 3)))}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        _same_read(str(tmp_path / name))
    assert [port_image.image_format(d) for d in cases.values()] == [
        "TGA", "BMP", "GIF", "PSD", "PNM"]
    assert port_image.image_format(b"\x00" * 17) is None


# ------------------------------ an OBJ on a TGA albedo --------------------------

def test_obj_map_kd_tga_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd albedo.tga`` (RLE, bottom-left
    origin): the texture tables and a 16x16 CPU render equal those of the
    same OBJ on a PNG of the same pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    tex = pattern(24, 32, 9)
    (tmp_path / "albedo.tga").write_bytes(tga_bytes(tex[..., ::-1], 10, 24, seed=3))
    (tmp_path / "albedo.png").write_bytes(port_image.encode_png(tex))
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = [], []
    for ext in ("tga", "png"):
        (tmp_path / f"m_{ext}.mtl").write_text(
            f"newmtl ground\nKd 1 1 1\nmap_Kd albedo.{ext}\nnewmtl lamp\nKe 40 35 30\n")
        (tmp_path / f"m_{ext}.obj").write_text(f"mtllib m_{ext}.mtl\n" + obj)
        scene = Scene(shapes=[load_obj(str(tmp_path / f"m_{ext}.obj"))]).compile(
            intersector="dense", device="cpu")
        tables.append(scene.textures.images.numpy())
        frames.append(render(scene, cam, PathConfig(spp=4, max_depth=3)).numpy())
    np.testing.assert_array_equal(tables[0], tables[1])
    assert frames[0].mean() > 0.01 and np.isfinite(frames[0]).all()
    np.testing.assert_array_equal(frames[0], frames[1])
