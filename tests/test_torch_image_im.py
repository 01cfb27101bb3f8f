"""Port parity: the PIL-free IM, IM Tools and IPTC/NAA decoders
(akari_torch/core/im.py, akari_torch/core/iptc.py) against PIL 12.1.0's
``ImImagePlugin``, ``ImtImagePlugin`` and ``IptcImagePlugin``, through
which the JAX package's ``read_image`` reads such files. None of the three
has a signature: PIL runs each plugin's header parse on every file that
reaches it, and so does the port.

Tolerance: exact. Wherever PIL reads a file the port gives PIL's
``convert("RGB")`` pixels and names the same format; wherever PIL refuses
it (its open or its load fails) the port raises ``ValueError``:

- the plugin fixtures of ``tests/data/torch_port_images`` (IM, IMT, IPTC,
  SPIDER, DCX, MSP, XBM) equal what ``plugin_fixtures`` writes, decode to
  PIL's digests and read through both packages' ``read_image`` bit for bit;
- IM: every image type of PIL's table on drawn data (the raw modes PIL
  has no unpacker for refused), the Lut forms (a colour table makes grey
  and index images palette images; a grey one is not applied), the header
  rules (defaults, line ends, sizes PIL parses, opens and cannot load, or
  refuses), a seeded header grammar, YCbCr on every (Cb, Cr) pair, the
  ``bit`` decoder at every width 2-31;
- IM Tools: drawn files and a seeded header grammar;
- IPTC: raw and JPEG data, grey and one band of RGB or CMYK, extended
  lengths, the refusals (a field length byte above 132, an unknown
  compression, a band past the image's, a colour JPEG as a band, no data,
  a broken field after the data) and a seeded field soup.
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
from PIL import Image, ImImagePlugin

from akari_torch.core import im as port_im
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tools import raster_writers as rw
from tools.make_torch_port_image_fixtures import pattern, plugin_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
PREFIXES = ("im_", "imt_", "iptc_", "spider_", "dcx_", "msp_", "xbm_")
PLUGIN_FIXTURES = sorted(n for n in json.load(open(os.path.join(FIXTURES, "digests.json")))
                         if n.startswith(PREFIXES))
PIL_NAMES = {"PPM": "PNM", "WEBP": "WebP"}


def _pil_path(path):
    """PIL's format and ``convert("RGB")`` of a file, or (None, None)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(path) as im:
                fmt = im.format
                return PIL_NAMES.get(fmt, fmt), np.asarray(im.convert("RGB"))
        except Exception:
            return None, None


def _same_read(path):
    """Both packages' read_image, linear and not: bit-equal."""
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _check(tmp_path, data, fmt=None, jax=False, name="f"):
    """The port reads ``data`` as PIL reads it (the same format and pixels)
    or refuses it where PIL does; ``fmt``: the format PIL must read it as
    (False: PIL must refuse it). Returns the port's pixels or None."""
    path = tmp_path / name
    path.write_bytes(data)
    want_fmt, want = _pil_path(str(path))
    if fmt is not None:
        assert want_fmt == (fmt or None), f"PIL reads it as {want_fmt}"
    try:
        got_fmt, got = port_image.decode_with_format(data, name)
    except ValueError:
        got_fmt = got = None
    if want is None:
        assert got is None, f"PIL refuses the file, the port reads it as {got_fmt}"
        return None
    assert got is not None, f"PIL reads the file as {want_fmt}, the port refuses it"
    assert got_fmt == want_fmt
    np.testing.assert_array_equal(got, want)
    if jax:
        _same_read(str(path))
    return got


# ------------------------------------------------------------------ the fixtures

def test_plugin_fixtures_are_the_tools_and_pils():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    written = plugin_fixtures()
    assert sorted(written) == PLUGIN_FIXTURES and len(PLUGIN_FIXTURES) >= 45
    for name in PLUGIN_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert written[name] == f.read(), name
        px = _pil_path(os.path.join(FIXTURES, name))[1]
        assert hashlib.sha256(px.tobytes()).hexdigest() == digests[name]["sha256"], name


@pytest.mark.parametrize("name", PLUGIN_FIXTURES)
def test_plugin_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        rec = json.load(f)[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        fmt, px = port_image.decode_with_format(f.read(), name)
    assert fmt == _pil_path(path)[0]
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ------------------------------------------------------------------ IM

IM_TYPES = sorted(ImImagePlugin.OPEN)


def test_the_ports_table_is_pils():
    assert port_im.OPEN == ImImagePlugin.OPEN


@pytest.mark.parametrize("image_type", IM_TYPES)
def test_every_im_image_type_reads_as_pil_reads_it(tmp_path, image_type):
    """Drawn data of every type, twice, once with a row's worth of bytes
    missing: PIL's raw decoder (and its ``bit`` decoder) read it, or refuse
    it, as the port does; the RLB and PA types PIL has no unpacker for."""
    r = np.random.default_rng(IM_TYPES.index(image_type))
    for k in range(2):
        w, h = int(r.integers(1, 23)), int(r.integers(1, 9))
        body = r.integers(0, 256, 4 * w * h + 8).astype(np.uint8).tobytes()
        if k:
            body = body[:int(r.integers(0, 4 * w * h))]
        data = rw.im_bytes(body, image_type, (w, h), lines=(b"Name: drawn",))
        got = _check(tmp_path, data, jax=k == 0)
        if image_type in ("RLB image", "RYB image", "PA image"):
            assert got is None


@pytest.mark.parametrize("image_type", ["Greyscale image", "LA image", "PA image", "B2 image",
                                        "B4 image", "RGB image", "0 1 image", "L 16 image"])
@pytest.mark.parametrize("lut", ["colour", "grey", "ramp", "short", "short_grey"])
def test_im_lut_forms_read_as_pil_reads_them(tmp_path, image_type, lut):
    """A colour table makes grey and index images palette images (LA and PA
    PA images); a grey table, linear or not, is kept unapplied (PIL stores
    it as an attribute its loaders never read); a table cut short makes PIL
    try the next format when a grey entry runs past its end."""
    r = np.random.default_rng(len(image_type) + 7 * len(lut))
    w, h = 11, 6
    table = {"colour": r.integers(0, 256, 768).astype(np.uint8).tobytes(),
             "grey": np.tile(np.arange(255, -1, -1, dtype=np.uint8), 3).tobytes(),
             "ramp": np.tile(np.arange(256, dtype=np.uint8), 3).tobytes(),
             "short": r.integers(0, 256, 600).astype(np.uint8).tobytes(),
             "short_grey": np.tile(np.arange(256, dtype=np.uint8), 3).tobytes()[:700]}[lut]
    body = r.integers(0, 256, 4 * w * h).astype(np.uint8).tobytes()
    if lut.startswith("short"):
        body = b""   # the file ends inside the table
    head = rw.im_bytes(b"", image_type, (w, h), lut=b"")
    got = _check(tmp_path, head + table + body)
    if lut in ("grey", "ramp") and image_type == "Greyscale image":
        assert got is not None   # the non-linear grey table leaves the pixels as stored
        np.testing.assert_array_equal(got[..., 0], np.frombuffer(body[:w * h], np.uint8)
                                      .reshape(h, w)[::-1])
    if lut == "short_grey":
        assert got is None


IM_HEADERS = {
    "defaults": b"Name: no type, no size\n\x1a",
    "lf_cr": b"Image type: Greyscale image\n\rImage size (x*y): 5*3\n\r\x1a",
    "nul_end": b"Image type: Greyscale image\nImage size (x*y): 5*3\n\0\0garbage\x1a",
    "no_1a": b"Image type: Greyscale image\nImage size (x*y): 5*3\n\0",
    "long_line": b"Image type: Greyscale image\nComment: " + b"x" * 95 + b"\n\x1a",
    "no_tag": b"Colour: red\nWidth: 5\n\x1a",
    "blank_line": b"Image type: Greyscale image\n\nImage size (x*y): 5*3\n\x1a",
    "size_float": b"Image type: Greyscale image\nImage size (x*y): 5.0*3\n\x1a",
    "size_three": b"Image type: Greyscale image\nImage size (x*y): 5*3*2\n\x1a",
    "size_one": b"Image type: Greyscale image\nImage size (x*y): 5\n\x1a",
    "size_word": b"Image type: Greyscale image\nImage size (x*y): 5*three\n\x1a",
    "size_empty": b"Image type: Greyscale image\nImage size (x*y):\n\x1a",
    "size_zero": b"Image type: Greyscale image\nImage size (x*y): 0*3\n\x1a",
    "size_nan": b"Image type: Greyscale image\nImage size (x*y): nan*3\n\x1a",
    "size_underscore": b"Image type: Greyscale image\nImage size (x*y): 0_5 * +3\n\x1a",
    "scale_word": b"Image type: Greyscale image\nScale (x,y): big\n\x1a",
    "frames_float": b"Image type: Greyscale image\nImage size (x*y): 5*3\n"
                    b"File size (no of images): 1e0\n\x1a",
    "type_empty": b"Image type:\nImage size (x*y): 5*3\n\x1a",
    "type_trailing_space": b"Image type: RGB image \nImage size (x*y): 5*3\n\x1a",
    "type_mode_l": b"Image type: L\nImage size (x*y): 5*3\n\x1a",
    "type_mode_p": b"Image type: P\nImage size (x*y): 5*3\n\x1a",
    "type_mode_rgbx": b"Image type: X 24 image\nImage type: RGBX\nImage size (x*y): 5*3\n\x1a",
    "type_mode_lab": b"Image type: LAB\nImage size (x*y): 5*3\n\x1a",
    "type_unknown": b"Image type: HSV\nImage size (x*y): 5*3\n\x1a",
    "type_bogus": b"Image type: sepia\nImage size (x*y): 5*3\n\x1a",
    "two_types": b"Image type: RGB image\nImage type: Greyscale image\nImage size (x*y): 5*3\n\x1a",
    "latin1": b"Image type: Greyscale image\nName: caf\xe9\nImage size (x*y): 5*3\n\x1a",
}


@pytest.mark.parametrize("case", sorted(IM_HEADERS))
def test_im_header_rules_are_pils(tmp_path, case):
    """Each header rule: PIL reads the file, tries the next format (which
    here reads none: the port then refuses too), or fails its open or its
    load; the port follows it."""
    body = np.random.default_rng(len(case)).integers(0, 256, 4 * 512 * 512).astype(np.uint8)
    _check(tmp_path, IM_HEADERS[case] + body.tobytes())


@pytest.mark.parametrize("seed", range(4))
def test_drawn_im_headers_read_as_pil_reads_them(tmp_path, seed):
    """A seeded grammar of header lines: types of the table and PIL mode
    names, sizes PIL parses or refuses, other tags, junk lines, line ends,
    padding, tables of every kind; 150 files a seed."""
    r = np.random.default_rng(300 + seed)
    types = IM_TYPES + ["L", "P", "LAB", "RGB", "F", "foo", "", "RGBX", "PA", "1"]
    sizes = [b"3*4", b"5*2", b"0*3", b"-1*2", b"2.0*3", b"2*3*4", b"7", b"abc", b"", b"1e1*2",
             b"nan*2", b" 3 * 2", b"3,2", b"0x3*2", b"1_0*2", b"inf*1"]
    keys = [b"Image size (x*y)", b"File size (no of images)", b"Scale (x,y)", b"Name",
            b"Comment", b"Date", b"Foo", b"image type", b"Lut"]
    for _ in range(150):
        w, h = int(r.integers(1, 6)), int(r.integers(1, 6))
        lines = []
        for _ in range(r.integers(0, 5)):
            c = r.integers(0, 4)
            if c == 0:
                lines.append(b"Image type: " + types[r.integers(len(types))].encode())
            elif c == 1:
                lines.append(b"Image size (x*y): " + sizes[r.integers(len(sizes))])
            elif c == 2:
                lines.append(keys[r.integers(len(keys))] + b":" + b" " * int(r.integers(0, 3))
                             + sizes[r.integers(len(sizes))])
            else:
                lines.append(r.integers(32, 127, r.integers(0, 20)).astype(np.uint8).tobytes())
        if r.random() < .6:
            lines.insert(0, b"Image size (x*y): %d*%d" % (w, h))
        if r.random() < .3:
            lines.append(b"Lut: 1")
        eol = [b"\n", b"\r\n", b"\n\r"][r.integers(3)]
        head = eol.join(lines) + eol
        if r.random() < .3:
            head += bytes(int(r.integers(0, 40)))
        if r.random() < .1:
            head = head.replace(b"\n", b"", 1)
        table = b""
        if b"Lut" in head:
            table = [r.integers(0, 256, 768).astype(np.uint8).tobytes(), bytes(range(256)) * 3,
                     bytes(range(255, -1, -1)) * 3,
                     r.integers(0, 256, r.integers(0, 768)).astype(np.uint8).tobytes()
                     ][r.integers(4)]
        body = r.integers(0, 256, int(r.integers(0, 40 * w * h + 2))).astype(np.uint8).tobytes()
        _check(tmp_path, head + (b"\x1a" if r.random() < .9 else b"") + table + body)


def test_im_ycc_reads_every_chroma_pair_as_pil():
    """YCC image: PIL's YCbCr -> RGB tables (``jpeg2000.ycbcr_tables``) on
    every (Cb, Cr) pair, with drawn luma."""
    r = np.random.default_rng(17)
    cb, cr = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    planes = np.stack([r.integers(0, 256, (256, 256)).astype(np.uint8), cb, cr])
    data = rw.im_bytes(rw.im_rows(planes), "YCC image", (256, 256))
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(port_image.decode_image(data), want)


@pytest.mark.parametrize("bits", range(2, 32))
def test_im_bit_fields_read_as_pil_reads_them(tmp_path, bits):
    """``L*n image``, n not 8, 16 or 32: PIL's ``bit`` decoder, whose rows
    start on a byte but whose bit buffer keeps the bits a row leaves spare
    (OR-ed into the next row's first byte); drawn bytes, so spare bits are
    set."""
    r = np.random.default_rng(bits)
    for w, h in ((1, 7), (int(r.integers(2, 15)), int(r.integers(2, 7)))):
        stride = (w * bits + 7) // 8
        body = r.integers(0, 256, stride * h).astype(np.uint8).tobytes()
        got = _check(tmp_path, rw.im_bytes(body, f"L*{bits} image", (w, h)), "IM")
        assert got is not None


# ------------------------------------------------------------------ IM Tools

def test_drawn_imt_files_read_as_pil_and_jax(tmp_path):
    r = np.random.default_rng(40)
    for k in range(6):
        grey = r.integers(0, 256, (int(r.integers(1, 20)), int(r.integers(1, 30))))
        _check(tmp_path, rw.imt_bytes(grey, comment=bool(k % 2)), "IMT", jax=k < 2)


@pytest.mark.parametrize("seed", range(3))
def test_drawn_imt_headers_read_as_pil_reads_them(tmp_path, seed):
    """Key lines in any order, comments, unknown keys, widths PIL's ``int``
    refuses (its open fails), no ``pixel n8`` (PIL tries the next format),
    no ``\\x0c`` (PIL opens the file and cannot load it), junk first."""
    r = np.random.default_rng(400 + seed)
    for _ in range(120):
        w, h = int(r.integers(1, 6)), int(r.integers(1, 6))
        opts = [b"width %d" % w, b"height %d" % h, b"pixel n8", b"pixel n16", b"* comment",
                b"width x", b"width", b"foo bar", b"", b"height -2", b"width 0", b"Width 3"]
        lines = [opts[i] for i in r.integers(0, len(opts), r.integers(0, 6))]
        if r.random() < .6:
            lines = [b"width %d" % w, b"height %d" % h, b"pixel n8"] + lines
        r.shuffle(lines)
        data = (b"\n".join(lines) + (b"\n" if r.random() < .8 else b"")
                + (b"\x0c" if r.random() < .85 else b"")
                + r.integers(0, 256, int(r.integers(0, 2 * w * h + 2))).astype(np.uint8).tobytes())
        if r.random() < .2:
            data = r.integers(0, 256, r.integers(0, 30)).astype(np.uint8).tobytes() + data
        _check(tmp_path, data)


# ------------------------------------------------------------------ IPTC

def _jpeg(px, **kw):
    b = io.BytesIO()
    Image.fromarray(px).save(b, "JPEG", **kw)
    return b.getvalue()


@pytest.mark.parametrize("form", ["raw_grey", "raw_rgb", "raw_cmyk", "jpeg_grey", "jpeg_rgb",
                                  "jpeg_cmyk_band", "jpeg_band_other_size", "raw_long"])
def test_drawn_iptc_files_read_as_pil_and_jax(tmp_path, form):
    """Raw data (PIL reads it as a P5 file of the header's size) and JPEG
    data (opened as a file of its own, at its own size), grey or one band,
    every band number from 0 (the last band) up."""
    r = np.random.default_rng(len(form))
    w, h = int(r.integers(1, 40)), int(r.integers(1, 30))
    grey = pattern(h, w, len(form))[..., 1]
    banded = form in ("raw_rgb", "raw_cmyk", "jpeg_cmyk_band", "jpeg_band_other_size")
    for band in range(5 if banded else 1):
        chunk = int(r.integers(1, 200))
        if form == "raw_grey":
            data = rw.iptc_bytes(1, 0, (w, h), 1, grey.tobytes(), chunk=chunk)
        elif form == "raw_rgb":
            data = rw.iptc_bytes(3, 1, (w, h), 1, grey.tobytes(), band=band, chunk=chunk)
        elif form == "raw_cmyk":
            data = rw.iptc_bytes(4, 1, (w, h), 1, grey.tobytes(), band=band, chunk=chunk)
        elif form == "raw_long":
            data = rw.iptc_bytes(1, 0, (w, h), 1, grey.tobytes() + b"more", chunk=chunk)
        elif form == "jpeg_grey":
            data = rw.iptc_bytes(1, 0, (w, h), 5, _jpeg(grey), chunk=chunk)
        elif form == "jpeg_rgb":
            data = rw.iptc_bytes(1, 0, (w, h), 5, _jpeg(pattern(h, w, 3)), chunk=chunk)
        elif form == "jpeg_cmyk_band":
            data = rw.iptc_bytes(4, 1, (w, h), 5, _jpeg(grey), band=band, chunk=chunk)
        else:
            data = rw.iptc_bytes(3, 1, (w + 3, h + 1), 5, _jpeg(grey, quality=60), band=band)
        got = _check(tmp_path, data, "IPTC" if band < 4 or "cmyk" in form else None,
                     jax=band == int(banded))
        if band == 4 and "cmyk" not in form:
            assert got is None   # bands[3] of three: PIL's load fails


IPTC_REFUSED = {
    "illegal_length": b"\x1c\x02\x00\x90" + bytes(40),
    "unknown_compression": rw.iptc_bytes(1, 0, (3, 2), 2, bytes(6)),
    "no_compression": rw.iptc_field(3, 60, b"\1\0") + rw.iptc_field(3, 20, b"\3")
    + rw.iptc_field(3, 30, b"\2") + rw.iptc_field(8, 10, bytes(6)),
    "no_data": rw.iptc_bytes(1, 0, (3, 2), 1, b"")[:-5],
    "raw_short": rw.iptc_bytes(1, 0, (3, 2), 1, bytes(5)),
    "junk_after_data": rw.iptc_bytes(1, 0, (3, 2), 1, bytes(6), tail=b"abcde"),
    "long_field_after_data": rw.iptc_bytes(1, 0, (3, 2), 1, bytes(6), tail=b"\x1c\2\0\x99\0"),
    "colour_jpeg_band": rw.iptc_bytes(3, 1, (8, 8), 5, _jpeg(pattern(8, 8, 1)), band=2),
    "band_past_cmyk": rw.iptc_bytes(4, 1, (3, 2), 1, bytes(6), band=6),
}


@pytest.mark.parametrize("case", sorted(IPTC_REFUSED))
def test_iptc_forms_pil_refuses_are_refused(tmp_path, case):
    """PIL's open fails (a length byte above 132, a compression other than
    1 or 5), or its load does (no data, data short of the image, a broken
    field after the data, a band PIL cannot merge)."""
    assert _check(tmp_path, IPTC_REFUSED[case], False) is None
    with pytest.raises(ValueError, match="IPTC|unsupported image format"):
        port_image.decode_image(IPTC_REFUSED[case], "x.iim")


def test_iptc_extended_lengths_as_pil_reads_them(tmp_path):
    """An extended length as PIL reads it (128 + k, a byte it skips, k
    bytes of length), and the standard form (0x80, k), which PIL reads as
    an empty field, so the length bytes read as the next field's header."""
    grey = pattern(5, 7, 2)[..., 0].tobytes()
    for k in (1, 2, 3, 4):
        data = rw.iptc_bytes(1, 0, (7, 5), 1, b"", tail=rw.iptc_field(8, 10, grey, extended=k))
        _check(tmp_path, data, "IPTC")
    standard = rw.iptc_bytes(1, 0, (7, 5), 1, b"", extra=[
        b"\x1c\x02\x78\x80\x02" + struct.pack(">H", 3) + b"abc"], tail=rw.iptc_field(8, 10, grey))
    _check(tmp_path, standard)


@pytest.mark.parametrize("seed", range(4))
def test_drawn_iptc_field_soups_read_as_pil_reads_them(tmp_path, seed):
    """Fields in any order, repeated, empty, cut; records PIL refuses; the
    file cut anywhere; 150 files a seed."""
    r = np.random.default_rng(500 + seed)
    for _ in range(150):
        w, h = int(r.integers(1, 6)), int(r.integers(1, 6))
        pool = [lambda: rw.iptc_field(3, 60, bytes([int(r.choice([1, 3, 4, 2])),
                                                    int(r.integers(0, 2))])),
                lambda: rw.iptc_field(3, 60, b"\1"),
                lambda: rw.iptc_field(3, 20, struct.pack(">H", w)),
                lambda: rw.iptc_field(3, 30, struct.pack(">H", h)),
                lambda: rw.iptc_field(3, 20, b""),
                lambda: rw.iptc_field(3, 120, bytes([int(r.choice([1, 5, 2]))])),
                lambda: rw.iptc_field(3, 65, bytes([int(r.integers(0, 6))])),
                lambda: rw.iptc_field(2, 5, b"title"),
                lambda: rw.iptc_field(3, 20, struct.pack(">I", w), extended=int(r.integers(1, 5))),
                lambda: bytes([0x1C, int(r.integers(0, 256)), 0, int(r.integers(0, 256)), 0])]
        fields = [pool[0](), pool[2](), pool[3](), rw.iptc_field(3, 120, b"\1")]
        for _ in range(r.integers(0, 4)):
            fields.insert(int(r.integers(0, len(fields) + 1)), pool[int(r.integers(len(pool)))]())
        if r.random() < .3:
            fields = fields[:int(r.integers(0, len(fields)))]
        blob = r.integers(0, 256, int(r.integers(0, 3 * w * h))).astype(np.uint8).tobytes()
        data = b"".join(fields) + b"".join(rw.iptc_field(8, 10, blob[i:i + 7])
                                           for i in range(0, len(blob), 7))
        data += [b"", bytes(5), b"xx", b"\x1c\x08\x0a\0\0", b"\x1c\2\0\x90\0", b"\x1c\2"
                 ][r.integers(6)]
        if r.random() < .2:
            data = data[:int(r.integers(0, len(data) + 1))]
        _check(tmp_path, data)


# ------------------------------------------------------------------ no PIL

def test_im_imt_iptc_decoders_need_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('im_pil_rgb_13x9.im', 'im_bit12_13x9.im', 'imt_grey_13x9.imt',\n"
            "          'iptc_jpeg_rgb_13x9.iim', 'iptc_raw_cmyk_band4_13x9.iim'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:6] == ["(9, 13, 3)"] * 5 + ["[]"]
