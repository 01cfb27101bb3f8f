"""Port parity: the PIL-free TIFF decoder (akari_torch/core/tiff.py with
akari_torch/native/tiff_lzw.cpp) against PIL 12.1 and the libtiff 4.7.1 it
calls for compressed files, through which the JAX package's ``read_image``
reads TIFF textures.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")`` of
the file read from its path, and ``read_image`` of both packages gives the
same float32 array bit for bit with ``to_linear`` True and False:

- the TIFF fixtures of ``tests/data/torch_port_images`` (Pillow's libtiff
  writer and the tool's ``tiff_bytes``; ``digests.json`` holds PIL's decode
  of each, which ``chip_smoke.py`` checks on a machine without PIL);
- seeded drawn files of every pixel form (bilevel, grey at 1-32 bits,
  integer and float, grey + alpha, palettes, RGB(A) at 8 and 16 bits with
  unassociated and associated alpha, CMYK, YCbCr) in both byte orders,
  raw, LZW, Deflate and PackBits, in one strip, in several, in tiles and in
  planes, with horizontal and floating-point prediction, BigTIFF and fill
  order 2 drawn in, and each with a drawn orientation;
- orientations 1-8 on every decoding route;
- libtiff's readings: missing RowsPerStrip and StripByteCounts, the old
  bit-reversed LZW codes, LZW and Deflate strips that hold more or less
  than the strip, the header forms PIL opens only uncompressed;
- JPEG-compressed TIFFs: Pillow's writer, and subsampled YCbCr strips and
  tiles with and without a JPEGTables tag;
- LZMA and ZSTD TIFFs: Pillow's writer, and ``tiff_bytes`` strips, tiles and
  planes with each predictor, the ZSTD frames written by the ``zstandard``
  package (a test dependency) holding between them every block type,
  literals mode and sequence table mode, and the frame forms libtiff reads
  or refuses (a second frame, a skippable frame, checksums, dictionary
  ids, reserved bits, windows);
- Pillow's own writer in every mode and compression it writes;
- seeded corruptions of the fixtures: wherever PIL reads the file the port
  gives its pixels, wherever PIL refuses it the port raises ValueError.
  JPEG strips read on over corrupt entropy-coded data as libjpeg does (as
  ``core/jpeg.py`` does for JPEG files), and a strip whose data ends early
  reads as libtiff's fake EOI marker leaves it;
  YCbCr strips that are not JPEG are left out, because libtiff's RGBA
  reader, which PIL uses for them, goes on from stale memory over a strip
  that fails to decode; on corrupt LZMA and ZSTD strips the port refuses
  two kinds PIL reads, naming them (see ROADMAP.md's divergences);
- every refused form raises ValueError naming it;
- an OBJ whose ``map_Kd`` is a TIFF renders at 16x16 on the CPU bit-equal
  to the same OBJ on a PNG of the same pixels.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core import tiff as port_tiff
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import (
    cmyk_jpegs,
    fax_fixtures,
    lab_pnm_dib_icns_fixtures,
    pattern,
    tiff_bytes,
    tiff_fixtures,
    tiff_jpeg_blocks,
    tiff_lzw,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")


def _pil_path(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


def _same_read(path):
    """Both packages' read_image, linear and not: bit-equal."""
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _outcome(tmp_path, data, name="t.tif"):
    """(PIL's pixels or None, the port's pixels or None) of ``data`` read
    from a file, as read_image reads it; the port may raise ValueError only."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        want = _pil_path(str(path))
    except Exception:
        want = None
    try:
        got = port_image.decode_image(data, name)
    except ValueError:
        got = None
    return want, got


def _check(tmp_path, data, name="t.tif", pil_reads=True):
    """The port gives PIL's pixels, or raises where PIL raises."""
    want, got = _outcome(tmp_path, data, name)
    if pil_reads:
        assert want is not None, f"{name}: PIL refuses the file"
    if want is None:
        assert got is None, f"{name}: PIL refuses the file, the port reads it"
        return None
    assert got is not None, f"{name}: PIL reads the file, the port refuses it"
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


# ------------------------------------ fixtures -----------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items()
                if k.endswith(".tif") or k.startswith(("cmyk", "ycck"))}


FIXTURE_NAMES = sorted(_digests())


def test_tiff_fixtures_are_the_tools_and_pils():
    """The tool's encoders still write the committed TIFF (CCITT,
    ThunderScan and old-style JPEG included) and CMYK JPEG fixtures, and
    digests.json holds PIL's decode of every one."""
    import PIL

    digests = _digests()
    assert len(digests) >= 17
    written = {**tiff_fixtures(np.random.default_rng(12)), **cmyk_jpegs(),
               **{k: v for k, v in {**fax_fixtures(), **lab_pnm_dib_icns_fixtures()}.items()
                  if k.endswith(".tif") and not k.startswith("tiff_pil")}}
    for name, rec in digests.items():
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        if not name.startswith("tiff_pil"):
            assert written[name] == data, name
        px = _pil_path(path)
        assert list(px.shape) == rec["shape"], name
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name
        assert rec["pil"] == PIL.__version__
    assert sorted(written) == sorted(n for n in digests if not n.startswith("tiff_pil"))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ------------------------------------ drawn forms --------------------------------

# name: (bits, samples a pixel, photometric, sample format, extra samples)
FORMS = {
    "bilevel": (1, 1, 1, None, None), "bilevel-min-is-white": (1, 1, 0, None, None),
    "grey2": (2, 1, 1, None, None), "grey2-min-is-white": (2, 1, 0, None, None),
    "grey4": (4, 1, 1, None, None), "grey4-min-is-white": (4, 1, 0, None, None),
    "grey8": (8, 1, 1, None, None), "grey8-min-is-white": (8, 1, 0, None, None),
    "grey8-signed": (8, 1, 1, 2, None), "grey12": (12, 1, 1, None, None),
    "grey16": (16, 1, 1, None, None), "grey16-min-is-white": (16, 1, 0, None, None),
    "grey16-signed": (16, 1, 1, 2, None), "grey32": (32, 1, 1, None, None),
    "grey32-signed": (32, 1, 1, 2, None), "float32": (32, 1, 1, 3, None),
    "float32-min-is-white": (32, 1, 0, 3, None),
    "grey-alpha": (8, 2, 1, None, (2,)),
    "palette1": (1, 1, 3, None, None), "palette2": (2, 1, 3, None, None),
    "palette4": (4, 1, 3, None, None), "palette8": (8, 1, 3, None, None),
    "palette-extra": (8, 2, 3, None, (0,)), "palette-alpha": (8, 2, 3, None, (2,)),
    "rgb8": (8, 3, 2, None, None), "rgba8-no-extra-tag": (8, 4, 2, None, None),
    "rgbx8": (8, 4, 2, None, (0,)), "rgbxx8": (8, 5, 2, None, (0, 0)),
    "rgbxxx8": (8, 6, 2, None, (0, 0, 0)),
    "rgba8-associated": (8, 4, 2, None, (1,)), "rgba8-associated-x": (8, 5, 2, None, (1, 0)),
    "rgba8-unassociated": (8, 4, 2, None, (2,)), "rgba8-unassociated-x": (8, 5, 2, None, (2, 0)),
    "rgba8-corel": (8, 4, 2, None, (999,)),
    "rgb16": (16, 3, 2, None, None), "rgba16": (16, 4, 2, None, (2,)),
    "rgbx16": (16, 4, 2, None, (0,)), "rgba16-associated": (16, 4, 2, None, (1,)),
    "cmyk8": (8, 4, 5, None, None), "cmykx8": (8, 5, 5, None, (0,)),
    "cmyk16": (16, 4, 5, None, None), "ycbcr": (8, 3, 6, None, None),
}
# forms PIL refuses in some layouts (then the port must refuse too)
SOMETIMES_REFUSED = {"grey12", "grey32", "grey16-min-is-white", "grey8-signed",
                     "rgbx8", "rgbxx8", "rgbxxx8", "rgba8-associated", "rgba8-associated-x",
                     "rgba8-unassociated-x", "rgbx16", "cmykx8", "palette-extra",
                     "palette-alpha", "grey-alpha", "ycbcr", "float32-min-is-white",
                     "rgba16-associated"}


II_ONLY = {"grey12", "grey32", "grey16-min-is-white"}


def _samples(r, bits, spp, fmt, h, w):
    if fmt == 3:
        v = r.normal(100, 120, (h, w, spp)).astype(np.float32)
        v.flat[:3] = [np.nan, np.inf, 254.99]
        return v
    if fmt == 2:
        return r.integers(-300, 300, (h, w, spp)) & ((1 << bits) - 1)
    v = r.integers(0, 1 << bits, (h, w, spp))
    if bits >= 16:  # small values too, under the 255 clip of the grey forms
        v = np.where(r.random((h, w, spp)) < 0.5, v & 511, v)
    if spp >= 4 and bits == 8:  # alpha 0 and 255, where PIL's un-premultiplying branches
        v[..., 3] = np.where(r.random((h, w)) < 0.3, r.choice([0, 255], (h, w)), v[..., 3])
    return v


def _drawn(r, form, order, compression, layout, predictor):
    bits, spp, photo, fmt, extra = FORMS[form]
    h, w = int(r.integers(1, 26)), int(r.integers(1, 26))
    kw = dict(order=order, compression=compression, predictor=predictor, sample_format=fmt,
              extra=extra, seed=int(r.integers(1 << 30)))
    if photo == 3:
        kw["colormap"] = r.integers(0, 65536, 3 * (1 << bits)).tolist()
    if photo == 6:  # 1x1 samples; a drawn subsampling is written as it says
        kw["ycbcr"] = [(1, 1), (2, 2), (2, 1), (4, 2)][int(r.integers(4))]
    if layout == "strips":
        kw["rows_per_strip"] = int(r.integers(1, 6))
    elif layout == "tiles":
        kw["tile"] = (16, 16) if r.random() < 0.7 else (32, 16)
    elif layout == "planes":
        kw.update(planar=2, rows_per_strip=int(r.integers(2, 9)))
    if r.random() < 0.5:
        kw["orientation"] = int(r.integers(1, 9))
    if order == "<" and r.random() < 0.2:
        kw["bigtiff"] = True
    return tiff_bytes(_samples(r, bits, spp, fmt, h, w), bits, photo, **kw)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("form", list(FORMS))
def test_drawn_tiff_matches_pil(tmp_path, form, order):
    """Raw, LZW, Deflate and PackBits; one strip, strips, tiles, planes;
    predictors 2 (8, 16, 32 bits) and 3 (float) under LZW and Deflate."""
    bits, spp, photo, fmt, _ = FORMS[form]
    r = np.random.default_rng(zlib.crc32(f"{form}{order}".encode()))
    layouts = ["strip", "strips", "tiles"] + (["planes"] if spp > 1 else [])
    read = 0
    for compression in (1, 5, 8, 32773):
        for layout in layouts:
            predictors = [1]
            if compression in (5, 8) and photo != 6:
                predictors += [3] if fmt == 3 else [2] if bits in (8, 16, 32) else []
            for predictor in predictors:
                data = _drawn(r, form, order, compression, layout, predictor)
                name = f"{compression}-{layout}-{predictor}.tif"
                got = _check(tmp_path, data, name, pil_reads=form not in SOMETIMES_REFUSED
                             and not (layout == "planes" and compression != 1 and spp > 1
                                      and photo not in (2, 5)))
                read += got is not None
    if order == ">" and form in II_ONLY:
        assert read == 0  # PIL's OPEN_INFO holds these for little-endian files only
    else:
        assert read >= len(layouts), "too few files of this form read"
    path = tmp_path / "same.tif"
    path.write_bytes(_drawn(r, form, order, 5, "strips", 1))
    if _outcome(tmp_path, path.read_bytes())[0] is not None:
        _same_read(str(path))


def test_16bit_rgb_keeps_the_high_byte_and_grey_clips_at_255(tmp_path):
    v = np.array([[[0x1234, 0xABCD, 0x00FF]]])
    got = _check(tmp_path, tiff_bytes(v, 16, 2, compression=8, predictor=2))
    assert got[0, 0].tolist() == [0x12, 0xAB, 0x00]
    grey = np.array([[[3], [255], [256], [65535]]])
    assert _check(tmp_path, tiff_bytes(grey, 16, 1, order=">"))[0, :, 0].tolist() == [
        3, 255, 255, 255]


def test_associated_alpha_is_unpremultiplied_as_pil_does(tmp_path):
    px = np.array([[[50, 100, 200, 0], [50, 100, 200, 100], [50, 100, 200, 255],
                    [90, 30, 10, 60]]])
    for planar, compression in ((1, 1), (1, 5), (2, 5)):
        got = _check(tmp_path, tiff_bytes(px, 8, 2, extra=(1,), planar=planar,
                                          compression=compression))
        assert got[0, :3].tolist() == [[0, 0, 0], [127, 255, 255], [50, 100, 200]]


# ----------------------------------- orientations --------------------------------

def _routes(r, o):
    """One file per decoding route, each with orientation ``o``."""
    px = pattern(9, 14, int(r.integers(100)))
    blocks, tables = tiff_jpeg_blocks(px, rows=8)
    return {
        "raw-mapped": tiff_bytes(px[..., :1], 8, 1, orientation=o),
        "raw-strips": tiff_bytes(px, 8, 2, rows_per_strip=4, orientation=o),
        "raw-tiles": tiff_bytes(px, 8, 2, order=">", tile=(16, 16), orientation=o),
        "lzw-pred2": tiff_bytes(px, 8, 2, compression=5, predictor=2, orientation=o),
        "packbits-planes": tiff_bytes(px, 8, 2, compression=32773, planar=2, orientation=o),
        "ycbcr-rgba": tiff_bytes(px, 8, 6, compression=8, ycbcr=(2, 1), orientation=o),
        "jpeg": tiff_bytes(np.zeros_like(px), 8, 6, compression=7, rows_per_strip=8,
                           blocks=blocks, tags={347: (7, tables), 530: (3, [2, 2])},
                           orientation=o),
    }


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientations_on_every_route_match_pil(tmp_path, orientation):
    """PIL swaps the size for orientations 5-8 (a single raw strip is even
    mapped from the file at the swapped size) and transposes last."""
    r = np.random.default_rng(orientation)
    for route, data in _routes(r, orientation).items():
        _check(tmp_path, data, f"{route}.tif")


# ---------------------------------- libtiff's readings ---------------------------

def _tiff_headers():
    px = pattern(7, 6, 3)
    out = {}
    for compression in (1, 5):
        out[f"bigtiff-{compression}"] = (tiff_bytes(px, 8, 2, bigtiff=True,
                                                    compression=compression), True)
        # PIL opens these "invalid" headers as classic TIFF; libtiff refuses
        # them, so only the uncompressed ones read
        for head, order in ((b"MM\x2a\x00", ">"), (b"II\x00\x2a", "<")):
            out[f"{head[:2].decode()}-swapped-{compression}"] = (tiff_bytes(
                px, 8, 2, order=order, header=head, compression=compression), compression == 1)
    return out


@pytest.mark.parametrize("case", list(_tiff_headers()))
def test_header_forms_read_as_pil_reads_them(tmp_path, case):
    data, reads = _tiff_headers()[case]
    assert port_image.image_format(data) == "TIFF"
    got = _check(tmp_path, data, pil_reads=reads)
    assert (got is not None) == reads


def test_missing_strip_tags_follow_libtiff(tmp_path):
    """No RowsPerStrip: one strip; no StripByteCounts or a zero count: one
    strip's estimated, several strips refused (uncompressed, PIL's own
    decoder needs neither)."""
    px = pattern(13, 11, 4)
    for compression in (1, 5, 8, 32773):
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, omit=(278,)))
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, omit=(279,)))
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, tags={279: (4, [0])}))
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, rows_per_strip=4,
                                    omit=(279,)), pil_reads=compression == 1)
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, rows_per_strip=4,
                                    omit=(278,)), pil_reads=False)
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=compression, tile=(16, 16),
                                    omit=(325,)))


def test_lzw_old_codes_and_strips_of_other_lengths(tmp_path):
    """The old bit-reversed LZW codes (libtiff decides by the first strip it
    decodes), long strings across table resets, strips holding more than
    the strip (read) and less (refused), and codes not yet in the table."""
    r = np.random.default_rng(7)
    px = r.integers(0, 4, (40, 50, 3))
    raw = px.astype(np.uint8).tobytes()
    for compat in (False, True):
        for predictor in (1, 2):
            _check(tmp_path, tiff_bytes(px, 8, 2, compression=5, compat=compat,
                                        predictor=predictor, rows_per_strip=7))
    half = px.shape[0] // 2
    top, bottom = px[:half].astype(np.uint8).tobytes(), px[half:].astype(np.uint8).tobytes()
    for first in (False, True):  # a file mixing the forms is refused either way
        blocks = [tiff_lzw(top, first), tiff_lzw(bottom, not first)]
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=5, rows_per_strip=half,
                                    blocks=blocks), pil_reads=False)
    for codec, compress in ((5, tiff_lzw), (8, zlib.compress)):
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=codec, blocks=[compress(raw + bytes(9))]))
        _check(tmp_path, tiff_bytes(px, 8, 2, compression=codec, blocks=[compress(raw[:-9])]),
               pil_reads=False)
    bits = np.unpackbits(np.frombuffer(tiff_lzw(raw), np.uint8))[9:]  # no opening clear code
    _check(tmp_path, tiff_bytes(px, 8, 2, compression=5, blocks=[np.packbits(bits).tobytes()]),
           pil_reads=False)


def test_lzw_decoder_grows_codes_one_early_and_fills_the_table(tmp_path):
    """A long run of distinct strings: the codes grow to 12 bits and the
    table resets; one decode checked byte for byte against the source."""
    r = np.random.default_rng(8)
    data = r.integers(0, 256, 60_000).astype(np.uint8).tobytes() + bytes(20_000)
    out = port_tiff._lzw(tiff_lzw(data), len(data), False, "t")
    assert out.tobytes() == data
    out = port_tiff._lzw(tiff_lzw(data, compat=True), len(data), True, "t")
    assert out.tobytes() == data


def test_fill_order_2_and_ycbcr_conversion(tmp_path):
    r = np.random.default_rng(9)
    for compression in (5, 8, 32773):
        _check(tmp_path, tiff_bytes(r.integers(0, 256, (6, 9, 3)), 8, 2, fill=2,
                                    compression=compression))
        _check(tmp_path, tiff_bytes(r.integers(0, 2, (6, 19, 1)), 1, 0, fill=2,
                                    compression=compression))
    ycc = r.integers(0, 256, (10, 12, 3))
    for sub in ((1, 1), (2, 2), (2, 1), (1, 2), (4, 2), (4, 1)):
        for layout in ({"rows_per_strip": 4}, {"tile": (16, 16)}):
            _check(tmp_path, tiff_bytes(ycc, 8, 6, compression=5, ycbcr=sub, **layout))
    # the reference black and white and luma coefficients enter the tables
    _check(tmp_path, tiff_bytes(ycc, 8, 6, compression=8, ycbcr=(1, 1), tags={
        532: (5, [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
        529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}))


# -------------------------------------- JPEG -------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCbCr"])
def test_pils_jpeg_tiffs_match(tmp_path, mode):
    for (h, w), quality in (((16, 16), 90), ((37, 29), 60), ((70, 45), 30)):
        path = tmp_path / "j.tif"
        Image.fromarray(pattern(h, w, quality)).convert(mode).save(
            path, "TIFF", compression="jpeg", quality=quality, strip_size=2000)
        _check(tmp_path, path.read_bytes())


@pytest.mark.parametrize("tables", [True, False], ids=["jpegtables", "whole-streams"])
@pytest.mark.parametrize("sub", [2, 1, 0], ids=["420", "422", "444"])
def test_subsampled_ycbcr_jpeg_strips_and_tiles_match_pil(tmp_path, sub, tables):
    r = np.random.default_rng(sub * 2 + tables)
    sampling = {2: (2, 2), 1: (2, 1), 0: (1, 1)}[sub]
    for layout in ("strips", "tiles"):
        h, w = int(r.integers(5, 50)), int(r.integers(5, 50))
        px = pattern(h, w, int(r.integers(100)))
        if layout == "tiles":
            blocks, jt = tiff_jpeg_blocks(px, tile=(16, 16), subsampling=sub, tables=tables)
            kw = {"tile": (16, 16)}
        else:
            blocks, jt = tiff_jpeg_blocks(px, rows=16, subsampling=sub, tables=tables)
            kw = {"rows_per_strip": 16}
        tags = {530: (3, list(sampling))}
        if jt:
            tags[347] = (7, jt)
        _check(tmp_path, tiff_bytes(np.zeros((h, w, 3), int), 8, 6, compression=7,
                                    blocks=blocks, tags=tags, order="<>"[sub % 2], **kw))
    # libtiff's checks: the first component sampled as the tag says, a strip
    # no wider than the image (a narrower one leaves libtiff's buffer
    # unwritten, which the port refuses)
    blocks, jt = tiff_jpeg_blocks(pattern(16, 16, 1), rows=16, subsampling=sub)
    for tags, reads in (({530: (3, [4, 4]), 347: (7, jt)}, False),
                        ({530: (3, [1, 1]), 347: (7, jt)}, sub == 0),
                        ({530: (3, list(sampling)), 347: (7, jt), 256: (4, [15])}, False)):
        _check(tmp_path, tiff_bytes(np.zeros((16, 16, 3), int), 8, 6, compression=7,
                                    blocks=blocks, tags=tags), pil_reads=reads)


# -------------------------------- Pillow's own writer ----------------------------

@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                                         "zstd", "lzma"])
def test_pils_writer_in_every_mode_matches(tmp_path, compression):
    px = pattern(17, 13, 5)
    ims = {"1": Image.fromarray(px).convert("1"), "L": Image.fromarray(px).convert("L"),
           "LA": Image.fromarray(px).convert("LA"), "P": Image.fromarray(px).convert("P"),
           "PA": Image.fromarray(px).convert("PA"), "RGB": Image.fromarray(px),
           "RGBA": Image.fromarray(px).convert("RGBA"), "CMYK": Image.fromarray(px).convert("CMYK"),
           "YCbCr": Image.fromarray(px).convert("YCbCr"),
           "I;16": Image.fromarray((px[..., 0].astype(np.uint16) * 3)),
           "I": Image.fromarray(px[..., 0].astype(np.int32) * 7 - 400),
           "F": Image.fromarray(px[..., 0].astype(np.float32) * 1.7 - 40)}
    for mode, im in ims.items():
        path = tmp_path / f"{mode}.tif"
        kw = {"tiffinfo": {317: 2}} if compression in ("tiff_lzw", "tiff_adobe_deflate", "zstd",
                                                       "lzma") \
            and mode in ("L", "RGB", "RGBA", "CMYK", "I;16") else {}
        im.save(path, "TIFF", compression=compression, **kw)
        # PIL reads uncompressed YCbCr with its 4-byte RGBX raw mode and
        # finds its own file truncated; the port refuses it too
        _check(tmp_path, path.read_bytes(), f"{mode}.tif",
               pil_reads=not (mode == "YCbCr" and compression == "raw"))
    im = ims["RGB"]
    im.save(tmp_path / "big.tif", "TIFF", big_tiff=True)
    _check(tmp_path, (tmp_path / "big.tif").read_bytes())


# ---------------------------------- LZMA and ZSTD --------------------------------

def _dot_tiff_names():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return sorted(k for k in json.load(f) if k.endswith(".tiff"))


@pytest.mark.parametrize("name", _dot_tiff_names())
def test_lzma_zstd_fixtures_decode_to_their_digests_and_read_as_jax(name):
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        rec = json.load(f)[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [34925, 50000], ids=["lzma", "zstd"])
def test_drawn_lzma_zstd_tiffs_match_pil(tmp_path, compression, order):
    """Strips, tiles and planes, no predictor, horizontal (8 and 16 bits) and
    floating-point prediction; the ZSTD frames drawn with and without a
    checksum and a content size (``tiff_bytes``'s seed)."""
    r = np.random.default_rng(compression + (order == ">"))
    for seed in range(4):
        rgb = pattern(int(r.integers(3, 40)), int(r.integers(3, 40)), seed)
        layout = [{"rows_per_strip": int(r.integers(1, 9))}, {"tile": (16, 16)},
                  {"planar": 2, "rows_per_strip": 5}, {}][seed]
        for predictor in (1, 2):
            _check(tmp_path, tiff_bytes(rgb, 8, 2, order=order, compression=compression,
                                        predictor=predictor, seed=seed, **layout))
        _check(tmp_path, tiff_bytes(r.integers(0, 65536, (9, 7, 3)), 16, 2, order=order,
                                    compression=compression, predictor=2, seed=seed, **layout))
        f = r.normal(0, 50, (7, 9, 1)).astype(np.float32)
        _check(tmp_path, tiff_bytes(f, 32, 1, order=order, compression=compression, predictor=3,
                                    sample_format=3, seed=seed))


def _one_strip(payload, frame):
    """A one-strip 8-bit grey TIFF of ``payload``'s bytes, its strip ``frame``."""
    return tiff_bytes(np.frombuffer(payload, np.uint8).reshape(1, -1, 1).astype(int), 8, 1,
                      compression=50000, blocks=[frame])


def _zstd_payloads():
    """Data whose Zstandard frames hold, between them, every block type,
    literals mode and sequence table mode (``zstd_modes``)."""
    r = np.random.default_rng(9)
    words = [bytes(r.integers(97, 123, r.integers(2, 9), dtype=np.uint8)) for _ in range(300)]
    text = b" ".join(words[i] for i in r.integers(0, 300, 40000))
    noise = r.integers(0, 256, 131072, dtype=np.uint8).tobytes()
    freq = np.array([40, 20, 10, 5, 5, 4, 3, 3, 2, 2, 2, 1, 1, 1, 1]) / 100
    return {  # name: (payload, compression levels)
        "noise": (noise[:5000], (3,)),
        "constant": (bytes([7]) * 140000, (3,)),
        "short-text": ((b"the quick brown fox jumps over the lazy dog " * 40)[:1700], (3, 19)),
        "few-symbols": (bytes(r.choice(np.arange(1, 16), 3000, p=freq).astype(np.uint8)), (1,)),
        "small-literals": (bytes(r.integers(0, 4, 200, dtype=np.uint8)) * 3, (3, -5)),
        "no-matches": (bytes(r.choice(np.arange(97, 113), 600).astype(np.uint8)), (1, 19)),
        "rle-literals": (noise + b"".join(noise[i * 60:(i + 1) * 60] + b"\xaa"
                                          for i in range(200)), (1, 3)),
        "treeless": (text[:131072] + b"".join(text[i * 300:i * 300 + 40] + bytes([text[i * 7 + 1]])
                                              for i in range(150)), (1, 3)),
        "mixed": (bytes(np.concatenate([r.integers(0, 256, 1000, dtype=np.uint8),
                                        np.tile(r.integers(0, 50, 300, dtype=np.uint8), 400)])),
                  (9,)),
        "seq-rle": (b"".join(bytes([i % 256]) + b"abcdefgh" for i in range(400)), (1,)),
    }


def test_zstd_frames_of_every_mode_match_pil(tmp_path):
    import zstandard

    from tools.legacy_writers import zstd_modes

    held = set()
    for name, (payload, levels) in _zstd_payloads().items():
        for level, checksum in ((v, c) for v in levels for c in (False, True)):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=checksum).compress(payload)
            held |= zstd_modes(frame)
            got = _check(tmp_path, _one_strip(payload, frame), f"{name}.tif")
            assert got[0, :, 0].tobytes() == payload
    every = {"block:raw", "block:rle", "block:compressed", "lit:raw", "lit:rle", "lit:huf1",
             "lit:huf4", "lit:treeless1", "lit:treeless4", "weights:direct", "weights:fse",
             "seq:none", "checksum", "content_size"}
    every |= {f"{t}:{m}" for t in ("ll", "of", "ml") for m in ("predefined", "rle", "fse",
                                                               "repeat")}
    assert held >= every, sorted(every - held)


def test_zstd_frame_forms_read_or_refused_as_libtiff_does(tmp_path):
    """libtiff decodes a strip's first frame only: a frame that ends short
    of the strip is "not enough data" even with a second frame after it, a
    skippable frame first leaves the strip empty; a wrong checksum or
    content size, a dictionary id, a reserved header bit or a window over
    128 MiB is refused; a frame longer than the strip, or bytes after it,
    are not."""
    import zstandard

    payload = pattern(16, 40, 3).tobytes()[:1500]
    plain = zstandard.ZstdCompressor(level=5).compress(payload)
    summed = zstandard.ZstdCompressor(level=5, write_checksum=True,
                                      write_content_size=True).compress(payload)
    half = zstandard.ZstdCompressor(level=5).compress(payload[:700])
    rest = zstandard.ZstdCompressor(level=5).compress(payload[700:])
    skip = b"\x50\x2a\x4d\x18" + struct.pack("<I", 3) + b"abc"
    bad_sum = summed[:-1] + bytes([summed[-1] ^ 1])
    dict_id = zstandard.ZstdCompressor(level=5, dict_data=zstandard.ZstdCompressionDict(
        payload[:400], dict_type=zstandard.DICT_TYPE_RAWCONTENT)).compress(payload)
    reserved = plain[:4] + bytes([plain[4] | 8]) + plain[5:]
    huge_window = plain[:5] + bytes([(18 << 3)]) + plain[6:]
    cases = {
        "plain": (plain, True), "checksum": (summed, True), "two-frames": (half + rest, False),
        "skippable-first": (skip + plain, False), "frame-then-junk": (plain + b"junk", True),
        "bad-checksum": (bad_sum, False), "dictionary": (dict_id, False),
        "reserved-bit": (reserved, False), "window-256MiB": (huge_window, False),
        "cut": (plain[:-5], False),
        "longer-than-strip": (zstandard.ZstdCompressor(level=5).compress(payload + b"x" * 99),
                              True),
    }
    for name, (frame, reads) in cases.items():
        want, got = _outcome(tmp_path, _one_strip(payload, frame), f"{name}.tif")
        assert (want is not None) == reads, name
        assert (got is not None) == reads, name
        if reads:
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="TIFF ZSTD data ends early"):
        port_image.decode_image(_one_strip(payload, half + rest))


def _lzma_zstd_corruption_bases():
    bases = {}
    for comp in ("zstd", "lzma"):
        for predictor in (1, 2):
            buf = io.BytesIO()
            Image.fromarray(pattern(40, 37, 5)).save(buf, "TIFF", compression=comp,
                                                     tiffinfo={317: predictor})
            bases[f"{comp}-{predictor}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(np.repeat(np.arange(64, dtype=np.uint8)[None], 48, 0)).convert("RGB").save(
        buf, "TIFF", compression="zstd")
    bases["zstd-ramp"] = buf.getvalue()
    return bases


@pytest.mark.parametrize("seed", range(3))
def test_corrupted_lzma_zstd_tiffs_read_as_pil_or_are_refused(tmp_path, seed):
    """Wherever PIL refuses the file the port refuses it; wherever PIL reads
    it the port gives its pixels, or refuses it naming one of two
    divergences (ROADMAP.md): a 4-stream Huffman literal stream that does
    not end where its size says (libzstd's fast decoders read on), and an
    LZMA error reported in the step that fills the strip (libtiff keeps the
    strip, Python's lzma drops that step's output)."""
    r = np.random.default_rng(900 + seed)
    bases = _lzma_zstd_corruption_bases()
    read = refused = 0
    for name, base in sorted(bases.items()):
        for _ in range(24):
            data = bytearray(base)
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
            want, got = _outcome(tmp_path, data, "c.tif")
            if want is None:
                assert got is None, f"{name}: PIL refuses {data.hex()}, the port reads it"
                refused += 1
            elif got is None:
                with pytest.raises(ValueError, match="fast decoder reads on|step that fills it"):
                    port_image.decode_image(data, name)
                refused += 1
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name}: {data.hex()}")
                read += 1
    assert read > 20 and refused > 20


def test_zstd_decoder_build_failure_raises(tmp_path, monkeypatch):
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-xyz")
    with open(os.path.join(FIXTURES, "tiff_pil_rgb8_zstd.tif"), "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match="TIFF ZSTD decoder"):
        port_image.decode_image(data)


# ----------------------------------- corruptions ---------------------------------

def _corruption_bases():
    bases = {k: v for k, v in tiff_fixtures(np.random.default_rng(12)).items()
             if "ycbcr22" not in k}  # libtiff's RGBA reader: see the module docstring
    px = pattern(12, 10, 6)
    for compression in ("tiff_lzw", "packbits", "tiff_adobe_deflate", "jpeg"):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "TIFF", compression=compression)
        bases[f"pil-{compression}"] = buf.getvalue()
    return bases


@pytest.mark.parametrize("seed", range(6))
def test_corrupted_files_read_as_pil_or_are_refused_as_pil_refuses(tmp_path, seed):
    """Seeded byte changes (anywhere, and in the header and IFD), cuts and
    tails: where PIL reads the file the pixels are equal, where it refuses
    it the port raises ValueError (never another error)."""
    r = np.random.default_rng(seed)
    bases = _corruption_bases()
    names = sorted(bases)
    read = refused = 0
    for _ in range(60):
        name = names[r.integers(len(names))]
        data = bytearray(bases[name])
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
        want, got = _outcome(tmp_path, data, "c.tif")
        if want is None:
            assert got is None, f"{name}: PIL refuses {data.hex()}, the port reads it"
            refused += 1
        else:
            assert got is not None, f"{name}: PIL reads {data.hex()}, the port refuses it"
            np.testing.assert_array_equal(got, want, err_msg=f"{name}: {data.hex()}")
            read += 1
    assert read > 10 and refused > 10


# ----------------------------------- refused forms -------------------------------

def _with_compression(code, photometric=1, bits=1):
    return tiff_bytes(np.zeros((4, 8, 1), int), bits, photometric, compression=1,
                      tags={259: (3, [code])})


REFUSED = {
    # a strip of zero bytes is no MH or MMR data: libtiff ends it early
    "ccitt-rle": (lambda: _with_compression(2), "CCITT RLE TIFF data ends early"),
    "ccitt-group4": (lambda: _with_compression(4), "CCITT Group 4 TIFF data ends early"),
    "ccitt-rlew": (lambda: _with_compression(32771), "CCITT RLEW TIFF data ends early"),
    # one YCbCr sample: libtiff's RGBA reader refuses it
    "old-jpeg": (lambda: _with_compression(6, 6, 8), "old-style JPEG TIFF of photometric 6"),
    # 1-bit samples: libtiff's ThunderScan decoder takes 4 bits only
    "thunderscan": (lambda: _with_compression(32809), "ThunderScan TIFF of 1-bit samples"),
    "sgilog": (lambda: _with_compression(34676), "SGILog-compressed TIFF .PIL refuses it"),
    "sgilog24": (lambda: _with_compression(34677), "SGILog24-compressed TIFF .PIL refuses it"),
    # zero bytes are no LZMA or ZSTD stream: libtiff refuses them
    "lzma": (lambda: _with_compression(34925, bits=8), "corrupt TIFF LZMA data"),
    "zstd": (lambda: _with_compression(50000, bits=8), "corrupt TIFF ZSTD data"),
    "webp-in-tiff": (lambda: _with_compression(50001, bits=8), "WebP"),
    # Lab at 16 bits: PIL's OPEN_INFO has no mode for it (8-bit Lab reads)
    "lab": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 16, 8),
            "photometric 8.*unknown pixel mode"),
    "unknown-pixel-mode": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 4, 2),
                           "unknown pixel mode"),
    "planar-grey": (lambda: tiff_bytes(np.arange(64).reshape(8, 8, 1), 8, 1, planar=2,
                                       compression=5), "planar TIFF in mode L"),
    "ycbcr-predictor": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 8, 6, compression=5,
                                           predictor=2), "YCbCr TIFF with predictor"),
    "ycbcr-4x4": (lambda: tiff_bytes(np.zeros((4, 4, 3), int), 8, 6, compression=5,
                                     ycbcr=(4, 4)), "subsampled 4x4"),
    "bigtiff-big-endian": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 8, 2, order=">",
                                              bigtiff=True), "big-endian BigTIFF"),
    "predictor-on-4-bits": (lambda: tiff_bytes(np.zeros((2, 2, 1), int), 4, 1, compression=5,
                                               tags={317: (3, [2])}), "predictor on 4-bit"),
}
# forms PIL reads that the port refuses, naming them (ROADMAP.md, later slices)
PIL_READS = {"planar-grey", "ycbcr-predictor", "ycbcr-4x4"}


@pytest.mark.parametrize("form", list(REFUSED))
def test_refused_forms_name_themselves(tmp_path, form):
    make, match = REFUSED[form]
    data = make()
    path = tmp_path / "r.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)
    if form not in PIL_READS:
        with pytest.raises(Exception):
            _pil_path(str(path))


def test_ccitt_tiff_written_by_pil_is_refused_naming_it(tmp_path):
    """A Group 4 file of PIL's writer reads bit-equal to PIL and to the JAX
    package's read_image, and a Group 3 strip of zero bytes reads as PIL
    reads it (no EOL: libtiff reads the strip again without EOLs, all
    white)."""
    path = tmp_path / "g4.tif"
    Image.fromarray(pattern(16, 24, 3)).convert("1").save(path, "TIFF", compression="group4")
    assert _pil_path(str(path)).shape == (16, 24, 3)
    np.testing.assert_array_equal(port_image.decode_image(path.read_bytes()),
                                  _pil_path(str(path)))
    _same_read(str(path))
    path.write_bytes(_with_compression(3))
    got = port_image.decode_image(path.read_bytes())
    np.testing.assert_array_equal(got, _pil_path(str(path)))
    assert (got == 0).all()  # white runs as 0 bits, black under photometric 1
    _same_read(str(path))


def test_tiff_lzw_build_failure_raises(tmp_path, monkeypatch):
    """Without a C++ compiler the LZW strips cannot decode: an error naming
    the compiler, no fallback."""
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="TIFF LZW decoder"):
        port_image.decode_image(tiff_bytes(np.zeros((2, 2, 3), int), 8, 2, compression=5))


def test_tiff_decoder_needs_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m, akari_torch.core.tiff\n"
            "for n in ('tiff_pil_rgb8_jpeg.tif', 'tiff_ycbcr420_jpeg_tables.tif',\n"
            "          'tiff_rgb16_deflate_pred2_be.tif', 'cmyk_adobe_q90.jpg'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:5] == ["(19, 23, 3)", "(21, 18, 3)", "(21, 18, 3)",
                                          "(19, 26, 3)", "[]"]


# -------------------------------- a TIFF albedo ----------------------------------

def test_obj_map_kd_tiff_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd albedo.tif`` (LZW with the
    horizontal predictor, as Photoshop saves): the texture tables and a
    16x16 CPU render equal those of the same OBJ on a PNG of the same
    pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    tex = pattern(24, 32, 9)
    (tmp_path / "albedo.tif").write_bytes(tiff_bytes(tex, 8, 2, compression=5, predictor=2,
                                                     rows_per_strip=8))
    (tmp_path / "albedo.png").write_bytes(port_image.encode_png(tex))
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = [], []
    for ext in ("tif", "png"):
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
    _same_read(str(tmp_path / "albedo.tif"))
