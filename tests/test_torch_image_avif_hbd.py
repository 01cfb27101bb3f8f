"""Port parity: the AVIF forms of slice 25 in the PIL-free decoder
(akari_torch/core/avif.py with akari_torch/native/av1_decode.cpp) against
PIL 12.1.0, which reads AVIF through its bundled libavif 1.3.0 (dav1d 1.5.1
decoding, libyuv scaling and converting) and through which the JAX
package's ``read_image`` reads it: 10- and 12-bit AV1, superres, and a key
frame hidden in sample 0 of a sequence and shown by ``show_existing_frame``.

PIL's writer makes 8-bit key frames only. The files here are header
rewrites of its files (``tools/av1_rewrite.py``): the AV1 syntax these
forms change sits in the uncompressed headers, so a rewritten header over
the unchanged tile data is a valid stream of the new form (at 10 and 12
bits the same symbols decode to other pixels). Files new at their size are
written by PIL in a subprocess (``_avif``: aom can crash the writer).

Tolerance: exact. Every read equals PIL's ``convert("RGB")`` (and its mode)
and the JAX package's ``read_image``, every plane dav1d's (uint16 above 8
bits), and what PIL refuses the port refuses:

- the header rewriter re-emits every header of the fixtures bit for bit,
  and refuses the sources it cannot rewrite soundly;
- 10- and 12-bit rewrites of the fixtures and of drawn files of PIL's
  writer (speeds 0-10, 4:2:0 / 4:2:2 / 4:4:4 / 4:0:0, both ranges, alpha and
  premultiplied alpha, segmentation, delta q / lf, intra block copy without
  palettes, CDEF, loop restoration, quantizer matrices, film grain, frame 0
  of sequences) and of the 2048^2 albedos;
- YUV -> RGB and the alpha's reduction to 8 bits at 10 and 12 bits against
  ``avifImageYUVToRGB`` on each of libavif's routes (the extremes and 2^20
  seeded triples each), and libyuv's ScalePlane_16 against
  ``avifImageScale``;
- superres at every denominator (9-16), odd widths among them;
- the hidden key frame shown by ``show_existing_frame``;
- the forms still refused, each named: a palette above 8 bits, a switch
  frame, frame ids on an inter frame, a hidden frame no header shows, and
  a transform past its range at 10 and 12 bits;
- seeded corruption of the new fixtures.
"""

import functools
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import avif as port_avif
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tests import _avif_oracle as oracle
from tests.test_torch_image_avif import OUT_OF_SCOPE, _agree, _planes_equal_dav1d
from tests.test_torch_image_avif_seg_ibc import ROUTES, _headers
from tools import av1_rewrite as rw
from tools.avif_writers import Avif
from tools.make_torch_port_image_fixtures import (AVIF_OUT, AVIF_REWRITES, _avif,
                                                  avif_rewrite_albedo_files, glyphs, pattern)

FORMATS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "400": (0, 0)}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    with open(os.path.join(AVIF_OUT, name), "rb") as f:
        return f.read()


def _digests():
    with open(os.path.join(AVIF_OUT, "digests.json")) as f:
        return json.load(f)


def _same_everywhere(data, tmp_path, name="x.avif"):
    """PIL, dav1d's planes and the JAX package's read_image; the header values."""
    assert _agree(data) == "ok"
    info = _planes_equal_dav1d(data)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(port_image.read_image(path), ref_image.read_image(path))
    return info


def _item_obus(data):
    c, item, _, _ = port_avif.parse(data)
    return c.item_data(item)


# ---------------------------------------------------------- rewriter -------

REWRITABLE = sorted(n for n in _digests() if "grid" not in n and "idat" not in n)


@pytest.mark.parametrize("name", REWRITABLE)
def test_rewriter_re_emits_every_header_bit_for_bit(name):
    """Each sequence and key-frame header parsed into its fields and written
    back (tile groups re-aligned after it) gives the file's own bytes."""
    data = _fixture(name)
    same = rw._rewrite_file(data, lambda d: rw._rewrite_obus(d, lambda s, t: t,
                                                             lambda s, h, t: t, strict=False))
    assert same == data
    s, toks = rw.parse_sequence_header(next(b for h, _, b in rw.split_obus(_item_obus(data))
                                            if (h >> 3) & 15 == 1))
    assert s["bitdepth"] == port_avif.avif_frame_info(data)["bit_depth"]


@pytest.mark.parametrize("form", ["screen_depth", "lr_superres", "lr_superres16",
                                  "screen_superres", "sequence_superres", "still_hidden",
                                  "deep_deep", "hidden_twice"])
def test_rewriter_refuses_what_it_cannot_rewrite_soundly(form):
    call = {
        "screen_depth": lambda: rw.to_high_bitdepth(
            _fixture("avif_palette_screen_128x96.avif"), 10),
        "lr_superres": lambda: rw.to_superres(_fixture("albedo2048_q60_s4_tools.avif"), 12),
        "lr_superres16": lambda: rw.to_superres(_fixture("albedo2048_q60_s4_tools.avif"), 16),
        "screen_superres": lambda: rw.to_superres(
            _fixture("avif_intrabc_screen_160x120.avif"), 12),
        "sequence_superres": lambda: rw.to_superres(_fixture("avis_aq1_s6_128x96.avif"), 12),
        "still_hidden": lambda: rw.hide_key_frame(_fixture("avif_q75_420_61x47.avif")),
        "deep_deep": lambda: rw.to_high_bitdepth(_fixture("avif_hbd10_q75_420_61x47.avif"), 12),
        "hidden_twice": lambda: rw.hide_key_frame(_fixture("avis_hidden_aq1_s6_128x96.avif")),
    }[form]
    with pytest.raises(rw.RewriteError):
        call()


def test_rewritten_headers_say_what_they_were_asked():
    ten = port_avif.avif_frame_info(_fixture("avif_hbd10_q75_420_61x47.avif"))
    twelve = port_avif.avif_frame_info(_fixture("avif_hbd12_q40_422_limited_50x30.avif"))
    assert (ten["bit_depth"], ten["profile"], ten["ssx"], ten["ssy"]) == (10, 0, 1, 1)
    assert (twelve["bit_depth"], twelve["profile"], twelve["ssx"], twelve["ssy"]) == (12, 2, 1, 0)
    sr = port_avif.avif_frame_info(_fixture("avif_superres9_q75_420_61x47.avif"))
    assert sr["superres_denom"] == 9 and sr["width"] == rw.superres_width(61, 9) == 69
    a = Avif.parse(_fixture("avif_hbd12_rgba_q90_444_30x20.avif"))
    assert {bytes(b[4:]) for t, b in a.props if t == b"pixi"} == {b"\x03\x0c\x0c\x0c",
                                                                   b"\x01\x0c"}
    assert all(b[2] & 0x60 == 0x60 and b[1] >> 5 == 2 for t, b in a.props if t == b"av1C")


# ------------------------------------------------------------ fixtures ------

NEW_FIXTURES = sorted(n for n in _digests() if "hbd" in n or "superres" in n or "hidden" in n)


def test_every_new_fixture_is_small_and_has_its_digest():
    assert len(NEW_FIXTURES) == 20
    for name in NEW_FIXTURES:
        assert os.path.getsize(os.path.join(AVIF_OUT, name)) < 30000, name


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixture_reads_as_pil_jax_and_dav1d(name, tmp_path):
    info = _same_everywhere(_fixture(name), tmp_path, name)
    if "hbd" in name:
        assert info["bit_depth"] == (10 if "hbd10" in name else 12)
    if "superres" in name:
        assert info["superres_denom"] == int(name.split("superres")[1].split("_")[0])
    assert info["hidden"] == ("hidden" in name)


BASES = ["avif_q75_420_61x47.avif", "avif_q100_444_lossless_33x21.avif",
         "avif_q40_422_limited_50x30.avif", "avif_q60_400_40x32.avif",
         "avif_rgba_premultiplied_30x20.avif", "avif_tiles_2x2_q50_128x128.avif",
         "avif_q0_txselect_64x48.avif", "avif_speed10_q75_45x37.avif",
         "avif_exif_rot_icc_24x16.avif",
         "avif_nclx_bt709_limited_26x18.avif", "avif_nclx_fcc_26x18.avif",
         "avif_nclx_identity_26x18.avif", "avif_deltaq_deltalf_q60_160x120.avif",
         "avif_grain_test5_422_66x35.avif", "avis_aq1_s0_96x72.avif", "avis_aq1_s4_128x96.avif"]


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", BASES)
def test_high_bitdepth_rewrite_of_fixture_reads_as_pil_jax_and_dav1d(name, depth, tmp_path):
    info = _same_everywhere(rw.to_high_bitdepth(_fixture(name), depth), tmp_path)
    assert info["bit_depth"] == depth


INTRABC = ["avif_intrabc_screen_160x120.avif", "avif_intrabc_screen_422_160x120.avif",
           "avif_intrabc_screen_444_160x120.avif", "avif_intrabc_screen_400_160x120.avif"]


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", INTRABC)
def test_intra_block_copy_at_depth_reads_as_pil_or_refuses_its_palette(name, depth, tmp_path):
    """A screen-content frame decodes the same symbols at 10 and 12 bits up
    to its first palette, whose colours are literals of the depth: the
    files without palettes read as PIL reads them, the others are refused
    naming the palette."""
    st = {}
    port_avif.avif_planes(_fixture(name), name, st)
    data = rw.to_high_bitdepth(_fixture(name), depth, screen_content_ok=True)
    if st["palette_y"] or st["palette_uv"]:
        with pytest.raises(ValueError, match=f"palette at a bit depth of {depth}"):
            port_avif.avif_planes(data)
        return
    _same_everywhere(data, tmp_path)
    st = {}
    port_avif.avif_planes(data, name, st)
    assert st["intrabc_blocks"] > 0


def _drawn(seed):
    """A file of PIL's writer drawn from ``seed`` (in a subprocess) and the
    rewrite applied to it."""
    r = np.random.default_rng(700 + seed)
    h, w = int(r.integers(8, 90)), int(r.integers(8, 90))
    px = pattern(h, w, 700 + seed)
    kw = {"quality": int(r.integers(20, 95)), "speed": int(r.integers(5, 11)),
          "subsampling": str(r.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
          "range": str(r.choice(["full", "limited"]))}
    if seed % 3 == 1:
        px = np.concatenate([px, pattern(h, w, 800 + seed)[..., :1]], -1)
        kw["alpha_premultiplied"] = bool(seed % 2)
    if seed % 4 == 2:
        kw["advanced"] = {"enable-cdef": "1", "denoise-noise-level": "10"}
    return _avif(px, **kw)


@pytest.mark.parametrize("seed", range(10))
def test_drawn_files_at_10_and_12_bits_read_as_pil_jax_and_dav1d(seed, tmp_path):
    data = _drawn(seed)
    assert data is not None
    for depth in (10, 12):
        assert _same_everywhere(rw.to_high_bitdepth(data, depth), tmp_path)["bit_depth"] == depth


@pytest.mark.parametrize("speed", range(11))
def test_every_writer_speed_at_depth_reads_as_pil_jax_and_dav1d(speed, tmp_path):
    """PIL's writer at each speed (0-4 with loop restoration and aom's
    other slow tools), rewritten at 10 bits (even speeds) or 12 (odd)."""
    data = _avif(pattern(40, 56, 950 + speed), quality=50, speed=speed)
    depth = 12 if speed % 2 else 10
    assert _same_everywhere(rw.to_high_bitdepth(data, depth), tmp_path)["bit_depth"] == depth


@pytest.mark.parametrize("name", ["albedo2048_q60_s4_tools_10bit.avif",
                                  "albedo2048_q60_s4_tools_12bit.avif",
                                  "albedo2048_q60_superres12.avif"])
def test_2048_albedo_rewrites_are_recorded_as_pil_reads_them(name):
    """The 2048^2 albedos phase 54 of ``chip_smoke.py`` rewrites at run time:
    the same bytes as ``AVIF_REWRITES`` records, PIL's decode as recorded,
    the port's decode equal to it and its planes to dav1d's."""
    with open(AVIF_REWRITES) as f:
        rec = json.load(f)
    files = avif_rewrite_albedo_files()
    assert sorted(files) == sorted(rec)
    data = files[name]
    assert hashlib.sha256(data).hexdigest() == rec[name]["file_sha256"]
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec[name]["sha256"]
    np.testing.assert_array_equal(port_image.decode_image(data, name), want)
    info = _planes_equal_dav1d(data)
    assert [info["height"], info["width"], 3] == rec[name]["shape"]


# -------------------------------------------------------- YUV -> RGB -------

# (depth, subsampling, matrix, primaries, alpha): one of each of libavif
# 1.3.0's routes from 10- and 12-bit YUV to PIL's 8-bit RGB(A)
RGB_ROUTES = {
    "shift8_420": (10, "420", 1, 1, False), "shift8_422": (12, "422", 6, 6, False),
    "shift8_444": (10, "444", 9, 9, False), "shift8_matrix12": (12, "420", 12, 1, False),
    "shift8_rgba_444_12": (12, "444", 6, 6, True), "shift8_rgba_422_12": (12, "422", 1, 1, True),
    "i410_rgba": (10, "444", 1, 1, True), "i210_rgba": (10, "422", 6, 6, True),
    "i010_rgba": (10, "420", 9, 9, True), "i012_rgba": (12, "420", 1, 1, True),
    "float_fcc_420": (10, "420", 4, 1, False), "float_smpte240_rgba": (12, "422", 7, 1, True),
    "float_ycgco": (12, "444", 8, 1, False), "float_identity_rgba": (10, "444", 0, 1, True),
    "float_matrix12": (10, "420", 12, 4, False), "grey_float": (12, "400", 1, 1, False),
    "grey_shift8_rgba": (10, "400", 6, 6, True), "grey_float_rgba": (12, "400", 4, 1, True),
}


def _planes(r, depth, fmt, h, w, extremes=False):
    ssx, ssy = FORMATS[fmt]
    n = 1 << depth
    y = r.integers(0, n, (h, w))
    u = r.integers(0, n, ((h + ssy) >> ssy, (w + ssx) >> ssx))
    v = r.integers(0, n, u.shape)
    if extremes:  # every combination of the extremes and the middle, 4:4:4
        e = np.array([0, 1, n // 2 - 1, n // 2, n - 2, n - 1])
        g = np.stack(np.meshgrid(e, e, e, indexing="ij"), -1).reshape(-1, 3)
        y, u, v = (g[:, k].reshape(12, 18) for k in range(3))
    return y, u, v


@pytest.mark.parametrize("route", sorted(RGB_ROUTES))
def test_yuv_to_rgb_at_depth_is_libavifs(route):
    depth, fmt, mc, cp, alpha = RGB_ROUTES[route]
    r = np.random.default_rng(len(route) * 7 + depth)
    for full in (1, 0):
        for extremes in ((True, False) if fmt == "444" else (False,)):
            if extremes:
                y, u, v = _planes(r, depth, fmt, 0, 0, True)
            else:
                y, u, v = _planes(r, depth, fmt, 1024, 1024 + (fmt != "444"))
            if mc == 8 and not full:
                continue
            h, w = y.shape
            ssx, ssy = FORMATS[fmt] if not extremes else (0, 0)
            al = r.integers(0, 1 << depth, (h, w)) if alpha else None
            res, ref = oracle.libavif_rgb(y, u, v, fmt if not extremes else "444", full, mc, cp,
                                          alpha=al, depth=depth)
            assert res == 0
            got, a8 = port_avif.yuv_to_rgb_alpha(y, u, v, al, fmt == "400", ssx, ssy, mc, full,
                                                 cp, False, depth=depth)
            np.testing.assert_array_equal(got, ref[..., :3], err_msg=f"{route} full={full}")
            if alpha:
                np.testing.assert_array_equal(a8, ref[..., 3])
            np.testing.assert_array_equal(
                port_avif.yuv_to_rgb(y, u, v, fmt == "400", ssx, ssy, mc, full, cp, alpha,
                                     depth=depth), got)


@pytest.mark.parametrize("route", sorted(k for k, v in RGB_ROUTES.items() if v[4]))
def test_alpha_reduction_and_unpremultiplication_at_depth_are_libavifs(route):
    """Every alpha value of the depth (shifted on libyuv's routes, rounded
    on libavif's own) and the premultiplied colour divided by it."""
    depth, fmt, mc, cp, _ = RGB_ROUTES[route]
    r = np.random.default_rng(len(route))
    n = 1 << depth
    al = np.arange(n).reshape(-1, 64)
    h, w = al.shape
    y, u, v = _planes(r, depth, fmt, h, w)
    for prem in (False, True):
        res, ref = oracle.libavif_rgb(y, u, v, fmt, 1, mc, cp, alpha=al, premultiplied=prem,
                                      depth=depth)
        assert res == 0
        ssx, ssy = FORMATS[fmt]
        got, a8 = port_avif.yuv_to_rgb_alpha(y, u, v, al, fmt == "400", ssx, ssy, mc, 1, cp,
                                             prem, depth=depth)
        np.testing.assert_array_equal(a8, ref[..., 3], err_msg=route)
        np.testing.assert_array_equal(got, ref[..., :3], err_msg=f"{route} prem={prem}")


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scale_plane_16_is_libavifs(route, depth):
    """libyuv's ScalePlane_16 (C rows where the 8-bit planes take SSSE3's,
    16-bit column fractions, 32-bit box sums) as avifImageScale runs it."""
    r = np.random.default_rng(len(route) + depth)
    for sw, sh, dw, dh in ROUTES[route]:
        src = r.integers(0, 1 << depth, (sh, sw)).astype(np.uint16)
        res, ref = oracle.libavif_scale([src], "400", sw, sh, dw, dh, depth=depth)
        assert res == 0
        got = port_avif.scale_plane(src, dw, dh)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, ref[0], err_msg=str((sw, sh, dw, dh)))


def test_an_alpha_plane_of_another_depth_fails_as_in_pil():
    """The colour item put back at 8 bits beside a 10-bit alpha item:
    libavif fails the alpha's decode, and so does the port."""
    a, o = Avif.parse(rw.to_high_bitdepth(_fixture("avif_rgba_q90_444_30x20.avif"), 10)), \
        Avif.parse(_fixture("avif_rgba_q90_444_30x20.avif"))
    a.items[a.primary] = o.items[a.primary]
    for idx, _ in a.assoc[a.primary]:
        a.props[idx - 1] = o.props[idx - 1]
    data = a.build()
    assert _agree(data) == "fail"
    with pytest.raises(ValueError, match="alpha plane of 10 bits in an image of 8"):
        port_image.decode_image(data)


def test_a_high_bitdepth_frame_scaled_to_its_ispe_reads_as_pil(tmp_path):
    a = Avif.parse(rw.to_high_bitdepth(_fixture("avif_q75_420_61x47.avif"), 12))
    a.props = [(t, b"\0" * 4 + (83).to_bytes(4, "big") + (31).to_bytes(4, "big"))
               if t == b"ispe" else (t, b) for t, b in a.props]
    data = a.build()
    assert _agree(data) == "ok"
    assert port_image.decode_image(data).shape == (31, 83, 3)


# ------------------------------------------------------------ superres ------

@functools.lru_cache(maxsize=None)
def _superres_base(fmt):
    return _avif(pattern(29, 37, 90), quality=55, speed=8, subsampling=fmt)


@pytest.mark.parametrize("denom", range(9, 17))
def test_superres_at_every_denominator_reads_as_pil_jax_and_dav1d(denom, tmp_path):
    """An odd coded width (37) upscaled at each denominator, 4:2:0 and 4:4:4."""
    for fmt in ("4:2:0", "4:4:4"):
        data = rw.to_superres(_superres_base(fmt), denom)
        info = _same_everywhere(data, tmp_path)
        assert info["superres_denom"] == denom
        assert info["width"] == rw.superres_width(37, denom)


@pytest.mark.parametrize("denom", [9, 16])
def test_superres_of_a_narrower_upscaled_width_reads_as_pil(denom, tmp_path):
    """The smallest upscaled width whose downscaled width is the coded one."""
    w = rw.superres_width(37, denom)
    while (w - 2) * 8 // denom >= 37 and ((w - 1) * 8 + denom // 2) // denom == 37:
        w -= 1
    data = rw.to_superres(_superres_base("4:2:2"), denom, upscaled_width=w)
    assert _same_everywhere(data, tmp_path)["width"] == w


def test_superres_of_a_lossless_frame_reads_its_restoration_types(tmp_path):
    """Superres makes a lossless frame's loop restoration types readable
    (AllLossless is off): the rewrite writes them (none) and the port reads
    them."""
    data = rw.to_superres(_fixture("avif_q100_444_lossless_33x21.avif"), 11)
    info = _same_everywhere(data, tmp_path)
    assert info["lossless"] and info["superres_denom"] == 11


# ------------------------------------------------------ hidden frames -------

@pytest.mark.parametrize("name", ["avis_aq1_s0_96x72.avif", "avis_aq1_s4_128x96.avif",
                                  "avis_3frames_rgba_24x17.avif", "avis_hbd12_aq1_s6_128x96.avif"])
def test_a_hidden_key_frame_shown_by_show_existing_frame_reads_as_pil(name, tmp_path):
    data = rw.hide_key_frame(_fixture(name))
    info = _same_everywhere(data, tmp_path)
    assert info["hidden"] == 1
    np.testing.assert_array_equal(port_image.decode_image(data),
                                  port_image.decode_image(_fixture(name)))


def test_any_slot_the_key_frame_refreshed_may_be_shown(tmp_path):
    for slot in (3, 7):
        _same_everywhere(rw.hide_key_frame(_fixture("avis_aq1_s6_128x96.avif"), slot), tmp_path)


def _without_show_existing(data):
    """``data`` with sample 0's show_existing_frame header dropped (its
    OBU_FRAME_HEADER emptied into a padding OBU of the same size)."""
    def payload(d):
        out = []
        for h, ext, body in rw.split_obus(d):
            if (h >> 3) & 15 == 3 and body and body[0] & 0x80:
                h = (15 << 3) | (h & 4)
            out.append((h, ext, body))
        return rw.join_obus(out)

    return rw._rewrite_file(data, payload, samples="first")


# ------------------------------------------------------------ refusals ------

def _refused(form):
    if form in ("palette10", "palette12"):
        return _item_obus(rw.to_high_bitdepth(_fixture("avif_palette_screen_128x96.avif"),
                                              int(form[7:]), screen_content_ok=True))
    if form == "hidden_not_shown":
        return _item_obus(_without_show_existing(_fixture("avis_hidden_aq1_s6_128x96.avif")))
    if form.startswith("overflow"):
        data = rw.to_high_bitdepth(_fixture("avif_grain_test5_422_66x35.avif"), int(form[8:]))
        return _item_obus(rw.set_base_q_idx(data, 255))
    return _headers(form)


@pytest.mark.parametrize("form,words", [
    ("palette10", "palette at a bit depth of 10"), ("palette12", "palette at a bit depth of 12"),
    ("switch", "switch frame"), ("frame_ids", "frame ids"),
    ("hidden", "hidden"), ("hidden_not_shown", "hidden AV1 key frame that no show_existing"),
    ("overflow10", "range the specification requires at a bit depth of 10"),
    ("overflow12", "range the specification requires at a bit depth of 12")])
def test_forms_still_refused_are_named(form, words):
    with pytest.raises(ValueError, match=words) as e:
        port_avif._decode_planes(_refused(form), "x")
    assert any(t in str(e.value) for t in OUT_OF_SCOPE)


def test_a_hidden_frame_no_header_shows_fails_in_pil_too():
    data = _without_show_existing(_fixture("avis_hidden_aq1_s6_128x96.avif"))
    assert _agree(data, allow_out_of_scope=True) in ("fail", "refused")


def test_no_new_fixture_leaves_the_transform_range():
    """The committed fixtures are conformant: none sets the overflow flag
    (the overflow refusal has the rewrites above with the q index raised)."""
    for name in NEW_FIXTURES:
        port_avif.avif_planes(_fixture(name))


# ---------------------------------------------------------- corruption ------

@pytest.mark.parametrize("seed", range(4))
def test_seeded_corruption_of_the_new_fixtures_reads_as_pil_or_is_refused(seed):
    r = np.random.default_rng(900 + seed)
    counts = {}
    for k in range(120):
        d = bytearray(_fixture(NEW_FIXTURES[int(r.integers(0, len(NEW_FIXTURES)))]))
        mdat = d.find(b"mdat") + 4
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(mdat, len(d))) if r.random() < 0.9 else int(r.integers(0, len(d)))
            d[pos] = int(r.integers(0, 256))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 30, counts


def test_digests_of_the_new_fixtures_are_pils_decode():
    digests = _digests()
    for name in NEW_FIXTURES:
        with Image.open(io.BytesIO(_fixture(name))) as im:
            px = np.asarray(im.convert("RGB"))
            assert im.mode == digests[name]["mode"]
        assert hashlib.sha256(px.tobytes()).hexdigest() == digests[name]["sha256"], name


def test_glyphs_at_12_bits_without_screen_tools_read_as_pil(tmp_path):
    """Screen content coded without screen content tools (aom's default
    tune) rewrites like any frame."""
    data = _avif(glyphs(64, 80, 5), quality=60, speed=8)
    if port_avif.avif_frame_info(data)["screen_content"]:
        pytest.fail("the writer turned on screen content tools")
    _same_everywhere(rw.to_high_bitdepth(data, 12), tmp_path)
