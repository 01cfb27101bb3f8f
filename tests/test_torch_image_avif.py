"""Port parity: AVIF (the HEIF container, AV1 intra frames, libavif's YUV ->
RGB) in the PIL-free decoder (akari_torch/core/avif.py with
akari_torch/native/av1_decode.cpp) against PIL 12.1.0, which reads AVIF
through its bundled libavif 1.3.0 (dav1d 1.5.1 decoding, libyuv 1909
converting) and through which the JAX package's ``read_image`` reads it.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
its planes equal dav1d's, and what PIL refuses the port refuses with
``ValueError``:

- the AV1 tables of ``akari_torch/native/av1_tables.h`` equal a fresh
  extraction from the bundled libavif (``tools/extract_av1_tables.py``,
  which checks dav1d's copies against aom's);
- YUV -> RGB on all 2^24 (Y, U, V) triples at 4:4:4 for every matrix and
  range libavif converts (BT.601 full range, PIL's writer's default, among
  them) against ``avifImageYUVToRGB`` called through ctypes, subsampled
  chroma, grey images with and without alpha, and the un-premultiplication
  on all (colour, alpha) pairs;
- the fixtures of ``tests/data/torch_port_avif`` (PIL's digests, mode,
  dav1d's planes) and files drawn from seeds through PIL's writer (1x1 to
  200x150, qualities 0-100, speeds 5-10, every subsampling, both ranges,
  alpha, premultiplied alpha, tiles, screen content, oriented edges, EXIF
  orientation and ICC), each equal to PIL, to the JAX package's
  ``read_image`` and, plane by plane, to dav1d;
- container edits by ``tools/avif_writers.py`` and seeded corruption, read
  as PIL reads them or refused where PIL fails (a ``NextFormat`` where
  PIL's open raises ``SyntaxError`` and goes on to the next format);
- PIL's speeds 0-4 (loop restoration), a grid and a sequence read as PIL
  reads them (``tests/test_torch_image_avif_tools.py`` holds the tools
  and containers of slice 23 in depth), and a frame whose size differs
  from its ``ispe`` scaled to it as PIL reads it;
- an OBJ whose ``map_Kd`` is an AVIF renders at 16x16 on the CPU bit-equal
  to the PNG route, and the decoder runs without PIL.
"""

import copy
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

from akari_torch.core import avif as port_avif
from akari_torch.core import image as port_image
from akari_torch.core.image_formats import NextFormat
from akari_tpu.core import image as ref_image
from tests import _avif_oracle as oracle
from tools import extract_av1_tables as xt
from tools.avif_writers import Avif
from tools.make_torch_port_image_fixtures import ALBEDO_AVIF, AVIF_OUT, pattern

# a refusal naming a tool or form outside the port's AVIF reader
OUT_OF_SCOPE = ("superres", "bit depth", "non-key", "hidden", "show_existing_frame",
                "16-bit range", "no file made here holds", "switch frame", "scaled prediction",
                "frame ids")


def _save(px, **kw):
    b = io.BytesIO()
    Image.fromarray(px).save(b, "AVIF", **kw)
    return b.getvalue()


def _pil(data):
    """('ok', pixels, mode), ('next', msg) where PIL's open gives up on the
    file (no format takes it), or ('fail', msg)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(io.BytesIO(data))
        except (SyntaxError, Image.UnidentifiedImageError) as e:
            return "next", str(e)
        except Exception as e:
            return "fail", str(e)
        try:
            return "ok", np.asarray(im.convert("RGB")), im.mode, im.format
        except Exception as e:
            return "fail", str(e)


def _port(data):
    try:
        fmt, mode, px, _ = port_image.decode_with_mode(data, "f")
        return "ok", px, mode, fmt
    except ValueError as e:
        return ("next" if "unsupported image format" in str(e) else "fail"), str(e)


def _agree(data, allow_out_of_scope=False):
    """PIL and the port read the same pixels (and mode), or fail alike;
    returns the outcome."""
    a, b = _pil(data), _port(data)
    if allow_out_of_scope and a[0] == "ok" and b[0] == "fail" and any(
            t in b[1] for t in OUT_OF_SCOPE):
        return "refused"
    assert a[0] == b[0], (a[1] if a[0] != "ok" else "PIL reads it", b[1] if b[0] != "ok" else
                          "the port reads it")
    if a[0] == "ok":
        assert a[2:] == b[2:], (a[2:], b[2:])
        np.testing.assert_array_equal(b[1], a[1])
    return a[0]


def _obus(data):
    a = Avif.parse(data)
    return a.items[a.primary]


def _planes_equal_dav1d(data):
    a = Avif.parse(data)
    if any(t == b"grid" and i == a.primary for i, t, _, _ in a.infe):  # each tile's planes
        for t, src, dst in a.iref:
            if t == b"dimg" and src == a.primary:
                for tile in dst:
                    ref = oracle.dav1d_planes(a.items[tile])
                    got, info = port_avif._decode_planes(a.items[tile], "tile")
                    for p, (g, r) in enumerate(zip(got[:1] if info[3] else got, ref)):
                        np.testing.assert_array_equal(g, r, err_msg=f"tile {tile} plane {p}")
        return port_avif.avif_frame_info(data)
    ref = oracle.dav1d_planes(_obus(data))
    got, info = port_avif.avif_planes(data)
    got = got[:1] if info["mono"] else got
    assert len(got) == len(ref)
    for p, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"plane {p}")
    return info


# ------------------------------------------------------------ tables -------

def test_av1_tables_header_is_a_fresh_extraction():
    """The committed header is what the extractor writes from the bundled
    libavif (dav1d's CDFs checked against aom's where both are there)."""
    with open(xt.HEADER) as f:
        assert f.read() == xt.render(xt.tables())


def test_av1_tables_hold_the_specifications_values():
    t = {k: v[0] for k, v in xt.tables().items()}
    kf = t["kf_y_mode"]
    assert kf[0, 0, :12].tolist() == [32768 - v for v in (
        15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466)]
    assert t["dc_qlookup"][:4].tolist() == [4, 8, 8, 9] and t["ac_qlookup"][-1] == 1828
    assert t["dr_intra_derivative"][3] == 1023 and t["mode_to_angle"][:9].tolist() == [
        0, 90, 180, 45, 135, 113, 157, 203, 67]
    assert t["sm_weights"][4:8].tolist() == [255, 149, 85, 64]
    assert t["coeff_base"].shape == (4, 5, 2, 41, 4) and t["eob_extra"].shape == (4, 5, 2, 9, 2)


# ------------------------------------------------------- YUV -> RGB ------

_ALL = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                -1).reshape(4096, 4096, 3).astype(np.uint8)


@pytest.mark.parametrize("matrix,full", [(6, 1), (6, 0), (2, 1), (5, 0), (1, 1), (1, 0),
                                         (9, 1), (9, 0), (4, 1), (7, 0), (15, 1), (8, 1),
                                         (0, 1), (0, 0)])
def test_yuv_to_rgb_on_all_triples_is_libavifs(matrix, full):
    """4:4:4 (Y, U, V) -> RGB on all 2^24 triples equals
    avifImageYUVToRGB: libyuv's fixed point for BT.601 (6, 5, and 2
    unspecified), BT.709 and BT.2020, libavif's float route for FCC,
    SMPTE 240M, IPT-C2, YCgCo and identity."""
    oracle.check_layout()
    y, u, v = _ALL[..., 0], _ALL[..., 1], _ALL[..., 2]
    res, want = oracle.libavif_rgb(y, u, v, "444", full, matrix)
    assert res == 0
    got = port_avif.yuv_to_rgb(y, u, v, 0, 0, 0, matrix, full, 1, False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["420", "422"])
def test_subsampled_yuv_to_rgb_is_libavifs(fmt):
    """Chroma upsampling as libavif runs it: libyuv's bilinear rows and
    libavif's own 9/3/3/1 float weights, at odd and even sizes, 1 wide and
    1 high included."""
    r = np.random.default_rng(20 + len(fmt))
    ssx, ssy = 1, int(fmt == "420")
    for h, w in [(1, 1), (1, 7), (6, 1), (2, 2), (3, 5), (17, 33), (40, 31)]:
        y = r.integers(0, 256, (h, w), dtype=np.uint8)
        cw, ch = (w + 1) >> 1, (h + ssy) >> ssy
        u = r.integers(0, 256, (ch, cw), dtype=np.uint8)
        v = r.integers(0, 256, (ch, cw), dtype=np.uint8)
        for matrix, full in [(6, 1), (6, 0), (1, 0), (9, 1), (4, 1), (8, 1)]:
            res, want = oracle.libavif_rgb(y, u, v, fmt, full, matrix)
            assert res == 0
            got = port_avif.yuv_to_rgb(y, u, v, 0, ssx, ssy, matrix, full, 1, False)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {matrix} {full}")


def test_grey_yuv_to_rgb_is_libavifs():
    """A monochrome image's grey, RGB and RGBA (libyuv's BT.601 / BT.709
    constants on the RGBA route at limited range), and the matrices libavif
    fails on failing in the port too."""
    y = np.arange(256, dtype=np.uint8).reshape(16, 16)
    alpha = np.full_like(y, 255)
    for matrix in (0, 1, 2, 4, 5, 6, 7, 8, 9, 15, 10, 13, 14, 16):
        for full in (0, 1):
            for a in (None, alpha):
                res, want = oracle.libavif_rgb(y, None, None, "400", full, matrix, alpha=a)
                if res != 0:
                    with pytest.raises(ValueError, match="nclx matrix"):
                        port_avif.yuv_to_rgb(y, y, y, 1, 1, 1, matrix, full, 1, a is not None)
                    continue
                got = port_avif.yuv_to_rgb(y, y, y, 1, 1, 1, matrix, full, 1, a is not None)
                np.testing.assert_array_equal(got, want[..., :3], err_msg=f"{matrix} {full}")


def test_colour_matrices_libavif_fails_on_fail_in_the_port():
    r = np.random.default_rng(3)
    y = r.integers(0, 256, (4, 6), dtype=np.uint8)
    for matrix, full, fmt in [(3, 1, "444"), (10, 1, "444"), (11, 0, "444"), (13, 1, "444"),
                              (14, 1, "444"), (16, 1, "444"), (8, 0, "444"), (0, 1, "420")]:
        ssy = int(fmt == "420")
        c = y[::1 + ssy, ::1 + ssy] if fmt == "420" else y
        res, _ = oracle.libavif_rgb(y, c, c, fmt, full, matrix)
        assert res != 0
        with pytest.raises(ValueError, match="nclx matrix"):
            port_avif.yuv_to_rgb(y, c, c, 0, ssy, ssy, matrix, full, 1, False)


def test_unpremultiply_on_all_pairs_is_libavifs():
    """libavif's un-premultiplication (libyuv's ARGBUnattenuate) on every
    (colour, alpha) pair: a grey full-range image carries the colour
    through the conversion unchanged."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    y, al = c.astype(np.uint8), a.astype(np.uint8)
    res, want = oracle.libavif_rgb(y, None, None, "400", 1, 6, alpha=al, premultiplied=True)
    assert res == 0
    got = port_avif.unpremultiply(np.repeat(y[..., None], 3, axis=-1), al)
    np.testing.assert_array_equal(got, want[..., :3])


# ------------------------------------------------------------ fixtures ----

def _fixture_digests():
    with open(os.path.join(AVIF_OUT, "digests.json")) as f:
        return json.load(f)


def test_fixture_digests_are_pils_decode():
    digests = _fixture_digests()
    assert len(digests) == len(os.listdir(AVIF_OUT)) - 1 >= 17
    assert os.path.getsize(os.path.join(AVIF_OUT, ALBEDO_AVIF)) == 287591
    for name, rec in digests.items():
        with Image.open(os.path.join(AVIF_OUT, name)) as im:
            px = np.asarray(im.convert("RGB"))
            assert im.mode == rec["mode"], name
        assert list(px.shape) == rec["shape"], name
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(AVIF_OUT) if n.endswith(".avif")))
def test_fixture_reads_as_pil_jax_and_dav1d(name):
    rec = _fixture_digests()[name]
    path = os.path.join(AVIF_OUT, name)
    with open(path, "rb") as f:
        data = f.read()
    fmt, mode, px, _ = port_image.decode_with_mode(data, name)
    assert (fmt, mode) == ("AVIF", rec["mode"])
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _planes_equal_dav1d(data)
    if name != ALBEDO_AVIF:
        np.testing.assert_array_equal(port_image.read_image(path), ref_image.read_image(path))


def test_fixtures_use_the_tools_they_are_named_for():
    """Each tool of the decoder shows in some fixture: 64 and 128 superblocks,
    several tiles, TX_MODE_SELECT and lossless frames, palettes, filter
    intra, CfL, intra transform types, tx_depth splits; and the fixtures of
    slice 23 theirs: CDEF, quantizer matrices, film grain, Wiener,
    self-guided and switchable restoration, a sequence with an alpha track
    and a grid."""
    seen, info_of, filt, parsed = {}, {}, {}, {}
    for name in sorted(_fixture_digests()):
        st, fl = {}, {}
        with open(os.path.join(AVIF_OUT, name), "rb") as f:
            data = f.read()
        _, info = port_avif.avif_planes(data, name, st, fl)
        info_of[name], filt[name], parsed[name] = info, fl, port_avif.parse(data)
        for k, v in st.items():
            seen[k] = seen.get(k, 0) + v
    tools = "albedo2048_q60_s4_tools.avif"
    for name in ("avif_cdef_q30_96x72.avif", tools):
        assert info_of[name]["cdef_strengths"] and filt[name]["cdef_blocks"], name
    for name in ("avif_qm_q40_444_64x48.avif", tools):
        assert info_of[name]["qm_levels"] != 0xFFF, name
    for name in ("avif_grain_q30_128x96.avif", "avif_grain_test5_422_66x35.avif", tools):
        assert info_of[name]["film_grain"] and filt[name]["grain_planes"] == 3, name
    assert info_of["avif_lr_wiener_s1_444_96x72.avif"]["lr_types"] == 0b010101
    assert info_of["avif_lr_sgrproj_s1_444_64x48.avif"]["lr_types"] == 0b101010
    assert info_of[tools]["lr_types"] & 3 == 3 and filt[tools]["lr_stripes"]
    c, item, alpha, _ = parsed["avis_3frames_rgba_24x17.avif"]
    assert c.sequence and alpha is not None and len(c.track_samples(c.tracks[0])) == 3
    assert parsed["avif_grid_3x2_180x100.avif"][1].grid[:4] == (2, 3, 180, 100)
    assert info_of[ALBEDO_AVIF]["sb128"] and info_of[ALBEDO_AVIF]["tile_cols"] == 4
    assert info_of["avif_tiles_2x2_q50_128x128.avif"]["tile_rows"] == 2
    assert info_of["avif_q0_txselect_64x48.avif"]["tx_mode"] == 2
    assert info_of["avif_q100_444_lossless_33x21.avif"]["lossless"]
    assert info_of["avif_palette_screen_128x96.avif"]["screen_content"]
    assert info_of["avif_q40_422_limited_50x30.avif"]["full_range"] == 0
    assert all(seen[k] > 0 for k in ("palette_y", "palette_uv", "filter_intra", "cfl",
                                     "tx_split", "tx_type_not_dct")), seen


# --------------------------------------------------------- drawn cases ----

def _drawn(r, i):
    """One seeded image and writer options."""
    h, w = int(r.integers(1, 151)), int(r.integers(1, 201))
    kind = i % 5
    if kind == 0:
        px = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == 1:
        px = pattern(h, w, int(r.integers(1 << 30)))
    elif kind == 2:  # oriented edges: directional modes with angle deltas
        yy, xx = np.mgrid[0:h, 0:w]
        ang = r.random() * np.pi
        a = 128 + 100 * np.sin((xx * np.cos(ang) + yy * np.sin(ang)) / (2 + 4 * r.random()))
        px = np.clip(np.stack([a, 0.6 * a + 40, 255 - a], -1), 0, 255).astype(np.uint8)
    elif kind == 3:  # flat colours: screen content and palettes
        cols = r.integers(0, 256, (int(r.integers(2, 9)), 3))
        cell = int(r.integers(4, 20))
        idx = (np.arange(h)[:, None] // cell + np.arange(w)[None, :] // (cell + 3)) % len(cols)
        px = cols[idx].astype(np.uint8)
    else:  # the config-3 albedo's texture, cut
        from akari_torch.scene.builtin import envtex_texture

        px = envtex_texture(256, int(r.integers(0, 4)))[:h, :w]
    kw = {"quality": int(r.choice([0, 20, 40, 60, 75, 90, 100])), "speed": int(r.integers(5, 11)),
          "subsampling": str(r.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
          "range": str(r.choice(["full", "limited"]))}
    if r.random() < 0.25:
        a = r.integers(0, 256, (h, w), dtype=np.uint8) if r.random() < 0.5 else np.full((h, w), 200)
        px = np.concatenate([px, a[..., None].astype(np.uint8)], axis=-1)
        kw["alpha_premultiplied"] = bool(r.random() < 0.5)
    if r.random() < 0.2 and h >= 64 and w >= 64:
        kw["tile_rows"], kw["tile_cols"] = int(r.integers(0, 2)), int(r.integers(0, 2))
    elif r.random() < 0.1:
        kw["autotiling"] = True
    if r.random() < 0.15:
        exif = Image.Exif()
        exif[0x0112] = int(r.integers(1, 9))
        kw["exif"] = exif.tobytes()
    if r.random() < 0.1:
        kw["icc_profile"] = bytes(r.integers(0, 256, 64, dtype=np.uint8))
    return px, kw


@pytest.mark.parametrize("seed", range(8))
def test_drawn_files_read_as_pil_jax_and_dav1d(seed, tmp_path):
    r = np.random.default_rng(1000 + seed)
    for i in range(10):
        px, kw = _drawn(r, i)
        data = _save(px, **kw)
        assert _agree(data) == "ok", kw
        _planes_equal_dav1d(data)
        path = str(tmp_path / f"d{i}.avif")
        with open(path, "wb") as f:
            f.write(data)
        for lin in (True, False):
            np.testing.assert_array_equal(port_image.read_image(path, to_linear=lin),
                                          ref_image.read_image(path, to_linear=lin))


def test_drawn_files_use_every_tool_in_scope():
    """Over a drawn set: palettes, filter intra, CfL, angle deltas, splits,
    intra transform types, 128 superblocks, several tiles, lossless."""
    r = np.random.default_rng(77)
    seen, flags = {}, set()
    for i in range(25):
        px, kw = _drawn(r, i)
        if i == 0:
            from akari_torch.scene.builtin import envtex_texture

            px, kw = envtex_texture(256, 1), {"speed": 5, "quality": 60}
        elif i == 1:
            px, kw = pattern(128, 96, 78), {"tile_rows": 1, "tile_cols": 1, "quality": 40}
        data = _save(px, **kw)
        st = {}
        _, info = port_avif.avif_planes(data, "d", st)
        for k in port_avif.STAT_NAMES:  # the slice-24 tools: tests/test_torch_image_avif_seg_ibc.py
            if k not in ("segmented_blocks", "delta_q_superblocks", "intrabc_blocks"):
                seen[k] = seen.get(k, 0) + st[k]
        flags |= {k for k in ("lossless", "screen_content") if info[k]}
        flags |= {"tiles"} if info["tile_cols"] * info["tile_rows"] > 1 else set()
    assert all(v > 0 for v in seen.values()), seen
    assert flags == {"lossless", "screen_content", "tiles"}, flags


def test_writer_speeds_5_to_10():
    """Every speed of the slice on one image (the 2048^2 fixture holds the
    128x128 superblocks the writer picks for large images)."""
    px = pattern(40, 52, 9)
    for speed in range(5, 11):
        data = _save(px, speed=speed, quality=55)
        assert _agree(data) == "ok"
        _planes_equal_dav1d(data)


# ----------------------------------------------------- container edits ----

_BASE = None


def _base():
    global _BASE
    if _BASE is None:
        px = pattern(20, 30, 60)
        alpha = np.concatenate([px, pattern(20, 30, 61)[..., :1]], axis=-1)
        _BASE = Avif.parse(_save(px, quality=60)), Avif.parse(_save(alpha, quality=60))
    return _BASE


def _prop_index(a, typ, item=None):
    idx = [i for i, (t, _) in enumerate(a.props) if t == typ]
    if item is not None:
        idx = [i for i in idx if any(j == i + 1 for j, _ in a.assoc[item])]
    return idx[0]


def _drop(typ, item):
    def f(a):
        a.assoc[item] = [(i, e) for i, e in a.assoc[item] if a.props[i - 1][0] != typ]
    return f


def _add(typ, body, essential, item=1):
    def f(a):
        a.props.append((typ, body))
        a.assoc[item].append((len(a.props), essential))
    return f


def _set(typ, body):
    def f(a):
        a.props[_prop_index(a, typ)] = (typ, body)
    return f


def _nclx(cp, tc, mc, last):
    return b"nclx" + struct.pack(">HHHB", cp, tc, mc, last)


_EDITS = {
    "rebuilt": lambda a: None,
    "no_ispe": _drop(b"ispe", 1),
    "no_pixi": _drop(b"pixi", 1),
    "no_av1C": _drop(b"av1C", 1),
    "no_colr": _drop(b"colr", 1),
    "duplicate_ispe": lambda a: a.assoc[1].append((_prop_index(a, b"ispe") + 1, False)),
    "duplicate_colr_nclx": _add(b"colr", _nclx(1, 13, 1, 0), False),
    "nclx_and_icc": _add(b"colr", b"prof" + bytes(64), False),
    "nclx_reserved_bits": _set(b"colr", _nclx(1, 13, 6, 0x81)),
    "nclx_bt709_limited": _set(b"colr", _nclx(1, 1, 1, 0)),
    "nclx_bt2020_full": _set(b"colr", _nclx(9, 16, 9, 0x80)),
    "nclx_ycgco": _set(b"colr", _nclx(1, 13, 8, 0x80)),
    "nclx_identity_420": _set(b"colr", _nclx(1, 13, 0, 0x80)),
    "nclx_reserved_matrix": _set(b"colr", _nclx(1, 13, 3, 0x80)),
    "colr_short": _set(b"colr", b"nclx" + struct.pack(">HHH", 1, 13, 6)),
    "unknown_essential": _add(b"zzzz", b"\0\0\0\0", True),
    "unknown_not_essential": _add(b"zzzz", b"\0\0\0\0", False),
    "irot_essential": _add(b"irot", b"\x01", True),
    "irot_not_essential": _add(b"irot", b"\x01", False),
    "imir_not_essential": _add(b"imir", b"\x01", False),
    "clap_invalid": _add(b"clap", struct.pack(">8I", 40, 1, 10, 1, 0, 1, 0, 1), True),
    "clap_valid": _add(b"clap", struct.pack(">8I", 20, 1, 10, 1, 0, 1, 0, 1), True),
    "ispe_past_libavifs_size_limit": _set(b"ispe", b"\0" * 4 + struct.pack(">II", 20000, 20000)),
    "ispe_past_libavifs_dimension_limit": _set(b"ispe", b"\0" * 4 + struct.pack(">II", 40000, 8)),
    "ispe_past_pils_pixel_limit": _set(b"ispe", b"\0" * 4 + struct.pack(">II", 15000, 15000)),
    "pasp": _add(b"pasp", struct.pack(">II", 1, 1), True),
    "pixi_10bit": _set(b"pixi", b"\0" * 4 + bytes([3, 10, 10, 10])),
    "pixi_mixed": _set(b"pixi", b"\0" * 4 + bytes([3, 8, 9, 8])),
    "pixi_empty": _set(b"pixi", b"\0" * 4 + bytes([0])),
    "pixi_one_channel": _set(b"pixi", b"\0" * 4 + bytes([1, 8])),
    "ispe_version_1": _set(b"ispe", b"\x01\0\0\0" + struct.pack(">II", 30, 20)),
    "ispe_zero": _set(b"ispe", b"\0" * 4 + struct.pack(">II", 0, 20)),
    "av1C_version_2": _set(b"av1C", b"\x82\x00\x0c\x00"),
    "av1C_short": _set(b"av1C", b"\x81\x00\x0c"),
    "property_index_out_of_range": lambda a: a.assoc[1].append((40, False)),
    "iloc_in_idat": lambda a: a.in_idat.add(1),
    "iloc_version_2": lambda a: setattr(a, "iloc_version", 2),
    "pitm_version_1": lambda a: setattr(a, "pitm_version", 1),
    "no_pitm": lambda a: setattr(a, "primary", None),
    "primary_of_type_hvc1": lambda a: a.infe.__setitem__(0, (1, b"hvc1", a.infe[0][2], 0)),
    "hidden_primary": lambda a: a.infe.__setitem__(0, (1, b"av01", a.infe[0][2], 1)),
    "hdlr_vide": lambda a: setattr(a, "hdlr", b"\0" * 4 + b"vide" + b"\0" * 13),
    "hdlr_pre_defined": lambda a: setattr(a, "hdlr", b"\0\0\0\x05pict" + b"\0" * 13),
    "hdlr_name_unterminated": lambda a: setattr(a, "hdlr", b"\0" * 4 + b"pict" + b"\0" * 12
                                                + b"x"),
    "second_hdlr": lambda a: a.extra_meta.append((b"hdlr", a.hdlr)),
    "free_box_in_meta": lambda a: a.extra_meta.append((b"free", b"xx")),
    "ftyp_mif1_heic": lambda a: setattr(a, "ftyp", b"mif1\0\0\0\0mif1heic"),
    "ftyp_mif1_avif": lambda a: setattr(a, "ftyp", b"mif1\0\0\0\0mif1avif"),
    "ftyp_msf1_avif": lambda a: setattr(a, "ftyp", b"msf1\0\0\0\0avifmsf1"),
    "ftyp_avis_without_tracks": lambda a: setattr(a, "ftyp", b"avis\0\0\0\0avismsf1"),
    "exif_item": lambda a: (a.infe.append((5, b"Exif", b"\0", 0)),
                            a.items.__setitem__(5, b"\0\0\0\0MM\0*\0\0\0\x08\0\0"),
                            a.iref.append((b"cdsc", 5, [1]))),
    "exif_item_bad_offset": lambda a: (a.infe.append((5, b"Exif", b"\0", 0)),
                                       a.items.__setitem__(5, b"\0\0\0\x02MM\0*\0\0\0\x08\0\0"),
                                       a.iref.append((b"cdsc", 5, [1]))),
    "exif_item_short": lambda a: (a.infe.append((5, b"Exif", b"\0", 0)),
                                  a.items.__setitem__(5, b"\0\0"),
                                  a.iref.append((b"cdsc", 5, [1]))),
}
_ALPHA_EDITS = {
    "alpha_rebuilt": lambda a: None,
    "alpha_in_idat": lambda a: a.in_idat.add(2),
    "alpha_no_ispe": _drop(b"ispe", 2),
    "alpha_no_pixi": _drop(b"pixi", 2),
    "alpha_no_av1C": _drop(b"av1C", 2),
    "alpha_premultiplied": lambda a: a.iref.append((b"prem", 1, [2])),
    "alpha_other_auxC": lambda a: a.props.__setitem__(
        _prop_index(a, b"auxC"), (b"auxC", b"\0" * 4 + b"urn:example:depth\0")),
    "alpha_unknown_essential": _add(b"zzzz", b"\0\0\0\0", True, item=2),
}


@pytest.mark.parametrize("name", sorted(_EDITS))
def test_container_edits_read_as_pil_reads_them(name):
    a = copy.deepcopy(_base()[0])
    _EDITS[name](a)
    _agree(a.build())


@pytest.mark.parametrize("name", sorted(_ALPHA_EDITS))
def test_alpha_container_edits_read_as_pil_reads_them(name):
    a = copy.deepcopy(_base()[1])
    _ALPHA_EDITS[name](a)
    _agree(a.build())


def test_cut_files_read_as_pil_reads_them():
    """Cut in the mdat: PIL's open passes while the items fit in the file
    and its load fails; cut shorter, its open fails."""
    data = _base()[0].build()
    outcomes = {_agree(data[:n]) for n in range(len(data) - 1, 100, -7)}
    assert outcomes == {"next", "fail"}


def test_a_mif1_file_that_is_not_avif_goes_on_as_in_pil():
    a = copy.deepcopy(_base()[0])
    a.ftyp = b"mif1\0\0\0\0mif1heic"
    data = a.build()
    with pytest.raises(NextFormat, match="Invalid ftyp"):
        port_avif.decode_avif(data, "f")
    assert port_image._accepted(data)[0] == "AVIF"
    with pytest.raises(ValueError, match="unsupported image format.*PIL gives up on it"):
        port_image.decode_image(data)


def test_orientation_and_clean_aperture_leave_the_pixels():
    """PIL turns irot / imir into an EXIF orientation and leaves the pixels
    as decoded, and crops nothing to a clap; so does the port."""
    px = pattern(14, 22, 62)
    plain = port_image.decode_image(_save(px, quality=80))
    for orient in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = orient
        data = _save(px, exif=exif.tobytes(), quality=80)
        assert _agree(data) == "ok"
        np.testing.assert_array_equal(port_image.decode_image(data), plain)
    a = Avif.parse(_save(px, quality=80))
    _add(b"clap", struct.pack(">8I", 10, 1, 8, 1, 0, 1, 0, 1), True)(a)
    assert _agree(a.build()) == "ok"
    np.testing.assert_array_equal(port_image.decode_image(a.build()), plain)


# ----------------------------------------------------------- refusals -----

def test_speeds_0_to_4_read_as_pil():
    """PIL's writer turns on loop restoration at speeds 0-4 (Wiener,
    self-guided or switchable units); the port reads those frames as PIL
    and dav1d do."""
    px = pattern(64, 64, 63)
    restored = 0
    for speed in range(5):
        data = _save(px, speed=speed, quality=60)
        assert _agree(data) == "ok"
        info = _planes_equal_dav1d(data)
        restored += info["lr_types"] != 0
    assert restored >= 3


def test_a_resized_frame_is_refused_naming_it():
    """A frame whose size differs from its ispe: libavif scales it to the
    ispe (avifImageScale), and so does the port; one PIL reads as PIL does."""
    a = copy.deepcopy(_base()[0])
    a.props[_prop_index(a, b"ispe")] = (b"ispe", b"\0" * 4 + struct.pack(">II", 31, 20))
    data = a.build()
    assert _agree(data) == "ok"
    assert port_image.decode_image(data).shape == (20, 31, 3)


def test_a_grid_reads_as_pil():
    """A primary item of type grid: two 64x64 tiles of one PIL file, read
    as PIL reads it."""
    t = Avif.parse(_save(pattern(64, 64, 5), quality=60))  # a grid of two 64x64 tiles
    g = copy.deepcopy(t)
    g.infe = [(1, b"grid", b"\0", 0), (2, b"av01", b"\0", 1), (3, b"av01", b"\0", 1)]
    g.items = {1: bytes([0, 0, 0, 1]) + struct.pack(">HH", 128, 64), 2: t.items[1],
               3: t.items[1]}
    g.props.append((b"ispe", b"\0" * 4 + struct.pack(">II", 128, 64)))
    g.assoc = {1: [(len(g.props), False)], 2: t.assoc[1], 3: t.assoc[1]}
    g.iref = [(b"dimg", 1, [2, 3])]
    data = g.build()
    assert _pil(data)[1].shape == (64, 128, 3)
    assert _agree(data) == "ok"
    y, _, _ = port_avif.avif_planes(data)[0]
    np.testing.assert_array_equal(y[:, :64], y[:, 64:])  # one tile twice


def test_an_image_sequence_reads_frame_0_as_pil():
    """PIL's ``save_all`` writes an ``avis`` file with tracks, whose frame 0
    PIL reads (libavif's tracks source); so does the port."""
    b = io.BytesIO()
    Image.fromarray(pattern(16, 24, 1)).save(b, "AVIF", save_all=True,
                                             append_images=[Image.fromarray(pattern(16, 24, 2))])
    data = b.getvalue()
    assert data[8:12] == b"avis" and _pil(data)[0] == "ok"
    assert _agree(data) == "ok"
    assert port_avif.parse(data)[0].sequence


@pytest.mark.parametrize("seed", range(16))
def test_seeded_corruption_reads_as_pil_or_is_refused(seed):
    """Bytes changed in PIL-written files (nine in ten in the mdat): each
    read equals PIL's, or both fail, or the port refuses a tool outside it
    naming it (a corrupted header turning on superres, delta q, ...)."""
    r = np.random.default_rng(500 + seed)
    bases = [_save(pattern(int(r.integers(16, 80)), int(r.integers(16, 80)), 70 + k), **kw)
             for k, kw in enumerate([{"quality": 60}, {"quality": 90, "subsampling": "4:4:4"},
                                     {"quality": 30, "subsampling": "4:2:2"}, {"quality": 100},
                                     {"quality": 50, "subsampling": "4:0:0"}])]
    counts = {}
    for k in range(300):
        d = bytearray(bases[k % len(bases)])
        mdat = d.find(b"mdat") + 4
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(mdat, len(d))) if r.random() < 0.9 else int(r.integers(0, len(d)))
            d[pos] = int(r.integers(0, 256))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 120 and counts.get("fail", 0) > 20, counts


# ------------------------------------------------------- render, no PIL ---

def test_obj_map_kd_avif_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd``: an AVIF gives the texture
    tables and a 16x16 CPU render of the OBJ on a PNG of its pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    data = _save(pattern(24, 32, 19), quality=70)
    files = {"png": port_image.encode_png(port_image.decode_image(data)), "avif": data}
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = {}, {}
    for ext, blob in files.items():
        (tmp_path / f"albedo.{ext}").write_bytes(blob)
        (tmp_path / f"m_{ext}.mtl").write_text(
            f"newmtl ground\nKd 1 1 1\nmap_Kd albedo.{ext}\nnewmtl lamp\nKe 40 35 30\n")
        (tmp_path / f"m_{ext}.obj").write_text(f"mtllib m_{ext}.mtl\n" + obj)
        scene = Scene(shapes=[load_obj(str(tmp_path / f"m_{ext}.obj"))]).compile(
            intersector="dense", device="cpu")
        tables[ext] = scene.textures.images.numpy()
        frames[ext] = render(scene, cam, PathConfig(spp=4, max_depth=3)).numpy()
    assert frames["png"].mean() > 0.01 and np.isfinite(frames["png"]).all()
    np.testing.assert_array_equal(tables["avif"], tables["png"])
    np.testing.assert_array_equal(frames["avif"], frames["png"])


def test_avif_fixtures_need_no_pil():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('avif_q75_420_61x47.avif', 'avif_rgba_premultiplied_30x20.avif',\n"
            "          'avif_nclx_fcc_26x18.avif'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, AVIF_OUT], capture_output=True, text=True,
                         check=True, cwd=root, timeout=120)
    assert out.stdout.split("\n")[:4] == ["(47, 61, 3)", "(20, 30, 3)", "(18, 26, 3)", "[]"]
