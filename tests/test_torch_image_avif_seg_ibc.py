"""Port parity: the AVIF forms of slice 24 in the PIL-free decoder
(akari_torch/core/avif.py with akari_torch/native/av1_decode.cpp) against
PIL 12.1.0, which reads AVIF through its bundled libavif 1.3.0 (dav1d 1.5.1
decoding, libyuv scaling and converting) and through which the JAX
package's ``read_image`` reads it.

Tolerance: exact. Every read equals PIL's ``convert("RGB")`` (and its mode),
every plane dav1d's, and what PIL refuses the port refuses:

- the CDFs this slice added to ``akari_torch/native/av1_tables.h``
  (segment ids, delta q / lf, intra block copy, its vector, the transform
  split tree and the inter transform sets) hold the specification's values;
- the fixtures of PIL's writer's ``advanced`` options (``deltaq-mode``,
  ``delta-lf-mode``, ``tune-content=screen`` at 4:2:0 / 4:2:2 / 4:4:4 /
  4:0:0, ``aq-mode=1`` sequences at speeds 0, 4 and 6), the 512 x 384
  files of those options, and seeded drawn cases written in a subprocess
  (aom can crash the writer), each equal to PIL, to the JAX package's
  ``read_image`` and to dav1d, their counters showing the tool in use;
- libavif's scaling of a frame, an alpha plane or a track to its item's
  ``ispe`` or its ``tkhd`` (libyuv's ScalePlane, each of its routes held to
  ``avifImageScale`` through ctypes), and the nclx matrix 12 (kr, kb from
  the primaries) held to ``avifImageYUVToRGB``;
- seeded corruption of the tool-bearing files; the forms still out of
  scope (palettes at 10 and 12 bits, switch frames, frame ids on an inter
  frame, a hidden key frame no later frame may show) refused naming them.

No 2048^2 file is decoded here (``tests/test_torch_image_avif.py`` holds
every fixture to its digest, the 2048^2 albedos among them).
"""

import copy
import functools
import os
import struct

import numpy as np
import pytest

from akari_torch.core import avif as port_avif
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tests import _avif_oracle as oracle
from tests.test_torch_image_avif import (OUT_OF_SCOPE, _agree, _base, _pil, _planes_equal_dav1d,
                                         _prop_index, _save)
from tests.test_torch_image_avif_tools import _sequence, _set
from tools import extract_av1_tables as xt
from tools.avif_writers import Avif, Sequence
from tools.make_torch_port_image_fixtures import AVIF_OUT, _avif, glyphs, pattern

COUNTS = ("segmented_blocks", "delta_q_superblocks", "intrabc_blocks")
# fixture -> (its header flag, its counter)
FIXTURES = {
    "avif_deltaq_q60_128x96.avif": ("delta_q", "delta_q_superblocks"),
    "avif_deltaq_deltalf_q60_160x120.avif": ("delta_lf", "delta_q_superblocks"),
    "avif_intrabc_screen_160x120.avif": ("intrabc", "intrabc_blocks"),
    "avif_intrabc_screen_422_160x120.avif": ("intrabc", "intrabc_blocks"),
    "avif_intrabc_screen_444_160x120.avif": ("intrabc", "intrabc_blocks"),
    "avif_intrabc_screen_400_160x120.avif": ("intrabc", "intrabc_blocks"),
    "avis_aq1_s0_96x72.avif": ("segmentation", "segmented_blocks"),
    "avis_aq1_s4_128x96.avif": ("segmentation", "segmented_blocks"),
    "avis_aq1_s6_128x96.avif": ("segmentation", "segmented_blocks"),
}


def _same_everywhere(data, tmp_path, name):
    """PIL, the JAX package's read_image and dav1d's planes; the counters."""
    assert _agree(data) == "ok"
    _planes_equal_dav1d(data)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(port_image.read_image(path), ref_image.read_image(path))
    st = {}
    _, info = port_avif.avif_planes(data, name, st)
    return info, st


# ------------------------------------------------------------ tables -------

def test_slice_24_tables_hold_the_specifications_values():
    t = {k: v[0].astype(np.int64) for k, v in xt.tables().items()}
    inv = lambda *v: [32768 - x for x in v]  # noqa: E731
    assert t["seg_id"][0][:7].tolist() == inv(5622, 7893, 16093, 18233, 27809, 28373, 32533)
    assert t["seg_id"][2][:7].tolist() == inv(27527, 28487, 28723, 28890, 32397, 32647, 32679)
    assert t["delta_q"][:3].tolist() == inv(28160, 32120, 32677)
    assert (t["delta_lf"][:, :3] == t["delta_q"][:3]).all()
    assert t["intrabc"][0] == 32768 - 30531
    assert t["inter_tx_set1"][0][:4].tolist() == inv(4458, 5560, 7695, 9709)
    assert t["inter_tx_set1"][1][:4].tolist() == inv(1645, 2573, 4778, 5711)
    assert t["inter_tx_set2"][:11].tolist() == inv(770, 2421, 5225, 12907, 15819, 18927, 21561,
                                                   24089, 26595, 28526, 30529)
    assert t["inter_tx_set3"][:, 0].tolist() == inv(16384, 4167, 1998, 748)
    assert t["txfm_split"].reshape(21, 2)[:3, 0].tolist() == inv(28581, 23846, 20847)
    assert t["mv_joint"][:3].tolist() == inv(4096, 11264, 19328)
    assert t["mv_classes"][:10].tolist() == inv(28672, 30976, 31858, 32320, 32551, 32656, 32740,
                                                32757, 32762, 32767)
    assert t["mv_sign"][0] == 16384 and t["mv_class0"][0] == 32768 - 216 * 128
    assert t["mv_bits"][:, 0].tolist() == inv(*[128 * v for v in (136, 140, 148, 160, 176, 192,
                                                                     224, 234, 234, 240)])


# ---------------------------------------------------------- fixtures -------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_uses_its_tool_and_reads_as_pil_jax_and_dav1d(name, tmp_path):
    with open(os.path.join(AVIF_OUT, name), "rb") as f:
        data = f.read()
    info, st = _same_everywhere(data, tmp_path, name)
    flag, count = FIXTURES[name]
    assert info[flag] and st[count] > 0, (info, st)
    if name.startswith("avis"):
        assert port_avif.parse(data)[0].sequence


def _motivation(case):
    px, g = pattern(384, 512, 1), glyphs(384, 512, 1)
    two = [px, px[::-1].copy()]
    return {
        "deltaq": (px, {"quality": 60, "advanced": {"deltaq-mode": "3"}}),
        "deltaq_deltalf": (px, {"quality": 60,
                                "advanced": {"deltaq-mode": "3", "delta-lf-mode": "1"}}),
        "screen": (g, {"advanced": {"tune-content": "screen"}}),
        "screen_intrabc": (g, {"advanced": {"tune-content": "screen", "enable-intrabc": "1"}}),
        "aq1_s4": (two, {"save_all": True, "quality": 60, "speed": 4,
                         "advanced": {"aq-mode": "1"}}),
        "aq1_s6": (two, {"save_all": True, "quality": 60, "speed": 6,
                         "advanced": {"aq-mode": "1"}}),
    }[case]


@pytest.mark.parametrize("case", ["deltaq", "deltaq_deltalf", "screen", "screen_intrabc",
                                  "aq1_s4", "aq1_s6"])
def test_512x384_files_of_the_writers_advanced_options_read_as_pil(case, tmp_path):
    """The files the port refused before this slice (the speed-0 sequence,
    a minute to write at this size, is the 96 x 72 fixture's)."""
    px, kw = _motivation(case)
    data = _avif(px, **kw)
    info, st = _same_everywhere(data, tmp_path, case + ".avif")
    tool = {"deltaq": "delta_q_superblocks", "deltaq_deltalf": "delta_q_superblocks",
            "screen": "intrabc_blocks", "screen_intrabc": "intrabc_blocks"}.get(case,
                                                                               "segmented_blocks")
    assert st[tool] > 0, st
    assert case != "deltaq_deltalf" or info["delta_lf"]


# -------------------------------------------------------- drawn cases ------

@functools.lru_cache(maxsize=None)
def _drawn(seed):
    """A seeded file of the writer's advanced options (the next draw where
    the writer crashes): delta q (with delta lf), screen content, two-frame
    aq-mode sequences, or all of them."""
    r = np.random.default_rng(2400 + seed)
    while True:
        kind = seed % 4
        h, w = int(r.integers(96, 145)), int(r.integers(128, 193))
        kw = {"quality": int(r.integers(30, 81)),
              "subsampling": str(r.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
              "range": str(r.choice(["full", "limited"])), "speed": int(r.choice([4, 6, 8]))}
        if kind == 0:
            px, adv = pattern(h, w, seed), {"deltaq-mode": "3"}
            if r.random() < 0.5:
                adv["delta-lf-mode"] = "1"
        elif kind == 1:
            px, adv = glyphs(max(h, 120), max(w, 160), seed), {"tune-content": "screen"}
            if r.random() < 0.5:
                adv["enable-intrabc"] = "1"
        elif kind == 2:
            from akari_torch.scene.builtin import envtex_texture

            t = envtex_texture(256, seed % 4)[:h, :w].copy()
            px, adv = [t, t[::-1].copy()], {"aq-mode": "1"}
            kw["save_all"] = True
        else:
            px = glyphs(max(h, 120), max(w, 160), seed)
            adv = {"deltaq-mode": "3", "aq-mode": "1", "tune-content": "screen"}
        data = _avif(px, advanced=adv, **kw)
        if data is not None:
            return data


@pytest.mark.parametrize("seed", range(8))
def test_drawn_files_read_as_pil_jax_and_dav1d(seed, tmp_path):
    _same_everywhere(_drawn(seed), tmp_path, f"d{seed}.avif")


def test_drawn_files_use_every_tool():
    seen = {k: 0 for k in COUNTS}
    for seed in range(8):
        st = {}
        port_avif.avif_planes(_drawn(seed), "d", st)
        for k in COUNTS:
            seen[k] += st[k]
    assert all(v > 0 for v in seen.values()), seen


# ------------------------------------------------------------ scaling ------

ROUTES = {  # (src w, h) -> (dst w, h) pairs taking each of ScalePlane's routes
    "vertical": [(40, 30, 40, 47), (37, 45, 37, 15), (64, 9, 64, 8)],
    "down34": [(48, 32, 36, 24), (64, 40, 48, 30), (128, 12, 96, 9)],
    "down2": [(40, 30, 20, 15), (66, 34, 33, 17)],
    "down38": [(48, 40, 18, 15), (64, 16, 24, 6), (16, 24, 6, 9)],
    "down4": [(64, 48, 16, 12), (36, 20, 9, 5)],
    "box": [(90, 70, 20, 11), (131, 97, 30, 7), (61, 300, 13, 29)],
    "up2_linear": [(20, 15, 40, 15), (21, 9, 41, 3)],
    "up2_bilinear": [(20, 15, 40, 30), (21, 9, 41, 17)],
    "bilinear_up": [(30, 20, 47, 35), (41, 13, 33, 29), (5, 7, 130, 9)],
    "bilinear_down": [(47, 35, 30, 20), (33, 29, 41, 17), (100, 3, 61, 2)],
    "simple": [(30, 1, 45, 2), (1, 20, 7, 11), (60, 30, 20, 10)],
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scale_plane_is_libavifs(route):
    """Each plane of a 4:2:0 / 4:2:2 / 4:4:4 / 4:0:0 image with alpha, as
    avifImageScale scales it."""
    r = np.random.default_rng(len(route))
    for k, (sw, sh, dw, dh) in enumerate(ROUTES[route]):
        fmt = ("420", "422", "444", "400")[k % 4]
        ssx, ssy = {"420": (1, 1), "422": (1, 0)}.get(fmt, (0, 0))
        planes = [r.integers(0, 256, (sh, sw), dtype=np.uint8)]
        if fmt != "400":
            planes += [r.integers(0, 256, ((sh + ssy) >> ssy, (sw + ssx) >> ssx),
                                  dtype=np.uint8) for _ in range(2)]
        planes.append(r.integers(0, 256, (sh, sw), dtype=np.uint8))
        res, ref = oracle.libavif_scale(planes, fmt, sw, sh, dw, dh)
        assert res == 0
        for p, (src, want) in enumerate(zip(planes, ref)):
            got = port_avif.scale_plane(src, want.shape[1], want.shape[0])
            np.testing.assert_array_equal(got, want, err_msg=f"{(sw, sh, dw, dh)} plane {p}")


def test_scale_plane_on_drawn_sizes_is_libavifs():
    r = np.random.default_rng(24)
    oracle.check_scale_layout()
    for _ in range(60):
        sw, sh, dw, dh = (int(v) for v in r.integers(1, 160, 4))
        src = r.integers(0, 256, (sh, sw), dtype=np.uint8)
        res, ref = oracle.libavif_scale([src], "400", sw, sh, dw, dh)
        assert res == 0
        np.testing.assert_array_equal(port_avif.scale_plane(src, dw, dh), ref[0],
                                      err_msg=str((sw, sh, dw, dh)))


def _ispe(w, h):
    return b"\0" * 4 + struct.pack(">II", w, h)


def _own_ispe(a, item, w, h):
    a.props.append((b"ispe", _ispe(w, h)))
    k = len(a.props)
    a.assoc[item] = [(k, e) if a.props[i - 1][0] == b"ispe" else (i, e) for i, e in a.assoc[item]]


@pytest.mark.parametrize("size", [(31, 20), (60, 40), (15, 10), (22, 15), (1, 1), (30, 7),
                                  (121, 83)])
def test_a_frame_scaled_to_its_ispe_reads_as_pil(size):
    """The colour (30 x 20) and, with alpha sharing its ispe, the alpha."""
    for base in _base():
        a = copy.deepcopy(base)
        a.props[_prop_index(a, b"ispe")] = (b"ispe", _ispe(*size))
        data = a.build()
        assert _agree(data) == "ok"
        assert port_image.decode_image(data).shape == (size[1], size[0], 3)


def test_alpha_scaled_to_its_own_ispe_reads_as_pil():
    """An alpha item with an ispe of its own: scaled to it; a size then not
    the colour's fails the decode in both. An alpha frame of another size
    than its ispe (the colour's): scaled to the colour's size."""
    rgba = _base()[1]
    alpha = next(i for i, *_ in rgba.infe if i != rgba.primary)
    for size in ((31, 20), (15, 10)):
        a = copy.deepcopy(rgba)
        _own_ispe(a, alpha, *size)
        assert _agree(a.build()) == "fail"
    small = Avif.parse(_save(np.concatenate([pattern(10, 15, 3), pattern(10, 15, 4)[..., :1]],
                                            axis=-1), quality=60))
    for other in (small, Avif.parse(_save(np.concatenate(
            [pattern(33, 41, 3), pattern(33, 41, 4)[..., :1]], axis=-1), quality=60))):
        a = copy.deepcopy(rgba)
        a.items[alpha] = other.items[next(i for i, *_ in other.infe if i != other.primary)]
        data = a.build()
        assert _agree(data) == "ok"
        assert _pil(data)[2] == "RGBA"


@pytest.mark.parametrize("alpha", [False, True])
def test_a_track_scaled_to_its_tkhd_reads_as_pil(alpha):
    """Frames of 24 x 17 in tracks whose tkhd says another size (the alpha
    track's too where there is one)."""
    for w, h in ((48, 34), (13, 9), (24, 40)):
        s = Sequence(_sequence(2, alpha))
        for k in range(2 if alpha else 1):
            _set((), b"tkhd", ">II", 88, w << 16, h << 16, k=k)(s)
        data = s.build()
        assert _agree(data) == "ok"
        assert port_image.decode_image(data).shape == (h, w, 3)


# --------------------------------------------------------- nclx matrix 12 --

def test_chroma_derived_primaries_are_libavifs():
    import ctypes

    lib = oracle.lib()
    lib.avifColorPrimariesGetValues.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for cp in range(256):
        want = (ctypes.c_float * 8)()
        lib.avifColorPrimariesGetValues(cp, want)
        got = np.float32(port_avif._PRIMARIES.get(cp, port_avif._PRIMARIES[1]))
        assert (got == np.float32(list(want))).all(), cp


@pytest.mark.parametrize("cp", [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22, 200])
def test_chroma_derived_matrix_converts_as_libavif(cp):
    """Every subsampling, both ranges, with and without alpha."""
    r = np.random.default_rng(cp)
    for fmt, full, alpha in (("444", 1, False), ("420", 0, False), ("422", 1, True),
                             ("400", 0, True), ("400", 1, False), ("444", 0, True),
                             ("420", 1, True)):
        h, w = 13, 17
        ssx, ssy = {"444": (0, 0), "422": (1, 0)}.get(fmt, (1, 1))
        y = r.integers(0, 256, (h, w), dtype=np.uint8)
        u, v = (r.integers(0, 256, ((h + ssy) >> ssy, (w + ssx) >> ssx), dtype=np.uint8)
                for _ in range(2))
        al = r.integers(0, 256, (h, w), dtype=np.uint8) if alpha else None
        res, want = oracle.libavif_rgb(y, u, v, fmt, full, 12, primaries=cp, alpha=al)
        assert res == 0
        mono = fmt == "400"
        got = port_avif.yuv_to_rgb(y, u, v, mono, 0 if mono else ssx, 0 if mono else ssy, 12, full,
                                   cp, alpha)
        np.testing.assert_array_equal(got, want[..., :3], err_msg=f"{fmt} {full} {alpha}")


@pytest.mark.parametrize("cp", [1, 4, 9, 12])
def test_a_file_of_nclx_matrix_12_reads_as_pil(cp):
    a = copy.deepcopy(_base()[0])
    a.props = [(t, b"nclx" + struct.pack(">HHHB", cp, 13, 12, 0x80))
               if t == b"colr" and b[:4] == b"nclx" else (t, b) for t, b in a.props]
    assert _agree(a.build()) == "ok"


# ------------------------------------------------ corruption, refusals ----

@pytest.mark.parametrize("seed", range(3))
def test_seeded_corruption_of_tool_files_reads_as_pil_or_is_refused(seed):
    """Bytes changed in the tool fixtures (nine in ten in the mdat): each read
    equals PIL's, or both fail, or the port refuses a form still out of
    scope naming it."""
    r = np.random.default_rng(2424 + seed)
    bases = []
    for name in ("avif_deltaq_deltalf_q60_160x120.avif", "avif_intrabc_screen_160x120.avif",
                 "avis_aq1_s6_128x96.avif"):
        with open(os.path.join(AVIF_OUT, name), "rb") as f:
            bases.append(f.read())
    counts = {}
    for k in range(60):
        d = bytearray(bases[k % len(bases)])
        mdat = d.find(b"mdat") + 4
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(mdat, len(d))) if r.random() < 0.9 else int(r.integers(0, len(d)))
            d[pos] = int(r.integers(0, 256))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 15, counts


def test_an_essential_property_index_0_goes_on_as_in_pil():
    """An ipma association of property index 0 marked essential (found by
    corrupting a tool fixture): libavif's parse fails and PIL's open goes on
    to the next format; without the essential bit it is skipped."""
    for base in _base():
        for essential in (0x80, 0):
            a = copy.deepcopy(base)
            a.assoc[a.primary] = a.assoc[a.primary] + [(0, bool(essential))]
            assert _agree(a.build()) == ("next" if essential else "ok")


class _Bits:
    def __init__(self):
        self.bits = []

    def f(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def obu(self, typ, pad=0):
        bits = self.bits + [0] * pad + [1]
        bits += [0] * (-len(bits) % 8)
        body = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
        return bytes([(typ << 3) | 2, len(body)]) + body


def _headers(form, width=64):
    """A sequence header and a frame header OBU turning on ``form``."""
    reduced = form in ("bit10", "bit12", "superres", "wide")
    depth = {"bit10": 10, "bit12": 12}.get(form, 8)
    profile = 2 if depth == 12 else 0
    s = _Bits()
    s.f(3, profile)
    s.f(1, int(reduced))
    s.f(1, int(reduced))
    if reduced:
        s.f(5, 0)
    else:
        s.f(1, 0)   # timing info
        s.f(1, 0)   # initial display delay
        s.f(5, 0)   # one operating point
        s.f(12, 0)
        s.f(5, 0)
    s.f(4, 15)
    s.f(4, 15)
    s.f(16, width - 1)
    s.f(16, 63)
    if not reduced:
        s.f(1, int(form == "frame_ids"))   # frame ids
        if form == "frame_ids":
            s.f(4, 5)   # delta_frame_id_length_minus_2
            s.f(3, 2)   # additional_frame_id_length_minus_1
    s.f(3, 0)       # 64x64 superblocks, no filter intra or edge filter
    if not reduced:
        s.f(4, 0)
        s.f(1, 0)   # order hints
        s.f(1, 1)   # screen content tools: chosen per frame
        s.f(1, 1)   # integer mv: chosen per frame
    s.f(1, int(form == "superres"))
    s.f(2, 0)       # CDEF, restoration
    s.f(1, int(depth > 8))
    if profile == 2:
        s.f(1, 1)   # twelve bit
    s.f(1, 0)       # not monochrome
    s.f(1, 0)       # no colour description
    s.f(1, 0)       # studio range
    if profile == 2:
        s.f(2, 3)   # 4:2:0
    s.f(2, 0)       # chroma sample position
    s.f(2, 0)       # separate uv delta q, film grain
    f = _Bits()
    if not reduced:
        f.f(1, 0)                            # show_existing_frame
        f.f(2, {"frame_ids": 1, "switch": 3}.get(form, 0))   # frame type
        f.f(1, int(form != "hidden"))        # show_frame
    f.f(2, 0)       # disable_cdf_update, allow_screen_content_tools
    if not reduced:
        f.f(1, 0)   # frame size override
    if form == "superres":
        f.f(1, 1)
    if form == "wide":
        f.f(2, 1)   # the render size, uniform tiles; zeros after
    return s.obu(1) + f.obu(3, pad=64)


def _out_of_scope(form):
    """The AV1 data of ``form``: crafted headers, or a header rewrite of a
    fixture (``tools/av1_rewrite.py``): a palette at 10 or 12 bits."""
    from tools.av1_rewrite import to_high_bitdepth

    if form in ("bit10", "bit12"):
        with open(os.path.join(AVIF_OUT, "avif_palette_screen_128x96.avif"), "rb") as f:
            data = to_high_bitdepth(f.read(), int(form[3:]), screen_content_ok=True)
    else:
        return _headers(form)
    c, item, _, _ = port_avif.parse(data)
    return c.item_data(item)


@pytest.mark.parametrize("form,words", [("bit10", "palette at a bit depth of 10"),
                                        ("bit12", "palette at a bit depth of 12"),
                                        ("switch", "switch frame"),
                                        ("frame_ids", "frame ids"), ("hidden", "hidden")])
def test_forms_still_out_of_scope_are_refused_naming_them(form, words):
    with pytest.raises(ValueError, match=words) as e:
        port_avif._decode_planes(_out_of_scope(form), "x")
    assert any(t in str(e.value) for t in OUT_OF_SCOPE)


def test_a_frame_over_16384_wide_is_not_scaled():
    """libavif's avifImageScale refuses a source side over 16384; the port
    refuses it before decoding a plane."""
    with pytest.raises(ValueError, match="does not scale an AV1 frame of 16385 x 64"):
        port_avif._decode_planes(_headers("wide", 16385), "x", size=(100, 64))
