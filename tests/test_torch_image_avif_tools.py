"""Port parity: the AVIF forms of slice 23 in the PIL-free decoder
(akari_torch/core/avif.py with akari_torch/native/av1_decode.cpp) against
PIL 12.1.0, which reads AVIF through its bundled libavif 1.3.0 (dav1d 1.5.1
decoding) and through which the JAX package's ``read_image`` reads it.

Tolerance: exact. Every read equals PIL's ``convert("RGB")`` (and its mode),
every plane dav1d's with the film grain applied, and what PIL refuses the
port refuses (``NextFormat`` where PIL's open gives up, ``ValueError``
otherwise):

- the tables this slice added to ``akari_torch/native/av1_tables.h``
  (loop-restoration CDFs, self-guided parameters, ``x_by_x``, quantizer
  matrices, the Gaussian sequence) hold the specification's values;
- files drawn from seeds through PIL's writer with CDEF, quantizer
  matrices, film grain (the denoiser's and aom's sixteen test vectors) and
  loop restoration (speeds 0-4), alone and together, at 4:2:0 / 4:2:2 /
  4:4:4 / 4:0:0, both ranges, RGBA with and without premultiplied alpha,
  odd sizes, also through the JAX package's ``read_image``;
- seeded corruption of tool-bearing files;
- ``avis`` sequences of 1-3 frames with and without alpha (frame 0, as
  libavif's tracks source reads it), edits to their ``moov`` and seeded
  corruption of their boxes;
- ``grid`` primaries (and grid alpha) of 1 x 2 to 3 x 2 tiles cropped to
  their output size, and the grids libavif refuses;
- a 16x16 config-3 ``map_Kd`` render of a tools AVIF equal to the PNG
  route of its pixels.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import avif as port_avif
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tests.test_torch_image_avif import _agree, _pil, _planes_equal_dav1d, _port, _save
from tools import extract_av1_tables as xt
from tools.avif_writers import Sequence, find, grid
from tools.make_torch_port_image_fixtures import pattern

TOOLS = {"cdef": {"enable-cdef": "1"}, "qm": {"enable-qm": "1"},
         "grain": {"denoise-noise-level": "10"}}
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")


def _tex(h, w, seed=0):
    """A cut of the config-3 albedo's texture: edges CDEF and the
    restoration filters act on, flat areas the grain denoiser models."""
    from akari_torch.scene.builtin import envtex_texture

    t = envtex_texture(256, seed % 4)
    y, x = (seed * 37) % (256 - h + 1), (seed * 53) % (256 - w + 1)
    return np.ascontiguousarray(t[y:y + h, x:x + w])


def _same_as_jax(data, tmp_path, name):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(port_image.read_image(path), ref_image.read_image(path))


# ------------------------------------------------------------ tables -------

def test_restoration_grain_and_qm_tables_hold_the_specifications_values():
    t = {k: v[0] for k, v in xt.tables().items()}
    assert t["use_wiener"][0] == 32768 - 11570 and t["use_sgrproj"][0] == 32768 - 16855
    assert t["restoration_type"][:2].tolist() == [32768 - 9413, 32768 - 22581]
    assert t["sgr_params"][0].tolist() == [2, 140, 1, 3236]
    assert t["sgr_params"][10].tolist() == [0, 0, 2 - 1, 2589]
    assert t["sgr_params"][15].tolist() == [2, 22, 0, 0]
    # x_by_x: 256 - ((z << 8) + z / 2) / (z + 1), 255 at z = 0 and 0 past 255
    z = np.arange(1, 255)
    assert (t["sgr_x_by_x"][1:255] == 256 - ((z << 8) + z // 2) // (z + 1)).all()
    assert t["sgr_x_by_x"][0] == 255 and t["sgr_x_by_x"][255] == 0
    assert t["gaussian_sequence"][:8].tolist() == [56, 568, -180, 172, 124, -84, 172, -64]
    assert t["gaussian_sequence"].shape == (2048,)
    # Quantizer_Matrix[0][0] (4x4 luma) and [14][1]'s start, as the specification prints them
    assert t["qm"][0, 0, :16].tolist() == [32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150,
                                           97, 110, 150, 200]
    assert t["qm"].shape == (15, 2, 3344) and (t["qm"][14, 1, :16] == 31).all()


# --------------------------------------------------------- drawn cases ----

def _drawn_tools(r):
    """A seeded image and writer options with a random set of the tools."""
    h, w = int(r.integers(1, 97)), int(r.integers(1, 97))
    px = _tex(h, w, int(r.integers(0, 1 << 20))) if r.random() < 0.7 else \
        pattern(h, w, int(r.integers(1 << 30)))
    names = [k for k in TOOLS if r.random() < 0.5] or [str(r.choice(list(TOOLS)))]
    adv = {k: v for n in names for k, v in TOOLS[n].items()}
    if "grain" in names and r.random() < 0.5:
        del adv["denoise-noise-level"]
        adv["film-grain-test"] = str(int(r.integers(1, 17)))
    kw = {"quality": int(r.choice([10, 30, 50, 70, 90])), "speed": int(r.integers(2, 7)),
          "subsampling": str(r.choice(SUBSAMPLINGS)), "range": str(r.choice(["full", "limited"])),
          "advanced": adv}
    if r.random() < 0.25:
        a = _tex(h, w, 99)[..., 0] if r.random() < 0.5 else np.full((h, w), 180, np.uint8)
        px = np.concatenate([px, a[..., None]], axis=-1)
        kw["alpha_premultiplied"] = bool(r.random() < 0.5)
    return px, kw


@pytest.mark.parametrize("seed", range(12))
def test_drawn_tool_files_read_as_pil_jax_and_dav1d(seed, tmp_path):
    r = np.random.default_rng(2300 + seed)
    for i in range(4):
        px, kw = _drawn_tools(r)
        data = _save(px, **kw)
        out = _agree(data)
        if out == "fail":  # aom can write a stream dav1d refuses (4:0:0 grain with tiles)
            continue
        assert out == "ok", kw
        _planes_equal_dav1d(data)
        if i == 0:
            _same_as_jax(data, tmp_path, f"d{i}.avif")


def test_drawn_tool_files_use_every_tool():
    """Over a drawn set: CDEF strengths that change pixels, quantizer
    matrices, film grain on every plane, and Wiener and self-guided
    restoration units."""
    r = np.random.default_rng(2399)
    seen = {"cdef": 0, "qm": 0, "grain": 0, "wiener": 0, "sgrproj": 0}
    for i in range(14):
        px, kw = _drawn_tools(r)
        if i == 0:  # speed 1 on the waves: Wiener units
            px, kw = pattern(72, 96, 7), {"quality": 30, "speed": 1, "subsampling": "4:4:4"}
        elif i < 4:  # speeds 1-3 on the albedo's texture: self-guided units
            px, kw = _tex(48, 64, 0), {"quality": 70, "speed": i, "subsampling": "4:4:4"}
        data = _save(px, **kw)
        fl = {}
        try:
            _, info = port_avif.avif_planes(data, filters=fl)
        except ValueError:
            continue
        seen["cdef"] += fl["cdef_blocks"] > 0
        seen["qm"] += info["qm_levels"] != 0xFFF
        seen["grain"] += fl["grain_planes"] > 0
        types = [(info["lr_types"] >> (2 * p)) & 3 for p in range(3)]
        seen["wiener"] += 1 in types
        seen["sgrproj"] += 2 in types
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("vector", range(1, 17))
def test_aoms_film_grain_test_vectors_read_as_pil(vector):
    """aom's film-grain test vectors 1-16 (every AR lag, chroma scaling
    from luma, overlap, clipping to the restricted range, offsets and
    multipliers), on each subsampling in turn: the grain is dav1d's."""
    sub = SUBSAMPLINGS[vector % 4]
    h, w = (67, 93) if sub == "4:2:0" else (35, 66)
    data = _save(_tex(h, w, vector), quality=50, subsampling=sub,
                 advanced={"film-grain-test": str(vector)})
    assert _agree(data) == "ok"
    assert _planes_equal_dav1d(data)["film_grain"]


def test_speeds_0_and_1_with_every_tool_read_as_pil(tmp_path):
    for speed, sub in ((0, "4:2:0"), (1, "4:4:4")):
        data = _save(_tex(48, 64, speed), quality=40, speed=speed, subsampling=sub,
                     advanced={"enable-cdef": "1", "enable-qm": "1", "denoise-noise-level": "20"})
        assert _agree(data) == "ok"
        _planes_equal_dav1d(data)
    _same_as_jax(data, tmp_path, "s1.avif")


@pytest.mark.parametrize("seed", range(4))
def test_seeded_corruption_of_tool_files_reads_as_pil_or_is_refused(seed):
    """Bytes changed anywhere in tool-bearing files: each read equals PIL's,
    or both fail, or the port refuses a form still out of scope naming it."""
    r = np.random.default_rng(2350 + seed)
    bases = [_save(_tex(40, 56, k), quality=40, speed=2 + k % 3, subsampling=SUBSAMPLINGS[k],
                   advanced={"enable-cdef": "1", "enable-qm": "1", "denoise-noise-level": "10"})
             for k in range(4)]
    counts = {}
    for k in range(100):
        d = bytearray(bases[k % len(bases)])
        for _ in range(int(r.integers(1, 4))):
            d[int(r.integers(0, len(d)))] = int(r.integers(0, 256))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 15 and counts.get("fail", 0) > 10, counts


# --------------------------------------------------------- sequences ------

def _sequence(n, alpha, h=17, w=24, **kw):
    ims = [pattern(h, w, 80 + i) for i in range(n)]
    if alpha:
        ims = [np.concatenate([im, pattern(h, w, 90 + i)[..., :1]], -1)
               for i, im in enumerate(ims)]
    b = io.BytesIO()
    Image.fromarray(ims[0]).save(b, "AVIF", save_all=True,
                                 append_images=[Image.fromarray(x) for x in ims[1:]], **kw)
    return b.getvalue()


@pytest.mark.parametrize("n,alpha", [(1, False), (1, True), (2, False), (2, True), (3, False),
                                     (3, True)])
def test_sequences_read_frame_0_as_pil(n, alpha):
    data = _sequence(n, alpha)
    assert (data[8:12] == b"avis") == (n > 1)
    assert _agree(data) == "ok"
    c, item, a, _ = port_avif.parse(data)
    assert c.sequence == (n > 1) and (a is not None) == alpha


def test_a_sequence_with_the_tools_reads_frame_0_as_pil():
    data = _sequence(2, False, 48, 64, speed=3, advanced={"enable-cdef": "1", "enable-qm": "1",
                                                          "denoise-noise-level": "10"})
    assert _agree(data) == "ok"


def _stbl(s, k=0):
    return find(find(s.moov(), b"trak", index=k)[1], b"mdia", b"minf", b"stbl")[1]


def _node(nodes, t):
    return next(n for n in nodes if n[0] == t)


def _patch(body, fmt, off, *v):
    b = bytearray(body)
    struct.pack_into(fmt, b, off, *v)
    return bytes(b)


def _drop(path, typ, k=0):
    def f(s):
        nodes = find(s.moov(), b"trak", index=k)[1]
        for p in path:
            nodes = _node(nodes, p)[1]
        nodes[:] = [n for n in nodes if n[0] != typ]
    return f


def _stsc_two_chunks(s):  # 3 samples: chunk 1 holds one, chunk 2 two
    st = _stbl(s)
    off = struct.unpack_from(">I", _node(st, b"stco")[1], 8)[0]
    sizes = struct.unpack_from(">3I", _node(st, b"stsz")[1], 12)
    _node(st, b"stco")[1] = _node(st, b"stco")[1][:4] + struct.pack(">III", 2, off, off + sizes[0])
    _node(st, b"stsc")[1] = _node(st, b"stsc")[1][:4] + struct.pack(">7I", 2, 1, 1, 1, 2, 2, 1)


def _set(path, typ, fmt, off, *v, k=0):
    def f(s):
        nodes = find(s.moov(), b"trak", index=k)[1]
        for p in path:
            nodes = _node(nodes, p)[1]
        n = _node(nodes, typ)
        n[1] = _patch(n[1], fmt, off, *v)
    return f


def _co64(s):
    n = _node(_stbl(s), b"stco")
    n[0], n[1] = b"co64", n[1][:8] + struct.pack(">Q", struct.unpack_from(">I", n[1], 8)[0])


def _stsz_constant(s):
    n = _node(_stbl(s), b"stsz")
    n[1] = n[1][:4] + struct.pack(">II", struct.unpack_from(">I", n[1], 12)[0], 3)


def _major(brand):
    def f(s):
        n = _node(s.top, b"ftyp")
        n[1] = brand + n[1][4:]
    return f


def _prem(s):
    tid = struct.unpack_from(">I", _node(find(s.moov(), b"trak", index=1)[1], b"tkhd")[1], 12)[0]
    find(s.moov(), b"trak")[1].append([b"tref", [[b"prem", struct.pack(">I", tid)]]])


def _reorder_tracks(s):
    m = s.moov()
    m[:] = [n for n in m if n[0] != b"trak"] + [n for n in m if n[0] == b"trak"][::-1]


def _alpha_urn(s):
    n = _node(_stbl(s, 1), b"stsd")
    n[1] = n[1].replace(b"auxiliary:alpha", b"auxiliary:alphz")


STBL = (b"mdia", b"minf", b"stbl")
MDIA = (b"mdia",)
_SEQ_EDITS = {
    "stsz_constant_size": _stsz_constant,
    "co64": _co64,
    "stsc_two_chunks": _stsc_two_chunks,
    "stsz_short": _set(STBL, b"stsz", ">I", 8, 2),
    "stsz_zero_sample": _set(STBL, b"stsz", ">I", 16, 0),
    "stsz_version_1": _set(STBL, b"stsz", ">B", 0, 1),
    "stsc_first_chunk_2": _set(STBL, b"stsc", ">I", 8, 2),
    "stsc_zero_samples": _set(STBL, b"stsc", ">I", 12, 0),
    "stsc_too_many_samples": _set(STBL, b"stsc", ">I", 12, 4),
    "stsc_one_sample_a_chunk": _set(STBL, b"stsc", ">I", 12, 1),
    "stsc_flags": _set(STBL, b"stsc", ">B", 3, 1),
    "stco_version_1": _set(STBL, b"stco", ">B", 0, 1),
    "stco_past_the_end": _set(STBL, b"stco", ">I", 8, 10 ** 8),
    "stsd_no_entries": _set(STBL, b"stsd", ">I", 4, 0),
    "stsd_two_entries_listed": _set(STBL, b"stsd", ">I", 4, 2),
    "stts_version_1": _set(STBL, b"stts", ">B", 0, 1),
    "no_stss": _drop(STBL, b"stss"),
    "no_stts": _drop(STBL, b"stts"),
    "no_stco": _drop(STBL, b"stco"),
    "no_stsd": _drop(STBL, b"stsd"),
    "no_tkhd": _drop((), b"tkhd"),
    "no_edts": _drop((), b"edts"),
    "no_mdhd": _drop(MDIA, b"mdhd"),
    "no_hdlr": _drop(MDIA, b"hdlr"),
    "mdhd_timescale_0": _set(MDIA, b"mdhd", ">I", 20, 0),
    "mdhd_version_2": _set(MDIA, b"mdhd", ">B", 0, 2),
    "hdlr_vide": _set(MDIA, b"hdlr", ">4s", 8, b"vide"),
    "hdlr_pre_defined": _set(MDIA, b"hdlr", ">I", 4, 5),
    "tkhd_version_2": _set((), b"tkhd", ">B", 0, 2),
    "tkhd_track_id_0": _set((), b"tkhd", ">I", 20, 0),
    "tkhd_size_0": _set((), b"tkhd", ">II", 88, 0, 0),
    "elst_two_entries": _set((b"edts",), b"elst", ">I", 4, 2),
    "elst_version_2": _set((b"edts",), b"elst", ">B", 0, 2),
    "elst_not_repeating": _set((b"edts",), b"elst", ">B", 3, 0),
    "mvhd_version_2": lambda s: _node(s.moov(), b"mvhd").__setitem__(
        1, b"\2" + _node(s.moov(), b"mvhd")[1][1:]),
    "second_trak": lambda s: s.moov().append(find(s.moov(), b"trak")),
    "major_brand_avif": _major(b"avif"),
    "major_brand_mif1": _major(b"mif1"),
    "no_meta": lambda s: s.top.__setitem__(slice(None), [n for n in s.top if n[0] != b"meta"]),
}
_ALPHA_SEQ_EDITS = {
    "alpha_without_auxl": _drop((), b"tref", k=1),
    "alpha_track_first": _reorder_tracks,
    "alpha_premultiplied": _prem,
    "alpha_other_auxiliary_type": _alpha_urn,
    "alpha_stsz_short": _set(STBL, b"stsz", ">I", 8, 1, k=1),
}


@pytest.mark.parametrize("name", sorted(_SEQ_EDITS))
def test_sequence_edits_read_as_pil_reads_them(name):
    s = Sequence(_sequence(3, False))
    _SEQ_EDITS[name](s)
    _agree(s.build())


@pytest.mark.parametrize("name", sorted(_ALPHA_SEQ_EDITS))
def test_alpha_sequence_edits_read_as_pil_reads_them(name):
    s = Sequence(_sequence(3, True))
    _ALPHA_SEQ_EDITS[name](s)
    _agree(s.build())


@pytest.mark.parametrize("tail", ["second_meta", "second_moov", "junk_box", "moov_of_junk"])
@pytest.mark.parametrize("kind", ["still", "sequence"])
def test_boxes_after_the_last_box_libavif_needs_are_not_read(kind, tail):
    """libavif stops at the last box its brands need (``meta`` for an
    ``avif`` brand, ``moov`` for ``avis``); what follows is not parsed."""
    from tools.avif_writers import box, boxes

    data = _save(pattern(20, 30, 1)) if kind == "still" else _sequence(2, False)
    tops = {t: (s, e) for t, s, e in boxes(data, 0, len(data))}
    extra = {"second_meta": lambda: data[tops[b"meta"][0] - 8:tops[b"meta"][1]],
             "second_moov": lambda: (data[tops[b"moov"][0] - 8:tops[b"moov"][1]]
                                     if b"moov" in tops else box(b"moov", b"\0" * 5)),
             "junk_box": lambda: b"\0\0\0\x03abcd",
             "moov_of_junk": lambda: box(b"moov", b"\0" * 5)}[tail]()
    assert _agree(data + extra) == "ok"


def test_a_track_of_another_size_is_refused_naming_it():
    """A track header of another size than the frame's: libavif scales the
    frame to it (avifImageScale), and so does the port, as PIL reads it."""
    s = Sequence(_sequence(2, False))
    _set((), b"tkhd", ">II", 88, 48 << 16, 34 << 16)(s)
    data = s.build()
    assert _agree(data) == "ok"
    assert port_image.decode_image(data).shape == (34, 48, 3)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_corruption_of_sequence_boxes_reads_as_pil(seed):
    """Bytes changed in the boxes of sequences (moov, meta, the first OBUs):
    each read equals PIL's or both fail alike."""
    r = np.random.default_rng(2370 + seed)
    bases = [_sequence(2, False), _sequence(2, True)]
    counts = {}
    for k in range(100):
        d = bytearray(bases[k % 2])
        end = d.find(b"mdat") + 40
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(0, end))
            d[pos] = int(r.integers(0, 256)) if r.random() < 0.5 else d[pos] ^ (1 << int(r.integers(8)))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 30 and counts.get("next", 0) > 5, counts


# --------------------------------------------------------------- grids ----

def _tiles(n, alpha=False, size=64, **kw):
    out = []
    for k in range(n):
        px = pattern(size, size, 100 + k)
        if alpha:
            px = np.concatenate([px, pattern(size, size, 120 + k)[..., :1]], -1)
        out.append(_save(px, **kw))
    return out


@pytest.mark.parametrize("rows,cols,w,h,kw", [
    (1, 2, 128, 64, {}), (1, 2, 120, 64, {}), (2, 1, 64, 100, {}), (2, 2, 100, 128, {}),
    (2, 3, 180, 100, {}), (2, 3, 130, 66, {"subsampling": "4:4:4"}),
    (1, 2, 127, 63, {"subsampling": "4:4:4"}), (2, 2, 100, 99, {"subsampling": "4:2:2"}),
    (2, 2, 99, 101, {"subsampling": "4:0:0"}),
    (2, 2, 128, 120, {"speed": 2, "advanced": {"enable-cdef": "1", "enable-qm": "1",
                                                "denoise-noise-level": "10"}})])
def test_grids_read_as_pil(rows, cols, w, h, kw):
    data = grid(_tiles(rows * cols, **kw), rows, cols, w, h)
    assert _agree(data) == "ok"
    _planes_equal_dav1d(data)
    assert port_image.decode_image(data).shape == (h, w, 3)


@pytest.mark.parametrize("premultiplied", [False, True])
def test_a_grid_with_a_grid_alpha_reads_as_pil(premultiplied):
    data = grid(_tiles(2, alpha=True, alpha_premultiplied=premultiplied), 1, 2, 120, 64)
    assert _agree(data) == "ok"
    assert port_image.decode_with_mode(data)[1] == "RGBA"


def _tile_av1c(data, tile, byte, xor):
    from tools.avif_writers import Avif

    a = Avif.parse(data)
    idx = [i for i, _ in a.assoc[tile] if a.props[i - 1][0] == b"av1C"][0]
    body = bytearray(a.props[idx - 1][1])
    body[byte] ^= xor
    a.props[idx - 1] = (b"av1C", bytes(body))
    return a.build()


_GRIDS = {
    "odd_width_420": lambda: grid(_tiles(2), 1, 2, 127, 64),
    "odd_height_420": lambda: grid(_tiles(2), 1, 2, 128, 63),
    "tiles_under_64": lambda: grid(_tiles(2, size=32), 1, 2, 64, 32),
    "not_covered": lambda: grid(_tiles(2), 1, 2, 130, 64),
    "a_column_past_the_output": lambda: grid(_tiles(2), 1, 2, 64, 64),
    "ispe_larger_than_output": lambda: grid(_tiles(2), 1, 2, 120, 64, ispe=(128, 64)),
    "ispe_smaller_than_output": lambda: grid(_tiles(2), 1, 2, 120, 64, ispe=(100, 60)),
    "ispe_smaller_rgba": lambda: grid(_tiles(2, alpha=True), 1, 2, 120, 64, ispe=(119, 50)),
    "version_1": lambda: grid(_tiles(2), 1, 2, 120, 64, version=1),
    "32_bit_sizes": lambda: grid(_tiles(2), 1, 2, 120, 64, flags=1),
    "other_flags": lambda: grid(_tiles(2), 1, 2, 120, 64, flags=2),
    "a_byte_more": lambda: grid(_tiles(2), 1, 2, 120, 64, extra=b"\0"),
    "tiles_reversed": lambda: grid(_tiles(2), 1, 2, 120, 64, order=[1, 0]),
    "a_tile_missing": lambda: grid(_tiles(2), 1, 2, 120, 64, order=[0]),
    "a_tile_twice": lambda: grid(_tiles(2), 1, 2, 120, 64, order=[0, 0]),
    "a_reference_more": lambda: grid(_tiles(2), 1, 2, 120, 64, order=[0, 1, 1]),
    "tiles_of_two_subsamplings": lambda: grid(_tiles(1) + _tiles(1, subsampling="4:4:4"),
                                              1, 2, 120, 64),
    "tiles_of_two_qualities": lambda: grid(_tiles(1) + _tiles(1, quality=20), 1, 2, 120, 64),
    "tiles_of_two_ranges": lambda: grid(_tiles(1) + _tiles(1, range="limited"), 1, 2, 120, 64),
    "tile_av1c_level": lambda: _tile_av1c(grid(_tiles(2), 1, 2, 120, 64), 3, 1, 1),
    "tile_av1c_position": lambda: _tile_av1c(grid(_tiles(2), 1, 2, 120, 64), 3, 2, 1),
    "tile_av1c_delay": lambda: _tile_av1c(grid(_tiles(2), 1, 2, 120, 64), 3, 3, 0x10),
}


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_grid_forms_read_or_fail_as_in_pil(name):
    _agree(_GRIDS[name]())


@pytest.mark.parametrize("seed", range(2))
def test_seeded_corruption_of_grids_reads_as_pil_or_is_refused(seed):
    r = np.random.default_rng(2380 + seed)
    base = grid(_tiles(2, quality=30), 1, 2, 120, 64)
    counts = {}
    for k in range(100):
        d = bytearray(base)
        end = d.find(b"mdat") + 40
        for _ in range(int(r.integers(1, 4))):
            pos = int(r.integers(0, end))
            d[pos] = int(r.integers(0, 256)) if r.random() < 0.5 else d[pos] ^ (1 << int(r.integers(8)))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 5 and counts.get("next", 0) > 20, counts


# ------------------------------------------------------------ render -------

def test_config3_map_kd_tools_avif_renders_equal_to_the_png_route(tmp_path):
    """The BASELINE config-3 scene (the env-lit textured terrain) at 16x16
    through the CLI on the CPU, its ``map_Kd`` an AVIF with CDEF,
    quantizer matrices, film grain and loop restoration, against the PNG
    of that AVIF's decoded pixels."""
    from akari_torch.cli import render as cli
    from akari_torch.scene.builtin import write_envtex_terrain

    data = _save(_tex(64, 64, 3), quality=50, speed=3,
                 advanced={"enable-cdef": "1", "enable-qm": "1", "denoise-noise-level": "10"})
    info = _planes_equal_dav1d(data)
    assert info["film_grain"] and info["qm_levels"] != 0xFFF
    akari = write_envtex_terrain(str(tmp_path), n=16, res=16, spp=2, depth=2, tex_res=64,
                                 sky_hw=(16, 32))
    (tmp_path / "albedo.avif").write_bytes(data)
    (tmp_path / "albedo_avif.png").write_bytes(
        port_image.encode_png(port_image.decode_image(data)))
    mtl = (tmp_path / "terrain.mtl").read_text()
    frames = {}
    for name in ("albedo.avif", "albedo_avif.png"):
        (tmp_path / "terrain.mtl").write_text(mtl.replace("map_Kd albedo.png", f"map_Kd {name}"))
        out = tmp_path / f"out_{name}.png"
        assert cli.main(["-i", akari, "-o", str(out), "--device", "cpu"]) == 0
        frames[name] = port_image.decode_image(out.read_bytes())
    assert frames["albedo_avif.png"].mean() > 1
    np.testing.assert_array_equal(frames["albedo.avif"], frames["albedo_avif.png"])
