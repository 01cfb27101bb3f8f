"""Port parity: the PIL-free WebP decoder (akari_torch/core/webp.py with
akari_torch/native/webp_vp8.cpp and webp_vp8l.cpp) against PIL 12.1.0 and
its libwebp, through which the JAX package's ``read_image`` reads WebP.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
and ``read_image`` of both packages gives the same float32 array bit for
bit with ``to_linear`` True and False:

- the WebP fixtures of ``tests/data/torch_port_images`` (written by
  ``tools/make_torch_port_image_fixtures.py``; ``digests.json`` holds
  PIL's decode of each, which ``chip_smoke.py`` checks on a machine
  without PIL), the 2048^2 config-3 albedo among them;
- PIL-written files: lossy at qualities 0-100 and methods 0-6, lossless at
  methods 0-6 with few-colour images (bundled palettes), alpha with
  ``alpha_quality`` and ``exact``, odd sizes, two-frame animations;
- random VP8 key frames of ``tools/webp_writers.py`` (simple and normal
  loop filters, sharpness, 1-8 token partitions, loop-filter deltas,
  segments, every mode at every border, every token category, skip flags
  on and off), each of which PIL must read;
- crafted VP8L streams: every predictor mode (14 and 15 included), palette
  sizes with indices past the palette's end, simple codes of every form,
  code lengths through repeat codes, and ALPH planes that end one code
  early (libwebp's byte-wise alpha decoding accepts one, not two);
- container forms (VP8X, ALPH raw or coded, kept only with the alpha flag,
  unknown and metadata chunks, ANIM / ANMF frames inside their canvas),
  RIFF sizes larger or smaller than the data, cut files and trailing
  bytes, and seeded corruptions: where PIL reads a file the pixels are
  equal, where it refuses it the port raises ValueError;
- ``chip_smoke.vp8l_bytes``, the lossless writer of the card's phase 44;
- an OBJ whose ``map_Kd`` is a WebP renders at 16x16 on the CPU bit-equal
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
from akari_torch.core import webp as port_webp
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import pattern
from tools.webp_writers import BitWriter, chunk, random_vp8_frame, random_vp8_webp, riff, \
    vp8l_header

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")


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


def _matches_pil(data, name="f.webp"):
    want = _pil(data)
    got = port_image.decode_image(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _as_pil(data, name="f.webp"):
    """Equal pixels where PIL reads ``data``; ValueError where it refuses.
    Returns whether PIL read it."""
    try:
        want = _pil(data)
    except Exception:
        with pytest.raises(ValueError):
            port_image.decode_image(data, name)
        return False
    np.testing.assert_array_equal(port_image.decode_image(data, name), want, err_msg=name)
    return True


def _save(px, **kw):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunks(data):
    """(fourcc, payload) of a WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _vp8x(flags, w, h):
    return chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


# ------------------------------------ fixtures ---------------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.endswith(".webp")}


WEBP_FIXTURES = sorted(_digests())


def test_digests_are_pils_decode():
    """digests.json holds PIL's decode of every WebP fixture (so the card,
    which has no PIL, checks the port against PIL's pixels)."""
    digests = _digests()
    assert len(digests) >= 14 and "albedo2048_q85.webp" in digests
    for name, rec in digests.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            px = _pil(f.read())
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name
        assert list(px.shape) == rec["shape"], name


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


def test_lossy_albedo_fixture_is_the_config3_albedo():
    """The committed 2048^2 lossy albedo is PIL's quality-85 WebP of
    ``envtex_texture(2048, 0)`` (800,538 bytes with libwebp 1.6.0)."""
    from akari_torch.scene.builtin import envtex_texture

    with open(os.path.join(FIXTURES, "albedo2048_q85.webp"), "rb") as f:
        data = f.read()
    assert data == _save(envtex_texture(2048, 0), quality=85)


# ------------------------------- PIL-written files -----------------------------------

@pytest.mark.parametrize("quality", range(0, 101, 10))
def test_pil_lossy_qualities_and_methods(quality):
    for method in range(7):
        for h, w, seed in ((17, 33, 1), (48, 40, 2)):
            _matches_pil(_save(pattern(h, w, seed + quality), quality=quality, method=method))


def _few_colours(h, w, n, seed):
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return r.integers(0, 256, (n, 3)).astype(np.uint8)[(x // 2 + y * 3) % n]


@pytest.mark.parametrize("method", range(7))
def test_pil_lossless_methods_and_palettes(method):
    """Lossless at every method: a smooth pattern, noise, and images of 1,
    2, 3, 4, 11, 16, 17 and 200 colours (palettes bundled at 8, 4, 2 and 1
    pixels a byte, and none)."""
    r = np.random.default_rng(method)
    cases = [pattern(23, 31, method), r.integers(0, 256, (9, 14, 3)).astype(np.uint8)]
    cases += [_few_colours(13 + n % 5, 21 + n % 7, n, n + method)
              for n in (1, 2, 3, 4, 11, 16, 17, 200)]
    for px in cases:
        got = _matches_pil(_save(px, lossless=True, method=method, quality=int(r.integers(101))))
        np.testing.assert_array_equal(got, px)


@pytest.mark.parametrize("alpha_quality", (0, 30, 100))
def test_pil_alpha(alpha_quality):
    """Lossy RGBA (a VP8L-coded ALPH plane, filtered or not) and lossless
    RGBA, with and without ``exact``: alpha never changes the RGB."""
    r = np.random.default_rng(alpha_quality)
    rgba = np.concatenate([pattern(19, 25, 3), r.integers(0, 256, (19, 25, 1))
                           .astype(np.uint8)], axis=2)
    rgba[2:6, 3:9, 3] = 0
    for method in (0, 4, 6):
        _matches_pil(_save(rgba, quality=60, alpha_quality=alpha_quality, method=method))
        _matches_pil(_save(rgba, quality=60, alpha_quality=alpha_quality, exact=True))
    np.testing.assert_array_equal(_matches_pil(_save(rgba, lossless=True, exact=True)),
                                  rgba[..., :3])
    _matches_pil(_save(rgba, lossless=True, alpha_quality=alpha_quality))


@pytest.mark.parametrize("size", [(1, 1), (1, 23), (23, 1), (17, 9), (15, 16), (16, 15),
                                  (33, 47), (2, 130)])
def test_odd_sizes(size):
    w, h = size
    px = pattern(h, w, w * 100 + h)
    _matches_pil(_save(px, quality=70))
    _matches_pil(_save(px, quality=95, method=6))
    np.testing.assert_array_equal(_matches_pil(_save(px, lossless=True)), px)


def test_pil_animations_read_frame_zero(tmp_path):
    frames = [Image.fromarray(pattern(20, 28, s)) for s in (5, 6, 7)]
    for kw in ({"quality": 70}, {"lossless": True}, {"allow_mixed": True, "quality": 50},
               {"minimize_size": True}):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40,
                       **kw)
        _matches_pil(buf.getvalue())
        (tmp_path / "a.webp").write_bytes(buf.getvalue())
        _same_read(str(tmp_path / "a.webp"))


# ------------------------------- random VP8 frames -----------------------------------

VP8_BATCHES = {
    "default": {},
    "simple-filter": {"simple": True},
    "normal-filter": {"simple": False, "level": 40},
    "sharpness-and-deltas": {"lf_delta": True, "simple": False},
    "partitions-8": {"log2_parts": 3},
    "no-skip-flag": {"skip_proba": False, "density": 0.3},
    "large-tokens": {"big": 0.5, "density": 0.8},
    "segments": {"segments": True},
}


@pytest.mark.parametrize("batch", list(VP8_BATCHES))
def test_random_vp8_key_frames(batch):
    """Seeded random VP8 streams: PIL reads each, the port gives its
    pixels. Sizes 1-70 put every mode on the frame's top and left borders
    and on its right edge."""
    force = VP8_BATCHES[batch]
    r = np.random.default_rng(len(batch))
    for k in range(20):
        w, h = int(r.integers(1, 71)), int(r.integers(1, 71))
        seed = 1000 * len(batch) + k
        if batch == "sharpness-and-deltas":
            force = dict(force, sharpness=1 + k % 7)
        data = random_vp8_webp(seed, w, h, **force)
        _matches_pil(data, f"{batch}-{seed}-{w}x{h}")


def test_random_vp8_streams_cover_every_mode_at_every_border():
    """Random frames of 3 x 3 macroblocks (and one column wide): every
    16x16, 4x4 and chroma mode is written on the frame's top, left and
    right edges and inside it, and every token size class and category
    3-6 appears; PIL and the port read each frame alike."""
    seen = set()
    for seed in range(12):
        w, h = (44, 40) if seed % 4 else (9, 33)
        _matches_pil(random_vp8_webp(5000 + seed, w, h, coverage=seen, big=0.3, density=0.5,
                                     skip_proba=False), f"coverage-{seed}")
    for kind, modes in (("y16", 4), ("y4", 10), ("uv", 4)):
        for mode in range(modes):
            places = [c[2:] for c in seen if c[:2] == (kind, mode)]
            for edge, name in enumerate(("top", "left", "right")):
                assert any(p[edge] for p in places), (kind, mode, name)
            assert (False, False, False) in places, (kind, mode, "inside")
    assert {("token", c) for c in range(9)} <= seen


def test_token_partitions_of_random_bytes():
    """The second of two token partitions replaced by random bytes, a third
    of them starting with 0xFF (the boolean decoder's value then never
    falls below its range and grows until libwebp's masked sign read parts
    from an ordinary bit read): PIL reads each, and the port alike."""
    r = np.random.default_rng(9)
    for seed in range(30):
        frame = bytearray(random_vp8_frame(seed, 40, 40, log2_parts=1, skip_proba=False))
        first = 10 + ((frame[0] | frame[1] << 8 | frame[2] << 16) >> 5)
        second = first + 3 + int.from_bytes(frame[first:first + 3], "little")
        noise = r.integers(0, 256, len(frame) - second).astype(np.uint8)
        if seed % 3 == 0:
            noise[0] = 0xFF
        frame[second:] = noise.tobytes()
        _as_pil(riff(chunk(b"VP8 ", bytes(frame))), f"noise-{seed}")


def test_loop_filter_changes_the_frame():
    """The same random tokens unfiltered (level 0) and under the strongest
    normal filter: both equal PIL's reads, and they differ, so the random
    streams do exercise the filters."""
    unfiltered = _matches_pil(riff(chunk(b"VP8 ", random_vp8_frame(7, 40, 40, level=0))))
    filtered = _matches_pil(riff(chunk(b"VP8 ", random_vp8_frame(7, 40, 40, level=63,
                                                                  simple=False))))
    assert not np.array_equal(filtered, unfiltered)


# -------------------------------- crafted VP8L ---------------------------------------

def _vp8l_stream(w, h, seed, transforms=(), dist=(0,), greens=(3, 200), green_repeat=False):
    """A VP8L image stream (no header): ``transforms`` as (type, arg),
    codes of one or two symbols (or a green code whose 8-bit lengths come
    from repeat codes 16 and 18), random pixels."""
    r = np.random.default_rng(seed)
    bw = BitWriter()
    for kind, arg in transforms:
        bw.put(1, 1)
        bw.put(kind, 2)
        if kind == 0:  # predictor: 4x4 tiles, mode ``arg`` everywhere
            bw.put(0, 3)
            bw.put(0, 1)
            bw.simple_code(arg)
            for _ in range(4):
                bw.simple_code(0)
        elif kind == 3:  # colour indexing with ``arg`` colours
            bw.put(arg - 1, 8)
            bw.put(0, 1)
            bw.simple_code(17, 90)
            bw.simple_code(5, 250)
            bw.simple_code(40, 41)
            bw.simple_code(128, 255)
            bw.simple_code(0)
            bw.put(int(r.integers(0, 1 << 30)), 4 * arg)
            bits = 3 if arg <= 2 else 2 if arg <= 4 else 1 if arg <= 16 else 0
            w = (w + (1 << bits) - 1) >> bits
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta codes
    if green_repeat:
        bw.put(0, 1)
        bw.put(9 - 4, 4)  # code-length code lengths for 17, 18, 0-5, 16: {16, 18} 1 bit
        for s in (17, 18, 0, 1, 2, 3, 4, 5, 16):
            bw.put(1 if s in (16, 18) else 0, 3)
        bw.put(0, 1)
        for _ in range(42):
            bw.code(0, 1)  # 16: repeat the previous length (8 at first) 6 times
            bw.put(3, 2)
        bw.code(0, 1)
        bw.put(1, 2)  # 4 times: 256 lengths of 8
        bw.code(1, 1)
        bw.put(13, 7)  # 18: 24 zeros
    else:
        bw.simple_code(*greens)
    bw.simple_code(7, 99)
    bw.simple_code(1, 150)
    bw.simple_code(255)
    bw.simple_code(*dist)
    for _ in range(w * h):
        bw.put(int(r.integers(0, 256 if green_repeat else 2)), 8 if green_repeat else 1)
        bw.put(int(r.integers(0, 4)), 2)
    return bw


def _vp8l_file(w, h, bw):
    return riff(chunk(b"VP8L", vp8l_header(w, h) + bw.data()))


CRAFTED = {f"predictor-{m}": (9, 7, {"transforms": [(0, m)]}) for m in range(16)}
CRAFTED.update({f"palette-{n}": (11, 5, {"transforms": [(3, n)]})
                for n in (1, 2, 3, 4, 5, 16, 17)})
CRAFTED.update({f"palette-3-then-predictor-{m}": (13, 6, {"transforms": [(3, 3), (0, m)]})
                for m in (11, 13)})
CRAFTED.update({f"distance-{'-'.join(map(str, d))}": (4, 3, {"dist": d})
                for d in ((39,), (40,), (200,), (5, 200), (200, 5))})
CRAFTED.update({f"green-{'-'.join(map(str, g))}": (3, 3, {"greens": g})
                for g in ((0,), (1,), (0, 1), (1, 1), (5, 5), (255,))})
CRAFTED["repeat-codes"] = (6, 5, {"green_repeat": True})


@pytest.mark.parametrize("case", list(CRAFTED))
def test_crafted_vp8l_streams(case):
    """Predictor modes 14 and 15 predict black as libwebp's padding entries
    do; a palette index past the palette reads transparent black; a simple
    distance code whose symbol is past the alphabet is refused alone and
    ignored beside one that fits; a green code's lengths may start with
    repeat code 16 (length 8). Only the out-of-alphabet distance codes
    alone are refused."""
    w, h, kw = CRAFTED[case]
    seed = sum(map(ord, case))
    reads = _as_pil(_vp8l_file(w, h, _vp8l_stream(w, h, seed, **kw)), case)
    assert reads == (case not in ("distance-40", "distance-200"))


# ------------------------------------ alpha planes -----------------------------------

def _lossy_chunk(w, h, seed):
    return dict(_chunks(_save(pattern(h, w, seed), quality=50)))[b"VP8 "]


def _alpha_file(alph, flags=0x10, w=16, h=8, order=("ALPH", "VP8 ")):
    parts = {"ALPH": chunk(b"ALPH", alph), "VP8 ": chunk(b"VP8 ", _lossy_chunk(w, h, 4))}
    return riff(_vp8x(flags, w, h), *[parts[k] for k in order])


def _palette_alpha(short_bits, extra_transform=False):
    """(height, ALPH payload) of an 8-pixel-wide alpha plane coded as VP8L:
    a 2-colour palette (8 pixels a byte, so one packed pixel a row), green
    codes of 1 bit; the height is picked so that the stream's last
    ``short_bits`` bits fall past its last byte, which is dropped."""
    for h in range(40, 48):
        bw = BitWriter()
        if extra_transform:
            bw.put(1, 1)
            bw.put(2, 2)  # subtract green: two transforms, no byte-wise decoding
        bw.put(1, 1)
        bw.put(3, 2)
        bw.put(1, 8)  # colour indexing, 2 colours
        bw.put(0, 1)
        bw.simple_code(0, 200)
        for _ in range(4):
            bw.simple_code(0)
        bw.put(0, 1)  # palette entries: green 0, then 0 + 200
        bw.put(1, 1)
        bw.put(0, 3)  # no more transforms, no colour cache, no meta codes
        bw.simple_code(0x0F, 0xF0)
        for _ in range(4):
            bw.simple_code(0)
        for k in range(h):
            bw.put(k & 1, 1)
        if len(bw.bits) % 8 == short_bits:
            bits = np.array(bw.bits[:len(bw.bits) - short_bits], np.uint8)
            return h, bytes([1]) + np.packbits(bits, bitorder="little").tobytes()
    raise AssertionError("no height fits")


def _vp8l_one_colour():
    """A headerless VP8L stream whose codes are all one-symbol codes."""
    bw = BitWriter()
    bw.put(0, 3)  # no transform, no colour cache, no meta codes
    for s in (7, 0, 0, 255, 0):
        bw.simple_code(s)
    return bw.data()


def test_alpha_planes_never_change_the_rgb_but_must_decode():
    w, h = 64, 8
    rgb = _pil(riff(chunk(b"VP8 ", _lossy_chunk(w, h, 4))))
    good = bytes([1]) + _vp8l_one_colour()
    np.testing.assert_array_equal(_matches_pil(_alpha_file(good, w=w, h=h)), rgb)
    raw = bytes([0x04]) + bytes(range(256)) * 2  # raw, horizontal filter
    np.testing.assert_array_equal(_matches_pil(_alpha_file(raw, w=w, h=h)), rgb)
    cases = {
        "raw-short": bytes([0x00]) + bytes(w * h - 1),
        "method-2": bytes([0x02]) + good[1:],
        "method-3": bytes([0x03]) + good[1:],
        "preprocessing-2": bytes([0x21]) + good[1:],
        "reserved-bit": bytes([0x41]) + good[1:],
        "header-only": bytes([0x01]),
        "empty": b"",
        "corrupt-stream": bytes([0x01, 0xFF, 0xFF, 0xFF]),
    }
    for name, alph in cases.items():
        assert not _as_pil(_alpha_file(alph, w=w, h=h), name), name
        # without the alpha flag the demuxer drops the plane undecoded
        np.testing.assert_array_equal(_matches_pil(_alpha_file(alph, flags=0, w=w, h=h)), rgb)


def test_alpha_streams_that_end_early():
    """libwebp decodes an alpha plane whose only transform is colour
    indexing byte by byte and then accepts a last code read past the data;
    with a second transform, or with two codes missing, it refuses."""
    for short, extra, reads in ((0, False, True), (1, False, True), (2, False, False),
                                (1, True, False), (0, True, True)):
        h, alph = _palette_alpha(short, extra)
        assert len(alph) > 9
        data = _alpha_file(alph, w=8, h=h)
        assert _as_pil(data, f"short {short} extra {extra}") == reads, (short, extra)


# --------------------------------- container forms -----------------------------------

def test_container_forms():
    vp8 = _lossy_chunk(20, 12, 9)
    vp8l = dict(_chunks(_save(pattern(12, 20, 9), lossless=True)))[b"VP8L"]
    rgb = _pil(riff(chunk(b"VP8 ", vp8)))
    reads = {
        "vp8x-still": riff(_vp8x(0, 20, 12), chunk(b"VP8 ", vp8)),
        "vp8x-lossless": riff(_vp8x(0x10, 20, 12), chunk(b"VP8L", vp8l)),
        "metadata-and-unknown": riff(_vp8x(0x2C, 20, 12), chunk(b"ICCP", bytes(7)),
                                     chunk(b"ABCD", b"xyz"), chunk(b"VP8 ", vp8),
                                     chunk(b"EXIF", b"Exif"), chunk(b"XMP ", b"<x/>")),
        "vp8x-size-12": riff(chunk(b"VP8X", bytes(4) + (19).to_bytes(3, "little")
                                   + (11).to_bytes(3, "little") + bytes(2)),
                             chunk(b"VP8 ", vp8)),
        "trailing-bytes": riff(chunk(b"VP8 ", vp8)) + b"garbage after the RIFF chunk",
        "trailing-chunk": riff(chunk(b"VP8 ", vp8), chunk(b"JUNK", bytes(9))),
        "alph-after-vp8-no-flag": riff(_vp8x(0, 20, 12), chunk(b"VP8 ", vp8),
                                       chunk(b"ALPH", b"\x01")),
        "vp8x-bad-flags": riff(_vp8x(0x01, 20, 12), chunk(b"VP8 ", vp8)),
        "vp8x-canvas-mismatch": riff(_vp8x(0, 21, 12), chunk(b"VP8 ", vp8)),
        "two-images": riff(_vp8x(0, 20, 12), chunk(b"VP8 ", vp8), chunk(b"VP8 ", vp8)),
        "two-vp8x": riff(_vp8x(0, 20, 12), _vp8x(0, 20, 12), chunk(b"VP8 ", vp8)),
        "alph-before-vp8l": riff(_vp8x(0x10, 20, 12), chunk(b"ALPH", bytes([0]) + bytes(240)),
                                 chunk(b"VP8L", vp8l)),
        "alph-after-vp8": riff(_vp8x(0x10, 20, 12), chunk(b"VP8 ", vp8),
                               chunk(b"ALPH", bytes([0]) + bytes(240))),
        "alph-unknown-vp8": riff(_vp8x(0x10, 20, 12), chunk(b"ALPH", bytes([0]) + bytes(240)),
                                 chunk(b"ABCD", b""), chunk(b"VP8 ", vp8)),
        "anim-flag-on-a-still": riff(_vp8x(0x02, 20, 12), chunk(b"VP8 ", vp8)),
        "simple-then-vp8x": riff(chunk(b"VP8 ", vp8), _vp8x(0, 20, 12)),
        "odd-chunk-unpadded": b"RIFF" + struct.pack("<I", 4 + 8 + len(vp8))
        + b"WEBPVP8 " + struct.pack("<I", len(vp8)) + vp8,
    }
    outcome = {name: _as_pil(data, name) for name, data in reads.items()}
    assert outcome == {
        "vp8x-still": True, "vp8x-lossless": True, "metadata-and-unknown": True,
        "vp8x-size-12": False, "trailing-bytes": True, "trailing-chunk": True,
        "alph-after-vp8-no-flag": True, "vp8x-bad-flags": False,
        "vp8x-canvas-mismatch": False, "two-images": False, "two-vp8x": False,
        "alph-before-vp8l": False, "alph-after-vp8": False, "alph-unknown-vp8": False,
        "anim-flag-on-a-still": False, "simple-then-vp8x": True,
        "odd-chunk-unpadded": outcome["odd-chunk-unpadded"],
    }, outcome
    np.testing.assert_array_equal(port_webp.decode_webp(reads["vp8x-still"]), rgb)


def _anim(frames, canvas=(40, 30), flags=0x12, anim=True):
    """ANIM then ANMF frames: (x, y, payload chunk, declared w, declared h)."""
    body = [_vp8x(flags, *canvas)]
    if anim:
        body.append(chunk(b"ANIM", struct.pack("<IH", 0, 0)))
    for x, y, image, fw, fh in frames:
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, fw - 1, fh - 1, 50))
        body.append(chunk(b"ANMF", head + b"\0" + image))
    return riff(*body)


def test_animation_frame_zero_on_its_canvas():
    """Frame 0 lands at (2x, 2y) on a zeroed canvas; the frame's size is the
    bitstream's (the ANMF size fields are overwritten by it); a frame past
    the canvas, frames without ANIM or without the animation flag are
    refused."""
    lossless = chunk(b"VP8L", dict(_chunks(_save(pattern(16, 20, 12), lossless=True)))[b"VP8L"])
    lossy = chunk(b"VP8 ", _lossy_chunk(20, 16, 13))
    alpha = chunk(b"ALPH", bytes([0]) + bytes(range(256)) + bytes(64))
    cases = {
        "offset": _anim([(4, 6, lossless, 20, 16)]),
        "corner": _anim([(20, 14, lossy, 20, 16)]),
        "alpha": _anim([(0, 0, alpha + lossy, 20, 16)]),
        "declared-size-differs": _anim([(2, 2, lossless, 5, 5)]),
        "past-the-canvas": _anim([(22, 0, lossless, 20, 16)]),
        "no-anim-chunk": _anim([(0, 0, lossless, 20, 16)], anim=False),
        "no-animation-flag": _anim([(0, 0, lossless, 20, 16)], flags=0x10),
        "two-frames": _anim([(0, 0, lossy, 20, 16), (10, 10, lossless, 20, 16)]),
        "empty-first-frame": _anim([(0, 0, b"", 20, 16), (0, 0, lossy, 20, 16)]),
    }
    outcome = {name: _as_pil(data, name) for name, data in cases.items()}
    assert outcome == {"offset": True, "corner": True, "alpha": True,
                       "declared-size-differs": True, "past-the-canvas": False,
                       "no-anim-chunk": False, "no-animation-flag": False, "two-frames": True,
                       "empty-first-frame": outcome["empty-first-frame"]}, outcome
    px = port_webp.decode_webp(cases["offset"])
    assert px.shape == (30, 40, 3) and not px[:6].any() and not px[:, :4].any()
    assert not px[22:].any() and not px[:, 24:].any() and px[6:22, 4:24].any()


def test_riff_size_and_cut_files():
    """A file cut short by even one byte, and a RIFF size larger or
    smaller than the payload, are refused; bytes past the RIFF chunk are
    ignored."""
    for data in (_save(pattern(12, 16, 14), quality=80),
                 _save(pattern(12, 16, 14), lossless=True),
                 _save(np.concatenate([pattern(12, 16, 14), np.full((12, 16, 1), 9, np.uint8)],
                                      axis=2), quality=80)):
        px = _matches_pil(data)
        for cut in (1, 2, 7, 8, 9, len(data) // 2, len(data) - 20):
            assert not _as_pil(data[:-cut], f"cut {cut}")
        size = struct.unpack_from("<I", data, 4)[0]
        for delta in (-3, -2, -1, 1, 2, 8):
            bad = data[:4] + struct.pack("<I", size + delta) + data[8:]
            assert not _as_pil(bad, f"RIFF size {delta:+d}")
        np.testing.assert_array_equal(_matches_pil(data + b"\0" * 5), px)


def test_more_pixels_than_pil_opens():
    """PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS pixels
    (178,956,970) when it opens it: a WebP canvas, and a BMP header, of
    20000 x 10000 are refused naming the limit; one pixel fewer than the
    limit is no such refusal."""
    from tools.make_torch_port_image_fixtures import bmp_bytes

    assert 2 * Image.MAX_IMAGE_PIXELS == 178_956_970
    lossless = chunk(b"VP8L", dict(_chunks(_save(pattern(4, 4, 1), lossless=True)))[b"VP8L"])
    huge = _anim([(0, 0, lossless, 4, 4)], canvas=(20000, 10000))
    for data in (huge, bmp_bytes(20000, 10000, 24, bytes(64))):
        with pytest.raises(Image.DecompressionBombError):
            _pil(data)
        with pytest.raises(ValueError, match="more pixels than PIL opens"):
            port_image.decode_image(data)
    with pytest.raises(ValueError) as err:
        port_image.decode_image(bmp_bytes(17_895_697, 10, 24, bytes(64)))
    assert "more pixels" not in str(err.value)


def test_signature_is_pils():
    """WebP is RIFF, WEBP, then VP8 / VP8L / VP8X at bytes 12-16 (PIL's
    ``_accept``); anything else is no WebP to either."""
    data = _save(pattern(8, 8, 1), quality=80)
    assert port_image.image_format(data) == "WebP"
    for fourcc in (b"ALPH", b"VP8Y", b"ANIM"):
        other = data[:12] + fourcc + data[16:]
        assert port_image.image_format(other) is None
        with pytest.raises(ValueError, match="unsupported image format"):
            port_image.decode_image(other)
        with pytest.raises(Exception):
            _pil(other)


# ------------------------------------ corruptions ------------------------------------

CORRUPTION_BASES = ("webp_lossy_q75_33x17.webp", "webp_lossless_m6_40x30.webp",
                    "webp_palette16_lossless_45x21.webp", "webp_alpha_lossy_q60_25x19.webp",
                    "webp_vp8_random_37x29.webp", "webp_icc_exif_24x16.webp")


def _small_enough(data):
    """Whether the canvas and frame the corrupted headers declare stay
    small (a corrupted size makes PIL allocate the canvas it declares)."""
    try:
        size = port_webp._features(memoryview(data))["size"]
    except Exception:
        return True
    return size[0] * size[1] <= 1 << 16


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_files_read_as_pil_or_are_refused_as_pil_refuses(seed):
    """Seeded byte changes (anywhere, or in the first 40 bytes), cuts and
    tails of the still fixtures: where PIL reads the file the pixels are
    equal, where it refuses it the port raises ValueError."""
    r = np.random.default_rng(seed)
    base = {}
    for name in CORRUPTION_BASES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            base[name] = f.read()
    read = refused = 0
    while read + refused < 60:
        name = CORRUPTION_BASES[r.integers(len(CORRUPTION_BASES))]
        data = bytearray(base[name])
        op = r.integers(0, 4)
        if op == 0:
            for _ in range(r.integers(1, 4)):
                data[r.integers(0, len(data))] = r.integers(0, 256)
        elif op == 1:
            data[r.integers(0, 40)] = r.integers(0, 256)
        elif op == 2:
            data = data[:r.integers(0, len(data) + 1)]
        else:
            data += r.integers(0, 256, r.integers(1, 20)).astype(np.uint8).tobytes()
        data = bytes(data)
        if not _small_enough(data):
            continue
        if _as_pil(data, name):
            read += 1
        else:
            refused += 1
    assert read > 5 and refused > 5


# --------------------------- the card's lossless writer ------------------------------

def test_chip_smoke_vp8l_writer_is_read_by_pil():
    """``chip_smoke.vp8l_bytes``, which writes phase 44's 2048^2 lossless
    albedo on the card (which has no encoder): PIL reads back the pixels it
    was given, and so does the port."""
    import chip_smoke

    r = np.random.default_rng(3)
    for px in (pattern(40, 56, 2), r.integers(0, 256, (7, 5, 3)).astype(np.uint8),
               np.full((3, 9, 3), (10, 200, 30), np.uint8), _few_colours(17, 30, 2, 1)):
        data = chip_smoke.vp8l_bytes(px)
        np.testing.assert_array_equal(_pil(data), px)
        np.testing.assert_array_equal(_matches_pil(data), px)


# ------------------------------------ a render ---------------------------------------

def test_obj_map_kd_webp_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd albedo.webp`` (lossy): the
    texture tables and a 16x16 CPU render equal those of the same OBJ on a
    PNG of the WebP's decoded pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    data = _save(pattern(24, 32, 9), quality=80)
    (tmp_path / "albedo.webp").write_bytes(data)
    (tmp_path / "albedo.png").write_bytes(port_image.encode_png(_pil(data)))
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = [], []
    for ext in ("webp", "png"):
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
    _same_read(str(tmp_path / "albedo.webp"))
