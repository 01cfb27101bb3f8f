"""Port parity: the PIL-free ICNS decoder (akari_torch/core/icns.py, with
the PNG and JPEG 2000 decoders for its PNG / J2K / JP2 icons) against
PIL's ``IcnsImagePlugin``, through which the JAX package's ``read_image``
reads Mac OS icons.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
and ``read_image`` of both packages gives the same float32 array bit for
bit with ``to_linear`` True and False:

- the ICNS fixtures of ``tests/data/torch_port_images`` and their digests;
- files of Pillow's ICNS writer (PNG icons at every size);
- seeded drawn files from ``tools/icns_writers.py``: the 24-bit icons in
  runs and raw with and without their masks, PNG, J2K and JP2 icons,
  several sizes in one file (the largest read), a J2K icon as the best
  size, icons whose payload is not the entry's size;
- the cases PIL refuses: masks missing their icon or cut short, runs that
  overrun or end early, ``it32`` without its zero bytes, payloads neither
  PNG nor JPEG 2000, sizes PIL does not allow, blocks of length 0 and walks
  past the end of the file (PIL then tries the other formats);
- seeded corruption: wherever PIL reads the file the port gives its
  pixels, and wherever PIL refuses it the port raises ``ValueError``.
"""

import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import icns as port_icns
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tools import icns_writers as iw
from tools import j2k_writers as jw
from tools.make_torch_port_image_fixtures import lab_pnm_dib_icns_fixtures, pattern

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


def _outcome(tmp_path, data, name="i.icns"):
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


def _check(tmp_path, data, pil_reads=True, jax=False):
    """The port gives PIL's pixels, or raises where PIL raises."""
    want, got = _outcome(tmp_path, data)
    assert (want is not None) == pil_reads, "PIL " + ("refuses" if pil_reads else "reads")
    if want is None:
        assert got is None, "PIL refuses the file, the port reads it"
        return None
    assert got is not None, "PIL reads the file, the port refuses it"
    np.testing.assert_array_equal(got, want)
    if jax:
        _same_read(str(tmp_path / "i.icns"))
    return got


ICNS_FIXTURES = sorted(n for n in json.load(open(os.path.join(FIXTURES, "digests.json")))
                       if n.endswith(".icns"))


def test_icns_fixtures_are_the_tools_and_pils():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    written = lab_pnm_dib_icns_fixtures()
    assert len(ICNS_FIXTURES) >= 6
    for name in ICNS_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert written[name] == data, name
        px = _pil_path(os.path.join(FIXTURES, name))
        assert hashlib.sha256(px.tobytes()).hexdigest() == digests[name]["sha256"], name


@pytest.mark.parametrize("name", ICNS_FIXTURES)
def test_icns_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        rec = json.load(f)[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


@pytest.mark.parametrize("size", [16, 33, 128])
def test_pils_icns_writer_reads_as_pil_and_jax(tmp_path, size):
    """Pillow writes PNG icons from 16 to 1024 pixels; the 1024^2 one
    (``ic10``, 512 at scale 2) is read."""
    b = io.BytesIO()
    Image.fromarray(pattern(size, size, size)).save(b, "ICNS")
    got = _check(tmp_path, b.getvalue(), jax=True)
    assert got.shape == (1024, 1024, 3)


SIDES = {b"is32": 16, b"il32": 32, b"ih32": 48, b"it32": 128}
MASKS = {b"is32": b"s8mk", b"il32": b"l8mk", b"ih32": b"h8mk", b"it32": b"t8mk"}


def _rgb_block(kind, px, r, rle=True):
    return iw.rgb32(px, rle=rle, it32=kind == b"it32", r=r)


def _icon(r, side):
    """A drawn icon with runs (flat rows) and noise."""
    px = r.integers(0, 256, (side, side, 3)).astype(np.uint8)
    px[: side // 3] = px[:1]
    return px


@pytest.mark.parametrize("seed", range(12))
def test_drawn_24_bit_icons_match_pil(tmp_path, seed):
    """A drawn set of 24-bit icons, raw or in runs, with or without masks,
    in a drawn order: PIL reads the largest."""
    r = np.random.default_rng(seed)
    kinds = [k for k in SIDES if r.random() < 0.6] or [b"is32"]
    blocks = []
    for kind in kinds:
        side = SIDES[kind]
        blocks.append((kind, _rgb_block(kind, _icon(r, side), r, rle=r.random() < 0.7)))
        if r.random() < 0.6:
            blocks.append((MASKS[kind], iw.mask(r.integers(0, 256, (side, side)))))
    order = r.permutation(len(blocks))
    got = _check(tmp_path, iw.icns_bytes([blocks[i] for i in order]), jax=seed < 3)
    best = max(SIDES[k] for k in kinds)
    assert got.shape == (best, best, 3)


@pytest.mark.parametrize("payload", ["png", "png-rgba", "png-grey16", "png-palette", "j2k",
                                     "jp2", "j2k-grey", "j2k-rgba", "j2k-16bit"])
def test_png_and_jpeg2000_icons_match_pil(tmp_path, payload):
    """PNG icons (any PNG mode) and JPEG 2000 ones (codestream or JP2, any
    component count and precision), which PIL converts to RGBA and then
    to RGB; beside a smaller 24-bit icon, which is not read."""
    from akari_torch.core.image import encode_png
    from tools.make_torch_port_image_fixtures import png_bytes

    r = np.random.default_rng(len(payload))
    px = _icon(r, 32)
    data = {
        "png": lambda: encode_png(px),
        "png-rgba": lambda: png_bytes(r.integers(0, 256, (32, 32, 4)), 8, 6),
        "png-grey16": lambda: png_bytes(r.integers(0, 65536, (32, 32, 1)), 16, 0),
        "png-palette": lambda: png_bytes(r.integers(0, 16, (32, 32, 1)), 4, 3,
                                         plte=r.integers(0, 256, 48).astype(np.uint8).tobytes()),
        "j2k": lambda: jw.encode([px[..., k].astype(np.int64) for k in range(3)]),
        "jp2": lambda: jw.jp2(jw.encode([px[..., k].astype(np.int64) for k in range(3)]),
                              32, 32, 3),
        "j2k-grey": lambda: jw.encode([px[..., 0].astype(np.int64)]),
        "j2k-rgba": lambda: jw.encode([px[..., k % 3].astype(np.int64) for k in range(4)]),
        "j2k-16bit": lambda: jw.encode([px[..., 0].astype(np.int64) * 3], prec=10),
    }[payload]()
    icns = iw.icns_bytes([(b"is32", _rgb_block(b"is32", _icon(r, 16), r)), (b"icp5", data)])
    got = _check(tmp_path, icns, jax=True)
    assert got.shape == (32, 32, 3)


def test_a_jpeg2000_icon_as_the_best_size_matches_pil(tmp_path):
    r = np.random.default_rng(40)
    px = np.repeat(np.repeat(_icon(r, 16), 8, 0), 8, 1)
    cs = jw.encode([px[..., k].astype(np.int64) for k in range(3)], irreversible=True,
                   rates=(10,))
    icns = iw.icns_bytes([(b"il32", _rgb_block(b"il32", _icon(r, 32), r)), (b"ic07", cs),
                          (b"t8mk", iw.mask(px[..., 0]))])
    got = _check(tmp_path, icns, jax=True)
    assert got.shape == (128, 128, 3)


@pytest.mark.parametrize("side, reads", [(64, True), (32, True), (100, False), (256, False)])
def test_icons_whose_payload_is_not_the_entrys_size(tmp_path, side, reads):
    """A PNG in a 128^2 entry: PIL keeps it when one of the file's sizes is
    a whole multiple of it, and refuses it otherwise."""
    from akari_torch.core.image import encode_png

    px = _icon(np.random.default_rng(side), side)
    got = _check(tmp_path, iw.icns_bytes([(b"ic07", encode_png(px))]), pil_reads=reads)
    if reads:
        assert got.shape == (side, side, 3)


def _refused_cases():
    r = np.random.default_rng(7)
    px16, px128 = _icon(r, 16), _icon(r, 128)
    runs = iw.rgb32(px16, r=r)
    return {
        "mask-alone": iw.icns_bytes([(b"s8mk", iw.mask(px16[..., 0]))]),
        "mask-short": iw.icns_bytes([(b"is32", runs), (b"s8mk", iw.mask(px16[..., 0])[:255])]),
        "runs-end-early": iw.icns_bytes([(b"is32", runs[:len(runs) // 2])]),
        "run-overruns": iw.icns_bytes([(b"is32", bytes([255, 9]) * 2 + runs)]),
        "literal-cut": iw.icns_bytes([(b"is32", bytes([127]) * 3)]),
        "raw-cut": iw.icns_bytes([(b"is32", px16.tobytes())])[:-1],
        "it32-signature": iw.icns_bytes([(b"it32", b"\0\0\0\1" + iw.rgb32(px128, r=r))]),
        "jpeg-icon": iw.icns_bytes([(b"ic08", b"\xff\xd8\xff\xe0" + bytes(40))]),
        "j2k-bare-signature": iw.icns_bytes([(b"ic08", b"\x0d\x0a\x87\x0a" + bytes(40))]),
        "corrupt-png": iw.icns_bytes([(b"ic08", b"\x89PNG\r\n\x1a\n" + bytes(30))]),
        "bad-it32-beside-png": iw.icns_bytes([
            (b"ic07", port_image.encode_png(px128)), (b"it32", b"\1\2\3\4")]),
    }


@pytest.mark.parametrize("case", list(_refused_cases()))
def test_icons_pil_refuses_are_refused(tmp_path, case):
    data = _refused_cases()[case]
    _check(tmp_path, data, pil_reads=False)
    with pytest.raises(ValueError, match="ICNS|PNG|JPEG 2000"):
        port_image.decode_image(data, "i.icns")


def test_raw_icon_cut_short_is_read_as_runs(tmp_path):
    """A block one byte short of width x height x 3 is no raw icon: PIL
    reads it as runs, from the block's start on, past its end."""
    r = np.random.default_rng(11)
    px = _icon(r, 16)
    raw = px.tobytes()
    _check(tmp_path, iw.icns_bytes([(b"is32", raw[:-1])]), pil_reads=False)
    runs = iw.rgb32(px, r=r)
    # runs that go on past the block, into bytes after the file's declared
    # length: PIL reads on from the block's start
    data = iw.icns_bytes([(b"is32", runs[:10])]) + runs[10:]
    got = _check(tmp_path, data)
    np.testing.assert_array_equal(got, px)


@pytest.mark.parametrize("case", ["empty", "zero-length-block", "walk-past-the-end",
                                  "unknown-blocks-only", "short-header"])
def test_files_pil_gives_up_on_try_the_next_format(tmp_path, case):
    """What ``Image.open`` catches in the plugin's walk makes PIL try the
    formats after ICNS (none takes these files); the port names ICNS's
    reason in its message."""
    runs = iw.rgb32(_icon(np.random.default_rng(3), 16))
    data = {
        "empty": iw.icns_bytes([]),
        "zero-length-block": iw.icns_bytes([(b"is32", runs)])[:8] + b"is32\0\0\0\0",
        "walk-past-the-end": iw.icns_bytes([(b"is32", runs)], filesize=10_000),
        "unknown-blocks-only": iw.icns_bytes([(b"TOC ", b"ic07" + bytes(4)), (b"icnV", bytes(4))]),
        "short-header": b"icns\0\0",
    }[case]
    path = tmp_path / "g.icns"
    path.write_bytes(data)
    with pytest.raises(Exception):
        _pil_path(str(path))
    with pytest.raises(ValueError, match="unsupported image format.*PIL gives up on it.*ICNS"):
        port_image.decode_image(data, "i.icns")


def test_later_blocks_replace_earlier_and_the_walk_follows_lengths():
    """A repeated block type: the last one is read (PIL's dict); the walk
    goes by each block's length, so a block length below 8 steps back."""
    r = np.random.default_rng(5)
    a, b = _icon(r, 16), _icon(r, 16)
    data = iw.icns_bytes([(b"is32", iw.rgb32(a, r=r)), (b"is32", iw.rgb32(b, r=r))])
    np.testing.assert_array_equal(port_icns.decode_icns(data), b)
    np.testing.assert_array_equal(port_icns.decode_icns(data), np.asarray(
        Image.open(io.BytesIO(data)).convert("RGB")))
    found = port_icns.blocks(data)
    assert list(found) == [b"is32"] and found[b"is32"][0] > 16


@pytest.mark.parametrize("seed", range(8))
def test_corrupted_icns_files_read_as_pil_or_are_refused(tmp_path, seed):
    r = np.random.default_rng(900 + seed)
    px16, px32, px48 = _icon(r, 16), _icon(r, 32), _icon(r, 48)
    bases = [
        iw.icns_bytes([(b"is32", iw.rgb32(px16, r=r)), (b"s8mk", iw.mask(px16[..., 0])),
                       (b"il32", iw.rgb32(px32, r=r)), (b"l8mk", iw.mask(px32[..., 1]))]),
        iw.icns_bytes([(b"ih32", iw.rgb32(px48, r=r)), (b"h8mk", iw.mask(px48[..., 0])),
                       (b"is32", iw.rgb32(px16, rle=False))]),
        iw.icns_bytes([(b"icp5", port_image.encode_png(px32)), (b"is32", iw.rgb32(px16, r=r))]),
    ]
    for k in range(30):
        data = bytearray(bases[k % 3])
        for _ in range(int(r.integers(1, 4))):
            i = int(r.integers(0, len(data)))
            data[i] = int(r.integers(0, 256))
        if r.random() < 0.2:
            data = data[:int(r.integers(1, len(data)))]
        want, got = _outcome(tmp_path, bytes(data))
        if want is None:
            assert got is None, f"case {k}: PIL refuses the file, the port reads it"
        else:
            assert got is not None, f"case {k}: PIL reads the file, the port refuses it"
            np.testing.assert_array_equal(got, want, err_msg=f"case {k}")


def test_icns_signature_is_routed_between_jpeg2000_and_ico():
    data = iw.icns_bytes([(b"is32", iw.rgb32(_icon(np.random.default_rng(1), 16)))])
    assert port_image.image_format(data) == "ICNS"
    accepted = port_image._accepted(b"icns" + bytes(12))
    assert accepted[:1] == ["ICNS"]
