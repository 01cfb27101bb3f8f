"""Port parity: the PIL-free DDS, BLP and FTEX decoders
(akari_torch/core/dds.py, blp.py and ftex.py with
akari_torch/native/bcn.cpp) against PIL 12.1.0, through which the JAX
package's ``read_image`` reads these textures.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
and ``read_image`` of both packages gives the same float32 array bit for
bit with ``to_linear`` True and False:

- the DDS, BLP and FTEX fixtures of ``tests/data/torch_port_images``
  (``digests.json`` holds PIL's decode of each, which ``chip_smoke.py``
  checks on a machine without PIL);
- drawn blocks of every BCn form, in every FourCC and DXGI code PIL
  reads: BC1-BC5 (BC5 signed too), BC6H UF16 / SF16 in each of its mode
  codes (the reserved ones included), BC7 in every mode x partition x
  rotation x index-selection bit and the invalid mode 8, at edge sizes;
- the uncompressed forms: mask pixel formats of every bit count (the
  float scaling of ``DdsRgbDecoder``, short payloads read as zeros), L,
  LA, the palette and R8G8B8A8;
- payloads one byte short (refused) and over-long (ignored), mip chains
  and cube / array files (the top level only), and every refusal PIL
  makes, which the port makes as a ValueError naming the form;
- BLP1 JPEG (grey, 4:2:0, CMYK and YCCK streams, a mip offset behind the
  header) and palette, BLP2 palette and DXT1 / DXT3 / DXT5 with and
  without alpha, whose Python DXT decoder parts from the C ``bcn``
  decoder (shown on drawn blocks); FTEX DXT1 and raw;
- the pixel limit on each container, the writers of ``tools/dds_writers.py``
  (which ``chip_smoke.py`` uses on the card), and an OBJ ``map_Kd`` DDS
  render equal to the PNG route.
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
from tools import dds_writers as dw
from tools.make_torch_port_image_fixtures import pattern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
EXTENSIONS = (".dds", ".blp", ".ftc", ".ftu")


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


def _matches_pil(data, name="t.dds"):
    want = _pil(data)
    got = port_image.decode_image(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _refused_as_pil(data, form):
    """PIL refuses ``data``; the port raises a ValueError naming ``form``."""
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match=form):
        port_image.decode_image(data, "t")


def _blocks(r, w, h, form):
    return dw.random_blocks(r, -(-w // 4) * -(-h // 4), form)


# ----------------------------------- fixtures -----------------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.endswith(EXTENSIONS)}


FIXTURE_NAMES = sorted(_digests())


def test_fixtures_cover_every_container():
    assert len(FIXTURE_NAMES) >= 30
    for prefix in ("dds_", "blp1_", "blp2_", "ftex_"):
        assert any(n.startswith(prefix) for n in FIXTURE_NAMES), prefix


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    px = _matches_pil(data, name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ---------------------------------- BCn blocks ----------------------------------

FOURCC_FORMS = [(b"DXT1", "BC1"), (b"DXT3", "BC2"), (b"DXT5", "BC3"), (b"BC4U", "BC4"),
                (b"ATI1", "BC4"), (b"BC5U", "BC5"), (b"ATI2", "BC5"), (b"BC5S", "BC5")]
DXGI_FORMS = [(70, "BC1"), (71, "BC1"), (73, "BC2"), (74, "BC2"), (76, "BC3"), (77, "BC3"),
              (79, "BC4"), (80, "BC4"), (82, "BC5"), (83, "BC5"), (84, "BC5"), (95, "BC6H"),
              (96, "BC6H"), (97, "BC7"), (98, "BC7"), (99, "BC7")]


@pytest.mark.parametrize("fourcc, form", FOURCC_FORMS, ids=[f[0].decode() for f in FOURCC_FORMS])
def test_fourcc_blocks_match_pil(tmp_path, fourcc, form):
    """512 drawn blocks of each FourCC form, read from a file by both
    packages."""
    r = np.random.default_rng(sum(fourcc))
    path = tmp_path / "t.dds"
    path.write_bytes(dw.dds_bytes(64, 128, [_blocks(r, 64, 128, form)], fourcc=fourcc))
    _matches_pil(path.read_bytes())
    _same_read(str(path))


@pytest.mark.parametrize("dxgi, form", DXGI_FORMS, ids=[str(d) for d, _ in DXGI_FORMS])
def test_dx10_blocks_match_pil(dxgi, form):
    r = np.random.default_rng(dxgi)
    _matches_pil(dw.dds_bytes(32, 64, [_blocks(r, 32, 64, form)], dxgi=dxgi))


@pytest.mark.parametrize("mode", range(9))
def test_bc7_every_partition_rotation_and_index_selection(mode):
    """Each combination of the mode's partition, rotation and
    index-selection fields in 4 blocks (random endpoints and indices):
    a slip in one partition row or anchor shows only there. Mode 8 (no
    mode bit) is black."""
    r = np.random.default_rng(70 + mode)
    if mode == 8:
        data = dw.bc7_blocks(r, 64, 8)
    else:
        _, pb, rb, isb = dw.BC7_MODES[mode]
        k = np.arange(4 << (pb + rb + isb)) // 4
        data = dw.bc7_blocks(r, len(k), mode, k % (1 << pb), (k >> pb) % (1 << rb),
                             (k >> (pb + rb)) % (1 << isb))
    n = len(data) // 16
    px = _matches_pil(dw.dds_bytes(16, n, [data], dxgi=98))
    if mode == 8:
        assert not px.any()


@pytest.mark.parametrize("dxgi", [95, 96], ids=["UF16", "SF16"])
@pytest.mark.parametrize("code", dw.BC6H_CODES, ids=[f"{c}/{b}" for c, b in dw.BC6H_CODES])
def test_bc6h_every_mode(dxgi, code):
    """128 blocks of each BC6H mode code (the four reserved ones black),
    unsigned and signed: the endpoint layouts, transforms, sign handling
    and the half-to-8-bit step as PIL's."""
    r = np.random.default_rng(code[0] + 40 * dxgi)
    px = _matches_pil(dw.dds_bytes(32, 64, [dw.bc6h_blocks(r, 128, code)], dxgi=dxgi))
    if code[0] in (19, 23, 27, 31):
        assert not px.any()


def test_bc6h_constant_blocks_cover_the_half_scale():
    """Mode 11 blocks whose endpoints are equal (every 10-bit value,
    unsigned and signed): the whole unquantise / 31-64ths / half / 8-bit
    chain, value by value."""
    bits = np.zeros((1024, 128), np.uint8)
    v = np.arange(1024)
    dw.set_fields(bits, [(3, 5)] + [(v, 10)] * 6)
    blocks = dw.bits_to_blocks(bits).tobytes()
    for dxgi in (95, 96):
        _matches_pil(dw.dds_bytes(4 * 64, 4 * 16, [blocks], dxgi=dxgi))


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (17, 9), (3, 13)])
@pytest.mark.parametrize("fourcc, form", [(b"DXT1", "BC1"), (b"DXT5", "BC3"), (b"BC4U", "BC4"),
                                          (b"BC5S", "BC5"), (b"DX10", "BC7")],
                         ids=["DXT1", "DXT5", "BC4", "BC5S", "BC7"])
def test_edge_sizes_clip_the_blocks(size, fourcc, form):
    """Sizes not a multiple of 4 read (w + 3) // 4 x (h + 3) // 4 blocks
    and drop the pixels past the edge (a 5 x 3 DXT1 reads two blocks)."""
    w, h = size
    r = np.random.default_rng(w * 31 + h)
    kw = dict(dxgi=98) if fourcc == b"DX10" else dict(fourcc=fourcc)
    data = _blocks(r, w, h, form)
    _matches_pil(dw.dds_bytes(w, h, [data], **kw))
    if size == (5, 3) and form == "BC1":
        assert len(data) == 16


def test_bc1_punch_through_and_the_four_colour_blocks_of_bc2_bc3():
    """c0 <= c1: BC1's index 3 is transparent black, (0, 0, 0) in RGB; the
    same colour block in DXT3 / DXT5 is always 4-colour: (170, 170, 170)."""
    colour = struct.pack("<HHI", 0x0000, 0xFFFF, 0xFFFFFFFF)  # every index 3
    assert not _matches_pil(dw.dds_bytes(4, 4, [colour], fourcc=b"DXT1")).any()
    for fourcc in (b"DXT3", b"DXT5"):
        px = _matches_pil(dw.dds_bytes(4, 4, [bytes(8) + colour], fourcc=fourcc))
        assert (px == 170).all()
    half = struct.pack("<HHI", 0x0000, 0xFFFF, 0xAAAAAAAA)  # index 2: the half
    assert (_matches_pil(dw.dds_bytes(4, 4, [half], fourcc=b"DXT1")) == 127).all()


def test_bc5_signed_mapping():
    """BC5 signed reads its endpoints as int8 + 128 and fills blue with 128:
    an all-zero-index block of endpoints 0xFF gives (127, 127, 128), the
    same block unsigned (255, 255, 0)."""
    block = bytes([0xFF, 0x00] + [0] * 6) * 2
    assert (_matches_pil(dw.dds_bytes(4, 4, [block], fourcc=b"BC5S")) == [127, 127, 128]).all()
    assert (_matches_pil(dw.dds_bytes(4, 4, [block], fourcc=b"BC5U")) == [255, 255, 0]).all()
    r = np.random.default_rng(5)
    for a0, a1 in ((0x80, 0x7F), (0x7F, 0x80), (0x00, 0xFF), (0x81, 0x81)):
        tail = r.integers(0, 256, 6, dtype=np.uint8).tobytes()
        _matches_pil(dw.dds_bytes(4, 4, [bytes([a0, a1]) + tail + bytes([a1, a0]) + tail],
                                  fourcc=b"BC5S"))


def test_payloads_short_refused_long_ignored():
    """A payload one byte short of the blocks or pixels is refused as PIL
    refuses it; bytes past them (mips, cube faces, slices, junk) are never
    read: the top level only."""
    r = np.random.default_rng(8)
    cases = [(dict(fourcc=b"DXT1"), _blocks(r, 12, 8, "BC1"), "BC1"),
             (dict(dxgi=98), _blocks(r, 12, 8, "BC7"), "BC7"),
             (dict(dxgi=96), _blocks(r, 12, 8, "BC6H"), "BC6HS"),
             (dict(dxgi=28), r.integers(0, 256, 12 * 8 * 4, dtype=np.uint8).tobytes(), "R8G8B8A8"),
             (dict(pf_flags=dw.DDPF_LUMINANCE, bitcount=8), bytes(range(96)), "L"),
             (dict(pf_flags=dw.DDPF_LUMINANCE | dw.DDPF_ALPHAPIXELS, bitcount=16),
              r.integers(0, 256, 192, dtype=np.uint8).tobytes(), "LA")]
    for kw, payload, form in cases:
        px = _matches_pil(dw.dds_bytes(12, 8, [payload], **kw))
        _refused_as_pil(dw.dds_bytes(12, 8, [payload[:-1]], **kw), form)
        _refused_as_pil(dw.dds_bytes(12, 8, [b""], **kw), form)
        for tail in (b"\0", r.integers(0, 256, 333, dtype=np.uint8).tobytes()):
            np.testing.assert_array_equal(_matches_pil(dw.dds_bytes(12, 8, [payload, tail],
                                                                    **kw)), px)
    cube = dw.dds_bytes(8, 8, [_blocks(r, 8, 8, "BC7") for _ in range(6)], dxgi=99,
                        caps2=0xFE00, array_size=6)
    np.testing.assert_array_equal(_matches_pil(cube),
                                  _matches_pil(cube[:148 + 64]))


def test_mip_chain_writers_top_level(tmp_path):
    """``dds_albedo`` writes the whole mip chain; PIL and the port read the
    top level, equal to the level alone."""
    px = pattern(20, 28, 3)
    for form in ("BC1", "BC7"):
        data = dw.dds_albedo(px, form)
        top = _matches_pil(data)
        head = 148 if form == "BC7" else 128
        np.testing.assert_array_equal(top, _matches_pil(data[:head + 7 * 5 * dw.BLOCK_BYTES[form]]))
        path = tmp_path / f"a_{form}.dds"
        path.write_bytes(data)
        _same_read(str(path))


# -------------------------------- uncompressed forms --------------------------------

MASKS = [
    (16, (0xF800, 0x07E0, 0x001F, 0)),
    (16, (0x7C00, 0x03E0, 0x001F, 0x8000)),
    (16, (0x0F00, 0x00F0, 0x000F, 0xF000)),
    (24, (0xFF0000, 0xFF00, 0xFF, 0)),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    (8, (0xE0, 0x1C, 0x03, 0)),
    (16, (0b1010_0000_0000_0101, 0x0FF0, 0, 0)),   # a mask with a gap, a zero mask
    (12, (0xF00, 0x0F0, 0x00F, 0)),                # 12 bits: one byte a pixel
    (0, (0xFF, 0xFF00, 0xFF0000, 0)),               # no bytes a pixel: black
    (40, (0xFFFFFFFF, 0xFF00FF00, 0x0000FFFF, 0x80000001)),
]


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("bitcount, masks", MASKS, ids=[f"{b}-{m[0]:x}" for b, m in MASKS])
def test_mask_forms_match_pil(bitcount, masks, alpha):
    """PIL's DdsRgbDecoder: int(v / max * 255) per mask; a short payload
    (here a third of it) reads zeros past its end."""
    r = np.random.default_rng(bitcount + masks[0] % 97)
    w, h = 9, 7
    payload = r.integers(0, 256, w * h * max(1, bitcount // 8), dtype=np.uint8).tobytes()
    kw = dict(pf_flags=dw.DDPF_RGB | (dw.DDPF_ALPHAPIXELS if alpha else 0), bitcount=bitcount,
              masks=masks)
    _matches_pil(dw.dds_bytes(w, h, [payload], **kw))
    _matches_pil(dw.dds_bytes(w, h, [payload[:len(payload) // 3]], **kw))


def test_palette_luminance_and_rgba_forms(tmp_path):
    """The palette form (its 1,024 bytes, then the indices: PIL never seeks
    to the tile), L, LA and R8G8B8A8 from a file, by both packages."""
    r = np.random.default_rng(9)
    pal = dw.dds_header(13, 5, pf_flags=dw.DDPF_PALETTEINDEXED8, bitcount=8)
    cases = {"p": pal + r.integers(0, 256, 1024 + 65, dtype=np.uint8).tobytes(),
             "l": dw.dds_bytes(13, 5, [bytes(range(65))], pf_flags=dw.DDPF_LUMINANCE,
                               bitcount=8),
             "la": dw.dds_bytes(13, 5, [bytes(range(130))], bitcount=16,
                                pf_flags=dw.DDPF_LUMINANCE | dw.DDPF_ALPHAPIXELS)}
    for code in (27, 28, 29):
        cases[f"rgba{code}"] = dw.dds_bytes(
            13, 5, [r.integers(0, 256, 260, dtype=np.uint8).tobytes()], dxgi=code)
    for name, data in cases.items():
        _matches_pil(data)
        (tmp_path / f"{name}.dds").write_bytes(data)
        _same_read(str(tmp_path / f"{name}.dds"))
    _refused_as_pil(pal + bytes(1024 + 64), "palette")


# ----------------------------------- refusals -----------------------------------

def _dds_refusals():
    r = np.random.default_rng(10)
    blocks = _blocks(r, 8, 8, "BC1")
    good = dw.dds_bytes(8, 8, [blocks], fourcc=b"DXT1")
    out = {
        "header size 123": good[:4] + struct.pack("<I", 123) + good[8:],
        "header size 125": good[:4] + struct.pack("<I", 125) + good[8:],
        "incomplete header": good[:100],
        "luminance 16 without alpha": dw.dds_bytes(8, 8, [bytes(128)], bitcount=16,
                                                   pf_flags=dw.DDPF_LUMINANCE),
        "luminance 24": dw.dds_bytes(8, 8, [bytes(192)], bitcount=24,
                                     pf_flags=dw.DDPF_LUMINANCE | dw.DDPF_ALPHAPIXELS),
        "flags ALPHA only": dw.dds_bytes(8, 8, [blocks], pf_flags=0x2),
        "no flags": dw.dds_bytes(8, 8, [blocks], pf_flags=0),
        "DX10 cut": dw.dds_header(8, 8, fourcc=b"DX10")[:130],
        "zero width": dw.dds_bytes(0, 8, [blocks], fourcc=b"DXT1"),
        "zero height": dw.dds_bytes(8, 0, [blocks], fourcc=b"DXT1"),
    }
    for fourcc in (b"DXT2", b"DXT4", b"BC4S", b"ATI3", b"\0\0\0\0", b"RGBG"):
        out[f"FourCC {fourcc!r}"] = dw.dds_bytes(8, 8, [blocks * 2], fourcc=fourcc)
    for code in (0, 2, 10, 24, 72, 75, 78, 81, 87, 91, 94, 100):
        out[f"DXGI {code}"] = dw.dds_bytes(8, 8, [blocks * 2], dxgi=code)
    return out


DDS_REFUSALS = _dds_refusals()


@pytest.mark.parametrize("case", list(DDS_REFUSALS))
def test_every_dds_refusal_of_pil(case):
    _refused_as_pil(DDS_REFUSALS[case], "DDS")


def test_more_pixels_than_pil_opens_on_each_container():
    """A header of 13,380 x 13,380 (over 2 * Image.MAX_IMAGE_PIXELS) with
    no pixels: PIL raises DecompressionBombError when it opens the DDS,
    BLP and FTEX file, the port refuses it naming the limit, at once."""
    import time

    n = 13_380
    cases = [dw.dds_bytes(n, n, [b""], fourcc=b"DXT1"), dw.dds_bytes(n, n, [b""], dxgi=98),
             dw.dds_bytes(n, n, [b""], pf_flags=dw.DDPF_RGB, bitcount=32,
                          masks=(0xFF, 0xFF00, 0xFF0000, 0)),
             dw.blp2_bytes(n, n, [b""]), dw.blp1_bytes(n, n, [b""], compression=0),
             dw.ftex_bytes(n, n, 0, [b""])]
    for data in cases:
        with pytest.raises(Image.DecompressionBombError):
            _pil(data)
        t0 = time.perf_counter()
        with pytest.raises(ValueError, match="more pixels than PIL opens"):
            port_image.decode_image(data, "huge")
        assert time.perf_counter() - t0 < 0.5


def test_signatures_are_pils():
    """``DDS ``, ``BLP1`` / ``BLP2`` and ``FTEX`` at the start, as PIL's
    ``_accept`` functions; a byte off is no such file to either."""
    blocks = _blocks(np.random.default_rng(11), 4, 4, "BC1")
    cases = {"DDS": dw.dds_bytes(4, 4, [blocks], fourcc=b"DXT1"),
             "BLP": dw.blp2_bytes(4, 4, [blocks]),
             "FTEX": dw.ftex_bytes(4, 4, 0, [blocks])}
    for fmt, data in cases.items():
        assert port_image.image_format(data) == fmt
        _matches_pil(data)
    assert port_image.image_format(b"BLP1" + cases["BLP"][4:]) == "BLP"
    for bad in (b"DDS_", b"BLP3", b"FTEY"):
        with pytest.raises(Exception):
            _pil(bad + cases["DDS"][4:])
        with pytest.raises(ValueError, match="unsupported image format"):
            port_image.decode_image(bad + cases["DDS"][4:])


# ------------------------------------- BLP --------------------------------------

def _jpeg(px, mode="RGB", **kw):
    buf = io.BytesIO()
    Image.fromarray(px).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _blp1_jpeg(jpeg, w, h, alpha=0, split=None, offset_delta=0):
    cut = jpeg.index(b"\xff\xda") if split is None else split
    data = dw.blp1_bytes(w, h, [jpeg[cut:]], compression=0, alpha=alpha,
                         jpeg_header=jpeg[:cut])
    if offset_delta:  # move mip 0's offset (PIL skips forward, never back)
        (off,) = struct.unpack_from("<I", data, 28)
        data = data[:28] + struct.pack("<I", off + offset_delta) + data[32:]
    return data


def test_blp1_jpeg_forms(tmp_path):
    """PIL decodes the shared header plus mip 0 as a JPEG and stores its
    RGB as BGR (red and blue swap); grey, 4:2:0, alpha-flagged, a split
    inside the tables, an offset behind the header, and CMYK / YCCK streams
    (read as CMYK: a YCCK stream is not converted)."""
    from tools.make_torch_port_image_fixtures import cmyk_jpegs

    px = pattern(16, 24, 12)
    rgb = _jpeg(px, quality=90, subsampling=2)
    cases = {"rgb": _blp1_jpeg(rgb, 24, 16), "alpha": _blp1_jpeg(rgb, 24, 16, alpha=8),
             "split": _blp1_jpeg(rgb, 24, 16, split=40),
             "behind": _blp1_jpeg(rgb, 24, 16, offset_delta=-7),
             "grey": _blp1_jpeg(_jpeg(px, "L", quality=70), 24, 16),
             "narrower": _blp1_jpeg(rgb, 20, 16)}
    for name, jpeg in cmyk_jpegs().items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            w, h = Image.open(io.BytesIO(jpeg)).size
        cases[name] = _blp1_jpeg(jpeg, w, h)
    for name, data in cases.items():
        got = _matches_pil(data, name)
        (tmp_path / f"{name}.blp").write_bytes(data)
        _same_read(str(tmp_path / f"{name}.blp"))
        if name == "rgb":
            np.testing.assert_array_equal(got, _pil(rgb)[..., ::-1])
    _refused_as_pil(_blp1_jpeg(rgb, 32, 16), "BLP1 JPEG")       # fewer pixels than the image
    _refused_as_pil(_blp1_jpeg(rgb, 24, 16, offset_delta=9), "BLP")  # JPEG cut short
    _refused_as_pil(cases["rgb"][:-300], "BLP")


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("size", [(1, 1), (7, 3), (16, 16), (33, 9)])
def test_pil_written_palette_blps(tmp_path, version, size):
    w, h = size
    buf = io.BytesIO()
    Image.fromarray(pattern(h, w, w + h)).convert("P").save(buf, "BLP", blp_version=version)
    _matches_pil(buf.getvalue())
    (tmp_path / "p.blp").write_bytes(buf.getvalue())
    _same_read(str(tmp_path / "p.blp"))


@pytest.mark.parametrize("alpha", [0, 1, 8])
def test_palette_blps_with_alpha_and_short_data(alpha):
    r = np.random.default_rng(13 + alpha)
    pal = r.integers(0, 256, (256, 4), dtype=np.uint8)
    idx = r.integers(0, 256, 70, dtype=np.uint8).tobytes()
    for data in (dw.blp2_bytes(10, 7, [idx], encoding=1, alpha_depth=alpha, palette=pal),
                 dw.blp1_bytes(10, 7, [idx], alpha=alpha, palette=pal, encoding=4)):
        _matches_pil(data)
        _refused_as_pil(data[:-1], "BLP")  # mip 0's length passes the end of the file


@pytest.mark.parametrize("alpha_encoding", [0, 1, 7], ids=["DXT1", "DXT3", "DXT5"])
@pytest.mark.parametrize("alpha_depth", [0, 1, 8])
@pytest.mark.parametrize("size", [(16, 8), (14, 8), (10, 6), (5, 3), (1, 1)])
def test_blp2_dxt_matches_pils_python_decoder(alpha_encoding, alpha_depth, size):
    """BLP2's DXT blocks through the plugin's Python decoder: 5:6:5 by plain
    shifts, rows of 4 * ceil(W / 4) pixels read as a stream of W-pixel rows
    (a width off the block grid, or DXT3 / DXT5 without alpha, shift it)."""
    w, h = size
    form = {0: "BC1", 1: "BC2", 7: "BC3"}[alpha_encoding]
    r = np.random.default_rng(w * h + alpha_encoding * 7 + alpha_depth)
    data = dw.blp2_bytes(w, h, [_blocks(r, w, h, form)], alpha_depth=alpha_depth,
                         alpha_encoding=alpha_encoding)
    _matches_pil(data, "t.blp")


def test_blp2_python_dxt_parts_from_the_c_bcn_decoder():
    """The same drawn DXT1 / DXT3 / DXT5 blocks read by PIL through BLP2
    (its Python decoder) and through DDS (its C decoder) differ: the C
    decoder replicates the 5:6:5 endpoints' high bits. Each route equals
    the port's, and on blocks whose endpoints have no high bits to
    replicate they agree."""
    r = np.random.default_rng(14)
    for enc, fourcc, form in ((0, b"DXT1", "BC1"), (1, b"DXT3", "BC2"), (7, b"DXT5", "BC3")):
        blocks = _blocks(r, 32, 32, form)
        via_blp = _matches_pil(dw.blp2_bytes(32, 32, [blocks], alpha_depth=8,
                                             alpha_encoding=enc))
        via_dds = _matches_pil(dw.dds_bytes(32, 32, [blocks], fourcc=fourcc))
        assert (via_blp != via_dds).any(axis=-1).mean() > 0.5
        low = np.frombuffer(blocks, np.uint8).reshape(64, -1).copy()
        col = low[:, -8:-4].view("<u2")
        col &= np.uint16(0b00011_000111_00011)  # 5-bit r, b < 4 and 6-bit g < 8
        if enc == 0:
            col.sort(axis=1)
            col[:, :] = col[:, ::-1]  # c0 >= c1 ...
            col[:, 0] += col[:, 0] == col[:, 1]  # ... strictly: the 4-colour mode in both
        np.testing.assert_array_equal(
            _pil(dw.blp2_bytes(32, 32, [low.tobytes()], alpha_depth=8, alpha_encoding=enc)),
            _pil(dw.dds_bytes(32, 32, [low.tobytes()], fourcc=fourcc)))


BLP_REFUSALS = {
    "BLP2 encoding 3": dw.blp2_bytes(8, 8, [bytes(64)], encoding=3),
    "BLP2 alpha encoding 2": dw.blp2_bytes(8, 8, [bytes(64)], alpha_encoding=2),
    "BLP2 compression 0": dw.blp2_bytes(8, 8, [bytes(64)], compression=0),
    "BLP1 compression 2": dw.blp1_bytes(8, 8, [bytes(64)], compression=2),
    "BLP1 encoding 3": dw.blp1_bytes(8, 8, [bytes(64)], encoding=3),
    "BLP2 cut in the palette": dw.blp2_bytes(8, 8, [bytes(32)])[:600],
    "BLP2 cut in the blocks": dw.blp2_bytes(8, 8, [bytes(32)])[:-1],
    "BLP1 cut in the tables": dw.blp1_bytes(8, 8, [bytes(64)])[:100],
    "BLP2 header": dw.blp2_bytes(8, 8, [bytes(32)])[:15],
    "BLP2 zero width": dw.blp2_bytes(0, 8, [bytes(32)]),
}


@pytest.mark.parametrize("case", list(BLP_REFUSALS))
def test_every_blp_refusal_of_pil(case):
    _refused_as_pil(BLP_REFUSALS[case], "BLP")


# ------------------------------------- FTEX -------------------------------------

def test_ftex_forms(tmp_path):
    """DXT1 through the C decoder and raw RGB, edge sizes, a negative mip
    size (read to the end of the file) and trailing mips."""
    r = np.random.default_rng(15)
    for w, h in ((1, 1), (5, 3), (17, 9), (32, 8)):
        blocks = _blocks(r, w, h, "BC1")
        raw = r.integers(0, 256, w * h * 3, dtype=np.uint8).tobytes()
        for fmt, mip in ((0, blocks), (1, raw)):
            data = dw.ftex_bytes(w, h, fmt, [mip, bytes(8)])
            px = _matches_pil(data)
            neg = data[:32] + struct.pack("<i", -1) + data[36:]  # mip 0's size
            np.testing.assert_array_equal(_matches_pil(neg), px)
            path = tmp_path / f"t{fmt}.ftc"
            path.write_bytes(data)
            _same_read(str(path))


FTEX_REFUSALS = {
    "format 2": dw.ftex_bytes(4, 4, 2, [bytes(8)]),
    "two formats": dw.ftex_bytes(4, 4, 0, [bytes(8)])[:20] + struct.pack("<i", 2)
    + dw.ftex_bytes(4, 4, 0, [bytes(8)])[24:],
    "DXT1 short": dw.ftex_bytes(8, 4, 0, [bytes(15)]),
    "RGB short": dw.ftex_bytes(4, 4, 1, [bytes(47)]),
    "offset past the end": dw.ftex_bytes(4, 4, 0, [bytes(8)])[:28] + struct.pack("<i", 999)
    + dw.ftex_bytes(4, 4, 0, [bytes(8)])[32:],
    "negative offset": dw.ftex_bytes(4, 4, 0, [bytes(8)])[:28] + struct.pack("<i", -4)
    + dw.ftex_bytes(4, 4, 0, [bytes(8)])[32:],
    "negative size": dw.ftex_bytes(-4, 4, 1, [bytes(48)]),
    "header": dw.ftex_bytes(4, 4, 0, [bytes(8)])[:30],
}


@pytest.mark.parametrize("case", list(FTEX_REFUSALS))
def test_every_ftex_refusal_of_pil(case):
    _refused_as_pil(FTEX_REFUSALS[case], "FTEX")


# ------------------------------ writers and a render ------------------------------

def test_writers_encode_near_their_source():
    """``bc1_encode`` and ``bc7_mode6_encode`` (chip_smoke.py's 2048^2
    albedos) are read by PIL as the port reads them, close to the image
    they encode: the config-3 albedo at 256^2 (8 x 8 texel cells with
    independent noise a channel, which one line of colours a block cannot
    follow) within a mean of 7 levels, BC7 no further than BC1."""
    from akari_torch.scene.builtin import envtex_texture

    px = envtex_texture(256, 0)
    errs = []
    for form in ("BC1", "BC7"):
        got = _matches_pil(dw.dds_albedo(px, form))
        errs.append(np.abs(got.astype(int) - px.astype(int)).mean())
    assert errs[1] <= errs[0] < 7.0, errs
    levels = dw.mip_levels(px)
    assert [lv.shape[:2] for lv in levels] == [(256 >> k, 256 >> k) for k in range(9)]


def test_obj_map_kd_dds_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd albedo.dds`` (BC7): the texture
    tables and a 16x16 CPU render equal those of the same OBJ on a PNG of
    the DDS's decoded pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    data = dw.dds_albedo(pattern(24, 32, 9), "BC7")
    (tmp_path / "albedo.dds").write_bytes(data)
    (tmp_path / "albedo.png").write_bytes(port_image.encode_png(_pil(data)))
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = [], []
    for ext in ("dds", "png"):
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
    _same_read(str(tmp_path / "albedo.dds"))
