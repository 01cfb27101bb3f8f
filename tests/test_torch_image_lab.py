"""Port parity: Lab textures (akari_torch/core/lcms.py with
akari_torch/native/lcms_lab.cpp; Lab PSDs in core/image_formats.py, Lab
TIFFs in core/tiff.py) against PIL, through which the JAX package's
``read_image`` reads them.

PIL converts LAB to RGB with LittleCMS 2.17 (``ImageCms.buildTransform``
from the Lab v2 identity profile to the built-in sRGB, perceptual, no
flags). Tolerance: exact.

- the transform on all 2^24 (L, a, b) byte triples, held to PIL's
  ``convert("RGB")`` of them, and PIL's table held to Pillow's bundled
  ``liblcms2`` driven through ctypes with the same profiles and intent
  (the oracle); the facts the port's transform rests on are pinned
  against that library: the 33-point grid, the white fix-up that does not
  apply, the optimisation, the 3- and 4-byte RGB layouts, the node values
  of the table and the sRGB profile's colorant and adaptation tags;
- the Lab fixtures of ``tests/data/torch_port_images`` and their digests,
  and the 2048^2 albedo files ``chip_smoke.py`` phase 50 writes
  (``tests/data/torch_port_generated_images.json``);
- seeded drawn Lab PSDs (raw and PackBits, three to five channels) and Lab
  TIFFs (raw, PackBits, LZW, Deflate, LZMA, ZSTD and JPEG; both byte
  orders; strips, tiles, planes), held to PIL and to the JAX package's
  ``read_image`` with ``to_linear`` True and False bit for bit;
- seeded corruption: wherever PIL reads the file the port gives its
  pixels, and wherever PIL refuses it the port raises ``ValueError``;
- the forms PIL refuses (Lab at 16 bits, with extra samples, a Lab PSD of
  two channels), refused by the port naming them;
- the port reads Lab without PIL and without loading ``liblcms2``, and an
  OBJ whose ``map_Kd`` is a Lab TIFF renders bit-equal to the same OBJ on a
  PNG of its decoded pixels.
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core import lcms
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import (
    GENERATED,
    lab_albedo_files,
    lab_pnm_dib_icns_fixtures,
    plugin_albedo_files,
    psd_bytes,
    raster_albedo_files,
    tiff_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
FLIP = np.uint8([0, 128, 128])  # a TIFF stores a and b signed


def _all_triples():
    """[2^24, 3] uint8: every (L, a + 128, b + 128), L slowest."""
    idx = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([idx >> 16, (idx >> 8) & 255, idx & 255], axis=-1).astype(np.uint8)


def _pil_table(triples):
    """PIL's convert("RGB") of the LAB image holding ``triples``; its raw
    mode "LAB" flips the top bit of a and b, so the bytes go in flipped."""
    im = Image.frombytes("LAB", (4096, 4096), (triples ^ FLIP).tobytes())
    return np.asarray(im.convert("RGB")).reshape(-1, 3)


# --------------------------------------------------------------- the oracle

class _Lcms:
    """Pillow's bundled LittleCMS through ctypes, with the profiles PIL's
    Image.convert builds (cmsCreateLab2Profile(NULL), cmsCreate_sRGBProfile)."""

    LAB8 = (30 << 16) | (1 << 7) | (3 << 3) | 1   # PT_LabV2, 3 channels + 1, 8 bits (Pillow's)
    RGBA8 = (4 << 16) | (1 << 7) | (3 << 3) | 1
    RGB8 = (4 << 16) | (3 << 3) | 1
    LAB16 = (10 << 16) | (3 << 3) | 2
    RGB16 = (4 << 16) | (3 << 3) | 2

    def __init__(self):
        import PIL

        libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                      "pillow.libs", "liblcms2-*.so*"))
        assert libs, "Pillow's bundled liblcms2 not found"
        lib = self.lib = ctypes.CDLL(libs[0])
        lib.cmsCreateLab2Profile.restype = ctypes.c_void_p
        lib.cmsCreateLab2Profile.argtypes = [ctypes.c_void_p]
        lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
        lib.cmsCreateTransform.restype = ctypes.c_void_p
        lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                           ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
        lib.cmsDoTransform.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint32]
        lib.cmsDeleteTransform.argtypes = [ctypes.c_void_p]
        lib.cmsReadTag.restype = ctypes.c_void_p
        lib.cmsReadTag.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        self.version = lib.cmsGetEncodedCMMversion()
        self.lab = lib.cmsCreateLab2Profile(None)
        self.srgb = lib.cmsCreate_sRGBProfile()

    def run(self, src, flags=0, fmt_in=LAB8, fmt_out=RGBA8):
        """``src`` [n, k] (uint8 or uint16, k the format's bytes a pixel)
        through a perceptual transform with ``flags`` -> [n, 3]."""
        x = self.lib.cmsCreateTransform(self.lab, fmt_in, self.srgb, fmt_out, 0, flags)
        assert x
        n_out = 4 if fmt_out == self.RGBA8 else 3
        out = np.zeros((len(src), n_out), np.uint16 if fmt_out == self.RGB16 else np.uint8)
        src = np.ascontiguousarray(src)
        self.lib.cmsDoTransform(x, src.ctypes.data, out.ctypes.data, len(src))
        self.lib.cmsDeleteTransform(x)
        return out[:, :3]

    def tag(self, name, n=3):
        p = self.lib.cmsReadTag(self.srgb, int.from_bytes(name.encode(), "big"))
        return tuple(ctypes.cast(p, ctypes.POINTER(ctypes.c_double))[i] for i in range(n))


@pytest.fixture(scope="module")
def oracle():
    return _Lcms()


@pytest.fixture(scope="module")
def triples():
    return _all_triples()


@pytest.fixture(scope="module")
def pil_table(triples):
    return _pil_table(triples)


def test_every_lab_triple_converts_as_pil_converts_it(triples, pil_table):
    """All 2^24 byte triples: 0 pixels differ from PIL's convert("RGB"),
    and the port's side takes under 15 s on the CPU."""
    lcms.lab8_to_rgb8(triples[:1])  # build the native library outside the timing
    t0 = time.perf_counter()
    got = lcms.lab8_to_rgb8(triples)
    seconds = time.perf_counter() - t0
    assert got.dtype == np.uint8 and got.shape == triples.shape
    assert int((got != pil_table).any(axis=1).sum()) == 0
    assert seconds < 15.0


def test_bundled_liblcms2_gives_pils_table(oracle, triples, pil_table):
    """LittleCMS 2.17 itself, the Lab v2 profile to the built-in sRGB at
    the perceptual intent with no flags, in Pillow's formats (LAB with a
    skipped fourth byte, RGBA): PIL's table, so PIL's convert is that
    transform."""
    assert oracle.version == 2170
    src = np.concatenate([triples, np.zeros((len(triples), 1), np.uint8)], axis=1)
    np.testing.assert_array_equal(oracle.run(src), pil_table)


@pytest.mark.parametrize("flags, equal", [
    (33 << 16, True),          # cmsFLAGS_GRIDPOINTS(33): the default grid
    (17 << 16, False), (32 << 16, False), (34 << 16, False),
    (0x0004, True),            # cmsFLAGS_NOWHITEONWHITEFIXUP: no fix-up applies to Lab
    (0x0100, False),           # cmsFLAGS_NOOPTIMIZE: the float pipeline, unsampled
])
def test_liblcms2_flags_pin_the_port_design(oracle, pil_table, flags, equal):
    idx = np.random.default_rng(flags & 0xFFFF).integers(0, 1 << 24, 200_000)
    src = np.concatenate([_all_triples()[idx], np.zeros((len(idx), 1), np.uint8)], axis=1)
    got = oracle.run(src, flags)
    assert np.array_equal(got, pil_table[idx]) == equal


def test_rgb_and_rgba_output_formats_agree(oracle, pil_table):
    idx = np.random.default_rng(3).integers(0, 1 << 24, 200_000)
    src = np.concatenate([_all_triples()[idx], np.zeros((len(idx), 1), np.uint8)], axis=1)
    np.testing.assert_array_equal(oracle.run(src, fmt_out=oracle.RGB8), pil_table[idx])


def test_table_is_liblcms2s_pipeline_at_the_grid_nodes(oracle):
    """LittleCMS's unoptimised 16-bit transform (``cmsFLAGS_NOOPTIMIZE``,
    the same pipeline in float) at the grid's node inputs gives the port's
    table exactly: the table is that pipeline sampled. The optimised 16-bit
    transform is not a way to read the table: it differs from it at some
    nodes (by up to 6 at 18.5 % of them here)."""
    table = lcms.clut()
    assert table.shape == (33, 33, 33, 3) and table.dtype == np.uint16
    q = np.round(np.arange(33) * 65535.0 / 32).astype(np.uint16)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    got = oracle.run(nodes, 0x0100, fmt_in=oracle.LAB16, fmt_out=oracle.RGB16)
    np.testing.assert_array_equal(got, table.reshape(-1, 3))
    optimised = oracle.run(nodes, fmt_in=oracle.LAB16, fmt_out=oracle.RGB16)
    assert not np.array_equal(optimised, got)


def test_srgb_profile_matrices_equal_liblcms2s_tags(oracle):
    """The colorant tags (columns of the RGB -> XYZ matrix) and the
    chromatic adaptation tag LittleCMS stores, bit for bit."""
    m = lcms.srgb_colorants()
    for k, name in enumerate(("rXYZ", "gXYZ", "bXYZ")):
        assert oracle.tag(name) == (m[0][k], m[1][k], m[2][k])
    chad = lcms.adaptation((0.3127 / 0.3290, 1.0, (1 - 0.3127 - 0.3290) / 0.3290), lcms.D50)
    assert oracle.tag("chad", 9) == tuple(v for row in chad for v in row)


def test_probe_values():
    """Grey (128, 128, 128) reads (119, 119, 119); L* 100 reads (254, 255,
    254), not white (no white fix-up on a Lab input); black (1, 0, 1)."""
    got = lcms.lab8_to_rgb8(np.uint8([[128, 128, 128], [255, 128, 128], [0, 128, 128]]))
    assert got.tolist() == [[119, 119, 119], [254, 255, 254], [1, 0, 1]]
    assert lcms.lab8_to_rgb8(np.zeros((2, 3, 0, 3), np.uint8)).shape == (2, 3, 0, 3)
    with pytest.raises(ValueError, match="Lab bytes"):
        lcms.lab8_to_rgb8(np.zeros((2, 4), np.uint8))


# ---------------------------------------------------------------- the files

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


def _check(tmp_path, data, name, jax=False):
    """PIL reads the file from a path and the port gives its pixels (and,
    with ``jax``, both read_image give the same floats)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = _pil_path(str(path))
    got = port_image.decode_image(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if jax:
        _same_read(str(path))
    return got


LAB_FIXTURES = sorted(n for n in json.load(open(os.path.join(FIXTURES, "digests.json")))
                      if n.startswith(("lab_", "tiff_lab_", "tiff_pil_lab_")))


def test_lab_fixtures_are_the_tools_and_pils():
    import PIL

    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    written = lab_pnm_dib_icns_fixtures()
    assert len(LAB_FIXTURES) >= 11
    for name in LAB_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert written[name] == data, name
        px = _pil_path(os.path.join(FIXTURES, name))
        assert hashlib.sha256(px.tobytes()).hexdigest() == digests[name]["sha256"], name
        assert digests[name]["pil"] == PIL.__version__


@pytest.mark.parametrize("name", LAB_FIXTURES)
def test_lab_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        rec = json.load(f)[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


def test_generated_albedo_files_are_recorded_as_pil_reads_them():
    """The 2048^2 files chip_smoke.py phases 50, 51 and 52 write: the same
    bytes as recorded, PIL's decode as recorded, and the port's decode equal
    to it."""
    from akari_torch.scene.builtin import envtex_texture

    with open(GENERATED) as f:
        rec = json.load(f)
    albedo = envtex_texture(2048, 0)
    files = {**lab_albedo_files(albedo), **plugin_albedo_files(albedo),
             **raster_albedo_files(albedo)}
    assert sorted(files) == sorted(rec) == sorted([
        "albedo2048_lab.tif", "albedo2048_lab_lzw.tif", "albedo2048_lab_packbits.psd",
        "albedo2048.pfm", "albedo2048_24.dib", "albedo2048_rgb.im", "albedo2048_rgb.dcx",
        "albedo2048_ycc_orient1.pcd", "albedo2048_rle24.ras", "albedo2048_brun.flc",
        "albedo2048_grey8.fits"])
    for name, data in files.items():
        assert hashlib.sha256(data).hexdigest() == rec[name]["file_sha256"], name
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert hashlib.sha256(want.tobytes()).hexdigest() == rec[name]["sha256"], name
        np.testing.assert_array_equal(port_image.decode_image(data, name), want, err_msg=name)


def _lab(r, h, w):
    """Drawn Lab bytes with flat runs (PackBits runs) and the extremes."""
    lab = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    lab[:, : w // 3] = lab[:, :1]
    flat = lab.reshape(-1, 3)
    k = min(4, len(flat))
    flat[:k] = np.uint8([[0, 0, 0], [255, 255, 255], [255, 128, 128], [0, 128, 128]])[:k]
    return lab


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("form", ["raw", "packbits", "raw-alpha", "packbits-2-extra"])
def test_drawn_lab_psd_matches_pil_and_jax(tmp_path, form, seed):
    """Lab PSDs keep three channels whatever the file holds (PIL reads the
    first three planes; PackBits byte counts for three channels only, so a
    PackBits file of more channels reads as PIL reads it, or is refused as
    PIL refuses it)."""
    r = np.random.default_rng(seed + 10 * ["raw", "packbits", "raw-alpha",
                                           "packbits-2-extra"].index(form))
    h, w = int(r.integers(1, 30)), int(r.integers(1, 40))
    planes = np.moveaxis(_lab(r, h, w), -1, 0)
    extra = {"raw": 0, "packbits": 0, "raw-alpha": 1, "packbits-2-extra": 2}[form]
    planes = np.concatenate([planes, r.integers(0, 256, (extra, h, w)).astype(np.uint8)])
    data = psd_bytes(planes, 9, compression=0 if form.startswith("raw") else 1,
                     seed=int(r.integers(1 << 20)))
    path = tmp_path / "d.psd"
    path.write_bytes(data)
    try:
        want = _pil_path(str(path))
    except Exception:
        assert extra, "PIL refuses a three-channel Lab PSD"
        with pytest.raises(ValueError):
            port_image.decode_image(data, "d.psd")
        return
    np.testing.assert_array_equal(port_image.decode_image(data, "d.psd"), want)
    _same_read(str(path))


TIFF_FORMS = [(comp, order, layout) for comp in (1, 32773, 5, 8, 32946, 34925, 50000)
              for order in "<>" for layout in ("strips", "tiles", "planes")]


@pytest.mark.parametrize("comp, order, layout", TIFF_FORMS)
def test_drawn_lab_tiff_matches_pil_and_jax(tmp_path, comp, order, layout):
    """Interleaved samples: PIL's LAB unpacker flips a and b; planes: its
    band unpackers take them as stored; every compression the port reads,
    both byte orders."""
    r = np.random.default_rng(TIFF_FORMS.index((comp, order, layout)))
    h, w = int(r.integers(1, 40)), int(r.integers(1, 40))
    lab = _lab(r, h, w)
    kw = dict(order=order, compression=comp, seed=int(r.integers(1 << 20)))
    if layout == "tiles":
        kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))
    else:
        kw["rows_per_strip"] = int(r.integers(1, h + 1))
    if layout == "planes":
        kw["planar"] = 2
    if comp in (5, 8, 32946) and r.random() < 0.5:
        kw["predictor"] = 2
    got = _check(tmp_path, tiff_bytes(lab, 8, 8, **kw), "d.tif", jax=True)
    flipped = lcms.lab8_to_rgb8(lab if layout == "planes" else lab ^ FLIP)
    np.testing.assert_array_equal(got, flipped)


@pytest.mark.parametrize("quality", [30, 75, 95])
def test_pils_jpeg_lab_tiff_matches_pil_and_jax(tmp_path, quality):
    """Pillow's libtiff writer with JPEG compression: libjpeg passes the
    three components through unconverted, then the LAB unpacker."""
    r = np.random.default_rng(quality)
    lab = _lab(r, 37, 45)
    im = Image.frombytes("LAB", (45, 37), (lab ^ FLIP).tobytes())
    b = io.BytesIO()
    im.save(b, "TIFF", compression="jpeg", quality=quality)
    _check(tmp_path, b.getvalue(), "j.tif", jax=True)
    for comp in ("tiff_lzw", "packbits", "tiff_adobe_deflate"):
        b = io.BytesIO()
        im.save(b, "TIFF", compression=comp)
        got = _check(tmp_path, b.getvalue(), "p.tif")
        np.testing.assert_array_equal(got, lcms.lab8_to_rgb8(lab))


@pytest.mark.parametrize("seed", range(6))
def test_corrupted_lab_files_read_as_pil_or_are_refused(tmp_path, seed):
    r = np.random.default_rng(500 + seed)
    lab = _lab(r, 12, 17)
    bases = [psd_bytes(np.moveaxis(lab, -1, 0), 9, compression=seed % 2, seed=seed),
             tiff_bytes(lab, 8, 8, compression=(1, 5, 32773)[seed % 3], rows_per_strip=5,
                        seed=seed)]
    for k in range(40):
        base = bases[k % 2]
        data = bytearray(base)
        for _ in range(int(r.integers(1, 4))):
            data[int(r.integers(0, len(data)))] = int(r.integers(0, 256))
        if r.random() < 0.2:
            data = data[:int(r.integers(1, len(data)))]
        name = "c.psd" if k % 2 == 0 else "c.tif"
        path = tmp_path / name
        path.write_bytes(bytes(data))
        try:
            want = _pil_path(str(path))
        except Exception:
            want = None
        try:
            got = port_image.decode_image(bytes(data), name)
        except ValueError:
            got = None
        if want is None:
            assert got is None, f"case {k}: PIL refuses the file, the port reads it"
        else:
            assert got is not None, f"case {k}: PIL reads the file, the port refuses it"
            np.testing.assert_array_equal(got, want, err_msg=f"case {k}")


REFUSED = {
    "tiff-16-bit": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 16, 8), "unknown pixel mode"),
    "tiff-extra-sample": (lambda: tiff_bytes(np.zeros((2, 2, 4), int), 8, 8, extra=(2,)),
                          "unknown pixel mode"),
    "tiff-fill-order-2": (lambda: tiff_bytes(np.zeros((2, 2, 3), int), 8, 8, fill=2),
                          "unknown pixel mode"),
    "psd-16-bit": (lambda: psd_bytes(np.zeros((3, 2, 2), np.uint8), 9, 16, compression=0),
                   "PSD Lab at 16 bits"),
    "psd-two-channels": (lambda: psd_bytes(np.zeros((2, 2, 2), np.uint8), 9, compression=0),
                         "PSD Lab with 2 channels"),
}


@pytest.mark.parametrize("form", list(REFUSED))
def test_lab_forms_pil_refuses_are_refused_naming_them(tmp_path, form):
    make, match = REFUSED[form]
    data = make()
    path = tmp_path / ("r.psd" if form.startswith("psd") else "r.tif")
    path.write_bytes(data)
    with pytest.raises(Exception):
        _pil_path(str(path))
    with pytest.raises(ValueError, match=match):
        port_image.read_image(str(path))


def test_lab_reads_without_pil_or_liblcms2(tmp_path):
    """In a process where PIL cannot be imported, a Lab TIFF and a Lab PSD
    decode, and no liblcms2 is mapped; no module of the port names it."""
    lab = _lab(np.random.default_rng(8), 9, 11)
    (tmp_path / "l.tif").write_bytes(tiff_bytes(lab ^ FLIP, 8, 8, compression=5))
    (tmp_path / "l.psd").write_bytes(psd_bytes(np.moveaxis(lab, -1, 0), 9))
    code = (
        "import sys; sys.modules['PIL'] = None; sys.modules['jax'] = None\n"
        "sys.modules['akari_tpu'] = None\n"
        "import numpy as np\n"
        "from akari_torch.core.image import decode_image\n"
        f"a = decode_image(open({str(tmp_path / 'l.tif')!r}, 'rb').read())\n"
        f"b = decode_image(open({str(tmp_path / 'l.psd')!r}, 'rb').read())\n"
        "assert (a == b).all()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'lcms' not in maps.replace('libakr_lcms', ''), 'liblcms2 mapped'\n"
        "np.save(sys.stdout.buffer, a)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True)
    assert out.returncode == 0, out.stderr.decode()
    np.testing.assert_array_equal(np.load(io.BytesIO(out.stdout)), lcms.lab8_to_rgb8(lab))
    loads = []  # every shared library the port loads: only those it builds
    for dirpath, _, names in os.walk(os.path.join(ROOT, "akari_torch")):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    loads += [line.strip() for line in f if "CDLL(" in line]
    assert sorted(loads) == ["_loaded[name] = ctypes.CDLL(build(name))",
                             "lib = ctypes.CDLL(path)"]


def test_obj_map_kd_lab_tiff_renders_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd albedo.tif`` (an LZW Lab TIFF):
    the texture tables and a 16x16 CPU render equal those of the same OBJ
    on a PNG of the Lab file's decoded pixels."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    lab = _lab(np.random.default_rng(9), 24, 32)
    lab[..., 0] = np.maximum(lab[..., 0], 90)  # a lit texture
    data = tiff_bytes(lab ^ FLIP, 8, 8, compression=5, rows_per_strip=7)
    (tmp_path / "albedo.tif").write_bytes(data)
    (tmp_path / "albedo.png").write_bytes(port_image.encode_png(lcms.lab8_to_rgb8(lab)))
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
