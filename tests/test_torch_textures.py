"""Port parity: image I/O and image textures (akari_torch.core.image,
shading/texture.py, the texture tables of scene/nodes.py, OBJ ``map_Kd``,
SDL image-path textures, the textured branches of shading/soa.py) vs
akari_tpu.

Tolerances:

- ``read_image``: bit-equal to the JAX package's on .npy, .hdr (flat and
  RLE scanlines) and PNG (the reference decodes PNG with PIL: PNGs written
  by PIL in grey / RGB / RGBA, PNGs encoded here with each of the five
  scanline filters forced or a seeded filter per row, and the port's
  writer's output); ``write_hdr`` writes the reference's bytes (the other
  PNG forms and JPEG: tests/test_torch_image_decode.py);
- a JPEG-textured OBJ under a JPEG ``EnvMap``: tables exact, the 16x16
  render within the textured render's budget below;
- ``_bilinear`` at uv 0, 1, -0.0 and wrapped values: allclose 1e-6 (the
  texel picks are exact; the weights round alike);
- compiled texture tables: exact;
- a textured 16x16 render, per sample, against the JAX program: the
  outlier budget of tests/test_torch_path.py's per-sample check
  (outlier_frac 0.005, mean_tol 2e-4);
- d loss / d tex_value against jax.grad (16x16, 1 spp, depth 2): the
  loss rtol 1e-6, NaN on the same entries, the rest within 1e-5 of max|g|
  (measured 3.4e-6: the glossy lobe amplifies XLA's and torch's few-ulp
  transcendental differences, as in tests/test_torch_diff.py).
"""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import akari_torch.scene.nodes as port_nodes
import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from _port_diff import assert_grad_parity, both, port_camera, port_value_and_grad, take_gathers
from akari_torch.core import image as port_image
from akari_torch.diff.inverse import apply_params
from akari_torch.integrators import path as port_path
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene import sdl as port_sdl
from akari_torch.scene.obj import load_obj as port_load_obj
from akari_torch.shading import texture as port_texture
from akari_tpu.core import image as ref_image
from akari_tpu.core import transform as ref_xf
from akari_tpu.diff.inverse import scene_params as ref_scene_params
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene import sdl as ref_sdl
from akari_tpu.scene.arrays import make_camera as ref_make_camera
from akari_tpu.scene.obj import load_obj as ref_load_obj
from akari_tpu.shading import texture as ref_texture

torch.set_num_threads(2)

TEX_FIELDS = ("kind", "value", "image_id", "images", "image_sizes")


def _pattern(h, w, seed, kind="noise"):
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        return r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "gradient":
        return np.stack([(x * 5) % 256, (y * 4) % 256, ((x + y) * 3) % 256], -1).astype(np.uint8)
    smooth = 128 + 60 * (np.sin(x / 5.0) * np.cos(y / 7.0))[..., None]
    return (smooth + r.normal(0, 3, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _png_filtered(pixels, ftypes):
    """[H, W, C] uint8 (C = 1, 3, 4) -> PNG bytes with filter ``ftypes`` on
    every scanline, or ``ftypes[y]`` on row y (the PNG specification's
    filters, written out)."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    out = []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        ftype = int(np.broadcast_to(ftypes, (h,))[y])
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prior
        elif ftype == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
            f = cur - pred
        out.append(bytes([ftype]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    ctype = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (port_image.PNG_SIGNATURE + port_image._chunk(b"IHDR", ihdr)
            + port_image._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + port_image._chunk(b"IEND", b""))


def _same_read(path):
    got, want = port_image.read_image(path), ref_image.read_image(path)
    # the same dtype too: float32, and float64 from .hdr as the reference's
    # decoder leaves it (compile casts to float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    raw_got, raw_want = (port_image.read_image(path, to_linear=False),
                         ref_image.read_image(path, to_linear=False))
    np.testing.assert_array_equal(raw_got, raw_want)
    return got


# ------------------------------- image I/O -------------------------------------

def test_read_npy_and_hdr_match_reference(tmp_path):
    r = np.random.default_rng(0)
    for name, arr in (("rgb.npy", r.uniform(0, 4, (5, 7, 3))), ("grey.npy", r.uniform(0, 1, (4, 6))),
                      ("rgba.npy", r.uniform(0, 1, (3, 3, 4)))):
        np.save(tmp_path / name, arr.astype(np.float64))
        _same_read(str(tmp_path / name))
    img = r.uniform(0, 50, (9, 13, 3)).astype(np.float32)
    img[0, 0] = 0.0
    ref_image.write_hdr(str(tmp_path / "flat.hdr"), img)
    _same_read(str(tmp_path / "flat.hdr"))
    # new-RLE scanlines: runs and literals (tests/test_image_io.py's layout)
    w, h = 16, 3
    payload = bytearray()
    for y in range(h):
        payload += bytes([2, 2, 0, w])
        payload += bytes([128 + 16, 100 + y]) + bytes([16]) + bytes(range(16))
        payload += bytes([128 + 8, 7, 8]) + bytes(range(8)) + bytes([128 + 16, 130])
    with open(tmp_path / "rle.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
        f.write(bytes(payload))
    got = _same_read(str(tmp_path / "rle.hdr"))
    assert got[2, 0, 0] == np.float32((102 + 0.5) * 2.0 ** (130 - 136))


def test_write_hdr_round_trip_and_bytes(tmp_path):
    r = np.random.default_rng(1)
    img = r.uniform(0, 20, (6, 10, 3)).astype(np.float32)
    img[1, 2] = 0.0
    img[2, 3] = (1e-30, 2.0, 0.5)
    port_image.write_hdr(str(tmp_path / "p.hdr"), img)
    ref_image.write_hdr(str(tmp_path / "r.hdr"), img)
    assert (tmp_path / "p.hdr").read_bytes() == (tmp_path / "r.hdr").read_bytes()
    back = _same_read(str(tmp_path / "p.hdr"))
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    maxc = img.max(-1, keepdims=True)
    assert np.all(np.abs(back - img) <= maxc * 2 ** -7)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("kind", ["noise", "gradient", "smooth"])
def test_read_png_written_by_pil_matches_reference(tmp_path, mode, kind):
    path = str(tmp_path / f"{kind}_{mode}.png")
    Image.fromarray(_pattern(40, 33, 2, kind)).convert(mode).save(path)
    _same_read(path)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_every_filter_type_matches_reference(tmp_path, ftype, channels):
    px = _pattern(17, 23, 3 + ftype, "smooth")
    px = px[..., :1] if channels == 1 else (
        px if channels == 3 else np.concatenate([px, px[..., :1] // 2], -1))
    path = tmp_path / f"f{ftype}_{channels}.png"
    path.write_bytes(_png_filtered(px, ftype))
    _same_read(str(path))


@pytest.mark.parametrize("hw", [(1, 1), (1, 12), (31, 9), (9, 31)])
def test_read_png_mixed_row_filters_matches_reference(tmp_path, hw):
    """A seeded filter type per row, on images taller and wider than they
    are wide and tall: the decoder steps along anti-diagonals."""
    h, w = hw
    px = _pattern(h, w, 7, "smooth")
    ftypes = np.random.default_rng(h * 100 + w).integers(0, 5, h)
    path = tmp_path / f"mixed_{h}x{w}.png"
    path.write_bytes(_png_filtered(px, ftypes))
    np.testing.assert_array_equal(_same_read(str(path)), port_image.read_image(str(path)))
    np.testing.assert_array_equal(port_image.decode_png(path.read_bytes()), px)


def test_png_writer_output_reads_back(tmp_path):
    px = _pattern(20, 30, 4)
    path = tmp_path / "w.png"
    path.write_bytes(port_image.encode_png(px))
    np.testing.assert_array_equal(port_image.decode_png(path.read_bytes()), px)
    _same_read(str(path))


def test_png_writer_filters_rows_as_other_encoders_do(tmp_path):
    """The writer picks a filter per row: a smooth image takes the Average
    / Paeth kinds, and PIL reads the pixels back."""
    px = _pattern(20, 30, 4, "smooth")
    data = port_image.encode_png(px)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:-16])
    assert set(np.frombuffer(raw, np.uint8).reshape(20, 91)[:, 0].tolist()) & {3, 4}
    path = tmp_path / "w.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), px)
    _same_read(str(path))


def test_unsupported_images_name_their_format(tmp_path):
    """What the decoders still refuse: hierarchical and 12-bit JPEG,
    PNG headers outside the specification, a BMP header PIL does not
    read, a 16-bit Lab TIFF (PIL has no mode for it), a DDS FourCC PIL does
    not read (DXT2) and a JP2 header PIL's plugin gives up on. DDS,
    arithmetic-coded JPEG, CCITT Group 4 TIFF, an 8-bit Lab TIFF (which PIL
    converts with LittleCMS 2.17's Lab -> sRGB transform) and AVIF (with
    loop restoration at a slow writer speed), which PIL opens, read as the
    reference reads them."""
    Image.fromarray(_pattern(8, 8, 5)).save(tmp_path / "a.jpg")
    data = (tmp_path / "a.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")
    (tmp_path / "arith.jpg").write_bytes(data[:sof + 1] + b"\xc9" + data[sof + 2:])
    _same_read(str(tmp_path / "arith.jpg"))
    (tmp_path / "sof5.jpg").write_bytes(data[:sof + 1] + b"\xc5" + data[sof + 2:])
    with pytest.raises(ValueError, match="hierarchical"):
        port_image.read_image(str(tmp_path / "sof5.jpg"))
    (tmp_path / "d12.jpg").write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(ValueError, match="12-bit"):
        port_image.read_image(str(tmp_path / "d12.jpg"))
    ihdr = struct.pack(">IIBBBBB", 8, 8, 16, 3, 0, 0, 0)  # 16-bit palette: no such PNG
    (tmp_path / "p16.png").write_bytes(port_image.PNG_SIGNATURE + port_image._chunk(b"IHDR", ihdr)
                                       + port_image._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bit depth 16, colour type 3"):
        port_image.read_image(str(tmp_path / "p16.png"))
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="BMP header of 0 bytes"):
        port_image.read_image(str(tmp_path / "x.bmp"))
    Image.fromarray(_pattern(8, 8, 5)).convert("1").save(tmp_path / "g4.tif",
                                                           compression="group4")
    _same_read(str(tmp_path / "g4.tif"))
    from tools.make_torch_port_image_fixtures import tiff_bytes

    (tmp_path / "lab.tif").write_bytes(tiff_bytes(np.full((2, 2, 3), 128), 8, 8))
    assert np.asarray(Image.open(tmp_path / "lab.tif").convert("RGB")).shape == (2, 2, 3)
    _same_read(str(tmp_path / "lab.tif"))
    (tmp_path / "lab16.tif").write_bytes(tiff_bytes(np.full((2, 2, 3), 128), 16, 8))
    with pytest.raises(Exception):
        Image.open(tmp_path / "lab16.tif").convert("RGB")
    with pytest.raises(ValueError, match="photometric 8.*unknown pixel mode"):
        port_image.read_image(str(tmp_path / "lab16.tif"))
    from tools.dds_writers import dds_bytes

    blocks = np.random.default_rng(5).integers(0, 256, 32, dtype=np.uint8).tobytes()
    (tmp_path / "x.dds").write_bytes(dds_bytes(8, 8, [blocks], fourcc=b"DXT2"))
    with pytest.raises(ValueError, match="DDS of FourCC b'DXT2'"):
        port_image.read_image(str(tmp_path / "x.dds"))
    (tmp_path / "y.dds").write_bytes(dds_bytes(8, 8, [blocks], fourcc=b"DXT1"))
    _same_read(str(tmp_path / "y.dds"))
    # a JP2 signature before a box of length 2: PIL's plugin gives up on its
    # header and no other format takes it; the port refuses it too
    (tmp_path / "x.jp2").write_bytes(b"\0\0\0\x0cjP  \r\n\x87\n" + struct.pack(">IIBB", 2, 2, 3, 0)
                                     + bytes(20))
    with pytest.raises(Exception):
        Image.open(tmp_path / "x.jp2").convert("RGB")
    with pytest.raises(ValueError, match="unsupported image format.*PIL gives up on it"):
        port_image.read_image(str(tmp_path / "x.jp2"))
    # AVIF: read at the writer's default speed, and at a slow speed that
    # turns on loop restoration, as the reference reads them
    Image.fromarray(_pattern(8, 8, 5)).save(tmp_path / "x.avif", "AVIF")
    _same_read(str(tmp_path / "x.avif"))
    Image.fromarray(_pattern(64, 64, 5, "smooth")).save(tmp_path / "lr.avif", "AVIF", speed=2)
    assert np.asarray(Image.open(tmp_path / "lr.avif").convert("RGB")).shape == (64, 64, 3)
    _same_read(str(tmp_path / "lr.avif"))


# ------------------------------- _bilinear -------------------------------------

def test_bilinear_matches_reference_at_edges():
    r = np.random.default_rng(6)
    a = r.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    b = r.uniform(0, 1, (3, 4, 3)).astype(np.float32)
    images = np.zeros((2, 5, 7, 3), np.float32)
    images[0], images[1, :3, :4] = a, b
    sizes = np.asarray([[5, 7], [3, 4]], np.int32)
    edge = [0.0, 1.0, -0.0, 0.5, 1e-9, -1e-9, 1.0 - 2 ** -24, 2.0, -3.25, 0.07142857, 17.3]
    uu, vv = np.meshgrid(np.asarray(edge, np.float32), np.asarray(edge, np.float32))
    uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    uv = np.concatenate([uv, r.uniform(-2, 3, (300, 2)).astype(np.float32)])
    for img_id in (0, 1):
        ids = np.full(uv.shape[0], img_id, np.int32)
        got = port_texture._bilinear(torch.from_numpy(images), torch.from_numpy(sizes),
                                     torch.from_numpy(ids), torch.from_numpy(uv)).numpy()
        want = np.asarray(ref_texture._bilinear(jnp.asarray(images), jnp.asarray(sizes),
                                                jnp.asarray(ids), jnp.asarray(uv)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --------------------------- scenes with image textures ------------------------

def _images(tmp_path):
    """Three seeded PNGs (albedo, roughness, mix fraction) and an .npy
    emitter image in tmp_path; returns their paths."""
    paths = {}
    for name, (h, w, seed) in {"albedo": (12, 9, 7), "rough": (5, 6, 8), "frac": (4, 4, 9)}.items():
        paths[name] = str(tmp_path / f"{name}.png")
        px = _pattern(h, w, seed, "smooth" if name == "albedo" else "noise")
        if name == "rough":  # roughness 0.4-1 (linear): a rough-glossy map
            px = (170 + px // 3).astype(np.uint8)
        Image.fromarray(px).save(paths[name])
    paths["glow"] = str(tmp_path / "glow.npy")
    np.save(paths["glow"], np.random.default_rng(10).uniform(8.0, 36.0, (3, 5, 3)).astype(np.float32))
    return paths


def textured_shapes(mod, paths):
    """A floor with an image albedo, a glossy panel with image roughness, a
    Mix with an image fraction, an image-textured emitter and a constant
    one, from ``mod``'s node types (uvs span [-0.5, 1.5] to wrap)."""
    tex = {k: mod.ImageTexture.load(p) for k, p in paths.items()}
    floor = mod.Mesh(
        vertices=np.asarray([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
        indices=np.asarray([[0, 2, 1], [0, 3, 2]], np.int64),
        uvs=np.asarray([[-0.5, -0.5], [1.5, -0.5], [1.5, 1.5], [-0.5, 1.5]], np.float32),
        materials=[mod.DiffuseMaterial(tex["albedo"])],
    )
    glossy = mod.GlossyMaterial((0.9, 0.8, 0.7), roughness=tex["rough"])
    mix = mod.MixMaterial(fraction=tex["frac"], material_a=mod.DiffuseMaterial((0.2, 0.5, 0.8)),
                          material_b=glossy)
    panel = mod.Mesh(
        vertices=np.asarray([[-1.5, 0, -1], [-0.2, 0, -1.2], [-0.2, 1.2, -1.2], [-1.5, 1.2, -1],
                             [0.2, 0, -1.2], [1.5, 0, -1], [1.5, 1.2, -1], [0.2, 1.2, -1.2]],
                            np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int64),
        uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float32),
        materials=[glossy, mix], material_ids=np.asarray([0, 0, 1, 1], np.int64),
    )
    lamps = mod.Mesh(
        vertices=np.asarray([[-0.6, 2.5, -0.4], [0.0, 2.5, -0.4], [0.0, 2.5, 0.4], [-0.6, 2.5, 0.4],
                             [0.2, 2.4, -0.3], [0.7, 2.4, -0.3], [0.7, 2.4, 0.3], [0.2, 2.4, 0.3]],
                            np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int64),
        uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float32),
        materials=[mod.EmissiveMaterial(tex["glow"]), mod.EmissiveMaterial((20.0, 16.0, 12.0))],
        material_ids=np.asarray([0, 0, 1, 1], np.int64),
    )
    return [floor, panel, lamps]


C2W = ref_xf.translate((0.0, 1.6, 3.2)) @ ref_xf.rotate_x(np.radians(-25.0))


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    paths = _images(tmp_path_factory.mktemp("tex"))
    ref_c = ref_nodes.compile_scene(textured_shapes(ref_nodes, paths), intersector="brute")
    ref, port = both(ref_c)
    cam_r = ref_make_camera(C2W, 50.0, 16, 16)
    return paths, ref_c, ref, port, cam_r, port_camera(cam_r)


def _tables_equal(a, b):
    for f in TEX_FIELDS:
        got, want = getattr(a.textures, f), np.asarray(getattr(b.textures, f))
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    assert a.textures.has_images == bool(b.textures.has_images)
    for f in ("kind", "color_tex", "roughness_tex", "fraction_tex", "mix_a", "mix_b"):
        np.testing.assert_array_equal(getattr(a.materials, f).numpy(),
                                      np.asarray(getattr(b.materials, f)), err_msg=f)
    for f in ("cdf", "pdf", "tri_id"):
        np.testing.assert_array_equal(getattr(a.lights, f).numpy(),
                                      np.asarray(getattr(b.lights, f)), err_msg=f)


def test_texture_tables_compile_equal(textured):
    paths, ref_c, *_ = textured
    port = port_nodes.compile_scene(textured_shapes(port_nodes, paths), intersector="dense",
                                    device="cpu")
    assert port.textures.has_images and port.textures.images.shape[0] == 4
    _tables_equal(port, ref_c)


def test_obj_map_kd_and_sdl_image_textures_compile_equal(tmp_path):
    Image.fromarray(_pattern(6, 10, 11, "smooth")).save(tmp_path / "wood.png")
    (tmp_path / "m.mtl").write_text("newmtl wood\nKd 1 1 1\nmap_Kd wood.png\n"
                                    "newmtl lamp\nKe 6 5 4\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv 0 2 0\nv 0.3 2 0\nv 0 2 0.3\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl wood\nf 1/1 3/3 2/2\nf 1/1 4/4 3/3\n"
        "usemtl lamp\nf 5 6 7\n")
    mp, mr = port_load_obj(str(tmp_path / "m.obj")), ref_load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(mp.materials[0].color.image, mr.materials[0].color.image)
    _tables_equal(port_nodes.compile_scene([mp], intersector="dense", device="cpu"),
                  ref_nodes.compile_scene([mr], intersector="brute"))
    src = ('export s = Scene { shapes: [ AkariMesh { path: "m.obj", materials: '
           '[ DiffuseMaterial { color: "wood.png" }, EmissiveMaterial { color: [4, 4, 4] } ] } ] }')
    (tmp_path / "s.akari").write_text(src)
    sp = port_sdl.parse_file(str(tmp_path / "s.akari")).exports["s"]
    sr = ref_sdl.parse_file(str(tmp_path / "s.akari")).exports["s"]
    _tables_equal(sp.compile(intersector="dense", device="cpu"), sr.compile(intersector="brute"))


def test_textured_render_matches_jax(textured):
    _, _, ref, port, cam_r, cam_p = textured
    cfg_r = ref_path.PathConfig(spp=1, max_depth=3)
    cfg_p = port_path.PathConfig(spp=1, max_depth=3)

    @jax.jit
    def one(s):
        ifn, ofn, ffn = ref_path._jax_intersectors_soa(ref)
        return ref_path.trace_paths(ref, cam_r, cfg_r, jnp.uint32(0), jnp.full(256, s, jnp.uint32),
                                    jnp.arange(256, dtype=jnp.uint32), ifn, ofn, jnp, fused_fn=ffn)

    got = np.mean([port_path.trace_paths(port, cam_p, cfg_p, 0, torch.full((256,), s),
                                         torch.arange(256)).numpy() for s in range(3)], 0)
    want = np.mean([np.asarray(one(s)) for s in range(3)], 0)
    assert got.mean() > 0.05
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-4)


def test_texture_value_gradient_matches_jax(textured, monkeypatch):
    """d loss / d tex_value of a 16x16, 1 spp, depth 2 render against
    jax.grad of the reference's unrolled trace (NaN entries, from masked
    sqrt'(0) branches, in the same places; ROADMAP Queue 3)."""
    from akari_tpu.diff.inverse import apply_params as ref_apply_params

    take_gathers(monkeypatch)
    _, _, ref, port, cam_r, cam_p = textured
    target = np.full((16, 16, 3), 0.2, np.float32)

    def loss(p):
        return loss_and_image(apply_params(port, p), cam_p, port_path.PathConfig(spp=1, max_depth=2),
                              torch.from_numpy(target))[0]

    got_loss, g = port_value_and_grad(loss, {"tex_value": np.asarray(port.textures.value)})
    cfg_r = ref_path.PathConfig(spp=1, max_depth=2, unroll=True)

    def f(params):
        sc = ref_apply_params(ref, params)
        ifn, ofn, ffn = ref_path._jax_intersectors_soa(sc)
        li = ref_path.trace_paths(sc, cam_r, cfg_r, jnp.uint32(0), jnp.zeros(256, jnp.uint32),
                                  jnp.arange(256, dtype=jnp.uint32), ifn, ofn, jnp, fused_fn=ffn)
        return jnp.sum((li - jnp.asarray(target).reshape(-1, 3)) ** 2) / (256 * 3)

    want_loss, want = jax.value_and_grad(f)(ref_scene_params(ref))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-6)
    assert_grad_parity(g["tex_value"], np.asarray(want["tex_value"]), 1e-5)


def test_scene_without_images_skips_the_image_branch(monkeypatch):
    """A constant-texture scene never evaluates a texture per lane."""
    from akari_torch.scene.builtin import cornell_box

    calls = []
    monkeypatch.setattr(port_texture, "_bilinear", lambda *a: calls.append(1))
    sc = cornell_box(8, 8)
    scene = sc.compile(device="cpu")
    assert not scene.textures.has_images
    port_path.render(scene, sc.camera, port_path.PathConfig(spp=1, max_depth=3))
    assert calls == []


def test_image_textures_of_the_sdl_resolve_relative_paths(tmp_path):
    Image.fromarray(_pattern(4, 4, 12)).save(tmp_path / "t.png")
    mat = port_sdl.parse_string('export m = DiffuseMaterial { color: "t.png" }',
                                base_dir=str(tmp_path)).exports["m"]
    assert isinstance(mat.color, port_nodes.ImageTexture)
    assert mat.color.path == os.path.abspath(tmp_path / "t.png")
    np.testing.assert_array_equal(mat.color.image, ref_image.read_image(str(tmp_path / "t.png")))


def test_png_decoder_needs_no_pil(tmp_path):
    """The decoders import no PIL: with PIL blocked, a progressive JPEG and
    an Adam7 palette PNG decode to PIL's pixels."""
    import hashlib
    import subprocess
    import sys

    from tools.make_torch_port_image_fixtures import png_bytes

    Image.fromarray(_pattern(21, 30, 15, "smooth")).save(tmp_path / "p.jpg", progressive=True)
    idx = np.random.default_rng(16).integers(0, 16, (9, 11, 1))
    plte = np.random.default_rng(17).integers(0, 256, (16, 3)).astype(np.uint8).tobytes()
    (tmp_path / "i.png").write_bytes(png_bytes(idx, 4, 3, interlace=1, plte=plte))
    want = [hashlib.sha256(np.asarray(Image.open(tmp_path / n).convert("RGB")).tobytes()).hexdigest()
            for n in ("p.jpg", "i.png")]
    code = ("import hashlib, sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import numpy as np, akari_torch.core.image as m\n"
            "px = m.decode_png(m.encode_png(np.zeros((2, 3, 3), 'uint8')))\n"
            "print(px.shape)\n"
            "for n in ('p.jpg', 'i.png'):\n"
            "    raw = m.read_image(sys.argv[1] + '/' + n, to_linear=False)\n"
            "    print(hashlib.sha256((raw * 255).round().astype('uint8').tobytes()).hexdigest())\n"
            "print(any(k.split('.')[0] == 'PIL' and v is not None for k, v in sys.modules.items()))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.split() == ["(2,", "3,", "3)", *want, "False"]


def test_jpeg_textured_obj_under_a_jpeg_envmap_matches_jax(tmp_path):
    """An OBJ whose map_Kd is a 4:2:0 JPEG, lit by an SDL EnvMap read from
    a progressive JPEG and a lamp: texture and env tables compile equal
    (the port's decoder gives PIL's pixels), and a 16x16 render matches
    the JAX program per sample within the textured render's budget."""
    Image.fromarray(_pattern(24, 40, 13, "smooth")).save(tmp_path / "wood.jpg", quality=80)
    sky = (_pattern(16, 32, 14, "smooth") // 2 + 100).astype(np.uint8)
    Image.fromarray(sky).save(tmp_path / "sky.jpg", quality=90, progressive=True)
    (tmp_path / "m.mtl").write_text("newmtl wood\nKd 1 1 1\nmap_Kd wood.jpg\n"
                                    "newmtl lamp\nKe 6 5 4\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv -2 0 -2\nv 2 0 -2\nv 2 0 2\nv -2 0 2\nv -0.4 2 -0.4\nv 0.4 2 -0.4\n"
        "v 0 2 0.4\nvt -0.5 -0.5\nvt 1.5 -0.5\nvt 1.5 1.5\nvt -0.5 1.5\nusemtl wood\n"
        "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    (tmp_path / "s.akari").write_text(
        'export env = EnvMap { image: "sky.jpg", scale: 1.5 }\n'
        'export s = Scene { environment: $env, shapes: [ AkariMesh { path: "m.obj" } ] }\n')
    sp = port_sdl.parse_file(str(tmp_path / "s.akari")).exports["s"]
    sr = ref_sdl.parse_file(str(tmp_path / "s.akari")).exports["s"]
    port, ref_c = sp.compile(intersector="dense", device="cpu"), sr.compile(intersector="brute")
    _tables_equal(port, ref_c)
    np.testing.assert_array_equal(port.env_image.numpy(), np.asarray(ref_c.env_image))
    ref, _ = both(ref_c)
    cam_r = ref_make_camera(C2W, 50.0, 16, 16)
    cam_p = port_camera(cam_r)
    cfg_r = ref_path.PathConfig(spp=1, max_depth=3)
    cfg_p = port_path.PathConfig(spp=1, max_depth=3)

    @jax.jit
    def one(s):
        ifn, ofn, ffn = ref_path._jax_intersectors_soa(ref)
        return ref_path.trace_paths(ref, cam_r, cfg_r, jnp.uint32(0), jnp.full(256, s, jnp.uint32),
                                    jnp.arange(256, dtype=jnp.uint32), ifn, ofn, jnp, fused_fn=ffn)

    got = np.mean([port_path.trace_paths(port, cam_p, cfg_p, 0, torch.full((256,), s),
                                         torch.arange(256)).numpy() for s in range(3)], 0)
    want = np.mean([np.asarray(one(s)) for s in range(3)], 0)
    assert got.mean() > 0.05
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-4)
