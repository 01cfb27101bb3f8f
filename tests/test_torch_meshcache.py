"""Port parity: the binary mesh cache (``akari_torch/scene/meshcache.py``),
SDL ``AkariMesh`` over caches, and the OBJ importer
(``akari_torch/cli/importer.py``) against akari_tpu. Caches are read
across packages bit for bit; the importer writes the JAX package's
``.akari`` text for the same OBJ; a scene through the importer's cache
renders bit-equal to the same scene through its OBJ. (The importer prints
material numbers with ``:g``, six significant digits, as the reference
does: the test's MTL uses values that print exactly, e.g. Ns 6 for a
roughness of 0.5.)
"""

import os

import numpy as np
import pytest
import torch

from akari_torch.cli import importer
from akari_torch.core.image import write_png
from akari_torch.integrators.path import PathConfig, render
from akari_torch.scene import meshcache, sdl
from akari_torch.scene.nodes import Mesh, MixMaterial
from akari_torch.scene.obj import load_obj
from akari_tpu.cli import importer as ref_importer
from akari_tpu.scene import meshcache as ref_meshcache
from akari_tpu.scene import sdl as ref_sdl

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_OBJ = os.path.join(ROOT, "scenes", "cornell_box", "CornellBox-Original.obj")
FIELDS = ("vertices", "indices", "material_ids", "corner_normals", "corner_uvs")


def _mesh_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _mesh_with_attributes():
    r = np.random.default_rng(0)
    return Mesh(vertices=r.random((6, 3)).astype(np.float32),
                indices=np.asarray([[0, 1, 2], [3, 4, 5], [0, 2, 4]], np.int64),
                material_ids=np.asarray([0, 1, 1], np.int64),
                corner_normals=r.random((3, 3, 3)).astype(np.float32),
                corner_uvs=r.random((3, 3, 2)).astype(np.float32))


@pytest.mark.parametrize("which", ["cornell", "attributes"])
def test_round_trip_and_cache(tmp_path, which):
    mesh = load_obj(CORNELL_OBJ) if which == "cornell" else _mesh_with_attributes()
    p = str(tmp_path / "m.mesh.npz")
    meshcache.save_mesh(p, mesh)
    meshcache.clear_cache()
    got = meshcache.load_mesh(p, materials=mesh.materials)
    _mesh_equal(got, mesh)
    assert got.materials == list(mesh.materials)
    os.remove(p)  # the path-keyed cache answers without the file
    again = meshcache.load_mesh(p)
    assert again.vertices is got.vertices and again.materials == []
    meshcache.clear_cache()
    with pytest.raises(FileNotFoundError):
        meshcache.load_mesh(p)


def test_bad_magic_raises(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, __magic__=np.frombuffer(b"NOT_A_MESH", np.uint8),
             vertices=np.zeros((3, 3), np.float32))
    for mod in (meshcache, ref_meshcache):
        mod.clear_cache()
        with pytest.raises(ValueError, match="bad mesh magic"):
            mod.load_mesh(p)
    assert meshcache.MAGIC == ref_meshcache.MAGIC


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_load_in_the_other_package(tmp_path, writer):
    mesh = _mesh_with_attributes()
    p = str(tmp_path / f"{writer}.mesh.npz")
    (meshcache if writer == "port" else ref_meshcache).save_mesh(p, mesh)
    meshcache.clear_cache()
    ref_meshcache.clear_cache()
    _mesh_equal(meshcache.load_mesh(p), mesh)
    _mesh_equal(ref_meshcache.load_mesh(p), mesh)
    q = str(tmp_path / "other.mesh.npz")
    (ref_meshcache if writer == "port" else meshcache).save_mesh(q, mesh)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def _akari_mesh(path, base_dir, mod=sdl):
    return mod.parse_string(f'export m = AkariMesh {{ path: "{path}" }}',
                            base_dir=str(base_dir)).exports["m"]


def test_akari_mesh_over_caches_and_fall_backs(tmp_path):
    import shutil

    obj = load_obj(CORNELL_OBJ)
    meshcache.clear_cache()
    meshcache.save_mesh(str(tmp_path / "a.npz"), obj)
    meshcache.save_mesh(str(tmp_path / "b.mesh.npz"), obj)
    shutil.copy(CORNELL_OBJ, tmp_path / "c.obj")
    shutil.copy(CORNELL_OBJ[:-4] + ".mtl", tmp_path / "CornellBox-Original.mtl")
    for mod in (sdl, ref_sdl):
        _mesh_equal(_akari_mesh("a.npz", tmp_path, mod), obj)     # the cache itself
        _mesh_equal(_akari_mesh("b.mesh", tmp_path, mod), obj)    # <path>.npz
        _mesh_equal(_akari_mesh("c.obj.mesh", tmp_path, mod), obj)  # the sibling OBJ
        with pytest.raises(mod.SDLError, match="d.obj.mesh"):
            _akari_mesh("d.obj.mesh", tmp_path, mod)
    from akari_torch.scene.sdl_nodes import _akari_mesh as node

    with pytest.raises(FileNotFoundError):
        node({"path": "d.npz"}, base_dir=str(tmp_path))
    # materials come from the SDL side
    src = ('export w = DiffuseMaterial { color: [0.5, 0.5, 0.5] }\n'
           'export m = AkariMesh { path: "a.npz", materials: [ $w ] }')
    m = sdl.parse_string(src, base_dir=str(tmp_path)).exports["m"]
    assert len(m.materials) == 1 and m.materials[0].color.value == (0.5, 0.5, 0.5)


def _write_textured_obj(d):
    """A floor with planar vt under a map_Kd PNG, a Diffuse/Glossy Mix
    box face and a lamp, as OBJ + MTL + PNG."""
    img = np.random.default_rng(2).uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    write_png(str(d / "tex.png"), img)
    (d / "m.mtl").write_text(
        "newmtl floor\nKd 1 1 1\nmap_Kd tex.png\n"
        "newmtl mix\nKd 0.6 0.3 0.2\nKs 0.4 0.4 0.4\nNs 6\n"
        "newmtl lamp\nKd 0 0 0\nKe 12 11 10\n")
    (d / "model.obj").write_text(
        "mtllib m.mtl\n"
        "v -2 0 -2\nv 2 0 -2\nv 2 0 2\nv -2 0 2\n"
        "v -0.5 0 -0.5\nv 0.5 0 -0.5\nv 0.5 1 -0.5\nv -0.5 1 -0.5\n"
        "v -0.4 2.4 -0.4\nv 0.4 2.4 -0.4\nv 0.4 2.4 0.4\nv -0.4 2.4 0.4\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl floor\nf 1/1 3/3 2/2\nf 1/1 4/4 3/3\n"
        "usemtl mix\nf 5 6 7\nf 5 7 8\n"
        "usemtl lamp\nf 9 10 11\nf 9 11 12\n")
    return d / "model.obj"


SCENE = """import "{mod}" as m
export scene = Scene {{
    camera: PerspectiveCamera {{ fov: 45, position: [0, 1.5, 4], rotation: [-15, 0, 0],
                               resolution: [16, 16] }},
    integrator: Path {{ spp: 2, max_depth: 3 }},
    shapes: [ {shape} ]
}}
"""


def test_importer_round_trip(tmp_path):
    obj = _write_textured_obj(tmp_path)
    out, ref_out = tmp_path / "port", tmp_path / "ref"
    assert importer.main([str(obj), "-o", str(out)]) == 0
    assert ref_importer.main([str(obj), "-o", str(ref_out)]) == 0
    text = (out / "model.akari").read_text()
    assert 'path: "model.mesh.npz"' in text and "MixMaterial" in text
    # the image outside the output directory is named by its absolute path
    assert "let model_mat1_A = DiffuseMaterial" in text and str(tmp_path / "tex.png") in text
    # the same SDL text and the same cache as the JAX package's importer
    assert text == (ref_out / "model.akari").read_text()
    meshcache.clear_cache()
    ref_meshcache.clear_cache()
    _mesh_equal(meshcache.load_mesh(str(out / "model.mesh.npz")),
                ref_meshcache.load_mesh(str(ref_out / "model.mesh.npz")))
    assert any(isinstance(m, MixMaterial) for m in load_obj(str(obj)).materials)

    # the imported scene renders as the OBJ scene does, bit for bit
    (tmp_path / "via_cache.akari").write_text(
        SCENE.format(mod="port/model.akari", shape="$m.mesh"))
    (tmp_path / "via_obj.akari").write_text(
        SCENE.format(mod="port/model.akari",
                     shape='AkariMesh { path: "model.obj" }'))
    imgs = []
    for name in ("via_cache", "via_obj"):
        node = sdl.parse_file(str(tmp_path / f"{name}.akari")).exports["scene"]
        scene = node.compile(intersector="dense", device="cpu")
        assert scene.textures.has_images and scene.materials.has_mix
        imgs.append(render(scene, node.camera, PathConfig(spp=2, max_depth=3)).numpy())
    assert imgs[0].mean() > 0.02
    np.testing.assert_array_equal(imgs[0], imgs[1])
