"""Port parity: scene compile, SDL, OBJ, BVH order and host helpers
(akari_torch.scene / bvh / core vs akari_tpu). Tolerance: none. Both
compiles run the same NumPy arithmetic on the host, so every array must be
equal exactly; prim ids and lights depend on the storage order."""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from akari_torch.bvh.build import NATIVE_MIN_TRIS, build_bvh
from akari_torch.core import distribution, transform
from akari_torch.scene import sdl
from akari_torch.scene.arrays import from_numpy_scene
from akari_torch.scene.builtin import cornell_box
from akari_torch.scene.nodes import (
    DiffuseMaterial,
    EmissiveMaterial,
    GlassMaterial,
    GlossyMaterial,
    Mesh,
    MirrorMaterial,
    MixMaterial,
    Scene,
)
from akari_torch.scene.obj import load_obj
from akari_tpu.core import distribution as ref_distribution
from akari_tpu.core import transform as ref_transform
from akari_tpu.scene import builtin as ref_builtin
from akari_tpu.scene import nodes as ref_nodes
from akari_tpu.scene import sdl as ref_sdl
from akari_tpu.scene.obj import load_obj as ref_load_obj

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")
CORNELL_OBJ = os.path.join(ROOT, "scenes", "cornell_box", "CornellBox-Original.obj")

FIELDS = [
    "tri_v0", "tri_e1", "tri_e2", "normals", "uvs", "mat_id", "prim_table",
    "prim_to_orig",
    "materials.kind", "materials.color_tex", "materials.roughness_tex",
    "materials.fraction_tex", "materials.mix_a", "materials.mix_b",
    "materials.double_sided", "materials.ior",
    "textures.kind", "textures.value",
    "lights.tri_id", "lights.cdf", "lights.pdf", "lights.tri_to_light",
    "bvh.node_lo", "bvh.node_hi", "bvh.first", "bvh.count", "bvh.miss",
]
STATICS = [
    "n_tris", "n_materials", "lights.n_lights", "materials.has_mix",
    "textures.has_images",
]


def _get(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def cornell_pair():
    ref = jax.tree_util.tree_map(
        np.asarray, ref_builtin.cornell_box(16, 16).compile(intersector="pallas")
    )
    return ref, cornell_box(16, 16).compile(device="cpu")


@pytest.mark.parametrize("field", FIELDS)
def test_cornell_compile_field_equal(cornell_pair, field):
    ref, port = cornell_pair
    a, b = _np(_get(port, field)), np.asarray(_get(ref, field))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("field", STATICS)
def test_cornell_compile_statics_equal(cornell_pair, field):
    ref, port = cornell_pair
    assert _get(port, field) == _get(ref, field)


def test_from_numpy_scene_carries_reference_state(cornell_pair):
    ref, port = cornell_pair
    conv = from_numpy_scene(ref, device="cpu")
    for field in FIELDS:
        np.testing.assert_array_equal(_np(_get(conv, field)), _np(_get(port, field)))
    assert conv.intersector == port.intersector == "dense"
    assert all(
        isinstance(_get(conv, f), torch.Tensor) for f in FIELDS
    )


def test_scene_to_device_keeps_values(cornell_pair):
    _, port = cornell_pair
    moved = port.to("cpu")
    assert moved.device == torch.device("cpu")
    np.testing.assert_array_equal(moved.prim_table.numpy(), port.prim_table.numpy())
    assert moved.lights.n_lights == port.lights.n_lights


def _material_zoo(mod):
    """The same mesh and material graph built with either package."""
    diffuse = mod.DiffuseMaterial((0.5, 0.4, 0.3))
    glossy = mod.GlossyMaterial((0.9, 0.8, 0.7), roughness=0.3)
    mix = mod.MixMaterial(fraction=0.25, material_a=diffuse, material_b=glossy)
    mats = [
        mix, mod.MirrorMaterial((0.8, 0.8, 0.9)), mod.GlassMaterial(ior=1.33),
        mod.EmissiveMaterial((4.0, 3.0, 2.0), double_sided=True), diffuse,
    ]
    r = np.random.default_rng(3)
    verts = r.normal(size=(40, 3)).astype(np.float32)
    idx = r.integers(0, 40, size=(30, 3)).astype(np.int64)
    idx[:, 1] = (idx[:, 0] + 1) % 40
    idx[:, 2] = (idx[:, 0] + 2) % 40
    mesh = mod.Mesh(
        vertices=verts, indices=idx, materials=mats,
        material_ids=np.arange(30, dtype=np.int64) % len(mats),
    )
    return mod.Scene(shapes=[mesh])


def test_material_zoo_compile_equal():
    import akari_torch.scene.nodes as port_nodes

    ref = jax.tree_util.tree_map(
        np.asarray, _material_zoo(ref_nodes).compile(intersector="brute")
    )
    port = _material_zoo(port_nodes).compile(intersector="brute", device="cpu")
    for field in FIELDS:
        np.testing.assert_array_equal(
            _np(_get(port, field)), np.asarray(_get(ref, field)).astype(_np(_get(port, field)).dtype),
            err_msg=field,
        )
    assert port.materials.has_mix and ref.materials.has_mix
    assert port.intersector == "brute"


def test_sdl_cornell_matches_reference():
    mod_p = sdl.parse_file(SCENE_FILE)
    mod_r = ref_sdl.parse_file(SCENE_FILE)
    sp, sr = mod_p.exports["scene"], mod_r.exports["scene"]
    cp, cr = sp.camera, sr.camera
    np.testing.assert_array_equal(cp.c2w, np.asarray(cr.c2w))
    assert np.float32(cp.tan_half_fov) == np.float32(cr.tan_half_fov)
    assert (cp.width, cp.height, cp.lens_radius, cp.focal_distance) == (
        cr.width, cr.height, cr.lens_radius, cr.focal_distance
    )
    ip, ir = sp.integrator, sr.integrator
    for name in ("spp", "max_depth", "ray_clamp", "mis", "rr_start"):
        assert getattr(ip, name) == getattr(ir, name), name
    assert sp.output == sr.output
    port = sp.compile(device="cpu")
    ref = jax.tree_util.tree_map(np.asarray, sr.compile(intersector="pallas"))
    for field in FIELDS:
        np.testing.assert_array_equal(
            _np(_get(port, field)), np.asarray(_get(ref, field)).astype(_np(_get(port, field)).dtype),
            err_msg=field,
        )


def test_obj_loader_matches_reference():
    mp, mr = load_obj(CORNELL_OBJ), ref_load_obj(CORNELL_OBJ)
    np.testing.assert_array_equal(mp.vertices, mr.vertices)
    np.testing.assert_array_equal(mp.indices, mr.indices)
    np.testing.assert_array_equal(mp.material_ids, mr.material_ids)
    assert [type(m).__name__ for m in mp.materials] == [
        type(m).__name__ for m in mr.materials
    ]
    for a, b in zip(mp.materials, mr.materials):
        np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))


@pytest.mark.parametrize(
    "src, slice_name",
    [
        ('export s = AkariMesh { path: "x.npz" }', "x.npz"),
        ('export s = AkariMesh { path: "x.mesh" }', "x.mesh"),
    ],
)
def test_unported_nodes_name_their_slice(src, slice_name, tmp_path):
    """Mesh caches are ported (slice 7): a cache with neither the file nor
    its sibling OBJ fails as in the reference, an SDLError naming the
    missing path, not a refusal naming a slice."""
    for mod in (sdl, ref_sdl):
        with pytest.raises(mod.SDLError, match=slice_name):
            mod.parse_string(src, base_dir=str(tmp_path))


@pytest.mark.parametrize("exc", [NotImplementedError, KeyError, ValueError])
def test_factory_exceptions_become_sdl_errors(exc):
    """An exception a node factory raises, NotImplementedError included,
    reaches the caller as an SDLError naming the type and the source
    location, with the same message in both packages."""

    def factory(fields, base_dir="."):
        raise exc("no such form")

    src = 'let a = 1\nexport s = Thing { size: 2 }'
    msgs = []
    for mod in (sdl, ref_sdl):
        with pytest.raises(mod.SDLError) as err:
            mod.parse_string(src, registry={"Thing": factory})
        assert (err.value.loc.line, err.value.loc.col) == (2, 12)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "creating Thing:" in msgs[0] and "no such form" in msgs[0]


def test_unported_scene_state_is_refused():
    # instanced scenes compile since slice 3; other shapes are refused
    with pytest.raises(TypeError, match="Mesh or Instance"):
        Scene(shapes=[object()]).compile(device="cpu")
    stand_in = SimpleNamespace(instances=object())
    with pytest.raises(ValueError, match="two-level"):
        from_numpy_scene(stand_in, device="cpu")
    with pytest.raises(ValueError):
        cornell_box(4, 4).compile(intersector="pallas", device="cpu")


def _needs_gxx():
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++) for the native BVH builder")


@pytest.fixture(scope="module")
def terrain_pair():
    """The 32,260-triangle terrain compiled by both packages: above
    NATIVE_MIN_TRIS, so both take the native builder."""
    _needs_gxx()
    from akari_torch.scene.builtin import terrain_scene

    ref = jax.tree_util.tree_map(
        np.asarray, ref_builtin.terrain_scene(8, 8, n=128).compile(intersector="pallas")
    )
    port = terrain_scene(8, 8, n=128).compile(device="cpu")
    assert port.n_tris == ref.n_tris == 32_260 >= NATIVE_MIN_TRIS
    return ref, port


@pytest.mark.parametrize(
    "field", ["prim_to_orig", "prim_table", "tri_clusters", "tri_tree", "bvh.first",
              "bvh.miss", "lights.tri_to_light"],
)
def test_native_terrain_compile_equal(terrain_pair, field):
    ref, port = terrain_pair
    a, b = _np(_get(port, field)), np.asarray(_get(ref, field))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b.astype(a.dtype))


def test_native_terrain_routes_to_the_tree(terrain_pair):
    ref, port = terrain_pair
    assert port.intersector == "tree"
    assert port.tree_leaf_span == ref.tree_leaf_span == 1


def test_native_builder_matches_reference_on_soup():
    _needs_gxx()
    from akari_tpu.bvh.build import build_bvh as ref_build_bvh

    r = np.random.default_rng(6)
    n = NATIVE_MIN_TRIS
    base = r.uniform(-5, 5, size=(n, 1, 3))
    tris = (base + r.normal(scale=0.2, size=(n, 3, 3))).astype(np.float32)
    bvh_p, order_p = build_bvh(tris[:, 0], tris[:, 1], tris[:, 2])
    bvh_r, order_r = ref_build_bvh(tris[:, 0], tris[:, 1], tris[:, 2], use_native=True)
    np.testing.assert_array_equal(order_p, order_r)
    for k in bvh_r:
        np.testing.assert_array_equal(bvh_p[k], bvh_r[k])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails raises: no fallback to the NumPy builder,
    which would store the triangles in another order."""
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ["--no-such-flag"])
    p = np.zeros((NATIVE_MIN_TRIS, 3), np.float32)
    with pytest.raises(RuntimeError, match="failed"):
        build_bvh(p, p + np.float32([1, 0, 0]), p + np.float32([0, 1, 0]))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-akari")
    with pytest.raises(RuntimeError, match="not found"):
        loader.build("bvh")


def test_native_nonzero_return_raises(monkeypatch):
    from akari_torch.native import loader

    class _Fake:
        @staticmethod
        def akr_bvh_build(*args):
            return 1

    monkeypatch.setattr(loader, "load", lambda name: _Fake)
    p = np.zeros((NATIVE_MIN_TRIS, 3), np.float32)
    with pytest.raises(RuntimeError, match="returned 1"):
        build_bvh(p, p, p)


def test_bvh_order_matches_reference_on_random_soup():
    from akari_tpu.bvh.build import build_bvh as ref_build_bvh

    r = np.random.default_rng(5)
    p0 = r.normal(size=(300, 3)).astype(np.float32)
    p1 = p0 + r.normal(scale=0.3, size=(300, 3)).astype(np.float32)
    p2 = p0 + r.normal(scale=0.3, size=(300, 3)).astype(np.float32)
    bvh_p, order_p = build_bvh(p0, p1, p2)
    bvh_r, order_r = ref_build_bvh(p0, p1, p2, use_native=False)
    np.testing.assert_array_equal(order_p, order_r)
    for k in bvh_r:
        np.testing.assert_array_equal(bvh_p[k], bvh_r[k])


def test_transforms_match_reference():
    rot = (0.3, -1.1, 2.0)
    np.testing.assert_array_equal(transform.euler_zyx(rot), ref_transform.euler_zyx(rot))
    np.testing.assert_array_equal(
        transform.look_at((1.6, 1.9, 2.3), (0.0, 0.25, 0.0)),
        ref_transform.look_at((1.6, 1.9, 2.3), (0.0, 0.25, 0.0)),
    )
    np.testing.assert_array_equal(transform.translate((1, 2, 3)), ref_transform.translate((1, 2, 3)))
    m = transform.translate((0.5, 0, 0)) @ transform.euler_zyx(rot) @ transform.scale(2.0)
    pts = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        transform.apply_point(m, pts), ref_transform.apply_point(m, pts), rtol=1e-6
    )
    np.testing.assert_allclose(
        transform.apply_normal(m, pts), ref_transform.apply_normal(m, pts), rtol=1e-5
    )


def test_distribution_matches_reference():
    w = np.asarray([0.5, 0.0, 2.0, 1.25, 0.25])
    pdf_p, cdf_p = distribution.build_cdf(w)
    pdf_r, cdf_r = ref_distribution.build_cdf(w)
    np.testing.assert_array_equal(pdf_p, pdf_r)
    np.testing.assert_array_equal(cdf_p, cdf_r)
    u = np.random.default_rng(2).random(1000).astype(np.float32)
    u[:4] = [0.0, float(cdf_r[1]), float(cdf_r[3]), 0.99999994]
    idx_p, p_p = distribution.sample_discrete(torch.from_numpy(cdf_p), torch.from_numpy(u))
    idx_r, p_r = ref_distribution.sample_discrete(cdf_r, u)
    np.testing.assert_array_equal(idx_p.numpy(), idx_r)
    np.testing.assert_array_equal(p_p.numpy(), p_r)
