"""Port parity: two-level instanced scenes (the two-level compile of
akari_torch.scene.nodes, scene.geom, ops.instanced_tree_intersect, the
instanced route of ops.intersect, the instanced branches of the path
integrator and of light sampling, the SDL Instance node) vs akari_tpu.

Two-level compiles are forced at small size the way both packages do it:
the module constant ``FLATTEN_MAX_TRIS = 1``. The JAX side compiles with
``intersector="pallas"`` for its per-prototype kernel tables and reaches
``run_instanced_tree`` in interpret mode, as tests/test_pallas.py does, or
its XLA two-level traversal (``intersector="bvh"``).

Tolerances: compiled tables, prim ids, light ids, validity and occlusion
exact (both compiles run the same NumPy arithmetic); geometry gathered by
scene.geom allclose 1e-6 (einsum order); t rtol 1e-5 against the JAX
traversals (XLA may fuse the Moeller-Trumbore products where the port
rounds op by op; a hit divides that difference by the determinant); light
samples rtol 1e-5; renders within the budget of tests/_imgcmp.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from akari_torch.core import transform as port_xf
from akari_torch.core.v3 import V3
from akari_torch.integrators import path as port_path
from akari_torch.ops import instanced_tree_intersect as iti
from akari_torch.ops.intersect import intersect_soa, occlude_soa
from akari_torch.scene import builtin as port_builtin
from akari_torch.scene import geom as port_geom
from akari_torch.scene.arrays import from_numpy_scene, make_camera
from akari_tpu.core import transform as ref_xf
from akari_tpu.ops import pallas_intersect as pi
from akari_tpu.ops import pallas_tree as ref_tree
from akari_tpu.scene import builtin as ref_builtin
from akari_tpu.scene import geom as ref_geom

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_instanced64_spp4_d5.npy")
T_RTOL = 1e-5
GEOM_TOL = dict(rtol=1e-6, atol=1e-6)

TABLES = [
    "tri_v0", "tri_e1", "tri_e2", "normals", "uvs", "mat_id", "prim_to_orig",
    "materials.kind", "materials.color_tex", "materials.roughness_tex",
    "materials.fraction_tex", "materials.mix_a", "materials.mix_b",
    "materials.double_sided", "materials.ior",
    "textures.kind", "textures.value",
    "lights.tri_id", "lights.cdf", "lights.pdf", "lights.tri_to_light",
    "bvh.node_lo", "bvh.node_hi", "bvh.first", "bvh.count", "bvh.miss",
    "instances.o2w", "instances.w2o", "instances.nrm", "instances.blas_root",
    "instances.tri_offset", "instances.prim_ends", "instances.light_base",
    "instances.tlas_inst",
    "tri_tree", "tri_clusters", "tri_superclusters",
]
STATICS = ["n_tris", "n_materials", "lights.n_lights", "instances.n_instances",
           "tree_leaf_span"]


def _get(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


class two_level:
    """Both packages compile instanced scenes two-level at any size (the
    module constant FLATTEN_MAX_TRIS = 1, as bench.py forces it)."""

    def __enter__(self):
        self.old = port_nodes.FLATTEN_MAX_TRIS, ref_nodes.FLATTEN_MAX_TRIS
        port_nodes.FLATTEN_MAX_TRIS = ref_nodes.FLATTEN_MAX_TRIS = 1

    def __exit__(self, *exc):
        port_nodes.FLATTEN_MAX_TRIS, ref_nodes.FLATTEN_MAX_TRIS = self.old


# ------------------------------ scenes --------------------------------------

def _xf(translate, scale, rot_y):
    """tests/test_instancing.py's placement: translate @ rot_y @ scale."""
    t = port_xf.translate(np.asarray(translate, np.float32))
    c, s = np.cos(rot_y), np.sin(rot_y)
    r = np.eye(4, dtype=np.float32)
    r[0, 0], r[0, 2], r[2, 0], r[2, 2] = c, s, -s, c
    sc = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    return np.asarray(t @ r @ sc, np.float32)


PAIR_XFORMS = [
    _xf((-1.5, 0.0, -0.5), 0.8, 0.4),
    _xf((0.3, 0.0, 0.4), 1.2, -0.7),
    _xf((1.6, 0.0, -1.0), 0.5, 1.1),
]


def pair_shapes(mod):
    """tests/test_instancing.py:63-92's scene from ``mod``'s node types: a
    floor, a lamp and three instances of a glossy unit cube."""
    white = mod.DiffuseMaterial((0.7, 0.7, 0.7))
    glossy = mod.GlossyMaterial((0.8, 0.7, 0.6), 0.2)
    light = mod.EmissiveMaterial((12.0, 11.0, 9.0))
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                 np.int64)
    proto = mod.Mesh(vertices=v, indices=f, materials=[glossy])
    floor = mod.Mesh(
        vertices=np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int64), materials=[white],
    )
    lamp = mod.Mesh(
        vertices=np.array([[-0.6, 3.0, -0.6], [0.6, 3.0, -0.6], [0.6, 3.0, 0.6],
                           [-0.6, 3.0, 0.6]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int64), materials=[light],
    )
    return [floor, lamp] + [mod.Instance(proto, m) for m in PAIR_XFORMS]


def forest_shapes(mod, terrain_mesh, n_instances=8, n=16):
    """The instanced forest from ``mod``'s node types: ``n_instances``
    copies of ``terrain_mesh(n)`` at the port's ``forest_transforms`` and
    the downward 4 x 4 light at y = 4 (port: builtin.instanced_forest_scene)."""
    proto = terrain_mesh(n)
    shapes = [mod.Instance(proto, m) for m in port_builtin.forest_transforms(n_instances)]
    lq = np.asarray([[-2, 4, 2], [-2, 4, -2], [2, 4, -2], [-2, 4, 2], [2, 4, -2], [2, 4, 2]],
                    np.float32)
    shapes.append(mod.Mesh(vertices=lq, indices=np.arange(6, dtype=np.int64).reshape(-1, 3),
                           materials=[mod.EmissiveMaterial((14.0, 13.0, 11.0))],
                           material_ids=np.zeros(2, np.int64)))
    return shapes


SCENES = {
    "pair": lambda mod, builtin: pair_shapes(mod),
    "forest8": lambda mod, builtin: forest_shapes(mod, builtin.terrain_mesh),
}


_CACHE = {}


def compiled(name, ref_intersector="pallas"):
    """(port two-level scene, JAX two-level scene), cached per module."""
    key = (name, ref_intersector)
    if key not in _CACHE:
        with two_level():
            port = port_nodes.compile_scene(SCENES[name](port_nodes, port_builtin), device="cpu")
            ref = ref_nodes.compile_scene(SCENES[name](ref_nodes, ref_builtin),
                                          intersector=ref_intersector)
        _CACHE[key] = port, ref
    return _CACHE[key]


def _rays(n=512, seed=0):
    """tests/test_instancing.py's rays: from around (0, 2, 6) toward the
    instances."""
    r = np.random.RandomState(seed)
    o = np.array([0.0, 2.0, 6.0], np.float32) + r.randn(n, 3).astype(np.float32) * 0.3
    target = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    target[:, 1] = r.uniform(0, 2, n)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _forest_rays(n, seed):
    """Rays from above the forest toward its instances, some bounded, some
    dead (t_max = 0)."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-7, 7, n), r.uniform(1.0, 3.0, n), r.uniform(-7, 7, n)], 1)
    centres = np.stack([m[:3, 3] for m in port_builtin.forest_transforms(8)])
    tgt = centres[r.integers(0, 8, n)] + r.uniform([-1, -0.2, -1], [1, 0.8, 1], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(r.integers(0, 4, n) == 0, 0.0, 1e30)
    t_max = np.where(r.integers(0, 4, n) == 0, 1.5, t_max)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def _v3(a):
    return V3(*torch.from_numpy(np.ascontiguousarray(a)).T)


def _pack(o, d, t_min, t_max):
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, d.T, t_min[None], t_max[None]], axis=0), dtype=np.float32))


# ------------------------------ tables --------------------------------------

@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_two_level_tables_equal_reference(name):
    port, ref = compiled(name)
    assert port.instances is not None and ref.instances is not None
    assert port.intersector == "tree" and port.prim_table is None
    for f in TABLES:
        a, b = _np(_get(port, f)), np.asarray(_get(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STATICS:
        assert _get(port, f) == _get(ref, f), f
    np.testing.assert_array_equal(port.inst_f32.numpy(), ref.inst_pallas_f32)
    np.testing.assert_array_equal(port.inst_i32.numpy(), ref.inst_pallas_i32)
    # the kernels' triangle store keeps the reference's [16, sum Kp*128]
    # layout: rows 0-8 (the rest are zero there)
    t16 = np.asarray(ref.inst_tris16)
    assert not t16[9:].any()
    np.testing.assert_array_equal(port.inst_tri_blocks.numpy(), t16[:9])
    # from_numpy_scene carries the reference's compile across unchanged
    conv = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), intersector="tree",
                            device="cpu")
    for f in TABLES + ["inst_f32", "inst_i32", "inst_tri_blocks"]:
        np.testing.assert_array_equal(_np(_get(conv, f)), _np(_get(port, f)), err_msg=f)


def test_inst_tris_pads_prototypes_to_whole_clusters():
    port, _ = compiled("forest8")
    rows = port.inst_tri_blocks.numpy().T  # a triangle per row
    n_store = port.tri_v0.shape[0]
    assert rows.shape[0] % 128 == 0 and rows.shape[0] >= n_store
    insti = port.inst_i32.numpy()
    for i in range(insti.shape[0]):
        kp, tile = insti[i, 3], insti[i, 4]
        assert (tile + kp) * 128 <= rows.shape[0]
    # padding rows are zero: det = 0, they never hit
    real = np.abs(rows).sum(axis=1) > 0
    assert real.sum() == n_store


def test_flatten_route_equal_reference():
    """At or under FLATTEN_MAX_TRIS both packages flatten the instances to
    world space and compile flat (test_instancing.py:190)."""
    port = port_nodes.compile_scene(pair_shapes(port_nodes), device="cpu")
    ref = ref_nodes.compile_scene(pair_shapes(ref_nodes), intersector="pallas")
    assert port.instances is None and ref.instances is None
    assert port.intersector == "dense"
    for f in TABLES[:26] + ["prim_table"]:
        np.testing.assert_array_equal(_np(_get(port, f)), np.asarray(_get(ref, f)), err_msg=f)
    assert port.n_tris == ref.n_tris


@pytest.mark.parametrize("intersector", ["dense", "brute"])
def test_two_level_refuses_dense_and_brute(intersector):
    with two_level(), pytest.raises(ValueError, match="two-level"):
        port_nodes.compile_scene(pair_shapes(port_nodes), intersector=intersector, device="cpu")


def test_forest_scene_is_two_level_on_auto_at_full_size():
    """128 copies of the 32,258-triangle terrain exceed FLATTEN_MAX_TRIS:
    the world count decides, without compiling the scene."""
    sc = port_builtin.instanced_forest_scene(8, 8)
    total = sum(len(s.mesh.indices) if isinstance(s, port_nodes.Instance) else len(s.indices)
                for s in sc.shapes)
    assert total == 4_129_026 > port_nodes.FLATTEN_MAX_TRIS
    assert sum(isinstance(s, port_nodes.Instance) for s in sc.shapes) == 128


# -------------------------------- geom --------------------------------------

@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_geom_equal_reference(name):
    port, ref = compiled(name)
    r = np.random.default_rng(5)
    prim = r.integers(0, port.n_tris, 400).astype(np.int32)
    ends = port.instances.prim_ends.numpy()
    prim[:len(ends)] = ends - 1             # each instance's last id
    prim[len(ends):2 * len(ends)] = np.r_[0, ends[:-1]]  # and its first
    tp = torch.from_numpy(prim.astype(np.int64))
    sid, inst = port_geom.decode_prim(port, tp)
    rsid, rinst = ref_geom.decode_prim(ref, prim, np)
    np.testing.assert_array_equal(sid.numpy(), rsid)
    np.testing.assert_array_equal(inst.numpy(), rinst)
    np.testing.assert_array_equal(port_geom.mat_of_prim(port, tp).numpy(),
                                  ref_geom.mat_of_prim(ref, prim, np))
    np.testing.assert_array_equal(port_geom.light_of_prim(port, tp).numpy(),
                                  ref_geom.light_of_prim(ref, prim, np))
    np.testing.assert_array_equal(port_geom.uvs_of_prim(port, tp).numpy(),
                                  ref_geom.uvs_of_prim(ref, prim, np))
    for a, b in zip(port_geom.tri_world(port, tp), ref_geom.tri_world(ref, prim, np)):
        np.testing.assert_allclose(a.numpy(), b, **GEOM_TOL)
    np.testing.assert_allclose(port_geom.normals_world(port, tp).numpy(),
                               ref_geom.normals_world(ref, prim, np), **GEOM_TOL)


# ------------------------- plain walk vs references -------------------------

def _run_instanced_tree(ref, o, d, t_min, t_max, any_hit, leaf_span=None):
    rays, n = pi._pack_rays_soa(
        JV3(o), JV3(d), jnp.asarray(t_min), jnp.asarray(t_max))
    out = ref_tree.run_instanced_tree(
        rays, jnp.asarray(ref.inst_pallas_f32), jnp.asarray(ref.inst_pallas_i32),
        jnp.asarray(ref.tri_tree), jnp.asarray(ref.inst_tris16), any_hit,
        leaf_span=ref.tree_leaf_span if leaf_span is None else leaf_span, interpret=True,
    )
    out = np.asarray(out)[:, :n]
    if any_hit:
        return out[0] > 0.5
    return tuple(np.asarray(x) for x in pi._unpack_closest(jnp.asarray(out)))


def JV3(a):
    from akari_tpu.core.v3 import V3 as RefV3

    return RefV3(*(jnp.asarray(c) for c in np.asarray(a).T))


def assert_virtual_prims_equal(port, prim, ref_prim, ok):
    """Virtual prims equal, except on exact-t ties between SBVH storage
    copies of one triangle: those must name the same original triangle."""
    np.testing.assert_array_equal(prim >= 0, ok)
    diff = np.nonzero((prim != ref_prim) & ok)[0]
    if len(diff):
        sid, _ = port_geom.decode_prim(port, torch.from_numpy(prim[diff].astype(np.int64)))
        rsid, _ = port_geom.decode_prim(port, torch.from_numpy(ref_prim[diff].astype(np.int64)))
        p2o = port.prim_to_orig.numpy()
        np.testing.assert_array_equal(p2o[sid.numpy()], p2o[rsid.numpy()])
    assert len(diff) <= 0.02 * max(int(ok.sum()), 1)


@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_plain_instanced_walk_matches_run_instanced_tree(name):
    port, ref = compiled(name)
    if name == "pair":
        o, d = _rays(400, seed=9)
        t_max = np.full(400, 1e30, np.float32)
        t_max[::5] = 0.0
        t_max[1::5] = 3.0
    else:
        o, d, t_max = _forest_rays(400, seed=3)
    t_min = np.zeros(len(o), np.float32)
    rays = _pack(o, d, t_min, t_max)
    args = (port.inst_f32, port.inst_i32, port.tri_tree, port.inst_tri_blocks,
            port.tree_leaf_span)
    t, u, v, prim = iti.closest(rays, *args)
    rt, rprim, ru, rv, rvalid = _run_instanced_tree(ref, o, d, t_min, t_max, False)
    assert_virtual_prims_equal(port, prim.numpy(), rprim, rvalid)
    np.testing.assert_allclose(t.numpy()[rvalid], rt[rvalid], rtol=T_RTOL)
    assert np.all(t.numpy()[~rvalid] == np.float32(1e30))
    occ = iti.any_hit(rays, *args)
    np.testing.assert_array_equal(occ.numpy(), _run_instanced_tree(ref, o, d, t_min, t_max, True))
    np.testing.assert_array_equal(occ.numpy(), rvalid)
    assert rvalid.sum() > 40 and (~rvalid).sum() > 40


@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_instanced_route_matches_xla_two_level_traversal(name):
    """intersect_soa / occlude_soa on the two-level scene (the instanced
    route, plain walk on the CPU) vs the JAX package's XLA TLAS/BLAS
    traversal of the same scene (intersector "bvh")."""
    from akari_tpu.ops.intersect import intersect, occlude

    port, _ = compiled(name)
    _, ref = compiled(name, ref_intersector="bvh")
    if name == "pair":
        o, d = _rays(1000, seed=4)
        t_max = np.full(1000, 3.0, np.float32)
    else:
        o, d, t_max = _forest_rays(1000, seed=8)
    n = len(o)
    h = intersect_soa(port, _v3(o), _v3(d))
    hr = intersect(ref, jnp.asarray(o), jnp.asarray(d))
    ok = np.asarray(hr.valid)
    np.testing.assert_array_equal(h.valid.numpy(), ok)
    assert_virtual_prims_equal(port, h.prim.numpy(), np.asarray(hr.prim), ok)
    np.testing.assert_allclose(h.t.numpy()[ok], np.asarray(hr.t)[ok], rtol=T_RTOL)
    occ = occlude_soa(port, _v3(o), _v3(d), torch.zeros(n), torch.from_numpy(t_max))
    occ_r = occlude(ref, jnp.asarray(o), jnp.asarray(d), 0.0, jnp.asarray(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    assert ok.sum() > 100


@pytest.mark.parametrize("leaf_span", [1, 2, 4])
def test_plain_walk_hits_do_not_depend_on_leaf_span(leaf_span, monkeypatch):
    base, _ = compiled("forest8")
    monkeypatch.setattr(port_nodes, "pick_leaf_span", lambda k: leaf_span)
    with two_level():
        port = port_nodes.compile_scene(forest_shapes(port_nodes, port_builtin.terrain_mesh),
                                        device="cpu")
    assert port.tree_leaf_span == leaf_span
    o, d, t_max = _forest_rays(600, seed=11)
    rays = _pack(o, d, np.zeros(600, np.float32), t_max)
    got = iti.closest(rays, port.inst_f32, port.inst_i32, port.tri_tree, port.inst_tri_blocks,
                      leaf_span)
    want = iti.closest(rays, base.inst_f32, base.inst_i32, base.tri_tree, base.inst_tri_blocks,
                       base.tree_leaf_span)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[3] >= 0).sum()) > 100


def test_ties_across_instances_go_to_the_lower_virtual_id():
    """Two instances with the same transform: every hit is an exact tie
    across instances, and the lower virtual id (the first instance) wins."""
    tri = port_nodes.Mesh(vertices=np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
                          indices=np.asarray([[0, 1, 2]]))
    m = np.asarray(port_xf.translate((0.0, 0.0, 1.0)), np.float32)
    with two_level():
        scene = port_nodes.compile_scene([port_nodes.Instance(tri, m), port_nodes.Instance(tri, m)],
                                         device="cpu")
    r = np.random.default_rng(1)
    n = 200
    o = np.stack([r.uniform(-0.3, 0.3, n), r.uniform(-0.3, 0.3, n), np.full(n, 5.0)], 1)
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    o, d = o.astype(np.float32), d.astype(np.float32)
    # a reversed pair of instance rows: the kernel still keeps the lower id
    for order in ([0, 1], [1, 0]):
        rays = _pack(o, d, np.zeros(n, np.float32), np.full(n, 1e30, np.float32))
        instf, insti = scene.inst_f32[order], scene.inst_i32[order]
        prim = iti.closest(rays, instf, insti, scene.tri_tree, scene.inst_tri_blocks,
                           scene.tree_leaf_span)[3]
        assert (prim == 0).all()


def test_wrapper_rejects_bad_inputs():
    port, _ = compiled("pair")
    rays = torch.zeros((8, 4))
    args = (port.inst_f32, port.inst_i32, port.tri_tree, port.inst_tri_blocks)
    with pytest.raises(ValueError):
        iti.closest(torch.zeros((7, 4)), *args)
    with pytest.raises(TypeError):
        iti.closest(rays, port.inst_f32, port.inst_i32.long(), *args[2:])
    with pytest.raises(ValueError):
        iti.closest(rays, port.inst_f32[:, :19], *args[1:])
    with pytest.raises(ValueError):
        iti.any_hit(rays, *args[:3], port.inst_tri_blocks[:, :100])
    blocks = port.inst_tri_blocks
    rows = torch.cat([blocks.T, torch.zeros(blocks.shape[1], 3)], 1)
    with pytest.raises(ValueError):
        iti.any_hit(rays, *args[:3], rows)  # a [sum Kp*128, 12] row store
    with pytest.raises(ValueError):
        iti.closest(rays, *args, leaf_span=0)


# ------------------------------ shading -------------------------------------

@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_light_sample_equal_reference(name):
    from akari_torch.shading import soa as port_soa
    from akari_tpu.shading import soa as ref_soa

    port, ref = compiled(name)
    r = np.random.default_rng(17)
    n = 500
    u = [r.uniform(size=n).astype(np.float32) for _ in range(3)]
    p = np.stack([r.uniform(-3, 3, n), r.uniform(0, 1, n), r.uniform(-3, 3, n)], 1)
    p = p.astype(np.float32)
    got = port_soa.light_sample(port, *(torch.from_numpy(x) for x in u), _v3(p))
    want = ref_soa.light_sample(ref, *(jnp.asarray(x) for x in u), JV3(p))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for a, b in ((got.wi, want.wi), (got.L, want.L)):
        np.testing.assert_allclose(a.stack().numpy(), np.stack([np.asarray(c) for c in b], -1),
                                   rtol=T_RTOL, atol=1e-6)
    for a, b in ((got.dist, want.dist), (got.pdf, want.pdf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=T_RTOL)
    assert got.valid.numpy().sum() > 50


def test_pair_render_matches_jax_two_level():
    """12x12, 8 spp, depth 3 render of the two-level pair scene: the port
    (instanced route, plain walk) vs the JAX package's two-level render."""
    from akari_tpu.integrators import path as ref_path
    from akari_tpu.scene.arrays import make_camera as ref_make_camera

    port, _ = compiled("pair")
    _, ref = compiled("pair", ref_intersector="bvh")
    cam = make_camera(port_xf.translate((0.0, 2.0, 8.0)), 30.0, 12, 12)
    cam_r = ref_make_camera(ref_xf.translate((0.0, 2.0, 8.0)), 30.0, 12, 12)
    img = port_path.render(port, cam, port_path.PathConfig(spp=8, max_depth=3, ray_clamp=40.0),
                           seed=0).numpy()
    cfg_r = ref_path.PathConfig(spp=8, max_depth=3, ray_clamp=40.0)
    img_r = np.asarray(ref_path.render(ref, cam_r, cfg_r, seed=0))
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert_images_match(img, img_r, outlier_frac=0.02, mean_tol=1e-3)


def test_instanced_golden_64():
    """The 64x64, 4 spp, depth 5 instanced forest (8 copies of the n=16
    terrain, two-level) against the JAX package's image
    (tools/make_torch_port_instanced_golden.py)."""
    with two_level():
        sc = port_builtin.instanced_forest_scene(64, 64, n_instances=8, n=16)
        scene = sc.compile(device="cpu")
    assert scene.instances is not None and scene.intersector == "tree"
    img = port_path.render(scene, sc.camera, port_path.PathConfig(spp=4, max_depth=5),
                           seed=0).numpy()
    assert img.mean() > 0.05
    assert_images_match(img, np.load(GOLDEN), outlier_frac=0.08, mean_tol=3e-3)


def test_golden_tool_builds_the_ports_scene():
    """The golden maker's JAX-side recipe equals the port's builtin."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_tool", os.path.join(ROOT, "tools", "make_torch_port_instanced_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for a, b in zip(tool.forest_transforms(8), port_builtin.forest_transforms(8)):
        np.testing.assert_array_equal(a, b)
    ref_sc = tool.forest_scene(64, 64, 8, 16)
    port_sc = port_builtin.instanced_forest_scene(64, 64, n_instances=8, n=16)
    np.testing.assert_array_equal(np.asarray(ref_sc.camera.c2w), port_sc.camera.c2w)
    light_r, light_p = ref_sc.shapes[-1], port_sc.shapes[-1]
    np.testing.assert_array_equal(light_r.vertices, light_p.vertices)


def test_instanced_queries_per_trace(monkeypatch):
    """A two-level scene's bounce answers shadow and extension rays in one
    fused launch: 1 + max_depth instanced-walk launches per trace_paths."""
    calls = []
    real = iti.closest

    def counting(rays, *args):
        calls.append(rays.shape[1])
        return real(rays, *args)

    monkeypatch.setattr(iti, "closest", counting)
    port, _ = compiled("pair")
    cam = make_camera(port_xf.translate((0.0, 2.0, 8.0)), 30.0, 8, 8)
    n = 64
    li = port_path.trace_paths(port, cam, port_path.PathConfig(spp=1, max_depth=3), 0,
                               torch.zeros(n, dtype=torch.int64), torch.arange(n))
    assert calls == [n] + [2 * n] * 3
    assert bool(torch.isfinite(li).all())


# ------------------------------ SDL and CLI ---------------------------------

SDL_SRC = """
let proto = OBJMesh { path: "tri.obj" }
export scene = Scene {
    camera: PerspectiveCamera { fov: 40, position: [0.5, 0.5, 5], resolution: [8, 8] },
    integrator: Path { spp: 1, max_depth: 2 },
    shapes: [
        Instance { mesh: $proto, translate: [1, 0, 0], scale: 2 },
        Instance { mesh: $proto, rotate: [0, 90, 0] },
        Instance { mesh: $proto, rotate: [10, 20, 30], scale: [1, 2, 0.5],
                   materials: [ EmissiveMaterial { color: [4, 4, 4] } ] },
        Instance { mesh: $proto, transform: [1, 0, 0, 0.5, 0, 1, 0, 0, 0, 0, 1, -1, 0, 0, 0, 1] }
    ]
}
"""


def _write_sdl(tmp_path):
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "main.akari").write_text(SDL_SRC)
    return str(tmp_path / "main.akari")


def test_sdl_instance_node_equal_reference(tmp_path):
    """test_instancing.py:287's Instance node (translate / rotate / scale,
    a full transform, a materials override) compiles to the same two-level
    scene in both packages."""
    from akari_torch.scene import sdl as port_sdl
    from akari_tpu.scene import sdl as ref_sdl

    path = _write_sdl(tmp_path)
    ps = port_sdl.parse_file(path).exports["scene"]
    rs = ref_sdl.parse_file(path).exports["scene"]
    for a, b in zip(ps.shapes, rs.shapes):
        assert isinstance(a, port_nodes.Instance)
        np.testing.assert_array_equal(a.transform, b.transform)
    with two_level():
        port = ps.compile(device="cpu")
        ref = rs.compile(intersector="pallas")
    assert port.instances.n_instances == 4 and port.tri_v0.shape[0] == 2
    for f in TABLES:
        np.testing.assert_array_equal(_np(_get(port, f)), np.asarray(_get(ref, f)), err_msg=f)
    np.testing.assert_array_equal(port.inst_f32.numpy(), ref.inst_pallas_f32)


def test_cli_renders_an_instanced_sdl_scene(tmp_path, monkeypatch):
    from PIL import Image

    from akari_torch.cli.render import main

    path = _write_sdl(tmp_path)
    monkeypatch.setattr(port_nodes, "FLATTEN_MAX_TRIS", 1)
    out = tmp_path / "out.png"
    assert main(["-i", path, "-o", str(out), "--device", "cpu"]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (8, 8, 3)


# ------------------------------- imports ------------------------------------

def test_port_imports_neither_jax_nor_the_reference():
    """No module of akari_torch/ and not chip_smoke.py imports jax or
    akari_tpu: a grep over the sources, then an import of every module in
    a fresh interpreter."""
    import re
    import subprocess
    import sys

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|akari_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "akari_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    mods = sorted(
        os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for f in files[1:]
    )
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(','.join(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'akari_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
