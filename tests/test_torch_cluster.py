"""Port parity: the linear supercluster -> cluster -> triangle sweeps
(akari_torch.bvh.cluster_tree.build_superclusters, ops.cluster_intersect and
the tri_tree-is-None routes of ops.intersect) vs akari_tpu's
``run_clustered`` and ``run_instanced``, reached in interpret mode as
tests/test_pallas.py reaches them, on scenes whose tree table is nulled.

Tolerances: tables, prim ids (storage or virtual), validity and any-hit
flags exact. The sweeps visit boxes in index order and keep the lowest
index on an exact tie, which is the first hit the reference's in-order
sweep keeps, so prims match exactly. t rtol 1e-5 (XLA may fuse the
Moeller-Trumbore products where the port rounds op by op). The port's
plain sweeps and its tree walk round op by op alike: they must agree bit
for bit. The plain sweeps read the component-major stores of the tree
walks (``tri_blocks``, ``inst_tri_blocks``); on the [T, 12] row layout of
the same triangles, read through its transpose, they give the same bits
and the same ``WalkStats`` counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
from akari_torch.bvh import cluster_tree as ct
from akari_torch.core.v3 import V3
from akari_torch.ops import cluster_intersect as ci
from akari_torch.ops import tree_intersect as ti
from akari_torch.ops.intersect import intersect_soa, occlude_soa
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.ops import pallas_cluster as ref_cluster
from akari_tpu.ops import pallas_intersect as pi
from test_torch_instancing import _forest_rays, _pack, _rays, compiled
from test_torch_leaf_store import _assert_same, _assert_same_stats, row_store

torch.set_num_threads(2)

T_RTOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


def _soup_mesh(n_tri=6000):
    """tests/test_pallas.py:258's 6,000-triangle soup."""
    r = np.random.default_rng(9)
    base = r.uniform(-4, 4, size=(n_tri, 1, 3))
    tris = (base + r.normal(scale=0.15, size=(n_tri, 3, 3))).astype(np.float32)
    verts = tris.reshape(-1, 3)
    return port_nodes.Mesh(vertices=verts, indices=np.arange(verts.shape[0]).reshape(-1, 3))


@pytest.fixture(scope="module")
def soup():
    scene = port_nodes.compile_scene([_soup_mesh()], intersector="auto", device="cpu")
    assert scene.intersector == "tree" and scene.tri_superclusters is not None
    return scene


def _soup_rays(n, seed):
    rr = np.random.default_rng(seed)
    o = rr.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    d = rr.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::4] = 0.0
    t_max[1::4] = 2.0
    return o, d, np.zeros(n, np.float32), t_max


def _ref_pack(o, d, t_min, t_max):
    return pi._pack_rays_soa(
        JV3(*(jnp.asarray(c) for c in o.T)), JV3(*(jnp.asarray(c) for c in d.T)),
        jnp.asarray(t_min), jnp.asarray(t_max),
    )


def _unpack(out, n, any_hit):
    out = np.asarray(out)[:, :n]
    if any_hit:
        return out[0] > 0.5
    return tuple(np.asarray(x) for x in pi._unpack_closest(jnp.asarray(out)))


def _assert_closest_equal(got, ref):
    t, u, v, prim = (x.numpy() for x in got)
    rt, rprim, ru, rv, rvalid = ref
    np.testing.assert_array_equal(prim >= 0, rvalid)
    np.testing.assert_array_equal(prim[rvalid], rprim[rvalid])
    np.testing.assert_allclose(t[rvalid], rt[rvalid], rtol=T_RTOL)
    assert np.all(t[~rvalid] == np.float32(1e30))
    assert not u[~rvalid].any() and not v[~rvalid].any()
    assert rvalid.sum() > 40 and (~rvalid).sum() > 40


# ------------------------------- tables -------------------------------------

def test_superclusters_equal_reference(soup):
    cl = soup.tri_clusters.numpy()
    ours = ct.build_superclusters(cl, soup.n_tris)
    ref = ref_cluster.build_superclusters(cl, soup.n_tris)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(soup.tri_superclusters.numpy(), ref)
    s_real = ct.n_superclusters(soup.n_tris)
    assert ours.shape[0] % ct.SUPER_CHUNK == 0 and ours.shape[0] > s_real
    # padded rows are inverted boxes: no ray enters them
    assert (ours[s_real:, 0:3] == np.float32(1e30)).all()
    assert (ours[s_real:, 3:6] == np.float32(-1e30)).all()


def test_flat_compile_stores_superclusters_with_the_clusters():
    """Superclusters are built wherever clusters are: above DENSE_MAX_TRIS,
    or on request of the tree intersector (akari_tpu/scene/nodes.py:622-625)."""
    small = port_nodes.compile_scene([_soup_mesh(300)], device="cpu")
    assert small.intersector == "dense" and small.tri_superclusters is None
    forced = port_nodes.compile_scene([_soup_mesh(300)], intersector="tree", device="cpu")
    np.testing.assert_array_equal(
        forced.tri_superclusters.numpy(),
        ref_cluster.build_superclusters(forced.tri_clusters.numpy(), forced.n_tris),
    )


# --------------------------- flat sweep -------------------------------------

def test_plain_flat_sweep_matches_run_clustered(soup):
    n = 400
    o, d, t_min, t_max = _soup_rays(n, seed=2)
    rays_r, nr = _ref_pack(o, d, t_min, t_max)
    tris_t = pi.pack_tris_t(jnp.asarray(soup.tri_v0.numpy()), jnp.asarray(soup.tri_e1.numpy()),
                            jnp.asarray(soup.tri_e2.numpy()))
    args_r = (tris_t, jnp.asarray(soup.tri_clusters.numpy()),
              jnp.asarray(soup.tri_superclusters.numpy()))
    rays = _pack(o, d, t_min, t_max)
    args = (soup.tri_superclusters, soup.tri_clusters, soup.tri_blocks, soup.n_tris)
    ref = _unpack(ref_cluster.run_clustered(rays_r, *args_r, False, n_tris=soup.n_tris,
                                            interpret=True), nr, False)
    _assert_closest_equal(ci.closest(rays, *args), ref)
    ref_occ = _unpack(ref_cluster.run_clustered(rays_r, *args_r, True, n_tris=soup.n_tris,
                                                interpret=True), nr, True)
    occ = ci.any_hit(rays, *args)
    np.testing.assert_array_equal(occ.numpy(), ref_occ)
    np.testing.assert_array_equal(occ.numpy(), ref[4])


def test_flat_cluster_route_equals_tree_route(soup):
    """intersect_soa / occlude_soa on the soup with its tree nulled (the
    linear sweep, as the JAX package routes such a scene) == the tree
    route, bit for bit."""
    nulled = dataclasses.replace(soup, tri_tree=None)
    o, d, t_min, t_max = _soup_rays(1500, seed=7)
    o3, d3 = V3(*torch.from_numpy(o).T), V3(*torch.from_numpy(d).T)
    tmn, tmx = torch.from_numpy(t_min), torch.from_numpy(t_max)
    a = intersect_soa(nulled, o3, d3, tmn, tmx)
    b = intersect_soa(soup, o3, d3, tmn, tmx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.valid.sum()) > 200
    assert torch.equal(occlude_soa(nulled, o3, d3, tmn, tmx), occlude_soa(soup, o3, d3, tmn, tmx))


def test_flat_sweep_ties_go_to_the_lowest_index():
    """Exact duplicates across superclusters: the sweep returns the lowest
    index, like the tree walk and the dense sweep."""
    r = np.random.default_rng(5)
    n = 9000
    v0 = r.uniform([-4.0, -1.0, -1.0], [4.0, 1.0, 1.0], size=(n, 3))
    v0 = v0[np.argsort(v0[:, 0])]
    tris = np.concatenate([v0, r.normal(scale=0.4, size=(n, 6))], 1).astype(np.float32)
    tris[8500:8540] = tris[100:140]
    tris[1000:1020] = tris[8900:8920]
    cl = ct.build_clusters(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    sup = torch.from_numpy(ct.build_superclusters(cl, n))
    blocks = torch.from_numpy(ct.tri_blocks(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]))
    nodes, span = ct.build_cluster_tree(cl, n, leaf_span=1)
    m = 2000
    o = np.stack([np.where(np.arange(m) % 2 == 0, -6.0, 6.0), r.uniform(-1.2, 1.2, m),
                  r.uniform(-1.2, 1.2, m)], 1).astype(np.float32)
    d = np.stack([np.where(np.arange(m) % 2 == 0, 1.0, -1.0), r.normal(scale=0.05, size=m),
                  r.normal(scale=0.05, size=m)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = _pack(o, d, np.zeros(m, np.float32), np.full(m, 1e30, np.float32))
    got = ci.closest(rays, sup, torch.from_numpy(cl), blocks, n)
    want = ti.closest(rays, torch.from_numpy(nodes), blocks, n, span)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    prim = got[3].numpy()
    assert not np.isin(prim, np.r_[8500:8540, 8900:8920]).any()
    assert np.isin(prim, np.r_[100:140]).any() and np.isin(prim, np.r_[1000:1020]).any()


def test_plain_chunking_does_not_change_results(soup, monkeypatch):
    o, d, t_min, t_max = _soup_rays(300, seed=12)
    rays = _pack(o, d, t_min, t_max)
    args = (soup.tri_superclusters, soup.tri_clusters, soup.tri_blocks, soup.n_tris)
    full = ci.closest_plain(rays, *args)
    occ = ci.any_hit_plain(rays, *args)
    monkeypatch.setattr(ti, "PLAIN_RAYS_PER_CHUNK", 97)
    for a, b in zip(full, ci.closest_plain(rays, *args)):
        assert torch.equal(a, b)
    assert torch.equal(occ, ci.any_hit_plain(rays, *args))


def test_wrapper_rejects_bad_inputs(soup):
    rays = torch.zeros((8, 4))
    boxes = (soup.tri_superclusters, soup.tri_clusters)
    args = (*boxes, soup.tri_blocks, soup.n_tris)
    with pytest.raises(ValueError):
        ci.closest(torch.zeros((7, 4)), *args)
    with pytest.raises(TypeError):
        ci.closest(rays.double(), *args)
    with pytest.raises(ValueError):
        ci.any_hit(rays, soup.tri_superclusters[:, :6], *args[1:])
    with pytest.raises(ValueError):
        ci.closest(rays, soup.tri_superclusters, soup.tri_clusters[:3], *args[2:])
    with pytest.raises(TypeError):
        ci.closest(rays, *boxes, None, soup.n_tris)  # no store
    with pytest.raises(ValueError):
        ci.any_hit(rays, *boxes, row_store(soup.tri_blocks, soup.n_tris), soup.n_tris)
    with pytest.raises(ValueError):
        ci.closest(rays, *boxes, soup.tri_blocks, soup.n_tris + 128)  # too few columns
    port, _ = compiled("pair")
    iargs = (port.inst_f32, port.inst_i32, port.tri_superclusters, port.tri_clusters)
    with pytest.raises(ValueError):
        ci.instanced_closest(rays, port.inst_f32[:, :8], *iargs[1:], port.inst_tri_blocks)
    with pytest.raises(TypeError):
        ci.instanced_closest(rays, *iargs, None)  # no store
    with pytest.raises(ValueError):
        ci.instanced_any_hit(rays, *iargs, row_store(port.inst_tri_blocks))


# ------------------------- instanced sweep ----------------------------------

@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_plain_instanced_sweep_matches_run_instanced(name):
    port, ref = compiled(name)
    if name == "pair":
        o, d = _rays(400, seed=9)
        t_max = np.full(400, 1e30, np.float32)
        t_max[::5] = 0.0
        t_max[1::5] = 3.0
    else:
        o, d, t_max = _forest_rays(400, seed=3)
    t_min = np.zeros(len(o), np.float32)
    rays_r, nr = _ref_pack(o, d, t_min, t_max)
    args_r = (jnp.asarray(ref.inst_pallas_f32), jnp.asarray(ref.inst_pallas_i32),
              jnp.asarray(ref.tri_superclusters), jnp.asarray(ref.tri_clusters),
              jnp.asarray(ref.inst_tris16))
    rays = _pack(o, d, t_min, t_max)
    args = (port.inst_f32, port.inst_i32, port.tri_superclusters, port.tri_clusters,
            port.inst_tri_blocks)
    ref_hit = _unpack(ref_cluster.run_instanced(rays_r, *args_r, False, interpret=True), nr, False)
    _assert_closest_equal(ci.instanced_closest(rays, *args), ref_hit)
    ref_occ = _unpack(ref_cluster.run_instanced(rays_r, *args_r, True, interpret=True), nr, True)
    occ = ci.instanced_any_hit(rays, *args)
    np.testing.assert_array_equal(occ.numpy(), ref_occ)
    np.testing.assert_array_equal(occ.numpy(), ref_hit[4])


@pytest.mark.parametrize("name", ["pair", "forest8"])
def test_instanced_cluster_route_equals_instanced_tree_route(name):
    """The two-level scene with its tree nulled takes the linear instanced
    sweep (pallas_intersect.py:346-355); it answers as the instanced tree
    walk does, bit for bit."""
    port, _ = compiled(name)
    nulled = dataclasses.replace(port, tri_tree=None)
    o, d, t_max = _forest_rays(1000, seed=21) if name == "forest8" else (*_rays(1000, 5), None)
    n = len(o)
    t_max = np.full(n, 1e30, np.float32) if t_max is None else t_max
    o3, d3 = V3(*torch.from_numpy(o).T), V3(*torch.from_numpy(d).T)
    tmn, tmx = torch.zeros(n), torch.from_numpy(t_max)
    a = intersect_soa(nulled, o3, d3, tmn, tmx)
    b = intersect_soa(port, o3, d3, tmn, tmx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.valid.sum()) > 100
    assert torch.equal(occlude_soa(nulled, o3, d3, tmn, tmx), occlude_soa(port, o3, d3, tmn, tmx))


# ------------------ the plain sweeps on both triangle layouts ----------------

@pytest.mark.parametrize("any_hit", [False, True])
def test_flat_plain_sweep_same_on_both_stores(soup, any_hit):
    """The flat sweep on ``tri_blocks`` == on the [T, 12] row layout of the
    same triangles (read through its transpose): the same bits and the same
    ``WalkStats`` box, triangle and distinct-row counts."""
    o, d, t_min, t_max = _soup_rays(600, seed=17)
    rays = _pack(o, d, t_min, t_max)
    sweep = ci.any_hit_plain if any_hit else ci.closest_plain
    boxes = (soup.tri_superclusters, soup.tri_clusters)
    s_blocks, s_rows = ti.WalkStats(), ti.WalkStats()
    got = sweep(rays, *boxes, soup.tri_blocks, soup.n_tris, stats=s_blocks)
    want = sweep(rays, *boxes, row_store(soup.tri_blocks, soup.n_tris).T, soup.n_tris,
                 stats=s_rows)
    _assert_same(got, want)
    _assert_same_stats(s_blocks, s_rows)
    hits = got if any_hit else got[3] >= 0
    assert int(hits.sum()) > 50 and s_blocks.mt > 0
    assert set(s_blocks.rows) == {"supers", "clusters", "tri_blocks"}


@pytest.mark.parametrize("any_hit", [False, True])
def test_instanced_plain_sweep_same_on_both_stores(any_hit):
    """The instanced sweep on ``inst_tri_blocks`` == on its row layout:
    the same bits and the same counts, transforms included."""
    port, _ = compiled("forest8")
    o, d, t_max = _forest_rays(500, seed=8)
    rays = _pack(o, d, np.zeros(len(o), np.float32), t_max)
    sweep = ci.instanced_any_hit_plain if any_hit else ci.instanced_closest_plain
    args = (port.inst_f32, port.inst_i32, port.tri_superclusters, port.tri_clusters)
    s_blocks, s_rows = ti.WalkStats(), ti.WalkStats()
    got = sweep(rays, *args, port.inst_tri_blocks, stats=s_blocks)
    want = sweep(rays, *args, row_store(port.inst_tri_blocks).T, stats=s_rows)
    _assert_same(got, want)
    _assert_same_stats(s_blocks, s_rows)
    hits = got if any_hit else got[3] >= 0
    assert int(hits.sum()) > 30 and s_blocks.xform > 0
