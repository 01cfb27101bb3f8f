"""Port parity: the tree walk (akari_torch.bvh.cluster_tree,
ops.tree_intersect, ops.ray_sort, the "tree" route of ops.intersect and
"auto" routing) vs akari_tpu (pallas_cluster / pallas_tree / the brute
backend).

The JAX side reaches the Pallas tree kernel through ``run_tree`` in
interpret mode, as tests/test_pallas.py does. Tolerances: tables, sort
keys, prim ids, validity and any-hit flags exact; t/u/v rtol = atol =
1e-6 scaled per hit by the test's condition number 1 + |e1 x e2| / |det|,
since XLA may contract the Moeller-Trumbore products into FMAs where the
port rounds op by op and a grazing hit divides that difference by a small
determinant (the reasoning of tests/test_torch_intersect.py). The port's
plain walk and its dense plain version round op by op alike: they must
agree bit for bit. The CUDA kernel runs only on the card: its tests are
in tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
from _imgcmp import assert_images_match
from akari_torch.bvh import cluster_tree as ct
from akari_torch.core.v3 import V3
from akari_torch.integrators import path as port_path
from akari_torch.ops import dense_intersect as di
from akari_torch.ops import tree_intersect as ti
from akari_torch.ops.intersect import brute_closest, intersect_soa, occlude_soa
from akari_torch.ops.ray_sort import sort_keys_soa
from akari_torch.scene.arrays import from_numpy_scene, make_camera
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.ops import pallas_cluster as ref_cluster
from akari_tpu.ops import pallas_intersect as pi
from akari_tpu.ops import pallas_tree as ref_tree
from test_torch_leaf_store import row_store

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


def _soup_mesh(mod, n_tri=6000, seed=13, spread=4.0, size=0.15):
    """Random small triangles in a box (tests/test_pallas.py's soup)."""
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, size=(n_tri, 1, 3))
    tris = (base + r.normal(scale=size, size=(n_tri, 3, 3))).astype(np.float32)
    verts = tris.reshape(-1, 3)
    idx = np.arange(verts.shape[0]).reshape(-1, 3)
    return mod.Mesh(vertices=verts, indices=idx)


@pytest.fixture(scope="module")
def soup():
    """The 6,000-triangle soup compiled by the port (tree tables built)."""
    scene = port_nodes.compile_scene([_soup_mesh(port_nodes)], intersector="auto", device="cpu")
    assert scene.intersector == "tree" and scene.tri_tree is not None
    return scene


def _rays(n, seed, spread=5.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _pack(o, d, t_min, t_max):
    return torch.from_numpy(
        np.ascontiguousarray(
            np.concatenate([o.T, d.T, t_min[None], t_max[None]], axis=0),
            dtype=np.float32,
        )
    )


def _limits(scene, o, d, seed):
    """t_max per ray: a third bounded to half the ray's own hit distance,
    a third dead (t_max = 0), the rest unbounded."""
    n = o.shape[0]
    t_hit = di.closest_plain(
        _pack(o, d, np.zeros(n, np.float32), np.full(n, 1e30, np.float32)),
        scene.prim_table,
    )[0].numpy()
    sel = np.random.default_rng(seed + 100).integers(0, 3, n)
    t_max = np.where(sel == 0, t_hit * 0.5, np.where(sel == 1, 0.0, 1e30))
    return np.zeros(n, np.float32), t_max.astype(np.float32)


def _condition(tris, d, prim):
    """1 + |e1 x e2| / |det| of each ray's hit triangle (float64)."""
    k = np.maximum(prim, 0)
    e1 = tris[k, 3:6].astype(np.float64)
    e2 = tris[k, 6:9].astype(np.float64)
    det = np.abs(np.sum(e1 * np.cross(d.astype(np.float64), e2), axis=-1))
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    return 1.0 + area2 / np.maximum(det, 1e-30)


def _run_tree(scene, tree, span, o, d, t_min, t_max, any_hit):
    """The reference's Pallas tree kernel (interpret mode) on the scene."""
    rays, n = pi._pack_rays_soa(
        JV3(*(jnp.asarray(c) for c in o.T)), JV3(*(jnp.asarray(c) for c in d.T)),
        jnp.asarray(t_min), jnp.asarray(t_max), ray_tile=ref_tree.TREE_RAY_TILE,
    )
    tris_t = pi.pack_tris_t(
        jnp.asarray(scene.tri_v0.numpy()), jnp.asarray(scene.tri_e1.numpy()),
        jnp.asarray(scene.tri_e2.numpy()),
    )
    out = ref_tree.run_tree(
        rays, tris_t, jnp.asarray(tree), any_hit,
        n_clusters=ct.n_clusters(scene.n_tris), leaf_span=span, interpret=True,
    )
    out = np.asarray(out)[:, :n]
    if any_hit:
        return out[0] > 0.5
    return tuple(np.asarray(x) for x in pi._unpack_closest(jnp.asarray(out)))


# ------------------------------- tables -------------------------------------

def test_clusters_equal_reference(soup):
    ours = ct.build_clusters(soup.tri_v0.numpy(), soup.tri_e1.numpy(), soup.tri_e2.numpy())
    ref = ref_cluster.build_clusters(soup.tri_v0.numpy(), soup.tri_e1.numpy(), soup.tri_e2.numpy())
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(soup.tri_clusters.numpy(), ref)


@pytest.mark.parametrize("leaf_span", [None, 1, 2, 4])
def test_cluster_tree_equal_reference(soup, leaf_span):
    cl = soup.tri_clusters.numpy()
    nodes, span = ct.build_cluster_tree(cl, soup.n_tris, leaf_span=leaf_span)
    ref_nodes, ref_span = ref_tree.build_cluster_tree(cl, soup.n_tris, leaf_span=leaf_span)
    assert span == ref_span
    assert nodes.dtype == ref_nodes.dtype
    np.testing.assert_array_equal(nodes, ref_nodes)
    assert ct.tree_depth(nodes) + 1 <= ct.STACK_DEPTH


def test_cluster_tree_refuses_a_stack_overflow(soup, monkeypatch):
    nodes, _ = ct.build_cluster_tree(soup.tri_clusters.numpy(), soup.n_tris)
    depth = ct.tree_depth(nodes)
    assert depth >= 3
    monkeypatch.setattr(ct, "STACK_DEPTH", depth)
    with pytest.raises(ValueError, match="stack"):
        ct.build_cluster_tree(soup.tri_clusters.numpy(), soup.n_tris)


def test_tree_tris_store_rows(soup):
    """The component-major store that the tree walk and the linear sweep
    read holds each storage triangle's v0 e1 e2 (the dense kernel's rows)
    in its column, and zero columns up to whole clusters."""
    blocks = soup.tri_blocks.numpy()
    assert blocks.shape == (9, ct.n_clusters(soup.n_tris) * ct.TRI_TILE)
    np.testing.assert_array_equal(blocks[:, :soup.n_tris].T, soup.prim_table.numpy()[:, 0:9])
    assert not blocks[:, soup.n_tris:].any()


# ------------------------------ sort keys -----------------------------------

@pytest.mark.parametrize("hint", ["primary", "secondary"])
def test_sort_keys_equal_reference(hint):
    o, d = _rays(3000, seed=31, spread=6.0)  # some origins outside the bounds
    t_min = np.zeros(3000, np.float32)
    t_max = np.full(3000, 1e30, np.float32)
    t_max[::7] = 0.0
    lo = np.asarray([-4.0, -3.5, -4.2], np.float32)
    hi = np.asarray([4.1, 3.9, 4.0], np.float32)
    ref = pi._sort_keys_soa(
        JV3(*(jnp.asarray(c) for c in o.T)), JV3(*(jnp.asarray(c) for c in d.T)),
        jnp.asarray(lo), jnp.asarray(hi), t_min=jnp.asarray(t_min),
        t_max=jnp.asarray(t_max), hint=hint,
    )
    got = sort_keys_soa(
        V3(*torch.from_numpy(o).T), V3(*torch.from_numpy(d).T),
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(t_min),
        torch.from_numpy(t_max), hint=hint,
    )
    assert np.asarray(ref).dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert (got.numpy()[::7] == 0xFFFFFFFF).all()


# ------------------------- plain walk vs run_tree ---------------------------

def _assert_prims_equal_up_to_sbvh_copies(scene, prim, ref_prim):
    """Storage prims equal, except where the SBVH stored one triangle in
    two clusters: both copies hit at the same t, the Pallas walk keeps the
    copy its tile visits first and the port the lower index (the stated
    tie rule). The original triangle is always the same, and the port's
    copy hits at exactly the t of the copy the reference kept."""
    p2o = scene.prim_to_orig.numpy()
    valid = ref_prim >= 0
    np.testing.assert_array_equal(prim >= 0, valid)
    np.testing.assert_array_equal(p2o[prim[valid]], p2o[ref_prim[valid]])
    diff = np.nonzero(prim != ref_prim)[0]
    assert (prim[diff] < ref_prim[diff]).all()
    assert len(diff) < 0.02 * len(prim)
    if len(diff):
        rows = scene.prim_table.numpy()[:, 0:9]
        np.testing.assert_array_equal(rows[prim[diff]], rows[ref_prim[diff]])

@pytest.mark.parametrize("leaf_span", [1, 2])
@pytest.mark.parametrize("sort", [False, True])
def test_plain_walk_matches_run_tree(soup, leaf_span, sort):
    n = 700
    o, d = _rays(n, seed=4 + leaf_span + 2 * sort)
    t_min, t_max = _limits(soup, o, d, seed=leaf_span)
    if sort:
        k = ct.n_clusters(soup.n_tris)
        key = sort_keys_soa(
            V3(*torch.from_numpy(o).T), V3(*torch.from_numpy(d).T),
            soup.tri_clusters[:k, 0:3].min(0).values,
            soup.tri_clusters[:k, 3:6].max(0).values,
            torch.from_numpy(t_min), torch.from_numpy(t_max), hint="secondary",
        )
        order = torch.argsort(key, stable=True).numpy()
        o, d, t_min, t_max = o[order], d[order], t_min[order], t_max[order]
    tree, span = ct.build_cluster_tree(soup.tri_clusters.numpy(), soup.n_tris, leaf_span)
    ref_t, ref_prim, ref_u, ref_v, ref_valid = _run_tree(
        soup, tree, span, o, d, t_min, t_max, any_hit=False
    )
    rays = _pack(o, d, t_min, t_max)
    t, u, v, prim = ti.closest(rays, torch.from_numpy(tree), soup.tri_blocks, soup.n_tris, span)
    np.testing.assert_array_equal(prim.numpy() >= 0, ref_valid)
    _assert_prims_equal_up_to_sbvh_copies(soup, prim.numpy(), ref_prim)
    ok = ref_valid
    cond = _condition(soup.prim_table.numpy(), d, prim.numpy())
    for a, b in ((t.numpy(), ref_t), (u.numpy(), ref_u), (v.numpy(), ref_v)):
        bound = cond[ok] * (TOL["atol"] + TOL["rtol"] * np.abs(b[ok]))
        assert np.all(np.abs(a[ok] - b[ok]) <= bound)
    assert np.all(t.numpy()[~ok] == np.float32(1e30))
    assert not u.numpy()[~ok].any() and not v.numpy()[~ok].any()
    ref_occ = _run_tree(soup, tree, span, o, d, t_min, t_max, any_hit=True)
    occ = ti.any_hit(rays, torch.from_numpy(tree), soup.tri_blocks, soup.n_tris, span)
    np.testing.assert_array_equal(occ.numpy(), ref_occ)
    np.testing.assert_array_equal(occ.numpy(), ok)
    # hits, bounded and dead rays were all exercised
    assert ok.sum() > 50 and (t_max == 0).any() and ((t_max > 0) & (t_max < 1e29)).any()


def _tie_soup(n=2000, seed=5):
    """Triangles sorted along x (coherent clusters) with exact duplicates
    placed in other clusters, lower and higher indices alike."""
    r = np.random.default_rng(seed)
    v0 = r.uniform([-4.0, -1.0, -1.0], [4.0, 1.0, 1.0], size=(n, 3))
    v0 = v0[np.argsort(v0[:, 0])]
    e1 = r.normal(scale=0.4, size=(n, 3))
    e2 = r.normal(scale=0.4, size=(n, 3))
    tris = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    tris[1500:1540] = tris[100:140]    # duplicate far along +x
    tris[1000:1020] = tris[1900:1920]  # duplicate of a later triangle
    tris[300:310] = tris[1200:1210]
    return tris


def _tables(tris):
    clusters = ct.build_clusters(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    nodes, span = ct.build_cluster_tree(clusters, tris.shape[0], leaf_span=1)
    blocks = ct.tri_blocks(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    return torch.from_numpy(nodes), torch.from_numpy(blocks), tris.shape[0], span


def test_tie_rule_matches_dense_and_brute():
    """Exact duplicates across clusters: the walk returns the lowest index
    whatever cluster it visits first, like the dense sweep and the brute
    oracle."""
    tris = _tie_soup()
    nodes, blocks, n_tris, span = _tables(tris)
    r = np.random.default_rng(8)
    n = 3000
    # rays along +x and along -x visit the duplicate clusters in both orders
    o = np.stack([np.where(np.arange(n) % 2 == 0, -6.0, 6.0),
                  r.uniform(-1.2, 1.2, n), r.uniform(-1.2, 1.2, n)], axis=1).astype(np.float32)
    d = np.stack([np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                  r.normal(scale=0.05, size=n), r.normal(scale=0.05, size=n)], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = np.full(n, 1e30, np.float32)
    rays = _pack(o, d, t_min, t_max)
    got = ti.closest(rays, nodes, blocks, n_tris, span)
    want = di.closest_plain(rays, torch.from_numpy(tris))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    scene = SimpleScene(tris)
    bt, bprim, bu, bv, bvalid = brute_closest(
        scene, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_min),
        torch.from_numpy(t_max),
    )
    np.testing.assert_array_equal(got[3].numpy(), bprim.numpy())
    np.testing.assert_allclose(got[0].numpy(), bt.numpy(), **TOL)
    prim = got[3].numpy()
    assert not np.isin(prim, np.r_[1500:1540, 1900:1920, 1200:1210]).any()
    assert np.isin(prim, np.r_[100:140]).any() and np.isin(prim, np.r_[1000:1020]).any()
    np.testing.assert_array_equal(
        ti.any_hit(rays, nodes, blocks, n_tris, span).numpy(), prim >= 0
    )


class SimpleScene:
    """The triangle fields ``brute_closest`` reads."""

    def __init__(self, tris):
        self.tri_v0 = torch.from_numpy(np.ascontiguousarray(tris[:, 0:3]))
        self.tri_e1 = torch.from_numpy(np.ascontiguousarray(tris[:, 3:6]))
        self.tri_e2 = torch.from_numpy(np.ascontiguousarray(tris[:, 6:9]))


def test_plain_chunking_does_not_change_results(soup, monkeypatch):
    o, d = _rays(400, seed=12)
    t_min, t_max = _limits(soup, o, d, seed=12)
    rays = _pack(o, d, t_min, t_max)
    args = (soup.tri_tree, soup.tri_blocks, soup.n_tris, soup.tree_leaf_span)
    full = ti.closest_plain(rays, *args)
    occ = ti.any_hit_plain(rays, *args)
    monkeypatch.setattr(ti, "PLAIN_RAYS_PER_CHUNK", 97)
    monkeypatch.setattr(ti, "PLAIN_LEAF_PAIRS", 128 * 5)
    for a, b in zip(full, ti.closest_plain(rays, *args)):
        assert torch.equal(a, b)
    assert torch.equal(occ, ti.any_hit_plain(rays, *args))


def test_wrapper_rejects_bad_inputs(soup):
    rays = torch.zeros((8, 4))
    args = (soup.tri_tree, soup.tri_blocks, soup.n_tris)
    with pytest.raises(ValueError):
        ti.closest(torch.zeros((7, 4)), *args)
    with pytest.raises(TypeError):
        ti.closest(rays.double(), *args)
    with pytest.raises(ValueError):
        ti.any_hit(rays, soup.tri_tree[:, :15], *args[1:])
    with pytest.raises(ValueError):
        ti.any_hit(rays, soup.tri_tree, row_store(soup.tri_blocks, soup.n_tris),
                   soup.n_tris)  # the row store
    with pytest.raises(ValueError):
        ti.any_hit(rays, soup.tri_tree, soup.tri_blocks, soup.n_tris + 128)  # too few columns
    with pytest.raises(ValueError):
        ti.closest(rays, *args, leaf_span=0)


# --------------------------- route and routing ------------------------------

@pytest.mark.parametrize("leaf_span", [1, 2])
def test_tree_route_matches_dense_route(soup, leaf_span):
    """intersect_soa / occlude_soa through the tree route (plain walk on
    the CPU, one or two clusters per leaf) == the dense route, bit for
    bit."""
    import dataclasses

    nodes, span = ct.build_cluster_tree(soup.tri_clusters.numpy(), soup.n_tris, leaf_span)
    tree = dataclasses.replace(soup, tri_tree=torch.from_numpy(nodes), tree_leaf_span=span)
    o, d = _rays(1500, seed=21 + leaf_span)
    t_min, t_max = _limits(soup, o, d, seed=21 + leaf_span)
    o3, d3 = V3(*torch.from_numpy(o).T), V3(*torch.from_numpy(d).T)
    tmn, tmx = torch.from_numpy(t_min), torch.from_numpy(t_max)
    dense = dataclasses.replace(soup, intersector="dense")
    a = intersect_soa(tree, o3, d3, tmn, tmx)
    b = intersect_soa(dense, o3, d3, tmn, tmx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.valid.sum()) > 100
    np.testing.assert_array_equal(
        occlude_soa(tree, o3, d3, tmn, tmx).numpy(),
        occlude_soa(dense, o3, d3, tmn, tmx).numpy(),
    )


def _grid_mesh(mod, n_tri):
    """Tiny separated triangles on a grid: the SBVH stores each once."""
    side = int(np.ceil(n_tri ** (1 / 3)))
    g = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    base = g[:n_tri].astype(np.float32)[:, None, :]
    corner = np.asarray([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0.1]], np.float32)
    verts = (base + corner[None]).reshape(-1, 3)
    return mod.Mesh(vertices=verts, indices=np.arange(3 * n_tri).reshape(-1, 3))


@pytest.mark.parametrize("n_tri, route", [(4096, "dense"), (4097, "tree")])
def test_auto_routing_at_the_threshold(n_tri, route):
    """"auto" takes the dense sweep at or under DENSE_MAX_TRIS storage
    triangles and the tree walk above, where the reference builds its
    tree (counterpart of tests/test_auto.py, without the TPU gates)."""
    import akari_tpu.scene.nodes as ref_nodes

    assert port_nodes.resolve_intersector("auto", n_tri) == route
    port = port_nodes.compile_scene([_grid_mesh(port_nodes, n_tri)], intersector="auto",
                                    device="cpu")
    ref = ref_nodes.compile_scene([_grid_mesh(ref_nodes, n_tri)], intersector="pallas")
    assert port.n_tris == ref.n_tris == n_tri
    assert port.intersector == route
    assert (ref.tri_tree is not None) == (route == "tree") == (port.tri_tree is not None)
    assert port_nodes.resolve_intersector("dense", n_tri) == "dense"
    assert port_nodes.resolve_intersector("tree", 36) == "tree"


def test_tree_tables_carried_from_the_reference():
    """from_numpy_scene of the JAX compile == the port's own compile on
    the 7,940-triangle terrain (tree route)."""
    from akari_torch.scene.builtin import terrain_scene
    from akari_tpu.scene.builtin import terrain_scene as ref_terrain_scene

    ref = jax.tree_util.tree_map(
        np.asarray, ref_terrain_scene(8, 8, n=64).compile(intersector="pallas")
    )
    conv = from_numpy_scene(ref, intersector="tree", device="cpu")
    port = terrain_scene(8, 8, n=64).compile(device="cpu")
    assert port.intersector == "tree" and port.n_tris == ref.n_tris
    for f in ("tri_clusters", "tri_tree", "tri_blocks", "prim_table"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(), getattr(port, f).numpy())
    np.testing.assert_array_equal(port.tri_tree.numpy(), np.asarray(ref.tri_tree))
    np.testing.assert_array_equal(port.tri_blocks.numpy(), np.asarray(ref.tri_blocks)[:9])
    assert port.tree_leaf_span == conv.tree_leaf_span == ref.tree_leaf_span == 1


def test_tree_queries_per_trace(soup, monkeypatch):
    """One primary query plus one fused shadow+extension query per bounce
    on the tree route too: 1 + max_depth closest-hit launches."""
    from akari_torch.core import transform

    calls = []
    real = ti.closest

    def counting(rays, *args):
        calls.append(rays.shape[1])
        return real(rays, *args)

    monkeypatch.setattr(ti, "closest", counting)
    light = port_nodes.Mesh(
        vertices=np.asarray([[-1, 6, -1], [1, 6, -1], [1, 6, 1], [-1, 6, 1]], np.float32),
        indices=np.asarray([[0, 2, 1], [0, 3, 2]]),
        materials=[port_nodes.EmissiveMaterial((5.0, 5.0, 5.0))],
    )
    scene = port_nodes.compile_scene([_soup_mesh(port_nodes), light], device="cpu")
    assert scene.intersector == "tree" and scene.lights.n_lights == 2
    cam = make_camera(transform.look_at((0.0, 2.0, 9.0), (0.0, 0.0, 0.0)), 40.0, 8, 8)
    n = 64
    li = port_path.trace_paths(
        scene, cam, port_path.PathConfig(spp=1, max_depth=3), 0,
        torch.zeros(n, dtype=torch.int64), torch.arange(n),
    )
    assert calls == [n] + [2 * n] * 3
    assert bool(torch.isfinite(li).all())


def test_terrain_render_matches_jax_brute():
    """16x16, 1 spp render of the 7,940-triangle terrain: the port's tree
    route (plain walk) vs the JAX package's brute intersector, within the
    full-render budget of tests/test_torch_path.py."""
    from akari_torch.scene.builtin import terrain_scene
    from akari_tpu.integrators import path as ref_path
    from akari_tpu.scene.builtin import terrain_scene as ref_terrain_scene

    sc = ref_terrain_scene(16, 16, n=64)
    ref = sc.compile(intersector="brute")
    cfg_r = ref_path.PathConfig(spp=1, max_depth=3)
    img_j = np.asarray(jax.jit(ref_path.render, static_argnums=(2, 3))(ref, sc.camera, cfg_r, 0))
    psc = terrain_scene(16, 16, n=64)
    port = psc.compile(intersector="auto", device="cpu")
    assert port.intersector == "tree"
    img_p = port_path.render(port, psc.camera, port_path.PathConfig(spp=1, max_depth=3), seed=0)
    img_p = img_p.numpy()
    assert img_p.shape == (16, 16, 3) and np.isfinite(img_p).all() and img_p.mean() > 0.01
    assert_images_match(img_p, img_j, outlier_frac=0.08, mean_tol=3e-3)


def test_cli_tree_intersector_matches_dense(tmp_path):
    from PIL import Image

    from akari_torch.cli.render import main

    scene_file = str(
        __import__("pathlib").Path(__file__).resolve().parents[1]
        / "scenes" / "cornell_box" / "scene.akari"
    )
    args = ["-i", scene_file, "--device", "cpu", "--width", "12",
            "--height", "12", "--spp", "1", "--max-depth", "2"]
    a, b = tmp_path / "dense.png", tmp_path / "tree.png"
    assert main(args + ["-o", str(a), "--intersector", "dense"]) == 0
    assert main(args + ["-o", str(b), "--intersector", "tree"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_tree_modules_import_neither_jax_nor_reference():
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import akari_torch.ops.tree_intersect, akari_torch.ops.ray_sort\n"
        "import akari_torch.bvh.cluster_tree, akari_torch.native.loader\n"
        "import akari_torch.ops.intersect, akari_torch.scene.builtin\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'akari_tpu', 'triton')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
