"""Port parity: the component-major triangle stores of the two tree walks
(``SceneArrays.tri_blocks``, ``SceneArrays.inst_tri_blocks``) and the
order-independence of a leaf's closest-hit update, which the CUDA kernels'
warp reduction relies on.

- The stores equal rows 0-8 of the JAX package's ``tri_blocks`` and
  ``inst_tris16`` (exact; both compiles run the same NumPy arithmetic).
- The plain walks on them give the same (t, u, v, prim) bits and the same
  ``WalkStats`` counts as on the [T, 12] row layout of the same triangles
  (``row_store``) read through its transpose (exact).
- ``Best.update`` over one leaf split into its four 32-triangle quarters,
  applied in any order, gives the bits of one pass (exact; a hypothesis
  test with exact-t ties, any-hit queries and a partial last cluster).
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from akari_torch.bvh import cluster_tree as ct
from akari_torch.ops import instanced_tree_intersect as iti
from akari_torch.ops import tree_intersect as ti
from akari_torch.scene.arrays import from_numpy_scene
from akari_torch.scene.builtin import terrain_scene
from akari_tpu.scene.builtin import terrain_scene as ref_terrain_scene
from test_torch_instancing import compiled

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def terrain():
    """The n=64 terrain (7,940 triangles, 7,957 stored: a partial last
    cluster), compiled by the port and by the JAX package (its tree
    route)."""
    ref = jax.tree_util.tree_map(
        np.asarray, ref_terrain_scene(8, 8, n=64).compile(intersector="pallas"))
    port = terrain_scene(8, 8, n=64).compile(device="cpu")
    assert port.intersector == "tree" and port.n_tris == ref.n_tris == 7_957
    return port, ref


def _rays(n, seed, lo, hi):
    """Origins in the box [lo, hi], random directions; a third of the rays
    dead (t_max = 0), a third bounded."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(r.integers(0, 3, n) == 0, 0.0, 1e30)
    t_max = np.where(r.integers(0, 3, n) == 0, 0.4, t_max)
    rays = np.concatenate([o.T, d.T, np.zeros((1, n)), t_max[None]], axis=0)
    return torch.from_numpy(np.ascontiguousarray(rays, dtype=np.float32))


def row_store(blocks, n=None):
    """The [n, 12] row layout (v0.xyz e1.xyz e2.xyz, 3 zero floats a row;
    the store the linear kernels read before the component-major one) of
    the first ``n`` columns of a component-major store."""
    n = blocks.shape[1] if n is None else n
    pad = torch.zeros((n, 3), dtype=blocks.dtype, device=blocks.device)
    return torch.cat([blocks[:9, :n].T, pad], 1).contiguous()


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(_bits(a), _bits(b))
    else:
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))


def _assert_same_stats(s1, s2):
    assert (s1.slab, s1.mt, s1.xform) == (s2.slab, s2.mt, s2.xform)
    assert s1.rows.keys() == s2.rows.keys()
    for k in s1.rows:
        assert torch.equal(s1.rows[k], s2.rows[k]), k


# ------------------------------- stores -------------------------------------

def test_flat_store_equals_reference_tri_blocks(terrain):
    port, ref = terrain
    blocks = np.asarray(ref.tri_blocks)
    assert blocks.shape == (16, 63 * 128) and not blocks[9:].any()  # 62 clusters + 21 tris
    np.testing.assert_array_equal(port.tri_blocks.numpy(), blocks[:9])
    np.testing.assert_array_equal(from_numpy_scene(ref, intersector="tree",
                                                   device="cpu").tri_blocks.numpy(),
                                  blocks[:9])
    np.testing.assert_array_equal(
        port.tri_blocks.numpy(),
        ct.tri_blocks(port.tri_v0.numpy(), port.tri_e1.numpy(), port.tri_e2.numpy()))


def test_instanced_store_equals_reference_inst_tris16():
    port, ref = compiled("forest8")
    t16 = np.asarray(ref.inst_tris16)
    np.testing.assert_array_equal(port.inst_tri_blocks.numpy(), t16[:9])
    conv = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), intersector="tree",
                            device="cpu")
    np.testing.assert_array_equal(conv.inst_tri_blocks.numpy(), t16[:9])


# ------------------------ plain walks on both stores ------------------------

@pytest.mark.parametrize("leaf_span", [1, 2])
@pytest.mark.parametrize("any_hit", [False, True])
def test_flat_plain_walk_same_on_both_stores(terrain, leaf_span, any_hit):
    port, _ = terrain
    nodes, span = ct.build_cluster_tree(port.tri_clusters.numpy(), port.n_tris, leaf_span)
    nodes = torch.from_numpy(nodes)
    rays = _rays(1500, 3 + leaf_span, (-1.0, 0.0, -1.0), (1.0, 1.0, 1.0))
    walk = ti.any_hit_plain if any_hit else ti.closest_plain
    s_blocks, s_rows = ti.WalkStats(), ti.WalkStats()
    got = walk(rays, nodes, port.tri_blocks, port.n_tris, span, stats=s_blocks)
    want = walk(rays, nodes, row_store(port.tri_blocks, port.n_tris).T, port.n_tris, span,
                stats=s_rows)
    _assert_same(got, want)
    _assert_same_stats(s_blocks, s_rows)
    hits = got if any_hit else got[3] >= 0
    assert int(hits.sum()) > 100 and s_blocks.mt > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_instanced_plain_walk_same_on_both_stores(any_hit):
    port, _ = compiled("forest8")
    rays = _rays(1500, 9, (-7.0, 0.2, -7.0), (7.0, 2.5, 7.0))
    walk = iti.any_hit_plain if any_hit else iti.closest_plain
    args = (port.inst_f32, port.inst_i32, port.tri_tree)
    s_blocks, s_rows = ti.WalkStats(), ti.WalkStats()
    got = walk(rays, *args, port.inst_tri_blocks, port.tree_leaf_span, stats=s_blocks)
    want = walk(rays, *args, row_store(port.inst_tri_blocks).T, port.tree_leaf_span,
                stats=s_rows)
    _assert_same(got, want)
    _assert_same_stats(s_blocks, s_rows)
    hits = got if any_hit else got[3] >= 0
    assert int(hits.sum()) > 50 and s_blocks.xform > 0


# ------------------- a leaf's update in any quarter order -------------------

def _leaf(seed, n_rays=64):
    """One 128-triangle leaf near the origin with exact duplicates across
    its quarters, and rays toward it from z = -3 (some dead, some bounded
    at the leaf's depth)."""
    r = np.random.default_rng(seed)
    c = ct.TRI_TILE
    v0 = np.stack([r.uniform(-1, 1, c), r.uniform(-1, 1, c), r.uniform(-0.2, 0.2, c)], 1)
    tri = np.concatenate([v0, r.normal(scale=0.6, size=(c, 6))], 1).astype(np.float32)
    tri[r.integers(0, c, 24)] = tri[r.integers(0, c, 24)]  # exact-t ties
    o = np.stack([r.uniform(-1, 1, n_rays), r.uniform(-1, 1, n_rays),
                  np.full(n_rays, -3.0)], 1)
    tgt = np.stack([r.uniform(-1, 1, n_rays), r.uniform(-1, 1, n_rays),
                    np.zeros(n_rays)], 1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    t_max = r.choice(np.asarray([1e30, 0.0, 3.0, 2.9], np.float32), n_rays)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return (f(tri.T), [f(o[:, k]) for k in range(3)], [f(d[:, k]) for k in range(3)],
            torch.zeros(n_rays), f(t_max))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n_real=st.integers(1, 128),
       order=st.permutations(range(4)), any_hit=st.booleans(),
       earlier=st.sampled_from([None, 0, 4096]))
def test_leaf_update_does_not_depend_on_the_order_of_its_quarters(
        seed, n_real, order, any_hit, earlier):
    """One pass of ``Best.update`` over a leaf == its four 32-triangle
    quarters applied in any order: the property the kernels' warp
    reduction relies on. ``earlier`` first applies a leaf of duplicates
    whose prims are lower (0) or higher (4096) than this leaf's, so hits
    also tie with the running best."""
    blocks, o, d, tmin, t_max = _leaf(seed)
    n = t_max.shape[0]
    li = torch.arange(n)
    tri = blocks[:, None, :].expand(9, n, ct.TRI_TILE)
    real = (torch.arange(ct.TRI_TILE) < n_real)[None, :].expand(n, ct.TRI_TILE)
    prim0 = torch.full((n,), 1024, dtype=torch.int64)
    one, parts = ti.Best(t_max, any_hit), ti.Best(t_max, any_hit)
    if earlier is not None:
        for b in (one, parts):
            b.update(li, o, d, tmin, tri[:, :, ::4], real[:, ::4],
                     torch.full((n,), earlier, dtype=torch.int64))
    one.update(li, o, d, tmin, tri, real, prim0)
    for q in order:
        sl = slice(32 * q, 32 * q + 32)
        parts.update(li, o, d, tmin, tri[:, :, sl], real[:, sl], prim0 + 32 * q)
    _assert_same(one.result(), parts.result())
    if not any_hit:
        assert torch.equal(one.prim, parts.prim)
