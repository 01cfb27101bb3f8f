"""CUDA kernel tests of the port: they need the card and skip without one.

Run on a machine with a CUDA device (no JAX needed):

    python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerance: none. The kernels are built with --fmad=false and follow their
plain versions' operation order, so outputs are equal bit for bit.
"""

import pytest
import torch

from akari_torch.core.v3 import V3
from akari_torch.integrators.path import PathConfig, trace_paths
from akari_torch.bvh import cluster_tree as ct
from akari_torch.ops import dense_intersect as di
from akari_torch.ops import tree_intersect as ti
from akari_torch.scene.builtin import cornell_box, terrain_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _rays(n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand((n, 3), generator=g, device=dev) * 1.8 - 0.9
    o[:, 1] += 1.0
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), di.T_MAX, device=dev)
    t_max[::3] = 0.0
    t_max[1::3] = 0.3
    zero = torch.zeros(n, device=dev)
    return di.pack_rays(V3(*o.T), V3(*d.T), zero, t_max).contiguous()


@pytest.mark.parametrize("n", [1, 31, 33, 255, 257, 513, 5000])
def test_closest_and_any_hit_equal_plain(dev, n):
    tris = cornell_box(8, 8).compile().to(dev).prim_table
    rays = _rays(n, dev)
    before = dict(di.LAUNCHES)
    got = di.closest(rays, tris)
    want = di.closest_plain(rays, tris)
    occ = di.any_hit(rays, tris)
    torch.cuda.synchronize()
    assert di.LAUNCHES["closest"] == before["closest"] + 1
    assert di.LAUNCHES["any_hit"] == before["any_hit"] + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, di.any_hit_plain(rays, tris))
    assert torch.equal(occ, want[3] >= 0)


def test_many_chunks_of_triangles(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    tris = torch.cat(
        [torch.rand((700, 3), generator=g, device=dev) * 2 - 1,
         torch.randn((700, 6), generator=g, device=dev) * 0.2], dim=1,
    )
    tris[400:450] = tris[0:50]  # duplicates in a later chunk lose ties
    rays = _rays(3000, dev, seed=4)
    got = di.closest(rays, tris.contiguous())
    want = di.closest_plain(rays, tris)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _dense_equal_plain(rays, tris):
    """Both dense kernels == their plain versions bit for bit; the closest
    answers."""
    got = di.closest(rays, tris)
    occ = di.any_hit(rays, tris)
    torch.cuda.synchronize()
    want = di.closest_plain(rays, tris)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    assert torch.equal(occ, di.any_hit_plain(rays, tris))
    return got


def test_dense_kernels_on_the_adversarial_pack(dev):
    """Pairs on the edges of the hit test and of float32
    (``chip_smoke.adversarial_pack``): |det| at HIT_EPS and one ulp either
    side, +-0, +-inf, NaN, denormals, u or v exactly 0, u + v exactly 1."""
    import chip_smoke

    rays, tris = chip_smoke.adversarial_pack(dev, torch)
    got = _dense_equal_plain(rays, tris)
    assert int((got[3] >= 0).sum()) > 50


@pytest.mark.parametrize("pattern", ["one_dead", "one_live"])
def test_dense_dead_rays_at_every_position(dev, pattern):
    """Group b of 512 rays has its ray b dead (``one_dead``) or only its
    ray b live (``one_live``: blocks and warps with a single live lane, and
    blocks with none), so a dead or lone live ray sits at every position of
    a block of up to 512 rays. Dead means !(t_min < best_t): t_max 0, t_max
    below t_min, a NaN t_max or t_min."""
    p = 512
    rays = _rays(p * p, dev, seed=11)
    k = torch.arange(p * p, device=dev)
    mark = (k % p) == (k // p)
    dead = mark if pattern == "one_dead" else ~mark
    rays[7] = torch.where(k % 2 == 0, di.T_MAX, 0.3)
    kind = k % 4
    rays[7] = torch.where(dead & (kind == 0), 0.0, rays[7])
    rays[7] = torch.where(dead & (kind == 1), -1.0, rays[7])
    rays[7] = torch.where(dead & (kind == 2), float("nan"), rays[7])
    rays[6] = torch.where(dead & (kind == 3), float("nan"), rays[6])
    tris = cornell_box(8, 8).compile().to(dev).prim_table
    t, _, _, prim = _dense_equal_plain(rays.contiguous(), tris)
    assert bool((prim[dead] == -1).all()) and bool((t[dead] == di.T_MAX).all())
    assert int((prim[~dead] >= 0).sum()) > 0


@pytest.mark.parametrize("n_tris", [1, 35, 36, 37, 255, 256, 257, 4096])
def test_dense_triangle_counts(dev, n_tris):
    """Triangle counts across the 256-triangle chunk and up to
    DENSE_MAX_TRIS, with exact duplicates later in the list: ties go to the
    lower index."""
    g = torch.Generator(device=dev).manual_seed(n_tris)
    tris = torch.cat([torch.rand((n_tris, 3), generator=g, device=dev) * 1.8 - 0.9
                      + torch.tensor([0.0, 1.0, 0.0], device=dev),
                      torch.randn((n_tris, 6), generator=g, device=dev) * 0.4], dim=1)
    m = min(n_tris // 4, 64)
    copies = torch.arange(n_tris - m, n_tris, device=dev)
    tris[copies] = tris[:m].clone()
    got = _dense_equal_plain(_rays(4000, dev, seed=n_tris), tris.contiguous())
    assert n_tris < 35 or int((got[3] >= 0).sum()) > 0
    assert not bool(torch.isin(got[3], copies).any())


def test_trace_paths_launches_once_per_query(dev):
    sc = cornell_box(16, 16)
    scene = sc.compile().to(dev)
    cfg = PathConfig(spp=1, max_depth=3)
    n = 16 * 16
    px = torch.arange(n, device=dev)
    di.reset_launches()
    li = trace_paths(scene, sc.camera, cfg, 0, torch.zeros_like(px), px)
    torch.cuda.synchronize()
    assert di.LAUNCHES == {"closest": 1 + cfg.max_depth, "any_hit": 0}
    assert bool(torch.isfinite(li).all())


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    tris = cornell_box(8, 8).compile().to(dev).prim_table
    rays = _rays(64, dev)
    with pytest.raises(ValueError):
        di.closest(rays[:, ::2], tris)  # not contiguous
    with pytest.raises(ValueError):
        di.closest(rays, tris.cpu())  # devices differ


def _tree_soup(dev, n=20_000, seed=7, leaf_span=None):
    """A spatially sorted random soup with exact duplicates in far
    clusters (they pin the lowest-index tie rule); its tree tables:
    (tris, nodes, blocks, n, leaf_span, cluster boxes)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    v0 = torch.rand((n, 3), generator=g) * 2 - 1
    v0 = v0[torch.argsort(v0[:, 0] * 64 + (v0[:, 1] > 0) * 2 + (v0[:, 2] > 0))]
    e = torch.randn((n, 6), generator=g) * 0.05
    tris = torch.cat([v0, e], dim=1)
    tris[n - 300:n - 200] = tris[100:200]        # copies in far clusters
    tris[n // 2:n // 2 + 50] = tris[n - 50:n]     # copies of later triangles
    t = tris.numpy()
    clusters = ct.build_clusters(t[:, 0:3], t[:, 3:6], t[:, 6:9])
    nodes, span = ct.build_cluster_tree(clusters, n, leaf_span)
    blocks = ct.tri_blocks(t[:, 0:3], t[:, 3:6], t[:, 6:9])
    return (tris.to(dev), torch.from_numpy(nodes).to(dev),
            torch.from_numpy(blocks).to(dev), n, span, torch.from_numpy(clusters).to(dev))


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 40_000])
def test_tree_kernel_equals_plain_on_soup(dev, n):
    tris, nodes, blocks, n_tris, span, _ = _tree_soup(dev)
    args = (nodes, blocks, n_tris, span)
    rays = _rays(n, dev, seed=n)
    before = dict(ti.LAUNCHES)
    got = ti.closest(rays, *args)
    occ = ti.any_hit(rays, *args)
    torch.cuda.synchronize()
    assert ti.LAUNCHES["closest"] == before["closest"] + 1
    assert ti.LAUNCHES["any_hit"] == before["any_hit"] + 1
    want = ti.closest_plain(rays, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, ti.any_hit_plain(rays, *args))
    assert torch.equal(occ, want[3] >= 0)
    dense = di.closest_plain(rays, tris)  # the tie rule: lowest index wins
    assert torch.equal(got[3], dense[3])


def test_tree_kernel_equals_plain_on_terrain(dev):
    scene = terrain_scene(8, 8, n=128).compile().to(dev)
    assert scene.intersector == "tree"
    rays = _rays(30_000, dev, seed=9)
    args = (scene.tri_tree, scene.tri_blocks, scene.n_tris, scene.tree_leaf_span)
    for a, b in zip(ti.closest(rays, *args), ti.closest_plain(rays, *args)):
        assert torch.equal(a, b)
    assert torch.equal(ti.any_hit(rays, *args), ti.any_hit_plain(rays, *args))


def test_tree_trace_paths_launches_once_per_query(dev):
    sc = terrain_scene(16, 16, n=64)
    scene = sc.compile().to(dev)
    assert scene.intersector == "tree"
    cfg = PathConfig(spp=1, max_depth=3)
    px = torch.arange(16 * 16, device=dev)
    di.reset_launches()
    ti.reset_launches()
    li = trace_paths(scene, sc.camera, cfg, 0, torch.zeros_like(px), px)
    torch.cuda.synchronize()
    assert ti.LAUNCHES == {"closest": 1 + cfg.max_depth, "any_hit": 0}
    assert di.LAUNCHES == {"closest": 0, "any_hit": 0}
    assert bool(torch.isfinite(li).all())


def test_tree_wrapper_refuses_what_the_kernel_cannot_take(dev):
    _, nodes, blocks, n_tris, span, _ = _tree_soup(dev, n=3000)
    rays = _rays(64, dev)
    with pytest.raises(ValueError):
        ti.closest(rays[:, ::2], nodes, blocks, n_tris, span)  # not contiguous
    with pytest.raises(ValueError):
        ti.closest(rays, nodes.t().contiguous().t(), blocks, n_tris, span)
    with pytest.raises(TypeError):
        ti.any_hit(rays, nodes.double(), blocks, n_tris, span)
    with pytest.raises(ValueError):
        ti.any_hit(rays, nodes, blocks.cpu(), n_tris, span)  # devices differ
    with pytest.raises(ValueError):
        ti.closest(rays, nodes, blocks.view(-1)[1:1 + 9 * 128].view(9, 128), 100, span)  # off 16 B
    with pytest.raises(ValueError):
        ti.closest(rays, nodes, blocks[:, :-128], n_tris, span)  # cut short
    with pytest.raises(ValueError):
        ti.closest(rays, nodes, blocks.t().contiguous().t(), n_tris, span)  # not contiguous


# ------------------------ instanced and linear kernels ----------------------

def _forest(dev, n_instances=8, n=16, nulled=False, leaf_span=None):
    """The instanced forest compiled two-level (FLATTEN_MAX_TRIS = 1),
    with the leaf span picked as the compile picks it or forced."""
    import dataclasses

    import akari_torch.scene.nodes as nodes
    from akari_torch.scene.builtin import instanced_forest_scene

    old = nodes.FLATTEN_MAX_TRIS, nodes.pick_leaf_span
    nodes.FLATTEN_MAX_TRIS = 1
    if leaf_span is not None:
        nodes.pick_leaf_span = lambda k: leaf_span
    try:
        sc = instanced_forest_scene(16, 16, n_instances=n_instances, n=n)
        scene = sc.compile()
    finally:
        nodes.FLATTEN_MAX_TRIS, nodes.pick_leaf_span = old
    assert scene.instances is not None and scene.intersector == "tree"
    if nulled:
        scene = dataclasses.replace(scene, tri_tree=None)
    return sc, scene.to(dev)


def _forest_rays(n, dev, seed=0):
    """Rays from above the forest toward the ground; a third dead, a
    third bounded."""
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand((n, 3), generator=g, device=dev) * 14 - 7
    o[:, 1] = o[:, 1] * 0.1 + 2.5
    tgt = torch.rand((n, 3), generator=g, device=dev) * 14 - 7
    tgt[:, 1] = 0.3
    d = tgt - o
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), di.T_MAX, device=dev)
    t_max[::3] = 0.0
    t_max[1::3] = 2.5
    zero = torch.zeros(n, device=dev)
    return di.pack_rays(V3(*o.T), V3(*d.T), zero, t_max).contiguous()


def _check_module(mod, closest, any_hit, rays, args):
    """Kernel == plain version bit for bit, any-hit == closest validity,
    one launch each; the same answers on a permuted ray order."""
    before = dict(mod.LAUNCHES)
    got = getattr(mod, closest)(rays, *args)
    occ = getattr(mod, any_hit)(rays, *args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[closest] == before[closest] + 1
    assert mod.LAUNCHES[any_hit] == before[any_hit] + 1
    want = getattr(mod, closest + "_plain")(rays, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, getattr(mod, any_hit + "_plain")(rays, *args))
    assert torch.equal(occ, want[3] >= 0)
    g = torch.Generator(device=rays.device).manual_seed(1)
    perm = torch.randperm(rays.shape[1], generator=g, device=rays.device)
    for a, b in zip(getattr(mod, closest)(rays[:, perm].contiguous(), *args), got):
        assert torch.equal(a, b[perm])
    assert torch.equal(getattr(mod, any_hit)(rays[:, perm].contiguous(), *args), occ[perm])
    return got


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 20_000])
def test_instanced_tree_kernel_equals_plain(dev, n):
    from akari_torch.ops import instanced_tree_intersect as iti

    _, scene = _forest(dev)
    args = (scene.inst_f32, scene.inst_i32, scene.tri_tree, scene.inst_tri_blocks,
            scene.tree_leaf_span)
    got = _check_module(iti, "closest", "any_hit", _forest_rays(n, dev, seed=n), args)
    if n == 20_000:
        assert int((got[3] >= 0).sum()) > 1000


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 20_000])
def test_instanced_cluster_kernel_equals_plain(dev, n):
    from akari_torch.ops import cluster_intersect as ci

    _, scene = _forest(dev, nulled=True)
    args = (scene.inst_f32, scene.inst_i32, scene.tri_superclusters, scene.tri_clusters,
            scene.inst_tri_blocks)
    got = _check_module(ci, "instanced_closest", "instanced_any_hit",
                        _forest_rays(n, dev, seed=n), args)
    if n == 20_000:
        assert int((got[3] >= 0).sum()) > 1000


def _cluster_soup(dev):
    """The 20k soup of ``_tree_soup`` (20,000 = 156 clusters + 32: a
    partial last cluster; exact duplicates in far clusters) with its
    supercluster and cluster boxes: (cluster kernel args, tree args)."""
    _, nodes, blocks, n_tris, span, clusters = _tree_soup(dev)
    supers = torch.from_numpy(ct.build_superclusters(clusters.cpu().numpy(), n_tris)).to(dev)
    return (supers, clusters, blocks, n_tris), (nodes, blocks, n_tris, span)


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 40_000])
def test_flat_cluster_kernel_equals_plain(dev, n):
    from akari_torch.ops import cluster_intersect as ci

    args, targs = _cluster_soup(dev)
    assert args[3] % ct.TRI_TILE != 0  # the real-count guard of the last cluster
    rays = _rays(n, dev, seed=n)
    got = _check_module(ci, "closest", "any_hit", rays, args)
    # the linear sweep answers as the tree walk does (lowest index on ties)
    for a, b in zip(got, ti.closest(rays, *targs)):
        assert torch.equal(a, b)


def test_instanced_trace_paths_launches_once_per_query(dev):
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import instanced_tree_intersect as iti

    sc, scene = _forest(dev)
    cfg = PathConfig(spp=1, max_depth=3)
    px = torch.arange(16 * 16, device=dev)
    for m in (di, ti, iti, ci):
        m.reset_launches()
    li = trace_paths(scene, sc.camera, cfg, 0, torch.zeros_like(px), px)
    torch.cuda.synchronize()
    assert iti.LAUNCHES == {"closest": 1 + cfg.max_depth, "any_hit": 0}
    assert sum(di.LAUNCHES.values()) + sum(ti.LAUNCHES.values()) + sum(ci.LAUNCHES.values()) == 0
    assert bool(torch.isfinite(li).all())


def test_instanced_wrappers_refuse_what_the_kernels_cannot_take(dev):
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import instanced_tree_intersect as iti

    _, scene = _forest(dev)
    rays = _forest_rays(64, dev)
    args = (scene.inst_f32, scene.inst_i32, scene.tri_tree, scene.inst_tri_blocks,
            scene.tree_leaf_span)
    with pytest.raises(ValueError):
        iti.closest(rays[:, ::2], *args)  # not contiguous
    blocks = scene.inst_tri_blocks
    rows = torch.cat([blocks.T, torch.zeros((blocks.shape[1], 3), device=dev)], 1).contiguous()
    with pytest.raises(ValueError):
        iti.closest(rays, *args[:3], rows, scene.tree_leaf_span)  # a [sum Kp*128, 12] row store
    with pytest.raises(ValueError):
        iti.closest(rays, scene.inst_f32.cpu(), *args[1:])  # devices differ
    with pytest.raises(TypeError):
        iti.any_hit(rays, scene.inst_f32, scene.inst_i32.float(), *args[2:])
    cargs = (scene.inst_f32, scene.inst_i32, scene.tri_superclusters, scene.tri_clusters)
    with pytest.raises(ValueError):
        ci.instanced_closest(rays, *cargs, blocks.view(-1)[1:1 + 9 * 128].view(9, 128))  # off 16 B
    with pytest.raises(ValueError):
        ci.instanced_any_hit(rays, *cargs, blocks.t().contiguous())  # not [9, 128 K]
    with pytest.raises(ValueError):
        ci.instanced_any_hit(rays, *cargs, blocks.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        ci.instanced_closest(rays[:, ::2], *cargs, blocks)  # not contiguous


# ------------- the warp walk: warp shapes, leaf spans, ray order -------------

def _cluster_spots(boxes, o2w=None):
    """World-space centres and half-diagonals of the real cluster boxes
    ([K, >= 6]), under each instance's [I, 3, 4] o2w if given (the
    half-diagonal then scaled by the largest column norm)."""
    b = boxes[:, :6].cpu()
    b = b[(b[:, 3:6] > b[:, 0:3]).all(dim=1)]
    centre, radius = (b[:, 0:3] + b[:, 3:6]) / 2, (b[:, 3:6] - b[:, 0:3]).norm(dim=1) / 2
    if o2w is None:
        return centre, radius
    m = o2w.cpu()
    world = torch.einsum("iab,kb->ika", m[:, :, :3], centre) + m[:, None, :, 3]
    scale = m[:, :, :3].norm(dim=1).max(dim=1).values
    return world.reshape(-1, 3), (scale[:, None] * radius[None]).reshape(-1)


def _warp_rays(case, dev, centre, radius, lo, hi, seed=0):
    """64 rays (two warps) that load a warp in one way: ``many_leaves``
    (each lane starts at a different cluster's centre, bounded to it:
    different leaves at once), ``all_dead`` (those rays with warp 0 dead),
    ``one_live`` (one live lane a warp), ``one_leaf`` (nearly equal rays
    from outside toward one cluster: the lanes enter the same leaves
    together); or 1,024 rays (32 warps) of ``many_leaves`` where warp w has
    only its lane w dead (``dead_each_lane``) or live
    (``live_each_lane``), so a dead or a lone live lane sits at every
    position of a warp. ``centre``/``radius`` are cluster spots,
    ``lo``/``hi`` bound the scene."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = 1024 if case.endswith("_each_lane") else 64
    k = torch.randperm(len(centre), generator=g)[:n]
    k = k[torch.arange(n) % len(k)]
    o, t_max = centre[k], 2 * radius[k]
    d = torch.randn((n, 3), generator=g)
    if case == "all_dead":
        t_max[:32] = 0.0
    elif case == "one_live":
        t_max[torch.arange(n) % 32 != 5] = 0.0
    elif case.endswith("_each_lane"):
        marked = torch.arange(n) % 32 == torch.arange(n) // 32
        t_max[marked if case == "dead_each_lane" else ~marked] = 0.0
    elif case == "one_leaf":
        c = centre[len(centre) // 2]
        o = (c + (torch.tensor(hi) - torch.tensor(lo)) * 0.6).expand(n, 3)
        d = c - o + 1e-3 * d
        t_max = torch.full((n,), di.T_MAX)
    d = d / d.norm(dim=1, keepdim=True)
    zero = torch.zeros(n)
    return di.pack_rays(V3(*o.T), V3(*d.T), zero, t_max).contiguous().to(dev)


WARP_CASES = ["all_dead", "one_live", "one_leaf", "many_leaves"]
# the linear sweeps also on a dead or a lone live lane at every position
SWEEP_CASES = WARP_CASES + ["dead_each_lane", "live_each_lane"]


@pytest.mark.parametrize("leaf_span", [1, 2, 4])
@pytest.mark.parametrize("case", WARP_CASES)
def test_tree_kernel_on_warp_shapes(dev, case, leaf_span):
    """Closest and any-hit == the plain walk on each warp shape and leaf
    span, and on a permuted ray order (``_check_module``)."""
    _, nodes, blocks, n_tris, span, clusters = _tree_soup(dev, leaf_span=leaf_span)
    assert span == leaf_span
    rays = _warp_rays(case, dev, *_cluster_spots(clusters), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    got = _check_module(ti, "closest", "any_hit", rays, (nodes, blocks, n_tris, span))
    if case in ("one_leaf", "many_leaves"):
        assert int((got[3] >= 0).sum()) >= 8


@pytest.mark.parametrize("leaf_span", [1, 2, 4])
@pytest.mark.parametrize("case", WARP_CASES)
def test_instanced_tree_kernel_on_warp_shapes(dev, case, leaf_span):
    from akari_torch.ops import instanced_tree_intersect as iti

    _, scene = _forest(dev, leaf_span=leaf_span)
    assert scene.tree_leaf_span == leaf_span
    args = (scene.inst_f32, scene.inst_i32, scene.tri_tree, scene.inst_tri_blocks, leaf_span)
    spots = _cluster_spots(scene.tri_clusters, scene.instances.o2w)
    rays = _warp_rays(case, dev, *spots, (-7.0, 0.2, -7.0), (7.0, 2.5, 7.0))
    got = _check_module(iti, "closest", "any_hit", rays, args)
    if case in ("one_leaf", "many_leaves"):
        assert int((got[3] >= 0).sum()) >= 8


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_flat_cluster_kernel_on_warp_shapes(dev, case):
    """Closest and any-hit == the plain sweep on each warp shape (lanes in
    one cluster or each in its own, dead or lone live lanes anywhere,
    any-hit lanes finishing at different times) and on a permuted ray
    order, on the soup with a partial last cluster and exact duplicates in
    far clusters; prims == the tree walk's (lowest index on ties)."""
    from akari_torch.ops import cluster_intersect as ci

    args, targs = _cluster_soup(dev)
    rays = _warp_rays(case, dev, *_cluster_spots(args[1]), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    got = _check_module(ci, "closest", "any_hit", rays, args)
    assert torch.equal(got[3], ti.closest(rays, *targs)[3])
    if case in ("one_leaf", "many_leaves", "dead_each_lane"):
        assert int((got[3] >= 0).sum()) >= 8


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_instanced_cluster_kernel_on_warp_shapes(dev, case):
    """The linear instanced kernel on each warp shape: rays that start in
    different instances' clusters, bounded to them, so each lane enters
    its own few instances and the others skip them; == the plain sweep and
    == the instanced tree walk."""
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import instanced_tree_intersect as iti

    _, scene = _forest(dev)
    args = (scene.inst_f32, scene.inst_i32, scene.tri_superclusters, scene.tri_clusters,
            scene.inst_tri_blocks)
    spots = _cluster_spots(scene.tri_clusters, scene.instances.o2w)
    rays = _warp_rays(case, dev, *spots, (-7.0, 0.2, -7.0), (7.0, 2.5, 7.0))
    got = _check_module(ci, "instanced_closest", "instanced_any_hit", rays, args)
    walk = iti.closest(rays, scene.inst_f32, scene.inst_i32, scene.tri_tree,
                       scene.inst_tri_blocks, scene.tree_leaf_span)
    for a, b in zip(got, walk):
        assert torch.equal(a, b)
    if case in ("one_leaf", "many_leaves", "dead_each_lane"):
        assert int((got[3] >= 0).sum()) >= 8


def test_bench_step_gradient_kernel_route_equals_plain_route(dev):
    """chip_smoke.py phase 19 at 64x64: the fwd + bwd step of the bench
    loss through the dense kernels and through their plain versions on the
    card. The hits are bit-equal, so the loss is too; the gradients differ
    only by the order of the row gathers' atomic scatter-adds (bound
    chip_smoke.GRAD_TOL of max|g|). The kernel runs 1 + depth times in the
    forward and never in the backward."""
    from chip_smoke import GRAD_TOL, bench_step, plain_route
    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.parallel.render import loss_and_image

    sc = cornell_box(64, 64)
    scene = sc.compile().to(dev)
    cfg = PathConfig(spp=4, max_depth=5)
    target = torch.zeros((64, 64, 3), device=dev)
    p = scene_params(scene)
    p["tex_value"].requires_grad_(True)
    before = di.LAUNCHES["closest"]
    loss, _ = loss_and_image(apply_params(scene, p), sc.camera, cfg, target)
    fwd = di.LAUNCHES["closest"] - before
    (g,) = torch.autograd.grad(loss, [p["tex_value"]])
    torch.cuda.synchronize()
    assert fwd == 1 + cfg.max_depth and di.LAUNCHES["closest"] - before == fwd
    with plain_route(di):
        loss_p, g_p = bench_step(scene, sc.camera, cfg, target)
    assert torch.equal(loss.detach(), loss_p)
    assert torch.isfinite(g).all() and float((g - g_p).abs().max()) <= GRAD_TOL * float(
        g_p.abs().max())


def _route_scenes(dev, which):
    """A 32x32 scene on the card and the kernel modules of its route: the
    Cornell box (dense) or the n=64 terrain (tree)."""
    sc = cornell_box(32, 32) if which == "cornell" else terrain_scene(32, 32, n=64)
    scene = sc.compile().to(dev)
    mods = (di,) if which == "cornell" else (ti,)
    return scene, sc.camera, mods


@pytest.mark.parametrize("which", ["cornell", "terrain"])
def test_ao_kernel_route_equals_plain_route(dev, which):
    """render_ao at 32x32 through the kernels and through their plain
    versions: the hits are bit-equal, so the images are; one closest and
    one any-hit launch per sample."""
    from chip_smoke import plain_route
    from akari_torch.integrators.ao import AOConfig, render_ao

    scene, cam, (mod,) = _route_scenes(dev, which)
    cfg = AOConfig(spp=4)
    before = dict(mod.LAUNCHES)
    img = render_ao(scene, cam, cfg)
    torch.cuda.synchronize()
    assert mod.LAUNCHES["closest"] - before["closest"] == cfg.spp
    assert mod.LAUNCHES["any_hit"] - before["any_hit"] == cfg.spp
    with plain_route(mod):
        img_p = render_ao(scene, cam, cfg)
    assert torch.equal(img, img_p) and float(img.mean()) > 0.1


@pytest.mark.parametrize("which", ["cornell", "terrain"])
def test_bdpt_kernel_route_equals_plain_route(dev, which):
    """render_bdpt at 32x32, 2 spp, through the kernels and through their
    plain versions: the radiance is bit-equal (the hits are); the splat
    film's index_add atomics sum in run-dependent order, so the image is
    within chip_smoke.SPLAT_TOL of max|image|. Per sample: eye_depth +
    light_depth - 1 closest launches and one any-hit launch."""
    from chip_smoke import SPLAT_TOL, plain_route
    from akari_torch.integrators import bdpt as pb

    scene, cam, (mod,) = _route_scenes(dev, which)
    cfg = pb.BDPTConfig(spp=2)
    px = torch.arange(cam.width * cam.height, device=dev)
    before = dict(mod.LAUNCHES)
    acc, spl = pb.bdpt_sums(scene, cam, cfg, 0, px)
    torch.cuda.synchronize()
    assert mod.LAUNCHES["closest"] - before["closest"] == cfg.spp * (
        cfg.eye_depth + cfg.light_depth - 1)
    assert mod.LAUNCHES["any_hit"] - before["any_hit"] == cfg.spp
    with plain_route(mod):
        acc_p, spl_p = pb.bdpt_sums(scene, cam, cfg, 0, px)
    assert torch.equal(acc, acc_p)
    assert torch.isfinite(spl).all() and float(spl.abs().max()) > 0
    assert float((spl - spl_p).abs().max()) <= SPLAT_TOL * float((acc + spl).abs().max())
