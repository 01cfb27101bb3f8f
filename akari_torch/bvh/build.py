"""Host-side SBVH construction (NumPy): the storage order of a compiled scene.

Counterpart of the NumPy builder in ``akari_tpu/bvh/build.py``. The port
does not traverse this BVH (the dense kernel sweeps every triangle; the
tree kernel walks ``bvh/cluster_tree.py``'s BVH2 over 128-triangle runs
of this order), but compile needs it all the same: triangle storage
order, and with it every prim id, is the BVH leaf order, so the port's
compiled arrays equal the reference's only if it builds the very same
tree.

Binned SAH object splits (N_BINS buckets) plus SBVH spatial splits with
triangle clipping and cost-based reference unsplitting; nodes in DFS
preorder with threaded miss links; leaves of at most MAX_LEAF references.

Scenes of NATIVE_MIN_TRIS (20 000) triangles or more take the native C++
builder (``native/bvh_builder.cpp``, a copy of the reference's), as the
reference does. It orders triangles differently from this NumPy builder,
so a failed native build or call raises instead of falling back here.
"""

from __future__ import annotations

import sys

import numpy as np

MAX_LEAF = 4
N_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0
# Spatial-split gate: min (object-split child overlap SA) / (root SA)
# (ref: SBVH paper alpha; bvh-accelerator.h spatial-split gating).
ALPHA = 1e-5
# Extra references allowed from spatial splits, as a fraction of T.
SPATIAL_BUDGET = 0.35
MAX_DEPTH = 60


class _Node:
    __slots__ = ("lo", "hi", "prims", "left", "right", "_size")

    def __init__(self, lo, hi, prims=None):
        self.lo, self.hi = lo, hi
        self.prims = prims  # leaf: int array of (possibly duplicated) prim ids
        self.left = self.right = None


def _sa(lo, hi):
    """Surface area of AABB(s); 0 for empty/inverted boxes."""
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _clip_halfspace_bounds(V, axis, s, keep_below):
    """AABB of (triangle ∩ halfspace) per triangle, vectorized.

    V: [R, 3, 3] triangle vertices. Returns (lo, hi) [R, 3]; inverted
    (lo > hi) where the intersection is empty. Sutherland–Hodgman against
    one plane: candidates are kept vertices + edge/plane crossings
    (ref: triangle clipping in bvh-accelerator.h:376-438, redesigned as a
    batched candidate-point min/max instead of per-polygon loops).
    """
    d = V[:, :, axis] - s  # [R, 3] signed distance
    keep = d <= 0.0 if keep_below else d >= 0.0
    nxt = [1, 2, 0]
    di, dj = d, d[:, nxt]
    Vi, Vj = V, V[:, nxt, :]
    crossing = (di * dj) < 0.0
    denom = di - dj
    t = di / np.where(denom == 0.0, 1.0, denom)
    P = Vi + (Vj - Vi) * t[..., None]
    pts = np.concatenate([V, P], axis=1)           # [R, 6, 3]
    valid = np.concatenate([keep, crossing], axis=1)  # [R, 6]
    lo = np.where(valid[..., None], pts, np.inf).min(axis=1)
    hi = np.where(valid[..., None], pts, -np.inf).max(axis=1)
    return lo, hi


class _Ctx:
    __slots__ = ("verts", "root_sa", "budget")

    def __init__(self, verts, root_sa, budget):
        self.verts = verts  # [T, 3, 3] original triangle vertices
        self.root_sa = root_sa
        self.budget = budget  # remaining extra references for spatial splits


def _object_split(prim, lo, hi, c):
    """Binned SAH over ref centroids. Returns None (degenerate) or
    (cost, go_left_mask, (Bl_lo, Bl_hi), (Br_lo, Br_hi))."""
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        return None
    t = (c[:, axis] - cmin[axis]) / extent[axis]
    bins = np.minimum((t * N_BINS).astype(np.int32), N_BINS - 1)
    counts = np.bincount(bins, minlength=N_BINS)
    bin_lo = np.full((N_BINS, 3), np.inf)
    bin_hi = np.full((N_BINS, 3), -np.inf)
    np.minimum.at(bin_lo, bins, lo)
    np.maximum.at(bin_hi, bins, hi)

    pre_lo = np.minimum.accumulate(bin_lo, axis=0)
    pre_hi = np.maximum.accumulate(bin_hi, axis=0)
    suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    pre_n = np.cumsum(counts)
    suf_n = np.cumsum(counts[::-1])[::-1]

    nl = pre_n[:-1]
    nr = suf_n[1:]
    costs = np.where(
        (nl > 0) & (nr > 0),
        nl * _sa(pre_lo[:-1], pre_hi[:-1]) + nr * _sa(suf_lo[1:], suf_hi[1:]),
        np.inf,
    )
    if not np.isfinite(costs).any():
        return None
    k = int(np.argmin(costs))
    go_left = bins <= k
    return (
        float(costs[k]),
        go_left,
        (pre_lo[k], pre_hi[k]),
        (suf_lo[k + 1], suf_hi[k + 1]),
    )


def _spatial_split_cost(prim, lo, hi, node_lo, node_hi):
    """Chopped-binned spatial SAH over the node's widest axis.

    Returns None or (cost, axis, plane). Bin bounds use references clamped
    to the bin slab (chopped binning); exact clipping happens only against
    the single chosen plane in `_apply_spatial_split`.
    """
    ext = node_hi - node_lo
    axis = int(np.argmax(ext))
    width = ext[axis]
    if width <= 1e-12:
        return None
    nlo = node_lo[axis]
    inv_w = N_BINS / width
    b0 = np.clip(((lo[:, axis] - nlo) * inv_w).astype(np.int32), 0, N_BINS - 1)
    b1 = np.clip(((hi[:, axis] - nlo) * inv_w).astype(np.int32), 0, N_BINS - 1)
    entries = np.bincount(b0, minlength=N_BINS)
    exits = np.bincount(b1, minlength=N_BINS)

    bin_lo = np.full((N_BINS, 3), np.inf)
    bin_hi = np.full((N_BINS, 3), -np.inf)
    edges = nlo + width * np.arange(N_BINS + 1) / N_BINS
    for b in range(N_BINS):
        m = (b0 <= b) & (b1 >= b)
        if not m.any():
            continue
        frag_lo = lo[m].copy()
        frag_hi = hi[m].copy()
        frag_lo[:, axis] = np.maximum(frag_lo[:, axis], edges[b])
        frag_hi[:, axis] = np.minimum(frag_hi[:, axis], edges[b + 1])
        bin_lo[b] = np.minimum(bin_lo[b], frag_lo.min(axis=0))
        bin_hi[b] = np.maximum(bin_hi[b], frag_hi.max(axis=0))

    pre_lo = np.minimum.accumulate(bin_lo, axis=0)
    pre_hi = np.maximum.accumulate(bin_hi, axis=0)
    suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    nl = np.cumsum(entries)[:-1]
    nr = np.cumsum(exits[::-1])[::-1][1:]
    costs = np.where(
        (nl > 0) & (nr > 0),
        nl * _sa(pre_lo[:-1], pre_hi[:-1]) + nr * _sa(suf_lo[1:], suf_hi[1:]),
        np.inf,
    )
    if not np.isfinite(costs).any():
        return None
    k = int(np.argmin(costs))
    return float(costs[k]), axis, float(edges[k + 1])


def _apply_spatial_split(prim, lo, hi, axis, plane, ctx):
    """Partition refs at `plane`; clip straddlers; cost-based unsplitting.

    Returns (left, right) each = (prim, lo, hi), or None if degenerate.
    """
    wholly_left = hi[:, axis] <= plane
    wholly_right = lo[:, axis] >= plane
    straddle = ~(wholly_left | wholly_right)
    ns = int(straddle.sum())

    if ns == 0:
        if not wholly_left.any() or not wholly_right.any():
            return None
        return (
            (prim[wholly_left], lo[wholly_left], hi[wholly_left]),
            (prim[wholly_right], lo[wholly_right], hi[wholly_right]),
        )

    sp = prim[straddle]
    slo, shi = lo[straddle], hi[straddle]
    V = ctx.verts[sp]
    fl_lo, fl_hi = _clip_halfspace_bounds(V, axis, plane, keep_below=True)
    fr_lo, fr_hi = _clip_halfspace_bounds(V, axis, plane, keep_below=False)
    # fragments live inside the (already clipped) reference bounds
    fl_lo, fl_hi = np.maximum(fl_lo, slo), np.minimum(fl_hi, shi)
    fr_lo, fr_hi = np.maximum(fr_lo, slo), np.minimum(fr_hi, shi)
    l_ok = np.all(fl_lo <= fl_hi, axis=1)
    r_ok = np.all(fr_lo <= fr_hi, axis=1)

    # Baseline child bounds/counts assuming every splittable ref is split.
    def bounds_of(masks_lo, masks_hi):
        if masks_lo.shape[0] == 0:
            return np.full(3, np.inf), np.full(3, -np.inf)
        return masks_lo.min(axis=0), masks_hi.max(axis=0)

    base_l_lo, base_l_hi = bounds_of(
        np.concatenate([lo[wholly_left], fl_lo[l_ok]]),
        np.concatenate([hi[wholly_left], fl_hi[l_ok]]),
    )
    base_r_lo, base_r_hi = bounds_of(
        np.concatenate([lo[wholly_right], fr_lo[r_ok]]),
        np.concatenate([hi[wholly_right], fr_hi[r_ok]]),
    )
    nl = int(wholly_left.sum()) + int(l_ok.sum())
    nr = int(wholly_right.sum()) + int(r_ok.sum())

    # Reference unsplitting (ref: bvh-accelerator.h unsplitting; Stich §4.4):
    # per straddler choose {split, all-left, all-right} by SAH delta against
    # the baseline, vectorized over straddlers.
    sal = _sa(base_l_lo, base_l_hi)
    sar = _sa(base_r_lo, base_r_hi)
    c_split = sal * nl + sar * nr
    ul_sa = _sa(np.minimum(base_l_lo, slo), np.maximum(base_l_hi, shi))
    ur_sa = _sa(np.minimum(base_r_lo, slo), np.maximum(base_r_hi, shi))
    c_left = ul_sa * nl + sar * (nr - 1)
    c_right = sal * (nl - 1) + ur_sa * nr
    both = l_ok & r_ok
    choice = np.zeros(ns, np.int8)  # 0=split 1=all-left 2=all-right
    better_l = both & (c_left < c_split) & (c_left <= c_right)
    better_r = both & (c_right < c_split) & (c_right < c_left)
    choice[better_l] = 1
    choice[better_r] = 2
    choice[l_ok & ~r_ok] = 1
    choice[r_ok & ~l_ok] = 2
    degen = ~l_ok & ~r_ok  # numeric corner: keep on the smaller-extent side
    choice[degen] = np.where(
        (shi[degen, axis] - plane) > (plane - slo[degen, axis]), 2, 1
    )

    # Enforce the duplication budget: demote the cheapest-to-unsplit splits.
    n_split = int((choice == 0).sum())
    if n_split > ctx.budget:
        split_idx = np.nonzero(choice == 0)[0]
        penalty = np.minimum(c_left, c_right)[split_idx] - c_split
        demote = split_idx[np.argsort(penalty)][: n_split - ctx.budget]
        choice[demote] = np.where(
            c_left[demote] <= c_right[demote], 1, 2
        ).astype(np.int8)
        n_split = ctx.budget
    ctx.budget -= n_split

    split_m = choice == 0
    left_full = choice == 1
    right_full = choice == 2
    lp = np.concatenate([prim[wholly_left], sp[split_m], sp[left_full]])
    llo = np.concatenate([lo[wholly_left], fl_lo[split_m], slo[left_full]])
    lhi = np.concatenate([hi[wholly_left], fl_hi[split_m], shi[left_full]])
    rp = np.concatenate([prim[wholly_right], sp[split_m], sp[right_full]])
    rlo = np.concatenate([lo[wholly_right], fr_lo[split_m], slo[right_full]])
    rhi = np.concatenate([hi[wholly_right], fr_hi[split_m], shi[right_full]])
    if lp.size == 0 or rp.size == 0 or lp.size == prim.size and rp.size == prim.size:
        return None
    return (lp, llo, lhi), (rp, rlo, rhi)


def _median_split(prim, lo, hi, c):
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    ordr = np.argsort(c[:, axis], kind="stable")
    mid = prim.shape[0] // 2
    li, ri = ordr[:mid], ordr[mid:]
    return (prim[li], lo[li], hi[li]), (prim[ri], lo[ri], hi[ri])


def _build_recursive(prim, lo, hi, ctx, depth=0):
    node_lo = lo.min(axis=0)
    node_hi = hi.max(axis=0)
    node = _Node(node_lo, node_hi)
    n = prim.shape[0]
    if n <= 2 or depth >= MAX_DEPTH:
        if n <= MAX_LEAF:
            node.prims = prim.copy()
            return node
        l, r = _median_split(prim, lo, hi, (lo + hi) * 0.5)
        node.left = _build_recursive(*l, ctx, depth + 1)
        node.right = _build_recursive(*r, ctx, depth + 1)
        return node

    c = (lo + hi) * 0.5
    obj = _object_split(prim, lo, hi, c)
    children = None
    best_cost = np.inf
    if obj is not None:
        best_cost, go_left, (bl_lo, bl_hi), (br_lo, br_hi) = obj
        split_point_ok = go_left.any() and not go_left.all()
        if split_point_ok:
            children = (
                (prim[go_left], lo[go_left], hi[go_left]),
                (prim[~go_left], lo[~go_left], hi[~go_left]),
            )
        else:
            children, best_cost = None, np.inf

        # Spatial split attempt, gated on child overlap (SBVH alpha test).
        ov_lo = np.maximum(bl_lo, br_lo)
        ov_hi = np.minimum(bl_hi, br_hi)
        if (
            ctx.budget > 0
            and np.all(ov_hi > ov_lo)
            and _sa(ov_lo, ov_hi) / ctx.root_sa > ALPHA
        ):
            sp = _spatial_split_cost(prim, lo, hi, node_lo, node_hi)
            if sp is not None and sp[0] < best_cost:
                applied = _apply_spatial_split(prim, lo, hi, sp[1], sp[2], ctx)
                if applied is not None:
                    children = applied
                    best_cost = sp[0]

    if children is not None:
        leaf_cost = n * INTERSECT_COST * _sa(node_lo, node_hi)
        split_cost = (
            TRAVERSAL_COST * _sa(node_lo, node_hi) + best_cost * INTERSECT_COST
        )
        if n <= MAX_LEAF and split_cost >= leaf_cost:
            node.prims = prim.copy()
            return node
    else:
        if n <= MAX_LEAF:
            node.prims = prim.copy()
            return node
        children = _median_split(prim, lo, hi, c)

    node.left = _build_recursive(*children[0], ctx, depth + 1)
    node.right = _build_recursive(*children[1], ctx, depth + 1)
    return node


def _flatten(root):
    """Preorder DFS emit with threaded miss links; hit link is implicit +1.

    Leaf prim lists are concatenated into one `order` array (with SBVH a
    prim id may appear in several leaves); first/count index into it.
    """
    nodes = []
    order_chunks = []
    n_prims = 0
    stack = [(root, -1)]
    while stack:
        node, miss = stack.pop()
        idx = len(nodes)
        is_leaf = node.prims is not None
        if is_leaf:
            first, count = n_prims, len(node.prims)
            order_chunks.append(node.prims)
            n_prims += count
        else:
            first, count = 0, 0
        nodes.append((node.lo, node.hi, first, count, miss))
        if not is_leaf:
            # left child's subtree misses to its right sibling at
            # idx + 1 + size(left subtree)
            right_idx = idx + 1 + _subtree_size(node.left)
            stack.append((node.right, miss))
            stack.append((node.left, right_idx))
    lo = np.stack([n[0] for n in nodes]).astype(np.float32)
    hi = np.stack([n[1] for n in nodes]).astype(np.float32)
    first = np.asarray([n[2] for n in nodes], dtype=np.int32)
    count = np.asarray([n[3] for n in nodes], dtype=np.int32)
    miss = np.asarray([n[4] for n in nodes], dtype=np.int32)
    order = (
        np.concatenate(order_chunks) if order_chunks else np.zeros(0, np.int64)
    )
    return lo, hi, first, count, miss, order.astype(np.int64)


def _subtree_size(node):
    if not hasattr(node, "_size"):
        size = 1
        if node.left is not None:
            size += _subtree_size(node.left) + _subtree_size(node.right)
        node._size = size
    return node._size


NATIVE_MIN_TRIS = 20_000


def _build_native(p0, p1, p2):
    """The native builder (``akari_tpu/bvh/build.py::_build_native``);
    raises where the reference returns None and falls back."""
    import ctypes

    from ..native.loader import load

    lib = load("bvh")
    p0 = np.ascontiguousarray(p0, dtype=np.float32)
    p1 = np.ascontiguousarray(p1, dtype=np.float32)
    p2 = np.ascontiguousarray(p2, dtype=np.float32)
    t = p0.shape[0]
    max_nodes = 2 * t + 8
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    order = np.empty(t, np.int32)
    n_nodes = ctypes.c_int64(0)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    rc = lib.akr_bvh_build(
        ptr(p0, ctypes.c_float), ptr(p1, ctypes.c_float), ptr(p2, ctypes.c_float),
        ctypes.c_int64(t), ctypes.c_int(MAX_LEAF),
        ptr(node_lo, ctypes.c_float), ptr(node_hi, ctypes.c_float),
        ptr(first, ctypes.c_int32), ptr(count, ctypes.c_int32),
        ptr(miss, ctypes.c_int32), ptr(order, ctypes.c_int32),
        ctypes.c_int64(max_nodes), ctypes.byref(n_nodes),
    )
    if rc != 0:
        raise RuntimeError(f"native BVH builder returned {rc} on {t} triangles")
    m = n_nodes.value
    bvh = dict(
        node_lo=node_lo[:m].copy(),
        node_hi=node_hi[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        miss=miss[:m].copy(),
    )
    return bvh, order.astype(np.int64)


def build_bvh(p0, p1, p2, spatial=True):
    """Build a threaded BVH/SBVH over triangles given [T,3] vertex arrays.

    Returns (bvh_dict, order) where ``order`` maps storage slots to original
    triangles (storage_attr = orig_attr[order]); with spatial splits a
    triangle may appear more than once, so ``len(order) >= T``. bvh_dict
    has the BVHArrays fields as numpy arrays.
    """
    n = np.asarray(p0).shape[0]
    if n >= NATIVE_MIN_TRIS:
        return _build_native(p0, p1, p2)
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    t = p0.shape[0]
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    verts = np.stack([p0, p1, p2], axis=1)  # [T, 3, 3]
    prim = np.arange(t)
    root_sa = float(_sa(tri_lo.min(axis=0), tri_hi.max(axis=0))) if t else 1.0
    budget = int(SPATIAL_BUDGET * t) if spatial else 0
    ctx = _Ctx(verts, max(root_sa, 1e-30), budget)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = _build_recursive(prim, tri_lo, tri_hi, ctx)
        _split_fat_leaves(root, tri_lo, tri_hi)
        lo, hi, first, count, miss, order = _flatten(root)
    finally:
        sys.setrecursionlimit(old_limit)

    # Pad the AABBs slightly for watertightness under f32 traversal.
    eps = np.float32(1e-6) * np.maximum(1.0, np.abs(lo) + np.abs(hi)).astype(np.float32)
    bvh = dict(
        node_lo=lo - eps,
        node_hi=hi + eps,
        first=first,
        count=count,
        miss=miss,
    )
    return bvh, order


def _aabb_rec(prim, lo, hi, max_leaf, depth=0):
    node = _Node(lo.min(axis=0), hi.max(axis=0))
    n = prim.shape[0]
    if n <= max_leaf or depth >= MAX_DEPTH:
        node.prims = prim.copy()
        return node
    c = (lo + hi) * 0.5
    children = None
    if n > 2:
        obj = _object_split(prim, lo, hi, c)
        if obj is not None:
            go_left = obj[1]
            if go_left.any() and not go_left.all():
                children = (
                    (prim[go_left], lo[go_left], hi[go_left]),
                    (prim[~go_left], lo[~go_left], hi[~go_left]),
                )
    if children is None:
        children = _median_split(prim, lo, hi, c)
    node.left = _aabb_rec(*children[0], max_leaf, depth + 1)
    node.right = _aabb_rec(*children[1], max_leaf, depth + 1)
    return node


def build_aabb_bvh(lo, hi, max_leaf=1):
    """Threaded BVH over boxes: the TLAS over instance world boxes of a
    two-level scene (``akari_tpu/bvh/build.py::build_aabb_bvh``). Returns
    (bvh_dict, order); leaf ``first`` indexes ``order`` (box ids). The
    port's instanced kernels loop over instances in index order and do
    not walk it; compile keeps it so the tables equal the reference's."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    root = _aabb_rec(np.arange(lo.shape[0]), lo, hi, max_leaf)
    lo_, hi_, first, count, miss, order = _flatten(root)
    eps = np.float32(1e-6) * np.maximum(1.0, np.abs(lo_) + np.abs(hi_)).astype(np.float32)
    bvh = dict(
        node_lo=lo_ - eps, node_hi=hi_ + eps,
        first=first, count=count, miss=miss,
    )
    return bvh, order


def _split_fat_leaves(node, tri_lo, tri_hi):
    """Guarantee leaf count <= MAX_LEAF by median-splitting oversized leaves."""
    if node.prims is None:
        _split_fat_leaves(node.left, tri_lo, tri_hi)
        _split_fat_leaves(node.right, tri_lo, tri_hi)
        return
    prims = node.prims
    n = prims.shape[0]
    if n <= MAX_LEAF:
        return
    c = (tri_lo[prims] + tri_hi[prims]) * 0.5
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    prims = prims[np.argsort(c[:, axis], kind="stable")]
    mid = n // 2

    def make(sub):
        return _Node(tri_lo[sub].min(axis=0), tri_hi[sub].max(axis=0), sub)

    node.prims = None
    node.left = make(prims[:mid])
    node.right = make(prims[mid:])
    _split_fat_leaves(node.left, tri_lo, tri_hi)
    _split_fat_leaves(node.right, tri_lo, tri_hi)
