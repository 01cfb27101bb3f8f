"""Host-side tables of the tree walk and the linear sweeps: cluster and
supercluster boxes and the BVH2 over clusters.

Counterpart of ``akari_tpu/ops/pallas_cluster.py::{build_clusters,
build_superclusters}`` and ``akari_tpu/ops/pallas_tree.py::{pick_leaf_span,
build_cluster_tree, _tree_rec, _row_of}``; the arrays are equal to the
reference's, array for array.

Hierarchy:

  triangle -> cluster      = TRI_TILE (128) consecutive storage-order triangles
  cluster  -> leaf         = leaf_span consecutive clusters (tree walk)
  leaf     -> BVH2         = binned-SAH binary tree, one node row per split
  cluster  -> supercluster = SUPER (32) consecutive clusters (linear sweeps)

Node row layout ([Nn, 16] float32, ``pallas_tree.py:21-31``):

  0:3  child0 lo   3:6  child0 hi   6:9  child1 lo   9:12 child1 hi
  12   child0 ref  13   child1 ref  14   split axis  15   pad

A ref >= 0 is an inner-node row; ref < 0 is leaf block ``-ref - 1``.
child0 is the lower child along the split axis.
"""

from __future__ import annotations

import sys

import numpy as np

from .build import _object_split

TRI_TILE = 128
# Clusters per supercluster (``pallas_cluster.SUPER``): the linear sweeps
# test one supercluster box before its 32 cluster boxes; the cluster table's
# row count is padded to a multiple of it, as in the reference.
SUPER = 32
# The supercluster table's row count is padded to a multiple of this with
# inverted boxes (``pallas_cluster.SUPER_CHUNK``), as in the reference.
SUPER_CHUNK = 128
# Ref stack entries per ray in the walk (``pallas_tree.STACK_DEPTH``).
STACK_DEPTH = 64
# The reference's TPU VMEM budget for the node table, kept so that
# ``leaf_span=None`` picks the reference's span (1 for every scene below
# 18,432 clusters, 2.36 M triangles).
NODE_BUDGET_BYTES = 9 * 1024 * 1024
_MAX_NODES = NODE_BUDGET_BYTES // 512
_FORCE_MEDIAN_DEPTH = 30


def n_clusters(n_tris):
    return (int(n_tris) + TRI_TILE - 1) // TRI_TILE


def build_clusters(tri_v0, tri_e1, tri_e2):
    """[Kpad, 8] cluster AABBs (lo.xyz, hi.xyz, pad, pad) over TRI_TILE
    triangle runs, padded by 1e-5 relative; Kpad rounds up to SUPER."""
    v0 = np.asarray(tri_v0, np.float64)
    p1 = v0 + np.asarray(tri_e1, np.float64)
    p2 = v0 + np.asarray(tri_e2, np.float64)
    t = v0.shape[0]
    k = n_clusters(t)
    pad = k * TRI_TILE - t

    def padded(a, fill):
        return np.concatenate([a, np.full((pad, 3), fill)]) if pad else a

    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    lo = padded(tri_lo, np.inf).reshape(k, TRI_TILE, 3).min(axis=1)
    hi = padded(tri_hi, -np.inf).reshape(k, TRI_TILE, 3).max(axis=1)
    eps = 1e-5 * np.maximum(1.0, np.abs(lo) + np.abs(hi))
    kpad = ((k + SUPER - 1) // SUPER) * SUPER
    out = np.zeros((kpad, 8), np.float32)
    out[:k, :3] = lo - eps
    out[:k, 3:6] = hi + eps
    return out


def n_superclusters(n_tris):
    """Real supercluster count: ceil(clusters / SUPER)."""
    return (n_clusters(n_tris) + SUPER - 1) // SUPER


def build_superclusters(clusters, n_tris):
    """[Spad, 8] supercluster AABBs over SUPER-cluster runs of the real
    clusters; rows past the real count, up to a SUPER_CHUNK multiple, are
    inverted boxes (lo = 1e30, hi = -1e30), as in the reference."""
    cl = np.asarray(clusters, np.float64)
    k = n_clusters(n_tris)
    s = n_superclusters(n_tris)
    lo = np.full((s * SUPER, 3), np.inf)
    hi = np.full((s * SUPER, 3), -np.inf)
    lo[:k] = cl[:k, 0:3]
    hi[:k] = cl[:k, 3:6]
    spad = ((s + SUPER_CHUNK - 1) // SUPER_CHUNK) * SUPER_CHUNK
    out = np.zeros((spad, 8), np.float32)
    out[:, 0:3] = 1e30
    out[:, 3:6] = -1e30
    out[:s, :3] = lo.reshape(s, SUPER, 3).min(axis=1)
    out[:s, 3:6] = hi.reshape(s, SUPER, 3).max(axis=1)
    return out


def pick_leaf_span(k):
    """Smallest power-of-two cluster span whose tree fits the budget."""
    span = 1
    while (k + span - 1) // span > _MAX_NODES:
        span *= 2
    return span


def build_cluster_tree(clusters, n_tris, leaf_span=None):
    """BVH2 node table over leaf_span-cluster blocks -> (nodes [Npad, 16]
    float32, leaf_span). Raises if the walk could need more than
    STACK_DEPTH stack entries (depth + 1; see ``tree_depth``)."""
    k = n_clusters(n_tris)
    if k == 0:
        raise ValueError("the tree walk needs at least one triangle")
    cl = np.asarray(clusters, np.float64)
    lo_c, hi_c = cl[:k, 0:3], cl[:k, 3:6]
    if leaf_span is None:
        leaf_span = pick_leaf_span(k)
    b = (k + leaf_span - 1) // leaf_span
    pad = b * leaf_span - k
    if pad:
        lo_c = np.concatenate([lo_c, np.full((pad, 3), np.inf)])
        hi_c = np.concatenate([hi_c, np.full((pad, 3), -np.inf)])
    lo = lo_c.reshape(b, leaf_span, 3).min(axis=1)
    hi = hi_c.reshape(b, leaf_span, 3).max(axis=1)

    nodes = []
    if b == 1:
        # Degenerate root: child1 is an inverted box over the same leaf.
        row = np.zeros(16, np.float64)
        row[0:3], row[3:6] = lo[0], hi[0]
        row[6:9], row[9:12] = np.full(3, 1e30), np.full(3, -1e30)
        row[12], row[13], row[14] = -1, -1, 0
        nodes.append(row)
    else:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            _tree_rec(np.arange(b), lo, hi, nodes, 0)
        finally:
            sys.setrecursionlimit(old)

    if len(nodes) >= (1 << 24):
        raise ValueError("node refs must stay exact in float32")
    out = np.stack(nodes).astype(np.float32)
    npad = (-out.shape[0]) % 8
    if npad:
        out = np.concatenate([out, np.zeros((npad, 16), np.float32)])
    depth = tree_depth(out)
    if depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"tree depth {depth} needs {depth + 1} stack entries > {STACK_DEPTH}"
        )
    return out, int(leaf_span)


def _tree_rec(ids, lo, hi, nodes, depth):
    """Recursive binned-SAH build over leaf-block boxes; returns a ref."""
    if ids.shape[0] == 1:
        return -(int(ids[0]) + 1)
    idx = len(nodes)
    nodes.append(None)
    l = lo[ids]
    h = hi[ids]
    c = (l + h) * 0.5
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    go_left = None
    if depth < _FORCE_MEDIAN_DEPTH and ext[axis] > 1e-12 and ids.shape[0] > 2:
        obj = _object_split(ids, l, h, c)
        if obj is not None:
            _, gl, _, _ = obj
            if gl.any() and not gl.all():
                go_left = gl
    if go_left is None:
        order = np.argsort(c[:, axis], kind="stable")
        go_left = np.zeros(ids.shape[0], bool)
        go_left[order[: ids.shape[0] // 2]] = True
    li, ri = ids[go_left], ids[~go_left]
    lref = _tree_rec(li, lo, hi, nodes, depth + 1)
    rref = _tree_rec(ri, lo, hi, nodes, depth + 1)
    nodes[idx] = _row_of(lo, hi, li, ri, lref, rref, axis)
    return idx


def _row_of(lo, hi, li, ri, lref, rref, axis):
    row = np.zeros(16, np.float64)
    row[0:3] = lo[li].min(axis=0)
    row[3:6] = hi[li].max(axis=0)
    row[6:9] = lo[ri].min(axis=0)
    row[9:12] = hi[ri].max(axis=0)
    row[12], row[13], row[14] = lref, rref, axis
    return row


def tree_depth(nodes):
    """Inner-node levels on the longest root-to-leaf path (1 for a lone
    root). A walk that pushes both children of each popped node holds at
    most depth + 1 refs at once."""
    refs = np.asarray(nodes)[:, 12:14].astype(np.int64)
    depth, level = 0, [0]
    while level:
        depth += 1
        children = refs[level].ravel()
        level = children[children >= 0].tolist()
    return depth


def tri_blocks(tri_v0, tri_e1, tri_e2):
    """[9, Tpad] float32 component-major triangle store of the tree walks:
    rows v0.xyz e1.xyz e2.xyz, triangles on the minor axis, zero columns up
    to a multiple of TRI_TILE. Rows 0-8 of the reference's ``tri_blocks``
    (``pack_tris_t`` layout; its rows 9-15 are zero and not kept), so a
    warp reading component c of 32 consecutive triangles reads 128
    contiguous bytes."""
    t = np.asarray(tri_v0).shape[0]
    out = np.zeros((9, n_clusters(t) * TRI_TILE), np.float32)
    out[0:3, :t] = np.asarray(tri_v0, np.float32).T
    out[3:6, :t] = np.asarray(tri_e1, np.float32).T
    out[6:9, :t] = np.asarray(tri_e2, np.float32).T
    return out
