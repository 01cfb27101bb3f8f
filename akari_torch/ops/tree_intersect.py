"""BVH2 tree-walk ray-triangle intersection: CUDA kernel and plain twin.

Counterpart of ``akari_tpu/ops/pallas_tree.py::run_tree`` (the TPU kernel
``_tree_kernel``) for flat scenes above ``DENSE_MAX_TRIS``. The kernel is
``kernels/csrc/tree_intersect.cu``: one lane per ray with its own ref
stack, each warp testing its lanes' pending leaves together, 32 triangles
a round; its note says what bounds it on the H100 and what its design does
about that. The plain PyTorch version lives beside it here: the same walk
over the same tables, vectorized over rays.

``closest(rays, nodes, blocks, n_tris, leaf_span)`` and ``any_hit(...)``
take

- ``rays``: ``[8, N]`` float32, rows ox oy oz dx dy dz tmin tmax;
- ``nodes``: ``[Nn, 16]`` float32, ``bvh/cluster_tree.build_cluster_tree``;
- ``blocks``: ``[9, Tpad]`` float32, ``bvh/cluster_tree.tri_blocks``
  (``SceneArrays.tri_blocks``): component-major, cluster k is columns
  ``128 k .. 128 k + 127``;
- ``n_tris``: the real triangle count T (the last cluster is cut at T);
- ``leaf_span``: clusters per leaf block.

On CUDA tensors they launch the kernel or raise; on CPU tensors they run
the plain version. There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per variant.

Closest hit takes ``t < best_t or (t == best_t and prim < best_prim)``,
so ties go to the lowest triangle index whatever order leaves are
visited in (the dense kernel's answer; the Pallas walk keeps the first
cluster its tile visits, a divergence recorded in ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes

import torch

from ..bvh.cluster_tree import STACK_DEPTH, TRI_TILE
from .dense_intersect import HIT_EPS, T_MAX

DIR_EPS = 1e-12

# Kernel launches since the last reset, per variant (CUDA tensors only).
LAUNCHES = {"closest": 0, "any_hit": 0}

# Rays walked together by the plain version (bounds its [chunk, 64] stack).
PLAIN_RAYS_PER_CHUNK = 1 << 18
# Ray x triangle pairs per leaf sub-batch of the plain version.
PLAIN_LEAF_PAIRS = 1 << 21

_LIB = "tree_intersect"


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------ plain twin ----------------------------------

def _safe_inv(c):
    s = torch.where(
        torch.abs(c) < DIR_EPS,
        torch.where(c < 0, -DIR_EPS, DIR_EPS).to(c.dtype), c,
    )
    return 1.0 / s


def _slab(box, o, inv, tmin, best_t):
    """[L, (W,) >=6] boxes (lo.xyz hi.xyz ...) x per-ray [L] (or [L, 1])
    terms -> [L] (or [L, W]) bool, in the operation order of
    ``pallas_tree.py`` ``slab_mask``."""
    t0 = [(box[..., a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(box[..., 3 + a] - o[a]) * inv[a] for a in range(3)]
    mn = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    mx = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    near = torch.maximum(torch.maximum(mn[0], mn[1]), torch.maximum(mn[2], tmin))
    far = torch.minimum(torch.minimum(mx[0], mx[1]), torch.minimum(mx[2], best_t))
    return (near <= far) & (best_t > tmin)


def _leaf_mt(o, d, tmin, tri):
    """Per-ray o/d/tmin [L] x component-major triangles ``tri`` ([>= 9,
    L, C]: ``tri[c]`` is component c of v0.xyz e1.xyz e2.xyz) -> (ok, t,
    u, v) [L, C], in the operation order of ``_pairwise_mt_t`` (``ok``
    leaves out the comparison against the running best t)."""
    ox, oy, oz = (a[:, None] for a in o)
    dx, dy, dz = (a[:, None] for a in d)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[c] for c in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < HIT_EPS, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        (torch.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin[:, None])
    )
    return ok, t, u, v


class Best:
    """Per-ray running answer of a plain walk (``ray_common.cuh`` Best):
    closest hit from min(t_max, T_MAX), or the any-hit flag."""

    def __init__(self, tmax, any_hit):
        n, dev = tmax.shape[0], tmax.device
        self.any_hit = any_hit
        self.t = tmax.clone() if any_hit else torch.clamp(tmax, max=T_MAX)
        self.u = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v = torch.zeros(n, dtype=torch.float32, device=dev)
        self.prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.occ = torch.zeros(n, dtype=torch.bool, device=dev)

    def result(self):
        """[N] occluded, or (t, u, v, prim int32) with t = T_MAX on a miss."""
        if self.any_hit:
            return self.occ
        valid = self.prim >= 0
        t_out = torch.where(valid, self.t, T_MAX)
        return t_out, self.u, self.v, self.prim.to(torch.int32)

    def update(self, li, o, d, tmin, tri, real, prim0, stats=None):
        """Moller-Trumbore of rays ``li`` (o/d/tmin: their [L] terms)
        against component-major triangles ``tri`` [>= 9, L, C], where
        triangle j of ray l is prim prim0[l] + j and ``real[l, j]`` says it
        exists. Closest: the lexicographic minimum of (t, prim) over the
        hits, then the tie rule against the running best. That minimum
        does not depend on the order the hits are taken in, so it is what
        a kernel's in-order loop keeps and what its warp reduction over
        32-triangle rounds keeps."""
        ok, t, u, v = _leaf_mt(o, d, tmin, tri)
        ok = ok & real
        if stats is not None:
            stats.mt += int(real.sum())
        if self.any_hit:
            self.occ[li] |= (ok & (t < self.t[li][:, None])).any(dim=1)
            return
        c = t.shape[1]
        col = torch.arange(c, device=t.device)
        t_m = torch.where(ok, t, float("inf"))
        t_leaf = t_m.min(dim=1).values
        first = torch.where(ok & (t_m == t_leaf[:, None]), col, c)
        jj = first.min(dim=1).values
        found = jj < c
        jc = torch.clamp(jj, max=c - 1)[:, None]
        prim = prim0 + jj
        bt, bp = self.t[li], self.prim[li]
        take = found & ((t_leaf < bt) | ((t_leaf == bt) & (prim < bp)))
        self.t[li] = torch.where(take, t_leaf, bt)
        self.u[li] = torch.where(take, u.gather(1, jc)[:, 0], self.u[li])
        self.v[li] = torch.where(take, v.gather(1, jc)[:, 0], self.v[li])
        self.prim[li] = torch.where(take, prim, bp)


class WalkStats:
    """Work a plain version did on its inputs, for the card's lower bound
    (``chip_smoke.py``): box slab tests, Moller-Trumbore tests, instance
    transforms, and the distinct rows read of each table. Pass one as
    ``stats`` to a plain version; the kernels count nothing."""

    def __init__(self):
        self.slab = 0
        self.mt = 0
        self.xform = 0
        self.rows = {}  # table name -> [rows] bool, read at least once

    def touch(self, name, size, idx):
        mask = self.rows.get(name)
        if mask is None:
            mask = self.rows[name] = torch.zeros(size, dtype=torch.bool, device=idx.device)
        mask[idx] = True

    def distinct(self, name):
        mask = self.rows.get(name)
        return 0 if mask is None else int(mask.sum())


def _walk(rays, nodes, blocks, n_tris, leaf_span, any_hit, stats=None):
    """The kernel's walk, vectorized over one chunk of rays: every ray
    with a non-empty stack pops one ref per step. ``blocks`` is any
    component-major store of at least ``n_tris`` columns (``tri_blocks``,
    or a [T, 12] row store's transpose)."""
    dev = rays.device
    n = rays.shape[1]
    n_cl = (n_tris + TRI_TILE - 1) // TRI_TILE
    o = [rays[0], rays[1], rays[2]]
    d = [rays[3], rays[4], rays[5]]
    tmin = rays[6]
    inv = [_safe_inv(c) for c in d]
    neg = torch.stack([c < 0 for c in d], dim=1)  # [n, 3]
    best = Best(rays[7], any_hit)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # the root, ref 0
    col = torch.arange(TRI_TILE, device=dev)
    leaf_rays = max(1, PLAIN_LEAF_PAIRS // TRI_TILE)
    while True:
        live = (sp > 0) & ~best.occ
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        ref = stack[idx, sp[idx]]
        inner = ref >= 0

        ii, rr = idx[inner], ref[inner]
        if ii.numel():
            push_children(stack, sp, ii, nodes[rr], [a[ii] for a in o],
                          [a[ii] for a in inv], tmin[ii], best.t[ii], neg[ii])
            if stats is not None:
                stats.slab += 2 * ii.numel()
                stats.touch("nodes", nodes.shape[0], rr)

        blk = -ref[~inner] - 1
        li_all = idx[~inner]
        for j in range(leaf_span):
            k_all = blk * leaf_span + j
            keep = k_all < n_cl
            for s in range(0, int(keep.sum()), leaf_rays):
                li = li_all[keep][s:s + leaf_rays]
                k = k_all[keep][s:s + leaf_rays]
                cols = k[:, None] * TRI_TILE + col          # [L, 128]
                real = cols < n_tris                        # real-count guard
                tri = blocks[:, torch.clamp(cols, max=n_tris - 1)]  # [9, L, 128]
                best.update(
                    li, [a[li] for a in o], [a[li] for a in d], tmin[li],
                    tri, real, k * TRI_TILE, stats,
                )
                if stats is not None:
                    stats.touch("tri_blocks", n_tris, cols[real])
    return best.result()


def first_box_hit(boxes, start, count, o, inv, tmin, best_t, window, stats=None, name=None):
    """Slab-test rows ``start[l] + w`` of ``boxes`` for ``w < min(count[l],
    window)`` with ray l's best t, and return ([L] offset of the first hit
    or -1, [L] boxes tested up to and including it). A kernel tests these
    boxes one after another, and a miss changes no best t, so this is its
    sequence of tests up to its first hit."""
    w = torch.arange(window, device=start.device)
    valid = w < count[:, None]                                  # [L, W]
    rows = torch.clamp(start[:, None] + w, min=0, max=boxes.shape[0] - 1)
    hit = _slab(boxes[rows], [a[:, None] for a in o], [a[:, None] for a in inv],
                tmin[:, None], best_t[:, None]) & valid
    found = hit.any(dim=1)
    first = torch.where(found, hit.int().argmax(dim=1), -1)
    tested = torch.where(found, first + 1, valid.sum(dim=1))
    if stats is not None:
        stats.slab += int(tested.sum())
        stats.touch(name, boxes.shape[0], rows[w < tested[:, None]])
    return first, tested


def push_children(stack, sp, ii, row, o, inv, tmin, best_t, neg):
    """One inner-node step of rays ``ii`` (the kernel's): slab-test both
    children of their popped node rows [L, 16] and push the hit ones, far
    first, near/far by each ray's direction sign ``neg`` [L, 3] on the
    node's split axis."""
    h0 = _slab(row[:, 0:6], o, inv, tmin, best_t)
    h1 = _slab(row[:, 6:12], o, inv, tmin, best_t)
    c0, c1 = row[:, 12].long(), row[:, 13].long()
    flip = neg.gather(1, row[:, 14].long()[:, None])[:, 0]
    near_r, far_r = torch.where(flip, c1, c0), torch.where(flip, c0, c1)
    near_h, far_h = torch.where(flip, h1, h0), torch.where(flip, h0, h1)
    p = sp[ii]
    stack[ii[far_h], p[far_h]] = far_r[far_h]  # far first: near pops first
    p = p + far_h
    stack[ii[near_h], p[near_h]] = near_r[near_h]
    sp[ii] = p + near_h


def chunked(walk, rays, any_hit):
    """Run a plain walk ``walk(rays_chunk)`` over chunks of at most
    PLAIN_RAYS_PER_CHUNK rays and join the answers."""
    step = PLAIN_RAYS_PER_CHUNK
    parts = [walk(rays[:, s:s + step]) for s in range(0, max(rays.shape[1], 1), step)]
    if any_hit:
        return torch.cat(parts)
    return tuple(torch.cat(cols) for cols in zip(*parts))


def closest_plain(rays, nodes, blocks, n_tris, leaf_span=1, stats=None):
    """Plain version of the closest-hit kernel -> (t, u, v, prim int32)."""
    return chunked(lambda r: _walk(r, nodes, blocks, n_tris, leaf_span, False, stats),
                   rays, False)


def any_hit_plain(rays, nodes, blocks, n_tris, leaf_span=1, stats=None):
    """Plain version of the any-hit kernel -> [N] bool occluded."""
    return chunked(lambda r: _walk(r, nodes, blocks, n_tris, leaf_span, True, stats),
                   rays, True)


# ------------------------------ CUDA wrapper --------------------------------

def check_blocks(blocks, n_real=None):
    """Shape of a component-major triangle store: [9, 128 K > 0] float32,
    with ``n_real`` (if given) in its last cluster."""
    if blocks.dim() != 2 or blocks.shape[0] != 9 or blocks.shape[1] == 0 \
            or blocks.shape[1] % TRI_TILE:
        raise ValueError(f"blocks must be [9, 128 K > 0], got {tuple(blocks.shape)}")
    if blocks.shape[1] >= 2 ** 31 - TRI_TILE:
        raise ValueError("too many triangles for int32 prim ids")
    if n_real is not None and not blocks.shape[1] - TRI_TILE < int(n_real) <= blocks.shape[1]:
        raise ValueError(
            f"n_tris {n_real} does not fill the last cluster of a {blocks.shape[1]}-column store"
        )


def _check(rays, nodes, blocks, n_tris, leaf_span):
    ts = (rays, nodes, blocks)
    if not all(isinstance(x, torch.Tensor) for x in ts):
        raise TypeError("rays, nodes and blocks must be tensors")
    if len({x.device for x in ts}) != 1:
        raise ValueError(
            f"rays on {rays.device}, nodes on {nodes.device}, blocks on {blocks.device}"
        )
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError(
            "expected float32 rays, nodes and blocks, got "
            f"{rays.dtype}, {nodes.dtype}, {blocks.dtype}"
        )
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, N], got {tuple(rays.shape)}")
    if nodes.dim() != 2 or nodes.shape[1] != 16 or nodes.shape[0] == 0:
        raise ValueError(f"nodes must be [Nn>0, 16], got {tuple(nodes.shape)}")
    check_blocks(blocks, n_tris)
    if int(leaf_span) < 1:
        raise ValueError(f"leaf_span must be >= 1, got {leaf_span}")
    if rays.is_cuda:
        if not all(x.is_contiguous() for x in ts):
            raise ValueError("the CUDA kernel needs contiguous rays, nodes and blocks")
        if nodes.data_ptr() % 16 or blocks.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned nodes and blocks")


def _lib():
    from ..kernels.build import load

    lib = load(_LIB)
    if not getattr(lib, "_akr_typed", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.akr_tree_closest.argtypes = [
            vp, i64, vp, vp, i64, i32, i32, vp, vp, vp, vp, i32, vp,
        ]
        lib.akr_tree_closest.restype = i32
        lib.akr_tree_anyhit.argtypes = [vp, i64, vp, vp, i64, i32, i32, vp, i32, vp]
        lib.akr_tree_anyhit.restype = i32
        lib._akr_typed = True
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def closest(rays, nodes, blocks, n_tris, leaf_span=1):
    """Closest hit -> (t [N] f32, u [N] f32, v [N] f32, prim [N] int32).

    A miss gives prim -1, t = T_MAX, u = v = 0."""
    _check(rays, nodes, blocks, n_tris, leaf_span)
    if not rays.is_cuda:
        return closest_plain(rays, nodes, blocks, n_tris, leaf_span)
    n = rays.shape[1]
    dev = rays.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, u, v, prim
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_tree_closest(
        rays.data_ptr(), n, nodes.data_ptr(), blocks.data_ptr(), blocks.shape[1],
        int(n_tris), int(leaf_span), t.data_ptr(), u.data_ptr(), v.data_ptr(),
        prim.data_ptr(), dev.index, stream,
    )
    _raise_on(err, "tree closest-hit")
    LAUNCHES["closest"] += 1
    return t, u, v, prim


def any_hit(rays, nodes, blocks, n_tris, leaf_span=1):
    """Any hit in (t_min, t_max) -> [N] bool occluded."""
    _check(rays, nodes, blocks, n_tris, leaf_span)
    if not rays.is_cuda:
        return any_hit_plain(rays, nodes, blocks, n_tris, leaf_span)
    n = rays.shape[1]
    dev = rays.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_tree_anyhit(
        rays.data_ptr(), n, nodes.data_ptr(), blocks.data_ptr(), blocks.shape[1],
        int(n_tris), int(leaf_span), occ.data_ptr(), dev.index, stream,
    )
    _raise_on(err, "tree any-hit")
    LAUNCHES["any_hit"] += 1
    return occ
