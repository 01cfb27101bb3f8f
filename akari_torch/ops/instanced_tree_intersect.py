"""Two-level instanced tree walk: CUDA kernel and plain twin.

Counterpart of ``akari_tpu/ops/pallas_tree.py::run_instanced_tree`` (the
TPU kernel ``_instanced_tree_kernel``), the route of every two-level
instanced scene compiled with tree tables. The kernel is
``kernels/csrc/instanced_tree_intersect.cu``: one lane per ray, the warp
stepping through the instances together and testing its lanes' pending
leaves together, 32 triangles a round; its note says what bounds it on the
H100 and what its design does about that. The
plain PyTorch version lives beside it here: the same per-ray sequence
(instances in index order; cull, transform, walk), vectorized over rays.

``closest(rays, instf, insti, nodes, blocks, leaf_span)`` and
``any_hit(...)`` take

- ``rays``: ``[8, N]`` float32, rows ox oy oz dx dy dz tmin tmax (world);
- ``instf``: ``[I, 20]`` float32, world box lo(0:3) hi(3:6), w2o rows
  (6:18) (``SceneArrays.inst_f32``);
- ``insti``: ``[I, 8]`` int32; slot 3 n_clusters, 4 tile_base, 5
  prim_base, 6 tree_base (``SceneArrays.inst_i32``);
- ``nodes``: ``[sum Nn, 16]`` float32, the prototype trees concatenated;
- ``blocks``: ``[9, sum Kp*128]`` float32 (``SceneArrays.inst_tri_blocks``),
  component-major: cluster ``tile_base + k`` is columns ``128 (tile_base +
  k)`` onward, each prototype padded to whole clusters with zero columns;
- ``leaf_span``: clusters per leaf block, one for every prototype.

On CUDA tensors they launch the kernel or raise; on CPU tensors they run
the plain version. ``LAUNCHES`` counts kernel launches per variant. Hits
carry VIRTUAL prim ids (``scene/geom.py``); ties, also across instances,
go to the lower virtual id.
"""

from __future__ import annotations

import ctypes

import torch

from ..bvh.cluster_tree import STACK_DEPTH, TRI_TILE
from .tree_intersect import (
    PLAIN_LEAF_PAIRS,
    Best,
    _raise_on,
    _safe_inv,
    check_blocks,
    chunked,
    first_box_hit,
    push_children,
)

LAUNCHES = {"closest": 0, "any_hit": 0}

_LIB = "instanced_tree_intersect"

# Per-instance transform ops counted by WalkStats.xform (origin 18, direction
# 15, three guarded reciprocals 12).
XFORM_OPS = 45
# Instance boxes one step of a plain instanced version tests per ray.
CULL_WINDOW = 32


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------ plain twin ----------------------------------

def to_object(m, wo, wd):
    """[L, 12] w2o rows applied to world origins / directions ([L] each),
    in the kernel's operation order; the direction stays unnormalized."""
    o = [m[:, 4 * r] * wo[0] + m[:, 4 * r + 1] * wo[1] + m[:, 4 * r + 2] * wo[2]
         + m[:, 4 * r + 3] for r in range(3)]
    d = [m[:, 4 * r] * wd[0] + m[:, 4 * r + 1] * wd[1] + m[:, 4 * r + 2] * wd[2]
         for r in range(3)]
    return o, d


class InstanceCursor:
    """Per-ray state of the instance loop shared by the plain instanced
    versions: the next instance to cull, and the object-space ray and int
    table row of the instance being walked."""

    def __init__(self, rays, instf, insti):
        n, dev = rays.shape[1], rays.device
        self.instf, self.insti = instf, insti.long()
        self.boxes = instf[:, 0:6]
        self.wo = [rays[0], rays[1], rays[2]]
        self.wd = [rays[3], rays[4], rays[5]]
        self.winv = [_safe_inv(c) for c in self.wd]
        self.tmin = rays[6]
        self.nxt = torch.zeros(n, dtype=torch.int64, device=dev)
        self.o = [torch.zeros(n, device=dev) for _ in range(3)]
        self.d = [torch.zeros(n, device=dev) for _ in range(3)]
        self.inv = [torch.ones(n, device=dev) for _ in range(3)]
        self.row = torch.zeros((n, 8), dtype=torch.int64, device=dev)

    def more(self):
        return self.nxt < self.instf.shape[0]

    def cull(self, rays_idx, best_t, stats=None):
        """Rays ``rays_idx`` test their next instances' world boxes in
        index order with their best t, up to CULL_WINDOW of them, as the
        kernel does one by one; a ray that hits one takes its object-space
        ray and row, and its cursor moves past it. Returns the indices of
        those rays."""
        nxt = self.nxt[rays_idx]
        first, tested = first_box_hit(
            self.boxes, nxt, self.instf.shape[0] - nxt, [a[rays_idx] for a in self.wo],
            [a[rays_idx] for a in self.winv], self.tmin[rays_idx], best_t, CULL_WINDOW,
            stats, "instances",
        )
        self.nxt[rays_idx] = nxt + tested
        hit = first >= 0
        a, ii = rays_idx[hit], (nxt + first)[hit]
        if stats is not None:
            stats.xform += a.numel()
        if a.numel():
            o, d = to_object(self.instf[ii, 6:18], [c[a] for c in self.wo],
                             [c[a] for c in self.wd])
            for k in range(3):
                self.o[k][a] = o[k]
                self.d[k][a] = d[k]
                self.inv[k][a] = _safe_inv(d[k])
            self.row[a] = self.insti[ii]
        return a


def _walk(rays, instf, insti, nodes, blocks, leaf_span, any_hit, stats=None):
    """The kernel's per-ray sequence, vectorized over one chunk of rays:
    each step, a ray with an empty stack culls its next instance (and
    pushes the prototype's root on a hit); a ray with a non-empty stack
    pops one ref. ``blocks`` is any component-major store (``inst_tri_blocks``,
    or a [sum Kp*128, 12] row store's transpose)."""
    dev = rays.device
    n = rays.shape[1]
    cur = InstanceCursor(rays, instf, insti)
    best = Best(rays[7], any_hit)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    col = torch.arange(TRI_TILE, device=dev)
    leaf_rays = max(1, PLAIN_LEAF_PAIRS // TRI_TILE)
    while True:
        live = ~best.occ & ((sp > 0) | cur.more())
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        adv = idx[sp[idx] == 0]
        if adv.numel():
            entered = cur.cull(adv, best.t[adv], stats)
            stack[entered, 0] = 0
            sp[entered] = 1
        idx = idx[sp[idx] > 0]
        if idx.numel() == 0:
            continue
        sp[idx] -= 1
        ref = stack[idx, sp[idx]]
        inner = ref >= 0

        ii = idx[inner]
        if ii.numel():
            nrow = cur.row[ii, 6] + ref[inner]
            neg = torch.stack([cur.d[k][ii] < 0 for k in range(3)], dim=1)
            push_children(stack, sp, ii, nodes[nrow], [a[ii] for a in cur.o],
                          [a[ii] for a in cur.inv], cur.tmin[ii], best.t[ii], neg)
            if stats is not None:
                stats.slab += 2 * ii.numel()
                stats.touch("nodes", nodes.shape[0], nrow)

        blk = -ref[~inner] - 1
        li_all = idx[~inner]
        for j in range(leaf_span):
            k_all = blk * leaf_span + j
            keep = k_all < cur.row[li_all, 3]
            for s in range(0, int(keep.sum()), leaf_rays):
                li = li_all[keep][s:s + leaf_rays]
                k = k_all[keep][s:s + leaf_rays]
                cols = (cur.row[li, 4] + k)[:, None] * TRI_TILE + col
                tri = blocks[:, cols]                             # [9, L, 128]
                real = torch.ones(cols.shape, dtype=torch.bool, device=dev)
                best.update(
                    li, [a[li] for a in cur.o], [a[li] for a in cur.d],
                    cur.tmin[li], tri, real, cur.row[li, 5] + k * TRI_TILE,
                    stats,
                )
                if stats is not None:
                    stats.touch("tri_blocks", blocks.shape[1], cols)
    return best.result()


def closest_plain(rays, instf, insti, nodes, blocks, leaf_span=1, stats=None):
    """Plain version of the closest-hit kernel -> (t, u, v, prim int32)."""
    return chunked(
        lambda r: _walk(r, instf, insti, nodes, blocks, leaf_span, False, stats),
        rays, False,
    )


def any_hit_plain(rays, instf, insti, nodes, blocks, leaf_span=1, stats=None):
    """Plain version of the any-hit kernel -> [N] bool occluded."""
    return chunked(
        lambda r: _walk(r, instf, insti, nodes, blocks, leaf_span, True, stats),
        rays, True,
    )


# ------------------------------ CUDA wrapper --------------------------------

def check_instanced(rays, instf, insti, tables, blocks):
    """Checks shared by the instanced wrappers: ``tables`` are the float32
    [*, 16] or [*, 8] box / node tables the kernel reads; ``blocks`` is the
    [9, sum Kp*128] component-major triangle store."""
    ts = (rays, instf, insti, *tables, blocks)
    if not all(isinstance(x, torch.Tensor) for x in ts):
        raise TypeError("rays and every table must be tensors")
    if len({x.device for x in ts}) != 1:
        raise ValueError(f"tensors on several devices: {sorted({str(x.device) for x in ts})}")
    if any(x.dtype != torch.float32 for x in (rays, instf, *tables, blocks)):
        raise TypeError("rays, instf, the box / node tables and blocks must be float32")
    if insti.dtype != torch.int32:
        raise TypeError(f"insti must be int32, got {insti.dtype}")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, N], got {tuple(rays.shape)}")
    n_inst = instf.shape[0] if instf.dim() == 2 else -1
    if instf.dim() != 2 or instf.shape[1] != 20 or n_inst == 0:
        raise ValueError(f"instf must be [I>0, 20], got {tuple(instf.shape)}")
    if tuple(insti.shape) != (n_inst, 8):
        raise ValueError(f"insti must be [{n_inst}, 8], got {tuple(insti.shape)}")
    check_blocks(blocks)
    if rays.is_cuda:
        if not all(x.is_contiguous() for x in ts):
            raise ValueError("the CUDA kernel needs contiguous tensors")
        if any(x.data_ptr() % 16 for x in ts[1:]):
            raise ValueError("the CUDA kernel needs 16-byte aligned tables")


def _check(rays, instf, insti, nodes, blocks, leaf_span):
    check_instanced(rays, instf, insti, (nodes,), blocks)
    if nodes.dim() != 2 or nodes.shape[1] != 16 or nodes.shape[0] == 0:
        raise ValueError(f"nodes must be [Nn>0, 16], got {tuple(nodes.shape)}")
    if int(leaf_span) < 1:
        raise ValueError(f"leaf_span must be >= 1, got {leaf_span}")


def _lib():
    from ..kernels.build import load

    lib = load(_LIB)
    if not getattr(lib, "_akr_typed", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.akr_instanced_tree_closest.argtypes = [
            vp, i64, vp, vp, i32, vp, vp, i64, i32, vp, vp, vp, vp, i32, vp,
        ]
        lib.akr_instanced_tree_closest.restype = i32
        lib.akr_instanced_tree_anyhit.argtypes = [
            vp, i64, vp, vp, i32, vp, vp, i64, i32, vp, i32, vp,
        ]
        lib.akr_instanced_tree_anyhit.restype = i32
        lib._akr_typed = True
    return lib


def closest(rays, instf, insti, nodes, blocks, leaf_span=1):
    """Closest hit -> (t [N] f32, u [N] f32, v [N] f32, prim [N] int32
    virtual). A miss gives prim -1, t = T_MAX, u = v = 0."""
    _check(rays, instf, insti, nodes, blocks, leaf_span)
    if not rays.is_cuda:
        return closest_plain(rays, instf, insti, nodes, blocks, leaf_span)
    n = rays.shape[1]
    dev = rays.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, u, v, prim
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_instanced_tree_closest(
        rays.data_ptr(), n, instf.data_ptr(), insti.data_ptr(), instf.shape[0],
        nodes.data_ptr(), blocks.data_ptr(), blocks.shape[1], int(leaf_span),
        t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(), dev.index, stream,
    )
    _raise_on(err, "instanced tree closest-hit")
    LAUNCHES["closest"] += 1
    return t, u, v, prim


def any_hit(rays, instf, insti, nodes, blocks, leaf_span=1):
    """Any hit in (t_min, t_max) -> [N] bool occluded."""
    _check(rays, instf, insti, nodes, blocks, leaf_span)
    if not rays.is_cuda:
        return any_hit_plain(rays, instf, insti, nodes, blocks, leaf_span)
    n = rays.shape[1]
    dev = rays.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_instanced_tree_anyhit(
        rays.data_ptr(), n, instf.data_ptr(), insti.data_ptr(), instf.shape[0],
        nodes.data_ptr(), blocks.data_ptr(), blocks.shape[1], int(leaf_span),
        occ.data_ptr(), dev.index, stream,
    )
    _raise_on(err, "instanced tree any-hit")
    LAUNCHES["any_hit"] += 1
    return occ
