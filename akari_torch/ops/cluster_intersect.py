"""Linear supercluster -> cluster -> triangle sweeps: CUDA kernels and plain
twins.

Counterparts of ``akari_tpu/ops/pallas_cluster.py::run_clustered`` (the TPU
kernel ``_cluster_kernel``, flat scenes) and ``run_instanced``
(``_instanced_kernel``, two-level scenes): the routes of scenes whose
``tri_tree`` is None, as in the JAX package. The kernels are
``kernels/csrc/cluster_intersect.cu``: one lane per ray with its own sweep
cursor, each warp testing its lanes' hit clusters together, 32 triangles a
round; its note says what bounds them on the H100. The plain PyTorch
versions live beside them here: the same per-ray sequence of box and
triangle tests, vectorized over rays, each ray with its own cursor.

Flat: ``closest(rays, supers, clusters, blocks, n_tris)`` and
``any_hit(...)`` take ``[8, N]`` rays, the ``[Spad, 8]`` supercluster and
``[Kpad, 8]`` cluster boxes (``bvh/cluster_tree.py``), the ``[9, Tpad]``
component-major triangle store of the tree walks
(``SceneArrays.tri_blocks``) and the real triangle count. Instanced:
``instanced_closest(rays, instf, insti, supers, clusters, blocks)`` and
``instanced_any_hit(...)`` take the instance tables of
``ops/instanced_tree_intersect.py`` (int slots 0-5: supercluster base, real
supercluster count, cluster base, cluster count, tile base, prim base), the
concatenated per-prototype box tables and the ``[9, sum Kp*128]`` store
(``SceneArrays.inst_tri_blocks``); hits carry virtual prim ids.

On CUDA tensors they launch the kernel or raise; on CPU tensors they run
the plain version. ``LAUNCHES`` counts kernel launches per kernel and
variant. Box tests use the ray's current best t; the TPU kernels' stale
tile flags only prune, so the answers are the same function.
"""

from __future__ import annotations

import ctypes

import torch

from ..bvh.cluster_tree import SUPER, TRI_TILE, n_clusters
from .instanced_tree_intersect import InstanceCursor, check_instanced
from .tree_intersect import Best, _raise_on, _safe_inv, check_blocks, chunked, first_box_hit

LAUNCHES = {
    "closest": 0, "any_hit": 0, "instanced_closest": 0, "instanced_any_hit": 0,
}

_LIB = "cluster_intersect"


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------ plain twins ---------------------------------

class _Sweep:
    """Per-ray cursor over one supercluster -> cluster hierarchy: the next
    supercluster ``s`` and, inside a hit one, the next cluster offset ``j``
    (-1 at the supercluster level). ``step`` advances every ray of ``idx``
    to its next box hit at its level (the boxes before it, which the
    kernel tests and misses one by one, in one batch), and runs the
    triangle tests of a hit cluster."""

    def __init__(self, n, dev):
        self.s = torch.zeros(n, dtype=torch.int64, device=dev)
        self.j = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def start(self, idx):
        self.s[idx] = 0
        self.j[idx] = -1

    def step(self, idx, ray, best, supers, clusters, blocks, n_store, base, stats=None):
        """``ray(i) -> (o, d, inv, tmin)`` of rays ``i``; ``base(i) ->
        (sup_base, n_sup, cl_base, n_cl, col0, n_real, prim0)`` int64 [L]
        each: cluster k's triangles are columns col0 + 128 k onward of the
        component-major store ``blocks`` ([>= 9, >= n_store]), the first
        n_real of the mesh real. Returns the rays whose sweep ended."""
        col = torch.arange(TRI_TILE, device=idx.device)
        sup_base, n_sup, cl_base, n_cl, col0, n_real, prim0 = base(idx)
        at_super = self.j[idx] < 0
        a = idx[at_super]
        if a.numel():
            o, _, inv, tmin = ray(a)
            s = self.s[a]
            first, tested = first_box_hit(
                supers, sup_base[at_super] + s, n_sup[at_super] - s, o, inv, tmin,
                best.t[a], SUPER, stats, "supers",
            )
            hit = first >= 0
            self.s[a] = torch.where(hit, s + first, s + tested)
            self.j[a[hit]] = 0
        b = idx[~at_super]
        if b.numel():
            keep = ~at_super
            cb, ncl, c0, nr, p0 = (x[keep] for x in (cl_base, n_cl, col0, n_real, prim0))
            o, d, inv, tmin = ray(b)
            s, j = self.s[b], self.j[b]
            k0 = s * SUPER + j
            first, _ = first_box_hit(
                clusters, cb + k0, torch.minimum(SUPER - j, ncl - k0), o, inv, tmin,
                best.t[b], SUPER, stats, "clusters",
            )
            h = (first >= 0).nonzero()[:, 0]
            if h.numel():
                local = (k0[h] + first[h]) * TRI_TILE
                cols = c0[h, None] + local[:, None] + col           # [L, 128]
                real = (local[:, None] + col) < nr[h, None]         # real-count guard
                tri = blocks[:, torch.clamp(cols, max=n_store - 1)]  # [>= 9, L, 128]
                best.update(b[h], [x[h] for x in o], [x[h] for x in d], tmin[h],
                            tri, real, p0[h] + local, stats)
                if stats is not None:
                    stats.touch("tri_blocks", n_store, cols[real])
            j = torch.where(first >= 0, j + first + 1, SUPER)
            end = (j >= SUPER) | (s * SUPER + j >= ncl)
            self.j[b] = torch.where(end, -1, j)
            self.s[b] = torch.where(end, s + 1, s)
        return idx[self.s[idx] >= n_sup]


def _flat_sweep(rays, supers, clusters, blocks, n_tris, any_hit, stats=None):
    dev, n = rays.device, rays.shape[1]
    n_cl = n_clusters(n_tris)
    n_sup = (n_cl + SUPER - 1) // SUPER
    o = [rays[0], rays[1], rays[2]]
    d = [rays[3], rays[4], rays[5]]
    inv = [_safe_inv(c) for c in d]
    tmin = rays[6]
    best = Best(rays[7], any_hit)
    sw = _Sweep(n, dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)

    def ray(i):
        return [a[i] for a in o], [a[i] for a in d], [a[i] for a in inv], tmin[i]

    def base(i):
        z = zero[i]
        return z, z + n_sup, z, z + n_cl, z, z + n_tris, z

    while True:
        idx = ((sw.s < n_sup) & ~best.occ).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sw.step(idx, ray, best, supers, clusters, blocks, n_tris, base, stats)
    return best.result()


def _instanced_sweep(rays, instf, insti, supers, clusters, blocks, any_hit, stats=None):
    dev, n = rays.device, rays.shape[1]
    cur = InstanceCursor(rays, instf, insti)
    best = Best(rays[7], any_hit)
    sw = _Sweep(n, dev)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)  # sweeping an instance

    def ray(i):
        return ([a[i] for a in cur.o], [a[i] for a in cur.d],
                [a[i] for a in cur.inv], cur.tmin[i])

    def base(i):
        r = cur.row[i]
        return r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4] * TRI_TILE, r[:, 3] * TRI_TILE, r[:, 5]

    while True:
        live = ~best.occ & (inside | cur.more())
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        adv = idx[~inside[idx]]
        if adv.numel():
            entered = cur.cull(adv, best.t[adv], stats)
            entered = entered[cur.row[entered, 1] > 0]
            sw.start(entered)
            inside[entered] = True
        idx = idx[inside[idx]]
        if idx.numel():
            inside[sw.step(idx, ray, best, supers, clusters, blocks, blocks.shape[1], base,
                           stats)] = False
    return best.result()


def closest_plain(rays, supers, clusters, blocks, n_tris, stats=None):
    """Plain version of the flat closest-hit kernel -> (t, u, v, prim int32).
    ``blocks`` is any component-major store of at least ``n_tris`` columns
    (``tri_blocks``, or a row store's transpose)."""
    return chunked(lambda r: _flat_sweep(r, supers, clusters, blocks, n_tris, False, stats),
                   rays, False)


def any_hit_plain(rays, supers, clusters, blocks, n_tris, stats=None):
    """Plain version of the flat any-hit kernel -> [N] bool occluded."""
    return chunked(lambda r: _flat_sweep(r, supers, clusters, blocks, n_tris, True, stats),
                   rays, True)


def instanced_closest_plain(rays, instf, insti, supers, clusters, blocks, stats=None):
    """Plain version of the instanced closest-hit kernel."""
    return chunked(
        lambda r: _instanced_sweep(r, instf, insti, supers, clusters, blocks, False, stats),
        rays, False,
    )


def instanced_any_hit_plain(rays, instf, insti, supers, clusters, blocks, stats=None):
    """Plain version of the instanced any-hit kernel."""
    return chunked(
        lambda r: _instanced_sweep(r, instf, insti, supers, clusters, blocks, True, stats),
        rays, True,
    )


# ------------------------------ CUDA wrappers -------------------------------

def _check_boxes(supers, clusters):
    for name, x in (("supers", supers), ("clusters", clusters)):
        if x.dim() != 2 or x.shape[1] != 8 or x.shape[0] == 0:
            raise ValueError(f"{name} must be [rows>0, 8], got {tuple(x.shape)}")


def _check_flat(rays, supers, clusters, blocks, n_tris):
    ts = (rays, supers, clusters, blocks)
    if not all(isinstance(x, torch.Tensor) for x in ts):
        raise TypeError("rays and every table must be tensors")
    if len({x.device for x in ts}) != 1:
        raise ValueError(f"tensors on several devices: {sorted({str(x.device) for x in ts})}")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError("rays, supers, clusters and blocks must be float32")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, N], got {tuple(rays.shape)}")
    _check_boxes(supers, clusters)
    check_blocks(blocks, n_tris)
    k = n_clusters(int(n_tris))
    if clusters.shape[0] < k or supers.shape[0] < (k + SUPER - 1) // SUPER:
        raise ValueError("the box tables are shorter than the triangle store")
    if rays.is_cuda:
        if not all(x.is_contiguous() for x in ts):
            raise ValueError("the CUDA kernel needs contiguous tensors")
        if any(x.data_ptr() % 16 for x in ts[1:]):
            raise ValueError("the CUDA kernel needs 16-byte aligned tables")


def _lib():
    from ..kernels.build import load

    lib = load(_LIB)
    if not getattr(lib, "_akr_typed", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.akr_cluster_closest.argtypes = [
            vp, i64, vp, vp, vp, i64, i32, vp, vp, vp, vp, i32, vp,
        ]
        lib.akr_cluster_anyhit.argtypes = [vp, i64, vp, vp, vp, i64, i32, vp, i32, vp]
        lib.akr_instanced_cluster_closest.argtypes = [
            vp, i64, vp, vp, i32, vp, vp, vp, i64, vp, vp, vp, vp, i32, vp,
        ]
        lib.akr_instanced_cluster_anyhit.argtypes = [
            vp, i64, vp, vp, i32, vp, vp, vp, i64, vp, i32, vp,
        ]
        for fn in (lib.akr_cluster_closest, lib.akr_cluster_anyhit,
                   lib.akr_instanced_cluster_closest, lib.akr_instanced_cluster_anyhit):
            fn.restype = i32
        lib._akr_typed = True
    return lib


def _outputs(rays, any_hit):
    n, dev = rays.shape[1], rays.device
    if any_hit:
        return (torch.empty((n,), dtype=torch.bool, device=dev),)
    return (
        torch.empty((n,), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.int32, device=dev),
    )


def _launch(fn, key, rays, args, any_hit):
    out = _outputs(rays, any_hit)
    n = rays.shape[1]
    if n:
        dev = rays.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rays.data_ptr(), n, *args, *(x.data_ptr() for x in out), dev.index, stream)
        _raise_on(err, f"cluster {key}")
        LAUNCHES[key] += 1
    return out[0] if any_hit else out


def _flat_args(supers, clusters, blocks, n_tris):
    return (supers.data_ptr(), clusters.data_ptr(), blocks.data_ptr(), blocks.shape[1],
            int(n_tris))


def closest(rays, supers, clusters, blocks, n_tris):
    """Flat closest hit -> (t, u, v, prim int32); a miss gives prim -1,
    t = T_MAX, u = v = 0."""
    _check_flat(rays, supers, clusters, blocks, n_tris)
    if not rays.is_cuda:
        return closest_plain(rays, supers, clusters, blocks, n_tris)
    args = _flat_args(supers, clusters, blocks, n_tris)
    return _launch(_lib().akr_cluster_closest, "closest", rays, args, False)


def any_hit(rays, supers, clusters, blocks, n_tris):
    """Flat any hit in (t_min, t_max) -> [N] bool occluded."""
    _check_flat(rays, supers, clusters, blocks, n_tris)
    if not rays.is_cuda:
        return any_hit_plain(rays, supers, clusters, blocks, n_tris)
    args = _flat_args(supers, clusters, blocks, n_tris)
    return _launch(_lib().akr_cluster_anyhit, "any_hit", rays, args, True)


def _instanced_args(instf, insti, supers, clusters, blocks):
    return (instf.data_ptr(), insti.data_ptr(), instf.shape[0], supers.data_ptr(),
            clusters.data_ptr(), blocks.data_ptr(), blocks.shape[1])


def instanced_closest(rays, instf, insti, supers, clusters, blocks):
    """Instanced closest hit -> (t, u, v, prim int32 virtual)."""
    check_instanced(rays, instf, insti, (supers, clusters), blocks)
    _check_boxes(supers, clusters)
    if not rays.is_cuda:
        return instanced_closest_plain(rays, instf, insti, supers, clusters, blocks)
    args = _instanced_args(instf, insti, supers, clusters, blocks)
    return _launch(_lib().akr_instanced_cluster_closest, "instanced_closest", rays, args, False)


def instanced_any_hit(rays, instf, insti, supers, clusters, blocks):
    """Instanced any hit -> [N] bool occluded."""
    check_instanced(rays, instf, insti, (supers, clusters), blocks)
    _check_boxes(supers, clusters)
    if not rays.is_cuda:
        return instanced_any_hit_plain(rays, instf, insti, supers, clusters, blocks)
    args = _instanced_args(instf, insti, supers, clusters, blocks)
    return _launch(_lib().akr_instanced_cluster_anyhit, "instanced_any_hit", rays, args, True)
