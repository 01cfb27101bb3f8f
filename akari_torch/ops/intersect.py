"""Ray-scene intersection on V3 rays (``akari_tpu/ops/intersect.py``).

Interchangeable backends behind ``intersect_soa`` / ``occlude_soa``:

- ``dense``: the hand-written CUDA all-pairs kernel on CUDA tensors, its
  plain PyTorch version on CPU tensors (ops/dense_intersect.py);
- ``tree``: the hand-written CUDA BVH2 tree walk on CUDA tensors, its
  plain PyTorch walk on CPU tensors (ops/tree_intersect.py); the route of
  ``pallas_intersect.intersect_pallas_soa`` for flat scenes above
  ``DENSE_MAX_TRIS``. The reference sorts the rays by a coherence key
  first (its tiles share one walk); the port's walk is per ray and the
  sort did not pay for itself on the H100 (PERF.md), so the route
  launches on the rays as they come. A flat scene whose ``tri_tree`` is
  None (its box tables only) takes the linear supercluster sweep
  (ops/cluster_intersect.py), as the reference does; nothing the port
  compiles is such a scene, and the tests reach it by nulling the table;
- two-level scenes (``scene.instances`` set; intersector ``tree``): the
  instanced tree walk (ops/instanced_tree_intersect.py), or the linear
  instanced sweep when ``tri_tree`` is None, the choice of
  ``pallas_intersect.intersect_pallas_instanced``, on the rays as they
  come; hits carry virtual prim ids (scene/geom.py);
- ``brute``: the reference's all-pairs oracle, tiled over triangles, for
  flat scenes on CPU tensors only.

``intersect`` / ``occlude`` are the reference's AoS entry points ([N, 3]
rays, a ``Hit`` record with ``uv`` [N, 2]) over the same routes.

Hits carry no gradient (the detached-hit convention): the queries run
under ``torch.no_grad()`` on detached inputs, so no autograd Function is
needed. Gradients reach scene parameters through shading at the hit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.v3 import from_stack
from ..core.vecmath import cross, dot
from . import cluster_intersect, dense_intersect, instanced_tree_intersect, tree_intersect
from .dense_intersect import HIT_EPS, T_MAX


class Hit(NamedTuple):
    t: torch.Tensor      # [N] float32 (T_MAX when missed)
    prim: torch.Tensor   # [N] int32 (-1 when missed)
    uv: torch.Tensor     # [N, 2] barycentric (u, v); p = v0 + u*e1 + v*e2
    valid: torch.Tensor  # [N] bool


class HitSoA(NamedTuple):
    t: torch.Tensor      # [N] float32 (T_MAX when missed)
    prim: torch.Tensor   # [N] int32 (-1 when missed)
    u: torch.Tensor      # [N] barycentric u; p = v0 + u*e1 + v*e2
    v: torch.Tensor      # [N] barycentric v
    valid: torch.Tensor  # [N] bool


def moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Batched Moeller-Trumbore over broadcast [..., 3] tensors.

    Returns (hit, t, u, v)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    safe_det = torch.where(torch.abs(det) < HIT_EPS, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (torch.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def brute_closest(scene, o, d, t_min, t_max, tri_chunk=2048):
    """All-pairs closest hit over [N, 3] rays, tiled over triangles.

    The CPU oracle: ties within a tile go to the lowest index (argmin
    returns the first minimum), later tiles need a strictly smaller t.
    """
    if o.is_cuda or getattr(scene, "instances", None) is not None:
        raise ValueError(
            "the brute intersector is the CPU oracle of flat scenes; compile "
            "with intersector='auto', 'dense' or 'tree' for CUDA tensors or "
            "two-level scenes"
        )
    n = o.shape[0]
    best_t = torch.clamp(t_max, max=float(T_MAX)).to(torch.float32)
    best_prim = torch.full((n,), -1, dtype=torch.int32)
    best_u = torch.zeros((n,), dtype=torch.float32)
    best_v = torch.zeros((n,), dtype=torch.float32)
    t_count = scene.tri_v0.shape[0]
    for base in range(0, t_count, tri_chunk):
        cv0 = scene.tri_v0[base:base + tri_chunk]
        ce1 = scene.tri_e1[base:base + tri_chunk]
        ce2 = scene.tri_e2[base:base + tri_chunk]
        hit, t, u, v = moller_trumbore(
            o[:, None, :], d[:, None, :], cv0[None], ce1[None], ce2[None],
            t_min[:, None], best_t[:, None],
        )
        t = torch.where(hit, t, T_MAX)
        k = torch.argmin(t, dim=1)
        tk = t.gather(1, k[:, None])[:, 0]
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_prim = torch.where(closer, (base + k).to(torch.int32), best_prim)
        best_u = torch.where(closer, u.gather(1, k[:, None])[:, 0], best_u)
        best_v = torch.where(closer, v.gather(1, k[:, None])[:, 0], best_v)
    valid = best_prim >= 0
    return best_t, best_prim, best_u, best_v, valid


def _limits(o3, t_min, t_max):
    n = o3.x.shape[0]
    dev = o3.x.device
    t_min = (
        torch.zeros((n,), dtype=torch.float32, device=dev) if t_min is None
        else torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32, device=dev), (n,))
    )
    t_max = (
        torch.full((n,), T_MAX, dtype=torch.float32, device=dev) if t_max is None
        else torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    )
    return t_min, t_max


def _tree_query(scene, o3, d3, t_min, t_max, any_hit):
    """Pack the rays and run the scene's traversal kernel (closest: (t, u,
    v, prim))."""
    rays = dense_intersect.pack_rays(o3, d3, t_min, t_max).detach().contiguous()
    if scene.instances is not None:
        inst = (scene.inst_f32, scene.inst_i32)
        if scene.tri_tree is not None:
            m = instanced_tree_intersect
            fn = m.any_hit if any_hit else m.closest
            return fn(rays, *inst, scene.tri_tree, scene.inst_tri_blocks, scene.tree_leaf_span)
        m = cluster_intersect
        fn = m.instanced_any_hit if any_hit else m.instanced_closest
        return fn(rays, *inst, scene.tri_superclusters, scene.tri_clusters,
                  scene.inst_tri_blocks)
    if scene.tri_tree is not None:
        fn = tree_intersect.any_hit if any_hit else tree_intersect.closest
        return fn(rays, scene.tri_tree, scene.tri_blocks, scene.n_tris, scene.tree_leaf_span)
    if scene.tri_superclusters is None:
        raise ValueError("intersector 'tree' needs a scene compiled with its tree tables")
    fn = cluster_intersect.any_hit if any_hit else cluster_intersect.closest
    return fn(rays, scene.tri_superclusters, scene.tri_clusters, scene.tri_blocks,
              scene.n_tris)


@torch.no_grad()
def intersect_soa(scene, o3, d3, t_min=None, t_max=None):
    """Closest-hit query on V3 rays -> HitSoA. Gradients detached."""
    t_min, t_max = _limits(o3, t_min, t_max)
    if scene.intersector == "brute":
        o = o3.stack().detach()
        d = d3.stack().detach()
        return HitSoA(*brute_closest(scene, o, d, t_min, t_max))
    if scene.intersector == "tree":
        t, u, v, prim = _tree_query(scene, o3, d3, t_min, t_max, False)
        return HitSoA(t, prim, u, v, prim >= 0)
    rays = dense_intersect.pack_rays(o3, d3, t_min, t_max).detach()
    t, u, v, prim = dense_intersect.closest(rays, scene.prim_table.detach())
    return HitSoA(t, prim, u, v, prim >= 0)


@torch.no_grad()
def occlude_soa(scene, o3, d3, t_min, t_max):
    """Any-hit query on V3 rays -> [N] bool occluded."""
    t_min, t_max = _limits(o3, t_min, t_max)
    if scene.intersector == "brute":
        o = o3.stack().detach()
        d = d3.stack().detach()
        return brute_closest(scene, o, d, t_min, t_max)[4]
    if scene.intersector == "tree":
        return _tree_query(scene, o3, d3, t_min, t_max, True)
    rays = dense_intersect.pack_rays(o3, d3, t_min, t_max).detach()
    return dense_intersect.any_hit(rays, scene.prim_table.detach())


@torch.no_grad()
def intersect(scene, o, d, t_min=None, t_max=None):
    """Closest-hit query on [N, 3] rays -> Hit. Gradients detached.

    ``t_min`` / ``t_max``: None (0 and T_MAX), a scalar or [N]."""
    h = intersect_soa(scene, from_stack(o.detach()), from_stack(d.detach()), t_min, t_max)
    return Hit(h.t, h.prim, torch.stack([h.u, h.v], dim=-1), h.valid)


@torch.no_grad()
def occlude(scene, o, d, t_min, t_max):
    """Any-hit (shadow ray) query on [N, 3] rays -> [N] bool occluded."""
    return occlude_soa(scene, from_stack(o.detach()), from_stack(d.detach()), t_min, t_max)
