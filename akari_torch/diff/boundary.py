"""Silhouette (visibility-boundary) gradients for vertex positions
(``akari_tpu/diff/boundary.py``).

The interior-term geometry gradients (diff/inverse.py ``tri_delta``)
differentiate shading at detached hit points; they miss the boundary term
of Reynolds' transport theorem, the change of the *blocked region* when an
occluder moves. This module estimates that term for the **direct-lighting**
(NEE) integral by explicit silhouette edge sampling (Li et al. 2018,
restricted to the area-light visibility integral):

    dI/dθ|_boundary = ∮_{∂blocked} f(x, y(s)) (n̂(s) · dy/dθ) dl(s)

where the boundary curve is the projection of occluder silhouette edges
onto the light plane and n̂ the in-plane normal pointing INTO the blocked
region. The estimator samples an occluder edge and a point q on it,
projects x→q onto a sampled light's plane (→ y), keeps the sample iff the
edge is a silhouette from x, y lies inside the light triangle and two side
probes confirm a real shadow boundary, and adds the surrogate
``Δf · |dy/ds| · n̂·(y − y.detach())``: primal value exactly 0, gradient
the boundary integrand, with y following the edge through ``tri_delta``.
Shared edges move with the mean of their two owners' deltas.

Scope, as in the reference: flat scenes; the NEE visibility boundary at
path vertices 0..max_bounce, later vertices reached by a detached
BSDF-sampled prefix walk. Edges of emissive faces are excluded.

RNG dimensions are the reference's: the prefix walk draws dims 8188 + 97·b
and 8189 + 97·b and the material pick 8190 + 97·b; edge sample k at vertex
b draws from 8192 + 512·b + 8·k. Once ``edge_samples >= 25`` the edge
blocks reach the prefix dims (8188 + 97 = 8285 < 8192 + 8·24 + 2): the
reference's overlap, kept for parity (ROADMAP Queue 3).

Queries go through ``intersect_soa`` / ``occlude_soa``: on the card the
dense kernels at or under 4,096 triangles and the tree walks above.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.distribution import sample_discrete
from ..core.v3 import V3, from_stack, v3where
from ..core.vecmath import abs_, maximum
from ..integrators.path import RAY_EPS, _vertex_data, camera_rays_soa
from ..ops.intersect import intersect_soa, occlude_soa
from ..parallel.render import check_device
from ..scene.arrays import MAT_EMISSIVE, map_tensors
from ..shading import soa


class EdgeTable(NamedTuple):
    """Deduped occluder edge list (host numpy, built once per scene)."""

    a: np.ndarray        # [E, 3] endpoint positions (undisplaced)
    b: np.ndarray        # [E, 3]
    tri1: np.ndarray     # [E] owning storage-triangle id
    tri2: np.ndarray     # [E] second owner or -1 (mesh-boundary edge)
    n1: np.ndarray       # [E, 3] owner-1 geometric normal
    n2: np.ndarray       # [E, 3] owner-2 normal (0 for boundary edges)


def build_edge_table(scene):
    """Enumerate unique occluder edges with face adjacency.

    Interior edges (shared by two faces, matched by exact endpoint
    positions) appear once with both owners; emissive faces contribute no
    edges. SBVH duplicate storage copies are collapsed through
    ``prim_to_orig`` so each physical edge is counted once.
    """
    def host(t, dtype=None):
        a = t.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    v0, e1, e2 = (host(t, np.float64) for t in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    mat = host(scene.mat_id)
    kind = host(scene.materials.kind)
    orig = host(scene.prim_to_orig)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    ngs = np.cross(e1, e2)
    ngs /= np.maximum(np.linalg.norm(ngs, axis=-1, keepdims=True), 1e-30)

    edges = {}
    seen_orig = set()
    for t in range(p0.shape[0]):
        if orig[t] in seen_orig:
            continue  # SBVH duplicate storage copy
        seen_orig.add(orig[t])
        if kind[mat[t]] == MAT_EMISSIVE:
            continue
        corners = (p0[t], p1[t], p2[t])
        for i in range(3):
            pa, pb = corners[i], corners[(i + 1) % 3]
            key = tuple(sorted((tuple(pa), tuple(pb))))
            if key in edges:
                ent = edges[key]
                if ent[2] < 0 and ent[1] != t:
                    edges[key] = (ent[0], ent[1], t)
            else:
                edges[key] = ((pa, pb), t, -1)
    if not edges:
        z = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return EdgeTable(z, z, zi, zi, z, z)
    a, b, t1, t2 = [], [], [], []
    for (pa_pb, tri1, tri2) in edges.values():
        a.append(pa_pb[0])
        b.append(pa_pb[1])
        t1.append(tri1)
        t2.append(tri2)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    t1 = np.asarray(t1, np.int32)
    t2 = np.asarray(t2, np.int32)
    n1 = ngs[t1].astype(np.float32)
    n2 = np.where((t2 >= 0)[:, None], ngs[np.maximum(t2, 0)], 0.0).astype(np.float32)
    return EdgeTable(a, b, t1, t2, n1, n2)


def boundary_direct_term(scene, camera, tri_delta, edge_table, seed=0,
                         edge_samples=4, sample_idx=0):
    """Per-pixel [H*W, 3] boundary surrogate for the FIRST-vertex NEE
    integral (``boundary_term`` at max_bounce=0)."""
    return boundary_term(
        scene, camera, tri_delta, edge_table, seed=seed,
        edge_samples=edge_samples, sample_idx=sample_idx, max_bounce=0,
    )


def boundary_term(scene, camera, tri_delta, edge_table, seed=0,
                  edge_samples=4, sample_idx=0, max_bounce=0):
    """Per-pixel [H*W, 3] boundary surrogate on the scene's device: primal
    ZERO, gradient with respect to ``tri_delta`` [T, 3] the silhouette
    boundary term of the direct lighting seen at path vertices
    0 .. max_bounce (later vertices through a detached BSDF-sampled prefix
    walk, mirror and glass bounces included, weighted by the detached
    throughput). Add it to a rendered image inside a loss; only
    ``tri_delta`` carries a gradient.
    """
    n = camera.width * camera.height
    dev = scene.device
    check_device(tri_delta, dev, "tri_delta")
    n_edges = edge_table.a.shape[0]
    if n_edges == 0 or scene.lights.n_lights == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    scene_d = map_tensors(scene, torch.Tensor.detach)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    smp = torch.full((n,), sample_idx, dtype=torch.int64, device=dev)
    o, d = camera_rays_soa(camera, seed, smp, pix)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    beta = V3(one, one, one)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    for b in range(max_bounce + 1):
        hit = intersect_soa(scene_d, o, d)
        valid = valid & hit.valid
        vd = _vertex_data(scene_d, hit.prim, hit.u, hit.v)
        wo = -d
        u_mix = rng.uniform(seed, pix, smp, 8190 + 97 * b)
        leaf, choice_pdf = soa.select_material(
            scene_d.materials, scene_d.textures, vd["mat_id"], u_mix, vd["uv_u"], vd["uv_v"]
        )
        params = soa.closure_params(
            scene_d.materials, scene_d.textures, leaf, choice_pdf, vd["uv_u"], vd["uv_v"]
        )
        frame = soa.make_frame(vd["ns"])
        acc = acc + _boundary_at_vertex(
            scene_d, vd["p"], vd["ng"], vd["ns"], wo, params, frame, valid, beta,
            tri_delta, edge_table, seed, pix, smp, edge_samples,
            dim_base=8192 + 512 * b,
        )
        if b == max_bounce:
            break
        # detached BSDF-sampled prefix step to the next vertex
        u1 = rng.uniform(seed, pix, smp, 8188 + 97 * b)
        u2 = rng.uniform(seed, pix, smp, 8189 + 97 * b)
        wi, f, pdf = soa.sample_world(params, frame, wo, u1, u2)
        cos_wi = abs_(vd["ns"].dot(wi))
        ok = valid & (params["kind"] != soa.CLOSURE_NULL) & (pdf > 1e-9)
        beta = v3where(ok, beta * f * (cos_wi / maximum(pdf, 1e-9)), beta)
        valid = ok
        o = vd["p"] + wi * (RAY_EPS / maximum(abs_(vd["ng"].dot(wi)), 1e-4))
        d = wi
    return acc


def _rows(table, idx):
    """V3 of the rows ``idx`` of an [R, 3] tensor."""
    return from_stack(table.index_select(0, idx))


def _norm(v):
    return torch.sqrt(v.dot(v))


def _boundary_at_vertex(scene_d, x_pt, ng, ns, wo, params, frame, valid,
                        beta, tri_delta, edge_table, seed, pix, smp,
                        edge_samples, dim_base):
    """Edge-sampled NEE boundary surrogate at ONE path vertex, weighted by
    the detached throughput ``beta``; [N, 3]. Everything but
    ``tri_delta`` is detached."""
    dev = x_pt.x.device
    n = x_pt.x.shape[0]
    n_edges = edge_table.a.shape[0]

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # light data (detached; the light's own motion is an interior term)
    lights = scene_d.lights
    tri = lights.tri_id
    lv0 = scene_d.tri_v0.index_select(0, tri)
    le1 = scene_d.tri_e1.index_select(0, tri)
    le2 = scene_d.tri_e2.index_select(0, tri)
    lng = torch.cross(le1, le2, dim=-1)
    l_area2 = torch.sqrt((lng * lng).sum(-1))
    lng = lng / torch.clamp(l_area2, min=1e-30)[:, None]
    l_eps = 1e-3 * torch.sqrt(torch.clamp(0.5 * l_area2.max(), min=1e-12))
    lmat = scene_d.mat_id.index_select(0, tri)
    l_em = soa.emission_and_sided(scene_d.materials, scene_d.textures, lmat, None, None)[0]
    l_em = l_em.stack()  # [L, 3] (constant-texture emitters)

    # displaced edge endpoints: interior edges move with the mean of their
    # owners' deltas (the symmetric subgradient)
    tri1 = dev_t(edge_table.tri1)
    tri2 = dev_t(edge_table.tri2)
    d1 = tri_delta.index_select(0, tri1)
    d2 = tri_delta.index_select(0, torch.clamp(tri2, min=0))
    delta_e = torch.where((tri2 >= 0)[:, None], 0.5 * (d1 + d2), d1)  # differentiable
    ea = dev_t(edge_table.a) + delta_e
    eb = dev_t(edge_table.b) + delta_e
    en1, en2 = dev_t(edge_table.n1), dev_t(edge_table.n2)

    def shadow_occluded(target):
        wi = target - x_pt
        dist = _norm(wi)
        wi = wi / maximum(dist, 1e-12)
        o_sh = x_pt + wi * (RAY_EPS / maximum(abs_(ng.dot(wi)), 1e-4))
        return occlude_soa(scene_d, o_sh, wi, torch.zeros_like(dist), dist * (1.0 - 1e-3))

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for k in range(edge_samples):
        base = dim_base + 8 * k
        u_e = rng.uniform(seed, pix, smp, base)
        u_s = rng.uniform(seed, pix, smp, base + 1)
        u_l = rng.uniform(seed, pix, smp, base + 2)
        ei = torch.clamp((u_e * n_edges).to(torch.int32), max=n_edges - 1)
        li, _ = sample_discrete(lights.cdf, u_l)

        a_k = _rows(ea, ei)                                  # differentiable
        b_k = _rows(eb, ei)
        q = a_k + (b_k - a_k) * u_s
        n1 = _rows(en1, ei)
        n2 = _rows(en2, ei)
        is_shared = tri2.index_select(0, ei) >= 0

        # silhouette test from x (detached geometry)
        view = V3(*(c.detach() for c in (x_pt - q)))
        silhouette = torch.where(is_shared, n1.dot(view) * n2.dot(view) < 0.0, True)

        # project x->q onto the sampled light's plane (differentiable in q)
        p0l = _rows(lv0, li)
        nl = _rows(lng, li)
        dir_q = q - x_pt
        denom = dir_q.dot(nl)
        safe = torch.where(abs_(denom) < 1e-9, 1e-9, denom)
        t_hit = (p0l - x_pt).dot(nl) / safe
        y = x_pt + dir_q * t_hit
        y_d = V3(y.x.detach(), y.y.detach(), y.z.detach())
        # q must lie strictly between x and the light plane
        between = (t_hit > 1.0 + 1e-4) & (denom != 0.0)

        # y inside the light triangle? (detached barycentrics)
        e1l = _rows(le1, li)
        e2l = _rows(le2, li)
        rel = y_d - p0l
        d11, d12, d22 = e1l.dot(e1l), e1l.dot(e2l), e2l.dot(e2l)
        r1, r2 = rel.dot(e1l), rel.dot(e2l)
        det_b = d11 * d22 - d12 * d12
        bu = (d22 * r1 - d12 * r2) / maximum(det_b, 1e-20)
        bv = (d11 * r2 - d12 * r1) / maximum(det_b, 1e-20)
        inside = (bu > 1e-3) & (bv > 1e-3) & (bu + bv < 1.0 - 1e-3)

        # boundary tangent in the light plane (detached): y = x + t(s) d(s),
        # dy/ds = t dq/ds + d(s) dt/ds, dt/ds = -t (dq/ds . nl) / denom
        with torch.no_grad():
            dq = b_k - a_k
            dt_ds = -t_hit * dq.dot(nl) / safe
            dy_ds = dq * t_hit + dir_q * dt_ds
            dl_ds = _norm(dy_ds)
            tangent = dy_ds / maximum(dl_ds, 1e-12)
            n_perp = nl.cross(tangent)  # in-plane, unit

        # side probes: n_perp must point INTO the blocked region (flip
        # when -n_perp is the blocked side)
        occ_plus = shadow_occluded(y_d + n_perp * l_eps)
        occ_minus = shadow_occluded(y_d - n_perp * l_eps)
        flip = occ_minus & ~occ_plus
        real_boundary = occ_plus ^ occ_minus
        n_perp = v3where(flip, -n_perp, n_perp)

        # direct integrand at the unblocked limit (detached)
        wi_y = y_d - x_pt
        dist2 = maximum(wi_y.dot(wi_y), 1e-12)
        wi_y = wi_y / torch.sqrt(dist2)
        f_val = soa.eval_world(params, frame, wo, wi_y)
        cos_x = abs_(ns.dot(wi_y))
        cos_l = abs_(wi_y.dot(nl))
        le = _rows(l_em, li)
        integrand = f_val * le * (cos_x * cos_l / dist2)

        ok = (valid & silhouette & between & inside & real_boundary
              & (params["kind"] != soa.CLOSURE_NULL))
        # surrogate: primal 0, d/dθ = integrand * (n̂ · dy/dθ) * |dy/ds| * E
        motion = n_perp.dot(y - y_d)
        contrib = beta * integrand * (motion * dl_ds * ok)
        acc = acc + contrib.stack() * (float(n_edges) / edge_samples)
    return acc
