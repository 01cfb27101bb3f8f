"""Wavefront path tracer with NEE + MIS (``akari_tpu/integrators/path.py``).

Per-ray state is ``[N]`` tensors and ``V3`` 3-vectors stepped through a
fixed per-bounce sweep with an ``active`` mask (the wavefront form). The
bounce loop is a Python loop; every bounce-dependent branch is on Python
ints. The math and the order of floating-point operations follow the
reference line for line, so the port draws the same random numbers, hits
the same triangles and agrees in radiance to float32 rounding.

Intersection: with the dense or the tree intersector (flat or two-level
scenes), each bounce answers its shadow ray and its next extension ray in
ONE closest-hit launch of 2N rays (shadow rays bounded by ``t_max``), as
the reference does for every Pallas scene, so a ``trace_paths`` call
launches the kernel exactly ``1 + max_depth`` times.

Environment light: an escaped extension ray adds the environment's
radiance once (MIS-weighted against env NEE), and NEE samples the
area-light / environment mixture (``soa.light_sample_mixed``); env shadow
rays join the same fused launch with ``t_max = 1e7``.

Gradients: radiance is differentiable with respect to the scene's
tensors (texel values, the ``prim_table`` / ``tri_v0`` geometry) under
the detached-hit convention: the queries run under ``torch.no_grad()`` on
detached rays (ops/intersect.py), so no backward launches one. A render
where no input requires a gradient records no graph and makes the same
launches as before. ``PathConfig.remat`` recomputes each bounce's shading
in the backward instead of keeping its intermediates (the reference's
per-bounce ``jax.checkpoint`` that saves only the ``"isect"`` values).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import sampling
from ..core import rng
from ..core.v3 import V3, from_rows, from_stack, v3where
from ..core.vecmath import abs_, clip, maximum, minimum
from ..ops.intersect import T_MAX, intersect_soa, occlude_soa
from ..scene import geom
from ..shading import soa

RAY_EPS = 1e-4
SHADOW_EPS = 1e-3


@dataclass(frozen=True)
class PathConfig:
    """Path-tracer settings; float32 RGB throughout (the bf16 spectrum
    variant arrives with slice 4b).

    mis: True = NEE + MIS; False = NEE only with depth-0 emission (the
    reference renderer's estimator); "bsdf" = BSDF sampling only.
    """

    spp: int = 4
    max_depth: int = 5
    mis: object = True
    ray_clamp: float = 10.0   # firefly clamp on per-sample radiance
    rr_start: int = 100       # russian roulette start depth (off by default)
    # True recomputes each bounce's shading in the backward from the
    # saved hit record and carried state instead of keeping its
    # intermediates (torch.utils.checkpoint per bounce); the intersection
    # queries stay outside the recomputed region, so the backward makes
    # no query. No effect when no gradient is recorded. The port has no
    # ``unroll``: its bounce loop is a Python loop, the unrolled form.
    remat: bool = False


def camera_rays_soa(camera, seed, sample_idx, pixel_idx):
    """Primary rays for flat pixel indices [N] (int64) -> (V3 o, V3 d)."""
    jx = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_CAMERA)
    jy = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_CAMERA + 1)
    w, h = camera.width, camera.height
    x = (pixel_idx % w).to(torch.float32) + jx
    y = torch.div(pixel_idx, w, rounding_mode="floor").to(torch.float32) + jy
    ndc_x = 2.0 * (x / w) - 1.0
    ndc_y = 1.0 - 2.0 * (y / h)  # flip v
    # image-plane scale, rounded to float32 as the reference computes it
    t = np.float32(camera.tan_half_fov)
    if w > h:
        sx, sy = t, t * np.float32(h / w)
    else:
        sx, sy = t * np.float32(w / h), t
    sx, sy = float(sx), float(sy)
    d_cam = V3(ndc_x * sx, ndc_y * sy, -torch.ones_like(ndc_x))
    o_cam = V3(
        torch.zeros_like(ndc_x), torch.zeros_like(ndc_x), torch.zeros_like(ndc_x)
    )

    lens_r = camera.lens_radius
    if lens_r > 0.0:  # thin-lens depth of field
        u1 = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_LENS)
        u2 = rng.uniform(seed, pixel_idx, sample_idx, rng.DIM_LENS + 1)
        px, py = soa.concentric_disk(u1, u2)
        px, py = px * lens_r, py * lens_r
        d_len = torch.sqrt(d_cam.dot(d_cam))
        ft = camera.focal_distance / abs_(d_cam.z / d_len)
        p_focus = d_cam.normalized() * ft
        o_cam = V3(px, py, torch.zeros_like(px))
        d_cam = p_focus - o_cam

    # c2w entries are float32 values; as Python floats they stay exact
    c2w = camera.c2w
    r = [[float(c2w[i, j]) for j in range(3)] for i in range(3)]

    def apply_rot(v):
        return V3(
            r[0][0] * v.x + r[0][1] * v.y + r[0][2] * v.z,
            r[1][0] * v.x + r[1][1] * v.y + r[1][2] * v.z,
            r[2][0] * v.x + r[2][1] * v.y + r[2][2] * v.z,
        )

    o = apply_rot(o_cam) + V3(float(c2w[0, 3]), float(c2w[1, 3]), float(c2w[2, 3]))
    d = apply_rot(d_cam).normalized()
    return o, d


def _vertex_data(scene, prim, bu, bv):
    """Gather all hit-surface attributes for [N] prim ids + [N] barys:
    ONE row gather of ``scene.prim_table`` on a flat scene; on a two-level
    scene, virtual ids decoded and prototype geometry moved to world space
    (scene/geom.py).

    Returns a dict of V3/[N]: p, ng, ns, uv_u, uv_v, mat_id, e1, e2,
    light_pdf (the hit triangle's NEE selection pmf; 0 for non-lights).
    """
    pid = torch.clamp(prim, min=0)
    if scene.instances is None:
        fat = soa.gather_rows_t(scene.prim_table, pid)
        v0, e1, e2 = from_rows(fat, 0), from_rows(fat, 3), from_rows(fat, 6)
        n0, n1, n2 = from_rows(fat, 9), from_rows(fat, 12), from_rows(fat, 15)
        uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = (
            fat[18], fat[19], fat[20], fat[21], fat[22], fat[23]
        )
        mat_id = fat[24].to(torch.int32)
        light_pdf = fat[25]
    else:
        v0, e1, e2 = (from_stack(a) for a in geom.tri_world(scene, pid))
        ns_c = geom.normals_world(scene, pid)  # [N, 3, 3]
        n0, n1, n2 = (from_stack(ns_c[:, c]) for c in range(3))
        uv_c = geom.uvs_of_prim(scene, pid)  # [N, 3, 2]
        uv0u, uv0v = uv_c[:, 0, 0], uv_c[:, 0, 1]
        uv1u, uv1v = uv_c[:, 1, 0], uv_c[:, 1, 1]
        uv2u, uv2v = uv_c[:, 2, 0], uv_c[:, 2, 1]
        mat_id = geom.mat_of_prim(scene, pid)
        li = geom.light_of_prim(scene, pid)
        light_pdf = torch.where(
            li >= 0, scene.lights.pdf.index_select(0, torch.clamp(li, min=0)), 0.0
        )
    p = v0 + e1 * bu + e2 * bv
    ng = e1.cross(e2).normalized(eps=1e-20)
    w0 = 1.0 - bu - bv
    ns = (n0 * w0 + n1 * bu + n2 * bv).normalized(eps=1e-12)
    # fall back to ng for degenerate shading normals
    ns = v3where(ns.dot(ns) > 0.5, ns, ng)
    uv_u = uv0u * w0 + uv1u * bu + uv2u * bv
    uv_v = uv0v * w0 + uv1v * bu + uv2v * bv
    return {
        "p": p, "ng": ng, "ns": ns, "uv_u": uv_u, "uv_v": uv_v,
        "mat_id": mat_id, "e1": e1, "e2": e2, "light_pdf": light_pdf,
    }


def camera_rays(camera, seed, sample_idx, pixel_idx):
    """AoS primary rays ([N, 3] o, [N, 3] d) for the BDPT and AO integrators."""
    o, d = camera_rays_soa(camera, seed, sample_idx, pixel_idx)
    return o.stack(), d.stack()


def _surface_data(scene, prim, bary):
    """Hit attributes as the AoS 5-tuple (p, ng, ns, uv, mat_id) for the
    BDPT and AO integrators; ``bary`` is [N, 2]."""
    vd = _vertex_data(scene, prim, bary[..., 0], bary[..., 1])
    uv = torch.stack([vd["uv_u"], vd["uv_v"]], dim=-1)
    return vd["p"].stack(), vd["ng"].stack(), vd["ns"].stack(), uv, vd["mat_id"]


def _intersectors(scene):
    """AoS adapters over ``intersect_soa`` / ``occlude_soa`` for the BDPT
    and AO integrators: ``intersect_fn(o, d) -> (t, prim, bary [N, 2],
    valid)`` and ``occlude_fn(o, d, t_min, t_max) -> occluded`` on [N, 3]
    rays, through the scene's intersector (its kernels on CUDA tensors)."""

    def intersect_fn(o, d):
        h = intersect_soa(scene, from_stack(o), from_stack(d))
        return h.t, h.prim, torch.stack([h.u, h.v], dim=-1), h.valid

    def occlude_fn(o, d, t_min, t_max):
        return occlude_soa(scene, from_stack(o), from_stack(d), t_min, t_max)

    return intersect_fn, occlude_fn


def _intersectors_soa(scene):
    """(intersect_fn, occlude_fn, fused_fn) for the scene's intersector.

    ``fused_fn`` answers a bounce's shadow rays and its extension rays in
    a single closest-hit query (dense and tree intersectors, two-level
    scenes included)."""

    def intersect_fn(o, d):
        h = intersect_soa(scene, o, d)
        return h.t, h.prim, h.u, h.v, h.valid

    def occlude_fn(o, d, t_min, t_max):
        return occlude_soa(scene, o, d, t_min, t_max)

    fused_fn = None
    if scene.intersector in ("dense", "tree"):
        def fused_fn(shadow_o, shadow_d, shadow_tmax, o2, d2, ext_tmax):
            n = o2.x.shape[0]
            cat = torch.cat
            o = V3(*(cat([a, b]) for a, b in zip(shadow_o, o2)))
            d = V3(*(cat([a, b]) for a, b in zip(shadow_d, d2)))
            t_max = cat([shadow_tmax, ext_tmax])
            h = intersect_soa(scene, o, d, t_max=t_max)
            occluded = h.valid[:n]
            hit = (h.t[n:], h.prim[n:], h.u[n:], h.v[n:], h.valid[n:])
            return occluded, hit

    return intersect_fn, occlude_fn, fused_fn


def trace_paths(scene, camera, cfg, seed, sample_idx, pixel_idx,
                intersectors=None):
    """Trace one sample per pixel; returns [N, 3] radiance, differentiable
    with respect to the scene's tensors that require a gradient.

    ``pixel_idx`` and ``sample_idx`` are int64 tensors on the scene's
    device (values in [0, 2^32)); ``intersectors`` defaults to
    ``_intersectors_soa(scene)``.
    """
    intersect_fn, occlude_fn, fused_fn = (
        intersectors if intersectors is not None else _intersectors_soa(scene)
    )
    o, d = camera_rays_soa(camera, seed, sample_idx, pixel_idx)
    n = o.x.shape[0]
    dev = o.x.device
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    L = V3(zero, zero, zero)
    beta = V3(one, one, one)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)

    hit = intersect_fn(o, d)
    state = (hit, o, d, L, beta, active, prev_pdf)
    for bounce in range(cfg.max_depth):
        state = _bounce_step(
            scene, cfg, seed, sample_idx, pixel_idx, state, bounce,
            intersect_fn, occlude_fn, fused_fn,
        )
    L = _emission_term(scene, cfg, state, cfg.max_depth)

    Ls = L.stack()
    if cfg.ray_clamp > 0.0:
        Ls = minimum(Ls, cfg.ray_clamp)
    # kill NaN/Inf lanes defensively
    return torch.where(torch.isfinite(Ls), Ls, 0.0)


def _emission_term(scene, cfg, state, bounce, vd=None):
    """Add this vertex's (MIS-weighted) emission to L and return it, plus
    the environment radiance on lanes whose extension ray escaped (once
    per path: ``active`` still holds the pre-miss liveness here)."""
    (t, prim, bu, bv, valid), o, d, L, beta, active, prev_pdf = state
    has_env = scene.env_image is not None
    if has_env:
        escaped = active & ~valid
    active = active & valid
    if vd is None:
        vd = _vertex_data(scene, prim, bu, bv)
    Le, double_sided = soa.emission_and_sided(
        scene.materials, scene.textures, vd["mat_id"], vd["uv_u"], vd["uv_v"]
    )
    front = d.dot(vd["ng"]) < 0.0
    emit_ok = double_sided | front
    ones = torch.ones_like(t)
    if cfg.mis == "bsdf" or bounce == 0:
        w_emit = ones
    elif cfg.mis:
        nee_pdf = soa.light_pdf_direction_from(
            vd["e1"], vd["e2"], vd["light_pdf"], valid, d, t, double_sided
        )
        if has_env:
            # NEE is a strategy mixture when an env light exists
            nee_pdf = nee_pdf * (1.0 - scene.env_p_select)
        w_emit = sampling.power_heuristic(prev_pdf, nee_pdf)
    else:
        w_emit = torch.zeros_like(t)
    L = L + beta * Le * ((active & emit_ok) * w_emit)
    if has_env:
        Le_env = soa.env_eval(scene, d)
        if cfg.mis == "bsdf" or bounce == 0:
            w_env = ones
        elif cfg.mis:
            env_nee = soa.env_pdf_sa(scene, d) * scene.env_p_select
            w_env = sampling.power_heuristic(prev_pdf, env_nee)
        else:
            w_env = torch.zeros_like(t)
        L = L + beta * Le_env * (escaped * w_env)
    return L


def _tensors(obj):
    """Every tensor inside nested tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for x in obj:
            yield from _tensors(x)
    elif is_dataclass(obj):
        for f in fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _records_gradient(scene, state):
    """Whether autograd records this bounce: grad mode is on and a scene
    tensor or a carried state tensor requires a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors((scene, state))
    )


def _bounce_step(scene, cfg, seed, sample_idx, pixel_idx, state, bounce,
                 intersect_fn, occlude_fn, fused_fn):
    """One full path-vertex step: emission + NEE + BSDF sample + next hit.

    The shading half (``_shade_vertex``) is the differentiable work; under
    ``cfg.remat`` with a gradient recorded it runs inside a checkpoint, so
    the backward recomputes it from the saved hit record and carried
    state. The queries and the NEE join stay outside, and the backward
    makes no query.
    """
    do_nee = (
        scene.lights.n_lights > 0 or scene.env_image is not None
    ) and cfg.mis != "bsdf"
    shade = partial(_shade_vertex, scene, cfg, seed, sample_idx, pixel_idx,
                    bounce=bounce, do_nee=do_nee)
    if cfg.remat and _records_gradient(scene, state):
        # the RNG is a hash of (seed, pixel, sample, dim): recomputation
        # draws the same numbers without saving torch's RNG state
        shaded = checkpoint(shade, state, use_reentrant=False, preserve_rng_state=False)
    else:
        shaded = shade(state)
    L, beta, ok, pdf, o, d, ext_tmax, nee = shaded

    # ---- shadow + next extension rays (one fused launch if possible) ----
    if do_nee:
        shadow_o, shadow_d, shadow_tmax, nee_contrib, useful, w_nee = nee
    if do_nee and fused_fn is not None:
        occluded, hit = fused_fn(shadow_o, shadow_d, shadow_tmax, o, d, ext_tmax)
    else:
        if do_nee:
            occluded = occlude_fn(
                shadow_o, shadow_d, torch.zeros_like(shadow_tmax), shadow_tmax
            )
        hit = intersect_fn(o, d)
    if do_nee:
        L = L + nee_contrib * ((useful & ~occluded) * w_nee)
    return (hit, o, d, L, beta, ok, pdf)


def _shade_vertex(scene, cfg, seed, sample_idx, pixel_idx, state, *, bounce, do_nee):
    """The shading half of ``_bounce_step``: emission, material walk, NEE
    setup, BSDF sample and the next rays. Returns (L, beta, ok, pdf, o, d,
    ext_tmax, nee) with nee = (shadow_o, shadow_d, shadow_tmax,
    nee_contrib, useful, w_nee), or None without NEE."""
    (t, prim, bu, bv, valid), o, d, _, beta, active, prev_pdf = state
    vd = _vertex_data(scene, prim, bu, bv)
    L = _emission_term(scene, cfg, state, bounce, vd=vd)
    active = active & valid
    p, ng, ns = vd["p"], vd["ng"], vd["ns"]
    wo = -d

    # ---- material selection + closure ----
    u_mix = rng.uniform(seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_MIX))
    leaf, choice_pdf = soa.select_material(
        scene.materials, scene.textures, vd["mat_id"], u_mix,
        vd["uv_u"], vd["uv_v"],
    )
    params = soa.closure_params(
        scene.materials, scene.textures, leaf, choice_pdf,
        vd["uv_u"], vd["uv_v"],
    )
    frame = soa.make_frame(ns)
    scatterable = active & (params["kind"] != soa.CLOSURE_NULL)

    # ---- next-event estimation setup ----
    nee = None
    if do_nee:
        u_sel = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_SELECT)
        )
        u_p1 = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_U)
        )
        u_p2 = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_LIGHT_U) + 1
        )
        ls = soa.light_sample_mixed(scene, u_sel, u_p1, u_p2, p)
        f_nee = soa.eval_world(params, frame, wo, ls.wi)
        cos_nee = abs_(ns.dot(ls.wi))
        contrib_scale = torch.where(
            ls.pdf > 1e-12, 1.0 / maximum(ls.pdf, 1e-12), 0.0
        )
        nee_contrib = beta * f_nee * ls.L * (cos_nee * contrib_scale)
        useful = scatterable & ls.valid & (nee_contrib.max_comp() > 0.0)
        shadow_o = p + ls.wi * (
            RAY_EPS / maximum(abs_(ng.dot(ls.wi)), 1e-4)
        )
        shadow_tmax = ls.dist * (1.0 - SHADOW_EPS)
        if cfg.mis:
            pdf_bsdf_nee = soa.pdf_world(params, frame, wo, ls.wi)
            w_nee = sampling.power_heuristic(ls.pdf, pdf_bsdf_nee)
        else:
            w_nee = torch.ones_like(t)
        # Inactive lanes get t_max = 0 ("dead rays"): their results are
        # masked out by the join anyway.
        shadow_tmax = torch.where(useful, shadow_tmax, 0.0)
        nee = (shadow_o, ls.wi, shadow_tmax, nee_contrib, useful, w_nee)

    # ---- BSDF sampling ----
    u_b1 = rng.uniform(
        seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_BSDF_U)
    )
    u_b2 = rng.uniform(
        seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_BSDF_U) + 1
    )
    wi, f, pdf = soa.sample_world(params, frame, wo, u_b1, u_b2)
    cos_wi = abs_(ns.dot(wi))
    ok = scatterable & (pdf > 1e-9)
    throughput = f * (cos_wi / maximum(pdf, 1e-9))
    beta = v3where(ok, beta * throughput, beta)

    # russian roulette (off by default)
    if cfg.rr_start < cfg.max_depth and bounce >= cfg.rr_start:
        u_rr = rng.uniform(
            seed, pixel_idx, sample_idx, rng.bounce_dim(bounce, rng.OFF_RR)
        )
        q = clip(beta.max_comp(), 0.05, 1.0)
        beta = beta * (1.0 / q)
        ok = ok & (u_rr < q)

    o = p + wi * (RAY_EPS / maximum(abs_(ng.dot(wi)), 1e-4))
    ext_tmax = torch.where(ok, T_MAX, 0.0)
    return L, beta, ok, pdf, o, wi, ext_tmax, nee


# Max rays in one wavefront: bounds the live per-ray state while keeping
# launches large.
MAX_RAYS_IN_FLIGHT = 1 << 22


def trace_accumulate(scene, camera, cfg, seed, base_pixel_idx, sample_offset=0):
    """Mean radiance over cfg.spp samples for the given pixel ids [B].

    Samples are folded into the ray axis (spp_chunk * B rays per
    wavefront) up to MAX_RAYS_IN_FLIGHT, then looped over chunks, exactly
    as the reference folds them.
    """
    n = base_pixel_idx.shape[0]
    dev = base_pixel_idx.device
    chunk = max(1, min(cfg.spp, MAX_RAYS_IN_FLIGHT // max(n, 1)))
    n_chunks = (cfg.spp + chunk - 1) // chunk
    pixel_idx = base_pixel_idx.to(torch.int64).repeat(chunk)
    sample_off = torch.repeat_interleave(
        torch.arange(chunk, dtype=torch.int64, device=dev), n
    )
    intersectors = _intersectors_soa(scene)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    count = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        sample_idx = sample_off + (c * chunk + sample_offset)
        li = trace_paths(
            scene, camera, cfg, seed, sample_idx, pixel_idx, intersectors
        )
        # only samples < offset+spp contribute (last chunk may be partial)
        w = (sample_idx < sample_offset + cfg.spp).to(torch.float32)[:, None]
        acc = acc + (li * w).reshape(chunk, n, 3).sum(dim=0)
        count = count + w.reshape(chunk, n, 1).sum(dim=0)
    return acc / maximum(count, 1.0)


def render(scene, camera, cfg, seed=0, sample_offset=0):
    """Full render on the scene's device: [H, W, 3] mean radiance."""
    n = camera.width * camera.height
    img = trace_accumulate(
        scene, camera, cfg, seed,
        torch.arange(n, dtype=torch.int64, device=scene.device),
        sample_offset=sample_offset,
    )
    return img.reshape(camera.height, camera.width, 3)
