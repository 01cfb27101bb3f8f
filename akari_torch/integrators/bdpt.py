"""Bidirectional path tracer (``akari_tpu/integrators/bdpt.py``).

For every pixel sample an eye subpath and a light subpath are traced with
the same masked wavefront sweeps as the path tracer, into vertex tapes
(here: per key, a list of one ``[N, ...]`` tensor per vertex). Every
connection strategy (light vertex s >= 1 or the light point s = 0, eye
vertex t >= 1), the s = 0 strategy (the eye path hits an emitter) and,
for pinhole cameras, light tracing (t = 1: each light vertex connected to
the camera and splatted to the pixel it projects to) are weighted by the
balance heuristic over the strategies of each path length, with the
reverse pdfs at the connection recomputed and delta (mirror / glass)
vertices handled by remap0. Environment light enters through escaped eye
segments only (its MIS weight is 1).

Queries: ``eye_depth`` closest-hit launches for the eye subpath and
``light_depth - 1`` for the light subpath (its vertex 0 is sampled on the
light), then every connection and splat visibility ray of the sample is
queued and answered by one any-hit launch per group of at most
``BDPT_OCC_CHUNK_RAYS`` rays (``eye_depth * light_depth + light_depth``
entries of N rays). The splat is an ``index_add_`` into the film; on the
card its atomics' order, and so its rounding, varies from run to run.

The arithmetic follows the reference line for line; where it multiplies a
[N, 3] point by the camera rotation (``_camera_connect``) the port writes
the products and sums out in float32 (``_rotate_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import sampling
from ..core import rng
from ..core.distribution import sample_discrete
from ..core.v3 import V3
from ..core.vecmath import (
    abs_,
    cross,
    dot,
    maximum,
    minimum,
    normalize,
    onb,
    to_world,
)
from ..scene import geom
from ..shading import bsdf as bsdf_mod
from ..shading import light as light_mod
from ..shading import material as mat_mod
from ..shading import soa
from .path import RAY_EPS, SHADOW_EPS, _intersectors, _surface_data, camera_rays

# RNG dimension plan: the eye subpath uses the per-bounce dims
# (rng.bounce_dim); the light subpath draws from a disjoint high range.
LIGHT_DIMS_BASE = 4096
OFF_L_POS = 0      # light point (2) + light select (1)
OFF_L_DIR = 3      # emission direction (2)
OFF_L_BSDF = 5     # per-bounce bsdf u (2)

# Cap on rays per connection-visibility launch: bounds the queued shadow
# rays' transient memory while fusing ~16 strategies per launch at 256^2.
BDPT_OCC_CHUNK_RAYS = 1 << 20


@dataclass(frozen=True)
class BDPTConfig:
    spp: int = 4
    eye_depth: int = 4    # max eye surface vertices (tape depth)
    light_depth: int = 3  # max light subpath vertices (tape depth)
    ray_clamp: float = 20.0
    # Cap on total surface vertices per path (0 = no cap beyond the tape
    # depths); applies to whole path lengths, so MIS needs no adjustment.
    max_vertices: int = 0
    # Light tracing: connect light-subpath vertices to the camera and
    # splat (t = 1 strategies). Off for thin-lens cameras.
    light_tracing: bool = True


_F32 = torch.float32


def _vertex_tape(n, depth, device):
    """Tape of one subpath: for every key a list of ``depth`` [n(, c)]
    tensors, the reference's [n, depth(, c)] arrays split by vertex.
    Unset entries share one zero (or -1 / False) tensor per kind."""
    def z(*sh):
        return torch.zeros((n,) + sh, dtype=_F32, device=device)

    zero3, zero2, zero = z(3), z(2), z()
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=device)
    false = torch.zeros((n,), dtype=torch.bool, device=device)
    izero = torch.zeros((n,), dtype=torch.int32, device=device)
    return {
        "p": [zero3] * depth,           # position
        "ns": [zero3] * depth,          # shading normal
        "ng": [zero3] * depth,          # geometric normal
        "wo": [zero3] * depth,          # direction toward the previous vertex
        "beta": [zero3] * depth,        # throughput up to this vertex
        "kind": [minus1] * depth,       # closure kind
        "color": [zero3] * depth,
        "alpha": [zero] * depth,
        "choice_pdf": [zero] * depth,
        "pdf_fwd": [zero] * depth,      # area pdf of generating this vertex
        "pdf_rev": [zero] * depth,      # area pdf of the reverse walk
        "valid": [false] * depth,
        "uv": [zero2] * depth,          # texture coordinates
        "mat_id": [izero] * depth,
        "prim": [minus1] * depth,
        # Dirac (mirror / glass) vertex: not connectible; its fwd / rev
        # pdfs count as 1 in the MIS ratios (remap0)
        "delta": [false] * depth,
    }


def _set(tape, i, **kv):
    for k, v in kv.items():
        tape[k][i] = v
    return tape


def _film_plane(camera):
    """Half-extents (sx, sy) of the film plane at unit depth, rounded to
    float32 as the reference's ``camera_rays`` computes them."""
    t = np.float32(camera.tan_half_fov)
    w, h = camera.width, camera.height
    if w > h:
        return t, t * np.float32(h / w)
    return t * np.float32(w / h), t


def _film_area(camera):
    """4 sx sy as a Python float holding the float32 product."""
    sx, sy = _film_plane(camera)
    return float(np.float32(4.0) * sx * sy)


def _sub_point(p, c):
    """[N, 3] p minus the host point c (three floats)."""
    return torch.stack([p[..., 0] - c[0], p[..., 1] - c[1], p[..., 2] - c[2]], dim=-1)


def _point_sub(c, p):
    """The host point c minus [N, 3] p."""
    return torch.stack([c[0] - p[..., 0], c[1] - p[..., 1], c[2] - p[..., 2]], dim=-1)


def _rotate_rows(q, rot):
    """q @ rot for [N, 3] q and a host 3x3 rot, as float32 products summed
    in k order (one device op each, so no contraction into FMAs)."""
    cols = [
        q[..., 0] * rot[0][j] + q[..., 1] * rot[1][j] + q[..., 2] * rot[2][j]
        for j in range(3)
    ]
    return torch.stack(cols, dim=-1)


def _camera_frame(camera):
    """(rotation rows, origin, forward axis) of the camera as Python floats
    holding float32 values."""
    c2w = np.asarray(camera.c2w, np.float32)
    rot = [[float(c2w[i, j]) for j in range(3)] for i in range(3)]
    cam_o = [float(c2w[i, 3]) for i in range(3)]
    fwd = [float(-c2w[i, 2]) for i in range(3)]
    return rot, cam_o, fwd


def _camera_ray_pdf_dir(camera, d):
    """Solid-angle pdf of the camera sampling world direction ``d`` (unit):
    1 / (A cos^3 theta), A the film area at unit depth. The eye subpath's
    vertex-0 forward pdf, so MIS can weigh t = 1 against camera sampling."""
    _, _, fwd = _camera_frame(camera)
    cos_t = maximum(d[..., 0] * fwd[0] + d[..., 1] * fwd[1] + d[..., 2] * fwd[2], 1e-6)
    return 1.0 / (_film_area(camera) * cos_t * cos_t * cos_t)


def _camera_connect(camera, p):
    """Project world points [N, 3] to the pinhole camera.

    Returns (w_to_cam, dist, pix, in_frustum, We, pdf_dir, cos_cam, cam_o):
    w_to_cam [N, 3] unit direction point -> camera; pix [N] int64 flat film
    pixel (clipped; gate on in_frustum); We = importance 1 / (A cos^4);
    pdf_dir = camera direction pdf toward p; cos_cam = cos(view axis,
    direction to p); cam_o the camera position (three floats).
    """
    rot, cam_o, _ = _camera_frame(camera)
    v = _point_sub(cam_o, p)
    d2 = maximum(dot(v, v), 1e-12)
    dist = torch.sqrt(d2)
    w_to_cam = v / dist[..., None]
    d_cam = _rotate_rows(_sub_point(p, cam_o), rot)  # R^T (p - cam_o)
    z = -d_cam[..., 2]
    safe_z = maximum(z, 1e-8)
    sx, sy = (float(x) for x in _film_plane(camera))
    ndc_x = d_cam[..., 0] / safe_z / sx
    ndc_y = d_cam[..., 1] / safe_z / sy
    in_frustum = (z > 1e-6) & (abs_(ndc_x) < 1.0) & (abs_(ndc_y) < 1.0)
    w, h = camera.width, camera.height
    px = torch.clamp(((ndc_x + 1.0) * 0.5 * w).to(torch.int32), 0, w - 1)
    py = torch.clamp(((1.0 - ndc_y) * 0.5 * h).to(torch.int32), 0, h - 1)
    pix = (py * w + px).to(torch.int64)
    cos_cam = safe_z / torch.sqrt(maximum(dot(d_cam, d_cam), 1e-16))
    area = _film_area(camera)
    cos2 = cos_cam * cos_cam
    we = 1.0 / (area * cos2 * cos2)
    pdf_dir = 1.0 / (area * cos_cam * cos2)
    return w_to_cam, dist, pix, in_frustum, we, pdf_dir, cos_cam, cam_o


def _t1_enabled(scene, camera, cfg):
    """t = 1 strategies are active (metadata only)."""
    return (
        cfg.light_tracing
        and camera.lens_radius == 0.0
        and scene.lights.n_lights > 0
        and cfg.light_depth > 0
    )


def _geo_term(pa, na, pb, nb):
    """|cos a||cos b| / d^2, the unit direction a -> b, the distance."""
    w = pb - pa
    d2 = maximum(dot(w, w), 1e-12)
    dist = torch.sqrt(d2)
    wn = w / dist[..., None]
    cos_a = abs_(dot(na, wn))
    cos_b = abs_(dot(nb, -wn))
    return cos_a * cos_b / d2, wn, dist, cos_a, cos_b


def _sa_to_area_w(pdf_sa, w, n_to):
    """Solid-angle pdf -> area pdf at the end of the segment w."""
    d2 = maximum(dot(w, w), 1e-12)
    wn = w / torch.sqrt(d2)[..., None]
    return pdf_sa * abs_(dot(n_to, wn)) / d2


def _sa_to_area(pdf_sa, p_from, p_to, n_to):
    """Solid-angle pdf at p_from -> area pdf at p_to."""
    return _sa_to_area_w(pdf_sa, p_to - p_from, n_to)


def _is_delta_kind(kind):
    return (kind == bsdf_mod.CLOSURE_SPECULAR) | (kind == bsdf_mod.CLOSURE_GLASS)


def _advance(params, frame, ns, ng, p, wo, u_b, active, beta):
    """Sample the continuation at a vertex: (wi, pdf, the reverse
    solid-angle pdf of wo from wi, the new throughput, ok, next origin)."""
    wi, f, pdf = bsdf_mod.sample_world(params, frame, wo, u_b)
    pdf_rev_sa = bsdf_mod.pdf_world(params, frame, wi, wo)
    cos_wi = abs_(dot(ns, wi))
    ok = active & (params["kind"] != bsdf_mod.CLOSURE_NULL) & (pdf > 1e-9)
    beta = torch.where(
        ok[..., None], beta * f * (cos_wi / maximum(pdf, 1e-9))[..., None], beta
    )
    o = p + wi * (RAY_EPS / maximum(abs_(dot(ng, wi)), 1e-4))[..., None]
    return wi, pdf, pdf_rev_sa, beta, ok, o


def _trace_eye_subpath(scene, camera, cfg, seed, sample_idx, pixel_idx, intersect_fn):
    """Trace the eye subpath into a tape of depth cfg.eye_depth.

    Returns (tape, L_env): escaped segments add the environment radiance
    times the running throughput (escape is the only strategy that makes
    env paths, so its MIS weight is 1)."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    depth = cfg.eye_depth
    tape = _vertex_tape(n, depth, dev)
    has_env = scene.env_image is not None
    L_env = torch.zeros((n, 3), dtype=_F32, device=dev)

    o, d = camera_rays(camera, seed, sample_idx, pixel_idx)
    beta = torch.ones((n, 3), dtype=_F32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    # vertex-0 forward pdf = the camera direction pdf (consumed by MIS only
    # when t = 1 strategies are in the set)
    pdf_dir = _camera_ray_pdf_dir(camera, d)
    prev_p = o
    prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)

    for t in range(depth):
        _, prim, bary, valid = intersect_fn(o, d)
        if has_env:
            escaped = active & ~valid
            Le_env = soa.env_eval(scene, V3(d[..., 0], d[..., 1], d[..., 2])).stack()
            L_env = L_env + beta * Le_env * escaped[..., None]
        active = active & valid
        p, ng, ns, uv, mat_id = _surface_data(scene, prim, bary)
        wo = -d

        u_mix = rng.uniform(seed, pixel_idx, sample_idx, rng.bounce_dim(t, rng.OFF_MIX))
        leaf, choice_pdf = mat_mod.select_material(
            scene.materials, scene.textures, mat_id, u_mix, uv
        )
        params = mat_mod.closure_params(
            scene.materials, scene.textures, leaf, choice_pdf, uv
        )
        # area pdf of this vertex from the previous one (0, remapped to 1
        # in MIS, after a delta lobe)
        pdf_area = torch.where(prev_delta, 0.0, _sa_to_area(pdf_dir, prev_p, p, ns))
        _set(
            tape, t,
            p=p, ns=ns, ng=ng, wo=wo, beta=beta,
            kind=params["kind"], color=params["color"], alpha=params["alpha"],
            choice_pdf=params["choice_pdf"], pdf_fwd=pdf_area,
            valid=active, uv=uv, mat_id=mat_id,
            prim=torch.where(active, prim, -1),
            delta=_is_delta_kind(params["kind"]),
        )

        frame = bsdf_mod.make_frame(ns)
        u_b = rng.uniform2(seed, pixel_idx, sample_idx, rng.bounce_dim(t, rng.OFF_BSDF_U))
        wi, pdf, pdf_rev_sa, beta, ok, o = _advance(
            params, frame, ns, ng, p, wo, u_b, active, beta)
        # reverse pdf of the PREVIOUS vertex: pdf of sampling wo from wi
        if t > 0:
            tape["pdf_rev"][t - 1] = _sa_to_area(
                pdf_rev_sa, p, tape["p"][t - 1], tape["ns"][t - 1])
        prev_p = p
        prev_delta = _is_delta_kind(params["kind"])
        d = wi
        pdf_dir = pdf
        active = ok

    return tape, L_env


def _sample_light_origin(scene, seed, sample_idx, pixel_idx):
    """A point on a light: (p, ng, Le, area pdf, prim)."""
    u_sel = rng.uniform(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_POS + 2)
    u_pos = rng.uniform2(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_POS)
    li, sel_pdf = sample_discrete(scene.lights.cdf, u_sel)
    tri = scene.lights.tri_id.index_select(0, li)
    v0, e1, e2 = geom.tri_world(scene, tri)
    ng_raw = cross(e1, e2)
    area2 = torch.sqrt(maximum(dot(ng_raw, ng_raw), 1e-20))
    ng = ng_raw / area2[..., None]
    area = 0.5 * area2
    b = sampling.uniform_triangle(u_pos)
    p = v0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
    mat_id = geom.mat_of_prim(scene, tri)
    uvs = geom.uvs_of_prim(scene, tri)
    b0 = 1.0 - b[..., 0:1] - b[..., 1:2]
    uv = uvs[:, 0] * b0 + uvs[:, 1] * b[..., 0:1] + uvs[:, 2] * b[..., 1:2]
    Le = mat_mod.emission(scene.materials, scene.textures, mat_id, uv)
    pdf_area = sel_pdf / maximum(area, 1e-12)
    return p, ng, Le, pdf_area, tri


def _trace_light_subpath(scene, cfg, seed, sample_idx, pixel_idx, intersect_fn):
    """Trace the light subpath; vertex 0 is the point on the light."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    depth = cfg.light_depth
    tape = _vertex_tape(n, depth, dev)
    if scene.lights.n_lights == 0 or depth == 0:
        return tape

    p0, ng0, Le, pdf_a0, tri0 = _sample_light_origin(scene, seed, sample_idx, pixel_idx)
    # vertex 0: on the light; beta = Le / pdf_area (direction factors follow)
    beta0 = Le / pdf_a0[..., None]
    _set(
        tape, 0,
        p=p0, ns=ng0, ng=ng0, wo=ng0, beta=beta0,
        kind=torch.full((n,), bsdf_mod.CLOSURE_NULL, dtype=torch.int32, device=dev),
        pdf_fwd=pdf_a0,
        valid=torch.amax(Le, dim=-1) > 0,
        prim=tri0,
    )

    # emission direction: cosine-weighted about the light normal
    u_dir = rng.uniform2(seed, pixel_idx, sample_idx, LIGHT_DIMS_BASE + OFF_L_DIR)
    w_local = sampling.cosine_hemisphere(u_dir)
    t0, b0v = onb(ng0)
    d = to_world(t0, b0v, ng0, w_local)
    cos0 = abs_(dot(ng0, d))
    pdf_dir = sampling.cosine_hemisphere_pdf(maximum(cos0, 1e-9))
    beta = beta0 * (cos0 / maximum(pdf_dir, 1e-9))[..., None]
    o = p0 + d * (RAY_EPS / maximum(cos0, 1e-4))[..., None]
    active = tape["valid"][0]
    prev_p = p0
    prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)

    for s in range(1, depth):
        _, prim, bary, valid = intersect_fn(o, d)
        active = active & valid
        p, ng, ns, uv, mat_id = _surface_data(scene, prim, bary)
        wo = -d

        dim = LIGHT_DIMS_BASE + OFF_L_BSDF + s * 4
        u_mix = rng.uniform(seed, pixel_idx, sample_idx, dim + 2)
        leaf, choice_pdf = mat_mod.select_material(
            scene.materials, scene.textures, mat_id, u_mix, uv
        )
        params = mat_mod.closure_params(
            scene.materials, scene.textures, leaf, choice_pdf, uv
        )
        pdf_area = torch.where(prev_delta, 0.0, _sa_to_area(pdf_dir, prev_p, p, ns))
        _set(
            tape, s,
            p=p, ns=ns, ng=ng, wo=wo, beta=beta,
            kind=params["kind"], color=params["color"], alpha=params["alpha"],
            choice_pdf=params["choice_pdf"], pdf_fwd=pdf_area,
            valid=active, uv=uv, mat_id=mat_id,
            prim=torch.where(active, prim, -1),
            delta=_is_delta_kind(params["kind"]),
        )

        frame = bsdf_mod.make_frame(ns)
        u_b = rng.uniform2(seed, pixel_idx, sample_idx, dim)
        wi, pdf, pdf_rev_sa, beta, ok, o = _advance(
            params, frame, ns, ng, p, wo, u_b, active, beta)
        tape["pdf_rev"][s - 1] = _sa_to_area(
            pdf_rev_sa, p, tape["p"][s - 1], tape["ns"][s - 1])
        prev_p = p
        prev_delta = _is_delta_kind(params["kind"])
        d = wi
        pdf_dir = pdf
        active = ok

    return tape


def _params_at(tape, i):
    kind = tape["kind"][i]
    return {
        "kind": kind,
        "color": tape["color"][i],
        "alpha": tape["alpha"][i],
        "dist": kind * 0,  # GGX == 0
        "choice_pdf": tape["choice_pdf"][i],
    }


def _remap0(x):
    """pbrt's remap0: a 0 pdf counts as 1 in the MIS ratios. Delta
    vertices record fwd / rev = 0, so their densities cancel; the
    strategies that would connect at them are excluded by the delta flags."""
    return torch.where(x > 0.0, x, 1.0)


def _connectible(tape, k):
    """The split after tape index k exists: neither endpoint is a delta
    vertex."""
    can = ~tape["delta"][k]
    if k >= 1:
        can = can & ~tape["delta"][k - 1]
    return can


def _mis_weight(eye, light, s, t, rev_e_t, rev_e_tm1, rev_l_s, rev_l_sm1,
                max_light_depth, t1=False):
    """Balance-heuristic weight of connection strategy (s, t): the r_i
    recurrence walked outward from the connection (Veach; pbrt's
    MISWeight), over the alternatives with at least one eye vertex (or the
    t = 1 splat when ``t1``) and at most max_light_depth light vertices.
    rev_e_t / rev_e_tm1 / rev_l_s / rev_l_sm1 are the reverse area pdfs of
    the four vertices next to the connection, recomputed for it."""
    sum_ri = torch.zeros_like(rev_e_t)
    max_eye_depth = len(eye["pdf_fwd"])

    # eye-ward: the connection moves past eye index k (k = t .. 1, and 0
    # for the t = 1 splat), leaving k eye and s + (t - k) + 2 light vertices
    ri = torch.ones_like(rev_e_t)
    for k in range(t, -1 if t1 else 0, -1):
        rev = rev_e_t if k == t else (rev_e_tm1 if k == t - 1 else eye["pdf_rev"][k])
        ri = ri * (_remap0(rev) / _remap0(eye["pdf_fwd"][k]))
        if s + (t - k) + 2 <= max_light_depth:
            sum_ri = sum_ri + torch.where(_connectible(eye, k), ri, 0.0)

    # light-ward: the connection moves past light index k (k = s .. 0; 0 is
    # the pure eye hit), leaving k light and t + (s - k) + 2 eye vertices
    ri = torch.ones_like(rev_e_t)
    for k in range(s, -1, -1):
        rev = rev_l_s if k == s else (rev_l_sm1 if k == s - 1 else light["pdf_rev"][k])
        ri = ri * (_remap0(rev) / _remap0(light["pdf_fwd"][k]))
        if t + (s - k) + 2 <= max_eye_depth:
            sum_ri = sum_ri + torch.where(_connectible(light, k), ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


def _mis_weight_s0(eye, t, pdf_light_area, pdf_emit_tm1, max_light_depth, t1=False):
    """Weight of the s = 0 strategy (the eye path hits the light at eye
    index t). pdf_light_area: area pdf of sampling the hit point on the
    light; pdf_emit_tm1: area pdf of eye vertex t-1 generated from the
    light point by emission-direction sampling."""
    sum_ri = torch.zeros_like(pdf_light_area)
    ri = torch.ones_like(pdf_light_area)
    # after moving past eye index k: (t - k + 1) light vertices, k eye
    # vertices (k = 0, the camera splat, only when t1)
    for k in range(t, -1 if t1 else 0, -1):
        if k == t:
            rev = pdf_light_area
        elif k == t - 1:
            rev = pdf_emit_tm1
        else:
            rev = eye["pdf_rev"][k]
        ri = ri * (_remap0(rev) / _remap0(eye["pdf_fwd"][k]))
        if (t - k + 1) <= max_light_depth:
            sum_ri = sum_ri + torch.where(_connectible(eye, k), ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _mis_weight_t1(light, s, rev_l_s, rev_l_sm1, max_eye_depth):
    """Weight of the t = 1 (light tracing) strategy splatting light vertex
    s. rev_l_s: area pdf of light vertex s generated from the camera;
    rev_l_sm1: of light vertex s-1 generated from s with incoming from the
    camera. After moving past light index k: k light vertices and s + 1 - k
    eye surface vertices."""
    sum_ri = torch.zeros_like(rev_l_s)
    ri = torch.ones_like(rev_l_s)
    for k in range(s, -1, -1):
        rev = rev_l_s if k == s else (rev_l_sm1 if k == s - 1 else light["pdf_rev"][k])
        ri = ri * (_remap0(rev) / _remap0(light["pdf_fwd"][k]))
        if (s + 1 - k) <= max_eye_depth:
            sum_ri = sum_ri + torch.where(_connectible(light, k), ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _emitter_factor(scene, light, w_out):
    """[N, 3] ones where light vertex 0 emits toward w_out (double-sided or
    the front face), zeros elsewhere."""
    mat0 = geom.mat_of_prim(scene, torch.clamp(light["prim"][0], min=0))
    dsided = mat_mod.emissive_double_sided(scene.materials, mat0)
    emit_cos = dot(light["ng"][0], w_out)
    ones = torch.ones_like(w_out)
    return torch.where((dsided | (emit_cos > 0))[..., None], ones, 0.0), emit_cos


def trace_bdpt(scene, camera, cfg, seed, sample_idx, pixel_idx,
               intersect_fn, occlude_fn, lane_mask=None):
    """One BDPT sample per pixel -> ([N, 3] radiance, [W*H, 3] splat film).

    The radiance holds the t >= 2 strategies and s = 0; the splat film is
    the whole frame's t = 1 light-tracing image (zeros when t = 1 is off):
    a light path traced for pixel i may splat anywhere. The image is
    radiance + splat, both averaged over spp. ``lane_mask`` ([N] bool)
    excludes lanes from the splat (pad lanes of a padded pixel axis: the
    t = 1 estimator assumes exactly W*H light subpaths per sample).
    """
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    t1 = _t1_enabled(scene, camera, cfg)
    n_film = camera.width * camera.height
    splat = torch.zeros((n_film, 3), dtype=_F32, device=dev)
    eye, L_env = _trace_eye_subpath(
        scene, camera, cfg, seed, sample_idx, pixel_idx, intersect_fn)
    light = _trace_light_subpath(scene, cfg, seed, sample_idx, pixel_idx, intersect_fn)
    L = L_env

    # Every connection / splat visibility ray is queued and answered by
    # grouped any-hit launches at the end: (o, d, t_max, payload).
    shadow_q = []
    cap = cfg.max_vertices if cfg.max_vertices > 0 else 1 << 30

    # ---- s = 0: the eye path hits an emitter ----
    for t in range(cfg.eye_depth):
        if t + 1 > cap:
            break
        mat_id = eye["mat_id"][t]
        Le = mat_mod.emission(scene.materials, scene.textures, mat_id, eye["uv"][t])
        dsided = mat_mod.emissive_double_sided(scene.materials, mat_id)
        front = dot(-eye["wo"][t], eye["ng"][t]) < 0.0
        ok = eye["valid"][t] & (dsided | front)
        if t == 0 and not t1:
            w = torch.ones((n,), dtype=_F32, device=dev)
        else:
            prim_t = torch.clamp(eye["prim"][t], min=0)
            li = geom.light_of_prim(scene, prim_t)
            sel_pdf = scene.lights.pdf.index_select(0, torch.clamp(li, min=0))
            _, _, _, _, area = light_mod._light_tri_data(scene, prim_t)
            pdf_l_area = sel_pdf / maximum(area, 1e-12)
            if t >= 1:
                # area pdf of eye vertex t-1 generated from the hit light
                # point by cosine emission-direction sampling
                w_back = normalize(eye["p"][t - 1] - eye["p"][t], eps=1e-20)
                cos_emit = abs_(dot(eye["ng"][t], w_back))
                pdf_emit_tm1 = _sa_to_area(
                    sampling.cosine_hemisphere_pdf(maximum(cos_emit, 1e-9)),
                    eye["p"][t], eye["p"][t - 1], eye["ns"][t - 1],
                )
            else:
                pdf_emit_tm1 = torch.zeros((n,), dtype=_F32, device=dev)  # unused
            w = _mis_weight_s0(eye, t, pdf_l_area, pdf_emit_tm1, cfg.light_depth, t1=t1)
            ok = ok & (li >= 0)
        L = L + eye["beta"][t] * Le * (ok * w)[..., None]

    if scene.lights.n_lights == 0:
        return L, splat

    # ---- t = 1: light tracing, splat light vertices to the camera ----
    if t1:
        for s in range(cfg.light_depth):
            if s + 1 > cap:  # the path has s + 1 surface / light vertices
                break
            pl = light["p"][s]
            w_cam, dist, pix, in_f, we, pdf_cam_dir, cos_cam, cam_o = \
                _camera_connect(camera, pl)
            cos_l = abs_(dot(light["ns"][s], w_cam))
            # area pdf of light vertex s generated from the camera
            rev_l_s = _sa_to_area_w(pdf_cam_dir, _sub_point(pl, cam_o), light["ns"][s])
            if s == 0:
                # the light point itself: emission already in beta; gate on
                # the emitting side
                f_l, _ = _emitter_factor(scene, light, w_cam)
                rev_l_sm1 = torch.zeros((n,), dtype=_F32, device=dev)
                can = light["valid"][0]
            else:
                l_params = _params_at(light, s)
                l_frame = bsdf_mod.make_frame(light["ns"][s])
                f_l = bsdf_mod.eval_world(l_params, l_frame, light["wo"][s], w_cam)
                w_back = normalize(light["p"][s - 1] - pl, eps=1e-20)
                rev_l_sm1 = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, w_cam, w_back),
                    pl, light["p"][s - 1], light["ns"][s - 1],
                )
                can = (
                    light["valid"][s]
                    & (light["kind"][s] != bsdf_mod.CLOSURE_NULL)
                    & ~light["delta"][s]
                )
            # importance transport: beta * f * We * cos_l * cos_cam / d^2
            contrib = light["beta"][s] * f_l * (
                we * cos_l * cos_cam / maximum(dist * dist, 1e-12)
            )[..., None]
            ok = can & in_f & (torch.amax(contrib, dim=-1) > 0.0)
            if lane_mask is not None:
                ok = ok & lane_mask
            o_sh = pl + w_cam * (
                RAY_EPS / maximum(abs_(dot(light["ng"][s], w_cam)), 1e-4)
            )[..., None]
            w = _mis_weight_t1(light, s, rev_l_s, rev_l_sm1, cfg.eye_depth)
            shadow_q.append((
                o_sh, w_cam, dist * (1.0 - SHADOW_EPS),
                ("splat", contrib, ok, w, pix),
            ))

    # ---- connections (s >= 1 light vertices or the light point, t >= 1) ----
    for t in range(cfg.eye_depth):
        pe = eye["p"][t]
        e_params = _params_at(eye, t)
        e_frame = bsdf_mod.make_frame(eye["ns"][t])
        e_scatterable = (
            eye["valid"][t]
            & (eye["kind"][t] != bsdf_mod.CLOSURE_NULL)
            & ~eye["delta"][t]   # delta vertices are not connectible
        )
        for s in range(cfg.light_depth):
            if t + s + 2 > cap:
                break
            pl = light["p"][s]
            g, w_el, dist, _, _ = _geo_term(pe, eye["ns"][t], pl, light["ns"][s])
            f_e = bsdf_mod.eval_world(e_params, e_frame, eye["wo"][t], w_el)
            # reverse pdfs the other side would use to make the connection
            # vertices (area measure at the respective vertex); first eye
            # vertex t generated from light vertex s:
            if s == 0:
                # light vertex 0 emits: one-sided emission factor
                f_l, emit_cos = _emitter_factor(scene, light, -w_el)
                rev_e_t = _sa_to_area(
                    sampling.cosine_hemisphere_pdf(abs_(emit_cos)),
                    pl, pe, eye["ns"][t],
                )
            else:
                l_params = _params_at(light, s)
                l_frame = bsdf_mod.make_frame(light["ns"][s])
                f_l = bsdf_mod.eval_world(l_params, l_frame, light["wo"][s], -w_el)
                rev_e_t = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, light["wo"][s], -w_el),
                    pl, pe, eye["ns"][t],
                )
            # light vertex s generated from eye vertex t:
            rev_l_s = _sa_to_area(
                bsdf_mod.pdf_world(e_params, e_frame, eye["wo"][t], w_el),
                pe, pl, light["ns"][s],
            )
            # eye vertex t-1 generated from eye vertex t (incoming = conn):
            if t >= 1:
                w_e_back = normalize(eye["p"][t - 1] - pe, eps=1e-20)
                rev_e_tm1 = _sa_to_area(
                    bsdf_mod.pdf_world(e_params, e_frame, w_el, w_e_back),
                    pe, eye["p"][t - 1], eye["ns"][t - 1],
                )
            else:
                rev_e_tm1 = torch.zeros((n,), dtype=_F32, device=dev)
            # light vertex s-1 generated from light vertex s (incoming = conn):
            if s >= 1:
                w_l_back = normalize(light["p"][s - 1] - pl, eps=1e-20)
                rev_l_sm1 = _sa_to_area(
                    bsdf_mod.pdf_world(l_params, l_frame, -w_el, w_l_back),
                    pl, light["p"][s - 1], light["ns"][s - 1],
                )
            else:
                rev_l_sm1 = torch.zeros((n,), dtype=_F32, device=dev)

            contrib = eye["beta"][t] * f_e * light["beta"][s] * f_l * g[..., None]
            ok = (
                e_scatterable
                & light["valid"][s]
                & ~light["delta"][s]
                & (torch.amax(contrib, dim=-1) > 0.0)
            )
            o_sh = pe + w_el * (
                RAY_EPS / maximum(abs_(dot(eye["ng"][t], w_el)), 1e-4)
            )[..., None]
            w = _mis_weight(
                eye, light, s, t, rev_e_t, rev_e_tm1, rev_l_s, rev_l_sm1,
                cfg.light_depth, t1=t1,
            )
            shadow_q.append((
                o_sh, w_el, dist * (1.0 - SHADOW_EPS), ("conn", contrib, ok, w),
            ))

    # ---- grouped any-hit launches for the queued visibility rays ----
    # at most BDPT_OCC_CHUNK_RAYS rays a launch: large launches, bounded
    # transient memory (the full queue is ~eye_depth * light_depth * N rays)
    if shadow_q:
        occluded = []
        for group in _occlusion_groups(shadow_q, n):
            o_all = torch.cat([q[0] for q in group], dim=0)
            d_all = torch.cat([q[1] for q in group], dim=0)
            t_all = torch.cat([q[2] for q in group], dim=0)
            occ = occlude_fn(o_all, d_all, torch.zeros_like(t_all), t_all)
            occluded.extend(occ.split(n))
        for (_, _, _, payload), occ in zip(shadow_q, occluded):
            if payload[0] == "splat":
                _, contrib, ok, w, pix = payload
                val = contrib * ((ok & ~occ) * w)[..., None]
                if cfg.ray_clamp > 0:
                    val = minimum(val, cfg.ray_clamp)
                val = torch.where(torch.isfinite(val), val, 0.0)
                splat = splat.index_add_(0, pix, val)
            else:
                _, contrib, ok, w = payload
                L = L + contrib * (ok & ~occ)[..., None] * w[..., None]

    if cfg.ray_clamp > 0:
        L = minimum(L, cfg.ray_clamp)
    return torch.where(torch.isfinite(L), L, 0.0), splat


def _occlusion_groups(shadow_q, n):
    """Queue entries (n rays each) in launch groups of at most
    BDPT_OCC_CHUNK_RAYS rays (a single entry may exceed it)."""
    group, groups, group_rays = [], [], 0
    for q in shadow_q:
        if group and group_rays + n > BDPT_OCC_CHUNK_RAYS:
            groups.append(group)
            group, group_rays = [], 0
        group.append(q)
        group_rays += n
    groups.append(group)
    return groups


def bdpt_sums(scene, camera, cfg, seed, pixel_idx, sample_offset=0, lane_mask=None):
    """cfg.spp BDPT samples for pixel ids [B] -> ([B, 3] radiance summed
    over the samples, [W*H, 3] splat film summed over the samples)."""
    intersect_fn, occlude_fn = _intersectors(scene)
    dev = pixel_idx.device
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=_F32, device=dev)
    spl = torch.zeros((camera.width * camera.height, 3), dtype=_F32, device=dev)
    for s in range(cfg.spp):
        li, sp = trace_bdpt(
            scene, camera, cfg, seed, s + sample_offset, pixel_idx,
            intersect_fn, occlude_fn, lane_mask=lane_mask,
        )
        acc = acc + li
        spl = spl + sp
    return acc, spl


def render_bdpt(scene, camera, cfg, seed=0):
    """Full-frame BDPT render on the scene's device -> [H, W, 3]."""
    n = camera.width * camera.height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=scene.device)
    acc, spl = bdpt_sums(scene, camera, cfg, seed, pixel_idx)
    return ((acc + spl) / cfg.spp).reshape(camera.height, camera.width, 3)
