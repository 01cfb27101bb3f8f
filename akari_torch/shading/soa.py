"""Component-SoA shading: the wavefront hot path (``akari_tpu/shading/soa.py``).

Lambert + GGX/Beckmann/Phong microfacet + specular mirror + smooth glass
closures, the Mix-tree walk, power-CDF area-light NEE and the
environment light, on ``[N]`` tensors and ``V3`` 3-vectors. Every
closure is evaluated on every lane and the result selected per lane, with
the reference's operation order, so radiance agrees with the JAX package
to float32 rounding.

Table lookups are plain row gathers (``index_select`` on the transposed
table, giving ``[C, N]`` rows). The reference's one-hot matmul gather is
a TPU workaround and is not ported: on the card it would also round
through TF32. Scenes with image textures evaluate textures per lane at
the hit's uv (``shading/texture.py``); scenes without skip that branch and
launch what they launched before it existed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.distribution import sample_continuous, sample_discrete
from ..core.vecmath import abs_, clip, maximum
from ..core.v3 import (
    V3, from_rows, from_stack, onb3, reflect3, to_local3, to_world3, v3where,
)
from ..scene import geom
from ..scene.arrays import MAT_EMISSIVE, MAX_MIX_DEPTH
from . import microfacet as mf
from .bsdf import (
    CLOSURE_GLASS,
    CLOSURE_MICROFACET,
    CLOSURE_NULL,
    CLOSURE_SPECULAR,
    DELTA_PDF,
    fresnel_dielectric,
)
from .light import _light_fat_table, _light_tri_data, _light_uv
from .material import (
    _resolved_closure_table,
    select_mix_textured,
    textured_closure,
)
from .texture import evaluate as texture_evaluate

INV_PI = 1.0 / np.pi
PI = np.pi


def gather_rows_t(table, ids):
    """``table[ids].T`` -> [C, N]: one row gather, rows contiguous."""
    return table.t().index_select(1, ids)


# ------------------------- sampling warps (scalar u) ------------------------

def concentric_disk(u1, u2):
    """Two [N] uniforms -> ([N] px, [N] py) on the unit disk."""
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    ax, ay = abs_(x), abs_(y)
    use_x = ax > ay
    r = torch.where(use_x, x, y)

    def safe(d):
        return torch.where(d == 0.0, 1.0, d)

    theta = torch.where(
        use_x,
        (PI / 4.0) * (y / safe(x)),
        (PI / 2.0) - (PI / 4.0) * (x / safe(y)),
    )
    degenerate = (x == 0.0) & (y == 0.0)
    px = torch.where(degenerate, 0.0, r * torch.cos(theta))
    py = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return px, py


def cosine_hemisphere(u1, u2):
    """-> V3 local direction (Z-up), cosine-weighted."""
    px, py = concentric_disk(u1, u2)
    z = torch.sqrt(maximum(1.0 - px * px - py * py, 0.0))
    return V3(px, py, z)


def uniform_triangle(u1, u2):
    """-> ([N] b0, [N] b1) uniform barycentrics."""
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0


# --------------------- microfacet distributions (local V3) ------------------

def _tan2_theta(w):
    c2 = w.z * w.z
    s2 = maximum(1.0 - c2, 0.0)
    return s2 / maximum(c2, 1e-8)


def _mf_d(dist, alpha, m):
    c2 = m.z * m.z
    t2 = _tan2_theta(m)
    a2 = alpha * alpha
    at = a2 + t2
    d_ggx = a2 / (PI * c2 * c2 * at * at + 1e-12)
    d_beck = torch.exp(-t2 / a2) / (PI * a2 * c2 * c2 + 1e-12)
    d_phong = (alpha + 2.0) / (2.0 * PI) * torch.pow(
        maximum(m.z, 1e-6), alpha
    )
    d = torch.where(
        dist == mf.GGX, d_ggx, torch.where(dist == mf.BECKMANN, d_beck, d_phong)
    )
    return torch.where(m.z > 0.0, d, 0.0)


def _rational_g1(a):
    g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, g, 1.0)


def _mf_g1(dist, alpha, v, m):
    back = v.dot(m) * v.z <= 0.0
    t2 = _tan2_theta(v)
    g_ggx = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))
    tt = torch.sqrt(maximum(t2, 0.0) + 1e-12)
    a_beck = 1.0 / (maximum(alpha, 1e-4) * maximum(tt, 1e-9))
    a_phong = torch.sqrt(0.5 * alpha + 1.0) / maximum(tt, 1e-9)
    g = torch.where(
        dist == mf.GGX,
        g_ggx,
        torch.where(
            dist == mf.BECKMANN, _rational_g1(a_beck), _rational_g1(a_phong)
        ),
    )
    return torch.where(back, 0.0, g)


def _mf_sample_wh(dist, alpha, u1, u2):
    phi = 2.0 * PI * u2
    t2_ggx = alpha * alpha * u1 / maximum(1.0 - u1, 1e-9)
    t2_beck = -alpha * alpha * torch.log(maximum(1.0 - u1, 1e-9))
    cos_p = torch.pow(maximum(u1, 1e-20), 1.0 / (alpha + 2.0))
    t2 = torch.where(dist == mf.GGX, t2_ggx, t2_beck)
    cos_t = 1.0 / torch.sqrt(1.0 + t2)
    cos_t = torch.where(dist == mf.PHONG, cos_p, cos_t)
    sin_t = torch.sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def _mf_pdf_wh(dist, alpha, m):
    return _mf_d(dist, alpha, m) * abs_(m.z)


# --------------------------- local-frame closures ---------------------------

def _same_hemisphere(wo, wi):
    return wo.z * wi.z > 0.0


def _diffuse_eval(color, wo, wi):
    return v3where(_same_hemisphere(wo, wi), color * INV_PI, 0.0)


def _diffuse_pdf(wo, wi):
    return torch.where(_same_hemisphere(wo, wi), abs_(wi.z) * INV_PI, 0.0)


def _diffuse_sample(color, wo, u1, u2):
    wi = cosine_hemisphere(u1, u2)
    flip = wo.z < 0.0
    wi = V3(wi.x, wi.y, torch.where(flip, -wi.z, wi.z))
    pdf = abs_(wi.z) * INV_PI
    return wi, color * INV_PI, pdf


def _half_vector(wo, wi):
    """Normalized upper-hemisphere half vector and its degeneracy mask.

    Degenerate half vectors (wi ~ -wo) are replaced by the pole before
    the microfacet math, as in the reference."""
    wh_raw = wo + wi
    wh2 = wh_raw.dot(wh_raw)
    degen = wh2 < 1e-12
    wh = v3where(
        degen,
        V3(torch.zeros_like(wh2), torch.zeros_like(wh2), torch.ones_like(wh2)),
        wh_raw * (1.0 / torch.sqrt(maximum(wh2, 1e-20))),
    )
    wh = v3where(wh.z < 0.0, -wh, wh)
    return wh, degen


def _micro_eval(color, dist, alpha, wo, wi):
    same = _same_hemisphere(wo, wi)
    cos_o = abs_(wo.z)
    cos_i = abs_(wi.z)
    wh, degen = _half_vector(wo, wi)
    d_val = _mf_d(dist, alpha, wh)
    g_val = _mf_g1(dist, alpha, wo, wh) * _mf_g1(dist, alpha, wi, wh)
    denom = 4.0 * cos_i * cos_o
    scale = d_val * g_val / maximum(denom, 1e-9)
    ok = same & (cos_i > 0) & (cos_o > 0) & ~degen
    return v3where(ok, color * scale, 0.0)


def _micro_pdf(dist, alpha, wo, wi):
    wh, degen = _half_vector(wo, wi)
    pdf = _mf_pdf_wh(dist, alpha, wh) / maximum(4.0 * abs_(wo.dot(wh)), 1e-9)
    return torch.where(_same_hemisphere(wo, wi) & ~degen, pdf, 0.0)


def _micro_sample(color, dist, alpha, wo, u1, u2):
    flip = wo.z < 0.0
    wo_up = V3(wo.x, wo.y, torch.where(flip, -wo.z, wo.z))
    wh = _mf_sample_wh(dist, alpha, u1, u2)
    wi_up = reflect3(wo_up, wh)
    wi = V3(wi_up.x, wi_up.y, torch.where(flip, -wi_up.z, wi_up.z))
    pdf = _mf_pdf_wh(dist, alpha, wh) / maximum(4.0 * abs_(wo_up.dot(wh)), 1e-9)
    f = _micro_eval(color, dist, alpha, wo, wi)
    ok = _same_hemisphere(wo, wi)
    return wi, f, torch.where(ok, pdf, 0.0)


def _specular_sample(color, wo):
    wi = V3(-wo.x, -wo.y, wo.z)
    cos_i = maximum(abs_(wi.z), 1e-6)
    f = color * (DELTA_PDF / cos_i)
    pdf = torch.full_like(wo.z, DELTA_PDF)
    return wi, f, pdf


def _glass_sample(color, ior, wo, u1):
    """Smooth dielectric: Fresnel-weighted delta reflection / refraction
    with the (1/eta)^2 radiance scale; TIR reflects."""
    cos_i = wo.z
    entering = cos_i > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    fr = fresnel_dielectric(cos_i, torch.ones_like(ior), ior)
    nz = torch.where(entering, 1.0, -1.0)
    ci = abs_(cos_i)
    sin2_t = eta * eta * maximum(1.0 - ci * ci, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(maximum(1.0 - sin2_t, 0.0))
    wt = V3(-eta * wo.x, -eta * wo.y, -eta * wo.z + (eta * ci - cos_t) * nz)
    wr = V3(-wo.x, -wo.y, wo.z)
    reflect_p = torch.where(tir, 1.0, fr)
    pick_r = (u1 < reflect_p) | tir
    wi = v3where(pick_r, wr, wt)
    cos_o = maximum(abs_(wi.z), 1e-6)
    w_refl = DELTA_PDF * reflect_p / cos_o
    w_refr = DELTA_PDF * (1.0 - reflect_p) * (eta * eta) / cos_o
    f = color * torch.where(pick_r, w_refl, w_refr)
    pdf = maximum(DELTA_PDF * torch.where(pick_r, reflect_p, 1.0 - reflect_p), 1e-12)
    return wi, f, pdf


# ------------------------------ dispatch ----------------------------------

def _delta_or_null(kind):
    return (
        (kind == CLOSURE_NULL)
        | (kind == CLOSURE_SPECULAR)
        | (kind == CLOSURE_GLASS)
    )


def eval_local(params, wo, wi):
    fd = _diffuse_eval(params["color"], wo, wi)
    fm = _micro_eval(params["color"], params["dist"], params["alpha"], wo, wi)
    f = v3where(params["kind"] == CLOSURE_MICROFACET, fm, fd)
    return v3where(_delta_or_null(params["kind"]), 0.0, f)


def pdf_local(params, wo, wi):
    pd = _diffuse_pdf(wo, wi)
    pm = _micro_pdf(params["dist"], params["alpha"], wo, wi)
    pdf = torch.where(params["kind"] == CLOSURE_MICROFACET, pm, pd)
    return torch.where(_delta_or_null(params["kind"]), 0.0, pdf) * params["choice_pdf"]


def sample_local(params, wo, u1, u2):
    wi_d, f_d, p_d = _diffuse_sample(params["color"], wo, u1, u2)
    wi_m, f_m, p_m = _micro_sample(
        params["color"], params["dist"], params["alpha"], wo, u1, u2
    )
    wi_s, f_s, p_s = _specular_sample(params["color"], wo)
    ior = params.get("ior")
    if ior is None:
        ior = torch.full_like(wo.z, 1.5)
    wi_g, f_g, p_g = _glass_sample(params["color"], ior, wo, u1)
    is_mf = params["kind"] == CLOSURE_MICROFACET
    is_sp = params["kind"] == CLOSURE_SPECULAR
    is_gl = params["kind"] == CLOSURE_GLASS
    wi = v3where(is_sp, wi_s, v3where(is_mf, wi_m, wi_d))
    f = v3where(is_sp, f_s, v3where(is_mf, f_m, f_d))
    pdf = torch.where(is_sp, p_s, torch.where(is_mf, p_m, p_d))
    wi = v3where(is_gl, wi_g, wi)
    f = v3where(is_gl, f_g, f)
    pdf = torch.where(is_gl, p_g, pdf)
    null = params["kind"] == CLOSURE_NULL
    f = v3where(null, 0.0, f)
    pdf = torch.where(null, 0.0, pdf) * params["choice_pdf"]
    return wi, f, pdf


def make_frame(ns):
    t, b = onb3(ns)
    return t, b, ns


def eval_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return eval_local(params, to_local3(t, b, n, wo_w), to_local3(t, b, n, wi_w))


def pdf_world(params, frame, wo_w, wi_w):
    t, b, n = frame
    return pdf_local(params, to_local3(t, b, n, wo_w), to_local3(t, b, n, wi_w))


def sample_world(params, frame, wo_w, u1, u2):
    t, b, n = frame
    wi_l, f, pdf = sample_local(params, to_local3(t, b, n, wo_w), u1, u2)
    return to_world3(t, b, n, wi_l), f, pdf


# ------------------------------ materials ----------------------------------

def select_material(materials, textures, mat_id, u, uv_u, uv_v):
    """Mix-tree walk -> (leaf_id, choice_pdf) over the resolved table, or
    with the fractions evaluated at (uv_u, uv_v) on image-textured scenes."""
    if not materials.has_mix:
        return mat_id, torch.ones_like(u)
    if textures.has_images:
        return select_mix_textured(
            materials, textures, mat_id, u, torch.stack([uv_u, uv_v], dim=-1)
        )
    choice_pdf = torch.ones_like(u)
    cur = mat_id
    ct = _resolved_closure_table(materials, textures)
    for _ in range(MAX_MIX_DEPTH):
        fat = gather_rows_t(ct, cur)
        is_mix = fat[12] > 0.5
        frac = fat[9]
        safe_frac = clip(frac, 1e-4, 1.0 - 1e-4)
        pick_b = u < safe_frac
        next_id = torch.where(pick_b, fat[11], fat[10]).to(torch.int32)
        new_u = torch.where(
            pick_b, u / safe_frac, (u - safe_frac) / (1.0 - safe_frac)
        )
        step_pdf = torch.where(pick_b, 1.0 / safe_frac, 1.0 / (1.0 - safe_frac))
        cur = torch.where(is_mix, next_id, cur)
        u = torch.where(is_mix, new_u, u)
        choice_pdf = torch.where(is_mix, choice_pdf * step_pdf, choice_pdf)
    return cur, choice_pdf


def closure_params(materials, textures, leaf_id, choice_pdf, uv_u, uv_v):
    """Leaf ids -> SoA closure params: kind [N], color V3, alpha [N],
    dist [N], ior [N], choice_pdf [N]. One row gather without images."""
    if textures.has_images:
        kind, color, alpha, ior = textured_closure(
            materials, textures, leaf_id, torch.stack([uv_u, uv_v], dim=-1)
        )
        return {
            "kind": kind,
            "color": from_stack(color),
            "alpha": alpha,
            "dist": torch.full_like(kind, mf.GGX),
            "ior": ior,
            "choice_pdf": choice_pdf,
        }
    ct = _resolved_closure_table(materials, textures)
    fat = gather_rows_t(ct, leaf_id)
    return {
        "kind": fat[0].to(torch.int32),
        "color": from_rows(fat, 1),
        "alpha": fat[4],
        "dist": torch.full_like(leaf_id, mf.GGX, dtype=torch.int32),
        "ior": fat[13],
        "choice_pdf": choice_pdf,
    }


def emission_and_sided(materials, textures, mat_id, uv_u, uv_v):
    """(V3 Le, [N] double_sided) — one row gather without images."""
    if textures.has_images:
        kind = materials.kind.index_select(0, mat_id)
        color = texture_evaluate(
            textures, materials.color_tex.index_select(0, mat_id),
            torch.stack([uv_u, uv_v], dim=-1),
        )
        Le = v3where(kind == MAT_EMISSIVE, from_stack(color), 0.0)
        return Le, materials.double_sided.index_select(0, mat_id)
    ct = _resolved_closure_table(materials, textures)
    fat = gather_rows_t(ct, mat_id)
    return from_rows(fat, 5), fat[8] > 0.5


# ------------------------------- lights -------------------------------------

class LightSampleSoA(NamedTuple):
    wi: V3            # unit, surface -> light
    dist: object      # [N]
    L: V3             # emitted radiance toward the surface
    pdf: object       # [N] solid-angle pdf * selection pmf
    valid: object     # [N] bool


def light_sample(scene, u_select, u_pos1, u_pos2, p_ref):
    """Power-select a light triangle, sample a point, return the NEE record.
    p_ref is a V3. Flat constant-texture scenes gather one row of the
    per-light table; otherwise (the reference's non-fast branch) the
    light's prim is moved to world space by its instance on a two-level
    scene, and its emission and sidedness are looked up at the sample's
    texture coordinates."""
    lights = scene.lights
    li, sel_pdf = sample_discrete(lights.cdf, u_select)
    b0, b1 = uniform_triangle(u_pos1, u_pos2)
    if scene.instances is None and not scene.textures.has_images:
        fat = gather_rows_t(_light_fat_table(scene), li)
        v0, e1, e2 = from_rows(fat, 0), from_rows(fat, 3), from_rows(fat, 6)
        ng = from_rows(fat, 9)
        area = fat[12]
        L = from_rows(fat, 13)
        double_sided = fat[16] > 0.5
    else:
        tri = lights.tri_id.index_select(0, li)
        v0_a, e1_a, e2_a, ng_a, area = _light_tri_data(scene, tri)
        v0, e1, e2, ng = (from_stack(a) for a in (v0_a, e1_a, e2_a, ng_a))
        L, double_sided = emission_and_sided(
            scene.materials, scene.textures, geom.mat_of_prim(scene, tri),
            *_light_uv(scene, tri, b0, b1),
        )

    p = v0 + e1 * b0 + e2 * b1

    wi_raw = p - p_ref
    dist2 = maximum(wi_raw.dot(wi_raw), 1e-12)
    dist = torch.sqrt(dist2)
    wi = wi_raw * (1.0 / dist)

    cos_light = -wi.dot(ng)  # emission from the front face
    cos_eff = torch.where(double_sided, abs_(cos_light), cos_light)
    area_ok = cos_eff > 1e-6
    pdf = dist2 / (maximum(cos_eff, 1e-6) * area) * sel_pdf
    valid = area_ok & (scene.lights.n_lights > 0)
    return LightSampleSoA(wi, dist, L, pdf, valid)


# --------------------------- environment light ------------------------------
# Equirectangular mapping: u = (atan2(x, -z) + pi) / 2pi, v = acos(y) / pi
# (v = 0 at +Y). Importance sampling uses the flattened luminance*sin(v*pi)
# texel CDF (SceneArrays.env_cdf); pdf conversion image -> solid angle is
# pmf * He*We / (2 pi^2 sin(theta)).

def env_uv_of_dir(d):
    """V3 unit direction -> ([N] u, [N] v) equirectangular coordinates."""
    u = (torch.atan2(d.x, -d.z) + PI) / (2.0 * PI)
    v = torch.acos(clip(d.y, -1.0, 1.0)) / PI
    return u, v


def _env_texel(flat, idx):
    t = flat.index_select(0, idx)
    return V3(t[:, 0], t[:, 1], t[:, 2])


def env_eval(scene, d):
    """Bilinear radiance of the environment map along V3 d -> V3 (wrap in
    longitude, clamp at the poles)."""
    img = scene.env_image
    he, we = img.shape[0], img.shape[1]
    u, v = env_uv_of_dir(d)
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), we)
    x1i = torch.remainder(x0i + 1, we)           # wrap in longitude
    y0i = torch.clamp(y0.to(torch.int32), 0, he - 1)
    y1i = torch.clamp(y0i + 1, 0, he - 1)        # clamp at the poles
    flat = img.reshape(-1, 3)
    r0, r1 = (y0i * we).to(torch.int64), (y1i * we).to(torch.int64)
    x0l, x1l = x0i.to(torch.int64), x1i.to(torch.int64)
    c00, c01 = _env_texel(flat, r0 + x0l), _env_texel(flat, r0 + x1l)
    c10, c11 = _env_texel(flat, r1 + x0l), _env_texel(flat, r1 + x1l)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def env_pdf_sa(scene, d):
    """Solid-angle NEE pdf of sampling direction d from the env CDF
    (EXCLUDING the strategy-mixture factor env_p_select)."""
    he, we = scene.env_image.shape[0], scene.env_image.shape[1]
    u, v = env_uv_of_dir(d)
    xi = torch.clamp((u * we).to(torch.int32), 0, we - 1)
    yi = torch.clamp((v * he).to(torch.int32), 0, he - 1)
    pmf = scene.env_pmf.index_select(0, (yi * we + xi).to(torch.int64))
    sin_t = maximum(torch.sin(v * PI), 1e-6)
    return pmf * (he * we) / (2.0 * PI * PI * sin_t)


def env_sample(scene, u1, u2):
    """Importance-sample a direction from the env CDF: the texel by ONE
    ``searchsorted(right)`` on the flattened CDF (u1; the in-texel
    longitude is the continuous inverse-CDF remainder), the latitude
    jitter from u2. Returns (wi V3, Le V3, pdf_sa [N])."""
    he, we = scene.env_image.shape[0], scene.env_image.shape[1]
    x_flat, _, idx = sample_continuous(scene.env_cdf, u1)
    # de-flatten: texel (yi, xi) + uniform position inside it
    frac = x_flat * (he * we) - idx.to(torch.float32)
    yi = torch.div(idx, we, rounding_mode="floor")
    xi = torch.remainder(idx, we)
    u = (xi.to(torch.float32) + frac) / we
    v = (yi.to(torch.float32) + u2) / he
    theta = v * PI
    phi = u * 2.0 * PI - PI
    sin_t = torch.sin(theta)
    wi = V3(sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi))
    Le = env_eval(scene, wi)
    pmf = scene.env_pmf.index_select(0, idx.to(torch.int64))
    pdf = pmf * (he * we) / (2.0 * PI * PI * maximum(sin_t, 1e-6))
    return wi, Le, pdf


# Shadow-ray length of environment NEE samples (the occlusion query is
# "anything between here and the sky?").
ENV_SHADOW_DIST = float(np.float32(1e7))


def light_sample_mixed(scene, u_select, u_p1, u_p2, p_ref):
    """NEE sample from the area-light / environment strategy mixture.

    No env: plain area sampling. Env only: pure env sampling. Both: pick
    the env with probability ``scene.env_p_select`` (a 0-d float32 tensor,
    so ``1 - p`` rounds in float32 as the reference's does; u_select split
    and rescaled), and fold the mixture pmf into the returned pdf so the
    MIS weights stay consistent.
    """
    if scene.env_image is None:
        return light_sample(scene, u_select, u_p1, u_p2, p_ref)
    if scene.lights.n_lights == 0:
        wi, Le, pdf = env_sample(scene, u_p1, u_p2)
        dist = torch.full_like(u_select, ENV_SHADOW_DIST)
        return LightSampleSoA(wi, dist, Le, pdf, pdf > 0.0)
    p_env = scene.env_p_select
    is_env = u_select < p_env
    u_area = clip(
        (u_select - p_env) / maximum(1.0 - p_env, 1e-6), 0.0, 0.999999
    )
    ls = light_sample(scene, u_area, u_p1, u_p2, p_ref)
    wi_e, Le_e, pdf_e = env_sample(scene, u_p1, u_p2)
    wi = v3where(is_env, wi_e, ls.wi)
    dist = torch.where(is_env, ENV_SHADOW_DIST, ls.dist)
    L = v3where(is_env, Le_e, ls.L)
    pdf = torch.where(is_env, pdf_e * p_env, ls.pdf * (1.0 - p_env))
    valid = torch.where(is_env, pdf_e > 0.0, ls.valid)
    return LightSampleSoA(wi, dist, L, pdf, valid)


def light_pdf_direction_from(e1, e2, sel_pdf, hit_ok, wi, dist, double_sided):
    """MIS light pdf from already-gathered hit data (V3 e1/e2/wi)."""
    ng_raw = e1.cross(e2)
    area2 = torch.sqrt(maximum(ng_raw.dot(ng_raw), 1e-20))
    ng = ng_raw * (1.0 / area2)
    area = 0.5 * area2
    cos_light = -wi.dot(ng)
    cos_eff = torch.where(double_sided, abs_(cos_light), cos_light)
    is_light = (sel_pdf > 0.0) & hit_ok
    d = torch.where(is_light, dist, 1.0)  # avoid inf*inf on missed lanes
    pdf = d * d / (maximum(cos_eff, 1e-6) * area) * sel_pdf
    return torch.where(is_light & (cos_eff > 1e-6), pdf, 0.0)
