"""BSDF closure ids, the Fresnel terms, and the ``[N, 3]`` local- and
world-frame entry points of the BDPT and AO integrators
(``akari_tpu/shading/bsdf.py``). ``params`` is a dict of per-lane tensors:
kind [N] (CLOSURE_*), color [N, 3], alpha [N], dist [N], choice_pdf [N],
optional ior [N].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.v3 import from_stack
from ..core.vecmath import abs_, clip, maximum, onb

CLOSURE_NULL = -1
CLOSURE_DIFFUSE = 0
CLOSURE_MICROFACET = 1
CLOSURE_SPECULAR = 2  # perfect mirror (delta)
CLOSURE_GLASS = 3     # smooth dielectric (delta reflect + refract)

INV_PI = 1.0 / np.pi

# Delta distributions report this as their sample pdf. The sampled f is
# scaled by the same constant so throughput f*cos/pdf is exact, while MIS
# power weights against any finite pdf evaluate to ~1.
DELTA_PDF = float(np.float32(1e8))


# --------------- [N, 3] local- and world-frame entry points -----------------
#
# The reference's AoS closures run here as ``shading/soa.py``'s
# per-component ones on the columns of the [N, 3] inputs: one copy of the
# closure arithmetic. The two differ only where the half vector is
# degenerate (|wo + wi|^2 < 1e-12 with wo, wi in one hemisphere, i.e. both
# grazing), where soa.py substitutes the pole (ROADMAP Queue 3).


def _soa_args(params, frame, *dirs):
    p = dict(params, color=from_stack(params["color"]))
    return (p, tuple(from_stack(v) for v in frame), *(from_stack(w) for w in dirs))


def eval_local(params, wo, wi):
    """f of [N, 3] local (Z-up) directions."""
    from . import soa

    p, _, wo, wi = _soa_args(params, (), wo, wi)
    return soa.eval_local(p, wo, wi).stack()


def pdf_local(params, wo, wi):
    from . import soa

    p, _, wo, wi = _soa_args(params, (), wo, wi)
    return soa.pdf_local(p, wo, wi)


def sample_local(params, wo, u):
    """(wi, f, pdf) of [N, 3] local wo and [N, 2] uniforms."""
    from . import soa

    p, _, wo = _soa_args(params, (), wo)
    wi, f, pdf = soa.sample_local(p, wo, u[..., 0], u[..., 1])
    return wi.stack(), f.stack(), pdf


def make_frame(ns):
    """Shading frame (t, b, n) from the shading normal."""
    t, b = onb(ns)
    return t, b, ns


def eval_world(params, frame, wo_w, wi_w):
    from . import soa

    return soa.eval_world(*_soa_args(params, frame, wo_w, wi_w)).stack()


def pdf_world(params, frame, wo_w, wi_w):
    from . import soa

    return soa.pdf_world(*_soa_args(params, frame, wo_w, wi_w))


def sample_world(params, frame, wo_w, u):
    from . import soa

    wi, f, pdf = soa.sample_world(*_soa_args(params, frame, wo_w), u[..., 0], u[..., 1])
    return wi.stack(), f.stack(), pdf


# ------------------------------ Fresnel -----------------------------------

def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance; handles total internal
    reflection. All arguments are [N] tensors."""
    cos_i = clip(cos_i, -1.0, 1.0)
    # swap indices when exiting
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = abs_(cos_i)
    sin_t = ei / et * torch.sqrt(maximum(1.0 - ci * ci, 0.0))
    tir = sin_t >= 1.0
    ct = torch.sqrt(maximum(1.0 - sin_t * sin_t, 0.0))
    r_par = (et * ci - ei * ct) / maximum(et * ci + ei * ct, 1e-9)
    r_perp = (ei * ci - et * ct) / maximum(ei * ci + et * ct, 1e-9)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel reflectance (the reference's fr_conductor); eta
    and k may be per-channel [N, 3] for coloured metals."""
    ci = clip(abs_(cos_i), 0.0, 1.0)
    if torch.is_tensor(eta) and eta.dim() > ci.dim():
        ci = ci[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - si2
    a2b2 = torch.sqrt(maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / maximum(t1 + t2, 1e-9)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / maximum(t3 + t4, 1e-9)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_i, f0):
    """Schlick's approximation; f0 may be per-channel [N, 3]."""
    m = clip(1.0 - abs_(cos_i), 0.0, 1.0)
    if torch.is_tensor(f0) and f0.dim() > cos_i.dim():
        m = m[..., None]
    return f0 + (1.0 - f0) * m ** 5
