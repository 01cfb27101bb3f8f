"""BSDF closure ids, the dielectric Fresnel term, and the ``[N, 3]``
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


# ------------------- [N, 3] world-frame entry points -----------------------
#
# The reference's AoS closures run here as ``shading/soa.py``'s
# per-component ones on the columns of the [N, 3] inputs: one copy of the
# closure arithmetic. The two differ only where the half vector is
# degenerate (|wo + wi|^2 < 1e-12 with wo, wi in one hemisphere, i.e. both
# grazing), where soa.py substitutes the pole (ROADMAP Queue 3).


def _soa_args(params, frame, *dirs):
    p = dict(params, color=from_stack(params["color"]))
    return (p, tuple(from_stack(v) for v in frame), *(from_stack(w) for w in dirs))


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
