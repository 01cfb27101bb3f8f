"""BSDF closure ids and the dielectric Fresnel term
(the pieces of ``akari_tpu/shading/bsdf.py`` that ``shading/soa.py`` uses)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import abs_, clip, maximum

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
