"""Sampling warps and the MIS heuristic (``akari_tpu/sampling.py``).

The warps take ``[..., 2]`` uniforms and return ``[..., 2]`` / ``[..., 3]``
tensors (Z-up local frames), for the BDPT and AO integrators; the path
tracer's hot loop uses the per-component forms in ``shading/soa.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.vecmath import abs_, maximum, minimum

INV_PI = 1.0 / np.pi


def concentric_disk(u):
    """[..., 2] uniform -> [..., 2] point on the unit disk (concentric map)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    ax, ay = abs_(x), abs_(y)
    use_x = ax > ay
    r = torch.where(use_x, x, y)

    def safe(d):
        return torch.where(d == 0.0, 1.0, d)

    theta = torch.where(
        use_x,
        (np.pi / 4.0) * (y / safe(x)),
        (np.pi / 2.0) - (np.pi / 4.0) * (x / safe(y)),
    )
    degenerate = (x == 0.0) & (y == 0.0)
    px = torch.where(degenerate, 0.0, r * torch.cos(theta))
    py = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return torch.stack([px, py], dim=-1)


def cosine_hemisphere(u):
    """[..., 2] -> [..., 3] cosine-weighted direction, Z-up."""
    d = concentric_disk(u)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    z = torch.sqrt(maximum(1.0 - r2, 0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_triangle(u):
    """[..., 2] -> barycentric (b0, b1) uniformly over a triangle."""
    su0 = torch.sqrt(u[..., 0])
    b0 = 1.0 - su0
    b1 = u[..., 1] * su0
    return torch.stack([b0, b1], dim=-1)


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta=2) weight for strategy A."""
    # clamp before squaring: a huge (near-delta) pdf squared overflows f32
    # and inf/inf = NaN even though the weight limit is a clean 1.
    pdf_a = minimum(pdf_a, 1e18)
    pdf_b = minimum(pdf_b, 1e18)
    a2 = pdf_a * pdf_a
    denom = a2 + pdf_b * pdf_b
    return torch.where(
        denom > 0.0, a2 / torch.where(denom > 0.0, denom, 1.0), 0.0
    )
