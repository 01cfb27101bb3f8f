"""Sampling helpers of the main path (``akari_tpu/sampling.py``)."""

from __future__ import annotations

import torch

from .core.vecmath import minimum


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
