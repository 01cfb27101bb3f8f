"""Dtype policy (``akari_tpu/utils/config.py``): the port of the
reference's build-time variant system (``Config<Float, Spectrum>``). A
variant is the dtype the wavefront's spectrum state carries, chosen at
run time (``PathConfig.dtypes``, the CLI's ``--spectrum-dtype``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DtypePolicy:
    """Numeric policy for the render pipeline.

    spectrum: dtype of radiance / throughput (L, beta) carried from one
    bounce to the next; bfloat16 halves that state at a quantisation-noise
    cost. geometry: vertices and traversal (keep float32: Moller-Trumbore
    determinants cancel in bfloat16). accum: the film accumulation (keep
    float32: many-sample sums need the mantissa).
    """

    spectrum: torch.dtype = torch.float32
    geometry: torch.dtype = torch.float32
    accum: torch.dtype = torch.float32


RGB = DtypePolicy()
RGB_BF16 = DtypePolicy(spectrum=torch.bfloat16)


def variant_string(policy=RGB):
    """``rgb-<spectrum>-<geometry>`` with NumPy's dtype names, as the JAX
    package spells them (``rgb-bfloat16-float32``)."""

    def name(dt):
        return str(dt).removeprefix("torch.")

    return f"rgb-{name(policy.spectrum)}-{name(policy.geometry)}"
