"""Resolved material closure table (``akari_tpu/shading/material.py``)."""

from __future__ import annotations

import torch

from ..core.vecmath import clip
from ..scene.arrays import (
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_MIRROR,
    MAT_MIX,
)
from .bsdf import (
    CLOSURE_DIFFUSE,
    CLOSURE_GLASS,
    CLOSURE_MICROFACET,
    CLOSURE_NULL,
    CLOSURE_SPECULAR,
)


def _resolved_closure_table(materials, textures):
    """[M, 16] closure params resolved against constant textures.

    [M]-sized work hoisted out of the per-lane hot path, so shading needs
    one row gather per use site. Columns: closure_kind(0) color(1:4)
    alpha(4) emission(5:8) double_sided(8) frac(9) mix_a(10) mix_b(11)
    is_mix(12) ior(13) pad(14:16).
    """
    kind = materials.kind
    value = textures.value
    color = value.index_select(0, materials.color_tex)  # [M,3]
    rough = value[:, 0].index_select(0, materials.roughness_tex)
    frac = clip(value[:, 0].index_select(0, materials.fraction_tex), 1e-4, 1.0 - 1e-4)
    # clip: roughness is physically in [0,1]; non-glossy rows point their
    # roughness_tex at arbitrary texels, and an unbounded alpha makes the
    # (masked) microfacet branch numerically wild.
    alpha = clip(rough * rough, 1e-4, 1.0)
    closure_kind = torch.where(
        kind == MAT_DIFFUSE,
        CLOSURE_DIFFUSE,
        torch.where(
            kind == MAT_GLOSSY,
            CLOSURE_MICROFACET,
            torch.where(
                kind == MAT_MIRROR,
                CLOSURE_SPECULAR,
                torch.where(kind == MAT_GLASS, CLOSURE_GLASS, CLOSURE_NULL),
            ),
        ),
    )
    emission_rgb = torch.where((kind == MAT_EMISSIVE)[:, None], color, 0.0)
    m = kind.shape[0]
    f32 = torch.float32
    ior = (
        materials.ior.to(f32) if materials.ior is not None
        else torch.full((m,), 1.5, dtype=f32, device=kind.device)
    )
    cols = [
        closure_kind.to(f32)[:, None],
        color.to(f32),
        alpha.to(f32)[:, None],
        emission_rgb.to(f32),
        materials.double_sided.to(f32)[:, None],
        frac.to(f32)[:, None],
        materials.mix_a.to(f32)[:, None],
        materials.mix_b.to(f32)[:, None],
        (kind == MAT_MIX).to(f32)[:, None],
        ior[:, None],
        torch.zeros((m, 2), dtype=f32, device=kind.device),
    ]
    return torch.cat(cols, dim=1)
