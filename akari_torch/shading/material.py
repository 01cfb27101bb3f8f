"""Material table lookup (``akari_tpu/shading/material.py``): the
resolved closure table of constant-texture scenes, the per-lane texture
path of image-textured ones (both shared with ``shading/soa.py``), and the
reference's ``[N, 3]`` entry points of the BDPT integrator, which run
``shading/soa.py``'s functions.
"""

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
    MAX_MIX_DEPTH,
)
from . import texture as tex
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
    one row gather per use site. Only valid when ``textures.has_images`` is
    False. Columns: closure_kind(0) color(1:4) alpha(4) emission(5:8)
    double_sided(8) frac(9) mix_a(10) mix_b(11) is_mix(12) ior(13)
    pad(14:16).
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
    closure_kind = _closure_kind(kind)
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


def _closure_kind(kind):
    """Material kinds -> CLOSURE_* (emissive and mix: CLOSURE_NULL)."""
    return torch.where(
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


def _ior_of(materials, leaf_id):
    if materials.ior is not None:
        return materials.ior.index_select(0, leaf_id)
    return torch.full(leaf_id.shape, 1.5, dtype=torch.float32, device=leaf_id.device)


def select_mix_textured(materials, textures, mat_id, u, uv):
    """The Mix walk with the fraction evaluated per lane at uv (image
    textures) -> (leaf_id, choice_pdf); shared with ``shading/soa.py``."""
    choice_pdf = torch.ones_like(u)
    cur = mat_id
    for _ in range(MAX_MIX_DEPTH):
        kind = materials.kind.index_select(0, cur)
        is_mix = kind == MAT_MIX
        frac_tex = materials.fraction_tex.index_select(0, cur)
        frac = clip(tex.evaluate_scalar(textures, frac_tex, uv), 1e-4, 1.0 - 1e-4)
        pick_b = u < frac
        next_id = torch.where(
            pick_b, materials.mix_b.index_select(0, cur),
            materials.mix_a.index_select(0, cur),
        )
        new_u = torch.where(pick_b, u / frac, (u - frac) / (1.0 - frac))
        step_pdf = torch.where(pick_b, 1.0 / frac, 1.0 / (1.0 - frac))
        cur = torch.where(is_mix, next_id, cur)
        u = torch.where(is_mix, new_u, u)
        choice_pdf = torch.where(is_mix, choice_pdf * step_pdf, choice_pdf)
    return cur, choice_pdf


def textured_closure(materials, textures, leaf_id, uv):
    """(closure kind, [N, 3] color, alpha, ior) with the textures evaluated
    per lane at uv; shared with ``shading/soa.py``."""
    kind = materials.kind.index_select(0, leaf_id)
    color = tex.evaluate(textures, materials.color_tex.index_select(0, leaf_id), uv)
    rough = tex.evaluate_scalar(
        textures, materials.roughness_tex.index_select(0, leaf_id), uv
    )
    # clip: roughness is physically in [0,1] (see _resolved_closure_table)
    alpha = clip(rough * rough, 1e-4, 1.0)
    return _closure_kind(kind).to(torch.int32), color, alpha, _ior_of(materials, leaf_id)


def select_material(materials, textures, mat_id, u, uv):
    """Resolve Mix chains: ([N] ids, [N] u, [N, 2] uv) -> (leaf_id,
    choice_pdf). Picks B with probability ``fraction``, rescaling u each
    step; scenes without Mix materials skip the walk. The same walk as
    ``shading/soa.py``'s, which it runs."""
    from . import soa

    return soa.select_material(materials, textures, mat_id, u, uv[..., 0], uv[..., 1])


def closure_params(materials, textures, leaf_id, choice_pdf, uv):
    """Leaf material ids -> closure params for shading/bsdf.py (glossy
    roughness squared into the microfacet alpha): ``shading/soa.py``'s
    with the colour as [N, 3]."""
    from . import soa

    params = soa.closure_params(materials, textures, leaf_id, choice_pdf,
                                uv[..., 0], uv[..., 1])
    params["color"] = params["color"].stack()
    return params


def emission_and_sided(materials, textures, mat_id, uv):
    """([N, 3] Le, [N] double_sided): ``shading/soa.py``'s with Le as
    [N, 3]."""
    from . import soa

    Le, sided = soa.emission_and_sided(materials, textures, mat_id, uv[..., 0], uv[..., 1])
    return Le.stack(), sided


def emission(materials, textures, mat_id, uv):
    """[N, 3] emitted radiance (zero for non-emissive materials)."""
    return emission_and_sided(materials, textures, mat_id, uv)[0]


def emissive_double_sided(materials, mat_id):
    return materials.double_sided.index_select(0, mat_id)
