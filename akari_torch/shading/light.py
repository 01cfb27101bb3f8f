"""Light-triangle data (``akari_tpu/shading/light.py``): the per-light
resolved table of flat scenes and the world-space triangles of two-level
ones."""

from __future__ import annotations

import torch

from ..core.vecmath import cross, dot, maximum
from ..scene import geom
from .material import _resolved_closure_table


def _light_tri_data(scene, tri):
    """World-space (v0, e1, e2, ng, area) of light triangles ``tri``
    (virtual prim ids on a two-level scene: geometry moved by the owning
    instance, scene/geom.py)."""
    v0, e1, e2 = geom.tri_world(scene, tri)
    ng_raw = cross(e1, e2)
    area2 = torch.sqrt(maximum(dot(ng_raw, ng_raw), 1e-20))
    ng = ng_raw / area2[..., None]
    area = 0.5 * area2
    return v0, e1, e2, ng, area


def _light_uv(scene, tri, b0, b1):
    """Texture coordinates [N] u, [N] v at barycentrics (b0, b1) of light
    triangles ``tri`` (virtual prim ids on a two-level scene)."""
    uvs = geom.uvs_of_prim(scene, tri)  # [N, 3, 2]
    w0 = 1.0 - b0 - b1
    uv = uvs[:, 0] * w0[:, None] + uvs[:, 1] * b0[:, None] + uvs[:, 2] * b1[:, None]
    return uv[:, 0], uv[:, 1]


def _light_fat_table(scene):
    """[L, 17] per-light resolved data: one row gather per NEE sample.

    Columns: v0(0:3) e1(3:6) e2(6:9) ng(9:12) area(12) em(13:16) ds(16).
    Flat constant-texture scenes only.
    """
    tri = scene.lights.tri_id
    v0 = scene.tri_v0.index_select(0, tri)
    e1 = scene.tri_e1.index_select(0, tri)
    e2 = scene.tri_e2.index_select(0, tri)
    ng_raw = cross(e1, e2)
    area2 = torch.sqrt(maximum(dot(ng_raw, ng_raw), 1e-20))
    ng = ng_raw / area2[..., None]
    area = 0.5 * area2
    mat_id = scene.mat_id.index_select(0, tri)
    ct = _resolved_closure_table(scene.materials, scene.textures)
    fat = ct.index_select(0, mat_id)
    em, ds = fat[:, 5:8], fat[:, 8:9]
    return torch.cat([v0, e1, e2, ng, area[:, None], em, ds], dim=1)
