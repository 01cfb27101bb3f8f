"""Instance-aware geometry gathers: prim id -> world-space data
(``akari_tpu/scene/geom.py``).

In a two-level scene (``SceneArrays.instances`` set) a hit carries a
VIRTUAL prim id and triangle storage holds object-space prototype
geometry shared by every instance. These helpers decode the virtual id to
(storage id, instance) and apply the instance's transform, so the
integrator stays instance-agnostic. On a flat scene they are the plain
gathers. ``prim`` must be clamped to >= 0 by the caller (missed lanes are
masked by ``valid``).
"""

from __future__ import annotations

import torch


def decode_prim(scene, prim):
    """Virtual prim id -> (storage id, instance id); flat: (prim, None)."""
    it = scene.instances
    if it is None:
        return prim, None
    inst = torch.searchsorted(it.prim_ends, prim.to(torch.int32), right=True)
    inst = torch.clamp(inst, max=it.prim_ends.shape[0] - 1)
    sid = prim + it.tri_offset.index_select(0, inst)
    return sid, inst


def _apply_affine(m, p):
    """[N, 3, 4] affine rows @ [N, 3] points."""
    return torch.einsum("nij,nj->ni", m[:, :, :3], p) + m[:, :, 3]


def _apply_linear(m, v):
    return torch.einsum("nij,nj->ni", m[:, :, :3], v)


def tri_world(scene, prim):
    """(v0, e1, e2) of triangle ``prim`` in world space, [N, 3] each."""
    sid, inst = decode_prim(scene, prim)
    v0 = scene.tri_v0.index_select(0, sid)
    e1 = scene.tri_e1.index_select(0, sid)
    e2 = scene.tri_e2.index_select(0, sid)
    if inst is not None:
        o2w = scene.instances.o2w.index_select(0, inst)  # [N, 3, 4]
        v0 = _apply_affine(o2w, v0)
        e1 = _apply_linear(o2w, e1)
        e2 = _apply_linear(o2w, e2)
    return v0, e1, e2


def mat_of_prim(scene, prim):
    """Material table id of triangle ``prim``."""
    sid, _ = decode_prim(scene, prim)
    return scene.mat_id.index_select(0, sid)


def uvs_of_prim(scene, prim):
    """Per-corner texture coordinates [N, 3, 2]."""
    sid, _ = decode_prim(scene, prim)
    return scene.uvs.index_select(0, sid)


def normals_world(scene, prim):
    """Per-corner shading normals [N, 3, 3] rotated to world space (not
    renormalized: callers normalize after interpolation)."""
    sid, inst = decode_prim(scene, prim)
    ns_c = scene.normals.index_select(0, sid)
    if inst is not None:
        nrm = scene.instances.nrm.index_select(0, inst)  # [N, 3, 3]
        ns_c = torch.einsum("nij,ncj->nci", nrm, ns_c)
    return ns_c


def light_of_prim(scene, prim):
    """Light id of triangle ``prim`` (-1 if not emissive). Two-level: the
    prototype's light index plus the instance's light base."""
    it = scene.instances
    if it is None:
        return scene.lights.tri_to_light.index_select(0, prim)
    sid, inst = decode_prim(scene, prim)
    local = scene.lights.tri_to_light.index_select(0, sid)
    base = it.light_base.index_select(0, inst)
    return torch.where(local >= 0, base + local, -1)
