"""Wavefront OBJ + MTL importer -> Mesh node (``akari_tpu/scene/obj.py``).

Per-face material indices, normal/texcoord handling and the reference
importer's MTL translation heuristics: Ke -> Emissive, illum 4/6/7 ->
Glass, Ks/Kd -> Diffuse, Glossy or a Diffuse/Glossy Mix with
shininess -> roughness sqrt(2/(Ns+2)). Pure Python/NumPy, run once at
scene-build time. Image textures (``map_Kd``) arrive with slice 4.
"""

from __future__ import annotations

import os

import numpy as np

from .nodes import (
    DiffuseMaterial,
    EmissiveMaterial,
    GlassMaterial,
    GlossyMaterial,
    Mesh,
    MixMaterial,
)


def _parse_mtl(path):
    """MTL file -> {name: material node} using the importer heuristics."""
    mats = {}
    cur = None

    def finalize(m):
        kd = np.asarray(m.get("Kd", (0.8, 0.8, 0.8)), np.float32)
        ks = np.asarray(m.get("Ks", (0.0, 0.0, 0.0)), np.float32)
        ke = np.asarray(m.get("Ke", (0.0, 0.0, 0.0)), np.float32)
        ns = float(m.get("Ns", 10.0))
        map_kd = m.get("map_Kd")

        if np.any(ke > 0.0):
            return EmissiveMaterial(color=tuple(ke))
        # transparent illumination models -> dielectric glass (extension
        # past the reference importer, which has no glass material)
        if int(m.get("illum", 2)) in (4, 6, 7):
            return GlassMaterial(ior=float(m.get("Ni", 1.5)))
        if map_kd:
            raise NotImplementedError(
                f"map_Kd {map_kd!r}: image textures arrive with slice 4"
            )
        color = tuple(kd)
        diffuse = DiffuseMaterial(color=color)
        strength = float(ks.max())
        if strength <= 1e-4:
            return diffuse
        roughness = float(np.sqrt(2.0 / (ns + 2.0)))
        glossy = GlossyMaterial(color=tuple(ks), roughness=roughness)
        if strength >= 1.0 - 1e-4:
            return glossy
        # fraction = probability of picking B (glossy), as in the reference's
        # MixMaterial translation.
        return MixMaterial(fraction=strength, material_a=diffuse, material_b=glossy)

    raw = {}
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = parts[1]
                raw[cur] = {}
            elif cur is not None and key in ("Kd", "Ks", "Ke", "Ka"):
                raw[cur][key] = tuple(float(x) for x in parts[1:4])
            elif cur is not None and key in ("Ns", "Ni"):
                raw[cur][key] = float(parts[1])
            elif cur is not None and key == "illum":
                raw[cur][key] = int(float(parts[1]))
            elif cur is not None and key == "map_Kd":
                raw[cur][key] = os.path.join(base, parts[-1])
    for name, m in raw.items():
        mats[name] = finalize(m)
    return mats


def load_obj(path, default_material=None):
    """Load an OBJ file into a single Mesh with per-face materials.

    Handles: v/vn/vt, f with v, v/t, v//n, v/t/n forms, negative (relative)
    indices, polygon fan-triangulation, usemtl groups, mtllib.
    """
    positions, normals, texcoords = [], [], []
    face_v, face_t, face_n, face_m = [], [], [], []
    materials = []
    mat_index = {}
    mtl_lib = {}
    cur_mat = -1
    base = os.path.dirname(os.path.abspath(path))

    def resolve(i, n):
        i = int(i)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                p = os.path.join(base, " ".join(parts[1:]))
                if os.path.exists(p):
                    mtl_lib.update(_parse_mtl(p))
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in mat_index:
                    mat = mtl_lib.get(name)
                    if mat is None:
                        mat = default_material or DiffuseMaterial()
                    mat_index[name] = len(materials)
                    materials.append(mat)
                cur_mat = mat_index[name]
            elif key == "f":
                corners = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = (
                        resolve(comps[1], len(texcoords))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        resolve(comps[2], len(normals))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    face_v.append([c[0] for c in tri])
                    face_t.append([c[1] for c in tri])
                    face_n.append([c[2] for c in tri])
                    face_m.append(cur_mat)

    if not materials:
        materials = [default_material or DiffuseMaterial()]
    face_m = np.asarray(face_m, np.int64)
    face_m = np.where(face_m < 0, 0, face_m)

    pos = np.asarray(positions, np.float32)
    fv = np.asarray(face_v, np.int64)
    p = pos[fv]  # [F,3,3]

    corner_normals = None
    if normals:
        nrm = np.asarray(normals, np.float32)
        fn = np.asarray(face_n, np.int64)
        if np.all(fn >= 0):
            corner_normals = nrm[fn]
    corner_uvs = None
    if texcoords:
        uvs = np.asarray(texcoords, np.float32)
        ft = np.asarray(face_t, np.int64)
        if np.all(ft >= 0):
            corner_uvs = uvs[ft]

    return Mesh(
        vertices=pos,
        indices=fv,
        materials=materials,
        material_ids=face_m,
        corner_normals=corner_normals,
        corner_uvs=corner_uvs,
    )
