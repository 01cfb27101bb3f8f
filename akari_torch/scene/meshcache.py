"""Binary mesh cache (``akari_tpu/scene/meshcache.py``): a compressed
``.npz`` with a magic key, written and read in the JAX package's format
(the same ``MAGIC``, keys and dtypes), so a cache written by either
package loads in the other. It skips OBJ re-parsing; a path-keyed
in-memory cache mirrors the reference's resource manager.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = "AKARI_TPU_MESH_V1"

_cache = {}


def save_mesh(path, mesh):
    arrays = {
        "__magic__": np.frombuffer(MAGIC.encode(), dtype=np.uint8),
        "vertices": np.asarray(mesh.vertices, np.float32),
        "indices": np.asarray(mesh.indices, np.int64),
        "material_ids": np.asarray(
            mesh.material_ids
            if mesh.material_ids is not None
            else np.zeros(len(mesh.indices), np.int64)
        ),
    }
    if mesh.corner_normals is not None:
        arrays["corner_normals"] = np.asarray(mesh.corner_normals, np.float32)
    if mesh.corner_uvs is not None:
        arrays["corner_uvs"] = np.asarray(mesh.corner_uvs, np.float32)
    np.savez_compressed(path, **arrays)


def load_mesh(path, materials=None):
    """Load a cached mesh; ``materials`` supplies the material nodes (the
    cache stores per-face material indices only; the materials come from
    the SDL side)."""
    from .nodes import Mesh

    key = os.path.abspath(path)
    if key in _cache:
        data = _cache[key]
    else:
        with np.load(path) as z:
            magic = bytes(z["__magic__"]).decode()
            if magic != MAGIC:
                raise ValueError(f"{path}: bad mesh magic {magic!r}")
            data = {k: z[k] for k in z.files if k != "__magic__"}
        _cache[key] = data
    return Mesh(
        vertices=data["vertices"],
        indices=data["indices"],
        materials=list(materials or []),
        material_ids=data["material_ids"],
        corner_normals=data.get("corner_normals"),
        corner_uvs=data.get("corner_uvs"),
    )


def clear_cache():
    _cache.clear()
