"""Built-in scenes (``akari_tpu/scene/builtin.py``): the Cornell box, the
procedural terrain, and two instanced scenes of one terrain prototype.

The Cornell box asset (scenes/cornell_box/) is the public-domain data set
by Guedis Cardenas and Morgan McGuire (Williams College, 2011).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import transform as xform
from .arrays import make_camera
from .nodes import DiffuseMaterial, EmissiveMaterial, Instance, Mesh, Scene
from .obj import load_obj

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "scenes")


def cornell_box_mesh():
    path = os.path.join(_ASSET_DIR, "cornell_box", "CornellBox-Original.obj")
    if os.path.exists(path):
        return load_obj(path)
    return _cornell_box_fallback()


def cornell_box(width=256, height=256, fov_deg=15.0):
    """The canonical workload scene: camera fov 15 at (0, 1, 9)."""
    mesh = cornell_box_mesh()
    c2w = xform.translate((0.0, 1.0, 9.0))  # identity rotation, looks down -Z
    cam = make_camera(c2w, fov_deg, width, height)
    return Scene(shapes=[mesh], camera=cam)


def terrain_mesh(n=512, seed=0):
    """Procedural heightfield: (n-1)^2 quads -> 2*(n-1)^2 triangles.

    The large-scene workload (n=512 -> 522,242 triangles, n=1024 ->
    2,093,058). Deterministic: a fixed sum-of-sines displacement plus
    seeded jitter.
    """
    r = np.random.default_rng(seed)
    xs = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    zs = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = 0.22 * (
        np.sin(3.1 * np.pi * X) * np.cos(2.3 * np.pi * Z)
        + 0.55 * np.sin(7.9 * np.pi * X + 1.1) * np.sin(6.1 * np.pi * Z)
        + 0.3 * np.cos(13.0 * np.pi * (X + Z))
    ) + 0.35
    Y += 0.01 * r.standard_normal(Y.shape)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)

    i = np.arange(n - 1)
    jj, ii = np.meshgrid(i, i, indexing="ij")
    a = (ii * n + jj).ravel()
    b = a + 1
    c = a + n
    d = c + 1
    idx = np.concatenate(
        [np.stack([a, c, b], axis=-1), np.stack([b, c, d], axis=-1)]
    ).astype(np.int64)

    white = DiffuseMaterial((0.73, 0.71, 0.68))
    return Mesh(vertices=verts, indices=idx, materials=[white],
                material_ids=np.zeros(idx.shape[0], np.int64))


def terrain_scene(width=256, height=256, n=512):
    """Terrain + overhead area light; camera looks down at the relief."""
    terrain = terrain_mesh(n)
    light = EmissiveMaterial((14.0, 13.0, 11.0))
    lq = _quad((-0.5, 2.4, 0.5), (-0.5, 2.4, -0.5),
               (0.5, 2.4, -0.5), (0.5, 2.4, 0.5))
    lverts = np.stack(lq).reshape(-1, 3)
    lmesh = Mesh(
        vertices=lverts,
        indices=np.arange(6, dtype=np.int64).reshape(-1, 3),
        materials=[light],
        material_ids=np.zeros(2, np.int64),
    )
    c2w = xform.look_at((1.6, 1.9, 2.3), (0.0, 0.25, 0.0))
    cam = make_camera(c2w, 40.0, width, height)
    return Scene(shapes=[terrain, lmesh], camera=cam)


def forest_transforms(n_instances, spread=6.0, seed=3):
    """Object -> world transforms of the instanced forest: instance k is
    translate(U(-spread, spread), 0, U(-spread, spread)) @ rotate_y(U(0, 2 pi))
    @ scale(s, s, s), s = U(0.5, 1.5), drawn in that order from
    ``np.random.default_rng(seed)``."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_instances):
        tx, tz = float(r.uniform(-spread, spread)), float(r.uniform(-spread, spread))
        theta = float(r.uniform(0.0, 2.0 * np.pi))
        s = float(r.uniform(0.5, 1.5))
        m = xform.translate((tx, 0.0, tz)) @ xform.rotate_y(theta) @ xform.scale((s, s, s))
        out.append(np.asarray(m, np.float32))
    return out


def instanced_forest_scene(width=256, height=256, n_instances=128, n=128):
    """``n_instances`` rotated, scaled copies of ``terrain_mesh(n)`` over
    [-6, 6]^2 under a 4 x 4 downward area light at y = 4. At the defaults
    (128 copies of 32,258 triangles: 4,129,024 world triangles with the
    light's 2) it is above FLATTEN_MAX_TRIS and compiles two-level."""
    proto = terrain_mesh(n)
    shapes = [Instance(proto, m) for m in forest_transforms(n_instances)]
    lq = _quad((-2.0, 4.0, 2.0), (-2.0, 4.0, -2.0), (2.0, 4.0, -2.0), (2.0, 4.0, 2.0))
    shapes.append(Mesh(
        vertices=np.stack(lq).reshape(-1, 3),
        indices=np.arange(6, dtype=np.int64).reshape(-1, 3),
        materials=[EmissiveMaterial((14.0, 13.0, 11.0))],
        material_ids=np.zeros(2, np.int64),
    ))
    c2w = xform.look_at((6.0, 5.0, 9.0), (0.0, 0.3, 0.0))
    return Scene(shapes=shapes, camera=make_camera(c2w, 40.0, width, height))


def instanced_bench_scene(width=256, height=256, n_instances=64, n=128, seed=3):
    """The JAX package's recorded instanced workload (``bench.py``): copies
    of ``terrain_mesh(n)`` at translate(U(-40, 40), 0, U(-40, 40)) from
    ``np.random.default_rng(seed)``, seen by the terrain scene's camera. It
    has no light (its image is black); 64 x 32,258 = 2.06 M world
    triangles, so the bench forces two-level with FLATTEN_MAX_TRIS = 1."""
    proto = terrain_mesh(n)
    r = np.random.default_rng(seed)
    shapes = []
    for _ in range(n_instances):
        t = xform.translate((float(r.uniform(-40, 40)), 0.0, float(r.uniform(-40, 40))))
        shapes.append(Instance(proto, np.asarray(t, np.float32)))
    c2w = xform.look_at((1.6, 1.9, 2.3), (0.0, 0.25, 0.0))
    return Scene(shapes=shapes, camera=make_camera(c2w, 40.0, width, height))


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for the quad p0 p1 p2 p3."""
    return [np.asarray([p0, p1, p2], np.float32), np.asarray([p0, p2, p3], np.float32)]


def _cornell_box_fallback():
    """Programmatic Cornell box with the classic dimensions (x,z in [-1,1],
    y in [0,2]; light quad just under the ceiling). Used if the bundled OBJ
    asset is missing."""
    white = DiffuseMaterial((0.725, 0.71, 0.68))
    red = DiffuseMaterial((0.63, 0.065, 0.05))
    green = DiffuseMaterial((0.14, 0.45, 0.091))
    light = EmissiveMaterial((17.0, 12.0, 4.0))

    tris = []
    mats = []

    def add(quads, m):
        for t in quads:
            tris.append(t)
            mats.append(m)

    add(_quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)), white)    # floor
    add(_quad((-1, 2, 1), (-1, 2, -1), (1, 2, -1), (1, 2, 1)), white)    # ceiling
    add(_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), white)  # back
    add(_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), green)      # right
    add(_quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)), red)    # left
    add(
        _quad(
            (-0.24, 1.98, 0.16), (-0.24, 1.98, -0.22),
            (0.23, 1.98, -0.22), (0.23, 1.98, 0.16),
        ),
        light,
    )

    p = np.stack(tris)  # [F,3,3]
    materials = [white, red, green, light]
    mat_ids = np.asarray([materials.index(m) for m in mats], np.int64)
    verts = p.reshape(-1, 3)
    idx = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return Mesh(vertices=verts, indices=idx, materials=materials, material_ids=mat_ids)
