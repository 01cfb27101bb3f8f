"""Built-in scenes (``akari_tpu/scene/builtin.py``): the Cornell box, the
procedural terrain, two instanced scenes of one terrain prototype, and
the env-lit textured terrain written as scene files (OBJ + MTL + PNG +
.hdr + .akari) for the CLI.

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


def envtex_texture(res, seed=0):
    """[res, res, 3] uint8 seeded albedo texture: a 32 x 32 grid of
    earth-toned cells upsampled, with per-texel noise."""
    r = np.random.default_rng(seed)
    cells = r.uniform((60, 50, 30), (200, 180, 120), (32, 32, 3))
    rep = -(-res // 32)
    img = np.kron(cells, np.ones((rep, rep, 1)))[:res, :res]
    img = img + r.normal(0.0, 8.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def envtex_sky(h, w, seed=0):
    """[h, w, 3] float32 seeded equirectangular sky: a blue gradient above
    the horizon, dark ground below, a small bright sun, per-texel noise."""
    r = np.random.default_rng(seed)
    v = (np.arange(h) + 0.5) / h                       # 0 at +Y (zenith)
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None, None]
    sky = (0.5 + 0.9 * up) * np.asarray([0.55, 0.7, 1.0]) * (v < 0.5)[:, None, None]
    ground = (v >= 0.5)[:, None, None] * np.asarray([0.12, 0.1, 0.08])
    img = np.broadcast_to(sky + ground, (h, w, 3)).copy()
    img *= r.uniform(0.9, 1.1, (h, w, 1))
    cy, cx = int(0.2 * h), int(0.3 * w)
    ry, rx = max(1, h // 64), max(1, w // 128)
    img[cy - ry:cy + ry + 1, cx - rx:cx + rx + 1] = (60.0, 55.0, 45.0)
    return img.astype(np.float32)


def write_envtex_terrain(directory, n=256, res=256, spp=16, depth=5, tex_res=2048,
                         sky_hw=(1024, 2048), seed=0):
    """The env-lit textured terrain as scene files in ``directory``:
    ``terrain_mesh(n)`` with planar texture coordinates as terrain.obj,
    terrain.mtl with ``map_Kd albedo.png`` (a ``tex_res``^2 seeded PNG) and
    the terrain scene's area light (Ke 14 13 11), sky.hdr (a seeded
    ``sky_hw`` RGBE sky), and envtex.akari rendering them at ``res``^2
    with the path tracer under ``EnvMap { image: "sky.hdr" }``. Returns
    the .akari path."""
    from ..core.image import encode_png, write_hdr

    terrain = terrain_mesh(n, seed)
    lq = np.stack(_quad((-0.5, 2.4, 0.5), (-0.5, 2.4, -0.5),
                        (0.5, 2.4, -0.5), (0.5, 2.4, 0.5))).reshape(-1, 3)
    with open(os.path.join(directory, "albedo.png"), "wb") as f:
        f.write(encode_png(envtex_texture(tex_res, seed)))
    write_hdr(os.path.join(directory, "sky.hdr"), envtex_sky(*sky_hw, seed=seed))
    with open(os.path.join(directory, "terrain.mtl"), "w") as f:
        f.write("newmtl ground\nKd 1 1 1\nmap_Kd albedo.png\n"
                "newmtl light\nKd 0 0 0\nKe 14 13 11\n")
    v = terrain.vertices
    nv = v.shape[0]
    uv = np.stack([(v[:, 0] + 1.0) * 0.5, (v[:, 2] + 1.0) * 0.5], axis=-1)
    tri = terrain.indices + 1
    with open(os.path.join(directory, "terrain.obj"), "w") as f:
        f.write("mtllib terrain.mtl\n")
        np.savetxt(f, v, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, lq, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, uv, fmt="vt %.9g %.9g")
        f.write("vt 0 0\nusemtl ground\n")
        np.savetxt(f, np.repeat(tri, 2, axis=1), fmt="f %d/%d %d/%d %d/%d")
        f.write("usemtl light\n")
        lidx = np.arange(6).reshape(2, 3) + 1 + nv
        light_faces = np.stack([lidx, np.full_like(lidx, nv + 1)], axis=-1).reshape(2, 6)
        np.savetxt(f, light_faces, fmt="f %d/%d %d/%d %d/%d")
    akari = os.path.join(directory, "envtex.akari")
    with open(akari, "w") as f:
        f.write(
            "export camera = PerspectiveCamera {\n"
            "    fov: 50, position: [0, 1.5, 2.7], rotation: [-20, 0, 0],\n"
            f"    resolution: [{res}, {res}]\n}}\n"
            'export mesh = AkariMesh { path: "terrain.obj" }\n'
            'export sky = EnvMap { image: "sky.hdr" }\n'
            "export scene = Scene {\n"
            "    camera: $camera,\n"
            f"    integrator: Path {{ spp: {spp}, max_depth: {depth} }},\n"
            "    environment: $sky,\n"
            '    output: "envtex.png",\n'
            "    shapes: [ $mesh ]\n}\n"
        )
    return akari


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
