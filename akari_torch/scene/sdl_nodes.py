"""SDL node registry: Type names -> scene-node factories.

Counterpart of ``akari_tpu/scene/sdl_nodes.py``: ``PerspectiveCamera``,
``AkariMesh`` (binary mesh cache or OBJ), ``OBJMesh``, ``Instance``, the
material nodes with constant or image-file textures, ``EnvMap``, the
``Path``, ``AO`` and ``BDPT`` integrators and ``Scene``.
"""

from __future__ import annotations

import os

import numpy as np

from ..integrators.ao import AOConfig
from ..integrators.bdpt import BDPTConfig
from ..integrators.path import PathConfig
from .arrays import make_camera
from .nodes import (
    ConstantTexture,
    DiffuseMaterial,
    EmissiveMaterial,
    EnvMapLight,
    GlassMaterial,
    GlossyMaterial,
    ImageTexture,
    Instance,
    MirrorMaterial,
    MixMaterial,
    Scene,
)

REGISTRY = {}


def register_node(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def _texture(v, base_dir="."):
    """SDL value -> texture: arrays and numbers are constants; a string
    names an image file relative to the scene file."""
    if isinstance(v, str):
        return ImageTexture.load(os.path.join(base_dir, v))
    return ConstantTexture.coerce(v)


@register_node("PerspectiveCamera")
def _camera(fields, base_dir="."):
    from ..core import transform as xform

    res = fields.get("resolution", [512, 512])
    position = fields.get("position", [0.0, 0.0, 0.0])
    rotation = np.radians(np.asarray(fields.get("rotation", [0, 0, 0]), np.float64))
    fov = float(fields.get("fov", 80.0))
    c2w = xform.translate(position) @ xform.euler_zyx(rotation)
    return make_camera(
        c2w, fov, int(res[0]), int(res[1]),
        lens_radius=float(fields.get("lens_radius", 0.0)),
        focal_distance=float(fields.get("focal_distance", 0.0)),
    )


@register_node("DiffuseMaterial")
def _diffuse(fields, base_dir="."):
    return DiffuseMaterial(color=_texture(fields.get("color", 0.8), base_dir))


@register_node("GlossyMaterial")
def _glossy(fields, base_dir="."):
    return GlossyMaterial(
        color=_texture(fields.get("color", 1.0), base_dir),
        roughness=_texture(fields.get("roughness", 0.1), base_dir),
    )


@register_node("EmissiveMaterial")
def _emissive(fields, base_dir="."):
    return EmissiveMaterial(
        color=_texture(fields.get("color", 1.0), base_dir),
        double_sided=bool(fields.get("double_sided", False)),
    )


@register_node("MirrorMaterial")
def _mirror(fields, base_dir="."):
    return MirrorMaterial(color=_texture(fields.get("color", 0.9), base_dir))


@register_node("GlassMaterial")
def _glass(fields, base_dir="."):
    return GlassMaterial(
        color=_texture(fields.get("color", [1.0, 1.0, 1.0]), base_dir),
        ior=float(fields.get("ior", 1.5)),
    )


@register_node("MixMaterial")
def _mix(fields, base_dir="."):
    return MixMaterial(
        fraction=_texture(fields.get("fraction", 0.5), base_dir),
        material_a=fields["material_A" if "material_A" in fields else "material_a"],
        material_b=fields["material_B" if "material_B" in fields else "material_b"],
    )


def _load_obj_mesh(path, base_dir, materials=()):
    from . import obj

    full = path if os.path.isabs(path) else os.path.join(base_dir, path)
    m = obj.load_obj(full)
    if materials:
        m.materials = list(materials)
    return m


@register_node("AkariMesh")
def _akari_mesh(fields, base_dir="."):
    """AkariMesh{path, materials[]} over a binary mesh cache (``.npz`` /
    ``.mesh``, ``scene/meshcache.py``) or an OBJ file. A ``.mesh`` path
    also finds ``<path>.npz``; without a cache, the sibling OBJ named by
    dropping ``.mesh`` (``model.obj.mesh`` -> ``model.obj``) is parsed;
    otherwise ``FileNotFoundError``."""
    from . import meshcache

    path = fields["path"]
    full = path if os.path.isabs(path) else os.path.join(base_dir, path)
    materials = fields.get("materials", [])
    if full.endswith((".npz", ".mesh")):
        cache_path = full if os.path.exists(full) else full + ".npz"
        if os.path.exists(cache_path):
            return meshcache.load_mesh(cache_path, materials)
        obj_path = full[: -len(".mesh")] if full.endswith(".mesh") else full
        if os.path.exists(obj_path):
            return _load_obj_mesh(os.path.abspath(obj_path), base_dir, materials)
        raise FileNotFoundError(full)
    return _load_obj_mesh(path, base_dir, materials)


@register_node("OBJMesh")
def _obj_mesh(fields, base_dir="."):
    return _load_obj_mesh(fields["path"], base_dir)


@register_node("Instance")
def _instance(fields, base_dir="."):
    """Placement of a prototype mesh: ``mesh`` (a mesh node or ``$ref``),
    ``translate`` / ``rotate`` (degrees, ZYX Euler) / ``scale`` (scalar or
    3-vector), or a full ``transform`` (16 numbers, row-major); optional
    ``materials`` override list."""
    from ..core import transform as xform

    if "transform" in fields:
        m = np.asarray(fields["transform"], np.float64).reshape(4, 4)
    else:
        t = xform.translate(fields.get("translate", [0, 0, 0]))
        r = xform.euler_zyx(
            np.radians(np.asarray(fields.get("rotate", [0, 0, 0]), np.float64))
        )
        s = np.asarray(fields.get("scale", 1.0), np.float64)
        s = np.broadcast_to(np.atleast_1d(s), (3,))
        m = t @ r @ np.diag([s[0], s[1], s[2], 1.0])
    return Instance(
        mesh=fields["mesh"],
        transform=np.asarray(m, np.float32),
        materials=fields.get("materials") or None,
    )


@register_node("Path")
def _path(fields, base_dir="."):
    """spp/max_depth/ray_clamp/mis; tile_size is accepted and ignored."""
    return PathConfig(
        spp=int(fields.get("spp", 16)),
        max_depth=int(fields.get("max_depth", 5)),
        ray_clamp=float(fields.get("ray_clamp", 10.0)),
        mis=bool(fields.get("mis", True)),
    )


@register_node("BDPT")
def _bdpt(fields, base_dir="."):
    return BDPTConfig(
        spp=int(fields.get("spp", 16)),
        eye_depth=int(fields.get("eye_depth", fields.get("max_depth", 4))),
        light_depth=int(fields.get("light_depth", 3)),
        ray_clamp=float(fields.get("ray_clamp", 20.0)),
        max_vertices=int(fields.get("max_vertices", 0)),
        light_tracing=bool(fields.get("light_tracing", True)),
    )


@register_node("AO")
def _ao(fields, base_dir="."):
    return AOConfig(
        spp=int(fields.get("spp", 16)),
        occlude_distance=float(fields.get("occlude", 1e30)),
    )


@register_node("EnvMap")
def _envmap(fields, base_dir="."):
    """Environment light: EnvMap { image: "sky.hdr", scale: 1.0 }."""
    img = fields.get("image")
    if isinstance(img, str):
        img = os.path.join(base_dir, img)
    return EnvMapLight(image=img, scale=float(fields.get("scale", 1.0)))


@register_node("Scene")
def _scene(fields, base_dir="."):
    shapes = fields.get("shapes", [])
    if not isinstance(shapes, list):
        shapes = [shapes]
    return Scene(
        shapes=shapes,
        camera=fields.get("camera"),
        integrator=fields.get("integrator"),
        environment=fields.get("environment"),
        output=fields.get("output", "out.png"),
    )
