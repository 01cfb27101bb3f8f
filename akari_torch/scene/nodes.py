"""Host-side scene graph and its compile to ``SceneArrays``.

Counterpart of ``akari_tpu/scene/nodes.py`` (node dataclasses and
``compile_scene``). Flat compile: meshes are merged, materials and
textures become flat tables (image textures padded and stacked), triangles
are stored in SBVH leaf order, emissive triangles become the light table
with a power CDF, an environment light its texel CDF and NEE mixture
probability (``_compile_env``), and the ``[T, 32]`` ``prim_table`` gathers
every per-hit attribute into one row.
Two-level compile (``_compile_instanced``): each prototype mesh is stored
once in object space with its own BVH, instances carry transforms, and the
per-prototype kernel tables of the instanced route are built.

The compile runs on the host in NumPy, then moves its tensors to
``device``: ``"cuda"`` by default, with no fallback (without a CUDA device
it raises; pass ``device="cpu"`` for CPU tensors, as the tests do).
``compile_seconds`` times the host compile alone.

Intersector names of the port: ``"dense"`` selects the dense all-pairs
intersector and ``"tree"`` the BVH2 tree walk (each the CUDA kernel on CUDA
tensors, its plain PyTorch version on CPU tensors); ``"auto"`` resolves
to ``"dense"`` at or under DENSE_MAX_TRIS (4096) storage triangles and to
``"tree"`` above, the reference's route (``pallas_intersect.py:381-385``)
without its TPU backend gate and TPU ceilings; ``"brute"`` selects the
all-pairs CPU oracle. The tree tables are built for every scene above
DENSE_MAX_TRIS, as the reference builds them, and for ``"tree"`` at any
size.

Instanced scenes (shapes holding ``Instance`` nodes) of at most
FLATTEN_MAX_TRIS world triangles are flattened to world space and compiled
flat, as the reference does. Larger ones compile two-level: ``"auto"`` and
``"tree"`` then take the instanced route (the instanced tree walk), and
``"dense"`` and ``"brute"`` raise ``ValueError`` (the reference sends them
to its XLA two-level traversal, which the port does not have). Set the
module constant FLATTEN_MAX_TRIS to 1 to force two-level at small size.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np

from ..bvh.build import build_aabb_bvh, build_bvh
from ..bvh.cluster_tree import (
    TRI_TILE,
    build_cluster_tree,
    build_clusters,
    build_superclusters,
    n_clusters,
    n_superclusters,
    pick_leaf_span,
    tri_blocks,
)
from ..core.device import target_device
from ..core.distribution import build_cdf
from ..core.spectrum import luminance
from .arrays import (
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_MIRROR,
    MAT_MIX,
    TEX_CONSTANT,
    TEX_IMAGE,
    from_numpy_scene,
)

INTERSECTORS = ("auto", "dense", "tree", "brute")

# Above this many storage triangles "auto" takes the tree walk
# (``akari_tpu/ops/pallas_intersect.py:250``).
DENSE_MAX_TRIS = 4096

# Instanced scenes of at most this many world triangles are flattened and
# compiled flat; larger ones compile two-level (``akari_tpu/scene/nodes.py``).
FLATTEN_MAX_TRIS = 4_000_000


def resolve_intersector(intersector, n_tris):
    """"auto" -> "dense" at or under DENSE_MAX_TRIS triangles, else "tree"."""
    if intersector != "auto":
        return intersector
    return "dense" if n_tris <= DENSE_MAX_TRIS else "tree"


# --------------------------------------------------------------------------
# Texture and material nodes
# --------------------------------------------------------------------------

@dataclass
class ConstantTexture:
    value: tuple  # rgb

    @staticmethod
    def coerce(v):
        """Scalar/3-tuple/texture -> texture."""
        if isinstance(v, (ConstantTexture, ImageTexture)):
            return v
        if np.isscalar(v):
            return ConstantTexture((float(v),) * 3)
        v = tuple(float(x) for x in np.asarray(v).reshape(-1)[:3])
        return ConstantTexture(v)


@dataclass
class ImageTexture:
    image: np.ndarray  # [H, W, 3] linear float32
    multiplier: tuple = (1.0, 1.0, 1.0)
    path: Optional[str] = None  # source file

    @staticmethod
    def load(path):
        from ..core.image import read_image

        return ImageTexture(read_image(path), path=os.path.abspath(path))


@dataclass
class DiffuseMaterial:
    color: object = (0.8, 0.8, 0.8)


@dataclass
class GlossyMaterial:
    color: object = (1.0, 1.0, 1.0)
    roughness: object = 0.1


@dataclass
class EmissiveMaterial:
    color: object = (1.0, 1.0, 1.0)
    double_sided: bool = False


@dataclass
class MirrorMaterial:
    """Perfect mirror (delta reflection with a tint)."""

    color: object = (0.9, 0.9, 0.9)


@dataclass
class GlassMaterial:
    """Smooth dielectric (delta reflect + refract, Fresnel-weighted)."""

    color: object = (1.0, 1.0, 1.0)
    ior: float = 1.5


@dataclass
class MixMaterial:
    fraction: object  # scalar/texture; probability of picking material B
    material_a: object = None
    material_b: object = None


@dataclass
class EnvMapLight:
    """Infinite environment (dome) light. ``image`` is an equirectangular
    linear radiance map: an [H, W, 3] array, an ImageTexture, or a path
    (.hdr / .png / .npy through core/image.read_image); ``scale``
    multiplies it."""

    image: object
    scale: float = 1.0

    def load_image(self):
        img = self.image
        if isinstance(img, ImageTexture):
            img = img.image
        elif isinstance(img, str):
            from ..core.image import read_image

            img = read_image(img)
        img = np.asarray(img, np.float32) * np.float32(self.scale)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])


# --------------------------------------------------------------------------
# Shape and scene nodes
# --------------------------------------------------------------------------

@dataclass
class Mesh:
    """Triangle mesh: indexed vertices with optional per-vertex attributes.

    ``material_ids`` maps each face to an entry of ``materials``.
    """

    vertices: np.ndarray            # [V, 3]
    indices: np.ndarray             # [F, 3] int
    materials: list = field(default_factory=list)
    material_ids: Optional[np.ndarray] = None  # [F] int into materials
    normals: Optional[np.ndarray] = None       # [V, 3] per-vertex
    uvs: Optional[np.ndarray] = None           # [V, 2] per-vertex
    corner_normals: Optional[np.ndarray] = None  # [F, 3, 3]
    corner_uvs: Optional[np.ndarray] = None      # [F, 3, 2]
    transform: Optional[np.ndarray] = None       # [4, 4]


@dataclass
class Instance:
    """A placement of a prototype ``Mesh`` with its own object -> world
    transform. All instances of one prototype share its triangle storage
    and BLAS in a two-level compile. ``materials`` overrides the
    prototype's material list (a distinct override list makes a distinct
    prototype, since face -> material ids live in shared storage)."""

    mesh: Mesh
    transform: np.ndarray                  # [4, 4] object -> world
    materials: Optional[list] = None


@dataclass
class Scene:
    shapes: list = field(default_factory=list)   # [Mesh | Instance]
    camera: object = None                        # arrays.Camera
    integrator: object = None                    # PathConfig
    environment: object = None                   # EnvMapLight or None
    output: str = "out.png"

    def compile(self, intersector="auto", device="cuda"):
        return compile_scene(
            self.shapes, intersector=intersector,
            environment=self.environment, device=device,
        )


def _flatten_mesh(mesh):
    """Mesh -> per-triangle (p0,p1,p2, corner normals, corner uvs)."""
    from ..core import transform as xform

    verts = np.asarray(mesh.vertices, dtype=np.float32)
    idx = np.asarray(mesh.indices, dtype=np.int64).reshape(-1, 3)
    if mesh.transform is not None:
        verts = xform.apply_point(np.asarray(mesh.transform, np.float32), verts)
    p = verts[idx]  # [F, 3, 3]

    if mesh.corner_normals is not None:
        n = np.asarray(mesh.corner_normals, dtype=np.float32)
        if mesh.transform is not None:
            n = xform.apply_normal(mesh.transform, n.reshape(-1, 3)).reshape(n.shape)
    elif mesh.normals is not None:
        nv = np.asarray(mesh.normals, dtype=np.float32)
        if mesh.transform is not None:
            nv = xform.apply_normal(mesh.transform, nv)
        n = nv[idx]
    else:
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        ng = np.cross(e1, e2)
        norm = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.where(norm > 0, norm, 1.0)
        n = np.repeat(ng[:, None, :], 3, axis=1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = (n / np.where(norm > 0, norm, 1.0)).astype(np.float32)

    if mesh.corner_uvs is not None:
        uv = np.asarray(mesh.corner_uvs, dtype=np.float32)
    elif mesh.uvs is not None:
        uv = np.asarray(mesh.uvs, dtype=np.float32)[idx]
    else:
        uv = np.zeros((idx.shape[0], 3, 2), dtype=np.float32)

    mat_ids = (
        np.zeros(idx.shape[0], dtype=np.int64)
        if mesh.material_ids is None
        else np.asarray(mesh.material_ids, dtype=np.int64)
    )
    return p, n, uv, mat_ids


def _flatten_instances(shapes):
    """Instances -> transformed Mesh copies in world space. Material
    objects are shared, so the tables dedupe as in the two-level compile."""
    import dataclasses

    out = []
    for s in shapes:
        if not isinstance(s, Instance):
            out.append(s)
            continue
        m = s.mesh
        base = np.eye(4) if m.transform is None else np.asarray(m.transform, np.float64)
        combined = np.asarray(s.transform, np.float64) @ base
        out.append(
            dataclasses.replace(
                m,
                transform=combined.astype(np.float32),
                materials=list(s.materials) if s.materials is not None
                else m.materials,
            )
        )
    return out


class _TableBuilder:
    """Assigns ids while deduplicating by object identity."""

    def __init__(self):
        self.ids = {}
        self.items = []

    def add(self, obj):
        key = id(obj)
        if key not in self.ids:
            self.ids[key] = len(self.items)
            self.items.append(obj)
        return self.ids[key]


def _compile_textures_materials(materials):
    """Walk the material graph -> (mats, material table, texture table, texs)
    as NumPy namespaces with the reference's attribute names."""
    mats = _TableBuilder()
    texs = _TableBuilder()
    images = []

    def tex_id(t):
        if not isinstance(t, (ConstantTexture, ImageTexture)) and not (
            np.isscalar(t) or isinstance(t, (tuple, list, np.ndarray))
        ):
            raise TypeError(f"texture {type(t).__name__}: expected a constant or an image")
        return texs.add(ConstantTexture.coerce(t))

    # Seed: walk mix graphs to register everything.
    pending = list(materials)
    seen = set()
    while pending:
        m = pending.pop()
        if id(m) in seen:
            continue
        seen.add(id(m))
        mats.add(m)
        if isinstance(m, MixMaterial):
            pending.append(m.material_a)
            pending.append(m.material_b)

    M = len(mats.items)
    kind = np.zeros(M, np.int32)
    color_tex = np.zeros(M, np.int32)
    roughness_tex = np.zeros(M, np.int32)
    fraction_tex = np.zeros(M, np.int32)
    mix_a = np.zeros(M, np.int32)
    mix_b = np.zeros(M, np.int32)
    double_sided = np.zeros(M, bool)
    ior = np.full(M, 1.5, np.float32)

    for i, m in enumerate(list(mats.items)):
        if isinstance(m, DiffuseMaterial):
            kind[i] = MAT_DIFFUSE
            color_tex[i] = tex_id(m.color)
        elif isinstance(m, GlossyMaterial):
            kind[i] = MAT_GLOSSY
            color_tex[i] = tex_id(m.color)
            roughness_tex[i] = tex_id(m.roughness)
        elif isinstance(m, EmissiveMaterial):
            kind[i] = MAT_EMISSIVE
            color_tex[i] = tex_id(m.color)
            double_sided[i] = bool(m.double_sided)
        elif isinstance(m, MirrorMaterial):
            kind[i] = MAT_MIRROR
            color_tex[i] = tex_id(m.color)
        elif isinstance(m, GlassMaterial):
            kind[i] = MAT_GLASS
            color_tex[i] = tex_id(m.color)
            ior[i] = float(m.ior)
        elif isinstance(m, MixMaterial):
            kind[i] = MAT_MIX
            fraction_tex[i] = tex_id(m.fraction)
            mix_a[i] = mats.ids[id(m.material_a)]
            mix_b[i] = mats.ids[id(m.material_b)]
        else:
            raise TypeError(f"unknown material node {type(m)}")

    X = len(texs.items)
    t_kind = np.zeros(X, np.int32)
    t_value = np.ones((X, 3), np.float32)
    t_image = np.zeros(X, np.int32)
    for i, t in enumerate(texs.items):
        if isinstance(t, ConstantTexture):
            t_kind[i] = TEX_CONSTANT
            t_value[i] = np.asarray(t.value, np.float32)
        else:
            t_kind[i] = TEX_IMAGE
            t_value[i] = np.asarray(t.multiplier, np.float32)
            t_image[i] = len(images)
            images.append(np.asarray(t.image, np.float32))

    if images:
        hm = max(im.shape[0] for im in images)
        wm = max(im.shape[1] for im in images)
        stack = np.zeros((len(images), hm, wm, 3), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            stack[i, : im.shape[0], : im.shape[1]] = im[..., :3]
            sizes[i] = (im.shape[0], im.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)

    mat_table = SimpleNamespace(
        kind=kind, color_tex=color_tex, roughness_tex=roughness_tex,
        fraction_tex=fraction_tex, mix_a=mix_a, mix_b=mix_b,
        double_sided=double_sided, ior=ior,
        has_mix=bool((kind == MAT_MIX).any()),
    )
    tex_table = SimpleNamespace(
        kind=t_kind, value=t_value, image_id=t_image, images=stack,
        image_sizes=sizes, has_images=bool(images),
    )
    return mats, mat_table, tex_table, texs


def _texture_mean(texs, tex_idx):
    """Host-side mean luminance of a texture, for light power."""
    t = texs.items[tex_idx]
    if isinstance(t, ConstantTexture):
        return float(luminance(np.asarray(t.value, np.float32)))
    mean_rgb = t.image.reshape(-1, 3).mean(axis=0) * np.asarray(t.multiplier)
    return float(luminance(mean_rgb.astype(np.float32)))


def _compile_env(environment, area_power_total):
    """EnvMapLight -> (env_image, env_cdf, env_pmf, env_p_select), in the
    reference's float64 host arithmetic.

    Texel weights are luminance * sin(theta) (the equirectangular area
    measure); the flattened CDF gives one-searchsorted importance sampling
    (shading/soa.py env_sample). NEE picks the environment with
    probability env_power / (env_power + area_power), clipped to [0.05,
    0.95] (1 without area lights)."""
    img = environment.load_image()
    he = img.shape[0]
    lum = (
        img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
    ).astype(np.float64)
    sin_t = np.sin((np.arange(he, dtype=np.float64) + 0.5) / he * np.pi)
    weight = lum * sin_t[:, None]
    pmf, cdf = build_cdf(weight.reshape(-1))
    # total env power ~ mean radiance integrated over the sphere
    env_power = float((lum * sin_t[:, None]).mean() * 2.0 * np.pi * np.pi)
    p_sel = 1.0 if area_power_total <= 0.0 else env_power / (
        env_power + float(area_power_total)
    )
    p_sel = float(np.clip(p_sel, 0.05, 1.0 if area_power_total <= 0 else 0.95))
    return dict(
        env_image=img.astype(np.float32),
        env_cdf=cdf.astype(np.float32),
        env_pmf=pmf.astype(np.float32),
        env_p_select=np.float32(p_sel),
    )


def compile_scene(shapes, intersector="auto", environment=None, device="cuda"):
    """Merge meshes, build materials/lights/BVH -> ``SceneArrays`` on
    ``device`` (``"cuda"`` unless the caller asks for another; no
    fallback). Shapes may mix ``Mesh`` and ``Instance`` (module
    docstring)."""
    device = target_device(device, "compile_scene")
    return _compile_host(shapes, intersector, environment).to(device)


def _compile_host(shapes, intersector, environment):
    """The compile on the host: CPU ``SceneArrays`` with
    ``compile_seconds``."""
    t_start = time.perf_counter()
    if intersector not in INTERSECTORS:
        raise ValueError(
            f"intersector {intersector!r}: expected one of {list(INTERSECTORS)}"
        )
    for s in shapes:
        if not isinstance(s, (Mesh, Instance)):
            raise TypeError(f"shape {type(s).__name__}: expected Mesh or Instance")
    if any(isinstance(s, Instance) for s in shapes):
        total = sum(
            len(np.asarray(s.mesh.indices if isinstance(s, Instance) else s.indices))
            for s in shapes
        )
        if total > FLATTEN_MAX_TRIS:
            if intersector in ("dense", "brute"):
                raise ValueError(
                    f"intersector {intersector!r} on a two-level scene ({total} "
                    "world triangles): use 'auto' or 'tree'"
                )
            return _compile_instanced(shapes, t_start, environment)
        shapes = _flatten_instances(shapes)
    all_p, all_n, all_uv, all_mid = [], [], [], []
    global_materials = []
    for mesh in shapes:
        p, n, uv, mid = _flatten_mesh(mesh)
        base = len(global_materials)
        global_materials.extend(mesh.materials or [DiffuseMaterial()])
        all_p.append(p)
        all_n.append(n)
        all_uv.append(uv)
        all_mid.append(mid + base)
    p = np.concatenate(all_p) if all_p else np.zeros((0, 3, 3), np.float32)
    n = np.concatenate(all_n)
    uv = np.concatenate(all_uv)
    mid = np.concatenate(all_mid)

    mats, mat_table, tex_table, texs = _compile_textures_materials(global_materials)
    top_ids = np.asarray([mats.ids[id(m)] for m in global_materials], np.int32)
    face_mat = top_ids[mid]

    t_bvh = time.perf_counter()
    bvh, order = build_bvh(p[:, 0], p[:, 1], p[:, 2])
    t_bvh = time.perf_counter() - t_bvh
    order = np.asarray(order, np.int64)
    n_orig = p.shape[0]
    # With SBVH spatial splits a triangle may occupy several storage slots.
    # Lights are enumerated over ORIGINAL triangles, so a duplicated
    # emitter's power is counted once.
    emissive_orig = mat_table.kind[face_mat] == MAT_EMISSIVE
    light_orig = np.nonzero(emissive_orig)[0]
    # canonical (first) storage copy of each original triangle
    first_copy = np.full(n_orig, -1, np.int64)
    rev = np.arange(order.shape[0] - 1, -1, -1, dtype=np.int64)
    first_copy[order[rev]] = rev
    p, n, uv, face_mat = p[order], n[order], uv[order], face_mat[order]

    v0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]

    # Light table: every emissive triangle is an area light with power
    # emission_mean * area. tri_id is the canonical storage copy;
    # tri_to_light maps EVERY storage copy to the same light.
    light_tris = first_copy[light_orig].astype(np.int32)
    if light_tris.size > 0:
        areas = 0.5 * np.linalg.norm(
            np.cross(e1[light_tris], e2[light_tris]), axis=-1
        )
        power = np.asarray(
            [
                _texture_mean(texs, mat_table.color_tex[face_mat[t]])
                for t in light_tris
            ]
        ) * areas
        pdf, cdf = build_cdf(power)
        area_power_total = float(power.sum())
        light_of_orig = np.full(n_orig, -1, np.int32)
        light_of_orig[light_orig] = np.arange(light_orig.size, dtype=np.int32)
        lights = SimpleNamespace(
            tri_id=light_tris, cdf=cdf, pdf=pdf,
            tri_to_light=light_of_orig[order],
            n_lights=int(light_tris.size),
        )
    else:
        area_power_total = 0.0
        lights = SimpleNamespace(
            tri_id=np.zeros(1, np.int32),
            cdf=np.asarray([0.0, 1.0], np.float32),
            pdf=np.ones(1, np.float32),
            tri_to_light=np.full(max(v0.shape[0], 1), -1, np.int32),
            n_lights=0,
        )
    env = {} if environment is None else _compile_env(environment, area_power_total)

    t_count = v0.shape[0]
    intersector = resolve_intersector(intersector, t_count)
    # Cluster boxes and the BVH2 over them (the tree walk's tables), built
    # past the dense sweep's break-even as the reference builds them.
    tri_clusters = tri_superclusters = tri_tree = blocks = None
    tree_leaf_span = 1
    t_tree = time.perf_counter()
    if t_count > DENSE_MAX_TRIS or intersector == "tree":
        tri_clusters = build_clusters(v0, e1, e2)
        tri_superclusters = build_superclusters(tri_clusters, t_count)
        tri_tree, tree_leaf_span = build_cluster_tree(tri_clusters, t_count)
        blocks = tri_blocks(v0, e1, e2)
    t_tree = time.perf_counter() - t_tree

    # Fat shading table: all per-hit attributes behind ONE row gather.
    light_sel_pdf = np.where(
        lights.tri_to_light >= 0,
        np.asarray(lights.pdf)[np.maximum(lights.tri_to_light, 0)],
        0.0,
    ).astype(np.float32)
    prim_table = np.zeros((t_count, 32), np.float32)
    prim_table[:, 0:3] = v0
    prim_table[:, 3:6] = e1
    prim_table[:, 6:9] = e2
    prim_table[:, 9:18] = n.reshape(t_count, 9)
    prim_table[:, 18:24] = uv.reshape(t_count, 6)
    prim_table[:, 24] = face_mat.astype(np.float32)  # exact for < 2^24 mats
    prim_table[:, 25] = light_sel_pdf

    compiled = SimpleNamespace(
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        normals=n, uvs=uv, mat_id=face_mat,
        materials=mat_table, textures=tex_table, lights=lights,
        bvh=SimpleNamespace(**bvh),
        prim_table=prim_table,
        prim_to_orig=order.astype(np.int32),
        tri_clusters=tri_clusters,
        tri_superclusters=tri_superclusters,
        tri_tree=tri_tree,
        tri_blocks=blocks,
        tree_leaf_span=tree_leaf_span,
        n_tris=int(v0.shape[0]),
        n_materials=len(mats.items),
        **env,
    )
    scene = from_numpy_scene(compiled, intersector=intersector, device="cpu")
    scene.compile_seconds = dict(
        bvh=t_bvh, tree=t_tree, total=time.perf_counter() - t_start
    )
    return scene


def _compile_instanced(shapes, t_start, environment=None):
    """Two-level compile (``akari_tpu/scene/nodes.py::_compile_instanced``
    with ``intersector="pallas"``): shared prototype storage + BLASes, a
    TLAS over instance world boxes, and the per-prototype kernel tables.

    Every shape becomes an instance (a plain ``Mesh`` with the identity).
    Prototypes are keyed by (mesh identity, materials-override identity).
    Lights are enumerated per (instance, emissive prototype triangle) with
    world-space areas. The reference's TPU ceiling on prototype storage
    (``INSTANCED_PALLAS_MAX_TRIS``) is not kept.
    """
    insts = []  # (mesh, materials override or None, o2w [4, 4])
    for s in shapes:
        if isinstance(s, Instance):
            insts.append((s.mesh, s.materials, np.asarray(s.transform, np.float64)))
        else:
            insts.append((s, None, np.eye(4)))

    # ---- prototypes -----------------------------------------------------
    proto_key_to_idx = {}
    protos = []
    global_materials = []
    inst_proto = np.zeros(len(insts), np.int64)
    for i, (mesh, mats_over, _) in enumerate(insts):
        key = (id(mesh), id(mats_over) if mats_over is not None else None)
        if key not in proto_key_to_idx:
            p, n, uv, mid = _flatten_mesh(mesh)
            mats = list(mats_over if mats_over is not None
                        else (mesh.materials or [DiffuseMaterial()]))
            base = len(global_materials)
            global_materials.extend(mats)
            proto_key_to_idx[key] = len(protos)
            protos.append(dict(p=p, n=n, uv=uv, mid=mid + base))
        inst_proto[i] = proto_key_to_idx[key]

    mats, mat_table, tex_table, texs = _compile_textures_materials(global_materials)
    top_ids = np.asarray([mats.ids[id(m)] for m in global_materials], np.int32)

    # ---- per-prototype BLAS + storage order -----------------------------
    t_bvh = time.perf_counter()
    blas_nodes, proto_tri_base, proto_n_storage, proto_lights = [], [], [], []
    all_v0, all_e1, all_e2 = [], [], []
    all_n, all_uv, all_mid, all_t2l, all_p2o = [], [], [], [], []
    tri_cursor = 0
    for pr in protos:
        p, nrm_c, uv, mid = pr["p"], pr["n"], pr["uv"], pr["mid"]
        face_mat = top_ids[mid]
        bvh, order = build_bvh(p[:, 0], p[:, 1], p[:, 2])
        order = np.asarray(order, np.int64)
        n_orig = p.shape[0]
        light_orig = np.nonzero(mat_table.kind[face_mat] == MAT_EMISSIVE)[0]
        first_copy = np.full(n_orig, -1, np.int64)
        rev = np.arange(order.shape[0] - 1, -1, -1, dtype=np.int64)
        first_copy[order[rev]] = rev
        p_s, n_s, uv_s, fm_s = p[order], nrm_c[order], uv[order], face_mat[order]
        v0 = p_s[:, 0]
        e1 = p_s[:, 1] - p_s[:, 0]
        e2 = p_s[:, 2] - p_s[:, 0]
        light_of_orig = np.full(n_orig, -1, np.int32)
        light_of_orig[light_orig] = np.arange(light_orig.size, dtype=np.int32)
        canon = first_copy[light_orig]  # prototype-local storage slot per light
        proto_lights.append(dict(
            canon=canon.astype(np.int64),
            e1=e1[canon].astype(np.float64) if canon.size else np.zeros((0, 3)),
            e2=e2[canon].astype(np.float64) if canon.size else np.zeros((0, 3)),
            mean=np.asarray(
                [_texture_mean(texs, mat_table.color_tex[fm_s[c]]) for c in canon],
                np.float64,
            ) if canon.size else np.zeros(0),
            count=int(canon.size),
        ))
        blas_nodes.append(bvh)
        proto_tri_base.append(tri_cursor)
        proto_n_storage.append(int(v0.shape[0]))
        tri_cursor += int(v0.shape[0])
        all_v0.append(v0)
        all_e1.append(e1)
        all_e2.append(e2)
        all_n.append(n_s)
        all_uv.append(uv_s)
        all_mid.append(fm_s)
        all_t2l.append(light_of_orig[order])
        all_p2o.append(order.astype(np.int32))
    t_bvh = time.perf_counter() - t_bvh

    v0 = np.concatenate(all_v0).astype(np.float32)
    e1 = np.concatenate(all_e1).astype(np.float32)
    e2 = np.concatenate(all_e2).astype(np.float32)

    # ---- instance tables ------------------------------------------------
    n_inst = len(insts)
    o2w34 = np.zeros((n_inst, 3, 4), np.float32)
    w2o34 = np.zeros((n_inst, 3, 4), np.float32)
    nrm33 = np.zeros((n_inst, 3, 3), np.float32)
    prim_base = np.zeros(n_inst + 1, np.int64)
    for i, (_, _, m) in enumerate(insts):
        m_inv = np.linalg.inv(m)
        o2w34[i] = m[:3, :4]
        w2o34[i] = m_inv[:3, :4]
        nrm33[i] = m_inv[:3, :3].T
        prim_base[i + 1] = prim_base[i] + proto_n_storage[inst_proto[i]]
    tri_offset = np.asarray(
        [proto_tri_base[inst_proto[i]] - prim_base[i] for i in range(n_inst)], np.int32
    )

    # ---- lights over (instance, prototype light) ------------------------
    light_base = np.zeros(n_inst, np.int32)
    lt_tri, lt_power = [], []
    cursor = 0
    for i in range(n_inst):
        light_base[i] = cursor
        pl = proto_lights[inst_proto[i]]
        if pl["count"] == 0:
            continue
        r = o2w34[i, :, :3].astype(np.float64)
        areas = 0.5 * np.linalg.norm(np.cross(pl["e1"] @ r.T, pl["e2"] @ r.T), axis=-1)
        lt_tri.append(prim_base[i] + pl["canon"])
        lt_power.append(pl["mean"] * areas)
        cursor += pl["count"]
    tri_to_light = np.concatenate(all_t2l)
    if lt_tri:
        power = np.concatenate(lt_power)
        pdf, cdf = build_cdf(power)
        area_power_total = float(power.sum())
        light_tris = np.concatenate(lt_tri).astype(np.int32)
        lights = SimpleNamespace(
            tri_id=light_tris, cdf=cdf, pdf=pdf, tri_to_light=tri_to_light,
            n_lights=int(light_tris.size),
        )
    else:
        area_power_total = 0.0
        lights = SimpleNamespace(
            tri_id=np.zeros(1, np.int32),
            cdf=np.asarray([0.0, 1.0], np.float32),
            pdf=np.ones(1, np.float32),
            tri_to_light=np.full(max(v0.shape[0], 1), -1, np.int32),
            n_lights=0,
        )
    env = {} if environment is None else _compile_env(environment, area_power_total)

    # ---- TLAS over instance world boxes, merged [TLAS | BLAS_0 | ...] ---
    ilo = np.zeros((n_inst, 3))
    ihi = np.zeros((n_inst, 3))
    for i in range(n_inst):
        b = blas_nodes[inst_proto[i]]
        lo = b["node_lo"][0].astype(np.float64)
        hi = b["node_hi"][0].astype(np.float64)
        corners = np.stack(
            np.meshgrid(*[(lo[k], hi[k]) for k in range(3)], indexing="ij"), axis=-1
        ).reshape(8, 3)
        wc = corners @ o2w34[i, :, :3].astype(np.float64).T + o2w34[i, :, 3]
        ilo[i], ihi[i] = wc.min(axis=0), wc.max(axis=0)
    tlas, tlas_order = build_aabb_bvh(ilo, ihi, max_leaf=1)
    node_base = []
    cur = tlas["node_lo"].shape[0]
    for b in blas_nodes:
        node_base.append(cur)
        cur += b["node_lo"].shape[0]
    merged = {k: np.concatenate([tlas[k]] + [b[k] for b in blas_nodes])
              for k in ("node_lo", "node_hi", "count")}
    merged["first"] = np.concatenate(
        [tlas["first"]] + [b["first"] + proto_tri_base[p] for p, b in enumerate(blas_nodes)]
    )
    merged["miss"] = np.concatenate(
        [tlas["miss"]]
        + [np.where(b["miss"] >= 0, b["miss"] + node_base[p], -1)
           for p, b in enumerate(blas_nodes)]
    )
    instances = SimpleNamespace(
        o2w=o2w34, w2o=w2o34, nrm=nrm33,
        blas_root=np.asarray([node_base[inst_proto[i]] for i in range(n_inst)], np.int32),
        tri_offset=tri_offset,
        prim_ends=prim_base[1:].astype(np.int32),
        light_base=light_base,
        tlas_inst=np.asarray(tlas_order, np.int32),
        n_instances=n_inst,
    )

    # ---- per-prototype kernel tables ------------------------------------
    # One leaf span for every prototype tree, picked over the total cluster
    # count as the reference picks it (its node-row padding is not counted).
    t_tree = time.perf_counter()
    span = pick_leaf_span(max(sum(n_clusters(c) for c in proto_n_storage), 1))
    t16_parts, cl_parts, sup_parts, tree_parts, proto_meta = [], [], [], [], []
    sup_cur = cl_cur = tile_cur = tree_cur = 0
    for p in range(len(protos)):
        s, cnt = proto_tri_base[p], proto_n_storage[p]
        v0p, e1p, e2p = v0[s:s + cnt], e1[s:s + cnt], e2[s:s + cnt]
        kp = n_clusters(cnt)
        t16 = np.zeros((kp * TRI_TILE, 16), np.float32)
        t16[:cnt, 0:3] = v0p
        t16[:cnt, 3:6] = e1p
        t16[:cnt, 6:9] = e2p
        cl = build_clusters(v0p, e1p, e2p)
        sup = build_superclusters(cl, cnt)
        tree, _ = build_cluster_tree(cl, cnt, leaf_span=span)
        # the REAL supercluster count: the padded rows are never walked
        proto_meta.append((sup_cur, n_superclusters(cnt), cl_cur, kp, tile_cur, tree_cur))
        sup_cur += sup.shape[0]
        cl_cur += cl.shape[0]
        tile_cur += kp
        tree_cur += tree.shape[0]
        t16_parts.append(t16.T.copy())
        cl_parts.append(cl)
        sup_parts.append(sup)
        tree_parts.append(tree)
    instf = np.zeros((n_inst, 20), np.float32)
    insti = np.zeros((n_inst, 8), np.int32)
    for i in range(n_inst):
        instf[i, 0:3] = ilo[i]
        instf[i, 3:6] = ihi[i]
        instf[i, 6:18] = w2o34[i].reshape(12)
        sb, sc, cb, cc, tb, trb = proto_meta[inst_proto[i]]
        insti[i] = (sb, sc, cb, cc, tb, int(prim_base[i]), trb, 0)
    t_tree = time.perf_counter() - t_tree

    compiled = SimpleNamespace(
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        normals=np.concatenate(all_n).astype(np.float32),
        uvs=np.concatenate(all_uv).astype(np.float32),
        mat_id=np.concatenate(all_mid),
        materials=mat_table, textures=tex_table, lights=lights,
        bvh=SimpleNamespace(**merged),
        prim_table=None,
        prim_to_orig=np.concatenate(all_p2o),
        instances=instances,
        tri_clusters=np.concatenate(cl_parts),
        tri_superclusters=np.concatenate(sup_parts),
        tri_tree=np.concatenate(tree_parts),
        inst_tris16=np.concatenate(t16_parts, axis=1),
        inst_pallas_f32=instf,
        inst_pallas_i32=insti,
        tree_leaf_span=span,
        n_tris=int(prim_base[-1]),
        n_materials=len(mats.items),
        **env,
    )
    scene = from_numpy_scene(compiled, intersector="tree", device="cpu")
    scene.compile_seconds = dict(
        bvh=t_bvh, tree=t_tree, total=time.perf_counter() - t_start
    )
    return scene
