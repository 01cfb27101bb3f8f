"""Device scene representation: plain dataclasses of tensors.

Counterpart of ``akari_tpu/scene/arrays.py``. Pointers of the reference's
compiled scene are integer ids into flat tables; every table is a tensor
field. Each dataclass has an explicit ``.to(device)`` that returns a copy
with every tensor field moved; static fields (counts, flags, names) stay
Python values.

``from_numpy_scene`` carries the reference's compiled state across: it
takes any object with the reference ``SceneArrays`` attribute names
holding arrays (the tests pass the JAX compile's leaves through
``np.asarray``) and returns the port's dataclass, flat or two-level.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..bvh.cluster_tree import tri_blocks

# Material kinds (ref: Material variant, kernel/material.h:249)
MAT_DIFFUSE = 0
MAT_GLOSSY = 1
MAT_EMISSIVE = 2
MAT_MIX = 3
MAT_MIRROR = 4
MAT_GLASS = 5

# Texture kinds
TEX_CONSTANT = 0
TEX_IMAGE = 1

# How many nested Mix levels select_material unrolls.
MAX_MIX_DEPTH = 4


def map_tensors(obj, fn):
    """dataclasses.replace with ``fn`` applied to every tensor field,
    nested dataclasses included (``fn = torch.Tensor.detach`` gives the
    scene with no gradient path, as the reference's
    ``tree_map(stop_gradient, scene)``)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = map_tensors(v, fn)
    return dataclasses.replace(obj, **changes)


def _move(obj, device):
    """dataclasses.replace with every tensor / dataclass field moved."""
    return map_tensors(obj, lambda t: t.to(device))


def _t(a, dtype=None):
    """Host array -> CPU tensor owning a copy (None passes through)."""
    if a is None:
        return None
    return torch.from_numpy(np.array(a, dtype=dtype, order="C", copy=True))


@dataclass
class TextureTable:
    """All textures, SoA. ``value`` is the constant colour of a constant
    texture and the multiplier of an image texture; images are padded to
    a common [Hm, Wm] and stacked. ``has_images`` False lets shading skip
    the image branch (constant textures resolve to a flat table)."""

    kind: torch.Tensor         # [X] int32 TEX_CONSTANT | TEX_IMAGE
    value: torch.Tensor        # [X, 3] float32
    image_id: torch.Tensor     # [X] int32 index into images (0 if unused)
    images: torch.Tensor       # [I, Hm, Wm, 3] float32 (at least one dummy)
    image_sizes: torch.Tensor  # [I, 2] int32 (h, w) actually used
    has_images: bool = False

    def to(self, device):
        return _move(self, device)


@dataclass
class MaterialTable:
    """All materials, SoA. ``has_mix`` gates the Mix-tree selection walk."""

    kind: torch.Tensor          # [M] int32
    color_tex: torch.Tensor     # [M] int32
    roughness_tex: torch.Tensor # [M] int32
    fraction_tex: torch.Tensor  # [M] int32
    mix_a: torch.Tensor         # [M] int32
    mix_b: torch.Tensor         # [M] int32
    double_sided: torch.Tensor  # [M] bool
    ior: torch.Tensor = None    # [M] float32 (None = all 1.5)
    has_mix: bool = False

    def to(self, device):
        return _move(self, device)


@dataclass
class LightTable:
    """Emissive-triangle area lights + power CDF."""

    tri_id: torch.Tensor        # [L] int32 storage triangle of each light
    cdf: torch.Tensor           # [L+1] float32 power CDF
    pdf: torch.Tensor           # [L] float32 selection pmf
    tri_to_light: torch.Tensor  # [T] int32 (-1 if not a light)
    n_lights: int = 0           # 0 => no lights (arrays are padded >= 1)

    def to(self, device):
        return _move(self, device)


@dataclass
class BVHArrays:
    """Threaded BVH as compiled (DFS-ordered nodes with skip links). The
    dense intersector does not read it; it records the storage order."""

    node_lo: torch.Tensor  # [Nn, 3] float32
    node_hi: torch.Tensor  # [Nn, 3] float32
    first: torch.Tensor    # [Nn] int32
    count: torch.Tensor    # [Nn] int32
    miss: torch.Tensor     # [Nn] int32

    def to(self, device):
        return _move(self, device)


@dataclass
class InstanceTable:
    """Two-level instancing tables (``akari_tpu/scene/arrays.py``
    ``InstanceTable``).

    ``SceneArrays.bvh`` holds ``[TLAS | BLAS_0 | BLAS_1 ...]``; TLAS leaves
    hold one instance (``first`` indexes ``tlas_inst``). Hits carry a
    VIRTUAL prim id: instance ``i`` owns ``[prim_ends[i-1], prim_ends[i])``
    and ``storage = virtual + tri_offset[i]`` (``scene/geom.py``).
    """

    o2w: torch.Tensor         # [I, 3, 4] object -> world rows
    w2o: torch.Tensor         # [I, 3, 4] world -> object
    nrm: torch.Tensor         # [I, 3, 3] normal matrix (w2o rotation^T)
    blas_root: torch.Tensor   # [I] int32 node of the instance's BLAS root
    tri_offset: torch.Tensor  # [I] int32 virtual + offset = storage prim
    prim_ends: torch.Tensor   # [I] int32 exclusive ends of virtual ranges
    light_base: torch.Tensor  # [I] int32 first light id of the instance
    tlas_inst: torch.Tensor   # [I] int32 TLAS leaf order -> instance
    n_instances: int = 0

    def to(self, device):
        return _move(self, device)


@dataclass
class SceneArrays:
    """The compiled flat scene. Triangle storage is in BVH order.

    tri_v0/e1/e2: Moeller-Trumbore-ready vertices (v0, v1-v0, v2-v0).
    prim_table: [T, 32] per-triangle shading rows, columns v0(0:3) e1(3:6)
    e2(6:9) normals(9:18) uvs(18:24) mat_id(24) light_sel_pdf(25)
    pad(26:32). Its first nine columns are also the dense kernel's
    triangle rows.

    Tree-walk tables (``bvh/cluster_tree.py``), built at compile for
    scenes above DENSE_MAX_TRIS (4096) triangles or on request, else None:
    tri_clusters: [Kpad, 8] cluster AABBs over 128-triangle runs (the
    reference's array); tri_tree: [Nn, 16] BVH2 node rows over
    tree_leaf_span-cluster blocks (the reference's array); tri_blocks:
    [9, Tpad] component-major triangle store of the tree kernel and of the
    linear cluster kernel (v0.xyz e1.xyz e2.xyz on rows 0-8, triangles on
    the minor axis, zero columns up to a multiple of 128): rows 0-8 of the
    reference's ``tri_blocks``, whose other seven rows are zero and not
    kept; tri_superclusters: [Spad, 8] boxes over 32-cluster runs (the linear
    cluster sweep's table when tri_tree is None; the reference's array).

    Two-level scenes (``instances`` set; storage holds object-space
    prototype triangles and hits carry virtual prim ids, ``scene/geom.py``)
    have no prim_table. Their kernel tables, each the reference's: inst_f32
    [I, 20] (world box lo 0:3 hi 3:6, w2o rows 6:18) and inst_i32 [I, 8]
    (supercluster base, real supercluster count, cluster base, cluster
    count, tile base, prim base, tree base, 0) of ``inst_pallas_f32/i32``;
    tri_clusters, tri_superclusters and tri_tree are the per-prototype
    tables concatenated; inst_tri_blocks is the [9, sum Kp*128] triangle
    store of the instanced tree kernel and of the linear instanced kernel,
    rows 0-8 of the reference's ``inst_tris16`` (each prototype padded to
    whole clusters with zero columns that never hit), so cluster
    ``tile_base + k`` is columns ``128 (tile_base + k)`` onward.

    Environment (dome) light, None without one: env_image [He, We, 3]
    linear radiance (equirectangular), env_cdf [He*We + 1] and env_pmf
    [He*We] the flattened luminance * sin(theta) texel distribution, and
    env_p_select the 0-d float32 probability that NEE picks the
    environment over the area lights.
    """

    tri_v0: torch.Tensor    # [T, 3]
    tri_e1: torch.Tensor    # [T, 3]
    tri_e2: torch.Tensor    # [T, 3]
    normals: torch.Tensor   # [T, 3, 3] per-corner shading normals
    uvs: torch.Tensor       # [T, 3, 2]
    mat_id: torch.Tensor    # [T] int32
    materials: MaterialTable
    textures: TextureTable
    lights: LightTable
    bvh: BVHArrays = None
    prim_table: torch.Tensor = None    # [T, 32] float32
    prim_to_orig: torch.Tensor = None  # [T] int32 storage slot -> original tri
    tri_clusters: torch.Tensor = None  # [Kpad, 8] float32
    tri_superclusters: torch.Tensor = None  # [Spad, 8] float32
    tri_tree: torch.Tensor = None      # [Nn, 16] float32
    tri_blocks: torch.Tensor = None    # [9, Tpad] float32
    instances: InstanceTable = None
    inst_f32: torch.Tensor = None      # [I, 20] float32
    inst_i32: torch.Tensor = None      # [I, 8] int32
    inst_tri_blocks: torch.Tensor = None  # [9, sum Kp*128] float32
    env_image: torch.Tensor = None     # [He, We, 3] float32
    env_cdf: torch.Tensor = None       # [He*We + 1] float32
    env_pmf: torch.Tensor = None       # [He*We] float32
    env_p_select: torch.Tensor = None  # [] float32
    tree_leaf_span: int = 1
    n_tris: int = 0             # storage triangles; virtual ones if two-level
    n_materials: int = 0
    intersector: str = "dense"  # "dense" | "tree" | "brute"
    # host seconds of compile_scene: "bvh" (storage order), "tree"
    # (cluster boxes + BVH2) and "total"; None when built otherwise
    compile_seconds: dict = None

    @property
    def device(self):
        return self.tri_v0.device

    def to(self, device):
        return _move(self, device)


@dataclass
class Camera:
    """Perspective pinhole/thin-lens camera; looks down local -Z.

    Host metadata only: ``c2w`` is a float32 NumPy [4, 4] and
    ``tan_half_fov`` a NumPy float32, read as exact float32 constants by
    the ray generator.
    """

    c2w: np.ndarray
    tan_half_fov: np.float32
    width: int = 0
    height: int = 0
    lens_radius: float = 0.0
    focal_distance: float = 0.0


def make_camera(c2w, fov_deg, width, height, lens_radius=0.0, focal_distance=0.0):
    return Camera(
        c2w=np.asarray(c2w, dtype=np.float32),
        tan_half_fov=np.float32(np.tan(np.radians(fov_deg) / 2.0)),
        width=int(width),
        height=int(height),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
    )


def from_numpy_scene(obj, intersector="dense"):
    """Reference-shaped compiled scene (arrays under the reference's
    ``SceneArrays`` attribute names) -> the port's CPU ``SceneArrays``.

    Flat scenes: the tree tables are carried when ``obj.tri_tree`` is set
    (the reference builds them above DENSE_MAX_TRIS); ``tri_blocks`` is
    rows 0-8 of ``obj.tri_blocks`` (made from ``tri_v0/e1/e2`` in the same
    layout where it is None, as the reference's route does below its
    threshold). Two-level scenes (``obj.instances`` set) need the
    reference's per-prototype tables (its ``intersector="pallas"``
    compile); ``inst_tri_blocks`` is rows 0-8 of ``inst_tris16``, and
    ``intersector`` must be "tree" (the instanced route).

    Image textures and the environment light are carried when present.
    """
    it = getattr(obj, "instances", None)
    if it is not None and (
        intersector != "tree" or getattr(obj, "inst_pallas_f32", None) is None
    ):
        raise ValueError(
            "a two-level scene needs its per-prototype kernel tables and "
            "intersector 'tree'"
        )
    tex, mat, li = obj.textures, obj.materials, obj.lights
    bvh = getattr(obj, "bvh", None)
    tree = getattr(obj, "tri_tree", None)
    if intersector == "tree" and tree is None:
        raise ValueError("intersector 'tree' needs the scene's tri_tree table")
    inst = {}
    if it is not None:
        inst = dict(
            instances=InstanceTable(
                o2w=_t(it.o2w, np.float32),
                w2o=_t(it.w2o, np.float32),
                nrm=_t(it.nrm, np.float32),
                blas_root=_t(it.blas_root, np.int32),
                tri_offset=_t(it.tri_offset, np.int32),
                prim_ends=_t(it.prim_ends, np.int32),
                light_base=_t(it.light_base, np.int32),
                tlas_inst=_t(it.tlas_inst, np.int32),
                n_instances=int(it.n_instances),
            ),
            inst_f32=_t(obj.inst_pallas_f32, np.float32),
            inst_i32=_t(obj.inst_pallas_i32, np.int32),
            inst_tri_blocks=_t(np.asarray(obj.inst_tris16)[:9], np.float32),
        )
    flat_tree = tree is not None and it is None
    blocks = None
    if flat_tree:
        blocks = getattr(obj, "tri_blocks", None)
        blocks = (tri_blocks(obj.tri_v0, obj.tri_e1, obj.tri_e2) if blocks is None
                  else np.asarray(blocks)[:9])
    return SceneArrays(
        tri_v0=_t(obj.tri_v0, np.float32),
        tri_e1=_t(obj.tri_e1, np.float32),
        tri_e2=_t(obj.tri_e2, np.float32),
        normals=_t(obj.normals, np.float32),
        uvs=_t(obj.uvs, np.float32),
        mat_id=_t(obj.mat_id, np.int32),
        materials=MaterialTable(
            kind=_t(mat.kind, np.int32),
            color_tex=_t(mat.color_tex, np.int32),
            roughness_tex=_t(mat.roughness_tex, np.int32),
            fraction_tex=_t(mat.fraction_tex, np.int32),
            mix_a=_t(mat.mix_a, np.int32),
            mix_b=_t(mat.mix_b, np.int32),
            double_sided=_t(mat.double_sided, bool),
            ior=_t(mat.ior, np.float32),
            has_mix=bool(mat.has_mix),
        ),
        textures=TextureTable(
            kind=_t(tex.kind, np.int32),
            value=_t(tex.value, np.float32),
            image_id=_t(tex.image_id, np.int32),
            images=_t(tex.images, np.float32),
            image_sizes=_t(tex.image_sizes, np.int32),
            has_images=bool(tex.has_images),
        ),
        lights=LightTable(
            tri_id=_t(li.tri_id, np.int32),
            cdf=_t(li.cdf, np.float32),
            pdf=_t(li.pdf, np.float32),
            tri_to_light=_t(li.tri_to_light, np.int32),
            n_lights=int(li.n_lights),
        ),
        bvh=None if bvh is None else BVHArrays(
            node_lo=_t(bvh.node_lo, np.float32),
            node_hi=_t(bvh.node_hi, np.float32),
            first=_t(bvh.first, np.int32),
            count=_t(bvh.count, np.int32),
            miss=_t(bvh.miss, np.int32),
        ),
        prim_table=_t(getattr(obj, "prim_table", None), np.float32),
        prim_to_orig=_t(obj.prim_to_orig, np.int32),
        tri_clusters=None if tree is None else _t(obj.tri_clusters, np.float32),
        tri_superclusters=None if tree is None else _t(obj.tri_superclusters, np.float32),
        tri_tree=_t(tree, np.float32),
        tri_blocks=_t(blocks, np.float32),
        **inst,
        env_image=_t(getattr(obj, "env_image", None), np.float32),
        env_cdf=_t(getattr(obj, "env_cdf", None), np.float32),
        env_pmf=_t(getattr(obj, "env_pmf", None), np.float32),
        env_p_select=_t(getattr(obj, "env_p_select", None), np.float32),
        tree_leaf_span=int(getattr(obj, "tree_leaf_span", 1) or 1),
        n_tris=int(obj.n_tris),
        n_materials=int(obj.n_materials),
        intersector=intersector,
    )
