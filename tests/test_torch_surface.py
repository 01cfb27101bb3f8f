"""Port parity: the package surface and the entry points it names.

- Every name that the JAX package's ``scene``, ``integrators``, ``ops``,
  ``diff``, ``shading`` and ``core`` ``__init__.py`` files import (read
  with ``ast``, not imported) exists in the port's counterpart, and
  importing the port builds no kernel and touches no CUDA state.
- The AoS ``ops.intersect.intersect`` / ``occlude`` / ``Hit`` against the
  JAX package's on the same seeded numpy rays: the Cornell box on the
  dense route, a 4,434-triangle terrain on the tree route and a two-level
  scene (``FLATTEN_MAX_TRIS = 1``), with ``t_min`` / ``t_max`` None,
  scalars and ``[N]``, and rays that miss. The JAX side runs its Pallas
  kernels in interpret mode, as tests/test_pallas.py does. Prims, validity
  and occlusion exact; t / uv within tests/test_torch_intersect.py's
  rtol = atol = 1e-6, scaled per hit as that file scales it on random
  rays: by the condition number 1 + |e1 x e2| / |det| of the world-space
  hit triangle (a grazing hit divides a one-rounding difference by a small
  determinant), and here also by |o - v0| / sqrt(|e1 x e2|) where that
  exceeds 1 (u and v divide a dot product of the origin's offset, rounded
  at its own size, by one of the triangle's: the terrain's triangles are
  0.04 wide and its rays start a unit away).
- ``integrators.path.render_sample`` against the JAX package's at 16x16,
  for sample 0 and 3 and for every pixel and a subset, within
  tests/test_torch_path.py's per-sample budget (outlier_frac 0.005,
  mean_tol 2e-4).
- Every public function and class of every ``akari_tpu`` module has a
  counterpart in the port's module of the same path, a mapped name, or a
  stated reason; the names the JAX package's own tests call are held to
  the JAX functions on seeded inputs (tolerances at each test).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from akari_torch.integrators import path as port_path
from akari_torch.ops.intersect import Hit, intersect, occlude
from akari_torch.scene import geom
from akari_torch.scene.arrays import from_numpy_scene
from akari_tpu.integrators import path as ref_path
from akari_tpu.ops.intersect import Hit as RefHit
from akari_tpu.ops.intersect import intersect as ref_intersect
from akari_tpu.ops.intersect import occlude as ref_occlude
from akari_tpu.ops import pallas_intersect as pi
from akari_tpu.scene import builtin as ref_builtin
from test_torch_instancing import pair_shapes, two_level
from test_torch_intersect import _assert_hits_equal
from test_torch_path import _port_camera

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["scene", "integrators", "ops", "diff", "shading", "core"]
N_RAYS = 256


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


# ------------------------------- the surface --------------------------------

def _jax_exports(sub):
    """Names imported by akari_tpu/<sub>/__init__.py."""
    with open(os.path.join(ROOT, "akari_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_in_the_port(sub):
    import importlib

    names = _jax_exports(sub)
    assert names
    port = importlib.import_module(f"akari_torch.{sub}")
    assert [n for n in names if not hasattr(port, n)] == []


def test_importing_the_port_builds_no_kernel_and_touches_no_cuda():
    code = (
        "import sys, torch\n"
        "import akari_torch\n"
        f"for sub in {SUBPACKAGES + ['bvh', 'utils', 'parallel']}:\n"
        "    __import__('akari_torch.' + sub)\n"
        "from akari_torch.kernels import build\n"
        "from akari_torch.native import loader\n"
        "assert build._loaded == {} and build.BUILD_LOG == {}, build._loaded\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'akari_tpu')]\n"
        "assert not bad, bad\n"
        "print(akari_torch.__version__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0.1.0"
    import akari_tpu

    assert akari_tpu.__version__ == "0.1.0"


def test_hit_has_the_reference_fields():
    assert Hit._fields == RefHit._fields


# --------------------------- AoS intersect / occlude --------------------------

_SCENES = {}


def _scene(name):
    """(JAX scene compiled for its Pallas route, the port's scene) of one
    scene; the flat ones carried across from the JAX compile."""
    if name not in _SCENES:
        if name == "pair":
            with two_level():
                port = port_nodes.compile_scene(pair_shapes(port_nodes), device="cpu")
                ref = ref_nodes.compile_scene(pair_shapes(ref_nodes), intersector="pallas")
            assert port.instances is not None and ref.instances is not None
        else:
            sc = (ref_builtin.cornell_box(16, 16) if name == "cornell"
                  else ref_builtin.terrain_scene(8, 8, n=48))
            ref = sc.compile(intersector="pallas")
            route = "dense" if name == "cornell" else "tree"
            port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), intersector=route,
                                    device="cpu")
        _SCENES[name] = ref, port
    return _SCENES[name]


def _rays(name, n, seed):
    """Seeded rays aimed into the scene, every fourth one turned away from
    it (a miss)."""
    r = np.random.default_rng(seed)
    if name == "cornell":
        o = np.asarray([0.0, 1.0, 3.5]) + r.normal(scale=0.2, size=(n, 3))
        tgt = r.uniform([-1, 0, -1], [1, 2, 1], size=(n, 3))
    elif name == "terrain":
        o = np.stack([r.uniform(-1, 1, n), r.uniform(0.8, 1.5, n), r.uniform(-1, 1, n)], 1)
        tgt = np.stack([r.uniform(-1, 1, n), np.zeros(n), r.uniform(-1, 1, n)], 1)
    else:
        o = np.asarray([0.0, 2.0, 6.0]) + r.normal(scale=0.3, size=(n, 3))
        tgt = np.stack([r.uniform(-2, 2, n), r.uniform(0, 2, n), r.uniform(-2, 2, n)], 1)
    d = tgt - o
    d[::4] = -d[::4]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _limits(kind, ref, o, d, seed):
    """(t_min, t_max) as None, scalars, or [N]: per ray a third bounded to
    half its own hit distance, a third dead (t_max = 0), the rest
    unbounded, with a small t_min on every other ray."""
    if kind == "none":
        return None, None
    n = o.shape[0]
    t_hit = np.asarray(ref_intersect(ref, jnp.asarray(o), jnp.asarray(d)).t)
    if kind == "scalar":  # t_max: the median hit distance
        return 0.05, float(np.median(t_hit[t_hit < 1e29]))
    sel = np.random.default_rng(seed).integers(0, 3, n)
    t_max = np.where(sel == 0, t_hit * 0.5, np.where(sel == 1, 0.0, 1e30)).astype(np.float32)
    t_min = np.where(np.arange(n) % 2 == 0, 0.0, 0.01).astype(np.float32)
    return t_min, t_max


def _condition(port, o, d, prim):
    """(1 + |e1 x e2| / |det|) * max(1, |o - v0| / sqrt(|e1 x e2|)) of each
    ray's world-space hit triangle."""
    v0, e1, e2 = (x.double().numpy() for x in
                  geom.tri_world(port, torch.clamp(prim, min=0).long()))
    det = np.abs(np.sum(e1 * np.cross(d.astype(np.float64), e2), axis=-1))
    area2 = np.maximum(np.linalg.norm(np.cross(e1, e2), axis=-1), 1e-30)
    reach = np.linalg.norm(o.astype(np.float64) - v0, axis=-1) / np.sqrt(area2)
    return (1.0 + area2 / np.maximum(det, 1e-30)) * np.maximum(reach, 1.0)


def _both(x):
    """A limit for each package: (JAX, port)."""
    if x is None or np.isscalar(x):
        return x, x
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["none", "scalar", "array"])
@pytest.mark.parametrize("name", ["cornell", "terrain", "pair"])
def test_aos_intersect_and_occlude_match_jax(name, kind):
    ref, port = _scene(name)
    seed = 10 * ["cornell", "terrain", "pair"].index(name) + len(kind)
    o, d = _rays(name, N_RAYS, seed)
    (jt_min, pt_min), (jt_max, pt_max) = (_both(x) for x in _limits(kind, ref, o, d, seed))
    h = intersect(port, torch.from_numpy(o), torch.from_numpy(d), pt_min, pt_max)
    hr = ref_intersect(ref, jnp.asarray(o), jnp.asarray(d), jt_min, jt_max)
    assert isinstance(h, Hit)
    assert h.t.shape == (N_RAYS,) and h.uv.shape == (N_RAYS, 2)
    assert h.prim.dtype == torch.int32 and h.valid.dtype == torch.bool
    ok = np.asarray(hr.valid)
    _assert_hits_equal((h.t, h.uv[:, 0], h.uv[:, 1], h.prim),
                       (hr.t, hr.prim, hr.uv[:, 0], hr.uv[:, 1], hr.valid),
                       cond=_condition(port, o, d, h.prim))
    assert 20 < ok.sum() < N_RAYS - 20  # hits and misses both
    occ_min, occ_max = (0.0, 1e30) if kind == "none" else (pt_min, pt_max)
    jocc_min, jocc_max = (0.0, 1e30) if kind == "none" else (jt_min, jt_max)
    occ = occlude(port, torch.from_numpy(o), torch.from_numpy(d), occ_min, occ_max)
    occ_r = ref_occlude(ref, jnp.asarray(o), jnp.asarray(d), jocc_min, jocc_max)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    np.testing.assert_array_equal(occ.numpy(), ok)  # any hit == closest validity


def test_aos_outputs_carry_no_gradient():
    _, port = _scene("cornell")
    o, d = _rays("cornell", 64, 3)
    o = torch.from_numpy(o).requires_grad_(True)
    d = torch.from_numpy(d).requires_grad_(True)
    with torch.enable_grad():
        h = intersect(port, o, d, 0.0, torch.full((64,), 1e30, requires_grad=True))
        occ = occlude(port, o * 1.0, d * 1.0, 0.0, 1e30)
    assert not any(x.requires_grad for x in h) and not occ.requires_grad
    assert h.t.grad_fn is None and h.uv.grad_fn is None
    assert bool(h.valid.any())


# ------------------------------- render_sample -------------------------------

@pytest.fixture(scope="module")
def sample_scenes():
    sc = ref_builtin.cornell_box(16, 16)
    ref = sc.compile(intersector="brute")
    port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    return ref, port, sc.camera, _port_camera(sc.camera)


_JAX_SAMPLE = {}


def _jax_render_sample(ref, cam, cfg, sample_idx, pixel_idx):
    """The JAX package's render_sample, jitted once per pixel-id shape."""
    key = None if pixel_idx is None else pixel_idx.shape
    if key not in _JAX_SAMPLE:
        if pixel_idx is None:
            fn = jax.jit(lambda s: ref_path.render_sample(ref, cam, cfg, 0, s))
        else:
            fn = jax.jit(lambda s, px: ref_path.render_sample(ref, cam, cfg, 0, s, px))
        _JAX_SAMPLE[key] = fn
    fn = _JAX_SAMPLE[key]
    out = fn(sample_idx) if pixel_idx is None else fn(sample_idx, jnp.asarray(pixel_idx))
    return np.asarray(out)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("sample_idx", [0, 3])
def test_render_sample_matches_jax(sample_scenes, sample_idx, subset):
    ref, port, cam, pcam = sample_scenes
    cfg = ref_path.PathConfig(spp=1, max_depth=5)
    pcfg = port_path.PathConfig(spp=1, max_depth=5)
    n = cam.width * cam.height
    px = (np.random.default_rng(7).permutation(n)[:90].astype(np.uint32) if subset else None)
    got = port_path.render_sample(
        port, pcam, pcfg, 0, sample_idx,
        None if px is None else torch.from_numpy(px.astype(np.int64)))
    want = _jax_render_sample(ref, cam, cfg, sample_idx, px)
    assert got.shape == want.shape == (n if px is None else 90, 3)
    assert_images_match(got.numpy(), want, outlier_frac=0.005, mean_tol=2e-4)
    # an int sample_idx broadcasts: the same bits as a full index tensor
    ids = torch.arange(n, dtype=torch.int64) if px is None else torch.from_numpy(
        px.astype(np.int64))
    full = port_path.trace_paths(port, pcam, pcfg, 0,
                                 torch.full(ids.shape, sample_idx, dtype=torch.int64), ids)
    assert torch.equal(got, full)
    assert float(got.mean()) > 0.0


# --------------------- every JAX module name, or a reason ----------------------
#
# Each public top-level function and class of each akari_tpu module (read
# with ast) exists in the port's module of the same path, or maps to the
# port's name below (checked to exist), or is listed with its reason.

PALLAS_STATE = "Pallas kernel state and operand packing: the CUDA kernels keep theirs in registers"
AOS_UNUSED = ("AoS helper with no caller in either package or in the JAX package's tests; "
              "its per-component form in shading/soa.py or core/v3.py serves")
MAPPED = {
    "ops/pallas_intersect.py": {
        "intersect_pallas": "ops/intersect.py:intersect",
        "intersect_pallas_soa": "ops/intersect.py:intersect_soa",
        "intersect_pallas_instanced": "ops/instanced_tree_intersect.py:closest",
        "pack_tris_t": "bvh/cluster_tree.py:tri_blocks",
    },
    "ops/pallas_tree.py": {
        "pick_leaf_span": "bvh/cluster_tree.py:pick_leaf_span",
        "build_cluster_tree": "bvh/cluster_tree.py:build_cluster_tree",
        "run_tree": "ops/tree_intersect.py:closest",
        "run_instanced_tree": "ops/instanced_tree_intersect.py:closest",
    },
    "ops/pallas_cluster.py": {
        "build_clusters": "bvh/cluster_tree.py:build_clusters",
        "build_superclusters": "bvh/cluster_tree.py:build_superclusters",
        "run_clustered": "ops/cluster_intersect.py:closest",
        "run_instanced": "ops/cluster_intersect.py:instanced_closest",
    },
    "shading/soa.py": {"power_heuristic": "sampling.py:power_heuristic"},
    "shading/light.py": {
        "sample": "shading/soa.py:light_sample",
        "pdf_direction_from": "shading/soa.py:light_pdf_direction_from",
    },
    "native/loader.py": {"get_bvh_lib": "native/loader.py:load"},
    "core/vecmath.py": {"reflect": "core/v3.py:reflect3"},
}
REASONS = {
    "ops/gather.py": {"*": "ROADMAP 'Do not port': the one-hot gather is a TPU workaround; "
                           "the port indexes"},
    "bvh/traverse.py": {"*": "ROADMAP 'Do not port': the XLA while-loop traversal; the tree "
                             "kernels answer the same queries"},
    "oracle/renderer.py": {"*": "ROADMAP: the NumPy oracle stays in the JAX package as the "
                                "port tests' second witness"},
    "ops/pallas_intersect.py": {"closest_update": PALLAS_STATE, "init_state": PALLAS_STATE,
                                "pack_tris": PALLAS_STATE},
    "scene/nodes.py": {"SceneTooLargeError": "ROADMAP 'Do not port': the TPU VMEM ceilings "
                                             "it reports do not exist on the card"},
    "scene/arrays.py": {
        "pytree_dataclass": "JAX pytree registration; the port's arrays are plain dataclasses "
                            "of tensors (map_tensors)",
        "tri_vertices": AOS_UNUSED, "tri_geometric_normal": AOS_UNUSED, "tri_area": AOS_UNUSED,
    },
    "native/loader.py": {"native_available": "the port has no Python fallback: a failed build "
                                             "raises (native/loader.py)"},
    "shading/light.py": {
        "LightSample": "the SoA light sampler returns a tuple (shading/soa.py light_sample)",
        "pdf_direction": AOS_UNUSED,
    },
    "shading/material.py": {"is_emissive": AOS_UNUSED},
    "shading/microfacet.py": {n: AOS_UNUSED for n in (
        "ggx_d", "ggx_g1", "beckmann_d", "beckmann_g1", "phong_d", "phong_g1", "d", "g1", "g",
        "sample_wh", "pdf_wh")},
    "sampling.py": {"uniform_hemisphere": AOS_UNUSED, "uniform_hemisphere_pdf": AOS_UNUSED},
    "core/distribution.py": {"pdf_discrete": AOS_UNUSED},
    "core/spectrum.py": {"is_black": AOS_UNUSED, "clamp_zero": AOS_UNUSED},
    "core/v3.py": {"v3splat": "a V3 of 0-d NumPy scalars for the JAX programs' constants; "
                              "torch broadcasts Python floats"},
    "core/vecmath.py": {n: AOS_UNUSED for n in (
        "vec3", "length2", "distance", "lerp", "refract", "face_forward", "cos_theta",
        "abs_cos_theta", "cos2_theta", "sin2_theta", "sin_theta", "tan_theta", "tan2_theta",
        "same_hemisphere")},
}


def _public_defs(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _port_attr(target):
    import importlib

    mod, name = target.split(":")
    module = importlib.import_module("akari_torch." + mod[:-3].replace("/", "."))
    return hasattr(module, name)


def test_every_jax_module_name_has_a_counterpart_or_a_reason():
    import importlib

    jax_root = os.path.join(ROOT, "akari_tpu")
    unmatched, used = [], set()
    for dirpath, _, files in os.walk(jax_root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), jax_root).replace(os.sep, "/")
            port_path_ = os.path.join(ROOT, "akari_torch", rel)
            module = None
            if os.path.exists(port_path_):
                module = importlib.import_module("akari_torch." + rel[:-3].replace("/", ".")
                                                 .replace(".__init__", ""))
            for name in _public_defs(os.path.join(dirpath, fname)):
                if module is not None and hasattr(module, name):
                    continue
                mapped = MAPPED.get(rel, {}).get(name)
                reason = REASONS.get(rel, {}).get(name) or REASONS.get(rel, {}).get("*")
                if mapped:
                    assert _port_attr(mapped), f"{rel}:{name} maps to missing {mapped}"
                    used.add((rel, name))
                elif reason:
                    used.add((rel, name))
                else:
                    unmatched.append(f"{rel}:{name}")
    assert unmatched == []
    # no stale entries: each listed name is still one the JAX package defines
    # and the port lacks under its own path
    listed = {(m, n) for table in (MAPPED, REASONS) for m, names in table.items()
              for n in names if n != "*"}
    assert listed <= used, sorted(listed - used)


# ---- the names the JAX package's own tests call, against the JAX functions ----

def _rand_u2(n, seed):
    from akari_tpu.core import rng

    return np.asarray(rng.uniform2(seed, np.arange(n, dtype=np.uint32), 0, 0))


def _closure_params(kind, n, alpha=0.2, dist=0, seed=0):
    r = np.random.default_rng(seed)
    return {"kind": np.full(n, kind, np.int32),
            "color": r.uniform(0.2, 0.9, (n, 3)).astype(np.float32),
            "alpha": np.full(n, alpha, np.float32), "dist": np.full(n, dist, np.int32),
            "choice_pdf": r.uniform(0.5, 1.0, n).astype(np.float32),
            "ior": np.full(n, 1.5, np.float32)}


def _torch_params(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


# (kind, dist, alpha) of the JAX test_materials.py cases and the other closures
CLOSURE_TOL = dict(rtol=1e-4, atol=1e-5)
LOCAL_CASES = {"diffuse": (0, 0, 0.2), "ggx": (1, 0, 0.2), "beckmann": (1, 1, 0.3),
               "phong": (1, 2, 0.25), "specular": (2, 0, 0.1), "glass": (3, 0, 0.1),
               "null": (-1, 0, 0.1)}


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_local_bsdf_matches_jax(case):
    """bsdf.sample_local / eval_local / pdf_local (over shading/soa.py)
    against the JAX package's on seeded wo and uniforms, as
    tests/test_materials.py's pdf-consistency cases draw them, within
    tests/test_torch_bdpt.py's closure tolerance (rtol 1e-4, atol 1e-5:
    float32 powers and roots of two libraries, up to 1.8e-5 relative on
    GGX), and the sampled pdf equals pdf_local where the JAX test checks
    it."""
    from akari_torch.shading import bsdf as port_bsdf
    from akari_tpu.shading import bsdf as ref_bsdf

    kind, dist, alpha = LOCAL_CASES[case]
    n = 2048
    p = _closure_params(kind, n, alpha, dist, seed=kind + 5)
    r = np.random.default_rng(11)
    wo = r.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05  # upper hemisphere, off grazing
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = _rand_u2(n, seed=2)
    wi_r, f_r, pdf_r = (np.asarray(x) for x in ref_bsdf.sample_local(p, wo, u))
    tp, two = _torch_params(p), torch.from_numpy(wo)
    wi_p, f_p, pdf_p = (x.numpy() for x in port_bsdf.sample_local(tp, two, torch.from_numpy(u)))
    np.testing.assert_allclose(wi_p, wi_r, **CLOSURE_TOL)
    np.testing.assert_allclose(f_p, f_r, **CLOSURE_TOL)
    np.testing.assert_allclose(pdf_p, pdf_r, **CLOSURE_TOL)
    wi = wi_r / np.maximum(np.linalg.norm(wi_r, axis=-1, keepdims=True), 1e-12)
    ev_r = np.asarray(ref_bsdf.eval_local(p, wo, wi))
    pd_r = np.asarray(ref_bsdf.pdf_local(p, wo, wi))
    ev_p = port_bsdf.eval_local(tp, two, torch.from_numpy(wi)).numpy()
    pd_p = port_bsdf.pdf_local(tp, two, torch.from_numpy(wi)).numpy()
    np.testing.assert_allclose(ev_p, ev_r, **CLOSURE_TOL)
    np.testing.assert_allclose(pd_p, pd_r, **CLOSURE_TOL)
    if case in ("diffuse", "ggx"):
        ok = pdf_p > 1e-6
        np.testing.assert_allclose(pdf_p[ok], pd_p[ok], rtol=1e-3, atol=1e-5)
    if case in ("specular", "glass", "null"):
        assert np.all(ev_p == 0.0) and np.all(pd_p == 0.0)


def test_fresnel_terms():
    """The JAX test's values, and each term against the JAX function on
    seeded cosines (scalar and per-channel eta, k, f0): rtol 1e-5."""
    from akari_torch.shading import bsdf as port_bsdf
    from akari_tpu.shading import bsdf as ref_bsdf

    one = torch.tensor(1.0)
    assert abs(float(port_bsdf.fresnel_dielectric(one, torch.tensor(1.0), torch.tensor(1.5)))
               - 0.04) < 1e-3
    assert 0.8 < float(port_bsdf.fresnel_conductor(one, torch.tensor(0.2), torch.tensor(3.0))) <= 1
    assert abs(float(port_bsdf.fresnel_schlick(one, torch.tensor(0.04))) - 0.04) < 1e-6
    r = np.random.default_rng(3)
    cos = r.uniform(-1.0, 1.0, 512).astype(np.float32)
    eta, k = r.uniform(0.1, 3.0, (512, 3)).astype(np.float32), r.uniform(0, 5, (512, 3)).astype(np.float32)
    f0 = r.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(port_bsdf.fresnel_conductor(t(cos), t(eta), t(k)).numpy(),
                               ref_bsdf.fresnel_conductor(cos, eta, k), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port_bsdf.fresnel_conductor(t(cos), t(eta[:, 0]), t(k[:, 0])).numpy(),
                               ref_bsdf.fresnel_conductor(cos, eta[:, 0], k[:, 0]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(port_bsdf.fresnel_schlick(t(cos), t(f0)).numpy(),
                               ref_bsdf.fresnel_schlick(cos, f0), rtol=1e-5, atol=1e-7)


def test_onb_roundtrip():
    """vecmath.onb / to_local / to_world / length against the JAX
    package's on its test's seeded normals (atol 1e-6), and the round
    trip (atol 1e-4, as there)."""
    from akari_torch.core import vecmath as port_vm
    from akari_tpu.core import vecmath as ref_vm

    rng = np.random.default_rng(0)
    n = rng.normal(size=(128, 3)).astype(np.float32)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.normal(size=(128, 3)).astype(np.float32)
    t, b = port_vm.onb(torch.from_numpy(n))
    tr, br = ref_vm.onb(n)
    np.testing.assert_allclose(port_vm.length(t).numpy(), ref_vm.length(tr), atol=1e-6)
    local = port_vm.to_local(t, b, torch.from_numpy(n), torch.from_numpy(w))
    np.testing.assert_allclose(local.numpy(), ref_vm.to_local(tr, br, n, w), atol=1e-6)
    np.testing.assert_allclose(port_vm.length(local, keepdim=True).numpy(),
                               ref_vm.length(w, keepdims=True), rtol=1e-6)
    back = port_vm.to_world(t, b, torch.from_numpy(n), local)
    np.testing.assert_allclose(back.numpy(), w, atol=1e-4)


def test_uniform_sphere_unit_and_mean():
    from akari_torch import sampling as port_sampling
    from akari_tpu import sampling as ref_sampling

    u = _rand_u2(16384, seed=0)
    w = port_sampling.uniform_sphere(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(w, ref_sampling.uniform_sphere(u), atol=1e-6)
    np.testing.assert_allclose((w ** 2).sum(-1), 1.0, atol=1e-5)
    assert np.all(np.abs(w.mean(axis=0)) < 0.02)
    assert port_sampling.uniform_sphere_pdf() == ref_sampling.uniform_sphere_pdf()


def test_transform_compose_apply():
    """transform.identity / inverse / apply_vector beside apply_point and
    apply_normal, against the JAX package's: exact."""
    from akari_torch.core import transform as port_xf
    from akari_tpu.core import transform as ref_xf

    m = ref_xf.translate((1, 2, 3)) @ ref_xf.rotate_y(0.3) @ ref_xf.scale((2.0, 1.0, 0.5))
    p = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_xf.identity(), ref_xf.identity())
    np.testing.assert_array_equal(port_xf.inverse(m), ref_xf.inverse(m))
    np.testing.assert_array_equal(port_xf.apply_vector(m, p), ref_xf.apply_vector(m, p))
    q = port_xf.apply_point(m, p)
    np.testing.assert_allclose(port_xf.apply_point(port_xf.inverse(m), q), p, atol=1e-5)


def test_image_post_processing_chain():
    """image.gamma_correction / identity / pipeline: the reference's
    functional post-process chain, exact on a seeded image."""
    from akari_torch.core import image as port_image
    from akari_tpu.core import image as ref_image

    img = np.random.default_rng(2).uniform(-0.1, 1.5, (5, 7, 3)).astype(np.float32)
    run_p = port_image.pipeline(port_image.identity, port_image.gamma_correction)
    run_r = ref_image.pipeline(ref_image.identity, ref_image.gamma_correction)
    np.testing.assert_array_equal(run_p(img), run_r(img))
    np.testing.assert_array_equal(port_image.identity(img), img)
