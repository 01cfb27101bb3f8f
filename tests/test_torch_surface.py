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
                port = port_nodes.compile_scene(pair_shapes(port_nodes))
                ref = ref_nodes.compile_scene(pair_shapes(ref_nodes), intersector="pallas")
            assert port.instances is not None and ref.instances is not None
        else:
            sc = (ref_builtin.cornell_box(16, 16) if name == "cornell"
                  else ref_builtin.terrain_scene(8, 8, n=48))
            ref = sc.compile(intersector="pallas")
            route = "dense" if name == "cornell" else "tree"
            port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), intersector=route)
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
    port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref))
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
