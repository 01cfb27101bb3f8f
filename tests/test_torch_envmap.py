"""Port parity: the environment (dome) light (``_compile_env``, the env
fields of the flat and two-level compiles, shading/soa.py ``env_*`` and
``light_sample_mixed``, the env escape and NEE mixture of the path
tracer, the SDL ``EnvMap`` node) vs akari_tpu.

Tolerances:

- compiled env arrays (image, CDF, pmf, ``env_p_select``): exact, flat and
  two-level (the same float64 host arithmetic);
- ``env_uv_of_dir``, ``env_eval``, ``env_sample`` directions and radiance:
  allclose rtol 1e-5, atol 1e-6 (torch's and XLA's atan2 / acos / sin /
  cos differ by a few ulp); the sampled texel exact (``searchsorted``
  right on the same float32 CDF, ``u`` on CDF steps and across runs of
  black texels included); ``env_pdf_sa`` rtol 1e-5 (a direction within
  ulps of a texel edge could pick the neighbour's pmf; none here);
- renders, per sample, against the JAX program: outlier_frac 0.005,
  mean_tol 2e-4 (tests/test_torch_path.py's per-sample budget); the
  64x64 env-lit textured terrain golden within the budget of
  tests/_imgcmp.py (outlier_frac 0.08, mean_tol 3e-3).
"""

import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from akari_torch.core import image as port_image
from akari_torch.core.v3 import V3
from akari_torch.integrators import path as port_path
from akari_torch.scene import sdl as port_sdl
from akari_torch.scene.arrays import from_numpy_scene, make_camera
from akari_torch.shading import soa as port_soa
from akari_tpu.core import transform as ref_xf
from akari_tpu.core.v3 import V3 as RefV3
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene import sdl as ref_sdl
from akari_tpu.scene.arrays import make_camera as ref_make_camera
from akari_tpu.shading import soa as ref_soa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_envtex64_spp4_d5.npy")
ENV_FIELDS = ("env_image", "env_cdf", "env_pmf", "env_p_select")
TOL = dict(rtol=1e-5, atol=1e-6)


def sky(h=8, w=16, seed=0):
    """A seeded sky with a bright patch and a run of black texels (zero
    pmf)."""
    r = np.random.default_rng(seed)
    img = r.uniform(0.1, 1.0, (h, w, 3)).astype(np.float32)
    img[2:4, 5:8] = 6.0
    img[5, 3:9] = 0.0
    return img


def env_shapes(mod, area=True):
    """A floor, a glossy triangle and (with ``area``) a small downward
    lamp, from ``mod``'s node types."""
    out = [
        mod.Mesh(vertices=np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
                 indices=np.asarray([[0, 2, 1], [0, 3, 2]], np.int64),
                 materials=[mod.DiffuseMaterial((0.7, 0.6, 0.5))]),
        mod.Mesh(vertices=np.asarray([[0, 0.5, 0], [1, 0.5, 0], [0, 1.5, 0]], np.float32),
                 indices=np.asarray([[0, 1, 2]], np.int64),
                 materials=[mod.GlossyMaterial((0.8, 0.8, 0.8), 0.3)]),
    ]
    if area:
        out.append(mod.Mesh(
            vertices=np.asarray([[-0.5, 2.5, -0.5], [0.5, 2.5, -0.5], [0.5, 2.5, 0.5],
                                 [-0.5, 2.5, 0.5]], np.float32),
            indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int64),
            materials=[mod.EmissiveMaterial((8.0, 8.0, 8.0))]))
    return out


C2W = ref_xf.translate((0.0, 2.0, 4.0)) @ ref_xf.rotate_x(np.radians(-30.0))

_CACHE = {}


def compiled(area):
    """(port compile, reference compile as jnp, port from the reference's
    arrays) of the env scene with or without the lamp."""
    if area not in _CACHE:
        env = sky()
        port = port_nodes.compile_scene(env_shapes(port_nodes, area), intersector="dense",
                                        environment=port_nodes.EnvMapLight(env), device="cpu")
        ref = ref_nodes.compile_scene(env_shapes(ref_nodes, area), intersector="brute",
                                      environment=ref_nodes.EnvMapLight(env))
        ref_np = jax.tree_util.tree_map(np.asarray, ref)
        _CACHE[area] = (port, jax.tree_util.tree_map(jnp.asarray, ref_np),
                        from_numpy_scene(ref_np, device="cpu"))
    return _CACHE[area]


def _env_equal(port, ref):
    for f in ENV_FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == np.float32 and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("area", [False, True])
def test_compile_env_arrays_equal(area):
    port, ref, conv = compiled(area)
    _env_equal(port, ref)
    _env_equal(conv, ref)
    assert port.env_p_select.shape == ()
    p = float(port.env_p_select)
    assert p == 1.0 if not area else 0.05 <= p <= 0.95


def test_env_scale_and_hdr_path_compile_equal(tmp_path):
    path = str(tmp_path / "sky.hdr")
    port_image.write_hdr(path, sky(6, 12, 3))
    port = port_nodes.compile_scene(env_shapes(port_nodes), intersector="dense",
                                    environment=port_nodes.EnvMapLight(path, scale=2.5),
                                    device="cpu")
    ref = ref_nodes.compile_scene(env_shapes(ref_nodes), intersector="brute",
                                  environment=ref_nodes.EnvMapLight(path, scale=2.5))
    _env_equal(port, ref)


def _dirs():
    """Unit directions: the seam (x = +-0 looking down +z), both poles,
    the horizon, and seeded random ones."""
    special = np.asarray([
        [0.0, 0.0, 1.0], [-0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
        [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [-0.0, 0.6, 0.8],
        [0.0, -0.6, 0.8], [1e-8, 1.0, 0.0], [0.0, 1.0, -1e-8],
    ], np.float32)
    r = np.random.default_rng(4).normal(size=(500, 3))
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    d = np.concatenate([special, r.astype(np.float32)])
    return d


def _pv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _rv3(a):
    return RefV3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], -1)


def test_env_eval_and_pdf_match_reference():
    _, ref, port = compiled(False)
    d = _dirs()
    for got, want in zip(port_soa.env_uv_of_dir(_pv3(d)), ref_soa.env_uv_of_dir(_rv3(d))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port_soa.env_eval(port, _pv3(d)).stack().numpy(),
                               _np3(ref_soa.env_eval(ref, _rv3(d))), **TOL)
    np.testing.assert_allclose(port_soa.env_pdf_sa(port, _pv3(d)).numpy(),
                               np.asarray(ref_soa.env_pdf_sa(ref, _rv3(d))), rtol=1e-5)
    # the seam: u is 1 for x = +0 and 0 for x = -0, in both packages
    u = port_soa.env_uv_of_dir(_pv3(d[:2]))[0].numpy()
    assert u[0] == 1.0 and u[1] == 0.0


def test_env_sample_matches_reference_on_cdf_steps():
    _, ref, port = compiled(False)
    cdf = port.env_cdf.numpy()
    pmf = port.env_pmf.numpy()
    assert (pmf == 0).sum() >= 6  # the black run
    steps = cdf[:-1]              # u exactly on every CDF step (ties with zero-pmf runs)
    r = np.random.default_rng(5)
    u1 = np.concatenate([steps, np.nextafter(steps, np.float32(1)), r.uniform(0, 1, 400)])
    u1 = np.clip(u1, 0, 0.99999994).astype(np.float32)
    u2 = np.concatenate([np.zeros(2 * steps.size), r.uniform(0, 1, 400)]).astype(np.float32)
    wi, Le, pdf = port_soa.env_sample(port, torch.from_numpy(u1), torch.from_numpy(u2))
    wi_r, Le_r, pdf_r = ref_soa.env_sample(ref, jnp.asarray(u1), jnp.asarray(u2))
    idx = torch.searchsorted(port.env_cdf, torch.from_numpy(u1), right=True).numpy()
    np.testing.assert_array_equal(idx, np.searchsorted(cdf, u1, side="right"))
    assert np.all(pmf[np.clip(idx - 1, 0, pmf.size - 1)] > 0)  # never a black texel
    np.testing.assert_allclose(wi.stack().numpy(), _np3(wi_r), **TOL)
    np.testing.assert_allclose(Le.stack().numpy(), _np3(Le_r), **TOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_r), rtol=1e-5)


def test_continuous_distribution_matches_reference():
    """sample_continuous / pdf_continuous on the env CDF (runs of zero pmf
    included) with u on every CDF step."""
    from akari_torch.core.distribution import pdf_continuous, sample_continuous
    from akari_tpu.core import distribution as ref_dist

    _, _, port = compiled(False)
    cdf = port.env_cdf
    u = torch.cat([cdf[:-1], torch.rand(300, generator=torch.Generator().manual_seed(2))])
    u = torch.clamp(u, max=0.99999994)
    got = sample_continuous(cdf, u)
    want = ref_dist.sample_continuous(jnp.asarray(cdf.numpy()), jnp.asarray(u.numpy()))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    x = torch.rand(500, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(
        pdf_continuous(cdf, x).numpy(),
        np.asarray(ref_dist.pdf_continuous(jnp.asarray(cdf.numpy()), jnp.asarray(x.numpy()))),
        rtol=1e-6)


@pytest.mark.parametrize("area", [False, True])
def test_light_sample_mixed_matches_reference(area):
    _, ref, port = compiled(area)
    n = 600
    r = np.random.default_rng(6)
    u = [r.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    if area:  # u_select around the mixture split
        p = np.float32(port.env_p_select)
        u[0][:3] = (p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(1)))
    p_ref = np.stack([r.uniform(-2, 2, n), r.uniform(0.01, 1.0, n), r.uniform(-2, 2, n)],
                     1).astype(np.float32)
    got = port_soa.light_sample_mixed(port, *(torch.from_numpy(x) for x in u), _pv3(p_ref))
    want = ref_soa.light_sample_mixed(ref, *(jnp.asarray(x) for x in u), _rv3(p_ref))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for a, b in ((got.wi, want.wi), (got.L, want.L)):
        np.testing.assert_allclose(a.stack().numpy(), _np3(b), **TOL)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=1e-6)
    np.testing.assert_allclose(got.pdf.numpy(), np.asarray(want.pdf), rtol=1e-5)


def _per_sample(port, ref, cam_p, cam_r, mis, spp=2, depth=3):
    cfg_r = ref_path.PathConfig(spp=1, max_depth=depth, mis=mis)
    cfg_p = port_path.PathConfig(spp=1, max_depth=depth, mis=mis)
    n = cam_p.width * cam_p.height

    @jax.jit
    def one(s):
        ifn, ofn, ffn = ref_path._jax_intersectors_soa(ref)
        return ref_path.trace_paths(ref, cam_r, cfg_r, jnp.uint32(0), jnp.full(n, s, jnp.uint32),
                                    jnp.arange(n, dtype=jnp.uint32), ifn, ofn, jnp, fused_fn=ffn)

    got = np.mean([port_path.trace_paths(port, cam_p, cfg_p, 0, torch.full((n,), s),
                                         torch.arange(n)).numpy() for s in range(spp)], 0)
    want = np.mean([np.asarray(one(s)) for s in range(spp)], 0)
    return got, want


@pytest.mark.parametrize("area, mis", [(False, True), (True, True), (True, "bsdf")])
def test_env_render_16_matches_jax(area, mis):
    _, ref, port = compiled(area)
    cam_p = make_camera(np.asarray(C2W, np.float32), 50.0, 16, 16)
    got, want = _per_sample(port, ref, cam_p, ref_make_camera(C2W, 50.0, 16, 16), mis)
    assert got.mean() > 0.2
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-4)


def test_env_render_launches_one_fused_query_per_bounce(monkeypatch):
    """Env shadow rays join the bounce's fused launch: 1 + max_depth
    closest-hit queries a trace, no any-hit query."""
    import importlib

    # the module: akari_torch.ops exports its function ``intersect``
    ops_intersect = importlib.import_module("akari_torch.ops.intersect")

    _, _, port = compiled(True)
    calls = []
    real = ops_intersect.intersect_soa
    monkeypatch.setattr(port_path, "intersect_soa",
                        lambda *a, **k: calls.append(a[1].x.shape[0]) or real(*a, **k))
    monkeypatch.setattr(port_path, "occlude_soa", lambda *a, **k: calls.append("any-hit"))
    cam = make_camera(np.asarray(C2W, np.float32), 50.0, 8, 8)
    port_path.render(port, cam, port_path.PathConfig(spp=1, max_depth=3))
    assert calls == [64] + [128] * 3


def test_env_on_a_two_level_scene_matches_jax():
    """The env fields of the two-level compile, and a per-sample render
    through the port's instanced route against the reference's XLA
    two-level traversal."""
    from test_torch_instancing import pair_shapes, two_level

    env = sky(8, 16, 7)
    with two_level():
        port = port_nodes.compile_scene(pair_shapes(port_nodes),
                                        environment=port_nodes.EnvMapLight(env, scale=0.5),
                                        device="cpu")
        ref = ref_nodes.compile_scene(pair_shapes(ref_nodes), intersector="bvh",
                                      environment=ref_nodes.EnvMapLight(env, scale=0.5))
    assert port.instances is not None and ref.instances is not None
    _env_equal(port, ref)
    c2w = ref_xf.translate((0.0, 2.0, 8.0))
    got, want = _per_sample(port, ref, make_camera(np.asarray(c2w, np.float32), 30.0, 16, 16),
                            ref_make_camera(c2w, 30.0, 16, 16), True, spp=1)
    assert got.mean() > 0.05
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-4)


def test_sdl_envmap_node_matches_reference(tmp_path):
    port_image.write_hdr(str(tmp_path / "sky.hdr"), sky(6, 12, 8))
    src = ('export env = EnvMap { image: "sky.hdr", scale: 1.5 }\n'
           'export s = Scene { environment: $env, shapes: [] }\n')
    (tmp_path / "s.akari").write_text(src)
    mp = port_sdl.parse_file(str(tmp_path / "s.akari"))
    mr = ref_sdl.parse_file(str(tmp_path / "s.akari"))
    ep, er = mp.exports["env"], mr.exports["env"]
    assert isinstance(ep, port_nodes.EnvMapLight) and ep.scale == er.scale == 1.5
    assert ep.image == er.image
    np.testing.assert_array_equal(ep.load_image(), er.load_image())
    assert mp.exports["s"].environment is ep
    shapes_p, shapes_r = env_shapes(port_nodes), env_shapes(ref_nodes)
    port = port_nodes.compile_scene(shapes_p, intersector="dense", environment=ep, device="cpu")
    ref = ref_nodes.compile_scene(shapes_r, intersector="brute", environment=er)
    _env_equal(port, ref)


def test_envtex_golden_64(tmp_path):
    """The env-lit textured terrain's scene files (n=64, 64 x 64 albedo
    PNG, 64 x 128 sky) rendered at 64x64, 4 spp, depth 5 on the tree route
    against the JAX package's render of the same files
    (tools/make_torch_port_envtex_golden.py)."""
    import importlib.util

    from akari_torch.scene.builtin import write_envtex_terrain

    spec = importlib.util.spec_from_file_location(
        "envtex_tool", os.path.join(ROOT, "tools", "make_torch_port_envtex_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    node = port_sdl.parse_file(write_envtex_terrain(str(tmp_path), **tool.SCENE)).exports["scene"]
    scene = node.compile(device="cpu")
    assert scene.intersector == "tree" and scene.textures.has_images
    assert scene.env_image.shape == (64, 128, 3)
    img = port_path.render(scene, node.camera, node.integrator, seed=tool.SEED).numpy()
    assert_images_match(img, np.load(GOLDEN), outlier_frac=0.08, mean_tol=3e-3)
