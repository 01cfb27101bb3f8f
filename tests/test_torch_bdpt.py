"""Port parity: the bidirectional path tracer (akari_torch.integrators.bdpt,
the [N, 3] shading entry points it calls, the SDL ``BDPT`` node, the BDPT branch
of ``loss_and_image``) vs akari_tpu, at 16x16 (256 lanes) and 1 spp.

The reference runs eagerly on the CPU (``jnp``) with its brute-force
intersector; the port on the same compiled scene with its dense route.

Tolerances:

- vertex tapes: ints and flags exact; floats rtol 1e-5, atol 1e-5 (the
  scene is ~2 units wide; hit points carry the barycentrics' ulps of two
  intersectors), the area pdfs ``pdf_fwd`` / ``pdf_rev`` rtol 1e-2 (a
  short segment or a grazing cosine amplifies those ulps: on this tape
  the largest, 18,814, differs by 5e-4 and the smallest, 3e-8, by 9e-3);
- ``_camera_connect``: pixels and the frustum test exact (points on pixel
  boundaries included, where the rotation is exact); importance and pdfs
  rtol 1e-5;
- ``trace_bdpt`` radiance and splat film: the per-sample budget of
  tests/test_torch_path.py (outlier_frac 0.005, mean_tol 2e-4; a
  connection ray that grazes an edge may decide differently);
- d loss / d tex_value through ``loss_and_image`` against jax.grad: every
  entry within 1e-5 of max|g|;
- the 64x64 golden within the budget of tests/_imgcmp.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from _port_diff import assert_rel_close, both, port_camera, port_value_and_grad
from akari_torch.diff.inverse import apply_params
from akari_torch.integrators import bdpt as pb
from akari_torch.integrators.path import _intersectors
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene import builtin as port_builtin
from akari_torch.scene import sdl as port_sdl
from akari_tpu.diff.inverse import apply_params as ref_apply_params
from akari_tpu.diff.inverse import scene_params as ref_scene_params
from akari_tpu.integrators import bdpt as rb
from akari_tpu.integrators.path import _jax_intersectors
from akari_tpu.scene import builtin as ref_builtin
from akari_tpu.scene import sdl as ref_sdl
from akari_tpu.scene.arrays import make_camera as ref_make_camera

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_bdpt_cornell64_spp4.npy")
N = 256
TOL = dict(rtol=1e-5, atol=1e-6)
BUDGET = dict(outlier_frac=0.005, mean_tol=2e-4)


def _glass_materials(mod, mats):
    """tests/test_bdpt.py's glass Cornell: the first diffuse material from
    index 3 on turned to glass."""
    mats = list(mats)
    for i, m in enumerate(mats):
        if isinstance(m, mod.DiffuseMaterial) and i >= 3:
            mats[i] = mod.GlassMaterial(ior=1.5)
            break
    return mats


_CACHE = {}


def scenes(name):
    """(reference scene, port scene, reference camera, port camera)."""
    if name in _CACHE:
        return _CACHE[name]
    if name in ("cornell", "glass"):
        sc = ref_builtin.cornell_box(16, 16)
        if name == "glass":
            mesh = sc.shapes[0]
            sc = dataclasses.replace(sc, shapes=[dataclasses.replace(
                mesh, materials=_glass_materials(ref_nodes, mesh.materials))])
        ref, port = both(sc.compile(intersector="brute"))
        cam = sc.camera
    else:  # the env + lamp scene of tests/test_torch_envmap.py
        from test_torch_envmap import C2W, env_shapes, sky

        ref_c = ref_nodes.compile_scene(env_shapes(ref_nodes), intersector="brute",
                                        environment=ref_nodes.EnvMapLight(sky()))
        ref, port = both(ref_c)
        cam = ref_make_camera(C2W, 50.0, 16, 16)
    _CACHE[name] = ref, port, cam, port_camera(cam)
    return _CACHE[name]


def ref_trace(name, cfg, cam=None, lane_mask=None, sample=0):
    ref, _, cam_r, _ = scenes(name)
    ifn, ofn, _ = _jax_intersectors(ref)
    mask = None if lane_mask is None else jnp.asarray(lane_mask)
    li, sp = rb.trace_bdpt(ref, cam or cam_r, rb.BDPTConfig(**cfg), 0, jnp.uint32(sample),
                           jnp.arange(N, dtype=jnp.uint32), ifn, ofn, jnp, lane_mask=mask)
    return np.asarray(li), np.asarray(sp)


def port_trace(name, cfg, cam=None, lane_mask=None, sample=0):
    _, port, _, cam_p = scenes(name)
    ifn, ofn = _intersectors(port)
    mask = None if lane_mask is None else torch.from_numpy(lane_mask)
    li, sp = pb.trace_bdpt(port, cam or cam_p, pb.BDPTConfig(**cfg), 0, sample,
                           torch.arange(N), ifn, ofn, lane_mask=mask)
    return li.numpy(), sp.numpy()


def assert_trace_matches(name, cfg, cam_r=None, cam_p=None, lane_mask=None, lit=0.01):
    li, sp = port_trace(name, cfg, cam_p, lane_mask)
    li_r, sp_r = ref_trace(name, cfg, cam_r, lane_mask)
    assert np.isfinite(li).all() and np.isfinite(sp).all()
    assert li.mean() + sp.mean() > lit
    assert_images_match(li, li_r, **BUDGET)
    assert_images_match(sp, sp_r, **BUDGET)
    return li, sp


# --------------------------------- tapes ----------------------------------------

def _tape_equal(got, want, depth):
    assert set(got) == set(want)
    for key, col in got.items():
        assert len(col) == depth, key
        a = torch.stack(col, dim=1).numpy()
        b = np.asarray(want[key])
        assert a.shape == b.shape, key
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=key)
        else:
            rtol = 1e-2 if key in ("pdf_fwd", "pdf_rev") else 1e-5
            np.testing.assert_allclose(a, b, err_msg=key, rtol=rtol, atol=1e-5)


def test_eye_and_light_tapes_match_jax():
    ref, port, cam_r, cam_p = scenes("cornell")
    cfg_r, cfg_p = rb.BDPTConfig(spp=1), pb.BDPTConfig(spp=1)
    ifn_r, _, _ = _jax_intersectors(ref)
    ifn_p, _ = _intersectors(port)
    px_r, px_p = jnp.arange(N, dtype=jnp.uint32), torch.arange(N)
    eye_r, env_r = rb._trace_eye_subpath(ref, cam_r, cfg_r, 0, jnp.uint32(0), px_r, ifn_r, jnp)
    eye_p, env_p = pb._trace_eye_subpath(port, cam_p, cfg_p, 0, 0, px_p, ifn_p)
    _tape_equal(eye_p, eye_r, cfg_p.eye_depth)
    np.testing.assert_array_equal(env_p.numpy(), np.asarray(env_r))
    light_r = rb._trace_light_subpath(ref, cfg_r, 0, jnp.uint32(0), px_r, ifn_r, jnp)
    light_p = pb._trace_light_subpath(port, cfg_p, 0, 0, px_p, ifn_p)
    _tape_equal(light_p, light_r, cfg_p.light_depth)
    assert eye_p["valid"][1].sum() > 100 and light_p["valid"][1].sum() > 50


def _connect_points(cam, extra):
    """Points on exact pixel boundaries (film x, y at k / w), 1 ulp to
    either side, and seeded random points in front of the camera."""
    w, h = cam.width, cam.height
    sx, sy = (float(v) for v in pb._film_plane(cam))
    c2w = np.asarray(cam.c2w, np.float64)
    k = np.arange(w + 1, dtype=np.float64)
    ndc = np.float32(2.0 * k / w - 1.0)
    ndc = np.concatenate([ndc, np.nextafter(ndc, np.float32(2)), np.nextafter(ndc, np.float32(-2))])
    gx, gy = np.meshgrid(ndc, ndc[::3])
    z = np.float32(4.0)
    cam_pts = np.stack([gx.ravel() * sx * z, gy.ravel() * sy * z, np.full(gx.size, -z)], -1)
    r = np.random.default_rng(7)
    rnd = np.stack([r.uniform(-1.2, 1.2, extra) * sx, r.uniform(-1.2, 1.2, extra) * sy,
                    -np.ones(extra)], -1) * r.uniform(0.5, 9.0, (extra, 1))
    pts = np.concatenate([cam_pts, rnd]) @ c2w[:3, :3].T + c2w[:3, 3]
    return pts.astype(np.float32)


@pytest.mark.parametrize("scene", ["cornell", "terrain"])
def test_camera_connect_pixels_exact(scene):
    if scene == "cornell":  # identity rotation: boundaries land exactly
        cam_r = ref_builtin.cornell_box(16, 12).camera
    else:                   # a rotated camera: random points only
        cam_r = ref_builtin.terrain_scene(16, 12, n=4).camera
    cam_p = port_camera(cam_r)
    p = _connect_points(cam_p, 3000)
    if scene == "terrain":
        p = p[-3000:]
    got = pb._camera_connect(cam_p, torch.from_numpy(p))
    want = rb._camera_connect(cam_r, jnp.asarray(p), jnp)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))   # pix
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))   # in_frustum
    assert got[3].numpy().mean() > 0.3
    for a, b in zip(got[:2] + got[4:7], want[:2] + want[4:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------ whole samples -----------------------------------

def test_trace_bdpt_matches_jax():
    li, sp = assert_trace_matches("cornell", dict(spp=1))
    assert sp.max() > 0  # light tracing splats


def test_glass_cornell_delta_mis_matches_jax():
    _, port, _, _ = scenes("glass")
    assert int((port.materials.kind == 5).sum()) == 1
    assert_trace_matches("glass", dict(spp=1, eye_depth=4, light_depth=2))


def test_env_scene_matches_jax():
    li, _ = assert_trace_matches("env", dict(spp=1, eye_depth=3, light_depth=2))
    assert li.mean() > 0.2


@pytest.mark.parametrize("variant", ["light_tracing_off", "thin_lens"])
def test_without_t1_matches_jax(variant):
    cfg = dict(spp=1, eye_depth=3, light_depth=2)
    cam_r = cam_p = None
    if variant == "light_tracing_off":
        cfg["light_tracing"] = False
    else:
        ref, port, cam_r, cam_p = scenes("cornell")
        cam_r = dataclasses.replace(cam_r, lens_radius=0.05, focal_distance=8.0)
        cam_p = dataclasses.replace(cam_p, lens_radius=0.05, focal_distance=8.0)
    _, sp = assert_trace_matches("cornell", cfg, cam_r, cam_p)
    assert not sp.any()  # t = 1 off: no splat


def test_max_vertices_matches_jax():
    assert_trace_matches("cornell", dict(spp=1, eye_depth=3, light_depth=2, max_vertices=3))


def test_lane_mask_matches_jax():
    mask = np.random.default_rng(8).uniform(size=N) < 0.6
    _, sp = assert_trace_matches("cornell", dict(spp=1, eye_depth=2, light_depth=2),
                                 lane_mask=mask)
    _, sp_all = port_trace("cornell", dict(spp=1, eye_depth=2, light_depth=2))
    assert 0 < sp.sum() < sp_all.sum()


def test_bdpt_queries_per_sample(monkeypatch):
    """eye_depth + light_depth - 1 closest-hit launches and one any-hit
    launch per sample (15 entries of 256 rays); a smaller group cap splits
    the queue into more launches and changes no answer."""
    from akari_torch.integrators import path as port_path

    _, port, _, cam_p = scenes("cornell")
    calls = []
    real_i, real_o = port_path.intersect_soa, port_path.occlude_soa
    monkeypatch.setattr(port_path, "intersect_soa",
                        lambda *a, **k: calls.append(("closest", a[1].x.shape[0])) or real_i(*a, **k))
    monkeypatch.setattr(port_path, "occlude_soa",
                        lambda *a, **k: calls.append(("any", a[1].x.shape[0])) or real_o(*a, **k))
    li, sp = port_trace("cornell", dict(spp=1))
    assert calls == [("closest", N)] * 6 + [("any", 15 * N)]
    calls.clear()
    monkeypatch.setattr(pb, "BDPT_OCC_CHUNK_RAYS", 4 * N)
    li2, sp2 = port_trace("cornell", dict(spp=1))
    assert calls == [("closest", N)] * 6 + [("any", 4 * N)] * 3 + [("any", 3 * N)]
    np.testing.assert_array_equal(li, li2)
    np.testing.assert_array_equal(sp, sp2)


def test_sdl_bdpt_node_matches_reference():
    src = ("export a = BDPT { spp: 8, max_depth: 5, light_depth: 2, ray_clamp: 30,"
           " max_vertices: 4, light_tracing: false }\nexport b = BDPT {}\n")
    for key in ("a", "b"):
        got = port_sdl.parse_string(src).exports[key]
        want = ref_sdl.parse_string(src).exports[key]
        assert isinstance(got, pb.BDPTConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_loss_and_image_with_bdpt_matches_jax_grad():
    """The BDPT branch of loss_and_image (radiance + splat film) against
    jax.grad of the same loss over the reference's trace_bdpt."""
    ref, port, cam_r, cam_p = scenes("cornell")
    cfg = dict(spp=1, eye_depth=2, light_depth=2)
    target = np.full((16, 16, 3), 0.1, np.float32)

    def loss(p):
        return loss_and_image(apply_params(port, p), cam_p, pb.BDPTConfig(**cfg),
                              torch.from_numpy(target))[0]

    got_loss, g = port_value_and_grad(loss, {"tex_value": np.asarray(port.textures.value)})

    def f(params):
        sc = ref_apply_params(ref, params)
        ifn, ofn, _ = _jax_intersectors(sc)
        li, sp = rb.trace_bdpt(sc, cam_r, rb.BDPTConfig(**cfg), 0, jnp.uint32(0),
                               jnp.arange(N, dtype=jnp.uint32), ifn, ofn, jnp)
        return jnp.sum((li + sp - jnp.asarray(target).reshape(-1, 3)) ** 2) / (N * 3)

    want_loss, want = jax.value_and_grad(f)(ref_scene_params(ref))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    assert_rel_close(g["tex_value"], np.asarray(want["tex_value"]), 1e-5)
    _, img = loss_and_image(port, cam_p, pb.BDPTConfig(**cfg), torch.from_numpy(target))
    li, sp = port_trace("cornell", cfg)
    np.testing.assert_array_equal(img.reshape(-1, 3).numpy(), li + sp)


def test_bdpt_golden_64():
    """64x64, BDPTConfig(spp=4) on the Cornell box against the JAX
    package's image (tools/make_torch_port_bdpt_golden.py)."""
    sc = port_builtin.cornell_box(64, 64)
    img = pb.render_bdpt(sc.compile(), sc.camera, pb.BDPTConfig(spp=4)).numpy()
    assert_images_match(img, np.load(GOLDEN), outlier_frac=0.08, mean_tol=3e-3)


# --------------------- the [N, 3] shading entry points ------------------------

def test_aos_bsdf_closures_match_jax():
    """bsdf.eval / pdf / sample_world (soa.py's closures on [N, 3] columns)
    and make_frame against the reference's AoS closures, over every closure
    kind and microfacet model on seeded directions."""
    from akari_torch.shading import bsdf as pbsdf
    from akari_tpu.shading import bsdf as rbsdf

    r = np.random.default_rng(9)
    n = 2000

    def unit(k):
        v = r.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    params = {
        "kind": r.integers(-1, 4, n).astype(np.int32),
        "color": r.uniform(0, 1, (n, 3)).astype(np.float32),
        "alpha": r.uniform(0.05, 1.0, n).astype(np.float32),
        "dist": r.integers(0, 3, n).astype(np.int32),
        "ior": r.uniform(1.1, 2.0, n).astype(np.float32),
        "choice_pdf": r.uniform(0.5, 2.0, n).astype(np.float32),
    }
    wo, wi, ns = unit(n), unit(n), unit(n)
    u = r.uniform(0, 1, (n, 2)).astype(np.float32)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    T = torch.from_numpy
    fp, fr = pbsdf.make_frame(T(ns)), rbsdf.make_frame(jnp.asarray(ns))
    for a, b in zip(fp, fr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    pairs = [
        (pbsdf.eval_world(pp, fp, T(wo), T(wi)), rbsdf.eval_world(rp, fr, jnp.asarray(wo),
                                                                   jnp.asarray(wi))),
        (pbsdf.pdf_world(pp, fp, T(wo), T(wi)), rbsdf.pdf_world(rp, fr, jnp.asarray(wo),
                                                                 jnp.asarray(wi))),
    ]
    pairs += list(zip(pbsdf.sample_world(pp, fp, T(wo), T(u)),
                      rbsdf.sample_world(rp, fr, jnp.asarray(wo), jnp.asarray(u))))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
