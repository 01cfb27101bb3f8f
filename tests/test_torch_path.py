"""Port parity: the forward path tracer (akari_torch.integrators.path vs
akari_tpu.integrators.path and the NumPy oracle), on the Cornell box at
16x16.

Tolerances follow tests/test_render.py and tests/_imgcmp.py:

- per-sample ``trace_paths`` against the JAX per-sample program:
  outlier_frac = 0.005, mean_tol = 2e-4 (like-for-like programs; the same
  random numbers and hit decisions, radiance to float32 rounding);
- a full ``render`` against the JAX ``render`` and the oracle:
  outlier_frac = 0.08, mean_tol = 3e-3 (different programs flip a few
  knife-edge hits);
- camera hits: exactly equal prims; pinhole rays rtol = 1e-6, thin-lens
  rays rtol = 1e-5 (XLA's and torch's sin/cos of the lens sample differ
  by a few ulp).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _imgcmp import assert_images_match
from akari_torch.integrators import path as port_path
from akari_torch.ops import dense_intersect as di
from akari_torch.scene.arrays import from_numpy_scene
from akari_tpu.integrators import path as ref_path
from akari_tpu.oracle.renderer import render_oracle
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16


@pytest.fixture(scope="module")
def scenes():
    sc = ref_cornell_box(RES, RES)
    ref = sc.compile(intersector="brute")
    port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    return ref, port, sc.camera


def _port_camera(cam):
    from akari_torch.scene.arrays import make_camera

    c = make_camera(np.asarray(cam.c2w), 15.0, cam.width, cam.height)
    assert np.float32(c.tan_half_fov) == np.float32(cam.tan_half_fov)
    return c


def _per_sample_port(port, cam, cfg, seed, spp):
    n = cam.width * cam.height
    px = torch.arange(n, dtype=torch.int64)
    acc = sum(
        port_path.trace_paths(port, cam, cfg, seed, torch.full((n,), s), px)
        .numpy().astype(np.float64)
        for s in range(spp)
    )
    return (acc / spp).reshape(cam.height, cam.width, 3)


def _per_sample_jax(scene, cam, cfg, seed, spp):
    """Same program shape as tests/test_render.py's per-sample JAX run."""
    n = cam.width * cam.height

    @jax.jit
    def one(s):
        ifn, ofn, ffn = ref_path._jax_intersectors_soa(scene)
        px = jnp.arange(n, dtype=jnp.uint32)
        sx = jnp.full(n, s, jnp.uint32)
        return ref_path.trace_paths(
            scene, cam, cfg, jnp.uint32(seed), sx, px, ifn, ofn, jnp,
            fused_fn=ffn,
        )

    acc = sum(np.asarray(one(s), np.float64) for s in range(spp)) / spp
    return acc.reshape(cam.height, cam.width, 3)


def test_per_sample_trace_paths_matches_jax(scenes):
    ref, port, cam = scenes
    img_p = _per_sample_port(port, _port_camera(cam), port_path.PathConfig(spp=2, max_depth=3), 0, 2)
    img_r = _per_sample_jax(ref, cam, ref_path.PathConfig(spp=2, max_depth=3), 0, 2)
    assert_images_match(img_p, img_r, outlier_frac=0.005, mean_tol=2e-4)


@pytest.mark.parametrize("mis", [True, False, "bsdf"])
def test_per_sample_trace_paths_matches_oracle(scenes, mis):
    ref, port, cam = scenes
    cfg_p = port_path.PathConfig(spp=2, max_depth=3, mis=mis)
    cfg_r = ref_path.PathConfig(spp=2, max_depth=3, mis=mis)
    img_p = _per_sample_port(port, _port_camera(cam), cfg_p, 1, 2)
    img_o = render_oracle(ref, cam, cfg_r, seed=1)
    assert_images_match(img_p, img_o, outlier_frac=0.005, mean_tol=2e-4)


def test_camera_hit_decisions_equal(scenes):
    ref, port, cam = scenes
    n = cam.width * cam.height
    px = np.arange(n, dtype=np.uint32)
    sx = np.full(n, 3, np.uint32)
    o_r, d_r = ref_path.camera_rays_soa(cam, 5, jnp.asarray(sx), jnp.asarray(px), jnp)
    o_p, d_p = port_path.camera_rays_soa(
        _port_camera(cam), 5, torch.from_numpy(sx.astype(np.int64)),
        torch.from_numpy(px.astype(np.int64)),
    )
    for a, b in zip((*o_p, *d_p), (*o_r, *d_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    ifn, _, _ = ref_path._jax_intersectors_soa(ref)
    t_r, prim_r, _, _, valid_r = ifn(o_r, d_r)
    t_p, prim_p, _, _, valid_p = port_path._intersectors_soa(port)[0](o_p, d_p)
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))
    np.testing.assert_array_equal(prim_p.numpy(), np.asarray(prim_r))
    assert valid_p.float().mean() > 0.8  # the box fills most of the view


@pytest.mark.parametrize("res", [(16, 16), (24, 10), (10, 24)])
def test_thin_lens_camera_rays_match(res):
    """Thin-lens and non-square cameras generate the reference's rays."""
    from akari_torch.core import transform
    from akari_torch.scene.arrays import make_camera
    from akari_tpu.scene.arrays import make_camera as ref_make_camera

    c2w = transform.translate((0.2, 1.0, 6.0)) @ transform.euler_zyx((0.1, -0.3, 0.05))
    w, h = res
    cam_p = make_camera(c2w, 30.0, w, h, lens_radius=0.05, focal_distance=5.5)
    cam_r = ref_make_camera(c2w, 30.0, w, h, lens_radius=0.05, focal_distance=5.5)
    n = w * h
    px = np.arange(n, dtype=np.uint32)
    sx = np.full(n, 2, np.uint32)
    o_r, d_r = ref_path.camera_rays_soa(cam_r, 3, jnp.asarray(sx), jnp.asarray(px), jnp)
    o_p, d_p = port_path.camera_rays_soa(
        cam_p, 3, torch.from_numpy(sx.astype(np.int64)), torch.from_numpy(px.astype(np.int64))
    )
    for a, b in zip((*o_p, *d_p), (*o_r, *d_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_full_render_matches_jax_render_and_oracle(scenes):
    ref, port, cam = scenes
    cfg_r = ref_path.PathConfig(spp=2, max_depth=3)
    img_p = port_path.render(port, _port_camera(cam), port_path.PathConfig(spp=2, max_depth=3), seed=0)
    img_p = img_p.numpy()
    img_j = np.asarray(jax.jit(ref_path.render, static_argnums=(2, 3))(ref, cam, cfg_r, 0))
    img_o = render_oracle(ref, cam, cfg_r, seed=0)
    assert img_p.shape == (RES, RES, 3) and np.isfinite(img_p).all()
    assert_images_match(img_p, img_j, outlier_frac=0.08, mean_tol=3e-3)
    assert_images_match(img_p, img_o, outlier_frac=0.08, mean_tol=3e-3)


def test_render_folds_samples_like_reference(scenes, monkeypatch):
    """spp split over several wavefront chunks, with a partial last chunk
    and a sample offset, matches the one-chunk render of the same slice."""
    _, port, cam = scenes
    pcam = _port_camera(cam)
    cfg = port_path.PathConfig(spp=3, max_depth=2)
    one = port_path.render(port, pcam, cfg, seed=2, sample_offset=5)
    monkeypatch.setattr(port_path, "MAX_RAYS_IN_FLIGHT", 2 * RES * RES)
    chunked = port_path.render(port, pcam, cfg, seed=2, sample_offset=5)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-6, atol=1e-7)


def test_dense_queries_per_trace(scenes, monkeypatch):
    """One primary query plus one fused shadow+extension query per bounce:
    1 + max_depth closest-hit launches on the card."""
    _, port, cam = scenes
    calls = []
    real = di.closest

    def counting(rays, tris):
        calls.append(rays.shape[1])
        return real(rays, tris)

    monkeypatch.setattr(di, "closest", counting)
    n = cam.width * cam.height
    port_path.trace_paths(
        port, _port_camera(cam), port_path.PathConfig(spp=1, max_depth=4), 0,
        torch.zeros(n, dtype=torch.int64), torch.arange(n),
    )
    assert calls == [n] + [2 * n] * 4


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import akari_torch.integrators.path, akari_torch.cli.render\n"
        "import akari_torch.scene.sdl, akari_torch.scene.builtin\n"
        "import akari_torch.ops.dense_intersect, akari_torch.kernels.build\n"
        "import akari_torch.diff.inverse, akari_torch.diff.boundary\n"
        "import akari_torch.parallel.render, akari_torch.integrators.progressive\n"
        "import akari_torch.utils, akari_torch.utils.checkpoint, akari_torch.core.film\n"
        "import akari_torch.cli.importer, akari_torch.scene.meshcache\n"
        "import akari_torch.core.tiff, akari_torch.core.jpeg, akari_torch.core.image_formats\n"
        "import akari_torch.core.webp, akari_torch.core.lcms, akari_torch.core.icns\n"
        "import akari_torch.core.im, akari_torch.core.iptc, akari_torch.core.pcd\n"
        "import akari_torch.core.spider, akari_torch.core.pcx\n"
        "import akari_torch.core.sun, akari_torch.core.fli, akari_torch.core.fits\n"
        "import akari_torch.core.rasters, akari_torch.core.xpm\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'akari_tpu', 'ml_dtypes', 'PIL')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
