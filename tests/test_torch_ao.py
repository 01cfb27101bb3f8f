"""Port parity: the ambient-occlusion integrator (akari_torch.integrators.ao,
its AoS intersector adapters, the SDL ``AO`` node, CLI ``--ao``) vs
akari_tpu.

Tolerances: primary hit prims exact; per-sample AO values (0 or 1 a lane)
within an outlier budget of 0.005 of the elements (an occlusion ray that
grazes an edge may decide differently after few-ulp differences in its
cosine-sampled direction), mean within 2e-3; the 64x64 golden within the
budget of tests/_imgcmp.py (outlier_frac 0.08, mean_tol 3e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _imgcmp import assert_images_match
from _port_diff import both, port_camera
from akari_torch.cli.render import main
from akari_torch.core.spectrum import to_uint8_srgb
from akari_torch.integrators import ao as port_ao
from akari_torch.integrators.path import _intersectors, camera_rays
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene import builtin as port_builtin
from akari_torch.scene import sdl as port_sdl
from akari_tpu.integrators import ao as ref_ao
from akari_tpu.integrators.path import _jax_intersectors
from akari_tpu.scene import builtin as ref_builtin
from akari_tpu.scene import sdl as ref_sdl

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_ao_terrain64_spp16.npy")

_CACHE = {}


def scenes(name):
    """(reference scene, port scene, reference camera, port camera): the
    16x16 Cornell box (dense route) or the n=16 terrain (tree route)."""
    if name not in _CACHE:
        if name == "cornell":
            sc = ref_builtin.cornell_box(16, 16)
            ref, port = both(sc.compile(intersector="brute"))
        else:
            # the port's own compile (same storage order) with the tree
            # tables its route needs; the reference's brute compile
            sc = ref_builtin.terrain_scene(16, 16, n=16)
            ref = jax.tree_util.tree_map(jnp.asarray, sc.compile(intersector="brute"))
            port = port_builtin.terrain_scene(16, 16, n=16).compile(intersector="tree",
                                                                    device="cpu")
        _CACHE[name] = ref, port, sc.camera, port_camera(sc.camera)
    return _CACHE[name]


@pytest.mark.parametrize("name", ["cornell", "terrain"])
def test_trace_ao_matches_jax(name):
    ref, port, cam_r, cam_p = scenes(name)
    n = 256
    px_r, px_p = jnp.arange(n, dtype=jnp.uint32), torch.arange(n)
    ifn_r, ofn_r, _ = _jax_intersectors(ref)
    ifn_p, ofn_p = _intersectors(port)
    # primary hits: the same prims
    from akari_tpu.integrators.path import camera_rays as ref_camera_rays

    o_r, d_r = ref_camera_rays(cam_r, 0, jnp.uint32(0), px_r, jnp)
    o_p, d_p = camera_rays(cam_p, 0, 0, px_p)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), rtol=1e-6, atol=1e-6)
    prim_r = np.asarray(ifn_r(o_r, d_r)[1])
    prim_p = ifn_p(o_p, d_p)[1].numpy()
    np.testing.assert_array_equal(prim_p, prim_r)
    cfg_r, cfg_p = ref_ao.AOConfig(spp=4), port_ao.AOConfig(spp=4)
    got = np.stack([port_ao.trace_ao(port, cam_p, cfg_p, 0, s, px_p, ifn_p, ofn_p).numpy()
                    for s in range(4)])
    want = np.stack([np.asarray(ref_ao.trace_ao(ref, cam_r, cfg_r, 0, jnp.uint32(s), px_r,
                                                ifn_r, ofn_r, jnp)) for s in range(4)])
    assert set(np.unique(got)) <= {0.0, 1.0} and got.mean() > 0.2
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-3)


def test_ao_queries_per_sample(monkeypatch):
    """One closest-hit and one any-hit query per sample."""
    import importlib

    # the AoS queries (ops/intersect.py intersect / occlude) each make one
    # SoA query in their module
    isect = importlib.import_module("akari_torch.ops.intersect")

    _, port, _, cam_p = scenes("cornell")
    calls = []
    real_i, real_o = isect.intersect_soa, isect.occlude_soa
    monkeypatch.setattr(isect, "intersect_soa",
                        lambda *a, **k: calls.append("closest") or real_i(*a, **k))
    monkeypatch.setattr(isect, "occlude_soa",
                        lambda *a, **k: calls.append("any") or real_o(*a, **k))
    port_ao.render_ao(port, cam_p, port_ao.AOConfig(spp=3))
    assert calls == ["closest", "any"] * 3


def test_ao_golden_64():
    """64x64, 16 spp AO of the n=64 terrain (tree route) against the JAX
    package's image (tools/make_torch_port_ao_golden.py)."""
    sc = port_builtin.terrain_scene(64, 64, n=64)
    scene = sc.compile(device="cpu")
    assert scene.intersector == "tree"
    img = port_ao.render_ao(scene, sc.camera, port_ao.AOConfig()).numpy()
    assert_images_match(img, np.load(GOLDEN), outlier_frac=0.08, mean_tol=3e-3)


def test_sdl_ao_node_matches_reference():
    src = "export a = AO { spp: 5, occlude: 2.5 }\nexport b = AO {}\n"
    for key in ("a", "b"):
        got = port_sdl.parse_string(src).exports[key]
        want = ref_sdl.parse_string(src).exports[key]
        assert isinstance(got, port_ao.AOConfig)
        assert (got.spp, got.occlude_distance) == (want.spp, want.occlude_distance)


def test_cli_ao_matches_render_ao(tmp_path):
    """``--ao`` on the SDL Cornell box at 16x16: the PNG is the sRGB of
    render_ao, and the JAX package's render_ao agrees within the budget."""
    out = tmp_path / "ao.png"
    assert main(["-i", SCENE_FILE, "-o", str(out), "--device", "cpu", "--ao",
                 "--width", "16", "--height", "16", "--spp", "4"]) == 0
    png = np.asarray(Image.open(out).convert("RGB"))
    node = port_sdl.parse_file(SCENE_FILE).exports["scene"]
    import dataclasses

    cam = dataclasses.replace(node.camera, width=16, height=16)
    img = port_ao.render_ao(node.compile(device="cpu"), cam, port_ao.AOConfig(spp=4)).numpy()
    np.testing.assert_array_equal(png, to_uint8_srgb(img))
    ref_node = ref_sdl.parse_file(SCENE_FILE).exports["scene"]
    ref_cam = dataclasses.replace(ref_node.camera, width=16, height=16)
    want = np.asarray(ref_ao.render_ao(ref_node.compile(intersector="brute"), ref_cam,
                                       ref_ao.AOConfig(spp=4)))
    assert_images_match(img, want, outlier_frac=0.005, mean_tol=2e-3)


def test_loss_and_image_with_ao_config():
    """loss_and_image dispatches on AOConfig: the image is render_ao's and
    the loss its mean squared difference to the target."""
    _, port, _, cam_p = scenes("cornell")
    target = torch.full((16, 16, 3), 0.25)
    loss, img = loss_and_image(port, cam_p, port_ao.AOConfig(spp=2), target)
    want = port_ao.render_ao(port, cam_p, port_ao.AOConfig(spp=2))
    assert torch.equal(img, want)
    assert float(loss) == pytest.approx(float(((want - target) ** 2).mean()), rel=1e-6)
