"""Port parity: the numeric variant (``akari_torch/utils/config.py``,
``PathConfig.dtypes``) against akari_tpu's ``RGB_BF16``.

The reference really rounds on the CPU: its bfloat16 render differs from
its float32 one (``test_reference_bf16_render_rounds``), so it is a
bfloat16 reference. Tolerances:

- ``variant_string``: equal strings;
- ``_bounce_step``'s carried L and beta, bounce by bounce (both packages
  op by op): equal except on lanes where the float32 value before the cast
  differs by float32 ulps between the packages (torch's and XLA's
  transcendentals; the float32 carries differ so on 20-45 % of lanes)
  and straddles a bfloat16 rounding boundary; there one bfloat16 ulp
  (2^-7 relative). At most 2 % of lanes may differ (measured: at most
  0.8 % on the Cornell box, none on the env scene);
- renders: the per-sample budget of tests/test_torch_path.py
  (outlier_frac 0.005, mean_tol 2e-4); the 64x64 golden
  (tools/make_torch_port_bf16_golden.py) within tests/_imgcmp.py's budget;
- the loss under RGB_BF16 within rtol 1e-6 and d loss / d tex_value
  within 1e-5 of max|g| of jax.grad's, the float32 tests' bounds
  (measured 1.9e-7 and 8.4e-8: the bfloat16 cotangents at the casts
  round alike in both packages).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_torch.scene.nodes as port_nodes
import akari_tpu.scene.nodes as ref_nodes
from _imgcmp import assert_images_match
from _port_diff import (
    assert_rel_close, both, port_camera, port_value_and_grad, ref_loss_fn,
)
from akari_torch.cli.render import main as cli_main
from akari_torch.core import vecmath
from akari_torch.core.image import read_image
from akari_torch.core.v3 import V3
from akari_torch.diff.inverse import apply_params
from akari_torch.integrators import path as port_path
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene.arrays import from_numpy_scene, make_camera
from akari_torch.scene.builtin import cornell_box
from akari_torch.utils import config
from akari_tpu.core.v3 import V3 as RefV3
from akari_tpu.diff.inverse import scene_params as ref_scene_params
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from akari_tpu.utils import config as ref_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5_bf16.npy")
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")
BF16_ULP = 2.0 ** -7


def test_variant_strings_match_reference():
    assert config.variant_string() == ref_config.variant_string() == "rgb-float32-float32"
    assert (config.variant_string(config.RGB_BF16)
            == ref_config.variant_string(ref_config.RGB_BF16) == "rgb-bfloat16-float32")
    assert config.RGB == config.DtypePolicy()
    assert port_path.PathConfig().dtypes == config.RGB
    assert config.RGB_BF16.spectrum is torch.bfloat16
    assert config.RGB_BF16.accum is torch.float32


_SCENES = {}


def _env_scene():
    """A floor, a glossy triangle and a lamp under a seeded sky: the env
    branches (escape, NEE mixture, ``env_p_select``) meet the carries."""
    r = np.random.default_rng(3)
    sky = r.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)

    def shapes(mod):
        return [
            mod.Mesh(vertices=np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                                         np.float32),
                     indices=np.asarray([[0, 2, 1], [0, 3, 2]], np.int64),
                     materials=[mod.DiffuseMaterial((0.7, 0.6, 0.5))]),
            mod.Mesh(vertices=np.asarray([[0, 0.5, 0], [1, 0.5, 0], [0, 1.5, 0]], np.float32),
                     indices=np.asarray([[0, 1, 2]], np.int64),
                     materials=[mod.GlossyMaterial((0.8, 0.8, 0.8), 0.3)]),
            mod.Mesh(vertices=np.asarray([[-0.5, 2.5, -0.5], [0.5, 2.5, -0.5], [0.5, 2.5, 0.5],
                                          [-0.5, 2.5, 0.5]], np.float32),
                     indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int64),
                     materials=[mod.EmissiveMaterial((8.0, 8.0, 8.0))]),
        ]

    ref = ref_nodes.compile_scene(shapes(ref_nodes), intersector="brute",
                                  environment=ref_nodes.EnvMapLight(sky))
    from akari_tpu.core import transform as ref_xf
    from akari_tpu.scene.arrays import make_camera as ref_make_camera

    c2w = ref_xf.translate((0.0, 2.0, 4.0)) @ ref_xf.rotate_x(np.radians(-30.0))
    ref_np = jax.tree_util.tree_map(np.asarray, ref)
    return (jax.tree_util.tree_map(jnp.asarray, ref_np), from_numpy_scene(ref_np, device="cpu"),
            ref_make_camera(c2w, 50.0, 16, 16), make_camera(np.asarray(c2w, np.float32),
                                                            50.0, 16, 16))


def scenes(name):
    """(reference scene, port scene, reference camera, port camera) at 16x16."""
    if name not in _SCENES:
        if name == "cornell":
            sc = ref_cornell_box(16, 16)
            ref, port = both(sc.compile(intersector="brute"))
            _SCENES[name] = ref, port, sc.camera, port_camera(sc.camera)
        else:
            _SCENES[name] = _env_scene()
    return _SCENES[name]


def test_reference_bf16_render_rounds():
    ref, port, cam_r, cam_p = scenes("cornell")
    f32 = np.asarray(ref_path.render(ref, cam_r, ref_path.PathConfig(spp=2, max_depth=3)))
    bf = np.asarray(ref_path.render(
        ref, cam_r, ref_path.PathConfig(spp=2, max_depth=3, dtypes=ref_config.RGB_BF16)))
    assert (f32 != bf).mean() > 0.5
    got = port_path.render(port, cam_p, port_path.PathConfig(
        spp=2, max_depth=3, dtypes=config.RGB_BF16)).numpy()
    assert_images_match(got, bf, outlier_frac=0.005, mean_tol=2e-4)
    assert got.dtype == np.float32 and (got != port_path.render(
        port, cam_p, port_path.PathConfig(spp=2, max_depth=3)).numpy()).mean() > 0.5


def _carries(name, xp, depth=5):
    """Each bounce's (L, beta) components [6, N] of one sample at 16x16
    under RGB_BF16, running ``_bounce_step`` op by op."""
    ref, port, cam_r, cam_p = scenes(name)
    n = 256
    out = []
    if xp is torch:
        cfg = port_path.PathConfig(spp=1, max_depth=depth, dtypes=config.RGB_BF16)
        ints = port_path._intersectors_soa(port)
        pix, smp = torch.arange(n), torch.zeros(n, dtype=torch.int64)
        o, d = port_path.camera_rays_soa(cam_p, 0, smp, pix)
        z, one = torch.zeros(n, dtype=torch.bfloat16), torch.ones(n, dtype=torch.bfloat16)
        st = (ints[0](o, d), o, d, V3(z, z, z), V3(one, one, one),
              torch.ones(n, dtype=torch.bool), torch.zeros(n))
        for b in range(depth):
            st = port_path._bounce_step(port, cfg, 0, smp, pix, st, b, *ints)
            assert all(c.dtype == torch.bfloat16 for c in (*st[3], *st[4]))
            out.append(np.stack([c.float().numpy() for c in (*st[3], *st[4])]))
        return out
    cfg = ref_path.PathConfig(spp=1, max_depth=depth, dtypes=ref_config.RGB_BF16)
    ints = ref_path._jax_intersectors_soa(ref)
    pix, smp = jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32)
    o, d = ref_path.camera_rays_soa(cam_r, jnp.uint32(0), smp, pix, jnp)
    z, one = jnp.zeros(n, jnp.bfloat16), jnp.ones(n, jnp.bfloat16)
    st = (ints[0](o, d), o, d, RefV3(z, z, z), RefV3(one, one, one), jnp.ones(n, bool),
          jnp.zeros(n, jnp.float32))
    for b in range(depth):
        st = ref_path._bounce_step(ref, cfg, jnp.uint32(0), smp, pix, st, b, *ints, jnp)
        out.append(np.stack([np.asarray(c.astype(jnp.float32)) for c in (*st[3], *st[4])]))
    return out


@pytest.mark.parametrize("name", ["cornell", "env"])
def test_bf16_bounce_carries_match_jax(name):
    got, want = _carries(name, torch), _carries(name, jnp)
    lit = 0.0
    for b, (g, w) in enumerate(zip(got, want)):
        differ = g != w
        assert differ.any(axis=0).mean() <= 0.02, (b, differ.any(axis=0).mean())
        np.testing.assert_array_less(np.abs(g - w)[differ],
                                     BF16_ULP * np.abs(w)[differ] + 1e-30)
        lit = max(lit, float(w[:3].max()))
    assert lit > 0.1


@pytest.mark.parametrize("name", ["cornell", "env"])
def test_bf16_render_16_matches_jax(name):
    ref, port, cam_r, cam_p = scenes(name)
    got = port_path.render(port, cam_p, port_path.PathConfig(
        spp=2, max_depth=3, dtypes=config.RGB_BF16), seed=1).numpy()
    want = np.asarray(ref_path.render(ref, cam_r, ref_path.PathConfig(
        spp=2, max_depth=3, dtypes=ref_config.RGB_BF16), seed=1))
    assert got.mean() > 0.02
    assert_images_match(got, want, outlier_frac=0.005, mean_tol=2e-4)


def test_bf16_golden_64():
    sc = cornell_box(64, 64)
    img = port_path.render(sc.compile(intersector="dense",
                                      device="cpu"), sc.camera, port_path.PathConfig(
        spp=4, max_depth=5, dtypes=config.RGB_BF16), seed=0).numpy()
    assert_images_match(img, np.load(GOLDEN))


def test_bf16_texel_value_gradient_matches_jax():
    sc = ref_cornell_box(12, 12)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    target = np.full((12, 12, 3), 0.1, np.float32)
    cfg = port_path.PathConfig(spp=2, max_depth=3, dtypes=config.RGB_BF16)

    def loss(p):
        return loss_and_image(apply_params(port, p), cam, cfg, torch.from_numpy(target))[0]

    got_loss, g = port_value_and_grad(loss, {"tex_value": np.asarray(port.textures.value)})
    f = ref_loss_fn(ref, sc.camera, ref_path.PathConfig(
        spp=2, max_depth=3, dtypes=ref_config.RGB_BF16), target)
    want_loss, want = jax.jit(jax.value_and_grad(f))(ref_scene_params(ref))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-6)
    assert_rel_close(g["tex_value"], np.asarray(want["tex_value"]), 1e-5)


@pytest.mark.parametrize("fn", ["clip", "maximum", "minimum", "abs_"])
def test_vecmath_helpers_keep_bfloat16(fn):
    """The gradient-rule helpers keep a bfloat16 input's dtype forward and
    backward, as the jnp functions do, with JAX's values at the bounds."""
    x_np = np.asarray([-1.0, 0.0, 0.05, 0.5, 1.0, 2.0], np.float32)
    args = {"clip": (0.05, 1.0), "maximum": (0.05,), "minimum": (1.0,), "abs_": ()}[fn]
    jfn = {"clip": jnp.clip, "maximum": jnp.maximum, "minimum": jnp.minimum,
           "abs_": jnp.abs}[fn]
    x = torch.tensor(x_np, dtype=torch.bfloat16, requires_grad=True)
    y = getattr(vecmath, fn)(x, *args)
    (g,) = torch.autograd.grad(y.sum(), [x])
    assert y.dtype == g.dtype == torch.bfloat16
    xj = jnp.asarray(x_np, jnp.bfloat16)
    yj, gj = jax.value_and_grad(lambda v: jfn(v, *args).sum())(xj)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jfn(xj, *args).astype(jnp.float32)))
    np.testing.assert_array_equal(g.float().numpy(), np.asarray(gj.astype(jnp.float32)))


def test_cli_spectrum_dtype(tmp_path, caplog):
    caplog.set_level("INFO")
    out = tmp_path / "bf16.png"
    args = ["-i", SCENE_FILE, "--device", "cpu", "--width", "12", "--height", "12",
            "--spp", "1", "--max-depth", "2"]
    assert cli_main(args + ["-o", str(out), "--spectrum-dtype", "bfloat16"]) == 0
    assert "variant: rgb-bfloat16-float32" in caplog.text
    from akari_torch.core.image import write_png
    from akari_torch.scene import sdl

    node = sdl.parse_file(SCENE_FILE).exports["scene"]
    cam = dataclasses.replace(node.camera, width=12, height=12)
    cfg = dataclasses.replace(node.integrator, spp=1, max_depth=2, dtypes=config.RGB_BF16)
    want = tmp_path / "want.png"
    write_png(str(want), port_path.render(node.compile(device="cpu"), cam, cfg).numpy())
    np.testing.assert_array_equal(read_image(str(out), to_linear=False),
                                  read_image(str(want), to_linear=False))
