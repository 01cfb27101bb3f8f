"""Port parity: image-texel gradients (``scene_params(optimize_images=
True)``, ``apply_params`` writing ``TextureTable.images``, and
``inverse_render`` optimizing them) against akari_tpu, on the textured
Cornell box of tests/test_textures.py's recipe built by each package from
its own nodes (``akari_torch.scene.builtin.texture_cornell_mesh``).

Tolerances:

- d loss / d tex_images and d tex_value against jax.grad: within 1e-5 of
  max|g| (the float32 gradient tests' bound), in linear and in log space;
  padding texels exactly 0 in both packages;
- the 64x64 texel-gradient golden (tools/make_torch_port_texgrad_golden.py):
  loss rtol 1e-6, gradients within 1e-5 of max|g|;
- ``inverse_render(optimize_images=True)``, 3 iterations at 12x12: losses
  and recovered values within rtol 1e-5 (optax and torch.optim.Adam round
  the same update differently; tests/test_torch_inverse.py); texels within
  rtol 1e-5 plus atol 1e-5, 2e-4 of one Adam step of lr 0.05: a texel that
  few lanes see has gradients of 1e-10-1e-6, where Adam's step lr * m /
  (sqrt(v) + 1e-8) turns the packages' last-bit differences into
  relative ones (measured: 10 of 768 texels beyond rtol 1e-5, at most
  5.6e-6 apart);
- a scene without images dispatches exactly the parent's ops.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import akari_tpu.scene.nodes as ref_nodes
from _port_diff import assert_grad_parity, assert_rel_close, both, port_camera, port_value_and_grad
from akari_torch.diff.inverse import InverseConfig, apply_params, inverse_render, scene_params
from akari_torch.integrators import path as port_path
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene.builtin import (
    checker_texture, cornell_box, texture_cornell_mesh, textured_cornell_box,
)
from akari_tpu.diff import inverse as ref_inverse
from akari_tpu.integrators import path as ref_path
from akari_tpu.parallel.mesh import make_ray_mesh
from akari_tpu.parallel.render import loss_and_image_sharded
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_texgrad_cornell64.npz")
F32 = np.float32


def _checker(n=8):
    img = np.indices((n, n)).sum(axis=0) % 2
    return np.repeat(img[..., None], 3, axis=-1).astype(np.float32)


def ref_textured(res, image):
    """The reference's Cornell box under the recipe, from its own nodes."""
    sc = ref_cornell_box(res, res)
    texture_cornell_mesh(sc.shapes[0], image, nodes=ref_nodes)
    return sc


def test_textured_cornell_box_compiles_as_the_reference():
    port = textured_cornell_box(8, 8).compile(intersector="dense", device="cpu")
    ref = ref_textured(8, checker_texture(64, 0)).compile(intersector="brute")
    for f in ("kind", "value", "image_id", "images", "image_sizes"):
        np.testing.assert_array_equal(getattr(port.textures, f).numpy(),
                                      np.asarray(getattr(ref.textures, f)), err_msg=f)
    assert port.textures.images.shape == (1, 64, 64, 3) and port.textures.has_images
    pt = port.prim_table.numpy()
    np.testing.assert_array_equal(pt, np.asarray(ref.prim_table)[:, :pt.shape[1]])
    img = checker_texture(64, 0)
    assert img.min() >= 0.05 and img.max() <= 1.0 and img.std() > 0.1


def _ref_render_loss(ref, cam, cfg, log_space):
    """params -> mean of the reference's render (tests/test_textures.py's
    loss), params in log space when asked."""

    def f(params):
        if log_space:
            params = {k: jnp.exp(v) for k, v in params.items()}
        return jnp.mean(ref_path.render(ref_inverse.apply_params(ref, params), cam, cfg, seed=0))

    return f


@pytest.mark.parametrize("space", ["linear", "log"])
def test_tex_images_gradient_matches_jax(space):
    """tests/test_textures.py::test_image_texel_gradients's scene (12x12,
    1 spp, depth 1, a 4x4 checker at 0.25-0.75 on every diffuse wall)."""
    sc = ref_textured(12, _checker(4) * 0.5 + 0.25)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    log = space == "log"
    cfg = port_path.PathConfig(spp=1, max_depth=1)

    def port_loss(p):
        if log:
            p = {k: torch.exp(v) for k, v in p.items()}
        return port_path.render(apply_params(port, p), cam, cfg, seed=0).mean()

    p0 = {k: v.numpy() for k, v in scene_params(port, optimize_images=True).items()}
    if log:
        p0 = {k: np.log(np.maximum(v, 1e-4)) for k, v in p0.items()}
    got_loss, g = port_value_and_grad(port_loss, p0)
    want_loss, want = jax.value_and_grad(_ref_render_loss(
        ref, sc.camera, ref_path.PathConfig(spp=1, max_depth=1), log))(
        {k: jnp.asarray(v) for k, v in p0.items()})
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-6)
    assert float(np.abs(g["tex_images"]).sum()) > 0
    for k in ("tex_images", "tex_value"):
        assert_grad_parity(g[k], np.asarray(want[k]), 1e-5)


def test_padding_texels_get_zero_gradient():
    """Two images of different sizes (4x4 and 8x2) stack into [2, 8, 4]:
    the texels outside each image's own size get exactly no gradient, as
    in the reference; the used ones get the reference's."""
    sc = ref_cornell_box(12, 12)
    mesh = sc.shapes[0]
    a = ref_nodes.ImageTexture(image=_checker(4) * 0.5 + 0.25)
    b = ref_nodes.ImageTexture(image=np.linspace(0.2, 0.9, 48, dtype=F32).reshape(8, 2, 3))
    mesh.materials = [m if isinstance(m, ref_nodes.EmissiveMaterial)
                      else ref_nodes.DiffuseMaterial(color=(a, b)[i % 2])
                      for i, m in enumerate(mesh.materials)]
    p = mesh.vertices[mesh.indices]
    mesh.corner_uvs = (p[..., [0, 1]] * 0.5 + 0.5).astype(F32)
    ref, port = both(sc.compile(intersector="brute"))
    assert tuple(port.textures.images.shape) == (2, 8, 4, 3)
    cam = port_camera(sc.camera)
    target = np.zeros((12, 12, 3), F32)
    cfg = port_path.PathConfig(spp=2, max_depth=2)

    def port_loss(p_):
        return loss_and_image(apply_params(port, p_), cam, cfg, torch.from_numpy(target))[0]

    p0 = {k: v.numpy() for k, v in scene_params(port, optimize_images=True).items()}
    _, g = port_value_and_grad(port_loss, p0)
    mesh1 = make_ray_mesh(n_devices=1)
    want = jax.jit(jax.grad(lambda q: loss_and_image_sharded(
        ref_inverse.apply_params(ref, q), sc.camera, ref_path.PathConfig(spp=2, max_depth=2),
        mesh1, jnp.asarray(target), seed=0)[0]))({k: jnp.asarray(v) for k, v in p0.items()})
    gi, wi = g["tex_images"], np.asarray(want["tex_images"])
    pad = np.ones(gi.shape[:3], bool)
    pad[0, :4, :4] = False
    pad[1, :8, :2] = False
    assert (gi[pad] == 0).all() and (wi[pad] == 0).all()
    assert (np.abs(gi[~pad]).sum(-1) > 0).mean() > 0.5
    assert_grad_parity(gi, wi, 1e-5)


def test_texgrad_golden_64():
    z = np.load(GOLDEN)
    w, h, spp, depth, seed, tex_res, tex_seed = (int(v) for v in z["config"])
    sc = textured_cornell_box(w, h, tex_res=tex_res, seed=tex_seed)
    scene = sc.compile(intersector="dense", device="cpu")
    cfg = port_path.PathConfig(spp=spp, max_depth=depth)

    def loss(p):
        return loss_and_image(apply_params(scene, p), sc.camera, cfg,
                              torch.zeros((h, w, 3)), seed=seed)[0]

    p0 = {k: v.numpy() for k, v in scene_params(scene, optimize_images=True).items()}
    got_loss, g = port_value_and_grad(loss, p0)
    np.testing.assert_allclose(got_loss, float(z["loss"]), rtol=1e-6)
    assert_rel_close(g["tex_images"], z["grad_tex_images"], 1e-5)
    assert_rel_close(g["tex_value"], z["grad_tex_value"], 1e-5)


@pytest.fixture(scope="module")
def texel_recovery12():
    """The 12x12 textured box (a 16x16 seeded checker), its image at seed
    123 as the target, and the scene with its values and texels at 0.4x."""
    sc = ref_textured(12, checker_texture(16, 5, cell=4))
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    with torch.no_grad():
        _, target = loss_and_image(port, cam, port_path.PathConfig(spp=2, max_depth=2),
                                   torch.zeros((12, 12, 3)), seed=123)
    bad_v = (np.asarray(port.textures.value) * 0.4).astype(F32)
    bad_i = (np.asarray(port.textures.images) * 0.4).astype(F32)
    bad_port = dataclasses.replace(port, textures=dataclasses.replace(
        port.textures, value=torch.from_numpy(bad_v), images=torch.from_numpy(bad_i)))
    return ref, bad_v, bad_i, bad_port, sc.camera, cam, target


@pytest.mark.parametrize("schedule", ["constant", "cosine_log_ema_ramp"])
def test_inverse_render_texels_matches_reference(texel_recovery12, schedule):
    ref, bad_v, bad_i, bad_port, cam_r, cam_p, target = texel_recovery12
    bad_ref = dataclasses.replace(ref, textures=dataclasses.replace(
        ref.textures, value=jnp.array(bad_v), images=jnp.array(bad_i)))
    kw = dict(iterations=3, learning_rate=0.05, seed=7, optimize_images=True)
    if schedule != "constant":
        kw.update(lr_schedule="cosine", param_space="log", param_ema=0.9,
                  spp_ramp=((0.5, 4),))
    cfg_p = port_path.PathConfig(spp=2, max_depth=2)
    rec, losses, img = inverse_render(bad_port, cam_p, cfg_p, target, InverseConfig(**kw))
    rec_r, losses_r, img_r = ref_inverse.inverse_render(
        bad_ref, cam_r, ref_path.PathConfig(spp=2, max_depth=2), jnp.asarray(target.numpy()),
        make_ray_mesh(n_devices=1), ref_inverse.InverseConfig(**kw))
    np.testing.assert_allclose(losses, losses_r, rtol=1e-5)
    np.testing.assert_allclose(rec.textures.images.numpy(), np.asarray(rec_r.textures.images),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rec.textures.value.numpy(), np.asarray(rec_r.textures.value),
                               rtol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_r), rtol=1e-5, atol=1e-6)
    assert not np.array_equal(rec.textures.images.numpy(), bad_i)
    assert losses[-1] < losses[0]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_scene_without_images_dispatches_the_parent_ops():
    """A float32 Cornell render and a bench step (loss and d / d tex_value)
    at 16x16 x 4 spp, depth 5, dispatch exactly the ops they did before
    texel gradients and the variant existed (counted on the parent: 10,603
    for the render, 10,850 + 12,688 for the step), so the card's
    cornell-256 frame keeps its 9,274 launches."""
    sc = cornell_box(16, 16)
    scene = sc.compile(device="cpu")
    cfg = port_path.PathConfig(spp=4, max_depth=5)
    with _CountOps() as c:
        port_path.render(scene, sc.camera, cfg, seed=0)
    assert c.n == 10_603
    p = scene_params(scene)
    p["tex_value"].requires_grad_(True)
    with _CountOps() as fwd:
        loss, _ = loss_and_image(apply_params(scene, p), sc.camera, cfg, torch.zeros(16, 16, 3))
    with _CountOps() as bwd:
        torch.autograd.grad(loss, [p["tex_value"]])
    assert (fwd.n, bwd.n) == (10_850, 12_688)
