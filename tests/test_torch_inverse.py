"""Gradient hygiene and the Adam inverse-rendering loop of the port
(akari_torch.diff.inverse) against the JAX package on the same compiled
scene (brute intersector on both sides) and the same RNG lattice.

Tolerances:

- a diffuse lane whose masked microfacet branch sees wi = -wo (or within
  1e-7 of it) at alpha 1e-4 (the reference's fix in 738d724): no NaN, and
  the texel gradient equal to jax.grad's within rtol 1e-5, atol 1e-6;
- a Cornell box with one material glass and one glossy: the raw texel
  gradient NaN on exactly the entries where the reference's is when it
  gathers rows as the port does (tests/_port_diff.py ``take_gathers``; its
  one-hot gather spreads a NaN lane to every row, a superset), the rest
  within 1e-5 * max|g|; one ``inverse_render`` step leaves every
  parameter finite;
- ``inverse_render``, 3 iterations at 12x12: losses and recovered texel
  values within rtol 1e-5 of the reference's (``inverse_render`` on a
  1-device mesh), for the constant learning rate and for cosine + log
  space + EMA + a two-phase spp ramp. optax and torch.optim.Adam round the
  same update differently (sqrt(v_hat) + eps against sqrt(v) / sqrt(bc2) +
  eps), so the trajectories agree to ~1e-6, not bit for bit.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_diff import (
    assert_grad_parity, both, emissive_texels, largest_material, make_glossy, port_camera,
    port_value_and_grad, ref_loss_fn, take_gathers,
)
from akari_torch.core.v3 import V3
from akari_torch.diff.inverse import InverseConfig, apply_params, cosine_lr, inverse_render
from akari_torch.integrators.path import PathConfig
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene.arrays import MAT_DIFFUSE, MAT_GLASS, MAT_GLOSSY
from akari_torch.shading import soa
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.diff import inverse as ref_inverse
from akari_tpu.integrators import path as ref_path
from akari_tpu.parallel.mesh import make_ray_mesh
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from akari_tpu.shading import soa as ref_soa

torch.set_num_threads(2)
F32 = np.float32


def _unit(r, n):
    v = r.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.3
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(F32)


def test_degenerate_masked_branch_gives_finite_gradient():
    r = np.random.default_rng(7)
    n = 64
    value = r.uniform(0.2, 0.9, (4, 3)).astype(F32)
    value[1, 0] = 0.005  # roughness 0.005: alpha 2.5e-5, clipped to 1e-4
    mats = SimpleNamespace(
        kind=np.asarray([MAT_DIFFUSE, MAT_GLOSSY], np.int32),
        color_tex=np.asarray([0, 2], np.int32), roughness_tex=np.asarray([1, 1], np.int32),
        fraction_tex=np.asarray([3, 3], np.int32), mix_a=np.zeros(2, np.int32),
        mix_b=np.zeros(2, np.int32), double_sided=np.zeros(2, bool),
        ior=np.full(2, 1.5, F32), has_mix=False)
    ns, wo = _unit(r, n), _unit(r, n)
    wi = -wo
    wi[n // 2:] += r.uniform(-1e-7, 1e-7, (n - n // 2, 3)).astype(F32)
    leaf = np.zeros(n, np.int32)  # every lane diffuse
    leaf[:4] = 1                  # and a few glossy ones beside them

    def run(mod, vec, value_, asarr):
        tex = SimpleNamespace(value=value_, has_images=False)
        m = SimpleNamespace(**{k: (asarr(v) if isinstance(v, np.ndarray) else v)
                               for k, v in vars(mats).items()})
        params = mod.closure_params(m, tex, asarr(leaf), asarr(np.ones(n, F32)), None, None)
        frame = mod.make_frame(vec(*(asarr(ns[:, c]) for c in range(3))))
        wo_v = vec(*(asarr(wo[:, c]) for c in range(3)))
        wi_v = vec(*(asarr(wi[:, c]) for c in range(3)))
        f = mod.eval_world(params, frame, wo_v, wi_v)
        return sum((c * (k + 1.0)).sum() for k, c in enumerate(f)) + mod.pdf_world(
            params, frame, wo_v, wi_v).sum()

    t_val = torch.tensor(value, requires_grad=True)
    (g,) = torch.autograd.grad(run(soa, V3, t_val, torch.from_numpy), [t_val])
    want = jax.grad(lambda v: run(ref_soa, JV3, v, jnp.asarray))(jnp.asarray(value))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _glass_and_glossy(ref_np):
    """The most used material glossy (a roughness texel drives the next
    direction) and the next most used glass."""
    counts = np.bincount(np.asarray(ref_np.mat_id), minlength=len(ref_np.materials.kind))
    glass = int(np.argsort(counts)[-2])
    assert glass != largest_material(ref_np)
    ref_np = make_glossy(ref_np)
    kind = np.array(ref_np.materials.kind)
    kind[glass] = MAT_GLASS
    return dataclasses.replace(ref_np, materials=dataclasses.replace(ref_np.materials, kind=kind))


def test_glass_cornell_nan_parity_and_a_finite_step(monkeypatch):
    sc = ref_cornell_box(12, 12)
    ref, port = both(sc.compile(intersector="brute"), _glass_and_glossy)
    cam = port_camera(sc.camera)
    target = np.zeros((12, 12, 3), np.float32)
    cfg = PathConfig(spp=2, max_depth=4)

    def port_loss(p):
        return loss_and_image(apply_params(port, p), cam, cfg, torch.from_numpy(target))[0]

    _, g = port_value_and_grad(port_loss, {"tex_value": np.asarray(port.textures.value)})
    g = g["tex_value"]
    f = ref_loss_fn(ref, sc.camera, ref_path.PathConfig(spp=2, max_depth=4), target)
    one_hot = np.asarray(jax.jit(jax.grad(f))(ref_inverse.scene_params(ref))["tex_value"])
    take_gathers(monkeypatch)
    want = np.asarray(jax.jit(jax.grad(f))(ref_inverse.scene_params(ref))["tex_value"])
    assert np.isnan(g).any()
    assert_grad_parity(g, want, 1e-5)
    assert (np.isnan(one_hot) >= np.isnan(g)).all()

    rec, losses, img = inverse_render(port, cam, cfg, torch.from_numpy(target),
                                      InverseConfig(iterations=1, learning_rate=0.05))
    assert np.isfinite(losses[0]) and torch.isfinite(rec.textures.value).all()
    assert img.shape == (12, 12, 3) and torch.isfinite(img).all()


@pytest.fixture(scope="module")
def corrupted12():
    """The 12x12 Cornell box, its image at seed 123 as the target, and the
    scene with the non-emissive texels at 0.4x (tests/test_diff.py's
    recovery set-up)."""
    sc = ref_cornell_box(12, 12)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    with torch.no_grad():
        _, target = loss_and_image(port, cam, PathConfig(spp=2, max_depth=2),
                                   torch.zeros((12, 12, 3)), seed=123)
    em = emissive_texels(port)
    bad_v = np.where(em[:, None], np.asarray(port.textures.value),
                     0.4 * np.asarray(port.textures.value)).astype(F32)
    bad_port = dataclasses.replace(port, textures=dataclasses.replace(
        port.textures, value=torch.from_numpy(bad_v)))
    return ref, bad_v, bad_port, sc.camera, cam, target


@pytest.mark.parametrize("schedule", ["constant", "cosine_log_ema_ramp"])
def test_inverse_render_matches_reference(corrupted12, schedule):
    ref, bad_v, bad_port, cam_r, cam_p, target = corrupted12
    # a fresh array each run: the reference's step donates its parameters
    bad_ref = dataclasses.replace(ref, textures=dataclasses.replace(
        ref.textures, value=jnp.array(bad_v)))
    kw = dict(iterations=3, learning_rate=0.05, seed=7)
    if schedule != "constant":
        kw.update(lr_schedule="cosine", param_space="log", param_ema=0.9,
                  spp_ramp=((0.5, 4),))
    rec, losses, img = inverse_render(bad_port, cam_p, PathConfig(spp=2, max_depth=2),
                                      target, InverseConfig(**kw))
    rec_r, losses_r, img_r = ref_inverse.inverse_render(
        bad_ref, cam_r, ref_path.PathConfig(spp=2, max_depth=2), jnp.asarray(target.numpy()),
        make_ray_mesh(n_devices=1), ref_inverse.InverseConfig(**kw))
    np.testing.assert_allclose(losses, losses_r, rtol=1e-5)
    np.testing.assert_allclose(rec.textures.value.numpy(), np.asarray(rec_r.textures.value),
                               rtol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_r), rtol=1e-5, atol=1e-6)
    assert losses[-1] < losses[0]


def test_cosine_lr_is_optax_schedule():
    import optax

    sched = optax.cosine_decay_schedule(0.05, 7, alpha=0.05)
    for step in range(9):
        np.testing.assert_allclose(cosine_lr(0.05, step, 7), float(sched(step)), rtol=1e-6)


def test_rare_masked_microfacet_lanes_are_nan_in_both_packages(monkeypatch):
    """Two of the lanes of the 1024x1024 x 16 spp bench step whose
    gradient is NaN on the card (chip_smoke.py phase 21): a diffuse lane's
    masked microfacet sampler draws u1 below ~6e-8, so cos_t rounds to 1,
    sin_t = sqrt(max(1 - cos_t^2, 0)) takes sqrt'(0) = inf times its zero
    cotangent, and the NaN reaches the alpha column, then the roughness
    texel through the clip's zero derivative. The reference (row gathers)
    gives NaN on exactly the same entry: kept for parity (ROADMAP Queue
    3); ``inverse_render`` masks it as the reference does."""
    sc = ref_cornell_box(1024, 1024)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    px, smp = np.asarray([328938, 272588]), np.asarray([0, 2])
    p = {"tex_value": torch.tensor(port.textures.value.numpy(), requires_grad=True)}
    from akari_torch.integrators import path as port_path

    li = port_path.trace_paths(apply_params(port, p), cam, PathConfig(spp=1, max_depth=5), 0,
                               torch.from_numpy(smp), torch.from_numpy(px))
    (g,) = torch.autograd.grad(li.sum(), [p["tex_value"]])
    take_gathers(monkeypatch)

    def ref_fn(params):
        fns = ref_path._jax_intersectors_soa(ref)
        return ref_path.trace_paths(
            ref_inverse.apply_params(ref, params), sc.camera,
            ref_path.PathConfig(spp=1, max_depth=5), jnp.uint32(0),
            jnp.asarray(smp, jnp.uint32), jnp.asarray(px, jnp.uint32), *fns[:2], jnp,
            fused_fn=fns[2]).sum()

    want = np.asarray(jax.jit(jax.grad(ref_fn))(ref_inverse.scene_params(ref))["tex_value"])
    assert np.isfinite(li.detach().numpy()).all()
    assert np.argwhere(np.isnan(g.numpy())).tolist() == [[0, 0]]
    assert_grad_parity(g.numpy(), want, 1e-5)
