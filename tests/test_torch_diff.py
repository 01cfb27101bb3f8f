"""Port parity of whole-render gradients (akari_torch.parallel.render,
akari_torch.diff.inverse, PathConfig.remat) against jax.grad of the JAX
package on the same compiled scene (brute intersector on both sides, as
tests/test_diff.py and tests/test_parallel.py run the reference on the
CPU) and the same RNG lattice.

Tolerances:

- the bench loss (16x16, spp 4, depth 5, NEE + MIS; the reference's
  ``loss_and_image_sharded`` on a 1-device mesh in its scan + remat form):
  loss rtol 1e-6; d loss / d tex_value within 1e-6 * max|g| on every
  entry (measured: 3.7e-9 on 0.0147);
- tests/test_diff.py's 12x12 config (spp 2, depth 2, mean-squared image
  loss, the reference unrolled): the same against jax.grad, and the port's
  own central differences at test_diff.py's probes within its 5 % rule;
- a glossy Cornell box at depth 5 (a roughness texel drives the next
  direction): NaN on exactly the entries of the reference with row
  gathers (see the test), the rest within 1e-5 * max|g| (XLA's and
  torch's exp / log / pow differ by a few ulp, and the glossy lobe
  amplifies them);
- remat: the loss bit-equal and the gradient within 1e-6 * max|g| of the
  render without it; the backward makes no intersection query.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_diff import (
    assert_grad_parity, assert_rel_close, both, make_glossy, port_camera, port_value_and_grad,
    ref_loss_fn, take_gathers,
)
from akari_torch.diff.inverse import apply_params, scene_params
from akari_torch.integrators import path as port_path
from akari_torch.integrators.path import PathConfig, render
from akari_torch.parallel.render import loss_and_image
from akari_tpu.diff.inverse import apply_params as ref_apply_params
from akari_tpu.diff.inverse import scene_params as ref_scene_params
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box

torch.set_num_threads(2)


def _bench_pair(res, mutate=None):
    sc = ref_cornell_box(res, res)
    ref, port = both(sc.compile(intersector="brute"), mutate)
    return ref, port, sc.camera, port_camera(sc.camera)


def _port_loss(port, cam, cfg, target):
    def f(p):
        return loss_and_image(apply_params(port, p), cam, cfg, torch.from_numpy(target))[0]
    return f


@pytest.fixture(scope="module")
def bench16():
    return _bench_pair(16)


def test_bench_loss_and_gradient_match_jax(bench16):
    ref, port, cam_r, cam_p = bench16
    target = np.zeros((16, 16, 3), np.float32)
    params = {"tex_value": np.asarray(port.textures.value)}
    loss, g = port_value_and_grad(
        _port_loss(port, cam_p, PathConfig(spp=4, max_depth=5, mis=True), target), params)
    f = ref_loss_fn(ref, cam_r, ref_path.PathConfig(spp=4, max_depth=5, mis=True), target)
    want_loss, want = jax.jit(jax.value_and_grad(f))(ref_scene_params(ref))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    assert_rel_close(g["tex_value"], np.asarray(want["tex_value"]), 1e-6)


def test_albedo_and_emission_gradient_12px_matches_jax_and_fd():
    ref, port, cam_r, cam_p = _bench_pair(12)
    target = np.zeros((12, 12, 3), np.float32)
    cfg = PathConfig(spp=2, max_depth=2, mis=True)

    def port_loss(p):
        img = render(apply_params(port, p), cam_p, cfg, seed=0)
        return torch.mean((img - torch.from_numpy(target)) ** 2)

    def ref_loss(params):
        cfg_r = ref_path.PathConfig(spp=2, max_depth=2, mis=True, unroll=True)
        img = ref_path.render(ref_apply_params(ref, params), cam_r, cfg_r, seed=0)
        return jnp.mean((img - target) ** 2)

    v0 = np.asarray(port.textures.value)
    loss, g = port_value_and_grad(port_loss, {"tex_value": v0})
    want_loss, want = jax.jit(jax.value_and_grad(ref_loss))(ref_scene_params(ref))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    g = g["tex_value"]
    assert_rel_close(g, np.asarray(want["tex_value"]), 1e-6)

    # the port's own central differences, test_diff.py's probes and rule
    checked = 0
    with torch.no_grad():
        for i, c in [(0, 0), (0, 2), (1, 0), (3, 0), (5, 0), (5, 2), (7, 0)]:
            eps = 1e-2 * max(abs(v0[i, c]), 1.0)
            vals = []
            for s in (eps, -eps):
                v = v0.copy()
                v[i, c] += s
                vals.append(float(port_loss({"tex_value": torch.from_numpy(v)})))
            fd = (vals[0] - vals[1]) / (2 * eps)
            ad = float(g[i, c])
            if abs(fd) < 1e-4 or abs(ad) < 1e-4:
                continue
            assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad)) + 1e-6, (i, c, fd, ad)
            checked += 1
    assert checked >= 3


def test_glossy_depth5_gradient_matches_jax(monkeypatch):
    """The next direction depends on a roughness texel, so the glass
    sampler's sqrt'(0) lanes (evaluated on every lane, then masked) give
    NaN gradients in both packages. Against the reference with row
    gathers (``take_gathers``): NaN on exactly the same entries, the rest
    within tolerance. Against the reference as it is, its one-hot gather
    spreads each NaN lane to every row of the gathered table: the port's
    NaN entries are a subset of its NaN entries and the rest agree."""
    ref, port, cam_r, cam_p = _bench_pair(16, make_glossy)
    target = np.zeros((16, 16, 3), np.float32)
    params = {"tex_value": np.asarray(port.textures.value)}
    _, g = port_value_and_grad(
        _port_loss(port, cam_p, PathConfig(spp=2, max_depth=5, mis=True), target), params)
    g = g["tex_value"]
    f = ref_loss_fn(ref, cam_r, ref_path.PathConfig(spp=2, max_depth=5, mis=True), target)
    one_hot = np.asarray(jax.jit(jax.grad(f))(ref_scene_params(ref))["tex_value"])
    take_gathers(monkeypatch)
    want = np.asarray(jax.jit(jax.grad(f))(ref_scene_params(ref))["tex_value"])
    assert np.isnan(g).any()  # the sqrt'(0) lanes reach the roughness texel
    assert_grad_parity(g, want, 1e-5)
    assert (np.isnan(one_hot) >= np.isnan(g)).all()
    both_finite = ~np.isnan(one_hot)
    np.testing.assert_allclose(g[both_finite], one_hot[both_finite], rtol=0,
                               atol=1e-5 * float(np.abs(one_hot[both_finite]).max()))


def test_remat_changes_no_gradient_and_backward_makes_no_query(bench16, monkeypatch):
    _, port, _, cam = bench16
    target = torch.zeros((16, 16, 3))
    calls = []
    for name in ("intersect_soa", "occlude_soa"):
        def counting(*args, _real=getattr(port_path, name), **kwargs):
            calls.append(1)
            return _real(*args, **kwargs)

        monkeypatch.setattr(port_path, name, counting)
    out = {}
    for remat in (False, True):
        p = scene_params(port)
        p["tex_value"].requires_grad_(True)
        cfg = PathConfig(spp=4, max_depth=5, remat=remat)
        calls.clear()
        loss, _ = loss_and_image(apply_params(port, p), cam, cfg, target)
        fwd_calls = len(calls)
        (g,) = torch.autograd.grad(loss, [p["tex_value"]])
        out[remat] = (loss.detach(), g, fwd_calls, len(calls) - fwd_calls)
    # one trace of the 4 folded samples: the camera query, then a shadow
    # and an extension query a bounce (the brute route answers them apart)
    assert out[False][2] == out[True][2] == 1 + 2 * 5
    assert out[True][3] == 0 and out[False][3] == 0
    assert torch.equal(out[True][0], out[False][0])
    scale = float(out[False][1].abs().max())
    torch.testing.assert_close(out[True][1], out[False][1], rtol=0, atol=1e-6 * scale)


def test_forward_render_records_no_graph(bench16):
    _, port, _, cam = bench16
    assert torch.is_grad_enabled()
    img = render(port, cam, PathConfig(spp=1, max_depth=2, remat=True), seed=0)
    assert img.grad_fn is None and not img.requires_grad
    loss, img = loss_and_image(port, cam, PathConfig(spp=1, max_depth=2),
                               torch.zeros((16, 16, 3)))
    assert loss.grad_fn is None and img.grad_fn is None


def test_gradient_golden_matches_the_plain_route():
    """tests/data/torch_port_grad_cornell64_spp4_d5.npz (the JAX package's
    64x64 bench loss and texel gradient, which chip_smoke.py phase 20
    holds the card to) against the port's plain route on the CPU: loss
    rtol 1e-6, gradient within 1e-5 * max|g| (measured 1.5e-7 and
    1.5e-6)."""
    import os

    from akari_torch.scene.builtin import cornell_box

    gold = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "torch_port_grad_cornell64_spp4_d5.npz"))
    assert gold["config"].tolist() == [64, 64, 4, 5, 0]
    sc = cornell_box(64, 64)
    scene = sc.compile(intersector="dense", device="cpu")
    loss, g = port_value_and_grad(
        _port_loss(scene, sc.camera, PathConfig(spp=4, max_depth=5), np.zeros((64, 64, 3),
                                                                            np.float32)),
        {"tex_value": scene.textures.value.numpy()})
    np.testing.assert_allclose(loss, float(gold["loss"]), rtol=1e-6)
    assert_rel_close(g["tex_value"], gold["grad_tex_value"], 1e-5)
