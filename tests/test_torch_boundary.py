"""Port parity of geometry gradients: ``tri_delta`` (akari_torch.diff.inverse)
and the edge-sampled boundary term (akari_torch.diff.boundary) against
jax.grad of the JAX package on the same compiled scene (brute intersector
on both sides) and the same RNG lattice.

Tolerances:

- ``tri_delta`` and ``tex_value`` gradients of the bench loss on the flat
  Cornell box (16x16, spp 2, depth 3): within 1e-5 * max|g| (geometry
  gradients pass through normalizations whose few-ulp differences between
  XLA and torch the chain rule carries);
- the port's own central difference of host-recompiled scenes, in the
  setup of tests/test_diff.py::test_geometry_gradient_finite_difference:
  within its 5 % rule;
- ``build_edge_table``: equal arrays; the surrogate's primal value: exactly
  0;
- ``boundary_direct_term`` and ``boundary_term(max_bounce=1)`` gradients on
  tests/test_boundary.py's shadow scene (24x24): within 1e-4 * max|g| (the
  side probes and the light-plane projection run on rays whose directions
  are computed in a different operation order, AoS in the reference);
- the RNG-dimension overlap at ``edge_samples = 25``: the same sequence of
  dimensions drawn by both packages, the overlapping dimension included.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_diff import assert_rel_close, both, port_camera, port_value_and_grad, ref_loss_fn
from akari_torch.core import rng as port_rng
from akari_torch.diff import boundary as port_boundary
from akari_torch.diff.inverse import apply_params, scene_params
from akari_torch.integrators.path import PathConfig, render
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene.arrays import MAT_EMISSIVE
from akari_tpu.core import rng as ref_rng
from akari_tpu.diff import boundary as ref_boundary
from akari_tpu.diff.inverse import scene_params as ref_scene_params
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from test_boundary import _shadow_scene

torch.set_num_threads(2)


def test_tri_delta_and_texel_gradients_match_jax():
    sc = ref_cornell_box(16, 16)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    target = np.zeros((16, 16, 3), np.float32)
    params = {k: v.numpy() for k, v in scene_params(port, optimize_geometry=True).items()}

    def port_loss(p):
        return loss_and_image(apply_params(port, p), cam, PathConfig(spp=2, max_depth=3),
                              torch.from_numpy(target))[0]

    _, g = port_value_and_grad(port_loss, params)
    f = ref_loss_fn(ref, sc.camera, ref_path.PathConfig(spp=2, max_depth=3), target)
    want = jax.jit(jax.grad(f))(ref_scene_params(ref, optimize_geometry=True))
    assert float(np.abs(g["tri_delta"]).max()) > 0
    for k in ("tri_delta", "tex_value"):
        assert_rel_close(g[k], np.asarray(want[k]), 1e-5)


def test_apply_params_is_functional_and_refuses_what_waits():
    sc = ref_cornell_box(8, 8)
    _, port = both(sc.compile(intersector="brute"))
    p = scene_params(port, optimize_geometry=True)
    p["tri_delta"] += 0.25
    before = port.prim_table.clone(), port.tri_v0.clone()
    moved = apply_params(port, p)
    assert torch.equal(port.prim_table, before[0]) and torch.equal(port.tri_v0, before[1])
    assert torch.equal(moved.tri_v0, before[1] + 0.25)
    assert torch.equal(moved.prim_table[:, 0:3], before[0][:, 0:3] + 0.25)
    assert torch.equal(moved.prim_table[:, 3:], before[0][:, 3:])
    # the texels come out as a copy of the stacked images and go back in
    # without touching the scene given
    pi = scene_params(port, optimize_images=True)
    assert torch.equal(pi["tex_images"], port.textures.images)
    assert pi["tex_images"].data_ptr() != port.textures.images.data_ptr()
    images_before = port.textures.images.clone()
    pi["tex_images"] += 0.5
    with_images = apply_params(port, pi)
    assert torch.equal(port.textures.images, images_before)
    assert torch.equal(with_images.textures.images, images_before + 0.5)
    # devices are explicit: nothing is copied across ("meta" stands in for
    # a card here)
    with pytest.raises(ValueError, match="tri_delta"):
        apply_params(port, {"tex_value": p["tex_value"], "tri_delta": p["tri_delta"].to("meta")})
    with pytest.raises(ValueError, match="target"):
        loss_and_image(port, port_camera(sc.camera), PathConfig(spp=1, max_depth=1),
                       torch.zeros((8, 8, 3), device="meta"))
    et = port_boundary.build_edge_table(port)
    with pytest.raises(ValueError, match="tri_delta"):
        port_boundary.boundary_term(port, port_camera(sc.camera), p["tri_delta"].to("meta"), et)


def test_tri_delta_refuses_a_two_level_scene():
    """On a two-level scene tri_v0 is shared prototype space: one delta
    would move every instance at once, so both entry points raise."""
    import akari_torch.scene.nodes as port_nodes
    from akari_torch.scene.builtin import instanced_forest_scene

    old = port_nodes.FLATTEN_MAX_TRIS
    port_nodes.FLATTEN_MAX_TRIS = 1
    try:
        scene = instanced_forest_scene(8, 8, n_instances=2, n=4).compile(device="cpu")
    finally:
        port_nodes.FLATTEN_MAX_TRIS = old
    assert scene.instances is not None
    with pytest.raises(ValueError, match="flat"):
        scene_params(scene, optimize_geometry=True)
    with pytest.raises(ValueError, match="flat"):
        apply_params(scene, {"tex_value": scene.textures.value,
                             "tri_delta": torch.zeros_like(scene.tri_v0)})


def test_tri_delta_gradient_matches_central_difference():
    """tests/test_diff.py::test_geometry_gradient_finite_difference on the
    port: the light quad moved vertically in an occlusion-free room, the
    emitter's directly visible rows masked from the loss, so the interior
    term is the whole derivative; FD of host-recompiled scenes."""
    from akari_torch.scene.builtin import _cornell_box_fallback, cornell_box
    from akari_torch.scene.nodes import EmissiveMaterial, compile_scene

    def build_scene(dy):
        mesh = _cornell_box_fallback()
        em = [i for i, m in enumerate(mesh.materials) if isinstance(m, EmissiveMaterial)]
        faces = np.isin(np.asarray(mesh.material_ids), em)
        vids = np.unique(np.asarray(mesh.indices)[faces])
        verts = np.asarray(mesh.vertices, np.float32).copy()
        verts[vids, 1] += dy
        mesh.vertices = verts
        return compile_scene([mesh], intersector="dense", device="cpu")

    res = 32
    cfg = PathConfig(spp=8, max_depth=2, mis=True)
    cam = cornell_box(res, res).camera
    cut = int(0.45 * res)
    base = -0.12  # light lowered clear of the ceiling

    def loss_of_scene(scene):
        return torch.mean(render(scene, cam, cfg, seed=0)[cut:])

    scene0 = build_scene(base)
    em_mask = (scene0.materials.kind[scene0.mat_id.long()] == MAT_EMISSIVE)[:, None]
    dy = torch.zeros((), requires_grad=True)
    delta = torch.where(em_mask, torch.tensor([0.0, 1.0, 0.0]) * dy, 0.0)
    params = {"tex_value": scene0.textures.value, "tri_delta": delta}
    (ad,) = torch.autograd.grad(loss_of_scene(apply_params(scene0, params)), [dy])
    ad = float(ad)
    h = 0.02
    with torch.no_grad():
        fd = (float(loss_of_scene(build_scene(base + h)))
              - float(loss_of_scene(build_scene(base - h)))) / (2 * h)
    assert abs(ad) > 1e-3
    assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad)), (fd, ad)


@pytest.fixture(scope="module")
def shadow():
    sc = _shadow_scene()
    ref, port = both(sc.compile(intersector="brute"))
    return ref, port, sc.camera, port_camera(sc.camera)


def _occluder_x(scene_np_v0, e1, e2):
    c = scene_np_v0 + (e1 + e2) / 3.0
    m = np.zeros_like(scene_np_v0)
    m[np.abs(c[:, 1] - 1.0) < 0.2, 0] = 1.0
    return m


def test_edge_table_equals_reference(shadow):
    ref, port, _, _ = shadow
    got = port_boundary.build_edge_table(port)
    want = ref_boundary.build_edge_table(ref)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.a.shape[0] == 10 and (got.tri2 >= 0).sum() == 2


def test_surrogate_primal_is_exactly_zero(shadow):
    _, port, _, cam = shadow
    et = port_boundary.build_edge_table(port)
    td = torch.zeros_like(port.tri_v0, requires_grad=True)
    for mb in (0, 1):
        out = port_boundary.boundary_term(port, cam, td, et, edge_samples=4, max_bounce=mb)
        assert out.shape == (24 * 24, 3) and out.requires_grad
        assert torch.equal(out.detach(), torch.zeros_like(out))


@pytest.mark.parametrize("max_bounce", [0, 1])
def test_boundary_gradient_matches_jax(shadow, max_bounce):
    """d/d tri_delta of a weighted sum of the surrogate over 4 sample
    indices, per triangle and axis, and along the occluder's +x move."""
    ref, port, cam_r, cam_p = shadow
    mask = _occluder_x(*(np.asarray(a) for a in (ref.tri_v0, ref.tri_e1, ref.tri_e2)))
    assert mask.sum() == 2
    et_p = port_boundary.build_edge_table(port)
    et_r = ref_boundary.build_edge_table(ref)
    w = np.random.default_rng(0).uniform(0.5, 1.5, (24 * 24, 3)).astype(np.float32)
    kw = dict(seed=0, edge_samples=4)

    td = torch.zeros_like(port.tri_v0, requires_grad=True)
    total = 0.0
    for si in range(4):
        if max_bounce == 0:
            b = port_boundary.boundary_direct_term(port, cam_p, td, et_p, sample_idx=si, **kw)
        else:
            b = port_boundary.boundary_term(port, cam_p, td, et_p, sample_idx=si,
                                            max_bounce=max_bounce, **kw)
        total = total + (b * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(total, [td])
    g = g.numpy()

    ref_grad = jax.jit(jax.grad(lambda d, si: (ref_boundary.boundary_term(
        ref, cam_r, d, et_r, sample_idx=si, max_bounce=max_bounce, **kw) * w).sum()))
    want = sum(np.asarray(ref_grad(jnp.zeros_like(ref.tri_v0), jnp.uint32(si)))
               for si in range(4))
    assert_rel_close(g, want, 1e-4)
    along = float((want * mask).sum())
    assert abs(along) > 1e-3  # the shadow boundary is seen
    np.testing.assert_allclose(float((g * mask).sum()), along, rtol=1e-4)


def test_rng_dimension_overlap_kept_for_parity(shadow, monkeypatch):
    """ROADMAP Queue 3: with edge_samples = 25 and max_bounce = 2, the
    material pick of vertex 2 (dim 8190 + 97 * 2 = 8384) draws the same
    dimension as the edge pick of edge sample 24 at vertex 0 (8192 + 8 *
    24). Both packages draw the same dimensions in the same order, that one
    twice."""
    ref, port, cam_r, cam_p = shadow
    drawn = {"port": [], "ref": []}

    def spy(mod, key):
        real = mod.uniform

        def uniform(seed, pixel, sample, dim):
            drawn[key].append(int(dim))
            return real(seed, pixel, sample, dim)

        monkeypatch.setattr(mod, "uniform", uniform)

    spy(port_rng, "port")
    spy(ref_rng, "ref")
    # the side probes' answers do not decide any draw: skip the reference's
    # (eager, so slow) any-hit queries
    ref_intersect = importlib.import_module("akari_tpu.ops.intersect")
    monkeypatch.setattr(ref_intersect, "occlude",
                        lambda scene, o, d, t_min, t_max: jnp.zeros(o.shape[0], bool))
    kw = dict(seed=0, edge_samples=25, sample_idx=0, max_bounce=2)
    port_boundary.boundary_term(port, cam_p, torch.zeros_like(port.tri_v0),
                                port_boundary.build_edge_table(port), **kw)
    ref_boundary.boundary_term(ref, cam_r, jnp.zeros_like(ref.tri_v0),
                               ref_boundary.build_edge_table(ref), **kw)  # eager
    # the camera's own draws (dims 0, 1) come first in both
    assert drawn["port"] == drawn["ref"]
    assert drawn["port"].count(8384) == 2
    assert 8190 + 97 * 2 == 8192 + 8 * 24 == 8384


def test_smoke_shadow_scene_is_the_reference_scene(shadow):
    """chip_smoke.py phase 22 rebuilds the shadow scene from the port's
    nodes: the same compiled triangles, materials and camera."""
    from chip_smoke import shadow_scene

    _, port, _, cam = shadow
    sc = shadow_scene(24, 24)
    mine = sc.compile(intersector="brute", device="cpu")
    for f in ("tri_v0", "tri_e1", "tri_e2", "mat_id", "prim_table"):
        assert torch.equal(getattr(mine, f), getattr(port, f)), f
    assert torch.equal(mine.textures.value, port.textures.value)
    np.testing.assert_array_equal(sc.camera.c2w, cam.c2w)
    assert np.float32(sc.camera.tan_half_fov) == np.float32(cam.tan_half_fov)
