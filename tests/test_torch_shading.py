"""Port parity: the component-SoA shading functions of the main path
(akari_torch.shading.soa vs akari_tpu.shading.soa run on jax.numpy).

Inputs are made with numpy from a seed and handed to both. Tolerance:
rtol = 1e-5 with atol = 1e-6 for values near zero, on all but 1 lane in
1000; those few lanes within rtol = 1e-3. Both sides round op by op in
float32, but XLA and torch implement exp/log/pow/sin/cos/sqrt with
different few-ulp errors, and the microfacet terms cancel some of them
badly: for a half vector near the pole, tan^2 = (1 - cos^2) / cos^2 loses
about three digits of a one-ulp difference in cos. Integer outputs (leaf
ids, closure kinds, light ids) and masks are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_torch import sampling
from akari_torch.core.v3 import V3
from akari_torch.scene.arrays import from_numpy_scene
from akari_torch.shading import soa
from akari_tpu import sampling as ref_sampling
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.scene import nodes as ref_nodes
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from akari_tpu.shading import soa as ref_soa

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
OUTLIER_TOL = dict(rtol=1e-3, atol=1e-5)
OUTLIER_FRAC = 1e-3


def _close(a, b):
    if isinstance(a, V3):
        for x, y in zip(a, b):
            _close(x, y)
        return
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_allclose(a, b, **OUTLIER_TOL)
    off = ~np.isclose(a, b, **TOL)
    assert off.mean() <= OUTLIER_FRAC, (
        f"{off.sum()} of {off.size} lanes beyond rtol={TOL['rtol']}"
    )


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _pair(a):
    """numpy [N] or [N,3] -> (torch value, jax value), V3 for [N,3]."""
    a = np.ascontiguousarray(a)
    if a.ndim == 2:
        t = torch.from_numpy(a)
        return V3(t[:, 0], t[:, 1], t[:, 2]), JV3(*(jnp.asarray(a[:, k]) for k in range(3)))
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(7)
    kind = r.integers(-1, 4, N).astype(np.int32)
    dist = r.integers(0, 3, N).astype(np.int32)
    color = r.uniform(0.05, 1.0, (N, 3)).astype(np.float32)
    alpha = r.uniform(0.01, 1.0, N).astype(np.float32)
    ior = r.uniform(1.2, 2.0, N).astype(np.float32)
    choice = r.uniform(0.3, 1.0, N).astype(np.float32)
    ns = _unit(r, N)
    wo = _unit(r, N)
    wi = _unit(r, N)
    u1 = r.random(N).astype(np.float32)
    u2 = r.random(N).astype(np.float32)
    port, ref = {}, {}
    for name, val in dict(kind=kind, dist=dist, color=color, alpha=alpha,
                          ior=ior, choice_pdf=choice).items():
        port[name], ref[name] = _pair(val)
    p = {k: _pair(v) for k, v in dict(ns=ns, wo=wo, wi=wi, u1=u1, u2=u2).items()}
    return port, ref, p


def _frames(p):
    return soa.make_frame(p["ns"][0]), ref_soa.make_frame(p["ns"][1])


def test_eval_world_matches(lanes):
    port, ref, p = lanes
    fp, fr = _frames(p)
    _close(
        soa.eval_world(port, fp, p["wo"][0], p["wi"][0]),
        ref_soa.eval_world(ref, fr, p["wo"][1], p["wi"][1]),
    )


def test_pdf_world_matches(lanes):
    port, ref, p = lanes
    fp, fr = _frames(p)
    _close(
        soa.pdf_world(port, fp, p["wo"][0], p["wi"][0]),
        ref_soa.pdf_world(ref, fr, p["wo"][1], p["wi"][1]),
    )


def test_sample_world_matches(lanes):
    port, ref, p = lanes
    fp, fr = _frames(p)
    wi_p, f_p, pdf_p = soa.sample_world(port, fp, p["wo"][0], p["u1"][0], p["u2"][0])
    wi_r, f_r, pdf_r = ref_soa.sample_world(ref, fr, p["wo"][1], p["u1"][1], p["u2"][1])
    _close(wi_p, wi_r)
    _close(f_p, f_r)
    _close(pdf_p, pdf_r)


def test_frame_and_warps_match(lanes):
    _, _, p = lanes
    (tp, bp, _), (tr, br, _) = _frames(p)
    _close(tp, tr)
    _close(bp, br)
    for a, b in zip(soa.concentric_disk(p["u1"][0], p["u2"][0]),
                    ref_soa.concentric_disk(p["u1"][1], p["u2"][1])):
        _close(a, b)
    _close(soa.cosine_hemisphere(p["u1"][0], p["u2"][0]),
           ref_soa.cosine_hemisphere(p["u1"][1], p["u2"][1]))


def test_power_heuristic_matches():
    r = np.random.default_rng(2)
    a = r.uniform(0, 10, N).astype(np.float32)
    b = r.uniform(0, 10, N).astype(np.float32)
    a[:8] = [0, 0, 1e30, 1e8, 3, 0, 1e-30, 5]
    b[:8] = [0, 1, 1e30, 2, 0, 0, 1e-30, 1e19]
    _close(sampling.power_heuristic(torch.from_numpy(a), torch.from_numpy(b)),
           ref_sampling.power_heuristic(jnp.asarray(a), jnp.asarray(b)))


def _zoo(mod):
    diffuse = mod.DiffuseMaterial((0.5, 0.4, 0.3))
    glossy = mod.GlossyMaterial((0.9, 0.8, 0.7), roughness=0.3)
    inner = mod.MixMaterial(fraction=0.6, material_a=diffuse, material_b=glossy)
    outer = mod.MixMaterial(fraction=0.25, material_a=inner,
                            material_b=mod.MirrorMaterial((0.8, 0.8, 0.9)))
    mats = [outer, mod.GlassMaterial(ior=1.33),
            mod.EmissiveMaterial((4.0, 3.0, 2.0), double_sided=True), diffuse]
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2], [1, 3, 2], [0, 2, 1], [1, 2, 3]], np.int64)
    mesh = mod.Mesh(vertices=verts, indices=idx, materials=mats,
                    material_ids=np.arange(4, dtype=np.int64))
    return mod.Scene(shapes=[mesh])


def test_material_walk_and_closures_match():
    import akari_torch.scene.nodes as port_nodes

    ref = jax.tree_util.tree_map(jnp.asarray, _zoo(ref_nodes).compile(intersector="brute"))
    port = _zoo(port_nodes).compile(intersector="brute", device="cpu")
    r = np.random.default_rng(4)
    m = port.n_materials
    mat_id = r.integers(0, m, N).astype(np.int32)
    u = r.random(N).astype(np.float32)
    uv = np.zeros(N, np.float32)
    (mid_p, mid_r), (u_p, u_r), (uv_p, uv_r) = _pair(mat_id), _pair(u), _pair(uv)
    leaf_p, cp_p = soa.select_material(port.materials, port.textures, mid_p, u_p, uv_p, uv_p)
    leaf_r, cp_r = ref_soa.select_material(ref.materials, ref.textures, mid_r, u_r, uv_r, uv_r)
    np.testing.assert_array_equal(leaf_p.numpy(), np.asarray(leaf_r))
    _close(cp_p, cp_r)
    assert len(np.unique(leaf_p.numpy())) >= 5  # walked through both mixes
    par_p = soa.closure_params(port.materials, port.textures, leaf_p, cp_p, uv_p, uv_p)
    par_r = ref_soa.closure_params(ref.materials, ref.textures, leaf_r, cp_r, uv_r, uv_r)
    for k in ("kind", "dist"):
        np.testing.assert_array_equal(par_p[k].numpy(), np.asarray(par_r[k]))
    for k in ("color", "alpha", "ior", "choice_pdf"):
        _close(par_p[k], par_r[k])
    le_p, ds_p = soa.emission_and_sided(port.materials, port.textures, mid_p, uv_p, uv_p)
    le_r, ds_r = ref_soa.emission_and_sided(ref.materials, ref.textures, mid_r, uv_r, uv_r)
    _close(le_p, le_r)
    np.testing.assert_array_equal(ds_p.numpy(), np.asarray(ds_r))


@pytest.fixture(scope="module")
def cornell():
    ref = jax.tree_util.tree_map(
        jnp.asarray, ref_cornell_box(16, 16).compile(intersector="brute")
    )
    port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref), intersector="brute",
                            device="cpu")
    return ref, port


def test_light_sample_matches(cornell):
    ref, port = cornell
    r = np.random.default_rng(5)
    p_ref = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N, 3)).astype(np.float32)
    us = [r.random(N).astype(np.float32) for _ in range(3)]
    (pp, pr) = _pair(p_ref)
    (s_p, s_r), (a_p, a_r), (b_p, b_r) = (_pair(x) for x in us)
    lp = soa.light_sample_mixed(port, s_p, a_p, b_p, pp)
    lr = ref_soa.light_sample_mixed(ref, s_r, a_r, b_r, pr)
    _close(lp.wi, lr.wi)
    _close(lp.dist, lr.dist)
    _close(lp.L, lr.L)
    _close(lp.pdf, lr.pdf)
    np.testing.assert_array_equal(lp.valid.numpy(), np.asarray(lr.valid))


def test_light_pdf_direction_from_matches(cornell):
    ref, port = cornell
    r = np.random.default_rng(6)
    prim = r.integers(0, port.n_tris, N)
    table = port.prim_table.numpy()[prim]
    e1, e2 = table[:, 3:6], table[:, 6:9]
    sel = table[:, 25].copy()
    hit_ok = r.random(N) < 0.9
    wi = _unit(r, N)
    dist = r.uniform(0.1, 3.0, N).astype(np.float32)
    dist[~hit_ok] = 1e30
    ds = r.random(N) < 0.5
    args = [_pair(x) for x in (e1, e2, sel, hit_ok, wi, dist, ds)]
    got = soa.light_pdf_direction_from(*(a[0] for a in args))
    want = ref_soa.light_pdf_direction_from(*(a[1] for a in args))
    _close(got, want)
    assert np.isfinite(got.numpy()).all()
