"""Port parity of gradients at kinks: the reference's rules for clip,
maximum, minimum and abs (akari_torch.core.vecmath.clip / maximum /
minimum / abs_) on every module that uses them, against jax.grad of the
JAX package's function on the same numpy inputs.

At a tie jnp.maximum / jnp.minimum pass half the gradient to each side,
so jnp.clip passes 1/2 at either bound, and jnp.abs passes +1 at +-0;
torch.clamp passes 1 (or 0) and torch.abs 0. The inputs are drawn from a
seed and then pinned so that lanes sit exactly on each clamp bound (a
roughness texel of exactly 1.0, mix fractions at 1e-4 and 1 - 1e-4, pdfs
at 1e18, |cos| at 1e-6, 1 - cos^2 = 0 at a half vector on the pole, a
squared triangle normal of exactly 1e-20) and some dot products are
exactly 0, one of them on a degenerate masked branch (wi = -wo, whose
half vector is replaced by the pole). The random lanes keep away from
grazing angles and tiny roughness, where XLA's and torch's few-ulp
differences in exp/log/pow/sqrt are amplified (tests/test_torch_shading.py
states the same for the forward values).

Tolerance: float32, rtol 1e-5, atol 1e-6 on every gradient entry. No
gradient with respect to a scene parameter (texel values, closure colors
and roughness, choice pdfs, throughput) is NaN. Two gradients with respect
to directions and indices of refraction are NaN in the reference itself,
where a glass or Fresnel branch takes sqrt'(0): the port is held to give
NaN on exactly those lanes and to agree everywhere else (ROADMAP Queue 3).
The forward values are held bit for bit elsewhere
(tests/test_torch_shading.py, tests/test_torch_path.py).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_torch import sampling
from akari_torch.core import vecmath
from akari_torch.core.v3 import V3
from akari_torch.integrators import path as port_path
from akari_torch.scene.arrays import MAT_GLOSSY, from_numpy_scene
from akari_torch.shading import bsdf, light, material, soa
from akari_tpu import sampling as ref_sampling
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.integrators import path as ref_path
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from akari_tpu.shading import bsdf as ref_bsdf
from akari_tpu.shading import light as ref_light
from akari_tpu.shading import material as ref_material
from akari_tpu.shading import soa as ref_soa

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 256
F32 = np.float32


def _unit(r, n, z_min=0.2):
    """Unit vectors with |z| >= z_min (away from grazing)."""
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = np.sign(v[:, 2] + 1e-9) * np.maximum(np.abs(v[:, 2]), z_min)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(F32)


def _v3(a, mod):
    return (V3 if mod == "torch" else JV3)(a[:, 0], a[:, 1], a[:, 2])


def _floats(out):
    """The float leaves of an output (tensors, V3s, tuples, dicts), in a
    fixed order."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _floats(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _floats(o)]
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    return [out] if jnp.issubdtype(jnp.asarray(out).dtype, jnp.floating) else []


def _compare(data, wrt, port_fn, ref_fn, nan_as_ref=(), seed=0):
    """Gradients of sum(out * cotangent) over every float output, with
    respect to the inputs ``wrt``: torch.autograd.grad of the port against
    jax.grad of the reference, the same numpy inputs and cotangents. No
    gradient is NaN, except those named in ``nan_as_ref``, which are NaN
    exactly where the reference's are."""
    t_in = {k: torch.tensor(v, requires_grad=k in wrt) for k, v in data.items()}
    outs = _floats(port_fn(t_in))
    r = np.random.default_rng(seed)
    cots = [r.normal(size=tuple(o.shape)).astype(F32) for o in outs]
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    got = torch.autograd.grad(loss, [t_in[k] for k in wrt], allow_unused=True)

    def ref_loss(*xs):
        j_in = {k: jnp.asarray(v) for k, v in data.items()}
        j_in.update(zip(wrt, xs))
        r_outs = _floats(ref_fn(j_in))
        assert len(r_outs) == len(cots)
        return sum((o * c).sum() for o, c in zip(r_outs, cots))

    want = jax.grad(ref_loss, argnums=tuple(range(len(wrt))))(
        *(jnp.asarray(data[k]) for k in wrt))
    for k, g, w in zip(wrt, got, want):
        g = np.zeros(data[k].shape, F32) if g is None else g.numpy()
        w = np.asarray(w)
        if k in nan_as_ref:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"NaN in d/d{k}")
        else:
            assert not np.isnan(g).any(), f"NaN in d/d{k}"
        np.testing.assert_allclose(g, w, err_msg=f"d/d{k}", equal_nan=True, **TOL)
    return got


# ------------------------------ the helpers ---------------------------------

@pytest.mark.parametrize("op", ["clip", "maximum", "minimum", "abs_"])
def test_helpers_forward_bits_and_gradient(op):
    """Each helper: torch.clamp's / torch.abs's forward bit for bit (with
    and without a gradient recorded), JAX's gradient at the kink."""
    x = np.asarray([-2.0, -0.0, 0.0, 1e-4, 0.5, 1.0, 2.0, np.nan, -1e-4], F32)
    port = {"clip": lambda t: vecmath.clip(t, 1e-4, 1.0),
            "maximum": lambda t: vecmath.maximum(t, 1e-4),
            "minimum": lambda t: vecmath.minimum(t, 1.0),
            "abs_": vecmath.abs_}[op]
    plain = {"clip": lambda t: torch.clamp(t, 1e-4, 1.0),
             "maximum": lambda t: torch.clamp(t, min=1e-4),
             "minimum": lambda t: torch.clamp(t, max=1.0),
             "abs_": torch.abs}[op]
    ref = {"clip": lambda a: jnp.clip(a, 1e-4, 1.0),
           "maximum": lambda a: jnp.maximum(a, 1e-4),
           "minimum": lambda a: jnp.minimum(a, 1.0),
           "abs_": jnp.abs}[op]
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    y = port(t)
    bits = plain(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(y.detach().numpy().view(np.int32), bits)
    with torch.no_grad():
        np.testing.assert_array_equal(port(t).numpy().view(np.int32), bits)
    w = np.arange(1, x.size + 1, dtype=F32)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), t)
    want = jax.grad(lambda a: (ref(a) * w).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_helpers_take_the_one_kernel_op_without_a_recorded_gradient():
    """No autograd node unless a gradient is being recorded."""
    x = torch.rand(8, requires_grad=True)
    with torch.no_grad():
        assert vecmath.clip(x, 0.1, 0.9).grad_fn is None
    assert vecmath.maximum(torch.rand(8), 0.5).grad_fn is None
    assert type(vecmath.abs_(x).grad_fn).__name__.startswith("_Abs")
    assert type(vecmath.minimum(x, 0.5).grad_fn).__name__.startswith("_Clip")


# ------------------------------ the modules ---------------------------------

def _material_case():
    """The resolved closure table, with respect to the texel values: a
    glossy roughness texel of exactly 1.0 (alpha on its upper bound), one
    above it, mix fractions exactly on 1e-4 and 1 - 1e-4."""
    r = np.random.default_rng(1)
    m, x = 12, 16
    value = r.uniform(0.05, 0.95, (x, 3)).astype(F32)
    value[3, 0] = 1.0                  # alpha = 1: the tie
    value[4, 0] = 1.5                  # alpha clipped
    value[5, 0] = F32(1e-4)            # fraction on the lower bound
    value[6, 0] = F32(1.0 - 1e-4)      # ... and on the upper one
    data = {
        "value": value,
        "kind": r.integers(0, 6, m).astype(np.int32),
        "color_tex": r.integers(0, x, m).astype(np.int32),
        "roughness_tex": np.asarray([3, 4, 3, 0, 1, 2, 7, 8, 3, 4, 9, 10], np.int32),
        "fraction_tex": np.asarray([5, 6, 5, 6, 11, 12, 13, 14, 5, 6, 15, 2], np.int32),
        "mix_a": r.integers(0, m, m).astype(np.int32),
        "mix_b": r.integers(0, m, m).astype(np.int32),
        "double_sided": r.random(m) < 0.5,
        "ior": r.uniform(1.2, 2.0, m).astype(F32),
    }
    data["kind"][[0, 2, 8]] = MAT_GLOSSY

    def tables(d):
        mats = SimpleNamespace(**{k: d[k] for k in data if k != "value"})
        return mats, SimpleNamespace(value=d["value"])

    return (data, ["value"],
            lambda t: material._resolved_closure_table(*tables(t)),
            lambda j: ref_material._resolved_closure_table(*tables(j), jnp))


def _power_heuristic_case():
    r = np.random.default_rng(2)
    a = r.uniform(0.1, 10, N).astype(F32)
    b = r.uniform(0.1, 10, N).astype(F32)
    a[:6] = [1e18, 1e18, 1e19, 3.0, 0.0, 1e18]
    b[:6] = [1e18, 2.0, 1e18, 1e18, 1e18, 0.0]
    return ({"a": a, "b": b}, ["a", "b"],
            lambda t: sampling.power_heuristic(t["a"], t["b"]),
            lambda j: ref_sampling.power_heuristic(j["a"], j["b"]))


def _lanes(seed):
    """Closure params and local directions for every closure kind, with
    the pinned lanes of the module docstring."""
    r = np.random.default_rng(seed)
    d = {
        "kind": r.integers(-1, 4, N).astype(np.int32),
        "dist": r.integers(0, 3, N).astype(np.int32),
        "color": r.uniform(0.05, 1.0, (N, 3)).astype(F32),
        "alpha": r.uniform(0.1, 1.0, N).astype(F32),
        "ior": r.uniform(1.2, 2.0, N).astype(F32),
        "choice_pdf": r.uniform(0.3, 1.0, N).astype(F32),
        "wo": _unit(r, N),
        "wi": _unit(r, N),
        "u1": r.uniform(0.05, 0.95, N).astype(F32),
        "u2": r.uniform(0.05, 0.95, N).astype(F32),
    }
    wo, wi, kind = d["wo"], d["wi"], d["kind"]
    # the half vector exactly on the pole: 1 - cos^2 = 0, the tie of
    # tan^2's maximum(1 - c2, 0)
    wo[0:6] = [0.75, 0.0, 0.5]
    wi[0:6] = [-0.75, 0.0, 0.5]
    kind[0:6] = soa.CLOSURE_MICROFACET
    d["dist"][0:6] = [0, 1, 2, 0, 1, 2]
    # wi = -wo: a degenerate half vector, masked (and wo . wh = 0 on it)
    wi[6:9] = -wo[6:9]
    kind[6:9] = soa.CLOSURE_MICROFACET
    # dot products exactly 0: wi.z = 0 and wo.z = +-0
    wi[9:12, 2] = 0.0
    wo[12:14, 2] = [0.0, -0.0]
    # |cos| exactly 1e-6: the specular and glass cos clamps' ties
    wo[14:18, 2] = [1e-6, -1e-6, 1e-6, -1e-6]
    kind[14:16] = soa.CLOSURE_SPECULAR
    kind[16:18] = soa.CLOSURE_GLASS
    return d


def _params(t, v3):
    return {"kind": t["kind"], "dist": t["dist"], "color": v3(t["color"]),
            "alpha": t["alpha"], "ior": t["ior"], "choice_pdf": t["choice_pdf"]}


def _soa_case(fn):
    """The local (and one world) closure evaluators and samplers, with
    respect to the closure params and the directions. The random numbers
    u1, u2 carry no gradient in either package and are not differentiated.
    Every lane also runs the glass sampler (its result is selected per
    lane afterwards): on the lanes where it finds total internal
    reflection, both packages take sqrt'(0) = inf times a zero cotangent,
    so d/d wo and d/d ior are NaN there in the reference too (ROADMAP
    Queue 3); the port must give NaN on exactly those lanes and agree
    everywhere else."""
    data = _lanes(3)
    wrt = ["color", "alpha", "ior", "choice_pdf", "wo", "wi"]

    def run(mod, t):
        v3 = lambda a: _v3(a, "torch" if mod is soa else "jax")  # noqa: E731
        p = _params(t, v3)
        if fn == "eval":
            return mod.eval_local(p, v3(t["wo"]), v3(t["wi"]))
        if fn == "pdf":
            return mod.pdf_local(p, v3(t["wo"]), v3(t["wi"]))
        if fn == "sample":
            return mod.sample_local(p, v3(t["wo"]), t["u1"], t["u2"])
        frame = mod.make_frame(v3(t["wo"]))  # the world forms through a frame
        return mod.eval_world(p, frame, v3(t["wi"]), v3(t["wo"] * 0.5 + t["wi"]))

    used = {"eval": ["color", "alpha", "wo", "wi"], "pdf": ["alpha", "choice_pdf", "wo", "wi"],
            "sample": ["color", "alpha", "ior", "choice_pdf", "wo"],
            "eval_world": ["color", "alpha", "wo", "wi"]}[fn]
    nan_as_ref = ("ior", "wo") if fn == "sample" else ()
    return (data, [k for k in wrt if k in used],
            lambda t: run(soa, t), lambda j: run(ref_soa, j), nan_as_ref)


def _fresnel_case():
    """cos_i exactly +-1 (the clip's ties) and exactly +-0 (abs's kink,
    seen where eta_t < eta_i leaves no total internal reflection). At
    normal incidence (1 - ci^2 = 0) and under total internal reflection
    (1 - sin_t^2 <= 0) both packages take sqrt'(0) = inf times a zero
    cotangent: NaN in the reference too (ROADMAP Queue 3), so the port's
    NaNs must sit on exactly its lanes."""
    r = np.random.default_rng(4)
    cos_i = r.uniform(-0.95, 0.95, N).astype(F32)
    eta_t = r.uniform(0.6, 2.0, N).astype(F32)
    cos_i[:6] = [1.0, -1.0, 0.0, -0.0, 0.0, 1.0]
    eta_t[:6] = [1.5, 1.5, 0.8, 0.8, 1.5, 0.7]
    data = {"cos_i": cos_i, "eta_i": np.ones(N, F32), "eta_t": eta_t}
    return (data, ["cos_i", "eta_t"],
            lambda t: bsdf.fresnel_dielectric(t["cos_i"], t["eta_i"], t["eta_t"]),
            lambda j: ref_bsdf.fresnel_dielectric(j["cos_i"], j["eta_i"], j["eta_t"]),
            ("cos_i", "eta_t"))


def _light_case():
    """Light-triangle data with a squared normal of exactly 1e-20 (the
    area clamp's tie): e1 = (1, 0, 0), e2 = (0, r, -q), q^2 + r^2 rounding
    to 1e-20 in float32."""
    r = np.random.default_rng(5)
    n = 32
    v0 = r.uniform(-1, 1, (n, 3)).astype(F32)
    e1 = r.normal(size=(n, 3)).astype(F32)
    e2 = r.normal(size=(n, 3)).astype(F32)
    q, s = F32(6.0000005e-11), F32(7.999999e-11)
    assert F32(F32(q * q) + F32(s * s)) == F32(1e-20)
    e1[:2] = [1.0, 0.0, 0.0]
    e2[:2] = [0.0, s, -q]
    e2[2] = e1[2]  # a degenerate triangle: the clamp's outside
    data = {"v0": v0, "e1": e1, "e2": e2, "tri": np.arange(n, dtype=np.int32)}

    def scene(d):
        return SimpleNamespace(instances=None, tri_v0=d["v0"], tri_e1=d["e1"], tri_e2=d["e2"])

    return (data, ["v0", "e1", "e2"],
            lambda t: light._light_tri_data(scene(t), t["tri"]),
            lambda j: ref_light._light_tri_data(scene(j), j["tri"]))


CASES = {
    "material_closure_table": _material_case,
    "power_heuristic": _power_heuristic_case,
    "soa_eval_local": lambda: _soa_case("eval"),
    "soa_pdf_local": lambda: _soa_case("pdf"),
    "soa_sample_local": lambda: _soa_case("sample"),
    "soa_eval_world": lambda: _soa_case("eval_world"),
    "bsdf_fresnel_dielectric": _fresnel_case,
    "light_tri_data": _light_case,
}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_at_ties(case):
    _compare(*CASES[case]())


def test_roughness_texel_at_one_passes_half_the_gradient():
    """alpha = clip(rough^2, 1e-4, 1): at a texel of exactly 1.0 the
    reference passes d alpha / d texel = 2 * 1/2 = 1, not 2."""
    data, wrt, port_fn, _ = _material_case()
    t = {k: torch.tensor(v, requires_grad=k in wrt) for k, v in data.items()}
    alpha = port_fn(t)[:, 4]
    (g,) = torch.autograd.grad(alpha[0], t["value"])  # material 0: glossy, texel 3
    assert float(g[3, 0]) == 1.0 and float(g.abs().sum()) == 1.0


# --------------------------- the path integrator ----------------------------

@pytest.fixture(scope="module")
def glossy_cornell():
    """The 16x16 Cornell box with one material turned glossy on a
    roughness texel of exactly 1.0 (alpha on its bound), compiled once and
    handed to both packages, and the camera's first hits (the JAX
    package's brute intersector)."""
    sc = ref_cornell_box(16, 16)
    ref_np = jax.tree_util.tree_map(np.asarray, sc.compile(intersector="brute"))
    mats, tex = ref_np.materials, ref_np.textures
    kind, rough = np.array(mats.kind), np.array(mats.roughness_tex)
    value = np.array(tex.value)
    k = int(np.argmax(np.bincount(np.asarray(ref_np.mat_id), minlength=len(kind))))
    kind[k] = MAT_GLOSSY
    rough[k] = value.shape[0]
    value = np.concatenate([value, np.ones((1, 3), F32)])  # the new texel: exactly 1.0
    ref_np = dataclasses.replace(
        ref_np, materials=dataclasses.replace(mats, kind=kind, roughness_tex=rough),
        textures=dataclasses.replace(tex, value=value))
    port = from_numpy_scene(ref_np, intersector="brute", device="cpu")
    ref = jax.tree_util.tree_map(jnp.asarray, ref_np)
    n = 16 * 16
    px, sx = np.arange(n, dtype=np.uint32), np.zeros(n, np.uint32)
    o, d = ref_path.camera_rays_soa(sc.camera, 0, jnp.asarray(sx), jnp.asarray(px), jnp)
    hit = ref_path._jax_intersectors_soa(ref)[0](o, d)
    state = [np.asarray(x) for x in (*hit, *o, *d)]
    return ref, port, sc.camera, state


def test_bounce_step_gradients_match_jax(glossy_cornell):
    """One path vertex (``_bounce_step``: emission, material walk, NEE with
    MIS, BSDF sample, throughput) of every camera hit: the gradients of
    its radiance and throughput with respect to the texel values and the
    incoming throughput, against the reference's ``_bounce_step``."""
    ref, port, cam, state = glossy_cornell
    n = state[0].shape[0]
    t_, prim, u, v, valid, ox, oy, oz, dx, dy, dz = state
    data = {"value": np.asarray(port.textures.value.numpy()),
            "beta": np.random.default_rng(6).uniform(0.5, 1.0, (n, 3)).astype(F32)}

    def step(mod, xp, t, scene):
        tex = dataclasses.replace(scene.textures, value=t["value"])
        scene = dataclasses.replace(scene, textures=tex)
        vec = V3 if xp is torch else JV3
        asarr = (lambda a: torch.from_numpy(np.array(a))) if xp is torch else jnp.asarray
        z = asarr(np.zeros(n, F32))
        st = ((asarr(t_), asarr(prim), asarr(u), asarr(v), asarr(valid)),
              vec(asarr(ox), asarr(oy), asarr(oz)), vec(asarr(dx), asarr(dy), asarr(dz)),
              vec(z, z, z), _v3(t["beta"], "torch" if xp is torch else "jax"),
              asarr(np.ones(n, bool)), z)
        pix = np.arange(n)
        if xp is torch:
            cfg = port_path.PathConfig(spp=1, max_depth=2)
            ints = port_path._intersectors_soa(scene)
            args = (torch.from_numpy(np.zeros(n, np.int64)), torch.from_numpy(pix))
            out = mod._bounce_step(scene, cfg, 0, *args, st, 1, *ints)
        else:
            cfg = ref_path.PathConfig(spp=1, max_depth=2)
            ints = ref_path._jax_intersectors_soa(scene)
            args = (jnp.zeros(n, jnp.uint32), jnp.asarray(pix, jnp.uint32))
            out = mod._bounce_step(scene, cfg, jnp.uint32(0), *args, st, 1, *ints, jnp)
        _, o, d, L, beta, _, pdf = out
        return L, beta, pdf

    got = _compare(data, ["value", "beta"],
                   lambda t: step(port_path, torch, t, port),
                   lambda j: step(ref_path, jnp, j, ref))
    assert float(got[0][-1].abs().sum()) > 0  # the glossy texel carries gradient
