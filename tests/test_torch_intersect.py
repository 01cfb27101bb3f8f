"""Port parity: dense intersection (akari_torch.ops.dense_intersect /
ops.intersect vs akari_tpu.ops.pallas_intersect and the JAX brute backend).

The JAX side reaches the Pallas kernel in interpret mode, as
tests/test_pallas.py does. Tolerances: prim ids, validity and any-hit
flags exact (same hit decisions); t/u/v rtol = atol = 1e-6, since XLA may
contract the Moeller-Trumbore products into FMAs where the port rounds op
by op. On the random soup that bound is scaled per hit by the test's
condition number 1 + |e1 x e2| / |det| (= 1 + 1/|cos| of the ray against
the triangle plane): a grazing hit divides a one-rounding difference by a
small determinant. The CUDA kernel itself runs only on the card: its
tests are in tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akari_tpu.ops.pallas_intersect as pi
from akari_torch.core.v3 import V3
from akari_torch.ops import dense_intersect as di
from akari_torch.ops.intersect import brute_closest, intersect_soa, occlude_soa
from akari_torch.scene.arrays import from_numpy_scene
from akari_tpu.core.v3 import V3 as JV3
from akari_tpu.ops.intersect import intersect_soa as ref_intersect_soa
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pi.INTERPRET
    pi.INTERPRET = True
    yield
    pi.INTERPRET = old


@pytest.fixture(scope="module")
def scenes():
    import jax

    ref_p = ref_cornell_box(16, 16).compile(intersector="pallas")
    ref_b = ref_cornell_box(16, 16).compile(intersector="brute")
    port = from_numpy_scene(jax.tree_util.tree_map(np.asarray, ref_p), device="cpu")
    return ref_p, ref_b, port


def _rays(n, seed):
    """Camera-side and inside-the-box origins, random directions."""
    r = np.random.default_rng(seed)
    o = np.where(
        (np.arange(n) % 2 == 0)[:, None],
        np.asarray([0.0, 1.0, 4.0]) + r.normal(scale=0.2, size=(n, 3)),
        r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], size=(n, 3)),
    ).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _limits(ref_b, o, d, seed):
    """t_max per ray: a third bounded to half the ray's own hit distance,
    a third dead (t_max = 0), the rest unbounded."""
    n = o.shape[0]
    h = ref_intersect_soa(ref_b, _jv3(o), _jv3(d))
    t_hit = np.asarray(h.t)
    sel = np.random.default_rng(seed + 100).integers(0, 3, n)
    t_max = np.where(sel == 0, t_hit * 0.5, np.where(sel == 1, 0.0, 1e30))
    return np.zeros(n, np.float32), t_max.astype(np.float32)


def _jv3(a):
    return JV3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _tv3(a):
    a = torch.from_numpy(np.ascontiguousarray(a))
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _pack(o, d, t_min, t_max):
    return torch.from_numpy(
        np.ascontiguousarray(
            np.concatenate([o.T, d.T, t_min[None], t_max[None]], axis=0),
            dtype=np.float32,
        )
    )


def _assert_hits_equal(port, ref, cond=None):
    """Port (t, u, v, prim) vs reference (t, prim, u, v, valid). ``cond``
    scales the tolerance per ray (1 everywhere when None)."""
    t, u, v, prim = port
    rt, rprim, ru, rv, rvalid = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(prim.numpy() >= 0, rvalid)
    np.testing.assert_array_equal(prim.numpy(), rprim)
    ok = rvalid
    scale = np.ones_like(rt) if cond is None else cond
    for a, b in ((t.numpy(), rt), (u.numpy(), ru), (v.numpy(), rv)):
        bound = scale[ok] * (TOL["atol"] + TOL["rtol"] * np.abs(b[ok]))
        assert np.all(np.abs(a[ok] - b[ok]) <= bound), np.max(
            np.abs(a[ok] - b[ok]) / bound
        )
    # misses: t = T_MAX, u = v = 0 like the reference's unpacked state
    assert np.all(t.numpy()[~ok] == np.float32(1e30))
    assert np.all(u.numpy()[~ok] == 0.0) and np.all(v.numpy()[~ok] == 0.0)


@pytest.mark.parametrize("n", [2048, 77])
def test_dense_plain_matches_pallas_kernel(scenes, n):
    ref_p, ref_b, port = scenes
    o, d = _rays(n, seed=n)
    t_min, t_max = _limits(ref_b, o, d, seed=n)
    ref = pi.intersect_pallas_soa(
        ref_p, _jv3(o), _jv3(d), jnp.asarray(t_min), jnp.asarray(t_max)
    )
    got = di.closest(_pack(o, d, t_min, t_max), port.prim_table)
    _assert_hits_equal(got, ref)
    # bounded and dead rays really were exercised
    assert (t_max == 0).any() and ((t_max > 0) & (t_max < 1e29)).any()


@pytest.mark.parametrize("n", [2048, 77])
def test_dense_plain_matches_jax_brute(scenes, n):
    _, ref_b, port = scenes
    o, d = _rays(n, seed=n + 1)
    t_min, t_max = _limits(ref_b, o, d, seed=n + 1)
    ref = ref_intersect_soa(ref_b, _jv3(o), _jv3(d), jnp.asarray(t_min), jnp.asarray(t_max))
    got = di.closest(_pack(o, d, t_min, t_max), port.prim_table)
    _assert_hits_equal(got, ref)


@pytest.mark.parametrize("n", [2048, 77])
def test_any_hit_plain_matches_pallas_kernel(scenes, n):
    ref_p, ref_b, port = scenes
    o, d = _rays(n, seed=n + 2)
    t_min, t_max = _limits(ref_b, o, d, seed=n + 2)
    ref = pi.intersect_pallas_soa(
        ref_p, _jv3(o), _jv3(d), jnp.asarray(t_min), jnp.asarray(t_max),
        any_hit=True,
    )
    rays = _pack(o, d, t_min, t_max)
    occ = di.any_hit(rays, port.prim_table)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    # any-hit == closest-hit validity under the same t_max
    np.testing.assert_array_equal(occ.numpy(), di.closest(rays, port.prim_table)[3].numpy() >= 0)


def _soup(seed=11, n=300):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-1.0, 1.0, size=(n, 3)) + np.asarray([0.0, 1.0, 0.0])
    e1 = r.normal(scale=0.3, size=(n, 3))
    e2 = r.normal(scale=0.3, size=(n, 3))
    tris = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    # exact duplicates across the reference's 128-row tile boundaries:
    # equal t, so the lower index must win
    tris[200:240] = tris[0:40]
    tris[290:300] = tris[130:140]
    return tris


def _condition(tris, d, prim):
    """1 + |e1 x e2| / |det| of each ray's hit triangle (float64)."""
    k = np.maximum(prim, 0)
    e1 = tris[k, 3:6].astype(np.float64)
    e2 = tris[k, 6:9].astype(np.float64)
    det = np.abs(np.sum(e1 * np.cross(d.astype(np.float64), e2), axis=-1))
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    return 1.0 + area2 / np.maximum(det, 1e-30)


def test_soup_crossing_tiles_matches_pallas_kernel():
    tris = _soup()
    o, d = _rays(2048, seed=21)
    t_min = np.zeros(2048, np.float32)
    t_max = np.full(2048, 1e30, np.float32)
    t_max[::5] = 0.0
    rays_j, n = pi._pack_rays_soa(
        _jv3(o), _jv3(d), jnp.asarray(t_min), jnp.asarray(t_max)
    )
    tris_j = pi.pack_tris(
        jnp.asarray(tris[:, 0:3]), jnp.asarray(tris[:, 3:6]), jnp.asarray(tris[:, 6:9])
    )
    assert tris_j.shape[0] // pi.TRI_TILE == 3  # several tiles
    ref = pi._unpack_closest(pi._run(rays_j, tris_j, False, interpret=True)[:, :n])
    got = di.closest(_pack(o, d, t_min, t_max), torch.from_numpy(tris))
    _assert_hits_equal(got, ref, cond=_condition(tris, d, got[3].numpy()))
    prim = got[3].numpy()
    assert not np.isin(prim, np.r_[200:240, 290:300]).any()  # duplicates lose ties
    assert np.isin(prim, np.r_[0:40, 130:140]).any()
    ref_any = pi._run(rays_j, tris_j, True, interpret=True)[0, :n] > 0.5
    np.testing.assert_array_equal(
        di.any_hit(_pack(o, d, t_min, t_max), torch.from_numpy(tris)).numpy(),
        np.asarray(ref_any),
    )


def test_plain_chunking_does_not_change_results(monkeypatch):
    tris = torch.from_numpy(_soup())
    o, d = _rays(500, seed=4)
    rays = _pack(o, d, np.zeros(500, np.float32), np.full(500, 1e30, np.float32))
    full = di.closest_plain(rays, tris)
    monkeypatch.setattr(di, "PLAIN_PAIRS_PER_CHUNK", 300 * 7)
    chunked = di.closest_plain(rays, tris)
    for a, b in zip(full, chunked):
        assert torch.equal(a, b)


def test_brute_backend_matches_dense_plain(scenes):
    _, _, port = scenes
    o, d = _rays(1000, seed=8)
    t_min = torch.zeros(1000)
    t_max = torch.full((1000,), 1e30)
    t, prim, u, v, valid = brute_closest(
        port, torch.from_numpy(o), torch.from_numpy(d), t_min, t_max
    )
    td, ud, vd, primd = di.closest_plain(_pack(o, d, t_min.numpy(), t_max.numpy()), port.prim_table)
    np.testing.assert_array_equal(prim.numpy(), primd.numpy())
    np.testing.assert_allclose(t.numpy(), td.numpy(), **TOL)
    np.testing.assert_allclose(u.numpy(), ud.numpy(), **TOL)


def test_soa_entry_points_on_v3(scenes):
    _, ref_b, port = scenes
    o, d = _rays(300, seed=9)
    h = intersect_soa(port, _tv3(o), _tv3(d))
    ref = ref_intersect_soa(ref_b, _jv3(o), _jv3(d))
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(h.valid.numpy(), np.asarray(ref.valid))
    t_max = torch.where(h.valid, h.t * 0.5, 1e30)
    occ = occlude_soa(port, _tv3(o), _tv3(d), 0.0, t_max)
    assert not occ[h.valid].any()  # nothing before half the hit distance
    occ_full = occlude_soa(port, _tv3(o), _tv3(d), 0.0, 1e30)
    np.testing.assert_array_equal(occ_full.numpy(), h.valid.numpy())


def test_wrapper_rejects_bad_inputs(scenes):
    _, _, port = scenes
    good = torch.zeros((8, 4))
    with pytest.raises(ValueError):
        di.closest(torch.zeros((7, 4)), port.prim_table)
    with pytest.raises(TypeError):
        di.closest(good.double(), port.prim_table)
    with pytest.raises(ValueError):
        di.any_hit(good, port.prim_table[:, :8])
