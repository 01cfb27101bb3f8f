"""The dense kernel's plain version on the edges of the hit test.

The CUDA kernel (kernels/csrc/dense_intersect.cu) scans each ray's
triangles in ascending order with a strict ``t < best_t``; the plain
version (``closest_plain`` / ``any_hit_plain``) reduces all pairs at once
(minimum t, then the lowest index among the minima). The card holds the
kernel against the plain version bit for bit, so here the plain version is
held against such a sequential scan, written in numpy float32 (one rounding
per operation, as the kernel is built), bit for bit, on random, edge-grazing
and adversarial pairs drawn by hypothesis: u or v exactly 0, u + v exactly
1, |det| at HIT_EPS and one ulp either side, denormal numerators, +-0,
+-inf and NaN components, dead and NaN ray limits.

The adversarial pack that ``chip_smoke.py`` and the GPU tests run through
the kernel is also held against the reference's Pallas kernel
(``akari_tpu/ops/pallas_intersect.py::_run``) in interpret mode. Its
special pairs are built from exact products, so XLA's contraction into
FMAs cannot move their decisions: prim ids, validity and any-hit flags
exact, t/u/v within rtol = atol = 1e-6 scaled per hit by the condition
number 1 + |e1 x e2| / |det| (as in tests/test_torch_intersect.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

import akari_tpu.ops.pallas_intersect as pi
import chip_smoke
from akari_torch.ops import dense_intersect as di
from akari_tpu.core.v3 import V3 as JV3

torch.set_num_threads(2)

F32 = np.float32
K = 8  # rays and triangles of one drawn example: K x K pairs
TOL = 1e-6


def _around(x):
    """x and one float32 ulp either side."""
    x = F32(x)
    return [np.nextafter(x, F32(-np.inf)), x, np.nextafter(x, F32(np.inf))]


NON_FINITE = [0.0, -0.0, np.inf, -np.inf, np.nan]
EDGES = [*_around(di.HIT_EPS), *_around(2.0 ** 60), *_around(2.0 ** -60)]
BEYOND = [2.0 ** 61, 2.0 ** 80, 2.0 ** 100, 2.0 ** 127, 1e-30]
DETS = [1.0, -1.0, 0.5, *EDGES, *(-x for x in EDGES), *BEYOND, *(-x for x in BEYOND),
        *NON_FINITE]
NUMS = [0.25, -0.25, 1e-45, -1e-45, 1e-40, -1e-40, 1e-30, -1e-30, 1e20, -1e20,
        *EDGES, *(-x for x in EDGES), *NON_FINITE]
BARY = [0.0, -0.0, 1.0, 0.5, 0.25, 0.75, 1e-7, -1e-7, 1.0 - 2 ** -24, 1.0 + 2 ** -23]
LIMITS = [(0.0, 1e30), (0.0, 1e30), (0.0, 2.0), (0.0, 0.5), (-0.0, 1e30), (1.0, 1e30),
          (0.0, np.inf), (np.nan, 1e30), (0.0, np.nan), (0.0, 0.0)]


def _scan(rays, tris, any_hit):
    """The kernel's loop in numpy float32: each ray visits the triangles in
    ascending order and takes a hit with t in (t_min, best_t)."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = rays
    best = tmax if any_hit else np.where(tmax > F32(di.T_MAX), F32(di.T_MAX), tmax)
    n = rays.shape[1]
    bu, bv = np.zeros(n, F32), np.zeros(n, F32)
    prim = np.full(n, -1, np.int32)
    occ = np.zeros(n, bool)
    eps = F32(di.HIT_EPS)
    for j, (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) in enumerate(tris[:, :9]):
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = F32(1.0) / np.where(np.abs(det) < eps, F32(1.0), det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = ((np.abs(det) >= eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin)
               & (t < best))
        occ |= hit
        if not any_hit:
            best, bu, bv = np.where(hit, t, best), np.where(hit, u, bu), np.where(hit, v, bv)
            prim = np.where(hit, np.int32(j), prim)
    t_out = np.where(prim >= 0, best, F32(di.T_MAX))
    return occ if any_hit else (t_out, bu, bv, prim)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return a.view(np.int32) if a.dtype == F32 else a


def _check_against_scan(rays, tris):
    """closest_plain and any_hit_plain == the sequential scan, bit for bit."""
    rays = np.ascontiguousarray(rays, F32)
    tris = np.ascontiguousarray(tris, F32)
    with np.errstate(all="ignore"):
        want = _scan(rays, tris, False)
        want_occ = _scan(rays, tris, True)
    got = di.closest_plain(torch.from_numpy(rays), torch.from_numpy(tris))
    for name, a, b in zip("tuvp", got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    occ = di.any_hit_plain(torch.from_numpy(rays), torch.from_numpy(tris))
    np.testing.assert_array_equal(occ.numpy(), want_occ)


def _inject(data, a, n):
    """Overwrite up to n components of array a with non-finite or edge
    values."""
    picks = data.draw(st.lists(st.tuples(st.integers(0, a.size - 1),
                                         st.sampled_from(NON_FINITE + EDGES)), max_size=n))
    flat = a.reshape(-1)
    for i, x in picks:
        flat[i] = x
    return a


def _limits(data):
    lim = np.asarray(data.draw(st.lists(st.sampled_from(LIMITS), min_size=K, max_size=K)))
    return lim.T.astype(F32)


def _random(data):
    """Random rays and triangles, some components non-finite or on edges."""
    f = st.floats(-2.0, 2.0, width=32)
    o = data.draw(arrays(F32, (3, K), elements=f))
    d = data.draw(arrays(F32, (3, K), elements=st.floats(-1.0, 1.0, width=32)))
    tris = data.draw(arrays(F32, (K, 9), elements=f))
    rays = np.concatenate([o, d, _limits(data)])
    return _inject(data, rays, 4), _inject(data, tris, 4)


def _grazing(data):
    """Ray i aimed at a point of triangle i with barycentrics on or near
    the edges (u or v 0, u + v 1) from a drawn distance; some triangles
    repeat an earlier one (a tie the lower index must win)."""
    f = st.floats(-1.0, 1.0, width=32)
    tris = data.draw(arrays(F32, (K, 9), elements=f))
    for i, j in data.draw(st.lists(st.tuples(st.integers(0, K - 1), st.integers(0, K - 1)),
                                   max_size=2)):
        tris[max(i, j)] = tris[min(i, j)]
    a = data.draw(st.lists(st.sampled_from(BARY) | st.floats(0.0, 1.0, width=32),
                           min_size=K, max_size=K))
    b = np.asarray([1.0 - x if data.draw(st.booleans()) else data.draw(st.sampled_from(BARY))
                    for x in a])
    a = np.asarray(a)
    d = data.draw(arrays(F32, (K, 3), elements=f)).astype(np.float64)
    d[np.linalg.norm(d, axis=1) < 1e-3] = (0.0, 0.0, 1.0)
    s = np.asarray(data.draw(st.lists(st.floats(0.01, 4.0), min_size=K, max_size=K)))
    t64 = tris.astype(np.float64)
    p = t64[:, 0:3] + a[:, None] * t64[:, 3:6] + b[:, None] * t64[:, 6:9]
    o = p - s[:, None] * d
    rays = np.concatenate([o.T, d.T, _limits(data)]).astype(F32)
    return _inject(data, rays, 2), _inject(data, tris, 2)


def _adversarial(data):
    """Triangle i = (v0 0, e1 (0, D_i, 0), e2 (1, 0, 0)) and ray i of
    direction (0, 0, 1): det = D_i, u_num = oy and v_num = RN(ox D_i)
    exactly for every pair, with D, oy and ox on HIT_EPS and the float32
    range's edges, denormal, +-0, +-inf or NaN. Ray i aims at triangle i:
    its ox is a drawn v over D_i, its oy a drawn u_num or u times D_i."""
    det = data.draw(st.lists(st.sampled_from(DETS), min_size=K, max_size=K))
    tris = np.zeros((K, 9), F32)
    tris[:, 4] = det
    tris[:, 6] = 1.0
    ox, oy = [], []
    with np.errstate(all="ignore"):
        for dj in tris[:, 4]:
            if not np.isfinite(dj) or dj == 0.0:
                dj = F32(1.0)
            ox.append(F32(F32(data.draw(st.sampled_from(BARY + NUMS))) / dj))
            if data.draw(st.booleans()):
                oy.append(F32(data.draw(st.sampled_from(NUMS))))
            else:
                oy.append(F32(F32(data.draw(st.sampled_from(BARY))) * dj))
    oz = data.draw(st.lists(st.sampled_from([-1.0, -1.0, -1.0, 1.0, -0.0, -1e-30, -1e30]),
                            min_size=K, max_size=K))
    d = np.tile(np.asarray([[0.0], [0.0], [1.0]], F32), (1, K))
    rays = np.concatenate([np.asarray([ox, oy, oz], F32), d, _limits(data)])
    return rays, tris


MODES = {"random": _random, "grazing": _grazing, "adversarial": _adversarial}


@pytest.mark.parametrize("mode", sorted(MODES))
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(data=st.data())
def test_plain_equals_sequential_scan(mode, data):
    _check_against_scan(*MODES[mode](data))


@pytest.fixture(scope="module")
def pack():
    rays, tris = chip_smoke.adversarial_pack(torch.device("cpu"), torch)
    return rays.numpy(), tris.numpy()


def _pallas(rays, tris, any_hit):
    """The reference's dense Pallas kernel, in interpret mode, on [8, N]
    rays and [T, 9] triangles."""
    o = JV3(*(jnp.asarray(rays[i]) for i in range(3)))
    d = JV3(*(jnp.asarray(rays[i]) for i in range(3, 6)))
    rays_j, n = pi._pack_rays_soa(o, d, jnp.asarray(rays[6]), jnp.asarray(rays[7]))
    tris_j = pi.pack_tris(*(jnp.asarray(tris[:, k:k + 3]) for k in (0, 3, 6)))
    out = pi._run(rays_j, tris_j, any_hit, interpret=True)
    if any_hit:
        return np.asarray(out[0, :n] > 0.5)
    return tuple(np.asarray(x) for x in pi._unpack_closest(out[:, :n]))


def _condition(rays, tris, prim):
    """1 + |e1 x e2| / |det| of each ray's hit triangle (float64)."""
    k = np.maximum(prim, 0)
    d = rays[3:6].T.astype(np.float64)
    e1 = tris[k, 3:6].astype(np.float64)
    e2 = tris[k, 6:9].astype(np.float64)
    with np.errstate(all="ignore"):
        det = np.abs(np.sum(e1 * np.cross(d, e2), axis=-1))
        area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
        return 1.0 + area2 / np.maximum(det, 1e-30)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_adversarial_pack_matches_pallas_kernel(pack, any_hit):
    rays, tris = pack
    tr, tt = torch.from_numpy(rays), torch.from_numpy(tris)
    with np.errstate(all="ignore"):
        ref = _pallas(rays, tris, any_hit)
    if any_hit:
        np.testing.assert_array_equal(di.any_hit(tr, tt).numpy(), ref)
        return
    t, u, v, prim = (x.numpy() for x in di.closest(tr, tt))
    rt, rprim, ru, rv, rvalid = ref
    np.testing.assert_array_equal(prim, rprim)
    np.testing.assert_array_equal(prim >= 0, rvalid)
    ok = rvalid
    cond = _condition(rays, tris, prim)[ok]
    for a, b in ((t, rt), (u, ru), (v, rv)):
        bound = cond * (TOL + TOL * np.abs(b[ok]))
        assert np.all(np.abs(a[ok] - b[ok]) <= bound)
    assert np.all(t[~ok] == F32(di.T_MAX)) and np.all(u[~ok] == 0) and np.all(v[~ok] == 0)


def test_adversarial_pack_reaches_its_edges(pack):
    """The pack the card runs has hitting pairs where it is built to: u or
    v exactly 0 (u = -0.0 too: a negative numerator whose product rounds to
    zero), u + v exactly 1, |det| at HIT_EPS and one ulp above it but not
    below; and it holds dead rays and misses."""
    rays, tris = (torch.from_numpy(x) for x in pack)
    with np.errstate(all="ignore"):
        hit, _, u, v = di._pairwise_mt(rays, tris, torch.clamp(rays[7], max=di.T_MAX))
    assert bool((hit & (u == 0)).any()) and bool((hit & (v == 0)).any())
    assert bool((hit & (u == 0) & torch.signbit(u)).any())
    assert bool((hit & (u + v == 1)).any())
    # a ray of direction (0, 0, 1) against a special triangle: det = D
    along_z = (rays[3] == 0) & (rays[4] == 0) & (rays[5] == 1)
    special = (tris[:, 0] == 0) & (tris[:, 3] == 0) & (tris[:, 6] == 1)
    exact = hit & along_z[:, None] & special[None]
    det = tris[:, 4].abs()[None]
    eps = _around(di.HIT_EPS)
    assert bool((exact & (det == float(eps[1]))).any())
    assert bool((exact & (det == float(eps[2]))).any())
    assert not bool((exact & (det == float(eps[0]))).any())
    prim = di.closest_plain(rays, tris)[3]
    assert int((prim >= 0).sum()) > 50 and bool((prim < 0).any())
    assert bool((~(rays[6] < torch.clamp(rays[7], max=di.T_MAX))).any())
