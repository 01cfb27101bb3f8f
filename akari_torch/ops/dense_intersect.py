"""Dense all-pairs ray-triangle intersection: CUDA kernel and plain twin.

Counterpart of ``akari_tpu/ops/pallas_intersect.py`` (``_run`` with
``_closest_kernel`` / ``_anyhit_kernel``) for flat scenes. The kernel is
``kernels/csrc/dense_intersect.cu``; its plain PyTorch version lives
beside it here.

``closest(rays, tris)`` and ``any_hit(rays, tris)`` take

- ``rays``: ``[8, N]`` float32, contiguous, rows ox oy oz dx dy dz tmin
  tmax (the reference's ``_pack_rays_soa`` layout, without tile padding);
- ``tris``: ``[T, C]`` float32 with C >= 9, contiguous, each row starting
  v0.xyz e1.xyz e2.xyz (``SceneArrays.prim_table`` qualifies as is).

On CUDA tensors they launch the kernel or raise; on CPU tensors they run
the plain version. There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

HIT_EPS = 1e-9
T_MAX = 1e30

# Kernel launches since the last reset, per kernel (CUDA tensors only).
LAUNCHES = {"closest": 0, "any_hit": 0}

# Rays per chunk of the plain version: bounds its [chunk, T] temporaries.
PLAIN_PAIRS_PER_CHUNK = 1 << 22

_LIB = "dense_intersect"


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_rays(o, d, t_min, t_max):
    """V3 o, V3 d, [N] t_min/t_max -> [8, N] float32 ray rows."""
    return torch.stack(
        torch.broadcast_tensors(o.x, o.y, o.z, d.x, d.y, d.z, t_min, t_max),
        dim=0,
    ).to(torch.float32)


# ------------------------------ plain twin ----------------------------------

def _pairwise_mt(rays, tris, best_t):
    """[8, R] rays x [T, >=9] tris -> per-pair (hit, t, u, v) as [R, T],
    in the operation order of the reference's ``_pairwise_mt_t``."""
    ox, oy, oz = rays[0][:, None], rays[1][:, None], rays[2][:, None]
    dx, dy, dz = rays[3][:, None], rays[4][:, None], rays[5][:, None]
    tmin = rays[6][:, None]
    v0x, v0y, v0z = tris[:, 0], tris[:, 1], tris[:, 2]
    e1x, e1y, e1z = tris[:, 3], tris[:, 4], tris[:, 5]
    e2x, e2y, e2z = tris[:, 6], tris[:, 7], tris[:, 8]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < HIT_EPS, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        (torch.abs(det) >= HIT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < best_t[:, None])
    )
    return hit, t, u, v


def _chunks(n, n_tris):
    step = max(1, PLAIN_PAIRS_PER_CHUNK // max(n_tris, 1))
    return range(0, n, step), step


def closest_plain(rays, tris):
    """Plain version of the closest-hit kernel -> (t, u, v, prim int32)."""
    n, n_tris = rays.shape[1], tris.shape[0]
    t_out = torch.full((n,), T_MAX, dtype=torch.float32, device=rays.device)
    u_out = torch.zeros((n,), dtype=torch.float32, device=rays.device)
    v_out = torch.zeros((n,), dtype=torch.float32, device=rays.device)
    prim_out = torch.full((n,), -1, dtype=torch.int32, device=rays.device)
    if n_tris == 0:
        return t_out, u_out, v_out, prim_out
    starts, step = _chunks(n, n_tris)
    col = torch.arange(n_tris, device=rays.device)
    for s in starts:
        r = rays[:, s:s + step]
        # init_state: best_t = minimum(t_max, T_MAX) (NaN stays NaN)
        best = torch.clamp(r[7], max=T_MAX)
        hit, t, u, v = _pairwise_mt(r, tris, best)
        t_m = torch.where(hit, t, T_MAX)
        t_best = t_m.min(dim=1, keepdim=True).values
        # lowest triangle index among the minima (the reference's tie order)
        k = torch.where(t_m <= t_best, col, n_tris).min(dim=1).values
        found = hit.any(dim=1)
        kk = torch.clamp(k, max=n_tris - 1)[:, None]
        t_out[s:s + step] = torch.where(found, t_best[:, 0], T_MAX)
        u_out[s:s + step] = torch.where(found, u.gather(1, kk)[:, 0], 0.0)
        v_out[s:s + step] = torch.where(found, v.gather(1, kk)[:, 0], 0.0)
        prim_out[s:s + step] = torch.where(found, k, -1).to(torch.int32)
    return t_out, u_out, v_out, prim_out


def any_hit_plain(rays, tris):
    """Plain version of the any-hit kernel -> [N] bool occluded."""
    n, n_tris = rays.shape[1], tris.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=rays.device)
    if n_tris == 0:
        return occ
    starts, step = _chunks(n, n_tris)
    for s in starts:
        r = rays[:, s:s + step]
        hit, _, _, _ = _pairwise_mt(r, tris, r[7])
        occ[s:s + step] = hit.any(dim=1)
    return occ


# ------------------------------ CUDA wrapper --------------------------------

def _check(rays, tris):
    if not isinstance(rays, torch.Tensor) or not isinstance(tris, torch.Tensor):
        raise TypeError("rays and tris must be tensors")
    if rays.device != tris.device:
        raise ValueError(
            f"rays on {rays.device} but triangles on {tris.device}"
        )
    if rays.dtype != torch.float32 or tris.dtype != torch.float32:
        raise TypeError(
            f"expected float32 rays and triangles, got {rays.dtype}, {tris.dtype}"
        )
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, N], got {tuple(rays.shape)}")
    if tris.dim() != 2 or tris.shape[1] < 9:
        raise ValueError(f"tris must be [T, C>=9], got {tuple(tris.shape)}")
    if tris.shape[0] >= 2 ** 31:
        raise ValueError("too many triangles for int32 prim ids")
    if rays.is_cuda and (not rays.is_contiguous() or not tris.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous rays and triangles")


def _lib():
    from ..kernels.build import load

    lib = load(_LIB)
    if not getattr(lib, "_akr_typed", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.akr_dense_closest.argtypes = [
            vp, i64, vp, i32, i32, vp, vp, vp, vp, i32, vp,
        ]
        lib.akr_dense_closest.restype = i32
        lib.akr_dense_anyhit.argtypes = [vp, i64, vp, i32, i32, vp, i32, vp]
        lib.akr_dense_anyhit.restype = i32
        lib._akr_typed = True
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def closest(rays, tris):
    """Closest hit -> (t [N] f32, u [N] f32, v [N] f32, prim [N] int32).

    A miss gives prim -1, t = T_MAX, u = v = 0."""
    _check(rays, tris)
    if not rays.is_cuda:
        return closest_plain(rays, tris)
    n = rays.shape[1]
    dev = rays.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, u, v, prim
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_dense_closest(
        rays.data_ptr(), n, tris.data_ptr(), tris.shape[0], tris.stride(0),
        t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
        dev.index, stream,
    )
    _raise_on(err, "dense closest-hit")
    LAUNCHES["closest"] += 1
    return t, u, v, prim


def any_hit(rays, tris):
    """Any hit in (t_min, t_max) -> [N] bool occluded."""
    _check(rays, tris)
    if not rays.is_cuda:
        return any_hit_plain(rays, tris)
    n = rays.shape[1]
    dev = rays.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().akr_dense_anyhit(
        rays.data_ptr(), n, tris.data_ptr(), tris.shape[0], tris.stride(0),
        occ.data_ptr(), dev.index, stream,
    )
    _raise_on(err, "dense any-hit")
    LAUNCHES["any_hit"] += 1
    return occ
