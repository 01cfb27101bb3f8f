"""Ambient-occlusion integrator (``akari_tpu/integrators/ao.py``): the
primary hit, one cosine-sampled occlusion ray about the shading normal
(flipped into the hemisphere the camera sees), white if unoccluded and
black on a miss. One closest-hit and one any-hit query per sample, through
the scene's intersector (its kernels on CUDA tensors)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import sampling
from ..core import rng
from ..core.vecmath import abs_, dot, maximum, to_world
from ..shading import bsdf as bsdf_mod
from .path import RAY_EPS, _intersectors, _surface_data, camera_rays


@dataclass(frozen=True)
class AOConfig:
    spp: int = 16
    occlude_distance: float = 1e30  # the occlusion rays' t_max


def trace_ao(scene, camera, cfg, seed, sample_idx, pixel_idx, intersect_fn, occlude_fn):
    """One AO sample for each pixel -> [N, 3] (1 lit, 0 occluded or missed)."""
    o, d = camera_rays(camera, seed, sample_idx, pixel_idx)
    n = o.shape[0]
    _, prim, bary, valid = intersect_fn(o, d)
    p, ng, ns, _, _ = _surface_data(scene, prim, bary)
    u = rng.uniform2(seed, pixel_idx, sample_idx, rng.bounce_dim(0, rng.OFF_BSDF_U))
    w_local = sampling.cosine_hemisphere(u)
    w = to_world(*bsdf_mod.make_frame(ns), w_local)
    # flip into the hemisphere the camera sees
    w = torch.where((dot(w, ng) * dot(-d, ng) < 0.0)[..., None], -w, w)
    o2 = p + w * (RAY_EPS / maximum(abs_(dot(ng, w)), 1e-4))[..., None]
    occluded = occlude_fn(
        o2, w, torch.zeros((n,), dtype=torch.float32, device=o.device),
        torch.full((n,), cfg.occlude_distance, dtype=torch.float32, device=o.device),
    )
    lit = valid & ~occluded
    L = torch.where(lit[..., None], torch.ones((n, 3), dtype=torch.float32, device=o.device), 0.0)
    # a miss is the background (black)
    return torch.where(valid[..., None], L, 0.0)


def ao_accumulate(scene, camera, cfg, seed, pixel_idx, sample_offset=0):
    """Mean AO over cfg.spp samples for pixel ids [B] -> [B, 3]."""
    intersect_fn, occlude_fn = _intersectors(scene)
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32, device=pixel_idx.device)
    for s in range(cfg.spp):
        acc = acc + trace_ao(scene, camera, cfg, seed, s + sample_offset, pixel_idx,
                             intersect_fn, occlude_fn)
    return acc / cfg.spp


def render_ao(scene, camera, cfg, seed=0):
    """Full-frame AO render on the scene's device -> [H, W, 3]."""
    n = camera.width * camera.height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=scene.device)
    return ao_accumulate(scene, camera, cfg, seed, pixel_idx).reshape(
        camera.height, camera.width, 3)
