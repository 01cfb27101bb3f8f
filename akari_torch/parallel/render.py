"""Ray-sharded rendering and the pixel loss (``akari_tpu/parallel/render.py``).

Pixels are sharded over the ranks of a ``RayMesh`` in the reference's
layout: the pixel ids are padded to a multiple of ``mesh.size`` with ids
``n … n+pad-1`` and rank ``r`` traces the contiguous block
``[r·blk, (r+1)·blk)``. Each rank traces its block with ``_trace_block``
(path, BDPT or AO) on its own device; the reference's ``psum``s become
sum all-reduces of a film in which each rank wrote only its own block,
which is exact (x + 0 = x). The scene is replicated on every rank.

Gradients come out as ``jax.grad`` through the reference's ``shard_map``
gives them, with no call after ``backward()``: ``_Replicate`` (identity
forward, all-reduce backward: the transpose of ``in_specs=P()``) wraps the
scene tensors that require a gradient on entry, so each replica's
gradient is the sum over the ranks; the loss's shard sum is an all-reduce
forward and the identity backward (``_ShardSum``); in the loss, the BDPT
splat film, whose rank-``r`` part reaches every rank's pixel block while
each rank's partial loss reads only its own block, all-reduces both ways
(``_SplatSum``).

``loss_and_image`` is the same loss on one device with no pad lanes.
"""

from __future__ import annotations

import torch

from ..integrators.ao import AOConfig, ao_accumulate
from ..integrators.bdpt import BDPTConfig, bdpt_sums
from ..integrators.path import PathConfig, _tensors, trace_accumulate
from ..scene.arrays import map_tensors


def check_device(tensor, device, what):
    """Raise unless ``tensor`` lies on ``device`` (no silent copies)."""
    if tensor.device != device:
        raise ValueError(f"{what} is on {tensor.device}, the scene on {device}")


def _trace_block(scene, camera, pixel_idx, *, cfg, seed, sample_offset=0):
    """Trace cfg.spp samples for a block of pixels -> [B, 3] mean radiance;
    for BDPT ([B, 3] mean radiance, [W*H, 3] mean splat film over the
    whole frame)."""
    if isinstance(cfg, BDPTConfig):
        # pixel ids beyond the film must not splat: the t = 1 estimator is
        # normalized for exactly W*H light subpaths
        lane_mask = pixel_idx < camera.width * camera.height
        acc, spl = bdpt_sums(scene, camera, cfg, seed, pixel_idx,
                             sample_offset=sample_offset, lane_mask=lane_mask)
        return acc / cfg.spp, spl / cfg.spp
    if isinstance(cfg, AOConfig):
        return ao_accumulate(scene, camera, cfg, seed, pixel_idx, sample_offset)
    if not isinstance(cfg, PathConfig):
        raise TypeError(f"integrator config {type(cfg).__name__}")
    return trace_accumulate(scene, camera, cfg, seed, pixel_idx, sample_offset=sample_offset)


def loss_and_image(scene, camera, cfg, target, seed=0):
    """Mean-squared pixel loss against ``target`` [H, W, 3] and the
    rendered [H, W, 3] image: ``sum((radiance - target)²) / (n·3)``, the
    reference's ``loss_and_image_sharded`` on one device (the BDPT image
    is its radiance plus its splat film). Differentiable with respect to
    the scene's tensors that require a gradient."""
    check_device(target, scene.device, "the target image")
    n = camera.width * camera.height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=scene.device)
    radiance = _trace_block(scene, camera, pixel_idx, cfg=cfg, seed=seed)
    if isinstance(cfg, BDPTConfig):
        radiance, spl = radiance
        radiance = radiance + spl
    sq = torch.sum((radiance - target.reshape(-1, 3)) ** 2)
    return sq / (n * 3), radiance.reshape(camera.height, camera.width, 3)


class _Replicate(torch.autograd.Function):
    """Identity forward; backward sums the cotangents over the ranks. One
    node for all the scene's gradient tensors, so every rank makes the
    same one all-reduce (a missing cotangent counts as zeros)."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return (None, *out)


class _ShardSum(torch.autograd.Function):
    """Sum over the ranks forward; identity backward (each rank's partial
    feeds its own sum)."""

    @staticmethod
    def forward(ctx, mesh, t):
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _SplatSum(torch.autograd.Function):
    """Sum over the ranks both ways: every rank's splat film reaches every
    rank's pixels, so its cotangent is the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_reduce(g)


def _replicated(scene, mesh):
    """The scene with its gradient tensors behind ``_Replicate`` (the scene
    itself when nothing requires a gradient or grad mode is off)."""
    if not torch.is_grad_enabled():
        return scene
    ts = list({id(t): t for t in _tensors(scene) if t.requires_grad}.values())
    if not ts:
        return scene
    swap = dict(zip(map(id, ts), _Replicate.apply(mesh, *ts)))
    return map_tensors(scene, lambda t: swap.get(id(t), t))


def _shard(scene, camera, mesh):
    """(n, pad, blk, this rank's pixel ids [blk]) in the reference's layout."""
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, this rank's device is {mesh.device}")
    n = camera.width * camera.height
    pad = (-n) % mesh.size
    blk = (n + pad) // mesh.size
    start = mesh.rank * blk
    return n, pad, blk, torch.arange(start, start + blk, dtype=torch.int64, device=mesh.device)


def render_sharded(scene, camera, cfg, mesh, seed=0, sample_offset=0):
    """Full-frame render with the pixels sharded over the ranks of
    ``mesh`` -> [H, W, 3] on ``mesh.device``, the same image on every
    rank. Every rank of the mesh must call it. Differentiable when every
    rank reduces the image to the same scalar: then ``backward()`` on every
    rank leaves in each replica the gradient of that scalar."""
    n, pad, blk, pixel_idx = _shard(scene, camera, mesh)
    scene = _replicated(scene, mesh)
    out = _trace_block(scene, camera, pixel_idx, cfg=cfg, seed=seed,
                       sample_offset=sample_offset)
    bdpt = isinstance(cfg, BDPTConfig)
    radiance = out[0] if bdpt else out
    lo = mesh.rank * blk
    zeros = radiance.new_zeros((n + pad, 3))
    # one all-reduce: the film (each rank's block, zeros elsewhere) and,
    # for BDPT, the whole-frame splat films
    film = torch.cat([zeros[:lo], radiance, zeros[lo + blk:]] + ([out[1]] if bdpt else []))
    film = _ShardSum.apply(mesh, film)
    img = film[:n]
    if bdpt:  # the reference's order: radiance[:n] + splat
        img = img + film[n + pad:]
    return img.reshape(camera.height, camera.width, 3)


def loss_and_image_sharded(scene, camera, cfg, mesh, target, seed=0):
    """Mean-squared pixel loss against ``target`` [H, W, 3] with the pixels
    sharded over ``mesh``, and the rendered [H, W, 3] image; both the same
    on every rank. ``total / (n·3)`` masks the pad lanes with the
    reference's ``valid``; a BDPT rank adds its block of the reduced splat
    film to its radiance. ``backward()`` on every rank leaves in each
    replica the gradient summed over the ranks."""
    check_device(target, mesh.device, "the target image")
    n, pad, blk, pixel_idx = _shard(scene, camera, mesh)
    scene = _replicated(scene, mesh)
    lo = mesh.rank * blk
    target_px = target.reshape(-1, 3)[lo:lo + blk]
    valid = (pixel_idx < n).to(torch.float32)[:, None]
    if target_px.shape[0] < blk:  # the pad lanes' target is 0, as the reference pads
        target_px = torch.cat([target_px, target_px.new_zeros((blk - target_px.shape[0], 3))])
    out = _trace_block(scene, camera, pixel_idx, cfg=cfg, seed=seed)
    if isinstance(cfg, BDPTConfig):
        radiance, spl = out
        spl = _SplatSum.apply(mesh, spl)
        if pad:
            spl = torch.cat([spl, spl.new_zeros((pad, 3))])
        radiance = radiance + spl[lo:lo + blk]
    else:
        radiance = out
    sq = torch.sum(((radiance - target_px) * valid) ** 2)
    # one all-reduce carries the loss's partial sum and the image film
    film = torch.zeros(((n + pad) * 3,), dtype=radiance.dtype, device=mesh.device)
    buf = torch.cat([sq[None], film[:lo * 3], radiance.reshape(-1), film[(lo + blk) * 3:]])
    buf = _ShardSum.apply(mesh, buf)
    img = buf[1:1 + n * 3].reshape(camera.height, camera.width, 3)
    return buf[0] / (n * 3), img
