"""The pixel loss on one device (``akari_tpu/parallel/render.py``).

The reference shards pixels over a device mesh with ``shard_map`` and
``psum``s the loss and the film; its ``render_sharded``, the ``mesh``
argument and the sharded loss arrive with slice 6 (multi-GPU). Here every
pixel is traced on the scene's device, so there are no pad lanes and the
reference's ``valid`` mask is all ones.
"""

from __future__ import annotations

import torch

from ..integrators.path import PathConfig, trace_accumulate


def check_device(tensor, device, what):
    """Raise unless ``tensor`` lies on ``device`` (no silent copies)."""
    if tensor.device != device:
        raise ValueError(f"{what} is on {tensor.device}, the scene on {device}")


def _trace_block(scene, camera, pixel_idx, *, cfg, seed, sample_offset=0):
    """Trace cfg.spp samples for a block of pixels -> [B, 3] mean radiance."""
    if not isinstance(cfg, PathConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the AO and BDPT integrators arrive with slice 4"
        )
    return trace_accumulate(scene, camera, cfg, seed, pixel_idx, sample_offset=sample_offset)


def loss_and_image(scene, camera, cfg, target, seed=0):
    """Mean-squared pixel loss against ``target`` [H, W, 3] and the
    rendered [H, W, 3] image: ``sum((radiance - target)²) / (n·3)``, the
    reference's ``loss_and_image_sharded`` on one device. Differentiable
    with respect to the scene's tensors that require a gradient."""
    check_device(target, scene.device, "the target image")
    n = camera.width * camera.height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=scene.device)
    radiance = _trace_block(scene, camera, pixel_idx, cfg=cfg, seed=seed)
    sq = torch.sum((radiance - target.reshape(-1, 3)) ** 2)
    return sq / (n * 3), radiance.reshape(camera.height, camera.width, 3)
