"""Film: radiance + weight accumulation planes (``akari_tpu/core/film.py``).

A frame's samples come as a ``[S, H, W, 3]`` batch (or a progressive
render's chunks), so accumulation is a sum over the sample axis. The
planes are NumPy arrays or torch tensors; each function keeps the kind
it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import target_device
from .spectrum import to_uint8_srgb


@dataclass
class Film:
    """Host- or device-side accumulation state."""

    radiance: object  # [H, W, 3] float32
    weight: object    # [H, W] float32

    @staticmethod
    def zeros(height, width, xp=np, device="cuda"):
        """Zero planes; ``xp`` is ``numpy`` or ``torch`` (then on
        ``device``, ``"cuda"`` unless the caller asks for another; no
        fallback)."""
        kw = {} if xp is np else {"device": target_device(device, "Film.zeros")}
        return Film(
            radiance=xp.zeros((height, width, 3), dtype=xp.float32, **kw),
            weight=xp.zeros((height, width), dtype=xp.float32, **kw),
        )

    def add(self, radiance, weight):
        return Film(self.radiance + radiance, self.weight + weight)

    def develop(self):
        """Normalize to a [H, W, 3] linear image."""
        xp = torch if isinstance(self.radiance, torch.Tensor) else np
        w = xp.where(self.weight > 0.0, self.weight, 1.0)[..., None]
        return self.radiance / w

    def to_srgb_u8(self):
        img = self.develop()
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        return to_uint8_srgb(np.asarray(img))


def accumulate_samples(sample_radiance):
    """[S, H, W, 3] per-sample radiance -> (radiance [H, W, 3], weight [H, W])."""
    s = sample_radiance.shape[0]
    if isinstance(sample_radiance, torch.Tensor):
        radiance = torch.sum(sample_radiance, dim=0)
        weight = torch.full(tuple(sample_radiance.shape[1:3]), float(s),
                            dtype=torch.float32, device=sample_radiance.device)
        return radiance, weight
    radiance = np.sum(sample_radiance, axis=0)
    weight = np.full(sample_radiance.shape[1:3], float(s), dtype=np.float32)
    return radiance, weight
