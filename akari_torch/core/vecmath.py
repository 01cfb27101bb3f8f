"""Vector math over ``[..., 3]`` tensors: the pieces of
``akari_tpu/core/vecmath.py`` the port uses outside the V3 hot loop
(per-light tables built once per trace)."""

from __future__ import annotations

import torch


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )

