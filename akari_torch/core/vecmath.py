"""Vector math over ``[..., 3]`` tensors (``akari_tpu/core/vecmath.py``):
the AoS helpers of the per-light tables and of the BDPT and AO
integrators (frames, Z-up local space), and the clamps with the
reference's gradient rules."""

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


def length(a, keepdim=False):
    return torch.sqrt(dot(a, a, keepdim=keepdim))


def normalize(a, eps=0.0):
    """Normalize; with eps > 0 guards against zero vectors (returns 0)."""
    n2 = dot(a, a, keepdim=True)
    if eps > 0.0:
        inv = torch.where(n2 > eps, 1.0 / torch.sqrt(maximum(n2, eps)), 0.0)
        return a * inv
    return a / torch.sqrt(n2)


def onb(n):
    """Branchless Duff / Pixar orthonormal basis (t, b) about unit normal n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_local(t, b, n, w):
    """World direction -> local Z-up shading space."""
    return torch.stack([dot(w, t), dot(w, b), dot(w, n)], dim=-1)


def to_world(t, b, n, w):
    """Local Z-up shading space -> world."""
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


# ------------- clamps and abs with the reference's gradient rules -------------
#
# The JAX package writes its kinks as jnp.clip / jnp.maximum / jnp.minimum /
# jnp.abs, whose derivatives differ from torch.clamp's and torch.abs's at
# the kink: jnp.maximum(x, a) passes 1/2 of the gradient to x where x == a
# (torch.clamp all of it, or none), jnp.clip = minimum(maximum(x, lo), hi)
# 1/2 at either bound, and jnp.abs passes +g at x = +-0 (torch.abs 0). These
# helpers compute torch.clamp's / torch.abs's forward, bit for bit and in
# one kernel, and JAX's gradient, through an autograd Function only when a
# gradient is being recorded. Bounds are Python floats: no device tensor is
# made for them.


def _recording(x):
    return torch.is_grad_enabled() and x.requires_grad


def _balanced(x, bound, inside):
    """d jnp.maximum(x, bound) / dx (``inside`` = x > bound) or d
    jnp.minimum(x, bound) / dx (``inside`` = x < bound): 1 inside, 1/2 at
    the bound, 0 outside and on NaN (lax's balanced-eq rule)."""
    return torch.where(inside, 1.0, torch.where(x == bound, 0.5, 0.0))


class _Clip(torch.autograd.Function):
    """torch.clamp(x, lo, hi) forward; the cotangent of jnp.clip(x, lo, hi)
    = minimum(maximum(x, lo), hi) backward, multiplied in JAX's order (the
    outer minimum's factor first). Either bound may be None."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        m = x if lo is None else torch.clamp(x, min=lo)
        if hi is not None:
            g = g * _balanced(m, hi, m < hi)
        if lo is not None:
            g = g * _balanced(x, lo, x > lo)
        # the float32 factors are 1, 1/2 or 0: exact in x's dtype too
        return g.to(x.dtype), None, None


class _Abs(torch.autograd.Function):
    """torch.abs forward (+0.0 for -0.0); jnp.abs's derivative backward:
    select(x >= 0, g, -g), so +g at x = +-0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` for float bounds ``lo`` < ``hi``."""
    return _Clip.apply(x, lo, hi) if _recording(x) else torch.clamp(x, lo, hi)


def maximum(x, a):
    """``jnp.maximum(x, a)`` for a float bound ``a``."""
    return _Clip.apply(x, a, None) if _recording(x) else torch.clamp(x, min=a)


def minimum(x, a):
    """``jnp.minimum(x, a)`` for a float bound ``a``."""
    return _Clip.apply(x, None, a) if _recording(x) else torch.clamp(x, max=a)


def abs_(x):
    """``jnp.abs(x)``."""
    return _Abs.apply(x) if _recording(x) else torch.abs(x)
