"""Component-SoA 3-vectors: a V3 is three separate ``[N]`` tensors.

The port keeps the reference's V3 layout (``akari_tpu/core/v3.py``) for
the whole package. On the TPU it avoided lane padding of ``[N, 3]``
temporaries; on the card either layout is fine, and keeping V3 makes every
shading and integrator function a line-for-line counterpart of the
reference with the same floating-point operation order, which is what the
parity tests hold it to.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .vecmath import maximum


class V3(NamedTuple):
    """Three parallel [N] components. Also used for RGB (x=r, y=g, z=b)."""

    x: Any
    y: Any
    z: Any

    # -- elementwise arithmetic (V3 op V3, or V3 op [N]/scalar) ------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- reductions ---------------------------------------------------------
    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def max_comp(self):
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def norm2(self):
        return self.dot(self)

    def normalized(self, eps=0.0):
        n2 = self.norm2()
        if eps > 0.0:
            inv = torch.where(
                n2 > eps, 1.0 / torch.sqrt(maximum(n2, eps)), 0.0
            )
        else:
            inv = 1.0 / torch.sqrt(n2)
        return self * inv

    # -- boundary conversions ------------------------------------------------
    def astype(self, dtype):
        """Components cast to ``dtype`` (no copy where they have it)."""
        return V3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))

    def stack(self):
        """-> [N, 3] (film/API boundary only; never inside the hot loop)."""
        return torch.stack(
            torch.broadcast_tensors(self.x, self.y, self.z), dim=-1
        )


def v3where(m, a, b):
    """Per-lane select with an [N] mask; a/b may be V3 or scalars."""
    if not isinstance(a, V3):
        a = V3(a, a, a)
    if not isinstance(b, V3):
        b = V3(b, b, b)
    return V3(
        torch.where(m, a.x, b.x),
        torch.where(m, a.y, b.y),
        torch.where(m, a.z, b.z),
    )


def from_rows(arr, row0=0):
    """[C, N] gathered row block -> V3 of three consecutive rows."""
    return V3(arr[row0], arr[row0 + 1], arr[row0 + 2])


def from_stack(arr):
    """[N, 3] -> V3 of its columns."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def reflect3(w, n):
    """Mirror w about n (both away from surface): -w + 2*dot(w,n)*n."""
    return -w + n * (2.0 * w.dot(n))


def onb3(n):
    """Branchless Duff/Pixar orthonormal basis about unit normal n."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = V3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def to_local3(t, b, n, w):
    return V3(w.dot(t), w.dot(b), w.dot(n))


def to_world3(t, b, n, w):
    return t * w.x + b * w.y + n * w.z
