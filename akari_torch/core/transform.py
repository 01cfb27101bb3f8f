"""Affine transforms as 4x4 float32 NumPy matrices (host-side, scene build).

Counterpart of ``akari_tpu/core/transform.py``: a transform is a ``[4,4]``
array, composition is ``a @ b``, normals use the inverse-transpose of the
3x3 block. Transforms are applied on the host at compile time, so NumPy is
the natural type here.
"""

from __future__ import annotations

import numpy as np


def identity():
    return np.eye(4, dtype=np.float32)


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, dtype=np.float32)
    return m


def scale(v):
    v = np.broadcast_to(np.asarray(v, dtype=np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def _rot(axis_fn, theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    axis_fn(m, np.float32(c), np.float32(s))
    return m


def rotate_x(theta):
    def f(m, c, s):
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return _rot(f, theta)


def rotate_y(theta):
    def f(m, c, s):
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return _rot(f, theta)


def rotate_z(theta):
    def f(m, c, s):
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return _rot(f, theta)


def euler_zyx(rotation_xyz):
    """Rotation from Euler angles applied Z, then Y, then X."""
    rx, ry, rz = [float(a) for a in rotation_xyz]
    return rotate_z(rz) @ rotate_y(ry) @ rotate_x(rx)


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world for a right-handed camera looking down -Z."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd  # camera looks down local -Z
    m[:3, 3] = eye
    return m


def apply_point(m, p):
    """Apply to ``[..., 3]`` points (translation included)."""
    return p @ np.asarray(m[:3, :3]).T + np.asarray(m[:3, 3])


def inverse(m):
    return np.linalg.inv(m).astype(np.float32)


def apply_vector(m, v):
    """Apply to ``[..., 3]`` vectors (no translation)."""
    return v @ np.asarray(m[:3, :3]).T


def apply_normal(m, n):
    """Apply to normals: inverse-transpose of the linear part."""
    it = np.linalg.inv(np.asarray(m[:3, :3], dtype=np.float32)).T
    return n @ it.T
