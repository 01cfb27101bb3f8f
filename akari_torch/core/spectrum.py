"""RGB spectrum helpers (``akari_tpu/core/spectrum.py``), host-side."""

from __future__ import annotations

import numpy as np

_LUMA = np.asarray([0.2126, 0.7152, 0.0722], dtype=np.float32)


def luminance(rgb):
    """Host-side (NumPy) luminance of [..., 3] linear RGB."""
    return np.sum(np.asarray(rgb, np.float32) * _LUMA, axis=-1)


def linear_to_srgb(c):
    """Host-side (NumPy) sRGB transfer curve on linear values."""
    c = np.clip(c, 0.0, 1.0)
    return np.where(
        c < 0.0031308,
        12.92 * c,
        1.055 * np.power(np.maximum(c, 1e-8), 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(c):
    """Host-side (NumPy) inverse sRGB transfer curve."""
    return np.where(
        c < 0.04045,
        c / 12.92,
        np.power(np.maximum((c + 0.055) / 1.055, 1e-8), 2.4),
    )


def to_uint8_srgb(img_linear):
    """[H,W,3] linear float -> uint8 sRGB (host-side, numpy)."""
    img = np.asarray(img_linear, dtype=np.float32)
    srgb = linear_to_srgb(img)
    return (np.clip(srgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
