"""LittleCMS 2.17's 8-bit Lab -> sRGB transform, without LittleCMS.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``). Pillow 12.1 converts a
``LAB`` image to RGB through ``ImageCms.buildTransform(lab, srgb, "LAB",
"RGB")``: LittleCMS 2.17, the perceptual intent, no flags, from
``cmsCreateLab2Profile(NULL)`` (the v2 Lab identity profile, D50) to
``cmsCreate_sRGBProfile()`` (the built-in v4 matrix-shaper), with 8-bit
Lab v2 in (Pillow's ``LAB`` layout: L, a + 128, b + 128, and a fourth byte
skipped) and 8-bit RGBA out. ``lab8_to_rgb8`` returns the same bytes; the
transform is computed here from the profiles' definitions, as LittleCMS
computes it:

- the sRGB profile: the Rec. 709 primaries and the D65 white (0.3127,
  0.3290) give the RGB -> XYZ matrix of ``_cmsBuildRGB2XYZtransferMatrix``,
  adapted to D50 (0.9642, 1.0, 0.8249) by Bradford, every product and sum
  in LittleCMS's order (its cofactor ``_cmsMAT3inverse``, ``_cmsMAT3per``,
  ``_cmsMAT3eval``); the curves are the parametric type 4 (2.4, 1/1.055,
  0.055/1.055, 1/12.92, 0.04045), inverted analytically (type -4);
- the pipeline after ``PreOptimize``: the Lab profile's v4 -> v2 -> v4
  encoding stages and its identity CLUT cancel, leaving Lab (v4 16-bit
  encoding) -> XYZ (``cmsLab2XYZ``, D50) / (1 + 32767/32768), the inverse
  colorant matrix times (1 + 32767/32768), the inverse curves. Black point
  compensation, which LittleCMS forces for a v4 profile at the perceptual
  intent, adds no stage: the Lab profile is abstract (black 0) and the
  sRGB black maps to 0, so the layer is empty. Every stage hands float32
  to the next and computes inside in float64;
- the optimisation (``OptimizeByResampling``): the pipeline sampled at the
  nodes of a 33^3 grid (``_cmsReasonableGridpointsByColorspace`` for three
  channels), node k of an axis at ``_cmsQuantizeVal(k, 33)``, each output
  ``_cmsQuickSaturateWord(v * 65535)`` (its rounding to 2^-16 before the
  floor included). The white fix-up does not apply: Lab white (0xFFFF,
  0x8080, 0x8080) is not on a node, so ``PatchLUT`` declines, and white
  (L* 100) reads (254, 255, 254);
- per pixel, the 8-bit input expanded v * 257 and ``TetrahedralInterp16``
  on the table, then ``FROM_16_TO_8``: ``akari_torch/native/lcms_lab.cpp``.

These facts were settled by driving Pillow's bundled ``liblcms2`` through
ctypes with the same profiles and intent: the default transform equals
``cmsFLAGS_GRIDPOINTS(33)`` on all 2^24 inputs, and 17, 31, 32, 34 and 65
points differ; ``cmsFLAGS_NOWHITEONWHITEFIXUP`` changes nothing;
``cmsFLAGS_NOOPTIMIZE`` changes 5,056,196 of them; ``TYPE_RGB_8`` and
``TYPE_RGBA_8`` output equal; its unoptimised 16-bit transform
(``cmsFLAGS_NOOPTIMIZE``) at the node inputs gives this module's table
exactly (the optimised 16-bit transform does not: it differs at some
nodes); and the colorant and chromatic adaptation tags it reads back equal
the matrices computed here bit for bit. The
table is computed once and cached; no table of LittleCMS's output is
stored.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np

GRID = 33
D50 = (0.9642, 1.0, 0.8249)
D65_XY = (0.3127, 0.3290)
REC709_XY = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)  # parametric type 4
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0

_lock = threading.Lock()
_table = []


def _inverse(a):
    """``_cmsMAT3inverse``: cofactors over the determinant, in its order."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return (
        (c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
         (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
        (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
         (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
        (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
         (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det),
    )


def _per(a, b):
    """``_cmsMAT3per``: the product a b."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
                       for j in range(3)) for i in range(3))


def _eval(a, v):
    """``_cmsMAT3eval``: the product a v."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3))


def adaptation(src, dst):
    """``_cmsAdaptationMatrix`` by Bradford from the white ``src`` to ``dst``
    (XYZ)."""
    inv = _inverse(BRADFORD)
    cs, cd = _eval(BRADFORD, src), _eval(BRADFORD, dst)
    cone = ((cd[0] / cs[0], 0.0, 0.0), (0.0, cd[1] / cs[1], 0.0), (0.0, 0.0, cd[2] / cs[2]))
    return _per(inv, _per(cone, BRADFORD))


def srgb_colorants():
    """The sRGB profile's RGB -> XYZ (D50) matrix, its colorant tags as
    columns (``cmsCreateRGBProfile`` on ``_cmsBuildRGB2XYZtransferMatrix``)."""
    xn, yn = D65_XY
    (xr, yr), (xg, yg), (xb, yb) = REC709_XY
    coef = _eval(_inverse(((xr, xg, xb), (yr, yg, yb), ((1 - xr - yr), (1 - xg - yg),
                                                           (1 - xb - yb)))),
                 (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    m = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
         (coef[0] * yr, coef[1] * yg, coef[2] * yb),
         (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)))
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)  # cmsxyY2XYZ, Y = 1
    return _per(adaptation(white, D50), m)


def _saturate_word(d):
    """``_cmsQuickSaturateWord``: d + 0.5 rounded to a multiple of 2^-16
    (LittleCMS's magic-number floor), floored and clamped to 0..65535."""
    d = np.asarray(d, np.float64) + 0.5
    fixed = ((d - 32767.0) + 68719476736.0 * 1.5).view(np.int64)
    floor = ((fixed & 0xFFFFFFFF).astype(np.uint32).view(np.int32) >> 16).astype(np.int64)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor + 32767))


def _inverse_curve(r):
    """The parametric type -4 curve (LittleCMS's analytic inverse of the
    sRGB type 4), in float64 with the C library's ``pow``."""
    g, a, b, c, d = SRGB_CURVE
    e = a * d + b
    disc = math.pow(e, g) if e >= 0 else 0.0
    return [(math.pow(v, 1.0 / g) - b) / a if v >= disc else v / c for v in r]


def clut():
    """The [33, 33, 33, 3] uint16 table LittleCMS samples (L slowest, then
    a, then b), computed once."""
    with _lock:
        if _table:
            return _table[0]
        q = _saturate_word(np.arange(GRID, dtype=np.float64) * 65535.0 / (GRID - 1))
        nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
        x = (nodes / 65535.0).astype(np.float32).astype(np.float64)
        # Lab2XYZ stage: v4 encoding, cmsLab2XYZ against D50, / MAX_ENCODEABLE_XYZ
        lab_l, lab_a, lab_b = x[:, 0] * 100.0, x[:, 1] * 255.0 - 128.0, x[:, 2] * 255.0 - 128.0
        fy = (lab_l + 16.0) / 116.0
        f = np.stack([fy + 0.002 * lab_a, fy, fy - 0.005 * lab_b], -1)
        f_1 = np.where(f <= 24.0 / 116.0, (108.0 / 841.0) * (f - (16.0 / 116.0)), f * f * f)
        xyz = ((f_1 * np.array(D50)) / MAX_ENCODEABLE_XYZ).astype(np.float32).astype(np.float64)
        # matrix stage: the inverse colorant matrix times MAX_ENCODEABLE_XYZ
        inv = [[v * MAX_ENCODEABLE_XYZ for v in row] for row in _inverse(srgb_colorants())]
        lin = np.empty_like(xyz)
        for i in range(3):
            acc = np.zeros(len(xyz))
            for j in range(3):
                acc = acc + xyz[:, j] * inv[i][j]
            lin[:, i] = acc
        lin = lin.astype(np.float32).astype(np.float64)
        # curve stage, then the sampler's float -> 16 bits
        rgb = np.array(_inverse_curve(lin.ravel().tolist())).astype(np.float32)
        table = _saturate_word(rgb.astype(np.float64) * 65535.0).astype(np.uint16)
        _table.append(np.ascontiguousarray(table.reshape(GRID, GRID, GRID, 3)))
        return _table[0]


def lab8_to_rgb8(lab):
    """uint8 [..., 3] in PIL's LAB layout (L, a + 128, b + 128) -> uint8
    [..., 3] sRGB, the bytes of PIL's ``convert("RGB")``."""
    from ..native.loader import load

    lab = np.ascontiguousarray(lab, np.uint8)
    if lab.shape[-1:] != (3,):
        raise ValueError(f"expected [..., 3] Lab bytes, got shape {lab.shape}")
    table = clut()
    rgb = np.empty(lab.shape, np.uint8)
    load("lcms").akr_lab8_to_rgb8(table.ctypes.data_as(ctypes.c_void_p),
                                  lab.ctypes.data_as(ctypes.c_void_p), lab.size // 3,
                                  rgb.ctypes.data_as(ctypes.c_void_p))
    return rgb
