"""Write ``akari_torch/native/av1_tables.h``: the AV1 tables intra and inter
frames read, found in the ``libavif`` that Pillow bundles (it links dav1d
1.5.1 to decode and aom 3.12.1 to encode, so the library holds both
projects' copies of the default tables).

- every default CDF of a key frame's mode info and coefficients, from
  dav1d's ``CdfModeContext`` / ``CdfCoefContext`` (one of each, four of the
  second, one per coefficient qindex context) and its key-frame y-mode
  table; the values are stored inverted (32768 - cdf) as dav1d and aom
  store them, the slot after a CDF's last value is its adaptation counter;
- ``Dc_Qlookup`` / ``Ac_Qlookup`` for 8 bits (aom's) and for 10 and 12
  (dav1d's ``dq_tbl``, checked against aom's), the superres
  ``Upscale_Filter`` (aom's, checked against dav1d's), ``Sm_Weights``
  (dav1d's ``dav1d_sm_weights``), ``Dr_Intra_Derivative`` and
  ``Mode_To_Angle`` (aom's), the filter-intra taps (aom's) and the
  coefficient-context offsets of the three block shapes (dav1d's
  ``dav1d_lo_ctx_offsets``);
- the loop-restoration tables: the ``restoration_type`` / ``use_wiener`` /
  ``use_sgrproj`` CDFs (dav1d's ``CdfModeContext``), the self-guided
  parameter sets (dav1d's ``dav1d_sgr_params``, checked against aom's
  ``av1_sgr_params`` with their radii) and dav1d's ``dav1d_sgr_x_by_x``
  (checked against aom's ``av1_x_by_xplus1``: 256 - x but at the ends);
- the quantizer matrices of levels 0-14, luma and chroma, every transform
  size up to 32 in the specification's order (aom's ``iwt_matrix_ref``, the
  specification's ``Quantizer_Matrix``; its squares checked against dav1d's
  triangular 32x32 tables, expanded and subsampled as dav1d's
  ``dav1d_init_qm_tables`` does);
- the film-grain Gaussian sequence (dav1d's ``dav1d_gaussian_sequence``,
  2,048 values; the library holds no second copy);
- the inter frames' CDFs (dav1d's ``CdfModeContext`` after its intra part:
  y modes by size, wedge indices, compound modes, filters, inter-intra,
  motion modes, the mode and reference flags, OBMC; its ``CdfMvContext``
  fractional and high-precision parts), checked against aom's copies where
  their rows lie alike;
- the sub-pixel filters (aom's six sets, checked against dav1d's halved
  ones), the warp filter (aom's, checked against dav1d's), the warp
  divisor table and the projection's ``Div_Mult`` (each aom's and
  dav1d's), the OBMC masks (aom's, checked against dav1d's 64 - m), the
  three wedge codebooks and master lines (aom's, checked against dav1d's
  copies), the inter-intra weights and the distance weights (aom's, the
  lookup checked against dav1d's).

Each table is found by anchors: a group of dav1d's tables by the first row
of one of them (the others lie at fixed places in the same structure, and
every row read is checked to be a CDF of the expected number of symbols),
aom's and dav1d's other copies by their first entries. Where both projects
hold a table, the two copies are compared, through dav1d's index order
where it differs (block sizes from 128x128 down; ``eob_hi_bit`` two
contexts on).

    python tools/extract_av1_tables.py [--check]

``--check`` compares the committed header with the library instead of
writing it. ``tables()`` returns the tables as numpy arrays.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "akari_torch", "native", "av1_tables.h")

# dav1d's CdfModeContext, anchored by its first table (uv_mode without CfL,
# DC_PRED's row: Default_Uv_Mode_Cfl_Not_Allowed_Cdf[0] inverted, four zeros)
MODE_ANCHOR = (10137, 8616, 7390, 7107, 6782, 6248, 5713, 4845, 4524, 2709, 1827, 807, 0, 0, 0, 0)
# dav1d's CdfCoefContext for qindex context 0 and 1 (their eob_bin_16 rows)
COEF_ANCHOR = (31928, 31729, 30788, 27873, 0, 0, 0, 0, 32398, 32097, 30885, 28297)
COEF_ANCHOR1 = (30643, 30217, 27603, 23822, 0, 0, 0, 0, 32255, 32003, 30909, 26429)
# dav1d's key-frame y-mode table (its first row, four zeros)
KF_ANCHOR = (17180, 15741, 13430, 12550, 12086, 11658, 10943, 9524, 8579, 4603, 3675, 2302,
             0, 0, 0, 0)

# spec block-size order -> dav1d's (BS_128x128 first, BS_4x4 last)
SPEC_BSIZES = ("4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16", "16x32", "32x16",
               "32x32", "32x64", "64x32", "64x64", "64x128", "128x64", "128x128", "4x16",
               "16x4", "8x32", "32x8", "16x64", "64x16")
DAV1D_BSIZES = ("128x128", "128x64", "64x128", "64x64", "64x32", "64x16", "32x64", "32x32",
                "32x16", "32x8", "16x64", "16x32", "16x16", "16x8", "16x4", "8x32", "8x16",
                "8x8", "8x4", "4x16", "4x8", "4x4")

# CDF tables: name -> (shape, symbols, stride in the header, place in dav1d's
# mode structure (byte offset from MODE_ANCHOR's row), dav1d's row stride)
MODE_CDFS = {
    "uv_mode_cfl_not_allowed": ((13,), 13, 16, 0x000, 16),
    "uv_mode_cfl_allowed": ((13,), 14, 16, 0x1A0, 16),
    "partition128": ((4,), 8, 8, 0x340, 16),
    "partition64": ((4,), 10, 16, 0x3C0, 16),
    "partition32": ((4,), 10, 16, 0x440, 16),
    "partition16": ((4,), 10, 16, 0x4C0, 16),
    "partition8": ((4,), 4, 4, 0x540, 16),
    "cfl_alpha": ((6,), 16, 16, 0x5C0, 16),
    "intra_tx_set1": ((2, 13), 7, 8, 0x6E0, 8),
    "intra_tx_set2": ((3, 13), 5, 8, 0x880, 8),
    "cfl_sign": ((), 8, 8, 0xAF0, 8),
    "angle_delta": ((8,), 7, 8, 0xB00, 8),
    "filter_intra_mode": ((), 5, 8, 0xB80, 8),
    "palette_y_size": ((7,), 7, 8, 0xBC0, 8),
    "palette_uv_size": ((7,), 7, 8, 0xC30, 8),
    "palette_y_color": ((7, 5), None, 8, 0xCA0, 8),   # 2 + the first index symbols
    "palette_uv_color": ((7, 5), None, 8, 0xED0, 8),
    "tx_size8": ((3,), 2, 4, 0x1100, 4),
    "tx_size16": ((3,), 3, 4, 0x1118, 4),
    "tx_size32": ((3,), 3, 4, 0x1130, 4),
    "tx_size64": ((3,), 3, 4, 0x1148, 4),
    "use_filter_intra": ((22,), 2, 2, 0x11B0, 2),     # dav1d's block-size order
    "skip": ((3,), 2, 2, 0x125C, 2),
    "palette_y_mode": ((7, 3), 2, 2, 0x1268, 2),
    "palette_uv_mode": ((2,), 2, 2, 0x12BC, 2),
    "restoration_type": ((), 3, 4, 0x1190, 4),        # switchable: none, Wiener, self-guided
    "use_wiener": ((), 2, 2, 0x1198, 2),
    "use_sgrproj": ((), 2, 2, 0x119C, 2),
    # segmentation, delta q / lf, intra block copy and its transforms
    "seg_id": ((3,), 8, 8, 0xB90, 8),
    "delta_q": ((), 4, 4, 0x1160, 4),
    "delta_lf": ((5,), 4, 4, 0x1168, 4),              # single, then multi (4)
    "inter_tx_set1": ((2,), 16, 16, 0x680, 16),
    "inter_tx_set2": ((), 12, 16, 0x6C0, 16),
    "inter_tx_set3": ((4,), 2, 2, 0x11A0, 2),
    "txfm_split": ((7, 3), 2, 2, 0x1208, 2),          # the specification's 21 contexts
    "intrabc": ((), 2, 2, 0x12C4, 2),
    # inter frames: the mode info of inter and intra blocks
    "y_mode": ((4,), 13, 16, 0x12E0, 16),
    "wedge_index": ((9,), 16, 16, 0x1360, 16),
    "compound_mode": ((8,), 8, 8, 0x1480, 8),
    "interp_filter": ((2, 8), 3, 4, 0x1500, 4),       # [dir][ctx & 7]
    "interintra_mode": ((4,), 4, 4, 0x1580, 4),
    "motion_mode": ((22,), 3, 4, 0x15A0, 4),          # dav1d's block-size order
    "skip_mode": ((3,), 2, 2, 0x1650, 2),
    "new_mv": ((6,), 2, 2, 0x165C, 2),
    "zero_mv": ((2,), 2, 2, 0x1674, 2),
    "ref_mv": ((6,), 2, 2, 0x167C, 2),
    "drl_mode": ((3,), 2, 2, 0x1694, 2),
    "is_inter": ((4,), 2, 2, 0x16A0, 2),
    "comp_mode": ((5,), 2, 2, 0x16B0, 2),
    "comp_ref_type": ((5,), 2, 2, 0x16C4, 2),
    "compound_idx": ((6,), 2, 2, 0x16D8, 2),
    "comp_group_idx": ((6,), 2, 2, 0x16F0, 2),
    "compound_type": ((9,), 2, 2, 0x1708, 2),         # the nine wedge sizes
    "single_ref": ((6, 3), 2, 2, 0x172C, 2),          # [p1..p6][ctx]
    "comp_ref": ((3, 3), 2, 2, 0x1774, 2),            # [comp_ref, p1, p2][ctx]
    "comp_bwd_ref": ((2, 3), 2, 2, 0x1798, 2),        # [comp_bwdref, p1][ctx]
    "uni_comp_ref": ((3, 3), 2, 2, 0x17B0, 2),        # [uni_comp_ref, p1, p2][ctx]
    "seg_id_predicted": ((3,), 2, 2, 0x17D4, 2),
    "interintra": ((4,), 2, 2, 0x17E0, 2),            # by size group
    "wedge_interintra": ((7,), 2, 2, 0x17FC, 2),      # 8x8 .. 32x32
    "use_obmc": ((22,), 2, 2, 0x1818, 2),             # dav1d's block-size order
}
# block sizes (dav1d's names) that read no motion mode: their rows are zero
NO_MOTION_MODE = ("16x4", "8x4", "4x16", "4x8", "4x4")
# dav1d's default_mv_component_cdf (its classes row, then sign and class0
# inverted: 128 * 128 and 216 * 128) and default_mv_joint_cdf, the CDFs of
# an intra block copy's vector: name -> (shape, symbols, stride, byte
# offset in the component, dav1d's stride)
MV_ANCHOR = (4096, 1792, 910, 448, 217, 112, 28, 11, 6, 1, 0, 0, 0, 0, 0, 0, 16384, 0, 5120, 0)
MV_JOINT_ANCHOR = (28672, 21504, 13440, 0)
MV_CDFS = {
    "mv_classes": ((), 11, 16, 0x00, 16),
    "mv_sign": ((), 2, 2, 0x20, 2),
    "mv_class0": ((), 2, 2, 0x24, 2),
    "mv_bits": ((10,), 2, 2, 0x3C, 2),
    "mv_class0_fr": ((2,), 4, 4, 0x28, 4),
    "mv_class0_hp": ((), 2, 2, 0x38, 2),
    "mv_fr": ((), 4, 4, 0x68, 4),
    "mv_hp": ((), 2, 2, 0x70, 2),
}
# CdfCoefContext tables: name -> (shape within one qindex context, symbols,
# stride, byte offset in the structure, dav1d's stride, dav1d's shape)
COEF_CDFS = {
    "eob_pt16": ((2, 2), 5, 8, 0x000, 8, None),
    "eob_pt32": ((2, 2), 6, 8, 0x040, 8, None),
    "eob_pt64": ((2, 2), 7, 8, 0x080, 8, None),
    "eob_pt128": ((2, 2), 8, 8, 0x0C0, 8, None),
    "eob_pt256": ((2, 2), 9, 16, 0x100, 16, None),
    "eob_pt512": ((2,), 10, 16, 0x180, 16, None),
    "eob_pt1024": ((2,), 11, 16, 0x1C0, 16, None),
    "coeff_base_eob": ((5, 2, 4), 3, 4, 0x200, 4, None),
    "coeff_base": ((5, 2, 41), 4, 4, 0x340, 4, None),   # context 41 never occurs
    "coeff_br": ((4, 2, 21), 4, 4, 0x1010, 4, None),    # read at min(tx size, 32x32)
    "eob_extra": ((5, 2, 9), 2, 2, 0x1550, 2, (5, 2, 11)),  # dav1d: context + 2
    "txb_skip": ((5, 13), 2, 2, 0x1708, 2, None),
    "dc_sign": ((2, 3), 2, 2, 0x180C, 2, None),
}
# aom's copies where the library holds them: name -> (its first row as in
# the spec (not inverted), aom's row stride, spec rows compared)
AOM_COPIES = {
    "kf_y_mode": ((15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093,
                   30466), 14, 25),
    "uv_mode_cfl_not_allowed": ((22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244,
                                 30059, 30941, 31961), 15, 13),
    "uv_mode_cfl_allowed": ((10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986,
                             20086, 20995, 22455, 24212), 15, 13),
    "angle_delta": ((2180, 5032, 7567, 22776, 26989, 30217), 8, 8),
    "partition8": ((19132, 25510, 30392), 11, 4),
    "partition16": ((15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902), 11, 4),
    "cfl_alpha": ((7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708,
                   32712, 32716, 32720, 32724), 17, 6),
    "intra_tx_set1": ((1535, 8035, 9461, 12751, 23467, 27825), 17, 26),
    "palette_y_size": ((7952, 13000, 18149, 21478, 25527, 29241), 8, 7),
    "palette_uv_size": ((8713, 19979, 27128, 29609, 31331, 32272), 8, 7),
    "use_filter_intra": ((4621, 6743, 5893, 7866), 3, 22),
    "palette_y_mode": ((31676, 3419, 1261), 3, 21),
    "txb_skip": ((31849, 5892, 12112, 21935), 3, 65),
    "eob_pt16": ((840, 1039, 1980, 4895), 6, 4),
    "y_mode": ((22801, 23489, 24293, 24756, 25601, 26123, 26606, 27418, 27945, 29228, 29685,
                30349), 14, 4),
    "wedge_index": ((2438, 4440, 6599, 8663, 11005, 12874, 15751, 18094, 20359, 22362, 24127,
                     25702, 27752, 29450, 31171), 17, 7),
    "compound_mode": ((7760, 13823, 15808, 17641, 19156, 20666, 26891), 9, 8),
    "interp_filter": ((31935, 32720), 4, 16),
    "new_mv": ((24035, 16630, 15339, 8386, 12222, 4676), 3, 6),
    "ref_mv": ((23974, 24188, 17848, 28622, 24312, 19923), 3, 6),
    "comp_group_idx": ((26607, 22891, 18840, 24594, 19934, 22674), 3, 6),
    "compound_idx": ((18244, 12865, 7053, 13259, 9334, 4644), 3, 6),
}
# two-symbol tables of aom's, compared value by value (one CDF a row)
AOM_TWO_SYMBOL = ("use_filter_intra", "palette_y_mode", "txb_skip", "new_mv", "ref_mv",
                  "comp_group_idx", "compound_idx")

_PREAMBLE = """\
// The default CDFs and lookup tables of AV1 intra and inter frames, as dav1d 1.5.1
// and aom 3.12.1 hold them (src/cdf.c, src/tables.c, src/dequant_tables.c,
// src/wedge.c of dav1d; av1/common/entropymode.c, entropymv.c,
// token_cdfs.h, quant_common.c, reconintra.c, reconinter.c, filter.h,
// warped_motion.c, mvref_common.h of aom). Written by
// tools/extract_av1_tables.py from the
// libavif that Pillow bundles, which links both; do not edit by hand.
//
// A CDF row holds the symbols' inverted cumulative probabilities
// (32768 - cdf, decreasing, the last symbol's 0 left out), then the
// adaptation counter (0), then zeros up to the row's stride. Each table
// names its source offsets in the library's file.
//
// dav1d and aom are under the BSD 2-clause licence:
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions are
// met:
// 1. Redistributions of source code must retain the above copyright notice,
//    this list of conditions and the following disclaimer.
// 2. Redistributions in binary form must reproduce the above copyright
//    notice, this list of conditions and the following disclaimer in the
//    documentation and/or other materials provided with the distribution.
//
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS"
// AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE
// IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR PURPOSE
// ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT OWNER OR CONTRIBUTORS BE
// LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR
// CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, PROCUREMENT OF
// SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR PROFITS; OR BUSINESS
// INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN
// CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE)
// ARISING IN ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE
// POSSIBILITY OF SUCH DAMAGE.

#pragma once

#include <cstdint>
"""


def library_path():
    """Pillow's bundled libavif."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                  "pillow.libs", "libavif*.so*"))
    if not libs:
        raise RuntimeError("PIL's bundled libavif was not found")
    return libs[0]


def _find(blob, values, fmt="<H"):
    pat = b"".join(struct.pack(fmt, v) for v in values)
    hits, pos = [], blob.find(pat)
    while pos >= 0:
        hits.append(pos)
        pos = blob.find(pat, pos + 1)
    return hits


def _find_one(blob, values, fmt, what):
    hits = _find(blob, values, fmt)
    if len(hits) != 1:
        raise RuntimeError(f"{what}: expected its anchor once in the library, found {len(hits)}")
    return hits[0]


def _rows(blob, off, n_rows, stride):
    return np.frombuffer(blob[off:off + 2 * n_rows * stride], "<u2").reshape(n_rows, stride)


def _check_cdf(row, nsym, what):
    vals = row[:nsym - 1].astype(np.int64)
    if (not (vals > 0).all() or (vals >= 32768).any() or (np.diff(vals) > 0).any()
            or row[nsym - 1:].any()):
        raise RuntimeError(f"{what}: the row {row.tolist()} is not a {nsym}-symbol CDF")


def _take(blob, off, shape, nsym, stride, src_stride, what, syms=None, unused=()):
    n = int(np.prod(shape)) if shape else 1
    rows = _rows(blob, off, n, src_stride)
    out = np.zeros((n, stride), np.uint16)
    for i in range(n):
        k = nsym if syms is None else syms[i]
        if i in unused:
            if rows[i].any():
                raise RuntimeError(f"{what}[{i}]: a row of an unused block size is not zero")
            continue
        _check_cdf(rows[i], k, f"{what}[{i}]")
        out[i, :k - 1] = rows[i, :k - 1]
    return out.reshape(*shape, stride), off


def tables(blob=None):
    """name -> (numpy array, C type, source note)."""
    if blob is None:
        with open(library_path(), "rb") as f:
            blob = f.read()
    out = {}
    mode = _find_one(blob, MODE_ANCHOR, "<H", "dav1d's CdfModeContext")
    for name, (shape, nsym, stride, rel, src) in MODE_CDFS.items():
        syms = None
        if nsym is None:  # palette colour maps: 2..8 colours, five contexts each
            syms = [2 + i // 5 for i in range(35)]
            nsym = 8
        unused = ()
        if name in ("motion_mode", "use_obmc"):
            unused = [DAV1D_BSIZES.index(b) for b in NO_MOTION_MODE]
        arr, off = _take(blob, mode + rel, shape, nsym, stride, src, name, syms, unused)
        if name in ("use_filter_intra", "motion_mode", "use_obmc"):  # dav1d's order -> the spec's
            arr = arr[[DAV1D_BSIZES.index(b) for b in SPEC_BSIZES]]
        out[name] = (arr, "uint16_t", f"dav1d CdfModeContext at 0x{off:x}")
    mv = _find_one(blob, MV_ANCHOR, "<H", "dav1d's default_mv_component_cdf")
    for name, (shape, nsym, stride, rel, src) in MV_CDFS.items():
        arr, off = _take(blob, mv + rel, shape, nsym, stride, src, name)
        out[name] = (arr, "uint16_t", f"dav1d default_mv_component_cdf at 0x{off:x}")
    joint = [h for h in _find(blob, MV_JOINT_ANCHOR, "<H") if mv < h < mv + 0x100]
    if len(joint) != 1:
        raise RuntimeError("dav1d's default_mv_joint_cdf not found after its component CDFs")
    arr, _ = _take(blob, joint[0], (), 4, 4, 4, "mv_joint")
    out["mv_joint"] = (arr, "uint16_t", f"dav1d default_mv_joint_cdf at 0x{joint[0]:x}")
    kf = _find_one(blob, KF_ANCHOR, "<H", "dav1d's key-frame y-mode CDF")
    arr, _ = _take(blob, kf, (5, 5), 13, 16, 16, "kf_y_mode")
    out["kf_y_mode"] = (arr, "uint16_t", f"dav1d default_kf_y_mode_cdf at 0x{kf:x}")
    coef0 = _find_one(blob, COEF_ANCHOR, "<H", "dav1d's CdfCoefContext[0]")
    size = _find_one(blob, COEF_ANCHOR1, "<H", "dav1d's CdfCoefContext[1]") - coef0
    for name, (shape, nsym, stride, rel, src, dshape) in COEF_CDFS.items():
        per_q = []
        for q in range(4):
            arr, _ = _take(blob, coef0 + q * size + rel, dshape or shape, nsym, stride, src,
                           f"{name}[{q}]")
            if dshape is not None:  # eob_hi_bit: context c at c + 2
                arr = arr[..., 2:11, :]
            per_q.append(arr)
        out[name] = (np.stack(per_q), "uint16_t",
                     f"dav1d CdfCoefContext[4] at 0x{coef0 + rel:x} + q * 0x{size:x}")
    # lookups
    dc = _find_one(blob, (4, 8, 8, 9, 10, 11, 12, 12, 13, 14), "<h", "aom's dc_qlookup")
    ac = _find_one(blob, (4, 8, 9, 10, 11, 12, 13, 14, 15, 16), "<h", "aom's ac_qlookup")
    dcq = np.frombuffer(blob[dc:dc + 512], "<i2").copy()
    acq = np.frombuffer(blob[ac:ac + 512], "<i2").copy()
    dq = _find_one(blob, (4, 4, 8, 8, 8, 9, 9, 10), "<H", "dav1d's dq_tbl")
    pairs = np.frombuffer(blob[dq:dq + 1024], "<u2").reshape(256, 2)
    if not ((pairs[:, 0] == dcq).all() and (pairs[:, 1] == acq).all()):
        raise RuntimeError("dav1d's 8-bit dq_tbl differs from aom's dc / ac qlookup")
    out["dc_qlookup"] = (dcq, "int16_t", f"aom dc_qlookup_QTX at 0x{dc:x} (dav1d 0x{dq:x})")
    out["ac_qlookup"] = (acq, "int16_t", f"aom ac_qlookup_QTX at 0x{ac:x} (dav1d 0x{dq:x})")
    # 10 and 12 bits: dav1d's dq_tbl[1], [2] (dc, ac pairs), checked against aom's copies
    for k, depth in ((1, 10), (2, 12)):
        pairs = np.frombuffer(blob[dq + 1024 * k:dq + 1024 * (k + 1)], "<u2").reshape(256, 2)
        for j, kind in enumerate(("dc", "ac")):
            col = pairs[:, j].astype(np.int16)
            hit = _find_one(blob, tuple(int(v) for v in col[:8]), "<h",
                            f"aom's {kind}_qlookup_{depth}")
            if not (np.frombuffer(blob[hit:hit + 512], "<i2") == col).all():
                raise RuntimeError(f"dav1d's {depth}-bit dq_tbl differs from aom's {kind} lookup")
            out[f"{kind}_qlookup{depth}"] = (
                col.copy(), "int16_t",
                f"dav1d dq_tbl[{k}] at 0x{dq + 1024 * k:x} (aom {kind}_qlookup_{depth}_QTX at "
                f"0x{hit:x})")
    sm = _find_one(blob, (0, 0, 255, 128, 255, 149, 85, 64), "B", "dav1d's sm_weights")
    out["sm_weights"] = (np.frombuffer(blob[sm:sm + 128], "u1").copy(), "uint8_t",
                         f"dav1d dav1d_sm_weights at 0x{sm:x} (weights of size n at n)")
    dr = _find_one(blob, (0, 0, 0, 1023, 0, 0, 547), "<h", "aom's dr_intra_derivative")
    out["dr_intra_derivative"] = (np.frombuffer(blob[dr:dr + 180], "<i2").copy(), "int16_t",
                                  f"aom dr_intra_derivative at 0x{dr:x}")
    m2a = _find(blob, (0, 90, 180, 45, 135, 113, 157, 203, 67), "B")
    m2a = [h for h in m2a if dr - 64 <= h < dr]  # aom's mode_to_angle_map, next to it
    if len(m2a) != 1:
        raise RuntimeError("aom's mode_to_angle_map not found beside dr_intra_derivative")
    out["mode_to_angle"] = (np.frombuffer(blob[m2a[0]:m2a[0] + 13], "u1").copy(), "uint8_t",
                            f"aom mode_to_angle_map at 0x{m2a[0]:x}")
    ft = _find_one(blob, (-6, 10, 0, 0, 0, 12, 0, 0), "b", "aom's av1_filter_intra_taps")
    out["filter_intra_taps"] = (np.frombuffer(blob[ft:ft + 320], "i1").reshape(5, 8, 8).copy(),
                                "int8_t", f"aom av1_filter_intra_taps at 0x{ft:x}")
    lo = _find_one(blob, (0, 1, 6, 6, 21, 1, 6, 6, 21, 21, 6, 6, 21, 21, 21), "B",
                   "dav1d's lo_ctx_offsets")
    out["lo_ctx_offsets"] = (np.frombuffer(blob[lo:lo + 75], "u1").reshape(3, 5, 5).copy(),
                             "uint8_t", f"dav1d dav1d_lo_ctx_offsets at 0x{lo:x} (w == h, "
                             "w > h, w < h)")
    # superres: aom's av1_resize_filter_normative (the specification's
    # Upscale_Filter), checked against dav1d's negated dav1d_resize_filter
    up = _find_one(blob, (0, 0, 0, 128, 0, 0, 0, 0, 0, 0, -1, 128, 2, -1, 0, 0), "<h",
                   "aom's av1_resize_filter_normative")
    filt = np.frombuffer(blob[up:up + 1024], "<i2").reshape(64, 8)
    rz = _find_one(blob, (0, 0, 0, -128, 0, 0, 0, 0, 0, 0, 1, -128, -2, 1, 0, 0), "b",
                   "dav1d's resize_filter")
    if not (np.frombuffer(blob[rz:rz + 512], "i1").reshape(64, 8) == -filt).all():
        raise RuntimeError("dav1d's resize_filter is not aom's upscale filter negated")
    out["upscale_filter"] = (filt.copy(), "int16_t",
                             f"aom av1_resize_filter_normative at 0x{up:x} (dav1d 0x{rz:x})")
    _restoration_and_grain(blob, out)
    _inter_tables(blob, out)
    _check_aom(blob, out)
    return out


# aom's sub-pixel filters (the specification's Subpel_Filters order:
# regular, smooth, sharp, bilinear, regular and smooth 4-tap), by their
# phase-1 rows; each [16][8] with phase 0 first
SUBPEL_ROW1 = ((0, 2, -6, 126, 8, -2, 0, 0), (0, 2, 28, 62, 34, 2, 0, 0),
               (-2, 2, -6, 126, 8, -2, 2, 0), (0, 0, 0, 120, 8, 0, 0, 0),
               (0, 0, -4, 126, 8, -2, 0, 0), (0, 0, 30, 62, 34, 2, 0, 0))
# dav1d's halved copies: regular, smooth, sharp, regular 4-tap, smooth 4-tap, bilinear
DAV1D_SUBPEL = (0, 1, 2, 4, 5, 3)


def _inter_tables(blob, out):
    """The lookups of inter prediction: the sub-pixel and warp filters, the
    warp divisor table, the OBMC masks, the wedge codebooks and master
    lines, the inter-intra weights, the distance weights."""
    zero = (0, 0, 0, 128, 0, 0, 0, 0)
    sets = []
    for row1 in SUBPEL_ROW1:
        hit = _find(blob, zero + row1, "<h")[0]  # every copy of aom's is the same
        sets.append(np.frombuffer(blob[hit:hit + 256], "<i2").reshape(16, 8))
    sub = np.stack(sets)
    dv = _find_one(blob, (0, 1, -3, 63, 4, -1, 0, 0), "b", "dav1d's mc_subpel_filters")
    dav = np.frombuffer(blob[dv:dv + 6 * 15 * 8], "i1").reshape(6, 15, 8)
    for k, spec in enumerate(DAV1D_SUBPEL):
        if not (dav[k].astype(np.int16) * 2 == sub[spec, 1:]).all():
            raise RuntimeError(f"dav1d's sub-pixel filter {k} is not aom's {spec} halved")
    out["subpel_filters"] = (sub.copy(), "int16_t", f"aom av1_sub_pel_filters at 0x{hit:x}.. "
                             f"(checked against dav1d's halved dav1d_mc_subpel_filters at 0x{dv:x})")
    first = (0, 0, 127, 1, 0, 0, 0, 0, 0, -1, 127, 2, 0, 0, 0, 0)
    wps = [h for h in _find(blob, first, "<h")  # each of the 193 rows sums to 128
           if (np.frombuffer(blob[h:h + 193 * 16], "<i2").reshape(193, 8).sum(1) == 128).all()]
    if len(wps) != 1:
        raise RuntimeError(f"aom's av1_warped_filter: found {len(wps)} times")
    wp = wps[0]
    warp = np.frombuffer(blob[wp:wp + 193 * 16], "<i2").reshape(193, 8)
    dws = [h for h in _find(blob, first, "b")
           if (np.frombuffer(blob[h:h + 193 * 8], "i1").reshape(193, 8) == warp).all()]
    if len(dws) != 1:
        raise RuntimeError("dav1d's mc_warp_filter, equal to aom's, not found once")
    dw = dws[0]
    out["warped_filters"] = (warp.copy(), "int16_t",
                             f"aom av1_warped_filter at 0x{wp:x} (dav1d 0x{dw:x})")
    dl = _find(blob, (16384, 16320, 16257, 16194, 16132, 16070), "<H")
    luts = [np.frombuffer(blob[h:h + 514], "<u2") for h in dl]
    if len(dl) != 2 or not (luts[0] == luts[1]).all() or luts[0][256] != 8192:
        raise RuntimeError("aom's and dav1d's div_lut not found equal")
    out["div_lut"] = (luts[0].astype(np.int32), "int32_t",
                      f"aom div_lut at 0x{dl[0]:x} (dav1d 0x{dl[1]:x})")
    # OBMC: aom's obmc_mask_2 .. _32, laid out as dav1d lays them out (the
    # mask of size n at n), checked against dav1d's (64 - the weights)
    o32 = _find_one(blob, (33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50, 51, 52, 53, 55), "B",
                    "aom's obmc_mask_32")
    masks = np.zeros(64, np.uint8)
    for n, off in ((32, 0), (16, 32), (8, 48), (4, 56), (2, 60)):
        masks[n:2 * n] = np.frombuffer(blob[o32 + off:o32 + off + n], "u1")
    do = _find_one(blob, (0, 0, 19, 0, 25, 14, 5, 0), "B", "dav1d's obmc_masks")
    dmask = np.frombuffer(blob[do:do + 64], "u1")
    if not (np.where(masks[2:] == 64, 0, 64 - masks[2:].astype(int)) == dmask[2:]).all():
        raise RuntimeError("dav1d's obmc_masks are not 64 - aom's")
    out["obmc_masks"] = (masks, "uint8_t", f"aom obmc_mask_32 .. _2 at 0x{o32:x} (the mask of "
                         f"size n at n; dav1d's 64 - m at 0x{do:x})")
    # wedges: aom's three codebooks (direction, x offset, y offset), in the
    # order h > w, h < w, h == w; the master lines (odd, even, vertical)
    books = {}
    for hit in _find(blob, (2, 4, 4, 3, 4, 4, 4, 4, 4, 5, 4, 4), "<i"):
        b = np.frombuffer(blob[hit:hit + 192], "<i4").reshape(16, 3)
        horiz, vert = int((b[:, 0] == 0).sum()), int((b[:, 0] == 1).sum())
        books[(horiz > vert) - (horiz < vert)] = (b, hit)
    if sorted(books) != [-1, 0, 1]:
        raise RuntimeError("aom's three wedge codebooks not found")
    cb = np.stack([books[1][0], books[-1][0], books[0][0]]).astype(np.uint8)
    for k in range(3):
        if len(_find(blob, tuple(int(v) for v in cb[k].ravel()), "B")) != 1:
            raise RuntimeError(f"dav1d's copy of wedge codebook {k} not found once")
    out["wedge_codebook"] = (cb, "uint8_t", "aom wedge_codebook_16_hgtw / hltw / heqw at "
                             + ", ".join(f"0x{books[k][1]:x}" for k in (1, -1, 0))
                             + " (each checked against dav1d's)")
    border = _find_one(blob, (1, 2, 6, 18, 37, 53, 60, 63, 1, 4, 11, 27, 46, 58, 62, 63), "B",
                       "dav1d's wedge_master_border")
    lines = []
    for k in range(3):
        mid = bytes(blob[border + 8 * k:border + 8 * k + 8])
        hits = [h - 28 for h in _find(blob, tuple(mid), "B") if not border <= h < border + 24]
        full = [np.frombuffer(blob[h:h + 64], "u1") for h in hits]
        full = [f for f in full if not f[:28].any() and (f[36:] == 64).all()]
        if len(full) != 1:
            raise RuntimeError(f"aom's wedge master line {k} not found beside dav1d's")
        lines.append(full[0])
    out["wedge_master"] = (np.stack(lines).copy(), "uint8_t", "aom wedge_master_oblique_odd / "
                           f"_even / _vertical (dav1d's wedge_master_border at 0x{border:x})")
    dm = _find_one(blob, (0, 16384, 8192, 5461, 4096, 3276, 2730, 2340), "<i", "aom's div_mult")
    mult = np.frombuffer(blob[dm:dm + 128], "<i4")
    dd = _find(blob, tuple(int(v) for v in mult), "<H")
    if not dd or not (mult[1:] == 16384 // np.arange(1, 32)).all():
        raise RuntimeError("aom's div_mult: no dav1d copy, or not 16384 / d")
    out["div_mult"] = (mult.copy(), "int32_t", f"aom div_mult at 0x{dm:x} (dav1d 0x{dd[0]:x})")
    ii = _find_one(blob, (60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35), "B",
                   "aom's ii_weights1d")
    out["ii_weights"] = (np.frombuffer(blob[ii:ii + 128], "u1").copy(), "uint8_t",
                         f"aom ii_weights1d at 0x{ii:x}")
    qd = _find_one(blob, (2, 3, 2, 5, 2, 7, 1, 31, 9, 7, 11, 5, 12, 4, 13, 3), "<i",
                   "aom's quant_dist_weight / quant_dist_lookup_table")
    q = np.frombuffer(blob[qd:qd + 64], "<i4").reshape(2, 4, 2)
    if len(_find(blob, tuple(int(v) for v in q[1].ravel()), "B")) != 1:
        raise RuntimeError("dav1d's quant_dist lookup not found once")
    out["quant_dist"] = (q.astype(np.uint8), "uint8_t", f"aom quant_dist_weight and "
                         f"quant_dist_lookup_table at 0x{qd:x} (the lookup checked against dav1d's)")


QM_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32),
            (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))  # (w, h), the specification's order
QM_TOTAL = sum(w * h for w, h in QM_SIZES)


def _untriangle(src, n=32):
    """dav1d's untriangle: row y's first y + 1 values, then the rest of the
    row down the columns of the lower triangle."""
    m = np.zeros((n, n), np.uint8)
    s = 0
    for y in range(n):
        m[y, :y + 1] = src[s:s + y + 1]
        p = s + y
        for x in range(y + 1, n):
            p += x
            m[y, x] = src[p]
        s += y + 1
    return m


def _restoration_and_grain(blob, out):
    sgr = _find_one(blob, (140, 3236, 112, 2158), "<H", "dav1d's sgr_params")
    sp = np.frombuffer(blob[sgr:sgr + 64], "<u2").reshape(16, 2)
    aom = _find_one(blob, (2, 1, 140, 3236), "<i", "aom's av1_sgr_params")
    ap = np.frombuffer(blob[aom:aom + 256], "<i4").reshape(16, 4)
    if not ((np.where(ap[:, 2:] < 0, 0, ap[:, 2:]) == sp).all()
            and (ap[:, 0] == np.where(sp[:, 0] > 0, 2, 0)).all()
            and (ap[:, 1] == np.where(sp[:, 1] > 0, 1, 0)).all()):
        raise RuntimeError("dav1d's sgr_params differ from aom's av1_sgr_params")
    # the specification's Sgr_Params rows: r0, s0, r1, s1
    rows = np.stack([ap[:, 0], sp[:, 0], ap[:, 1], sp[:, 1]], 1).astype(np.int32)
    out["sgr_params"] = (rows, "int32_t", f"dav1d dav1d_sgr_params at 0x{sgr:x} with aom "
                         f"av1_sgr_params' radii at 0x{aom:x} (r0, s0, r1, s1)")
    xb = _find_one(blob, (255, 128, 85, 64, 51, 43, 37, 32), "B", "dav1d's sgr_x_by_x")
    x = np.frombuffer(blob[xb:xb + 256], "u1").copy()
    ax = _find_one(blob, (1, 128, 171, 192, 205, 213, 219, 224), "<i", "aom's av1_x_by_xplus1")
    a = np.frombuffer(blob[ax:ax + 1024], "<i4")
    if not (256 - a == x).all():
        raise RuntimeError("dav1d's sgr_x_by_x is not 256 - aom's av1_x_by_xplus1")
    out["sgr_x_by_x"] = (x, "uint8_t", f"dav1d dav1d_sgr_x_by_x at 0x{xb:x} (aom 0x{ax:x})")
    qm = _find_one(blob, (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200),
                   "B", "aom's iwt_matrix_ref")
    q = np.frombuffer(blob[qm:qm + 15 * 2 * QM_TOTAL], "u1").reshape(15, 2, QM_TOTAL).copy()
    tri = _find(blob, (32, 31, 32, 31, 32, 32), "B")
    tri = [t for t in tri if (np.frombuffer(blob[t:t + 15 * 1056], "u1") > 0).all()][:1]
    if not tri:
        raise RuntimeError("dav1d's triangular 32x32 quantizer matrices not found")
    t = np.frombuffer(blob[tri[0]:tri[0] + 15 * 1056], "u1").reshape(15, 2, 528)
    off = 0
    for w, h in QM_SIZES:
        if w == h:
            step = 32 // w
            for lv in range(15):
                for pl in range(2):
                    full = _untriangle(t[lv, pl])
                    sub = full[(step - 1) // 2::step, (step - 1) // 2::step]
                    if not (sub == q[lv, pl, off:off + w * h].reshape(h, w)).all():
                        raise RuntimeError(f"the {w}x{w} quantizer matrix of level {lv}, "
                                           f"plane {pl}: aom's differs from dav1d's")
        off += w * h
    out["qm"] = (q, "uint8_t", f"aom iwt_matrix_ref at 0x{qm:x} (levels 0-14, luma / chroma; "
                 f"the squares checked against dav1d's qm_tbl_32x32_t at 0x{tri[0]:x})")
    g = _find_one(blob, (56, 568, -180, 172, 124, -84, 172, -64), "<h",
                  "dav1d's gaussian_sequence")
    out["gaussian_sequence"] = (np.frombuffer(blob[g:g + 4096], "<i2").copy(), "int16_t",
                                f"dav1d dav1d_gaussian_sequence at 0x{g:x}")


def _check_aom(blob, out):
    """Compare dav1d's copies with aom's where the library holds both."""
    for name, (first, stride, n_rows) in AOM_COPIES.items():
        arr = out[name][0]
        flat = arr.reshape(-1, arr.shape[-1])[:n_rows]
        if name not in AOM_TWO_SYMBOL:
            hits = _find(blob, [32768 - v for v in first] + [0, 0], "<H")
        else:  # two-symbol rows: value, 0, 0 each
            hits = _find(blob, sum([[32768 - v, 0, 0] for v in first], []), "<H")
        hits = [h for h in hits if not _same_region(h, out)]
        if len(hits) != 1:
            raise RuntimeError(f"{name}: aom's copy found {len(hits)} times")
        rows = _rows(blob, hits[0], n_rows, stride)
        for i in range(n_rows):
            k = int(np.count_nonzero(flat[i])) + 1
            if not (rows[i, :k - 1] == flat[i, :k - 1]).all():
                raise RuntimeError(f"{name}[{i}]: dav1d's {flat[i].tolist()} != aom's "
                                   f"{rows[i].tolist()}")


def _same_region(hit, out):
    """Whether ``hit`` is one of dav1d's copies (within its structures)."""
    for _, _, note in out.values():
        if note.startswith("dav1d"):
            off = int(note.split(" at 0x")[1].split()[0], 16)
            if abs(hit - off) < 0x2000:
                return True
    return False


def render(tabs):
    out = [_PREAMBLE]
    for name, (arr, ctype, note) in tabs.items():
        dims = "".join(f"[{d}]" for d in arr.shape)
        out.append(f"\n// {note}\nstatic const {ctype} av1_{name}{dims} = {{\n")
        flat = (arr.reshape(-1, arr.shape[-1]) if 1 < arr.ndim and arr.shape[-1] <= 32
                else [row[i:i + 16] for row in arr.reshape(-1, arr.shape[-1])
                      for i in range(0, row.size, 16)])
        for row in flat:
            out.append("    " + " ".join(f"{int(v)}," for v in row) + "\n")
        out.append("};\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the committed header with the library instead of writing it")
    args = ap.parse_args(argv)
    text = render(tables())
    if args.check:
        with open(HEADER) as f:
            same = f.read() == text
        print("equal" if same else "differs")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
