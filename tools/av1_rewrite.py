"""AV1 header rewrites of AVIF files: the forms of a stream that differ from
an 8-bit key frame only in its uncompressed headers, made from the files of
PIL's own writer (which makes 8-bit key frames only).

- ``to_high_bitdepth(data, 10 | 12)``: the sequence header's colour config
  at 10 bits (``high_bitdepth``; profiles 0, 1 and 2 keep theirs) or 12
  (profile 2 with ``twelve_bit``, the 4:2:0 / 4:4:4 / 4:2:2 subsampling
  bits written out; 4:0:0 has none), the ``av1C`` and ``pixi`` depths to
  match. No tile symbol depends on the depth but a palette's colours, so a
  frame without palettes reads as the same symbols at 10 or 12 bits, and
  decodes to other pixels: the depth changes dequantisation, prediction
  and the loop filters. A frame that allows screen content (palettes) is
  refused unless ``screen_content_ok`` (the caller has seen that no block
  holds a palette).
- ``to_superres(data, denominator)``: ``enable_superres`` and a
  ``max_frame_width`` whose superres-downscaled width is the coded width
  (so ``MiCols`` and the tile layout stay), ``use_superres`` and
  ``coded_denom`` inserted in the key frame's header after its frame size,
  the ``ispe`` widened to the upscaled width. Refused where the frame uses
  loop restoration (whose units are counted on the upscaled width) or
  allows screen content (whose ``allow_intrabc`` superres removes).
- ``hide_key_frame(data)``: in sample 0 of an ``avis`` colour track, the
  key frame made hidden (``show_frame`` 0, ``showable_frame`` 1,
  ``error_resilient_mode`` 0, ``refresh_frame_flags`` 0xFF inserted) and
  an ``OBU_FRAME_HEADER`` with ``show_existing_frame`` 1 showing slot 0
  appended.

Each frame header is parsed bit by bit (key frames; the full and reduced
sequence headers), re-emitted with its fields changed, re-aligned before
its tile group, and its OBU size rewritten; every AV1 payload of the file
(``av01`` items in the ``mdat``, track samples) is rewritten and the
``iloc`` extents, ``stco`` / ``co64`` offsets and ``stsz`` sizes move with
it. The standard library only.

    from tools.av1_rewrite import to_high_bitdepth, to_superres, hide_key_frame
    ten = to_high_bitdepth(open("x.avif", "rb").read(), 10)
"""

from __future__ import annotations

import struct

from tools.avif_writers import boxes

CONTAINERS = (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf", b"edts", b"iprp", b"ipco")


class RewriteError(ValueError):
    """A source the rewrite cannot change soundly."""


# ------------------------------------------------------------- bits -------

class _Reader:
    """A bit reader that logs each field as [name, width, value] (width
    'uvlc' for the variable-length ones)."""

    def __init__(self, data):
        self.d = data
        self.pos = 0
        self.toks = []

    def _bit(self):
        if self.pos >> 3 >= len(self.d):
            raise RewriteError("a header runs past its OBU")
        b = (self.d[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def f(self, n, name=""):
        v = 0
        for _ in range(n):
            v = (v << 1) | self._bit()
        self.toks.append([name, n, v])
        return v

    def su(self, n, name=""):
        v = self.f(n, name)
        return v - (1 << n) if v >> (n - 1) else v

    def ns(self, n, name=""):
        w = n.bit_length()
        m = (1 << w) - n
        start = len(self.toks)
        v = self.f(w - 1, name)
        if v >= m:
            v = (v << 1) - m + self.f(1, name)
        del self.toks[start:]
        self.toks.append([name, ("ns", n), v])
        return v

    def uvlc(self, name=""):
        lz = 0
        while not self._bit():
            lz += 1
        v = 0
        for _ in range(lz):
            v = (v << 1) | self._bit()
        v += (1 << lz) - 1
        self.toks.append([name, "uvlc", v])
        return v


class _Writer:
    def __init__(self):
        self.bits = []

    def f(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def tok(self, width, v):
        if width == "uvlc":
            v1 = v + 1
            lz = v1.bit_length() - 1
            self.f(lz, 0)
            self.f(lz + 1, v1)
        elif isinstance(width, tuple):  # ns(n)
            n = width[1]
            w = n.bit_length()
            m = (1 << w) - n
            if v < m:
                self.f(w - 1, v)
            else:
                x = v + m
                self.f(w - 1, x >> 1)
                self.f(1, x & 1)
        else:
            self.f(width, v)

    def bytes(self, trailing):
        bits = list(self.bits)
        if trailing:
            bits.append(1)
        bits += [0] * (-len(bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def _emit(toks, trailing=True):
    w = _Writer()
    for _, width, v in toks:
        w.tok(width, v)
    return w.bytes(trailing)


def _index(toks, name):
    for i, t in enumerate(toks):
        if t[0] == name:
            return i
    raise KeyError(name)


# --------------------------------------------------- sequence header -------

def parse_sequence_header(body):
    """(fields as a dict, the field log) of a sequence header OBU's payload."""
    r = _Reader(body)
    s = {}
    s["profile"] = r.f(3, "seq_profile")
    s["still"] = r.f(1, "still_picture")
    s["reduced"] = r.f(1, "reduced_still_picture_header")
    s["decoder_model_info_present"] = 0
    s["equal_picture_interval"] = 0
    s["op_idc"], s["op_decoder_model_present"] = [0], [0]
    if s["reduced"]:
        r.f(5, "seq_level_idx")
    else:
        if r.f(1, "timing_info_present_flag"):
            r.f(32, "num_units_in_display_tick")
            r.f(32, "time_scale")
            s["equal_picture_interval"] = r.f(1, "equal_picture_interval")
            if s["equal_picture_interval"]:
                r.uvlc("num_ticks_per_picture_minus_1")
            s["decoder_model_info_present"] = r.f(1, "decoder_model_info_present_flag")
            if s["decoder_model_info_present"]:
                s["buffer_delay_length"] = r.f(5, "buffer_delay_length_minus_1") + 1
                r.f(32, "num_units_in_decoding_tick")
                s["buffer_removal_time_length"] = r.f(5, "buffer_removal_time_length_minus_1") + 1
                s["frame_presentation_time_length"] = r.f(
                    5, "frame_presentation_time_length_minus_1") + 1
        idd = r.f(1, "initial_display_delay_present_flag")
        n = r.f(5, "operating_points_cnt_minus_1") + 1
        s["op_idc"], s["op_decoder_model_present"] = [], []
        for _ in range(n):
            s["op_idc"].append(r.f(12, "operating_point_idc"))
            if r.f(5, "seq_level_idx") > 7:
                r.f(1, "seq_tier")
            present = 0
            if s["decoder_model_info_present"]:
                present = r.f(1, "decoder_model_present_for_this_op")
                if present:
                    r.f(s["buffer_delay_length"], "decoder_buffer_delay")
                    r.f(s["buffer_delay_length"], "encoder_buffer_delay")
                    r.f(1, "low_delay_mode_flag")
            s["op_decoder_model_present"].append(present)
            if idd and r.f(1, "initial_display_delay_present_for_this_op"):
                r.f(4, "initial_display_delay_minus_1")
    s["fwb"] = r.f(4, "frame_width_bits_minus_1") + 1
    s["fhb"] = r.f(4, "frame_height_bits_minus_1") + 1
    s["max_w"] = r.f(s["fwb"], "max_frame_width_minus_1") + 1
    s["max_h"] = r.f(s["fhb"], "max_frame_height_minus_1") + 1
    s["frame_id_numbers_present"] = 0 if s["reduced"] else r.f(1, "frame_id_numbers_present_flag")
    if s["frame_id_numbers_present"]:
        a = r.f(4, "delta_frame_id_length_minus_2") + 2
        s["id_len"] = a + r.f(3, "additional_frame_id_length_minus_1") + 1
    s["use128"] = r.f(1, "use_128x128_superblock")
    r.f(1, "enable_filter_intra")
    r.f(1, "enable_intra_edge_filter")
    s["enable_order_hint"], s["order_hint_bits"] = 0, 0
    if s["reduced"]:
        s["force_sct"], s["force_imv"] = 2, 2
    else:
        r.f(4, "inter_tools")
        s["enable_order_hint"] = r.f(1, "enable_order_hint")
        if s["enable_order_hint"]:
            r.f(2, "jnt_comp_ref_frame_mvs")
        s["force_sct"] = (2 if r.f(1, "seq_choose_screen_content_tools")
                          else r.f(1, "seq_force_screen_content_tools"))
        if s["force_sct"] > 0:
            s["force_imv"] = (2 if r.f(1, "seq_choose_integer_mv")
                              else r.f(1, "seq_force_integer_mv"))
        else:
            s["force_imv"] = 2
        if s["enable_order_hint"]:
            s["order_hint_bits"] = r.f(3, "order_hint_bits_minus_1") + 1
    s["enable_superres"] = r.f(1, "enable_superres")
    s["enable_cdef"] = r.f(1, "enable_cdef")
    s["enable_restoration"] = r.f(1, "enable_restoration")
    high = r.f(1, "high_bitdepth")
    if s["profile"] == 2 and high:
        s["bitdepth"] = 12 if r.f(1, "twelve_bit") else 10
    else:
        s["bitdepth"] = 10 if high else 8
    s["mono"] = 0 if s["profile"] == 1 else r.f(1, "mono_chrome")
    s["cp"] = s["tc"] = s["mc"] = 2
    if r.f(1, "color_description_present_flag"):
        s["cp"], s["tc"], s["mc"] = r.f(8, "cp"), r.f(8, "tc"), r.f(8, "mc")
    s["ssx"] = s["ssy"] = 1
    if s["mono"]:
        r.f(1, "color_range")
    elif (s["cp"], s["tc"], s["mc"]) == (1, 13, 0):
        s["ssx"] = s["ssy"] = 0
    else:
        r.f(1, "color_range")
        if s["profile"] == 1:
            s["ssx"] = s["ssy"] = 0
        elif s["profile"] == 2:
            if s["bitdepth"] == 12:
                s["ssx"] = r.f(1, "subsampling_x")
                s["ssy"] = r.f(1, "subsampling_y") if s["ssx"] else 0
            else:
                s["ssx"], s["ssy"] = 1, 0
        if s["ssx"] and s["ssy"]:
            r.f(2, "chroma_sample_position")
    if not s["mono"]:
        r.f(1, "separate_uv_delta_q")
    s["separate_uv_delta_q"] = r.toks[-1][2] if not s["mono"] else 0
    s["film_grain_present"] = r.f(1, "film_grain_params_present")
    return s, r.toks


def _high_bitdepth_tokens(s, toks, depth):
    toks = [list(t) for t in toks]
    hb = _index(toks, "high_bitdepth")
    if s["bitdepth"] != 8:
        raise RewriteError(f"a sequence header of {s['bitdepth']} bits (the source must be 8-bit)")
    toks[hb][2] = 1
    if depth == 10:
        if s["profile"] == 2:  # 8-bit 4:2:2 -> 10-bit 4:2:2
            toks.insert(hb + 1, ["twelve_bit", 1, 0])
        return toks
    if (s["cp"], s["tc"], s["mc"]) == (1, 13, 0) and not s["mono"]:
        raise RewriteError("an sRGB colour config (4:4:4 without subsampling bits) at 12 bits")
    toks[_index(toks, "seq_profile")][2] = 2
    toks.insert(hb + 1, ["twelve_bit", 1, 1])  # the source is 8-bit: none was read
    if s["profile"] == 1:  # profile 2 reads mono_chrome, profile 1 does not
        toks.insert(hb + 2, ["mono_chrome", 1, 0])
    if not s["mono"]:
        cr = _index(toks, "color_range")
        if s["profile"] == 2 and s["bitdepth"] == 8:  # 4:2:2 implied: write it out
            toks[cr + 1:cr + 1] = [["subsampling_x", 1, 1], ["subsampling_y", 1, 0]]
        elif s["profile"] == 1:
            toks.insert(cr + 1, ["subsampling_x", 1, 0])
        else:
            toks[cr + 1:cr + 1] = [["subsampling_x", 1, 1], ["subsampling_y", 1, 1]]
    return toks


# -------------------------------------------------------- frame header -----

def parse_frame_header(body, s, temporal_id=0, spatial_id=0):
    """(fields, field log, the bit position after the header) of a key
    frame's uncompressed header (OBU_FRAME or OBU_FRAME_HEADER payload)."""
    r = _Reader(body)
    h = {"show_frame": 1, "showable_frame": 0}
    if not s["reduced"]:
        if r.f(1, "show_existing_frame"):
            raise RewriteError("a show_existing_frame header")
        if r.f(2, "frame_type") != 0:
            raise RewriteError("a frame that is not a key frame")
        h["show_frame"] = r.f(1, "show_frame")
        if h["show_frame"] and s["decoder_model_info_present"] and not s["equal_picture_interval"]:
            r.f(s["frame_presentation_time_length"], "frame_presentation_time")
        if not h["show_frame"]:
            h["showable_frame"] = r.f(1, "showable_frame")
            r.f(1, "error_resilient_mode")
    r.f(1, "disable_cdf_update")
    disable_cdf_update = r.toks[-1][2]
    sct = r.f(1, "allow_screen_content_tools") if s["force_sct"] == 2 else s["force_sct"]
    h["allow_screen_content_tools"] = sct
    if sct and s["force_imv"] == 2:
        r.f(1, "force_integer_mv")
    if s["frame_id_numbers_present"]:
        r.f(s["id_len"], "current_frame_id")
    override = 0 if s["reduced"] else r.f(1, "frame_size_override_flag")
    r.f(s["order_hint_bits"], "order_hint")
    if s["decoder_model_info_present"]:
        if r.f(1, "buffer_removal_time_present_flag"):
            for idc, present in zip(s["op_idc"], s["op_decoder_model_present"]):
                if not present:
                    continue
                in_t, in_s = (idc >> temporal_id) & 1, (idc >> (spatial_id + 8)) & 1
                if idc == 0 or (in_t and in_s):
                    r.f(s["buffer_removal_time_length"], "buffer_removal_time")
    if not h["show_frame"]:
        refresh = r.f(8, "refresh_frame_flags")
        if refresh != 0xFF:
            raise RewriteError("a hidden key frame that does not refresh every slot")
    if override:
        w = r.f(s["fwb"], "frame_width_minus_1") + 1
        hh = r.f(s["fhb"], "frame_height_minus_1") + 1
    else:
        w, hh = s["max_w"], s["max_h"]
    r.toks.append(["<superres>", 0, 0])  # superres_params() go here
    h["use_superres"] = 0
    if s["enable_superres"]:
        h["use_superres"] = r.f(1, "use_superres")
        if h["use_superres"]:
            raise RewriteError("a frame that already uses superres")
    h["width"], h["height"] = w, hh
    if r.f(1, "render_and_frame_size_different"):
        r.f(16, "render_width_minus_1")
        r.f(16, "render_height_minus_1")
    intrabc = r.f(1, "allow_intrabc") if sct else 0
    if not (s["reduced"] or disable_cdf_update):
        r.f(1, "disable_frame_end_update_cdf")
    # tile info
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((hh + 7) >> 3)
    sb_shift = 5 if s["use128"] else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tw = 4096 >> sb_size
    max_area = (4096 * 2304) >> (2 * sb_size)

    def tlog2(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k

    min_cols = tlog2(max_tw, sb_cols)
    max_cols = tlog2(1, min(sb_cols, 64))
    max_rows = tlog2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, tlog2(max_area, sb_rows * sb_cols))
    if r.f(1, "uniform_tile_spacing_flag"):
        cl = min_cols
        while cl < max_cols and r.f(1, "increment_tile_cols_log2"):
            cl += 1
        rl = max(min_tiles - cl, 0)
        while rl < max_rows and r.f(1, "increment_tile_rows_log2"):
            rl += 1
    else:
        widest, start, n = 0, 0, 0
        while start < sb_cols:
            size = r.ns(min(sb_cols - start, max_tw), "width_in_sbs_minus_1") + 1
            widest = max(widest, size)
            start += size
            n += 1
        cl = tlog2(1, n)
        area = (sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles > 0 else sb_rows * sb_cols
        max_th = max(area // widest, 1)
        start, n = 0, 0
        while start < sb_rows:
            start += r.ns(min(sb_rows - start, max_th), "height_in_sbs_minus_1") + 1
            n += 1
        rl = tlog2(1, n)
    if cl or rl:
        r.f(cl + rl, "context_update_tile_id")
        r.f(2, "tile_size_bytes_minus_1")
    # quantisation
    base_q = r.f(8, "base_q_idx")
    deltas = []

    def dq(name):
        v = r.su(7, name) if r.f(1, name + "_coded") else 0
        deltas.append(v)

    dq("delta_q_y_dc")
    if not s["mono"]:
        diff = r.f(1, "diff_uv_delta") if s["separate_uv_delta_q"] else 0
        dq("delta_q_u_dc")
        dq("delta_q_u_ac")
        if diff:
            dq("delta_q_v_dc")
            dq("delta_q_v_ac")
    if r.f(1, "using_qmatrix"):
        r.f(4, "qm_y")
        r.f(4, "qm_u")
        if s["separate_uv_delta_q"]:
            r.f(4, "qm_v")
    # segmentation
    alt_q = [0] * 8
    if r.f(1, "segmentation_enabled"):
        bits, sgn = (8, 6, 6, 6, 6, 3, 0, 0), (1, 1, 1, 1, 1, 0, 0, 0)
        for i in range(8):
            for j in range(8):
                if r.f(1, "feature_enabled"):
                    v = (r.su(1 + bits[j], "feature_value") if sgn[j]
                         else r.f(bits[j], "feature_value"))
                    if j == 0:
                        alt_q[i] = max(-255, min(255, v))
    delta_q_present = r.f(1, "delta_q_present") if base_q > 0 else 0
    if delta_q_present:
        r.f(2, "delta_q_res")
        if not intrabc and r.f(1, "delta_lf_present"):
            r.f(2, "delta_lf_res")
            r.f(1, "delta_lf_multi")
    coded_lossless = all(max(0, min(255, base_q + alt_q[i])) == 0 for i in range(8)) \
        and not any(deltas)
    h["coded_lossless"] = coded_lossless
    if not coded_lossless and not intrabc:
        l0, l1 = r.f(6, "loop_filter_level_0"), r.f(6, "loop_filter_level_1")
        if not s["mono"] and (l0 or l1):
            r.f(6, "loop_filter_level_2")
            r.f(6, "loop_filter_level_3")
        r.f(3, "loop_filter_sharpness")
        if r.f(1, "loop_filter_delta_enabled") and r.f(1, "loop_filter_delta_update"):
            for _ in range(8):
                if r.f(1, "update_ref_delta"):
                    r.su(7, "loop_filter_ref_deltas")
            for _ in range(2):
                if r.f(1, "update_mode_delta"):
                    r.su(7, "loop_filter_mode_deltas")
    if not coded_lossless and not intrabc and s["enable_cdef"]:
        r.f(2, "cdef_damping_minus_3")
        nb = r.f(2, "cdef_bits")
        for _ in range(1 << nb):
            r.f(6, "cdef_y_strength")
            if not s["mono"]:
                r.f(6, "cdef_uv_strength")
    h["lr"] = 0
    if not coded_lossless and not intrabc and s["enable_restoration"]:
        uses, chroma = 0, 0
        for p in range(1 if s["mono"] else 3):
            t = r.f(2, "lr_type")
            if t:
                uses, chroma = 1, chroma or p > 0
        h["lr"] = uses
        if uses:
            shift = r.f(1, "lr_unit_shift")
            if not s["use128"] and shift:
                r.f(1, "lr_unit_extra_shift")
            if s["ssx"] and s["ssy"] and chroma:
                r.f(1, "lr_uv_shift")
    if not coded_lossless:
        r.f(1, "tx_mode_select")
    r.f(1, "reduced_tx_set")
    if s["film_grain_present"] and (h["show_frame"] or h["showable_frame"]):
        if r.f(1, "apply_grain"):
            r.f(16, "grain_seed")
            ny = r.f(4, "num_y_points")
            for _ in range(ny):
                r.f(8, "point_y_value")
                r.f(8, "point_y_scaling")
            csfl = 0 if s["mono"] else r.f(1, "chroma_scaling_from_luma")
            ncb = ncr = 0
            if not (s["mono"] or csfl or (s["ssx"] and s["ssy"] and ny == 0)):
                ncb = r.f(4, "num_cb_points")
                for _ in range(ncb):
                    r.f(16, "point_cb")
                ncr = r.f(4, "num_cr_points")
                for _ in range(ncr):
                    r.f(16, "point_cr")
            r.f(2, "grain_scaling_minus_8")
            lag = r.f(2, "ar_coeff_lag")
            npos = 2 * lag * (lag + 1)
            if ny:
                r.f(8 * npos, "ar_coeffs_y")
            if csfl or ncb:
                r.f(8 * (npos + (1 if ny else 0)), "ar_coeffs_cb")
            if csfl or ncr:
                r.f(8 * (npos + (1 if ny else 0)), "ar_coeffs_cr")
            r.f(2, "ar_coeff_shift_minus_6")
            r.f(2, "grain_scale_shift")
            if ncb:
                r.f(8 + 8 + 9, "cb_mult_luma_offset")
            if ncr:
                r.f(8 + 8 + 9, "cr_mult_luma_offset")
            r.f(1, "overlap_flag")
            r.f(1, "clip_to_restricted_range")
    return h, r.toks, r.pos


# ----------------------------------------------------------------- OBUs -----

def _leb128(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def split_obus(d):
    """[(header byte, extension byte or None, payload)] of an OBU sequence
    (every OBU with its size field)."""
    out, pos = [], 0
    while pos < len(d):
        h = d[pos]
        pos += 1
        ext = None
        if h & 4:
            ext = d[pos]
            pos += 1
        if not h & 2:
            out.append((h, ext, bytes(d[pos:])))
            break
        size = shift = 0
        while True:
            b = d[pos]
            pos += 1
            size |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        out.append((h, ext, bytes(d[pos:pos + size])))
        pos += size
    return out


def join_obus(obus):
    out = b""
    for h, ext, body in obus:
        out += (bytes([h | 2]) + (bytes([ext]) if ext is not None else b"")
                + _leb128(len(body)) + body)
    return out


def _rewrite_obus(d, seq_fn=None, frame_fn=None, strict=True):
    """The OBUs of ``d`` with each sequence header's payload passed through
    ``seq_fn(s, toks) -> toks`` and each key frame header through
    ``frame_fn(s, h, toks) -> toks`` (parsed with the sequence header as
    it was; the tile group re-aligned after it). Unless ``strict``, a frame
    header that is not a key frame's, or has no sequence header before it
    in ``d``, is kept as it is."""
    out, s = [], None
    for h, ext, body in split_obus(d):
        typ = (h >> 3) & 15
        if typ == 1:
            s, toks = parse_sequence_header(body)
            if seq_fn is not None:
                body = _emit(seq_fn(s, toks))
        elif typ in (3, 6) and frame_fn is not None:
            if s is None:
                if strict:
                    raise RewriteError("a frame header before its sequence header")
                out.append((h, ext, body))
                continue
            tid, sid = (ext >> 5, (ext >> 3) & 3) if ext is not None else (0, 0)
            try:
                fh, toks, end = parse_frame_header(body, s, tid, sid)
            except RewriteError:
                if strict:
                    raise
                out.append((h, ext, body))
                continue
            toks = frame_fn(s, fh, toks)
            if typ == 6:
                body = _emit(toks, trailing=False) + body[(end + 7) >> 3:]
            else:
                body = _emit(toks)
        out.append((h, ext, body))
    return join_obus(out)


# ------------------------------------------------------------ the file ------

def _walk(d, start, end, path=()):
    """(path of types, type, payload start, end) of every box, into the
    containers, ``meta`` (a full box), the ``stsd`` entries and ``av01``."""
    for t, s, e in boxes(d, start, end):
        yield path, t, s, e
        if t in CONTAINERS:
            yield from _walk(d, s, e, path + (t,))
        elif t == b"meta":
            yield from _walk(d, s + 4, e, path + (t,))
        elif t == b"stsd":
            yield from _walk(d, s + 8, e, path + (t,))
        elif t == b"av01":
            yield from _walk(d, s + 78, e, path + (t,))


def _iloc_entries(d, s):
    """[(item id, method, field offset of the extent offset, its width,
    field offset of the length, its width)] of an iloc box's payload at s
    (one extent per item)."""
    v = d[s]
    p = s + 4
    osz, lsz, bsz = d[p] >> 4, d[p] & 15, d[p + 1] >> 4
    isz = d[p + 1] & 15 if v in (1, 2) else 0
    p += 2
    n = int.from_bytes(d[p:p + (2 if v < 2 else 4)], "big")
    p += 2 if v < 2 else 4
    out = []
    for _ in range(n):
        iid = int.from_bytes(d[p:p + (2 if v < 2 else 4)], "big")
        p += 2 if v < 2 else 4
        method = 0
        if v in (1, 2):
            method = int.from_bytes(d[p:p + 2], "big") & 15
            p += 2
        p += 2
        base = int.from_bytes(d[p:p + bsz], "big") if bsz else 0
        p += bsz
        count = int.from_bytes(d[p:p + 2], "big")
        p += 2
        for k in range(count):
            p += isz
            if count != 1:
                raise RewriteError("an item of several extents")
            out.append((iid, method, base, p, osz, p + osz, lsz))
            p += osz + lsz
    return out


def _item_types(d):
    """item id -> type (the meta's infe entries, versions 2 and 3)."""
    out = {}
    for path, t, s, e in _walk(d, 0, len(d)):
        if t == b"iinf" and path == (b"meta",):
            for t2, s2, e2 in boxes(d, s + (6 if d[s] == 0 else 8), e):
                v = d[s2]
                if t2 == b"infe" and v in (2, 3):
                    k = 2 if v == 2 else 4
                    iid = int.from_bytes(d[s2 + 4:s2 + 4 + k], "big")
                    out[iid] = bytes(d[s2 + 6 + k:s2 + 10 + k])
    return out


def _samples(d, stbl):
    """[(offset, size, field offset of the size in stsz)] of a track's samples."""
    chunks, stsc, sizes = [], [], []
    for path, t, s, e in _walk(d, *stbl):
        if t in (b"stco", b"co64"):
            k = 4 if t == b"stco" else 8
            n = struct.unpack_from(">I", d, s + 4)[0]
            chunks = [(int.from_bytes(d[s + 8 + i * k:s + 8 + (i + 1) * k], "big"),
                       s + 8 + i * k, k) for i in range(n)]
        elif t == b"stsc":
            n = struct.unpack_from(">I", d, s + 4)[0]
            stsc = [struct.unpack_from(">III", d, s + 8 + 12 * i) for i in range(n)]
        elif t == b"stsz":
            fixed, n = struct.unpack_from(">II", d, s + 4)
            if fixed:
                raise RewriteError("an stsz of one size for every sample")
            sizes = [(struct.unpack_from(">I", d, s + 12 + 4 * i)[0], s + 12 + 4 * i)
                     for i in range(n)]
    out, si = [], 0
    for ci, (off, _, _) in enumerate(chunks):
        per = next(spc for first, spc, _ in reversed(stsc) if first <= ci + 1)
        for _ in range(per):
            if si >= len(sizes):
                break
            out.append((off, sizes[si][0], sizes[si][1]))
            off += sizes[si][0]
            si += 1
    return out, chunks


def _rewrite_file(data, payload_fn, av1c_fn=None, pixi_depth=None, ispe_width=None,
                  samples="all"):
    """``data`` with its AV1 payloads passed through ``payload_fn`` (each
    byte range once: an item that is a track's sample is rewritten with
    it); the av1C bodies through ``av1c_fn``, the pixi depths set to
    ``pixi_depth``, the ispe widths to ``ispe_width`` (a function of the
    old width). ``samples``: "all", or "first" (sample 0 of the first
    track only; items whose extent is that sample follow it)."""
    d = bytearray(data)
    regions = {}  # (offset, length) -> [("iloc", (length field, width)) | ("sample", stsz field)]
    chunk_fields, iloc = [], []
    tracks = []
    for path, t, s, e in _walk(data, 0, len(data)):
        if t == b"iloc" and path == (b"meta",):
            iloc = _iloc_entries(data, s)
        elif t == b"stbl":
            tracks.append((s, e))
    track_samples = []
    for stbl in tracks:
        smp, chunks = _samples(data, stbl)
        track_samples.append(smp)
        chunk_fields += chunks
    if samples == "first":
        if not track_samples or not track_samples[0]:
            raise RewriteError("no track sample to rewrite")
        off, size, field = track_samples[0][0]
        regions[(off, size)] = [("sample", field)]
    else:
        for smp in track_samples:
            for off, size, field in smp:
                regions.setdefault((off, size), []).append(("sample", field))
    types = _item_types(data)
    for iid, method, base, fo, osz, fl, lsz in iloc:
        if types.get(iid) != b"av01":
            continue
        if method == 1:
            raise RewriteError("an item in idat")
        key = (base + (int.from_bytes(data[fo:fo + osz], "big") if osz else 0),
               int.from_bytes(data[fl:fl + lsz], "big"))
        if samples == "first" and key not in regions:
            continue
        regions.setdefault(key, []).append(("iloc", (fl, lsz)))
    # rewrite the payloads in file order; later offsets move by the deltas
    new = {k: payload_fn(bytes(data[k[0]:k[0] + k[1]])) for k in regions}
    order = sorted(regions)
    for (a, la), (b, _) in zip(order, order[1:]):
        if a + la > b:
            raise RewriteError("overlapping AV1 payloads")

    def moved(pos):
        return pos + sum(len(new[k]) - k[1] for k in order if k[0] + k[1] <= pos and k[0] < pos)

    # the fixed-size fields first (positions in the old file; before any payload)
    for (off, ln), refs in regions.items():
        for kind, ref in refs:
            if kind == "sample":
                struct.pack_into(">I", d, ref, len(new[(off, ln)]))
            else:
                fl, lsz = ref
                d[fl:fl + lsz] = len(new[(off, ln)]).to_bytes(lsz, "big")
    for iid, method, base, fo, osz, fl, lsz in iloc:  # every item's, Exif and grids too
        if method == 0 and osz:
            off = base + int.from_bytes(data[fo:fo + osz], "big")
            d[fo:fo + osz] = (moved(off) - base).to_bytes(osz, "big")
    for off, field, k in chunk_fields:
        d[field:field + k] = moved(off).to_bytes(k, "big")
    for path, t, s, e in _walk(data, 0, len(data)):
        if t == b"av1C" and av1c_fn is not None:
            body = av1c_fn(bytes(data[s:e]))
            if len(body) != e - s:
                raise RewriteError("an av1C that changes size")
            d[s:e] = body
        elif t == b"pixi" and pixi_depth is not None:
            n = data[s + 4]
            d[s + 5:s + 5 + n] = bytes([pixi_depth]) * n
        elif t == b"ispe" and ispe_width is not None:
            struct.pack_into(">I", d, s + 4, ispe_width(struct.unpack_from(">I", data, s + 4)[0]))
    # the payloads, from the last, so earlier positions hold; then the box sizes
    out = bytes(d)
    for off, ln in reversed(order):
        out = out[:off] + new[(off, ln)] + out[off + ln:]
    return _fix_sizes(out, len(out) - len(data), data)


def _fix_sizes(out, delta, old):
    """``out`` with the size of its mdat (which holds every changed payload)
    grown by ``delta``."""
    if not delta:
        return out
    b = bytearray(out)
    p = 0
    for t, s, e in boxes(old, 0, len(old)):
        if t == b"mdat":
            size = struct.unpack_from(">I", b, p)[0]
            if size == 1 or s - p != 8:
                raise RewriteError("an mdat of a 64-bit size")
            if size:
                struct.pack_into(">I", b, p, size + delta)
            return bytes(b)
        p = e
    raise RewriteError("no mdat")


# ----------------------------------------------------------- the forms ------

def _av1c_depth(depth):
    def fn(b):
        b = bytearray(b)
        if len(b) > 4:
            raise RewriteError("an av1C with config OBUs")
        profile = b[1] >> 5
        mono, sx, sy = (b[2] >> 4) & 1, (b[2] >> 3) & 1, (b[2] >> 2) & 1
        if depth == 12:
            profile = 2
        b[1] = (profile << 5) | (b[1] & 31)
        b[2] = (b[2] & 0x80) | 0x40 | (0x20 if depth == 12 else 0) | (mono << 4) | (sx << 3) \
            | (sy << 2) | (b[2] & 3)
        return bytes(b)

    return fn


def to_high_bitdepth(data, depth, screen_content_ok=False):
    """``data`` (an AVIF file of 8-bit AV1) with every AV1 stream at
    ``depth`` (10 or 12) bits."""
    if depth not in (10, 12):
        raise RewriteError(f"a depth of {depth}")

    def frame_fn(s, h, toks):
        if h["allow_screen_content_tools"] and not screen_content_ok:
            raise RewriteError("a frame that allows screen content tools (a palette's colours "
                               "are literals of the bit depth)")
        return toks

    def payload(d):
        return _rewrite_obus(d, lambda s, t: _high_bitdepth_tokens(s, t, depth), frame_fn,
                             strict=False)

    return _rewrite_file(data, payload, _av1c_depth(depth), pixi_depth=depth)


def superres_width(coded_width, denominator):
    """The largest upscaled width whose superres-downscaled width
    ((w * 8 + d / 2) / d) is ``coded_width``."""
    w = (coded_width * denominator) // 8 + denominator
    while (w * 8 + denominator // 2) // denominator != coded_width:
        w -= 1
        if w < coded_width:
            raise RewriteError(f"no width downscales to {coded_width} by {denominator}/8")
    return w


def to_superres(data, denominator, upscaled_width=None, restoration_ok=False):
    """``data`` (an AVIF still image) with its frame coded at superres
    ``denominator`` (9-16): the upscaled width ``upscaled_width`` (by
    default the largest whose downscaled width is the coded width).
    ``restoration_ok`` rewrites a frame with loop restoration all the same
    (a stream whose tiles misparse: a decoder must refuse it before)."""
    if not 9 <= denominator <= 16:
        raise RewriteError(f"a superres denominator of {denominator}")
    widths = {}

    def seq_fn(s, toks):
        if not s["reduced"] and not s["still"]:
            raise RewriteError("superres of a sequence")
        if s["enable_superres"]:
            raise RewriteError("a sequence header that already enables superres")
        w = upscaled_width or superres_width(s["max_w"], denominator)
        if (w * 8 + denominator // 2) // denominator != s["max_w"]:
            raise RewriteError(f"{w} does not downscale to {s['max_w']} by {denominator}/8")
        widths[s["max_w"]] = w
        toks = [list(t) for t in toks]
        fwb = max(s["fwb"], (w - 1).bit_length())
        toks[_index(toks, "frame_width_bits_minus_1")][2] = fwb - 1
        i = _index(toks, "max_frame_width_minus_1")
        toks[i][1], toks[i][2] = fwb, w - 1
        toks[_index(toks, "enable_superres")][2] = 1
        return toks

    def frame_fn(s, h, toks):
        if h["lr"] and not restoration_ok:
            raise RewriteError("a frame with loop restoration (its units are counted on the "
                               "upscaled width)")
        if h["allow_screen_content_tools"]:
            raise RewriteError("a frame that allows screen content tools (superres removes "
                               "allow_intrabc)")
        if "frame_width_minus_1" in [t[0] for t in toks]:
            raise RewriteError("a frame size override")
        toks = [list(t) for t in toks]
        if h["coded_lossless"] and s["enable_restoration"]:
            # a lossless frame is not AllLossless under superres: its
            # restoration types are read (none, for every plane)
            j = _index(toks, "reduced_tx_set")
            toks[j:j] = [["lr_type", 2, 0] for _ in range(1 if s["mono"] else 3)]
        i = _index(toks, "<superres>")
        toks[i + 1:i + 1] = [["use_superres", 1, 1], ["coded_denom", 3, denominator - 9]]
        return toks

    def payload(d):
        return _rewrite_obus(d, seq_fn, frame_fn)

    out = _rewrite_file(data, payload,
                        ispe_width=lambda w: widths.get(w, w) if widths else w)
    if not widths:
        raise RewriteError("no sequence header")
    return out


def hide_key_frame(data, slot=0):
    """``data`` (an ``avis`` sequence) with sample 0 of its colour track a
    hidden key frame shown by an ``OBU_FRAME_HEADER`` of
    ``show_existing_frame`` (``frame_to_show_map_idx`` ``slot``)."""
    def payload(d):
        obus = split_obus(d)
        s, out, shown = None, [], False
        for h, ext, body in obus:
            typ = (h >> 3) & 15
            if typ == 1:
                s, _ = parse_sequence_header(body)
                if s["reduced"]:
                    raise RewriteError("a reduced still-picture header (no frame can be hidden)")
            if typ in (3, 6) and not shown:
                tid, sid = (ext >> 5, (ext >> 3) & 3) if ext is not None else (0, 0)
                fh, toks, end = parse_frame_header(body, s, tid, sid)
                if not fh["show_frame"]:
                    raise RewriteError("a key frame already hidden")
                toks = [list(t) for t in toks]
                i = _index(toks, "show_frame")
                toks[i][2] = 0
                if i + 1 < len(toks) and toks[i + 1][0] == "frame_presentation_time":
                    del toks[i + 1]
                toks[i + 1:i + 1] = [["showable_frame", 1, 1], ["error_resilient_mode", 1, 0]]
                j = _index(toks, "<superres>")
                while toks[j - 1][0] in ("frame_width_minus_1", "frame_height_minus_1"):
                    j -= 1
                toks.insert(j, ["refresh_frame_flags", 8, 0xFF])
                if typ == 6:
                    body = _emit(toks, trailing=False) + body[(end + 7) >> 3:]
                else:
                    body = _emit(toks)
                out.append((h, ext, body))
                show = _Writer()
                show.f(1, 1)
                show.f(3, slot)
                if s["decoder_model_info_present"] and not s["equal_picture_interval"]:
                    show.f(s["frame_presentation_time_length"], 0)
                if s["frame_id_numbers_present"]:
                    raise RewriteError("frame ids (display_frame_id)")
                shown = True
                out.append(((3 << 3) | (h & 4), ext, show.bytes(True)))
                continue
            out.append((h, ext, body))
        if not shown:
            raise RewriteError("no key frame in sample 0")
        return join_obus(out)

    if b"moov" not in {t for t, _, _ in boxes(data, 0, len(data))}:
        raise RewriteError("an image item (a hidden frame needs an avis track)")
    return _rewrite_file(data, payload, samples="first")


def set_base_q_idx(data, q):
    """``data`` with each key frame's ``base_q_idx`` set to ``q`` (in the same
    coefficient-CDF context as the source's, its tiles parse alike): larger
    dequantised coefficients, a stream whose transforms may leave the range
    the specification requires."""
    def frame_fn(s, h, toks):
        toks = [list(t) for t in toks]
        toks[_index(toks, "base_q_idx")][2] = q
        return toks

    return _rewrite_file(data, lambda d: _rewrite_obus(d, None, frame_fn, strict=False))
