"""AV1 header rewrites of AVIF files: the forms of a stream that differ from
PIL's own writer's files (8-bit key frames, and sequences whose samples
hold one shown frame each) only in their uncompressed headers and in how
their frame OBUs fall into samples.

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
  the ``ispe`` widened to the upscaled width. Refused where the frame
  allows screen content (whose ``allow_intrabc`` superres removes), or
  uses loop restoration whose units (counted on the upscaled width) a
  superblock column reads in other numbers than without superres.
- ``hide_key_frame(data)``: in sample 0 of an ``avis`` colour track, the
  key frame made hidden (``show_frame`` 0, ``showable_frame`` 1,
  ``error_resilient_mode`` 0, ``refresh_frame_flags`` 0xFF inserted) and
  an ``OBU_FRAME_HEADER`` with ``show_existing_frame`` 1 showing slot 0
  appended.
- ``splice_frames(data, n)``: sample 0 of every track of an ``avis``
  sequence (colour and alpha) made of its key frame, hidden, and the frame
  OBUs of samples 1 to n - 1 (temporal delimiters and sequence headers
  dropped), every frame but the last hidden (``showable_frame`` 1): the
  sample's shown frame is the source's frame n - 1, decoded through inter
  frames (and through the hidden frames an encoder codes ahead).
- ``to_intra_only(data)``: sample 0's key frame hidden, then the same frame
  again as an intra-only frame (``frame_type`` 2, ``error_resilient_mode``
  0, ``refresh_frame_flags`` not 0xFF), whose tile data parses as the key
  frame's.

Each frame header is parsed bit by bit (key frames, and with the reference
slots followed through (``Slots``) intra-only and inter frames: the whole
uncompressed header of spec 5.9; the full and reduced sequence headers),
re-emitted with its fields changed, re-aligned before
its tile group, and its OBU size rewritten; every AV1 payload of the file
(``av01`` items in the ``mdat``, track samples) is rewritten and the
``iloc`` extents, ``stco`` / ``co64`` offsets and ``stsz`` sizes move with
it. The standard library only.

    from tools.av1_rewrite import to_high_bitdepth, splice_frames
    ten = to_high_bitdepth(open("x.avif", "rb").read(), 10)
    inter0 = splice_frames(open("seq.avif", "rb").read(), 2)
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
    s["enable_warped_motion"] = s["enable_ref_frame_mvs"] = 0
    if s["reduced"]:
        s["force_sct"], s["force_imv"] = 2, 2
    else:
        tools = r.f(4, "inter_tools")
        s["enable_warped_motion"] = (tools >> 1) & 1
        s["enable_order_hint"] = r.f(1, "enable_order_hint")
        if s["enable_order_hint"]:
            s["enable_ref_frame_mvs"] = r.f(2, "jnt_comp_ref_frame_mvs") & 1
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

class Slots:
    """The reference slots of a stream, as far as the headers after them
    read them: each slot's order hint, sizes (upscaled width, height,
    render size) and segment q deltas (for CodedLossless)."""

    def __init__(self):
        self.slots = [None] * 8

    def refresh(self, h):
        for i in range(8):
            if (h["refresh_frame_flags"] >> i) & 1:
                self.slots[i] = {k: h[k] for k in ("order_hint", "width", "height", "render",
                                                   "alt_q", "alt_q_on")}


def _rel(s, a, b):
    if not s["enable_order_hint"]:
        return 0
    m = 1 << (s["order_hint_bits"] - 1)
    d = a - b
    return (d & (m - 1)) - (d & m)


def parse_frame_header(body, s, temporal_id=0, spatial_id=0, slots=None):
    """(fields, field log, the bit position after the header) of a frame's
    uncompressed header (OBU_FRAME or OBU_FRAME_HEADER payload, spec 5.9):
    key frames, and with ``slots`` (a ``Slots``, which the caller refreshes
    with the fields) intra-only and inter frames too."""
    r = _Reader(body)
    h = {"show_frame": 1, "showable_frame": 0, "frame_type": 0, "refresh_frame_flags": 0xFF,
         "error_resilient_mode": 1, "order_hint": 0}
    if not s["reduced"]:
        if r.f(1, "show_existing_frame"):
            raise RewriteError("a show_existing_frame header")
        h["frame_type"] = r.f(2, "frame_type")
        if h["frame_type"] != 0 and slots is None:
            raise RewriteError("a frame that is not a key frame")
        if h["frame_type"] == 3:
            raise RewriteError("a switch frame")
        h["show_frame"] = r.f(1, "show_frame")
        if h["show_frame"] and s["decoder_model_info_present"] and not s["equal_picture_interval"]:
            r.f(s["frame_presentation_time_length"], "frame_presentation_time")
        if h["show_frame"]:
            h["showable_frame"] = int(h["frame_type"] != 0)
        else:
            h["showable_frame"] = r.f(1, "showable_frame")
        if not (h["frame_type"] == 0 and h["show_frame"]):
            h["error_resilient_mode"] = r.f(1, "error_resilient_mode")
    intra = h["frame_type"] in (0, 2)
    r.f(1, "disable_cdf_update")
    disable_cdf_update = r.toks[-1][2]
    sct = r.f(1, "allow_screen_content_tools") if s["force_sct"] == 2 else s["force_sct"]
    h["allow_screen_content_tools"] = sct
    force_imv = 0
    if sct:
        force_imv = r.f(1, "force_integer_mv") if s["force_imv"] == 2 else s["force_imv"]
    if intra:
        force_imv = 1
    if s["frame_id_numbers_present"]:
        if not intra:
            raise RewriteError("frame ids on an inter frame")
        r.f(s["id_len"], "current_frame_id")
    override = 0 if s["reduced"] else r.f(1, "frame_size_override_flag")
    h["order_hint"] = r.f(s["order_hint_bits"], "order_hint")
    primary = 7 if intra or h["error_resilient_mode"] else r.f(3, "primary_ref_frame")
    if s["decoder_model_info_present"]:
        if r.f(1, "buffer_removal_time_present_flag"):
            for idc, present in zip(s["op_idc"], s["op_decoder_model_present"]):
                if not present:
                    continue
                in_t, in_s = (idc >> temporal_id) & 1, (idc >> (spatial_id + 8)) & 1
                if idc == 0 or (in_t and in_s):
                    r.f(s["buffer_removal_time_length"], "buffer_removal_time")
    if not (h["frame_type"] == 0 and h["show_frame"]):
        h["refresh_frame_flags"] = r.f(8, "refresh_frame_flags")
        if h["frame_type"] == 0 and h["refresh_frame_flags"] != 0xFF:
            raise RewriteError("a hidden key frame that does not refresh every slot")
    if ((not intra or h["refresh_frame_flags"] != 0xFF) and h["error_resilient_mode"]
            and s["enable_order_hint"]):
        for _ in range(8):
            r.f(s["order_hint_bits"], "ref_order_hint")
    refs = []
    found = None
    if not intra:
        if s["enable_order_hint"] and r.f(1, "frame_refs_short_signaling"):
            raise RewriteError("frame_refs_short_signaling")
        for _ in range(7):
            i = r.f(3, "ref_frame_idx")
            if slots.slots[i] is None:
                raise RewriteError(f"a reference slot ({i}) that holds no frame")
            refs.append(slots.slots[i])
        if override and not h["error_resilient_mode"]:
            for ref in refs:
                if r.f(1, "found_ref"):
                    found = ref
                    break
    if found is not None:
        w, hh = found["width"], found["height"]
        h["render"] = found["render"]
    else:
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
    if found is None:
        h["render"] = (w, hh)
        if r.f(1, "render_and_frame_size_different"):
            h["render"] = (r.f(16, "render_width_minus_1") + 1, r.f(16, "render_height_minus_1") + 1)
    intrabc = r.f(1, "allow_intrabc") if sct and intra else 0
    if not intra:
        hp = 0 if force_imv else r.f(1, "allow_high_precision_mv")
        h["allow_high_precision_mv"] = hp
        if not r.f(1, "is_filter_switchable"):
            r.f(2, "interpolation_filter")
        r.f(1, "is_motion_mode_switchable")
        if not h["error_resilient_mode"] and s["enable_ref_frame_mvs"]:
            r.f(1, "use_ref_frame_mvs")
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
    # segmentation (the q deltas carried from the primary reference frame
    # where the data is not updated)
    prev = refs[primary] if primary != 7 else None
    alt_q, alt_q_on = ([0] * 8, [0] * 8) if prev is None else (list(prev["alt_q"]),
                                                                  list(prev["alt_q_on"]))
    seg = r.f(1, "segmentation_enabled")
    update_data = 0
    if seg:
        if primary == 7:
            update_data = 1
        else:
            if r.f(1, "segmentation_update_map"):
                r.f(1, "segmentation_temporal_update")
            update_data = r.f(1, "segmentation_update_data")
    if not seg or update_data:
        alt_q, alt_q_on = [0] * 8, [0] * 8
    if update_data:
        bits, sgn = (8, 6, 6, 6, 6, 3, 0, 0), (1, 1, 1, 1, 1, 0, 0, 0)
        for i in range(8):
            for j in range(8):
                if r.f(1, "feature_enabled"):
                    v = (r.su(1 + bits[j], "feature_value") if sgn[j]
                         else r.f(bits[j], "feature_value"))
                    if j == 0:
                        alt_q[i], alt_q_on[i] = max(-255, min(255, v)), 1
    h["alt_q"], h["alt_q_on"] = alt_q, alt_q_on
    delta_q_present = r.f(1, "delta_q_present") if base_q > 0 else 0
    if delta_q_present:
        r.f(2, "delta_q_res")
        if not intrabc and r.f(1, "delta_lf_present"):
            r.f(2, "delta_lf_res")
            r.f(1, "delta_lf_multi")
    qi = [max(0, min(255, base_q + alt_q[i])) if seg and alt_q_on[i] else base_q for i in range(8)]
    coded_lossless = all(q == 0 for q in qi) and not any(deltas)
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
    h["lr"], h["lr_types"], h["lr_unit"] = 0, [0, 0, 0], [64, 64, 64]
    if not coded_lossless and not intrabc and s["enable_restoration"]:
        uses, chroma = 0, 0
        for p in range(1 if s["mono"] else 3):
            t = r.f(2, "lr_type")
            h["lr_types"][p] = t
            if t:
                uses, chroma = 1, chroma or p > 0
        h["lr"] = uses
        if uses:
            shift = r.f(1, "lr_unit_shift")
            if s["use128"]:
                shift += 1
            elif shift:
                shift += r.f(1, "lr_unit_extra_shift")
            uv = r.f(1, "lr_uv_shift") if s["ssx"] and s["ssy"] and chroma else 0
            h["lr_unit"] = [64 << shift, (64 << shift) >> uv, (64 << shift) >> uv]
    if not coded_lossless:
        r.f(1, "tx_mode_select")
    reference_select = 0 if intra else r.f(1, "reference_select")
    if not intra and reference_select and s["enable_order_hint"]:
        # skip_mode_params: a forward and a backward (or second forward) reference
        hints = [ref["order_hint"] for ref in refs]
        cur = h["order_hint"]
        fwd = [x for x in hints if _rel(s, x, cur) < 0]
        bwd = [x for x in hints if _rel(s, x, cur) > 0]
        allowed = bool(fwd) and bool(bwd)
        if fwd and not bwd:
            near = fwd[0]
            for x in fwd:
                if _rel(s, x, near) > 0:
                    near = x
            allowed = any(_rel(s, x, near) < 0 for x in hints)
        if allowed:
            r.f(1, "skip_mode_present")
    if not intra and not h["error_resilient_mode"] and s["enable_warped_motion"]:
        r.f(1, "allow_warped_motion")
    r.f(1, "reduced_tx_set")
    if not intra:
        hp = h["allow_high_precision_mv"]
        for _ in range(7):
            typ = 0
            if r.f(1, "is_global"):
                typ = 2 if r.f(1, "is_rot_zoom") else (1 if r.f(1, "is_translation") else 3)
            params = ([2, 3] + ([4, 5] if typ == 3 else [])) if typ >= 2 else []
            params += [0, 1] if typ >= 1 else []
            for idx in params:
                if idx < 2:
                    absb = (9 - (not hp)) if typ == 1 else 12
                else:
                    absb = 12
                _subexp(r, 2 * (1 << absb) + 1)
    if s["film_grain_present"] and (h["show_frame"] or h["showable_frame"]):
        if r.f(1, "apply_grain"):
            r.f(16, "grain_seed")
            if h["frame_type"] == 1 and not r.f(1, "update_grain"):
                r.f(3, "film_grain_params_ref_idx")
                return h, r.toks, r.pos
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


def _subexp(r, num_syms):
    """decode_subexp (5.9.26) of a global motion parameter: its bits."""
    i, mk, k = 0, 0, 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            r.ns(num_syms - mk, "subexp_final_bits")
            return
        if not r.f(1, "subexp_more_bits"):
            r.f(b2, "subexp_bits")
            return
        i += 1
        mk += a


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
    old width). ``samples``: "all", "first" (sample 0 of the first track
    only) or "zero" (sample 0 of every track); items whose extent is such a
    sample follow it."""
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
    if samples in ("first", "zero"):
        if not track_samples or not track_samples[0]:
            raise RewriteError("no track sample to rewrite")
        for smp in track_samples[:1] if samples == "first" else track_samples:
            off, size, field = smp[0]
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
        if samples != "all" and key not in regions:
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


def _lr_units_per_sb(s, h, plane, width, up, denominator):
    """The loop-restoration units each superblock column of a frame of
    coded ``width`` reads in ``plane`` (spec 5.11.57 ``read_lr``), upscaled
    to ``up`` at ``denominator`` (8: none): unit columns counted on the
    upscaled width, a superblock's through ``SuperresDenom``."""
    unit = h["lr_unit"][plane]
    sx = s["ssx"] if plane else 0
    cols = max((((up + sx) >> sx) + (unit >> 1)) // unit, 1)
    num, den = (4 >> sx) * denominator, unit * 8
    mi_cols = 2 * ((width + 7) >> 3)
    sb4 = 32 if s["use128"] else 16
    out = []
    for c in range(0, mi_cols, sb4):
        start = (c * num + den - 1) // den
        end = min(cols, ((c + sb4) * num + den - 1) // den)
        out.append(max(end - start, 0))
    return out


def to_superres(data, denominator, upscaled_width=None):
    """``data`` (an AVIF still image) with its frame coded at superres
    ``denominator`` (9-16): the upscaled width ``upscaled_width`` (by
    default the largest whose downscaled width is the coded width). A
    frame with loop restoration is rewritten where every superblock column
    reads as many restoration units of each plane as without superres (its
    tile data then parses as it stands), refused otherwise."""
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
        if h["lr"]:
            w, up = s["max_w"], widths[s["max_w"]]
            for p in range(1 if s["mono"] else 3):
                if h["lr_types"][p] and (_lr_units_per_sb(s, h, p, w, w, 8)
                                         != _lr_units_per_sb(s, h, p, w, up, denominator)):
                    raise RewriteError(f"a frame whose loop restoration units of plane {p} "
                                       "fall otherwise under superres (counted on the "
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
        s, out, shown = None, [], False
        for h, ext, body in split_obus(d):
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
                out.append((h, ext, _reheader(typ, body, _hidden(toks, fh), end)))
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


# ------------------------------------------------------ inter frame 0 ------

def track_samples(data):
    """The samples of each track of ``data`` (colour first, as the file
    lists them), as bytes."""
    out = []
    for path, t, s, e in _walk(data, 0, len(data)):
        if t == b"stbl":
            smp, _ = _samples(data, (s, e))
            out.append([bytes(data[o:o + n]) for o, n, _ in smp])
    return out


def _hidden(toks, h):
    """A frame header's fields with the frame hidden (``show_frame`` 0,
    ``showable_frame`` 1; a key frame also ``error_resilient_mode`` 0 and
    ``refresh_frame_flags`` 0xFF, which a shown key frame implies)."""
    toks = [list(t) for t in toks]
    i = _index(toks, "show_frame")
    toks[i][2] = 0
    if i + 1 < len(toks) and toks[i + 1][0] == "frame_presentation_time":
        del toks[i + 1]
    if h["frame_type"] == 0:
        toks[i + 1:i + 1] = [["showable_frame", 1, 1], ["error_resilient_mode", 1, 0]]
        j = _index(toks, "<superres>")
        while toks[j - 1][0] in ("frame_width_minus_1", "frame_height_minus_1"):
            j -= 1
        toks.insert(j, ["refresh_frame_flags", 8, 0xFF])
    else:
        toks.insert(i + 1, ["showable_frame", 1, 1])
    return toks


def _reheader(typ, body, toks, end):
    if typ == 6:
        return _emit(toks, trailing=False) + body[(end + 7) >> 3:]
    return _emit(toks)


def _splice(samples):
    """Sample 0 of a track made of its ``samples``: the key frame hidden,
    then the frame OBUs of the others (temporal delimiters and sequence
    headers dropped), every frame but the last hidden (a
    show_existing_frame header before the last dropped)."""
    obus = list(split_obus(samples[0]))
    for smp in samples[1:]:
        obus += [o for o in split_obus(smp) if (o[0] >> 3) & 15 in (3, 4, 5, 6)]
    frames = [k for k, (h, _, body) in enumerate(obus) if (h >> 3) & 15 in (3, 6)]
    if len(frames) < 2:
        raise RewriteError("fewer than two frames to splice")
    last = frames[-1]
    s, slots, out = None, Slots(), []
    for k, (h, ext, body) in enumerate(obus):
        typ = (h >> 3) & 15
        if typ == 1:
            s, _ = parse_sequence_header(body)
            if s["reduced"]:
                raise RewriteError("a reduced still-picture header")
        if typ in (3, 6):
            if body and body[0] & 0x80:  # show_existing_frame
                if k != last:
                    continue
                out.append((h, ext, body))
                continue
            tid, sid = (ext >> 5, (ext >> 3) & 3) if ext is not None else (0, 0)
            fh, toks, end = parse_frame_header(body, s, tid, sid, slots)
            if k != last:
                if not fh["show_frame"] and fh["frame_type"] == 0:
                    raise RewriteError("a hidden key frame in the source")
                if fh["show_frame"]:
                    toks = _hidden(toks, fh)
                    body = _reheader(typ, body, toks, end)
                fh["refresh_frame_flags"] = fh["refresh_frame_flags"] if fh["frame_type"] else 0xFF
            elif not fh["show_frame"]:
                raise RewriteError("the last frame of the splice is hidden")
            slots.refresh(fh)
        out.append((h, ext, body))
    return join_obus(out)


def splice_frames(data, n):
    """``data`` (an ``avis`` sequence) with sample 0 of every track (colour
    and alpha) the hidden key frame followed by the frames of samples 1 to
    ``n - 1``: frame 0 is then the source's frame ``n - 1``, decoded
    through inter (or intra-only) frames."""
    if b"moov" not in {t for t, _, _ in boxes(data, 0, len(data))}:
        raise RewriteError("an image item (a splice needs an avis track)")
    new = {}
    for smp in track_samples(data):
        if len(smp) < n:
            raise RewriteError(f"a track of {len(smp)} samples (the splice needs {n})")
        new[smp[0]] = _splice(smp[:n])
    return _rewrite_file(data, lambda d: new[d], samples="zero")


def to_intra_only(data, refresh=0x01):
    """``data`` (an ``avis`` sequence) with sample 0 of every track the key
    frame hidden, then the same frame as an intra-only frame (``frame_type``
    2, ``error_resilient_mode`` 0, ``refresh_frame_flags`` ``refresh``, not
    0xFF): its tile data parses as the key frame's, and it decodes to the
    same pixels."""
    if refresh == 0xFF:
        raise RewriteError("an intra-only frame refreshes less than every slot")

    def payload(d):
        s, out, done = None, [], False
        for h, ext, body in split_obus(d):
            typ = (h >> 3) & 15
            if typ == 1:
                s, _ = parse_sequence_header(body)
                if s["reduced"]:
                    raise RewriteError("a reduced still-picture header")
            if typ in (3, 6) and not done:
                if typ == 3:
                    raise RewriteError("a frame header OBU (the rewrite repeats an OBU_FRAME)")
                tid, sid = (ext >> 5, (ext >> 3) & 3) if ext is not None else (0, 0)
                fh, toks, end = parse_frame_header(body, s, tid, sid)
                if not fh["show_frame"]:
                    raise RewriteError("a key frame already hidden")
                out.append((h, ext, _reheader(typ, body, _hidden(toks, fh), end)))
                toks = [list(t) for t in toks]
                toks[_index(toks, "frame_type")][2] = 2
                toks.insert(_index(toks, "show_frame") + 1, ["error_resilient_mode", 1, 0])
                j = _index(toks, "<superres>")
                while toks[j - 1][0] in ("frame_width_minus_1", "frame_height_minus_1"):
                    j -= 1
                toks.insert(j, ["refresh_frame_flags", 8, refresh])
                body = _reheader(typ, body, toks, end)
                done = True
            out.append((h, ext, body))
        if not done:
            raise RewriteError("no key frame in sample 0")
        return join_obus(out)

    if b"moov" not in {t for t, _, _ in boxes(data, 0, len(data))}:
        raise RewriteError("an image item (the rewrite needs an avis track)")
    return _rewrite_file(data, payload, samples="zero")
