"""Port parity: the AVIF forms of slice 26 in the PIL-free decoder
(akari_torch/core/avif.py with akari_torch/native/av1_decode.cpp) against
PIL 12.1.0, which reads AVIF through its bundled libavif 1.3.0 (dav1d 1.5.1
decoding) and through which the JAX package's ``read_image`` reads it.

PIL's writer makes key frames and sequences; the forms here are header
rewrites of its files (``tools/av1_rewrite.py``):

- ``splice_frames(data, n)``: sample 0 of every track the hidden key frame
  followed by the frames of samples 1 to n - 1 (every frame but the last
  hidden), so frame 0 is decoded through inter frames: PIL reads the
  source's frame n - 1 from it, an oracle for free;
- ``to_intra_only``: the hidden key frame, then the same frame as an
  intra-only frame (PIL reads the key frame from it);
- ``to_superres`` of frames with loop restoration whose units each
  superblock column reads alike with and without superres.

Tolerance: exact. Every read equals PIL's ``convert("RGB")`` (and its
mode), every plane dav1d's (``tests/_avif_oracle.py``), every 2048^2-free
read the JAX package's ``read_image``; the splices' reads are the digests
``digests.json`` records; seeded corruption of the splices reads alike or
is refused alike; the inter tools the decoder reads are each used by some
splice (``INTER_NAMES``), and the forms no file here holds are refused
naming them.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import avif as port_avif
from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tests.test_torch_image_avif import _agree, _planes_equal_dav1d
from tools import av1_rewrite as rw
from tools import extract_av1_tables as xt
from tools.make_torch_port_image_fixtures import (ALBEDO_AVIF_INTER, AVIF_OUT, AVIF_REWRITES,
                                                  splice_digests)


def _digests():
    with open(os.path.join(AVIF_OUT, "digests.json")) as f:
        return json.load(f)


def _fixture(name):
    with open(os.path.join(AVIF_OUT, name), "rb") as f:
        return f.read()


SOURCES = sorted(n for n in _digests() if n.startswith("avis_inter_"))
SPLICES = [(name, int(n)) for name in SOURCES for n in _digests()[name]["splices"]]
LR_STILLS = ["avif_lr_s0_422_120x60.avif", "avif_lr_s1_420_96x72.avif",
             "avif_lr_s0_444_150x60.avif", "avif_lr_wiener_s1_444_96x72.avif",
             "avif_lr_sgrproj_s1_444_64x48.avif"]


def _pil_rgb(data, frame=0):
    with Image.open(io.BytesIO(data)) as im:
        im.seek(frame)
        return np.asarray(im.convert("RGB"))


def _same_everywhere(data, tmp_path, name="f.avif"):
    """PIL, dav1d's planes and the JAX package's read_image; the inter
    counters."""
    assert _agree(data) == "ok"
    _planes_equal_dav1d(data)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(port_image.read_image(path), ref_image.read_image(path))
    st = {}
    _, info = port_avif.avif_planes(data, name, st)
    return info, st


# ------------------------------------------------------------ tables -------

def test_inter_tables_hold_the_specifications_values():
    """Spot checks of the inter tables against the specification's defaults
    (the extractor's --check holds the whole header to the library)."""
    t = xt.tables()

    def inv(*v):
        return [32768 - x for x in v]

    assert t["is_inter"][0][:, 0].tolist() == inv(806, 16662, 20186, 26538)
    assert t["new_mv"][0][:, 0].tolist() == inv(24035, 16630, 15339, 8386, 12222, 4676)
    assert t["zero_mv"][0][:, 0].tolist() == inv(2175, 1054)
    assert t["drl_mode"][0][:, 0].tolist() == inv(13104, 24560, 18945)
    assert t["comp_mode"][0][:, 0].tolist() == inv(26828, 24035, 12031, 10640, 2901)
    assert t["single_ref"][0][:, 0, 0].tolist() == inv(4897, 1555, 4236, 8650, 904, 1444)
    assert t["compound_mode"][0][0, :7].tolist() == inv(7760, 13823, 15808, 17641, 19156,
                                                        20666, 26891)
    assert t["motion_mode"][0][3, :2].tolist() == inv(7651, 24760)        # 8x8
    assert t["use_obmc"][0][3, 0] == 32768 - 10437
    assert t["interintra"][0][:, 0].tolist() == inv(16384, 26887, 27597, 30237)
    assert t["mv_class0_fr"][0][0, :3].tolist() == inv(16384, 24576, 26624)
    sub = t["subpel_filters"][0]
    assert (sub.sum(-1) == 128).all() and sub[0, 8].tolist() == [0, 2, -14, 76, 76, -14, 2, 0]
    assert t["warped_filters"][0][64].tolist() == [0, 0, 0, 127, 1, 0, 0, 0]
    assert t["div_lut"][0][[0, 128, 256]].tolist() == [16384, 10923, 8192]
    assert t["obmc_masks"][0][2:4].tolist() == [45, 64]
    assert t["wedge_codebook"][0][2, 4].tolist() == [0, 4, 2]
    assert t["quant_dist"][0][1].tolist() == [[9, 7], [11, 5], [12, 4], [13, 3]]
    assert t["ii_weights"][0][:4].tolist() == [60, 58, 56, 54]


# ------------------------------------------------------------ splices ------

@pytest.mark.parametrize("name,n", SPLICES)
def test_splice_reads_as_pil_jax_and_dav1d(name, n, tmp_path):
    data = _fixture(name)
    sp = rw.splice_frames(data, n)
    px = _pil_rgb(sp)
    assert hashlib.sha256(px.tobytes()).hexdigest() == _digests()[name]["splices"][str(n)]
    np.testing.assert_array_equal(px, _pil_rgb(data, n - 1))
    info, inter = _same_everywhere(sp, tmp_path)
    assert info["hidden"] == 1 and inter["frames"] >= n


def test_splice_digests_are_pils_reads():
    for name in SOURCES:
        assert splice_digests(_fixture(name)) == _digests()[name]["splices"], name


def test_every_inter_tool_the_decoder_reads_is_hit():
    """The census: each counter of INTER_NAMES is nonzero over the splices
    and an intra-only rewrite."""
    seen = dict.fromkeys(port_avif.INTER_NAMES, 0)
    datas = [rw.splice_frames(_fixture(name), n) for name, n in SPLICES]
    datas.append(rw.to_intra_only(_fixture("avis_aq1_s6_128x96.avif")))
    for data in datas:
        st = {}
        port_avif.avif_planes(data, "x", st)
        for k in port_avif.INTER_NAMES:
            seen[k] += st[k]
    assert all(v > 0 for v in seen.values()), {k: v for k, v in seen.items() if not v}


@pytest.mark.parametrize("name,depth", [("avis_inter_zoom_s0_5f_128x96.avif", 10),
                                        ("avis_inter_occl_s1_5f_128x96.avif", 12),
                                        ("avis_inter_occl_s0_422_4f_128x96.avif", 12),
                                        ("avis_inter_zoom_s2_444_3f_96x72.avif", 10)])
def test_splices_at_10_and_12_bits_read_as_pil(name, depth, tmp_path):
    """The sub-pixel filters' rounding (InterRound0 5 at 12 bits), the
    compound masks at depth: the splice rewritten to ``depth`` bits (no
    tile symbol depends on the depth but a palette's, and these frames have
    none)."""
    data = _fixture(name)
    sp = rw.to_high_bitdepth(rw.splice_frames(data, len(rw.track_samples(data)[0])), depth)
    info, inter = _same_everywhere(sp, tmp_path)
    assert info["bit_depth"] == depth and inter["inter_blocks"]


def test_the_alpha_track_is_spliced_too(tmp_path):
    data = _fixture("avis_inter_occl_s6_rgba_3f_96x72.avif")
    sp = rw.splice_frames(data, 3)
    with Image.open(io.BytesIO(sp)) as im:
        assert im.mode == "RGBA"
        want = np.asarray(im)
    with Image.open(io.BytesIO(data)) as im:
        im.seek(2)
        np.testing.assert_array_equal(np.asarray(im), want)
    c, _, alpha, _ = port_avif.parse(sp)
    assert alpha is not None
    _same_everywhere(sp, tmp_path)


def test_the_2048_splice_is_the_record_of_pils_read():
    """Phase 54's inter frame 0: the splice of ALBEDO_AVIF_INTER, its bytes
    and PIL's read recorded in AVIF_REWRITES, the port's read equal."""
    with open(AVIF_REWRITES) as f:
        rec = json.load(f)["albedo2048_q60_s6_inter_frame0.avif"]
    sp = rw.splice_frames(_fixture(ALBEDO_AVIF_INTER), 2)
    assert hashlib.sha256(sp).hexdigest() == rec["file_sha256"]
    px = port_image.decode_image(sp)
    assert hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest() == rec["sha256"]
    st = {}
    port_avif.avif_planes(sp, "x", st)
    assert st["inter_blocks"] > 4000 and st["frames"] == 2


# ------------------------------------------------------- intra-only --------

@pytest.mark.parametrize("name,refresh", [("avis_aq1_s6_128x96.avif", 0x01),
                                          ("avis_aq1_s0_96x72.avif", 0x7F),
                                          ("avis_3frames_rgba_24x17.avif", 0x02),
                                          ("avis_hbd12_aq1_s6_128x96.avif", 0x10),
                                          ("avis_inter_scene_s6_screen_2f_128x96.avif", 0x01)])
def test_an_intra_only_frame_reads_as_the_key_frame(name, refresh, tmp_path):
    data = _fixture(name)
    io_ = rw.to_intra_only(data, refresh)
    np.testing.assert_array_equal(_pil_rgb(io_), _pil_rgb(data))
    info, inter = _same_everywhere(io_, tmp_path)
    assert inter["intra_only_frames"] == 1 and inter["frames"] == 2


# --------------------------------------------------------- superres --------

@pytest.mark.parametrize("name", LR_STILLS)
@pytest.mark.parametrize("denom", [9, 12, 16])
def test_superres_with_loop_restoration_reads_as_pil(name, denom, tmp_path):
    """Units counted on the upscaled width, the filter run on the upscaled
    CDEF output with stripe rows of the upscaled deblocked frame."""
    data = rw.to_superres(_fixture(name), denom)
    _same_everywhere(data, tmp_path)
    filters = {}
    _, info = port_avif.avif_planes(data, name, filters=filters)
    assert info["superres_denom"] == denom and info["lr_types"] and filters["lr_stripes"]


# ---------------------------------------------------------- rewriter -------

@pytest.mark.parametrize("name", SOURCES)
def test_every_frame_header_re_emits_bit_for_bit(name):
    """Each frame header of each sample (key, inter; the reference slots
    followed through) parsed into its fields and written back gives its own
    bytes."""
    s, slots = None, rw.Slots()
    for smp in rw.track_samples(_fixture(name))[0]:
        for h, ext, body in rw.split_obus(smp):
            typ = (h >> 3) & 15
            if typ == 1:
                s, _ = rw.parse_sequence_header(body)
            if typ in (3, 6) and not body[0] & 0x80:
                fh, toks, end = rw.parse_frame_header(body, s, slots=slots)
                again = rw._emit(toks, trailing=False)
                assert again[:end >> 3] == body[:end >> 3], name
                slots.refresh(fh)


def test_the_rewrites_refuse_what_they_cannot_make():
    with pytest.raises(rw.RewriteError):
        rw.splice_frames(_fixture("avif_q75_420_61x47.avif"), 2)
    with pytest.raises(rw.RewriteError, match="samples"):
        rw.splice_frames(_fixture("avis_inter_sub_s6_2f_128x96.avif"), 3)
    with pytest.raises(rw.RewriteError):
        rw.to_intra_only(_fixture("avis_aq1_s6_128x96.avif"), 0xFF)
    with pytest.raises(rw.RewriteError):
        rw.to_intra_only(_fixture("avif_q75_420_61x47.avif"))


# -------------------------------------------------------- refusals ---------

def test_an_inter_frame_with_empty_reference_slots_fails_as_in_pil():
    """The splice's key frame dropped: the inter frame names slots that hold
    no frame; dav1d (PIL) fails, and so does the port."""
    data = _fixture("avis_inter_sub_s6_2f_128x96.avif")

    def payload(d):
        obus = rw.split_obus(d)
        frames = [k for k, (h, _, _) in enumerate(obus) if (h >> 3) & 15 in (3, 6)]
        return rw.join_obus([o for k, o in enumerate(obus) if k != frames[0]])

    bad = rw._rewrite_file(rw.splice_frames(data, 2), payload, samples="zero")
    assert _agree(bad) == "fail"
    with pytest.raises(ValueError, match="reference slot"):
        port_avif.avif_planes(bad)


def _sequence_header_as(body, form):
    """A 4:2:0 sequence header's payload as itself, as profile 1 (4:4:4) or
    as monochrome."""
    if form == "same":
        return body
    _, toks = rw.parse_sequence_header(body)
    toks = [list(t) for t in toks]
    drop = {"chroma_sample_position"}
    if form == "444":
        toks[rw._index(toks, "seq_profile")][2] = 1
        drop.add("mono_chrome")  # profile 1 reads none
    else:
        toks[rw._index(toks, "mono_chrome")][2] = 1
        drop.add("separate_uv_delta_q")
    return rw._emit([t for t in toks if t[0] not in drop])


@pytest.mark.parametrize("form,outcome", [("same", "ok"), ("444", "fail"), ("mono", "fail")])
def test_a_new_sequence_between_the_frames_drops_the_references_as_in_pil(form, outcome):
    """A sequence header between the splice's hidden key frame and its inter
    frame: the same header changes nothing; one of other subsampling starts
    a new sequence, which drops every reference (dav1d), so the inter frame
    fails as in PIL and no plane of the old sequence is read."""
    data = rw.splice_frames(_fixture("avis_inter_sub_s6_2f_128x96.avif"), 2)

    def payload(d):
        obus = rw.split_obus(d)
        frames = [k for k, (h, _, _) in enumerate(obus) if (h >> 3) & 15 in (3, 6)]
        seq = next(b for h, _, b in obus if (h >> 3) & 15 == 1)
        new = (1 << 3, None, _sequence_header_as(seq, form))
        return rw.join_obus(obus[:frames[1]] + [new] + obus[frames[1]:])

    changed = rw._rewrite_file(data, payload, samples="zero")
    assert _agree(changed) == outcome
    if outcome == "ok":
        np.testing.assert_array_equal(_pil_rgb(changed), _pil_rgb(data))
    else:
        with pytest.raises(ValueError, match="reference slot 0 holds no frame"):
            port_avif.avif_planes(changed)


# ------------------------------------------------------- corruption --------

@pytest.mark.parametrize("seed", range(3))
def test_seeded_corruption_of_splices_reads_as_pil_or_is_refused(seed):
    r = np.random.default_rng(2600 + seed)
    counts = {}
    for _ in range(40):
        name, n = SPLICES[int(r.integers(0, len(SPLICES)))]
        d = bytearray(rw.splice_frames(_fixture(name), n))
        mdat = d.find(b"mdat") + 4
        for _ in range(int(r.integers(1, 3))):
            d[int(r.integers(mdat, len(d)))] = int(r.integers(0, 256))
        out = _agree(bytes(d), allow_out_of_scope=True)
        counts[out] = counts.get(out, 0) + 1
    assert counts.get("ok", 0) > 5, counts
