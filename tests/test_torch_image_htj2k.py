"""Port parity: HTJ2K (JPEG 2000 Part 15) code-blocks and the Part-2 MCT /
MCC / MCO / CBD markers in the PIL-free JPEG 2000 decoder
(akari_torch/core/jpeg2000.py with akari_torch/native/j2k_decode.cpp)
against PIL 12.1, which reads them through its bundled OpenJPEG 2.5.4 and
through which the JAX package's ``read_image`` reads them.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")``,
and what PIL refuses the port refuses with ``ValueError``:

- the port's VLC tables (``akari_torch/native/j2k_ht_tables.h``) equal the
  bytes of the bundled ``libopenjp2`` (``tools/extract_ht_tables.py``);
- the ``htj2k_*`` and ``part2_*`` fixtures decode to PIL's digests and read
  as the JAX package reads them;
- the HT writer of ``tools/j2k_writers.py`` (``encode_ht``): its reversible
  cleanup-only files read back through PIL as their input, and cases drawn
  from a seed (sizes, code-blocks up to 128 x 32 and 4 x 1024, precincts,
  one to three passes, 5/3 + RCT and 9/7 + ICT, 1-4 components, 8 and 16
  bits, VSC, raw / JP2 / JPH) read as PIL reads them;
- OpenJPEG's limits and outcomes on crafted blocks: the mixed HT style,
  placeholder passes, ROI, the band's bit-planes, zero bit-planes equal to
  them, significant samples outside the block, the MEL stream's start;
- Part-2 segments spliced beside COD transform 0 and 1 in the main and
  tile-part headers (offset arrays of every element type, records that do
  not match, the sizes OpenJPEG checks, CBD precisions);
- seeded corruptions of HT and Part-2 files, read as PIL reads them or
  refused where PIL refuses them (PIL runs in a subprocess here: its
  OpenJPEG is built with assertions);
- ``ALBEDO_HTJ2K``, the 64^2 albedo scaled up 32x as a reversible HT
  codestream, reads through PIL and the port as those pixels;
- an OBJ whose ``map_Kd`` is an HT codestream or a JPH file renders at
  16x16 on the CPU bit-equal to the PNG route.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tools import extract_ht_tables as xt
from tools import j2k_writers as jw
from tools.make_torch_port_image_fixtures import htj2k_albedo, htj2k_fixtures, pattern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
JPH = b"jph \0\0\0\0jph "


def _pil(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))


def _port(data):
    try:
        return port_image.decode_image(data, "f"), None
    except ValueError as e:
        return None, str(e)


def _agrees_with_pil(data, name="f"):
    """PIL and the port give the same pixels, or both refuse the file;
    returns PIL's pixels or None."""
    try:
        want = _pil(data)
    except Exception:
        want = None
    got, err = _port(data)
    if want is None:
        assert got is None, f"{name}: PIL refuses it, the port reads it"
    else:
        assert got is not None, f"{name}: PIL reads it, the port refuses it: {err}"
        np.testing.assert_array_equal(got, want, err_msg=name)
    return want


_WORKER = r"""
import hashlib, sys, warnings
import numpy as np
from PIL import Image
for line in sys.stdin:
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(line.strip()) as im:
                px = np.asarray(im.convert("RGB"))
        print(hashlib.sha256(px.tobytes()).hexdigest(), flush=True)
    except Exception:
        print("refused", flush=True)
"""


class _PilProcess:
    """PIL's read of a file in a process of its own (its OpenJPEG asserts):
    the SHA-256 of its pixels, "refused", or "crashed"."""

    def __init__(self, tmp_path):
        self.path = str(tmp_path / "case.j2k")
        self.proc = None

    def __call__(self, data):
        if self.proc is None:
            self.proc = subprocess.Popen([sys.executable, "-c", _WORKER], stdin=subprocess.PIPE,
                                         stdout=subprocess.PIPE, text=True)
        with open(self.path, "wb") as f:
            f.write(data)
        self.proc.stdin.write(self.path + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline().strip()
        if not line:
            self.proc.wait()
            self.proc = None
            return "crashed"
        return line

    def close(self):
        if self.proc is not None:
            self.proc.stdin.close()
            self.proc.wait()


@pytest.fixture
def pil_process(tmp_path):
    p = _PilProcess(tmp_path)
    yield p
    p.close()


def _agrees_in_process(pil, data, name):
    want = pil(data)
    assert want != "crashed", f"{name}: PIL crashed"
    got, err = _port(data)
    if want == "refused":
        assert got is None, f"{name}: PIL refuses it, the port reads it"
        return False
    assert got is not None, f"{name}: PIL reads it, the port refuses it: {err}"
    assert hashlib.sha256(got.tobytes()).hexdigest() == want, name
    return True


def _ramps(r, h, w, n, hi=256, noise=None):
    y, x = np.mgrid[0:h, 0:w]
    noise = noise or max(hi // 6, 2)
    return [np.clip((x * (3 + c) + y * (5 + c)) % hi + r.integers(0, noise, (h, w)), 0, hi - 1)
            for c in range(n)]


# ----------------------------------------- the tables ----------------------------

def test_tables_are_the_bundled_openjpegs():
    with open(xt.library_path(), "rb") as f:
        t0, t1 = xt.find_tables(f.read())
    h0, h1 = xt.read_header()
    np.testing.assert_array_equal(h0, t0)
    np.testing.assert_array_equal(h1, t1)
    with open(xt.HEADER) as f:
        assert f.read() == xt.render(t0, t1)
    assert tuple(t0[:8]) == xt.HEAD0 and tuple(t1[:8]) == xt.HEAD1
    # every entry decodes to a codeword of 1-7 bits; rho 0 never has u_off
    for t in (t0, t1):
        assert ((t & 7) >= 1).all()
        assert not ((((t >> 4) & 15) == 0) & (((t >> 3) & 1) == 1)).any()


# ----------------------------------------- the fixtures --------------------------

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.startswith(("htj2k_", "part2_"))}


FIXTURE_NAMES = sorted(_digests())


def test_fixtures_are_the_tools():
    written = htj2k_fixtures()
    assert sorted(written) == FIXTURE_NAMES and len(written) == 12
    for name, data in written.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_pils_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert port_image.image_format(data) == "JPEG2000"
    px = port_image.decode_image(data, name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    assert hashlib.sha256(_pil(data).tobytes()).hexdigest() == rec["sha256"]
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ----------------------------------------- the writer ----------------------------

@pytest.mark.parametrize("seed", range(12))
def test_reversible_writer_files_read_back_through_pil_as_their_input(seed):
    """The HT writer checked by OpenJPEG alone: a cleanup-only reversible
    file of every component count, 8 or 16 bits, any code-block shape."""
    r = np.random.default_rng(300 + seed)
    n = (1, 2, 3, 4)[seed % 4]
    prec = 16 if seed % 5 == 4 and n == 1 else 8
    h, w = (int(v) for v in r.integers(1, 60, 2))
    planes = _ramps(r, h, w, n, 1 << prec) if seed % 2 else [
        r.integers(0, 1 << prec, (h, w)) for _ in range(n)]
    cblk = (int(2 ** r.integers(2, 8)), int(2 ** r.integers(2, 7)))
    if cblk[0] * cblk[1] > 4096:
        cblk = (cblk[0], 4096 // cblk[0])
    data = jw.encode_ht(planes, prec=prec, cblk=cblk, mct=n >= 3 and seed % 3 != 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            got = np.asarray(im)
    want = np.stack(planes, -1) if n > 1 else planes[0]
    np.testing.assert_array_equal(got.astype(np.int64), want)
    _agrees_with_pil(data, f"seed {seed}")


def _drawn_ht_case(seed):
    r = np.random.default_rng(500 + seed)
    n = (1, 3, 4, 2, 3)[seed % 5]
    prec = 16 if n == 1 and seed % 7 == 3 else 8
    h, w = (int(v) for v in r.integers(1, 70, 2))
    planes = (_ramps(r, h, w, n, 1 << prec) if r.random() < 0.6 else
              [r.integers(0, 1 << prec, (h, w)) for _ in range(n)])
    shapes = ((64, 64), (128, 32), (32, 128), (4, 1024), (1024, 4), (16, 8), (8, 4), (4, 4))
    kw = {"prec": prec, "cblk": shapes[seed % len(shapes)],
          "passes": int(r.integers(1, 4)), "irreversible": bool(r.random() < 0.4),
          "num_resolutions": int(r.integers(1, max(2, min(h, w).bit_length() + 1)))}
    if kw["irreversible"]:
        kw["step"] = float(r.choice([0.25, 0.5, 1.0, 3.0]))
    if n >= 3:
        kw["mct"] = bool(r.random() < 0.7)
    if r.random() < 0.3:
        kw["cblk_style"] = 0x48  # VSC
    if r.random() < 0.35 and kw["num_resolutions"] > 1:
        kw["precincts"] = [(int(r.integers(2, 8)), int(r.integers(2, 8))) if i == 0 else
                           (int(r.integers(3, 8)), int(r.integers(3, 8)))
                           for i in range(kw["num_resolutions"])]
    data = jw.encode_ht(planes, **kw)
    if seed % 4 == 1:
        data = jw.jp2(data, w, h, n, bpc=prec - 1, colr=(1, 16 if n >= 3 else 17),
                      ftyp=JPH if seed % 8 == 1 else b"jp2 \0\0\0\0jp2 ")
    return data, kw


@pytest.mark.parametrize("seed", range(40))
def test_drawn_ht_cases_read_as_pil(seed):
    data, kw = _drawn_ht_case(seed)
    assert _agrees_with_pil(data, f"seed {seed}: {kw}") is not None, kw


def test_sigprop_signs_follow_groups_of_four_columns():
    """The SigProp pass's sign bits follow each group of 4 columns of a
    stripe: written so PIL reads the file as written; written after groups
    of 8 it does not."""
    r = np.random.default_rng(7)
    g = np.full((16, 32), 128) + (r.random((16, 32)) < 0.5) * r.choice([-1, 1], (16, 32))
    g[::2, ::3] += 9
    four = jw.encode_ht([g], num_resolutions=1, passes=3, cblk=(32, 16))
    eight = jw.encode_ht([g], num_resolutions=1, passes=3, cblk=(32, 16), group=8)
    np.testing.assert_array_equal(_agrees_with_pil(four)[..., 0], g)
    assert not np.array_equal(_agrees_with_pil(eight)[..., 0], g)


def test_vsc_keeps_sigprop_from_the_next_stripe():
    """Under VSC (stripe-causal) a sample's SigProp neighbourhood leaves out
    the next stripe, as OpenJPEG's does: the file written so reads the same
    in PIL and the port, and differs from the one written without it."""
    r = np.random.default_rng(4)
    g = np.full((16, 16), 128) + (r.random((16, 16)) < 0.3) * r.choice([-1, 1], (16, 16))
    for y in (4, 8, 12):
        g[y, ::3] += 6
    vsc = _agrees_with_pil(jw.encode_ht([g], num_resolutions=1, passes=3, cblk_style=0x48))
    plain = _agrees_with_pil(jw.encode_ht([g], num_resolutions=1, passes=3))
    assert (vsc != plain).any()


# ----------------------------------------- OpenJPEG's outcomes -------------------

def _refused_by_both(data, match):
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match=match):
        port_image.decode_image(data)


def test_mixed_ht_style_and_roi_are_refused_as_pil_refuses_them():
    g = _ramps(np.random.default_rng(1), 20, 24, 1)
    _refused_by_both(jw.encode_ht(g, cblk_style=0xC0), "Unsupported Mixed HT code-block style")
    base = jw.encode_ht(g)
    for shift in (1, 5):
        _refused_by_both(jw.splice_main(base, b"\xff\x5e\x00\x05\x00\x00" + bytes([shift])),
                         "ROI in decoding HT codeblocks")


def test_placeholder_passes_as_openjpeg_reads_them():
    """OpenJPEG has no placeholder passes: with an empty second segment the
    block is read as its cleanup pass alone, at the bit-plane the missing
    MSBs give; with refinement data it is refused (more than 3 passes)."""
    g = _ramps(np.random.default_rng(2), 20, 24, 1)
    for z in (1, 2):
        want = _agrees_with_pil(jw.encode_ht(g, placeholders=z, cblk=(16, 16)))
        assert want is not None and not np.array_equal(want[..., 0], g[0])
    _refused_by_both(jw.encode_ht(g, placeholders=1, passes=3), "more than 3 coding passes")


def _with_qcd_exponent(data, delta):
    """``data`` with every band's exponent in its reversible QCD moved by ``delta``."""
    i = data.index(b"\xff\x5c")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    body = bytearray(data[i + 4:i + 2 + n])
    for k in range(1, len(body)):
        body[k] = max(0, min(31, (body[k] >> 3) + delta)) << 3
    return data[:i + 4] + bytes(body) + data[i + 2 + n:]


def test_bit_plane_limits_as_openjpeg():
    g = _ramps(np.random.default_rng(3), 20, 24, 1)
    one = jw.encode_ht(g, cblk=(16, 16))
    three = jw.encode_ht(g, cblk=(16, 16), passes=3)
    # the band's bit-planes above 30
    _refused_by_both(_with_qcd_exponent(one, 31), "32 bits are not enough")
    # more zero bit-planes than the band has
    _refused_by_both(_with_qcd_exponent(one, -3), "zero bitplanes")
    # zero bit-planes equal to the band's: the cleanup pass alone is read
    want = _agrees_with_pil(_with_qcd_exponent(three, -1))
    assert want is not None


def test_samples_outside_the_block_are_refused(monkeypatch):
    """A VLC codeword that makes a sample past the block's last odd column or
    row significant: OpenJPEG refuses the block."""
    cleanup = jw._ht_cleanup

    def phantom(mu, sgn):
        if mu.shape[1] % 2:
            mu = np.pad(mu, ((0, 0), (0, 1)), constant_values=3)
            sgn = np.pad(sgn, ((0, 0), (0, 1)))
        elif mu.shape[0] % 2:
            mu = np.pad(mu, ((0, 1), (0, 0)), constant_values=3)
            sgn = np.pad(sgn, ((0, 1), (0, 0)))
        return cleanup(mu, sgn)

    monkeypatch.setattr(jw, "_ht_cleanup", phantom)
    g = (np.mgrid[0:16, 0:17][1] * 7 + 100) % 256
    for img in (g, g[:15, :16]):
        _refused_by_both(jw.encode_ht([img], num_resolutions=1, cblk=(16, 16)),
                         "significant samples outside the codeblock")


def test_mel_stream_start_as_openjpeg(monkeypatch, pil_process):
    """An 0xFF then a byte above 0x8F among the MEL stream's first bytes (up
    to a 4-byte boundary of the block's buffer) is refused; further on it is
    read as data."""
    cleanup = jw._ht_cleanup
    g = (np.random.default_rng(1).random((32, 32)) < 0.05) * 40 + 128
    refused = read = 0
    for k in range(8):
        for nxt in (0x90, 0xC3, 0xFF, 0x8F, 0x20):
            def mel_ff(mu, sgn, k=k, nxt=nxt):
                b = bytearray(cleanup(mu, sgn))
                scup = (b[-1] << 4) + (b[-2] & 15)
                m0 = len(b) - scup
                if m0 + k + 1 < len(b) - 2:
                    b[m0 + k], b[m0 + k + 1] = 0xFF, nxt
                return bytes(b)

            monkeypatch.setattr(jw, "_ht_cleanup", mel_ff)
            data = jw.encode_ht([g], num_resolutions=1, cblk=(32, 32))
            if _agrees_in_process(pil_process, data, f"MEL byte {k} then {nxt:#x}"):
                read += 1
            else:
                refused += 1
    assert refused >= 5 and read >= 20


# ----------------------------------------- Part 2 --------------------------------

def _part2_cases(mct):
    r = np.random.default_rng(5 + mct)
    base = jw.encode([np.clip(r.integers(60, 200, (24, 20)), 0, 255) for _ in range(3)],
                     mct=mct)
    m, t = jw.splice_main, jw.splice_tile
    off = [100, -20, 50]
    return {
        "no MCO": base,
        "MCO of no stage": m(base, jw.mco()),
        "MCO of no stage, tile": t(base, jw.mco()),
        **{f"offsets, element type {e}": m(base, jw.mct(1, e, [100, 20 if e == 0 else -20, 50]),
                                           jw.mcc(3, 3, offset=1), jw.mco(3)) for e in range(4)},
        "offsets, tile": t(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1), jw.mco(3)),
        "records main, MCO tile": t(m(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1)),
                                    jw.mco(3)),
        "MCO names no record": m(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1), jw.mco(4)),
        "MCO names the second record": m(base, jw.mct(1, 1, off), jw.mcc(2, 3, offset=1),
                                         jw.mcc(3, 3, offset=1), jw.mco(3)),
        "MCO names the first record": m(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1),
                                        jw.mcc(2, 3, offset=1), jw.mco(3)),
        "decorrelation array": m(base, jw.mct(1, 2, [1, 0, 0, 0, 1, 0, 0, 0, 1], array_type=1),
                                 jw.mcc(3, 3, deco=1), jw.mco(3)),
        "decorrelation array short": m(base, jw.mct(1, 2, [1, 0, 0, 0, 1, 0, 0, 0],
                                                    array_type=1), jw.mcc(3, 3, deco=1),
                                       jw.mco(3)),
        "offset array short": m(base, jw.mct(1, 1, off[:2]), jw.mcc(3, 3, offset=1), jw.mco(3)),
        "MCC names no MCT": m(base, jw.mcc(3, 3, offset=1), jw.mco(3)),
        "MCC of 2 components": m(base, jw.mct(1, 1, off[:2]), jw.mcc(3, 2, offset=1), jw.mco(3)),
        "offsets wrap in 32 bits": m(base, jw.mct(1, 1, [0x7FFFFFF0, -0x7FFFFFF0, 5]),
                                     jw.mcc(3, 3, offset=1), jw.mco(3)),
        "float offsets NaN, huge": m(base, jw.mct(1, 2, [float("nan"), 3e9, -7.9]),
                                     jw.mcc(3, 3, offset=1), jw.mco(3)),
        "16-bit offsets unsigned": m(base, jw.mct(1, 0, [0xFFFF, 0x8000, 1]),
                                     jw.mcc(3, 3, offset=1), jw.mco(3)),
        "CBD 7 bits": m(base, jw.cbd(6, 6, 6)),
        "CBD signed": m(base, jw.cbd(0x87, 0x87, 0x87)),
        "CBD 12 bits": m(base, jw.cbd(11, 11, 11)),
        "CBD of 2 components": m(base, jw.cbd(7, 7)),
        "CBD of 40 bits": m(base, jw.cbd(7, 39, 7)),
        "CBD in a tile-part": t(base, jw.cbd(7, 7, 7)),
        "MCT Zmct 1": m(base, jw.mct(1, 1, off, zmct=1), jw.mcc(3, 3, offset=1), jw.mco(3)),
        "MCT Ymct 1": m(base, jw.mct(1, 1, off, ymct=1), jw.mcc(3, 3, offset=1), jw.mco(3)),
        "MCC of no collection": m(base, jw.mcc(3, 3, collections=0), jw.mco(3)),
        "MCC not array based": m(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1, kind=2),
                                 jw.mco(3)),
        "MCO of 2 stages": m(base, jw.mct(1, 1, off), jw.mcc(3, 3, offset=1), jw.mco(3, 3)),
        "MCO short": m(base, b"\xff\x77\x00\x03\x01"),
        "MCT short": m(base, b"\xff\x74\x00\x06\x00\x00\x00\x01"),
    }


@pytest.mark.parametrize("mct", (0, 1))
def test_part2_markers_read_as_openjpeg(mct):
    """MCT / MCC / MCO / CBD beside COD transform 0 and 1: read as PIL reads
    them (DC level shifts zeroed and offset, only the first MCC record
    matched, 32-bit wrapping, x86 float truncation, 16-bit offsets
    unsigned), refused where PIL refuses them."""
    read = 0
    base = None
    for name, data in _part2_cases(mct).items():
        want = _agrees_with_pil(data, name)
        if name == "no MCO":
            base = want
        read += want is not None
    assert read >= 20 and base is not None
    cases = _part2_cases(mct)
    names_first = _pil(cases["MCO names the first record"])
    assert not np.array_equal(names_first, _pil(cases["MCO names the second record"]))


# ----------------------------------------- seeded corruption ---------------------

def _corruption_bases():
    r = np.random.default_rng(21)
    rgb = _ramps(r, 24, 20, 3)
    return {
        "cleanup_grey": jw.encode_ht(_ramps(r, 35, 41, 1), cblk=(16, 16)),
        "three_pass_grey": jw.encode_ht(_ramps(r, 35, 41, 1), cblk=(16, 16), passes=3),
        "rgb_97_three_pass": jw.encode_ht(rgb, cblk=(8, 8), passes=3, irreversible=True),
        "rgb_rct_128x32_jp2": jw.jp2(jw.encode_ht(rgb, cblk=(128, 32)), 20, 24, 3),
        "vsc_sigprop": jw.encode_ht(_ramps(r, 20, 18, 1, noise=90), passes=2, cblk_style=0x48),
        "part2_offsets": jw.splice_main(jw.encode(rgb, mct=1), jw.mct(1, 1, [90, -30, 40]),
                                        jw.mcc(3, 3, offset=1), jw.mco(3)),
    }


_BASES = _corruption_bases()


@pytest.mark.parametrize("name", sorted(_BASES))
def test_seeded_corruptions_read_as_pil_or_are_refused(name, pil_process):
    """Bytes flipped or set (mostly in the packets: MagSgn, MEL, VLC,
    SigProp, MagRef, segment lengths) and files cut: the port reads what PIL
    reads, bit for bit, and refuses what PIL refuses."""
    base = _BASES[name]
    r = np.random.default_rng(sum(name.encode()))
    sod = base.index(b"\xff\x93") + 2
    cases = [base[:int(c)] for c in r.integers(1, len(base), 8)]
    for _ in range(52):
        b = bytearray(base)
        for _ in range(int(r.integers(1, 4))):
            pos = (int(r.integers(sod, len(b) - 2)) if r.random() < 0.85 else
                   int(r.integers(0, len(b))))
            b[pos] = b[pos] ^ (1 << int(r.integers(0, 8))) if r.random() < 0.5 else int(
                r.integers(0, 256))
        cases.append(bytes(b))
    read = sum(_agrees_in_process(pil_process, data, f"{name} case {i}")
               for i, data in enumerate(cases))
    assert read >= 5, name


# ----------------------------------------- the albedo ----------------------------

def test_htj2k_albedo_reads_as_the_scaled_albedo():
    """``ALBEDO_HTJ2K`` (written where it is needed: the fixtures' size
    budget has no room for it): PIL and the port read the 64^2 albedo scaled
    up 32x."""
    from akari_torch.scene.builtin import envtex_texture

    data = htj2k_albedo()
    x32 = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    assert data[:4] == b"\xff\x4f\xff\x51" and b"\xff\x50" in data[:200]
    np.testing.assert_array_equal(port_image.decode_image(data, "albedo"), x32)
    np.testing.assert_array_equal(_pil(data), x32)


def test_htj2k_decoder_needs_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('htj2k_rgb_rct_3pass_16x4_16x12.j2c', 'htj2k_grey_128x32_40x36.jph',\n"
            "          'part2_mct_mcc_mco_offsets_rct_8x10.j2k'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:4] == ["(12, 16, 3)", "(36, 40, 3)", "(10, 8, 3)", "[]"]


def test_obj_map_kd_htj2k_and_jph_render_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd``: a reversible HT codestream
    and a JPH file of the same pixels give the texture tables and a 16x16
    CPU render of the OBJ on a PNG of them."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    tex = pattern(24, 32, 19)
    planes = [tex[..., c].astype(np.int64) for c in range(3)]
    files = {"png": port_image.encode_png(tex),
             "j2c": jw.encode_ht(planes, cblk=(16, 8)),
             "jph": jw.jp2(jw.encode_ht(planes, cblk=(128, 32)), 32, 24, 3, ftyp=JPH)}
    obj = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nv -0.3 1.5 -0.3\nv 0.3 1.5 -0.3\n"
           "v 0 1.5 0.3\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl ground\n"
           "f 1/1 3/3 2/2\nf 1/1 4/4 3/3\nusemtl lamp\nf 5 6 7\n")
    cam = make_camera(look_at((0.0, 2.0, 2.5), (0.0, 0.0, 0.0)), 50.0, 16, 16)
    frames, tables = {}, {}
    for ext, data in files.items():
        (tmp_path / f"albedo.{ext}").write_bytes(data)
        (tmp_path / f"m_{ext}.mtl").write_text(
            f"newmtl ground\nKd 1 1 1\nmap_Kd albedo.{ext}\nnewmtl lamp\nKe 40 35 30\n")
        (tmp_path / f"m_{ext}.obj").write_text(f"mtllib m_{ext}.mtl\n" + obj)
        scene = Scene(shapes=[load_obj(str(tmp_path / f"m_{ext}.obj"))]).compile(
            intersector="dense", device="cpu")
        tables[ext] = scene.textures.images.numpy()
        frames[ext] = render(scene, cam, PathConfig(spp=4, max_depth=3)).numpy()
    assert frames["png"].mean() > 0.01 and np.isfinite(frames["png"]).all()
    for ext in files:
        np.testing.assert_array_equal(tables[ext], tables["png"], err_msg=ext)
        np.testing.assert_array_equal(frames[ext], frames["png"], err_msg=ext)
