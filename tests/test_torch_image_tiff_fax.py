"""Port parity: CCITT (RLE, RLEW, Group 3, Group 4), ThunderScan and
old-style JPEG TIFFs, read by the PIL-free decoders (akari_torch/core/
tiff.py and tiff_ojpeg.py with akari_torch/native/fax3.cpp and rle.cpp)
against PIL 12.1.0 and the libtiff 4.7.1 it calls, through which the JAX
package's ``read_image`` reads TIFF textures.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")`` of
the file read from its path, and ``read_image`` of both packages gives the
same float32 array bit for bit:

- the fixtures of ``tests/data/torch_port_images`` written by
  ``tools/make_torch_port_image_fixtures.py`` (``fax_fixtures``: Pillow's
  four CCITT writers and ``tools/tiff_writers.py``'s strips), against the
  JAX package's read and the SHA-256 of PIL's decode in ``digests.json``;
- seeded drawn bilevel images of drawn sizes (widths that are not
  multiples of 8 among them) through MH (RLE, RLEW, Group 3), MR with each
  T4Options bit, MMR, fill order 2, one strip or several, grey or palette;
- ThunderScan rows coding every opcode (runs, runs of 0, 2-bit and 3-bit
  deltas with their skip codes, raw pixels with the bits libtiff ignores);
- old-style JPEG in the interchange form (the stream at
  JPEGInterchangeFormat), the header form (the entropy-coded data in the
  strips) and the tables form (JPEGQTables / DCTables / ACTables), at
  4:4:4, 4:2:2 and 4:2:0, in one strip or a strip an MCU row, with restart
  intervals, and grey;
- the libtiff rules the decoders follow: Group 3 data without EOLs read
  again from the strip's start, Group 4 strips that end early, RLEW rows
  aligned in the file, tiles, the strict restarts and the premature end
  of libtiff's old-style JPEG source;
- seeded corruptions of each family: wherever PIL reads the file the port
  gives its pixels or refuses it naming libtiff's buffer as it stood (the
  YCbCr route's stale strips, a Group 4 strip that ends early), wherever
  PIL refuses it the port raises ValueError;
- SGILog TIFFs of every photometric and sample layout: PIL refuses them,
  and so does the port, saying so;
- a failed build of a new native source raises naming its decoder.
"""

import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image
from tools.make_torch_port_image_fixtures import pattern, tiff_bytes
from tools.tiff_writers import fax_options, fax_strip, ojpeg_tiff, thunder_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
FAX_FIXTURES = sorted(
    n for n in os.listdir(FIXTURES)
    if n.startswith(("tiff_pil_group", "tiff_pil_tiff_ccitt", "tiff_pil_tiff_raw_16", "tiff_mh_",
                     "tiff_mr_", "tiff_mmr_", "tiff_rle", "tiff_thunder_", "tiff_ojpeg_")))
# what the port says where PIL reads pixels out of libtiff's buffer as it stood
STALE = ("as it stood", "as PIL's buffer held them")


def _pil_path(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


def _outcome(tmp_path, data, name="t.tif"):
    """(PIL's pixels or None, the port's pixels or its error message) of
    ``data`` read from a file; the port may raise ValueError only."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        want = _pil_path(str(path))
    except Exception:
        want = None
    try:
        got = port_image.decode_image(data, name)
    except ValueError as e:
        got = str(e)
    return want, got


def _check(tmp_path, data, name="t.tif"):
    want, got = _outcome(tmp_path, data, name)
    assert want is not None, "PIL refuses the file"
    assert not isinstance(got, str), got
    np.testing.assert_array_equal(got, want)
    return got


def _same_read(path):
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fixtures

def test_the_fixtures_cover_every_family():
    assert len(FAX_FIXTURES) == 16
    for stem in ("group3", "group4", "tiff_ccitt", "raw_16", "mh_", "mr_", "mmr_strips",
                 "mmr_tiled", "rle_", "rlew_", "thunder_grey", "thunder_palette",
                 "ojpeg_interchange", "ojpeg_header", "ojpeg_tables", "ojpeg_grey"):
        assert any(stem in n for n in FAX_FIXTURES), stem


@pytest.mark.parametrize("name", FAX_FIXTURES)
def test_fixture_reads_as_the_jax_package_reads_it(name):
    path = os.path.join(FIXTURES, name)
    _same_read(path)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)[name]
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == want["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(px, _pil_path(path))


# --------------------------------------------------------------- drawn CCITT

def _bilevel(r, h, w):
    bits = (r.random((h, w)) < r.uniform(0.05, 0.95)).astype(np.uint8)
    if r.random() < 0.5:  # long runs, make-up codes
        k = int(r.integers(2, 40))
        bits = np.repeat(bits[:, ::k], k, axis=1)[:, :w]
    return bits


# (compression, T4Options) of every framing and option
FAX_FORMS = [(2, 0), (32771, 0), (3, 0), (3, 1), (3, 4), (3, 5), (3, 2), (3, 3), (4, 0)]


@pytest.mark.parametrize("seed", range(12))
def test_drawn_ccitt_images_match_pil(tmp_path, seed):
    r = np.random.default_rng(seed)
    for comp, options in FAX_FORMS:
        h, w = int(r.integers(1, 40)), int(r.choice([1, 7, 8, 9, 63, 64, 65, 200,
                                                      int(r.integers(1, 3000))]))
        bits = _bilevel(r, h, w)
        fill = 2 if r.random() < 0.3 else 1
        rps = int(r.integers(1, h + 1))
        drawn = r if r.random() < 0.6 else None
        blocks = [fax_strip(bits[y:y + rps], comp, two_d=bool(options & 1),
                            k=int(r.integers(1, 5)), fill_bits=bool(options & 4),
                            rtc=r.random() < 0.3, eofb=r.random() < 0.3, fill=fill, r=drawn)
                  for y in range(0, h, rps)]
        photometric = int(r.integers(0, 2))
        tags = {292: (4, [options])} if comp == 3 else {}
        data = tiff_bytes(bits[..., None], 1, photometric, compression=comp, fill=fill,
                          rows_per_strip=rps, blocks=blocks, tags=tags, order=r.choice(["<", ">"]))
        if comp == 32771:
            # libtiff aligns RLEW rows by what it has read ahead and by the
            # byte's address, not by the row's length: rows aligned to 16
            # bits from the strip's start may misread, or fail, in PIL too
            want, got = _outcome(tmp_path, data)
            if want is None:
                assert isinstance(got, str)
            else:
                np.testing.assert_array_equal(got, want)
            continue
        got = _check(tmp_path, data)
        # a set bit is black under min-is-white (0), white under min-is-black (1)
        want = np.where(bits == 1, 255 * photometric, 255 * (1 - photometric))
        np.testing.assert_array_equal(got[..., 0], want.astype(np.uint8))


def test_every_run_length_and_make_up_code_reads(tmp_path):
    """Runs 0-63 of both colours, every make-up code and the 2560 ones
    repeated, in one image 5,300 wide."""
    w = 5300
    rows = []
    for start in (0, 1):
        row, x, colour, n = np.zeros(w, np.uint8), 0, start, 0
        for run in list(range(64)) + list(range(64, 2561, 64)) + [5000 - 4096]:
            run = min(run, w - x)
            row[x:x + run] = colour
            x += run
            colour ^= 1
            n += 1
            if x >= w:
                break
        rows.append(row)
    rows.append(np.r_[np.zeros(2700, np.uint8), np.ones(w - 2700, np.uint8)])
    bits = np.array(rows)
    for comp, options in ((2, 0), (3, 0), (3, 1), (4, 0)):
        data = tiff_bytes(bits[..., None], 1, 0, compression=comp,
                          blocks=[fax_strip(bits, comp, two_d=bool(options & 1))],
                          tags={292: (4, [options])} if comp == 3 else {})
        got = _check(tmp_path, data)
        np.testing.assert_array_equal(got[..., 0] == 0, bits == 1)


def test_palette_and_tiled_ccitt_match_pil(tmp_path):
    r = np.random.default_rng(3)
    bits = _bilevel(r, 37, 53)
    cmap = r.integers(0, 65536, 6).tolist()
    _check(tmp_path, tiff_bytes(bits[..., None], 1, 3, compression=4, colormap=cmap,
                                blocks=[fax_strip(bits, 4)]))
    pad = np.zeros((48, 64), np.uint8)
    pad[:37, :53] = bits
    for comp in (2, 3, 4, 32771):
        blocks = [fax_strip(pad[y:y + 16, x:x + 32], comp) for y in (0, 16, 32) for x in (0, 32)]
        _check(tmp_path, tiff_bytes(bits[..., None], 1, 0, compression=comp, tile=(32, 16),
                                    blocks=blocks))


# ---------------------------------------------------------- libtiff's rules

def test_group3_data_without_an_eol_is_read_again_without_eols(tmp_path):
    """libtiff 4.7's Group 3 decoder, finding no EOL where the data ends,
    decodes the strip again from its first bit without looking for EOLs,
    from the row it had reached: the strip of zero bytes reads as white
    (the EOL codes end each row at once), and a strip cut short reads
    its first rows, then the start of the data again as rows."""
    zeros = tiff_bytes(np.zeros((4, 8, 1), int), 1, 1, compression=1, tags={259: (3, [3])})
    got = _check(tmp_path, zeros)
    assert (got == 0).all()  # photometric 1: white runs are 0 bits, black
    r = np.random.default_rng(5)
    for two_d in (False, True):
        bits = _bilevel(r, 12, 40)
        full = fax_strip(bits, 3, two_d=two_d)
        read = 0
        for cut in range(1, len(full)):
            data = tiff_bytes(bits[..., None], 1, 0, compression=3, blocks=[full[:cut]],
                              tags={292: (4, [fax_options(two_d)])})
            want, got = _outcome(tmp_path, data)
            if want is None:
                assert isinstance(got, str) and "premature EOF" in got
                continue
            np.testing.assert_array_equal(got, want)
            read += 1
        assert read > len(full) // 3


def test_group4_strip_that_ends_early_is_refused_where_pil_reads_stale_rows(tmp_path):
    """Fax4Decode succeeds once it has decoded a row before the data ends
    and leaves the rows after the one it ended in unwritten: PIL's pixels
    there are whatever its buffer held (here the strip before's)."""
    bits = np.ones((8, 16), np.uint8)
    bits[4:, 3:9] = 0
    s1, s2 = fax_strip(bits[:4], 4), fax_strip(bits[4:], 4)
    data = tiff_bytes(bits[..., None], 1, 0, compression=4, rows_per_strip=4,
                      blocks=[s1, s2[:2]])
    want, got = _outcome(tmp_path, data)
    assert want is not None
    assert isinstance(got, str) and "as PIL's buffer held them" in got
    assert (want[6:] == 0).all()  # the first strip's black rows, left in PIL's buffer
    # no row decoded at all: libtiff fails the strip
    want, got = _outcome(tmp_path, tiff_bytes(bits[..., None], 1, 0, compression=4,
                                              blocks=[b"\0\0"]))
    assert want is None and isinstance(got, str) and "premature EOF" in got


def test_rlew_rows_align_on_the_file_offset(tmp_path):
    """Fax3DecodeRLE word-aligns a row's end in memory, and libtiff reads the
    strip where the file is mapped: a strip at an odd offset reads otherwise
    than one at an even offset (PIL's tiff_raw_16 files do)."""
    bits = _bilevel(np.random.default_rng(6), 9, 37)
    strip = fax_strip(bits, 32771)
    outs = []
    for pad in (0, 1):
        data = tiff_bytes(bits[..., None], 1, 0, compression=32771, blocks=[b"\0" * pad + strip])
        data = bytearray(data)
        # point the strip past the pad byte
        ifd = int.from_bytes(data[4:8], "little")
        for i in range(int.from_bytes(data[ifd:ifd + 2], "little")):
            at = ifd + 2 + 12 * i
            if int.from_bytes(data[at:at + 2], "little") == 273:
                data[at + 8:at + 12] = (8 + pad).to_bytes(4, "little")
            if int.from_bytes(data[at:at + 2], "little") == 279:
                data[at + 8:at + 12] = len(strip).to_bytes(4, "little")
        outs.append(_outcome(tmp_path, bytes(data)))
    for want, got in outs:
        if want is None:
            assert isinstance(got, str)
        else:
            np.testing.assert_array_equal(got, want)
    assert outs[0][0] is not None


def test_uncompressed_mode_option_reads_as_without_it(tmp_path):
    """T4Options bit 1 (uncompressed mode allowed): libtiff ignores it and
    takes an uncompressed-mode code word in 2-D data as the end of the row."""
    bits = _bilevel(np.random.default_rng(7), 10, 30)
    for options in (2, 3):
        data = tiff_bytes(bits[..., None], 1, 0, compression=3,
                          blocks=[fax_strip(bits, 3, two_d=bool(options & 1))],
                          tags={292: (4, [options])})
        np.testing.assert_array_equal(_check(tmp_path, data)[..., 0] == 0, bits == 1)
    ext = fax_strip(bits, 3, two_d=True)
    # replace the first 2-D row's codes by the extension code 0000001 111
    from tools.tiff_writers import EOL, EXTENSION, _mh_row, _pack
    row0 = EOL + "1" + "".join(_mh_row(bits[0]))
    ext = _pack(row0 + EOL + "0" + EXTENSION + "111", 1)
    data = tiff_bytes(bits[:2, :, None], 1, 0, compression=3, blocks=[ext],
                      tags={292: (4, [3])})
    want, got = _outcome(tmp_path, data)
    assert want is not None
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits, comp, match", [
    (2, 4, "Bits/sample must be 1"), (8, 3, "Bits/sample must be 1"),
    (1, 32809, "only supports 4 bits"), (8, 32809, "only supports 4 bits")])
def test_sample_sizes_libtiff_refuses(tmp_path, bits, comp, match):
    data = tiff_bytes(np.zeros((4, 8, 1), int), bits, 1, compression=1,
                      tags={259: (3, [comp])})
    want, got = _outcome(tmp_path, data)
    assert want is None
    assert isinstance(got, str) and match in got


def test_tiled_thunderscan_is_refused_as_libtiff_refuses_it(tmp_path):
    p4 = np.random.default_rng(8).integers(0, 16, (20, 20))
    data = tiff_bytes(p4[..., None], 4, 1, compression=32809, tile=(16, 16),
                      blocks=[thunder_rows(np.zeros((16, 16), int))] * 4)
    want, got = _outcome(tmp_path, data)
    assert want is None and "tile decoding is not implemented" in got


def test_ccitt_build_failure_raises(tmp_path, monkeypatch):
    """Without a C++ compiler the CCITT and ThunderScan strips cannot
    decode: an error naming the compiler and the decoder, no fallback."""
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-xyz")
    bits = np.zeros((4, 8), np.uint8)
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz.*TIFF CCITT"):
        port_image.decode_image(tiff_bytes(bits[..., None], 1, 0, compression=4,
                                           blocks=[fax_strip(bits, 4)]))
    with pytest.raises(RuntimeError, match="ThunderScan"):
        port_image.decode_image(tiff_bytes(np.zeros((2, 2, 1), int), 4, 1, compression=32809,
                                           blocks=[bytes([0xC0] * 4)]))


# ---------------------------------------------------------------- ThunderScan

@pytest.mark.parametrize("seed", range(8))
def test_drawn_thunderscan_matches_pil(tmp_path, seed):
    r = np.random.default_rng(seed)
    h, w = int(r.integers(1, 30)), int(r.integers(1, 70))
    p4 = r.integers(0, 16, (h, w))
    if seed % 2:  # smooth rows: runs and deltas
        p4 = np.cumsum(r.integers(-1, 2, (h, w)), axis=1) % 16
        p4[:, w // 2:] = p4[:, w // 2:w // 2 + 1]
    rps = int(r.integers(1, h + 1))
    blocks = [thunder_rows(p4[y:y + rps], r) for y in range(0, h, rps)]
    ops = {b >> 6 for blk in blocks for b in blk}
    if seed % 2:
        assert ops == {0, 1, 2, 3}, ops
    photometric = int(r.integers(0, 2))
    got = _check(tmp_path, tiff_bytes(p4[..., None], 4, photometric, compression=32809,
                                      rows_per_strip=rps, blocks=blocks))
    levels = (p4 * 17).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], levels if photometric else 255 - levels)


def test_thunderscan_run_that_fills_or_overfills_a_row(tmp_path):
    """A run ending at the row's end is written; one that passes it is "too
    much data", and a row the data ends in "not enough": PIL refuses both."""
    row = [0xC5, 0x03]  # raw 5, then a run of 3 of it: 4 pixels
    data = tiff_bytes(np.zeros((1, 4, 1), int), 4, 1, compression=32809, blocks=[bytes(row)])
    assert _check(tmp_path, data)[0, :, 0].tolist() == [85] * 4
    for blob, match in ((bytes([0xC5, 0x05]), "too much"), (bytes([0xC5]), "not enough")):
        data = tiff_bytes(np.zeros((1, 4, 1), int), 4, 1, compression=32809, blocks=[blob])
        want, got = _outcome(tmp_path, data)
        assert want is None and match in got


# ------------------------------------------------------------ old-style JPEG

def _jpeg(px, **kw):
    b = io.BytesIO()
    Image.fromarray(px).save(b, "JPEG", **kw)
    return b.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("form", ["interchange", "header", "tables", "stream"])
def test_ojpeg_forms_match_pil(tmp_path, form, subsampling):
    px = pattern(37, 53, 40 + subsampling)
    rows = 16 if subsampling == 2 else 8
    plain = _jpeg(px, quality=80, subsampling=subsampling)
    restarts = _jpeg(px, quality=80, subsampling=subsampling, restart_marker_rows=1)
    _check(tmp_path, ojpeg_tiff(plain, form))
    if form != "stream":
        _check(tmp_path, ojpeg_tiff(restarts, form, rows_per_strip=rows))
    if form == "tables":  # one strip, its restarts named by JPEGRestartInterval
        mcus = -(-53 // (16 if subsampling else 8))
        _check(tmp_path, ojpeg_tiff(restarts, form, restart_tag=mcus))


def test_ojpeg_differs_from_the_bare_stream_as_libtiff_converts_it(tmp_path):
    """The reason PIL's OJPEG read is not its JPEG read: at 4:2:0 libtiff's
    RGBA reader repeats each 2x2 block's chroma where libjpeg interpolates
    (tens of levels near edges); at 4:4:4 only the conversion's arithmetic
    differs (at most one level)."""
    px = pattern(48, 64, 50)
    for subsampling, most in ((2, 255), (0, 1)):
        stream = _jpeg(px, quality=90, subsampling=subsampling)
        bare = np.asarray(Image.open(io.BytesIO(stream)).convert("RGB")).astype(int)
        got = _check(tmp_path, ojpeg_tiff(stream, "interchange")).astype(int)
        diff = np.abs(got - bare).max()
        assert diff <= most and (diff > 1 if subsampling == 2 else True)


@pytest.mark.parametrize("photometric", [0, 1])
def test_grey_ojpeg_matches_pil(tmp_path, photometric):
    stream = _jpeg(pattern(21, 30, 60)[..., 0], quality=70)
    for form in ("interchange", "tables"):
        _check(tmp_path, ojpeg_tiff(stream, form, photometric=photometric))


def test_ojpeg_directory_fixups(tmp_path):
    """libtiff reads compression 6 without a photometric, or with RGB, as
    YCbCr, takes the frame's sampling over the tag's (and where the tag is
    missing), cuts the tag's values to a byte and ignores JPEGProc; the
    tables form reads in big-endian order too."""
    stream = _jpeg(pattern(29, 45, 61), quality=75, subsampling=1)
    _check(tmp_path, ojpeg_tiff(stream, "interchange", omit=(262,)))
    _check(tmp_path, ojpeg_tiff(stream, "interchange", photometric=2))
    _check(tmp_path, ojpeg_tiff(stream, "interchange", subsampling=False))
    _check(tmp_path, ojpeg_tiff(stream, "interchange", tags={530: (3, [2, 2])}))
    _check(tmp_path, ojpeg_tiff(stream, "tables", tags={530: (3, [258, 1])}))
    _check(tmp_path, ojpeg_tiff(stream, "interchange", tags={512: (3, [14])}))
    _check(tmp_path, ojpeg_tiff(stream, "tables", order=">"))  # big-endian tags and offsets


def test_ojpeg_restarts_are_strict_and_the_source_can_run_dry(tmp_path):
    """libtiff's source manager fails where libjpeg resynchronises (any
    marker but the expected RSTn at a restart) and where its strips run
    out after an RSTn it wrote: the YCbCr route then reads stale strips in
    PIL, and the port refuses, saying so."""
    px = pattern(32, 40, 62)
    stream = _jpeg(px, quality=80, subsampling=0, restart_marker_rows=1)
    data = bytearray(ojpeg_tiff(stream, "header", rows_per_strip=8))
    # cut the last strip's byte count to 0 bytes of data: offset past the end
    ifd = int.from_bytes(data[4:8], "little")
    for i in range(int.from_bytes(data[ifd:ifd + 2], "little")):
        at = ifd + 2 + 12 * i
        if int.from_bytes(data[at:at + 2], "little") == 273:
            offsets_at = int.from_bytes(data[at + 8:at + 12], "little")
            data[offsets_at + 12:offsets_at + 16] = (10 ** 6).to_bytes(4, "little")
    want, got = _outcome(tmp_path, bytes(data))
    assert want is not None and isinstance(got, str) and "as it stood" in got


# ---------------------------------------------------------------- corruption

def _corruption_bases():
    r = np.random.default_rng(70)
    bits = _bilevel(r, 14, 45)
    fax = {f"fax{comp}-{opt}": tiff_bytes(
        bits[..., None], 1, 0, compression=comp, rows_per_strip=7,
        blocks=[fax_strip(bits[y:y + 7], comp, two_d=bool(opt)) for y in (0, 7)],
        tags={292: (4, [opt])} if comp == 3 else {})
        for comp, opt in ((2, 0), (3, 0), (3, 1), (4, 0), (32771, 0))}
    p4 = r.integers(0, 16, (9, 21))
    thunder = {"thunder": tiff_bytes(p4[..., None], 4, 1, compression=32809, rows_per_strip=5,
                                     blocks=[thunder_rows(p4[:5], r), thunder_rows(p4[5:], r)])}
    ojpeg = {}
    for ss in (0, 1, 2):
        stream = _jpeg(pattern(29, 45, 71 + ss), quality=70, subsampling=ss,
                       restart_marker_rows=1)
        rows = 16 if ss == 2 else 8
        ojpeg[f"oj{ss}-i"] = ojpeg_tiff(stream, "interchange")
        ojpeg[f"oj{ss}-h"] = ojpeg_tiff(stream, "header", rows_per_strip=rows)
        ojpeg[f"oj{ss}-t"] = ojpeg_tiff(stream, "tables", rows_per_strip=rows)
    return {"fax": fax, "thunder": thunder, "ojpeg": ojpeg}


@pytest.mark.parametrize("family", ["fax", "thunder", "ojpeg"])
def test_seeded_corruption_reads_as_pil_or_is_refused(tmp_path, family):
    bases = _corruption_bases()[family]
    names = sorted(bases)
    r = np.random.default_rng({"fax": 1, "thunder": 2, "ojpeg": 3}[family])
    read = refused = stale = 0
    for i in range(150):
        name = names[i % len(names)]
        data = bytearray(bases[name])
        op = r.integers(0, 4)
        if op == 0:
            for _ in range(r.integers(1, 4)):
                data[r.integers(0, len(data))] = r.integers(0, 256)
        elif op == 1:
            data = data[:r.integers(8, len(data) + 1)]
        elif op == 2:
            data[r.integers(8, len(data))] ^= 1 << r.integers(0, 8)
        else:
            data += r.integers(0, 256, r.integers(1, 20)).astype(np.uint8).tobytes()
        want, got = _outcome(tmp_path, bytes(data))
        if want is None:
            assert isinstance(got, str), f"{name}: PIL refuses {bytes(data).hex()}"
            refused += 1
        elif isinstance(got, str):
            assert any(s in got for s in STALE), f"{name}: {got}: {bytes(data).hex()}"
            stale += 1
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name}: {bytes(data).hex()}")
            read += 1
    assert read > 40 and refused > 20 and stale < 20


# -------------------------------------------------------------------- SGILog

@pytest.mark.parametrize("comp", [34676, 34677])
@pytest.mark.parametrize("photometric, bits, spp, fmt", [
    (32844, 16, 1, 2), (32845, 16, 3, 2), (32844, 32, 1, 3), (32845, 8, 3, 1), (1, 16, 1, 1),
    (0, 8, 1, 1), (2, 8, 3, 1), (1, 32, 1, 3)])
def test_sgilog_is_refused_by_pil_and_by_the_port(tmp_path, comp, photometric, bits, spp, fmt):
    px = np.zeros((4, 4, spp), np.float32 if fmt == 3 else int)
    data = tiff_bytes(px, bits, photometric, compression=1, sample_format=fmt,
                      tags={259: (3, [comp])})
    want, got = _outcome(tmp_path, data)
    assert want is None
    assert isinstance(got, str) and "SGILog" in got and "PIL refuses it" in got


@pytest.mark.parametrize("sof_ids, sos_ids", [
    ((1, 1, 1), (1, 1, 1)), ((2, 2, 3), (2, 2, 3)), ((1, 2, 3), (1, 2, 2)),
    ((1, 2, 3), (3, 2, 1)), ((1, 2, 3), (2, 1, 3))])
def test_scan_component_ids_follow_libjpeg_turbo(sof_ids, sos_ids):
    """get_sos takes, for scan position i, the first frame component of the
    id whose index is a scan position not yet filled: repeated ids in both
    headers read, a repeat or a reordering the rule cannot place is
    refused; an old-style JPEG stream whose scan header libtiff leaves
    zeroed fails the same way."""
    data = bytearray(_jpeg(pattern(16, 24, 1), quality=80, subsampling=0))
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    for k, v in enumerate(sof_ids):
        data[sof + 10 + 3 * k] = v
    for k, v in enumerate(sos_ids):
        data[sos + 5 + 2 * k] = v
    try:
        want = np.asarray(Image.open(io.BytesIO(bytes(data))).convert("RGB"))
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="invalid component ID"):
            port_image.decode_image(bytes(data))
    else:
        np.testing.assert_array_equal(port_image.decode_image(bytes(data)), want)
