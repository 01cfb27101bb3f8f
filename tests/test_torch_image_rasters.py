"""Port parity: the PIL-free Sun raster, FITS, GBR, McIdas, PIXAR and XV
thumbnail decoders (akari_torch/core/sun.py, fits.py, rasters.py) against
PIL 12.1.0's plugins, through which the JAX package's ``read_image`` reads
such files.

Tolerance: exact. Wherever PIL reads a file (from a path, as
``read_image`` does) the port gives PIL's ``convert("RGB")`` pixels and
names the same format; wherever PIL's open or load fails the port raises
``ValueError``. Pillow writes none of these formats: the files come from
``tools/raster_writers.py`` and every one is read back through PIL here.

- Sun: depths 1 / 4 / 8 / 24 / 32, palettes of every length PIL takes,
  file types 0-5 (type 2 run-length: escapes, runs across rows, runs past
  the image, cut data), header rules, seeded corruption;
- FITS: BITPIX 8 / 16 / 32 / -32 / -64 (PIL's native byte order, a -64
  image read as float32, BZERO / BSCALE ignored), NAXIS 1 and 3, the
  GZIP_1 table route (-32 refused by PIL's load), a seeded header grammar;
- GBR versions 1 and 2, depths 1 and 4, comment lengths, header rules;
- McIdas at 1, 2 and 4 bytes, line prefixes and strides PIL maps (lines
  overlapping, back to back, past the file) or decodes;
- PIXAR (only the (14, 2) pair opens) and XV thumbnails (size lines).
"""

import hashlib
import json
import os
import struct

import numpy as np
import pytest

from akari_torch.core import image as port_image
from tests._raster_checks import FIXTURES, check, corrupt, fixtures, pil_path
from tools import raster_writers as rw
from tools.make_torch_port_image_fixtures import pattern, raster_fixtures

RASTER_FIXTURES = fixtures("sun_", "flc_", "fli_", "fits_", "gbr_", "mcidas_", "pixar_",
                           "xvthumb_", "xpm_")


# ------------------------------------------------------------------ the fixtures

def test_raster_fixtures_are_the_tools_and_pils():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    written = raster_fixtures()
    assert sorted(written) == RASTER_FIXTURES and len(RASTER_FIXTURES) >= 16
    for name in RASTER_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert written[name] == f.read(), name
        px = pil_path(os.path.join(FIXTURES, name))[1]
        assert hashlib.sha256(px.tobytes()).hexdigest() == digests[name]["sha256"], name


@pytest.mark.parametrize("name", RASTER_FIXTURES)
def test_raster_fixture_reads_as_pil_and_jax(tmp_path, name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    fmt = {"sun": "SUN", "flc": "FLI", "fli": "FLI", "fits": "FITS", "gbr": "GBR",
           "mcidas": "MCIDAS", "pixar": "PIXAR", "xvthumb": "XVThumb", "xpm": "XPM"}
    check(tmp_path, data, fmt[name.split("_")[0]], jax=True, name=name)


# ------------------------------------------------------------------ Sun


def _sun_px(r, depth, h, w):
    if depth >= 24:
        px = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        px[:, :w // 2] = px[:, :1]
    else:
        px = r.integers(0, 1 << min(depth, 8), (h, w)).astype(np.uint8)
        px[:, :w // 3] = 0x80 & ((1 << depth) - 1)
    return px


@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("file_type", [0, 1, 2, 3, 4, 5])
def test_drawn_sun_rasters_read_as_pil(tmp_path, depth, file_type):
    """Sizes with odd rows (16-bit padding), palettes of 0-300 entries (a
    palette under depth 1 / 24 / 32 or of more than 256 entries makes PIL's
    load fail), runs of every length cap, cut files."""
    r = np.random.default_rng(depth * 10 + file_type)
    for case in range(6):
        h, w = int(r.integers(1, 12)), int(r.integers(1, 20))
        px = _sun_px(r, depth, h, w)
        n = [None, None, 3, 16, 256, 300][case]
        pal = None if n is None else r.integers(0, 256, (n, 3))
        data = rw.sun_bytes(px, depth, file_type, palette=pal, most=int(r.integers(2, 257)))
        reads = pal is None or (depth in (4, 8) and n <= 256)
        # (width 1 or 2 passes GBR's signature, tried first: test_torch_image_fli_xpm.py)
        got = check(tmp_path, data, ("SUN" if reads else False) if w > 2 else None)
        if reads and pal is None and depth >= 24 and w > 2:
            np.testing.assert_array_equal(got, px)
        check(tmp_path, data[:-int(r.integers(1, 4))])


def test_sun_header_rules_are_pils(tmp_path):
    """Depths, palette types and lengths, file types and sizes PIL opens,
    passes over (to the next format) or fails on."""
    px = _sun_px(np.random.default_rng(1), 8, 3, 5)
    base = rw.sun_bytes(px, 8)

    def head(**kw):
        f = dict(zip(("w", "h", "depth", "length", "type", "ptype", "plen"),
                     struct.unpack_from(">7I", base, 4)))
        f.update(kw)
        return struct.pack(">8I", 0x59A66A95, *f.values())

    for depth in (0, 2, 16, 31, 33):
        assert check(tmp_path, head(depth=depth) + base[32:], False) is None
    for ftype, ok in ((6, False), (0xFFFF, False), (5, True)):
        check(tmp_path, head(type=ftype) + base[32:], "SUN" if ok else False)
    for w, h in ((0, 3), (5, 0)):
        assert check(tmp_path, head(w=w, h=h) + base[32:], False) is None
    pal = bytes(range(48))
    for ptype, plen, ok in ((1, 48, True), (2, 48, False), (0, 48, False), (5, 0, True),
                            (1, 1, True), (1, 770, True), (1, 771, False), (1, 1025, False)):
        body = pal * 30
        got = check(tmp_path, head(ptype=ptype, plen=plen) + body[:plen] + base[32:],
                    "SUN" if ok else False)
        if plen in (1, 48) and ok:
            assert got.shape == (3, 5, 3)


def test_sun_run_length_escapes_are_pils(tmp_path):
    """0x80 0x00 is one 0x80; 0x80 n v is n + 1 bytes v, continuing across
    rows; a run past the image's end is cut; the stream ending in a run or
    an escape is a truncated file; rows are read unpadded."""
    def rle(w, h, body, depth=8):
        return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), 2, 0, 0) + body

    cases = {b"\x01\x02\x03\x04\x05\x06": [[1, 2, 3], [4, 5, 6]],
             b"\x80\x00\x02\x80\x03\x09": [[128, 2, 9], [9, 9, 9]],
             b"\x80\x06\x07": [[7, 7, 7], [7, 7, 7]],
             b"\x80\xff\x07": [[7, 7, 7], [7, 7, 7]],
             b"\x80\x01\x07\x01\x02\x03\x04": [[7, 7, 1], [2, 3, 4]]}
    for body, want in cases.items():
        got = check(tmp_path, rle(3, 2, body), "SUN")
        assert got[..., 0].tolist() == want
    for body in (b"\x80\x01\x07\x01\x02", b"\x80\x01\x07\x01\x02\x80",
                 b"\x80\x01\x07\x01\x02\x80\x02", b""):
        assert check(tmp_path, rle(3, 2, body), False) is None
    got = check(tmp_path, rle(3, 2, bytes(range(1, 19)), 24), "SUN")
    assert got[0, 0].tolist() == [3, 2, 1] and got[1, 2].tolist() == [18, 17, 16]


@pytest.mark.parametrize("seed", range(3))
def test_sun_seeded_corruption_reads_or_refuses_as_pil(tmp_path, seed):
    r = np.random.default_rng(300 + seed)
    for depth, ftype in ((8, 2), (24, 2), (4, 1), (32, 3)):
        px = _sun_px(r, depth, int(r.integers(2, 9)), int(r.integers(2, 15)))
        pal = r.integers(0, 256, (16, 3)) if depth in (4, 8) else None
        data = rw.sun_bytes(px, depth, ftype, palette=pal, most=int(r.integers(3, 100)))
        corrupt(lambda d: check(tmp_path, d), data, r, 12)


# ------------------------------------------------------------------ FITS


def _fits_values(r, bitpix, h, w):
    if bitpix == 8:
        return r.integers(0, 256, (h, w))
    if bitpix == 16:
        return r.integers(-32768, 32768, (h, w))
    if bitpix == 32:
        return r.integers(-(1 << 31), 1 << 31, (h, w))
    v = r.normal(120, 150, (h, w))
    v.ravel()[:3] = [np.nan, np.inf, -np.inf]
    return v


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_drawn_fits_read_as_pil(tmp_path, bitpix):
    """Raw images in every BITPIX (NAXIS 1, 2 and 3, BZERO / BSCALE cards
    PIL ignores) and GZIP_1 tables (PIL keeps the last min(BITPIX // 8, 4)
    bytes of each word: none for floats, so its load fails)."""
    r = np.random.default_rng(bitpix + 100)
    for case in range(4):
        h, w = int(r.integers(1, 10)), int(r.integers(1, 14))
        v = _fits_values(r, bitpix, h, w)
        cards = [[], [rw.fits_card("BZERO", 32768), rw.fits_card("BSCALE", 3)],
                 [rw.fits_card("NAXIS3", 2), rw.fits_card("COMMENT")], []][case]
        data = rw.fits_bytes(v if case < 2 else np.concatenate([v, v[::-1]]), bitpix,
                             cards=cards)
        check(tmp_path, data, "FITS")
        check(tmp_path, rw.fits_bytes(v[:, :1], bitpix, naxis=1), "FITS")
        words = r.integers(0, 1 << 31, (h, w))
        check(tmp_path, rw.fits_gzip_bytes(words, bitpix), "FITS" if bitpix > 0 else False)
        check(tmp_path, rw.fits_gzip_bytes(words, bitpix, pad=False))


def test_fits_quirks_are_pils(tmp_path):
    """PIL's raw modes are its native (little-endian) ones: a 16-bit sample
    0x0102 reads as 0x0201 (clipped to 255), a 32-bit 1 as 2^24; a -64 image
    is read as float32 from its first bytes; rows are bottom up; BZERO
    changes nothing; a float GZIP_1 table fails; a data unit shorter than
    a card (80 bytes, unpadded) is looked for before its start, in the
    header."""
    def one(bitpix, values, cards=()):
        return check(tmp_path, rw.fits_bytes(np.array(values), bitpix, cards=cards),
                     "FITS")[..., 0].tolist()

    assert one(8, [[1, 2], [3, 4]]) == [[3, 4], [1, 2]]
    assert one(8, [[1, 2], [3, 4]], [rw.fits_card("BZERO", 100)]) == [[3, 4], [1, 2]]
    assert one(16, [[0x0102, 0x0001], [0x0100, 0x7F00]]) == [[1, 127], [255, 255]]
    assert one(32, [[1, 0x01000000]]) == [[255, 1]]
    f64 = np.frombuffer(np.array([[2.5, 7.0]], ">f8").tobytes(), "<f4")
    got = one(-64, [[2.5, 7.0]])
    np.testing.assert_array_equal(got, [np.where(np.isfinite(f64), np.clip(f64, 0, 255), 0)[:2]
                                       .astype(np.uint8).tolist()])
    assert check(tmp_path, rw.fits_gzip_bytes(np.ones((2, 2)), -32), False) is None
    tiny = rw.fits_gzip_bytes(np.ones((2, 2)), 8, pad=False)
    assert len(tiny) < 5760 + 80 and check(tmp_path, tiny, False) is None
    check(tmp_path, rw.fits_gzip_bytes(np.ones((2, 2)), 8), "FITS")


@pytest.mark.parametrize("seed", range(4))
def test_fits_header_grammar_as_pils(tmp_path, seed):
    """Seeded card soups: keywords in any order, values with and without
    ``=``, comments after ``/``, missing and unparsable keywords, NAXIS 0
    then an XTENSION unit, END placed early or late, units cut short."""
    r = np.random.default_rng(seed)
    for _ in range(40):
        v = r.integers(0, 256, (int(r.integers(1, 5)), int(r.integers(1, 6))))
        h, w = v.shape
        pool = [("BITPIX", int(r.choice([8, 8, 16, -32, 24]))),
                ("NAXIS", int(r.choice([2, 2, 1, 0]))),
                ("NAXIS1", w), ("NAXIS2", h), ("BZERO", 0), ("OBJECT", "'M31'"),
                ("NAXIS1", "'x'"), ("COMMENT", None)]
        keep = [c for c in pool if r.random() < 0.8]
        r.shuffle(keep)
        cards = [rw.fits_card(k, val, "c" if r.random() < 0.3 else None) for k, val in keep]
        if r.random() < 0.2:
            cards.insert(0, rw.fits_card("SIMPLE", "F"))
        head = rw.fits_unit([rw.fits_card("SIMPLE", "T"), *cards])
        if r.random() < 0.3:
            head += rw.fits_unit([rw.fits_card("XTENSION", "'IMAGE   '"),
                                  rw.fits_card("BITPIX", 8), rw.fits_card("NAXIS", 2),
                                  rw.fits_card("NAXIS1", w), rw.fits_card("NAXIS2", h)])
        data = head + v.astype(np.uint8).tobytes() * 4
        if r.random() < 0.2:
            data = data[:int(r.integers(1, len(data)))]
        check(tmp_path, data)


def test_fits_seeded_corruption_reads_or_refuses_as_pil(tmp_path):
    r = np.random.default_rng(31)
    for bitpix in (8, 16, -32):
        v = _fits_values(r, bitpix, 4, 5)
        corrupt(lambda d: check(tmp_path, d), rw.fits_bytes(v, bitpix), r, 8)
        corrupt(lambda d: check(tmp_path, d),
                rw.fits_gzip_bytes(np.nan_to_num(v, posinf=0, neginf=0).astype(np.int64) % 999,
                                   16),
                r, 8, lo=5760)


# ------------------------------------------------------------------ GBR


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("depth", [1, 4])
def test_drawn_gbr_read_as_pil(tmp_path, version, depth):
    r = np.random.default_rng(version * 10 + depth)
    for _ in range(5):
        h, w = int(r.integers(1, 12)), int(r.integers(1, 16))
        px = r.integers(0, 256, (h, w) if depth == 1 else (h, w, 4)).astype(np.uint8)
        comment = bytes(r.integers(32, 127, int(r.integers(0, 30))).astype(np.uint8))
        data = rw.gbr_bytes(px, version, comment=comment, spacing=int(r.integers(0, 100)))
        got = check(tmp_path, data, "GBR")
        np.testing.assert_array_equal(got, np.repeat(px[..., None], 3, -1) if depth == 1
                                      else px[..., :3])
        check(tmp_path, data[:-1], False)


def test_gbr_header_rules_are_pils(tmp_path):
    """Header sizes below a version's fixed part (a negative comment length
    reads the rest of the file: no data left), versions, depths, zero
    sizes, the magic, and a size past PIL's pixel limit (its open fails)."""
    g = np.arange(12, dtype=np.uint8).reshape(3, 4)
    for size in (19, 20, 21, 27, 28, 40):
        for version in (1, 2):
            data = rw.gbr_bytes(g, version, header_size=size)
            check(tmp_path, data, False if size < 20 or (version == 2 and size < 28) else None)
    for version, depth, ok in ((3, 1, False), (0, 1, False), (1, 2, False), (1, 3, False),
                               (1, 4, True)):
        data = struct.pack(">5I", 21, version, 4, 3, depth) + b"\0" + bytes(range(12 * depth))
        check(tmp_path, data, "GBR" if ok else False)
    zero = rw.gbr_bytes(g, 1)
    check(tmp_path, zero[:8] + struct.pack(">I", 0) + zero[12:], False)
    check(tmp_path, rw.gbr_bytes(g, 2).replace(b"GIMP", b"GIMQ"), False)
    huge = rw.gbr_bytes(g, 1)[:8] + struct.pack(">II", 20_000, 20_000) + rw.gbr_bytes(g, 1)[16:]
    assert check(tmp_path, huge, False) is None
    assert port_image.image_format(huge) is None
    with pytest.raises(ValueError, match="more pixels than PIL opens"):
        port_image.decode_image(huge, "huge")


# ------------------------------------------------------------------ McIdas


@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_drawn_mcidas_read_as_pil(tmp_path, nbytes):
    r = np.random.default_rng(nbytes)
    for case in range(6):
        h, w = int(r.integers(1, 9)), int(r.integers(1, 12))
        v = r.integers(0, 1 << (8 * min(nbytes, 3)), (h, w))
        prefix = bytes(r.integers(0, 256, int(r.integers(0, 5))).astype(np.uint8))
        data = rw.mcidas_bytes(v, nbytes, prefix=prefix, bands=int(r.integers(1, 3)),
                               offset=int(r.choice([256, 300])))
        got = check(tmp_path, data, "MCIDAS")
        if len(prefix) == 0 and data[59] == 1:   # one band, lines back to back
            np.testing.assert_array_equal(got[..., 0], np.clip(v, 0, 255))
        check(tmp_path, data[:-int(r.integers(1, 8))])


@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_mcidas_strides_as_pils_map_or_decoder(tmp_path, nbytes):
    """L and I;16B are memory-mapped from a path (lines may overlap, a
    stride of 0 or less means back to back, a map past the end fails), I
    always decoded (a stride short of a line fails); offsets past the end
    or negative."""
    v = np.arange(30).reshape(5, 6) * 7
    for words in ({14: 0, 15: 0}, {14: 0, 15: 3}, {14: -1}, {14: 3}, {34: -10}, {34: 10 ** 6},
                  {15: 2, 14: 0}, {9: 0}, {10: -3}, {11: 3}, {11: 8}):
        for cut in (0, 1, 7):
            data = rw.mcidas_bytes(v, nbytes, words=words)
            check(tmp_path, data[:len(data) - cut])


def test_mcidas_seeded_corruption_reads_or_refuses_as_pil(tmp_path):
    r = np.random.default_rng(41)
    for nbytes in (1, 2, 4):
        data = rw.mcidas_bytes(r.integers(0, 300, (4, 6)), nbytes, prefix=b"ab")
        corrupt(lambda d: check(tmp_path, d), data, r, 12)


# ------------------------------------------------------------------ PIXAR, XV


def test_pixar_reads_as_pil(tmp_path):
    """Only the channel / depth pair (14, 2) sets a mode: any other, or a
    zero size, makes PIL try the next format (none takes the file)."""
    r = np.random.default_rng(5)
    for h, w in ((1, 1), (3, 7), (9, 13)):
        px = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = check(tmp_path, rw.pixar_bytes(px, fill=7), "PIXAR", jax=True)
        np.testing.assert_array_equal(got, px)
        check(tmp_path, rw.pixar_bytes(px)[:-1], False)
        for pair in ((14, 3), (13, 2), (0, 0)):
            check(tmp_path, rw.pixar_bytes(px, pair), False)
    check(tmp_path, rw.pixar_bytes(np.zeros((0, 4, 3), np.uint8)), False)
    check(tmp_path, rw.pixar_bytes(px)[:427], False)


def test_xvthumb_reads_as_pil(tmp_path):
    """The RGB332 palette with PIL's integer divisions; comment lines; size
    lines with fewer than two fields or fields that are not integers fail
    PIL's open (a size line without its newline runs into the data), a zero
    or negative size makes it try the next format."""
    r = np.random.default_rng(6)
    idx = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = check(tmp_path, rw.xvthumb_bytes(idx), "XVThumb", jax=True)
    np.testing.assert_array_equal(got.reshape(256, 3)[[0, 255, 0b11100000, 0b00000011]],
                                  [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]])
    idx = r.integers(0, 256, (3, 4))
    for size, fmt in ((b"4 3\n", "XVThumb"), (b" 4\t3 \n", "XVThumb"), (b"4 3 255 x\n", "XVThumb"),
                      (b"+4 3\n", "XVThumb"), (b"4\n", False), (b"\n", False), (b"x 3\n", False),
                      (b"-4 3\n", False), (b"0 3\n", False), (b"4 3", False)):
        check(tmp_path, rw.xvthumb_bytes(idx, size=size), fmt)
    for data in (b"P7 332", b"P7 332\n#c\n", rw.xvthumb_bytes(idx, comments=(), first=b"\n"),
                 rw.xvthumb_bytes(idx)[:-1]):
        check(tmp_path, data)


@pytest.mark.parametrize("form", ["pixar", "xvthumb"])
def test_pixar_xvthumb_seeded_corruption(tmp_path, form):
    r = np.random.default_rng(7)
    px = pattern(5, 7, 3)
    data = rw.pixar_bytes(px) if form == "pixar" else rw.xvthumb_bytes(rw.rgb332(px))
    corrupt(lambda d: check(tmp_path, d), data, r, 15, lo=400 if form == "pixar" else 0)
