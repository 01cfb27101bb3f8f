"""Port parity: the PIL-free FLI / FLC and XPM decoders
(akari_torch/core/fli.py, xpm.py, native/rle.cpp::akr_fli_frame), the
IPTC band read from any one-band image (akari_torch/core/iptc.py, through
``decode_with_mode``), and the gates of the weak signatures (GBR, FLI,
McIdas) in ``core/image.py``'s dispatch, against PIL 12.1.0.

Tolerance: exact, as tests/test_torch_image_rasters.py: the port gives
PIL's ``convert("RGB")`` pixels and format wherever PIL reads a file from
a path, and raises ``ValueError`` wherever PIL's open or load fails.

- FLI / FLC frame 0: colour chunks of 8- and 6-bit entries (skips, counts
  of 256, a prefix chunk before the frame), BRUN, LC, SS2 (line skips and
  last-byte words), COPY, black and stamp chunks, drawn frames and
  seeded raw chunks (sizes 0, short, past the buffer; packets past a
  line's end), header rules, truncation;
- XPM: one to three characters a pixel, ``P`` and ``RGB`` (more than 256
  colours), PIL's line rules (rows short and long, quoted comments, the
  ``/* pixels */`` line, a colour line without its comma), the colour
  grammar (``None``, names, ``#`` forms Python's ``int`` takes), a seeded
  grammar, and a 1024^2 file decoded without a loop per pixel;
- IPTC: a band taken from a grey TIFF, a PGM, a grey-palette BMP, JPEG,
  PNG and the new formats, merged as PIL merges it, and the refusals
  (mode mismatch, wrong mode, PIL's crash on ``I`` / ``F``);
- gates: TGA, TIFF, ICO, QOI, Sun and PhotoCD files crafted to pass GBR's,
  FLI's or McIdas's signature, read as PIL reads them (as their own format
  or as the weak one) or refused where PIL's open fails (GBR's pixel limit).
"""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from tests._raster_checks import FIXTURES, ROOT, check, corrupt, pil_path
from tools import raster_writers as rw
from tools.legacy_writers import qoi_bytes
from tools.make_torch_port_image_fixtures import pattern, raster_albedo_files, tga_bytes

# ------------------------------------------------------------------ FLI


def _drawn_frame(r, w, h):
    """Subchunks of a frame: an optional colour chunk, a BRUN / COPY /
    black / no first image, then LC and SS2 deltas and a stamp."""
    base = r.integers(0, 256, (h, w)).astype(np.uint8)
    base[:, :w // 2] = base[:, :1]
    chunks, image = [], np.zeros((h, w), np.uint8)
    if r.random() < 0.7:
        kind = int(r.choice([4, 11]))
        entries = [(int(r.integers(0, 4)), r.integers(0, 256 if kind == 4 else 64,
                                                       (int(r.integers(1, 40)), 3)))
                   for _ in range(int(r.integers(1, 4)))]
        chunks.append(rw.fli_chunk(kind, rw.fli_colour(entries, kind)))
    first = r.choice(["brun", "copy", "black", "none"])
    if first == "brun":
        chunks.append(rw.fli_chunk(15, rw.fli_brun(base, int(r.integers(1, 128)))))
        image = base
    elif first == "copy":
        chunks.append(rw.fli_chunk(16, base.tobytes()))
        image = base
    elif first == "black":
        chunks.append(rw.fli_chunk(13, bytes(4)))
    for _ in range(int(r.integers(0, 3))):
        new = image.copy()
        for _ in range(int(r.integers(1, 5))):
            y, x = int(r.integers(0, h)), int(r.integers(0, w))
            new[y, x:x + int(r.integers(1, 6))] = r.integers(0, 256)
        if w % 2 == 0 and r.random() < 0.5:
            chunks.append(rw.fli_chunk(7, rw.fli_ss2(new, image, r)))
        else:
            chunks.append(rw.fli_chunk(12, rw.fli_lc(new, image, r)))
        image = new
    if r.random() < 0.2:
        chunks.append(rw.fli_chunk(18, b"stamp" * 3))
    return chunks


@pytest.mark.parametrize("seed", range(4))
def test_drawn_fli_frames_read_as_pil(tmp_path, seed):
    """Drawn frames of every chunk type, FLI and FLC, one or two frames
    (frame 0 read), each also with 1-3 bytes after the header set to
    drawn values and cut at a drawn length."""
    r = np.random.default_rng(seed)
    read = 0
    for case in range(40):
        w, h = int(r.integers(3, 20)), int(r.integers(2, 12))
        w += w % 2 if r.random() < 0.5 else 0
        frames = [rw.fli_frame(_drawn_frame(r, w, h))]
        if r.random() < 0.3:
            frames.append(rw.fli_frame([rw.fli_chunk(13, bytes(4))]))
        data = rw.fli_bytes(w, h, frames, magic=int(r.choice([0xAF11, 0xAF12])))
        read += check(tmp_path, data, jax=case == 0) is not None
        corrupt(lambda d: check(tmp_path, d), data, r, 3, lo=128)
    assert read >= 30


@pytest.mark.parametrize("seed", range(3))
def test_raw_fli_chunks_decode_as_pils(tmp_path, seed):
    """Subchunks of drawn bytes under drawn headers (SS2 flag words, LC line
    ranges, BRUN counts), sizes of 0, too short and past the buffer, frame
    sizes short and long: PIL's FliDecode.c checks, step for step."""
    r = np.random.default_rng(40 + seed)
    for _ in range(150):
        w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
        chunks = []
        for _ in range(int(r.integers(1, 4))):
            kind = int(r.choice([7, 12, 15, 16, 13, 4, 11, 18, 7, 12, 15, 99]))
            size = int(r.integers(0, 60))
            payload = bytearray(r.integers(0, 256, size).astype(np.uint8).tobytes())
            if kind == 7 and size >= 4:
                payload[0:2] = struct.pack("<H", int(r.integers(0, h + 2)))
                payload[2:4] = struct.pack("<H", int(r.choice(
                    [0xFFFF, 0xFFFE, 0x8012, 0xC000 + int(r.integers(0, 0x4000)), 1, 2])))
            if kind == 12 and size >= 4:
                payload[0:4] = struct.pack("<HH", int(r.integers(0, h + 1)),
                                           int(r.integers(0, h + 1)))
            if kind == 15:
                for k in range(0, size, 3):
                    payload[k] = int(r.integers(0, 3))
            c = rw.fli_chunk(kind, bytes(payload))
            if r.random() < 0.15:
                c = struct.pack("<I", int(r.choice([0, 1, 5, 6, 10, len(c) + 3,
                                                    0xFFFFFFF0]))) + c[4:]
            chunks.append(c)
        frame = rw.fli_frame(chunks)
        if r.random() < 0.1:
            frame = struct.pack("<I", int(r.choice([0, 3, len(frame) - 1, len(frame) + 1,
                                                    0xBF000083]))) + frame[4:]
        check(tmp_path, rw.fli_bytes(w, h, [frame]) + bytes(int(r.integers(0, 3))))


def test_fli_header_and_palette_rules_are_pils(tmp_path):
    """PIL's open: reserved bytes, flags, no frames (the next format), a
    prefix chunk (its palette is found, but PIL loads the prefix as the
    frame and fails), palette packets with skips and a count of 256, 6-bit
    entries shifted and cut to 8 bits, packets past entry 255 or cut
    short (the next format)."""
    idx = np.arange(48, dtype=np.uint8).reshape(6, 8)
    copy = rw.fli_chunk(16, idx.tobytes())
    pal = np.arange(256 * 3).reshape(256, 3) % 256

    def fli(chunks, **kw):
        return rw.fli_bytes(8, 6, [rw.fli_frame(chunks)], **kw)

    got = check(tmp_path, fli([rw.fli_chunk(4, rw.fli_colour([(0, pal)])), copy]), "FLI",
                jax=True)
    np.testing.assert_array_equal(got, pal[idx])
    six = rw.fli_colour([(3, np.full((2, 3), 63)), (1, np.full((1, 3), 64))], 11)
    got = check(tmp_path, fli([rw.fli_chunk(11, six), copy]), "FLI")
    assert got[0, :7, 0].tolist() == [0, 1, 2, 252, 252, 5, 0]
    check(tmp_path, fli([copy, rw.fli_chunk(4, rw.fli_colour([(200, pal[:56])]))]), "FLI")
    check(tmp_path, fli([copy, rw.fli_chunk(4, rw.fli_colour([(200, pal[:57])]))]), False)
    check(tmp_path, fli([rw.fli_chunk(4, rw.fli_colour([(0, pal)])[:100])]), "FLI")  # 32 entries
    check(tmp_path, fli([rw.fli_chunk(4, rw.fli_colour([(0, pal)])[:101])]), False)
    check(tmp_path, fli([copy], prefix=bytes(10)), False)
    check(tmp_path, fli([copy], n_frames=0), False)
    for flags, ok in ((0, True), (3, True), (1, False)):
        check(tmp_path, fli([copy], flags=flags), "FLI" if ok else False)
    data = bytearray(fli([copy]))
    for pos in (20, 50, 100):
        bad = data.copy()
        bad[pos] = 1
        check(tmp_path, bytes(bad), False)
    check(tmp_path, bytes(data[:128]), False)
    check(tmp_path, bytes(data[:-1]), False)
    check(tmp_path, rw.fli_bytes(0, 6, [rw.fli_frame([copy])]), False)


# ------------------------------------------------------------------ XPM


@pytest.mark.parametrize("ncolours", [1, 8, 256, 257, 600])
def test_drawn_xpm_read_as_pil(tmp_path, ncolours):
    r = np.random.default_rng(ncolours)
    for bpp in (1, 2, 3):
        if ncolours > 90 ** bpp:
            continue
        h, w = int(r.integers(1, 12)), int(r.integers(1, 16))
        idx = r.integers(0, ncolours, (h, w))
        colours = r.integers(0, 256, (ncolours, 3))
        got = check(tmp_path, rw.xpm_bytes(idx, colours, bpp=bpp,
                                           pixels_comment=bool(r.random() < 0.5)),
                    "XPM", jax=bpp == 1)
        np.testing.assert_array_equal(got, colours[idx])


def test_xpm_line_and_colour_rules_are_pils(tmp_path):
    r = np.random.default_rng(9)
    cols = r.integers(0, 256, (4, 3))
    idx = r.integers(0, 4, (3, 5))
    keys = rw.xpm_keys(4, 1)
    text = [np.array(keys, "S1")[row].tobytes() for row in idx]
    rows = [b'"' + t + b'",' for t in text]
    base = rw.xpm_bytes(idx, cols)
    check(tmp_path, base, "XPM")
    check(tmp_path, base.replace(b'",\n/* pixels */', b'"\n/* pixels */'), "XPM")
    short_long = [b'"' + text[0][:3] + b'",', b'"' + text[0][3:] + text[1] + b'",', rows[2]]
    for rows_, ok in ((short_long, True),
                      ([rows[0], rows[1] + rows[2][1:]], False),   # its '",' read as keys
                      ([b'/* a "quoted" comment */'] + rows, False),
                      (rows + [b'"xyz"'], True), (rows[:2], False),
                      ([b'/* pixels */', b'/* pixels */'] + rows, True)):
        check(tmp_path, rw.xpm_bytes(idx, cols, rows=rows_), "XPM" if ok else False)
    check(tmp_path, rw.xpm_bytes(idx, list(cols[:3]) + [b"None"]), False)
    check(tmp_path, rw.xpm_bytes(idx % 3, list(cols[:3]) + [b"None"]), "XPM")
    check(tmp_path, rw.xpm_bytes(idx, list(cols[:3]) + [b"red"]), False)

    def lines(*specs):
        return rw.xpm_bytes(idx, cols, colour_lines=[b'"' + k + b" " + s + b'",'
                                                     for k, s in zip(keys, specs)])

    check(tmp_path, lines(b"c #ff0000", b"s blue c #00ff00", b"m #000 c #0000ff",
                          b"c #123456789abc"), "XPM")
    check(tmp_path, lines(b"c #0x0ff00", b"c #-12", b"c #1_0", b"c #1"), "XPM")
    check(tmp_path, lines(b"c #ff0000", b"g #00ff00", b"c #12", b"c #1"), False)
    check(tmp_path, lines(b"c #ff0000", b"c #00ff00", b"c", b"c #1"), False)
    check(tmp_path, lines(b"c #ff0000", b"c #00ff00", b"c #", b"c #1"), False)
    dup = rw.xpm_bytes(idx, cols, colour_lines=[b'"a c #ff0000",', b'"b c #00ff00",',
                                                b'"a c #0000ff",', b'"c c #010203",'],
                       keys=[b"a", b"b", b"a", b"c"])
    check(tmp_path, dup)
    for head in (b'"5 3  1",', b'"0 3 1 1",', b'"2 1 1 0",'):
        check(tmp_path, b"/* XPM */\nstatic char *x[] = {\n" + head +
              b'\n"a c #ff0000",\n"aaaaa",\n"aaaaa",\n"aaaaa"};\n', False)
    check(tmp_path, b'/* XPM */"3 1 1 1",\n"a c #ff0000",\n"aaa"};\n', "XPM")
    check(tmp_path, b'/* XPM */ "3 1 1 1",\n"a c #ff0000",\n"aaa"};\n', False)  # not at 0
    check(tmp_path, b"/* XPM */\nno values line\n", False)


@pytest.mark.parametrize("seed", range(3))
def test_xpm_seeded_grammar_and_corruption_as_pils(tmp_path, seed):
    r = np.random.default_rng(70 + seed)
    for _ in range(25):
        n, bpp = int(r.integers(1, 12)), int(r.integers(1, 3))
        idx = r.integers(0, n, (int(r.integers(1, 5)), int(r.integers(1, 7))))
        data = rw.xpm_bytes(idx, r.integers(0, 256, (n, 3)), bpp=bpp,
                            pixels_comment=bool(r.random() < 0.5))
        corrupt(lambda d: check(tmp_path, d), data, r, 3, lo=9)


def test_large_xpm_decodes_without_a_loop_per_pixel():
    """A 1024^2 XPM of two characters a pixel and 300 colours (RGB): the
    colours of its keys, in well under a second a megapixel on this host."""
    import time

    r = np.random.default_rng(3)
    idx = r.integers(0, 300, (1024, 1024))
    colours = r.integers(0, 256, (300, 3))
    data = rw.xpm_bytes(idx, colours, bpp=2)
    t0 = time.perf_counter()
    fmt, px = port_image.decode_with_format(data, "big.xpm")
    assert time.perf_counter() - t0 < 5.0
    assert fmt == "XPM"
    np.testing.assert_array_equal(px, colours[idx])


# ------------------------------------------------------------------ IPTC


def _save(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _band_images():
    r = np.random.default_rng(0)
    g = r.integers(0, 256, (5, 7)).astype(np.uint8)
    rgb = np.stack([g, g // 2, 255 - g], -1)
    return {
        "grey-tiff": _save(Image.fromarray(g), "TIFF"), "pgm": _save(Image.fromarray(g), "PPM"),
        "grey-palette-bmp": _save(Image.fromarray(g), "BMP"),
        "grey-jpeg": _save(Image.fromarray(g), "JPEG"),
        "grey-png": _save(Image.fromarray(g), "PNG"),
        "grey-tga": _save(Image.fromarray(g), "TGA"), "grey-sgi": _save(Image.fromarray(g), "SGI"),
        "grey-pcx": _save(Image.fromarray(g), "PCX"),
        "grey-j2k": _save(Image.fromarray(g), "JPEG2000"),
        "grey-im": _save(Image.fromarray(g), "IM"), "imt": rw.imt_bytes(g),
        "bilevel-png": _save(Image.fromarray(g > 100), "PNG"),
        "bilevel-bmp": _save(Image.fromarray(g > 100), "BMP"),
        "xbm": _save(Image.fromarray(g > 100).convert("1"), "XBM"),
        "palette-gif": _save(Image.fromarray(g).convert("P"), "GIF"),
        "palette-png": _save(Image.fromarray(rgb).convert("P"), "PNG"),
        "i16-png": _save(Image.fromarray(g.astype(np.uint16) * 300), "PNG"),
        "i16-tiff": _save(Image.fromarray(g.astype(np.uint16) * 300), "TIFF"),
        "rgb-png": _save(Image.fromarray(rgb), "PNG"),
        "la-png": _save(Image.fromarray(g).convert("LA"), "PNG"),
        "f-tiff": _save(Image.fromarray(g.astype(np.float32)), "TIFF"),
        "i-tiff": _save(Image.fromarray(g.astype(np.int32) * 3 - 50), "TIFF"),
        "spider": _save(Image.fromarray(g.astype(np.float32)), "SPIDER"),
        "fits8": rw.fits_bytes(g, 8), "fits-float": rw.fits_bytes(g, -32), "gbr": rw.gbr_bytes(g),
        "mcidas8": rw.mcidas_bytes(g, 1), "mcidas16": rw.mcidas_bytes(g, 2),
        "sun8": rw.sun_bytes(g, 8),
        "sun-palette": rw.sun_bytes(g, 8, palette=r.integers(0, 256, (256, 3))),
        "sun4": rw.sun_bytes(g & 15, 4), "xvthumb": rw.xvthumb_bytes(g),
        "fli": rw.fli_bytes(7, 5, [rw.fli_frame([rw.fli_chunk(16, g.tobytes())])]),
        "xpm": rw.xpm_bytes(g % 4, r.integers(0, 256, (4, 3))), "pixar": rw.pixar_bytes(rgb),
        "grey-small": _save(Image.fromarray(g[:3, :4]), "PNG"),
    }


def _pil_merge(path, crashes):
    """PIL's read of an IPTC file, in a process of its own where it
    ``crashes`` (a first band of mode I or F): None where it fails."""
    if not crashes:
        return pil_path(str(path))[1]
    code = ("import sys, numpy as np\nfrom PIL import Image\n"
            "np.save(sys.argv[2], np.asarray(Image.open(sys.argv[1]).convert('RGB')))\n")
    out = str(path) + ".npy"
    p = subprocess.run([sys.executable, "-c", code, str(path), out], capture_output=True,
                       timeout=60)
    assert p.returncode < 0   # killed by a signal
    return None


@pytest.mark.parametrize("name", sorted(_band_images()))
def test_iptc_band_of_any_one_band_image_merges_as_pils(tmp_path, name):
    """Grey (no band), a band of RGB (first, second, last) and of CMYK:
    PIL merges an ``L`` image as any band, and any one-band image as the
    first (its raw bytes: indices, half of 16-bit samples' bytes); it
    refuses other modes ("mode mismatch", "image has wrong mode"),
    crashes on ``I`` / ``F`` first bands, and cannot convert an ``F``,
    ``I;16B`` or ``LAB`` core of a grey file to RGB."""
    blob = _band_images()[name]
    with Image.open(io.BytesIO(blob)) as im:
        one_band_int = im.mode in ("I", "F")
    for layers, band in ((1, None), (3, 1), (3, 2), (3, 3), (3, 0), (4, 1), (4, 4)):
        data = rw.iptc_bytes(layers, 0 if band is None else 1, (7, 5), 5, blob, band=band)
        path = tmp_path / f"{layers}_{band}.iim"
        path.write_bytes(data)
        want = _pil_merge(path, one_band_int and band == 1)
        try:
            got = port_image.decode_image(data, name)
        except ValueError:
            got = None
        assert (got is None) == (want is None), (layers, band, want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def test_iptc_bands_the_records_named(tmp_path):
    """The three files of the repair: a grey TIFF, a PGM and a grey-palette
    BMP as the band (PIL merges them: mode L), through both packages'
    ``read_image``; a colour-palette GIF as a second band is refused as
    PIL refuses it."""
    images = _band_images()
    for name in ("grey-tiff", "pgm", "grey-palette-bmp"):
        data = rw.iptc_bytes(3, 1, (7, 5), 5, images[name], band=2)
        got = check(tmp_path, data, "IPTC", jax=True, name=f"{name}.iim")
        assert got[..., 0].max() == 0 and got[..., 2].max() == 0 and got[..., 1].max() > 0
    check(tmp_path, rw.iptc_bytes(3, 1, (7, 5), 5, images["palette-gif"], band=2), False)


# ------------------------------------------------------------------ the gates


def test_gates_of_the_weak_signatures(tmp_path):
    """Files of formats the port already read, crafted to pass the
    signature of a format PIL tries before theirs:

    - GBR (two big-endian words): a TGA with a colour-map depth byte of 1
      (GBR's open passes it on: TGA), a Sun raster 1 or 2 wide whose data
      length is 1 or 4 (a width of 1: GBR's open takes it, its load fails), a QOI 1 wide
      whose stream starts 00 00 00 01 (GBR's pixel limit fails PIL's open)
      and one 2 wide (no ``GIMP`` magic: QOI);
    - FLI (two 16-bit fields): a TGA of height 3 with 0x12 0xAF at byte 4
      (no frames, or a zero size: TGA; else PIL opens it as FLI and fails
      its load, or reads a frame hidden in the TGA's ID field), a TIFF
      whose first directory is at 0xAF12 or 0x1AF12 (TIFF, or FLI where
      bytes 8-11 are set), an ICO of 0xAF12 entries whose first image is
      65,536 bytes (FLI's header checks pass it on: ICO);
    - McIdas (eight bytes): a PhotoCD with 4 at byte 7 (McIdas's element
      size is 0 there: PCD), and one whose directory makes McIdas take it.

    IM headers are text and cannot pass any of these signatures."""
    r = np.random.default_rng(23)
    px = r.integers(0, 256, (3, 5, 3)).astype(np.uint8)
    tga = bytearray(tga_bytes(px[..., ::-1], 2, 24, id_field=b"x"))
    tga[7] = 1
    check(tmp_path, bytes(tga), "TGA")
    tga[8] = 1
    check(tmp_path, bytes(tga), "TGA")
    sun = rw.sun_bytes(np.zeros((3, 1), np.uint8), 8, body=bytes(4))
    assert check(tmp_path, sun, False) is None
    assert port_image.image_format(sun) == "GBR"
    check(tmp_path, rw.sun_bytes(np.zeros((3, 3), np.uint8), 8, body=bytes(4) + bytes(8)), "SUN")
    for height in (9, 2):
        q = qoi_bytes(np.zeros((height, 1, 3), np.uint8))
        q = q[:14] + b"\0\0\0\0\0\1" + bytes(height) + q[-8:]
        assert check(tmp_path, q, False) is None
        if height > 3:
            with pytest.raises(ValueError, match="more pixels than PIL opens"):
                port_image.decode_image(q, "q")
    check(tmp_path, qoi_bytes(np.zeros((4, 2, 3), np.uint8)), "QOI")

    tga = bytearray(tga_bytes(px[..., ::-1], 2, 24, id_field=bytes(120)))
    tga[4], tga[5] = 0x12, 0xAF
    check(tmp_path, bytes(tga), "TGA")
    tga[6] = 1   # one frame
    check(tmp_path, bytes(tga), "TGA")   # a zero size: the next format
    tga[8], tga[10] = 5, 2
    assert check(tmp_path, bytes(tga), False) is None
    assert port_image.image_format(bytes(tga)) == "FLI"
    hidden = bytearray(tga_bytes(px[..., ::-1], 2, 24, id_field=bytes(255)))
    hidden[4:7], hidden[8], hidden[10] = b"\x12\xaf\x01", 5, 2
    hidden[128:144] = rw.fli_frame([])
    got = check(tmp_path, bytes(hidden), "FLI")
    assert got.shape == (2, 5, 3) and not got.any()

    def tiff(offset, pad8=b"\0\0\0\0"):
        strip = px.reshape(-1).tobytes()
        tags = [(256, 3, 5), (257, 3, 3), (258, 3, 8), (259, 3, 1), (262, 3, 2),
                (273, 4, offset + 2 + 10 * 12 + 4), (277, 3, 3), (278, 3, 3), (279, 4, len(strip)),
                (284, 3, 1)]
        ifd = struct.pack("<H", len(tags)) + b"".join(
            struct.pack("<HHI", t, k, 1) + (struct.pack("<HH", v, 0) if k == 3
                                            else struct.pack("<I", v)) for t, k, v in tags)
        head = b"II*\0" + struct.pack("<I", offset) + pad8
        return head + bytes(offset - len(head)) + ifd + b"\0\0\0\0" + strip

    check(tmp_path, tiff(0xAF12), "TIFF")
    check(tmp_path, tiff(0x1AF12), "TIFF")
    taken = tiff(0x1AF12, b"\5\0\2\0")
    assert check(tmp_path, taken, False) is None
    assert port_image.image_format(taken) == "FLI"

    png = _save(Image.fromarray(px[:1, :2]), "PNG")
    png += bytes(65536 - len(png))   # its size field's low half 0, as FLI's flags
    n = 0xAF12
    ico = struct.pack("<HHH", 0, 1, n) + struct.pack("<BBBBHHII", 2, 1, 0, 0, 1, 32, len(png),
                                                      6 + 16 * n) * n + png
    check(tmp_path, ico, "ICO")

    y = pattern(512, 768, 1)[..., 1]
    c = r.integers(0, 256, (2, 256, 384))
    pcd = bytearray(rw.pcd_bytes(y, c[0], c[1]))
    pcd[7] = 4
    check(tmp_path, bytes(pcd), "PCD")
    pcd[40:44] = struct.pack(">i", 1)                 # one byte an element
    pcd[32:40] = struct.pack(">ii", 64, 96)           # 64 lines of 96
    got = check(tmp_path, bytes(pcd), "MCIDAS")
    assert got.shape == (64, 96, 3)


def test_fixtures_and_generated_files_need_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('sun_rle24_13x9.ras', 'flc_brun_lc_13x9.flc', 'fits_gzip16_13x9.fits',\n"
            "          'gbr_v2_rgba_13x9.gbr', 'mcidas_4byte_13x9.area', 'xpm_p_13x9.xpm',\n"
            "          'xvthumb_13x9.xv', 'pixar_rgb_13x9.pxr'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:9] == ["(9, 13, 3)"] * 8 + ["[]"]


def test_generated_albedo_files_read_as_pil(tmp_path):
    """``raster_albedo_files`` (chip_smoke.py phase 52's 2048^2 files) at
    256^2: each read as PIL names it, bit-equal; the Sun raster holds the
    albedo's pixels."""
    from akari_torch.scene.builtin import envtex_texture

    albedo = envtex_texture(256, 0)
    files = raster_albedo_files(albedo)
    assert sorted(files) == ["albedo256_brun.flc", "albedo256_grey8.fits", "albedo256_rle24.ras"]
    for name, data in files.items():
        check(tmp_path, data, {"flc": "FLI", "fits": "FITS", "ras": "SUN"}[name.split(".")[1]],
              name=name)
    np.testing.assert_array_equal(port_image.decode_image(files["albedo256_rle24.ras"]), albedo)


def test_digests_hold_the_raster_fixtures():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = [n for n in digests if n.endswith((".ras", ".flc", ".fli", ".fits", ".gbr", ".area",
                                               ".pxr", ".xv", ".xpm"))]
    assert len(names) == 16
