"""Port parity: the PIL-free PhotoCD, SPIDER, DCX, MSP and XBM decoders
(akari_torch/core/pcd.py, spider.py, pcx.py, image_formats.py) against
PIL 12.1.0's plugins, through which the JAX package's ``read_image`` reads
such files, and the dispatch of ``core/image.py``: the five formats
without a signature (IM, IMT, IPTC, PCD, SPIDER) decide, by their header
parse, which format PIL opens many files as.

Tolerance: exact. Wherever PIL reads a file the port gives PIL's
``convert("RGB")`` pixels and names the same format; wherever PIL refuses
it the port raises ``ValueError``:

- PhotoCD: Pillow's Photo YCC -> RGB tables on all 2^24 (Y, C1, C2)
  triples (43 base images, in one vectorised pass), every orientation byte,
  the gate (``PCD_`` at byte 2048) and truncation;
- SPIDER: both byte orders, stacks, Pillow's writer, seeded labels
  (NaN, infinities, every ``iform``, stack cases PIL refuses or fails on),
  truncation;
- DCX: pages of every PCX form, offset tables PIL passes over or refuses,
  the 8-bit page's palette at the end of the whole file;
- MSP: both versions, Pillow's writer, drawn runs, empty, short and long
  rows, the checksum, truncation;
- XBM: Pillow's writer, drawn files (hotspot, hex case, separators), the C
  decoder's hex rules, seeded edits;
- dispatch: every fixture and the generated albedo files read as the
  format PIL's ``Image.open`` names (or refused where it fails), and
  crafted files at each of the five gates.
"""

import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from akari_torch.core import image as port_image
from akari_torch.core import pcd as port_pcd
from akari_tpu.core import image as ref_image
from tools import raster_writers as rw
from tools.legacy_writers import pcx_bytes
from tools.make_torch_port_image_fixtures import (
    lab_albedo_files,
    pattern,
    plugin_albedo_files,
    raster_albedo_files,
    tga_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
PIL_NAMES = {"PPM": "PNM", "WEBP": "WebP"}


def _pil_path(path):
    """PIL's format and ``convert("RGB")`` of a file: (None, None) where
    its open fails, (format, None) where its load does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(path)
        except Exception:
            return None, None
        with im:
            fmt = PIL_NAMES.get(im.format, im.format)
            try:
                return fmt, np.asarray(im.convert("RGB"))
            except Exception:
                return fmt, None


def _same_read(path):
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _check(tmp_path, data, fmt=None, jax=False, name="f"):
    """As ``tests/test_torch_image_im.py``'s: the port reads ``data`` as
    PIL reads it or refuses it where PIL does; ``fmt`` the format PIL must
    read it as (False: PIL must refuse it)."""
    path = tmp_path / name
    path.write_bytes(data)
    want_fmt, want = _pil_path(str(path))
    if fmt is not None:
        assert (want_fmt if want is not None else None) == (fmt or None), want_fmt
    try:
        got_fmt, got = port_image.decode_with_format(data, name)
    except ValueError:
        got_fmt = got = None
    if want is None:
        assert got is None, f"PIL refuses the file, the port reads it as {got_fmt}"
        return None
    assert got is not None, f"PIL reads the file as {want_fmt}, the port refuses it"
    assert got_fmt == want_fmt
    np.testing.assert_array_equal(got, want)
    if jax:
        _same_read(str(path))
    return got


# ------------------------------------------------------------------ PhotoCD

def _pcd_blocks(y4, c1, c2):
    """[n, 4] luma of n <= 98,304 2 x 2 blocks and their chroma -> the base
    image's planes, blocks in raster order (the rest zero)."""
    nb = 256 * 384
    yb, cb1, cb2 = np.zeros((nb, 4), np.uint8), np.zeros(nb, np.uint8), np.zeros(nb, np.uint8)
    yb[:len(y4)], cb1[:len(c1)], cb2[:len(c2)] = y4, c1, c2
    y = yb.reshape(256, 384, 2, 2).transpose(0, 2, 1, 3).reshape(512, 768)
    return y, cb1.reshape(256, 384), cb2.reshape(256, 384)


def test_pcd_ycc_tables_equal_pils_on_every_triple():
    """All 2^24 (Y, C1, C2): each (C1, C2) pair in 64 blocks holding the
    256 luma values, 98,304 blocks a file, 43 files; the port's tables
    (``(int)(k (v - offset) + 0.5)``) on each, vectorised."""
    nb, total = 256 * 384, 1 << 22   # blocks a file, blocks in all
    bad = 0
    for start in range(0, total, nb):
        blocks = np.arange(start, min(start + nb, total))
        pair, j = blocks // 64, blocks % 64
        y4 = (j[:, None] * 4 + np.arange(4)).astype(np.uint8)
        data = rw.pcd_bytes(*_pcd_blocks(y4, pair >> 8, pair & 255))
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        bad += int((port_pcd.decode_pcd(data) != want).any(axis=-1).sum())
    assert bad == 0


@pytest.mark.parametrize("orientation", range(8))
def test_pcd_orientations_read_as_pil_and_jax(tmp_path, orientation):
    """The low two bits rotate: 1 by 90 degrees, 3 by 270 (a 512 x 768
    image); the high bits are ignored."""
    r = np.random.default_rng(orientation)
    y = pattern(512, 768, orientation).astype(np.int32).sum(-1) // 3
    c = r.integers(0, 256, (2, 256, 384))
    got = _check(tmp_path, rw.pcd_bytes(y, c[0], c[1], orientation * 0x41 & 0xFF), "PCD",
                 jax=orientation < 4)
    assert got.shape == ((768, 512, 3) if orientation * 0x41 & 1 else (512, 768, 3))


def test_pcd_gate_and_truncation_as_pils(tmp_path):
    """``PCD_`` at byte 2048 and the orientation byte within the file: else
    PIL tries the next format; the base image cut short is refused."""
    data = rw.pcd_bytes(np.zeros((512, 768)), np.full((256, 384), 156), np.full((256, 384), 137))
    assert _check(tmp_path, data, "PCD") is not None
    for cut in (2052, 2048 + 1538, 2048 + 1539, 96 * 2048, len(data) - 1):
        assert _check(tmp_path, data[:cut], False) is None
    assert _check(tmp_path, data[:2048] + b"PCD " + data[2052:], False) is None
    assert port_image.image_format(data[:2048 + 1539]) == "PCD"
    assert port_image.image_format(data[:2048 + 1538]) is None


# ------------------------------------------------------------------ SPIDER

@pytest.mark.parametrize("order", [">", "<"])
@pytest.mark.parametrize("stack", [0, 1, 3])
def test_drawn_spider_files_read_as_pil_and_jax(tmp_path, order, stack):
    """Floats of every kind (NaN, infinities, negatives, past 255,
    fractions) in both byte orders; a stack's first image."""
    r = np.random.default_rng(stack + (order == "<"))
    for k in range(3):
        w, h = int(r.integers(1, 40)), int(r.integers(1, 20))
        v = r.uniform(-100, 400, (h, w)).astype(np.float32)
        v.ravel()[:4] = [np.nan, np.inf, -np.inf, 254.999][:v.size]
        _check(tmp_path, rw.spider_bytes(v, order, stack), "SPIDER", jax=k == 0)


def test_pils_spider_writer_reads_as_pil(tmp_path):
    r = np.random.default_rng(9)
    for w, h in ((1, 1), (64, 3), (5, 70)):
        b = io.BytesIO()
        Image.fromarray(r.uniform(-5, 300, (h, w)).astype(np.float32)).save(b, "SPIDER")
        _check(tmp_path, b.getvalue(), "SPIDER")


@pytest.mark.parametrize("seed", range(3))
def test_drawn_spider_labels_read_as_pil_reads_them(tmp_path, seed):
    """Labels 1, 2, 3, 5, 12, 13, 22-27 drawn from integers and special
    values: PIL reads the file, passes it over (labels not integers, an
    ``iform`` not 1, header bytes that disagree, an inconsistent stack),
    or fails its open (NaN or infinite stack labels, an image inside a
    stack); files cut anywhere."""
    r = np.random.default_rng(600 + seed)
    specials = [0, 1, -1, 2, 3, 1.5, np.nan, np.inf, -np.inf, 1e30, -11, 256, 1e9, 0.5]
    for _ in range(120):
        w, h = int(r.integers(1, 5)), int(r.integers(1, 5))
        labels = {}
        for _ in range(r.integers(0, 4)):
            labels[int(r.choice([1, 2, 5, 12, 13, 22, 23, 24, 26, 27, 3]))] = (
                float(r.choice(specials)) if r.random() < .7 else float(r.integers(-3, 10)))
        v = r.uniform(-300, 600, (h, w)).astype(np.float32)
        data = rw.spider_bytes(v, [">", "<"][r.integers(2)], stack=int(r.choice([0, 0, 2])),
                               labels=labels)
        if r.random() < .2:
            data = data[:int(r.integers(0, len(data)))]
        _check(tmp_path, data)


def test_spider_image_inside_a_stack_is_refused(tmp_path):
    """Label 27 above zero with label 24 zero: PIL's open fails (the plugin
    reads a stack offset it has not set), and the port refuses too."""
    data = rw.spider_bytes(np.ones((4, 4), np.float32), labels={27: 2})
    assert _check(tmp_path, data, False) is None
    assert port_image.image_format(data) is None
    with pytest.raises(ValueError, match="stack"):
        port_image.decode_image(data)


# ------------------------------------------------------------------ DCX

@pytest.mark.parametrize("form", ["rgb", "grey", "vga", "1bit", "4planes"])
def test_drawn_dcx_pages_read_as_pil_and_jax(tmp_path, form):
    """Page 0 of one to three pages, in each PCX form; an 8-bit page's VGA
    palette is the last 769 bytes of the whole file, so a page after it
    decides it (and a lone small grey page, in a file shorter than 769
    bytes, PIL refuses: it seeks before the file's start)."""
    r = np.random.default_rng(len(form))
    for n in (1, 2, 3):
        w, h = int(r.integers(1, 30)), int(r.integers(1, 12))
        px = pattern(h, w, n)
        page = {"rgb": lambda: pcx_bytes(px, 8, 3),
                "grey": lambda: pcx_bytes(px[..., 0], 8, 1),
                "vga": lambda: pcx_bytes(px[..., 0], 8, 1, vga=r.integers(0, 256, (256, 3))),
                "1bit": lambda: pcx_bytes(px[..., 0] & 1, 1, 1),
                "4planes": lambda: pcx_bytes(px[..., 0] & 15, 1, 4,
                                             palette=r.integers(0, 256, (16, 3)))}[form]()
        others = [pcx_bytes(px[..., 1], 8, 1, vga=r.integers(0, 256, (256, 3)))] * (n - 1)
        data = rw.dcx_bytes([page] + others)
        refused = form == "grey" and len(data) < 769
        assert (_check(tmp_path, data, False if refused else "DCX", jax=n == 2) is None) == refused


DCX_PAGE = pcx_bytes(pattern(5, 7, 1), 8, 3)
DCX_CASES = {
    "empty_table": (rw.dcx_bytes([], offsets=[]) + DCX_PAGE, None),
    "table_cut": (struct.pack("<I", 0x3ADE68B1) + struct.pack("<I", 12)[:3], None),
    "page_past_end": (rw.dcx_bytes([DCX_PAGE], offsets=[10_000]), None),
    "page_not_pcx": (rw.dcx_bytes([b"\x0b" + DCX_PAGE[1:]]), None),
    "page_header_cut": (rw.dcx_bytes([DCX_PAGE[:60]]), None),
    "second_offset_used_first_zero": (rw.dcx_bytes([DCX_PAGE], offsets=[0, 12]), None),
    "page_mode_unknown": (rw.dcx_bytes([DCX_PAGE[:3] + b"\x04" + DCX_PAGE[4:]]), None),
    "page_data_cut": (rw.dcx_bytes([DCX_PAGE[:140]]), None),
    "full_table": (struct.pack("<I", 0x3ADE68B1) + struct.pack("<I", 4100) * 1024 + DCX_PAGE,
                   "DCX"),
}


@pytest.mark.parametrize("case", sorted(DCX_CASES))
def test_dcx_tables_and_pages_as_pil_reads_them(tmp_path, case):
    """PIL passes over a table cut short or empty and a page 0 that is no
    PCX (then no other format reads these files), refuses a page of an
    unknown mode or cut data, and reads a table of all 1024 entries."""
    data, fmt = DCX_CASES[case]
    got = _check(tmp_path, data)
    assert (got is not None) == (fmt is not None)


# ------------------------------------------------------------------ MSP

@pytest.mark.parametrize("version", [1, 2])
def test_drawn_msp_files_read_as_pil_and_jax(tmp_path, version):
    r = np.random.default_rng(version)
    for k in range(5):
        w, h = int(r.integers(1, 70)), int(r.integers(1, 12))
        bits = r.integers(0, 2, (h, w))
        bits[:, :w // 2] = k % 2
        _check(tmp_path, rw.msp_bytes(bits, version, r=r), "MSP", jax=k == 0)


def test_pils_msp_writer_reads_as_pil(tmp_path):
    for w, h in ((1, 1), (37, 9), (64, 3)):
        b = io.BytesIO()
        img = Image.fromarray((pattern(h, w, w)[..., 0] > 128).astype(np.uint8) * 255)
        img.convert("1").save(b, "MSP")
        assert b.getvalue()[:4] == b"DanM"
        _check(tmp_path, b.getvalue(), "MSP")


@pytest.mark.parametrize("seed", range(3))
def test_msp_rows_read_as_pil_joins_them(tmp_path, seed):
    """Version-2 rows that are empty (white), cut short, longer than the
    stride, or literals cut by the row's end: PIL joins every row's output
    and reads it as one raw image (later rows shift; output short of the
    image refused); a bad checksum makes PIL pass the file over; files cut
    anywhere."""
    r = np.random.default_rng(700 + seed)
    for _ in range(120):
        w, h = int(r.integers(1, 30)), int(r.integers(1, 6))
        bits = r.integers(0, 2, (h, w))
        bits[:, :w // 2] = 1
        rows = None
        if r.random() < .6:
            rows = [rw.msp_runs(p, r) for p in np.packbits(bits.astype(np.uint8), axis=1)]
            for _ in range(r.integers(1, 3)):
                y, kind = int(r.integers(0, h)), r.integers(4)
                if kind == 0:
                    rows[y] = b""
                elif kind == 1:
                    rows[y] = rows[y][:int(r.integers(0, len(rows[y]) + 1))]
                elif kind == 2:
                    rows[y] += r.integers(0, 256, r.integers(1, 4)).astype(np.uint8).tobytes()
                else:
                    rows[y] = (bytes([int(r.integers(1, 9))])
                               + r.integers(0, 256, r.integers(0, 9)).astype(np.uint8).tobytes())
        data = rw.msp_bytes(bits, int(r.choice([1, 2])), rows=rows, r=r,
                            checksum=r.random() < .9)
        if r.random() < .2:
            data = data[:int(r.integers(0, len(data)))]
        _check(tmp_path, data)


def test_msp_header_rules(tmp_path):
    bits = np.ones((3, 9), np.uint8)
    assert _check(tmp_path, rw.msp_bytes(bits, 2, checksum=False), False) is None
    assert _check(tmp_path, rw.msp_bytes(bits, 1)[:31], False) is None
    assert _check(tmp_path, rw.msp_bytes(np.ones((0, 9), np.uint8), 1), False) is None
    white = _check(tmp_path, rw.msp_bytes(bits, 2, rows=[b"", b"", b""]), "MSP")
    assert (white == 255).all()


# ------------------------------------------------------------------ XBM

def test_pils_xbm_writer_reads_as_pil_and_jax(tmp_path):
    for w, h in ((1, 1), (37, 9), (16, 2)):
        b = io.BytesIO()
        img = Image.fromarray((pattern(h, w, w)[..., 1] > 128).astype(np.uint8) * 255)
        img.convert("1").save(b, "XBM")
        _check(tmp_path, b.getvalue(), "XBM", jax=w == 37)


@pytest.mark.parametrize("seed", range(3))
def test_drawn_xbm_files_read_as_pil_reads_them(tmp_path, seed):
    """Names, a hotspot, upper-case hex, separators, values a line; seeded
    edits of single characters (an ``x`` inside a value, a digit PIL's
    ``HEX`` reads as 0, a broken ``#define``); leading blank lines."""
    r = np.random.default_rng(800 + seed)
    for _ in range(100):
        w, h = int(r.integers(1, 20)), int(r.integers(1, 6))
        data = rw.xbm_bytes(r.integers(0, 2, (h, w)), name=["img", "a_b", "x"][r.integers(3)],
                            hotspot=None if r.random() < .5 else (1, 2),
                            per_line=int(r.integers(1, 20)), upper=bool(r.integers(2)),
                            sep=[b", ", b",", b" ,\n  "][r.integers(3)])
        if r.random() < .5:
            data = bytearray(data)
            for _ in range(r.integers(1, 4)):
                data[int(r.integers(0, len(data)))] = int(r.choice(list(b"x0aG ,\n_#9")))
            data = bytes(data)
        if r.random() < .2:
            data = b"  \n" * int(r.integers(0, 6)) + data
        _check(tmp_path, data)


def test_xbm_hex_rules_are_pils(tmp_path):
    """After each ``x`` the next two characters, whatever they are: ``0x1,``
    reads 0x10, a non-hex digit 0 (``0xxA`` 0x0A: the second ``x`` is a
    digit, not a value's start); a header past 512 bytes is no XBM to PIL."""
    head = b"#define a_width 8\n#define a_height 3\nstatic char a_bits[] = {\n"
    got = _check(tmp_path, head + b"0x1, 0xG8, 0xxA };", "XBM")
    assert (got[:, :, 0] // 255).tolist() == [[0, 0, 0, 0, 1, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0, 0],
                                              [0, 1, 0, 1, 0, 0, 0, 0]]
    assert _check(tmp_path, head + b"0x01, 0x02", False) is None
    assert _check(tmp_path, b" " * 400 + head + b"0x1, 0x2, 0x3", False) is None


# ------------------------------------------------------------------ dispatch

ALL_FIXTURES = sorted(json.load(open(os.path.join(FIXTURES, "digests.json"))))


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_every_fixture_reads_as_the_format_pil_names(name):
    """The port's format for each fixture is PIL's ``Image.open(...)
    .format``; ``image_format`` agrees wherever the first format whose
    signature matches is the one PIL opens."""
    path = os.path.join(FIXTURES, name)
    want_fmt, want = _pil_path(path)
    with open(path, "rb") as f:
        data = f.read()
    got_fmt, got = port_image.decode_with_format(data, name)
    assert got_fmt == want_fmt
    np.testing.assert_array_equal(got, want)
    if name != "tga_16bit_bottom_right.tga":   # its header also passes CUR's signature
        assert port_image.image_format(data) == want_fmt


def test_generated_albedo_files_read_as_the_format_pil_names(tmp_path):
    """``lab_albedo_files``, ``plugin_albedo_files`` and
    ``raster_albedo_files`` (chip_smoke.py's 2048^2 files) at 1024^2 and
    256^2: the same forms, each read as PIL names it, bit-equal."""
    from akari_torch.scene.builtin import envtex_texture

    files = {**lab_albedo_files(envtex_texture(256, 0)),
             **plugin_albedo_files(envtex_texture(1024, 0)),
             **raster_albedo_files(envtex_texture(1024, 0))}
    assert len(files) == 11
    for name, data in files.items():
        fmt = _check(tmp_path, data, name=name)
        assert fmt is not None, name


def test_gates_of_the_formats_without_a_signature(tmp_path):
    """Hand-made files at each of the five gates: a TGA whose first byte is
    0x1C (IPTC's field start: PIL reads it as TGA, or fails its open when
    the length byte is above 132), text with newlines (IM and IMT pass it
    over, or IM's header parse fails the open), a file of 108 bytes read as
    a SPIDER header, and IPTC's illegal length."""
    r = np.random.default_rng(21)
    px = r.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    for cm_type, first_index in ((0, 0), (1, 0), (1, 140), (1, 133), (1, 132)):
        cmap = r.integers(0, 256, (first_index + 8) * 3).astype(np.uint8).tobytes()
        if cm_type:
            data = tga_bytes(r.integers(0, 8, (6, 5, 1)).astype(np.uint8) + first_index, 1, 8,
                             cmap=cmap[3 * first_index:], cm_start=first_index, cm_len=8,
                             cm_depth=24, id_field=bytes(28))
        else:
            data = tga_bytes(px[..., ::-1], 2, 24, id_field=bytes(28))
        assert data[0] == 0x1C
        got = _check(tmp_path, data, "TGA" if first_index <= 132 else False)
        assert (got is None) == (first_index > 132)
    text = b"Hello, world\nThis is no image.\nName: still none\n"
    assert _check(tmp_path, text, False) is None
    assert port_image.image_format(text) is None
    im_text = b"Image size (x*y): 2*2\nImage type: Greyscale image\n\x1a" + bytes(4)
    assert _check(tmp_path, im_text, "IM") is not None
    assert port_image.image_format(im_text) == "IM"
    assert port_image.image_format(b"Image size (x*y): 2*x\n\x1a" + bytes(4)) is None
    spider = rw.spider_bytes(np.arange(27, dtype=np.float32).reshape(3, 9))[:108]
    assert len(spider) == 108 and port_image.image_format(spider) == "SPIDER"
    assert _check(tmp_path, spider, False) is None   # PIL opens it; its data is missing
    full = rw.spider_bytes(np.arange(27, dtype=np.float32).reshape(3, 9))
    assert _check(tmp_path, full, "SPIDER") is not None
    illegal = b"\x1c\x02\x00\x90" + r.integers(0, 256, 60).astype(np.uint8).tobytes()
    assert _check(tmp_path, illegal, False) is None
    assert port_image.image_format(illegal) is None
    with pytest.raises(ValueError, match="illegal field length"):
        port_image.decode_image(illegal, "x")
