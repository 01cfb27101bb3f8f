"""Port parity: the PIL-free ICO / CUR, QOI, SGI and PCX decoders
(akari_torch/core/ico.py, qoi.py, sgi.py, pcx.py with
akari_torch/native/qoi.cpp and rle.cpp) against PIL 12.1, through which the
JAX package's ``read_image`` reads them.

Tolerance: exact. The port's 8-bit pixels equal PIL's ``convert("RGB")`` of
the file read from its path, and ``read_image`` of both packages gives the
same float32 array bit for bit:

- the fixtures of ``tests/data/torch_port_images`` (Pillow's writers and
  ``tools/legacy_writers.py``; ``digests.json`` holds PIL's decode of each,
  which ``chip_smoke.py`` checks on a machine without PIL);
- the fault this slice repairs: ICO files whose directory looks like a TGA
  header (PIL's 100x256 and 128x256 single-entry icons, PNG and BMP, and
  their CUR twins) were taken for TGA; now every file PIL opens as ICO,
  CUR, SGI, PCX or QOI is routed as PIL routes it;
- seeded drawn files: ICO entry sets (PNG and 1-32 bit DIB entries, sizes,
  colour counts, the order PIL sorts them in), CUR entry sets, every QOI
  op under each channels byte, SGI raw and RLE at 1 and 2 bytes in L, RGB
  and RGBA, PCX at 1, 2, 4, 8 and 24 bits with every stride rule;
- the decoders' quirks, each probed on PIL: SGI rows that keep the last
  row's samples, the early stop on a nonzero last packet, PCX runs that
  cross a line, the grey VGA palette, files that fall through to TGA;
- seeded corruptions (bytes changed, files cut or extended): wherever PIL
  reads the file the port gives its pixels, wherever PIL refuses it the
  port raises ``ValueError``;
- the forms PIL refuses, each refused naming the format;
- an OBJ whose ``map_Kd`` is an SGI, PCX, QOI or ICO renders at 16x16 on
  the CPU bit-equal to the same OBJ on a PNG of the same pixels.
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
from akari_torch.core.image_formats import tga_header
from akari_tpu.core import image as ref_image
from tools import legacy_writers as lw
from tools.make_torch_port_image_fixtures import legacy_fixtures, pattern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
EXTENSIONS = (".ico", ".cur", ".qoi", ".sgi", ".rgba", ".bw", ".pcx")


def _pil_path(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


def _outcome(tmp_path, data, name="f.bin"):
    """(PIL's pixels or None, the port's pixels or None) of ``data`` read
    from a file, as the JAX package reads it."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        want = _pil_path(str(path))
    except Exception:
        want = None
    try:
        got = port_image.decode_image(data, name)
    except ValueError:
        got = None
    return want, got


def _matches_pil(tmp_path, data, name="f.bin"):
    want, got = _outcome(tmp_path, data, name)
    assert want is not None, f"{name}: PIL refuses it"
    assert got is not None, f"{name}: the port refuses it"
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


def _same_read(path):
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _pil_bytes(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return {k: v for k, v in json.load(f).items() if k.endswith(EXTENSIONS)}


FIXTURE_NAMES = sorted(_digests())


def test_legacy_fixtures_are_the_tools_and_pils():
    import PIL

    written = legacy_fixtures()
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert len(written) == 22 and len(FIXTURE_NAMES) == 16
    for name, data in written.items():
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            assert f.read() == data, name
        px = _pil_path(path)
        rec = digests[name]
        assert list(px.shape) == rec["shape"] and rec["pil"] == PIL.__version__, name
        assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"], name


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_its_digest_and_reads_as_jax(name):
    rec = _digests()[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        px = port_image.decode_image(f.read(), name)
    assert list(px.shape) == rec["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"]
    _same_read(path)


# ------------------------------------ the repaired fault -------------------------

@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("width", [100, 128])
def test_icons_whose_directory_looks_like_tga_read_as_pil_reads_them(tmp_path, width, fmt):
    """A single-entry 256-high icon of 64-128 KB: its directory reads as a
    sane TGA header (image type 1 or 2, 1-bit depth), which the parent
    slice's ``image_format`` took for TGA. PIL tries ICO and CUR first."""
    src = Image.fromarray(np.random.default_rng(width).integers(0, 256, (256, width, 3),
                                                                 dtype=np.uint8))
    data = _pil_bytes(src, "ICO", sizes=[(width, 256)], bitmap_format=fmt)
    cur = data[:2] + b"\2" + data[3:]
    for kind, blob in (("ICO", data), ("CUR", cur)):
        assert tga_header(blob) is not None  # the parent slice's route
        assert port_image.image_format(blob) == kind
        want, got = _outcome(tmp_path, blob, f"x.{kind.lower()}")
        if kind == "CUR" and fmt == "png":
            assert want is None and got is None  # PIL reads a PNG entry as a bitmap header
            with pytest.raises(ValueError, match="CUR with a PNG entry"):
                port_image.decode_image(blob)
            continue
        assert want is not None and got is not None and want.shape == (256, width, 3)
        np.testing.assert_array_equal(got, want)


def _formats_pil_opens(r):
    """Seeded files of the five formats, of drawn sizes, from PIL's writers
    and the tool's."""
    for i in range(12):
        h, w = (int(v) for v in r.integers(1, 70, 2))
        img = Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8))
        kind = i % 6
        if kind == 0:
            size = (int(r.integers(1, 257)), int(r.integers(1, 257)))
            big = Image.fromarray(r.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
            data = _pil_bytes(big, "ICO", sizes=[size], bitmap_format=("png", "bmp")[i % 2])
            yield "ICO", data
            yield "CUR", data[:2] + b"\2" + data[3:] if i % 2 else None
        elif kind == 1:
            yield "QOI", _pil_bytes(img, "QOI")
        elif kind == 2:
            yield "SGI", _pil_bytes(img, "SGI", bpc=int(r.integers(1, 3)))
        elif kind == 3:
            yield "SGI", lw.sgi_bytes(np.asarray(img).transpose(2, 0, 1), 1, True)
        elif kind == 4:
            yield "PCX", _pil_bytes(img.convert(("1", "L", "P", "RGB")[i % 4]), "PCX")
        else:
            yield "PCX", lw.pcx_bytes(r.integers(0, 16, (h, w)), 1, 4)


@pytest.mark.parametrize("seed", range(2))
def test_no_file_pil_opens_as_these_formats_is_taken_for_tga(tmp_path, seed):
    for fmt, data in _formats_pil_opens(np.random.default_rng(100 + seed)):
        if data is None:
            continue
        path = tmp_path / "f"
        path.write_bytes(data)
        with Image.open(path) as im:
            assert im.format == fmt
        assert port_image.image_format(data) == fmt
        _matches_pil(tmp_path, data)


# ------------------------------------------- ICO / CUR ----------------------------

def _quads(r, n):
    return np.concatenate([r.integers(0, 256, (n, 3)), np.zeros((n, 1), int)],
                          1).astype(np.uint8).tobytes()


def _ico_entry(r, w, h):
    """One drawn entry of w x h: a PNG or a 1/4/8/24/32-bit DIB."""
    kind = int(r.integers(0, 6))
    if kind == 0:
        img = Image.fromarray(r.integers(0, 256, (h, w, 4), dtype=np.uint8))
        return 32, 0, _pil_bytes(img, "PNG")
    bits = (1, 4, 8, 24, 32)[kind - 1]
    mask = r.integers(0, 2, (h, w))
    if bits <= 8:
        n = 1 << bits if r.random() < 0.7 else int(r.integers(1, 1 << bits))
        return bits, (n if bits < 8 else 0), lw.dib_entry(r.integers(0, n, (h, w)), bits,
                                                          _quads(r, n), mask)
    k = bits // 8
    return bits, 0, lw.dib_entry(r.integers(0, 256, (h, w, k)), bits, mask=mask)


@pytest.mark.parametrize("seed", range(6))
def test_drawn_ico_entry_sets_match_pil(tmp_path, seed):
    """PIL sorts the entries by colour depth, then by area (stable), and
    reads the first; a depth of 0 comes from the colour count or is 256."""
    r = np.random.default_rng(200 + seed)
    for _ in range(4):
        entries = []
        for _ in range(int(r.integers(1, 5))):
            w, h = (int(v) for v in r.integers(1, 20, 2))
            if entries and r.random() < 0.5:  # another depth at an earlier size
                w, h = entries[int(r.integers(0, len(entries)))][:2]
            bits, colors, data = _ico_entry(r, w, h)
            field = bits if r.random() < 0.7 else 0
            entries.append((w, h, colors if r.random() < 0.8 else int(r.integers(0, 256)),
                            field, data))
        _matches_pil(tmp_path, lw.icon_bytes(entries), "d.ico")


@pytest.mark.parametrize("seed", range(3))
def test_drawn_cur_entry_sets_match_pil(tmp_path, seed):
    """PIL keeps the first entry, or a later one larger in both width and
    height bytes (a 0 byte is not 256)."""
    r = np.random.default_rng(300 + seed)
    for _ in range(4):
        entries = []
        for _ in range(int(r.integers(1, 5))):
            w, h = (int(v) for v in r.integers(1, 24, 2))
            bits, _, data = _ico_entry(r, w, h)
            while data[:4] == b"\x89PNG":
                bits, _, data = _ico_entry(r, w, h)
            entries.append((w, h, 0, int(r.integers(0, 16)), data))
        _matches_pil(tmp_path, lw.icon_bytes(entries, kind=2), "d.cur")


def test_ico_png_entry_of_another_size_and_dib_headers(tmp_path):
    r = np.random.default_rng(7)
    png = _pil_bytes(Image.fromarray(pattern(12, 20, 1)), "PNG")
    px = _matches_pil(tmp_path, lw.icon_bytes([(16, 16, 0, 32, png)]))
    assert px.shape == (12, 20, 3)  # the PNG's own size
    for header in (40, 108, 124):
        dib = lw.dib_entry(r.integers(0, 256, (5, 7, 3)), 24, header=header)
        _matches_pil(tmp_path, lw.icon_bytes([(7, 5, 0, 24, dib)]))


# ------------------------------------------------ QOI ----------------------------

@pytest.mark.parametrize("channels", [3, 4, 0, 7])
def test_drawn_qoi_every_op_matches_pil(tmp_path, channels):
    r = np.random.default_rng(400 + channels)
    for h, w in ((1, 1), (9, 13), (30, 7)):
        px = pattern(h, w, channels)
        px[h // 2:] = px[h // 2, 0]  # runs
        px[::3, ::2] = px[0, 0]      # index hits
        if channels != 3:
            px = np.concatenate([px, r.integers(0, 2, (h, w, 1)).astype(np.uint8) * 200], 2)
        data = lw.qoi_bytes(px, channels=channels, r=r)
        ops = set()
        for b in data[14:-8]:
            ops.add("rgb" if b == 0xFE else "rgba" if b == 0xFF else b >> 6)
        _matches_pil(tmp_path, data, "q.qoi")
        _matches_pil(tmp_path, data[:-8], "q.qoi")  # PIL never reads the end marker
        if h * w > 100:
            assert ops >= {0, 1, 2, 3, "rgb"}
    _matches_pil(tmp_path, lw.qoi_bytes(pattern(40, 50, 9), index=False), "f.qoi")


def test_qoi_truncated_streams_are_refused(tmp_path):
    data = lw.qoi_bytes(pattern(6, 7, 3), r=np.random.default_rng(1), end=False)
    for cut in range(14, len(data)):
        want, got = _outcome(tmp_path, data[:cut])
        assert (want is None) == (got is None), cut
        if got is not None:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="QOI data ends before the last pixel"):
        port_image.decode_image(data[:20])


# ------------------------------------------------ SGI ----------------------------

@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_drawn_sgi_matches_pil(tmp_path, bpc, rle):
    r = np.random.default_rng(500 + bpc + 2 * rle)
    for z, dims in ((1, (1, 2)), (3, (3,)), (4, (3,))):
        for dim in dims:
            h = 1 if dim == 1 else int(r.integers(1, 20))
            w = int(r.integers(1, 300))
            planes = r.integers(0, 4, (z, h, w)) * (60 if bpc == 1 else 16411)
            planes[:, :, w // 3:w // 2] = planes[:, :, w // 3:w // 3 + 1]
            _matches_pil(tmp_path, lw.sgi_bytes(planes, bpc, rle, dimension=dim), "s.sgi")


def _sgi_rle_file(w, rows, lens=None, starts=None, bpc=1):
    h = len(rows)
    head = struct.pack(">hBBHHHH", 474, 1, bpc, 2, w, h, 1).ljust(512, b"\0")
    st, body = [], b""
    for row in rows:
        st.append(512 + 8 * h + len(body))
        body += row
    return (head + struct.pack(f">{h}I", *(starts or st))
            + struct.pack(f">{h}I", *(lens or [len(x) for x in rows])) + body)


def test_sgi_rle_quirks_follow_pils_decoder(tmp_path):
    """A row that ends early keeps the row before's samples; a nonzero
    packet as the last one its length allows stops the decode (the rows
    not reached stay black); a copy that reaches the file's last byte, or a
    row past the end of the file, is an overrun; a length longer than the
    file is not."""
    stale = _matches_pil(tmp_path, _sgi_rle_file(4, [b"\x04\x05\x00", b"\x82\x01\x02\x00"]))
    np.testing.assert_array_equal(stale[0, :, 0], [1, 2, 5, 5])
    stop = _matches_pil(tmp_path, _sgi_rle_file(4, [b"\x04\x05\x00", b"\x82\x01\x02\x82\x03"],
                                                lens=[3, 2]))
    np.testing.assert_array_equal(stop[:, :, 0], [[0, 0, 0, 0], [5, 5, 5, 5]])
    _matches_pil(tmp_path, _sgi_rle_file(4, [b"\x04\x05\x00", b"\x04\x06\x00"], lens=[3, 100]))
    for rows, kw in (([b"\x04\x05\x00", b"\x84\x01\x02\x03\x04"], {}),
                     ([b"\x04\x05\x00", b"\x04\x06\x00"], {"starts": [528, 600]}),
                     ([b"\x04\x05\x00", b"\x05\x06\x00"], {})):
        want, got = _outcome(tmp_path, _sgi_rle_file(4, rows, **kw))
        assert want is None and got is None
    with pytest.raises(ValueError, match="SGI run-length data overruns"):
        port_image.decode_image(_sgi_rle_file(4, [b"\x04\x05\x00", b"\x05\x06\x00"]))


# ------------------------------------------------ PCX ----------------------------

PCX_FORMS = {"1bit": (1, 1), "2planes": (1, 2), "4planes": (1, 4), "grey": (8, 1),
             "vga": (8, 1), "rgb": (8, 3)}


@pytest.mark.parametrize("form", list(PCX_FORMS))
def test_drawn_pcx_matches_pil(tmp_path, form):
    """Every width parity, the header's bytes per line equal to PIL's
    stride, odd, or 0 (PIL then pads the line to even), a box off the
    origin, and the 8-bit forms long enough to hold a VGA palette."""
    bits, planes = PCX_FORMS[form]
    r = np.random.default_rng(600 + len(form))
    for w in (1, 2, 3, 8, 9, 16, 21, 64):
        h = int(r.integers(1, 12)) if bits == 1 else 1024 // w + 1
        if planes == 3:
            px = r.integers(0, 3, (h, w, 3)).astype(np.uint8) * 100
        elif bits == 8:
            px = r.integers(0, 3, (h, w)).astype(np.uint8) * 100
        else:
            px = r.integers(0, 1 << planes, (h, w)).astype(np.uint8)
        vga = r.integers(0, 256, (256, 3)) if form == "vga" else None
        for bpl in (None, 0, 7):
            data = lw.pcx_bytes(px, bits, planes, palette=r.integers(0, 256, (16, 3)), vga=vga,
                                bytes_per_line=bpl, box=(int(r.integers(0, 9)), 3))
            _matches_pil(tmp_path, data, "p.pcx")


def test_pcx_rules_probed_on_pil(tmp_path):
    """A grey-ramp VGA palette reads as grey, another as colours; a run that
    crosses a line is refused; an 8-bit file shorter than the 769-byte
    palette is refused (PIL seeks before the start of the file)."""
    px = np.arange(60, dtype=np.uint8).reshape(1, 60).repeat(14, 0)
    ramp = np.repeat(np.arange(256), 3).reshape(256, 3)
    got = _matches_pil(tmp_path, lw.pcx_bytes(px, 8, 1, vga=ramp))
    np.testing.assert_array_equal(got[..., 0], px)
    pal = np.random.default_rng(2).integers(0, 256, (256, 3))
    np.testing.assert_array_equal(_matches_pil(tmp_path, lw.pcx_bytes(px, 8, 1, vga=pal)),
                                  pal[px])
    head = lw.pcx_bytes(np.zeros((2, 4), np.uint8), 8, 1)[:128]
    for body, match in ((bytes([0xC6, 7, 1, 2]), "PCX run crosses a line"),
                        (bytes([0xC4, 7, 0xC4, 9]), "8-bit PCX of 132 bytes")):
        want, got = _outcome(tmp_path, head + body + bytes(800 if "run" in match else 0))
        assert want is None and got is None
        with pytest.raises(ValueError, match=match):
            port_image.decode_image(head + body + bytes(800 if "run" in match else 0))


# ---------------------------------------- falling through ------------------------

def test_headers_pil_gives_up_on_fall_through_to_the_next_format(tmp_path):
    """A CUR directory with no entries makes PIL try the formats after it:
    these bytes are a sane 24-bit TGA, which both read; an ICO directory
    that ends early, and an empty PCX box, fall through to nothing."""
    tga = bytes([0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0, 2, 0, 24, 0])
    data = tga + np.random.default_rng(3).integers(0, 256, 18, dtype=np.uint8).tobytes()
    assert port_image.image_format(data) == "CUR"
    _matches_pil(tmp_path, data)
    for data in (b"\0\0\1\0\2\0" + bytes(20), lw.pcx_bytes(np.zeros((2, 3), np.uint8), 1, 1,
                                                            box=(5, 0))[:8] + bytes(120)):
        data = bytearray(data)
        if data[0] == 10:
            data[8:10] = b"\0\0"  # xmax below xmin
        want, got = _outcome(tmp_path, bytes(data))
        assert want is None and got is None


# --------------------------------------------- corruption ------------------------

def _corruption_bases():
    r = np.random.default_rng(700)
    px = pattern(13, 17, 4)
    px[3:6] = 50
    bmp_ico = _pil_bytes(Image.fromarray(px), "ICO", sizes=[(17, 13)], bitmap_format="bmp")
    return [
        ("ico", bmp_ico),
        ("ico", _pil_bytes(Image.fromarray(px).convert("P"), "ICO", sizes=[(17, 13)],
                           bitmap_format="bmp")),
        ("ico", _pil_bytes(Image.fromarray(px), "ICO", sizes=[(8, 8), (17, 13)])),
        ("cur", bmp_ico[:2] + b"\2" + bmp_ico[3:]),
        ("qoi", lw.qoi_bytes(px, r=r)),
        ("sgi", lw.sgi_bytes(px.transpose(2, 0, 1), 1, True)),
        ("sgi", lw.sgi_bytes(px.transpose(2, 0, 1).astype(np.uint16) * 257, 2, True)),
        ("sgi", lw.sgi_bytes(px.transpose(2, 0, 1), 1, False)),
        ("pcx", lw.pcx_bytes(px, 8, 3)),
        ("pcx", lw.pcx_bytes(np.tile(px[..., 0], (1, 4)), 8, 1, vga=r.integers(0, 256, (256, 3)))),
        ("pcx", lw.pcx_bytes(r.integers(0, 16, (9, 21)), 1, 4)),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_files_read_as_pil_or_are_refused_as_pil_refuses(tmp_path, seed):
    r = np.random.default_rng(800 + seed)
    read = refused = 0
    for kind, base in _corruption_bases():
        for _ in range(16):
            data = bytearray(base)
            op = int(r.integers(0, 4))
            if op == 0:
                for _ in range(int(r.integers(1, 4))):
                    data[int(r.integers(0, len(data)))] = int(r.integers(0, 256))
            elif op == 1:
                data[int(r.integers(0, min(len(data), 40)))] = int(r.integers(0, 256))
            elif op == 2:
                data = data[:int(r.integers(0, len(data) + 1))]
            else:
                data += r.integers(0, 256, int(r.integers(1, 20))).astype(np.uint8).tobytes()
            want, got = _outcome(tmp_path, bytes(data), f"c.{kind}")
            if want is None:
                assert got is None, f"{kind}: PIL refuses {bytes(data).hex()}, the port reads it"
                refused += 1
            else:
                assert got is not None, f"{kind}: PIL reads {bytes(data).hex()}, the port refuses"
                np.testing.assert_array_equal(got, want, err_msg=f"{kind}: {bytes(data).hex()}")
                read += 1
    assert read > 40 and refused > 20


# --------------------------------------------- refused forms ---------------------

def _sgi_head(bpc, dim, z, storage=0):
    return struct.pack(">hBBHHHH", 474, storage, bpc, dim, 2, 2, z).ljust(512, b"\0") + bytes(64)


REFUSED = {
    "sgi-3-bytes": (_sgi_head(3, 2, 1), "SGI of 3 bytes a sample"),
    "sgi-2-channels": (_sgi_head(1, 3, 2), "PIL: unsupported SGI image mode"),
    "sgi-storage-2": (_sgi_head(1, 2, 1, storage=2), "SGI storage 2"),
    "sgi-raw-short": (_sgi_head(1, 3, 3)[:520], "SGI image data is truncated"),
    "pcx-4bit-1plane": (lw.pcx_bytes(np.zeros((2, 4), np.uint8), 1, 1)[:3] + b"\4"
                        + lw.pcx_bytes(np.zeros((2, 4), np.uint8), 1, 1)[4:],
                        "unknown PCX mode"),
    "pcx-truncated": (lw.pcx_bytes(np.arange(64, dtype=np.uint8).reshape(8, 8), 1, 1)[:133],
                      "PCX image data is truncated"),
    "cur-png": (lw.icon_bytes([(4, 4, 0, 0, _pil_bytes(Image.new("RGB", (4, 4)), "PNG"))],
                              kind=2), "CUR with a PNG entry"),
    "ico-dib-header": (lw.icon_bytes([(4, 4, 0, 24, b"\x10\0\0\0" + bytes(60))]),
                       "ICO header of 16 bytes"),
    "ico-short-mask": (lw.icon_bytes([(4, 4, 0, 24, lw.dib_entry(np.zeros((4, 4, 3)),
                                                                 24))])[:-10],
                       "ICO AND mask is truncated"),
    "ico-short-alpha": (lw.icon_bytes([(4, 4, 0, 32, lw.dib_entry(np.zeros((4, 4, 3)),
                                                                  24)[:-16])]),
                        "ICO alpha is truncated"),
    "qoi-short": (b"qoif" + struct.pack(">IIBB", 3, 3, 3, 0) + b"\xfe\1\2", "QOI data ends"),
}


@pytest.mark.parametrize("form", list(REFUSED))
def test_refused_forms_name_themselves(tmp_path, form):
    data, match = REFUSED[form]
    path = tmp_path / "r.bin"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        port_image.read_image(str(path))
    assert str(path) in str(err.value)
    with pytest.raises(Exception):
        _pil_path(str(path))


def test_avif_is_still_refused_naming_the_formats_read():
    avif = b"\0\0\0\x20ftypavif\0\0\0\0avifmif1miafMA1B" + bytes(40)
    with pytest.raises(ValueError, match="unsupported image format.*ICO, CUR, QOI, SGI, PCX"):
        port_image.decode_image(avif)


# --------------------------------------------- no PIL, no compiler ---------------

def test_legacy_decoders_need_no_pil():
    code = ("import sys\n"
            "sys.modules['PIL'] = None  # any import of PIL fails\n"
            "import akari_torch.core.image as m\n"
            "for n in ('ico_depths_16x16.ico', 'cur_8bit_12x10.cur', 'qoi_ops_rgba_21x17.qoi',\n"
            "          'sgi_rle_rgba_14x9.rgba', 'pcx_4planes_21x9.pcx'):\n"
            "    print(m.read_image(sys.argv[1] + '/' + n).shape)\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'akari_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, FIXTURES], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120)
    assert out.stdout.split("\n")[:6] == ["(16, 16, 3)", "(10, 12, 3)", "(21, 17, 3)", "(9, 14, 3)",
                                          "(9, 21, 3)", "[]"]


@pytest.mark.parametrize("lib, name", [("qoi", "qoi_pil_rgb_19x23.qoi"),
                                       ("rle", "sgi_rle_rgba_14x9.rgba")])
def test_native_build_failure_raises(tmp_path, monkeypatch, lib, name):
    from akari_torch.native import loader

    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "CXX", "no-such-compiler-xyz")
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match=loader.SOURCES[lib][2]):
        port_image.decode_image(data)


# ------------------------------------------------ an albedo ----------------------

def test_obj_map_kd_sgi_pcx_qoi_ico_render_equal_to_the_png_route(tmp_path):
    """read_image through an OBJ's ``map_Kd``: an RLE SGI, a 24-bit PCX, a
    QOI and a 24-bit ICO of the same pixels give the texture tables and a
    16x16 CPU render of the OBJ on a PNG of them."""
    from akari_torch.core.transform import look_at
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import Scene
    from akari_torch.scene.obj import load_obj

    tex = pattern(24, 32, 9)
    files = {"png": port_image.encode_png(tex),
             "rgb": lw.sgi_bytes(tex.transpose(2, 0, 1), 1, True),
             "pcx": lw.pcx_bytes(tex, 8, 3), "qoi": lw.qoi_bytes(tex, r=np.random.default_rng(3)),
             "ico": lw.icon_bytes([(32, 24, 0, 24, lw.dib_entry(tex[..., ::-1], 24))])}
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
