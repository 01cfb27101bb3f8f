"""Write the image fixtures the PyTorch port's decoders are checked against
on a machine without PIL.

Writes into ``tests/data/torch_port_images/``:

- ``albedo2048_q85_420.jpg``: ``envtex_texture(2048, 0)`` (the config-3
  albedo of ``akari_torch.scene.builtin.write_envtex_terrain``) saved by
  PIL as a baseline 4:2:0 JPEG at quality 85;
- small JPEGs saved by PIL in the other forms the port decodes:
  progressive, optimized progressive 4:2:2, restart markers, RGB kept
  (Adobe transform 0), grey, 16-bit quantisation tables, quality 100 with
  partial MCUs;
- PNGs: a palette PNG with tRNS and an LA PNG saved by PIL, and an
  Adam7-interlaced 4-bit palette PNG and a 16-bit RGBA PNG written here
  (Pillow writes neither; ``png_bytes``, which the decoder tests use too);
- TIFFs in the forms of ``akari_torch/core/tiff.py``: Pillow's libtiff
  writer (LZW with a predictor, JPEG, PackBits, Deflate) and ``tiff_bytes``
  (``tiff_fixtures``: both byte orders, BigTIFF, tiles, planes, 16-bit and
  float samples, subsampled YCbCr, JPEG strips with JPEGTables, the old
  LZW codes, fill order 2, an orientation), and a CMYK JPEG saved by PIL
  with its YCCK twin (``cmyk_jpegs``);
- TGA, BMP, PNM, GIF and PSD files, a few KB each, in the forms of
  ``akari_torch/core/image_formats.py``: Pillow writes some of them, and
  the encoders below (``tga_bytes``, ``bmp_bytes``, ``pnm_bytes``,
  ``gif_bytes``, ``psd_bytes``) write every form, those Pillow cannot
  write included (colour-mapped and 16-bit TGA, BMP RLE and bitfields and
  OS/2 headers, GIF frames off the screen origin, PSD);
- ``albedo2048_q85.webp``: ``envtex_texture(2048, 0)`` saved by PIL as a
  lossy WebP at quality 85, and a dozen small WebPs (``webp_fixtures``):
  lossy and lossless ones saved by PIL at several qualities and methods, a
  16- and a 2-colour lossless image (bundled palettes), lossy with a
  VP8L-coded alpha plane, a two-frame animation, one with ICC and EXIF
  chunks, and files built here: a raw (uncompressed) alpha plane, an
  animation whose first frame sits inside its canvas at an offset, and a
  random VP8 key frame of ``tools/webp_writers.py`` (simple loop filter,
  four token partitions);
- DDS, BLP and FTEX files of a few hundred bytes each (``dds_fixtures``):
  Pillow's DDS and BLP writers and the forms they cannot write, from
  ``tools/dds_writers.py`` (every BCn form, BC6H and BC7 of every mode, the
  DX10 header, the mask and palette forms, BLP1 JPEG, BLP2 DXT, FTEX);
- ICO / CUR, QOI, SGI, PCX and LZMA / ZSTD TIFF files (``legacy_fixtures``):
  Pillow's writers, ``tools/legacy_writers.py`` for the forms Pillow cannot
  write, and a 2048^2 ZSTD TIFF of the config-3 albedo scaled up 32x
  (``ZSTD_ALBEDO``, 71 KB);
- arithmetic-coded (SOF9 / SOF10) and lossless (SOF3) JPEGs written by
  ``tools/jpeg_writers.py`` and progressive JPEGs saved by PIL and cut
  after a scan (``jpeg_form_fixtures``), each a few KB (below Pillow's
  64 KiB feed, past which libjpeg's arithmetic decoder, which cannot
  suspend, fails in PIL), and ``ALBEDO_CUT``: ``envtex_texture(2048, 0)``
  saved by PIL as a progressive 4:2:0 JPEG at quality 85 and cut after its
  6th scan, which libjpeg reads with block smoothing;
- CCITT (RLE, RLEW, Group 3, Group 4), ThunderScan and old-style JPEG
  TIFFs (``fax_fixtures``): Pillow's CCITT writer and
  ``tools/tiff_writers.py``'s strips, a few KB each;
- JPEG 2000 files (``jpeg2000_fixtures``): raw codestreams (``j2k_*``)
  and JP2 files (``jp2_*``) of a few KB each, from Pillow's writer and from
  ``tools/j2k_writers.py`` (OpenJPEG's encoder through ``ctypes``, for the
  code-block styles, POC, tile-parts, subsampling, signed and 1-16-bit
  components, ROI, SOP / EPH, PLT / TLM, PPM / PPT, and hand-built JP2 boxes),
  ``ALBEDO_JP2``: ``envtex_texture(2048, 0)`` saved by PIL as an
  irreversible (9/7) JP2 at a rate of 30 (419 KB), and ``ALBEDO_J2K``: the
  config-3 albedo at 64^2 scaled up 32x, saved by PIL as a reversible (5/3)
  codestream with the RCT (602 KB);
- HTJ2K and Part-2 files (``htj2k_fixtures``), a few hundred bytes each:
  ``htj2k_*`` from the HT writer of ``tools/j2k_writers.py`` (``encode_ht``:
  cleanup-only and three-pass code-blocks, 5/3 + RCT and 9/7 + ICT, grey,
  RGB, RGBA and 16-bit, 8x8 to 128x32 code-blocks, VSC, placeholder passes,
  raw, JP2 and JPH), ``part2_*`` OpenJPEG codestreams with MCT / MCC / MCO /
  CBD segments spliced in; ``ALBEDO_HTJ2K``, the 64^2 albedo scaled up 32x
  as a reversible HT codestream (1.18 MB), is not committed (the fixtures'
  size budget): ``htj2k_albedo`` writes it where it is needed;
- Lab PSDs and TIFFs, ``Pf`` and PIL's other PNM modes, DIBs and ICNS
  files (``lab_pnm_dib_icns_fixtures``), a few hundred bytes to a few KB
  each: Pillow's writers (Lab TIFF, DIB, ICNS with PNG entries) and the
  encoders here and in ``tools/icns_writers.py`` / ``tools/j2k_writers.py``;
- IM, IM Tools, IPTC/NAA, SPIDER, DCX, MSP and XBM files
  (``plugin_fixtures``), a few hundred bytes to a few KB each: Pillow's
  writers (IM, SPIDER, MSP version 1, XBM) and ``tools/raster_writers.py``
  for every IM image type and Lut form, IM Tools, IPTC raw and JPEG data,
  SPIDER stacks, DCX pages and version-2 MSP;
- Sun raster, FLI / FLC, FITS, GBR, McIdas, PIXAR, XV thumbnail and XPM
  files (``raster_fixtures``), from ``tools/raster_writers.py`` (Pillow
  writes none of them), a few hundred bytes each, the FITS files a few KB;
- AVIF files (``avif_fixtures``) in ``tests/data/torch_port_avif/`` with
  a ``digests.json`` of their own (the fixtures above fill their 3.2 MB
  budget): PIL's writer at several qualities, speeds 5-10, 4:2:0 / 4:2:2
  / 4:4:4 / 4:0:0, full and limited range, alpha (premultiplied too),
  screen content (palettes), 2x2 tiles, quality 0 (TX_MODE_SELECT) and
  100 (lossless), an EXIF orientation and an ICC profile, and files edited
  by ``tools/avif_writers.py`` (the item in ``idat``, BT.709, FCC and
  identity nclx matrices), a few KB each; and ``ALBEDO_AVIF``:
  ``envtex_texture(2048, 0)`` at quality 60, speed 6, 4:2:0 (287,591
  bytes), which the card's machine, without an AV1 encoder, decodes; the
  AV1 tools PIL's writer makes through ``advanced=`` (``avif_tool_fixtures``,
  ``avif_seg_ibc_fixtures``) and their 2048^2 albedos; and the 10- and
  12-bit, superres and hidden-frame forms PIL's writer does not make,
  header rewrites of those files (``avif_rewrite_fixtures``,
  ``tools/av1_rewrite.py``); the sequences of slice 26 that
  ``splice_frames`` makes into inter frame 0, the stills with loop
  restoration for its superres rewrite and ``ALBEDO_AVIF_INTER``
  (``avif_inter_fixtures``; each sequence's ``digests.json`` entry holds
  PIL's read of each splice, ``splice_digests``);
- ``tests/data/torch_port_avif_rewrites.json`` (``AVIF_REWRITES``): the
  2048^2 rewrites of the albedos (``avif_rewrite_albedo_files``, the
  inter-frame splice of ``ALBEDO_AVIF_INTER`` among them), which
  ``chip_smoke.py`` phase 54 makes at run time: each file's SHA-256 and
  PIL's decode of it;
- ``digests.json``: for each file, the SHA-256 of PIL's decoded RGB bytes
  (``Image.open(path).convert("RGB")``), their shape and the version of
  PIL that decoded them;
- ``tests/data/torch_port_generated_images.json`` (``GENERATED``): the
  2048^2 albedo files of ``lab_albedo_files``, ``plugin_albedo_files`` and
  ``raster_albedo_files``,
  which ``chip_smoke.py`` writes on the card's machine rather than reading
  them from the repository: each file's SHA-256 and PIL's decode of it.

``chip_smoke.py`` decodes every fixture with the port and checks the
digests; ``tests/test_torch_image_decode.py``,
``tests/test_torch_image_formats.py``, ``tests/test_torch_image_tiff.py``,
``tests/test_torch_image_webp.py``, ``tests/test_torch_image_dds.py`` and
``tests/test_torch_image_legacy.py`` hold ``digests.json`` to PIL's
decode here, so it cannot go stale. Needs PIL.

Usage: python tools/make_torch_port_image_fixtures.py [-o DIR]
           [--only jpeg2000|htj2k|lab_pnm_dib_icns|plugins|rasters|avif]

``--only avif`` rewrites ``tests/data/torch_port_avif/`` (files and
digests) and nothing else. Each AVIF file is written by PIL in a process
of its own (``_avif``): aom, which PIL's writer runs, can crash the process
(SIGSEGV) on some ``advanced`` settings, e.g. the 2048^2 albedo at
``quality=60, speed=6, advanced={"deltaq-mode": "3", "delta-lf-mode":
"1"}``, and a 160 x 120 pattern at quality 78, speed 7 with the same two.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_images")
AVIF_OUT = os.path.join(ROOT, "tests", "data", "torch_port_avif")
ALBEDO_AVIF = "albedo2048_q60.avif"
ALBEDO_AVIF_TOOLS = "albedo2048_q60_s4_tools.avif"
ALBEDO_AVIF_AQ = "albedo2048_q60_s6_aq1.avis.avif"
# slice 26: the albedo and its (3, 5) roll averaged with a one-pixel shift of
# that roll (sub-pixel motion), a two-frame sequence whose frame 1 is
# almost all motion-compensated; chip_smoke.py phase 54 splices it into
# inter frame 0 (AVIF_REWRITES)
ALBEDO_AVIF_INTER = "albedo2048_q60_s6_inter.avis.avif"
# the 2048^2 albedos of slice 25, made from the committed ones by header
# rewrites (avif_rewrite_albedo_files): each file's SHA-256 and PIL's decode
AVIF_REWRITES = os.path.join(ROOT, "tests", "data", "torch_port_avif_rewrites.json")
ALBEDO = "albedo2048_q85_420.jpg"
ALBEDO_WEBP = "albedo2048_q85.webp"
ZSTD_ALBEDO = "albedo2048_x32_zstd_pred2.tiff"
ALBEDO_CUT = "albedo2048_q85_prog_cut6.jpg"
ALBEDO_JP2 = "albedo2048_irrev97_rate30.jp2"
ALBEDO_J2K = "albedo2048_x32_rev53.j2k"
ALBEDO_HTJ2K = "albedo2048_x32_rev53_ht.j2c"


def pattern(h, w, seed):
    """Smooth colour waves plus seeded noise: every DCT band gets energy."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    wave = (np.sin(x / 3.0) * np.cos(y / 4.0))[..., None] * np.array([90.0, -60.0, 40.0])
    return (128 + wave + r.normal(0, 20, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _pack(samples, depth):
    """[h, n] samples -> [h, stride] bytes: big-endian 16-bit, or sub-byte
    samples packed MSB first, each row padded to whole bytes."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(samples.shape[0], -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filter(rows, bpp, ftypes):
    """[h, stride] bytes -> filtered scanlines, filter ftypes[y] on row y."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        f = [cur, cur - left, cur - prior, cur - (left + prior) // 2, cur - paeth][ftypes[y]]
        out.append(bytes([ftypes[y]]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(out)


def png_bytes(px, depth, ctype, interlace=0, plte=None, trns=None, extra=(), seed=0):
    """[H, W, ch] samples -> PNG bytes of that colour type and depth, each
    scanline (of each Adam7 pass) with a seeded filter type, the image data
    in two IDAT chunks. Pillow writes no interlaced, sub-byte grey or 16-bit
    colour PNG; this writes them all."""
    from akari_torch.core.image import _ADAM7, PNG_SIGNATURE, _chunk

    h, w, ch = px.shape
    bpp = max(1, depth * ch // 8)
    r = np.random.default_rng(seed)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        raw += _filter(rows, bpp, r.integers(0, 5, sub.shape[0]))
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      interlace))
    for tag, body in extra:
        out += _chunk(tag, body)
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    comp = zlib.compress(raw)
    half = len(comp) // 2
    return (out + _chunk(b"IDAT", comp[:half]) + _chunk(b"IDAT", comp[half:])
            + _chunk(b"IEND", b""))


# --------------------------------------------------------------------------
# TGA


def _rle_packets(px, row_len, lit_max, run_ok, r):
    """[n, bpp] pixels in file order -> TGA RLE packets: a run packet for
    2-128 equal pixels that stays inside its scanline (PIL refuses a run
    across one), else a literal packet of a seeded length up to ``lit_max``
    that may cross scanlines."""
    out, i, n = [], 0, px.shape[0]
    while i < n:
        j = i
        line_end = (i // row_len + 1) * row_len
        while j + 1 < min(n, line_end, i + 128) and np.array_equal(px[j + 1], px[i]):
            j += 1
        if run_ok and j > i:
            out.append(bytes([0x80 | (j - i)]) + px[i].tobytes())
            i = j + 1
            continue
        k = min(n, i + int(r.integers(1, lit_max + 1)))
        out.append(bytes([k - i - 1]) + px[i:k].tobytes())
        i = k
    return b"".join(out)


def tga_bytes(stored, imtype, depth, cmap=b"", cm_start=0, cm_len=0, cm_depth=0, origin=0x00,
              id_field=b"", lit_max=128, seed=0):
    """[H, W, bpp] stored pixel bytes (BGR(A), little-endian 16-bit words or
    grey / index bytes, in display order) -> a TGA file of image type
    ``imtype`` (1/2/3, or 9/10/11 run-length encoded) and pixel ``depth``.
    ``origin`` is the descriptor's bits 4-5: 0x00 bottom-left, 0x10
    bottom-right, 0x20 top-left, 0x30 top-right. ``cmap`` holds ``cm_len``
    colour-map entries of ``cm_depth`` bits for indices from ``cm_start``.
    ``stored`` may be [H, row_bytes, 1] packed bits for depth 1."""
    h, w = stored.shape[:2]
    width = w * 8 // depth if depth == 1 else w
    rows = stored if origin & 0x20 else stored[::-1]
    if origin & 0x10 and depth != 1:
        rows = rows[:, ::-1]
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap else 0, imtype, cm_start,
                       cm_len, cm_depth, 0, 0, width, h, depth, origin)
    flat = np.ascontiguousarray(rows).reshape(h * w, -1)
    if imtype & 8:
        body = _rle_packets(flat, w, lit_max, True, np.random.default_rng(seed))
    else:
        body = flat.tobytes()
    return head + id_field + cmap + body


# --------------------------------------------------------------------------
# BMP


def bmp_rows(samples, bits, top_down=False):
    """[H, W] indices or [H, W, k] stored bytes (display order) -> the
    pixel array, bottom-up unless ``top_down``, each row padded to 4
    bytes."""
    h = samples.shape[0]
    if bits < 8:
        rows = _pack(samples.reshape(h, -1), bits)
    else:
        rows = np.ascontiguousarray(samples, np.uint8).reshape(h, -1)
    stride = -(-rows.shape[1] // 4) * 4
    pad = np.zeros((h, stride - rows.shape[1]), np.uint8)
    rows = np.concatenate([rows, pad], axis=1)
    return (rows if top_down else rows[::-1]).tobytes()


def bmp_rle(idx, rle4, r):
    """[H, W] palette indices -> BI_RLE8 / BI_RLE4 data, bottom row first:
    runs (two alternating indices under RLE4), absolute packets of 3 or
    more pixels padded to a 16-bit boundary, an end-of-line escape after
    each row and an end-of-bitmap escape."""
    out = bytearray()
    h, w = idx.shape
    for row in idx[::-1]:
        x = 0
        while x < w:
            n = min(w - x, int(r.integers(1, 12)))
            seg = row[x:x + n]
            if n >= 3 and r.random() < 0.5:  # absolute
                out += bytes([0, n])
                data = (bytes((seg[0::2] << 4) | np.append(seg[1::2], 0)[:len(seg[0::2])])
                        if rle4 else seg.astype(np.uint8).tobytes())
                out += data + bytes(len(data) & 1)
            elif rle4:
                pair = seg[:2] if n > 1 else np.append(seg, 0)
                rep = np.resize(pair, n)
                if not np.array_equal(rep, seg):  # keep the run honest: 1-2 pixels
                    n, rep = min(n, 2), seg[:min(n, 2)]
                    pair = rep if len(rep) == 2 else np.append(rep, 0)
                out += bytes([n, (int(pair[0]) << 4) | int(pair[1])])
            else:
                n = 1 + int(np.argmax(np.append(seg[1:] != seg[0], True)))
                out += bytes([n, int(seg[0])])
            x += n
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def bmp_bytes(width, height, bits, pixels, header=40, compression=0, palette=b"",
              colors=0, masks=None, masks_in_header=True):
    """A BMP file: the 14-byte file header, a BITMAPCOREHEADER (``header``
    12, OS/2) or a BITMAPINFOHEADER of size 40/52/56/108/124 (negative
    ``height`` for top-down rows), the bitfield ``masks`` (in the header
    from 52 bytes on, else after it when ``masks_in_header`` is False),
    the ``palette`` bytes and the pixel data."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits, compression,
                           len(pixels), 2835, 2835, colors, 0)
        if masks is not None and masks_in_header and header >= 52:
            fit = masks[:3] if header == 52 else masks  # the alpha mask from 56 bytes on
            info += struct.pack("<" + "I" * len(fit), *fit)
        info += bytes(header - len(info))
    tail = b""
    if masks is not None and not (masks_in_header and header >= 52):
        tail = struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(tail) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + tail
            + palette + pixels)


# --------------------------------------------------------------------------
# PNM


def pnm_bytes(kind, samples, maxval=255, comments=False, seed=0):
    """[H, W] or [H, W, 3] samples -> a P1-P6 file; ASCII forms take seeded
    whitespace (and ``comments``), raw P5/P6 above 255 take big-endian
    16-bit samples. P1/P4 samples are bits, 1 = black."""
    r = np.random.default_rng(seed)
    h, w = samples.shape[:2]

    def sep():
        return b"".join(b" \t\n\r\x0b\x0c"[i:i + 1]
                        for i in r.integers(0, 6, int(r.integers(1, 3)))) if seed else b" "

    head = [f"P{kind}".encode(), str(w).encode(), str(h).encode()]
    if kind not in (1, 4):
        head.append(str(maxval).encode())
    out = b""
    for tok in head:
        out += tok + (b"\n# a comment\n" if comments else sep())
    flat = np.asarray(samples).reshape(-1)
    if kind == 4:
        return out + _pack(np.asarray(samples).reshape(h, w), 1).tobytes()
    if kind in (5, 6):
        dt = ">u2" if maxval > 255 else np.uint8
        return out + flat.astype(dt).tobytes()
    vals = [str(int(v)).encode() for v in flat]
    if kind == 1 and r.random() < 0.5:  # plain PBM needs no separators
        return out + b"".join(vals)
    body = b""
    for i, v in enumerate(vals):
        body += v + (b"\n# c\n" if comments and i % 7 == 3 else sep())
    return out + body


# --------------------------------------------------------------------------
# GIF


def lzw_codes(idx, min_code, clear_every=None):
    """Palette indices -> GIF LZW codes (a clear code first, the end code
    last); the table stops growing at 4,096 codes, and ``clear_every``
    codes a clear code restarts it."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    codes, sizes = [clear], [min_code + 1]
    table, nxt, size = {}, end + 1, min_code + 1
    since = 0
    prefix = None
    for v in np.asarray(idx, np.int64).reshape(-1).tolist():
        if prefix is None:
            prefix = v
            continue
        key = (prefix, v)
        if key in table:
            prefix = table[key]
            continue
        codes.append(prefix)
        sizes.append(size)
        since += 1
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        prefix = v
        if clear_every and since >= clear_every:
            codes.append(prefix)
            sizes.append(size)
            codes.append(clear)
            sizes.append(size)
            table, nxt, size, since, prefix = {}, end + 1, min_code + 1, 0, None
    if prefix is not None:
        codes.append(prefix)
        sizes.append(size)
    codes.append(end)
    sizes.append(size)
    return codes, sizes


def pack_codes(codes, sizes):
    """Codes of the given bit sizes -> bytes, least significant bit first."""
    acc = nbits = 0
    out = bytearray()
    for c, s in zip(codes, sizes):
        acc |= c << nbits
        nbits += s
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    return bytes(out)


def sub_blocks(data, block=255):
    """Bytes -> GIF data sub-blocks and the block terminator."""
    return b"".join(bytes([len(data[i:i + block])]) + data[i:i + block]
                    for i in range(0, len(data), block)) + b"\x00"


def gif_bytes(idx, palette, screen=None, offset=(0, 0), local=False, interlace=False,
              min_code=8, transparency=None, background=0, clear_every=None, block=255,
              extensions=b"", version=b"GIF89a"):
    """[h, w] palette indices -> a one-frame GIF: ``palette`` ([n, 3], n a
    power of two) global or ``local``, the frame at ``offset`` on a logical
    screen of ``screen`` (w, h), optionally interlaced, a graphic control
    extension when ``transparency`` is set, LZW of ``min_code`` bits."""
    h, w = idx.shape
    sw, sh = screen or (w + offset[0], h + offset[1])
    bits = max(1, int(np.log2(len(palette)))) - 1
    pal = np.asarray(palette, np.uint8).tobytes()
    flags = 0 if local else 0x80 | 0x70 | bits
    out = version + struct.pack("<HHBBB", sw, sh, flags, background, 0)
    if not local:
        out += pal
    out += extensions
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    rows = np.arange(h)
    if interlace:
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h,
                              (0x80 | bits if local else 0) | (0x40 if interlace else 0))
    if local:
        out += pal
    data = pack_codes(*lzw_codes(idx[rows], min_code, clear_every))
    return out + bytes([min_code]) + sub_blocks(data, block) + b";"


# --------------------------------------------------------------------------
# PSD


def packbits_row(row, r):
    """One row of bytes -> PackBits: runs of 3+ equal bytes as run packets,
    the rest as literal packets of seeded lengths, with no-op bytes (128)."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and j - i < 127 and row[j + 1] == row[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
        else:
            k = min(n, i + int(r.integers(1, 129)))
            out += bytes([k - i - 1]) + bytes(row[i:k])
            i = k
        if r.random() < 0.05:
            out.append(128)
    return bytes(out)


def _literal_rows(planes):
    """[C, H, W] uint8 -> PackBits rows of literal packets of up to 128
    bytes (vectorised, for large images)."""
    c, h, w = planes.shape
    rows = planes.reshape(c * h, w)
    parts = []
    for x in range(0, w, 128):
        n = min(128, w - x)
        parts += [np.full((c * h, 1), n - 1, np.uint8), rows[:, x:x + n]]
    coded = np.concatenate(parts, axis=1)
    return [coded[i].tobytes() for i in range(c * h)]


def psd_bytes(planes, mode, bits=8, compression=1, color_data=b"", n_channels=None, seed=0,
              literal=False):
    """[C, H, W] channel planes (packed rows for 1-bit) -> a PSD file of
    colour ``mode`` (0 bitmap, 1 grey, 2 indexed, 3 RGB, 4 CMYK, 7
    multichannel, 8 duotone, 9 Lab): the colour-mode data (an indexed
    image's 768-byte planar palette), an image resource, an empty layer
    section and the composite image, raw or PackBits by channel and row
    (``literal``: literal packets only, written without a Python loop over
    the bytes)."""
    c, h = planes.shape[:2]
    width = planes.shape[2] * 8 if bits == 1 else planes.shape[2]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, n_channels or c, h, width, bits, mode)
    res = b"8BIM" + struct.pack(">HBx", 1000, 0) + struct.pack(">I", 2) + b"\x00\x01"
    out = head + struct.pack(">I", len(color_data)) + color_data
    out += struct.pack(">I", len(res)) + res + struct.pack(">I", 0)
    if compression == 0:
        return out + b"\x00\x00" + planes.astype(np.uint8).tobytes()
    r = np.random.default_rng(seed)
    rows = (_literal_rows(np.asarray(planes, np.uint8)) if literal
            else [packbits_row(bytes(row), r) for plane in planes for row in plane])
    counts = struct.pack(">" + "H" * len(rows), *[len(x) for x in rows])
    return out + b"\x00\x01" + counts + b"".join(rows)


# --------------------------------------------------------------------------
# the fixtures


def tiff_lzw(data, compat=False):
    """TIFF LZW codes for ``data`` (libtiff's encoder: a clear code first,
    the table reset before it passes 4,093 entries, an end code last),
    most significant bit first with the code width growing one code
    early, or with ``compat`` the old bit-reversed form (least significant
    bit first, the width growing one code late)."""
    early = 0 if compat else 1
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = acc << nbits | code
            nacc += nbits
            while nacc >= 8:
                nacc -= 8
                out.append(acc >> nacc & 255)
                acc &= (1 << nacc) - 1

    nbits = 9
    table, nxt, first = {}, 258, True
    dec_free = 258  # the decoder's next entry, which sets the width

    def emit(code):
        nonlocal nbits, dec_free, first
        put(code, nbits)
        if first:
            first = False
            return
        dec_free += 1
        if dec_free > (1 << nbits) - 1 - early and nbits < 12:
            nbits += 1

    def clear():
        nonlocal nbits, table, nxt, first, dec_free
        put(256, nbits)
        nbits, table, nxt, first, dec_free = 9, {}, 258, True, 258

    clear()
    w = None
    for b in data:
        if w is None:
            w = b
            continue
        k = (w << 8) | b
        code = table.get(k)
        if code is not None:
            w = code
            continue
        emit(w)
        table[k] = nxt
        nxt += 1
        w = b
        if nxt >= 4093:
            emit(w)
            w = None
            clear()
    if w is not None:
        emit(w)
    put(257, nbits)
    if nacc:
        put(0, 8 - nacc)
    return bytes(out)


_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "L", 5: "L", 6: "b", 7: "B", 8: "h", 9: "l", 10: "l",
               11: "f", 12: "d", 16: "Q"}
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_rows(samples, bits, order):
    """[h, n] samples -> [h, row bytes] in the file's order, sub-byte samples
    packed most significant first."""
    if bits in (16, 32, 64):
        kind = "f" if samples.dtype.kind == "f" else "u"
        return samples.astype(f"{order}{kind}{bits // 8}").view(np.uint8).reshape(
            samples.shape[0], -1)
    return _pack(samples, bits) if bits < 8 else samples.astype(np.uint8)


def _tiff_predict(samples, bits, spp, predictor):
    """Horizontal differencing of [h, w * spp] samples (predictor 2), in
    the samples' own width."""
    if predictor != 2:
        return samples
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    v = samples.astype(dt)
    h = v.shape[0]
    px = v.reshape(h, -1, spp)
    d = px.copy()
    d[:, 1:] = px[:, 1:] - px[:, :-1]
    return d.reshape(h, -1)


def _tiff_fp_predict(rows, spp):
    """libtiff's fpDiff on rows of host-order (little-endian) float32 bytes:
    the bytes regrouped most significant plane first, then differenced
    with a step of ``spp`` bytes."""
    h, n = rows.shape
    planes = rows.reshape(h, n // 4, 4)[..., ::-1].transpose(0, 2, 1).reshape(h, n)
    g = planes.reshape(h, -1, spp).astype(np.int16)
    g[:, 1:] = g[:, 1:] - g[:, :-1]
    return (g & 255).astype(np.uint8).reshape(h, n)


def _tiff_compress(job):
    """One strip or tile's rows [n, row bytes] -> its stored bytes."""
    rows, compression, compat, fill, seed = job
    if compression == 1:
        b = rows.tobytes()
    elif compression == 5:
        b = tiff_lzw(rows.tobytes(), compat)
    elif compression in (8, 32946):
        b = zlib.compress(rows.tobytes(), 6)
    elif compression == 32773:
        r = np.random.default_rng(seed)
        b = b"".join(packbits_row(row, r) for row in rows)
    elif compression == 34925:
        import lzma

        b = lzma.compress(rows.tobytes(), lzma.FORMAT_XZ, lzma.CHECK_NONE)
    elif compression == 50000:
        import zstandard  # a test dependency; the port decodes without it

        k = seed[0] if isinstance(seed, tuple) else seed
        b = zstandard.ZstdCompressor(level=3 + k % 17, write_checksum=bool(k & 1),
                                     write_content_size=bool(k & 2)).compress(rows.tobytes())
    else:
        raise ValueError(f"no encoder for compression {compression}")
    if fill == 2 and compression != 1:
        b = _BITREV[np.frombuffer(b, np.uint8)].tobytes()
    return b


def _ycbcr_units(part, hs, vs):
    """[rows, cols, 3] YCbCr -> the bytes of its subsampled blocks, the
    image padded by repeating its last row and column."""
    rows, cols, _ = part.shape
    ph, pw = -(-rows // vs) * vs, -(-cols // hs) * hs
    p = np.pad(part, ((0, ph - rows), (0, pw - cols), (0, 0)), mode="edge").astype(np.uint8)
    y = p[..., 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(ph // vs, pw // hs, hs * vs)
    chroma = p[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], axis=-1).reshape(-1)


def _jpeg_segments(data):
    """A JPEG -> [(marker, segment bytes)] up to SOS, and the scan data."""
    pos, out = 2, []
    while True:
        code = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((code, data[pos:pos + 2 + length]))
        pos += 2 + length
        if code == 0xDA:
            return out, data[pos:]


def tiff_jpeg_blocks(rgb, rows=None, tile=None, subsampling=2, quality=80, tables=True):
    """JPEG strips of ``rows`` rows (or tiles ``tile`` = (tw, th), the image
    padded by repeating its edge) of an [h, w, 3] RGB image, each saved by
    PIL (YCbCr, 4:2:0 with ``subsampling`` 2); with ``tables`` the DQT and
    DHT segments are moved out into one JPEGTables stream and each strip is
    an abbreviated stream. Returns (blocks, JPEGTables bytes or None)."""
    import io

    from PIL import Image

    h, w, _ = rgb.shape
    if tile:
        tw, th = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        padded = np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
        parts = [padded[y:y + th, x:x + tw] for y in range(0, ph, th) for x in range(0, pw, tw)]
    else:
        parts = [rgb[y:y + rows] for y in range(0, h, rows)]
    blocks, table_segs = [], []
    for part in parts:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(part).astype(np.uint8)).save(
            buf, "JPEG", quality=quality, subsampling=subsampling)
        data = buf.getvalue()
        if not tables:
            blocks.append(data)
            continue
        segs, scan = _jpeg_segments(data)
        table_segs = [seg for code, seg in segs if code in (0xC4, 0xDB)]
        blocks.append(b"\xff\xd8" + b"".join(seg for code, seg in segs
                                              if code not in (0xC4, 0xDB)) + scan)
    return blocks, (b"\xff\xd8" + b"".join(table_segs) + b"\xff\xd9") if tables else None


def tiff_bytes(samples, bits, photometric, order="<", bigtiff=False, compression=1,
               predictor=1, fill=1, planar=1, rows_per_strip=None, tile=None,
               sample_format=None, extra=None, colormap=None, orientation=None, tags=None,
               omit=(), compat=False, blocks=None, header=None, ycbcr=None, seed=0,
               mapper=map):
    """A TIFF file of ``samples`` [h, w, spp] (integers, or float32 for
    sample format 3): strips of ``rows_per_strip`` rows or ``tile`` (tw,
    th) tiles, planar configuration 1 or 2, compression 1 (raw), 5 (LZW,
    ``compat``: the old codes), 8 / 32946 (Deflate), 32773 (PackBits,
    a row at a time, packets drawn from ``seed``), 34925 (LZMA: an .xz
    stream without a check, as libtiff writes it) or 50000 (ZSTD through
    the ``zstandard`` package, a test dependency: the level, checksum and
    content size drawn from ``seed``), predictor 2 or 3, fill
    order 2, classic or BigTIFF in either byte order. ``tags`` adds or
    replaces tags ({tag: (type, values)}), ``omit`` drops tags,
    ``blocks`` gives the compressed strips or tiles outright and ``header``
    replaces the first four bytes. ``ycbcr`` (hs, vs) writes 8-bit YCbCr
    samples in subsampled blocks (hs x vs luma, then Cb and Cr of the
    block's first pixel) with a YCbCrSubsampling tag. ``mapper`` maps the
    compression over the strips or tiles (an executor's ``map`` spreads it
    over processes)."""
    samples = np.asarray(samples)
    h, w, spp = samples.shape
    fp_bytes = predictor == 3
    if tile:
        tw, th = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        padded = np.zeros((ph, pw, spp), samples.dtype)
        padded[:h, :w] = samples
    planes = [samples] if planar == 1 else [samples[..., k:k + 1] for k in range(spp)]
    if tile:
        planes = [padded] if planar == 1 else [padded[..., k:k + 1] for k in range(spp)]
    raw_blocks = []
    for plane in planes:
        ps = plane.shape[2]
        if tile:
            parts = [plane[y:y + th, x:x + tw] for y in range(0, ph, th) for x in range(0, pw, tw)]
        else:
            rps = rows_per_strip or h
            parts = [plane[y:y + rps] for y in range(0, h, rps)]
        for part in parts:
            flat = part.reshape(part.shape[0], -1)
            if ycbcr:
                raw_blocks.append(_ycbcr_units(part, *ycbcr)[None])
                continue
            if fp_bytes:
                rows = _tiff_fp_predict(_tiff_rows(flat, 32, "<"), ps)
            else:
                rows = _tiff_rows(_tiff_predict(flat, bits, ps, predictor), bits, order)
            raw_blocks.append(rows)
    if blocks is None:
        jobs = [(rows, compression, compat, fill, (seed, i)) for i, rows in enumerate(raw_blocks)]
        blocks = list(mapper(_tiff_compress, jobs))
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
         262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fill != 1:
        t[266] = (3, [fill])
    if predictor != 1:
        t[317] = (3, [predictor])
    if sample_format is not None:
        t[339] = (3, [sample_format] * spp)
    if extra is not None:
        t[338] = (3, list(extra))
    if colormap is not None:
        t[320] = (3, list(colormap))
    if orientation is not None:
        t[274] = (3, [orientation])
    if ycbcr:
        t[530] = (3, list(ycbcr))
    if tile:
        t[322], t[323] = (4, [tile[0]]), (4, [tile[1]])
    else:
        t[278] = (4, [rows_per_strip or h])
    t.update(tags or {})
    head = 16 if bigtiff else 8
    offsets, pos, body = [], head, b""
    for b in blocks:
        offsets.append(pos)
        body += b
        pos += len(b)
    pos += pos & 1
    body += bytes(pos - head - len(body))
    t[324 if tile else 273] = (16 if bigtiff else 4, offsets)
    t[325 if tile else 279] = (16 if bigtiff else 4, [len(b) for b in blocks])
    for k in omit:
        t.pop(k, None)
    entry, count_fmt = ("HHQ", "Q") if bigtiff else ("HHL", "H")
    ifd_at = pos
    n = len(t)
    ifd_size = (8 if bigtiff else 2) + n * (20 if bigtiff else 12) + (8 if bigtiff else 4)
    extra_data = b""
    data_at = ifd_at + ifd_size
    ifd = struct.pack(order + count_fmt, n)
    for tag in sorted(t):
        typ, vals = t[tag]
        if typ in (5, 10):
            vals = [v for pair in vals for v in pair]
        packed = (bytes(vals) if typ in (1, 2, 7) and isinstance(vals, (bytes, bytearray))
                  else struct.pack(f"{order}{len(vals)}{_TIFF_TYPES[typ]}", *vals))
        count = len(packed) // struct.calcsize("<" + _TIFF_TYPES[typ]) // (2 if typ in (5, 10) else 1)
        if len(packed) <= (8 if bigtiff else 4):
            inline = packed.ljust(8 if bigtiff else 4, b"\0")
        else:
            inline = struct.pack(order + ("Q" if bigtiff else "L"), data_at + len(extra_data))
            extra_data += packed + bytes(len(packed) & 1)
        ifd += struct.pack(order + entry, tag, typ, count) + inline
    ifd += bytes(8 if bigtiff else 4)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(order + "H", 43 if bigtiff else 42)
    if bigtiff:
        hdr = magic + struct.pack(order + "HHQ", 8, 0, ifd_at)
    else:
        hdr = magic + struct.pack(order + "L", ifd_at)
    if header is not None:
        hdr = header + hdr[4:]
    return hdr + body + ifd + extra_data


def _bgr_palette(r, n, pad):
    pal = r.integers(0, 256, (n, 3)).astype(np.uint8)
    if pad:
        pal = np.concatenate([pal, np.zeros((n, 1), np.uint8)], axis=1)
    return pal.tobytes()


def format_fixtures(r):
    """name -> file bytes of the TGA, BMP, PNM, GIF and PSD fixtures."""
    out = {}
    px = pattern(13, 17, 20)
    bgr = px[..., ::-1]
    idx = r.integers(0, 16, (11, 9))
    # TGA: true colour, grey, colour-mapped (map at an offset), 16-bit,
    # run-length encoded with packets across scanlines, each origin, an ID
    out["tga_bgr24_rle_bottom_left.tga"] = tga_bytes(np.repeat(bgr, 2, axis=1), 10, 24, seed=1)
    out["tga_bgra32_top_right_id.tga"] = tga_bytes(
        np.concatenate([bgr, r.integers(0, 256, (13, 17, 1)).astype(np.uint8)], axis=2),
        2, 32, origin=0x30, id_field=b"fixture")
    words = r.integers(0, 1 << 16, (9, 14)).astype("<u2")
    out["tga_16bit_bottom_right.tga"] = tga_bytes(words.view(np.uint8).reshape(9, 14, 2), 2, 16,
                                                  origin=0x10)
    out["tga_grey8_rle_top_left.tga"] = tga_bytes(
        np.repeat(px[..., :1], 3, axis=1), 11, 8, origin=0x20, seed=2)
    out["tga_cmap24_start5.tga"] = tga_bytes(
        (idx + 3)[..., None].astype(np.uint8), 1, 8, cmap=_bgr_palette(r, 16, False),
        cm_start=5, cm_len=16, cm_depth=24)
    out["tga_cmap16_rle.tga"] = tga_bytes(
        np.repeat(idx, 3, axis=1)[..., None].astype(np.uint8), 9, 8,
        cmap=r.integers(0, 1 << 16, 16).astype("<u2").tobytes(), cm_len=16, cm_depth=16, seed=3)
    out["tga_cmap24_rle_top_left.tga"] = tga_bytes(
        np.repeat(idx, 2, axis=0)[..., None].astype(np.uint8), 9, 8,
        cmap=r.integers(0, 256, 48).astype(np.uint8).tobytes(), cm_len=16, cm_depth=24,
        origin=0x20, seed=4)
    # BMP: every header, palette depth, RLE, bitfields, 16/24/32-bit, top-down
    pal16 = _bgr_palette(r, 16, True)
    out["bmp_rgb24_19x7.bmp"] = bmp_bytes(19, 7, 24, bmp_rows(pattern(7, 19, 21)[..., ::-1], 24))
    out["bmp_rgb24_topdown.bmp"] = bmp_bytes(
        5, -6, 24, bmp_rows(pattern(6, 5, 22)[..., ::-1], 24, top_down=True))
    out["bmp_pal8_clrused.bmp"] = bmp_bytes(10, 6, 8, bmp_rows(r.integers(0, 20, (6, 10)), 8),
                                            palette=_bgr_palette(r, 12, True), colors=12)
    out["bmp_pal4_v5.bmp"] = bmp_bytes(9, 5, 4, bmp_rows(idx[:5], 4), header=124,
                                       palette=pal16)
    out["bmp_pal1_os2.bmp"] = bmp_bytes(21, 4, 1, bmp_rows(r.integers(0, 2, (4, 21)), 1),
                                        header=12, palette=_bgr_palette(r, 2, False))
    out["bmp_rle8.bmp"] = bmp_bytes(13, 6, 8, bmp_rle(r.integers(0, 4, (6, 13)), False, r),
                                    compression=1, palette=pal16, colors=16)
    out["bmp_rle4.bmp"] = bmp_bytes(13, 6, 4, bmp_rle(r.integers(0, 3, (6, 13)), True, r),
                                    compression=2, palette=pal16, colors=16)
    w16 = r.integers(0, 1 << 16, (5, 6)).astype("<u2")
    out["bmp_16bit_555.bmp"] = bmp_bytes(6, 5, 16, bmp_rows(w16.view(np.uint8).reshape(5, 12), 16))
    out["bmp_bitfields565_v3.bmp"] = bmp_bytes(
        6, 5, 16, bmp_rows(w16.view(np.uint8).reshape(5, 12), 16), compression=3,
        masks=(0xF800, 0x07E0, 0x001F), masks_in_header=False)
    out["bmp_bitfields32_rgba_v4.bmp"] = bmp_bytes(
        4, 3, 32, bmp_rows(r.integers(0, 256, (3, 4, 4)).astype(np.uint8), 32), header=108,
        compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out["bmp_bgrx32.bmp"] = bmp_bytes(4, 3, 32,
                                      bmp_rows(r.integers(0, 256, (3, 4, 4)).astype(np.uint8), 32))
    # PNM: P1-P6, ASCII with comments, maxval below and above 255
    out["pbm_p1_plain.pbm"] = pnm_bytes(1, r.integers(0, 2, (5, 11)), comments=True, seed=4)
    out["pbm_p4_raw.pbm"] = pnm_bytes(4, r.integers(0, 2, (6, 13)))
    out["pgm_p2_maxval100.pgm"] = pnm_bytes(2, r.integers(0, 101, (4, 7)), 100, True, seed=5)
    out["pgm_p5_maxval1000.pgm"] = pnm_bytes(5, r.integers(0, 1001, (4, 7)), 1000)
    out["ppm_p3_plain.ppm"] = pnm_bytes(3, r.integers(0, 256, (3, 5, 3)), 255, seed=6)
    out["ppm_p6_maxval1000.ppm"] = pnm_bytes(6, r.integers(0, 1001, (4, 5, 3)), 1000)
    out["ppm_p6_maxval31.ppm"] = pnm_bytes(6, r.integers(0, 32, (4, 5, 3)), 31, seed=7)
    # GIF: global and local palettes, interlaced, transparency, a frame off
    # the screen origin, small code sizes, clear codes, a full code table
    pal256 = r.integers(0, 256, (256, 3))
    out["gif_global_interlaced.gif"] = gif_bytes(r.integers(0, 256, (21, 10)), pal256,
                                                 interlace=True, clear_every=40)
    out["gif_local_4colour.gif"] = gif_bytes(r.integers(0, 4, (7, 9)), r.integers(0, 256, (4, 3)),
                                             local=True, min_code=2)
    out["gif_offset_transparent.gif"] = gif_bytes(
        r.integers(0, 8, (3, 4)), r.integers(0, 256, (8, 3)), screen=(7, 6), offset=(2, 1),
        transparency=5, background=3, min_code=3, extensions=b"!\xfe\x05hello\x00")
    out["gif_offset_background.gif"] = gif_bytes(
        r.integers(0, 8, (2, 3)), r.integers(0, 256, (8, 3)), screen=(5, 4), offset=(1, 1),
        background=6, min_code=3, version=b"GIF87a")
    out["gif_full_table.gif"] = gif_bytes(r.integers(0, 3, (64, 80)), pal256[:4], min_code=2)
    # PSD: each colour mode, raw and PackBits
    grey = pattern(6, 9, 23)[..., 0]
    out["psd_rgb_packbits.psd"] = psd_bytes(np.moveaxis(pattern(7, 10, 24), 2, 0), 3, seed=8)
    out["psd_rgba_raw.psd"] = psd_bytes(r.integers(0, 256, (4, 5, 6)), 3, compression=0)
    out["psd_cmyk_packbits.psd"] = psd_bytes(r.integers(0, 256, (4, 5, 7)), 4, seed=9)
    out["psd_grey_raw.psd"] = psd_bytes(grey[None], 1, compression=0)
    out["psd_indexed_packbits.psd"] = psd_bytes(
        r.integers(0, 256, (1, 6, 8)), 2, color_data=r.integers(0, 256, 768).astype(
            np.uint8).tobytes(), seed=10)
    out["psd_bitmap.psd"] = psd_bytes(r.integers(0, 256, (1, 5, 2)), 0, bits=1, seed=11)
    out["psd_duotone.psd"] = psd_bytes(grey[None], 8, color_data=bytes(20), seed=12)
    out["psd_multichannel.psd"] = psd_bytes(r.integers(0, 256, (2, 4, 5)), 7, compression=0)
    return out


def tiff_fixtures(r):
    """TIFFs written by ``tiff_bytes`` in the forms of ``akari_torch/core/
    tiff.py`` that Pillow's writer does not make: both byte orders,
    BigTIFF, tiles, planar configuration 2, 16-bit and float samples with
    predictors, associated alpha, 4-bit palettes, subsampled YCbCr in
    Deflate and in JPEG strips with a JPEGTables tag, the old LZW codes,
    fill order 2 and an orientation that swaps the axes."""
    out = {}
    px = pattern(21, 18, 30)
    out["tiff_rgb8_raw_tiled_be.tif"] = tiff_bytes(px, 8, 2, order=">", tile=(16, 16))
    out["tiff_rgb16_deflate_pred2_be.tif"] = tiff_bytes(
        px.astype(np.int64) * 257 + r.integers(0, 256, px.shape), 16, 2, order=">",
        compression=8, predictor=2, rows_per_strip=8)
    rgba = np.concatenate([px, r.choice([0, 255, 77, 160], (21, 18, 1))], axis=2)
    out["tiff_rgba_assoc_lzw_planar.tif"] = tiff_bytes(rgba, 8, 2, compression=5, planar=2,
                                                     extra=(1,), rows_per_strip=7)
    out["tiff_grey16_packbits_be.tif"] = tiff_bytes(r.integers(0, 600, (13, 9, 1)), 16, 1,
                                                  order=">", compression=32773, seed=3)
    out["tiff_palette4_lzw_compat.tif"] = tiff_bytes(
        r.integers(0, 16, (11, 14, 1)), 4, 3, compression=5, compat=True,
        colormap=r.integers(0, 65536, 48).tolist())
    out["tiff_float32_pred3_lzw.tif"] = tiff_bytes(
        r.normal(120, 90, (9, 12, 1)).astype(np.float32), 32, 1, compression=5, predictor=3,
        sample_format=3)
    out["tiff_ycbcr22_deflate.tif"] = tiff_bytes(px, 8, 6, compression=8, ycbcr=(2, 2),
                                               rows_per_strip=6)
    blocks, tables = tiff_jpeg_blocks(px, rows=16)
    out["tiff_ycbcr420_jpeg_tables.tif"] = tiff_bytes(
        np.zeros_like(px), 8, 6, compression=7, rows_per_strip=16, blocks=blocks,
        tags={347: (7, tables), 530: (3, [2, 2])})
    out["tiff_bigtiff_lzw_pred2.tif"] = tiff_bytes(px, 8, 2, bigtiff=True, compression=5,
                                                 predictor=2, rows_per_strip=5)
    out["tiff_bilevel_fill2_packbits.tif"] = tiff_bytes(r.integers(0, 2, (10, 23, 1)), 1, 0,
                                                      compression=32773, fill=2, seed=4)
    out["tiff_cmyk_raw_orientation6.tif"] = tiff_bytes(r.integers(0, 256, (7, 10, 4)), 8, 5,
                                                     orientation=6)
    return out


def cmyk_jpegs():
    """A CMYK JPEG saved by PIL (Adobe transform 0), and the same stream
    marked YCCK (Adobe transform 2), which libjpeg converts to CMYK."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pattern(19, 26, 31)).convert("CMYK").save(buf, "JPEG", quality=90)
    cmyk = buf.getvalue()
    at = cmyk.index(b"\xff\xeeAdobe") if b"\xff\xeeAdobe" in cmyk else cmyk.index(b"Adobe") - 4
    flag = at + 4 + 11  # the transform byte of the APP14 segment
    return {"cmyk_adobe_q90.jpg": cmyk,
            "ycck_adobe_q90.jpg": cmyk[:flag] + b"\x02" + cmyk[flag + 1:]}


def webp_fixtures():
    """The small WebP fixtures: PIL's writer, then container forms it
    cannot write (built from PIL's own VP8 streams)."""
    import io

    from PIL import Image

    from tools.webp_writers import chunk, random_vp8_frame, riff

    def save(px, **kw):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "WEBP", **kw)
        return buf.getvalue()

    def chunks(data):  # the chunks of a RIFF WebP file, by fourcc
        out, pos = {}, 12
        while pos < len(data):
            size = struct.unpack_from("<I", data, pos + 4)[0]
            out[data[pos:pos + 4]] = data[pos + 8:pos + 8 + size]
            pos += 8 + size + (size & 1)
        return out

    def vp8x(flags, w, h):
        return chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little")
                     + (h - 1).to_bytes(3, "little"))

    r = np.random.default_rng(33)
    rgba = np.concatenate([pattern(19, 25, 34), r.integers(0, 256, (19, 25, 1),
                                                           dtype=np.uint8)], axis=2)
    yy, xx = np.mgrid[0:21, 0:45]
    pal16 = r.integers(0, 256, (16, 3), dtype=np.uint8)[(xx // 3 + yy) % 16]
    pal2 = r.integers(0, 256, (2, 3), dtype=np.uint8)[(xx[:13, :19] ^ yy[:13, :19]) & 1]
    out = {
        "webp_lossy_q75_33x17.webp": save(pattern(17, 33, 35), quality=75),
        "webp_lossy_q0_m0_17x9.webp": save(pattern(9, 17, 36), quality=0, method=0),
        "webp_lossy_q100_m6_64x48.webp": save(pattern(48, 64, 37), quality=100, method=6),
        "webp_lossless_m6_40x30.webp": save(pattern(30, 40, 38), lossless=True, method=6),
        "webp_lossless_m0_31x23.webp": save(pattern(23, 31, 39), lossless=True, method=0,
                                            quality=0),
        "webp_palette16_lossless_45x21.webp": save(pal16, lossless=True),
        "webp_palette2_lossless_19x13.webp": save(pal2, lossless=True),
        "webp_alpha_lossy_q60_25x19.webp": save(rgba, quality=60, alpha_quality=30),
        "webp_icc_exif_24x16.webp": save(pattern(16, 24, 40), quality=80,
                                         icc_profile=b"\0" * 128, exif=b"Exif\0\0MM\0*"),
    }
    buf = io.BytesIO()
    Image.fromarray(pattern(20, 28, 41)).save(
        buf, "WEBP", save_all=True, duration=50, quality=70,
        append_images=[Image.fromarray(pattern(20, 28, 42))])
    out["webp_anim_2frames_28x20.webp"] = buf.getvalue()
    # a raw alpha plane (compression 0, gradient filter) before PIL's VP8 stream
    vp8 = chunks(save(pattern(12, 16, 43), quality=50))[b"VP8 "]
    alph = bytes([0x0C]) + r.integers(0, 256, 12 * 16, dtype=np.uint8).tobytes()
    out["webp_alpha_raw_16x12.webp"] = riff(vp8x(0x10, 16, 12), chunk(b"ALPH", alph),
                                            chunk(b"VP8 ", vp8))
    # an animation whose first frame (lossless, 20 x 16) sits at (4, 6) of 40 x 30
    frame = chunks(save(pattern(16, 20, 44), lossless=True))[b"VP8L"]
    anmf = b"".join(v.to_bytes(3, "little") for v in (2, 3, 19, 15, 100)) + b"\0" \
        + chunk(b"VP8L", frame)  # x / 2, y / 2, width - 1, height - 1, duration, flags
    out["webp_anim_offset_40x30.webp"] = riff(
        vp8x(0x12, 40, 30), chunk(b"ANIM", struct.pack("<IH", 0xFF000000, 0)),
        chunk(b"ANMF", anmf))
    out["webp_vp8_random_29x37.webp"] = riff(chunk(b"VP8 ", random_vp8_frame(
        45, 37, 29, simple=True, level=30, sharpness=3, log2_parts=2)))
    return out


def dds_fixtures():
    """The small DDS, BLP and FTEX fixtures: Pillow's DDS writer (DXT1 /
    DXT3 / DXT5, BC5, the uncompressed forms), Pillow's BLP writer
    (palette BLP1 and BLP2), then the forms it cannot write, built by
    ``tools/dds_writers.py``: BC1 / BC7 encodings with full mip chains,
    drawn blocks of every BCn form (BC1 with 3-colour blocks, BC5 signed,
    BC6H UF16 / SF16 of every mode, BC7 of every mode), the DX10 header's
    BC2-BC4 and R8G8B8A8 codes, mask forms, a palette DDS, BLP1 JPEG and
    BLP2 DXT1 / DXT3 / DXT5, FTEX DXT1 and raw."""
    import io

    from PIL import Image

    from tools import dds_writers as dw

    def pil_dds(px, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(px).convert(mode).save(buf, "DDS", **kw)
        return buf.getvalue()

    def pil_blp(px, version):
        buf = io.BytesIO()
        Image.fromarray(px).convert("P").save(buf, "BLP", blp_version=version)
        return buf.getvalue()

    r = np.random.default_rng(46)

    def blocks(w, h, form):
        return dw.random_blocks(r, -(-w // 4) * -(-h // 4), form)

    bc6 = lambda dxgi: dw.dds_bytes(16, 72, [b"".join(  # noqa: E731 (a row of blocks a mode)
        dw.bc6h_blocks(r, 4, code) for code in dw.BC6H_CODES)], dxgi=dxgi)
    bc7 = b"".join(dw.bc7_blocks(r, 4, m) for m in range(9))
    masks565 = (0xF800, 0x07E0, 0x001F, 0)
    out = {
        "dds_pil_dxt1_21x13.dds": pil_dds(pattern(13, 21, 47), "RGB", pixel_format="DXT1"),
        "dds_pil_dxt5_16x12.dds": pil_dds(pattern(12, 16, 48), "RGBA", pixel_format="DXT5"),
        "dds_pil_bc5_12x8.dds": pil_dds(pattern(8, 12, 49), "RGB", pixel_format="BC5"),
        "dds_pil_rgb_11x9.dds": pil_dds(pattern(9, 11, 50), "RGB"),
        "dds_pil_rgba_10x7.dds": pil_dds(pattern(7, 10, 51), "RGBA"),
        "dds_pil_l_9x6.dds": pil_dds(pattern(6, 9, 52), "L"),
        "dds_pil_la_7x5.dds": pil_dds(pattern(5, 7, 53), "LA"),
        "dds_bc1_mips_32x16.dds": dw.dds_albedo(pattern(16, 32, 54), "BC1"),
        "dds_bc7_srgb_mips_24x20.dds": dw.dds_albedo(pattern(20, 24, 55), "BC7"),
        "dds_dxt1_random_13x7.dds": dw.dds_bytes(13, 7, [blocks(13, 7, "BC1")], fourcc=b"DXT1"),
        "dds_dxt3_random_12x8.dds": dw.dds_bytes(12, 8, [blocks(12, 8, "BC2")], fourcc=b"DXT3"),
        "dds_ati1_random_16x8.dds": dw.dds_bytes(16, 8, [blocks(16, 8, "BC4")], fourcc=b"ATI1"),
        "dds_ati2_random_8x8.dds": dw.dds_bytes(8, 8, [blocks(8, 8, "BC5")], fourcc=b"ATI2"),
        "dds_bc5s_random_9x9.dds": dw.dds_bytes(9, 9, [blocks(9, 9, "BC5")], fourcc=b"BC5S"),
        "dds_dx10_bc6h_uf16_16x72.dds": bc6(95),
        "dds_dx10_bc6h_sf16_16x72.dds": bc6(96),
        "dds_dx10_bc7_modes_16x36.dds": dw.dds_bytes(16, 36, [bc7], dxgi=98),
        "dds_dx10_bc2_unorm_8x4.dds": dw.dds_bytes(8, 4, [blocks(8, 4, "BC2")], dxgi=74),
        "dds_dx10_bc3_typeless_5x6.dds": dw.dds_bytes(5, 6, [blocks(5, 6, "BC3")], dxgi=76),
        "dds_dx10_bc4_unorm_7x4.dds": dw.dds_bytes(7, 4, [blocks(7, 4, "BC4")], dxgi=80),
        "dds_dx10_rgba8_srgb_6x5.dds": dw.dds_bytes(
            6, 5, [r.integers(0, 256, 120, dtype=np.uint8).tobytes()], dxgi=29),
        "dds_mask_r5g6b5_10x6.dds": dw.dds_bytes(
            10, 6, [r.integers(0, 256, 120, dtype=np.uint8).tobytes()], pf_flags=dw.DDPF_RGB,
            bitcount=16, masks=masks565),
        "dds_mask_a4r4g4b4_short_7x5.dds": dw.dds_bytes(  # 5 pixels short: PIL reads zeros
            7, 5, [r.integers(0, 256, 60, dtype=np.uint8).tobytes()],
            pf_flags=dw.DDPF_RGB | dw.DDPF_ALPHAPIXELS, bitcount=16,
            masks=(0x0F00, 0x00F0, 0x000F, 0xF000)),
        "dds_palette_9x7.dds": dw.dds_header(9, 7, pf_flags=dw.DDPF_PALETTEINDEXED8, bitcount=8)
        + r.integers(0, 256, 1024 + 63, dtype=np.uint8).tobytes(),
        "blp1_pil_palette_12x10.blp": pil_blp(pattern(10, 12, 56), "BLP1"),
        "blp2_pil_palette_15x9.blp": pil_blp(pattern(9, 15, 57), "BLP2"),
        "blp2_dxt1_alpha_14x8.blp": dw.blp2_bytes(14, 8, [blocks(14, 8, "BC1")],
                                                  alpha_depth=1, alpha_encoding=0),
        "blp2_dxt3_16x8.blp": dw.blp2_bytes(16, 8, [blocks(16, 8, "BC2")], alpha_depth=8,
                                            alpha_encoding=1),
        "blp2_dxt5_noalpha_10x6.blp": dw.blp2_bytes(10, 6, [blocks(10, 6, "BC3")],
                                                    alpha_encoding=7),
        "ftex_dxt1_18x10.ftc": dw.ftex_bytes(18, 10, 0, [blocks(18, 10, "BC1"), bytes(8)]),
        "ftex_raw_7x5.ftu": dw.ftex_bytes(7, 5, 1, [pattern(5, 7, 58).tobytes()]),
    }
    buf = io.BytesIO()
    Image.fromarray(pattern(16, 24, 59)).save(buf, "JPEG", quality=85)
    jpeg = buf.getvalue()
    sos = jpeg.index(b"\xff\xda")
    out["blp1_jpeg_24x16.blp"] = dw.blp1_bytes(24, 16, [jpeg[sos:]], compression=0,
                                               jpeg_header=jpeg[:sos])
    return out


def legacy_fixtures():
    """The ICO / CUR, QOI, SGI, PCX and LZMA / ZSTD TIFF fixtures: Pillow's
    writers (ICO with a PNG and a BMP entry and the BMP one's CUR twin, QOI,
    raw SGI, PCX, TIFF with ``compression`` "zstd" / "lzma") and
    ``tools/legacy_writers.py``'s (ICO and CUR entry sets, every QOI op,
    RLE SGI, PCX forms Pillow does not write), tiles, planes and the
    floating-point predictor through ``tiff_bytes`` (``.tiff``, apart from
    ``tiff_fixtures``' ``.tif`` files), and ``ZSTD_ALBEDO``: the config-3
    albedo at 64^2 scaled up 32x by repetition to 2048^2, saved by Pillow
    as a ZSTD TIFF with the horizontal predictor (71 KB: compressed blocks,
    raw and 4-stream Huffman literals, blocks without sequences, and
    predefined, RLE, FSE and repeat sequence tables)."""
    import io

    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture
    from tools import legacy_writers as lw

    def pil(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    r = np.random.default_rng(60)
    square = Image.fromarray(pattern(24, 24, 61))
    out = {}
    for fmt in ("png", "bmp"):
        out[f"ico_pil_{fmt}_24x24.ico"] = pil(square, "ICO", sizes=[(24, 24)], bitmap_format=fmt)
    cur = bytearray(out["ico_pil_bmp_24x24.ico"])
    cur[2] = 2  # the same bytes as a CUR
    out["cur_pil_bmp_24x24.cur"] = bytes(cur)
    quads = lambda n: np.concatenate([r.integers(0, 256, (n, 3)), np.zeros((n, 1), int)],
                                     1).astype(np.uint8).tobytes()
    px = pattern(16, 16, 62)
    entries = [
        (16, 16, 2, 1, lw.dib_entry(r.integers(0, 2, (16, 16)), 1, quads(2))),
        (16, 16, 16, 4, lw.dib_entry(r.integers(0, 16, (16, 16)), 4, quads(16))),
        (16, 16, 0, 8, lw.dib_entry(r.integers(0, 256, (16, 16)), 8, quads(256))),
        (16, 16, 0, 24, lw.dib_entry(px[..., ::-1], 24, mask=r.integers(0, 2, (16, 16)))),
        (16, 16, 0, 32, pil(Image.fromarray(px), "PNG")),
        (8, 8, 0, 32, lw.dib_entry(np.concatenate([pattern(8, 8, 63), r.integers(
            0, 256, (8, 8, 1)).astype(np.uint8)], 2), 32)),
    ]
    out["ico_depths_16x16.ico"] = lw.icon_bytes(entries)  # PIL reads the 1-bit entry
    out["ico_24bit_9x7.ico"] = lw.icon_bytes(
        [(9, 7, 0, 24, lw.dib_entry(pattern(7, 9, 64), 24)),
         (5, 5, 0, 32, lw.dib_entry(r.integers(0, 256, (5, 5, 4)), 32))])
    out["cur_8bit_12x10.cur"] = lw.icon_bytes(
        [(6, 6, 0, 3, lw.dib_entry(r.integers(0, 4, (6, 6)), 8, quads(4))),
         (12, 10, 0, 5, lw.dib_entry(r.integers(0, 256, (10, 12)), 8, quads(256)))], kind=2)
    rgba = np.concatenate([pattern(21, 17, 65), r.integers(0, 2, (21, 17, 1)).astype(
        np.uint8) * 255], 2)
    rgba[3:6] = rgba[3, 0]
    out["qoi_pil_rgb_19x23.qoi"] = pil(Image.fromarray(pattern(19, 23, 66)), "QOI")
    out["qoi_ops_rgba_21x17.qoi"] = lw.qoi_bytes(rgba, r=np.random.default_rng(67))
    out["sgi_pil_rgb16_13x11.sgi"] = pil(Image.fromarray(pattern(11, 13, 68)), "SGI", bpc=2)
    planes = r.integers(0, 3, (4, 9, 14)) * 100
    planes[:, 2:5] = planes[:, 2:3, :1]
    out["sgi_rle_rgba_14x9.rgba"] = lw.sgi_bytes(planes, 1, True)
    out["sgi_rle16_l_10x8.bw"] = lw.sgi_bytes(r.integers(0, 4, (1, 8, 10)) * 20000, 2, True)
    out["pcx_pil_rgb_15x9.pcx"] = pil(Image.fromarray(pattern(9, 15, 69)), "PCX")
    out["pcx_pil_p8_33x21.pcx"] = pil(Image.fromarray(pattern(21, 33, 70)).convert("P"), "PCX")
    out["pcx_pil_1bit_19x6.pcx"] = pil(Image.fromarray(pattern(6, 19, 71)).convert("1"), "PCX")
    out["pcx_4planes_21x9.pcx"] = lw.pcx_bytes(r.integers(0, 16, (9, 21)), 1, 4,
                                               palette=r.integers(0, 256, (16, 3)))
    out["pcx_grey_ramp_40x30.pcx"] = lw.pcx_bytes(
        r.integers(0, 4, (30, 40)) * 60, 8, 1, vga=np.repeat(np.arange(256), 3).reshape(256, 3))
    tif = Image.fromarray(pattern(23, 19, 72))
    out["tiff_pil_rgb8_zstd.tif"] = pil(tif, "TIFF", compression="zstd")
    out["tiff_pil_la_lzma_pred2.tif"] = pil(tif.convert("LA"), "TIFF", compression="lzma",
                                            tiffinfo={317: 2})
    out["tiff_zstd_tiles_rgb16_be.tiff"] = tiff_bytes(r.integers(0, 65536, (21, 18, 3)), 16, 2,
                                                     order=">", compression=50000, predictor=2,
                                                     tile=(16, 16), seed=3)
    out["tiff_lzma_planar_rgb_pred2.tiff"] = tiff_bytes(pattern(13, 11, 73), 8, 2,
                                                       compression=34925, predictor=2,
                                                       planar=2, rows_per_strip=5)
    out["tiff_zstd_fp32_pred3.tiff"] = tiff_bytes(
        r.normal(0, 100, (9, 14, 1)).astype(np.float32), 32, 1, compression=50000, predictor=3,
        sample_format=3, seed=5)
    big = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    out[ZSTD_ALBEDO] = pil(Image.fromarray(big), "TIFF", compression="zstd", tiffinfo={317: 2})
    return out


def jpeg_form_fixtures():
    """The arithmetic-coded, lossless and cut progressive JPEG fixtures:
    ``tools/jpeg_writers.py``'s SOF9 and SOF10 files (4:4:4, 4:2:0 and mixed
    sampling, grey; restart intervals; DAC conditioning), its SOF3 files
    (grey and RGB, predictors 1, 4, 5 and 7, point transforms, restarts, a
    2x2 / 1x1 / 1x1 frame), PIL progressive files cut after a scan (grey,
    4:4:4, 4:2:0), and ``ALBEDO_CUT``."""
    import io

    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture
    from tools import jpeg_writers as jw

    def pil(px, **kw):
        b = io.BytesIO()
        Image.fromarray(px).save(b, "JPEG", **kw)
        return b.getvalue()

    adobe_rgb = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    out = {}
    px = pattern(37, 45, 80)
    c420 = jw.pixel_coefficients(px, [(2, 2), (1, 1), (1, 1)], 75)
    out["arith_seq_420_45x37.jpg"] = jw.arith_jpeg(*c420)
    c444 = jw.pixel_coefficients(pattern(29, 33, 81), [(1, 1)] * 3, 90)
    out["arith_seq_444_rst_dac_33x29.jpg"] = jw.arith_jpeg(
        *c444, restart=3, dac=[(0, 0, 0x52), (1, 0, 2), (0, 1, 0x31), (1, 1, 40)])
    cmix = jw.pixel_coefficients(pattern(40, 48, 82), [(2, 1), (1, 1), (1, 2)], 60)
    out["arith_prog_mixed_48x40.jpg"] = jw.arith_jpeg(*cmix, script=jw.PROGRESSION)
    out["arith_prog_420_rst_45x37.jpg"] = jw.arith_jpeg(*c420, script=jw.PROGRESSION, restart=2,
                                                        dac=[(1, 0, 1), (1, 1, 63)])
    grey = jw.pixel_coefficients(pattern(35, 21, 83)[..., 0], [(1, 1)], 85)
    out["arith_prog_grey_21x35.jpg"] = jw.arith_jpeg(*grey, script=jw.PROGRESSION_GREY,
                                                     restart=4)
    g = pattern(21, 27, 84)
    out["lossless_grey_psv1_27x21.jpg"] = jw.lossless_jpeg([g[..., 0]], [(1, 1, 1)], (21, 27), 1)
    out["lossless_grey_psv4_pt2_rst_27x21.jpg"] = jw.lossless_jpeg(
        [g[..., 1]], [(1, 1, 1)], (21, 27), 4, pt=2, restart_rows=2)
    rgb = pattern(19, 23, 85)
    out["lossless_rgb_psv7_23x19.jpg"] = jw.lossless_jpeg(
        [rgb[..., i] for i in range(3)], [(1, 1, 1), (2, 1, 1), (3, 1, 1)], (19, 23), 7)
    out["lossless_420_psv5_pt1_rst_23x19.jpg"] = jw.lossless_jpeg(
        [rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]], [(1, 2, 2), (2, 1, 1), (3, 1, 1)],
        (19, 23), 5, pt=1, restart_rows=3, app=adobe_rgb)
    prog = pil(pattern(40, 48, 86), quality=80, progressive=True, subsampling=2)
    out["prog_420_cut3_48x40.jpg"] = jw.cut_progressive(prog, 3)
    prog = pil(pattern(33, 26, 87), quality=90, progressive=True, subsampling=0)
    out["prog_444_cut5_26x33.jpg"] = jw.cut_progressive(prog, 5)
    prog = pil(pattern(17, 50, 88)[..., 0], quality=70, progressive=True)
    out["prog_grey_cut1_50x17.jpg"] = jw.cut_progressive(prog, 1)
    out[ALBEDO_CUT] = jw.cut_progressive(pil(envtex_texture(2048, 0), quality=85,
                                             progressive=True, subsampling=2), 6)
    return out


def fax_fixtures():
    """The CCITT, ThunderScan and old-style JPEG TIFF fixtures: Pillow's
    libtiff writer in its four CCITT compressions (group3, group4,
    tiff_ccitt, tiff_raw_16) on a 53 x 37 bilevel image, and
    ``tools/tiff_writers.py``'s strips: MH with fill order 2, fill bits and
    an RTC; MR with drawn codes; MMR in strips and in tiles with EOFBs; RLE
    of a palette image; RLEW at odd offsets; ThunderScan with every opcode,
    grey and palette; old-style JPEG in the interchange form (4:2:0), the
    header form (4:4:4, a strip an MCU row, libtiff's RSTs between them),
    the tables form (4:2:2 with restart intervals) and grey."""
    import io

    from PIL import Image

    from tools import tiff_writers as tw

    def pil(img, **kw):
        b = io.BytesIO()
        img.save(b, "TIFF", **kw)
        return b.getvalue()

    r = np.random.default_rng(19)
    out = {}
    bits = Image.fromarray(pattern(37, 53, 90)).convert("1")
    for comp in ("group3", "group4", "tiff_ccitt", "tiff_raw_16"):
        out[f"tiff_pil_{comp}_53x37.tif"] = pil(bits, compression=comp)
    b = (pattern(29, 71, 91)[..., 0] > 120).astype(np.uint8)
    out["tiff_mh_fill2_fillbits_rtc_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 0, fill=2, compression=3, rows_per_strip=10,
        blocks=[tw.fax_strip(b[y:y + 10], 3, fill_bits=True, rtc=True, fill=2)
                for y in range(0, 29, 10)], tags={292: (4, [tw.fax_options(fill_bits=True)])})
    out["tiff_mr_drawn_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 1, compression=3, blocks=[tw.fax_strip(b, 3, two_d=True, k=3, r=r)],
        tags={292: (4, [tw.fax_options(two_d=True)])})
    out["tiff_mmr_strips_eofb_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 0, compression=4, rows_per_strip=8,
        blocks=[tw.fax_strip(b[y:y + 8], 4, eofb=True, r=r) for y in range(0, 29, 8)])
    pad = np.zeros((32, 96), np.uint8)
    pad[:29, :71] = b
    out["tiff_mmr_tiled_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 0, compression=4, tile=(48, 16),
        blocks=[tw.fax_strip(pad[y:y + 16, x:x + 48], 4) for y in (0, 16) for x in (0, 48)])
    out["tiff_rle_palette1_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 3, compression=2, colormap=r.integers(0, 65536, 6).tolist(),
        blocks=[tw.fax_strip(b, 2)])
    out["tiff_rlew_strips_71x29.tif"] = tiff_bytes(
        b[..., None], 1, 0, compression=32771, rows_per_strip=5,
        blocks=[tw.fax_strip(b[y:y + 5], 32771) + b"\0" * (y % 2) for y in range(0, 29, 5)])
    p4 = pattern(23, 41, 92)[..., 0] // 16
    out["tiff_thunder_grey4_41x23.tif"] = tiff_bytes(
        p4[..., None], 4, 1, compression=32809, rows_per_strip=12,
        blocks=[tw.thunder_rows(p4[:12], r), tw.thunder_rows(p4[12:], r)])
    out["tiff_thunder_palette4_41x23.tif"] = tiff_bytes(
        p4[..., None], 4, 3, compression=32809, colormap=r.integers(0, 65536, 48).tolist(),
        blocks=[tw.thunder_rows(p4)])
    px = pattern(37, 45, 93)
    jpegs = {}
    for ss, kw in ((2, {}), (0, {"restart_marker_rows": 1}), (1, {"restart_marker_blocks": 4})):
        b_ = io.BytesIO()
        Image.fromarray(px).save(b_, "JPEG", quality=80, subsampling=ss, **kw)
        jpegs[ss] = b_.getvalue()
    out["tiff_ojpeg_interchange_420_45x37.tif"] = tw.ojpeg_tiff(jpegs[2], "interchange")
    out["tiff_ojpeg_header_444_strips_45x37.tif"] = tw.ojpeg_tiff(jpegs[0], "header",
                                                               rows_per_strip=8)
    out["tiff_ojpeg_tables_422_rst_45x37.tif"] = tw.ojpeg_tiff(jpegs[1], "tables",
                                                            restart_tag=4)
    b_ = io.BytesIO()
    Image.fromarray(px).convert("L").save(b_, "JPEG", quality=75)
    out["tiff_ojpeg_grey_45x37.tif"] = tw.ojpeg_tiff(b_.getvalue(), "tables", photometric=1)
    return out


def jpeg2000_fixtures():
    """The JPEG 2000 fixtures: Pillow's writer through every option it takes
    (irreversible, tiles and offsets, resolutions, code-blocks, precincts,
    progressions, quality layers, mct, PLT, raw codestreams), and
    ``tools/j2k_writers.py``: OpenJPEG's encoder for the code-block styles,
    POC, tile-parts, ROI, subsampled (sYCC by Pillow's rule), signed and 1, 4,
    12 and 16-bit components, SOP / EPH, PLT / TLM and PPM / PPT; JP2 boxes
    for grey, sYCC, CMYK, ICC, ``pclr`` / ``cmap`` (RGB and RGBA palettes
    with repeated colours, indices past the palette), ``cdef``, ``res ``,
    ``bpcc`` and boxes OpenJPEG skips; and the two 2048^2 albedos."""
    import io

    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture
    from tools import j2k_writers as jw

    def pil(px, **kw):
        b = io.BytesIO()
        Image.fromarray(px).save(b, "JPEG2000", **kw)
        return b.getvalue()

    r = np.random.default_rng(80)

    def planes(h, w, n, seed):
        return [pattern(h, w, seed + c)[..., c % 3].astype(np.int64) for c in range(n)]

    px = pattern(37, 29, 81)
    out = {
        "j2k_pil_rgb_29x37.j2k": pil(px, no_jp2=True),
        "j2k_pil_irrev_rpcl_prec_29x37.j2k": pil(
            px, no_jp2=True, irreversible=True, progression="RPCL", precinct_size=(16, 16),
            codeblock_size=(16, 16), num_resolutions=4, quality_layers=[30, 10, 3], mct=1),
        "j2k_pil_tiles_offsets_cprl_29x37.j2k": pil(
            px, no_jp2=True, tile_size=(13, 11), tile_offset=(2, 3), offset=(5, 7),
            progression="CPRL", num_resolutions=3, mct=1),
        "j2k_pil_pcrl_rlcp_plt_grey_40x33.j2k": pil(
            pattern(33, 40, 82)[..., 0], no_jp2=True, progression="PCRL", plt=True,
            quality_layers=[20, 0]),
        "jp2_pil_rgb_29x37.jp2": pil(px),
        "jp2_pil_rgba_irrev_rlcp_31x26.jp2": pil(
            np.concatenate([pattern(26, 31, 83), r.integers(0, 256, (26, 31, 1)).astype(
                np.uint8)], 2), irreversible=True, progression="RLCP", quality_layers=[12, 4]),
    }
    b = io.BytesIO()
    Image.fromarray(pattern(23, 19, 84)).convert("LA").save(b, "JPEG2000")
    out["jp2_pil_la_19x23.jp2"] = b.getvalue()
    pl = planes(41, 35, 3, seed=85)
    out["j2k_styles_all_irrev_layers_35x41.j2k"] = jw.encode(
        pl, mode=63, irreversible=True, rates=(20, 8, 3), cblk=(16, 8), mct=1)
    out["j2k_bypass_termall_vsc_35x41.j2k"] = jw.encode(
        pl, mode=jw.BYPASS | jw.TERMALL | jw.VSC, cblk=(8, 16), rates=(10, 0))
    out["j2k_reset_pterm_segsym_35x41.j2k"] = jw.encode(
        pl, mode=jw.RESET | jw.PTERM | jw.SEGSYM, irreversible=True, rates=(6,))
    out["j2k_poc_rlcp_cprl_35x41.j2k"] = jw.encode(
        pl, poc=[(0, 0, 2, 3, 3, "RLCP", 1), (3, 0, 2, 6, 3, "CPRL", 1)], rates=(10, 0))
    out["j2k_tileparts_r_tiles_35x41.j2k"] = jw.encode(
        pl, tile=(16, 16), num_resolutions=3, tile_parts="R", rates=(12, 0), mct=1)
    out["j2k_roi_shift_35x41.j2k"] = jw.encode(pl, roi=(1, 6), rates=(15, 0))
    full = planes(34, 30, 1, seed=86)[0]
    out["j2k_sub420_sycc_30x34.j2k"] = jw.encode(
        [full, full[::2, ::2], full[1::2, 1::2]], dx=[1, 2, 2], dy=[1, 2, 2])
    out["j2k_sub422_odd_offset_29x34.j2k"] = jw.encode(
        [full[:, :29], full[:, 1:29:2], full[:, 2:30:2]], dx=[1, 2, 2], dy=[1, 1, 1],
        offset=(1, 0), size=(29, 34))
    out["j2k_signed12_irrev_35x41.j2k"] = jw.encode(
        [p * 16 - 2048 for p in pl], prec=12, sgnd=True, irreversible=True, rates=(4,))
    out["j2k_prec4_rgb_35x41.j2k"] = jw.encode([p // 16 for p in pl], prec=4)
    out["j2k_prec1_grey_35x41.j2k"] = jw.encode([pl[0] // 128], prec=1)
    out["j2k_grey16_i16_35x41.j2k"] = jw.encode([pl[1] * 2 + pl[0] % 3], prec=16)
    out["j2k_la_prec10_35x41.j2k"] = jw.encode([pl[0] * 4, pl[2] * 4], prec=10)
    out["j2k_rgba_tiles_pcrl_35x41.j2k"] = jw.encode(
        pl + [pl[0][::-1]], tile=(20, 24), num_resolutions=3, progression="PCRL")
    sop = jw.encode(planes(32, 36, 3, seed=87), sop=True, eph=True, rates=(10, 0),
                    tile=(16, 16), num_resolutions=3)
    out["j2k_sop_eph_plt_tlm_36x32.j2k"] = jw.encode(
        planes(32, 36, 3, seed=87), sop=True, eph=True, rates=(10, 0), tile=(16, 16),
        num_resolutions=3, extra=("PLT=YES", "TLM=YES"))
    out["j2k_ppm_36x32.j2k"] = jw.to_ppm(sop, 2)
    out["j2k_ppt_36x32.j2k"] = jw.to_ppt(sop, 2)
    cs = jw.encode(pl)
    idx = r.integers(0, 14, (23, 19))
    pal = r.integers(0, 256, (12, 3))
    cmap3 = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    out["jp2_pclr_cmap_19x23.jp2"] = jw.jp2(jw.encode([idx]), 19, 23, 1, pclr=([7, 7, 7], pal),
                                            cmap=cmap3)
    dup = np.concatenate([pal[:5], pal[:2], pal[5:]])
    alpha = np.concatenate([dup, r.integers(0, 256, (len(dup), 1))], 1)
    out["jp2_pclr_rgba_repeats_19x23.jp2"] = jw.jp2(
        jw.encode([idx]), 19, 23, 1, pclr=([7, 7, 7, 7], alpha), cmap=cmap3 + [(0, 1, 3)])
    out["jp2_pa_cdef_19x23.jp2"] = jw.jp2(
        jw.encode([idx, r.integers(0, 256, (23, 19))]), 19, 23, 2, pclr=([7, 7, 7], pal),
        cmap=cmap3, cdef=[(0, 0, 1), (1, 1, 0)])
    out["jp2_cmyk_35x41.jp2"] = jw.jp2(jw.encode(pl + [pl[1][:, ::-1]]), 35, 41, 4, colr=(1, 12))
    out["jp2_sycc_colr18_35x41.jp2"] = jw.jp2(cs, 35, 41, 3, colr=(1, 18))
    out["jp2_icc_odd_boxes_35x41.jp2"] = jw.jp2(
        cs, 35, 41, 3, colr=(2, bytes(range(48))), cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3)],
        res=jw.box(b"resc", struct.pack(">HHHHBB", 72, 1, 72, 1, 0, 0)),
        extra_header=[jw.box(b"zzzz", b"skipped")], ftyp=b"jpx \0\0\0\0jpx jp2 ")
    out["jp2_grey16_bpcc_35x41.jp2"] = jw.jp2(
        jw.encode([pl[2] * 256 + pl[0]], prec=16), 35, 41, 1, bpc=255, colr=(1, 17),
        extra_header=[jw.box(b"bpcc", b"\x0f")])
    out[ALBEDO_JP2] = pil(envtex_texture(2048, 0), irreversible=True, quality_mode="rates",
                          quality_layers=[30], mct=1)
    big = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    out[ALBEDO_J2K] = pil(big, no_jp2=True, mct=1)
    return out


# --------------------------------------------------------------------------
# HTJ2K (Part 15) and the Part-2 MCT / MCC / MCO / CBD markers

def _ramp(h, w, n, seed, noise=6, hi=256, base=0):
    """Seeded gradients with a little noise, ``n`` planes of [h, w]."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip(base + (x * (2 + c) + y * (3 + 2 * c)) * hi // 256 % (hi - base)
                    + r.integers(0, noise * hi // 256 + 1, (h, w)), 0, hi - 1)
            for c in range(n)]


def htj2k_fixtures():
    """The HTJ2K and Part-2 fixtures (a few hundred bytes each: the fixtures'
    size budget has little room)."""
    from tools import j2k_writers as jw

    jph = b"jph \0\0\0\0jph "
    out = {
        "htj2k_grey_cleanup_8x8_20x16.j2c": jw.encode_ht(_ramp(16, 20, 1, 1), cblk=(8, 8)),
        "htj2k_rgb_rct_3pass_16x4_16x12.j2c": jw.encode_ht(_ramp(12, 16, 3, 2, 12),
                                                           cblk=(16, 4), passes=3),
        "htj2k_rgba_97_ict_12x10.jp2": jw.jp2(jw.encode_ht(_ramp(10, 12, 4, 3, 8),
                                                           irreversible=True, cblk=(8, 8),
                                                           step=2.0), 12, 10, 4),
        "htj2k_grey16_12x10.j2c": jw.encode_ht(_ramp(10, 12, 1, 4, 30, 512), prec=16,
                                               cblk=(4, 8)),
        "htj2k_grey_97_sigprop_16x16.j2c": jw.encode_ht(_ramp(16, 16, 1, 5, 60),
                                                        irreversible=True, passes=2, step=0.5),
        "htj2k_grey_128x32_40x36.jph": jw.jp2(
            jw.encode_ht(_ramp(36, 40, 1, 6, 3), cblk=(128, 32), num_resolutions=1),
            40, 36, 1, colr=(1, 17), ftyp=jph),
        "htj2k_grey_vsc_3pass_16x16.j2c": jw.encode_ht(_ramp(16, 16, 1, 7, 3), passes=3,
                                                       cblk_style=0x48, num_resolutions=1),
        "htj2k_grey_placeholders_12x12.j2c": jw.encode_ht(_ramp(12, 12, 1, 8, 6, 256, 100),
                                                          placeholders=1),
    }
    grey = jw.encode(_ramp(12, 10, 1, 9, 0, 256, 140))
    rct = jw.encode(_ramp(10, 8, 3, 10, 0, 256, 140), mct=1)
    out["part2_mco_no_stage_10x12.j2k"] = jw.splice_main(grey, jw.mco())
    out["part2_mct_mcc_mco_offsets_rct_8x10.j2k"] = jw.splice_main(
        rct, jw.mct(1, 1, [90, -30, 40]), jw.mcc(3, 3, offset=1), jw.mco(3))
    out["part2_tile_mco_float_offsets_8x10.j2k"] = jw.splice_tile(
        jw.splice_main(rct, jw.mct(1, 2, [60.9, 20.0, -5.5]), jw.mcc(3, 3, offset=1)),
        jw.mco(3))
    out["part2_cbd_7bit_10x12.j2k"] = jw.splice_main(jw.encode(_ramp(12, 10, 1, 11, 0, 256, 20)),
                                                     jw.cbd(6))
    return out


def htj2k_albedo():
    """``ALBEDO_HTJ2K``: the config-3 albedo at 64^2 scaled up 32x (the
    pixels of ``ALBEDO_J2K``) as a reversible 5/3 + RCT HT codestream of
    64 x 64 cleanup-only code-blocks; its read must be those pixels."""
    from akari_torch.scene.builtin import envtex_texture
    from tools import j2k_writers as jw

    x32 = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    return jw.encode_ht([x32[..., c] for c in range(3)])


# --------------------------------------------------------------------------
# AVIF


_AVIF_WRITER = """
import io, pickle, sys
from PIL import Image
frames, kw = pickle.load(sys.stdin.buffer)
ims = [Image.fromarray(f) for f in frames]
b = io.BytesIO()
ims[0].save(b, "AVIF", append_images=ims[1:], **kw)
sys.stdout.buffer.write(b.getvalue())
"""


def _avif(px, **kw):
    """PIL's AVIF file of ``px`` (an array, or a list of frames for
    ``save_all=True``), written in a subprocess; None where the writer
    crashes or fails."""
    import pickle
    import subprocess

    frames = px if isinstance(px, list) else [px]
    r = subprocess.run([sys.executable, "-c", _AVIF_WRITER], input=pickle.dumps((frames, kw)),
                       capture_output=True)
    return r.stdout if r.returncode == 0 else None


def glyphs(h, w, seed):
    """Screen content: one seeded 8 x 8 glyph stamped in four rotations on a
    flat background, so aom's screen tools copy blocks (intra block copy)."""
    r = np.random.default_rng(seed)
    g = (r.random((8, 8, 3)) > 0.5).astype(np.uint8) * 255
    c = np.full((h, w, 3), int(r.integers(0, 256)), np.uint8)
    for y in range(0, h - 8, 10 + seed % 3):
        for x in range(0, w - 8, 9 + seed % 4):
            c[y:y + 8, x:x + 8] = np.rot90(g, int(r.integers(0, 4)))
    return c


def _flat_colours(h, w, n, seed, cell=16):
    """Rectangles of ``n`` seeded colours: the writer turns on screen
    content tools (palettes) for such images."""
    r = np.random.default_rng(seed)
    cols = r.integers(0, 256, (n, 3))
    idx = (np.arange(h)[:, None] // cell + np.arange(w)[None, :] // (cell + 8)) % n
    return cols[idx].astype(np.uint8)


def _edited_colr(data, matrix, full):
    from tools.avif_writers import Avif

    a = Avif.parse(data)
    a.props = [(t, b"nclx" + struct.pack(">HHHB", 1, 13, matrix, 0x80 if full else 0))
               if t == b"colr" and b[:4] == b"nclx" else (t, b) for t, b in a.props]
    return a.build()


def avif_fixtures():
    """The AVIF fixtures, a few KB each, and ``ALBEDO_AVIF``."""
    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture
    from tools.avif_writers import Avif

    rgba = np.concatenate([pattern(20, 30, 42), pattern(20, 30, 43)[..., :1]], axis=-1)
    exif = Image.Exif()
    exif[0x0112] = 6
    out = {
        "avif_q75_420_61x47.avif": _avif(pattern(47, 61, 40)),
        "avif_q100_444_lossless_33x21.avif": _avif(pattern(21, 33, 41), quality=100,
                                                   subsampling="4:4:4"),
        "avif_q40_422_limited_50x30.avif": _avif(pattern(30, 50, 44), quality=40,
                                                 subsampling="4:2:2", range="limited"),
        "avif_q60_400_40x32.avif": _avif(pattern(32, 40, 45), quality=60, subsampling="4:0:0"),
        "avif_rgba_premultiplied_30x20.avif": _avif(rgba, quality=70, alpha_premultiplied=True),
        "avif_rgba_q90_444_30x20.avif": _avif(rgba, quality=90, subsampling="4:4:4"),
        "avif_palette_screen_128x96.avif": _avif(_flat_colours(96, 128, 6, 46), quality=75),
        "avif_tiles_2x2_q50_128x128.avif": _avif(pattern(128, 128, 47), quality=50,
                                                 tile_rows=1, tile_cols=1),
        "avif_q0_txselect_64x48.avif": _avif(pattern(48, 64, 48), quality=0),
        "avif_speed10_q75_45x37.avif": _avif(pattern(37, 45, 49), speed=10),
        "avif_speed5_q60_limited_39x26.avif": _avif(pattern(26, 39, 50), quality=60, speed=5,
                                                    range="limited"),
        "avif_exif_rot_icc_24x16.avif": _avif(pattern(16, 24, 51), exif=exif.tobytes(),
                                              icc_profile=b"\0" * 128),
    }
    a = Avif.parse(_avif(pattern(12, 20, 52), quality=80))
    a.in_idat.add(a.primary)
    out["avif_idat_20x12.avif"] = a.build()
    base = _avif(pattern(18, 26, 53), quality=85, subsampling="4:4:4")
    out["avif_nclx_bt709_limited_26x18.avif"] = _edited_colr(base, 1, False)
    out["avif_nclx_fcc_26x18.avif"] = _edited_colr(base, 4, True)
    out["avif_nclx_identity_26x18.avif"] = _edited_colr(base, 0, True)
    out[ALBEDO_AVIF] = _avif(envtex_texture(2048, 0), quality=60, speed=6)
    out.update(avif_tool_fixtures())
    out.update(avif_seg_ibc_fixtures())
    out.update(avif_rewrite_fixtures(out))
    out.update(avif_inter_fixtures())
    return out


def avif_rewrite_fixtures(base):
    """The AVIF fixtures of slice 25, header rewrites (``tools/av1_rewrite.py``)
    of fixtures in ``base``: 10- and 12-bit AV1 (4:2:0, 4:2:2 limited,
    4:4:4 with alpha, premultiplied alpha, 4:0:0, film grain, loop
    restoration, quantizer matrices, segmentation), superres at
    denominators 9, 12 and 16 (odd widths among them), and key frames
    hidden in sample 0 of ``avis`` sequences and shown by
    ``show_existing_frame`` (one of them at 10 bits)."""
    from tools.av1_rewrite import hide_key_frame, to_high_bitdepth, to_superres

    hbd = {"avif_hbd10_q75_420_61x47.avif": ("avif_q75_420_61x47.avif", 10),
           "avif_hbd12_q75_420_61x47.avif": ("avif_q75_420_61x47.avif", 12),
           "avif_hbd12_q40_422_limited_50x30.avif": ("avif_q40_422_limited_50x30.avif", 12),
           "avif_hbd10_rgba_q90_444_30x20.avif": ("avif_rgba_q90_444_30x20.avif", 10),
           "avif_hbd12_rgba_q90_444_30x20.avif": ("avif_rgba_q90_444_30x20.avif", 12),
           "avif_hbd10_rgba_premultiplied_30x20.avif": ("avif_rgba_premultiplied_30x20.avif", 10),
           "avif_hbd12_q60_400_40x32.avif": ("avif_q60_400_40x32.avif", 12),
           "avif_hbd10_grain_q30_128x96.avif": ("avif_grain_q30_128x96.avif", 10),
           "avif_hbd12_grain_test5_422_66x35.avif": ("avif_grain_test5_422_66x35.avif", 12),
           "avif_hbd10_lr_wiener_s1_444_96x72.avif": ("avif_lr_wiener_s1_444_96x72.avif", 10),
           "avif_hbd12_lr_sgrproj_s1_444_64x48.avif": ("avif_lr_sgrproj_s1_444_64x48.avif", 12),
           "avif_hbd12_qm_q40_444_64x48.avif": ("avif_qm_q40_444_64x48.avif", 12),
           "avif_hbd10_cdef_q30_96x72.avif": ("avif_cdef_q30_96x72.avif", 10),
           "avis_hbd12_aq1_s6_128x96.avif": ("avis_aq1_s6_128x96.avif", 12)}
    out = {name: to_high_bitdepth(base[src], depth) for name, (src, depth) in hbd.items()}
    out["avif_superres9_q75_420_61x47.avif"] = to_superres(base["avif_q75_420_61x47.avif"], 9)
    out["avif_superres12_q60_400_40x32.avif"] = to_superres(base["avif_q60_400_40x32.avif"], 12)
    out["avif_superres16_cdef_q30_96x72.avif"] = to_superres(base["avif_cdef_q30_96x72.avif"], 16)
    out["avif_superres13_hbd10_grain_q30_128x96.avif"] = to_superres(
        out["avif_hbd10_grain_q30_128x96.avif"], 13)
    out["avis_hidden_aq1_s6_128x96.avif"] = hide_key_frame(base["avis_aq1_s6_128x96.avif"])
    out["avis_hidden_hbd10_3frames_rgba_24x17.avif"] = to_high_bitdepth(
        hide_key_frame(base["avis_3frames_rgba_24x17.avif"]), 10)
    return out


def avif_seg_ibc_fixtures():
    """The AVIF fixtures of the AV1 tools PIL's writer makes through its
    ``advanced`` options that slice 24 reads: delta q (``deltaq-mode=3``),
    delta q with delta lf (``delta-lf-mode=1``), intra block copy
    (``tune-content=screen`` on ``glyphs``) at 4:2:0, 4:2:2, 4:4:4 and
    4:0:0, segmentation (``aq-mode=1``: frame 0 of two-frame ``avis``
    sequences at speeds 0, 4 and 6); and ``ALBEDO_AVIF_AQ``, the 2048^2
    albedo and its vertical flip as such a sequence at speed 6 (its frame 0
    segmented; delta q and intra block copy leave that albedo's frames
    alone)."""
    from akari_torch.scene.builtin import envtex_texture

    tex = envtex_texture(256, 0)
    tex1 = envtex_texture(256, 1)
    text = glyphs(120, 160, 1)
    screen = {"tune-content": "screen"}
    albedo = envtex_texture(2048, 0)
    return {
        "avif_deltaq_q60_128x96.avif": _avif(pattern(96, 128, 7), quality=60,
                                             advanced={"deltaq-mode": "3"}),
        "avif_deltaq_deltalf_q60_160x120.avif": _avif(
            pattern(120, 160, 3), quality=60,
            advanced={"deltaq-mode": "3", "delta-lf-mode": "1"}),
        "avif_intrabc_screen_160x120.avif": _avif(text, quality=60, advanced=screen),
        "avif_intrabc_screen_422_160x120.avif": _avif(text, quality=60, subsampling="4:2:2",
                                                      advanced=screen),
        "avif_intrabc_screen_444_160x120.avif": _avif(text, quality=60, subsampling="4:4:4",
                                                      advanced=screen),
        "avif_intrabc_screen_400_160x120.avif": _avif(text, quality=60, subsampling="4:0:0",
                                                      advanced=screen),
        "avis_aq1_s0_96x72.avif": _avif([pattern(72, 96, 5), pattern(72, 96, 5)[::-1].copy()],
                                        save_all=True, quality=60, speed=0,
                                        advanced={"aq-mode": "1"}),
        "avis_aq1_s4_128x96.avif": _avif([tex[:96, :128].copy(), tex[:96, :128][::-1].copy()],
                                         save_all=True, quality=60, speed=4,
                                         advanced={"aq-mode": "1"}),
        "avis_aq1_s6_128x96.avif": _avif([tex1[:96, :128].copy(), tex1[:96, :128][::-1].copy()],
                                         save_all=True, quality=60, speed=6,
                                         advanced={"aq-mode": "1"}),
        ALBEDO_AVIF_AQ: _avif([albedo, albedo[::-1].copy()], save_all=True, quality=60, speed=6,
                              advanced={"aq-mode": "1"}),
    }


def avif_tool_fixtures():
    """The AVIF fixtures of the AV1 tools PIL's writer turns on at speeds 0-4
    or through its ``advanced`` options (CDEF, quantizer matrices, film
    grain, loop restoration), a three-frame ``avis`` sequence with alpha,
    a 3 x 2 ``grid`` cropped to its output size, and ``ALBEDO_AVIF_TOOLS``
    (the 2048^2 albedo with CDEF, quantizer matrices, film grain and, at
    speed 4, switchable loop restoration)."""
    from akari_torch.scene.builtin import envtex_texture
    from tools.avif_writers import grid

    tex = envtex_texture(256, 0)
    rgba = [np.concatenate([pattern(17, 24, i), pattern(17, 24, 9 + i)[..., :1]], axis=-1)
            for i in range(3)]
    out = {
        "avif_cdef_q30_96x72.avif": _avif(tex[:72, :96].copy(), quality=30,
                                          advanced={"enable-cdef": "1"}),
        "avif_qm_q40_444_64x48.avif": _avif(tex[:48, :64].copy(), quality=40,
                                            subsampling="4:4:4", advanced={"enable-qm": "1"}),
        "avif_grain_q30_128x96.avif": _avif(tex[:96, :128].copy(), quality=30,
                                            advanced={"denoise-noise-level": "10"}),
        "avif_grain_test5_422_66x35.avif": _avif(tex[:35, :66].copy(), quality=50,
                                                 subsampling="4:2:2",
                                                 advanced={"film-grain-test": "5"}),
        "avif_lr_wiener_s1_444_96x72.avif": _avif(pattern(72, 96, 7), quality=30, speed=1,
                                                  subsampling="4:4:4"),
        "avif_lr_sgrproj_s1_444_64x48.avif": _avif(tex[:48, :64].copy(), quality=70, speed=1,
                                                   subsampling="4:4:4"),
        "avis_3frames_rgba_24x17.avif": _avif(rgba, save_all=True, quality=70),
        "avif_grid_3x2_180x100.avif": grid([_avif(pattern(64, 64, 60 + k), quality=50)
                                            for k in range(6)], 2, 3, 180, 100),
        ALBEDO_AVIF_TOOLS: _avif(envtex_texture(2048, 0), quality=60, speed=4,
                                 advanced={"enable-cdef": "1", "enable-qm": "1",
                                           "denoise-noise-level": "10"}),
    }
    return out


def motion_frames(kind, n, h, w, seed):
    """``n`` frames of ``pattern`` content in motion: ``shift`` (whole
    pixels, 3 down and 5 across a frame), ``sub`` (the shift averaged with
    a one-pixel shift: half pixels), ``zoom`` (3 % a frame, about the
    centre), ``occl`` (a 2-pixel pan under a flat patch moving against
    it), ``scene`` (flat colours of another layout each frame: intra
    blocks, palettes under screen content tools)."""
    base = pattern(h + 40 + 6 * n, w + 40 + 6 * n, seed)
    out = []
    for k in range(n):
        if kind == "shift":
            f = base[3 * k:3 * k + h, 5 * k:5 * k + w]
        elif kind == "sub":
            a = base[3 * k:3 * k + h, 5 * k:5 * k + w].astype(np.uint16)
            f = ((a + base[3 * k:3 * k + h, 5 * k + 1:5 * k + 1 + w]) // 2).astype(np.uint8)
        elif kind == "zoom":
            ys = (np.arange(h) * (1 - 0.03 * k) + 10 * k).astype(int)
            xs = (np.arange(w) * (1 - 0.03 * k) + 10 * k).astype(int)
            f = base[ys][:, xs]
        elif kind == "occl":
            f = base[2 * k:2 * k + h, 2 * k:2 * k + w].copy()
            f[30 + 6 * k:60 + 6 * k, 40 + 8 * k:80 + 8 * k] = (200, 40, 90)
        else:
            f = _flat_colours(h, w, 5 + k, seed + k, cell=8 + 4 * k)
        out.append(np.ascontiguousarray(f))
    return out


def avif_inter_fixtures():
    """The AVIF fixtures of slice 26: ``avis`` sequences of PIL's writer
    whose samples ``tools/av1_rewrite.py::splice_frames`` makes into inter
    frame 0 (speeds 0-10; 4:2:0, 4:2:2, 4:4:4, 4:0:0 and alpha; whole- and
    sub-pixel shifts, zoom, an occluding patch, a scene change; aq-mode 1
    and 2, delta q, film grain, CDEF with quantizer matrices, screen
    content, lossless; six frames with hidden ones coded ahead, skip
    mode), still images with loop restoration at speeds 0-1 for the
    superres rewrite (4:2:2, 4:2:0, 4:4:4 150 wide), and
    ``ALBEDO_AVIF_INTER``."""
    from akari_torch.scene.builtin import envtex_texture

    def seq(kind, n, speed, h=96, w=128, seed=3, quality=60, **kw):
        return _avif(motion_frames(kind, n, h, w, seed), save_all=True, quality=quality,
                     speed=speed, **kw)

    rgba = [np.concatenate([f, g[..., :1]], axis=-1)
            for f, g in zip(motion_frames("occl", 3, 72, 96, 5), motion_frames("zoom", 3, 72, 96, 6))]
    albedo = envtex_texture(2048, 0)
    roll = np.roll(albedo, (3, 5), (0, 1))
    moved = ((roll.astype(np.uint16) + np.roll(roll, 1, 1)) // 2).astype(np.uint8)
    return {
        "avis_inter_zoom_s0_5f_128x96.avif": seq("zoom", 5, 0),
        "avis_inter_occl_s1_5f_128x96.avif": seq("occl", 5, 1),
        "avis_inter_shift_s2_2f_128x96.avif": seq("shift", 2, 2),
        "avis_inter_zoom_s4_3f_128x96.avif": seq("zoom", 3, 4),
        "avis_inter_sub_s6_2f_128x96.avif": seq("sub", 2, 6),
        "avis_inter_shift_s8_3f_128x96.avif": seq("shift", 3, 8),
        "avis_inter_shift_s10_2f_128x96.avif": seq("shift", 2, 10),
        "avis_inter_sub_s1_4f_128x96.avif": seq("sub", 4, 1),
        "avis_inter_sub_s6_aq2_6f_119x93.avif": seq("sub", 6, 6, 93, 119, seed=1, quality=31,
                                                    advanced={"aq-mode": "2"}),
        "avis_inter_occl_s0_422_4f_128x96.avif": seq("occl", 4, 0, subsampling="4:2:2"),
        "avis_inter_zoom_s2_444_3f_96x72.avif": seq("zoom", 3, 2, 72, 96, subsampling="4:4:4"),
        "avis_inter_occl_s6_400_3f_128x96.avif": seq("occl", 3, 6, subsampling="4:0:0"),
        "avis_inter_occl_s6_rgba_3f_96x72.avif": _avif(rgba, save_all=True, quality=60,
                                                      speed=6),
        "avis_inter_occl_s2_aq1_4f_128x96.avif": seq("occl", 4, 2, advanced={"aq-mode": "1"}),
        "avis_inter_occl_s4_deltaq_4f_128x96.avif": seq("occl", 4, 4,
                                                        advanced={"deltaq-mode": "1"}),
        "avis_inter_zoom_s6_grain_4f_96x72.avif": seq("zoom", 4, 6, 72, 96,
                                                      advanced={"film-grain-test": "5"}),
        "avis_inter_occl_s8_cdef_qm_3f_128x96.avif": seq("occl", 3, 8, advanced={
            "enable-cdef": "1", "enable-qm": "1"}),
        "avis_inter_scene_s6_screen_2f_128x96.avif": seq("scene", 2, 6, advanced={
            "tune-content": "screen"}),
        "avis_inter_occl_s6_lossless_3f_64x48.avif": seq("occl", 3, 6, 48, 64,
                                                         advanced={"lossless": "1"}),
        "avif_lr_s0_422_120x60.avif": _avif(pattern(60, 120, 71), quality=30, speed=0,
                                            subsampling="4:2:2"),
        "avif_lr_s1_420_96x72.avif": _avif(pattern(72, 96, 73), quality=30, speed=1),
        "avif_lr_s0_444_150x60.avif": _avif(pattern(60, 150, 72), quality=30, speed=0,
                                            subsampling="4:4:4"),
        ALBEDO_AVIF_INTER: _avif([albedo, moved], save_all=True, quality=60, speed=6),
    }


def avif_rewrite_albedo_files(avif_dir=AVIF_OUT):
    """The 2048^2 AVIF albedos ``chip_smoke.py`` phase 54 makes at run time
    from the committed 8-bit ones by header rewrites
    (``tools/av1_rewrite.py``; too large to commit, so recorded in
    ``AVIF_REWRITES``): ``ALBEDO_AVIF_TOOLS`` at 10 and 12 bits,
    ``ALBEDO_AVIF`` coded at superres denominator 12 (3,072 wide), and
    ``ALBEDO_AVIF_INTER`` spliced into inter frame 0."""
    from tools.av1_rewrite import splice_frames, to_high_bitdepth, to_superres

    def read(name):
        with open(os.path.join(avif_dir, name), "rb") as f:
            return f.read()

    tools, base = read(ALBEDO_AVIF_TOOLS), read(ALBEDO_AVIF)
    return {"albedo2048_q60_s4_tools_10bit.avif": to_high_bitdepth(tools, 10),
            "albedo2048_q60_s4_tools_12bit.avif": to_high_bitdepth(tools, 12),
            "albedo2048_q60_superres12.avif": to_superres(base, 12),
            "albedo2048_q60_s6_inter_frame0.avif": splice_frames(read(ALBEDO_AVIF_INTER), 2)}


def write_avif_rewrites(avif_dir=AVIF_OUT):
    """Record ``avif_rewrite_albedo_files`` in ``AVIF_REWRITES``."""
    with open(AVIF_REWRITES, "w") as f:
        json.dump(generated_record(avif_rewrite_albedo_files(avif_dir)), f, indent=1,
                  sort_keys=True)
        f.write("\n")


def splice_digests(data):
    """n -> the SHA-256 of PIL's RGB read of ``splice_frames(data, n)``
    (frame 0 decoded through frames 1 to n - 1; PIL reads the source's
    frame n - 1), for n from 2 to the sequence's length."""
    from PIL import Image

    from tools.av1_rewrite import splice_frames, track_samples

    out = {}
    for n in range(2, len(track_samples(data)[0]) + 1):
        px = np.asarray(Image.open(io.BytesIO(splice_frames(data, n))).convert("RGB"))
        out[str(n)] = hashlib.sha256(px.tobytes()).hexdigest()
    return out


def write_avif_fixtures(out_dir=AVIF_OUT):
    """Write ``avif_fixtures`` and their ``digests.json`` (PIL's decode:
    SHA-256, shape, mode, version) into ``out_dir``, replacing its files."""
    import PIL
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    digests = {}
    for name, data in avif_fixtures().items():
        if data is None:
            raise RuntimeError(f"PIL's AVIF writer failed on {name}")
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        im = Image.open(os.path.join(out_dir, name))
        px = np.asarray(im.convert("RGB"))
        digests[name] = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                         "shape": list(px.shape), "mode": im.mode, "pil": PIL.__version__}
        if name.startswith("avis_inter_"):
            digests[name]["splices"] = splice_digests(data)
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


# --------------------------------------------------------------------------
# Lab, PIL's other PNM modes, DIB and ICNS

# the 2048^2 albedo files chip_smoke.py phase 50 writes (lab_albedo_files),
# with their SHA-256 and PIL's decode: too large to commit, so recorded
GENERATED = os.path.join(ROOT, "tests", "data", "torch_port_generated_images.json")


def pnm_mode_bytes(magic, samples, maxval=255):
    """[H, W, bands] samples -> a file of one of PIL's PNM extension modes
    (``P0CMYK``, ``PyP``, ``PyRGBA``, ``PyCMYK``): the magic, width, height
    and maxval, then the raw samples (big-endian 16-bit above 255)."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    head = magic + f"\n{w} {h}\n{maxval}\n".encode()
    return head + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm_bytes(values, scale=-1.0):
    """[H, W] float32 -> a grey PFM (``Pf``) file: rows bottom up,
    little-endian under a negative ``scale``, big-endian under a positive
    one."""
    values = np.asarray(values, np.float32)
    h, w = values.shape
    return (f"Pf\n{w} {h}\n{scale}\n".encode()
            + values[::-1].astype("<f4" if scale < 0 else ">f4").tobytes())


def lab_bytes(px):
    """[H, W, 3] uint8 RGB -> 8-bit Lab in PIL's and the PSD's layout (L,
    a + 128, b + 128), integers only, so every machine writes the same
    bytes: L the luma, a and b half the red-green and green-blue
    differences. (A TIFF stores a and b signed: the top bit flipped.)"""
    p = np.asarray(px, np.int32)
    lum = (54 * p[..., 0] + 183 * p[..., 1] + 19 * p[..., 2] + 128) >> 8
    return np.stack([lum, 128 + ((p[..., 0] - p[..., 1]) >> 1),
                     128 + ((p[..., 1] - p[..., 2]) >> 1)], axis=-1).astype(np.uint8)


def lab_albedo_files(px, mapper=map):
    """The config-3 albedo ``px`` ([H, W, 3] uint8) in the forms
    ``chip_smoke.py`` phase 50 decodes, written with integer numpy only (so
    they are the same bytes here and on the card's machine, which records
    nothing and has no PIL): a raw and an LZW Lab TIFF (64-row strips,
    the LZW over ``mapper``), a PackBits Lab PSD (literal packets), a grey
    ``Pf`` PFM of the red channel plus a quarter of the green's low two
    bits (exact in float32), and a 24-bit DIB."""
    h, w = px.shape[:2]
    lab = lab_bytes(px)
    signed = lab ^ np.uint8([0, 128, 128])
    grey = px[..., 0].astype(np.float32) + (px[..., 1] & 3).astype(np.float32) / 4
    return {
        f"albedo{w}_lab.tif": tiff_bytes(signed, 8, 8, rows_per_strip=64),
        f"albedo{w}_lab_lzw.tif": tiff_bytes(signed, 8, 8, compression=5, rows_per_strip=64,
                                            mapper=mapper),
        f"albedo{w}_lab_packbits.psd": psd_bytes(np.moveaxis(lab, -1, 0), 9, literal=True),
        f"albedo{w}.pfm": pfm_bytes(grey),
        f"albedo{w}_24.dib": bmp_bytes(w, h, 24, bmp_rows(px[..., ::-1], 24))[14:],
    }


def lab_pnm_dib_icns_fixtures():
    """The Lab, PNM-mode, DIB and ICNS fixtures: Lab PSDs (raw, PackBits,
    with an alpha channel) and Lab TIFFs (``tiff_bytes`` in both byte
    orders, strips, tiles, planes, LZW / Deflate / PackBits; Pillow's writer
    raw, LZW and JPEG); ``Pf`` files in both byte orders holding NaN, +-inf,
    negatives, values past 255 and fractions, and ``P0CMYK`` / ``PyP`` /
    ``PyRGBA`` / ``PyCMYK`` at 8 and 16 bits; DIBs (Pillow's writer, the OS/2
    header, RLE8, bitfields, top-down rows, a V5 header); ICNS files
    (Pillow's writer with PNG entries, and ``tools/icns_writers.py``: the
    24-bit icons in runs and raw with their masks, J2K and JP2 entries from
    ``tools/j2k_writers.py``)."""
    from PIL import Image

    from tools import icns_writers as iw
    from tools import j2k_writers as jw

    def pil(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    r = np.random.default_rng(90)
    lab = np.moveaxis(r.integers(0, 256, (3, 9, 13)).astype(np.uint8), 0, -1)
    lab_img = Image.frombytes("LAB", (13, 9), (lab ^ np.uint8([0, 128, 128])).tobytes())
    signed = lab ^ np.uint8([0, 128, 128])
    vals = np.float32([0.6, 254.6, 300, -3, np.nan, np.inf, -np.inf, 255, 254.99, 1e-30, -0.0,
                       128.5])
    pfm = np.concatenate([vals, r.uniform(-50, 320, 42 - len(vals)).astype(np.float32)])
    out = {
        "lab_raw_13x9.psd": psd_bytes(np.moveaxis(lab, -1, 0), 9, compression=0),
        "lab_packbits_13x9.psd": psd_bytes(np.moveaxis(lab, -1, 0), 9, seed=91),
        "lab_alpha_raw_13x9.psd": psd_bytes(
            np.concatenate([np.moveaxis(lab, -1, 0), lab[None, ..., 0]]), 9, compression=0),
        "tiff_lab_raw_le_13x9.tif": tiff_bytes(signed, 8, 8, rows_per_strip=4),
        "tiff_lab_lzw_be_tiles_13x9.tif": tiff_bytes(signed, 8, 8, order=">", compression=5,
                                                     tile=(16, 16)),
        "tiff_lab_planar_deflate_13x9.tif": tiff_bytes(signed, 8, 8, compression=8, planar=2,
                                                       rows_per_strip=3),
        "tiff_lab_planar_raw_be_13x9.tif": tiff_bytes(signed, 8, 8, order=">", planar=2),
        "tiff_lab_packbits_13x9.tif": tiff_bytes(signed, 8, 8, compression=32773, seed=92),
        "tiff_pil_lab_13x9.tif": pil(lab_img, "TIFF"),
        "tiff_pil_lab_lzw_13x9.tif": pil(lab_img, "TIFF", compression="tiff_lzw"),
        "tiff_pil_lab_jpeg_13x9.tif": pil(lab_img, "TIFF", compression="jpeg", quality=90),
        "pfm_le_7x6.pfm": pfm_bytes(pfm.reshape(6, 7)),
        "pfm_be_7x6.pfm": pfm_bytes(pfm.reshape(6, 7)[::-1], scale=2.5),
        "pnm_p0cmyk_7x5.pnm": pnm_mode_bytes(b"P0CMYK", r.integers(0, 256, (5, 7, 4))),
        "pnm_pycmyk16_7x5.pnm": pnm_mode_bytes(b"PyCMYK", r.integers(0, 1000, (5, 7, 4)), 999),
        "pnm_pyrgba_7x5.pnm": pnm_mode_bytes(b"PyRGBA", r.integers(0, 256, (5, 7, 4))),
        "pnm_pyp_7x5.pnm": pnm_mode_bytes(b"PyP", r.integers(0, 256, (5, 7, 1))),
        "pnm_p0cmyk100_7x5.pnm": pnm_mode_bytes(b"P0CMYK", r.integers(0, 101, (5, 7, 4)), 100),
        "dib_pil_rgb_13x9.dib": pil(Image.fromarray(pattern(9, 13, 93)), "DIB"),
        "dib_pil_p8_13x9.dib": pil(Image.fromarray(pattern(9, 13, 94)).convert("P"), "DIB"),
        "dib_os2_pal8_7x5.dib": bmp_bytes(7, 5, 8, bmp_rows(r.integers(0, 16, (5, 7)), 8),
                                          header=12, palette=_bgr_palette(r, 256, False))[14:],
        "dib_rle8_9x6.dib": bmp_bytes(9, 6, 8, bmp_rle(r.integers(0, 4, (6, 9)), False, r),
                                      compression=1, palette=_bgr_palette(r, 4, True),
                                      colors=4)[14:],
        "dib_bitfields565_v3_7x5.dib": bmp_bytes(
            7, 5, 16, bmp_rows(r.integers(0, 65536, (5, 7)).astype("<u2").view(np.uint8)
                               .reshape(5, 7, 2), 16),
            header=56, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0))[14:],
        "dib_topdown_v5_24_7x5.dib": bmp_bytes(7, -5, 24,
                                               bmp_rows(r.integers(0, 256, (5, 7, 3)), 24,
                                                        top_down=True), header=124)[14:],
    }
    px16 = pattern(16, 16, 95)
    px32 = pattern(32, 32, 96)
    px48 = pattern(48, 48, 97)
    px128 = np.repeat(np.repeat(pattern(8, 8, 98), 16, 0), 16, 1)
    out["icns_pil_png_16x16.icns"] = pil(Image.fromarray(np.full((16, 16, 3), 90, np.uint8)),
                                         "ICNS")
    out["icns_rle_masks_48x48.icns"] = iw.icns_bytes([
        (b"is32", iw.rgb32(px16, r=r)), (b"s8mk", iw.mask(px16[..., 0])),
        (b"il32", iw.rgb32(px32, r=r)), (b"l8mk", iw.mask(px32[..., 1])),
        (b"ih32", iw.rgb32(px48, r=r)), (b"h8mk", iw.mask(px48[..., 2]))])
    out["icns_it32_128x128.icns"] = iw.icns_bytes([
        (b"is32", iw.rgb32(px16, rle=False)), (b"it32", iw.rgb32(px128, it32=True, r=r)),
        (b"t8mk", iw.mask(px128[..., 0]))])
    out["icns_raw_il32_32x32.icns"] = iw.icns_bytes([(b"il32", iw.rgb32(px32, rle=False))])
    out["icns_j2k_ic07_128x128.icns"] = iw.icns_bytes([
        (b"ic07", jw.encode([px128[..., k].astype(np.int64) for k in range(3)])),
        (b"is32", iw.rgb32(px16, r=r))])
    out["icns_jp2_icp5_32x32.icns"] = iw.icns_bytes([
        (b"icp5", jw.jp2(jw.encode([px32[..., k].astype(np.int64) for k in range(3)],
                                   irreversible=True, rates=(8,)), 32, 32, 3))])
    return out


def plugin_albedo_files(px):
    """The config-3 albedo ``px`` ([H, W, 3] uint8) in the forms
    ``chip_smoke.py`` phase 51 decodes, written with integer numpy only: an
    IM ``RGB image`` (planar rows, bottom up), a DCX holding it as a 24-bit
    run-length PCX page, and a PhotoCD base image rotated by 90 degrees
    (orientation 1) whose luma and two chroma planes are its green, blue
    and red channels (the chroma at every other texel of the top-left
    1536 x 1024)."""
    from tools.legacy_writers import pcx_bytes
    from tools.raster_writers import dcx_bytes, im_rgb, pcd_bytes

    w = px.shape[1]
    return {f"albedo{w}_rgb.im": im_rgb(px), f"albedo{w}_rgb.dcx": dcx_bytes([pcx_bytes(px, 8, 3)]),
            f"albedo{w}_ycc_orient1.pcd": pcd_bytes(px[:512, :768, 1], px[:512:2, :768:2, 2],
                                                    px[:512:2, :768:2, 0], 1)}


def plugin_fixtures():
    """The IM, IM Tools, IPTC/NAA, PhotoCD, SPIDER, DCX, MSP and XBM
    fixtures: Pillow's writers where it has one (IM in its modes, SPIDER,
    MSP version 1, XBM), and ``tools/raster_writers.py``: IM in the image
    types and Lut forms Pillow does not write (packed, planar, three-plane,
    2- and 4-bit indices, 8 / 16 / 32-bit integers and floats, ``bit``
    fields, a colour and a non-linear grey table, a PIL mode named directly,
    several frames), IM Tools, IPTC raw and JPEG data (grey, one band of RGB
    and CMYK), SPIDER in both byte orders and a stack, DCX pages, version-2
    MSP with empty and short rows, XBM with a hotspot and with one-digit hex
    values. A PhotoCD file is 768 KB at least, past the fixtures' budget: it
    is generated (``plugin_albedo_files``)."""
    from PIL import Image

    from tools import raster_writers as rw
    from tools.legacy_writers import pcx_bytes

    def pil(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    r = np.random.default_rng(120)
    px = pattern(9, 13, 121)
    h, w = px.shape[:2]
    grey = px[..., 1]
    planes = np.moveaxis(px, -1, 0)

    def drawn(k, dtype=np.uint8, lo=0, hi=256):
        return r.integers(lo, hi, (k, h, w)).astype(dtype)

    def im(name, image_type, body, **kw):
        out[f"im_{name}_{w}x{h}.im"] = rw.im_bytes(body, image_type, (w, h), **kw)

    out = {}
    for mode, src in (("rgb", px), ("p", px), ("la", px), ("1", px), ("i32s", grey),
                      ("f32f", grey), ("i16b", grey), ("cmyk", px), ("ycc", px)):
        img = Image.fromarray(src)
        img = {"p": lambda: img.convert("P"), "la": lambda: img.convert("LA"),
               "1": lambda: img.convert("1"), "i32s": lambda: img.convert("I"),
               "f32f": lambda: Image.fromarray(src.astype(np.float32) * 1.7 - 40),
               "i16b": lambda: Image.frombytes(
                   "I;16B", (w, h), (src.astype(">u2") // 2 + 200).tobytes()),
               "cmyk": lambda: img.convert("CMYK"), "ycc": lambda: img.convert("YCbCr")
               }.get(mode, lambda: img)()
        out[f"im_pil_{mode}_{w}x{h}.im"] = pil(img, "IM")
    im("x24", "X 24 image", rw.im_rows(px.reshape(1, h, 3 * w)))
    im("rgb3", "RGB3 image", b"".join(rw.im_rows(planes[k:k + 1]) for k in (1, 0, 2)))
    im("rgba", "RGBA image", rw.im_rows(drawn(4)))
    im("rgbx", "RGBX image", rw.im_rows(drawn(4)))
    im("b2_nolut", "B2 image", rw.im_rows(drawn(1, hi=4), bits=2))
    im("b4_lut", "B4 image", rw.im_rows(drawn(1)), lut=r.integers(0, 256, 768).astype(np.uint8))
    im("grey_lut", "Greyscale image", rw.im_rows(grey[None]),
       lut=np.tile(np.arange(256, dtype=np.uint8)[::-1], 3))
    im("la_colour_lut", "LA image", rw.im_rows(drawn(2)),
       lut=r.integers(0, 256, 768).astype(np.uint8))
    im("l8s", "L 8S image", rw.im_rows(drawn(1)))
    im("l16s", "L*16S image", rw.im_rows(drawn(1, "<i2", -300, 600).view(np.uint8)))
    im("l32", "L 32 image", rw.im_rows(drawn(1, "<u4", 0, 300).view(np.uint8)))
    im("l32s", "L 32 S image", rw.im_rows(drawn(1, "<i4", -100, 400).view(np.uint8)))
    im("l16", "L 16 image", rw.im_rows(drawn(1, "<u2", 0, 400).view(np.uint8)))
    for bits in (5, 12, 31):
        im(f"bit{bits}", f"L*{bits} image", rw.im_bit_rows(r.integers(0, 300, (h, w)) %
                                                           (1 << bits), bits))
    im("lab_mode", "LAB", rw.im_rows(grey[None]))
    im("frames", "Greyscale image", rw.im_rows(np.concatenate([grey[None], drawn(1)], 1)),
       lines=(b"File size (no of images): 2", b"Name: two frames", b"Comment: first",
              b"Comment: second"), crlf=False, pad=False)
    out[f"imt_grey_{w}x{h}.imt"] = rw.imt_bytes(grey)
    out["imt_lines_7x5.imt"] = rw.imt_bytes(
        drawn(1)[0, :5, :7], lines=[b"* scanner", b"height 5", b"pixel n8", b"width 7"])
    jpeg_rgb = pil(Image.fromarray(px), "JPEG", quality=85)
    jpeg_grey = pil(Image.fromarray(grey), "JPEG", quality=90)
    out[f"iptc_raw_grey_{w}x{h}.iim"] = rw.iptc_bytes(1, 0, (w, h), 1, grey.tobytes(),
                                                      extra=[rw.iptc_field(2, 5, b"title")])
    out[f"iptc_raw_rgb_band2_{w}x{h}.iim"] = rw.iptc_bytes(3, 1, (w, h), 1, grey.tobytes(),
                                                           band=2, chunk=40)
    out[f"iptc_raw_cmyk_band4_{w}x{h}.iim"] = rw.iptc_bytes(4, 1, (w, h), 1, grey.tobytes(),
                                                            band=4, tail=bytes(5))
    out[f"iptc_jpeg_rgb_{w}x{h}.iim"] = rw.iptc_bytes(1, 0, (w, h), 5, jpeg_rgb, chunk=100)
    out[f"iptc_jpeg_grey_band0_{w}x{h}.iim"] = rw.iptc_bytes(3, 1, (w, h), 5, jpeg_grey,
                                                             band=0)
    out[f"iptc_extended_{w}x{h}.iim"] = rw.iptc_bytes(
        1, 0, (w, h), 1, b"", extra=[rw.iptc_field(2, 120, b"caption", extended=2)],
        tail=rw.iptc_field(8, 10, grey.tobytes(), extended=3))
    vals = grey.astype(np.float32) * 1.25 - 30.5
    vals.ravel()[:4] = [np.nan, np.inf, -np.inf, 255.0]
    out[f"spider_be_{w}x{h}.spi"] = rw.spider_bytes(vals)
    out[f"spider_le_{w}x{h}.spi"] = rw.spider_bytes(vals, "<")
    out[f"spider_stack3_{w}x{h}.spi"] = rw.spider_bytes(vals[::-1], stack=3)
    out[f"spider_pil_{w}x{h}.spi"] = pil(Image.fromarray(vals * 0.5 + 60), "SPIDER")
    out[f"dcx_rgb_2pages_{w}x{h}.dcx"] = rw.dcx_bytes([pcx_bytes(px, 8, 3),
                                                       pcx_bytes(grey > 128, 1, 1)])
    out[f"dcx_p8_vga_{w}x{h}.dcx"] = rw.dcx_bytes(
        [pcx_bytes(drawn(1)[0], 8, 1, vga=r.integers(0, 256, (256, 3)))])
    out[f"dcx_1bit_{w}x{h}.dcx"] = rw.dcx_bytes([pcx_bytes(grey & 1, 1, 1)])
    bits = (pattern(9, 37, 124)[..., 0] > 128).astype(np.uint8)
    bits[:, :12] = 1
    out["msp_pil_v1_37x9.msp"] = pil(Image.fromarray(bits * 255).convert("1"), "MSP")
    out["msp_v2_runs_37x9.msp"] = rw.msp_bytes(bits, r=r)
    rows = [rw.msp_runs(p) for p in np.packbits(bits, axis=1)]
    rows[2], rows[5] = b"", rows[5][:3]     # a white row; a row cut short, the
    rows[-1] += b"\x05\xaa\x55\xaa\x55\xaa"   # rows after it shifted, the last row long
    out["msp_v2_blank_short_rows_37x9.msp"] = rw.msp_bytes(bits, rows=rows)
    out["xbm_pil_37x9.xbm"] = pil(Image.fromarray(bits * 255).convert("1"), "XBM")
    out[f"xbm_hotspot_upper_{w}x{h}.xbm"] = rw.xbm_bytes(grey > 100, "icon", (3, 4),
                                                        per_line=5, upper=True)
    out["xbm_one_digit_9x3.xbm"] = (b"#define d_width 9\n#define d_height 3\n"
                                    b"static unsigned char d_bits[] = {\n"
                                    b"0x1, 0xff, 0x3, 0xA, 0x5a, 0x0 };\n")
    return out


def raster_albedo_files(px):
    """The config-3 albedo ``px`` ([H, W, 3] uint8) in the forms
    ``chip_smoke.py`` phase 52 decodes, written with integer numpy only: a
    24-bit run-length Sun raster of its pixels, an FLC whose frame 0 is a
    colour chunk (the RGB332 palette) and a BRUN chunk of its RGB332
    indices, and a raw 8-bit FITS of its channels' integer mean (rows
    stored bottom first, as FITS stores them)."""
    from tools import raster_writers as rw

    h, w = px.shape[:2]
    idx = rw.rgb332(px)
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 255 // 3], -1)
    frame = rw.fli_frame([rw.fli_chunk(4, rw.fli_colour([(0, pal)])),
                          rw.fli_chunk(15, rw.fli_brun(idx))])
    grey = (px.astype(np.uint16).sum(axis=-1) // 3).astype(np.uint8)
    return {f"albedo{w}_rle24.ras": rw.sun_bytes(px, 24, 2),
            f"albedo{w}_brun.flc": rw.fli_bytes(w, h, [frame]),
            f"albedo{w}_grey8.fits": rw.fits_bytes(grey[::-1], 8)}


def raster_fixtures():
    """The Sun raster, FLI / FLC, FITS, GBR, McIdas, PIXAR, XV thumbnail
    and XPM fixtures, all from ``tools/raster_writers.py`` (Pillow writes
    none of these formats): Sun rasters raw and run-length at depths 1, 8
    (palette), 24 and 32 (RGBX, file type 3); an FLC (colour chunk of 8-bit
    entries, BRUN, LC, stamp, a second frame) and an FLI (6-bit entries,
    COPY, SS2); FITS raw 8-bit and a GZIP_1 table of 16-bit samples; GBR
    versions 1 and 2 (grey, RGBA); McIdas of 1 and 4 bytes an element with
    line prefixes; PIXAR; an XV thumbnail; XPM of one and two characters a
    pixel (a ``None`` key unused). Each is a few hundred bytes, the FITS
    files a few KB (2,880-byte units), under the fixtures' size budget."""
    from tools import raster_writers as rw

    r = np.random.default_rng(130)
    px = pattern(9, 13, 131)
    h, w = px.shape[:2]
    grey = px[..., 1]
    px[:, :4] = px[:, :1]   # flat runs for the run-length codes
    out = {}
    pal16 = r.integers(0, 256, (16, 3))
    out[f"sun_rle24_{w}x{h}.ras"] = rw.sun_bytes(px, 24, 2, most=5)
    out[f"sun_rle8_palette_{w}x{h}.ras"] = rw.sun_bytes(grey >> 4, 8, 2, palette=pal16)
    out[f"sun_1bit_{w}x{h}.ras"] = rw.sun_bytes(grey > 100, 1)
    out[f"sun_rgbx32_type3_{w}x{h}.ras"] = rw.sun_bytes(px, 32, 3)
    idx = (grey >> 4).astype(np.uint8)
    idx[:, :5] = 3
    new = idx.copy()
    new[2, 3:9], new[5, 0] = 9, 1
    flc = rw.fli_frame([rw.fli_chunk(4, rw.fli_colour([(0, pal16[:8]), (2, pal16[8:])])),
                        rw.fli_chunk(15, rw.fli_brun(idx, 6)),
                        rw.fli_chunk(12, rw.fli_lc(new, idx)),
                        rw.fli_chunk(18, bytes(range(12)))])
    out[f"flc_brun_lc_{w}x{h}.flc"] = rw.fli_bytes(w, h, [flc, rw.fli_frame(
        [rw.fli_chunk(13, bytes(4))])])
    w2 = w - 1   # SS2 patches words
    new2 = new[:, :w2].copy()
    new2[1, 2:6], new2[7, 6:8] = 12, 4
    fli = rw.fli_frame([rw.fli_chunk(11, rw.fli_colour([(0, pal16 >> 2)], 11)),
                        rw.fli_chunk(16, new[:, :w2].tobytes()),
                        rw.fli_chunk(7, rw.fli_ss2(new2, new[:, :w2]))])
    out[f"fli_copy_ss2_{w2}x{h}.fli"] = rw.fli_bytes(w2, h, [fli], magic=0xAF11)
    out[f"fits_grey8_{w}x{h}.fits"] = rw.fits_bytes(grey, 8, cards=[rw.fits_card("BZERO", 0)])
    out[f"fits_gzip16_{w}x{h}.fits"] = rw.fits_gzip_bytes(grey.astype(np.int32) * 257 - 300, 16,
                                                          pad=False)
    out[f"gbr_v1_grey_{w}x{h}.gbr"] = rw.gbr_bytes(grey, 1, comment=b"old brush")
    out[f"gbr_v2_rgba_{w}x{h}.gbr"] = rw.gbr_bytes(
        np.concatenate([px, grey[..., None]], axis=-1), 2, comment=b"GIMP brush")
    out[f"mcidas_1byte_prefix_{w}x{h}.area"] = rw.mcidas_bytes(grey, 1, prefix=b"\1\2\3")
    out[f"mcidas_4byte_{w}x{h}.area"] = rw.mcidas_bytes(
        grey.astype(np.int32) * 3 - 200, 4, offset=264)
    out[f"pixar_rgb_{w}x{h}.pxr"] = rw.pixar_bytes(px)
    out[f"xvthumb_{w}x{h}.xv"] = rw.xvthumb_bytes(rw.rgb332(px))
    out[f"xpm_p_{w}x{h}.xpm"] = rw.xpm_bytes(grey >> 5, r.integers(0, 256, (8, 3)))
    out[f"xpm_p_2chars_none_{w}x{h}.xpm"] = rw.xpm_bytes(
        (grey >> 6) + 1, [b"None"] + list(r.integers(0, 256, (4, 3))), bpp=2)
    return out


def generated_record(files):
    """name -> the file's SHA-256 and PIL's decode of it (digest, shape,
    version), for ``lab_albedo_files``' and ``plugin_albedo_files``' output."""
    import PIL
    from PIL import Image

    out = {}
    for name, data in files.items():
        px = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(), "pil": PIL.__version__,
                     "sha256": hashlib.sha256(px.tobytes()).hexdigest(), "shape": list(px.shape)}
    return out


def write_generated(albedo):
    """Record ``lab_albedo_files``, ``plugin_albedo_files`` and
    ``raster_albedo_files`` of the 2048^2 albedo in ``GENERATED``."""
    files = {**lab_albedo_files(albedo), **plugin_albedo_files(albedo),
             **raster_albedo_files(albedo)}
    with open(GENERATED, "w") as f:
        json.dump(generated_record(files), f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    ap.add_argument("--only", choices=["jpeg2000", "htj2k", "lab_pnm_dib_icns", "plugins",
                                       "rasters", "avif"],
                    help="write only this group's files and merge their digests into "
                         "digests.json, leaving the other fixtures as they are")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import PIL
    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture

    def digest(name):
        px = np.asarray(Image.open(os.path.join(args.output, name)).convert("RGB"))
        return {"sha256": hashlib.sha256(px.tobytes()).hexdigest(), "shape": list(px.shape),
                "pil": PIL.__version__}

    if args.only == "avif":
        digests = write_avif_fixtures()
        write_avif_rewrites()
        print(f"wrote {len(digests)} AVIF fixtures and their digests.json to {AVIF_OUT}, "
              f"the rewritten albedos' record to {AVIF_REWRITES}")
        return
    if args.only:
        path = os.path.join(args.output, "digests.json")
        with open(path) as f:
            digests = json.load(f)
        group = {"jpeg2000": jpeg2000_fixtures, "htj2k": htj2k_fixtures,
                 "lab_pnm_dib_icns": lab_pnm_dib_icns_fixtures,
                 "plugins": plugin_fixtures, "rasters": raster_fixtures}[args.only]
        for name, data in group().items():
            with open(os.path.join(args.output, name), "wb") as f:
                f.write(data)
            digests[name] = digest(name)
        if args.only in ("lab_pnm_dib_icns", "plugins", "rasters"):
            write_generated(envtex_texture(2048, 0))
        with open(path, "w") as f:
            json.dump(digests, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote the {args.only} fixtures and merged their digests into {path}")
        return

    os.makedirs(args.output, exist_ok=True)
    for name in os.listdir(args.output):
        os.remove(os.path.join(args.output, name))

    def save_jpeg(name, px, mode="RGB", **kw):
        Image.fromarray(px).convert(mode).save(os.path.join(args.output, name), "JPEG", **kw)

    save_jpeg(ALBEDO, envtex_texture(2048, 0), quality=85, subsampling=2)
    Image.fromarray(envtex_texture(2048, 0)).save(os.path.join(args.output, ALBEDO_WEBP),
                                                  "WEBP", quality=85)
    save_jpeg("prog_444_q90.jpg", pattern(64, 48, 1), quality=90, subsampling=0,
              progressive=True)
    save_jpeg("prog_opt_422_33x17.jpg", pattern(33, 17, 2), quality=70, subsampling=1,
              progressive=True, optimize=True)
    save_jpeg("restart_420_q70.jpg", pattern(40, 56, 3), quality=70, subsampling=2,
              restart_marker_blocks=1)
    save_jpeg("keep_rgb_q95.jpg", pattern(24, 31, 4), quality=95, keep_rgb=True)
    save_jpeg("grey_q75_7x300.jpg", pattern(7, 300, 5), mode="L", quality=75)
    save_jpeg("qtables16_420.jpg", pattern(30, 20, 6), subsampling=2,
              qtables=[[max(1, (i * 37) % 700) for i in range(64)], [300 + i for i in range(64)]])
    save_jpeg("q100_420_17x33.jpg", pattern(17, 33, 7), quality=100, subsampling=2)
    Image.fromarray(pattern(20, 30, 8)).convert("P").save(
        os.path.join(args.output, "palette8_trns.png"), transparency=3)
    Image.fromarray(pattern(12, 9, 9)).convert("LA").save(os.path.join(args.output, "la8.png"))
    r = np.random.default_rng(10)
    with open(os.path.join(args.output, "palette4_adam7_33x17.png"), "wb") as f:
        f.write(png_bytes(r.integers(0, 16, (33, 17, 1)), 4, 3, 1,
                     plte=r.integers(0, 256, (16, 3)).astype(np.uint8).tobytes()))
    with open(os.path.join(args.output, "rgba16_19x23.png"), "wb") as f:
        f.write(png_bytes(r.integers(0, 65536, (19, 23, 4)), 16, 6, 0))
    # Pillow's own writers: RLE TGA, 8-bit palette BMP, P6, GIF
    Image.fromarray(pattern(15, 12, 25)).save(os.path.join(args.output, "pil_rle.tga"),
                                               compression="tga_rle")
    Image.fromarray(pattern(9, 14, 26)).convert("P").save(os.path.join(args.output, "pil_p8.bmp"))
    Image.fromarray(pattern(8, 6, 27)).save(os.path.join(args.output, "pil_p6.ppm"))
    Image.fromarray(pattern(16, 20, 28)).save(os.path.join(args.output, "pil.gif"))
    for name, data in format_fixtures(np.random.default_rng(11)).items():
        with open(os.path.join(args.output, name), "wb") as f:
            f.write(data)
    # TIFF: Pillow's libtiff writer, then the forms it cannot write
    tif = pattern(19, 23, 32)
    Image.fromarray(tif).save(os.path.join(args.output, "tiff_pil_rgb8_lzw_pred2.tif"),
                              compression="tiff_lzw", tiffinfo={317: 2})
    Image.fromarray(tif).save(os.path.join(args.output, "tiff_pil_rgb8_jpeg.tif"),
                              compression="jpeg", quality=85)
    Image.fromarray(tif).convert("CMYK").save(
        os.path.join(args.output, "tiff_pil_cmyk_packbits.tif"), compression="packbits")
    Image.fromarray(tif).convert("LA").save(
        os.path.join(args.output, "tiff_pil_la_deflate.tif"), compression="tiff_adobe_deflate")
    for name, data in {**tiff_fixtures(np.random.default_rng(12)), **cmyk_jpegs(),
                       **webp_fixtures(), **dds_fixtures(), **legacy_fixtures(),
                       **jpeg_form_fixtures(), **fax_fixtures(), **jpeg2000_fixtures(),
                       **htj2k_fixtures(),
                       **lab_pnm_dib_icns_fixtures(), **plugin_fixtures(),
                       **raster_fixtures()}.items():
        with open(os.path.join(args.output, name), "wb") as f:
            f.write(data)

    digests = {name: digest(name) for name in sorted(os.listdir(args.output))}
    with open(os.path.join(args.output, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    write_generated(envtex_texture(2048, 0))
    total = sum(os.path.getsize(os.path.join(args.output, n)) for n in os.listdir(args.output))
    print(f"wrote {len(digests)} fixtures and digests.json to {args.output}: {total} bytes")
    write_avif_fixtures()


if __name__ == "__main__":
    main()
