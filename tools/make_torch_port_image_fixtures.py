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
- ``digests.json``: for each file, the SHA-256 of PIL's decoded RGB bytes
  (``Image.open(path).convert("RGB")``) and their shape.

``chip_smoke.py`` decodes every fixture with the port and checks the
digests; ``tests/test_torch_image_decode.py`` holds ``digests.json`` to
PIL's decode here, so it cannot go stale. Needs PIL.

Usage: python tools/make_torch_port_image_fixtures.py [-o DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_images")
ALBEDO = "albedo2048_q85_420.jpg"


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    from PIL import Image

    from akari_torch.scene.builtin import envtex_texture

    os.makedirs(args.output, exist_ok=True)
    for name in os.listdir(args.output):
        os.remove(os.path.join(args.output, name))

    def save_jpeg(name, px, mode="RGB", **kw):
        Image.fromarray(px).convert(mode).save(os.path.join(args.output, name), "JPEG", **kw)

    save_jpeg(ALBEDO, envtex_texture(2048, 0), quality=85, subsampling=2)
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

    digests = {}
    for name in sorted(os.listdir(args.output)):
        px = np.asarray(Image.open(os.path.join(args.output, name)).convert("RGB"))
        digests[name] = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                         "shape": list(px.shape)}
    with open(os.path.join(args.output, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.output, n)) for n in os.listdir(args.output))
    print(f"wrote {len(digests)} fixtures and digests.json to {args.output}: {total} bytes")


if __name__ == "__main__":
    main()
