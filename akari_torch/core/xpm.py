"""X11 pixmap (XPM) decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_xpm`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of an XPM file (``XpmImagePlugin``); ``xpm_header`` is
the plugin's open, which raises ``NextFormat`` where PIL tries the formats
after XPM and ``ValueError`` where its open fails.

- After ``/* XPM */``, lines are read until one starts with the values
  string ``"<width> <height> <colours> <chars per pixel>`` (PIL's
  ``xpm_head``; an empty field fails the open, no such line makes PIL try
  the next format).
- One line a colour: the key is the ``bpp`` bytes after the line's first
  byte, the rest up to the line's last two bytes (``",`` in a well-formed
  file: a line without the comma loses a byte of its colour) is split into
  key / value pairs, of which only ``c`` counts: ``#`` and hexadecimal
  (Python's ``int(..., 16)``, its low 24 bits), ``None`` (a transparency
  key, kept out of the palette: a pixel that uses it fails the load);
  anything else, or no ``c`` pair, fails the open ("cannot read this XPM
  file"); a ``c`` without a value makes PIL try the next format. Keys
  repeated keep their first place and their last colour.
- More than 256 colour lines read as ``RGB``, others as ``P``: either way
  each key gives its colour. PIL's ``load_read`` is dead code (its decoder
  reads the file itself): the decoder reads lines from the end of the
  colours, skipping the first ``/* pixels */`` line, each line's part
  between its first and last ``"`` cut into ``bpp``-byte keys (the last one
  shorter where the part is), until the image's count of keys is reached;
  short lines do not pad, long lines run on into the next row, and keys
  past the image are ignored. Too few keys, or a key not in the palette,
  fail the load.
- The keys are looked up as integers (``bpp`` <= 8) with ``searchsorted``,
  so a 2048^2 file costs no Python loop per pixel.
"""

from __future__ import annotations

import re

import numpy as np

from .image_formats import NextFormat, _check_size, note_band, note_mode

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _readline(data, pos):
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def xpm_header(data, what="XPM"):
    """``XpmImageFile._open``: (width, height, bpp, {key: (r, g, b)} in the
    file's order, mode, offset of the pixel lines)."""
    if not data.startswith(b"/* XPM */"):
        raise NextFormat(f"{what}: not an XPM file")
    pos = 9
    while True:
        line, pos = _readline(data, pos)
        if not line:
            raise NextFormat(f"{what}: broken XPM file (no values line)")
        m = _HEAD.match(line)
        if m:
            break
    try:
        w, h, n, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{what}: XPM values line {line[:40]!r} has an empty field (PIL's open "
                         "fails)") from None
    palette = {}
    for _ in range(n):
        line, pos = _readline(data, pos)
        line = line.rstrip()
        key, s = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise NextFormat(f"{what}: XPM colour line {line[:40]!r} ends at its key")
                rgb = s[i + 1]
                if rgb == b"None":
                    break
                try:
                    v = int(rgb[1:], 16) if rgb.startswith(b"#") else None
                except ValueError:
                    v = None
                if v is None:
                    raise ValueError(f"{what}: XPM colour {rgb[:20]!r} (PIL: cannot read this "
                                     "XPM file)")
                palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                break
        else:
            raise ValueError(f"{what}: XPM colour line {line[:40]!r} without a c key (PIL: "
                             "cannot read this XPM file)")
    if w <= 0 or h <= 0:
        raise NextFormat(f"{what}: XPM of size {w} x {h}")
    _check_size(w, h, what, "XPM")
    return w, h, bpp, palette, "RGB" if n > 256 else "P", pos


def _codes(mat):
    """[N, k] uint8 keys (k <= 8) -> [N] uint64, big-endian."""
    out = np.zeros(len(mat), np.uint64)
    for j in range(mat.shape[1]):
        out = (out << np.uint64(8)) | mat[:, j].astype(np.uint64)
    return out


def decode_xpm(data, what="XPM"):
    data = bytes(data)
    w, h, bpp, palette, mode, pos = xpm_header(data, what)
    note_mode(mode)
    need, got, parts, pixel_header = w * h, 0, [], False
    while got < need:
        line, pos = _readline(data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        part = b'"'.join(line.split(b'"')[1:-1])
        if part and bpp <= 0:
            raise ValueError(f"{what}: XPM of {bpp} characters a pixel (PIL fails to load it)")
        if part:
            parts.append(part)
            got += -(-len(part) // bpp)
    if got < need:
        raise ValueError(f"{what}: XPM holds {got} of {need} pixels (PIL: not enough image data)")
    keys = list(palette)
    colours = np.array([palette[k] for k in keys] + [(0, 0, 0)], np.uint8).reshape(-1, 3)
    lookup = {k: i for i, k in enumerate(keys)}
    full = [p[:len(p) - len(p) % bpp] for p in parts]
    rest = [(i, p[len(p) - len(p) % bpp:]) for i, p in enumerate(parts) if len(p) % bpp]
    mat = np.frombuffer(b"".join(full), np.uint8).reshape(-1, bpp)
    if bpp <= 8:
        whole = [i for i, k in enumerate(keys) if len(k) == bpp]
        table = _codes(np.frombuffer(b"".join(keys[i] for i in whole), np.uint8)
                       .reshape(-1, bpp)) if whole else np.zeros(0, np.uint64)
        order = np.argsort(table, kind="stable")
        codes = _codes(mat)
        at = np.minimum(np.searchsorted(table[order], codes), max(len(table) - 1, 0))
        found = (table[order][at] == codes) if len(table) else np.zeros(len(codes), bool)
        idx = np.where(found, np.asarray(whole, np.int64)[order][at] if len(table) else 0, -1)
    else:
        idx = np.array([lookup.get(bytes(k), -1) for k in mat], np.int64)
    if rest:   # each line's short last key, after its full keys
        ends = np.cumsum([len(f) // bpp for f in full])
        idx = np.insert(idx, [ends[i] for i, _ in rest], [lookup.get(k, -1) for _, k in rest])
    idx = idx[:need]
    if (idx < 0).any():
        bad = np.flatnonzero(idx < 0)[0]
        raise ValueError(f"{what}: XPM pixel {bad} has a key not in its palette (PIL fails to "
                         "load it)")
    idx = idx.reshape(h, w)
    if mode == "P":
        note_band(idx.astype(np.uint8))
    return colours[idx]
