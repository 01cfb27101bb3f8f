"""PCX decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_pcx`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a PCX file (``PcxImagePlugin``):

- the size from xmin..xmax and ymin..ymax of the 128-byte header; the
  line PIL decodes is ``planes`` x its own stride, (width x bits + 7) // 8
  made even unless the header's bytes-per-line equals it;
- 1 bit, 1 plane: bilevel; 1 bit, 2 or 4 planes: indices into the
  16-colour header palette (bit p of an index in plane p); version 5,
  8 bits, 1 plane: grey, unless the file ends in a 769-byte VGA palette
  (``0x0C`` first) that is not the grey ramp (a file shorter than that
  PIL refuses: it seeks before the start of the file); version 5, 8 bits,
  3 planes:
  RGB, one plane a colour. Other forms are refused, as PIL refuses them;
- the run-length data from byte 128 to the end of the file, decoded by
  ``akari_torch/native/rle.cpp`` as PIL's ``PcxDecode.c`` does: a run
  may not cross a line (PIL refuses the file), and data that ends before
  the last line is a truncated file; each line's planes are then moved
  together as PIL moves them for its unpackers (a header stride that
  differs from the computed one thus shifts the planes PIL reads).

An empty or inverted box, or a header shorter than 68 bytes, makes PIL try
the formats after PCX (``NextFormat``).

DCX (``DcxImagePlugin``): the magic number ``0x3ADE68B1``, a table of up to
1024 page offsets ended by a zero, and PCX pages; ``decode_dcx`` reads page
0 as PIL does, through the PCX plugin on the whole file: the page's header
at its offset, its run-length data to the end of the file, and an 8-bit
page's VGA palette in the file's last 769 bytes. A table cut by the end of
the file, no pages, or a page PIL's PCX parse gives up on makes PIL try the
next format.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .image_formats import NextFormat, _bits, _check_size, _grey, note_band, note_mode

_GREY_RAMP = bytes(v for i in range(256) for v in (i, i, i))


DCX_MAGIC = 0x3ADE68B1


def decode_pcx(data, what="PCX", start=0):
    """A PCX file, or (``start``, a DCX page's offset) the page there, its
    data and VGA palette running to the end of ``data``."""
    from ..native.loader import load

    data = bytes(data)
    head = data[start:start + 68]
    if len(head) < 2 or head[0] != 10 or head[1] not in (0, 2, 3, 5):
        if start:
            raise NextFormat(f"{what}: DCX page 0 at byte {start} is not a PCX image")
        raise ValueError(f"{what}: not a PCX file")
    if len(head) < 68:
        raise NextFormat(f"{what}: PCX header is truncated")
    x0, y0, x1, y1 = (int.from_bytes(head[o:o + 2], "little") for o in (4, 6, 8, 10))
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NextFormat(f"{what}: PCX box {x0}..{x1} x {y0}..{y1} is empty (PIL: bad PCX "
                         "image size)")
    version, bits, planes = head[1], head[3], head[65]
    lut = None
    if bits == 1 and planes == 1:
        form, depth = "1", 1
    elif bits == 1 and planes in (2, 4):
        form, depth = "P", planes
        lut = np.frombuffer(head[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        form, depth = "L", 8
        if len(data) < 769:
            raise ValueError(f"{what}: 8-bit PCX of {len(data)} bytes (PIL seeks to the VGA "
                             "palette 769 bytes before the end of the file and fails)")
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != _GREY_RAMP:
            form, lut = "P", np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        form, depth = "RGB", 24
    else:
        raise ValueError(f"{what}: PCX version {version} of {bits} bits in {planes} planes "
                         "(PIL: unknown PCX mode)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    _check_size(w, h, what, "PCX")
    note_mode(form)
    stride = (w * bits + 7) // 8
    if int.from_bytes(head[66:68], "little") != stride:
        stride += stride % 2
    line = planes * stride
    if (w * depth + 7) // 8 > line:
        raise ValueError(f"{what}: PCX line of {line} bytes holds fewer than {w} pixels (PIL: "
                         "buffer overrun)")
    out = np.zeros((h, line), np.uint8)
    rc = load("rle").akr_pcx_rle(data[start + 128:], max(len(data) - start - 128, 0), w, depth,
                                 line, h, out.ctypes.data_as(ctypes.c_void_p))
    if rc == 1:
        raise ValueError(f"{what}: PCX image data is truncated (PIL: image file is truncated)")
    if rc:
        raise ValueError(f"{what}: PCX run crosses a line (PIL: buffer overrun)")
    if form == "1":
        return _grey(_bits(out, w) * np.uint8(255))
    if form == "RGB":
        return np.ascontiguousarray(out[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    if bits == 8:
        idx = out[:, :w]
    else:
        s = (w + 7) // 8
        idx = sum(_bits(out[:, p * s:(p + 1) * s], w) << p for p in range(planes))
    if lut is None:
        return _grey(idx)
    note_band(idx)
    return lut[idx]


def decode_dcx(data, what="DCX"):
    data = bytes(data)
    if len(data) < 4 or int.from_bytes(data[:4], "little") != DCX_MAGIC:
        raise ValueError(f"{what}: not a DCX file")
    first = None
    for i in range(1024):
        entry = data[4 + 4 * i:8 + 4 * i]
        if len(entry) < 4:
            raise NextFormat(f"{what}: DCX page table cut short")
        offset = int.from_bytes(entry, "little")
        if not offset:
            break
        if first is None:
            first = offset
    if first is None:
        raise NextFormat(f"{what}: DCX file without pages")
    return decode_pcx(data, what, start=first)
