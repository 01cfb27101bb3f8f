"""IPTC/NAA decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_iptc`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of an IPTC/NAA file (``IptcImagePlugin``).

The format has no signature: PIL runs the plugin's header parse on every
file that reaches it (``iptc_header``), and that parse either makes PIL
try the next format (``NextFormat``: a first byte other than ``0x1C``, a
record number outside 1-9 and 240, a file cut inside a field header, no or
short ``(3, 60)``, ``(3, 20)`` or ``(3, 30)`` fields) or fails the open
(``ValueError``: a field length byte above 132, a compression other than 1
or 5). A file is a run of fields (``0x1C``, record, dataset, a 15-bit
length or an extended one of 1-4 bytes) up to the first ``(8, 10)`` field
or an all-zero one:

- ``(3, 60)``: layers and component: one layer and component 0 is grey,
  three or four layers with a component are RGB or CMYK with one band
  (``(3, 65)``, from 1; 0 is the last band) holding the image and the others
  zero;
- ``(3, 20)`` / ``(3, 30)``: the width and height (the last four bytes,
  big-endian);
- ``(3, 120)``: the compression, 1 raw (8-bit grey, rows top down) or 5
  JPEG: the data of the ``(8, 10)`` fields, joined, is then an image file
  of its own, opened as any file is (``decode_image``), at its own size. A
  band must be an 8-bit grey image (PIL merges it as mode ``L``): the port
  reads one from a grey JPEG or PNG and refuses other formats there.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, _cmyk_to_rgb, _grey


class _Syntax(Exception):
    """The plugin's SyntaxError / IndexError / TypeError / KeyError /
    struct.error: during the open, PIL tries the next format."""


def _i(c):
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def _field(fp):
    """``IptcImageFile.field``: (tag or None, size); ``_Syntax`` where the
    plugin's parse raises what PIL catches, ``ValueError`` for its
    ``OSError``."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    if len(s) < 3:
        raise _Syntax("IPTC field header cut short")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise _Syntax("invalid IPTC/NAA file")
    if len(s) < 4:
        raise _Syntax("IPTC field header cut short")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        if len(s) < 5:
            raise _Syntax("IPTC field header cut short")
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _getint(info, key):
    v = info[key]   # KeyError
    if not isinstance(v, bytes):
        raise _Syntax(f"IPTC field {key} is {type(v).__name__}")
    return _i(v)


def iptc_header(data, what="IPTC"):
    """``IptcImageFile._open`` on ``data``: (mode, band or None, size,
    compression, offset of the first ``(8, 10)`` field or None)."""
    try:
        fp, info = io.BytesIO(data), {}
        while True:
            offset = fp.tell()
            tag, size = _field(fp)
            if not tag or tag == (8, 10):
                break
            tagdata = fp.read(size) if size else None
            if tag in info:
                if isinstance(info[tag], list):
                    info[tag].append(tagdata)
                else:
                    info[tag] = [info[tag], tagdata]
            else:
                info[tag] = tagdata
        mode = ""
        layer = info[(3, 60)]
        if layer is None:
            raise _Syntax("empty IPTC (3, 60) field")
        layers, component = layer[0], layer[1]
        if layers == 1 and not component:
            mode, band = "L", None
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = 0
            if (3, 65) in info:
                b = info[(3, 65)]
                if not isinstance(b, bytes):
                    raise _Syntax("IPTC (3, 65) field is not one value")
                band = b[0] - 1
        size = _getint(info, (3, 20)), _getint(info, (3, 30))
        try:
            compression = {1: "raw", 5: "jpeg"}[_getint(info, (3, 120))]
        except KeyError:
            raise ValueError("Unknown IPTC image compression") from None
    except (_Syntax, IndexError, KeyError) as e:
        raise NextFormat(f"{what}: not an IPTC/NAA image ({e})") from None
    except ValueError as e:
        raise ValueError(f"{what}: {e} (PIL's open fails)") from None
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NextFormat(f"{what}: IPTC/NAA file of mode {mode!r}, size {size[0]} x {size[1]}")
    return mode, band, size, compression, offset if tag == (8, 10) else None


def _grey_blob(blob, what):
    """The pixels of an image file PIL opens in mode ``L`` ([H, W] uint8),
    for a band: a one-component JPEG or a 2-, 4- or 8-bit grey PNG."""
    from .image import decode_png, image_format
    from .jpeg import decode_components

    fmt = image_format(blob)
    if fmt == "JPEG":
        comps, space, _ = decode_components(blob, what)
        if space == "grey":
            return comps[0]
        raise ValueError(f"{what}: IPTC band of a {space} JPEG (PIL: image has wrong mode)")
    if fmt == "PNG" and blob[12:16] == b"IHDR":
        depth, ctype = blob[24], blob[25]
        if ctype == 0 and depth in (2, 4, 8):
            return decode_png(blob, what)[..., 0]
        raise ValueError(f"{what}: IPTC band of a PNG of colour type {ctype}, depth {depth} "
                         "(PIL: image has wrong mode)")
    raise ValueError(f"{what}: IPTC band of a {fmt or 'unidentified'} image (the port reads a "
                     "band from a grey JPEG or PNG)")


def decode_iptc(data, what="IPTC"):
    from .image import decode_image

    data = bytes(data)
    mode, band, (w, h), compression, offset = iptc_header(data, what)
    _check_size(w, h, what, "IPTC/NAA")
    if offset is None:
        raise ValueError(f"{what}: IPTC/NAA file without image data (PIL: cannot load this "
                         "image)")
    fp, parts = io.BytesIO(data), []
    fp.seek(offset)
    try:
        while True:
            tag, size = _field(fp)
            if tag != (8, 10):
                break
            parts.append(fp.read(size))
    except (_Syntax, ValueError) as e:
        raise ValueError(f"{what}: IPTC/NAA field after the image data: {e}") from None
    blob = b"".join(parts)
    if compression == "raw":
        if len(blob) < w * h:
            raise ValueError(f"{what}: IPTC/NAA raw data is truncated (PIL: image file is "
                             "truncated)")
        grey = np.frombuffer(blob, np.uint8, w * h).reshape(h, w)
    elif band is None:
        return decode_image(blob, f"{what} (its JPEG data)")
    else:
        grey = _grey_blob(blob, f"{what} (its JPEG data)")
    if band is None:
        return _grey(grey)
    bands = np.zeros((4 if mode == "CMYK" else 3,) + grey.shape, np.uint8)
    if not -len(bands) <= band < len(bands):
        raise ValueError(f"{what}: IPTC/NAA band {band + 1} of a {mode} image (PIL: list "
                         "assignment index out of range)")
    bands[band] = grey
    px = np.moveaxis(bands, 0, -1)
    return _cmyk_to_rgb(px) if mode == "CMYK" else px
