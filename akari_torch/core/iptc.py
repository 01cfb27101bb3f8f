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
  of its own in any format PIL opens, read at its own size (PIL keeps the
  header's size as an attribute and never checks it). A grey file takes
  that image's pixels (``decode_image``), except where PIL's conversion of
  its core has no path to RGB (modes ``F``, ``LAB``, ``I;16L``, ``I;16B``:
  refused). A band is put in with ``Image.merge``, which needs PIL's mode of
  the embedded file (``decode_with_mode``): the other bands must be ``L``
  ("mode mismatch"), so a band other than the first is read only from an
  ``L`` image; the first band is checked only by the C merge, which takes
  any one-band image and copies the first W bytes of each of its rows:
  grey levels for ``L`` and ``1`` (0 and 255), the indices of ``P``, half
  of the stored sample bytes of ``I;16`` (the decoders note them:
  ``image_formats.note_band``); ``I`` and ``F`` crash PIL 12.1.0
  (refused); images of several bands make it fail ("image has wrong
  mode"). A grey image under a colour map (TGA) merges its grey levels.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .image_formats import NextFormat, _check_size, _cmyk_to_rgb, _grey, note_mode


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


# PIL's modes whose core has no conversion to RGB (``Image.convert`` goes
# through the mode's base only for the image's own mode, not the IPTC's L)
_NO_RGB = ("F", "LAB", "I;16L", "I;16B")


def _band_pixels(blob, first, what):
    """The [H, W] bytes ``Image.merge`` puts in a band from the image file
    ``blob``: its grey levels where PIL opens it in mode ``L``, and for the
    ``first`` band the bytes of any one-band image; refused as PIL's merge
    refuses other modes."""
    from .image import decode_with_mode

    fmt, mode, px, band = decode_with_mode(blob, what)
    if mode == "L" or (first and mode in ("1", "P", "I;16", "I;16L", "I;16B")):
        if band is not None:
            return band
        if mode in ("L", "1"):
            return px[..., 0]
        raise ValueError(f"{what}: IPTC first band of a {fmt} image of mode {mode} (its "
                         "decoder keeps no bytes of it)")
    if not first:
        raise ValueError(f"{what}: IPTC band of a {fmt} image of mode {mode} (PIL: mode "
                         "mismatch)")
    if mode in ("I", "F"):
        raise ValueError(f"{what}: IPTC first band of a {fmt} image of mode {mode} (PIL "
                         "12.1.0 crashes on it)")
    raise ValueError(f"{what}: IPTC band of a {fmt} image of mode {mode} (PIL: image has "
                     "wrong mode)")


def decode_iptc(data, what="IPTC"):
    from .image import decode_with_mode

    data = bytes(data)
    mode, band, (w, h), compression, offset = iptc_header(data, what)
    _check_size(w, h, what, "IPTC/NAA")
    note_mode(mode)
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
    n = 4 if mode == "CMYK" else 3
    if band is not None and not -n <= band < n:
        raise ValueError(f"{what}: IPTC/NAA band {band + 1} of a {mode} image (PIL: list "
                         "assignment index out of range)")
    if compression == "raw":
        if len(blob) < w * h:
            raise ValueError(f"{what}: IPTC/NAA raw data is truncated (PIL: image file is "
                             "truncated)")
        grey = np.frombuffer(blob, np.uint8, w * h).reshape(h, w)
    elif band is None:
        fmt, inner, px, _ = decode_with_mode(blob, f"{what} (its JPEG data)")
        if inner in _NO_RGB:
            raise ValueError(f"{what}: IPTC/NAA data of a {fmt} image of mode {inner} (PIL: "
                             f"conversion from {inner} to RGB not supported)")
        return px
    else:
        grey = _band_pixels(blob, band % n == 0, f"{what} (its JPEG data)")
    if band is None:
        return _grey(grey)
    bands = np.zeros((n,) + grey.shape, np.uint8)
    bands[band] = grey
    px = np.moveaxis(bands, 0, -1)
    return _cmyk_to_rgb(px) if mode == "CMYK" else px
