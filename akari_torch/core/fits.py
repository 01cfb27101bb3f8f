"""FITS decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_fits`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of a FITS file (``FitsImagePlugin``); ``fits_header``
is the plugin's open, which raises ``NextFormat`` where PIL tries the
formats after FITS and ``ValueError`` where its open fails.

- The header: 80-byte cards (a keyword in bytes 0-7, a value before any
  ``/``, a leading ``=`` dropped), the first ``SIMPLE = T``; ``END`` moves
  to the next multiple of 2,880 bytes and parses the cards read so far
  (every header unit's, kept in one table); the first card after a unit
  that does not start a new one (``SIMPLE`` / ``XTENSION``) is the data.
  A read at the end of the file fails the open ("Truncated FITS file"), a
  header without image data too ("No image data"); a missing keyword makes
  PIL try the next format, an integer it cannot parse fails the open.
- ``NAXIS`` 0 (no image: the next unit, an ``XTENSION``, may hold it), 1
  (a column: width 1, height ``NAXIS1``) or more (``NAXIS1`` x ``NAXIS2``,
  the first plane). ``BITPIX`` 8 / 16 / 32 / -32 / -64 give PIL's modes
  ``L`` / ``I;16`` / ``I`` / ``F`` / ``F`` with raw modes of the same
  names, rows bottom up: so PIL reads FITS's big-endian samples in its own
  little-endian order (16 and 32 bits byte-swapped, floats as little-endian
  float32), and a -64 image as float32, 4 bytes a pixel, from the start of
  its data. ``BZERO`` and ``BSCALE`` are ignored. Other ``BITPIX`` values
  make PIL try the next format.
- ``GZIP_1`` tables (``XTENSION = 'BINTABLE'``, ``ZIMAGE = T``): the size
  and ``BITPIX`` come from the ``Z`` keywords; the data after the table's
  rows is one gzip stream (``gzip.decompress``, zero padding allowed) of a
  4-byte word a pixel, of which PIL keeps the last ``min(BITPIX // 8, 4)``
  bytes (for -32 and -64 none: the load fails), rows reversed.
- ``convert("RGB")``: ``L`` as is, ``I;16`` and ``I`` clipped to 0..255,
  ``F`` through ``L`` (``_f_to_grey``).
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

from .image_formats import NextFormat, _check_size, _f_to_grey, _grey, note_band, note_mode

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_DTYPES = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}


def _int(headers, key):
    try:
        return int(headers[key])
    except KeyError:
        raise NextFormat(f"FITS header without {key.decode()}") from None
    except ValueError:
        raise ValueError(f"FITS {key.decode()} of {headers[key]!r} (PIL: invalid literal for "
                         "int())") from None


def _size(headers, prefix):
    naxis = _int(headers, prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1")
    return _int(headers, prefix + b"NAXIS1"), _int(headers, prefix + b"NAXIS2")


def _parse(headers):
    """``FitsImageFile._parse_headers``: (decoder, offset, size, mode,
    BITPIX), decoder "" where the table holds no image."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise NextFormat("FITS table without ZCMPTYPE")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            no_prefix = _size(headers, b"") or (0, 0)
            offset = no_prefix[0] * no_prefix[1] * (_int(headers, b"BITPIX") // 8)
            prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, None, "", 0
    bits = _int(headers, prefix + b"BITPIX")
    return decoder, offset, size, _MODES.get(bits, ""), bits


def fits_header(data, what="FITS"):
    """``FitsImageFile._open`` on ``data``: (size, mode, BITPIX, decoder,
    offset of the data)."""
    headers, in_progress, decoder, pos = {}, False, "", 0
    try:
        while True:
            card = data[pos:pos + 80]
            pos += len(card)
            if not card:
                raise ValueError("Truncated FITS file")
            keyword = card[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_progress = True
            elif headers and not in_progress:
                break
            elif keyword == b"END":
                pos = -(-pos // 2880) * 2880
                if not decoder:
                    decoder, offset, size, mode, bits = _parse(headers)
                in_progress = False
                continue
            if decoder:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
                raise NextFormat("not a FITS file")
            headers[keyword] = value
    except NextFormat as e:
        raise NextFormat(f"{what}: {e}") from None
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    if not decoder:
        raise ValueError(f"{what}: FITS header without image data (PIL: No image data)")
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise NextFormat(f"{what}: FITS of BITPIX {bits}, size {w} x {h}")
    _check_size(w, h, what, "FITS")
    return (w, h), mode, bits, decoder, offset + pos - 80


def decode_fits(data, what="FITS"):
    data = bytes(data)
    (w, h), mode, bits, decoder, offset = fits_header(data, what)
    note_mode(mode)
    dtype = np.dtype(_DTYPES[mode])
    if decoder == "raw":
        if offset < 0 or len(data) - offset < w * h * dtype.itemsize:
            raise ValueError(f"{what}: FITS data is truncated (PIL: image file is truncated)")
        v = np.frombuffer(data, dtype, w * h, offset).reshape(h, w)[::-1]
    else:
        try:
            words = gzip.decompress(data[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"{what}: FITS GZIP_1 data: {e} (PIL fails to load it)") from None
        keep = min(bits // 8, 4)   # PIL's slice of each word: empty for -32 and -64
        if keep <= 0 or len(words) < 4 * w * h:
            raise ValueError(f"{what}: FITS GZIP_1 data of BITPIX {bits} gives fewer than "
                             f"{w * h * dtype.itemsize} bytes (PIL: not enough image data)")
        v = np.frombuffer(words, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - keep:]
        v = np.ascontiguousarray(v).view(dtype).reshape(h, w)
    if mode == "L":
        return _grey(v)
    if mode == "I;16":
        note_band(v, "<")
    if mode == "F":
        return _grey(_f_to_grey(v.astype(np.float32)))
    return _grey(np.clip(v, 0, 255))
