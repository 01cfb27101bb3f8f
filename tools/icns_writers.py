"""Writers of ICNS (Mac OS icon) files for the PyTorch port's decoder tests.

Pillow writes ICNS with PNG entries only (``ic07``-``ic14``); these writers
need no PIL and write every entry Pillow's ``IcnsImagePlugin`` reads:

- ``rgb32``: the 24-bit icons ``it32`` / ``ih32`` / ``il32`` / ``is32``,
  raw (width x height x 3 bytes, RGB interleaved) or as three channels of
  runs (a byte n < 128 then n + 1 literal bytes, or n >= 128 then one byte
  repeated n - 125 times, 3 to 130), run and literal lengths drawn from
  ``r``; ``it32`` takes four zero bytes first;
- ``mask``: the 8-bit masks ``t8mk`` / ``h8mk`` / ``l8mk`` / ``s8mk``;
- ``icns_bytes``: the file, blocks in the order given (PNG and JPEG 2000
  payloads as they come: ``tools/j2k_writers.py`` writes the latter),
  with the header's file length or another one.
"""

from __future__ import annotations

import struct

import numpy as np


def channel_runs(chan, r=None):
    """One channel's bytes -> the ICNS run coding: runs of 3 or more equal
    bytes (up to 130) as run packets, the rest as literal packets of at most
    128 bytes (lengths drawn from ``r`` when given)."""
    chan = bytes(chan)
    out, i, n = bytearray(), 0, len(chan)
    while i < n:
        j = i
        while j + 1 < n and j - i < 129 and chan[j + 1] == chan[i]:
            j += 1
        if j - i >= 2:
            out += bytes([j - i + 1 + 125, chan[i]])
            i = j + 1
            continue
        k = i + 1  # a literal up to the next run of 3, or a drawn length
        limit = min(n, i + (int(r.integers(1, 129)) if r is not None else 128))
        while k < limit and not (k + 2 < n and chan[k] == chan[k + 1] == chan[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + chan[i:k]
        i = k
    return bytes(out)


def rgb32(px, rle=True, it32=False, r=None):
    """[side, side, 3] uint8 -> a 24-bit icon block's payload."""
    px = np.ascontiguousarray(px, np.uint8)
    body = (b"".join(channel_runs(px[..., k].tobytes(), r) for k in range(3)) if rle
            else px.tobytes())
    return (b"\0\0\0\0" if it32 else b"") + body


def mask(a):
    """[side, side] uint8 -> a mask block's payload."""
    return np.ascontiguousarray(a, np.uint8).tobytes()


def icns_bytes(blocks, filesize=None):
    """(type, payload) pairs -> an ICNS file; ``filesize`` replaces the
    header's length (by default the file's)."""
    body = b"".join(kind + struct.pack(">I", len(data) + 8) + data for kind, data in blocks)
    return b"icns" + struct.pack(">I", len(body) + 8 if filesize is None else filesize) + body
