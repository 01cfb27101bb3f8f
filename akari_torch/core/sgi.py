"""SGI image decoding without PIL.

The JAX package reads textures with PIL (``Image.open(path)
.convert("RGB")``, ``akari_tpu/core/image.py``); the card's machine has no
PIL. ``decode_sgi`` returns the [H, W, 3] uint8 pixels of PIL's
``convert("RGB")`` of an SGI file (``.rgb``, ``.rgba``, ``.bw``, ``.sgi``;
``SgiImagePlugin``):

- the 512-byte header: storage 0 (raw) or 1 (RLE), 1 or 2 bytes a sample,
  and the (bytes, dimension, channels) triple PIL maps to L, RGB or RGBA
  (``MODES``); others are refused, as PIL refuses them;
- raw: one plane a channel, rows bottom-up; RLE: the start and length
  tables and the packets, decoded by ``akari_torch/native/rle.cpp`` as
  PIL's ``SgiRleDecode.c`` decodes them (its overrun checks, the row
  buffer it never clears, the early stop it makes on a nonzero last
  packet);
- 16-bit samples keep their high byte, as PIL's ``L;16B`` / ``RGB;16B``
  unpackers do; ``convert("RGB")`` drops the alpha.

A header shorter than 12 bytes makes PIL try the formats after SGI
(``NextFormat``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .image_formats import NextFormat, _check_size, _grey, note_mode

# PIL's SgiImagePlugin.MODES: (bytes a sample, dimension, channels) -> mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def decode_sgi(data, what="SGI"):
    data = bytes(data)
    if data[:2] != b"\x01\xda":
        raise ValueError(f"{what}: not an SGI file")
    if len(data) < 12:
        raise NextFormat(f"{what}: SGI header is truncated")
    storage, bpc = data[2], data[3]
    dim, w, h, z = (int.from_bytes(data[o:o + 2], "big") for o in (4, 6, 8, 10))
    mode = MODES.get((bpc, dim, z))
    if mode is None:
        raise ValueError(f"{what}: SGI of {bpc} bytes a sample, dimension {dim} and {z} "
                         "channels (PIL: unsupported SGI image mode)")
    _check_size(w, h, what, "SGI")
    note_mode(mode)
    if storage == 0:
        need = 512 + z * w * h * bpc
        if len(data) < need:
            raise ValueError(f"{what}: SGI image data is truncated ({len(data)} of {need} "
                             "bytes)")
        planes = np.frombuffer(data, np.uint8, z * w * h * bpc, 512).reshape(z, h, w * bpc)
        px = planes[:, ::-1, ::bpc].transpose(1, 2, 0)
    elif storage == 1:
        from ..native.loader import load

        out = np.zeros((h, w * z * bpc), np.uint8)
        rc = load("rle").akr_sgi_rle(data[512:], max(len(data) - 512, 0), w, h, z, bpc,
                                     out.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ValueError(f"{what}: SGI run-length data overruns its row or the file (PIL: "
                             "buffer overrun)")
        px = out.reshape(h, w, z * bpc)[..., ::bpc]
    else:
        raise ValueError(f"{what}: SGI storage {storage} (PIL reads 0, raw, and 1, RLE)")
    if mode == "L":
        return _grey(px[..., 0])
    return np.ascontiguousarray(px[..., :3])
