"""Shared checks of tests/test_torch_image_rasters.py and
tests/test_torch_image_fli_xpm.py: the port's decoders held to PIL 12.1.0
reading the same bytes from a path, as the JAX package's ``read_image``
reads them."""

import json
import os
import warnings

import numpy as np
from PIL import Image

from akari_torch.core import image as port_image
from akari_tpu.core import image as ref_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
PIL_NAMES = {"PPM": "PNM", "WEBP": "WebP"}


def fixtures(*prefixes):
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return sorted(n for n in json.load(f) if n.startswith(prefixes))


def pil_path(path):
    """PIL's format and ``convert("RGB")`` of a file: (None, None) where its
    open fails, (format, None) where its load does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(path)
        except Exception:
            return None, None
        with im:
            fmt = PIL_NAMES.get(im.format, im.format)
            try:
                return fmt, np.asarray(im.convert("RGB"))
            except Exception:
                return fmt, None


def same_read(path):
    """Both packages' ``read_image``, linear and not: bit-equal."""
    for lin in (True, False):
        got = port_image.read_image(path, to_linear=lin)
        want = ref_image.read_image(path, to_linear=lin)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def check(tmp_path, data, fmt=None, jax=False, name="f"):
    """The port reads ``data`` as PIL reads it (the same format and pixels)
    or refuses it where PIL's open or load fails; ``fmt``: the format PIL
    must read it as (False: PIL must refuse it), and then ``image_format``
    names it too. Returns the port's pixels or None."""
    path = tmp_path / name
    path.write_bytes(data)
    open_fmt, want = pil_path(str(path))
    if fmt is not None:
        assert (open_fmt if want is not None else None) == (fmt or None), open_fmt
        if fmt:
            assert port_image.image_format(data) == fmt
    try:
        got_fmt, got = port_image.decode_with_format(data, name)
    except ValueError:
        got_fmt = got = None
    if want is None:
        assert got is None, f"PIL refuses the file, the port reads it as {got_fmt}"
        return None
    assert got is not None, f"PIL reads the file as {open_fmt}, the port refuses it"
    assert got_fmt == open_fmt
    np.testing.assert_array_equal(got, want)
    if jax:
        same_read(str(path))
    return got


def corrupt(check_one, data, r, n, lo=0):
    """``n`` seeded corruptions of ``data``: 1-3 bytes from ``lo`` on set
    to drawn values, or the file cut at a drawn length; each read as PIL
    reads it or refused as PIL refuses it. Returns how many PIL read."""
    read = 0
    for _ in range(n):
        d = bytearray(data)
        if r.random() < 0.25:
            d = d[:int(r.integers(1, len(d)))]
        else:
            for _ in range(int(r.integers(1, 4))):
                d[int(r.integers(lo, len(d)))] = int(r.integers(0, 256))
        read += check_one(bytes(d)) is not None
    return read
