"""Oracles for the AVIF tests, through the libavif that Pillow bundles
(``pillow.libs/libavif-*.so``, libavif 1.3.0 linking dav1d 1.5.1 and
libyuv): ``dav1d_planes`` decodes an item's OBUs with dav1d's own API
(``dav1d_open`` / ``dav1d_send_data`` / ``dav1d_get_picture``, with frame
threads as libavif runs it, so that every OBU of the data is parsed before
the frame is output) and returns its planes; ``libavif_rgb`` runs libavif's
``avifImageYUVToRGB`` on planes the test gives (an ``avifImage`` made by
``avifImageCreate`` and filled through its field offsets, RGB or RGBA
out, libavif's default chroma upsampling); ``libavif_scale`` runs
``avifImageScale`` (libyuv's ScalePlane with the box filter, as libavif
scales a frame to its item's size) on such an image. PIL is imported
first, so that the bundled libraries resolve.

The structure offsets are libavif 1.3.0's and dav1d 1.5.1's on x86-64
(``avifImage``: yuvRange at 16, yuvPlanes at 24, yuvRowBytes at 48,
alphaPlane / alphaRowBytes at 64 / 72, alphaPremultiplied at 80,
colorPrimaries / transferCharacteristics / matrixCoefficients at 104 /
106 / 108; ``avifRGBImage``: depth / format at 8 / 12, pixels / rowBytes at 48 / 56;
``Dav1dSettings``: n_threads / max_frame_delay at 0 / 4; ``Dav1dPicture``: data at 16, stride at 40,
p.w / p.h / p.layout / p.bpc at 56 / 60 / 64 / 68); ``check_layout`` reads a fresh image's defaults back through
them, ``check_scale_layout`` the size and row bytes ``avifImageScale``
writes back.
"""

import ctypes
import glob
import os
import struct

import numpy as np
import PIL
from PIL import AvifImagePlugin  # noqa: F401  (loads the bundled libraries)

_LIB = None


def lib():
    global _LIB
    if _LIB is None:
        path = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                      "pillow.libs", "libavif*.so*"))[0]
        a = ctypes.CDLL(path)
        p = ctypes.c_void_p
        a.avifImageCreate.restype = p
        a.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
        a.avifImageAllocatePlanes.argtypes = [p, ctypes.c_int]
        a.avifImageDestroy.argtypes = [p]
        a.avifRGBImageSetDefaults.argtypes = [p, p]
        a.avifRGBImageAllocatePixels.argtypes = [p]
        a.avifRGBImageFreePixels.argtypes = [p]
        a.avifImageYUVToRGB.argtypes = [p, p]
        a.avifImageScale.argtypes = [p, ctypes.c_uint32, ctypes.c_uint32, p]
        a.avifVersion.restype = ctypes.c_char_p
        a.dav1d_default_settings.argtypes = [p]
        a.dav1d_open.argtypes = [ctypes.POINTER(p), p]
        a.dav1d_data_create.restype = p
        a.dav1d_data_create.argtypes = [p, ctypes.c_size_t]
        a.dav1d_send_data.argtypes = [p, p]
        a.dav1d_get_picture.argtypes = [p, p]
        a.dav1d_picture_unref.argtypes = [p]
        a.dav1d_close.argtypes = [ctypes.POINTER(p)]
        a.dav1d_version.restype = ctypes.c_char_p
        _LIB = a
    return _LIB


def versions():
    a = lib()
    return a.avifVersion().decode(), a.dav1d_version().decode()


def check_layout():
    """The offsets above on a fresh 4x4 4:4:4 image: its size, depth,
    format, full range, unspecified CICP; RGB defaults of RGBA, 8 bits."""
    a = lib()
    im = a.avifImageCreate(4, 4, 8, 1)
    try:
        raw = ctypes.string_at(im, 112)
        assert struct.unpack_from("<6I", raw, 0) == (4, 4, 8, 1, 1, 0)
        assert struct.unpack_from("<3H", raw, 104) == (2, 2, 2)
        rgb = ctypes.create_string_buffer(128)
        a.avifRGBImageSetDefaults(rgb, im)
        assert struct.unpack_from("<4I", rgb.raw, 0) == (4, 4, 8, 1)
    finally:
        a.avifImageDestroy(im)


def check_scale_layout():
    """A 4x4 4:2:0 image with alpha scaled to 6x2: width and height at 0 /
    4, the planes' row bytes at 48 and the alpha's at 72 at least their
    widths (6, 3, 3, 6), every plane pointer set."""
    a = lib()
    im = a.avifImageCreate(4, 4, 8, 3)
    try:
        a.avifImageAllocatePlanes(im, 0xFF)
        diag = ctypes.create_string_buffer(512)
        assert a.avifImageScale(im, 6, 2, diag) == 0
        raw = ctypes.string_at(im, 112)
        assert struct.unpack_from("<2I", raw, 0) == (6, 2)
        rows = struct.unpack_from("<3I", raw, 48) + struct.unpack_from("<I", raw, 72)
        assert all(r >= w for r, w in zip(rows, (6, 3, 3, 6))), rows
        assert all(struct.unpack_from("<3Q", raw, 24)) and struct.unpack_from("<Q", raw, 64)[0]
    finally:
        a.avifImageDestroy(im)


_FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}


def libavif_rgb(y, u, v, fmt, full, matrix, primaries=1, transfer=13, alpha=None,
                premultiplied=False, depth=8):
    """avifImageYUVToRGB of planes of ``depth`` bits to 8-bit RGB, as PIL
    asks for it: (result, [H, W, 3 or 4] uint8); RGBA when ``alpha`` is
    given, as PIL converts an image with alpha."""
    a = lib()
    h, w = y.shape
    dt = np.uint8 if depth == 8 else np.dtype("<u2")
    im = a.avifImageCreate(w, h, depth, _FORMATS[fmt])
    try:
        a.avifImageAllocatePlanes(im, 1 if alpha is None else 0xFF)
        raw = ctypes.string_at(im, 112)
        planes = struct.unpack_from("<3Q", raw, 24)
        rows = struct.unpack_from("<3I", raw, 48)
        for k, arr in enumerate([y] + ([] if fmt == "400" else [u, v])):
            arr = np.ascontiguousarray(arr, dt)
            for r in range(arr.shape[0]):
                ctypes.memmove(planes[k] + r * rows[k], arr[r].tobytes(), arr.nbytes // arr.shape[0])
        if alpha is not None:
            ap, ar = struct.unpack_from("<QI", raw, 64)
            al = np.ascontiguousarray(alpha, dt)
            for r in range(h):
                ctypes.memmove(ap + r * ar, al[r].tobytes(), al.nbytes // h)
            ctypes.c_int.from_address(im + 80).value = int(premultiplied)
        ctypes.c_int.from_address(im + 16).value = int(full)
        ctypes.c_uint16.from_address(im + 104).value = primaries
        ctypes.c_uint16.from_address(im + 106).value = transfer
        ctypes.c_uint16.from_address(im + 108).value = matrix
        rgb = ctypes.create_string_buffer(128)
        a.avifRGBImageSetDefaults(rgb, im)
        ch = 3 if alpha is None else 4
        struct.pack_into("<II", rgb, 8, 8, 0 if alpha is None else 1)  # depth 8, RGB / RGBA
        a.avifRGBImageAllocatePixels(rgb)
        try:
            res = a.avifImageYUVToRGB(im, rgb)
            pix, rb = struct.unpack_from("<QI", rgb.raw, 48)
            out = np.frombuffer(ctypes.string_at(pix, rb * h), np.uint8).reshape(h, rb)
            out = out[:, :w * ch].reshape(h, w, ch).copy()
        finally:
            a.avifRGBImageFreePixels(rgb)
        return res, out
    finally:
        a.avifImageDestroy(im)


def libavif_scale(planes, fmt, width, height, dst_width, dst_height, depth=8):
    """avifImageScale of an image of ``depth`` bits and ``width`` x
    ``height`` with ``planes`` ([Y, U, V] of their sizes, or [Y] for 4:0:0;
    plus the alpha plane last, where given beyond them) to ``dst_width`` x
    ``dst_height``: (result, its planes in the same order, uint8 or
    uint16)."""
    a = lib()
    n_yuv = 1 if fmt == "400" else 3
    dt = np.uint8 if depth == 8 else np.dtype("<u2")
    im = a.avifImageCreate(width, height, depth, _FORMATS[fmt])
    try:
        has_alpha = len(planes) > n_yuv
        a.avifImageAllocatePlanes(im, 0xFF if has_alpha else 1)

        def slots():
            raw = ctypes.string_at(im, 112)
            ptrs = list(struct.unpack_from("<3Q", raw, 24))[:n_yuv]
            rows = list(struct.unpack_from("<3I", raw, 48))[:n_yuv]
            if has_alpha:
                ap, ar = struct.unpack_from("<QI", raw, 64)
                ptrs.append(ap)
                rows.append(ar)
            return ptrs, rows

        ptrs, rows = slots()
        for k, arr in enumerate(planes):
            arr = np.ascontiguousarray(arr, dt)
            for r in range(arr.shape[0]):
                ctypes.memmove(ptrs[k] + r * rows[k], arr[r].tobytes(), arr.nbytes // arr.shape[0])
        diag = ctypes.create_string_buffer(512)
        res = a.avifImageScale(im, dst_width, dst_height, diag)
        if res != 0:
            return res, None
        ptrs, rows = slots()
        ssx, ssy = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (0, 0)}[fmt]
        out = []
        for k in range(len(planes)):
            sx, sy = (ssx, ssy) if 0 < k < n_yuv else (0, 0)
            w, h = (dst_width + sx) >> sx, (dst_height + sy) >> sy
            px = np.frombuffer(ctypes.string_at(ptrs[k], rows[k] * h), dt)
            out.append(px.reshape(h, rows[k] // np.dtype(dt).itemsize)[:, :w].copy())
        return res, out
    finally:
        a.avifImageDestroy(im)


def dav1d_planes(obus):
    """dav1d's decode of an AV1 item's OBUs: [Y] or [Y, U, V] as arrays of
    the frame's (chroma) size, uint8 at 8 bits and uint16 above, or None
    where dav1d fails."""
    a = lib()
    settings = ctypes.create_string_buffer(1024)
    a.dav1d_default_settings(settings)
    # frame threads, as libavif's dav1d runs: every OBU of the data is parsed
    # before the frame is output, and an error in any fails the decode
    struct.pack_into("<ii", settings, 0, 2, 2)  # n_threads, max_frame_delay
    ctx = ctypes.c_void_p()
    assert a.dav1d_open(ctypes.byref(ctx), settings) == 0
    try:
        data = ctypes.create_string_buffer(256)
        buf = a.dav1d_data_create(data, len(obus))
        ctypes.memmove(buf, obus, len(obus))
        res = a.dav1d_send_data(ctx, data)
        if res < 0 and res != -11:  # DAV1D_ERR(EAGAIN)
            return None
        pic = ctypes.create_string_buffer(1024)
        for _ in range(8):  # drain
            res = a.dav1d_get_picture(ctx, pic)
            if res != -11:
                break
        if res != 0:
            return None
        raw = pic.raw
        ptrs = struct.unpack_from("<3Q", raw, 16)
        strides = struct.unpack_from("<2q", raw, 40)
        w, h, layout, bpc = struct.unpack_from("<4i", raw, 56)
        dt = np.uint8 if bpc == 8 else np.dtype("<u2")

        def plane(ptr, stride, pw, ph):
            rows = np.frombuffer(ctypes.string_at(ptr, stride * ph), dt)
            return rows.reshape(ph, stride // dt.itemsize if bpc > 8 else stride)[:, :pw].copy()

        out = [plane(ptrs[0], strides[0], w, h)]
        if layout != 0:  # I400, I420, I422, I444
            ssx, ssy = int(layout in (1, 2)), int(layout == 1)
            cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
            out += [plane(ptrs[1], strides[1], cw, ch), plane(ptrs[2], strides[1], cw, ch)]
        a.dav1d_picture_unref(pic)
        return out
    finally:
        a.dav1d_close(ctypes.byref(ctx))
