"""Build the native libraries at first use and load them with ctypes.

Counterpart of ``akari_tpu/native/loader.py``. Each source of ``SOURCES``
is compiled by ``g++`` with the reference loader's flags into
``build/akari_torch_native/<hash>/<library>`` at the repository root, keyed
by a hash of the source, the compiler and the flags, and loaded with
``ctypes``. Nothing is built at import time.

- ``bvh``: ``bvh_builder.cpp`` (a copy of the reference's source), the
  binned-SAH BVH builder;
- ``jpeg``: ``jpeg_entropy.cpp``, the Huffman decoding of JPEG scans,
  lossy and lossless, and ``jpeg_arith``: ``jpeg_arith.cpp``, the
  arithmetic decoding of JPEG scans (``akari_torch/core/jpeg.py``);
- ``gif``: ``gif_lzw.cpp``, the LZW decoding of a GIF frame
  (``akari_torch/core/image_formats.py``);
- ``tiff``: ``tiff_lzw.cpp``, the LZW decoding of a TIFF strip or tile
  (``akari_torch/core/tiff.py``);
- ``webp_vp8l``: ``webp_vp8l.cpp``, lossless WebP images and alpha planes,
  and ``webp_vp8``: ``webp_vp8.cpp``, lossy WebP key frames to RGB
  (``akari_torch/core/webp.py``);
- ``bcn``: ``bcn.cpp``, the BC1-BC7 blocks of DDS and FTEX textures
  (``akari_torch/core/dds.py``, ``ftex.py``);
- ``qoi``: ``qoi.cpp``, the op stream of QOI images (``core/qoi.py``);
- ``rle``: ``rle.cpp``, the run-length data of SGI, PCX and Sun raster
  images, FLI / FLC frames and ThunderScan TIFF strips (``core/sgi.py``,
  ``core/pcx.py``, ``core/sun.py``, ``core/fli.py``, ``core/tiff.py``);
- ``zstd``: ``zstd.cpp``, Zstandard frames (RFC 8878) of ZSTD-compressed
  TIFF strips and tiles (``core/tiff.py``); no compression library is
  linked;
- ``fax3``: ``fax3.cpp``, the CCITT RLE, RLEW, Group 3 and Group 4 strips
  and tiles of TIFF files (``core/tiff.py``);
- ``j2k``: ``j2k_decode.cpp``, JPEG 2000 codestreams (``core/jpeg2000.py``);
- ``lcms``: ``lcms_lab.cpp``, LittleCMS's tetrahedral interpolation of 8-bit
  Lab pixels on the Lab -> sRGB table (``core/lcms.py``);
- ``av1``: ``av1_decode.cpp``, the AV1 intra frames of AVIF images to YUV
  planes, libavif's (libyuv's) plane scaling and YUV -> RGB
  (``core/avif.py``); its default CDFs and lookup tables are in
  ``av1_tables.h``.

Unlike the reference loader, a failed build raises: the Python BVH builder
would give another triangle storage order, and the JPEG (Huffman and
arithmetic), GIF, TIFF, WebP,
BCn, QOI, SGI / PCX / SUN / FLI run-length, Zstandard, CCITT, ThunderScan, JPEG 2000
and AV1 decoders and the Lab evaluator have no Python twin, so there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "akari_torch_native")

CXX = "g++"
# The reference loader's flags (akari_tpu/native/loader.py), no -march=native.
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpthread"]
# flags a source needs besides CXX_FLAGS (never -ffast-math or -march=native)
EXTRA_FLAGS = {"j2k": ["-ffp-contract=off"]}
# headers a source includes, hashed with it into the library's key
HEADERS = {"j2k": ("j2k_ht_tables.h",), "av1": ("av1_tables.h",)}


def _bind_bvh(lib):
    fp, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.akr_bvh_build.restype = ctypes.c_int
    lib.akr_bvh_build.argtypes = [
        fp, fp, fp,                        # p0, p1, p2
        ctypes.c_int64, ctypes.c_int,      # n_tris, max_leaf
        fp, fp,                            # node_lo, node_hi
        i32p, i32p, i32p, i32p,            # first, count, miss, order
        ctypes.c_int64,                    # max_nodes
        ctypes.POINTER(ctypes.c_int64),    # out_n_nodes
    ]


def _bind_jpeg(lib):
    i32 = ctypes.c_int32
    lib.akr_jpeg_scan.restype = ctypes.c_int
    lib.akr_jpeg_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, start
        i32, ctypes.POINTER(ctypes.c_void_p),              # n_comp, planes
        ctypes.POINTER(i32), ctypes.c_char_p,              # geom, huff
        i32, i32, i32, i32, i32, i32,                      # mcus_x, mcus_y, ss, se, ah, al
        i32, i32,                                          # progressive, restart_interval
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i32),  # end_pos, last_good
        i32,                                               # strict_restart
    ]
    lib.akr_jpeg_lossless.restype = ctypes.c_int
    lib.akr_jpeg_lossless.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, start
        i32, ctypes.POINTER(ctypes.c_void_p),              # n_comp, planes
        ctypes.POINTER(i32), ctypes.c_char_p,              # geom, huff
        i32, i32, i32, i32, i32,                           # mcus_x, mcus_y, psv, pt, restart
        ctypes.POINTER(ctypes.c_int64),                    # end_pos
    ]


def _bind_jpeg_arith(lib):
    i32 = ctypes.c_int32
    lib.akr_jpeg_arith_scan.restype = ctypes.c_int
    lib.akr_jpeg_arith_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, start
        i32, ctypes.POINTER(ctypes.c_void_p),              # n_comp, planes
        ctypes.POINTER(i32), ctypes.c_char_p,              # geom, tables
        ctypes.c_char_p,                                   # cond (L, U, K)
        i32, i32, i32, i32, i32, i32,                      # mcus_x, mcus_y, ss, se, ah, al
        i32, i32,                                          # progressive, restart_interval
        ctypes.POINTER(ctypes.c_int64),                    # end_pos
    ]


def _bind_gif(lib):
    i32 = ctypes.c_int32
    lib.akr_gif_lzw.restype = ctypes.c_int
    lib.akr_gif_lzw.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, start
        ctypes.c_int64,                                    # chunk
        i32, i32, i32, i32,                                # bits, xsize, ysize, interlace
        ctypes.c_void_p,                                   # frame
    ]


def _bind_tiff(lib):
    lib.akr_tiff_lzw.restype = ctypes.c_int
    lib.akr_tiff_lzw.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # src, size
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,   # dst, occ, compat
    ]


def _bind_vp8l(lib):
    i32 = ctypes.c_int32
    lib.akr_vp8l_decode.restype = ctypes.c_int
    lib.akr_vp8l_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # data, size
        i32, i32, i32,                                     # width, height, alpha
        ctypes.c_void_p,                                   # argb
    ]


def _bind_vp8(lib):
    i32 = ctypes.c_int32
    lib.akr_vp8_decode.restype = ctypes.c_int
    lib.akr_vp8_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # data, size
        i32, i32, ctypes.c_void_p,                         # width, height, rgb
    ]


def _bind_bcn(lib):
    i32, u8p = ctypes.c_int32, ctypes.c_void_p
    for name in ("akr_bc1", "akr_bc2", "akr_bc3", "akr_bc4", "akr_bc7"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, u8p]
    for name in ("akr_bc5", "akr_bc6h"):  # ... and whether the block is signed
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, i32, u8p]


def _bind_qoi(lib):
    lib.akr_qoi_decode.restype = ctypes.c_int
    lib.akr_qoi_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, pos
        ctypes.c_int64, ctypes.c_void_p,                   # n_pixels, rgb
    ]


def _bind_rle(lib):
    i32 = ctypes.c_int32
    lib.akr_sgi_rle.restype = ctypes.c_int
    lib.akr_sgi_rle.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # buf, size
        i32, i32, i32, i32, ctypes.c_void_p,               # xsize, ysize, zsize, bpc, out
    ]
    lib.akr_pcx_rle.restype = ctypes.c_int
    lib.akr_pcx_rle.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # src, size
        i32, i32, i32, i32, ctypes.c_void_p,               # xsize, bits, line, ysize, out
    ]
    lib.akr_thunder.restype = ctypes.c_int
    lib.akr_thunder.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # src, size
        i32, i32, i32, ctypes.c_void_p,                    # width, rows, rowbytes, out
    ]
    lib.akr_sun_rle.restype = ctypes.c_int
    lib.akr_sun_rle.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # src, size, total
        ctypes.c_void_p,                                   # out
    ]
    lib.akr_fli_frame.restype = ctypes.c_int64
    lib.akr_fli_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # buf, bytes
        i32, i32, ctypes.c_void_p,                         # xsize, ysize, im
    ]


def _bind_zstd(lib):
    lib.akr_zstd_decode.restype = ctypes.c_int
    lib.akr_zstd_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,                   # src, size
        ctypes.c_void_p, ctypes.c_int64,                   # dst, occ
    ]


def _bind_fax3(lib):
    i32 = ctypes.c_int32
    lib.akr_fax_strip.restype = ctypes.c_int
    lib.akr_fax_strip.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # src, size, offset
        i32, i32, i32, i32,                                # kind, width, rows, rowbytes
        ctypes.POINTER(i32), ctypes.c_void_p, ctypes.c_void_p,  # state, runs, out
    ]
    lib.akr_fax_runs.restype = ctypes.c_int64
    lib.akr_fax_runs.argtypes = [i32, i32]                 # width, kind


def _bind_j2k(lib):
    i32 = ctypes.c_int32
    lib.akr_j2k_decode.restype = ctypes.c_int
    lib.akr_j2k_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # data, size, start
        i32, i32, i32, ctypes.c_char_p,                    # ihdr_w, ihdr_h, color_space, mode
        i32, i32, ctypes.c_void_p, ctypes.c_void_p,        # xsize, ysize, out8, out16
        ctypes.c_void_p, ctypes.c_char_p, i32,             # ycc, err, errlen
    ]


def _bind_lcms(lib):
    lib.akr_lab8_to_rgb8.restype = None
    lib.akr_lab8_to_rgb8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # clut, lab, n
        ctypes.c_void_p,                                   # rgb
    ]


def _bind_av1(lib):
    i32, p = ctypes.c_int32, ctypes.c_void_p
    lib.akr_av1_probe.restype = ctypes.c_int
    lib.akr_av1_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, p,                # data, size, info[30]
        ctypes.c_char_p, i32,                              # err, errlen
    ]
    lib.akr_av1_sequence_header.restype = ctypes.c_int
    lib.akr_av1_sequence_header.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, i32,  # payload, size, err, errlen
    ]
    lib.akr_av1_decode.restype = ctypes.c_int
    lib.akr_av1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, p, p, p,          # data, size, y, u, v (uint16)
        p, ctypes.c_char_p, i32,                           # stats[14], err, errlen
    ]
    lib.akr_yuv_to_rgb.restype = None
    lib.akr_yuv_to_rgb.argtypes = [
        p, p, p, i32, i32,                                 # y, u, v, width, height
        i32, i32, i32, p, p,                               # ssx, ssy, mono, k[6], rgb
    ]
    lib.akr_scale_plane.restype = None
    lib.akr_scale_plane.argtypes = [p, i32, i32, p, i32, i32]  # src, w, h, dst, w, h
    lib.akr_scale_plane16.restype = None
    lib.akr_scale_plane16.argtypes = [p, i32, i32, p, i32, i32]


# name -> (source, library file, what needs it, ctypes binding)
SOURCES = {
    "bvh": ("bvh_builder.cpp", "libakr_bvh.so",
            "the native BVH builder (scenes of 20,000 triangles or more)", _bind_bvh),
    "jpeg": ("jpeg_entropy.cpp", "libakr_jpeg.so", "the JPEG decoder", _bind_jpeg),
    "jpeg_arith": ("jpeg_arith.cpp", "libakr_jpeg_arith.so", "the arithmetic-coded JPEG decoder",
                   _bind_jpeg_arith),
    "gif": ("gif_lzw.cpp", "libakr_gif.so", "the GIF decoder", _bind_gif),
    "tiff": ("tiff_lzw.cpp", "libakr_tiff.so", "the TIFF LZW decoder", _bind_tiff),
    "webp_vp8l": ("webp_vp8l.cpp", "libakr_vp8l.so", "the lossless WebP decoder", _bind_vp8l),
    "webp_vp8": ("webp_vp8.cpp", "libakr_vp8.so", "the lossy WebP decoder", _bind_vp8),
    "bcn": ("bcn.cpp", "libakr_bcn.so", "the DDS / FTEX block (BCn) decoder", _bind_bcn),
    "qoi": ("qoi.cpp", "libakr_qoi.so", "the QOI decoder", _bind_qoi),
    "rle": ("rle.cpp", "libakr_rle.so",
            "the SGI / PCX / Sun / FLI / ThunderScan run-length decoder", _bind_rle),
    "zstd": ("zstd.cpp", "libakr_zstd.so", "the TIFF ZSTD decoder", _bind_zstd),
    "fax3": ("fax3.cpp", "libakr_fax3.so", "the TIFF CCITT (fax) decoder", _bind_fax3),
    "j2k": ("j2k_decode.cpp", "libakr_j2k.so", "the JPEG 2000 decoder", _bind_j2k),
    "lcms": ("lcms_lab.cpp", "libakr_lcms.so", "the Lab -> sRGB transform", _bind_lcms),
    "av1": ("av1_decode.cpp", "libakr_av1.so", "the AVIF (AV1) decoder", _bind_av1),
}

_lock = threading.Lock()
_loaded = {}


def _library_path(name):
    src, lib, _, _ = SOURCES[name]
    digest = hashlib.sha256()
    for part in (src, *HEADERS.get(name, ())):
        with open(os.path.join(_HERE, part), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join([CXX, *CXX_FLAGS, *EXTRA_FLAGS.get(name, []), *LIBS]).encode())
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16], lib)


def build(name):
    """Compile the source ``name`` of ``SOURCES`` unless its keyed library
    exists; return the library path. Raises ``RuntimeError`` if the
    compiler is missing or fails."""
    lib = _library_path(name)
    if os.path.exists(lib):
        return lib
    src = os.path.join(_HERE, SOURCES[name][0])
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: {SOURCES[name][2]} needs a C++ compiler"
        )
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", tmp, src, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{CXX} failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def load(name):
    """Build if needed and ``ctypes``-load the library ``name`` (cached per
    path)."""
    with _lock:
        path = build(name)
        if path not in _loaded:
            lib = ctypes.CDLL(path)
            SOURCES[name][3](lib)
            _loaded[path] = lib
        return _loaded[path]
