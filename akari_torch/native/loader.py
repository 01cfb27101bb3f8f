"""Build the native BVH builder at first use and load it with ctypes.

Counterpart of ``akari_tpu/native/loader.py``. ``bvh_builder.cpp`` (a copy
of the reference's source) is compiled by ``g++`` with the reference
loader's flags into ``build/akari_torch_native/<hash>/libakr_bvh.so`` at
the repository root, keyed by a hash of the source, the compiler and the
flags, and loaded with ``ctypes``. Nothing is built at import time.

Unlike the reference loader, a failed build raises: the Python builder
would give another triangle storage order, so there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "bvh_builder.cpp")
REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "akari_torch_native")

CXX = "g++"
# The reference loader's flags (akari_tpu/native/loader.py), no -march=native.
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_loaded = {}


def _library_path():
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join([CXX, *CXX_FLAGS, *LIBS]).encode()
        )
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16], "libakr_bvh.so")


def build():
    """Compile ``bvh_builder.cpp`` unless its keyed library exists; return
    the library path. Raises ``RuntimeError`` if the compiler is missing
    or fails."""
    lib = _library_path()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: the native BVH builder (scenes of "
            "20,000 triangles or more) needs a C++ compiler"
        )
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SRC, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{CXX} failed ({proc.returncode}) building {SRC}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def load():
    """Build if needed and ``ctypes``-load the builder (cached per path)."""
    with _lock:
        path = build()
        if path not in _loaded:
            lib = ctypes.CDLL(path)
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
            _loaded[path] = lib
        return _loaded[path]
