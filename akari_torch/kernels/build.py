"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel source under ``kernels/csrc`` has a plain C interface. It is
compiled by ``nvcc`` into a shared library under
``build/akari_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, and
loaded with ``ctypes``. Nothing is
built at import time: the CPU tests import every module without ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``--fmad=false`` so that float
arithmetic is rounded op by op exactly as the plain PyTorch versions round
it, and no ``--use_fast_math`` (IEEE division and square root).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "akari_torch_kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded = {}
# name -> (seconds, ptxas report) of builds done by this process
BUILD_LOG = {}


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels need the CUDA toolkit to build"
    )


def _library_path(name):
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    key = digest.hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, key, f"lib{name}.so")


def build(name):
    """Compile ``csrc/<name>.cu`` unless its keyed library exists; return
    the library path."""
    src, lib = _library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr.strip())
    return lib


def load(name):
    """Build if needed and ``ctypes``-load ``csrc/<name>.cu`` (cached)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
