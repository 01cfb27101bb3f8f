"""The device rule of the port's entry points.

Functions that create tensors from host data alone (``compile_scene``,
``Scene.compile``, ``from_numpy_scene``, a torch ``Film``, the ray mesh)
take ``device="cuda"`` by default and never fall back: without a CUDA
device they raise, and the caller asks for the CPU with ``device="cpu"``,
as the CLI asks with ``--device cpu``. Functions that take a scene or a
tensor run on its device.
"""

from __future__ import annotations

import torch


def target_device(device, what):
    """``torch.device(device)``; a CUDA device without CUDA raises
    ``RuntimeError`` naming ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device}: no CUDA device is available "
                           '(pass device="cpu" to run on the CPU)')
    return dev
