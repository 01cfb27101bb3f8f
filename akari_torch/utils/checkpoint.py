"""Checkpoint / resume for long renders and inverse-rendering runs
(``akari_tpu/utils/checkpoint.py``).

Render state (film accumulator, next sample index, RNG seed, a JSON
``meta`` dict) is written in the JAX package's ``.npz`` format: the same
keys and dtypes, ``meta`` as UTF-8 JSON bytes in a uint8 array, so a
render checkpointed by either package resumes in the other. Train state
(parameters, optimizer state, step, seed) is a ``torch.save`` file; the
JAX package pickles optax state or writes orbax directories, so the two
train formats differ. Every write goes to a temporary file first and is
moved into place with ``os.replace``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_render_state(path, radiance_sum, next_sample, seed, meta=None):
    """Atomic save of a progressive render accumulator ([H, W, 3])."""
    if isinstance(radiance_sum, torch.Tensor):
        radiance_sum = radiance_sum.detach().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        radiance_sum=np.asarray(radiance_sum, np.float32),
        next_sample=np.int64(next_sample),
        seed=np.int64(seed),
        meta=np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load_render_state(path):
    """Returns (radiance_sum, next_sample, seed, meta) or None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode() or "{}")
        return (
            z["radiance_sum"],
            int(z["next_sample"]),
            int(z["seed"]),
            meta,
        )


def save_train_state(path, params, opt_state, step, seed):
    """Atomic ``torch.save`` of an inverse-rendering loop's state:
    ``params`` (a dict of tensors), ``opt_state`` (e.g. an optimizer's
    ``state_dict()``), ``step`` and ``seed``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"params": params, "opt_state": opt_state,
                "step": int(step), "seed": int(seed)}, tmp)
    os.replace(tmp, path)


def load_train_state(path, map_location=None):
    """The dict ``save_train_state`` wrote, or None if ``path`` does not
    exist."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
