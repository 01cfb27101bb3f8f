"""Deterministic counter-based RNG: the PCG hash lattice of ``akari_tpu``.

Every sample is a pure function of ``(seed, pixel, sample_index, dim)``
through PCG output-function hashing, so the port draws the very same
uint32 words as the JAX package and its NumPy oracle. That bit parity is
the test strategy: same decisions, same paths. ``torch.Generator`` is not
used for this reason.

Torch's uint32 op coverage is thin, so words are carried in int64 tensors
holding values in [0, 2^32): every multiply and add is masked with
``& 0xFFFFFFFF``, and right shifts of non-negative int64 values are the
logical shifts the hash needs.

Sample-stream layout (identical to the reference):

- dims 0-1: camera film jitter;  dims 2-3: lens
- per bounce ``b``: base = 4 + b * DIMS_PER_BOUNCE, offsets:
  +0,+1 bsdf sample u;  +2 material mix select;  +3 light select;
  +4,+5 light surface sample;  +6 russian roulette;  +7 reserved
"""

from __future__ import annotations

import torch

DIM_CAMERA = 0
DIM_LENS = 2
DIMS_BASE = 4
DIMS_PER_BOUNCE = 8
OFF_BSDF_U = 0
OFF_MIX = 2
OFF_LIGHT_SELECT = 3
OFF_LIGHT_U = 4
OFF_RR = 6

M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32.

    Split into 16-bit halves so no partial product leaves int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def pcg_hash(x):
    """PCG output-function hash: uint32 -> uint32 (int64 tensor in/out)."""
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def _as_u32(x, like):
    """Python int or tensor -> int64 tensor of u32 values on like's device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.tensor(int(x) & M32, dtype=torch.int64, device=like.device)


def hash_combine(a, b):
    """Mix two uint32 streams: h(a ^ h(b))."""
    return pcg_hash(a ^ pcg_hash(b))


def random_u32(seed, pixel, sample, dim):
    """uint32 word (as int64) for lattice point (seed, pixel, sample, dim).

    ``pixel`` must be a tensor; the others may be tensors or Python ints.
    """
    pixel = _as_u32(pixel, pixel)
    seed = _as_u32(seed, pixel)
    sample = _as_u32(sample, pixel)
    dim = _as_u32(dim, pixel)
    key = pcg_hash(seed ^ pcg_hash(dim ^ pcg_hash(sample)))
    return pcg_hash((_mul32(pixel, 0x9E3779B9) + key) & M32)


def uniform(seed, pixel, sample, dim):
    """float32 uniform in [0, 1) for the given lattice point."""
    bits = random_u32(seed, pixel, sample, dim)
    # u32 -> f32 rounds to nearest, as numpy/XLA do; 2^-32 scaling; cap
    # below 1.0 in f32.
    u = bits.to(torch.float32) * 2.3283064365386963e-10
    return torch.clamp(u, max=0.99999994)


def bounce_dim(bounce, offset):
    """Dimension index for a per-bounce draw."""
    return DIMS_BASE + bounce * DIMS_PER_BOUNCE + offset
