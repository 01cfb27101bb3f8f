"""Port parity: the counter-based RNG lattice (akari_torch.core.rng vs
akari_tpu.core.rng). Tolerance: none. Words and floats must be equal bit
for bit, since identical random numbers are what make every later parity
test possible."""

import numpy as np
import pytest
import torch

from akari_torch.core import rng
from akari_tpu.core import rng as ref_rng

torch.set_num_threads(2)

SEEDS = [0, 1, 12345, 0x9E3779B9, 2**31 - 1, 2**31, 2**32 - 1]
DIMS = [0, 1, 2, 5, 4 + 8 * 7 + 6, 8191, 8192, 8193, 123457, 2**31 + 3]


def _lattice():
    r = np.random.default_rng(0)
    pixels = np.concatenate(
        [np.arange(48), r.integers(0, 2**24, 200), [2**24 - 1, 2**24]]
    ).astype(np.uint32)
    samples = np.asarray([0, 1, 3, 1000, 65535, 2**31 + 5], np.uint32)
    p, s = np.meshgrid(pixels, samples, indexing="ij")
    return p.ravel(), s.ravel()


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_u32_bit_exact(seed):
    pix, smp = _lattice()
    for dim in DIMS:
        ref = ref_rng.random_u32(np.uint32(seed), pix, smp, np.uint32(dim))
        got = rng.random_u32(seed, _t(pix), _t(smp), dim)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_exact(seed):
    pix, smp = _lattice()
    for dim in DIMS:
        ref = ref_rng.uniform(np.uint32(seed), pix, smp, np.uint32(dim))
        got = rng.uniform(seed, _t(pix), _t(smp), dim).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
        assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform_matches_jax_backend():
    """The JAX program draws the same floats as its NumPy oracle and the port."""
    import jax.numpy as jnp

    pix, smp = _lattice()
    for dim in (3, 8200):
        ref = np.asarray(
            ref_rng.uniform(jnp.uint32(7), jnp.asarray(pix), jnp.asarray(smp), dim)
        )
        got = rng.uniform(7, _t(pix), _t(smp), dim).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_pcg_hash_bit_exact_full_range():
    r = np.random.default_rng(1)
    x = np.concatenate(
        [[0, 1, 2**31 - 1, 2**31, 2**32 - 1], r.integers(0, 2**32, 4096)]
    ).astype(np.uint32)
    np.testing.assert_array_equal(
        rng.pcg_hash(_t(x)).numpy(), ref_rng.pcg_hash(x).astype(np.int64)
    )
    y = r.integers(0, 2**32, x.shape[0]).astype(np.uint32)
    np.testing.assert_array_equal(
        rng.hash_combine(_t(x), _t(y)).numpy(),
        ref_rng.hash_combine(x, y).astype(np.int64),
    )


def test_pixels_above_2_31_wrap_like_uint32():
    """The golden-ratio multiply must wrap mod 2^32 for any u32 pixel."""
    pix = np.asarray([2**31, 2**32 - 1, 3 * 2**30 + 7], np.uint32)
    smp = np.zeros(3, np.uint32)
    ref = ref_rng.random_u32(np.uint32(9), pix, smp, np.uint32(4))
    got = rng.random_u32(9, _t(pix), _t(smp), 4)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_bounce_dim_layout():
    for b in range(6):
        for off in (rng.OFF_BSDF_U, rng.OFF_MIX, rng.OFF_LIGHT_SELECT,
                    rng.OFF_LIGHT_U, rng.OFF_RR):
            assert rng.bounce_dim(b, off) == ref_rng.bounce_dim(b, off)
