"""The port's threefry draws against `jax.random`, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64, as the reference draws)
from repro_torch import random as jr

SEEDS = list(range(200)) + [2**31 - 1, 2**32 + 7, 2**63 - 1]


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_prng_key_split_fold_in_match_jax():
    for seed in SEEDS:
        kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
        np.testing.assert_array_equal(_np(kj), kt.numpy())
        for n in (1, 2, 3, 8):
            np.testing.assert_array_equal(_np(jax.random.split(kj, n)),
                                          jr.split(kt, n).numpy())
        for d in (0, 1, seed % 2**32, 2**32 - 1):
            np.testing.assert_array_equal(_np(jax.random.fold_in(kj, d)),
                                          jr.fold_in(kt, d).numpy())


@pytest.mark.parametrize("size", [1, 7, 129, 1 << 16])
def test_randint_int64_array_maxval_matches_jax(size):
    rng = np.random.default_rng(size)
    for seed in range(0, 200, 40 if size == 1 << 16 else 1):
        maxval = rng.integers(-3, 2**31 - 1, size=size).astype(np.int32)
        maxval[: min(size, 4)] = [1, 0, 2**31 - 1, 2][: min(size, 4)]
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(kj, (size,), 0,
                                             jnp.maximum(jnp.asarray(maxval), 1)))
        assert want.dtype == np.int64
        got = jr.randint(jr.PRNGKey(seed, device="cpu"), (size,), 0,
                         torch.clamp(torch.from_numpy(maxval), min=1))
        np.testing.assert_array_equal(want, got.numpy())


def test_randint_scalar_bounds_and_empty_span():
    kj = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    kt = jr.as_key(np.asarray(kj), "cpu")
    for lo, hi in ((0, 10), (3, 3), (5, 2), (-7, 1000)):
        want = np.asarray(jax.random.randint(kj, (33,), lo, hi))
        got = jr.randint(kt, (33,), lo, hi).numpy()
        np.testing.assert_array_equal(want, got)
