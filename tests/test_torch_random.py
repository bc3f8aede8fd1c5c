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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_matches_jax(dtype):
    tdt = getattr(torch, dtype)
    for seed in range(0, 60, 3):
        kj = jax.random.PRNGKey(seed)
        kt = jr.PRNGKey(seed, device="cpu")
        for shape in ((), (7,), (33, 2)):
            want = np.asarray(jax.random.uniform(kj, shape, dtype=dtype))
            got = jr.uniform(kt, shape, tdt).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                          want.reshape(-1).view(np.uint8))
            assert ((got >= 0) & (got < 1)).all()


def test_per_lane_keys_match_vmap():
    """One key per lane ([B, 2]): fold_in over lane ids, then split,
    randint and uniform per key, as the reference's `jax.vmap` chain in
    `_node2vec_step_perlane`."""
    kj = jax.random.PRNGKey(17)
    kt = jr.as_key(np.asarray(kj), "cpu")
    lanes = np.array([0, 1, 5, 63, 2**31 - 1, 2**32 - 1], np.int64)
    lk = jax.vmap(lambda i: jax.random.fold_in(kj, i))(jnp.asarray(lanes, jnp.uint32))
    lkt = jr.fold_in(kt, torch.from_numpy(lanes))
    np.testing.assert_array_equal(_np(lk), lkt.numpy())
    sp = jax.vmap(lambda k: jax.random.split(k, 8))(lk)
    spt = jr.split(lkt, 8)
    np.testing.assert_array_equal(_np(sp), spt.numpy())
    k12 = jax.vmap(jax.vmap(jax.random.split))(sp)           # [B, 8, 2, 2]
    k12t = jr.split(spt, 2)
    np.testing.assert_array_equal(_np(k12), k12t.numpy())
    maxval = np.arange(1, 7)[:, None] * np.arange(1, 9)[None]  # [B, 8]
    want = jax.vmap(jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m)))(
        k12[:, :, 0], jnp.asarray(maxval))
    got = jr.randint(k12t[:, :, 0], (), 0, torch.from_numpy(maxval))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    want = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(k12[:, :, 1])
    got = jr.uniform(k12t[:, :, 1], (), torch.float64)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # a batch of keys, each drawing a whole vector
    ks = jax.random.split(kj, 4)
    want = jax.vmap(lambda k: jax.random.randint(k, (5,), 0, jnp.arange(1, 6)))(ks)
    got = jr.randint(jr.as_key(np.asarray(ks), "cpu"), (5,), 0, torch.arange(1, 6))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("lo,hi", [(0, 1000), (0, 2**18), (-5, 2**31 - 1),
                                   (3, 3), (7, 2), (0, 2**40),
                                   (-2**31, 2**31 - 1), (-2**31, 2**40)])
def test_randint_int32_matches_jax(lo, hi):
    """The 32-bit draw (the maintainer's negatives) consumes other bits
    than the int64 one; bit for bit, over int32 limits and a maxval above
    the int32 range (the last case: a span of 2^32, which wraps to 0)."""
    for seed in range(0, 60, 3):
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(kj, (4, 33), lo, hi, dtype=jnp.int32))
        got = jr.randint(jr.PRNGKey(seed, device="cpu"), (4, 33), lo, hi,
                         dtype=torch.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    want = jax.vmap(lambda k: jax.random.randint(k, (5,), lo, hi, dtype=jnp.int32))(ks)
    got = jr.randint(jr.as_key(np.asarray(ks), "cpu"), (5,), lo, hi, dtype=torch.int32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_normal_within_four_ulp_of_jax():
    """float32 `normal`: XLA's erf_inv polynomial in its order; the log1p
    inside it is torch's, not XLA's, so a draw may differ by a few ulp.
    Held to 4 ulp over 2^20 draws."""
    worst = 0
    for seed in range(16):
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.normal(kj, (1 << 16,), jnp.float32))
        got = jr.normal(jr.PRNGKey(seed, device="cpu"), (1 << 16,)).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        worst = max(worst, int(ulps.max()))
    assert worst <= 4, worst
    kj = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(kj, (3, 7), jnp.float32))
    got = jr.normal(jr.PRNGKey(3, device="cpu"), (3, 7)).numpy()
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, want, rtol=4 * 2**-23, atol=0)
    with pytest.raises(TypeError):
        jr.normal(jr.PRNGKey(3, device="cpu"), (2,), torch.float64)
