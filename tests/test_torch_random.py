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


def test_normal_matches_jax_bit_for_bit():
    """float32 `normal` = `jax.random.normal` bit for bit (0 ulp) over 2^20
    draws: XLA's erf_inv polynomial and its own f32 log1p, with FMA where
    XLA's CPU backend contracts."""
    for seed in range(16):
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.normal(kj, (1 << 16,), jnp.float32))
        got = jr.normal(jr.PRNGKey(seed, device="cpu"), (1 << 16,)).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    kj = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(kj, (3, 7), jnp.float32))
    got = jr.normal(jr.PRNGKey(3, device="cpu"), (3, 7)).numpy()
    assert got.shape == (3, 7)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(TypeError):
        jr.normal(jr.PRNGKey(3, device="cpu"), (2,), torch.float64)


@pytest.mark.parametrize("part", range(4))
def test_erfinv_and_log1p_match_xla_on_every_normal_input(part):
    """`normal` draws u from 2^23 values (a mantissa, scaled by 2 and
    shifted by nextafter(-1, 0)); a quarter of them each case, every
    fourth mantissa from `part`: `log1p32(-u^2)` and `erfinv32(u)` equal
    XLA's jitted `log1p` and `erf_inv` bit for bit."""
    from jax import lax
    m = np.arange(part, 1 << 23, 4, dtype=np.uint32)
    u = ((m | 0x3F800000).view(np.float32) - np.float32(1)) * np.float32(2)
    u = np.maximum(u + np.nextafter(np.float32(-1), np.float32(0)),
                   np.nextafter(np.float32(-1), np.float32(0)))
    want_l, want_e = jax.jit(lambda x: (jnp.log1p(x * -x), lax.erf_inv(x)))(u)
    t = torch.from_numpy(u)
    np.testing.assert_array_equal(jr.log1p32(t * -t).numpy().view(np.int32),
                                  np.asarray(want_l).view(np.int32))
    np.testing.assert_array_equal(jr.erfinv32(t).numpy().view(np.int32),
                                  np.asarray(want_e).view(np.int32))


def test_fma32_rounds_once():
    """`fma32` is a true float32 FMA where a float64 sum rounded to float32
    is not: (1 + 2^-12)^2 is the midpoint 1 + 2^-11 + 2^-24 of two floats,
    and + 2^-80 puts the exact sum just above it. The f64 sum drops the
    2^-80 and ties to even (down); one rounding goes up."""
    a = torch.tensor([1.0 + 2**-12, -(1.0 + 2**-12), 3.0], dtype=torch.float32)
    c = torch.tensor([2.0**-80, -(2.0**-80), -0.25], dtype=torch.float32)
    got = jr.fma32(a, a.abs(), c)
    up = 1.0 + 2**-11 + 2**-23
    assert got.tolist() == [up, -up, 8.75]
    twice = (a.double() * a.abs().double() + c.double()).float()
    assert twice.tolist()[:2] == [1.0 + 2**-11, -(1.0 + 2**-11)]


# the draws of the stream generators (data/streams.py): shapes with a
# [n, 4] quadrant axis and odd lengths
DRAW_SHAPES = ((), (7,), (1001,), (257, 4), (3, 33, 4))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_range_matches_jax(dtype):
    """`floats * (maxval - minval) + minval` is one FMA in XLA's CPU code:
    `fma32` / `fma64` round it once, as it does; then the max with minval."""
    tdt = getattr(torch, dtype)
    bounds = ((-1.7, 3.3), (0.25, 0.5), (-1e3, 1e-3), (2.0, 2.0),
              (np.finfo(dtype).tiny, 1.0), (1e-300, 7.0))
    for seed in range(0, 40, 7):
        kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
        for shape in DRAW_SHAPES:
            for lo, hi in bounds:
                want = np.asarray(jax.random.uniform(kj, shape, dtype, lo, hi))
                got = jr.uniform(kt, shape, tdt, lo, hi).numpy()
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                              want.reshape(-1).view(np.uint8))
    # array bounds broadcast against the shape
    lo = np.linspace(-2, 1, 4).astype(dtype)
    want = jax.random.uniform(jax.random.PRNGKey(3), (9, 4), dtype, lo, lo + 3)
    got = jr.uniform(jr.PRNGKey(3, device="cpu"), (9, 4), tdt,
                     torch.from_numpy(lo), torch.from_numpy(lo + 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fma64_rounds_once():
    """(1 + 2^-27)(1 + 2^-26) = 1 + 2^-26 + 2^-27 + 2^-53 is the midpoint of
    two doubles, and + 2^-110 puts the exact sum just above it: the product
    rounded first ties to even (down) and drops it; one rounding goes up."""
    a = torch.tensor([1.0 + 2**-27, -(1.0 + 2**-27), 3.0], dtype=torch.float64)
    b = torch.tensor([1.0 + 2**-26, 1.0 + 2**-26, 3.0], dtype=torch.float64)
    c = torch.tensor([2.0**-110, -(2.0**-110), -0.25], dtype=torch.float64)
    got = jr.fma64(a, b, c)
    up = 1.0 + 2**-26 + 2**-27 + 2**-52
    assert got.tolist() == [up, -up, 8.75]
    down = 1.0 + 2**-26 + 2**-27
    assert (a * b + c).tolist()[:2] == [down, -down]


def test_gumbel_matches_jax():
    """float32: bit for bit (XLA's own f32 log, `_log32`). float64: the
    uniforms are bit for bit, the logs torch's, which differ from XLA's f64
    log in the last bit for a few draws in a thousand; -log(-log u) keeps
    that an absolute error of a few 1e-16 (its size where |g| < 1)."""
    for seed in range(4):
        kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
        for shape in DRAW_SHAPES + ((1 << 16,),):
            want = np.asarray(jax.random.gumbel(kj, shape, jnp.float32))
            got = jr.gumbel(kt, shape, torch.float32).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            want = np.asarray(jax.random.gumbel(kj, shape))
            got = jr.gumbel(kt, shape).numpy()
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=5e-16, atol=5e-16)
            assert np.mean(got == want) > 0.98


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_categorical_ids_match_jax(dtype):
    """The sampled ids are bit for bit: an f64 draw flips only where two
    candidates' noisy logits lie within an ulp or two (see gumbel)."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    for probs in ([0.5, 0.1, 0.1, 0.3], [0.25] * 4, [0.9, 0.05, 0.03, 0.02]):
        logits = np.log(np.asarray(probs, dtype))
        for seed in range(3):
            kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
            for shape in ((1,), (4097,), (3, 65)):
                want = np.asarray(jax.random.categorical(kj, logits, shape=shape))
                got = jr.categorical(kt, torch.from_numpy(logits), shape).numpy()
                assert got.dtype == want.dtype == np.int64
                np.testing.assert_array_equal(got, want)
    # batched logits [n, k]: one categorical a row; and a leading sample axis
    batch = np.log(rng.dirichlet(np.ones(5), size=33)).astype(dtype)
    kj, kt = jax.random.PRNGKey(9), jr.PRNGKey(9, device="cpu")
    for shape in (None, (7, 33)):
        want = np.asarray(jax.random.categorical(kj, batch, shape=shape))
        got = jr.categorical(kt, torch.from_numpy(batch), shape).numpy()
        np.testing.assert_array_equal(got, want)


def test_bernoulli_matches_jax():
    for seed in range(5):
        kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
        for p, shape in ((0.01, (33, 77)), (0.5, (1001,)), (0.8, ())):
            want = np.asarray(jax.random.bernoulli(kj, p, shape))
            np.testing.assert_array_equal(jr.bernoulli(kt, p, shape).numpy(), want)
        p = np.linspace(0, 1, 19).astype(np.float32)
        want = np.asarray(jax.random.bernoulli(kj, p))
        np.testing.assert_array_equal(jr.bernoulli(kt, torch.from_numpy(p)).numpy(),
                                      want)
