"""The port's Szudzik pair / unpair / isqrt against `repro.core.pairing`
and the `repro.kernels.ref` oracles, bit for bit (zero tolerance)."""
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core  # noqa: F401
from repro.core import pairing as jp
from repro.kernels import ref
from repro_torch._u64 import from_u64_numpy, to_u64_numpy
from repro_torch.core import pairing as tp

U64_EDGES = [0, 1, 2, 3, 4, 2**32 - 1, 2**32, (2**32 - 1) ** 2,
             (2**32 - 1) ** 2 - 1, (2**32 - 1) ** 2 + 1, 2**63, 2**64 - 2,
             2**64 - 1]
U32_EDGES = [0, 1, 2, 2**31, 2**32 - 2, 2**32 - 1]

u64s = st.lists(st.one_of(st.integers(0, 2**64 - 1), st.sampled_from(U64_EDGES),
                          st.integers(0, 2**20)), min_size=1, max_size=64)
u32s = st.lists(st.one_of(st.integers(0, 2**32 - 1), st.sampled_from(U32_EDGES)),
                min_size=1, max_size=64)


def _t(a):
    return from_u64_numpy(np.asarray(a, dtype=np.uint64))


@settings(max_examples=60, deadline=None)
@given(u64s)
def test_isqrt_and_unpair_match_reference(zs):
    z = np.asarray(zs + U64_EDGES, dtype=np.uint64)
    np.testing.assert_array_equal(
        tp.isqrt_u64(_t(z)).numpy().astype(np.uint64),
        np.asarray(jp.isqrt_u64(jnp.asarray(z))))
    x, y = tp.szudzik_unpair(_t(z))
    jx, jy = jp.szudzik_unpair(jnp.asarray(z))
    np.testing.assert_array_equal(x.numpy().astype(np.uint64), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy().astype(np.uint64), np.asarray(jy))


@settings(max_examples=60, deadline=None)
@given(u32s, u32s)
def test_pair_matches_reference_and_oracle(xs, ys):
    n = min(len(xs), len(ys))
    x = np.asarray(xs[:n] + U32_EDGES, dtype=np.uint32)
    y = np.asarray(ys[:n] + U32_EDGES[::-1], dtype=np.uint32)
    import torch
    code = tp.szudzik_pair(torch.from_numpy(x.astype(np.int64)),
                           torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_array_equal(
        to_u64_numpy(code),
        np.asarray(jp.szudzik_pair(jnp.asarray(x, jnp.uint64),
                                   jnp.asarray(y, jnp.uint64))))
    hi, lo = ref.szudzik_pair_ref(jnp.asarray(x), jnp.asarray(y))
    th, tl = tp.split_u64(code)
    np.testing.assert_array_equal(th.numpy().astype(np.uint32), np.asarray(hi))
    np.testing.assert_array_equal(tl.numpy().astype(np.uint32), np.asarray(lo))
    # roundtrip through the u32 (hi, lo) oracle of the unpair kernel
    rx, ry = ref.szudzik_unpair_ref(hi, lo)
    ux, uy = tp.szudzik_unpair(tp.join_u64(th, tl))
    np.testing.assert_array_equal(ux.numpy().astype(np.uint32), np.asarray(rx))
    np.testing.assert_array_equal(uy.numpy().astype(np.uint32), np.asarray(ry))
    np.testing.assert_array_equal(ux.numpy(), x.astype(np.int64))
    np.testing.assert_array_equal(uy.numpy(), y.astype(np.int64))


def test_triplet_encoding_and_search_range():
    import torch
    rng = np.random.default_rng(0)
    length = 80
    w = rng.integers(0, 2**20, size=500)
    p = rng.integers(0, length, size=500)
    v = rng.integers(0, 2**18, size=500)
    vlo, vhi = np.minimum(v, 7), np.maximum(v, 2**17)
    tw, tpp, tv = (torch.from_numpy(a) for a in (w, p, v))
    code = tp.encode_triplet(tw, tpp, tv, length)
    np.testing.assert_array_equal(
        to_u64_numpy(code),
        np.asarray(jp.encode_triplet(jnp.asarray(w, jnp.uint64), jnp.asarray(p, jnp.uint64),
                                     jnp.asarray(v, jnp.uint64), length)))
    dw, dp, dv = tp.decode_triplet(code, length)
    assert (dw.numpy() == w).all() and (dp.numpy() == p).all() and (dv.numpy() == v).all()
    f = tp.pack_wp(tw, tpp, length)
    lb, ub = tp.search_range(f, torch.from_numpy(vlo), torch.from_numpy(vhi))
    jlb, jub = jp.search_range(jnp.asarray(f.numpy(), jnp.uint64),
                               jnp.asarray(vlo, jnp.uint64), jnp.asarray(vhi, jnp.uint64))
    np.testing.assert_array_equal(to_u64_numpy(lb), np.asarray(jlb))
    np.testing.assert_array_equal(to_u64_numpy(ub), np.asarray(jub))
    assert bool((lb <= code).all()) and bool((code <= ub).all())


def test_cantor_pair_matches_reference():
    """`cantor_pair` on u64 operands, the wrapping ones included (s = x + y
    and s (s + 1) past 2^64), bit for bit."""
    import torch
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint64),
                        rng.integers(0, 2**64 - 1, 200, dtype=np.uint64, endpoint=True),
                        np.asarray(U64_EDGES, dtype=np.uint64)])
    y = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint64),
                        rng.integers(0, 2**64 - 1, 200, dtype=np.uint64, endpoint=True),
                        np.asarray(U64_EDGES[::-1], dtype=np.uint64)])
    got = tp.cantor_pair(torch.from_numpy(x.view(np.int64)),
                         torch.from_numpy(y.view(np.int64)))
    np.testing.assert_array_equal(
        to_u64_numpy(got), np.asarray(jp.cantor_pair(jnp.asarray(x), jnp.asarray(y))))


def test_isqrt_around_the_exact_seed_bound():
    """`isqrt_u64` takes the float64 seed as the root below 2^52 on the CPU
    and corrects it above: squares and their neighbours on both sides of
    the bound, against the reference."""
    roots = [2**26 - 2, 2**26 - 1, 2**26, 2**26 + 1, 2**20 + 7, 3]
    z = sorted({r * r + d for r in roots for d in (-1, 0, 1, 2 * r)}
               | {2**52 - 2, 2**52 - 1, 2**52, 2**52 + 1})
    z = np.asarray(z, dtype=np.uint64)
    np.testing.assert_array_equal(tp.isqrt_u64(_t(z)).numpy().astype(np.uint64),
                                  np.asarray(jp.isqrt_u64(jnp.asarray(z))))
    x, y = tp.szudzik_unpair(_t(z))
    jx, jy = jp.szudzik_unpair(jnp.asarray(z))
    np.testing.assert_array_equal(x.numpy().astype(np.uint64), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy().astype(np.uint64), np.asarray(jy))
