"""The plain versions of the port's kernels (FOR encode/decode, packed
FINDNEXT) against the JAX package's Pallas kernels run in interpret mode,
on the same packed inputs, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401
from repro.core import pairing as jp
from repro.kernels import delta as jdelta
from repro.kernels import range_search as jrs
from repro_torch._u64 import from_u32_numpy, from_u64_numpy, to_u32_numpy, to_u64_numpy
from repro_torch.core import packed_store
from repro_torch.core.pairing import szudzik_pair
from repro_torch.kernels import _build, delta, ops, range_search


def _codes_every_width(seed=1):
    """Sorted u64 codes whose 128-code chunks cover widths 8, 16, 32, 64
    (the last chunks are unsorted raw ones); 32 chunks in all."""
    rng = np.random.default_rng(seed)
    parts, base = [], np.uint64(1 << 40)
    for step in (100, 50_000, 3_000_000_000, 1 << 40):
        d = rng.integers(0, step, size=128 * 7, dtype=np.uint64)
        parts.append(base + np.cumsum(d, dtype=np.uint64))
        base = parts[-1][-1]
    raw = rng.integers(0, 2**64 - 1, size=128 * 4, dtype=np.uint64, endpoint=True)
    raw[:2] = [2**64 - 1, 0]
    return np.concatenate(parts + [raw])


def _jax_pack(codes):
    hi, lo = jp.split_u64(jnp.asarray(codes.reshape(-1, 128)))
    return jdelta.encode_chunks(hi, lo)


def test_encode_matches_reference_every_width():
    codes = _codes_every_width()
    jpk, jw, jah, jal = _jax_pack(codes)
    pk, w, ah, al = delta.encode_chunks(from_u64_numpy(codes).reshape(-1, 128))
    assert set(np.asarray(jw).tolist()) == {8, 16, 32, 64}
    for mine, ref in ((pk, jpk), (w, jw), (ah, jah), (al, jal)):
        np.testing.assert_array_equal(to_u32_numpy(mine), np.asarray(ref))
    assert delta.packed_nbytes(w) == jdelta.packed_nbytes(np.asarray(jw))


def test_decode_plain_matches_pallas_interpret():
    codes = _codes_every_width(2)
    jpk, jw, jah, jal = _jax_pack(codes)
    jhi, jlo = jdelta.decode_chunks(jpk, jw, jah, jal, interpret=True)
    want = np.asarray(jp.join_u64(jhi, jlo))
    t = [from_u32_numpy(np.asarray(a)) for a in (jpk, jw, jah, jal)]
    rows = torch.arange(t[0].shape[0])
    got = delta.decode_rows_plain(*t, rows)
    np.testing.assert_array_equal(to_u64_numpy(got), want)
    np.testing.assert_array_equal(want.reshape(-1), codes)
    # the wrapper on CPU tensors takes the plain version, gathered rows too
    perm = torch.flip(rows, [0])
    np.testing.assert_array_equal(to_u64_numpy(ops.delta_decode(*t, perm)),
                                  want[perm.numpy()])
    grid = packed_store.gather_decode(*t, perm.reshape(4, -1))
    assert grid.shape == (4, rows.shape[0] // 4, 128)


def test_search_plain_matches_pallas_interpret():
    """Hits in chunk k > 0, several hits in one chunk (max v wins), a hit
    in two chunks (the first wins) and misses."""
    rng = np.random.default_rng(3)
    c = 16
    f = np.sort(rng.integers(0, 5000, size=c * 128))
    v = rng.integers(0, 1 << 16, size=c * 128)
    codes = np.sort(to_u64_numpy(szudzik_pair(torch.from_numpy(f), torch.from_numpy(v))))
    jpk, jw, jah, jal = _jax_pack(codes)
    q, k = 12, 4
    cidx = rng.integers(0, c, size=(q, k)).astype(np.int32)
    cidx[0] = [3, 5, 5, 9]
    pick = rng.integers(0, k, size=q)
    lane = rng.integers(0, 128, size=q)
    ft, _ = jp.szudzik_unpair(jnp.asarray(codes[cidx[np.arange(q), pick] * 128 + lane]))
    ft = np.asarray(ft).astype(np.uint32)
    ft[-3:] = 7_000_000 + np.arange(3)            # misses
    jv, jfound = jrs.find_next_packed(jpk, jw, jah, jal, jnp.asarray(cidx),
                                      jnp.asarray(ft), interpret=True)
    t = [from_u32_numpy(np.asarray(a)) for a in (jpk, jw, jah, jal)]
    tv, tfound = ops.find_next_packed(*t, torch.from_numpy(cidx),
                                      torch.from_numpy(ft.astype(np.int64)))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    assert np.asarray(jfound)[:-3].all() and not np.asarray(jfound)[-3:].any()
    tv2, tf2 = range_search.find_next_packed_plain(*t, torch.from_numpy(cidx),
                                                   torch.from_numpy(ft.astype(np.int64)))
    assert torch.equal(tv, tv2) and torch.equal(tfound, tf2)


def test_search_kernel_wrapper_bounds_k_before_device_work(monkeypatch):
    """The kernel holds chunk j's scalars in lane j, so its wrapper takes
    K <= 32 and raises on K = 33 before it touches the card or builds the
    kernels; at K = 32 it goes on to its operand checks (which refuse CPU
    tensors)."""
    def no_build():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_build, "lib", no_build)
    packed = torch.zeros((4, delta.WORDS), dtype=torch.int32)
    meta = [torch.zeros(4, dtype=torch.int32)] * 3
    ft = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="K = 33"):
        range_search.find_next_packed_cuda(packed, *meta, torch.zeros((3, 33), dtype=torch.int32),
                                           ft)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        range_search.find_next_packed_cuda(packed, *meta, torch.zeros((3, 32), dtype=torch.int32),
                                           ft)


def test_candidate_chunks_matches_reference():
    codes = np.sort(np.random.default_rng(4).integers(0, 2**63, size=128 * 9,
                                                       dtype=np.uint64))
    heads = codes[::128]
    lb = np.concatenate([heads[[0, 3, 8]], heads[[2, 5]] + np.uint64(1),
                         np.array([0, 2**64 - 1], np.uint64)])
    hh, hl = jp.split_u64(jnp.asarray(heads))
    lh, ll = jp.split_u64(jnp.asarray(lb))
    want = np.asarray(jrs.candidate_chunks(hh, hl, lh, ll, 3))
    got = ops.candidate_chunks(from_u64_numpy(heads), from_u64_numpy(lb), 3)
    np.testing.assert_array_equal(got.numpy(), want)
