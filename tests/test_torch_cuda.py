"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on the card; and the engine on the card against the engine on the CPU.

Run on a machine with an NVIDIA sm_90a card:  pytest -m cuda tests/test_torch_*.py
Without a card every test here skips (decided inside the fixture). This
file imports no JAX: the card machine need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch._u64 import from_u64_numpy
from repro_torch.convert import state_to_numpy
from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus
from repro_torch.core import pairing
from repro_torch.core.packed_store import encode_codes
from repro_torch.core.update import WalkEngine
from repro_torch.kernels import delta, ops, range_search, szudzik

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edge_codes(rng, n):
    z = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True)
    r = rng.integers(0, 2**32, size=n // 4, dtype=np.uint64)
    edges = np.array([0, 1, 2, 3, 2**64 - 1, 2**64 - 2, (2**32 - 1) ** 2,
                      (2**32 - 1) ** 2 - 1], dtype=np.uint64)
    return np.concatenate([z, r * r, r * r - 1, r * r + 1, r, edges])


def test_szudzik_kernels_match_plain(dev):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=100_003)
    y = rng.integers(0, 2**32, size=100_003)
    x[:4], y[:4] = [0, 2**32 - 1, 2**32 - 1, 0], [0, 2**32 - 1, 0, 2**32 - 1]
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    assert torch.equal(szudzik.pair_cuda(xt, yt), pairing.szudzik_pair(xt, yt))
    z = from_u64_numpy(_edge_codes(rng, 100_000), dev)
    kx, ky = szudzik.unpair_cuda(z)
    px, py = pairing.szudzik_unpair(z)
    assert torch.equal(kx, px) and torch.equal(ky, py)


def _chunks_of_every_width(dev):
    """Sorted codes whose chunks cover the width classes 8, 16, 32, 64."""
    rng = np.random.default_rng(1)
    parts, base = [], np.uint64(1 << 40)
    for step in (100, 50_000, 3_000_000_000, 1 << 40):
        d = rng.integers(0, step, size=128 * 6, dtype=np.uint64)
        parts.append(base + np.cumsum(d, dtype=np.uint64))
        base = parts[-1][-1]
    codes = np.concatenate(parts + [rng.integers(0, 2**63, size=128 * 3,
                                                 dtype=np.uint64)])
    return from_u64_numpy(codes, dev)


def test_decode_kernel_matches_plain(dev):
    codes = _chunks_of_every_width(dev)
    packed, widths, a_hi, a_lo, _, _ = encode_codes(codes)
    assert set(widths.tolist()) == {8, 16, 32, 64}
    rows = torch.arange(packed.shape[0], device=dev)
    got = delta.decode_rows_cuda(packed, widths, a_hi, a_lo, rows)
    assert torch.equal(got, delta.decode_rows_plain(packed, widths, a_hi, a_lo, rows))
    assert torch.equal(got.reshape(-1)[:codes.shape[0]], codes)
    perm = torch.randperm(rows.shape[0], device=dev)
    assert torch.equal(delta.decode_rows_cuda(packed, widths, a_hi, a_lo, perm),
                       got[perm])


def test_search_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    c = 64
    f = np.sort(rng.integers(0, 1 << 20, size=c * 128))
    v = rng.integers(0, 1 << 18, size=c * 128)
    codes = pairing.szudzik_pair(torch.from_numpy(f), torch.from_numpy(v))
    codes = torch.sort(codes).values.to(dev)
    packed, widths, a_hi, a_lo, _, _ = encode_codes(codes)
    q, k = 4096, 8
    cidx = torch.from_numpy(rng.integers(0, c, size=(q, k))).to(dev, torch.int32)
    # targets: half from a random chunk of the window (hits at k > 0), half misses
    pick = torch.from_numpy(rng.integers(0, k, size=q)).to(dev)
    lane = torch.from_numpy(rng.integers(0, 128, size=q)).to(dev)
    row = cidx[torch.arange(q, device=dev), pick].to(torch.int64)
    ft, _ = pairing.szudzik_unpair(codes[row * 128 + lane])
    ft[::2] = (1 << 20) + torch.arange(0, q, 2, device=dev)
    kv, kf = range_search.find_next_packed_cuda(packed, widths, a_hi, a_lo, cidx, ft)
    pv, pf = range_search.find_next_packed_plain(packed, widths, a_hi, a_lo, cidx, ft)
    assert torch.equal(kf, pf) and torch.equal(kv, pv)
    assert bool(kf[1::2].all()) and not bool(kf[::2].any())


def test_engine_on_card_equals_cpu(dev):
    """The same engine and stream on the card (kernels) and on the CPU
    (plain versions): identical states and walk matrices."""
    rng = np.random.default_rng(3)
    n, cfg = 256, WalkConfig(n_walks_per_vertex=3, length=12)
    src, dst = rng.integers(0, n, size=(2, 3000))
    ins = rng.integers(0, n, size=(2, 4, 40))
    dels = rng.integers(0, n, size=(2, 4, 10))
    states, walks = [], []
    ops.reset_launches()
    for d in (dev, torch.device("cpu")):
        g = StreamingGraph.from_edges(src, dst, n, 1 << 14, device=d)
        store = generate_corpus(jr.PRNGKey(1, d), g, cfg)
        eng = WalkEngine(graph=g, store=store, cfg=cfg, rewalk_capacity=n * 3,
                         max_pending=3)
        eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        states.append(state_to_numpy(eng.state))
        walks.append(eng.walk_matrix().cpu().numpy())
        s = eng.store
        assert torch.equal(s.packed_view().decode()[:s.size], s.code)
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
    np.testing.assert_array_equal(walks[0], walks[1])
    assert all(ops.launches[k] > 0 for k in ops.KERNELS), ops.launches


def test_kernel_wrappers_reject_cpu_tensors(dev):
    x = torch.arange(4)
    with pytest.raises(ValueError):
        szudzik.pair_cuda(x, x)
