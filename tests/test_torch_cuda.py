"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on the card; and the engine on the card against the engine on the CPU,
order 1 and order 2 (both samplers, unfused and fused).

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
from repro_torch.kernels import delta, intersect, megakernel, ops, range_search, szudzik

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
    order1 = ("szudzik_pair", "szudzik_unpair", "delta_decode", "find_next_packed")
    assert all(ops.launches[k] > 0 for k in order1), ops.launches


def test_kernel_wrappers_reject_cpu_tensors(dev):
    x = torch.arange(4)
    with pytest.raises(ValueError):
        szudzik.pair_cuda(x, x)


# ------------------------------------------------ order 2: kernels 5 and 6


def windows_case(rng, b, d, n_vertices=None):
    """Random sorted SENT-padded windows (degrees 0..d), prev a neighbor of
    v where v has one, and two f32 uniforms per row (the generator of the
    reference's intersect tests)."""
    n_vertices = 2 * d if n_vertices is None else n_vertices
    nv = np.full((b, d), intersect.SENT, np.int64)
    npv = np.full((b, d), intersect.SENT, np.int64)
    prev = np.zeros(b, np.int64)
    for i in range(b):
        dv, dp = rng.integers(0, d + 1, size=2)
        a = np.sort(rng.choice(n_vertices, size=dv, replace=False))
        nv[i, :dv] = a
        npv[i, :dp] = np.sort(rng.choice(n_vertices, size=dp, replace=False))
        prev[i] = a[rng.integers(dv)] if dv else rng.integers(n_vertices)
    u = rng.random((b, 2)).astype(np.float32)
    return [torch.from_numpy(x) for x in (nv, npv, prev, u[:, 0], u[:, 1])]


def intersect_edge_cases(d):
    """Empty windows, prev absent, prev v's only neighbor, a u_group just
    below 1, and windows with no common neighbor."""
    s = intersect.SENT
    nv = np.full((6, d), s, np.int64)
    npv = np.full((6, d), s, np.int64)
    nv[1, :3], npv[1, :2] = [4, 9, 11], [9, 30]          # prev absent
    nv[2, :1], npv[2, :1] = [7], [3]                       # prev only nbr
    nv[3, :5], npv[3, :5] = [1, 2, 3, 4, 5], [2, 3, 8, 9, 10]
    nv[4, :d] = np.arange(d)                               # full windows
    npv[4, :d] = np.arange(d) * 2
    nv[5, :2] = [100, 200]                                 # nothing common
    prev = np.array([5, 2, 7, 3, 6, 1])
    u_g = np.array([0.5, 0.3, 0.9, np.nextafter(np.float32(1), np.float32(0)),
                    0.99, 0.0], np.float32)
    u_r = np.array([0.5, 0.99, 0.2, 0.999, 0.0, 0.7], np.float32)
    return [torch.from_numpy(x) for x in (nv, npv, prev, u_g, u_r)]


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (0.25, 4.0), (4.0, 0.25)])
def test_intersect_kernel_matches_plain(dev, p, q):
    rng = np.random.default_rng(int(p * 100))
    inv = intersect.inverse_weights(p, q)
    cases = [windows_case(rng, b, d) for b, d in ((4096, 128), (999, 256))]
    cases += [intersect_edge_cases(128)]
    for case in cases:
        want = intersect.factorized_plain(*case, *inv)
        assert torch.equal(want[0], intersect._factorized_ref(*case, *inv)[0])
        got = intersect.factorized_cuda(*[t.to(dev) for t in case], *inv)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_intersect_wrapper_pads_and_explicit_request_guards(dev):
    rng = np.random.default_rng(4)
    case = windows_case(rng, 300, 48)
    want = intersect.factorized_next(*case, 0.5, 2.0)
    got = ops.intersect_next(*[t.to(dev) for t in case],
                             *intersect.inverse_weights(0.5, 2.0))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="D % 128"):
        intersect.factorized_next(*[t.to(dev) for t in case], 0.5, 2.0,
                                  backend="cuda")


def order2_graph(n=256, hubs=3, seed=5):
    """Random edges plus `hubs` vertices of degree ~200 (> dmax = 128), so
    that the rejection fallback runs."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, size=(2, 3000))
    hs = np.repeat(np.arange(hubs), 220)
    hd = rng.integers(0, n, size=hs.shape[0])
    return np.concatenate([src, hs]), np.concatenate([dst, hd])


@pytest.mark.parametrize("sampler,megak", [("rejection", "off"),
                                           ("factorized", "off"),
                                           ("factorized", "fused")])
def test_order2_engine_on_card_equals_cpu(dev, sampler, megak):
    from repro_torch.core.walkers import WalkModel
    n = 256
    src, dst = order2_graph(n)
    rng = np.random.default_rng(6)
    ins = rng.integers(0, n, size=(2, 4, 40))
    dels = rng.integers(0, n, size=(2, 4, 10))
    model = WalkModel(order=2, p=0.5, q=2.0, sampler=sampler, dmax=128)
    states = []
    ops.reset_launches()
    for d in (dev, torch.device("cpu")):
        mk = megak if megak == "off" else ("cuda" if d.type == "cuda" else "torch")
        cfg = WalkConfig(n_walks_per_vertex=3, length=10, model=model,
                         megakernel=mk)
        g = StreamingGraph.from_edges(src, dst, n, 1 << 14, device=d)
        store = generate_corpus(jr.PRNGKey(1, d), g, cfg)
        eng = WalkEngine(graph=g, store=store, cfg=cfg, rewalk_capacity=n * 3,
                         max_pending=3)
        eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        st = state_to_numpy(eng.state)
        st["walk_matrix"] = eng.walk_matrix().cpu().numpy()
        states.append(st)
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
    if sampler == "factorized":
        assert ops.launches["intersect_next"] > 0
    if megak == "fused":
        assert ops.launches["fused_rewalk_step"] > 0


def test_fused_step_kernel_matches_plain(dev, monkeypatch):
    """The fused step's kernel against its plain version on operands the
    card engine formed, at a prefix-heavy and an emit-heavy step."""
    from repro_torch.core.walkers import WalkModel
    n = 256
    src, dst = order2_graph(n)
    rng = np.random.default_rng(7)
    ins = rng.integers(0, n, size=(2, 3, 40))
    model = WalkModel(order=2, p=0.25, q=4.0, sampler="factorized", dmax=128)
    cfg = WalkConfig(n_walks_per_vertex=3, length=10, model=model,
                     megakernel="cuda")
    g = StreamingGraph.from_edges(src, dst, n, 1 << 14, device=dev)
    eng = WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(1, dev), g, cfg),
                     cfg=cfg, rewalk_capacity=n * 3, max_pending=3)
    wrapped, calls = ops.fused_rewalk_step, []

    def keep(store, step):      # the engine looks the wrapper up per call
        calls.append((store, step))
        return wrapped(store, step)

    monkeypatch.setattr(ops, "fused_rewalk_step", keep)
    for step_k in (1, 6):
        calls.clear()
        eng.run_stream(jr.PRNGKey(step_k, dev), ins[0][:1], ins[1][:1])
        store, step = calls[step_k]
        assert bool(step.is_prefix.any()) and bool((~step.is_prefix).any())
        got = megakernel.fused_step_cuda(store, step)
        want = megakernel.fused_step_plain(store, step)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
