"""The port's CUDA kernels against their plain PyTorch versions on the
card (bit for bit; kernel 7, the f32 SGNS step, within stated
tolerances); and the engine on the card against the engine on the CPU,
order 1 and order 2 (both samplers, unfused and fused), the
downstream maintainer, the stream generators, the II and tree
baselines, and the sharded engine (4 gloo ranks on the card = the same
ranks on the CPU = the single-host card engine; 1 rank on NCCL); the LM
family, DLRM and the GNN family at their smoke configs (f32, TF32 off),
the GNN samplers; and the wharf family's cell plans card = CPU with their
kernel counts, and the dry-run of a wharf cell on the card.

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
from repro_torch.kernels import (_launch, delta, intersect, megakernel, ops, range_search, sgns,
                                 szudzik)

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
    # packed rows off a 16-byte boundary are refused by the wrapper and the
    # C entry: the kernels load a lane's words of a chunk as one vector
    off = torch.zeros(packed.numel() + 1, dtype=torch.int32, device=dev)[1:].view(packed.shape)
    off.copy_(packed)
    with pytest.raises(ValueError, match="16-byte"):
        delta.decode_rows_cuda(off, widths, a_hi, a_lo, rows)
    out = torch.empty((rows.shape[0], delta.CHUNK), dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="repro_delta_decode"):
        _launch.call("repro_delta_decode", dev, off, widths, a_hi, a_lo, rows, out,
                     rows.shape[0])


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


# ------------------------------------------- kernels 1 and 4: edge cases

PAIR_EDGES = np.array([[0, 2**32 - 1, 2**32 - 1, 0], [0, 2**32 - 1, 0, 2**32 - 1]])


@pytest.mark.parametrize("n", [0, 1, 2, 3, (1 << 20) + 1])
@pytest.mark.parametrize("ox,oy", [(0, 0), (1, 1), (1, 0), (0, 1)])
def test_pair_kernel_lengths_and_offsets(dev, n, ox, oy):
    """Lengths 0-3 and 2^20+1 (odd), operands that are views starting at an
    odd element (not 16-byte aligned), alone or both, with the operands 0
    and 2^32-1 at both ends (an odd last element is thread 0's); an output
    off a 16-byte boundary is refused."""
    rng = np.random.default_rng(n)
    x, y = rng.integers(0, 2**32, size=(2, n))
    e = min(n, 4)
    x[:e], y[:e] = PAIR_EDGES[0, :e], PAIR_EDGES[1, :e]
    x[n - e:], y[n - e:] = PAIR_EDGES[0, :e], PAIR_EDGES[1, :e]
    bx = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    by = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    bx[ox:ox + n], by[oy:oy + n] = torch.from_numpy(x), torch.from_numpy(y)
    xt, yt = bx[ox:ox + n], by[oy:oy + n]
    assert n == 0 or (xt.data_ptr() % 16, yt.data_ptr() % 16) == (8 * ox, 8 * oy)
    want = pairing.szudzik_pair(xt, yt)
    assert torch.equal(szudzik.pair_cuda(xt, yt), want)
    if n:   # (an empty view has no data pointer to be off a boundary)
        ob = torch.full((n + 1,), -7, dtype=torch.int64, device=dev)
        with pytest.raises(RuntimeError, match="repro_szudzik_pair"):
            _launch.call("repro_szudzik_pair", dev, xt, yt, ob[1:], n)
        assert bool((ob == -7).all())


def _search_store(dev):
    """Sorted Szudzik codes in 21 chunks of 128 that cover the width
    classes 8, 16, 32 and 64, codes with f < v (the y^2 + x branch, up to v
    = 2^32-1), and targets f whose codes span two chunks -> (packed args, the codes,
    {class: chunk ids})."""
    rng = np.random.default_rng(5)
    ar = np.arange(128)
    parts = {
        "w8": [(np.full(128, 5000 + 200 * i), ar) for i in range(4)],
        "two_chunks": [(np.full(256, 70_000), np.arange(256))],
        "w16": [(np.full(128, 1_000_000 + 10 * i), ar * 300) for i in range(4)],
        "w32": [(2_000_000 + 4 * np.arange(512), rng.integers(0, 1000, 512))],
        "f_below_v": [(ar, np.full(128, 3_000_000 + i)) for i in range(2)],
        "w64": [(10**9 + 1000 * np.arange(512), rng.integers(0, 1 << 18, 512))],
        "f_below_top_v": [(ar, np.full(128, 2**32 - 1))],       # codes near 2^64
    }
    codes, chunks, c0 = [], {}, 0
    for name, pieces in parts.items():
        f = np.concatenate([p[0] for p in pieces])
        v = np.concatenate([p[1] for p in pieces])
        z = pairing.szudzik_pair(torch.from_numpy(f), torch.from_numpy(v))
        codes.append(torch.sort(z).values)
        chunks[name] = list(range(c0, c0 + f.shape[0] // 128))
        c0 += f.shape[0] // 128
    codes = torch.cat(codes).to(dev)
    assert torch.equal(codes, torch.sort(codes).values)
    packed, widths, a_hi, a_lo, _, _ = encode_codes(codes)
    assert [int(widths[c[0]]) for c in chunks.values()] == [8, 8, 16, 32, 8, 64, 8]
    return (packed, widths, a_hi, a_lo), codes, chunks


def _check_search(args, cidx, ft):
    got = range_search.find_next_packed_cuda(*args, cidx, ft)
    want = range_search.find_next_packed_plain(*args, cidx, ft)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    return got


@pytest.mark.parametrize("k", [1, 8, 32])
def test_search_kernel_every_width_and_k(dev, k):
    """K = 1, 8 and 32 windows over chunks of every width class; targets
    from a random chunk of the window, a tenth of them misses. Q = 100,003
    is odd, so not a multiple of the grid's warps, and above them: every
    warp runs its pipeline over several queries and the last turn is
    partial."""
    args, codes, _ = _search_store(dev)
    rng = np.random.default_rng(k)
    n_chunks, q = args[0].shape[0], 100_003
    cidx = torch.from_numpy(rng.integers(0, n_chunks, size=(q, k))).to(dev, torch.int32)
    pick = torch.from_numpy(rng.integers(0, k, size=q)).to(dev)
    lane = torch.from_numpy(rng.integers(0, 128, size=q)).to(dev)
    row = cidx[torch.arange(q, device=dev), pick].to(torch.int64)
    ft, _ = pairing.szudzik_unpair(codes[row * 128 + lane])
    ft[::10] = 123_456_789                                    # no such f
    _, found = _check_search(args, cidx, ft)
    assert bool(found[1::10].all()) and not bool(found[::10].any())


def test_search_kernel_edge_cases(dev):
    """A hit only at k = K-1, no hit at all, a target whose codes lie in two
    chunks (the first in the window wins, with its largest v), f < v codes,
    and Q = 0."""
    args, codes, chunks = _search_store(dev)
    k = 8
    others = chunks["w8"] + chunks["w16"] + chunks["w32"]          # 12 chunks
    rows, fts = [], []
    for i, c in enumerate(chunks["w64"]):                         # hit only at K-1
        rows.append(others[:k - 1] + [c])
        fts.append(10**9 + 1000 * (128 * i + 37))
    for c in chunks["f_below_v"] + chunks["f_below_top_v"]:
        rows.append(others[:k - 1] + [c])
        fts.append(77)
    rows += [others[:k], others[4:4 + k]]                         # no hit at all
    fts += [70_000, 10**9 + 1000 * 37]
    a, b = chunks["two_chunks"]
    rows += [[a, b] + others[:k - 2], [b, a] + others[:k - 2],    # first wins
             others[:3] + [b, a] + others[3:k - 2]]
    fts += [70_000] * 3
    cidx = torch.tensor(rows, dtype=torch.int32, device=dev)
    ft = torch.tensor(fts, dtype=torch.int64, device=dev)
    v, found = _check_search(args, cidx, ft)
    n_late = len(chunks["w64"]) + len(chunks["f_below_v"]) + len(chunks["f_below_top_v"])
    assert bool(found[:n_late].all())
    assert not bool(found[n_late:n_late + 2].any())
    assert v[n_late + 2:].tolist() == [127, 255, 255]
    empty = torch.zeros((0, k), dtype=torch.int32, device=dev)
    v0, f0 = _check_search(args, empty, torch.zeros(0, dtype=torch.int64, device=dev))
    assert v0.shape == (0,) and f0.shape == (0,)


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
    if sampler == "factorized":   # the corpus, and the unfused steps
        assert ops.launches["intersect_csr"] > 0
    assert ops.launches["intersect_next"] == 0
    if megak == "fused":
        assert ops.launches["fused_rewalk_step"] > 0


def test_fused_step_kernel_matches_plain(dev, monkeypatch):
    """The fused step's kernel against its plain version on operands the
    card engine formed (the graph's CSR, hubs of degree > dmax), at a
    prefix-heavy and an emit-heavy step, and with every lane emitting."""
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
        all_emit = step._replace(is_prefix=torch.zeros_like(step.is_prefix))
        for s in (step, all_emit):
            got = megakernel.fused_step_cuda(store, s)
            want = megakernel.fused_step_plain(store, s)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool(got[2].any()), "no emitting lane overflowed dmax"
    with pytest.raises(ValueError, match="CUDA tensor"):
        megakernel.fused_step_cuda(store, step._replace(cur=step.cur.cpu()))


def csr_case(n=512, b=4096, dmax=128, seed=10):
    """A graph with four hubs of degree ~2 dmax (> dmax) and 16 isolated
    vertices, and lanes with v and prev both hubs, v isolated, prev
    isolated, prev == v, and uniform pairs -> (graph edges, v, prev, u f32
    [b, 2])."""
    rng = np.random.default_rng(seed + dmax)
    src, dst = rng.integers(0, n - 16, size=(2, 8000))
    hs = np.repeat(np.arange(4), 2 * dmax)
    src = np.concatenate([src, hs])
    dst = np.concatenate([dst, rng.integers(4, n - 16, size=hs.shape[0])])
    v, prev = rng.integers(0, n, size=(2, b))
    v[:8], prev[:8] = np.arange(8) % 4, (np.arange(8) + 1) % 4
    v[8:16] = n - 1 - np.arange(8)
    prev[16:24] = n - 1 - np.arange(8)
    prev[24:40] = v[24:40]
    u = rng.random((b, 2)).astype(np.float32)
    return (src, dst), torch.from_numpy(v), torch.from_numpy(prev), torch.from_numpy(u)


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (0.25, 4.0), (4.0, 0.25)])
def test_intersect_csr_kernel_matches_plain(dev, p, q):
    """The CSR kernel against `factorized_csr_plain` (the windows, then the
    windowed plain version), bit for bit, at dmax 128 and 256 (and 1024,
    the widest: 32 entries a lane). Hub rows pass the Bloom filter with
    more than 32 candidates and take the sorted search; the others the
    warp compare."""
    inv = intersect.inverse_weights(p, q)
    for dmax in (128, 256, 1024):
        n = max(512, 4 * dmax)
        (src, dst), v, prev, u = csr_case(n=n, dmax=dmax)
        g = StreamingGraph.from_edges(src, dst, n, 1 << 16, device=dev)
        args = (g.codes, g.offsets, v.to(dev), prev.to(dev), u.to(dev))
        got = intersect.factorized_csr_cuda(*args, dmax, *inv)
        want = intersect.factorized_csr_plain(*args, dmax, *inv)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), dmax
        assert bool(got[2][:8].all()) and not bool(got[1][8:16].any())
        ops.reset_launches()
        via = intersect.factorized_next_csr(*args, dmax, p, q)
        assert ops.launches["intersect_csr"] == 1
        assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_csr_wrappers_reject_cpu_tensors_and_guard(dev):
    (src, dst), v, prev, u = csr_case(b=300)
    g = StreamingGraph.from_edges(src, dst, 512, 1 << 15, device="cpu")
    cpu = (g.codes, g.offsets, v, prev, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        intersect.factorized_csr_cuda(*cpu, 128, 1.0, 1.0)
    card = [t.to(dev) for t in cpu]
    with pytest.raises(ValueError, match="dmax % 128"):
        intersect.factorized_next_csr(*card, 96, 0.5, 2.0, backend="cuda")
    got = intersect.factorized_next_csr(*card, 96, 0.5, 2.0)    # auto: any dmax
    want = intersect.factorized_csr_plain(*cpu, 96, *intersect.inverse_weights(0.5, 2.0))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="dmax"):
        ops.intersect_csr(*card, 2048, 1.0, 1.0)


# -------------------------------------- kernel 7 (SGNS) and the maintainer

SGNS_LOSS_TOL = dict(rtol=1e-5, atol=0)
SGNS_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def sgns_cases():
    """Random rows at the slice's shape and at odd ones (B = 1, 13; K = 1,
    16; D = 64, 100, 256, 7), rows with logits of exactly ±100, all-zero
    rows. Random entries are N(0, 4/D), rows of norm ~2 as in a maintained
    table: at unit entries (logits ~±40) f32 rounding of the logits alone
    moves du by more than atol 1e-6, whatever the order of the sums."""
    rng = np.random.default_rng(8)

    def rnd(b, k, d):
        return [torch.from_numpy((rng.standard_normal(s) * 2 / np.sqrt(d))
                                 .astype(np.float32))
                for s in ((b, d), (b, d), (b, k, d))]
    cases = [rnd(b, k, d) for b, k, d in ((4096, 5, 128), (1, 5, 128), (13, 5, 128),
                                          (64, 1, 128), (33, 5, 64), (17, 3, 256),
                                          (9, 16, 100), (5, 2, 7))]
    u, vp, vn = (torch.zeros(s) for s in ((6, 128), (6, 128), (6, 5, 128)))
    u[:4, 0] = 10.0
    vp[0, 0], vn[0, :, 0] = 10.0, -10.0                  # pos +100, negs -100
    vp[1, 0], vn[1, :, 0] = -10.0, 10.0                  # pos -100, negs +100
    vp[2, 0], vn[2, :, 0] = 10.0, 10.0
    vn[3, ::2, 0] = 10.0                                  # v+ zero, mixed negs
    return cases + [[u, vp, vn]]


def assert_sgns_close(got, want):
    for name, g, w in zip(("loss", "du", "dvp", "dvn"), got, want):
        tol = SGNS_LOSS_TOL if name == "loss" else SGNS_GRAD_TOL
        torch.testing.assert_close(g.cpu(), w.cpu(), msg=name, **tol)
        assert bool(torch.isfinite(g).all()), name


def test_sgns_kernel_matches_plain(dev):
    for case in sgns_cases():
        args = [t.to(dev) for t in case]
        got = sgns.sgns_cuda(*args)
        assert_sgns_close(got, sgns.sgns_plain(*args))
        assert_sgns_close(got, sgns.sgns_plain(*case))     # the CPU's plain version
    # a view whose rows are not 16-byte aligned takes the scalar loads
    u, vp, vn = [t.to(dev) for t in sgns_cases()[0]]
    off = [t.reshape(-1)[1:1 + t.numel() - t[0].numel()].reshape(
        t.shape[0] - 1, *t.shape[1:]) for t in (u, vp, vn)]
    assert_sgns_close(sgns.sgns_cuda(*off), sgns.sgns_plain(*off))


def test_sgns_kernel_states_its_limits(dev):
    u = torch.zeros((4, 128), device=dev)
    with pytest.raises(ValueError, match="K <= 16"):
        sgns.sgns_cuda(u, u, torch.zeros((4, 17, 128), device=dev))
    with pytest.raises(ValueError, match="B >= 1"):
        sgns.sgns_cuda(u[:0], u[:0], torch.zeros((0, 5, 128), device=dev))
    with pytest.raises(TypeError):
        sgns.sgns_cuda(u.double(), u, torch.zeros((4, 5, 128), device=dev))
    before = ops.launches["sgns_step"]
    sgns.sgns_apply(u, u, torch.zeros((4, 5, 128), device=dev))
    assert ops.launches["sgns_step"] == before + 1


@pytest.mark.parametrize("max_pairs", [0, 1000])
def test_maintainer_on_card_equals_cpu(dev, max_pairs):
    """The same maintainer and stream on the card (kernels) and on the CPU
    (plain versions), from the same tables: the engine bit for bit, the
    pair and affected counts equal, the loss and tables within the
    reference's tolerance (the card's scatter-add uses atomics)."""
    from repro_torch.downstream import EmbeddingMaintainer, MaintainerConfig
    rng = np.random.default_rng(9)
    n = 256
    src, dst = rng.integers(0, n, size=(2, 3000))
    ins = rng.integers(0, n, size=(2, 4, 40))
    dels = rng.integers(0, n, size=(2, 4, 10))
    wcfg = WalkConfig(n_walks_per_vertex=3, length=12)
    # training every live pair puts ~250 pairs a batch on each input row
    # here, where lr 0.01 does not converge
    lr = 0.01 if max_pairs else 0.001
    out = []
    ops.reset_launches()
    for d in (torch.device("cpu"), dev):
        g = StreamingGraph.from_edges(src, dst, n, 1 << 14, device=d)
        cfg = MaintainerConfig(walk=wcfg, n_vertices=n, dim=128, window=5,
                               n_negative=5, rewalk_capacity=n * 3, max_pending=3,
                               max_pairs=max_pairs, lr=lr)
        mt = EmbeddingMaintainer(graph=g, store=generate_corpus(jr.PRNGKey(1, d), g, wcfg),
                                 cfg=cfg, key=jr.PRNGKey(3, d))
        if d.type == "cuda":   # the CPU's tables: the draws' log1p differs by ulps
            mt.load_state(mt.state._replace(params={k: v.to(d) for k, v in out[0][1].items()}))
        init = {k: v.clone() for k, v in mt.params.items()}
        m = mt.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1],
                          train_key=jr.PRNGKey(4, d))
        out.append((state_to_numpy(mt.state.engine), init, m, mt.params))
    (s_cpu, _, m_cpu, p_cpu), (s_dev, _, m_dev, p_dev) = out
    for k in s_cpu:
        np.testing.assert_array_equal(s_cpu[k], s_dev[k], err_msg=k)
    assert torch.equal(m_cpu.n_pairs, m_dev.n_pairs.cpu())
    assert torch.equal(m_cpu.n_affected, m_dev.n_affected.cpu())
    torch.testing.assert_close(m_dev.loss_sum.cpu(), m_cpu.loss_sum, rtol=1e-5, atol=0)
    for k in ("in", "out"):
        torch.testing.assert_close(p_dev[k].cpu(), p_cpu[k], rtol=2e-4, atol=1e-5)
    assert ops.launches["sgns_step"] == 4


def test_normal_on_card_equals_cpu(dev):
    """`normal` on the card (its f32 log1p and FMAs from float64 operations)
    equals its CPU values bit for bit, as the CPU equals JAX's."""
    for seed, shape in ((0, (1 << 16,)), (4, (300, 128)), (7, (3, 7))):
        got = jr.normal(jr.PRNGKey(seed, dev), shape).cpu()
        want = jr.normal(jr.PRNGKey(seed, "cpu"), shape)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), seed
    u = torch.linspace(-0.99999994, 0.99999994, 1 << 20)
    assert torch.equal(jr.erfinv32(u.to(dev)).cpu().view(torch.int32),
                       jr.erfinv32(u).view(torch.int32))


def _service_pair(dev, metrics=False):
    """One engine and mixed stream on the card and on the CPU, 3 batches
    left pending, and a service over each."""
    from repro_torch.serve import WalkQueryService
    rng = np.random.default_rng(5)
    n, cfg = 256, WalkConfig(n_walks_per_vertex=3, length=12, metrics=metrics)
    src, dst = rng.integers(0, n, size=(2, 3000))
    ins = rng.integers(0, n, size=(2, 3, 40))
    dels = rng.integers(0, n, size=(2, 3, 10))
    out = []
    for d in (dev, torch.device("cpu")):
        g = StreamingGraph.from_edges(src, dst, n, 1 << 14, device=d)
        eng = WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(1, d), g, cfg),
                         cfg=cfg, rewalk_capacity=n * 3, max_pending=4)
        eng.run_stream(jr.PRNGKey(2, d), ins[0], ins[1], dels[0], dels[1])
        assert eng.n_pending == 3
        out.append(WalkQueryService(engine=eng))
    return out


def _service_answers(svc, snap=None):
    wm = svc.walk_matrix(snapshot=snap)
    ws = torch.arange(0, 768, 7)
    ps = ws % 11
    v = wm[ws, ps]
    nxt, found = svc.next_vertices(v, ws, ps, snapshot=snap)
    assert bool(found.all())
    vs = list(range(0, 256, 5))
    return {"walk_matrix": wm, "next": nxt, "found": found,
            "walks_of": svc.walks_of(vs, capacity=64, snapshot=snap),
            "neighborhoods": svc.neighborhoods(vs, hops=4, snapshot=snap),
            "ppr": svc.ppr_rows(vs, snapshot=snap)}


def test_service_on_card_equals_cpu(dev):
    """Every query kind on the card (kernels 1-4 on its read path) equals
    the CPU's: walks, ids and pinned answers bit for bit; PPR rows within
    rtol 1e-5 (the table's adds do not depend on their order, its row
    sums do: each device sums in its own); embedding neighbors' ids equal
    and scores within 1e-5; a pin survives a merge and two more batches
    on both."""
    card, cpu = _service_pair(dev)
    ops.reset_launches()
    a = _service_answers(card)
    launches = dict(ops.launches)
    b = _service_answers(cpu)
    for k in a:
        if k == "ppr":
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(a[k].cpu(), b[k]), k
    for k in ("szudzik_pair", "szudzik_unpair", "delta_decode", "find_next_packed"):
        assert launches[k] > 0, launches
    table = jr.normal(jr.PRNGKey(8, "cpu"), (256, 128))
    table[20:23] = table[19]                     # exact ties
    card.set_embedding_table(table.to(dev))
    cpu.set_embedding_table(table)
    ids_c, sc_c = card.embedding_neighbors(list(range(0, 256, 3)), k=10)
    ids, sc = cpu.embedding_neighbors(list(range(0, 256, 3)), k=10)
    assert torch.equal(ids_c.cpu(), ids)
    torch.testing.assert_close(sc_c.cpu(), sc, rtol=1e-5, atol=1e-5)
    assert card.embedding_neighbors([19], k=3)[0].tolist() == [[20, 21, 22]]
    snaps = [s.pin() for s in (card, cpu)]
    pre = [_service_answers(s, snap) for s, snap in zip((card, cpu), snaps)]
    rng = np.random.default_rng(6)
    for s in (card, cpu):
        s.engine.merge()
        ins = rng.integers(0, 256, size=(2, 2, 40))
        s.engine.run_stream(jr.PRNGKey(9, s.device), ins[0], ins[1])
        s._wm_cache.clear()
        s._ppr_cache.clear()
    for s, snap, want in zip((card, cpu), snaps, pre):
        got = _service_answers(s, snap)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        snap.release()
        assert s.engine.pins_active == 0


def test_ppr_table_on_card_is_deterministic(dev):
    """Two builds of the PPR table from one walk matrix on the card are
    bit-identical, and equal to the CPU's."""
    from repro_torch.core.ppr import ppr_scores
    rng = np.random.default_rng(7)
    wm = torch.from_numpy(rng.integers(0, 2048, size=(2048 * 10, 80)))
    wm[:, 0] = torch.arange(2048 * 10) // 10
    a = ppr_scores(wm.to(dev), 2048, 0.2)
    b = ppr_scores(wm.to(dev), 2048, 0.2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(a.cpu(), ppr_scores(wm, 2048, 0.2), rtol=1e-5, atol=0)


def test_metrics_on_card_equal_cpu(dev):
    """A metrics-ON stream on the card: the counters equal the CPU's, and
    the engine equals a metrics-OFF card engine."""
    from repro_torch.obs.export import summary
    card, cpu = _service_pair(dev, metrics=True)
    off, _ = _service_pair(dev)
    assert summary(card.engine.metrics) == summary(cpu.engine.metrics)
    a, b = state_to_numpy(card.engine.state), state_to_numpy(off.engine.state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_generators_on_card_equal_cpu(dev):
    """The stream generators and their draws on the card equal the CPU's:
    ids bit for bit (the f64 gumbel noise through the card's log), the
    uniforms, bernoulli and cora_like's features and labels."""
    from repro_torch.data import streams
    cpu = torch.device("cpu")
    for name, fn in (
            ("rmat", lambda k: streams.rmat_edges(k, 1 << 16, 18)),
            ("er", lambda k: streams.er_edges(k, 100_003, 12)),
            ("skewed", lambda k: streams.skewed_edges(k, 4097, 10, 10.0)),
            ("stream", lambda k: streams.edge_batch_stream(k, 3, 1000, 18)),
            ("mixed", lambda k: streams.mixed_edge_stream(k, 4, 1000, 200, 18)),
            ("cora", lambda k: (*streams.cora_like(k)[0], *streams.cora_like(k)[1:])),
            ("tokens", lambda k: (streams.token_stream(k, 4, 33, 50_000),)),
            ("uniform64", lambda k: (jr.uniform(k, (1001, 4), torch.float64, -1.7, 3.3),)),
            ("uniform32", lambda k: (jr.uniform(k, (1001, 4), torch.float32, -1.7, 3.3),)),
            ("gumbel32", lambda k: (jr.gumbel(k, (1 << 16,), torch.float32),)),
            ("bernoulli", lambda k: (jr.bernoulli(k, 0.01, (333, 77)),))):
        got = fn(jr.PRNGKey(3, dev))
        want = fn(jr.PRNGKey(3, cpu))
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), w), name
    g64 = jr.gumbel(jr.PRNGKey(4, dev), (1 << 16,)).cpu()
    torch.testing.assert_close(g64, jr.gumbel(jr.PRNGKey(4, cpu), (1 << 16,)),
                               rtol=5e-16, atol=5e-16)


def _baseline_pair(dev, kind, model):
    """An II or tree engine on the card and on the CPU from the same keys,
    a 2^10-vertex er graph and a 3-batch mixed stream -> the two engines
    and their affected counts."""
    from repro_torch.core.baselines import IIEngine, TreeEngine
    from repro_torch.data import streams
    cls = {"ii": IIEngine, "tree": TreeEngine}[kind]
    cfg = WalkConfig(n_walks_per_vertex=4, length=16, model=model)
    out = []
    for d in (dev, torch.device("cpu")):
        src, dst = streams.er_edges(jr.PRNGKey(1, d), 10_000, 10)
        stream = streams.mixed_edge_stream(jr.PRNGKey(2, d), 3, 100, 20, 10)
        g = StreamingGraph.from_edges(src, dst, 1024, 1 << 16, device=d)
        eng = cls.create(jr.PRNGKey(3, d), g, cfg)
        eng.rewalk_capacity = 4096
        out.append((eng, eng.run_stream(jr.PRNGKey(4, d), *stream).cpu()))
    return out


@pytest.mark.parametrize("kind", ["ii", "tree"])
@pytest.mark.parametrize("model", ["order1", "order2-factorized"])
def test_baselines_on_card_equal_cpu(dev, kind, model):
    """II and tree on the card (kernel 5 at order 2) = on the CPU: the
    affected counts and every column, bit for bit."""
    from repro_torch.convert import baseline_to_numpy
    from repro_torch.core.walkers import WalkModel
    m = WalkModel() if model == "order1" else WalkModel(
        order=2, p=0.5, q=2.0, sampler="factorized", dmax=128)
    ops.reset_launches()
    (card, a1), (cpu, a2) = _baseline_pair(dev, kind, m)
    assert torch.equal(a1, a2)
    if model != "order1":
        assert ops.launches["intersect_csr"] > 0
    x, y = baseline_to_numpy(card), baseline_to_numpy(cpu)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_tree_equals_wharf_and_shifted_ii_on_card(dev):
    """Phase 6's cross-checks on the card at a small size: from one corpus
    key and stream key, batch by batch, the tree's walks = Wharf's at order
    1, batch 1's affected counts equal across the three, and after batch 1
    the II = the tree shifted by the reference's one column."""
    import chip_smoke
    from repro_torch.core.baselines import IIEngine, TreeEngine
    from repro_torch.data import streams
    cfg = WalkConfig(n_walks_per_vertex=4, length=16)
    src, dst = streams.er_edges(jr.PRNGKey(1, dev), 10_000, 10)
    stream = streams.mixed_edge_stream(jr.PRNGKey(2, dev), 3, 100, 20, 10)
    g = StreamingGraph.from_edges(src, dst, 1024, 1 << 16, device=dev)
    key = jr.PRNGKey(4, dev)
    engines = {"wharf": chip_smoke.paper_engine(
        "wharf", g, cfg, jr.PRNGKey(3, dev), 4096, 2,
        dict(merge_policy="on-demand", merge_impl="interleave"))}
    for kind, cls in (("ii", IIEngine), ("tree", TreeEngine)):
        engines[kind] = cls.create(jr.PRNGKey(3, dev), g, cfg)
        engines[kind].rewalk_capacity = 4096
    ii0 = engines["ii"].walks
    for i in range(3):
        aff = {k: chip_smoke.paper_batch(e, stream, key, i) for k, e in engines.items()}
        m = {k: chip_smoke.walk_matrix_of(e) for k, e in engines.items()}
        assert torch.equal(m["tree"], m["wharf"]) and aff["tree"] == aff["wharf"]
        chip_smoke.tree_checks(engines["tree"])
        if i == 0:
            assert aff["ii"] == aff["wharf"]
            pm = chip_smoke.first_touched(ii0, stream, 0, 1024)
            chip_smoke.ii_checks(ii0, engines["ii"], pm)
            assert chip_smoke.ii_shifted_equal(m["ii"], m["tree"], pm)


def test_default_findnext_backend_guards(dev):
    """The process-wide FINDNEXT default: "cuda" serves card tensors and
    raises on CPU tensors; "auto" restores the per-device pick."""
    from repro_torch.core import packed_store
    saved = packed_store._default_backend
    try:
        packed_store.set_default_backend("cuda")
        assert packed_store.get_default_backend(dev) == "cuda"
        with pytest.raises(ValueError, match="card"):
            packed_store.resolve_backend(None, torch.device("cpu"))
        packed_store.set_default_backend("auto")
        assert packed_store.resolve_backend(None, torch.device("cpu")) == "torch"
        assert packed_store.get_default_backend() == "cuda"
    finally:
        packed_store._default_backend = saved


def test_compact_lanes_by_shard_card_equals_cpu(dev):
    from repro_torch.core.corpus import compact_lanes_by_shard
    dest = torch.from_numpy(np.random.default_rng(5).integers(0, 9, 100_000))
    for slab in (20_000, 5_000):       # roomy, and overflowing
        send, ovf = compact_lanes_by_shard(dest.to(dev), 8, slab)
        want, want_ovf = compact_lanes_by_shard(dest, 8, slab)
        assert torch.equal(send.cpu(), want) and bool(ovf) == bool(want_ovf)


def test_sharded_engine_on_the_card(dev, tmp_path):
    """chip_smoke's phase 7a: 4 gloo ranks on the card at 2^12 vertices,
    both merge policies and once with metrics; unsharded = the single-host
    card engine, each shard = the same ranks' CPU shard, metrics ON = OFF,
    counters card = CPU; one rank on NCCL = the single-host engine."""
    import chip_smoke
    checks = chip_smoke.phase_sharded_small(dev, str(tmp_path))
    assert checks and all(checks.values()), checks


def test_trainer_on_the_card(dev, tmp_path):
    """chip_smoke's phase 8a: the launcher's downstream and stream trainers
    through TrainLoop at the wharf-stream smoke config, card = CPU (engines
    bit for bit, metrics exact, tables within tolerance), and a crash after
    step 2 resumed by a fresh trainer = the uninterrupted run."""
    import chip_smoke
    chip_smoke.phase_trainer_small(dev, str(tmp_path))


def test_permutation_train_epoch_and_probe_on_card_equal_cpu(dev):
    """`permutation` (3 rounds) bit for bit; `train_epoch`'s tables within
    rtol 2e-4 / atol 1e-5 of the CPU's (its autograd scatter-adds in
    another order) and its loss within rtol 1e-5; the probe's weights within
    rtol 1e-4 / atol 1e-6 (f32, TF32 off) and the same accuracy."""
    from repro_torch.models import embeddings as temb
    for n in (1000, 3_000_000):
        got = jr.permutation(jr.PRNGKey(n, dev), n)
        assert got.is_cuda and torch.equal(got.cpu(), jr.permutation(jr.PRNGKey(n, "cpu"), n))
    rng = np.random.default_rng(2)
    walks = torch.from_numpy(rng.integers(0, 50, size=(40, 10)))
    cfg = temb.SGNSConfig(n_vertices=50, dim=32, window=3, n_negative=4)
    out = {}
    for d in ("cpu", dev):
        p = temb.sgns_init(jr.PRNGKey(3, d), cfg)
        out[str(d)] = temb.train_epoch(jr.PRNGKey(4, d), p, walks.to(d), cfg, batch=256)
    (pc, lc), (pd, ld) = out["cpu"], out[str(dev)]
    for k in ("in", "out"):
        torch.testing.assert_close(pd[k].cpu(), pc[k], rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(ld.cpu(), lc, rtol=1e-5, atol=0)
    emb = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, size=300))
    x = emb / emb.norm(dim=1, keepdim=True)
    tr = torch.arange(200)
    wc = temb.logistic_probe(x, labels, tr)
    wd = temb.logistic_probe(x.to(dev), labels.to(dev), tr.to(dev))
    torch.testing.assert_close(wd.cpu(), wc, rtol=1e-4, atol=1e-6)
    assert temb.logistic_eval(emb.to(dev), labels) == temb.logistic_eval(emb, labels)


def test_checkpoint_of_card_tensors(dev, tmp_path):
    """A save of card tensors is a host copy (a later in-place write does not
    reach it); restore puts each leaf on its template's device, or on the
    device `shardings` names."""
    from repro_torch.train.checkpoint import CheckpointManager
    state = {"a": torch.arange(10, device=dev), "n": 3,
             "b": {"c": torch.ones(4, 4, device=dev)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    state["a"].zero_()
    mgr.wait()
    out, _ = mgr.restore(state)
    assert out["a"].is_cuda and torch.equal(out["a"].cpu(), torch.arange(10))
    assert out["n"] == 3 and torch.equal(out["b"]["c"], state["b"]["c"])
    out, _ = mgr.restore(state, shardings="cpu")
    assert not out["a"].is_cuda and not out["b"]["c"].is_cuda


def test_lm_family_on_card_equals_cpu(dev, tmp_path):
    """chip_smoke's phase 9a: every LM arch's smoke config in f32 with TF32
    off, card against CPU (gemma2's sliding window and softcaps, the MoE
    archs' routing exactly): init bit for bit; forward, loss, gradients,
    prefill and decode within rtol 1e-4 / atol 1e-5; DLRM's smoke step;
    the launcher's `lm_trainer` for 4 steps, tokens exact."""
    import chip_smoke
    chip_smoke.phase_lm_small(dev, str(tmp_path))


def test_dlrm_step_on_card_equals_cpu(dev):
    """DLRM's smoke config, card against CPU (TF32 off): init bit for bit;
    forward, retrieval scores, loss, gradient norm and the parameters after
    one AdamW step within rtol 1e-5 / atol 1e-6."""
    import chip_smoke
    with chip_smoke.tf32_off():
        err = chip_smoke.dlrm_small(dev)
    assert max(err.values()) <= 1e-4, err


@pytest.mark.parametrize("arch", ["meshgraphnet", "equiformer-v2", "gat-cora",
                                  "graphsage-reddit"])
def test_gnn_smoke_on_card_equals_cpu(dev, arch):
    """chip_smoke's phase 10a for one GNN arch at its smoke config with a
    plan's input widths (f32, TF32 off): init bit for bit; forward, `_gnn_loss` and its gradients
    within rtol 1e-4 / atol 1e-5 (`index_add` on the card adds with
    atomics, in another order)."""
    import chip_smoke
    from repro_torch import tree
    with chip_smoke.tf32_off():
        card, host = chip_smoke.gnn_small_run(arch, dev), chip_smoke.gnn_small_run(arch, "cpu")
    want = tree.leaf_paths(host["params"])
    for k, v in tree.leaf_paths(card["params"]).items():
        assert torch.equal(v.cpu(), want[k]), k
    for k in ("out", "loss"):
        chip_smoke.close(card[k], host[k], k, **chip_smoke.GNN_TOL)
    chip_smoke.trees_close(card["grads"], host["grads"], "grads", **chip_smoke.GNN_TOL)


def test_gnn_samplers_on_card_equal_cpu(dev):
    """`sample_fanout` and `sample_two_hop` (a graph with vertices of degree
    0) give the card's ids and masks equal to the CPU's; and
    `walk_based_neighborhood` through the CUDA FINDNEXT on the card = the
    plain backend on the CPU, with a pending block live."""
    from repro_torch.models import sampling
    rng = np.random.default_rng(4)
    n = 1 << 10
    src, dst = (torch.from_numpy(rng.integers(0, n - 50, 8000)) for _ in range(2))
    seeds = torch.from_numpy(rng.integers(0, n, 256))
    out = {}
    for d in (torch.device("cpu"), dev):
        g = StreamingGraph.from_edges(src.to(d), dst.to(d), n, 1 << 15, device=d)
        key = jr.PRNGKey(3, d)
        cfg = WalkConfig(n_walks_per_vertex=4, length=12)
        eng = WalkEngine(graph=g, store=generate_corpus(jr.PRNGKey(0, d), g, cfg), cfg=cfg,
                         rewalk_capacity=n * 4, max_pending=4)
        eng.run_stream(jr.PRNGKey(1, d), src[None, :100].to(d), dst[None, :100].to(d),
                       src[None, 200:220].to(d), dst[None, 200:220].to(d))
        assert eng.n_pending == 1
        out[d.type] = (sampling.sample_fanout(key, g, seeds.to(d), 25),
                       sampling.sample_two_hop(key, g, seeds.to(d), 15, 10),
                       sampling.walk_based_neighborhood(eng.overlay(), seeds.to(d), 4, 12, 2))
    from repro_torch.tree import tree_leaves
    want, got = tree_leaves(out["cpu"]), tree_leaves(out["cuda"])
    assert len(want) == len(got) == 7
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_wharf_plans_on_card_equal_cpu(dev):
    """chip_smoke's phase 11a: the 13 wharf cell plans at the smoke config
    on the card and on the CPU from the same inputs, every output leaf bit
    for bit; op_analysis's kernel calls on the card = the plain twins'
    calls on the CPU = the launch counts; kernels 1-6 launched."""
    import chip_smoke
    res = chip_smoke.phase_wharf_plans(dev)
    assert len(res["cells"]) == 13


def test_dryrun_of_a_wharf_cell_on_the_card(dev):
    """The dry-run of a wharf cell on real inputs on the card at a cut
    config: its kernel calls = the card's launches in the counted run, a
    peak, the card's name; and a meta cell's record beside it."""
    from repro_torch.launch import dryrun
    cfg = dryrun.wharf_config(12, max_pending=4)
    rec = dryrun.run_cell("wharf-stream", "stream_10k_mixed", config=cfg, device=dev,
                          verbose=False)
    assert rec["launches"] == {k: int(v) for k, v in rec["kernel_calls"].items()}
    assert rec["launches"]["szudzik_pair"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert rec["card"] == torch.cuda.get_device_name(0)
    meta = dryrun.run_cell("gemma2-2b", "train_4k", verbose=False)
    assert meta["device"] == "meta" and meta["launches"] is None


def test_partitioned_steps_on_the_card(dev, tmp_path):
    """launch/partitioned.py on the card, as chip_smoke's 11d-b at the
    smoke configs: four gloo ranks sharing the card on a (2, 2) mesh run
    gemma2-2b's train step (f32, one KV head: the queries cut along the
    sequence, so Shard -> Shard moves) and dlrm-rm2's serve step; every
    rank's output shards within tolerance of the unsharded step on the
    card, its collectives = the meta count (the all-gathers and moves
    through `collectives.gloo_routes`), no kernel launched."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import partitioned

    def smoke(arch, **kw):
        return dataclasses.replace(get_arch(arch).make_config(True), **kw)
    cells = [dict(arch="gemma2-2b", shape="train_4k",
                  info={"kind": "train", "seq_len": 16, "global_batch": 4},
                  config=smoke("gemma2-2b", n_kv_heads=1)),
             dict(arch="dlrm-rm2", shape="serve_p99", info={"kind": "serve", "batch": 8},
                  config=smoke("dlrm-rm2"))]
    for r in partitioned.check(cells, device=dev, workdir=str(tmp_path)):
        assert partitioned.passed(r), r
        assert all(not any(rank["launches"].values()) for rank in r["ranks"])


def test_wharf_cell_on_lockstep_ranks_on_the_card(dev):
    """chip_smoke's 11e-a at a small size: stream_10k_sharded (2 batches)
    at 2^12 vertices on 8 lockstep ranks sharing the card on a (2, 4)
    mesh, its rows unsharded = the one-card plan's outputs on the same
    inputs bit for bit; kernels 1 and 2 launched on every rank."""
    import chip_smoke
    from repro_torch.launch import dryrun, lockstep, steps
    from repro_torch.launch.mesh import fake_mesh
    cfg = dryrun.wharf_config(12, max_pending=2)
    info = dryrun.cut_info("stream_10k_sharded", 2)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        plan = steps.build_cell("wharf-stream", "stream_10k_sharded", mesh=mesh, config=cfg,
                                info=info)
    args, setup, _ = dryrun.wharf_mesh_inputs(plan, cfg, 5, dev)
    run = lockstep.run(lambda r, _: plan.fn(*args), 8, device=dev, setup=setup)
    one = steps.build_cell("wharf-stream", "stream_10k_sharded", config=cfg, info=info)
    oargs = dryrun.wharf_inputs(one, cfg, 5, dev)
    want = lockstep.run(lambda r, _: one.fn(*oargs), 1, device=dev, counted=None).outputs[0]
    chip_smoke.mesh_outputs_equal("stream_10k_sharded", plan, args, run, want, cfg)
    chip_smoke.ranks_launched("stream_10k_sharded", run.launches)
    assert run.launches[0] == {k: int(v) for k, v in run.totals.kernel_calls.items()}
