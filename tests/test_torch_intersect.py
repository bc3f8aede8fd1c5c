"""Kernel 5's plain versions and oracle against the JAX package's intersect
backends ("xla-ref", and "interpret", which runs the Pallas kernel body's
`_choose_math`), bit for bit: the windowed form on the generator of
tests/test_kernels.py, and the CSR form (`factorized_csr_plain`, the card
kernel's plain version) against the reference's windows of a graph with
hubs and isolated vertices; and the backend registry and guards."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401
from repro.core import StreamingGraph as JGraph
from repro.core import walkers as jw
from repro.kernels import intersect as jint
from repro_torch.core import StreamingGraph
from repro_torch.kernels import intersect, ops

SENT = np.uint32(0xFFFFFFFF)


def _case(rng, b, d, n_vertices=None, p=0.5, q=2.0):
    """tests/test_kernels.py::_intersect_case, as numpy."""
    n_vertices = 2 * d if n_vertices is None else n_vertices
    nbrs_v = np.full((b, d), SENT, np.uint32)
    nbrs_p = np.full((b, d), SENT, np.uint32)
    deg_v = rng.integers(0, d + 1, size=b)
    deg_p = rng.integers(0, d + 1, size=b)
    prev = np.zeros(b, np.uint32)
    for i in range(b):
        nv = np.sort(rng.choice(n_vertices, size=deg_v[i], replace=False))
        npr = np.sort(rng.choice(n_vertices, size=deg_p[i], replace=False))
        nbrs_v[i, : deg_v[i]] = nv
        nbrs_p[i, : deg_p[i]] = npr
        prev[i] = nv[rng.integers(deg_v[i])] if deg_v[i] else \
            rng.integers(n_vertices)
    u = rng.random((b, 2)).astype(np.float32)
    return nbrs_v, nbrs_p, prev, u[:, 0], u[:, 1], p, q


def _torch(case):
    nbrs_v, nbrs_p, prev, u_g, u_r, p, q = case
    t = [torch.from_numpy(a.astype(np.int64)) for a in (nbrs_v, nbrs_p, prev)]
    return t + [torch.from_numpy(u_g), torch.from_numpy(u_r), p, q]


def _edge_case(d, p, q):
    """Empty windows, prev absent from v's window, prev v's only neighbor,
    u_group just below 1, and rows with no common neighbor."""
    nv = np.full((6, d), SENT, np.uint32)
    npv = np.full((6, d), SENT, np.uint32)
    nv[1, :3], npv[1, :2] = [4, 9, 11], [9, 30]
    nv[2, :1], npv[2, :1] = [7], [3]
    nv[3, :5], npv[3, :5] = [1, 2, 3, 4, 5], [2, 3, 8, 9, 10]
    nv[4, :] = np.arange(d)
    npv[4, :] = np.arange(d) * 2
    nv[5, :2] = [100, 200]
    prev = np.array([5, 2, 7, 3, 6, 1], np.uint32)
    u_g = np.array([0.5, 0.3, 0.9, np.nextafter(np.float32(1), np.float32(0)),
                    0.99, 0.0], np.float32)
    u_r = np.array([0.5, 0.99, 0.2, 0.999, 0.0, 0.7], np.float32)
    return nv, npv, prev, u_g, u_r, p, q


@pytest.mark.parametrize("b,d", [(16, 128), (8, 256), (24, 128)])
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (0.25, 4.0), (4.0, 0.25)])
def test_factorized_next_matches_reference(b, d, p, q):
    rng = np.random.default_rng(b * d)
    for case in (_case(rng, b, d, p=p, q=q), _edge_case(d, p, q)):
        jcase = [jnp.asarray(a) for a in case[:5]] + list(case[5:])
        want = {}
        for backend in ("xla-ref", "interpret"):
            nxt, found = jint.factorized_next(*jcase, backend=backend)
            want[backend] = (np.asarray(nxt).astype(np.int64) * np.asarray(found),
                             np.asarray(found))
        np.testing.assert_array_equal(want["xla-ref"][0], want["interpret"][0])
        for backend in ("torch", "ref"):
            nxt, found = intersect.factorized_next(*_torch(case), backend=backend)
            np.testing.assert_array_equal(found.numpy(), want["xla-ref"][1],
                                          err_msg=backend)
            np.testing.assert_array_equal((nxt * found).numpy(),
                                          want["xla-ref"][0], err_msg=backend)


def test_member_sorted_equals_allpairs_and_padding_is_neutral():
    rng = np.random.default_rng(3)
    nbrs_v, nbrs_p, prev, u_g, u_r, p, q = _torch(_case(rng, 32, 64))
    valid = nbrs_v != intersect.SENT
    a = intersect.member_sorted(nbrs_v, nbrs_p)
    b = intersect.member_allpairs(nbrs_v, nbrs_p)
    assert torch.equal(a & valid, b & valid)
    want = intersect.factorized_next(nbrs_v, nbrs_p, prev, u_g, u_r, p, q)
    pv, pp = intersect.pad_windows(nbrs_v, nbrs_p)
    assert pv.shape[1] == 128 and bool((pv[:, 64:] == intersect.SENT).all())
    got = ops.intersect_next(pv, pp, prev, u_g, u_r,
                             *intersect.inverse_weights(p, q))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_weights_round_once_to_f32():
    for p in (0.3, 0.5, 3.0, 7.0):
        assert intersect.inverse_weights(p, p)[0] == float(
            jnp.asarray(float(1.0 / p), jnp.float32))


def test_registry_and_explicit_cuda_guard():
    cpu = torch.device("cpu")
    assert intersect.resolve_backend(None, cpu) == "torch"
    assert intersect.resolve_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="card"):
        intersect.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError):
        intersect.set_default_backend("pallas")
    try:
        intersect.set_default_backend("ref")
        assert intersect.resolve_backend(None, cpu) == "ref"
    finally:
        intersect.set_default_backend(None)
    assert intersect.default_backend_request() is None
    rng = np.random.default_rng(9)
    case = _torch(_case(rng, 12, 100))
    with pytest.raises(ValueError):
        intersect.factorized_next(*case, backend="cuda")   # CPU tensors
    with pytest.raises(ValueError, match="CUDA tensor"):
        intersect.factorized_cuda(*case[:5], 1.0, 1.0)
    nxt, _ = intersect.factorized_next(*case, backend="auto")
    assert nxt.shape == (12,)


def _csr_case(dmax, n=512, b=384, seed=0):
    """Edges on n vertices with four hubs of degree ~2 dmax (> dmax) and
    the last 16 vertices isolated; lanes with v and prev both hubs, v
    isolated, prev isolated, prev == v, prev a neighbor of v, and uniform
    pairs. -> (src, dst, v, prev, u f32 [b, 2])."""
    rng = np.random.default_rng(seed + dmax)
    src, dst = rng.integers(0, n - 16, size=(2, 6000))
    hs = np.repeat(np.arange(4), 2 * dmax)
    src = np.concatenate([src, hs])
    dst = np.concatenate([dst, rng.integers(4, n - 16, size=hs.shape[0])])
    v, prev = rng.integers(0, n, size=(2, b))
    v[:8], prev[:8] = np.arange(8) % 4, (np.arange(8) + 1) % 4   # hub, hub
    v[8:16], prev[8:16] = n - 1 - np.arange(8), rng.integers(0, n, size=8)
    prev[16:24] = n - 1 - np.arange(8)                           # isolated prev
    prev[24:40] = v[24:40]                                       # prev == v
    for i in range(40, 72):                                      # prev ~ v
        nb = dst[src == v[i]]
        prev[i] = nb[i % nb.shape[0]] if nb.shape[0] else prev[i]
    return src, dst, v, prev, rng.random((b, 2)).astype(np.float32)


@pytest.mark.parametrize("dmax", [128, 256, 96])
@pytest.mark.parametrize("p,q", [(0.5, 2.0), (0.25, 4.0), (4.0, 0.25)])
def test_factorized_csr_plain_matches_reference(dmax, p, q):
    n = 512
    src, dst, v, prev, u = _csr_case(dmax, n)
    jg = JGraph.from_edges(jnp.asarray(src, jnp.uint32),
                           jnp.asarray(dst, jnp.uint32), n, 1 << 15)
    tg = StreamingGraph.from_edges(src, dst, n, 1 << 15, device="cpu")
    nbrs_v, deg_v = jw._neighbor_window(jg, v, dmax)
    nbrs_p, deg_p = jw._neighbor_window(jg, prev, dmax)
    nxt, found = jint.factorized_next(nbrs_v, nbrs_p, jnp.asarray(prev, jnp.uint32),
                                      jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]),
                                      p, q, backend="xla-ref")
    found = np.asarray(found)
    want = (np.asarray(nxt).astype(np.int64) * found, found,
            np.asarray((deg_v > dmax) | (deg_p > dmax)))
    deg = np.asarray(tg.degrees())
    assert (deg[v] > dmax).any() and (deg[prev] > dmax).any()
    assert (deg[v] == 0).any() and (deg[prev] == 0).any() and (v == prev).any()
    tv, tp = (torch.from_numpy(a.astype(np.int64)) for a in (v, prev))
    tu = torch.from_numpy(u)
    inv = intersect.inverse_weights(p, q)
    got = intersect.factorized_csr_plain(tg.codes, tg.offsets, tv, tp, tu, dmax, *inv)
    np.testing.assert_array_equal((got[0] * got[1]).numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    for backend in ("torch", "ref", "auto"):
        alt = intersect.factorized_next_csr(tg.codes, tg.offsets, tv, tp, tu, dmax,
                                            p, q, backend=backend)
        for a, b in zip(alt, got):
            assert torch.equal(a, b), backend
    assert torch.equal(ops.intersect_csr(tg.codes, tg.offsets, tv, tp, tu, dmax,
                                         *inv)[0], got[0])


def test_csr_explicit_cuda_request_guards():
    src, dst, v, prev, u = _csr_case(96)
    tg = StreamingGraph.from_edges(src, dst, 512, 1 << 15, device="cpu")
    args = (tg.codes, tg.offsets, torch.from_numpy(v), torch.from_numpy(prev),
            torch.from_numpy(u))
    with pytest.raises(ValueError, match="card"):
        intersect.factorized_next_csr(*args, 128, 0.5, 2.0, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        intersect.factorized_csr_cuda(*args, 128, 1.0, 1.0)
    window = intersect.neighbor_window(tg.codes, tg.offsets, args[2], 96)[0]
    assert window.shape == (v.shape[0], 96)
