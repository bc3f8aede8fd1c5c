"""The `stats` tier on the port (tests/test_walk_stats.py's seven cases at
the same seeds, contexts, reps, rounds and thresholds): chi-square fits of
the port's order-2 samplers, and of its corpus after an insert(+delete)
stream, against the exact node2vec weights. Run with `pytest -m stats`.

The CPU cases run the samplers' plain versions. The `cuda` cases sample
the factorized model on the card, at dmax 128 (the CSR kernel refuses
dmax % 128 != 0): SAMPLENEXT through kernel 5's CSR entry, and a stream
whose rewalks go through kernel 6 (the fused step); each is held to the
same chi-square, and its kernel's launches are counted.
"""
import pytest
import torch

from _torch_stats import (adjacency, chi2_crit, chi2_tv_against_exact,
                          edge_contexts, sampler_counts, sampler_graph,
                          stream_engine, stream_transition_counts)
from repro_torch.core.walkers import WalkModel
from repro_torch.kernels import ops

pytestmark = pytest.mark.stats


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------- sampler-level tests


def test_factorized_sampler_exact_chi2():
    """The factorized sampler is exact even for sharp (p, q)."""
    g = sampler_graph()
    adj = adjacency(g)
    contexts = edge_contexts(adj, 12)
    p, q = 0.25, 4.0
    model = WalkModel(order=2, p=p, q=q, sampler="factorized", dmax=32)
    counts = sampler_counts(g, model, contexts, reps=16, rounds=40, seed=50)
    chi2, df, tv = chi2_tv_against_exact(counts, adj, p, q)
    assert chi2 < chi2_crit(df, 1e-3), (chi2, df, tv)


def test_rejection_sampler_bias_bound():
    """K=8 rejection: empirical TV within the documented (1-amin/amax)^K
    residual bound (plus sampling noise, calibrated off the exact sampler
    on the identical harness)."""
    g = sampler_graph()
    adj = adjacency(g)
    contexts = edge_contexts(adj, 12)
    p, q = 0.5, 2.0
    k = 8
    bound = (1.0 - (0.5 / 2.0)) ** k           # amin/amax = (1/q)/(1/p)
    m_rej = WalkModel(order=2, p=p, q=q, n_trials=k)
    m_fac = WalkModel(order=2, p=p, q=q, sampler="factorized", dmax=32)
    c_rej = sampler_counts(g, m_rej, contexts, reps=16, rounds=40, seed=60)
    c_fac = sampler_counts(g, m_fac, contexts, reps=16, rounds=40, seed=61)
    _, _, tv_rej = chi2_tv_against_exact(c_rej, adj, p, q)
    _, _, tv_fac = chi2_tv_against_exact(c_fac, adj, p, q)
    assert tv_rej <= bound + tv_fac + 0.02, (tv_rej, bound, tv_fac)


def test_harness_detects_rejection_bias_at_small_k():
    """Power check: at K=2 with sharp (p, q) the rejection sampler's
    residual bias is real and the harness rejects it, while the factorized
    sampler passes on the identical contexts and sample sizes."""
    g = sampler_graph()
    adj = adjacency(g)
    contexts = edge_contexts(adj, 12)
    p, q = 0.25, 4.0
    m_rej = WalkModel(order=2, p=p, q=q, n_trials=2)
    m_fac = WalkModel(order=2, p=p, q=q, sampler="factorized", dmax=32)
    c_rej = sampler_counts(g, m_rej, contexts, reps=16, rounds=40, seed=70)
    c_fac = sampler_counts(g, m_fac, contexts, reps=16, rounds=40, seed=71)
    chi2_rej, df_rej, _ = chi2_tv_against_exact(c_rej, adj, p, q)
    chi2_fac, df_fac, _ = chi2_tv_against_exact(c_fac, adj, p, q)
    assert chi2_rej > 2.0 * chi2_crit(df_rej, 1e-3), (chi2_rej, df_rej)
    assert chi2_fac < chi2_crit(df_fac, 1e-3), (chi2_fac, df_fac)


# -------------------------------------------------------- stream-level tests


@pytest.mark.parametrize("with_deletes", [False, True])
def test_stream_factorized_exact_chi2(with_deletes):
    """The factorized order-2 sampler passes the exact chi-square test on
    insert and insert+delete streams."""
    p, q = 0.5, 2.0
    eng = stream_engine("factorized", p, q)
    counts = stream_transition_counts(eng, with_deletes)
    adj = adjacency(eng.graph)
    chi2, df, tv = chi2_tv_against_exact(counts, adj, p, q)
    assert chi2 < chi2_crit(df, 1e-3), (chi2, df, tv)


@pytest.mark.parametrize("with_deletes", [False, True])
def test_stream_rejection_bias_within_bound(with_deletes):
    """The K=8 rejection sampler stays within its documented residual-bias
    bound on the same streams (noise calibrated off the exact sampler)."""
    p, q = 0.5, 2.0
    bound = (1.0 - 0.25) ** 8
    e_rej = stream_engine("rejection", p, q)
    e_fac = stream_engine("factorized", p, q)
    c_rej = stream_transition_counts(e_rej, with_deletes)
    c_fac = stream_transition_counts(e_fac, with_deletes)
    adj = adjacency(e_rej.graph)
    _, _, tv_rej = chi2_tv_against_exact(c_rej, adj, p, q)
    _, _, tv_fac = chi2_tv_against_exact(c_fac, adj, p, q)
    assert tv_rej <= bound + tv_fac + 0.05, (tv_rej, bound, tv_fac)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_card_csr_kernel_sampler_exact_chi2(card):
    """SAMPLENEXT through kernel 5's CSR entry (dmax 128) is exact."""
    g = sampler_graph(card)
    adj = adjacency(g)
    contexts = edge_contexts(adj, 12)
    p, q = 0.25, 4.0
    model = WalkModel(order=2, p=p, q=q, sampler="factorized", dmax=128)
    ops.reset_launches()
    counts = sampler_counts(g, model, contexts, reps=16, rounds=40, seed=50)
    assert ops.launches["intersect_csr"] == 40
    chi2, df, tv = chi2_tv_against_exact(counts, adj, p, q)
    assert chi2 < chi2_crit(df, 1e-3), (chi2, df, tv)


@pytest.mark.cuda
@pytest.mark.parametrize("with_deletes", [False, True])
def test_card_fused_stream_exact_chi2(card, with_deletes):
    """A stream whose rewalks take kernel 6 (the fused step, dmax 128)
    leaves a corpus that passes the exact chi-square test."""
    p, q = 0.5, 2.0
    eng = stream_engine("factorized", p, q, dev=card, dmax=128, megakernel="cuda")
    ops.reset_launches()
    counts = stream_transition_counts(eng, with_deletes)
    assert ops.launches["fused_rewalk_step"] > 0
    adj = adjacency(eng.graph)
    chi2, df, tv = chi2_tv_against_exact(counts, adj, p, q)
    assert chi2 < chi2_crit(df, 1e-3), (chi2, df, tv)
