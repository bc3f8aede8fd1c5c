"""Walk-freshness metrics: how stale is the maintained corpus right now?
Port of `repro/obs/staleness.py`.

Carried by the `WalkConfig.metrics` stream path under the same contract as
the rest of `StreamMetrics`: OFF runs none of this code, ON only READS the
engine state and draws from no engine key (bit-identical outputs).

Three signals:

  * **per-walk epoch-lag histogram** — a slot's lag is `epoch -
    slot_epoch[slot]` (u32), a walk's lag the MIN over its slots: every
    rewalk rewrites the suffix through the terminal slot, so the min is
    the batches since the walk was last refreshed. Log2 buckets: bucket 0
    = lag 0, bucket b = lag in [2^(b-1), 2^b), the last open-ended.
  * **stale-walk fraction over stream time** — a walk observation is stale
    when its lag >= `STALE_LAG`; the fraction is derived at export.
  * **divergence auditor** — each step draws K walk ids from
    `fold_in(step_key, AUDIT_SALT)` (no engine draw is consumed), replays
    them through the current overlay (base + pending) and counts the
    transitions (u -> x) with no live edge, other than the isolated-vertex
    self-loop `sample_neighbor` defines. 0 on a maintained engine.

The auditor is single-host; the sharded engine (distr/, not ported yet)
records lag only in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device
from repro_torch._u64 import M32, u32_value

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

LAG_BUCKETS = 8
# lower bound of bucket b (b >= 1); bucket 0 holds lag == 0 exactly and the
# last bucket is open-ended
LAG_THRESHOLDS = (1, 2, 4, 8, 16, 32, 64)
assert len(LAG_THRESHOLDS) == LAG_BUCKETS - 1

# a walk observation counts stale when not refreshed for >= STALE_LAG
# batches (a histogram bucket edge, so other thresholds stay derivable)
STALE_LAG = 4

# PRNG salt of the auditor's sample key: `fold_in(step_key, AUDIT_SALT)`
AUDIT_SALT = 0x57A1E


@dataclass(frozen=True)
class StalenessMetrics:
    """Device freshness counters (nested inside `StreamMetrics`)."""

    lag_hist: torch.Tensor           # int32 [LAG_BUCKETS] walk-lag histogram
    lag_sum: torch.Tensor            # f32 [] cumulative walk lag
    lag_max: torch.Tensor            # int32 [] max walk lag observed
    walk_steps: torch.Tensor         # int32 [] walk observations
    stale_walk_steps: torch.Tensor   # int32 [] observations with lag >= STALE_LAG
    audit_walks: torch.Tensor        # int32 [] walks replayed by the auditor
    audit_transitions: torch.Tensor  # int32 [] transitions checked
    audit_invalid: torch.Tensor      # int32 [] transitions with no live edge

    def replace(self, **kw) -> "StalenessMetrics":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(device=None) -> "StalenessMetrics":
        """Zeroed counters on `device` (None: the card)."""
        device = resolve_device(device)
        z = lambda: torch.zeros((), dtype=I32, device=device)  # noqa: E731
        return StalenessMetrics(
            lag_hist=torch.zeros((LAG_BUCKETS,), dtype=I32, device=device),
            lag_sum=torch.zeros((), dtype=F32, device=device), lag_max=z(),
            walk_steps=z(), stale_walk_steps=z(), audit_walks=z(),
            audit_transitions=z(), audit_invalid=z())


def per_walk_lag(state) -> torch.Tensor:
    """int64 [n_walks] freshness lag (u32 values): epochs since each walk
    was last refreshed (the min of its slots' lags)."""
    store = state.store
    slot_lag = (state.epoch - u32_value(store.slot_epoch)) & M32
    return slot_lag.reshape(store.n_walks, store.length).amin(dim=1)


def lag_bucket_counts(lag: torch.Tensor) -> torch.Tensor:
    """int32 [LAG_BUCKETS] histogram of walk lags over the log2 buckets."""
    th = torch.tensor(LAG_THRESHOLDS, dtype=I64, device=lag.device)
    bucket = (lag[:, None] >= th[None, :]).sum(dim=1)
    return torch.bincount(bucket, minlength=LAG_BUCKETS).to(I32)


def record_lag(st: StalenessMetrics, state) -> StalenessMetrics:
    """Fold one post-apply engine state's walk-lag snapshot into the
    counters. The lag sum is taken exactly and rounded once to f32 (the
    reference's f32 sum of integer lags is exact below 2^24)."""
    lag = per_walk_lag(state)
    return st.replace(
        lag_hist=st.lag_hist + lag_bucket_counts(lag),
        lag_sum=st.lag_sum + lag.sum().to(F32),
        lag_max=torch.maximum(st.lag_max, lag.max().to(I32)),
        walk_steps=st.walk_steps + lag.shape[0],
        stale_walk_steps=st.stale_walk_steps
        + (lag >= STALE_LAG).sum().to(I32))


def audit_invalid_count(key, graph, store, pending, k: int, n_w: int
                        ) -> torch.Tensor:
    """int32 [] invalid transitions among K sampled walks replayed through
    the overlay of `store` + `pending` (the filled blocks, or None) against
    `graph`. A transition (u -> x) at a non-terminal position is valid iff
    the edge (u, x) is live, or it is the isolated-vertex self-loop (u == x,
    deg(u) == 0); a FINDNEXT miss keeps the walk at u, which counts invalid
    whenever u has neighbors."""
    from repro_torch.core.corpus import walk_start_vertex
    from repro_torch.core.overlay import Overlay
    akey = jr.fold_in(key, AUDIT_SALT)
    wids = jr.randint(akey, (k,), 0, store.n_walks)
    ov = Overlay.build(store, pending)
    path = ov.traverse(wids, walk_start_vertex(wids, n_w), store.length - 1)
    u, x = path[:, :-1].reshape(-1), path[:, 1:].reshape(-1)
    deg_u = graph.degrees()[u]
    ok = graph.has_edge(u, x) | ((u == x) & (deg_u == 0))
    return (~ok).sum().to(I32)


def record_audit(st: StalenessMetrics, state, key, cfg) -> StalenessMetrics:
    """Replay `cfg.audit_k` sampled walks through the live overlay and fold
    the invalid-transition count (0 skips the auditor)."""
    k = int(cfg.audit_k)
    if k <= 0:
        return st
    invalid = audit_invalid_count(key, state.graph, state.store,
                                  state.pending.filled(state.n_pending), k,
                                  cfg.n_walks_per_vertex)
    length = state.store.length
    return st.replace(
        audit_walks=st.audit_walks + k,
        audit_transitions=st.audit_transitions + k * (length - 1),
        audit_invalid=st.audit_invalid + invalid)
