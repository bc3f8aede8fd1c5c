"""`StreamMetrics`: device-side stream counters; port of
`repro/obs/metrics.py`.

The counters are device tensors updated between the steps of the stream
loops (`core/update.run_stream`, the downstream maintainer) and read
once, at export. The contract, restated for the port (the reference's is
byte-identical HLO with metrics OFF):

  * metrics OFF (the `WalkConfig.metrics` default) runs none of this code:
    the loops launch exactly the kernels, in the same order, that they
    launch without it (tests/test_torch_obs.py);
  * metrics ON leaves engine outputs bit-identical: the counters only READ
    the engine state and draw from no engine key.

Counter semantics are the reference's: `affected_total`/`affected_max`
(|MAV| a step), `pmin_hist` (the re-walked suffix fraction (l - p_min)/l
over affected lanes), `pending_hwm` (pending fill after the append),
`merges_forced`/`merges_eager`, `deg_fallback_lanes` (order-2 factorized
only: emitted non-terminal steps whose current vertex has degree >
dmax), `handoff_*` (the sharded engine's, 0 on one device),
`overflow_first_epoch` (the first epoch each overflow source tripped,
`NEVER` if none) and the nested `staleness` counters.

`record_sharded_step` folds a step of the sharded engine (distr/) into one
shard's counters; `combine_shards` reduces an [S, ...]-stacked tree of the
shards' counters as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device
from repro_torch.obs.staleness import (StalenessMetrics, record_audit,
                                       record_lag)
from repro_torch.tree import tree_map

I32 = torch.int32
I64 = torch.int64

PMIN_BUCKETS = 8
OVERFLOW_SOURCES = ("graph", "store_merge", "mav_gather", "handoff_slab")
OVF_GRAPH, OVF_STORE, OVF_MAV, OVF_SLAB = range(4)
NEVER = 0xFFFFFFFF  # u32 sentinel: overflow source never tripped


@dataclass(frozen=True)
class StreamMetrics:
    """Device counters (int32 scalars and small vectors; the overflow
    epochs are u32 values held in int64)."""

    n_steps: torch.Tensor
    affected_total: torch.Tensor
    affected_max: torch.Tensor
    pmin_hist: torch.Tensor             # int32 [PMIN_BUCKETS]
    pending_hwm: torch.Tensor
    merges_forced: torch.Tensor
    merges_eager: torch.Tensor
    deg_fallback_lanes: torch.Tensor
    handoff_sent: torch.Tensor
    handoff_cross: torch.Tensor
    handoff_max_load: torch.Tensor
    overflow_first_epoch: torch.Tensor  # int64 [4], u32 values
    staleness: StalenessMetrics

    def replace(self, **kw) -> "StreamMetrics":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(device=None) -> "StreamMetrics":
        """Zeroed counters on `device` (None: the card)."""
        device = resolve_device(device)
        z = lambda: torch.zeros((), dtype=I32, device=device)  # noqa: E731
        return StreamMetrics(
            n_steps=z(), affected_total=z(), affected_max=z(),
            pmin_hist=torch.zeros((PMIN_BUCKETS,), dtype=I32, device=device),
            pending_hwm=z(), merges_forced=z(), merges_eager=z(),
            deg_fallback_lanes=z(), handoff_sent=z(), handoff_cross=z(),
            handoff_max_load=z(),
            overflow_first_epoch=torch.full((len(OVERFLOW_SOURCES),), NEVER,
                                            dtype=I64, device=device),
            staleness=StalenessMetrics.empty(device))


def pmin_bucket_counts(p_min, lane_valid, length: int) -> torch.Tensor:
    """int32 [PMIN_BUCKETS] counts of (l - p_min)/l over the valid lanes:
    bucket b covers [b/NB, (b+1)/NB), a full re-walk lands in the last."""
    suffix = length - p_min.to(I64)
    bucket = torch.clamp((suffix * PMIN_BUCKETS) // length, 0, PMIN_BUCKETS - 1)
    counts = torch.zeros((PMIN_BUCKETS,), dtype=I64, device=p_min.device)
    return counts.scatter_add_(0, bucket, lane_valid.to(I64)).to(I32)


def deg_fallback_count(graph, block_owner, block_epoch, length: int, model
                       ) -> torch.Tensor:
    """deg > dmax fallback lane-steps of one emitted version block (the
    lane-major [capacity * l] owner/epoch columns): emitted non-terminal
    positions whose owner has degree > dmax. 0 for models without a
    factorized fallback."""
    from repro_torch.core.store import PAD_EPOCH
    dev = block_owner.device
    if model.order != 2 or model.sampler != "factorized":
        return torch.zeros((), dtype=I32, device=dev)
    n = block_owner.shape[0]
    p = torch.arange(n, device=dev) % length
    emitted = (block_epoch != PAD_EPOCH) & (p < length - 1)
    owner = block_owner.to(I64).clamp(0, graph.n_vertices - 1)
    deg = graph.degrees()[owner]
    return (emitted & (deg > model.dmax)).sum().to(I32)


def record_overflow(m: StreamMetrics, source: int, tripped, epoch
                    ) -> StreamMetrics:
    """Stamp `epoch` as `source`'s first-trip epoch if it tripped now and
    never had before (sticky-first)."""
    first = m.overflow_first_epoch.clone()
    hit = tripped & (first[source] == NEVER)
    first[source] = torch.where(hit, epoch & NEVER, first[source])
    return m.replace(overflow_first_epoch=first)


def record_engine_step(m: StreamMetrics, state, aux, block_row: int,
                       forced_merge: bool, overflow_before, cfg, eager: bool,
                       key=None) -> StreamMetrics:
    """Fold one single-device `stream_step_aux` into the counters: called
    between the Algorithm-2 apply and any eager merge, so the block just
    appended at `block_row` is still pending. `key` is the step key (the
    auditor folds its own stream off it); None skips the auditor."""
    length = state.store.length
    owner = state.pending.owner[block_row]
    epoch_col = state.pending.epoch[block_row]
    st = record_lag(m.staleness, state)
    if key is not None:
        st = record_audit(st, state, key, cfg)
    m = m.replace(
        n_steps=m.n_steps + 1,
        affected_total=m.affected_total + state.last_affected,
        affected_max=torch.maximum(m.affected_max, state.last_affected),
        pmin_hist=m.pmin_hist + pmin_bucket_counts(aux.p_min, aux.lane_valid,
                                                   length),
        pending_hwm=torch.clamp(m.pending_hwm, min=state.n_pending),
        merges_forced=m.merges_forced + int(forced_merge),
        merges_eager=m.merges_eager + int(eager),
        deg_fallback_lanes=m.deg_fallback_lanes + deg_fallback_count(
            state.graph, owner, epoch_col, length, cfg.model),
        staleness=st)
    return record_overflow(m, OVF_MAV, state.overflow & ~overflow_before,
                           state.epoch)


def record_sharded_step(m: StreamMetrics, state, obs: dict, forced_merge: bool,
                        merge_tripped, eager: bool) -> StreamMetrics:
    """Fold one step of the sharded engine into this shard's counters.

    `obs` is the step's observation dict from the sharded update: the
    replicated p_min histogram, this shard's handoff volumes and its
    per-source overflow flags (graph, MAV gather, handoff slab);
    `merge_tripped` is the store merge's. Walk lag is recorded (slot_epoch
    is replicated); the divergence auditor is not (a sharded replay would
    need a cross-shard traversal), so its counters stay 0."""
    m = m.replace(
        staleness=record_lag(m.staleness, state),
        n_steps=m.n_steps + 1,
        affected_total=m.affected_total + state.last_affected,
        affected_max=torch.maximum(m.affected_max, state.last_affected),
        pmin_hist=m.pmin_hist + obs["pmin_hist"],
        pending_hwm=torch.clamp(m.pending_hwm, min=state.n_pending),
        merges_forced=m.merges_forced + int(forced_merge),
        merges_eager=m.merges_eager + int(eager),
        handoff_sent=m.handoff_sent + obs["handoff_sent"],
        handoff_cross=m.handoff_cross + obs["handoff_cross"],
        handoff_max_load=torch.maximum(m.handoff_max_load,
                                       obs["handoff_max_load"]))
    epoch = state.epoch
    m = record_overflow(m, OVF_GRAPH, obs["graph_overflow"], epoch)
    m = record_overflow(m, OVF_STORE, merge_tripped, epoch)
    m = record_overflow(m, OVF_MAV, obs["mav_overflow"], epoch)
    return record_overflow(m, OVF_SLAB, obs["handoff_overflow"], epoch)


def combine_shards(stacked: StreamMetrics) -> StreamMetrics:
    """Reduce an [S, ...]-stacked per-shard metrics tree to global totals:
    replicated counters take shard 0, handoff volumes sum (max-load takes
    the max), overflow epochs take the earliest."""
    first = tree_map(lambda leaf: leaf[0], stacked)
    return first.replace(
        handoff_sent=stacked.handoff_sent.sum().to(I32),
        handoff_cross=stacked.handoff_cross.sum().to(I32),
        handoff_max_load=stacked.handoff_max_load.max().to(I32),
        overflow_first_epoch=stacked.overflow_first_epoch.amin(dim=0))
