"""Batch walk update (paper §6.2, Algorithm 2) and merge (App. A); port of
`repro/core/update.py`.

The engine state is a base WalkStore plus fixed-capacity pending version
blocks (one per processed edge batch). One `stream_step_aux` is: policy
merge -> graph update -> MAV -> re-walk -> pending append (-> eager merge).
Order-2 walks read their prefix (the vertex before p_min) through the
overlay of base + pending (core/overlay.py), and `WalkConfig.megakernel`
selects the fused rewalk step (kernels/megakernel.py) instead of the
unfused loop; both write the same blocks bit for bit.

The reference runs a stream inside one `lax.scan` with `lax.cond` merges
and donated buffers. Here the stream is a host loop: the merge schedule
does not depend on the data, so whether a step merges is decided on the
host, and `n_pending` and `epoch` are host integers. Where the reference
donates, the port updates in place: a step writes its version block into
the pending tensors in place, and a merge resets them in place, so an
engine's earlier `pending` tensors are overwritten (as donation
invalidates them in the reference). Stores are never written in place:
`slot_epoch` is cloned by every update and a merge builds a new store, so
a reader that holds a store, plus copies of the pending blocks it reads
(`Overlay.copy_pending`), keeps its answers while the engine streams on
(the pin registry below, serve/snapshots.py).

With `WalkConfig.metrics` the stream loops also update a
`repro_torch.obs.metrics.StreamMetrics` between the apply and any eager
merge; with it off they run none of that code.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch import random as jr
from repro_torch._u64 import BIAS
from repro_torch.core.corpus import WalkConfig, check_config, walk_start_vertex
from repro_torch.core.graph import StreamingGraph, as_ids
from repro_torch.core.mav import (MAV, gather_touched_segments, keyed_pmin,
                                  mav_from_keyed, touched_vertices)
from repro_torch.core.overlay import Overlay
from repro_torch.core.store import PAD_EPOCH, WalkStore
from repro_torch.core.utils import compact_nonzero, lexsort, seg_searchsorted
from repro_torch.core.walkers import sample_next
from repro_torch.kernels import megakernel, ops

I32 = torch.int32
I64 = torch.int64


class UpdateAux(NamedTuple):
    """Per-update affected-walk identification ([capacity] lanes)."""

    walk_ids: torch.Tensor    # int64 compacted affected walk ids
    lane_valid: torch.Tensor  # bool  lanes < |affected|
    p_min: torch.Tensor       # int64 first re-sampled position


class PendingBlocks(NamedTuple):
    """Fixed-capacity version blocks [P, cap*l]; `slot` = w*l + p."""

    owner: torch.Tensor  # int32
    code: torch.Tensor   # int64 biased; dead entries hold u64 0
    epoch: torch.Tensor  # int32; PAD_EPOCH = dead entry
    slot: torch.Tensor   # int32

    @staticmethod
    def empty(max_pending: int, entries: int, device) -> "PendingBlocks":
        shape = (max_pending, entries)
        return PendingBlocks(
            owner=torch.zeros(shape, dtype=I32, device=device),
            code=torch.full(shape, BIAS, dtype=I64, device=device),
            epoch=torch.full(shape, PAD_EPOCH, dtype=I32, device=device),
            slot=torch.zeros(shape, dtype=I32, device=device))

    def filled(self, n: int) -> Optional["PendingBlocks"]:
        """The first n blocks (views), or None when n is 0."""
        return PendingBlocks(*(t[:n] for t in self)) if n else None

    def clear_(self) -> None:
        """Reset every block to dead entries, in place."""
        self.owner.zero_()
        self.code.fill_(BIAS)
        self.epoch.fill_(PAD_EPOCH)
        self.slot.zero_()


@dataclass(frozen=True)
class EngineState:
    """Graph + base store + pending blocks. `n_pending` and `epoch` are host
    integers (the schedule is data-independent); the counters are device
    scalars, read only when asked."""

    graph: StreamingGraph
    store: WalkStore
    pending: PendingBlocks
    n_pending: int
    epoch: int
    last_affected: torch.Tensor   # int32 []
    total_affected: torch.Tensor  # int32 []
    overflow: torch.Tensor        # bool [] sticky MAV gather overflow

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(graph: StreamingGraph, store: WalkStore, max_pending: int,
               entries: int, pending: Optional[PendingBlocks] = None,
               n_pending: int = 0, epoch: int = 0) -> "EngineState":
        dev = store.device
        if pending is None:
            pending = PendingBlocks.empty(max_pending, entries, dev)
        zero = torch.zeros((), dtype=I32, device=dev)
        return EngineState(graph=graph, store=store, pending=pending,
                           n_pending=int(n_pending), epoch=int(epoch),
                           last_affected=zero, total_affected=zero.clone(),
                           overflow=torch.zeros((), dtype=torch.bool,
                                                device=dev))


class WalkEngine:
    """Stateful wrapper around `EngineState`: graph + walk corpus."""

    def __init__(self, graph: StreamingGraph = None, store: WalkStore = None,
                 cfg: WalkConfig = None, merge_policy: str = "on-demand",
                 rewalk_capacity: int = 1024, max_pending: int = 8,
                 mav_capacity: Optional[int] = None,
                 merge_impl: str = "interleave",
                 pending: Optional[PendingBlocks] = None, n_pending: int = 0,
                 epoch: int = 0):
        check_config(cfg)
        if merge_policy not in ("on-demand", "eager"):
            raise ValueError(f"unknown merge_policy {merge_policy!r}")
        if merge_impl not in ("interleave", "lexsort"):
            raise ValueError(f"unknown merge_impl {merge_impl!r}")
        self.cfg = cfg
        self.merge_policy = merge_policy
        self.rewalk_capacity = rewalk_capacity
        self.max_pending = max_pending
        self.mav_capacity = mav_capacity
        self.merge_impl = merge_impl
        # `epoch` resumes the update counter of a store built mid-stream
        self.state = EngineState.create(graph, store, max_pending,
                                        rewalk_capacity * cfg.length,
                                        pending=pending, n_pending=n_pending,
                                        epoch=epoch)
        # outstanding read pins (serve/snapshots.py)
        self._pins = 0
        # cfg.metrics: StreamMetrics accumulated across run_stream calls
        # (export with repro_torch.obs.export.summary)
        if cfg.metrics:
            from repro_torch.obs.metrics import StreamMetrics
            self.metrics = StreamMetrics.empty(store.device)
        else:
            self.metrics = None

    # ----------------------------------------------------- state projections

    @property
    def graph(self) -> StreamingGraph:
        return self.state.graph

    @property
    def store(self) -> WalkStore:
        return self.state.store

    @property
    def pending(self) -> PendingBlocks:
        return self.state.pending

    @property
    def n_pending(self) -> int:
        return self.state.n_pending

    @property
    def epoch_counter(self) -> int:
        return self.state.epoch

    @property
    def last_affected(self) -> int:
        return int(self.state.last_affected)

    @property
    def total_affected(self) -> int:
        return int(self.state.total_affected)

    @property
    def mav_overflowed(self) -> bool:
        """Sticky MAV gather-capacity flag, checked once at stream end."""
        return bool(self.state.overflow)

    # ----------------------------------------------------------- pin registry

    @property
    def pins_active(self) -> int:
        """Outstanding snapshot pins (serve/snapshots.py)."""
        return self._pins

    def pin_buffers(self) -> None:
        """Register a read pin. The reference stops donating the engine's
        buffers while a pin is out; the port donates nothing, and a pinned
        snapshot owns copies of the only tensors an update rewrites in
        place (the pending blocks), so this only counts."""
        self._pins += 1

    def unpin_buffers(self) -> None:
        """Release one read pin."""
        if self._pins <= 0:
            raise RuntimeError("unpin_buffers without a matching pin")
        self._pins -= 1

    # ------------------------------------------------------------------ API

    def insert_edges(self, key, src, dst):
        return self._update(key, src, dst, None, None)

    def delete_edges(self, key, src, dst):
        return self._update(key, None, None, src, dst)

    def update_batch(self, key, ins_src, ins_dst, del_src, del_dst):
        return self._update(key, ins_src, ins_dst, del_src, del_dst)

    def _update(self, key, ins_src, ins_dst, del_src, del_dst):
        """One graph update delta-G -> walk updates (Algorithm 2). Returns
        the affected count as a device scalar."""
        if self.state.n_pending == self.max_pending:
            self.merge()
        self.state, _ = _apply_update(
            self.state, ins_src, ins_dst, del_src, del_dst,
            jr.as_key(key, self.store.device), self.cfg, self.rewalk_capacity,
            self._mav_capacity())
        if self.merge_policy == "eager":
            self.merge()
        return self.state.last_affected

    def run_stream(self, key, ins_src, ins_dst, del_src=None, del_dst=None,
                   return_masks: bool = False):
        """Consume a whole [n_batches, batch] edge stream; `key` is split
        into one key per batch, as the reference. Returns the per-batch
        affected counts (int32 [n_batches]); MAV overflow accumulates and
        surfaces once via `mav_overflowed`. With `return_masks=True`
        returns `(affected, aux)`, `aux` the stacked `UpdateAux` of the
        steps ([n_batches, capacity] leaves). With `cfg.metrics`,
        `self.metrics` accumulates the stream's counters; the return value
        is unchanged."""
        keys = jr.split(jr.as_key(key, self.store.device), len(ins_src))
        kw = dict(cfg=self.cfg, capacity=self.rewalk_capacity,
                  mav_capacity=self._mav_capacity(),
                  max_pending=self.max_pending, merge_policy=self.merge_policy,
                  merge_impl=self.merge_impl, with_masks=return_masks)
        if self.cfg.metrics:
            self.state, out, self.metrics = run_stream(
                self.state, keys, ins_src, ins_dst, del_src, del_dst,
                metrics=self.metrics, **kw)
        else:
            self.state, out = run_stream(self.state, keys, ins_src, ins_dst,
                                         del_src, del_dst, **kw)
        return out

    def _mav_capacity(self) -> int:
        return self.mav_capacity or self.state.store.size

    def merge(self):
        """Consolidate the pending blocks into the base store (Merge)."""
        if self.state.n_pending:
            self.state = _merge_state(self.state, self.merge_impl)

    def walk_matrix(self):
        """Read out the full corpus (merges first) -> int64 [n_walks, l]."""
        self.merge()
        store = self.state.store
        w = torch.arange(store.n_walks, device=store.device)
        start = walk_start_vertex(w, self.cfg.n_walks_per_vertex)
        return store.traverse(w, start, store.length - 1)

    def overlay(self) -> Overlay:
        """Mergeless read view over base + pending (valid until the next
        update rewrites the pending tensors in place)."""
        return Overlay.build(self.state.store,
                             self.state.pending.filled(self.state.n_pending))


# ------------------------------------------------------------------ the step


def _apply_update(state: EngineState, ins_src, ins_dst, del_src, del_dst,
                  key, cfg: WalkConfig, capacity: int, mav_capacity: int):
    """One Algorithm-2 update appended as a pending version block. The
    `record_function` scopes name the layers in a torch.profiler trace
    (chip_smoke.py reads their device time)."""
    with record_function("wharf.graph_update"):
        graph = state.graph.apply_batch(ins_src, ins_dst, del_src, del_dst)
    with record_function("wharf.mav"):
        mav, overflow = _mav(state, ins_src, ins_dst, del_src, del_dst,
                             mav_capacity)
    with record_function("wharf.rewalk"):
        block, slot_epoch, n_aff, aux = _rewalk(
            key, graph, state.store, state.pending.filled(state.n_pending),
            mav, state.epoch + 1, cfg, capacity)
    pending = state.pending
    j = state.n_pending            # in place: the reference donates pending
    pending.owner[j] = block.owner
    pending.code[j] = block.code
    pending.epoch[j] = block.epoch
    pending.slot[j] = block.slot
    n_aff = n_aff.to(I32)
    return EngineState(
        graph=graph, store=state.store.replace(slot_epoch=slot_epoch),
        pending=pending, n_pending=j + 1, epoch=state.epoch + 1,
        last_affected=n_aff, total_affected=state.total_affected + n_aff,
        overflow=state.overflow | overflow), aux


def _mav(state: EngineState, ins_src, ins_dst, del_src, del_dst,
         mav_capacity: int):
    """The MAV of one batch over the base store and the pending blocks;
    returns (MAV, gather overflow flag)."""
    store, pending = state.store, state.pending
    length, n_walks = store.length, store.n_walks
    touched_v = touched_vertices(store.n_vertices, store.device, ins_src,
                                 ins_dst, del_src, del_dst)

    # MAV over the touched vertices' base-store segments (§6.1) ...
    g_owner, g_code, g_epoch, g_valid, total = gather_touched_segments(
        store, touched_v, mav_capacity)
    overflow = total > mav_capacity
    g_f, _ = ops.szudzik_unpair(g_code)
    g_touched = touched_v[g_owner.to(I64)] & g_valid
    best = keyed_pmin(g_f // length, g_f % length, g_owner, g_epoch,
                      store.slot_epoch, g_touched, g_valid, length, n_walks)
    # ... and over the pending blocks, one block at a time (blocks past
    # n_pending hold only dead entries and add nothing to the min)
    for i in range(state.n_pending):
        p_slot = pending.slot[i].to(I64)
        p_valid = pending.epoch[i] != PAD_EPOCH
        p_touched = touched_v[pending.owner[i].to(I64)] & p_valid
        best = torch.minimum(best, keyed_pmin(
            p_slot // length, p_slot % length, pending.owner[i],
            pending.epoch[i], store.slot_epoch, p_touched, p_valid, length,
            n_walks))
    return mav_from_keyed(best, length), overflow


class VersionBlock(NamedTuple):
    owner: torch.Tensor
    code: torch.Tensor
    epoch: torch.Tensor
    slot: torch.Tensor


def _rewalk(key, graph: StreamingGraph, store: WalkStore,
            pending: Optional[PendingBlocks], mav: MAV, new_epoch: int,
            cfg: WalkConfig, capacity: int):
    """Lines 4-11 of Algorithm 2: re-walk up to `capacity` affected walks
    from p_min with fresh draws on the updated graph; emit triplets at
    positions p_min..l-1 (the terminal one points to itself) and bump their
    slot versions. `pending` holds the filled version blocks (or None): an
    order-2 walk reads its prefix through them. Affected walks beyond
    `capacity` are dropped without a flag, as in the reference
    (compact_nonzero)."""
    dev = store.device
    length = store.length
    affected = mav.p_min < length
    walk_ids, lane_valid = compact_nonzero(affected, size=capacity)
    p_min = mav.p_min[walk_ids]
    v_at_pmin = mav.v_min[walk_ids]
    f_base = walk_ids * length

    req = (cfg.megakernel if cfg.megakernel != "auto"
           else megakernel.default_backend_request())
    backend = megakernel.resolve_backend(req, dev)
    if backend is not None:
        megakernel.check_supported(store, cfg, backend)
        owners, codes, emits = megakernel.fused_scan(
            key, graph, store, pending, walk_ids, lane_valid, p_min,
            v_at_pmin, cfg, backend)
    else:
        if cfg.model.order == 2:
            # the vertex before p_min, read through base + pending (earlier
            # blocks may have rewritten prefix slots)
            with record_function("wharf.prefix"):
                view = (store if pending is None
                        else Overlay.build(store, pending))
                prev0 = _prefix_prev(view, walk_ids, lane_valid, p_min, cfg)
        else:
            prev0 = v_at_pmin
        owners = torch.empty((capacity, length), dtype=I32, device=dev)
        codes = torch.empty((capacity, length), dtype=I64, device=dev)
        emits = torch.empty((capacity, length), dtype=torch.bool, device=dev)
        keys = jr.split(key, length)
        cur, prev = v_at_pmin, prev0
        for p in range(length):
            cur = torch.where(p_min == p, v_at_pmin, cur)
            is_term = p == length - 1   # the terminal triplet points to itself
            nxt = cur if is_term else sample_next(keys[p], graph, cur, prev,
                                                  cfg.model)
            codes[:, p] = ops.szudzik_pair(f_base + p, nxt)
            past = p >= p_min
            emits[:, p] = lane_valid & past
            owners[:, p] = cur.to(I32)
            prev = torch.where(past, cur, prev)
            if not is_term:
                cur = torch.where(past, nxt, cur)
    owners, codes, emits = owners.reshape(-1), codes.reshape(-1), emits.reshape(-1)

    epoch = torch.where(emits, new_epoch, PAD_EPOCH).to(I32)
    owners = torch.where(emits, owners, 0)
    codes = torch.where(emits, codes, BIAS)   # u64 0
    # bump slot versions for every rewritten slot (w, p >= p_min)
    slots = (f_base[:, None] + torch.arange(length, device=dev)[None]).reshape(-1)
    slots = slots.clamp(0, store.n_walks * length - 1)
    slot_epoch = store.slot_epoch.clone()
    slot_epoch.scatter_reduce_(0, slots, torch.where(emits, new_epoch, 0).to(I32),
                               "amax")
    block = VersionBlock(owner=owners, code=codes, epoch=epoch,
                         slot=torch.where(emits, slots, 0).to(I32))
    aux = UpdateAux(walk_ids=walk_ids, lane_valid=lane_valid, p_min=p_min)
    return block, slot_epoch, affected.sum(), aux


def _prefix_prev(view, walk_ids, lane_valid, p_min, cfg: WalkConfig):
    """Each walk's vertex at max(p_min - 1, 0) through `view` (a store or an
    overlay). The reference traverses all l-1 positions of every lane and
    reads this one column; the port walks each valid lane only as far as
    that column (the same FINDNEXTs, in the same order), and leaves the
    padding lanes, which emit nothing, at their start."""
    cur = walk_start_vertex(walk_ids, cfg.n_walks_per_vertex)
    stop = torch.where(lane_valid, (p_min - 1).clamp(min=0), 0)
    n = int(stop.max()) if stop.numel() else 0
    for p in range(n):
        lanes = torch.nonzero(stop > p).reshape(-1)
        c = cur[lanes]
        nxt, found = view.find_next(c, walk_ids[lanes],
                                    torch.full_like(lanes, p))
        cur[lanes] = torch.where(found, nxt, c)
    return cur


# ------------------------------------------------------------------- merges


def _merge_state(state: EngineState, merge_impl: str) -> EngineState:
    """Fold the filled pending blocks into the base store and reset the
    pending tensors in place."""
    with record_function("wharf.merge"):
        return _merge_filled(state, merge_impl)


def _merge_filled(state: EngineState, merge_impl: str) -> EngineState:
    n = state.n_pending
    p = state.pending
    if merge_impl == "interleave":
        store = merge_interleave(state.store, p.owner[:n].reshape(-1),
                                 p.code[:n].reshape(-1),
                                 p.epoch[:n].reshape(-1),
                                 p.slot[:n].reshape(-1))
    else:
        s = state.store
        store = merge_consolidate(
            torch.cat([s.owner, p.owner[:n].reshape(-1)]),
            torch.cat([s.code, p.code[:n].reshape(-1)]),
            torch.cat([s.epoch, p.epoch[:n].reshape(-1)]), s)
    p.clear_()
    return state.replace(store=store, n_pending=0)


def consolidate(state: EngineState, merge_impl: str = "interleave") -> EngineState:
    """Public Merge: fold every pending block into the base store."""
    return _merge_state(state, merge_impl) if state.n_pending else state


def pending_after_stream(n_pending: int, n_batches: int, max_pending: int,
                         merge_policy: str) -> int:
    """Pending fill level after `n_batches` steps (the data-independent
    merge schedule)."""
    if n_batches <= 0:
        return n_pending
    if merge_policy == "eager":
        return 0
    return (n_pending + n_batches - 1) % max_pending + 1


def stream_step_aux(state: EngineState, key, ins_src, ins_dst, del_src,
                    del_dst, cfg: WalkConfig, capacity: int,
                    mav_capacity: int, max_pending: int, merge_policy: str,
                    merge_impl: str, metrics=None):
    """One streaming step: forced merge if pending is full, Algorithm 2,
    then the eager merge. Returns (EngineState, UpdateAux). With a
    `StreamMetrics` as `metrics` the step also folds this update into the
    counters (after the apply, before the eager merge, while the new block
    is pending) and returns (state, aux, metrics)."""
    forced = state.n_pending >= max_pending
    if forced:
        state = _merge_state(state, merge_impl)
    overflow_before = state.overflow
    state, aux = _apply_update(state, ins_src, ins_dst, del_src, del_dst,
                               key, cfg, capacity, mav_capacity)
    if metrics is not None:
        from repro_torch.obs.metrics import record_engine_step
        metrics = record_engine_step(metrics, state, aux, state.n_pending - 1,
                                     forced, overflow_before, cfg,
                                     eager=merge_policy == "eager", key=key)
    if merge_policy == "eager":
        state = _merge_state(state, merge_impl)
    if metrics is not None:
        return state, aux, metrics
    return state, aux


def stream_step(state: EngineState, key, ins_src, ins_dst, del_src, del_dst,
                cfg: WalkConfig, capacity: int, mav_capacity: int,
                max_pending: int, merge_policy: str,
                merge_impl: str) -> EngineState:
    """The shared update step, state alone: `stream_step_aux` without its
    aux, as the reference's `stream_step`."""
    state, _ = stream_step_aux(state, key, ins_src, ins_dst, del_src,
                               del_dst, cfg, capacity, mav_capacity,
                               max_pending, merge_policy, merge_impl)
    return state


def run_stream(state: EngineState, keys, ins_src, ins_dst, del_src, del_dst,
               *, cfg: WalkConfig, capacity: int, mav_capacity: int,
               max_pending: int, merge_policy: str = "on-demand",
               merge_impl: str = "interleave", with_masks: bool = False,
               metrics=None):
    """A whole [n_batches, batch] stream through `stream_step_aux`, one
    host loop; `keys` [n_batches, 2]. Deletion streams may be None or
    zero-width. Returns (state, affected int32 [n_batches]), or with
    `with_masks` (state, (affected, UpdateAux of [n_batches, capacity]
    leaves)). With `cfg.metrics` the counters of `metrics` (default
    fresh) are updated step by step and returned last: (state, out,
    metrics)."""
    dev = state.store.device
    ins_src, ins_dst = as_ids(ins_src, dev), as_ids(ins_dst, dev)
    n_batches = ins_src.shape[0]
    if del_src is None:
        del_src = del_dst = torch.zeros((n_batches, 0), dtype=I64, device=dev)
    else:
        del_src, del_dst = as_ids(del_src, dev), as_ids(del_dst, dev)
    keys = jr.as_key(keys, dev)
    if cfg.metrics and metrics is None:
        from repro_torch.obs.metrics import StreamMetrics
        metrics = StreamMetrics.empty(dev)
    affected, auxs = [], []
    for i in range(n_batches):
        step = (keys[i], ins_src[i], ins_dst[i], del_src[i], del_dst[i], cfg,
                capacity, mav_capacity, max_pending, merge_policy, merge_impl)
        if cfg.metrics:
            state, aux, metrics = stream_step_aux(state, *step,
                                                  metrics=metrics)
        else:
            state, aux = stream_step_aux(state, *step)
        affected.append(state.last_affected)
        if with_masks:
            auxs.append(aux)
    affected = torch.stack(affected)
    out = (affected if not with_masks
           else (affected, UpdateAux(*map(torch.stack, zip(*auxs)))))
    if cfg.metrics:
        return state, out, metrics
    return state, out


def merge_interleave(base: WalkStore, acc_owner, acc_code, acc_epoch,
                     acc_slot) -> WalkStore:
    """O(T) interleave Merge: the base store is already (owner, code)-sorted,
    so only the live pending rows are sorted and slotted in.

      live base[i] -> i - dead_prefix[i] + #acc_with_pos<=i
      acc[j]       -> live_prefix[pos_j] + rank_j

    The reference sorts every pending row with dead rows last and then
    drops the dead ones; sorting only the live rows places them the same.
    """
    t = base.size
    length, n_walks = base.length, base.n_walks
    nwl = n_walks * length
    dev = base.device

    f, _ = ops.szudzik_unpair(base.code)
    live_b = base.epoch == base.slot_epoch[f.clamp(0, nwl - 1)]
    del f
    live_a = (acc_epoch != PAD_EPOCH) & (
        acc_epoch == base.slot_epoch[acc_slot.to(I64).clamp(0, nwl - 1)])
    sel = torch.nonzero(live_a).reshape(-1)
    a_owner, a_code, a_epoch = acc_owner[sel], acc_code[sel], acc_epoch[sel]
    order = lexsort((a_code, a_owner))
    a_owner, a_code, a_epoch = a_owner[order], a_code[order], a_epoch[order]

    own = a_owner.to(I64)
    seg_lo = base.offsets[own.clamp(0, base.n_vertices - 1)]
    seg_hi = base.offsets[(own + 1).clamp(0, base.n_vertices)]
    pos_a = seg_searchsorted(base.code, seg_lo, seg_hi, a_code, side="left")

    live_prefix = torch.cumsum(live_b, dim=0)          # live base[<=i]
    acc_before = torch.searchsorted(torch.sort(pos_a).values,
                                    torch.arange(t, device=dev), right=True)
    out_base = (live_prefix - 1 + acc_before)[live_b]
    lp_at = torch.where(pos_a > 0, live_prefix[(pos_a - 1).clamp(0, t - 1)], 0)
    out_acc = lp_at + torch.arange(sel.shape[0], device=dev)

    owner_out = torch.zeros((t,), dtype=I32, device=dev)
    code_out = torch.full((t,), BIAS, dtype=I64, device=dev)
    epoch_out = torch.zeros((t,), dtype=I32, device=dev)
    for out, b_col, a_col in ((owner_out, base.owner, a_owner),
                              (code_out, base.code, a_code),
                              (epoch_out, base.epoch, a_epoch)):
        out[out_base] = b_col[live_b]
        out[out_acc] = a_col
    # prev=base keeps the packed rows of chunks the merge left unchanged
    return WalkStore.from_sorted(owner_out, code_out, epoch_out,
                                 base.slot_epoch, length, n_walks,
                                 base.n_vertices, base.chunk_b, prev=base)


def merge_consolidate(owner, code, epoch, base: WalkStore) -> WalkStore:
    """Sort-merge eviction (paper-faithful bulk Merge): keep, per slot, the
    live entry; one three-key lexsort over base + pending."""
    t = base.size
    f, _ = ops.szudzik_unpair(code)
    slot = f.clamp(0, base.n_walks * base.length - 1)
    live = (epoch != PAD_EPOCH) & (epoch == base.slot_epoch[slot])
    order = lexsort((code, owner, ~live))[:t]
    return WalkStore.from_sorted(owner[order], code[order], epoch[order],
                                 base.slot_epoch, base.length, base.n_walks,
                                 base.n_vertices, chunk_b=base.chunk_b,
                                 prev=base)
