"""Explicitly partitioned walk engine on `torch.distributed` (port of
`repro/distr/sharded.py`).

One process a shard, rank = shard index (or one thread a shard, the ranks
of an in-process group run in lockstep: `launch/lockstep.py`); each rank
holds and passes its OWN shard state (a `core.update.EngineState`). The state is partitioned
BY VERTEX RANGE (shard k of S owns vertices [k*vps, (k+1)*vps)):
  * graph edge codes: the sorted codes whose SOURCE the shard owns
    (per-shard capacity, SENTINEL-padded); the CSR offsets span the global
    vertex space, so `sample_neighbor` works unchanged on owned vertices;
  * triplet store: the (owner, code, epoch) triplets whose owner the shard
    owns, sorted, pad rows (owner=n, SENTINEL, PAD_EPOCH) at the tail;
    packed chunks, vmin and vmax derived locally;
  * pending blocks: each shard's version blocks hold only the entries its
    vertices own (a lane emits on the shard that owns its current vertex);
  * slot_epoch and the engine's scalars: REPLICATED. The slot-version bump
    depends only on (affected walk ids, p_min), which every shard derives
    from the combined MAV, so it is recomputed alike everywhere.

A batch makes exactly 1 + `length` collectives (`distr/collectives.py`):
  1. the MAV combine, one `all_reduce(MIN)` over the int64 [n_walks]
     composite keys (core/mav.py::keyed_pmin), whose (p, owner) order gives
     the single-device tie-break;
  2. the walk handoff, one `all_to_all` of fixed-size lane slabs a rewalk
     step (distr/handoff.py).
No rank reads another rank's overflow flag or affected count mid-stream.

Bit-identity with the single-device engine: every shard draws the full
[capacity] lanes with the same key, and a lane's draw depends only on
(key, lane), so the shard that owns a lane reproduces the single-device
draw (core/walkers.py::sample_next_sharded). The rewalk is the unfused
loop, order 1 only. `n_pending` and `epoch` are host integers, as in
core/update.py, so every rank takes the same merge branch.

Capacities (`ShardSpec`): per-shard edge, store and MAV-gather rows and the
handoff slab. Overflowing any sets the sticky `overflow` flag, read at
stream end. Each shard keeps the single-device [max_pending, capacity*l]
pending allocation (the content is partitioned, the allocation is not).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import random as jr
from repro_torch._u64 import BIAS, hi32, u32_value
from repro_torch.core.corpus import WalkConfig
from repro_torch.core.graph import SENTINEL, StreamingGraph, as_ids, edge_code
from repro_torch.core.mav import (gather_touched_segments, keyed_pmin,
                                  mav_from_keyed, touched_vertices)
from repro_torch.core.store import PAD_EPOCH, WalkStore
from repro_torch.core.update import EngineState, PendingBlocks
from repro_torch.core.utils import compact_nonzero, lexsort
from repro_torch.core.walkers import sample_next_sharded
from repro_torch.distr import collectives
from repro_torch.distr.handoff import exchange_frontier, shard_of_vertex
from repro_torch.kernels import ops

I32 = torch.int32
I64 = torch.int64
PAD_CODE = SENTINEL


@dataclass(frozen=True)
class ShardSpec:
    """Static shape of the vertex-range partition."""

    n_shards: int
    n_vertices: int
    edge_capacity: int    # per-shard sorted-code capacity
    store_capacity: int   # per-shard triplet rows (>= owned live triplets)
    mav_capacity: int     # per-shard MAV gather capacity
    slab: int             # handoff lanes per (src, dst) shard pair a step

    @property
    def vps(self) -> int:
        """Vertices per shard (ceil; the last shard may own fewer)."""
        return -(-self.n_vertices // self.n_shards)

    @staticmethod
    def create(n_shards: int, n_vertices: int, total_triplets: int,
               total_edge_capacity: int, rewalk_capacity: int,
               headroom: float = 2.0) -> "ShardSpec":
        """Balanced default: `headroom` x the uniform share (skewed graphs
        put more triplets on hub-owning shards), rounded up to the
        128-code packed chunk."""
        def share(total):
            per = int(total * headroom) // n_shards + 1
            return -(-per // 128) * 128
        return ShardSpec(n_shards=n_shards, n_vertices=n_vertices,
                         edge_capacity=min(share(total_edge_capacity),
                                           total_edge_capacity),
                         store_capacity=min(share(total_triplets),
                                            total_triplets),
                         mav_capacity=min(share(total_triplets),
                                          total_triplets),
                         slab=rewalk_capacity)


def shard_group(n_shards: int, group=None):
    """The group of an `n_shards` run, checked to hold one rank a shard:
    `group`, else the in-process group this thread is bound to (ranks as
    threads, `launch/lockstep.py`), else the whole world."""
    group = collectives.bound_group() if group is None else group
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError("the sharded engine needs torch.distributed "
                               "initialized (one process a shard) or an "
                               "in-process group (one thread a shard)")
        group = dist.group.WORLD
    size = collectives.group_size(group)
    if size != n_shards:
        raise ValueError(f"{n_shards} shards need {n_shards} ranks, the "
                         f"group has {size}")
    return group


# ------------------------------------------------------- local graph update


def _local_delete(codes, gone):
    """Match-and-sentinel deletion against the local sorted codes, the
    single-device `delete_edges` math: codes absent here simply miss."""
    gone = torch.sort(gone).values
    pos = torch.searchsorted(gone, codes).clamp(0, gone.shape[0] - 1)
    hit = gone[pos] == codes
    return torch.sort(torch.where(hit, SENTINEL, codes)).values


def _local_insert(codes, new_masked, capacity: int):
    """Sorted merge + dedup + slice, as `insert_edges`; `new_masked` has
    the directions this shard does not own replaced by SENTINEL. Returns
    (codes, overflow): overflow = the live codes did not fit."""
    merged = torch.sort(torch.cat([codes, new_masked])).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=codes.device),
                     merged[1:] == merged[:-1]])
    merged = torch.sort(torch.where(dup, SENTINEL, merged)).values
    overflow = (merged != SENTINEL).sum() > capacity
    return merged[:capacity], overflow


def _local_apply_batch(graph: StreamingGraph, ins_src, ins_dst, del_src,
                       del_dst, spec: ShardSpec, my_shard: int):
    """Shard-local graph delta: deletions then insertions (both
    undirected), keeping the directions whose source this shard owns."""
    dev = graph.device
    codes = graph.codes
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if del_src is not None and len(del_src) > 0:
        s, d = as_ids(del_src, dev), as_ids(del_dst, dev)
        codes = _local_delete(codes, torch.cat([edge_code(s, d),
                                                edge_code(d, s)]))
    if ins_src is not None and len(ins_src) > 0:
        s, d = as_ids(ins_src, dev), as_ids(ins_dst, dev)
        new = torch.cat([edge_code(s, d), edge_code(d, s)])
        mine = shard_of_vertex(torch.cat([s, d]), spec.vps) == my_shard
        codes, overflow = _local_insert(codes, torch.where(mine, new, SENTINEL),
                                        spec.edge_capacity)
    return graph._with(codes), overflow


# -------------------------------------------------------------- local merge


def _local_consolidated_store(store: WalkStore,
                              pending: Optional[PendingBlocks]):
    """Pad-aware local Merge: base + the filled pending blocks -> the live
    partition, sorted, pad rows (owner=n, SENTINEL, PAD_EPOCH) at the tail.

    Liveness is the global `epoch == slot_epoch[slot]` check against the
    REPLICATED slot_epoch, so a base entry superseded by a version block on
    another shard dies here too: the union of the local live sets is the
    single-device merged store. The order is the reference's
    `lexsort((code, owner, ~live))`, which puts the live rows first in
    (owner, code) order; the port takes the non-pad rows of each part
    (the reference's dead rows land in the tail it overwrites with pads),
    unpairs their codes (kernel 2 on the card) and sorts only the live
    ones, in the reference's concatenation order."""
    t = store.size
    nwl = store.n_walks * store.length
    parts = [(store.owner, store.code, store.epoch)]
    if pending is not None:
        parts += [(pending.owner[i], pending.code[i], pending.epoch[i])
                  for i in range(pending.code.shape[0])]
    owner, code, epoch = [], [], []
    for o, c, e in parts:
        sel = torch.nonzero(e != PAD_EPOCH).reshape(-1)
        o, c, e = o[sel], c[sel], e[sel]
        f, _ = ops.szudzik_unpair(c)
        live = e == store.slot_epoch[f.clamp(0, nwl - 1)]
        owner.append(o[live])
        code.append(c[live])
        epoch.append(e[live])
    owner, code, epoch = torch.cat(owner), torch.cat(code), torch.cat(epoch)
    n_live = owner.shape[0]
    overflow = torch.tensor(n_live > t, device=store.device)
    order = lexsort((code, owner))[:t]
    k = order.shape[0]
    owner_out = torch.full((t,), store.n_vertices, dtype=I32,
                           device=store.device)
    code_out = torch.full((t,), PAD_CODE, dtype=I64, device=store.device)
    epoch_out = torch.full((t,), PAD_EPOCH, dtype=I32, device=store.device)
    owner_out[:k] = owner[order]
    code_out[:k] = code[order]
    epoch_out[:k] = epoch[order]
    return WalkStore.from_sorted(owner_out, code_out, epoch_out,
                                 store.slot_epoch, store.length,
                                 store.n_walks, store.n_vertices,
                                 chunk_b=store.chunk_b, prev=store), overflow


def _local_merge_state(state: EngineState) -> EngineState:
    store, overflow = _local_consolidated_store(
        state.store, state.pending.filled(state.n_pending))
    state.pending.clear_()
    return state.replace(store=store, n_pending=0,
                         overflow=state.overflow | overflow)


def consolidate(state: EngineState) -> EngineState:
    """Fold this shard's pending blocks into its base store (the local
    Merge); a no-op with nothing pending. Every rank calls it at the same
    point: `n_pending` is replicated."""
    return _local_merge_state(state) if state.n_pending else state


# ------------------------------------------------------------ sharded update


def _sharded_rewalk(key, graph: StreamingGraph, store: WalkStore, mav,
                    new_epoch: int, cfg: WalkConfig, capacity: int,
                    spec: ShardSpec, my_shard: int, group, out,
                    with_obs: bool = False):
    """The single-device rewalk loop with lane residency + handoff.

    The lane METADATA (affected walk ids, p_min, spawn vertex) is
    replicated, but each lane is live on exactly one shard at a time: it
    spawns on the owner of its p_min vertex, emits its triplet there (the
    owner is its current vertex, owned by construction) and is re-routed
    by `exchange_frontier` every step. The version block is written into
    `out` ([capacity, length] views of the pending row), lane-major as the
    reference's. Returns (slot_epoch, |affected|, handoff overflow, obs);
    `obs` (with `with_obs`) holds this shard's handoff counters and the
    p_min histogram, pure reads of `dest`."""
    dev = store.device
    length = store.length
    nwl = store.n_walks * length
    affected = mav.p_min < length
    walk_ids, lane_valid = compact_nonzero(affected, size=capacity)
    p_min = mav.p_min[walk_ids]
    v_at_pmin = mav.v_min[walk_ids]
    spawn_here = lane_valid & (shard_of_vertex(v_at_pmin, spec.vps) == my_shard)
    f_base = walk_ids * length
    keys = jr.split(key, length)
    cur = torch.zeros((capacity,), dtype=I64, device=dev)
    mine = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    handoff_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    slot_epoch = store.slot_epoch.clone()
    if with_obs:
        h_sent = torch.zeros((), dtype=I32, device=dev)
        h_cross = torch.zeros((), dtype=I32, device=dev)
        h_max = torch.zeros((), dtype=I32, device=dev)
    for p in range(length):
        spawn = p_min == p
        cur = torch.where(spawn, v_at_pmin, cur)
        mine = torch.where(spawn, spawn_here, mine)
        is_term = p == length - 1
        # full-lane draw: the owned lanes match the single-device stream;
        # the terminal triplet points to itself, its draw unused
        nxt = cur if is_term else sample_next_sharded(keys[p], graph, cur,
                                                      cfg.model)
        slot = (f_base + p).clamp(0, nwl - 1)
        out.code[:, p] = torch.where(mine, ops.szudzik_pair(f_base + p, nxt),
                                     BIAS)
        out.owner[:, p] = torch.where(mine, cur, 0).to(I32)
        out.epoch[:, p] = torch.where(mine, new_epoch, PAD_EPOCH).to(I32)
        out.slot[:, p] = torch.where(mine, slot, 0).to(I32)
        # replicated slot-version bump: it depends only on (walk_ids,
        # p_min, lane_valid), not on which shard emitted
        bump = lane_valid & (p >= p_min)
        slot_epoch.scatter_reduce_(0, slot,
                                   torch.where(bump, new_epoch, 0).to(I32),
                                   "amax")
        dest = torch.where(mine & (not is_term),
                           shard_of_vertex(nxt, spec.vps), spec.n_shards)
        if with_obs:
            load = torch.zeros((spec.n_shards + 1,), dtype=I64, device=dev)
            load = load.scatter_add_(0, dest, torch.ones_like(dest))[:-1]
            h_sent += load.sum().to(I32)
            h_cross += ((dest < spec.n_shards) & (dest != my_shard)).sum().to(I32)
            h_max = torch.maximum(h_max, load.max().to(I32))
        cur, mine, ovf = exchange_frontier(dest, nxt, spec.n_shards,
                                           spec.slab, group)
        handoff_ovf |= ovf
    obs = None
    if with_obs:
        from repro_torch.obs.metrics import pmin_bucket_counts
        obs = {"handoff_sent": h_sent, "handoff_cross": h_cross,
               "handoff_max_load": h_max,
               "pmin_hist": pmin_bucket_counts(p_min, lane_valid, length)}
    return slot_epoch, affected.sum(), handoff_ovf, obs


def _sharded_apply_update(state: EngineState, ins_src, ins_dst, del_src,
                          del_dst, key, cfg: WalkConfig, capacity: int,
                          spec: ShardSpec, my_shard: int, group,
                          with_obs: bool = False):
    """Shard-local Algorithm 2: the single-device update with the frontier
    gather factored into (local gather) + (min combine) and the rewalk
    replaced by the handoff loop; the version block goes into pending row
    `n_pending`, in place. Returns (state, obs): `obs` (with `with_obs`)
    adds this step's per-source overflow flags (graph, MAV gather,
    handoff slab) to the rewalk's counters; the engine's `overflow`
    stays their OR."""
    graph, g_ovf = _local_apply_batch(state.graph, ins_src, ins_dst, del_src,
                                      del_dst, spec, my_shard)
    store, pending = state.store, state.pending
    length, n_walks = store.length, store.n_walks
    new_epoch = state.epoch + 1

    # MAV: the local gather over owned segments (a touched vertex owned
    # elsewhere has an empty segment here) and the filled pending blocks ...
    touched_v = touched_vertices(store.n_vertices, store.device, ins_src,
                                 ins_dst, del_src, del_dst)
    g_owner, g_code, g_epoch, g_valid, total = gather_touched_segments(
        store, touched_v, spec.mav_capacity)
    mav_ovf = total > spec.mav_capacity
    g_f, _ = ops.szudzik_unpair(g_code)
    g_touched = touched_v[g_owner.to(I64)] & g_valid
    best = keyed_pmin(g_f // length, g_f % length, g_owner, g_epoch,
                      store.slot_epoch, g_touched, g_valid, length, n_walks)
    for i in range(state.n_pending):
        sel = torch.nonzero(pending.epoch[i] != PAD_EPOCH).reshape(-1)
        p_owner = pending.owner[i][sel]
        p_slot = pending.slot[i][sel].to(I64)
        p_valid = torch.ones_like(sel, dtype=torch.bool)
        best = torch.minimum(best, keyed_pmin(
            p_slot // length, p_slot % length, p_owner, pending.epoch[i][sel],
            store.slot_epoch, touched_v[p_owner.to(I64)], p_valid, length,
            n_walks))
    # ... then ONE min over the composite keys combines the shards
    mav = mav_from_keyed(collectives.all_reduce_min(best, group), length)

    j = state.n_pending        # in place, as the single-device engine
    out = PendingBlocks(*(t[j].view(capacity, length) for t in pending))
    slot_epoch, n_aff, h_ovf, obs = _sharded_rewalk(
        key, graph, store, mav, new_epoch, cfg, capacity, spec, my_shard,
        group, out, with_obs=with_obs)
    if with_obs:
        obs = dict(obs, graph_overflow=g_ovf, mav_overflow=mav_ovf,
                   handoff_overflow=h_ovf)
    n_aff = n_aff.to(I32)
    state = EngineState(
        graph=graph, store=store.replace(slot_epoch=slot_epoch),
        pending=pending, n_pending=j + 1, epoch=new_epoch,
        last_affected=n_aff, total_affected=state.total_affected + n_aff,
        overflow=state.overflow | g_ovf | mav_ovf | h_ovf)
    return state, obs


def sharded_stream_step(state: EngineState, key, ins_src, ins_dst, del_src,
                        del_dst, cfg: WalkConfig, capacity: int,
                        spec: ShardSpec, my_shard: int, max_pending: int,
                        merge_policy: str, group=None) -> EngineState:
    """The `stream_step` twin for this shard's state: the same merge
    cadence (n_pending is replicated) with the local consolidate as the
    merge."""
    if state.n_pending >= max_pending:
        state = _local_merge_state(state)
    state, _ = _sharded_apply_update(state, ins_src, ins_dst, del_src,
                                     del_dst, key, cfg, capacity, spec,
                                     my_shard, group)
    if merge_policy == "eager":
        state = _local_merge_state(state)
    return state


def sharded_stream_step_obs(state: EngineState, metrics, key, ins_src,
                            ins_dst, del_src, del_dst, cfg: WalkConfig,
                            capacity: int, spec: ShardSpec, my_shard: int,
                            max_pending: int, merge_policy: str, group=None):
    """`sharded_stream_step` + this shard's StreamMetrics fold -> (state,
    metrics). The engine's dataflow is the same; the store-merge overflow
    is read from the sticky flag's change around each merge."""
    from repro_torch.obs.metrics import record_sharded_step
    forced = state.n_pending >= max_pending
    ovf0 = state.overflow
    if forced:
        state = _local_merge_state(state)
    merge_tripped = state.overflow & ~ovf0
    state, obs = _sharded_apply_update(state, ins_src, ins_dst, del_src,
                                       del_dst, key, cfg, capacity, spec,
                                       my_shard, group, with_obs=True)
    if merge_policy == "eager":
        ovf1 = state.overflow
        state = _local_merge_state(state)
        merge_tripped = merge_tripped | (state.overflow & ~ovf1)
    metrics = record_sharded_step(metrics, state, obs, forced, merge_tripped,
                                  eager=merge_policy == "eager")
    return state, metrics


# --------------------------------------------------------- the stream loop


def sharded_run_stream(state: EngineState, key, ins_src, ins_dst,
                       del_src=None, del_dst=None, *, cfg: WalkConfig,
                       spec: ShardSpec, capacity: int, max_pending: int = 8,
                       merge_policy: str = "on-demand", group=None,
                       metrics=None):
    """A whole [n_batches, batch] mixed stream on this rank's shard.

    The partitioned twin of `WalkEngine.run_stream`: the same per-batch key
    split and merge cadence, and the same output triplets, graph and
    corpus, bit for bit, once unsharded. Every rank of `group` (default:
    the world, one rank a shard, rank = shard index) calls it with the
    same arguments and its own `state` (from `shard_state`), whose pending
    tensors it updates in place. The pending blocks are consolidated at
    stream end. Returns (state, affected int32 [n_batches]).

    With `cfg.metrics` the return gains this shard's StreamMetrics (pass
    `metrics` to continue a prior stream's counters); reduce the ranks'
    with `obs.metrics.combine_shards` / `obs.export.summary`."""
    if cfg.model.order != 1:
        raise NotImplementedError(
            "sharded run_stream is order-1 (DeepWalk) only: order-2 "
            "SAMPLENEXT needs remote neighbor windows")
    group = shard_group(spec.n_shards, group)
    my_shard = collectives.group_rank(group)
    dev = state.store.device
    ins_src, ins_dst = as_ids(ins_src, dev), as_ids(ins_dst, dev)
    n_batches = ins_src.shape[0]
    if del_src is None:
        del_src = del_dst = torch.zeros((n_batches, 0), dtype=I64, device=dev)
    else:
        del_src, del_dst = as_ids(del_src, dev), as_ids(del_dst, dev)
    keys = jr.split(jr.as_key(key, dev), n_batches)
    if cfg.metrics and metrics is None:
        from repro_torch.obs.metrics import StreamMetrics
        metrics = StreamMetrics.empty(dev)
    affected = []
    for i in range(n_batches):
        step = (keys[i], ins_src[i], ins_dst[i], del_src[i], del_dst[i], cfg,
                capacity, spec, my_shard, max_pending, merge_policy, group)
        if cfg.metrics:
            state, metrics = sharded_stream_step_obs(state, metrics, *step)
        else:
            state = sharded_stream_step(state, *step)
        affected.append(state.last_affected)
    affected = (torch.stack(affected) if affected
                else torch.zeros((0,), dtype=I32, device=dev))
    if cfg.metrics:
        # the end-of-stream merge can trip the store capacity too
        from repro_torch.obs.metrics import OVF_STORE, record_overflow
        ovf0 = state.overflow
        state = consolidate(state)
        metrics = record_overflow(metrics, OVF_STORE, state.overflow & ~ovf0,
                                  state.epoch)
        return state, affected, metrics
    return consolidate(state), affected


# ------------------------------------------------- host-side (un)partition


def local_shard_state(graph: StreamingGraph, store: WalkStore,
                      spec: ShardSpec, shard: int, capacity: int,
                      max_pending: int = 8,
                      pending: Optional[PendingBlocks] = None) -> EngineState:
    """Shard `shard`'s part of a merged single-device engine state (on the
    store's device), its pending blocks `pending` (cleared in place) or new
    ones. Raises if its owned rows exceed a capacity."""
    src = hi32(graph.codes)      # SENTINEL's source 2^32-1 is no shard's
    gmask = (graph.codes != SENTINEL) & (shard_of_vertex(src, spec.vps)
                                         == shard)
    n_g = int(gmask.sum())
    if n_g > spec.edge_capacity:
        raise ValueError(f"shard {shard}: {n_g} edges > per-shard capacity "
                         f"{spec.edge_capacity}")
    idx, valid = compact_nonzero(gmask, spec.edge_capacity)
    g_k = graph._with(torch.where(valid, graph.codes[idx], SENTINEL))

    smask = shard_of_vertex(u32_value(store.owner), spec.vps) == shard
    n_s = int(smask.sum())
    if n_s > spec.store_capacity:
        raise ValueError(f"shard {shard}: {n_s} triplets > per-shard "
                         f"capacity {spec.store_capacity}")
    idx, valid = compact_nonzero(smask, spec.store_capacity)
    # compact_nonzero keeps the (owner, code) order; pads normalized
    s_k = WalkStore.from_sorted(
        torch.where(valid, store.owner[idx], store.n_vertices).to(I32),
        torch.where(valid, store.code[idx], PAD_CODE),
        torch.where(valid, store.epoch[idx], PAD_EPOCH).to(I32),
        store.slot_epoch, store.length, store.n_walks, store.n_vertices,
        chunk_b=store.chunk_b)
    epoch = int(u32_value(store.slot_epoch).max())
    if pending is not None:
        pending.clear_()
    return EngineState.create(g_k, s_k, max_pending, capacity * store.length,
                              pending=pending, epoch=epoch)


def shard_state(graph: StreamingGraph, store: WalkStore, spec: ShardSpec,
                capacity: int, max_pending: int = 8) -> List[EngineState]:
    """Partition a merged single-device engine state (exactly T live
    triplets, nothing pending) into the S shard states, shard k at index
    k. A rank takes its own; `local_shard_state` builds one alone."""
    return [local_shard_state(graph, store, spec, k, capacity, max_pending)
            for k in range(spec.n_shards)]


def unshard_state(states: List[EngineState], edge_capacity: int):
    """The S shard states (shard k at index k, on one device) -> the
    global (graph, store, overflow): the union of the local live sets,
    re-sorted into the single-device layout (the lexsort `WalkStore.build`
    runs), so a bit-for-bit comparison with the single-device engine is
    meaningful. Raises if the live triplet count is not T, the symptom of
    a capacity overflow (also in the sticky `overflow` flag)."""
    first = states[0]
    dev = first.store.device
    n_vertices = first.graph.n_vertices
    codes = torch.cat([s.graph.codes for s in states])
    live_codes = torch.sort(codes[codes != SENTINEL]).values
    if live_codes.numel() > edge_capacity:
        raise ValueError(f"{live_codes.numel()} live edges > edge capacity "
                         f"{edge_capacity}")
    full = torch.full((edge_capacity,), SENTINEL, dtype=I64, device=dev)
    full[:live_codes.numel()] = live_codes
    graph = StreamingGraph.empty(n_vertices, 0, dev)._with(full)

    owner = torch.cat([s.store.owner for s in states])
    code = torch.cat([s.store.code for s in states])
    epoch = torch.cat([s.store.epoch for s in states])
    live = epoch != PAD_EPOCH
    t = first.store.n_walks * first.store.length
    if int(live.sum()) != t:
        raise RuntimeError(f"{int(live.sum())} live triplets != T={t}: "
                           f"per-shard store/pending capacity overflow?")
    store = WalkStore.build(owner[live], code[live], epoch[live],
                            first.store.slot_epoch, first.store.length,
                            first.store.n_walks, n_vertices,
                            chunk_b=first.store.chunk_b)
    return graph, store, any(bool(s.overflow) for s in states)
