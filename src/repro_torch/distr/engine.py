"""The reference's GSPMD-partitioned engine, as what it computes on one
device's state (port of `repro/distr/engine.py`).

The reference runs the single-device `stream_step` on dict-of-array state
under NamedSharding annotations and lets the compiler insert the
collectives. PyTorch has no compiler partitioner, so here
`distributed_update_step` and `distributed_run_stream` compute the same
function on one device's dicts, and `wharf_placements` /
`stream_placements` keep the reference's sharding table as data: which
field is `Shard(0)` and which `Replicate()` on a ("data", "model") mesh,
as `torch.distributed.tensor` placements. Nothing applies the table. The
port's distributed path is the explicit engine, `distr/sharded.py`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch._u64 import u32_value
from repro_torch.core.graph import StreamingGraph
from repro_torch.core.store import WalkStore
from repro_torch.core.update import (EngineState, consolidate, run_stream,
                                     stream_step_aux)

STORE_KEYS = ("owner", "code", "epoch", "offsets", "vmin", "vmax", "packed",
              "widths", "anchors_hi", "anchors_lo", "last_hi", "last_lo",
              "slot_epoch")


def graph_to_dict(g: StreamingGraph) -> Dict[str, Any]:
    return {"codes": g.codes, "offsets": g.offsets, "num_edges": g.num_edges}


def dict_to_graph(d: Dict[str, Any], n_vertices: int) -> StreamingGraph:
    return StreamingGraph(d["codes"], d["offsets"], d["num_edges"], n_vertices)


def store_to_dict(s: WalkStore) -> Dict[str, Any]:
    return {k: getattr(s, k) for k in STORE_KEYS}


def dict_to_store(d: Dict[str, Any], cfg) -> WalkStore:
    return WalkStore(**{k: d[k] for k in STORE_KEYS}, length=cfg.length,
                     n_walks=cfg.n_vertices * cfg.n_walks_per_vertex,
                     n_vertices=cfg.n_vertices, chunk_b=cfg.chunk_b)


def wharf_placements() -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(graph, store) placements on a ("data", "model") mesh, one per mesh
    dim, as the reference's `wharf_shardings`: the triplet and edge arrays
    (and the packed chunks, whose chunk axis follows them) shard dim 0
    over both dims, which in vertex-major order is a vertex-range
    partition; vmin/vmax shard over "model" (the vertex axis); the CSR
    offsets and the edge count are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    flat = (Shard(0), Shard(0))
    vtx = (Replicate(), Shard(0))
    rep = (Replicate(), Replicate())
    g = {"codes": flat, "offsets": rep, "num_edges": rep}
    s = {k: flat for k in STORE_KEYS}
    s.update(offsets=rep, vmin=vtx, vmax=vtx)
    return g, s


def stream_placements() -> Dict[str, tuple]:
    """The stream inputs (keys, insertion and deletion batches) are small
    and read whole each step: replicated."""
    from torch.distributed.tensor import Replicate
    rep = (Replicate(), Replicate())
    return {k: rep for k in ("keys", "ins_src", "ins_dst", "del_src",
                             "del_dst")}


def _init_state(graph_d, store_d, cfg, max_pending: int,
                epoch0: int) -> EngineState:
    return EngineState.create(dict_to_graph(graph_d, cfg.n_vertices),
                              dict_to_store(store_d, cfg), max_pending,
                              cfg.rewalk_capacity * cfg.length, epoch=epoch0)


def distributed_update_step(graph_d, store_d, ins_src, ins_dst, new_epoch,
                            key, cfg, merge_impl: str = "interleave",
                            do_merge: bool = True, del_src=None,
                            del_dst=None) -> Dict[str, Any]:
    """One edge batch (insertions + optional deletions) -> the updated
    store dict (Algorithm 2), with a one-row pending accumulator:
    do_merge=True is the eager policy (append + merge), do_merge=False the
    on-demand policy's merge-free batch (the block stays pending; only the
    slot-epoch bumps reach the returned store). `cfg` is a
    `WharfStreamConfig`."""
    state = _init_state(graph_d, store_d, cfg, 1, int(new_epoch) - 1)
    dev = state.store.device
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    state, _ = stream_step_aux(
        state, jr.as_key(key, dev), ins_src, ins_dst,
        empty if del_src is None else del_src,
        empty if del_dst is None else del_dst, cfg.walk_config(),
        cfg.rewalk_capacity, state.store.size, 1,
        "eager" if do_merge else "on-demand", merge_impl)
    return store_to_dict(state.store)


def distributed_run_stream(graph_d, store_d, keys, ins_src, ins_dst, cfg,
                           merge_impl: str = "interleave",
                           merge_policy: str = "on-demand",
                           max_pending: int = 8, del_src=None, del_dst=None):
    """A whole [n_batches, batch] mixed stream (`keys` [n_batches, 2]) ->
    (graph dict, store dict, affected int32 [n_batches]), the pending
    blocks consolidated at stream end. Epochs resume above the store's
    highest slot-epoch stamp, so a store returned by one call can feed the
    next without reusing a live epoch."""
    epoch0 = int(u32_value(store_d["slot_epoch"]).max())
    state = _init_state(graph_d, store_d, cfg, max_pending, epoch0)
    state, affected = run_stream(
        state, keys, ins_src, ins_dst, del_src, del_dst,
        cfg=cfg.walk_config(), capacity=cfg.rewalk_capacity,
        mav_capacity=state.store.size, max_pending=max_pending,
        merge_policy=merge_policy, merge_impl=merge_impl)
    state = consolidate(state, merge_impl)
    return graph_to_dict(state.graph), store_to_dict(state.store), affected
