"""Walk-corpus generation (paper §3.2) and conversion into the WalkStore;
port of `repro/core/corpus.py`.

n_w walks per vertex, each of length l; walk w starts at vertex w // n_w.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core.graph import StreamingGraph
from repro_torch.core.store import WalkStore
from repro_torch.core.walkers import DEEPWALK, WalkModel, check_model, sample_next
from repro_torch.kernels import ops


class WalkConfig(NamedTuple):
    n_walks_per_vertex: int = 10
    length: int = 80
    model: WalkModel = DEEPWALK
    chunk_b: int = 128
    # the fused rewalk step: "auto" consults the kernels/megakernel registry
    # (default off), or "off", or a megakernel backend ("cuda", "torch",
    # "ref"; the reference's "pallas" is "cuda" here)
    megakernel: str = "auto"
    # update repro_torch.obs.metrics.StreamMetrics in the stream loops;
    # OFF (the default) runs none of that code, ON only reads the engine
    metrics: bool = False
    # walks replayed a step by the freshness divergence auditor
    # (obs/staleness.py) when metrics are on; 0 skips the auditor
    audit_k: int = 4


def check_config(cfg: WalkConfig) -> None:
    """Raise on an unknown option."""
    from repro_torch.kernels import megakernel
    check_model(cfg.model)
    if cfg.megakernel not in ("off", "auto") + megakernel.BACKENDS:
        raise ValueError(f"unknown megakernel backend {cfg.megakernel!r}; "
                         f"expected one of "
                         f"{megakernel.BACKENDS + ('off', 'auto')}")


def walk_start_vertex(w, n_w: int):
    return w // n_w


def compact_lanes_by_shard(dest, n_shards: int, slab: int):
    """Bucket rewalk lanes by destination shard into fixed-size slabs.

    dest: int [capacity] destination shard of each lane; `n_shards` marks
    an inactive lane. Returns (send_lane int64 [n_shards, slab], overflow
    bool []): row d lists the lanes routed to shard d in ascending lane
    order, padded with the sentinel `capacity`; `overflow` flags a
    destination given more than `slab` lanes (the lanes past `slab` are
    dropped: a sticky correctness flag, as the MAV gather's). A stable
    sort by destination, so the op count does not depend on `n_shards`."""
    capacity = dest.shape[0]
    dev = dest.device
    dest = dest.to(torch.int64)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    start = torch.searchsorted(
        sdest, torch.arange(n_shards + 1, dtype=torch.int64, device=dev),
        side="left")
    overflow = ((start[1:] - start[:-1]) > slab).any()
    rank = (torch.arange(capacity, device=dev)
            - start[sdest.clamp(0, n_shards)])
    ok = (sdest < n_shards) & (rank < slab)
    # slot n_shards * slab is the scratch row of the dropped lanes
    slot = torch.where(ok, sdest * slab + rank, n_shards * slab)
    send_lane = torch.full((n_shards * slab + 1,), capacity,
                           dtype=torch.int64, device=dev)
    send_lane[slot] = order
    return send_lane[:-1].reshape(n_shards, slab), overflow


def generate_walk_matrix(key, graph: StreamingGraph, cfg: WalkConfig):
    """Dense int64 [n_walks, l] walk matrix sampled from scratch."""
    check_config(cfg)
    dev = graph.device
    n_walks = graph.n_vertices * cfg.n_walks_per_vertex
    start = walk_start_vertex(torch.arange(n_walks, device=dev),
                              cfg.n_walks_per_vertex)
    walks = torch.empty((n_walks, cfg.length), dtype=torch.int64, device=dev)
    walks[:, 0] = start
    keys = jr.split(jr.as_key(key, dev), cfg.length - 1)
    cur = prev = start
    for i in range(cfg.length - 1):
        nxt = sample_next(keys[i], graph, cur, prev, cfg.model)
        walks[:, i + 1] = nxt
        cur, prev = nxt, cur
    return walks


def matrix_to_triplets(walks, length: int):
    """Walk matrix -> (owner int32, code int64) triplets (paper §4.2): the
    triplet at (w, p) points to walks[w, p+1], the terminal one to itself.
    f(w, p) = w*l + p is the flat index, and the Szudzik pair runs on the
    pair kernel on the card."""
    owner = walks.reshape(-1).to(torch.int32)
    nxt = torch.cat([walks[:, 1:], walks[:, -1:]], dim=1).reshape(-1)
    f = torch.arange(nxt.shape[0], dtype=torch.int64, device=walks.device)
    return owner, ops.szudzik_pair(f, nxt)


def corpus_to_store(walks, cfg: WalkConfig, n_vertices: int) -> WalkStore:
    n_walks, length = walks.shape
    owner, code = matrix_to_triplets(walks, length)
    epoch = torch.zeros_like(owner)
    slot_epoch = torch.zeros((n_walks * length,), dtype=torch.int32,
                             device=walks.device)
    return WalkStore.build(owner, code, epoch, slot_epoch, length, n_walks,
                           n_vertices, chunk_b=cfg.chunk_b)


def generate_corpus(key, graph: StreamingGraph, cfg: WalkConfig) -> WalkStore:
    """From-scratch corpus generation + store build."""
    walks = generate_walk_matrix(key, graph, cfg)
    return corpus_to_store(walks, cfg, graph.n_vertices)
