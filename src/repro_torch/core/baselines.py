"""Baselines from paper §7.1: Inverted-Index-based and Tree-based walk
stores; port of `repro/core/baselines.py`, bit for bit.

II-based: walks stored as dense sequences (a dense [n_walks, l] matrix) +
an inverted index vertex -> walk ids. To build the MAV it must traverse
each affected walk *from position 0* to locate p_min (the paper's
Θ(Σ p_min) term), and every update rewrites both the sequences and the
index.

Tree-based: raw (uncompressed) triplets in balanced parallel trees — here
the same lexsorted layout as Wharf but with full-width columns and no
pairing, no chunk heads and no delta compression (~3-4.4x the footprint,
paper Fig. 8).

Both reuse the same samplers as Wharf, so corpora are distribution-
identical, and both replay the stacked [n_batches, batch] streams of
`repro_torch.data.streams` through `run_stream` with the same per-batch
key split as `WalkEngine.run_stream`. Columns are held at the reference's
widths, so `nbytes()` equals its: u32 columns as int32 bits (vertex and
walk ids stay below 2^31), the index's u64 (vertex << 32 | walk) codes as
biased int64 (`repro_torch._u64`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import random as jr
from repro_torch._u64 import INT64_MAX, bias, hi32
from repro_torch.core.corpus import WalkConfig, generate_walk_matrix
from repro_torch.core.graph import StreamingGraph, as_ids
from repro_torch.core.utils import compact_nonzero, lexsort
from repro_torch.core.walkers import sample_next

I32 = torch.int32
I64 = torch.int64


class StackedStreamMixin:
    """Consume the stacked [n_batches, batch] streams of data/streams.py.

    Splits `key` exactly as `WalkEngine.run_stream` does (one key per batch
    via `random.split`), so a benchmark can hand the same stream and key to
    Wharf and to a baseline. Baselines replay the stream batch by batch on
    the host. Returns per-batch affected counts, int32 [n_batches]."""

    def run_stream(self, key, ins_src, ins_dst, del_src=None, del_dst=None):
        n_batches = len(ins_src)
        keys = jr.split(jr.as_key(key, self.graph.device), n_batches)
        affected = []
        for i in range(n_batches):
            ds = None if del_src is None else del_src[i]
            dd = None if del_dst is None else del_dst[i]
            affected.append(self.update_batch(keys[i], ins_src[i],
                                              ins_dst[i], ds, dd))
        return torch.tensor(affected, dtype=I32, device=self.graph.device)

    def _apply(self, ins_src, ins_dst, del_src, del_dst):
        """Apply the graph delta -> the four id arrays, int64 on the graph's
        device (None -> empty)."""
        dev = self.graph.device
        arrs = [torch.zeros((0,), dtype=I64, device=dev) if a is None
                else as_ids(a, dev) for a in (ins_src, ins_dst, del_src, del_dst)]
        self.graph = self.graph.apply_batch(*arrs)
        return arrs


def _touched(n_vertices: int, arrs, device) -> torch.Tensor:
    touched = torch.zeros((n_vertices,), dtype=torch.bool, device=device)
    for a in arrs:
        touched[a] = True
    return touched


# --------------------------------------------------------------------------- II


@dataclass(frozen=True)
class InvertedIndex:
    """vertex -> walk-ids index as a sorted (vertex, walk) pair list."""

    vw: torch.Tensor       # biased int64 [T] (vertex << 32 | walk), sorted
    offsets: torch.Tensor  # int32 [n + 1]

    @staticmethod
    def build(walks: torch.Tensor, n_vertices: int) -> "InvertedIndex":
        n_walks, length = walks.shape
        v = walks.reshape(-1).to(I64)
        w = torch.arange(n_walks, dtype=I64,
                         device=walks.device).repeat_interleave(length)
        vw = torch.sort(bias((v << 32) | w)).values
        offsets = torch.searchsorted(
            hi32(vw), torch.arange(n_vertices + 1, dtype=I64,
                                   device=walks.device), side="left")
        return InvertedIndex(vw, offsets.to(I32))


@dataclass
class IIEngine(StackedStreamMixin):
    graph: StreamingGraph
    walks: torch.Tensor        # int32 [n_walks, l] dense sequences
    index: InvertedIndex
    cfg: WalkConfig
    rewalk_capacity: int = 1024
    last_n_affected: int = 0

    @staticmethod
    def create(key, graph: StreamingGraph, cfg: WalkConfig) -> "IIEngine":
        walks = generate_walk_matrix(key, graph, cfg).to(I32)
        return IIEngine(graph, walks,
                        InvertedIndex.build(walks, graph.n_vertices), cfg)

    def update_batch(self, key, ins_src, ins_dst, del_src=None, del_dst=None):
        arrs = self._apply(ins_src, ins_dst, del_src, del_dst)
        self.walks, n_aff = _ii_update(
            jr.as_key(key, self.graph.device), self.graph, self.walks, arrs,
            self.cfg, self.rewalk_capacity)
        # the II must be rebuilt to reflect rewritten suffixes (paper: "has
        # to update the walk sequences and the walk index")
        self.index = InvertedIndex.build(self.walks, self.graph.n_vertices)
        self.last_n_affected = n_aff
        return n_aff

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.walks, self.index.vw, self.index.offsets))


def _ii_update(key, graph, walks, arrs, cfg: WalkConfig, capacity: int):
    """The reference's `_ii_update`: p_min by scanning each walk from the
    front, then every lane steps through all l positions and writes from
    p_min + 1 on. Column p receives the vertex sampled AT step p (the
    successor of the walk's vertex p), as the reference writes it."""
    n_walks, length = walks.shape
    dev = walks.device
    touched = _touched(graph.n_vertices, arrs, dev)
    hit = touched[walks]                                   # [n_walks, l]
    cols = torch.arange(length, dtype=I32, device=dev)
    p_min = torch.where(hit, cols, length).amin(dim=1)
    affected = p_min < length
    ids, lane_valid = compact_nonzero(affected, capacity)
    pm = p_min[ids]
    rows = walks[ids]                                      # [capacity, l]
    cur = rows.gather(1, pm.clamp(max=length - 1).to(I64)[:, None])[:, 0].to(I64)
    prev = rows.gather(1, (pm - 1).clamp(min=0).to(I64)[:, None])[:, 0].to(I64)
    new = torch.empty_like(rows)
    write = torch.empty(rows.shape, dtype=torch.bool, device=dev)
    keys = jr.split(key, length)
    for p in range(length):
        cur = torch.where(pm == p, rows[:, p].to(I64), cur)
        nxt = sample_next(keys[p], graph, cur, prev, cfg.model)
        write[:, p] = (p > pm) & lane_valid
        new[:, p] = nxt.to(I32)
        on = p >= pm
        prev = torch.where(on, cur, prev)
        cur = torch.where(on, nxt, cur)
    keep = ids[lane_valid]
    walks = walks.clone()
    walks[keep] = torch.where(write, new, rows)[lane_valid]
    return walks, int(affected.sum())


# ------------------------------------------------------------------------ Tree


@dataclass
class TreeEngine(StackedStreamMixin):
    """Tree-based baseline: uncompressed triplet columns, lexsorted.

    Mirrors Wharf's update path but stores (owner, walk, pos, next) as four
    full-width columns (no pairing, no chunks, no delta coding) and re-walks
    obsolete parts to remove them (the paper notes this costs it
    throughput)."""

    graph: StreamingGraph
    owner: torch.Tensor  # int32 [T]
    walk: torch.Tensor   # int32 [T]
    pos: torch.Tensor    # int32 [T]
    nxt: torch.Tensor    # int32 [T]
    cfg: WalkConfig
    rewalk_capacity: int = 1024

    @staticmethod
    def create(key, graph: StreamingGraph, cfg: WalkConfig) -> "TreeEngine":
        walks = generate_walk_matrix(key, graph, cfg).to(I32)
        n_walks, length = walks.shape
        dev = walks.device
        owner = walks.reshape(-1)
        w = torch.arange(n_walks, dtype=I32, device=dev).repeat_interleave(length)
        p = torch.arange(length, dtype=I32, device=dev).repeat(n_walks)
        nx = torch.cat([walks[:, 1:], walks[:, -1:]], dim=1).reshape(-1)
        del walks
        order = lexsort([p, w, owner])
        return TreeEngine(graph, owner[order], w[order], p[order], nx[order],
                          cfg)

    def update_batch(self, key, ins_src, ins_dst, del_src=None, del_dst=None):
        arrs = self._apply(ins_src, ins_dst, del_src, del_dst)
        (self.owner, self.walk, self.pos, self.nxt), n_aff = _tree_update(
            jr.as_key(key, self.graph.device), self.graph, self.owner,
            self.walk, self.pos, self.nxt, arrs, self.cfg,
            self.rewalk_capacity)
        return n_aff

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.owner, self.walk, self.pos, self.nxt))


def _tree_update(key, graph, owner, walk, pos, nxt, arrs, cfg: WalkConfig,
                 capacity: int):
    """The reference's `_tree_update`. Its first resampled step takes prev
    = cur (`prev0 = vm`), which order 2 reads; the port keeps it."""
    length = cfg.length
    n_walks = walk.shape[0] // length
    dev = owner.device
    touched = _touched(graph.n_vertices, arrs, dev)
    hit = touched[owner]
    big = 1 << 32
    keyed = torch.where(hit, pos.to(I64) * big + owner.to(I64), length * big)
    # segment_min; a walk with a hit has best < length * 2^32 (the
    # reference's segment_max of the hits)
    best = torch.full((n_walks,), INT64_MAX, dtype=I64, device=dev)
    best.scatter_reduce_(0, walk.to(I64), keyed, "amin")
    del keyed
    anyh = best < length * big
    p_min = torch.where(anyh, best // big, length).to(I32)
    v_min = torch.where(anyh, best % big, 0)
    affected = p_min < length
    ids, lane_valid = compact_nonzero(affected, capacity)
    pm = p_min[ids]
    vm = v_min[ids]
    cur, prev = vm, vm
    keys = jr.split(key, length)
    owners_new = torch.empty((capacity, length), dtype=I32, device=dev)
    nxts_new = torch.empty_like(owners_new)
    emits = torch.empty((capacity, length), dtype=torch.bool, device=dev)
    for p in range(length):
        cur = torch.where(pm == p, vm, cur)
        s = sample_next(keys[p], graph, cur, prev, cfg.model)
        is_term = p == length - 1
        owners_new[:, p] = cur.to(I32)
        nxts_new[:, p] = (cur if is_term else s).to(I32)
        on = p >= pm
        emits[:, p] = lane_valid & on
        prev = torch.where(on, cur, prev)
        if not is_term:
            cur = torch.where(on, s, cur)

    # the tree baseline rewrites in place via a sort-merge keyed by
    # (walk, pos): obsolete rows (same (walk, pos), older) evicted by
    # keep-newest
    w_new = ids.to(I32).repeat_interleave(length)
    p_new = torch.arange(length, dtype=I32, device=dev).repeat(capacity)
    slot_old = walk.to(I64) * length + pos.to(I64)
    slot_new = torch.where(emits.reshape(-1),
                           w_new.to(I64) * length + p_new.to(I64), -1)
    slots = torch.cat([slot_old, slot_new])
    del slot_old, slot_new
    stamps = torch.cat([torch.zeros_like(walk), torch.ones_like(w_new)])
    # keep-newest per slot: sort by (slot, -stamp); first occurrence wins
    order = lexsort([-stamps, slots])
    del stamps
    slots_s = slots[order]
    del slots
    first = torch.ones_like(slots_s, dtype=torch.bool)
    first[1:] = slots_s[1:] != slots_s[:-1]
    keep = first & (slots_s >= 0)
    del slots_s, first
    sel, _ = compact_nonzero(keep, owner.shape[0])
    pick = order[sel]
    del order, sel, keep
    cols = [torch.cat([old, new.reshape(-1)])[pick] for old, new in
            ((owner, owners_new), (walk, w_new), (pos, p_new), (nxt, nxts_new))]
    order2 = lexsort([cols[2], cols[1], cols[0]])
    return tuple(c[order2] for c in cols), int(affected.sum())
