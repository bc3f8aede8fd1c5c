"""Streaming graph substrate (paper §3.1): port of `repro/core/graph.py`.

The edge set is one sorted int64 tensor of biased directed edge codes
(src << 32 | dst), capacity-padded with SENTINEL (u64 2^64-1, INT64_MAX
here). CSR offsets come from searchsorted over the sources. Batch updates
are sort-merge passes, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device
from repro_torch._u64 import INT64_MAX, bias, hi32, lo32

SENTINEL = INT64_MAX


def as_ids(x, device) -> torch.Tensor:
    """Vertex ids from torch, numpy or JAX arrays -> int64 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def edge_code(src, dst):
    return bias((src.to(torch.int64) << 32) | dst.to(torch.int64))


def edge_endpoints(code):
    """Biased edge codes -> (src, dst) as int64 values in [0, 2^32)."""
    return hi32(code), lo32(code)


@dataclass(frozen=True)
class StreamingGraph:
    """Directed edge set with static capacity.

    codes:      int64 [E_cap] sorted biased edge codes, SENTINEL-padded tail
    offsets:    int32 [N+1]   CSR offsets over the live prefix
    num_edges:  int32 []      live (directed) edge count
    n_vertices: int           vertex-id capacity
    """

    codes: torch.Tensor
    offsets: torch.Tensor
    num_edges: torch.Tensor
    n_vertices: int

    def replace(self, **kw) -> "StreamingGraph":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty(n_vertices: int, edge_capacity: int,
              device=None) -> "StreamingGraph":
        dev = resolve_device(device)
        return StreamingGraph(
            torch.full((edge_capacity,), SENTINEL, dtype=torch.int64, device=dev),
            torch.zeros((n_vertices + 1,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), n_vertices)

    @staticmethod
    def from_edges(src, dst, n_vertices: int, edge_capacity: int,
                   undirected: bool = True, device=None) -> "StreamingGraph":
        g = StreamingGraph.empty(n_vertices, edge_capacity, device)
        return g.insert_edges(src, dst, undirected=undirected)

    # -- views ---------------------------------------------------------------

    @property
    def neighbors(self):
        """int64 [E_cap] destination of each edge slot (sorted by src)."""
        return lo32(self.codes)

    def degrees(self):
        return self.offsets[1:] - self.offsets[:-1]

    def _rebuild_offsets(self, codes, num_edges):
        srcs = hi32(codes)   # the padded tail has src 2^32-1 >= n_vertices
        bounds = torch.arange(self.n_vertices + 1, dtype=torch.int64,
                              device=codes.device)
        offsets = torch.searchsorted(srcs, bounds, side="left")
        return torch.minimum(offsets, num_edges.to(torch.int64)).to(torch.int32)

    def _with(self, codes) -> "StreamingGraph":
        num = (codes != SENTINEL).sum().to(torch.int32)
        return StreamingGraph(codes, self._rebuild_offsets(codes, num), num,
                              self.n_vertices)

    # -- streaming updates (paper §3.1) --------------------------------------

    def insert_edges(self, src, dst, undirected: bool = True) -> "StreamingGraph":
        """Bulk edge insertion (dedup'd merge)."""
        if src is None or len(src) == 0:
            return self
        src, dst = as_ids(src, self.device), as_ids(dst, self.device)
        new = edge_code(src, dst)
        if undirected:
            new = torch.cat([new, edge_code(dst, src)])
        merged = torch.sort(torch.cat([self.codes, new])).values
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=self.device),
                         merged[1:] == merged[:-1]])
        merged = torch.where(dup, SENTINEL, merged)
        merged = torch.sort(merged).values[: self.codes.shape[0]]
        return self._with(merged)

    def delete_edges(self, src, dst, undirected: bool = True) -> "StreamingGraph":
        """Bulk edge deletion (match -> sentinel -> re-sort)."""
        if src is None or len(src) == 0:
            return self
        src, dst = as_ids(src, self.device), as_ids(dst, self.device)
        gone = edge_code(src, dst)
        if undirected:
            gone = torch.cat([gone, edge_code(dst, src)])
        gone = torch.sort(gone).values
        pos = torch.searchsorted(gone, self.codes).clamp(0, gone.shape[0] - 1)
        hit = gone[pos] == self.codes
        codes = torch.sort(torch.where(hit, SENTINEL, self.codes)).values
        return self._with(codes)

    def apply_batch(self, ins_src, ins_dst, del_src, del_dst,
                    undirected: bool = True) -> "StreamingGraph":
        """One graph update delta-G (deletions then insertions)."""
        g = self.delete_edges(del_src, del_dst, undirected=undirected)
        return g.insert_edges(ins_src, ins_dst, undirected=undirected)

    # -- queries --------------------------------------------------------------

    def has_edge(self, src, dst):
        q = edge_code(as_ids(src, self.device), as_ids(dst, self.device))
        pos = torch.searchsorted(self.codes, q).clamp(0, self.codes.shape[0] - 1)
        return self.codes[pos] == q

    def sample_neighbor(self, key, v):
        """Uniform neighbor of v (DeepWalk transition); v itself if
        isolated. Draws `randint(key, v.shape, 0, max(deg, 1))` exactly as
        the reference (graph.py:147); keys [K, 2] give [K, *v.shape], one
        draw of the whole batch per key."""
        start = self.offsets[v]
        deg = self.offsets[v + 1] - start
        r = jr.randint(key, v.shape, 0, torch.clamp(deg, min=1))
        idx = (start + r).clamp(max=self.codes.shape[0] - 1)
        return torch.where(deg > 0, lo32(self.codes[idx]), v)

    def sample_neighbor_per_key(self, keys, v):
        """One uniform neighbor per key: keys [..., 2], v broadcast to the
        key batch -> int64 [...], the draws of `jax.vmap` of the reference's
        `sample_neighbor(k, v)` over scalar lanes."""
        v = torch.broadcast_to(v, keys.shape[:-1])
        start = self.offsets[v]
        deg = self.offsets[v + 1] - start
        r = jr.randint(keys, (), 0, torch.clamp(deg, min=1))
        idx = (start + r).clamp(max=self.codes.shape[0] - 1)
        return torch.where(deg > 0, lo32(self.codes[idx]), v)
