"""Neighbor samplers for GraphSAGE minibatching; port of
`repro/models/sampling.py`.

Uniform fanout sampling over the StreamingGraph CSR, the same gather the
walk engine's transition uses (DESIGN.md §6): two fixed hops with masks
for vertices of degree 0. And a sampler that reads neighborhoods from the
maintained walk corpus through FINDNEXT (`walk_based_neighborhood`).

The draws are the reference's bit for bit: `randint` in int64 (as under
x64) with a per-row maxval of max(degree, 1).
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch._u64 import lo32
from repro_torch.core.graph import StreamingGraph, as_ids


def sample_fanout(key, graph: StreamingGraph, seeds, fanout: int):
    """seeds [B] -> (nbrs int64 [B, fanout], mask f32 [B, fanout]), uniform
    with replacement; a vertex of degree 0 is its own neighbor, masked.
    `key` is a port key or a reference key as numpy."""
    seeds = as_ids(seeds, graph.device)
    key = jr.as_key(key, graph.device)
    b = seeds.shape[0]
    start = graph.offsets[seeds].to(torch.int64)
    deg = graph.offsets[seeds + 1].to(torch.int64) - start
    r = jr.randint(key, (b, fanout), 0, torch.clamp(deg, min=1)[:, None])
    idx = (start[:, None] + r).clamp(max=graph.codes.shape[0] - 1)
    nbrs = lo32(graph.codes[idx])
    mask = (deg > 0)[:, None].expand(b, fanout)
    nbrs = torch.where(mask, nbrs, seeds[:, None])
    return nbrs, mask.to(torch.float32)


def sample_two_hop(key, graph: StreamingGraph, seeds, f1: int, f2: int):
    """Two-hop neighborhood: ((h1 [B, f1], m1), (h2 [B, f1, f2], m2)); a
    hop-2 row is masked where its hop-1 vertex is."""
    k1, k2 = jr.split(jr.as_key(key, graph.device))
    h1, m1 = sample_fanout(k1, graph, seeds, f1)
    h2, m2 = sample_fanout(k2, graph, h1.reshape(-1), f2)
    b = h1.shape[0]
    return (h1, m1), (h2.reshape(b, f1, f2), m2.reshape(b, f1, f2) * m1[..., None])


def walk_based_neighborhood(store, seeds, n_w: int, length: int, hops: int,
                            backend=None):
    """The corpus-powered sampler: the first `hops` steps of each
    maintained walk of a seed vertex form an importance-sampled
    neighborhood (the walks starting at v have ids v*n_w .. v*n_w + n_w - 1
    by corpus construction) -> int64 [B, n_w, hops + 1]. `store` is a
    WalkStore or an Overlay (pending blocks live); `backend` selects the
    FINDNEXT backend ("cuda", "torch", "ref"; the device's default if
    None). `length` is the corpus's, kept for the reference's signature."""
    dev = getattr(store, "base", store).device
    seeds = as_ids(seeds, dev)
    b = seeds.shape[0]
    walk_ids = seeds[:, None] * n_w + torch.arange(n_w, dtype=torch.int64, device=dev)[None]
    start = torch.repeat_interleave(seeds, n_w)
    paths = store.traverse(walk_ids.reshape(-1), start, hops, backend=backend)
    return paths.reshape(b, n_w, hops + 1)
