"""Synthetic graph-stream generators (paper §7.1: R-MAT / Erdős–Rényi /
skew); port of `repro/data/streams.py`, bit for bit on the module-0 PRNG.

R-MAT(a, b, c, d): recursive quadrant sampling; the paper uses
  * update batches: a=0.5, b=c=0.1, d=0.3 (as in Aspen)
  * er-k graphs:    a=b=c=d=0.25, avg degree 100 (TrillionG settings)
  * sg-s skew:      b=c=0.25, d/a ratio tuned so bottom-right mass ≈ s x top-left

Every generator is deterministic in its key and runs on the key's device
(a numpy or JAX key goes to `device`, the card unless the caller asks for
the CPU). Vertex ids are u32 values held as int32 bits (`repro_torch._u64`).
The quadrant draws are float64, as the reference's under x64: their
uniforms are bit for bit, their logs torch's (see `random.gumbel`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch._device import resolve_device

I32 = torch.int32


def _key(key, device) -> torch.Tensor:
    dev = key.device if isinstance(key, torch.Tensor) else resolve_device(device)
    return jr.as_key(key, dev)


def rmat_edges(key, n_edges: int, log2_n: int, a: float = 0.5,
               b: float = 0.1, c: float = 0.1, d: float = 0.3, device=None):
    """Sample n_edges (src, dst) pairs from R-MAT over 2^log2_n vertices.
    A batch of keys [..., 2] gives [..., n_edges] each, the reference's
    `vmap` over the keys."""
    key = _key(key, device)
    logits = torch.log(torch.tensor([a, b, c, d], dtype=torch.float64,
                                    device=key.device))
    keys = jr.split(key, log2_n)
    src = torch.zeros(key.shape[:-1] + (n_edges,), dtype=I32, device=key.device)
    dst = src
    for i in range(log2_n):
        q = jr.categorical(keys[..., i, :], logits, shape=(n_edges,))
        src = (src << 1) | (q >= 2).to(I32)
        dst = (dst << 1) | (q % 2).to(I32)
    return src, dst


def er_edges(key, n_edges: int, log2_n: int, device=None):
    """Erdős–Rényi-style batch (uniform R-MAT quadrants, paper's er-k)."""
    return rmat_edges(key, n_edges, log2_n, 0.25, 0.25, 0.25, 0.25,
                      device=device)


def skewed_params(s: float):
    """sg-s graphs: b=c=0.25, bottom-right ≈ s x top-left (paper §7.1)."""
    a = 0.5 / (1.0 + s)
    d = s * a
    return a, 0.25, 0.25, d


def skewed_edges(key, n_edges: int, log2_n: int, s: float, device=None):
    a, b, c, d = skewed_params(s)
    return rmat_edges(key, n_edges, log2_n, a, b, c, d, device=device)


def cora_like(key, n_vertices: int = 2708, n_edges: int = 5429,
              n_classes: int = 7, d_feat: int = 1433, device=None):
    """Synthetic stand-in for the Cora citation graph (paper §7.6): a random
    partition model with intra-class preference plus one-hot-ish features.
    -> ((src, dst) int32, labels int64, features float32 [n, d_feat])."""
    k1, k2, k3, k4 = jr.split(_key(key, device), 4)
    labels = jr.randint(k1, (n_vertices,), 0, n_classes)
    src = jr.randint(k2, (n_edges,), 0, n_vertices)
    # 80% intra-class edges: pick dst from the same label bucket by rejection
    dst_rand = jr.randint(k3, (n_edges,), 0, n_vertices)
    same = jr.uniform(k4, (n_edges,), torch.float64) < 0.8
    # crude intra-class pairing: shift within sorted-by-label ordering
    order = torch.argsort(labels, stable=True)
    rank = torch.argsort(order, stable=True)
    dst_same = order[(rank[src] + 1) % n_vertices]
    dst = torch.where(same, dst_same, dst_rand)
    feats = jr.bernoulli(k2, 0.01, (n_vertices, d_feat)).to(torch.float32)
    return (src.to(I32), dst.to(I32)), labels, feats


def edge_batches(key, n_batches: int, batch_size: int, log2_n: int,
                 a=0.5, b=0.1, c=0.1, d=0.3, device=None):
    """Stream of edge-update batches (paper §7.2 setup), a list of pairs."""
    keys = jr.split(_key(key, device), n_batches)
    return [rmat_edges(keys[i], batch_size, log2_n, a, b, c, d)
            for i in range(n_batches)]


def edge_batch_stream(key, n_batches: int, batch_size: int, log2_n: int,
                      a=0.5, b=0.1, c=0.1, d=0.3, device=None):
    """Stacked [n_batches, batch_size] R-MAT edge stream; batch i equals
    `rmat_edges(split(key, n)[i], ...)`, drawn for all keys at once."""
    keys = jr.split(_key(key, device), n_batches)
    return rmat_edges(keys, batch_size, log2_n, a, b, c, d)


def mixed_edge_stream(key, n_batches: int, n_ins: int, n_del: int,
                      log2_n: int, a=0.5, b=0.1, c=0.1, d=0.3, device=None):
    """Stacked insertion + deletion stream (paper Fig. 7 mixed workload):
    (ins_src, ins_dst, del_src, del_dst), [n_batches, n_ins] /
    [n_batches, n_del]. Deletions are drawn from the same R-MAT
    distribution, so most target existing hubs; deleting an absent edge is
    a graph no-op but still marks its endpoints MAV-touched."""
    k_ins, k_del = jr.split(_key(key, device))
    ins_src, ins_dst = edge_batch_stream(k_ins, n_batches, n_ins, log2_n,
                                         a, b, c, d)
    del_src, del_dst = edge_batch_stream(k_del, n_batches, max(n_del, 1),
                                         log2_n, a, b, c, d)
    return ins_src, ins_dst, del_src[:, :n_del], del_dst[:, :n_del]


def token_stream(key, batch: int, seq_len: int, vocab: int, device=None):
    """Synthetic LM token batch, int32 [batch, seq_len]."""
    return jr.randint(_key(key, device), (batch, seq_len), 0, vocab,
                      dtype=torch.int32)


def host_rmat(seed: int, n_edges: int, log2_n: int, a=0.5, b=0.1, c=0.1,
              d=0.3):
    """NumPy R-MAT (for host-side dataset prep without device transfer)."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.uint32)
    dst = np.zeros(n_edges, np.uint32)
    for _ in range(log2_n):
        q = rng.choice(4, size=n_edges, p=[a, b, c, d])
        src = (src << 1) | (q >= 2)
        dst = (dst << 1) | (q % 2)
    return src, dst
