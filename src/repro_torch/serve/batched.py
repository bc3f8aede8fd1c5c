"""Batched, shape-bucketed query functions (the multi-query engine); port
of `repro/serve/batched.py`.

Each query kind is one function over the overlay (base store + pending
rows). The reference jits each at module level and rounds ragged batches
up to power-of-two buckets so that a live mix hits a handful of compiled
entries. The port has no jit: these are plain functions on tensors, and
the host drives them. The buckets stay: the padded shapes are part of the
contract (a padded batch answers as per-item calls do), and they keep the
kernels' launch shapes to a few sizes. Results are sliced back to the true
batch length by the caller (serve/walk_queries.py).

On the card the reads go through the port's kernels: `find_next_batch`
and `walk_matrix_all` through `Overlay.find_next` (the Szudzik pair for
the FINDNEXT bounds and the verify, the packed FINDNEXT, the unpair of
pending rows), `walks_of_batch` through the FOR decode and the unpair.
"""
from __future__ import annotations

import torch

from repro_torch.core.corpus import walk_start_vertex
from repro_torch.core.overlay import Overlay
from repro_torch.core.packed_store import CHUNK, gather_decode
from repro_torch.core.ppr import ppr_scores
from repro_torch.kernels import ops

I64 = torch.int64
F32 = torch.float32

# smallest request bucket: sub-8 batches share one shape
BUCKET_MIN = 8


def bucket_size(n: int) -> int:
    """Round a request batch length up to the next power-of-two bucket."""
    if n <= BUCKET_MIN:
        return BUCKET_MIN
    return 1 << (n - 1).bit_length()


def pad_ids(arr: torch.Tensor, fill=0):
    """Pad a 1-D query tensor to its bucket: returns (padded, true_len).
    Pad lanes carry `fill` (a valid in-range id) and are sliced off by the
    caller."""
    arr = arr.reshape(-1)
    n = arr.shape[0]
    b = bucket_size(n)
    if b == n:
        return arr, n
    return torch.cat([arr, arr.new_full((b - n,), fill)]), n


# ------------------------------------------------------------- query kinds


def find_next_batch(ov: Overlay, v, w, p, backend=None, window=None):
    """Batched FINDNEXT over base + pending: (v_next int64 [B], found bool
    [B])."""
    return ov.find_next(v, w, p, backend=backend, window=window)


def walks_of_batch(ov: Overlay, vertices: torch.Tensor, capacity: int):
    """Walk ids visiting each vertex: int64 [B, 2 * capacity], -1 padded.

    Reads the vertex's segment bounds and decodes the covering FOR-packed
    chunks (the decode kernel on the card); base entries superseded by a
    pending version are masked by the slot-epoch liveness check, and the
    live pending entries of each vertex are appended from the overlay, so
    the union equals the post-merge segment exactly."""
    store = ov.base
    dev = store.device
    vertices = vertices.to(I64)
    starts = store.offsets[vertices].to(I64)
    lens = store.offsets[vertices + 1].to(I64) - starts
    # chunks covering [start, start + capacity) for every queried vertex
    kc = -(-capacity // CHUNK) + 1
    c0 = starts // CHUNK
    cidx = (c0[:, None] + torch.arange(kc, device=dev)[None]).clamp(
        0, store.n_chunks - 1)
    codes = gather_decode(store.packed, store.widths, store.anchors_hi,
                          store.anchors_lo, cidx).reshape(-1, kc * CHUNK)
    col = torch.arange(capacity, device=dev)[None]
    rel = (starts - c0 * CHUNK)[:, None] + col
    seg_codes = torch.gather(codes, 1, rel)
    valid = col < lens[:, None]
    f, _ = ops.szudzik_unpair(seg_codes)
    # slot-epoch liveness: mask base entries superseded by pending blocks
    abs_idx = (starts[:, None] + col).clamp(0, store.size - 1)
    slot = f.clamp(0, store.n_walks * store.length - 1)
    live = store.epoch[abs_idx] == store.slot_epoch[slot]
    base_w = torch.where(valid & live, f // store.length, -1)
    pend_w = ov.pending_walks_of(vertices, capacity)
    return torch.cat([base_w, pend_w], dim=1)


def walk_matrix_all(ov: Overlay, n_w: int, backend=None):
    """The full [n_walks, l] corpus (int64) by overlay traversal: the
    per-epoch product every matrix-backed read shares."""
    store = ov.base
    w = torch.arange(store.n_walks, device=store.device)
    return ov.traverse(w, walk_start_vertex(w, n_w), store.length - 1,
                       backend=backend)


def neighborhoods_from_matrix(wm, seeds, n_w: int, hops: int):
    """[B, n_w, hops + 1] seed neighborhoods gathered from the walk matrix
    (the walks of v are ids v*n_w .. v*n_w + n_w - 1)."""
    seeds = seeds.to(I64)
    walk_ids = seeds[:, None] * n_w + torch.arange(n_w, device=wm.device)[None]
    return wm[walk_ids.reshape(-1), : hops + 1].reshape(seeds.shape[0], n_w,
                                                        hops + 1)


def ppr_table(wm, n_vertices: int, restart_prob: float):
    """Full [n, n] PPR score table from the walk matrix (cached per
    (epoch, restart_prob) by the service)."""
    return ppr_scores(wm, n_vertices, restart_prob)


def gather_rows(table, idx):
    """Row gather: the per-query cost of a cache-warm PPR read."""
    return table[idx.to(I64)]


def normalize_rows(table):
    """L2-normalize embedding rows once per install (the emb-norm cache
    value); each query is then a plain matmul + top-k."""
    table = table.to(F32)
    norm = torch.clamp(torch.linalg.vector_norm(table, dim=1, keepdim=True),
                       min=1e-6)
    return table / norm


def _topk_lower_index_first(scores, k: int):
    """`lax.top_k` over rows of f32 scores: the k largest in descending
    order, the lower index first among equal scores (total order on the
    float bits, so -0.0 < 0.0). Each score and its index form one distinct
    int64 key, so `torch.topk` has no ties to order."""
    bits = scores.contiguous().view(torch.int32).to(I64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(scores.shape[1], device=scores.device, dtype=I64)
    keys = ordered * (1 << 32) + (0xFFFFFFFF - idx)[None]
    _, pos = torch.topk(keys, k, dim=1)
    return pos, torch.gather(scores, 1, pos)


def embedding_topk(normed, vertices, k: int):
    """Cosine top-k over the normalized table, query vertices excluded:
    (ids int64 [B, k], scores f32 [B, k]). The product is taken in f32 as
    the reference takes it, with TF32 off on the card."""
    vertices = vertices.to(I64)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scores = normed[vertices] @ normed.T                # [B, n]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    scores[torch.arange(vertices.shape[0], device=scores.device),
           vertices] = -torch.inf
    return _topk_lower_index_first(scores, k)
