"""Kernel 4: FINDNEXT over packed chunks (CUDA, `csrc/range_search.cu`),
its plain PyTorch version, and `candidate_chunks`.

Port of `repro/kernels/range_search.py`. For each query q the K candidate
chunks `chunk_idx[q, :]` are decoded and unpaired in order; the first
chunk that holds a code with f == f_targets[q] wins, with the largest v
among its hits (first-hit-wins, range_search.py:52-61).
"""
from __future__ import annotations

import torch

from repro_torch.core.pairing import szudzik_unpair
from repro_torch.kernels._launch import call, require
from repro_torch.kernels._observe import observed
from repro_torch.kernels.delta import CHUNK, decode_rows_plain, packed_rows

QUERY_SLAB = 4096   # queries per plain-version slab
MAX_WINDOW = 32     # the kernel's K bound: chunk j's scalars sit in lane j


def _search_plain_slab(packed, widths, a_hi, a_lo, chunk_idx, f_targets):
    q, k = chunk_idx.shape
    # each distinct chunk of the slab is decoded and unpaired once
    rows, inv = torch.unique(chunk_idx.reshape(-1).to(torch.int64),
                             return_inverse=True)
    f, v = szudzik_unpair(decode_rows_plain(packed, widths, a_hi, a_lo, rows))
    hit = f[inv].reshape(q, k, CHUNK) == f_targets[:, None, None]
    v = v[inv].reshape(q, k, CHUNK)
    chunk_hit = hit.any(dim=-1)                                  # [Q, K]
    found = chunk_hit.any(dim=-1)
    first = torch.argmax(chunk_hit.to(torch.int8), dim=-1)      # first hit k
    sel = first[:, None, None].expand(q, 1, CHUNK)
    sel_hit = torch.gather(hit, 1, sel)[:, 0]
    sel_v = torch.gather(v, 1, sel)[:, 0]
    val = torch.where(sel_hit, sel_v, torch.zeros_like(sel_v)).amax(dim=-1)
    return val, found


@observed("find_next_packed")
def find_next_packed_plain(packed, widths, a_hi, a_lo, chunk_idx, f_targets):
    """chunk_idx int [Q, K]; f_targets int64 [Q] -> (v int64 [Q], found
    bool [Q])."""
    q = chunk_idx.shape[0]
    v = torch.zeros((q,), dtype=torch.int64, device=packed.device)
    found = torch.zeros((q,), dtype=torch.bool, device=packed.device)
    for s in range(0, q, QUERY_SLAB):
        v[s:s + QUERY_SLAB], found[s:s + QUERY_SLAB] = _search_plain_slab(
            packed, widths, a_hi, a_lo, chunk_idx[s:s + QUERY_SLAB],
            f_targets[s:s + QUERY_SLAB])
    return v, found


def find_next_packed_cuda(packed, widths, a_hi, a_lo, chunk_idx, f_targets):
    """The kernel: as `find_next_packed_plain`, for 1 <= K <= MAX_WINDOW
    (raised before any work on the card) and 16-byte aligned packed rows."""
    q, k = chunk_idx.shape
    if not 1 <= k <= MAX_WINDOW:
        raise ValueError(f"find_next_packed: the kernel takes 1 <= K <= {MAX_WINDOW} "
                         f"chunks a query, got K = {k}")
    packed = packed_rows(packed, "find_next_packed")
    widths = require(widths, torch.int32, "find_next_packed widths")
    a_hi = require(a_hi, torch.int32, "find_next_packed anchors_hi")
    a_lo = require(a_lo, torch.int32, "find_next_packed anchors_lo")
    chunk_idx = require(chunk_idx.to(torch.int32), torch.int32,
                        "find_next_packed chunk_idx")
    f_targets = require(f_targets, torch.int64, "find_next_packed f_targets")
    if f_targets.shape != (q,):
        raise ValueError("find_next_packed: f_targets must be [Q]")
    v = torch.empty((q,), dtype=torch.int64, device=packed.device)
    found = torch.empty((q,), dtype=torch.bool, device=packed.device)
    call("repro_find_next_packed", packed.device, packed, widths, a_hi, a_lo,
         chunk_idx, f_targets, v, found, q, k)
    return v, found


def candidate_chunks(chunk_first, lb, k: int):
    """First chunk whose head could cover lb, plus the next k-1 chunks.
    `chunk_first` biased heads [C], globally sorted (single-segment corpora
    only, as in the reference); lb biased [Q] -> int64 [Q, k]."""
    pos = torch.searchsorted(chunk_first, lb, right=True)
    start = (pos - 1).clamp(min=0)
    idx = start[:, None] + torch.arange(k, device=lb.device)[None]
    return idx.clamp(0, chunk_first.shape[0] - 1)
