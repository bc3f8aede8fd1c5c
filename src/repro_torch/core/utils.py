"""Vectorized search/compaction helpers shared by the core (port of
`repro/core/utils.py`)."""
from __future__ import annotations

import math

import torch


def seg_searchsorted(sorted_vals, lo, hi, target, side: str = "left"):
    """Per-query binary search of `target` within [lo, hi) of `sorted_vals`
    (sorted within each queried segment). Fixed log2(N)+1 iterations,
    branch-free, as the reference. Returns int64 positions."""
    n = sorted_vals.shape[0]
    iters = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        v = sorted_vals[mid.clamp(0, n - 1)]
        go_right = (v < target) if side == "left" else (v <= target)
        cont = lo < hi
        lo = torch.where(cont & go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    return lo


def lexsort(keys):
    """`jnp.lexsort`: the permutation sorting by the LAST key first, ties
    broken by the earlier keys; one stable sort per key."""
    keys = [k.to(torch.uint8) if k.dtype == torch.bool else k for k in keys]
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def compact_nonzero(mask, size: int, fill_value: int = 0):
    """Indices of True entries in ascending order, cut or padded to `size`,
    and the validity of each lane (lanes < count of True). Entries past
    `size` are dropped without a flag, as in the reference."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    pad = size - idx.shape[0]
    if pad:
        idx = torch.cat([idx, torch.full((pad,), fill_value, dtype=idx.dtype,
                                         device=idx.device)])
    valid = torch.arange(size, device=mask.device) < mask.sum()
    return idx, valid
