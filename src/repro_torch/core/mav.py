"""Map of Affected Vertices (paper §6.1, Def. 3); port of `repro/core/mav.py`.

For a batch of edge updates the MAV maps each affected walk w to
{v_min, p_min}: its first touched vertex and that position.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u64 import INT64_MAX, M32, u32_value
from repro_torch.core.graph import as_ids
from repro_torch.core.store import WalkStore
from repro_torch.kernels import ops


class MAV(NamedTuple):
    p_min: torch.Tensor   # int64 [n_walks]; == l -> walk unaffected
    v_min: torch.Tensor   # int64 [n_walks]; vertex at p_min


def touched_vertices(n_vertices: int, device, *arrays):
    touched = torch.zeros((n_vertices,), dtype=torch.bool, device=device)
    for arr in arrays:
        if arr is not None and len(arr) > 0:
            touched[as_ids(arr, device)] = True
    return touched


def keyed_pmin(w, p, owner, epoch, slot_epoch, touched, valid,
               length: int, n_walks: int):
    """Per-walk composite-min keys p * 2^32 + v_at_p (int64 [n_walks]),
    clamped to the miss key length * 2^32. The min over live touched
    entries selects (p_min, v at p_min), ties broken by owner, as the
    reference's segment_min. Callers may combine several calls with
    torch.minimum: the min is associative."""
    slot = (w * length + p).clamp(0, n_walks * length - 1)
    hit = valid & touched & (epoch == slot_epoch[slot])
    miss = length << 32
    keyed = torch.where(hit, (p << 32) + u32_value(owner),
                        torch.full_like(p, miss))
    best = torch.full((n_walks,), INT64_MAX, dtype=torch.int64, device=w.device)
    best.scatter_reduce_(0, torch.where(hit, w, 0), keyed, "amin")
    return best.clamp(max=miss)


def mav_from_keyed(best, length: int) -> MAV:
    p_min = best >> 32
    v_min = torch.where(p_min < length, best & M32, 0)
    return MAV(p_min=p_min, v_min=v_min)


def _pmin_from_wpo(w, p, owner, epoch, slot_epoch, touched, valid,
                   length: int, n_walks: int) -> MAV:
    return mav_from_keyed(keyed_pmin(w, p, owner, epoch, slot_epoch, touched,
                                     valid, length, n_walks), length)


def _pmin_from_entries(owner, code, epoch, slot_epoch, touched, valid,
                       length: int, n_walks: int) -> MAV:
    f, _ = ops.szudzik_unpair(code)
    return _pmin_from_wpo(f // length, f % length, owner, epoch, slot_epoch,
                          touched, valid, length, n_walks)


def mav_dense(store: WalkStore, ins_src, ins_dst, del_src=None,
              del_dst=None) -> MAV:
    """O(T) masked scan (oracle + II-like baseline)."""
    touched_v = touched_vertices(store.n_vertices, store.device, ins_src,
                                 ins_dst, del_src, del_dst)
    touched = touched_v[store.owner.to(torch.int64)]
    return _pmin_from_entries(store.owner, store.code, store.epoch,
                              store.slot_epoch, touched,
                              torch.ones_like(touched), store.length,
                              store.n_walks)


def gather_touched_segments(store: WalkStore, touched_v, capacity: int):
    """Output-sensitive segment gather (§6.1) of the touched vertices'
    walk-tree segments.

    Returns (owner, code, epoch, valid, total). The reference returns
    `capacity` rows, valid below `total`; here the rows are cut to
    min(total, capacity), which drops only invalid rows (one host read of
    `total`). `total > capacity` is a gather overflow: rows past
    `capacity` are dropped, and the caller flags it."""
    dev = store.device
    seg_len = (store.offsets[1:] - store.offsets[:-1]).to(torch.int64)
    aff_len = torch.where(touched_v, seg_len, 0)
    ends = torch.cumsum(aff_len, dim=0)
    total = ends[-1] if ends.numel() else torch.zeros((), dtype=torch.int64,
                                                      device=dev)
    rows = min(int(total), capacity)
    slot_ids = torch.arange(rows, dtype=torch.int64, device=dev)
    seg_of = torch.searchsorted(ends, slot_ids, right=True).clamp(
        0, store.n_vertices - 1)
    within = slot_ids - (ends[seg_of] - aff_len[seg_of])
    src = (store.offsets[seg_of].to(torch.int64) + within).clamp(0, store.size - 1)
    valid = torch.ones((rows,), dtype=torch.bool, device=dev)
    return store.owner[src], store.code[src], store.epoch[src], valid, total


def mav_indexed(store: WalkStore, ins_src, ins_dst, del_src=None,
                del_dst=None, gather_capacity: int | None = None) -> MAV:
    """Output-sensitive MAV: gather only the touched vertices' segments."""
    touched_v = touched_vertices(store.n_vertices, store.device, ins_src,
                                 ins_dst, del_src, del_dst)
    if gather_capacity is None:
        gather_capacity = store.size
    owner, code, epoch, valid, _ = gather_touched_segments(
        store, touched_v, gather_capacity)
    touched = touched_v[owner.to(torch.int64)] & valid
    return _pmin_from_entries(owner, code, epoch, store.slot_epoch, touched,
                              valid, store.length, store.n_walks)
