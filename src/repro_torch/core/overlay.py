"""Mergeless overlay reads: base store + pending version blocks; port of
`repro/core/overlay.py`.

Between merges the engine state is an immutable base `WalkStore` plus
pending rows whose slot-epoch stamps supersede the base. Per corpus slot,
the live entry is the one (base or pending) whose epoch equals
`slot_epoch[slot]`: rewritten slots fail the base's liveness check and
resolve from pending; the others resolve from the base as after a merge.

The reference indexes every pending row by a sort on (slot << 32 | epoch)
and answers a point lookup by `searchsorted` of (slot, slot_epoch[slot]).
A row with that key is exactly the slot's live pending row, and a slot has
at most one (one row per slot and epoch). So the port keeps a dense table
slot -> live pending row instead (-1 where the slot lives in the base):
the same answers, without sorting the pending rows, whose count at full
width (four blocks of 2^18 * 10 * 80 rows) is four times the corpus. The
owner-sorted index of `pending_walks_of` is built when that read asks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch._u64 import u32_value
from repro_torch.core.store import PAD_EPOCH, WalkStore
from repro_torch.kernels import ops


@dataclass(frozen=True)
class Overlay:
    """Read view over `base` + pending rows (flattened [E] views of the
    filled pending blocks) and the slot -> live row table."""

    base: WalkStore
    owner: torch.Tensor         # int32 [E]
    code: torch.Tensor          # int64 [E] biased
    epoch: torch.Tensor         # int32 [E]; PAD_EPOCH = dead row
    slot: torch.Tensor          # int32 [E]
    row_of_slot: torch.Tensor   # int32/int64 [n_walks * l]; -1 = none

    # ------------------------------------------------------------------ build

    @staticmethod
    def build(store: WalkStore, pending) -> "Overlay":
        """Index the pending rows (a PendingBlocks of any leading shape, or
        None for none) for overlay reads: one pass per block."""
        dev = store.device
        if pending is None:
            cols = [torch.zeros((0,), dtype=dt, device=dev) for dt in
                    (torch.int32, torch.int64, torch.int32, torch.int32)]
        else:
            cols = [t.reshape(-1) for t in pending]
        owner, code, epoch, slot = cols
        t = store.n_walks * store.length
        n = epoch.shape[0]
        dt = torch.int32 if n < 2**31 else torch.int64
        table = torch.full((t,), -1, dtype=dt, device=dev)
        step = pending.owner.shape[-1] if n else 1
        for s in range(0, n, step):
            sl = slot[s:s + step].to(torch.int64).clamp_(0, t - 1)
            ep = epoch[s:s + step]
            live = (ep != PAD_EPOCH) & (ep == store.slot_epoch[sl])
            rows = torch.nonzero(live).reshape(-1)
            table[sl[rows]] = (rows + s).to(dt)
        return Overlay(store, owner, code, epoch, slot, table)

    def replace(self, **kw) -> "Overlay":
        return dataclasses.replace(self, **kw)

    @property
    def n_pending_entries(self) -> int:
        return self.epoch.shape[0]

    def copy_pending(self) -> "Overlay":
        """The same view over fresh copies of the pending rows and the
        table. The engine rewrites its pending tensors in place (where the
        reference donates them), so a reader that must outlive the next
        update holds copies; the base store is shared."""
        return self.replace(owner=self.owner.clone(), code=self.code.clone(),
                            epoch=self.epoch.clone(), slot=self.slot.clone(),
                            row_of_slot=self.row_of_slot.clone())

    # ------------------------------------------------------------- traversal

    def _pending_next(self, v, slot):
        """The live pending entry of `slot` if v owns it: (next int64, 0
        where there is none; hit bool)."""
        if self.n_pending_entries == 0:
            return torch.zeros_like(v), torch.zeros_like(v, dtype=torch.bool)
        row = self.row_of_slot[slot].to(torch.int64)
        rc = row.clamp(min=0)
        hit = (row >= 0) & (u32_value(self.owner[rc]) == v)
        _, nxt = ops.szudzik_unpair(self.code[rc])
        return torch.where(hit, nxt, 0), hit

    def find_next(self, v, w, p, backend: Optional[str] = None,
                  window: Optional[int] = None):
        """FINDNEXT over base + pending (slot-epoch precedence). A slot
        rewritten in pending fails the base's liveness check, so base and
        pending hits exclude each other."""
        dev = self.base.device
        v = torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(-1)
        w = torch.as_tensor(w, dtype=torch.int64, device=dev).reshape(-1)
        p = torch.as_tensor(p, dtype=torch.int64, device=dev).reshape(-1)
        base_out, base_found = self.base.find_next(v, w, p, backend=backend,
                                                   window=window)
        pend_out, pend_found = self._pending_next(
            v, w * self.base.length + p)
        return (torch.where(pend_found, pend_out, base_out),
                base_found | pend_found)

    def traverse(self, w, start_vertex, upto: int,
                 backend: Optional[str] = None):
        """Walks w's vertices [0..upto] via overlay FINDNEXT -> int64
        [Q, upto + 1]."""
        dev = self.base.device
        w = torch.as_tensor(w, dtype=torch.int64, device=dev).reshape(-1)
        cur = torch.as_tensor(start_vertex, dtype=torch.int64,
                              device=dev).reshape(-1)
        path = [cur]
        for p in range(upto):
            nxt, found = self.find_next(cur, w, torch.full_like(w, p),
                                        backend=backend)
            cur = torch.where(found, nxt, cur)
            path.append(cur)
        return torch.stack(path, dim=1)

    # ---------------------------------------------------------- segment reads

    def pending_walks_of(self, vertices, capacity: int):
        """Walk ids with a LIVE pending triplet owned by each vertex: int64
        [B, capacity], -1 padded. As the reference: the first `capacity`
        rows of the vertex's owner segment of the not-dead rows (in row
        order within the segment), each kept if live."""
        dev = self.base.device
        vertices = torch.as_tensor(vertices, dtype=torch.int64,
                                   device=dev).reshape(-1)
        out = torch.full((vertices.shape[0], capacity), -1, dtype=torch.int64,
                         device=dev)
        rows = torch.nonzero(self.epoch != PAD_EPOCH).reshape(-1)
        if rows.numel() == 0:
            return out
        okey = u32_value(self.owner[rows])
        order = torch.argsort(okey, stable=True)
        okey, rows = okey[order], rows[order]
        lo = torch.searchsorted(okey, vertices)
        hi = torch.searchsorted(okey, vertices + 1)
        idx = lo[:, None] + torch.arange(capacity, device=dev)[None]
        in_seg = idx < hi[:, None]
        r = rows[idx.clamp(max=rows.shape[0] - 1)]
        nwl = self.base.n_walks * self.base.length
        slot = self.slot[r].to(torch.int64)
        live = self.epoch[r] == self.base.slot_epoch[slot.clamp(0, nwl - 1)]
        return torch.where(in_seg & live, slot // self.base.length, out)
