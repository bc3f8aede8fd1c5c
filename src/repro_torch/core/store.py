"""WalkStore — the hybrid tree (paper §4) as flat device tensors; port of
`repro/core/store.py`.

    owner   int32 [T]  vertex at (w, p); primary sort key
    code    int64 [T]  biased Szudzik codes; secondary sort key
    epoch   int32 [T]  version stamp of each entry
    offsets int32 [n+1] per-vertex segment bounds
    vmin/vmax int32 [n] (u32 bits) min/max next vertex per vertex (§5.1);
            an empty segment has vmin 0xFFFFFFFF (-1 here) and vmax 0
    packed/widths/anchors_*/last_*: the FOR-packed chunks (§4.4, §5.2)
    slot_epoch int32 [n_walks * l] latest version per corpus slot

FINDNEXT reads the packed chunks through the backend registry of
core/packed_store.py and verifies each hit against the uncompressed
code/epoch tensors, as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch._u64 import M32, u32_bits, u32_value
from repro_torch.core import packed_store
from repro_torch.core.packed_store import CHUNK, PackedWalkStore
from repro_torch.core.utils import lexsort, seg_searchsorted
from repro_torch.kernels import ops

PAD_EPOCH = -1   # u32 0xFFFFFFFF


def _nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


@dataclass(frozen=True)
class WalkStore:
    owner: torch.Tensor
    code: torch.Tensor
    epoch: torch.Tensor
    offsets: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    packed: torch.Tensor
    widths: torch.Tensor
    anchors_hi: torch.Tensor
    anchors_lo: torch.Tensor
    last_hi: torch.Tensor
    last_lo: torch.Tensor
    slot_epoch: torch.Tensor
    length: int
    n_walks: int
    n_vertices: int
    chunk_b: int = 128

    def replace(self, **kw) -> "WalkStore":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ build

    @staticmethod
    def build(owner, code, epoch, slot_epoch, length: int, n_walks: int,
              n_vertices: int, chunk_b: int = 128) -> "WalkStore":
        """Sort by (owner, code) and derive all index metadata."""
        order = lexsort((code, owner))
        return WalkStore.from_sorted(
            owner[order].to(torch.int32), code[order],
            epoch[order].to(torch.int32), slot_epoch, length, n_walks,
            n_vertices, chunk_b)

    @staticmethod
    def from_sorted(owner, code, epoch, slot_epoch, length: int,
                    n_walks: int, n_vertices: int, chunk_b: int = 128,
                    prev: Optional["WalkStore"] = None) -> "WalkStore":
        """Derive metadata from an (owner, code)-sorted stream.

        With `prev` (the pre-merge store, same shapes) only the chunks whose
        codes changed are re-encoded; clean chunks keep prev's packed rows
        bit-identically (the dirty-chunk invariant). The reference encodes
        every chunk and selects; encoding only the dirty rows gives the
        same tensors, since each chunk encodes on its own."""
        dev = code.device
        offsets = torch.searchsorted(
            owner, torch.arange(n_vertices + 1, dtype=torch.int32, device=dev),
            side="left").to(torch.int32)
        _, v_next = ops.szudzik_unpair(code)
        # a shard's pad rows (owner n_vertices) land in a dropped last row
        seg = owner.to(torch.int64).clamp(max=n_vertices)
        vmin = torch.full((n_vertices + 1,), M32, dtype=torch.int64, device=dev)
        vmin.scatter_reduce_(0, seg, v_next, "amin")
        vmax = torch.zeros((n_vertices + 1,), dtype=torch.int64, device=dev)
        vmax.scatter_reduce_(0, seg, v_next, "amax")
        vmin, vmax = vmin[:n_vertices], vmax[:n_vertices]
        del v_next, seg
        chunks = packed_store.pad_chunk_codes(code)
        if prev is not None and prev.code.shape == code.shape:
            dirty = torch.nonzero(
                (packed_store.pad_chunk_codes(prev.code) != chunks).any(dim=1)
            ).reshape(-1)
            enc = packed_store.encode_chunk_grid(chunks[dirty])
            cols = [t.clone() for t in (prev.packed, prev.widths,
                                        prev.anchors_hi, prev.anchors_lo,
                                        prev.last_hi, prev.last_lo)]
            for col, new in zip(cols, enc):
                col[dirty] = new
        else:
            cols = packed_store.encode_chunk_grid(chunks)
        return WalkStore(owner, code, epoch, offsets, u32_bits(vmin),
                         u32_bits(vmax), *cols, slot_epoch, length, n_walks,
                         n_vertices, chunk_b)

    @property
    def size(self) -> int:
        return self.code.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.packed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.code.device

    def packed_view(self) -> PackedWalkStore:
        return PackedWalkStore(self.packed, self.widths, self.anchors_hi,
                               self.anchors_lo, self.last_hi, self.last_lo,
                               self.offsets, self.vmin, self.vmax,
                               self.length, self.n_vertices)

    # ------------------------------------------------------------- traversal

    def _slot_query(self, v, w, p):
        dev = self.device
        v = torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(-1)
        w = torch.as_tensor(w, dtype=torch.int64, device=dev).reshape(-1)
        p = torch.as_tensor(p, dtype=torch.int64, device=dev).reshape(-1)
        f = w * self.length + p
        seg_lo = self.offsets[v]
        seg_hi = self.offsets[v + 1]
        return v, f, seg_lo, seg_hi, self.slot_epoch[f]

    def find_next(self, v, w, p, backend: Optional[str] = None,
                  window: Optional[int] = None):
        """FINDNEXT (paper Alg. 1), batched: (v_next int64, found bool).

        The §5.1 pruned range [lb, ub] = [<f, vmin[v]>, <f, vmax[v]>] within
        v's segment is searched in K = `window` packed chunks from the
        chunk of lb; each hit is verified against code/epoch (the slot's
        live version), and lanes whose range spans more than K chunks take
        the reference scan. Bit-identical to the reference's backends."""
        backend = packed_store.resolve_backend(backend, self.device)
        if self.n_walks * self.length > M32:
            backend = "ref"   # the kernel's f-match is u32; huge corpora scan
        v, f, seg_lo, seg_hi, want_epoch = self._slot_query(v, w, p)
        lb = ops.szudzik_pair(f, u32_value(self.vmin[v]))
        ub = ops.szudzik_pair(f, u32_value(self.vmax[v]))
        lo = seg_searchsorted(self.code, seg_lo, seg_hi, lb, side="left")
        hi = seg_searchsorted(self.code, seg_lo, seg_hi, ub, side="right")
        if backend == "ref":
            return self._scan_ref(lo, hi, f, want_epoch)

        k = window or packed_store.get_default_window()
        c0 = lo // CHUNK
        c1 = torch.maximum(hi - 1, lo) // CHUNK
        cidx = (c0[:, None] + torch.arange(k, device=self.device)[None]
                ).clamp(0, self.n_chunks - 1).to(torch.int32)
        v_k, f_k = packed_store.packed_search(
            self.packed, self.widths, self.anchors_hi, self.anchors_lo, cidx,
            f, backend)
        over = (hi > lo) & ((c1 - c0) >= k)
        # verify against the authoritative tensors: the hit must sit in v's
        # segment and carry the slot's live epoch
        tgt = ops.szudzik_pair(f, v_k)
        pos = seg_searchsorted(self.code, seg_lo, seg_hi, tgt, side="left")
        pc = pos.clamp(0, self.size - 1)
        ok = (pos < seg_hi) & (self.code[pc] == tgt) & (self.epoch[pc] == want_epoch)
        found = f_k & ok
        out = torch.where(found, v_k, torch.zeros_like(v_k))
        lanes = torch.nonzero(over).reshape(-1)
        if lanes.numel():
            o_out, o_found = self._scan_ref(lo[lanes], hi[lanes], f[lanes],
                                            want_epoch[lanes])
            out[lanes] = o_out
            found[lanes] = o_found
        return out, found

    def _scan_ref(self, lo, hi, f, want_epoch, first: bool = True):
        """The "ref" backend: scan the uncompressed codes of [lo, hi) for
        the entry with first operand f and the live epoch, vectorized over
        lanes. `first=False` keeps the last match instead (the reference's
        find_next_simple)."""
        out = torch.zeros_like(f)
        found = torch.zeros(f.shape, dtype=torch.bool, device=f.device)
        span = int((hi - lo).max()) if f.numel() else 0
        for j in range(max(span, 0)):
            i = lo + j
            active = i < hi
            if first:
                active &= ~found
            ic = i.clamp(0, self.size - 1)
            cf, cv = ops.szudzik_unpair(self.code[ic])
            ok = active & (cf == f) & (self.epoch[ic] == want_epoch)
            out = torch.where(ok, cv, out)
            found |= ok
        return out, found

    def find_next_simple(self, v, w, p):
        """Baseline 'simple search' (paper §7.5): scan the whole segment."""
        _, f, seg_lo, seg_hi, want_epoch = self._slot_query(v, w, p)
        return self._scan_ref(seg_lo.to(torch.int64), seg_hi.to(torch.int64),
                              f, want_epoch, first=False)

    def traverse(self, w, start_vertex, upto: int,
                 backend: Optional[str] = None):
        """Reconstruct walks w's vertices [0..upto] by repeated FINDNEXT
        -> int64 [Q, upto + 1]."""
        w = torch.as_tensor(w, dtype=torch.int64, device=self.device).reshape(-1)
        cur = torch.as_tensor(start_vertex, dtype=torch.int64,
                              device=self.device).reshape(-1)
        path = [cur]
        for p in range(upto):
            nxt, found = self.find_next(cur, w, torch.full_like(w, p),
                                        backend=backend)
            cur = torch.where(found, nxt, cur)
            path.append(cur)
        return torch.stack(path, dim=1)

    # ------------------------------------------------------------- memory

    def nbytes_uncompressed(self) -> int:
        return _nbytes(self.owner, self.code, self.epoch, self.offsets,
                       self.vmin, self.vmax, self.anchors_hi, self.anchors_lo,
                       self.last_hi, self.last_lo)

    def nbytes_packed(self) -> int:
        return self.packed_view().nbytes()

    def nbytes_packed_capacity(self) -> int:
        return self.packed_view().nbytes_capacity()
