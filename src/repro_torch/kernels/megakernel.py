"""Kernel 6: the fused rewalk step (CUDA, `csrc/megakernel.cu`), its plain
PyTorch version, and the fused scan; port of `repro/kernels/megakernel.py`.

The unfused order-2 rewalk traverses each walk's prefix through the
overlay first, then runs per step: the neighbor windows, the factorized
selection (kernel 5), the Szudzik write-back. The fused scan carries the
TRUE walk from position 0 instead: at a prefix position (p < p_min) a lane
advances by FINDNEXT, at p >= p_min by the sampler, and ONE launch per step
does, per lane,

  (i)   FINDNEXT over the K candidate chunks of the pruned range [lo, hi):
        decode, unpair, hit = pos in [lo, hi) & f == ft & epoch ==
        slot_epoch[f], first hit wins (WalkStore.find_next's search and
        verification, given one live entry per slot in the base store);
  (ii)  kernel 5's selection on the CSR segments of cur and prev
        (factorized mode), or the sampler's draw computed outside
        (external mode);
  (iii) `finalize_math`: pending precedence, stay in place when nothing is
        found, the terminal self-pointer;
  (iv)  the Szudzik pair of the written triplet.

The pruned ranges and the pending lookup (for the prefix lanes, which
alone read them) are formed outside the kernel; in factorized mode the
kernel reads the CSR segments of cur and prev itself and reports
deg > dmax (`overflow`), so no neighbor window is built on the card.
Exceptional lanes keep the unfused path's exactness at a cost
proportional to their count: candidate ranges wider than K chunks (`over`)
are fixed up by the reference scan `WalkStore._scan_ref`, and factorized
lanes with deg > dmax by `walkers.rejection_fallback`. Draw discipline, as
the unfused step: per step k_u, k_fb = split(kp); the uniforms are
uniform(k_u, (capacity, 2)), the fallback keys fold_in(k_fb, lane). So the
emitted triplets are the unfused path's, bit for bit.

Backends (the registry's default is None: the megakernel is OFF):
    "cuda"  — the kernel, one launch per step
    "torch" — `fused_step_plain`, the same per-lane math in plain PyTorch
    "ref"   — the step composed of the existing primitives
              (Overlay.find_next, sample_next, szudzik_pair): the oracle
"cuda" for tensors off the card raises; a kernel backend with a
factorized window width not a multiple of 128 raises (the reference's
guard), as does a corpus whose slot ids pass 2^32 - 1 (the in-kernel f
match is u32) for every backend but "ref".
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import pairing
from repro_torch.kernels import intersect
from repro_torch.kernels._launch import call, require
from repro_torch.kernels.delta import CHUNK, decode_rows_plain, packed_rows

BACKENDS = ("cuda", "torch", "ref")

_default_backend: Optional[str] = None   # None -> megakernel OFF

QUERY_SLAB = 4096   # lanes per plain FINDNEXT slab


def set_default_backend(name: Optional[str]) -> None:
    """Install the process-wide megakernel backend; None/"off"/"auto" all
    mean OFF (fusion is opt-in, as in the reference)."""
    global _default_backend
    if name in (None, "off", "auto"):
        _default_backend = None
        return
    if name not in BACKENDS:
        raise ValueError(f"unknown megakernel backend {name!r}; expected "
                         f"one of {BACKENDS + ('off', 'auto')}")
    _default_backend = name


def default_backend_request() -> Optional[str]:
    """The installed request (None = off)."""
    return _default_backend


def resolve_backend(name: Optional[str], device: torch.device) -> Optional[str]:
    """A request -> a backend, or None for OFF. "auto" consults the
    registry; "cuda" for tensors off the card raises."""
    if name in (None, "off"):
        return None
    if name == "auto":
        name = _default_backend
        if name is None:
            return None
    if name not in BACKENDS:
        raise ValueError(f"unknown megakernel backend {name!r}; expected "
                         f"one of {BACKENDS + ('off', 'auto')}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"megakernel backend 'cuda' needs tensors on the "
                         f"card, got {device}")
    return name


def check_supported(store, cfg, backend: str) -> None:
    """Refuse, never fall back: a megakernel is always asked for."""
    if backend == "ref":
        return
    if store.n_walks * store.length > 0xFFFFFFFF:
        raise ValueError(
            f"megakernel backend {backend!r} matches FINDNEXT targets in u32 "
            f"but n_walks*length = {store.n_walks * store.length} exceeds "
            f"2^32 - 1; use megakernel='off' or 'ref'")
    model = cfg.model
    if (backend == "cuda" and model.order == 2
            and model.sampler == "factorized" and model.dmax % intersect.LANES):
        raise ValueError(
            f"megakernel backend 'cuda' requires the factorized window "
            f"dmax % {intersect.LANES} == 0, got dmax={model.dmax}; use "
            f"'torch' (same math) for other widths")


# ------------------------------------------------------------ the step


class FusedStep(NamedTuple):
    """One step's per-lane operands ([B] unless noted)."""

    lo: torch.Tensor         # int64 pruned range [lo, hi) in the base store
    hi: torch.Tensor
    ft: torch.Tensor         # int64 slot f = w*l + p
    want: torch.Tensor       # int32 slot_epoch[f] (u32 bits)
    cur: torch.Tensor        # int64
    prev: torch.Tensor       # int64
    pend_nxt: torch.Tensor   # int64 the live pending entry's next, if hit
    pend_hit: torch.Tensor   # bool
    is_prefix: torch.Tensor  # bool p < p_min
    is_term: bool            # p == l - 1
    window: int              # K candidate chunks
    u: Optional[torch.Tensor] = None        # f32 [B, 2] (factorized)
    codes: Optional[torch.Tensor] = None    # int64 [E] the graph's CSR
    offsets: Optional[torch.Tensor] = None  # int32 [N+1] (factorized)
    dmax: int = 0                           # window width (factorized)
    ext_nxt: Optional[torch.Tensor] = None  # int64 (external mode)
    inv_p: float = 1.0       # f32 weights (intersect.inverse_weights)
    inv_q: float = 1.0

    @property
    def factorized(self) -> bool:
        return self.codes is not None


def findnext_hit_mask(pos, f, ep, lo, hi, ft, want):
    """The fused FINDNEXT verification: position inside the pruned range,
    slot match, live epoch."""
    return (pos >= lo) & (pos < hi) & (f == ft) & (ep == want)


def finalize_math(fn_v, fn_found, pend_hit, pend_nxt, samp, cur, is_prefix,
                  is_term: bool):
    """Per-lane step resolution: pending precedence, traverse's
    stay-in-place, the terminal self-pointer -> (nxt, nxt_eff)."""
    pfx = torch.where(pend_hit, pend_nxt, torch.where(fn_found, fn_v, cur))
    nxt = torch.where(is_prefix, pfx, samp)
    return nxt, (cur if is_term else nxt)


def _findnext_plain(store, lo, hi, ft, want, k: int):
    """First-hit-wins FINDNEXT over the K chunks from lo's (clipped to the
    store), slab by slab -> (v int64, found bool)."""
    n = lo.shape[0]
    v = torch.zeros((n,), dtype=torch.int64, device=lo.device)
    found = torch.zeros((n,), dtype=torch.bool, device=lo.device)
    ar_k = torch.arange(k, device=lo.device)
    ar_c = torch.arange(CHUNK, device=lo.device)
    for s in range(0, n, QUERY_SLAB):
        sl = slice(s, s + QUERY_SLAB)
        cidx = ((lo[sl] // CHUNK)[:, None] + ar_k[None]).clamp(0, store.n_chunks - 1)
        q = cidx.shape[0]
        codes = decode_rows_plain(store.packed, store.widths, store.anchors_hi,
                                  store.anchors_lo, cidx.reshape(-1))
        f, val = pairing.szudzik_unpair(codes.reshape(q, k, CHUNK))
        pos = cidx[:, :, None] * CHUNK + ar_c
        ep = store.epoch[pos.clamp(0, store.size - 1)]
        hit = findnext_hit_mask(pos, f, ep, lo[sl, None, None], hi[sl, None, None],
                                ft[sl, None, None], want[sl, None, None])
        chunk_hit = hit.any(-1)
        first = torch.argmax(chunk_hit.to(torch.int8), dim=1)
        sel = first[:, None, None].expand(q, 1, CHUNK)
        sel_hit = torch.gather(hit, 1, sel)[:, 0]
        sel_v = torch.gather(val, 1, sel)[:, 0]
        v[sl] = torch.where(sel_hit, sel_v, 0).amax(-1)
        found[sl] = chunk_hit.any(-1)
    return v, found


def fused_step_plain(store, s: FusedStep):
    """The plain version of the kernel -> (nxt int64 [B], code biased int64
    [B], overflow bool [B]). As the kernel, each lane computes only the
    stage it reads: the FINDNEXT for prefix lanes pending does not answer,
    the selection for emitting lanes, whose windows alone are built (the
    reference computes both everywhere and selects). `overflow` is deg >
    dmax of an emitting lane's cur or prev in factorized mode, else
    False."""
    fn_v = torch.zeros_like(s.cur)
    fn_found = torch.zeros_like(s.pend_hit)
    lanes = torch.nonzero(s.is_prefix & ~s.pend_hit).reshape(-1)
    if lanes.numel():
        fn_v[lanes], fn_found[lanes] = _findnext_plain(
            store, s.lo[lanes], s.hi[lanes], s.ft[lanes], s.want[lanes],
            s.window)
    overflow = torch.zeros_like(s.is_prefix)
    if s.factorized:
        samp = s.cur.clone()
        lanes = torch.nonzero(~s.is_prefix).reshape(-1)
        if lanes.numel():
            sn, sf, so = intersect.factorized_csr_plain(
                s.codes, s.offsets, s.cur[lanes], s.prev[lanes], s.u[lanes],
                s.dmax, s.inv_p, s.inv_q)
            samp[lanes] = torch.where(sf, sn, s.cur[lanes])
            overflow[lanes] = so
    else:
        samp = s.ext_nxt
    nxt, nxt_eff = finalize_math(fn_v, fn_found, s.pend_hit, s.pend_nxt, samp,
                                 s.cur, s.is_prefix, s.is_term)
    return nxt, pairing.szudzik_pair(s.ft, nxt_eff), overflow


def fused_step_cuda(store, s: FusedStep):
    """Launch the kernel (one warp per lane) -> (nxt, code, overflow)."""
    i64, i32 = torch.int64, torch.int32
    cols = [packed_rows(store.packed, "fused_rewalk_step")] + [
        require(t, i32, "fused_rewalk_step store")
        for t in (store.widths, store.anchors_hi, store.anchors_lo, store.epoch)]
    lane = [require(t, dt, "fused_rewalk_step lane operand") for t, dt in (
        (s.lo, i64), (s.hi, i64), (s.ft, i64), (s.want, i32), (s.cur, i64),
        (s.prev, i64), (s.pend_nxt, i64), (s.pend_hit, torch.bool),
        (s.is_prefix, torch.bool))]
    b = s.cur.shape[0]
    if any(t.shape != (b,) for t in lane):
        raise ValueError("fused_rewalk_step: per-lane operands must be [B]")
    u = codes = offsets = ext = 0
    if s.factorized:
        u = require(s.u, torch.float32, "fused_rewalk_step u")
        codes = require(s.codes, i64, "fused_rewalk_step codes")
        offsets = require(s.offsets, i32, "fused_rewalk_step offsets")
        if (u.shape != (b, 2) or codes.dim() != 1 or offsets.dim() != 1
                or not 1 <= s.dmax <= intersect.MAX_D):
            raise ValueError(f"fused_rewalk_step: u [B, 2], codes [E], offsets "
                             f"[N+1] and 1 <= dmax <= {intersect.MAX_D}")
    else:
        ext = require(s.ext_nxt, i64, "fused_rewalk_step ext_nxt")
        if ext.shape != (b,):
            raise ValueError("fused_rewalk_step: ext_nxt must be [B]")
    nxt = torch.empty((b,), dtype=i64, device=s.cur.device)
    code = torch.empty((b,), dtype=i64, device=s.cur.device)
    overflow = torch.empty((b,), dtype=torch.bool, device=s.cur.device)
    call("repro_fused_rewalk_step", s.cur.device, *cols, store.n_chunks,
         s.window, *lane, u, codes, offsets, ext, s.dmax, int(s.factorized),
         int(s.is_term), s.inv_p, s.inv_q, nxt, code, overflow, b)
    return nxt, code, overflow


# ------------------------------------------------------------- the scan


def fused_scan(key, graph, store, pending, walk_ids, lane_valid, p_min,
               v_at_pmin, cfg, backend: str, window: Optional[int] = None):
    """The fused replacement of `_rewalk`'s prefix traversal + sample loop
    -> (owners int32, codes int64, emits bool), each [capacity, l]: the
    unfused path's, bit for bit. `pending` holds the filled version blocks
    (or None)."""
    from repro_torch import random as jr
    from repro_torch._u64 import u32_value
    from repro_torch.core import packed_store
    from repro_torch.core.corpus import walk_start_vertex
    from repro_torch.core.overlay import Overlay
    from repro_torch.core.utils import seg_searchsorted
    from repro_torch.core.walkers import rejection_fallback, sample_next
    from repro_torch.kernels import ops

    dev = store.device
    length = store.length
    capacity = walk_ids.shape[0]
    model = cfg.model
    factorized = model.order == 2 and model.sampler == "factorized"
    k_chunks = window or packed_store.get_default_window()
    view = store if pending is None else Overlay.build(store, pending)
    inv_p, inv_q = intersect.inverse_weights(model.p, model.q)
    owners = torch.empty((capacity, length), dtype=torch.int32, device=dev)
    codes = torch.empty((capacity, length), dtype=torch.int64, device=dev)
    emits = torch.empty((capacity, length), dtype=torch.bool, device=dev)
    keys = jr.split(key, length)
    f_base = walk_ids * length
    cur = prev = walk_start_vertex(walk_ids, cfg.n_walks_per_vertex)
    for p in range(length):
        kp = keys[p]
        cur = torch.where(p_min == p, v_at_pmin, cur)
        is_prefix = p < p_min
        is_term = p == length - 1
        f = f_base + p
        if backend == "ref":
            nxt = cur
            if not is_term:   # the terminal step writes cur whatever nxt is
                fn_v, fn_found = view.find_next(cur, walk_ids,
                                                torch.full_like(walk_ids, p))
                samp = sample_next(kp, graph, cur, prev, model)
                nxt = torch.where(is_prefix, torch.where(fn_found, fn_v, cur),
                                  samp)
            code = ops.szudzik_pair(f, cur if is_term else nxt)
        else:
            # prologue: the pruned candidate range (paper §5.1) and the
            # pending lookup, as WalkStore.find_next / Overlay._pending_next,
            # for the prefix lanes, the only ones that read them (the
            # reference forms them for every lane; an empty range elsewhere)
            want = store.slot_epoch[f]
            lo, hi = torch.zeros_like(cur), torch.zeros_like(cur)
            pend_nxt, pend_hit = torch.zeros_like(cur), torch.zeros_like(is_prefix)
            lanes = torch.nonzero(is_prefix).reshape(-1)
            if lanes.numel():
                c, fl = cur[lanes], f[lanes]
                lb = ops.szudzik_pair(fl, u32_value(store.vmin[c]))
                ub = ops.szudzik_pair(fl, u32_value(store.vmax[c]))
                seg_lo, seg_hi = store.offsets[c], store.offsets[c + 1]
                lo[lanes] = seg_searchsorted(store.code, seg_lo, seg_hi, lb,
                                             side="left")
                hi[lanes] = seg_searchsorted(store.code, seg_lo, seg_hi, ub,
                                             side="right")
                if pending is not None:
                    pend_nxt[lanes], pend_hit[lanes] = view._pending_next(c, fl)
            c0 = lo // CHUNK
            over = (hi > lo) & ((torch.maximum(hi - 1, lo) // CHUNK - c0)
                                >= k_chunks)
            if factorized:
                k_u, k_fb = jr.split(kp)
                u = jr.uniform(k_u, (capacity, 2), torch.float32)
                extra = dict(u=u, codes=graph.codes, offsets=graph.offsets,
                             dmax=model.dmax, inv_p=inv_p, inv_q=inv_q)
            else:
                extra = dict(ext_nxt=sample_next(kp, graph, cur, prev, model))
            step = FusedStep(lo, hi, f, want, cur, prev, pend_nxt, pend_hit,
                             is_prefix, is_term, k_chunks, **extra)
            if backend == "cuda":
                nxt, code, overflow = ops.fused_rewalk_step(store, step)
            else:
                nxt, code, overflow = fused_step_plain(store, step)
            del step, extra
            # epilogue: the exceptional lanes, at a cost proportional to
            # their count
            changed = is_prefix & over
            lanes = torch.nonzero(changed).reshape(-1)
            if lanes.numel():
                o_out, o_found = store._scan_ref(lo[lanes], hi[lanes],
                                                 f[lanes], want[lanes])
                nxt[lanes] = torch.where(
                    pend_hit[lanes], pend_nxt[lanes],
                    torch.where(o_found, o_out, cur[lanes]))
            if factorized:
                nxt = rejection_fallback(k_fb, graph, cur, prev, overflow, nxt,
                                         model.p, model.q, model.n_trials)
                changed = changed | overflow
            lanes = torch.nonzero(changed).reshape(-1)
            if lanes.numel():
                eff = cur[lanes] if is_term else nxt[lanes]
                code[lanes] = ops.szudzik_pair(f[lanes], eff)
        owners[:, p] = cur.to(torch.int32)
        codes[:, p] = code
        emits[:, p] = lane_valid & (p >= p_min)
        cur, prev = (cur if is_term else nxt), cur
    return owners, codes, emits
