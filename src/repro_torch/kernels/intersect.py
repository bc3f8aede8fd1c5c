"""Kernel 5: the exact factorized node2vec step (CUDA, `csrc/intersect.cu`),
its plain PyTorch versions, and the straight-line oracle.

Port of `repro/kernels/intersect.py`. The node2vec bias alpha(prev, x)
over the neighbors x of the current vertex v takes three values, so the
step is sampled exactly by groups:

    group 0  x == prev              weight 1/p
    group 1  x in N(prev), x!=prev  weight 1
    group 2  otherwise              weight 1/q

The group is picked by aggregate mass (count * weight, f32, in a fixed
order) with one uniform, then a member uniformly by rank with another.

Two forms of the inputs:
  * neighbor WINDOWS (`factorized_next`, the reference's API), nbrs_v /
    nbrs_p int64 [B, D]: the first min(deg, D) CSR neighbors of v and of
    prev (sorted), padded with SENT = 0xFFFFFFFF (`neighbor_window`).
    Windows are int64 values below 2^32, so SENT sorts last and each row
    stays sorted, the contract `member_sorted` needs.
  * the graph's CSR (`factorized_next_csr`, the samplers' entry): codes
    int64 [E] (biased edge codes; the dst is the low word), offsets int32
    [N+1], v and prev int64 [B], and the window width dmax. It also
    returns `overflow` = deg(v) > dmax | deg(prev) > dmax. On the card the
    kernel reads the two segments itself and no window is built; its plain
    version is `neighbor_window` twice, then `factorized_plain`.

Backends (both forms):
    "cuda"  — the CUDA kernel through `ops.intersect_next` /
              `ops.intersect_csr` (the card's default); windows of any
              width are padded to a multiple of 128, any dmax <= 1024 is
              taken
    "torch" — `_choose_math` over the whole batch with the binary-search
              membership (the CPU default)
    "ref"   — `_factorized_ref`, written straight-line (all-pairs
              membership, argmax rank-select): the oracle
All three take the same two uniforms per lane and agree bit for bit. An
explicit "cuda" request keeps the reference's tiling guard (D % 128 == 0,
dmax % 128 == 0) and raises for tensors off the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._launch import call, require
from repro_torch.kernels._observe import observed

LANES = 128          # the kernel's window alignment (the reference's tile)
MAX_D = 1024         # the kernel's widest window (32 entries a lane)
SENT = 0xFFFFFFFF    # window padding: never a vertex id

BACKENDS = ("cuda", "torch", "ref")

_default_backend: Optional[str] = None   # None -> by device


def set_default_backend(name: Optional[str]) -> None:
    """Install the process-wide intersect backend (None/"auto": by device)."""
    global _default_backend
    if name in (None, "auto"):
        _default_backend = None
        return
    if name not in BACKENDS:
        raise ValueError(f"unknown intersect backend {name!r}; "
                         f"expected one of {BACKENDS + ('auto',)}")
    _default_backend = name


def default_backend_request() -> Optional[str]:
    """The installed request, unresolved (None = auto)."""
    return _default_backend


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """None/"auto" -> the registry's, else "cuda" on the card and "torch"
    on the CPU. "cuda" for tensors off the card raises."""
    name = _default_backend if name in (None, "auto") else name
    if name is None:
        return "cuda" if device.type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown intersect backend {name!r}; "
                         f"expected one of {BACKENDS + ('auto',)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"intersect backend 'cuda' needs tensors on the "
                         f"card, got {device}")
    return name


def inverse_weights(p: float, q: float) -> tuple:
    """(1/p, 1/q) as the reference forms them: in float64, rounded once to
    float32 (python floats holding the f32 values)."""
    return float(np.float32(1.0 / p)), float(np.float32(1.0 / q))


# ------------------------------------------------------------- plain math


def neighbor_window(codes, offsets, v, dmax: int):
    """Sentinel-padded neighbor windows from the CSR (biased edge codes
    `codes`, int32 `offsets`): (int64 [B, dmax], deg int64 [B]), the first
    min(deg, dmax) neighbors of each vertex (sorted)."""
    v = v.to(torch.int64)
    start = offsets[v].to(torch.int64)
    deg = offsets[v + 1].to(torch.int64) - start
    col = torch.arange(dmax, device=v.device)
    idx = (start[:, None] + col[None]).clamp_(0, codes.shape[0] - 1)
    nbrs = codes[idx].bitwise_and_(0xFFFFFFFF)    # the low word: dst
    del idx
    nbrs.masked_fill_(col[None] >= deg.clamp(max=dmax)[:, None], SENT)
    return nbrs, deg


def _f32(x: float, device) -> torch.Tensor:
    """A weight as a 0-d f32 tensor, so that every product stays f32."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def member_allpairs(nbrs_v, nbrs_p):
    """Membership of each window-v entry in window-p: bool [R, D], by an
    all-pairs compare (no sortedness assumed; SENT matches SENT, callers
    mask it with the validity mask)."""
    return (nbrs_v[:, :, None] == nbrs_p[:, None, :]).any(-1)


def member_sorted(nbrs_v, nbrs_p):
    """The same booleans by a per-row binary search in the SORTED
    prev-window."""
    d = nbrs_p.shape[1]
    pos = torch.searchsorted(nbrs_p, nbrs_v).clamp(max=d - 1)
    return torch.gather(nbrs_p, 1, pos) == nbrs_v


def _choose_math(nbrs_v, valid, member, prev, u_group, u_rank, inv_p, inv_q):
    """Group-then-member selection (`intersect._choose_math`), row by row.

    nbrs_v int64 [R, D]; valid/member bool [R, D]; prev int64 [R, 1];
    u_group/u_rank f32 [R, 1]; inv_p/inv_q the f32 weights
    (`inverse_weights`). Returns (nxt int64 [R], found bool [R]). The f32
    operations are separate multiplies and adds in the reference's order,
    so every group pick resolves as there; the group id is clamped to the
    last non-empty group (u_group -> 1)."""
    inv_p, inv_q = _f32(inv_p, nbrs_v.device), _f32(inv_q, nbrs_v.device)
    is_prev = valid & (nbrs_v == prev)
    is_common = valid & member & ~is_prev
    is_far = valid & ~member & ~is_prev
    c0 = is_prev.sum(1, keepdim=True)
    c1 = is_common.sum(1, keepdim=True)
    c2 = is_far.sum(1, keepdim=True)
    m0 = c0.to(torch.float32) * inv_p
    m1 = c1.to(torch.float32)
    m2 = c2.to(torch.float32) * inv_q
    t = u_group * ((m0 + m1) + m2)
    grp = (t >= m0).to(torch.int64) + (t >= m0 + m1).to(torch.int64)
    last = torch.where(c2 > 0, 2, torch.where(c1 > 0, 1, 0))
    grp = torch.minimum(grp, last)
    cg = torch.where(grp == 0, c0, torch.where(grp == 1, c1, c2))
    r = torch.minimum((u_rank * cg.to(torch.float32)).to(torch.int64), cg - 1)
    cls = torch.where(grp == 0, is_prev, torch.where(grp == 1, is_common,
                                                     is_far))
    rank = torch.cumsum(cls, dim=1)
    hit = cls & (rank == r + 1)
    nxt = torch.where(hit, nbrs_v, 0).amax(dim=1)
    found = (c0 + c1 + c2)[:, 0] > 0
    return nxt, found


@observed("intersect_next")
def factorized_plain(nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p, inv_q):
    """The plain version of the kernel: `_choose_math` over the whole batch
    with the binary-search membership -> (nxt int64 [B], found bool [B])."""
    valid = nbrs_v != SENT
    member = member_sorted(nbrs_v, nbrs_p)
    return _choose_math(nbrs_v, valid, member, prev.reshape(-1, 1),
                        u_group.reshape(-1, 1), u_rank.reshape(-1, 1),
                        inv_p, inv_q)


@observed("intersect_csr", args_of=lambda a: a[1:])
def _factorized_csr(choose, codes, offsets, v, prev, u, dmax, inv_p, inv_q):
    """`choose` (factorized_plain or _factorized_ref) on the windows of v
    and prev -> (nxt, found, overflow)."""
    nbrs_v, deg_v = neighbor_window(codes, offsets, v, dmax)
    nbrs_p, deg_p = neighbor_window(codes, offsets, prev, dmax)
    nxt, found = choose(nbrs_v, nbrs_p, prev, u[:, 0], u[:, 1], inv_p, inv_q)
    return nxt, found, (deg_v > dmax) | (deg_p > dmax)


def factorized_csr_plain(codes, offsets, v, prev, u, dmax: int, inv_p, inv_q):
    """The plain version of the CSR kernel: the windows of v and prev, then
    `factorized_plain` -> (nxt int64 [B], found bool [B], overflow bool
    [B])."""
    return _factorized_csr(factorized_plain, codes, offsets, v, prev, u, dmax,
                           inv_p, inv_q)


def _factorized_ref(nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p, inv_q):
    """The oracle, straight-line and independent of the helpers above:
    all-pairs membership, argmax rank-select."""
    f32 = torch.float32
    inv_p, inv_q = _f32(inv_p, nbrs_v.device), _f32(inv_q, nbrs_v.device)
    valid = nbrs_v != SENT
    member = (nbrs_v[:, :, None] == nbrs_p[:, None, :]).any(-1)
    is_prev = valid & (nbrs_v == prev[:, None])
    is_common = valid & member & ~is_prev
    is_far = valid & ~member & ~is_prev
    c0, c1, c2 = is_prev.sum(1), is_common.sum(1), is_far.sum(1)
    m0 = c0.to(f32) * inv_p
    m1 = c1.to(f32)
    m2 = c2.to(f32) * inv_q
    t = u_group.to(f32) * ((m0 + m1) + m2)
    grp = (t >= m0).to(torch.int64) + (t >= m0 + m1).to(torch.int64)
    grp = torch.minimum(grp, torch.where(c2 > 0, 2, torch.where(c1 > 0, 1, 0)))
    cg = torch.where(grp == 0, c0, torch.where(grp == 1, c1, c2))
    r = torch.minimum((u_rank.to(f32) * cg.to(f32)).to(torch.int64), cg - 1)
    g = grp[:, None]
    cls = torch.where(g == 0, is_prev, torch.where(g == 1, is_common, is_far))
    rank = torch.cumsum(cls.to(torch.int64), dim=1)
    idx = torch.argmax(((rank == (r + 1)[:, None]) & cls).to(torch.int8), dim=1)
    nxt = torch.gather(nbrs_v, 1, idx[:, None])[:, 0]
    found = (c0 + c1 + c2) > 0
    return torch.where(found, nxt, 0), found


# ------------------------------------------------------------------ kernel


def factorized_cuda(nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p: float,
                    inv_q: float):
    """Launch the kernel: windows int64 [B, D] with D % 128 == 0; prev
    int64 [B]; uniforms f32 [B]; inv_p/inv_q the f32 weights (python
    floats of f32 values) -> (nxt int64 [B], found bool [B])."""
    nbrs_v = require(nbrs_v, torch.int64, "intersect nbrs_v")
    nbrs_p = require(nbrs_p, torch.int64, "intersect nbrs_p")
    b, d = nbrs_v.shape
    if nbrs_p.shape != (b, d) or d % LANES:
        raise ValueError(f"intersect: windows must be [B, D] with D % "
                         f"{LANES} == 0, got {tuple(nbrs_v.shape)} and "
                         f"{tuple(nbrs_p.shape)}")
    prev = require(prev, torch.int64, "intersect prev")
    u_group = require(u_group, torch.float32, "intersect u_group")
    u_rank = require(u_rank, torch.float32, "intersect u_rank")
    nxt = torch.empty((b,), dtype=torch.int64, device=nbrs_v.device)
    found = torch.empty((b,), dtype=torch.bool, device=nbrs_v.device)
    call("repro_intersect_next", nbrs_v.device, nbrs_v, nbrs_p, prev, u_group,
         u_rank, inv_p, inv_q, nxt, found, b, d)
    return nxt, found


def factorized_csr_cuda(codes, offsets, v, prev, u, dmax: int, inv_p: float,
                        inv_q: float):
    """Launch the CSR kernel: codes int64 [E], offsets int32 [N+1], v and
    prev int64 [B], u f32 [B, 2], 1 <= dmax <= 1024 -> (nxt int64 [B],
    found bool [B], overflow bool [B])."""
    codes = require(codes, torch.int64, "intersect_csr codes")
    offsets = require(offsets, torch.int32, "intersect_csr offsets")
    v = require(v, torch.int64, "intersect_csr v")
    prev = require(prev, torch.int64, "intersect_csr prev")
    u = require(u, torch.float32, "intersect_csr u")
    b = v.shape[0]
    if (codes.dim() != 1 or offsets.dim() != 1 or v.shape != (b,)
            or prev.shape != (b,) or u.shape != (b, 2)):
        raise ValueError("intersect_csr: codes [E], offsets [N+1], v and prev "
                         "[B], u [B, 2]")
    if not 1 <= dmax <= MAX_D:
        raise ValueError(f"intersect_csr: dmax must be in [1, {MAX_D}], got "
                         f"{dmax}")
    nxt = torch.empty((b,), dtype=torch.int64, device=v.device)
    found = torch.empty((b,), dtype=torch.bool, device=v.device)
    overflow = torch.empty((b,), dtype=torch.bool, device=v.device)
    call("repro_intersect_csr", v.device, codes, offsets, v, prev, u, dmax,
         inv_p, inv_q, nxt, found, overflow, b)
    return nxt, found, overflow


def pad_windows(nbrs_v, nbrs_p):
    """Pad windows to a multiple of LANES columns with SENT (never a member,
    never valid), which leaves every selection unchanged."""
    pad = (-nbrs_v.shape[1]) % LANES
    if pad:
        nbrs_v = torch.nn.functional.pad(nbrs_v, (0, pad), value=SENT)
        nbrs_p = torch.nn.functional.pad(nbrs_p, (0, pad), value=SENT)
    return nbrs_v, nbrs_p


# ---------------------------------------------------------------- dispatch


def factorized_next(nbrs_v, nbrs_p, prev, u_group, u_rank, p: float,
                    q: float, backend: Optional[str] = None):
    """One exact group-factorized node2vec selection per row -> (nxt int64
    [B], found bool [B]); found=False (isolated v) leaves the caller to
    keep the walker in place. An explicit "cuda" request on windows whose
    width is not a multiple of 128 raises (the reference's tiling guard);
    the automatic pick pads them instead."""
    from repro_torch.kernels import ops
    explicit = backend not in (None, "auto")
    backend = resolve_backend(backend, nbrs_v.device)
    inv_p, inv_q = inverse_weights(p, q)
    if backend == "cuda":
        if explicit and nbrs_v.shape[1] % LANES:
            raise ValueError(
                f"intersect backend 'cuda' requires D % {LANES} == 0, got "
                f"D={nbrs_v.shape[1]}; use backend='auto' to pad")
        return ops.intersect_next(nbrs_v, nbrs_p, prev, u_group, u_rank,
                                  inv_p, inv_q)
    if backend == "torch":
        return factorized_plain(nbrs_v, nbrs_p, prev, u_group, u_rank,
                                inv_p, inv_q)
    return _factorized_ref(nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p,
                           inv_q)


def factorized_next_csr(codes, offsets, v, prev, u, dmax: int, p: float,
                        q: float, backend: Optional[str] = None):
    """The exact step from the graph's CSR: codes int64 [E], offsets int32
    [N+1], v and prev int64 [B], u f32 [B, 2] (u_group, u_rank) -> (nxt
    int64 [B], found bool [B], overflow bool [B]). "cuda" launches the
    kernel, which reads the segments itself; the other backends build the
    windows of v and prev (`neighbor_window`). An explicit "cuda" request
    with dmax % 128 != 0 raises (the reference's tiling guard); the
    automatic pick takes any dmax <= 1024."""
    from repro_torch.kernels import ops
    explicit = backend not in (None, "auto")
    backend = resolve_backend(backend, v.device)
    inv_p, inv_q = inverse_weights(p, q)
    if backend == "cuda":
        if explicit and dmax % LANES:
            raise ValueError(
                f"intersect backend 'cuda' requires dmax % {LANES} == 0, got "
                f"dmax={dmax}; use backend='auto'")
        return ops.intersect_csr(codes, offsets, v, prev, u, dmax, inv_p,
                                 inv_q)
    choose = factorized_plain if backend == "torch" else _factorized_ref
    return _factorized_csr(choose, codes, offsets, v, prev, u, dmax, inv_p,
                           inv_q)
