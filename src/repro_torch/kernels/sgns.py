"""Kernel 7: the fused skip-gram negative-sampling (SGNS) step (CUDA,
`csrc/sgns.cu`), its plain PyTorch version and the autograd oracle.

Port of `repro/kernels/sgns.py`. Per batch row, the u·v+ and u·v-_k
logits, the loss softplus(-pos) + Σ_k softplus(neg_k), and every input
gradient in one pass:

  u      [B, D]     center rows     (gathered)
  v_pos  [B, D]     context rows
  v_neg  [B, K, D]  negative rows
  ->
  loss   [B]        per-row loss
  du     [B, D]     dL/du
  dvp    [B, D]     dL/dv_pos
  dvn    [B, K, D]  dL/dv_neg

Backends (`sgns_apply`):
    "cuda"  — the CUDA kernel through `ops.sgns_step` (the card's default;
              the reference's "pallas"); any B >= 1 and D >= 1, and
              K <= MAX_K, beyond which it raises
    "torch" — `sgns_plain`, the closed form (the reference's `_sgns_math`)
              over the whole batch (the CPU default; the reference's
              "interpret")
    "ref"   — `torch.autograd` of `sgns_reference_loss` (the reference's
              "xla-ref"): the oracle the closed form is checked against
"auto" picks "cuda" for tensors on the card and "torch" for CPU tensors;
"cuda" for CPU tensors raises. The reference's B % 8 / D % 128 guard is a
Mosaic tiling rule that the CUDA kernel does not have, and no shape is
handed to the plain version in its place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._launch import call, require

ROWS = 8        # the reference's row tile: pair batches are padded to it
MAX_K = 16      # the kernel keeps K negative rows of a lane in registers

BACKENDS = ("cuda", "torch", "ref")

_default_backend: Optional[str] = None   # None -> by device


def set_default_backend(name: Optional[str]) -> None:
    """Install the process-wide SGNS backend (None/"auto": by device)."""
    global _default_backend
    if name in (None, "auto"):
        _default_backend = None
        return
    if name not in BACKENDS:
        raise ValueError(f"unknown sgns backend {name!r}; "
                         f"expected one of {BACKENDS + ('auto',)}")
    _default_backend = name


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """None/"auto" -> the registry's, else "cuda" on the card and "torch"
    on the CPU. "cuda" for tensors off the card raises."""
    name = _default_backend if name in (None, "auto") else name
    if name is None:
        return "cuda" if device.type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown sgns backend {name!r}; "
                         f"expected one of {BACKENDS + ('auto',)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"sgns backend 'cuda' needs tensors on the card, "
                         f"got {device}")
    return name


# ------------------------------------------------------------- plain math


def _softplus(x):
    """log(1 + e^x) as `jnp.logaddexp(0, x)`: stable at |x| ~ 100."""
    return torch.logaddexp(torch.zeros_like(x), x)


def sgns_plain(u, vp, vn):
    """The plain version of the kernel: the fused forward and closed-form
    backward (the reference's `_sgns_math`) over the whole batch: loss =
    -log σ(u·v+) - Σ log σ(-u·v-) and the three input gradients. The
    logits are elementwise products summed in f32, never a matmul, so no
    TF32 setting can reach them."""
    pos = (u * vp).sum(-1)                                  # [B]
    neg = (u[:, None, :] * vn).sum(-1)                      # [B, K]
    loss = _softplus(-pos) + _softplus(neg).sum(-1)
    gpos = -torch.sigmoid(-pos)
    gneg = torch.sigmoid(neg)
    du = gpos[:, None] * vp + (gneg[..., None] * vn).sum(1)
    dvp = gpos[:, None] * u
    dvn = gneg[..., None] * u[:, None, :]
    return loss, du, dvp, dvn


def sgns_reference_loss(u, vp, vn):
    """Per-row reference loss [B] (the "ref" forward)."""
    pos = (u * vp).sum(-1)
    neg = (u[:, None, :] * vn).sum(-1)
    logsig = torch.nn.functional.logsigmoid
    return -(logsig(pos) + logsig(-neg).sum(-1))


def _sgns_autograd(u, vp, vn):
    args = [t.detach().requires_grad_(True) for t in (u, vp, vn)]
    with torch.enable_grad():
        loss = sgns_reference_loss(*args)
        du, dvp, dvn = torch.autograd.grad(loss.sum(), args)
    return loss.detach(), du, dvp, dvn


# ------------------------------------------------------------------ kernel


def sgns_cuda(u, vp, vn):
    """Launch the kernel: u, vp f32 [B, D], vn f32 [B, K, D] on the card,
    B >= 1, D >= 1, 1 <= K <= MAX_K -> (loss [B], du, dvp, dvn)."""
    u = require(u, torch.float32, "sgns u")
    vp = require(vp, torch.float32, "sgns v_pos")
    vn = require(vn, torch.float32, "sgns v_neg")
    if u.dim() != 2 or vn.dim() != 3:
        raise ValueError(f"sgns: u [B, D] and v_neg [B, K, D], got "
                         f"{tuple(u.shape)} and {tuple(vn.shape)}")
    b, d = u.shape
    k = vn.shape[1]
    if vp.shape != (b, d) or vn.shape != (b, k, d):
        raise ValueError(f"sgns: shapes {tuple(u.shape)}, {tuple(vp.shape)}, "
                         f"{tuple(vn.shape)} do not agree")
    if b < 1 or d < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"sgns kernel: needs B >= 1, D >= 1 and "
                         f"1 <= K <= {MAX_K}, got B={b}, K={k}, D={d}")
    loss = torch.empty((b,), dtype=torch.float32, device=u.device)
    du = torch.empty_like(u)
    dvp = torch.empty_like(u)
    dvn = torch.empty_like(vn)
    call("repro_sgns_step", u.device, u, vp, vn, loss, du, dvp, dvn, b, k, d)
    return loss, du, dvp, dvn


# ---------------------------------------------------------------- dispatch


def sgns_apply(u, v_pos, v_neg, backend: Optional[str] = None):
    """One fused SGNS forward+backward on the resolved backend -> (loss
    [B], du, dvp, dvn)."""
    from repro_torch.kernels import ops
    backend = resolve_backend(backend, u.device)
    if backend == "cuda":
        return ops.sgns_step(u, v_pos, v_neg)
    if backend == "torch":
        return sgns_plain(u, v_pos, v_neg)
    return _sgns_autograd(u, v_pos, v_neg)
