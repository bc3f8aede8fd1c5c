"""Kernels 1 and 2: batched Szudzik pair / unpair (CUDA, `csrc/szudzik.cu`).

Port of the Pallas kernels `repro/kernels/szudzik.py` (`_pair_kernel`,
`_unpair_kernel`). The plain PyTorch versions are those of
`core/pairing.py`, re-exported here so that each kernel sits beside its
plain version; `kernels/ops.py` picks one by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.pairing import szudzik_pair as pair_plain  # noqa: F401
from repro_torch.core.pairing import szudzik_unpair as unpair_plain  # noqa: F401
from repro_torch.kernels._launch import call, require


def pair_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64 operands < 2^32 (same shape) -> biased int64 codes."""
    if x.shape != y.shape:
        raise ValueError(f"szudzik_pair: shapes {tuple(x.shape)} != {tuple(y.shape)}")
    x = require(x, torch.int64, "szudzik_pair x")
    y = require(y, torch.int64, "szudzik_pair y")
    out = torch.empty_like(x)
    call("repro_szudzik_pair", x.device, x, y, out, x.numel())
    return out


def unpair_cuda(z: torch.Tensor):
    """biased int64 codes -> (x, y) int64."""
    z = require(z, torch.int64, "szudzik_unpair z")
    x = torch.empty_like(z)
    y = torch.empty_like(z)
    call("repro_szudzik_unpair", z.device, z, x, y, z.numel())
    return x, y
