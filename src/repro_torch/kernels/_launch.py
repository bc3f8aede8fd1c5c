"""Shared launch plumbing for the ctypes-bound CUDA kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry point `name` on `device`'s current stream with
    `args` (tensors pass their data pointer, ints pass as they are), and
    raise if the launch was refused."""
    fn = getattr(_build.lib(), name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(fn(*conv, stream), name)


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """Check a kernel operand's type and device; make it contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    return t.contiguous()
