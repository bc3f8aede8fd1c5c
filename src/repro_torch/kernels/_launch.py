"""Shared launch plumbing for the ctypes-bound CUDA kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry point `name` on `device`'s current stream with
    `args` (tensors pass their data pointer, ints pass as they are), and
    raise if the launch was refused. The stream comes from PyTorch's
    raw-stream getter: a `torch.cuda.Stream` object for `.cuda_stream`
    costs more host time than a small kernel runs. The current device is
    switched only when `device` is another one."""
    fn = getattr(_build.lib(), name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*conv, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*conv, torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, name)


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """Check a kernel operand's type and device; make it contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    return t.contiguous()
