"""The port's representation of unsigned integers in torch tensors.

torch has no usable unsigned 64-bit type (no `+`, `<`, `>>`, `searchsorted`
or `scatter_reduce` on `uint64`), so:

* a u64 code (Szudzik walk code, graph edge code `src << 32 | dst`) is a
  `torch.int64` holding the u64 bits XOR 2^63 (the "biased" form). Signed
  compare, `sort` and `searchsorted` on the biased form give unsigned order.
  The u64 value 2^64-1 (the graph's SENTINEL) is INT64_MAX.
  Wrapping int64 `+`, `-` and `*` on the raw bits (`biased ^ BIAS`) are the
  u64 operations mod 2^64; a difference of two biased codes is the u64
  difference directly (the bias cancels).
* a u32 column (owner, epoch, slot_epoch, widths, packed words, anchor
  halves, vmin/vmax) is a `torch.int32` holding the same 32 bits, so the
  JAX package's PAD_EPOCH 0xFFFFFFFF is -1 here. Read the value back with
  `u32_value` before any order-dependent use.
"""
from __future__ import annotations

import numpy as np
import torch

BIAS = -(1 << 63)            # XOR with this flips bit 63
INT64_MAX = (1 << 63) - 1    # biased form of u64 2^64-1
M32 = 0xFFFFFFFF


def bias(raw: torch.Tensor) -> torch.Tensor:
    """u64 bits held in an int64 -> biased code (and back: it is an XOR)."""
    return raw ^ BIAS


unbias = bias


def hi32(code: torch.Tensor) -> torch.Tensor:
    """High 32 bits of a biased code, as a non-negative int64."""
    return ((code ^ BIAS) >> 32) & M32


def lo32(code: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of a biased code, as a non-negative int64."""
    return code & M32


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 halves (any int dtype) -> biased int64 code."""
    return bias((u32_value(hi) << 32) | u32_value(lo))


def u32_value(x: torch.Tensor) -> torch.Tensor:
    """u32 bits in an int32/int64 tensor -> their non-negative int64 value."""
    return x.to(torch.int64) & M32


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) (or any int64, taken mod 2^32) -> int32
    holding the same 32 bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


# ------------------------------------------------------------ numpy bridges


def from_u64_numpy(a, device=None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64) ^ np.int64(BIAS)).to(device)


def to_u64_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.detach().cpu().numpy().astype(np.int64) ^ np.int64(BIAS)).view(np.uint64)


def from_u32_numpy(a, device=None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_u32_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.detach().cpu().numpy().astype(np.int64) & M32).astype(np.uint32)
