"""Szudzik pairing / unpairing and walk-triplet encoding (paper §2, §4.2-4.3).

Port of `repro/core/pairing.py` in the biased-int64 code representation
(`repro_torch._u64`). These are the plain PyTorch versions; on the card the
main path runs the CUDA kernels of `kernels/szudzik.py` through
`kernels/ops.py`, which are held bit-exact against these.

    f(w, p) = w * l + p
    code    = Szudzik(f, v_next) = v^2 + f        if f <  v
                                 = f^2 + f + v    if f >= v

Operands are int64 values in [0, 2^32); codes are biased int64.
"""
from __future__ import annotations

import torch

from repro_torch._u64 import BIAS, M32, bias, hi32, join, lo32

_MAX_ROOT = M32


def _ule(a_raw, b_raw):
    """Unsigned a <= b for u64 bits held in int64 (raw, not biased)."""
    return (a_raw ^ BIAS) <= (b_raw ^ BIAS)


def isqrt_u64(z: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(z)) of biased u64 codes -> int64 in [0, 2^32).

    A float64 seed is within one of the root for every u64; two integer
    corrections each way make it exact, and the clamp at 2^32-1 keeps the
    square from wrapping (isqrt(2^64-1) = 2^32-1)."""
    raw = z ^ BIAS
    # from the halves: the biased value itself loses small z to rounding
    zf = hi32(z).to(torch.float64) * 2.0 ** 32 + lo32(z).to(torch.float64)
    r = torch.sqrt(zf).floor().clamp(0, float(_MAX_ROOT)).to(torch.int64)
    for _ in range(2):   # r*r > z -> r - 1   (r <= 2^32-1: r*r cannot wrap)
        r = torch.where(_ule(r * r, raw) | (r == 0), r, r - 1)
    for _ in range(2):   # (r+1)^2 <= z -> r + 1
        r1 = r + 1
        r = torch.where((r1 <= _MAX_ROOT) & _ule(r1 * r1, raw), r1, r)
    return r


def szudzik_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Szudzik(x, y) of int64 operands < 2^32 -> biased int64 code."""
    x = torch.as_tensor(x, dtype=torch.int64)
    y = torch.as_tensor(y, dtype=torch.int64, device=x.device)
    return bias(torch.where(x < y, y * y + x, x * x + x + y))


def szudzik_unpair(z: torch.Tensor):
    """Inverse of szudzik_pair: biased code -> (x, y) int64."""
    s = isqrt_u64(z)
    rem = (z ^ BIAS) - s * s      # exact: 0 <= rem <= 2s < 2^33
    lt = rem < s
    return torch.where(lt, rem, s), torch.where(lt, s, rem - s)


def pack_wp(w, p, length: int):
    """f(w, p) = w * l + p (paper §4.3)."""
    return torch.as_tensor(w, dtype=torch.int64) * length + torch.as_tensor(
        p, dtype=torch.int64)


def unpack_wp(f, length: int):
    return f // length, f % length


def encode_triplet(w, p, v_next, length: int):
    return szudzik_pair(pack_wp(w, p, length), v_next)


def decode_triplet(code, length: int):
    f, v_next = szudzik_unpair(code)
    w, p = unpack_wp(f, length)
    return w, p, v_next


def search_range(f, v_min, v_max):
    """FINDNEXT search bounds [lb, ub] (paper §5.1)."""
    return szudzik_pair(f, v_min), szudzik_pair(f, v_max)


def split_u64(code):
    """biased code -> (hi, lo) as non-negative int64 (the JAX kernels'
    (hi, lo) u32 lane pair)."""
    return hi32(code), lo32(code)


def join_u64(hi, lo):
    return join(hi, lo)
