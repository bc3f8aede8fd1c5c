"""threefry2x32 keys and draws, bit-identical to `jax.random` as the
reference runs it (jax 0.9 with `jax_threefry_partitionable=True`, x64 on).

A key is an int64 tensor of shape [..., 2] holding two u32 words. There is
no global generator state: every draw takes its key explicitly, as in JAX.
All arithmetic is int64 on values in [0, 2^32), masked after each add.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._u64 import M32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k0, k1); all broadcastable int64 tensors in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the 64-bit seed split into two words."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def as_key(key, device) -> torch.Tensor:
    """A key from JAX (uint32 array), numpy or torch -> int64 [..., 2]."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    arr = np.asarray(key).astype(np.int64) & M32
    return torch.from_numpy(arr).to(device)


def _iota_bits(key: torch.Tensor, n: int):
    """threefry of the flat counters 0..n-1 under every key of `key`
    ([..., 2]) -> two int64 tensors [..., n] (the partitionable layout:
    counter hi word 0, lo word the index)."""
    if n >= 1 << 32:
        raise ValueError("random_bits: more than 2^32 counters")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for each key of `key` ([..., 2]) ->
    int64 [..., num, 2]."""
    b0, b1 = _iota_bits(key, num)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for u32 `data` of any shape that
    broadcasts against the key batch: one key [2] and data [B] give [B, 2],
    as `jax.vmap(lambda d: fold_in(key, d))(data)`."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def _draw_shape(key: torch.Tensor, shape) -> tuple:
    """Keys [..., 2] draw `shape` each: the result is key batch + shape,
    the draw of `jax.vmap` over the key batch."""
    return tuple(key.shape[:-1]) + tuple(shape)


def randint(key: torch.Tensor, shape, minval, maxval,
            dtype=torch.int64) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, dtype)` for each key
    of `key` ([..., 2]) -> a `dtype` tensor [..., *shape] on the key's
    device. int64 is the reference's default under x64; int32 is the
    maintainer's draw of negatives (`dtype=I32`), which consumes other
    bits: one 32-bit word per element from each of the two subkeys.

    Both follow `jax._src.random._randint`: a higher and a lower word per
    element, and unsigned remainders by the span. torch has no unsigned
    remainder, so a 64-bit word is reduced from its 32-bit halves:
    (H*2^32 + L) mod s = ((H mod s)(2^32 mod s) + L mod s) mod s, which
    needs span < 2^31 (it is a vertex degree or a vertex count). The
    32-bit draw keeps the reference's u32 arithmetic, wrap-around
    included.
    """
    if dtype == torch.int32:
        return _randint32(key, shape, minval, maxval)
    if dtype != torch.int64:
        raise TypeError(f"randint: int32 or int64, got {dtype}")
    full = _draw_shape(key, shape)
    batch = full[:len(full) - len(tuple(shape))]
    n = math.prod(tuple(shape))
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    ks = split(key, 2)
    span = torch.broadcast_to(maxval - minval, full).reshape(batch + (n,))
    span = torch.where(torch.broadcast_to(maxval <= minval, full)
                       .reshape(batch + (n,)), torch.ones_like(span), span)
    t32 = torch.remainder(torch.full_like(span, 1 << 32), span)
    mult = (t32 * t32) % span

    def word_mod(k):
        h, l = _iota_bits(k, n)
        return ((h % span) * t32 + l % span) % span

    offset = (word_mod(ks[..., 0, :]) * mult + word_mod(ks[..., 1, :])) % span
    return torch.broadcast_to(minval, full) + offset.reshape(full)


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors in [0, 2^32), without an int64
    overflow: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _randint32(key, shape, minval, maxval):
    """`randint` with dtype int32: bounds clipped to int32, u32 words
    bits1 ^ bits2, the span one larger where maxval lies above the int32
    range, and u32 products that wrap."""
    dev = key.device
    full = _draw_shape(key, shape)
    batch = full[:len(full) - len(tuple(shape))]
    n = math.prod(tuple(shape))
    i32 = torch.iinfo(torch.int32)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    out_of_range = maxval > i32.max
    maxval = maxval.clamp(i32.min, i32.max)
    minval = minval.clamp(i32.min, i32.max)

    def flat(t):
        return torch.broadcast_to(t, full).reshape(batch + (n,))

    span = flat((maxval - minval) & M32)
    span = torch.where(flat(maxval <= minval), 1, span)
    span = torch.where(flat(out_of_range & (maxval > minval)),
                       (span + 1) & M32, span)
    # a span of 2^32 wraps to 0, and x rem 0 is x (XLA's unsigned rem)
    nonzero = span != 0
    safe = torch.where(nonzero, span, 1)

    def rem(x):
        return torch.where(nonzero, x % safe, x)

    mult = rem(torch.full_like(span, 1 << 16))
    mult = rem(_mul32(mult, mult))
    ks = split(key, 2)
    words = []
    for j in range(2):
        b1, b2 = _iota_bits(ks[..., j, :], n)
        words.append(b1 ^ b2)
    offset = rem((_mul32(rem(words[0]), mult) + rem(words[1])) & M32)
    out = (flat(minval) + offset + (1 << 31)) & M32   # int32 add, wrapped
    return (out - (1 << 31)).to(torch.int32).reshape(full)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype)` on [0, 1), for each key of
    `key` ([..., 2]) -> [..., *shape].

    The mantissa of 1.0 is filled from the top random bits (32-bit:
    bits1 ^ bits2 of the counter's threefry; 64-bit: bits1 << 32 | bits2)
    and 1.0 is subtracted, as `jax._src.random._uniform`; the scale by
    (1 - 0) and the max with 0 change no value."""
    full = _draw_shape(key, shape)
    n = math.prod(tuple(shape))
    b1, b2 = _iota_bits(key, n)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        out = bits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        out = bits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform: float32 or float64, got {dtype}")
    return out.reshape(full)


# XLA's float32 erf_inv (the chlo decomposition): Giles' single-precision
# polynomial in w = -log1p(-x^2), one coefficient set below w = 5 and one
# above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 by the polynomial XLA lowers `lax.erf_inv` to, in its
    order of operations (separate multiplies and adds). The log1p and sqrt
    are taken in float64 and rounded once to float32: the sqrt is then
    IEEE-exact, as XLA's (torch's float32 CPU sqrt is not), and the log1p
    within an ulp of exact, where XLA uses its own approximation; so
    results may differ from the reference by a few ulp
    (tests/test_torch_random.py states the bound)."""
    f32, f64 = torch.float32, torch.float64
    w = -torch.log1p((x * -x).to(f64)).to(f32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(f64)).to(f32) - 3.0)
    coef = [torch.where(lt, torch.tensor(a, dtype=f32, device=x.device),
                        torch.tensor(b, dtype=f32, device=x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)` for each key of `key`
    ([..., 2]): sqrt(2) * erf^-1(u), u uniform on [nextafter(-1, 0), 1)
    as `jax._src.random._normal_real` draws it (the mantissa bits of
    `uniform`, scaled by (hi - lo), which rounds to 2, and shifted by lo).
    Within a few ulp of the reference (see `erfinv32`)."""
    if dtype != torch.float32:
        raise TypeError(f"normal: float32 only, got {dtype}")
    f32 = torch.float32
    full = _draw_shape(key, shape)
    b1, b2 = _iota_bits(key, math.prod(tuple(shape)))
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(f32) - 1.0
    lo = torch.tensor(np.nextafter(np.float32(-1), np.float32(0)), dtype=f32,
                      device=key.device)
    hi = torch.tensor(1.0, dtype=f32, device=key.device)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=f32, device=key.device)
    return (sqrt2 * erfinv32(u)).reshape(full)
