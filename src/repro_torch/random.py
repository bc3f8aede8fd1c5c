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


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` with the int64 dtype
    the reference draws under x64, for each key of `key` ([..., 2]) ->
    int64 tensor [..., *shape] on the key's device.

    Two 64-bit words per element (`higher_bits`, `lower_bits`) and
    unsigned 64-bit remainders by the span, as `jax._src.random._randint`.
    torch has no unsigned remainder, so each 64-bit word is reduced from its
    32-bit halves: (H*2^32 + L) mod s = ((H mod s)(2^32 mod s) + L mod s)
    mod s. Requires span < 2^31 (it is a vertex degree), so no product
    exceeds 2^62.
    """
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
