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


def _unit_floats(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The [0, 1) floats of `jax._src.random._uniform`: the mantissa of
    1.0 filled from the top random bits (32-bit: bits1 ^ bits2 of the
    counter's threefry; 64-bit: bits1 << 32 | bits2), less 1.0."""
    full = _draw_shape(key, shape)
    b1, b2 = _iota_bits(key, math.prod(tuple(shape)))
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        out = bits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        out = bits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform: float32 or float64, got {dtype}")
    return out.reshape(full)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` for each key
    of `key` ([..., 2]) -> [..., *shape]; `minval`/`maxval` are scalars or
    tensors that broadcast against `shape`.

    As `jax._src.random._uniform`: the [0, 1) floats scaled as
    `floats * (maxval - minval) + minval`, which XLA's CPU backend
    contracts into one FMA (`fma32` / `fma64`), then the max with minval.
    On [0, 1) the scale changes no value and is skipped."""
    floats = _unit_floats(key, shape, dtype)
    if isinstance(minval, (int, float)) and isinstance(maxval, (int, float)) \
            and (minval, maxval) == (0, 1):
        return floats
    lo = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    fma = fma32 if dtype == torch.float32 else fma64
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def gumbel(key: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, dtype)` in its default mode "low":
    -log(-log(u)), u uniform on [finfo.tiny, 1). float64 is the reference's
    default under x64.

    The uniforms are bit for bit. float32's logs are XLA's own (`_log32`);
    float64's are torch's, which differ from XLA's in the last bit for a
    few draws in a thousand: an argmax over these values (`categorical`)
    changes only where two candidates lie within an ulp or two, ~1e-16
    relative a draw."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, dtype, minval=tiny, maxval=1.0)
    if dtype == torch.float32:
        return -_log32(-_log32(u))
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape=None) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1, shape)` with
    replacement: argmax over the last axis of gumbel noise of shape
    `shape + (k,)` plus the logits (their dtype), the first index on ties
    -> int64 [..., *shape] for each key of `key`."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"categorical: shape {shape} does not end in the "
                         f"logits' batch shape {batch}")
    noise = gumbel(key, shape + (logits.shape[-1],), logits.dtype)
    return torch.argmax(noise + logits, dim=-1)


def bernoulli(key: torch.Tensor, p=0.5, shape=None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (mode "low"): uniform of p's
    dtype < p. A Python float p is float64, as under x64."""
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(p, dtype=torch.float64)
    p = p.to(key.device)
    shape = tuple(p.shape) if shape is None else tuple(shape)
    return uniform(key, shape, p.dtype) < p


# XLA's float32 erf_inv (the chlo decomposition): Giles' single-precision
# polynomial in w = -log1p(-x^2), one coefficient set below w = 5 and one
# above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

# XLA's f32 log1p (ElementalIrEmitter::EmitLog1p): a Cephes rational
# x + (-x^2/2 + x^3 * N(x)/D(x)) for |x| < sqrt(2) - 1, else log(1 + x)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# and its f32 log (the Cephes logf polynomial XLA's CPU backend inlines):
# three interleaved Horner chains in the reduced mantissa, then the
# exponent's two-part ln 2
_LOG_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
          (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
          (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LN2_LO, _LN2_HI = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
_FLT_MIN = 1.17549435e-38


def _two_sum(a, b):
    """a + b rounded, and its exact error (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s, err):
    """s + err rounded to odd, for s = RN(x + y) and err its exact error:
    an inexact sum whose last bit is even steps once away from s towards
    err. Rounding that once more to nearest rounds x + y only once."""
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(odd, bits + step, bits).view(torch.float64)


def fma32(a, b, c):
    """float32 fused multiply-add a*b + c, rounded once, from float64 ops
    (the same on the CPU and the card): the f32 product is exact in f64,
    the sum is rounded to odd (TwoSum's error term fixes the last bit), and
    rounding that to f32 is the correctly rounded FMA. A plain f64 sum
    rounded twice is not: it misses where the f64 sum lands on an f32 tie.
    XLA's CPU backend contracts a multiply feeding a single add into an
    FMA, so the reference's float32 math needs it where it does so."""
    f64 = torch.float64
    p = a.to(f64) * b.to(f64)
    c = torch.as_tensor(c, dtype=f64, device=p.device)
    return _round_odd(*_two_sum(p, c)).to(torch.float32)


_SPLITTER = 134217729.0   # 2^27 + 1: Veltkamp's split of a double


def _split(a):
    t = a * _SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def fma64(a, b, c):
    """float64 fused multiply-add a*b + c, rounded once (Boldo and
    Melquiond's emulation): the product exactly as hi + lo (Dekker), then
    RN(th + RO(tl + lo)) with (th, tl) = TwoSum(c, hi). Exact for operands
    whose product neither overflows nor underflows (|a|, |b| < 2^996 here:
    uniform's [0, 1) floats and span)."""
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    hi = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, hi)
    return th + _round_odd(*_two_sum(tl, lo))


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _log32(a):
    """XLA's f32 log of a normal float a > 0 (1 + x >= 2^-24 in log1p,
    gumbel's uniforms and their logs; never 0, inf or NaN): the mantissa
    reduced to [sqrt(1/2) - 1, sqrt(2) - 1), the polynomial with FMA where
    XLA's CPU code contracts it."""
    f32 = torch.float32
    bits = torch.maximum(a, _f32(_FLT_MIN, a)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    low = m < _f32(_SQRT_HALF, a)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(f32)
    x2 = x * x
    x3 = x2 * x
    y0, y1, y2 = (fma32(x, _f32(c0, a), _f32(c1, a)) for c0, c1, _ in _LOG_P)
    y0, y1, y2 = (fma32(y, x, _f32(c2, a))
                  for y, (_, _, c2) in zip((y0, y1, y2), _LOG_P))
    y = fma32(fma32(y0, x3, y1), x3, y2)
    y = fma32(y, x3, e * _f32(_LN2_LO, a))
    return ((x - x2 * 0.5) + y) + e * _f32(_LN2_HI, a)


def log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend computes it (jax 0.9.0): for
    |x| < sqrt(2) - 1 the Cephes rational with FMA Horner steps, else its
    own f32 log of 1 + x; bit for bit on every input `normal` can draw."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = fma32(num, x, _f32(cn, x))
        den = fma32(den, x, _f32(cd, x))
    x2 = x * x
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL, x), small,
                       _log32(x + 1.0))


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 by the polynomial XLA lowers `lax.erf_inv` to, bit for
    bit with jax 0.9.0 on the CPU: w = -log1p(-x^2) through `log1p32`, the
    sqrt correctly rounded (from float64, which is exact for an f32
    operand; torch's float32 CPU sqrt is not), and the Horner steps fused
    as XLA's CPU backend fuses them. Held over every one of the 2^23
    inputs `normal` can draw (tests/test_torch_random.py)."""
    f32, f64 = torch.float32, torch.float64
    w = -log1p32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(f64)).to(f32) - 3.0)
    coef = [torch.where(lt, _f32(a, x), _f32(b, x))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma32(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)` for each key of `key`
    ([..., 2]): sqrt(2) * erf^-1(u), u uniform on [nextafter(-1, 0), 1)
    as `jax._src.random._normal_real` draws it (the mantissa bits of
    `uniform`, scaled by (hi - lo), which rounds to 2, and shifted by lo;
    the product is exact, so XLA's FMA there changes nothing). Bit for bit
    with the reference (see `erfinv32`)."""
    if dtype != torch.float32:
        raise TypeError(f"normal: float32 only, got {dtype}")
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = uniform(key, shape, torch.float32, minval=lo, maxval=1.0)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=key.device)
    return sqrt2 * erfinv32(u)
