"""Kernel 3: frame-of-reference decode of packed chunks (CUDA,
`csrc/delta.cu`), its plain PyTorch version, and the encoder.

Port of `repro/kernels/delta.py`. A chunk is 128 sorted u64 codes packed as
an anchor (the first code) plus 128 deltas (the first is 0) at a width
w in {8, 16, 32} bits, or w = 64: the raw (hi, lo) words, for chunks that
are not monotone or have a delta of 2^32 or more.

    packed  int32 [C, WORDS]   u32 words (w=8: 4 deltas a word, ...)
    widths  int32 [C]          width class
    anchors int32 [C] (hi, lo) halves of the chunk head code

`encode_chunks` is plain PyTorch (plain `jnp` in the reference) and runs
on every merge, in slabs of chunk rows so that its temporaries stay small
at full scale.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._u64 import BIAS, M32, hi32, lo32, u32_bits, u32_value
from repro_torch.kernels._launch import call, require

CHUNK = 128           # codes per chunk
WORDS = 2 * CHUNK     # packed words per chunk (w=64 raw worst case)
SLAB = 1 << 15        # chunk rows per plain encode/decode slab


# ------------------------------------------------------------------ decode


def _decode_plain_slab(packed, widths, a_hi, a_lo):
    p = u32_value(packed)                                      # [R, WORDS]
    w = widths.to(torch.int64)[:, None]
    lane = torch.arange(CHUNK, device=packed.device)
    v8 = (p[:, lane // 4] >> ((lane % 4) * 8)) & 0xFF
    v16 = (p[:, lane // 2] >> ((lane % 2) * 16)) & 0xFFFF
    d = torch.where(w == 8, v8, torch.where(w == 16, v16, p[:, :CHUNK]))
    anchor = (u32_value(a_hi) << 32) | u32_value(a_lo)        # raw u64 bits
    code = anchor[:, None] + torch.cumsum(d, dim=1)            # mod 2^64
    raw = (p[:, :CHUNK] << 32) | p[:, CHUNK:]
    return torch.where(w == 64, raw, code) ^ BIAS


def decode_rows_plain(packed, widths, a_hi, a_lo, rows) -> torch.Tensor:
    """Decode chunks `rows` (int64 [R]) -> biased int64 codes [R, CHUNK]."""
    out = torch.empty((rows.shape[0], CHUNK), dtype=torch.int64,
                      device=packed.device)
    for s in range(0, rows.shape[0], SLAB):
        r = rows[s:s + SLAB]
        out[s:s + SLAB] = _decode_plain_slab(packed[r], widths[r], a_hi[r],
                                             a_lo[r])
    return out


def packed_rows(packed, name: str) -> torch.Tensor:
    """`packed` as the kernels take it: int32 [C, WORDS] on the card with
    16-byte aligned rows (a lane loads its words of a chunk as one vector)."""
    packed = require(packed, torch.int32, f"{name} packed")
    if packed.dim() != 2 or packed.shape[1] != WORDS or packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be [C, {WORDS}] with 16-byte "
                         "aligned rows")
    return packed


def decode_rows_cuda(packed, widths, a_hi, a_lo, rows) -> torch.Tensor:
    packed = packed_rows(packed, "delta_decode")
    widths = require(widths, torch.int32, "delta_decode widths")
    a_hi = require(a_hi, torch.int32, "delta_decode anchors_hi")
    a_lo = require(a_lo, torch.int32, "delta_decode anchors_lo")
    rows = require(rows, torch.int64, "delta_decode rows")
    out = torch.empty((rows.shape[0], CHUNK), dtype=torch.int64,
                      device=packed.device)
    call("repro_delta_decode", packed.device, packed, widths, a_hi, a_lo,
         rows, out, rows.shape[0])
    return out


# ------------------------------------------------------------------ encode


def _encode_slab(chunks):
    c = chunks.shape[0]
    dev = chunks.device
    mono = (chunks[:, 1:] >= chunks[:, :-1]).all(dim=1)
    d = chunks[:, 1:] - chunks[:, :-1]          # u64 difference (bias cancels)
    small = mono & ((d >> 32) == 0).all(dim=1)
    d_lo = torch.cat([torch.zeros((c, 1), dtype=torch.int64, device=dev),
                      d & M32], dim=1)
    dmax = d_lo.max(dim=1).values
    width = torch.where(~small, 64, torch.where(
        dmax < 256, 8, torch.where(dmax < 65536, 16, 32)))
    sh4 = torch.arange(4, device=dev) * 8
    sh2 = torch.arange(2, device=dev) * 16
    p8 = (d_lo.reshape(c, CHUNK // 4, 4) << sh4).sum(-1) & M32
    p16 = (d_lo.reshape(c, CHUNK // 2, 2) << sh2).sum(-1) & M32
    packed = torch.zeros((c, WORDS), dtype=torch.int64, device=dev)
    w = width[:, None]
    packed[:, :CHUNK // 4] = torch.where(w == 8, p8, 0)
    packed[:, :CHUNK // 2] += torch.where(w == 16, p16, 0)
    packed[:, :CHUNK] += torch.where(w == 32, d_lo, 0)
    raw = torch.cat([hi32(chunks), lo32(chunks)], dim=1)
    packed = torch.where(w == 64, raw, packed)
    return (u32_bits(packed), width.to(torch.int32), u32_bits(hi32(chunks[:, 0])),
            u32_bits(lo32(chunks[:, 0])))


def encode_chunks(chunks: torch.Tensor):
    """FOR-pack sorted biased codes [C, CHUNK] -> (packed int32 [C, WORDS],
    widths int32 [C], anchors_hi, anchors_lo int32 [C])."""
    c = chunks.shape[0]
    dev = chunks.device
    packed = torch.empty((c, WORDS), dtype=torch.int32, device=dev)
    widths = torch.empty((c,), dtype=torch.int32, device=dev)
    a_hi = torch.empty((c,), dtype=torch.int32, device=dev)
    a_lo = torch.empty((c,), dtype=torch.int32, device=dev)
    for s in range(0, c, SLAB):
        packed[s:s + SLAB], widths[s:s + SLAB], a_hi[s:s + SLAB], \
            a_lo[s:s + SLAB] = _encode_slab(chunks[s:s + SLAB])
    return packed, widths, a_hi, a_lo


def packed_nbytes(widths) -> int:
    """Compressed footprint: words used at each chunk's width + metadata."""
    w = np.asarray(widths.cpu() if isinstance(widths, torch.Tensor) else widths
                   ).astype(np.int64)
    words = np.where(w == 64, 2 * CHUNK, CHUNK * w // 32)
    return int(words.sum() * 4 + w.size * (1 + 8))
