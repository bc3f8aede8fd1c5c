"""PackedWalkStore — the FOR bit-packed corpus (paper §4.4), port of
`repro/core/packed_store.py`.

FINDNEXT backends:
    "cuda"  — the packed-chunk CUDA kernel (kernels/range_search.py), the
              default for tensors on the card
    "torch" — its plain PyTorch version, the default on the CPU
    "ref"   — the scan over the uncompressed codes (WalkStore._scan_ref)
An explicit "cuda" request for tensors on the CPU raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch._u64 import BIAS, hi32, lo32, u32_bits
from repro_torch.kernels import ops
from repro_torch.kernels.delta import CHUNK, encode_chunks, packed_nbytes
from repro_torch.kernels.range_search import find_next_packed_plain

BACKENDS = ("cuda", "torch", "ref")
DEFAULT_WINDOW = 8    # K candidate chunks per query


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """None/"auto" -> "cuda" on the card, "torch" on the CPU."""
    if name in (None, "auto"):
        return "cuda" if device.type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown find_next backend {name!r}; "
                         f"expected one of {BACKENDS + ('auto',)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"find_next backend 'cuda' needs tensors on the "
                         f"card, got {device}")
    return name


# ------------------------------------------------------------------- encode


def pad_chunk_codes(code: torch.Tensor) -> torch.Tensor:
    """biased codes [T] -> [C, CHUNK] grid, tail-padded with the last code
    (u64 0 for an empty corpus) so the padding stays monotone."""
    t = code.shape[0]
    c = max(1, -(-t // CHUNK))
    pad = c * CHUNK - t
    if pad:
        filler = code[-1:] if t else torch.full((1,), BIAS, dtype=torch.int64,
                                                device=code.device)
        code = torch.cat([code, filler.expand(pad)])
    return code.reshape(c, CHUNK)


def encode_chunk_grid(chunks: torch.Tensor):
    """[C, CHUNK] biased chunks -> (packed, widths, a_hi, a_lo, l_hi, l_lo);
    anchors are the chunk heads (§5.2 c_first), last the tails (c_last)."""
    packed, widths, a_hi, a_lo = encode_chunks(chunks)
    return (packed, widths, a_hi, a_lo, u32_bits(hi32(chunks[:, -1])),
            u32_bits(lo32(chunks[:, -1])))


def encode_codes(code: torch.Tensor):
    """biased sorted codes [T] -> (packed, widths, a_hi, a_lo, l_hi, l_lo)."""
    return encode_chunk_grid(pad_chunk_codes(code))


# ------------------------------------------------------------------- decode


def gather_decode(packed, widths, a_hi, a_lo, chunk_idx) -> torch.Tensor:
    """Decode any set of chunks: chunk_idx [...] -> biased codes
    [..., CHUNK], through the decode kernel on the card."""
    shape = chunk_idx.shape
    rows = chunk_idx.reshape(-1).to(torch.int64)
    return ops.delta_decode(packed, widths, a_hi, a_lo, rows).reshape(
        *shape, CHUNK)


def packed_search(packed, widths, a_hi, a_lo, chunk_idx, f_targets,
                  backend: str):
    """Dispatch a packed-chunk FINDNEXT to a resolved backend."""
    if backend == "cuda":
        return ops.find_next_packed(packed, widths, a_hi, a_lo, chunk_idx,
                                    f_targets)
    if backend == "torch":
        return find_next_packed_plain(packed, widths, a_hi, a_lo, chunk_idx,
                                      f_targets)
    raise ValueError(f"packed_search cannot serve backend {backend!r}")


# ---------------------------------------------------------------- dataclass


@dataclass(frozen=True)
class PackedWalkStore:
    """Standalone packed view of a consolidated walk corpus (tensors are
    shared with the owning WalkStore)."""

    packed: torch.Tensor       # int32 [C, WORDS] FOR bit-packed chunks
    widths: torch.Tensor       # int32 [C] width class per chunk
    anchors_hi: torch.Tensor   # int32 [C] chunk head code halves (c_first)
    anchors_lo: torch.Tensor
    last_hi: torch.Tensor      # int32 [C] chunk tail code halves (c_last)
    last_lo: torch.Tensor
    offsets: torch.Tensor      # int32 [n+1] per-vertex segment bounds
    vmin: torch.Tensor         # int32 (u32 bits) [n] search bounds (§5.1)
    vmax: torch.Tensor
    length: int = dataclasses.field(default=0)
    n_vertices: int = dataclasses.field(default=0)

    @property
    def n_chunks(self) -> int:
        return self.packed.shape[0]

    def decode(self) -> torch.Tensor:
        """Full biased code grid [C * CHUNK]."""
        idx = torch.arange(self.n_chunks, device=self.packed.device)
        return gather_decode(self.packed, self.widths, self.anchors_hi,
                             self.anchors_lo, idx).reshape(-1)

    def search(self, chunk_idx, f_targets, backend: Optional[str] = None):
        """Raw packed FINDNEXT over explicit candidate windows."""
        backend = resolve_backend(backend, self.packed.device)
        if backend == "ref":   # no uncompressed codes in this view
            backend = "torch"
        return packed_search(self.packed, self.widths, self.anchors_hi,
                             self.anchors_lo, chunk_idx, f_targets, backend)

    def nbytes(self) -> int:
        meta = sum(t.numel() * t.element_size() for t in (
            self.offsets, self.vmin, self.vmax, self.last_hi, self.last_lo))
        return packed_nbytes(self.widths) + meta

    def nbytes_capacity(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.packed, self.widths, self.anchors_hi, self.anchors_lo,
            self.last_hi, self.last_lo, self.offsets, self.vmin, self.vmax))
