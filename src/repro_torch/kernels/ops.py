"""Public wrappers of the port's kernels (port of `repro/kernels/ops.py`).

Each wrapper looks at where its tensors lie: on the CPU it runs the plain
PyTorch version; on the card it launches the CUDA kernel, or raises if the
launch fails. There is no fallback from the card to the plain version.
`launches[name]` counts the kernel launches each wrapper made, so that a
run can show that the main path went through the kernels. An observer
(`kernels/_observe.py`) is told of every wrapper call, on the card or on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import delta as _delta
from repro_torch.kernels import intersect as _intersect
from repro_torch.kernels import megakernel as _mk
from repro_torch.kernels import range_search as _rs
from repro_torch.kernels import sgns as _sgns
from repro_torch.kernels import szudzik as _szudzik
from repro_torch.kernels._observe import observed

KERNELS = ("szudzik_pair", "szudzik_unpair", "delta_decode",
           "find_next_packed", "intersect_next", "intersect_csr",
           "fused_rewalk_step", "sgns_step")
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _on_card(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


@observed("szudzik_pair")
def szudzik_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64 operands < 2^32 -> biased int64 Szudzik codes."""
    x, y = torch.broadcast_tensors(x, y)
    if not _on_card(x, y):
        return _szudzik.pair_plain(x, y)
    out = _szudzik.pair_cuda(x, y)
    launches["szudzik_pair"] += 1
    return out


@observed("szudzik_unpair")
def szudzik_unpair(z: torch.Tensor):
    """biased int64 codes -> (x, y) int64."""
    if not _on_card(z):
        return _szudzik.unpair_plain(z)
    out = _szudzik.unpair_cuda(z)
    launches["szudzik_unpair"] += 1
    return out


@observed("delta_decode")
def delta_decode(packed, widths, anchors_hi, anchors_lo, rows):
    """Decode chunks `rows` (int64 [R]) -> biased int64 codes [R, 128]."""
    if not _on_card(packed, widths, anchors_hi, anchors_lo, rows):
        return _delta.decode_rows_plain(packed, widths, anchors_hi,
                                        anchors_lo, rows)
    out = _delta.decode_rows_cuda(packed, widths, anchors_hi, anchors_lo,
                                  rows)
    launches["delta_decode"] += 1
    return out


@observed("find_next_packed")
def find_next_packed(packed, widths, anchors_hi, anchors_lo, chunk_idx,
                     f_targets):
    """Packed FINDNEXT: chunk_idx [Q, K], f_targets int64 [Q] ->
    (v int64 [Q], found bool [Q]), first hitting chunk wins."""
    if not _on_card(packed, widths, anchors_hi, anchors_lo, chunk_idx,
                    f_targets):
        return _rs.find_next_packed_plain(packed, widths, anchors_hi,
                                          anchors_lo, chunk_idx, f_targets)
    out = _rs.find_next_packed_cuda(packed, widths, anchors_hi, anchors_lo,
                                    chunk_idx, f_targets)
    launches["find_next_packed"] += 1
    return out


@observed("intersect_next")
def intersect_next(nbrs_v, nbrs_p, prev, u_group, u_rank, inv_p: float,
                   inv_q: float):
    """The exact factorized node2vec step: windows int64 [B, D], prev int64
    [B], uniforms f32 [B], f32 weights -> (nxt int64 [B], found bool [B]).
    On the card, windows are padded with SENT to a multiple of 128."""
    if not _on_card(nbrs_v, nbrs_p, prev, u_group, u_rank):
        return _intersect.factorized_plain(nbrs_v, nbrs_p, prev, u_group,
                                           u_rank, inv_p, inv_q)
    nbrs_v, nbrs_p = _intersect.pad_windows(nbrs_v, nbrs_p)
    out = _intersect.factorized_cuda(nbrs_v, nbrs_p, prev, u_group, u_rank,
                                     inv_p, inv_q)
    launches["intersect_next"] += 1
    return out


@observed("intersect_csr")
def intersect_csr(codes, offsets, v, prev, u, dmax: int, inv_p: float,
                  inv_q: float):
    """The exact factorized node2vec step from the graph's CSR: codes int64
    [E], offsets int32 [N+1], v and prev int64 [B], u f32 [B, 2], the
    window width dmax, f32 weights -> (nxt int64 [B], found bool [B],
    overflow bool [B]). On the card the kernel reads the segments itself."""
    if not _on_card(codes, offsets, v, prev, u):
        return _intersect.factorized_csr_plain(codes, offsets, v, prev, u, dmax,
                                               inv_p, inv_q)
    out = _intersect.factorized_csr_cuda(codes, offsets, v, prev, u, dmax,
                                         inv_p, inv_q)
    launches["intersect_csr"] += 1
    return out


@observed("fused_rewalk_step")
def fused_rewalk_step(store, step):
    """One fused rewalk step (`megakernel.FusedStep`) over the packed
    `store` -> (nxt int64 [B], code biased int64 [B], overflow bool [B])."""
    if not _on_card(store.packed, step.cur):
        return _mk.fused_step_plain(store, step)
    out = _mk.fused_step_cuda(store, step)
    launches["fused_rewalk_step"] += 1
    return out


@observed("sgns_step")
def sgns_step(u: torch.Tensor, v_pos: torch.Tensor, v_neg: torch.Tensor):
    """The fused SGNS step: u, v_pos f32 [B, D], v_neg f32 [B, K, D] ->
    (loss [B], du [B, D], dvp [B, D], dvn [B, K, D])."""
    if not _on_card(u, v_pos, v_neg):
        return _sgns.sgns_plain(u, v_pos, v_neg)
    out = _sgns.sgns_cuda(u, v_pos, v_neg)
    launches["sgns_step"] += 1
    return out


candidate_chunks = _rs.candidate_chunks
