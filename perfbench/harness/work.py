"""The least work a kernel call needs, counted from its operands, and the
H100's data-sheet peaks: the denominators of the `<kernel>_roofline`
metrics. Frozen here so that the count stays the same whatever implements
the kernel.

Kernel 5, the exact factorized node2vec step on the graph's CSR (rows of v
and prev, their CSR segments read): each CSR segment that the call's rows
read counts once per call, 8 bytes a code (min(deg, dmax) codes) and its two
u32 offsets; each row reads its v and prev (u32) and two f32 uniforms and
writes a u32 next vertex and two flags (22 bytes); the membership search
and the ballots take ~30 operations per v entry of a row.

The counts are kept on the device, so that counting a call inside a traced
window neither waits for the device nor copies to the host.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.profiler import record_function

# NVIDIA H100 SXM5 data sheet (dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12       # FP32 outside the tensor cores

ROW_BYTES = 22.0               # u32 v, u32 prev, 2 x f32 u; u32 next, 2 flags
OPS_PER_ENTRY = 30.0


def segment_entries(offsets: torch.Tensor, verts: torch.Tensor, dmax: int):
    """min(deg, dmax) of each vertex of `verts`: the codes its row reads."""
    deg = (offsets[1:] - offsets[:-1]).to(torch.int64).clamp(max=dmax)
    return deg[verts]


def csr_call_work(offsets: torch.Tensor, v: torch.Tensor, prev: torch.Tensor,
                  dmax: int):
    """(bytes, operations) of one kernel-5 call, as float64 device scalars."""
    deg = (offsets[1:] - offsets[:-1]).to(torch.int64).clamp(max=dmax)
    seen = torch.zeros(deg.shape[0], dtype=torch.bool, device=deg.device)
    seen[v] = True
    seen[prev] = True
    nbytes = ((deg * 8 + 8) * seen).sum().to(torch.float64)
    nbytes = nbytes + ROW_BYTES * v.shape[0]
    ops = deg[v].sum().to(torch.float64) * OPS_PER_ENTRY
    return nbytes, ops


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


class Kernel5Work:
    """An observer (`repro_torch.kernels._observe`) that adds up the work of
    every kernel-5 call it is told of, on the device. `span` names the
    profiler scope its own kernels run in, so a trace reader can leave
    them out."""

    NAME = "intersect_csr"
    span = "perfbench.k5_work"

    def __init__(self):
        self.work = []   # (bytes, operations) device scalars, one pair a call

    @contextmanager
    def kernel(self, name, args):
        if name == self.NAME:
            _codes, offsets, v, prev, _u, dmax = args[:6]
            with record_function(self.span):
                self.work.append(csr_call_work(offsets, v, prev, int(dmax)))
        yield

    @property
    def calls(self) -> int:
        return len(self.work)

    def bound_seconds(self) -> float:
        """The sum over the calls of each call's bound (one host read)."""
        if not self.work:
            return 0.0
        per_call = torch.stack([torch.stack(w) for w in self.work]).tolist()
        return sum(bound_seconds(b, o) for b, o in per_call)
