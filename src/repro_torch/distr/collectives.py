"""The sharded engine's two collectives, counted and timed.

Every collective of `distr/` goes through this module: `all_reduce_min`
(the MAV combine, once a batch) and `all_to_all` (the walk handoff, once a
rewalk step). `calls[name]` counts them and `seconds[name]` sums their
host time; with `set_timing(True)` each call first waits for the card's
queued work and then for its own, so that `seconds` is the collective's
own time (a measurement mode: it adds two synchronizations a call).

Backends: NCCL when each rank has its own card; gloo on the CPU, and for
several ranks on one card (NCCL refuses two ranks on one device). gloo
takes CUDA tensors itself (torch 2.11 on the H100: `all_to_all_single`
and a MIN `all_reduce` of int64) and stages them through host memory
inside its own call, so the time of that copy is part of the collective's
`seconds`. No wrapper copies a tensor anywhere itself. An observer
installed by `observe` (`launch/op_analysis.py`) is told of each call's
kind and output bytes.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

NAMES = ("all_reduce", "all_to_all")
calls = dict.fromkeys(NAMES, 0)
seconds = dict.fromkeys(NAMES, 0.0)
_timing = False
_observer = None
KINDS = {"all_reduce": "all-reduce", "all_to_all": "all-to-all"}


def reset() -> None:
    for name in NAMES:
        calls[name] = 0
        seconds[name] = 0.0


def set_timing(on: bool) -> None:
    global _timing
    _timing = bool(on)


@contextlib.contextmanager
def observe(observer):
    """Within the block, each collective calls
    `observer.collective(kind, output bytes)`."""
    global _observer
    saved, _observer = _observer, observer
    try:
        yield observer
    finally:
        _observer = saved


def _run(name: str, t: torch.Tensor, fn):
    if _timing and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if _timing and t.is_cuda:
        torch.cuda.synchronize(t.device)
    seconds[name] += time.perf_counter() - t0
    calls[name] += 1
    if _observer is not None:
        _observer.collective(KINDS[name], out.numel() * out.element_size())
    return out


def all_reduce_min(t: torch.Tensor, group=None) -> torch.Tensor:
    """Element-wise min of `t` over the group's ranks, in place."""
    def fn():
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        return t
    return _run("all_reduce", t, fn)


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """One `all_to_all_single` of equal splits: row block r of `send`
    (dim 0 cut into world-size blocks) goes to rank r; returns the blocks
    received, in rank order."""
    def fn():
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv
    return _run("all_to_all", send, fn)
