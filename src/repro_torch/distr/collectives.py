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

A partitioned step (`launch/steps.partition`) moves its DTensors with
torch's functional collectives. On torch 2.11 on the H100, gloo's
functional `all_gather_into_tensor` and DTensor's `shard_dim_alltoall` (a
Shard(i) -> Shard(j) move) of CUDA tensors end the process (SIGSEGV), and
with the functional all-reduce, reduce-scatter and all-to-all, which it
takes, a sharded train step's gradient norm came out 96,163 off the
unsharded step's (its forward agreed). Within `gloo_routes()` each
functional collective of CUDA tensors runs as the synchronous
`torch.distributed` call of the same kind on the same card tensors
(`dist.all_gather_into_tensor`, `all_reduce`, `reduce_scatter_tensor`,
`all_to_all_single`; the move as one `all_to_all_single` of the input's
chunks along the new shard dim, concatenated along the old one), which
returns only when gloo has written its output. A work counter above
(`op_analysis`) still sees, and counts, the functional op.

Ranks as threads: an `InProcessGroup` (`launch/lockstep.py`) holds S ranks
that are threads of this process. A thread bound to one (`bind`) takes
its collectives from it, and `shard_group` of `distr/sharded.py` returns
it: no `torch.distributed` group is needed then. The observer is the
calling thread's, and a counter is suspended while a collective runs, so
the copies a collective makes for its ranks (on whichever thread makes
them) are counted as its one record, not as the thread's ops. `calls` and
`seconds` are the process's totals.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

NAMES = ("all_reduce", "all_to_all")
calls = dict.fromkeys(NAMES, 0)
seconds = dict.fromkeys(NAMES, 0.0)
_timing = False
_lock = threading.Lock()
# this thread's observer and in-process group
_tls = threading.local()
KINDS = {"all_reduce": "all-reduce", "all_to_all": "all-to-all"}


class InProcessGroup:
    """A group whose ranks are threads of this process: the two
    collectives of the sharded engine on the calling thread's rank."""

    def rank(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def all_reduce_min(self, t: torch.Tensor) -> None:
        """Element-wise min over the ranks, into `t` in place."""
        raise NotImplementedError

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Row block r of `send` to rank r; the blocks received, in rank
        order."""
        raise NotImplementedError


def reset() -> None:
    with _lock:
        for name in NAMES:
            calls[name] = 0
            seconds[name] = 0.0


def set_timing(on: bool) -> None:
    global _timing
    _timing = bool(on)


@contextlib.contextmanager
def observe(observer):
    """Within the block, each collective this thread makes calls
    `observer.collective(kind, output bytes)`, and runs inside
    `observer.suspended()`."""
    saved, _tls.observer = getattr(_tls, "observer", None), observer
    try:
        yield observer
    finally:
        _tls.observer = saved


@contextlib.contextmanager
def bind(group: InProcessGroup):
    """Within the block this thread's collectives run on `group`."""
    saved, _tls.group = getattr(_tls, "group", None), group
    try:
        yield group
    finally:
        _tls.group = saved


def bound_group():
    """The in-process group this thread is bound to, or None."""
    return getattr(_tls, "group", None)


def group_rank(group=None) -> int:
    """This thread's rank in `group` (default: the bound in-process group,
    else the default process group)."""
    group = bound_group() if group is None else group
    return group.rank() if isinstance(group, InProcessGroup) else dist.get_rank(group)


def group_size(group=None) -> int:
    group = bound_group() if group is None else group
    return group.size() if isinstance(group, InProcessGroup) else dist.get_world_size(group)


def _run(name: str, t: torch.Tensor, fn):
    observer = getattr(_tls, "observer", None)
    if _timing and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    with (observer.suspended() if observer is not None else contextlib.nullcontext()):
        out = fn()
    if _timing and t.is_cuda:
        torch.cuda.synchronize(t.device)
    with _lock:
        seconds[name] += time.perf_counter() - t0
        calls[name] += 1
    if observer is not None:
        observer.collective(KINDS[name], out.numel() * out.element_size())
    return out


def all_reduce_min(t: torch.Tensor, group=None) -> torch.Tensor:
    """Element-wise min of `t` over the group's ranks, in place."""
    group = bound_group() if group is None else group

    def fn():
        if isinstance(group, InProcessGroup):
            group.all_reduce_min(t)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        return t
    return _run("all_reduce", t, fn)


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """One `all_to_all_single` of equal splits: row block r of `send`
    (dim 0 cut into world-size blocks) goes to rank r; returns the blocks
    received, in rank order."""
    group = bound_group() if group is None else group

    def fn():
        if isinstance(group, InProcessGroup):
            return group.all_to_all(send)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv
    return _run("all_to_all", send, fn)


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _gather(inp, group_size: int, group_name):
    out = inp.new_empty((group_size * inp.shape[0],) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=_group(group_name))
    return out


def _shard_dim_all_to_all(inp, gather_dim: int, shard_dim: int, group_name):
    """DTensor's Shard(gather_dim) -> Shard(shard_dim) move: chunk r of
    this rank's shard along `shard_dim` goes to rank r, and the chunks
    received are concatenated along `gather_dim` in rank order."""
    pg = _group(group_name)
    n = pg.size()
    if inp.shape[shard_dim] % n:
        raise ValueError(f"shard dim {shard_dim} of {tuple(inp.shape)} over {n} ranks")
    chunks = [c.contiguous() for c in torch.chunk(inp, n, dim=shard_dim)]
    send = torch.cat([c.reshape(-1) for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=pg)
    return torch.cat([r.reshape(chunks[0].shape) for r in recv.chunk(n)], dim=gather_dim)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _op(reduce_op: str):
    """The ReduceOp of a functional op's name; "avg" is a sum here, divided
    after (gloo has no AVG)."""
    op = reduce_op.lower()
    return dist.ReduceOp.SUM if op == "avg" else _OPS[op], op == "avg"


def _reduce(inp, reduce_op: str, group_name):
    out = inp.clone()
    pg = _group(group_name)
    op, avg = _op(reduce_op)
    dist.all_reduce(out, op=op, group=pg)
    return out / pg.size() if avg else out


def _reduce_scatter(inp, reduce_op: str, group_size: int, group_name):
    out = inp.new_empty((inp.shape[0] // group_size,) + tuple(inp.shape[1:]))
    op, avg = _op(reduce_op)
    dist.reduce_scatter_tensor(out, inp.contiguous(), op=op, group=_group(group_name))
    return out / group_size if avg else out


def _exchange(inp, output_split_sizes, input_split_sizes, group_name):
    rows = sum(output_split_sizes) if output_split_sizes else inp.shape[0]
    out = inp.new_empty((rows,) + tuple(inp.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(), output_split_sizes or None,
                           input_split_sizes or None, group=_group(group_name))
    return out


_ROUTES = {("_c10d_functional", "all_gather_into_tensor"): _gather,
           ("_c10d_functional", "all_reduce"): _reduce,
           ("_c10d_functional", "reduce_scatter_tensor"): _reduce_scatter,
           ("_c10d_functional", "all_to_all_single"): _exchange,
           ("_dtensor", "shard_dim_alltoall"): _shard_dim_all_to_all}
# the collectives run through the routes in this process, by route
routed = {r.__name__: 0 for r in _ROUTES.values()}


class _GlooRoutes(TorchDispatchMode):
    def __init__(self, cuda_only: bool):
        super().__init__()
        self.cuda_only = cuda_only

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor dispatches it with this mode kept: its collectives
            # come back here
            return NotImplemented
        route = _ROUTES.get((func.namespace, func._overloadpacket.__name__))
        if route is None or (self.cuda_only and not args[0].is_cuda):
            return func(*args, **(kwargs or {}))
        routed[route.__name__] += 1
        return route(*args, **(kwargs or {}))


def gloo_routes(cuda_only: bool = True):
    """Within the block the functional collectives and DTensor's Shard ->
    Shard move of CUDA tensors (of every tensor with `cuda_only` False)
    run as synchronous `torch.distributed` calls (module doc). Enter it
    before a work counter, so that the counter sees the functional op."""
    return _GlooRoutes(cuda_only)
