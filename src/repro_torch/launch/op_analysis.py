"""Work counts of a cell plan from the operations its step executes: the
port's counterpart of `repro/launch/hlo_analysis.py`, which reads them off
the compiled HLO.

`analyze(plan)` runs `plan.fn` once under a `TorchDispatchMode` and sums:

  * FLOPs            = the formulas of `torch.utils.flop_counter` (the
                       registry `FlopCounterMode` counts by: products,
                       convolutions, attention), an op's count by its
                       output dtype as well;
  * bytes            = for every aten op but views, aliases and bare
                       allocations, its tensor operands' bytes plus its
                       outputs' (an in-place op's operand counts as both):
                       unfused traffic, each op reading its inputs from
                       memory and writing its outputs back. XLA's bytes
                       are counted after fusion, so the two are not
                       comparable. As the walker counts an HLO gather and
                       scatter, a gather (`index`, `gather`, `searchsorted`,
                       ...) moves twice its output and its index operands,
                       not its whole source, and a scatter (`index_put_`,
                       `scatter_add_`, ...) twice its index and update
                       operands, not the buffer it writes into;
  * the seven kernels = ctypes calls, which no dispatch mode sees: each
                       wrapper of `kernels/ops.py`, and each plain twin a
                       CPU route calls in a wrapper's place, reports its
                       call (`kernels/_observe.py`), with its bytes by the
                       bound formula of the kernels line (`kernel_bytes`);
                       a twin's own aten ops are not counted, so a card
                       count and a CPU count of one plan agree;
  * collectives      = each `distr/collectives.py` call and each
                       `_c10d_functional` collective (what DTensor's
                       redistributions and the models' explicit sharded
                       steps run), its output bytes a rank by kind, as the
                       walker counts an HLO collective's. A DTensor
                       Shard(i) -> Shard(j) move is one all-to-all of its
                       output, also where a CPU mesh runs it as all-gather
                       and chunk.

A loop whose iterations run the same ops is written `for x in
uniform_loop(xs)`: under `analyze(..., scale_loops=True)` it runs the first
iteration alone and counts its ops len(xs) times, as the walker scales a
while body by its `known_trip_count` (a train plan's microbatch loop). Its
values are then those of one iteration: a scaled run counts, it computes
nothing. Plans with meta args are counted on meta tensors; the wharf plans,
whose ops have data-dependent shapes, on real tensors (`args`).

All numbers are one rank's. A plan run on one card (no mesh) is one
card's step of the whole cell. A plan whose args are DTensors
(`steps.partition`) is counted at its local ops: the counter lets DTensor
dispatch each op and counts the local op it runs on the shard, and skips
the ops of DTensor's sharding propagation (on FakeTensors). On a fake
process group the local shards are rank 0's, the largest where a dim does
not divide.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
KERNELS = ("szudzik_pair", "szudzik_unpair", "delta_decode",
           "find_next_packed", "intersect_next", "intersect_csr",
           "fused_rewalk_step", "sgns_step")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_op_counter",
                                                         default=None)

# ops that move no bytes: shape queries are not dispatched here at all;
# views and aliases share their input; these allocate without writing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "set_"}
# functional collectives (DTensor's redistributions) -> the walker's kinds
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
# a gather reads the window it outputs; a scatter writes its updates
_GATHERS = {"index", "gather", "index_select", "embedding", "take", "searchsorted"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_", "index_copy", "index_copy_", "index_fill_",
             "masked_scatter_"}


@dataclass
class Totals:
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_counts: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    # FLOPs by the product's output dtype ("bfloat16", "float32", ...)
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    # the seven kernels: calls (launches on the card, plain-twin calls on
    # the CPU) and bytes by the bound formula; mem_bytes includes them
    kernel_calls: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in KERNELS})
    kernel_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in KERNELS})
    # the step's outputs (meta outputs have their shapes)
    output_bytes: float = 0.0

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_nbytes(t: torch.Tensor) -> int:
    """This rank's bytes of `t` (its shard, for a DTensor)."""
    from torch.distributed.tensor import DTensor
    return _nbytes(t.to_local() if isinstance(t, DTensor) else t)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _shape_str(dtype, shape) -> str:
    if dtype is None:
        return "()"
    dt = str(dtype).replace("torch.", "")
    return f"{dt}[{','.join(str(d) for d in shape)}]"


# ------------------------------------------------- the kernels' bound bytes


def _used_words(widths: torch.Tensor) -> torch.Tensor:
    """Packed u32 words a chunk of FOR width class `widths` holds (64 is
    the raw class: two words a code)."""
    from repro_torch.kernels.delta import CHUNK
    w = widths.to(torch.int64)
    return torch.where(w == 64, 2 * CHUNK, CHUNK * w // 32)


def _chunk_bytes(widths: torch.Tensor, chunks: torch.Tensor) -> float:
    """Each distinct chunk of `chunks` read once: its used words, width
    and two anchor words."""
    seen = torch.unique(chunks.reshape(-1).to(torch.int64))
    return float((_used_words(widths[seen]) * 4 + 12).sum())


def _segment_bytes(offsets, dmax: int, *verts) -> float:
    """The CSR bytes rows at these vertices read, each segment once:
    min(deg, dmax) codes of 8 B and its two offsets."""
    seen = torch.unique(torch.cat([v.reshape(-1).to(torch.int64) for v in verts]))
    deg = (offsets[seen + 1] - offsets[seen]).to(torch.int64).clamp(max=dmax)
    return float((deg * 8 + 8).sum())


def kernel_bytes(name: str, args) -> float:
    """The bytes one call of kernel `name` on `args` must move, counted
    at the reference's types (u32 ids, u64 codes), each input read once
    and each output written once: the kernels line's bound formula. For
    FINDNEXT (kernels 4 and 6) every chunk of a lane's K-chunk window
    counts, where the kernels line counts up to the first hit."""
    from repro_torch.kernels.delta import CHUNK
    if name in ("szudzik_pair", "szudzik_unpair"):
        shape = torch.broadcast_shapes(*(a.shape for a in args))
        return 16.0 * shape.numel()
    if name == "delta_decode":
        _, widths, _, _, rows = args
        return float((_used_words(widths[rows.to(torch.int64)]) * 4).sum()) + (
            20.0 + 8 * CHUNK) * rows.numel()
    if name == "find_next_packed":
        _, widths, _, _, chunk_idx, f_targets = args
        return (4.0 * chunk_idx.numel() + 9.0 * f_targets.numel()
                + _chunk_bytes(widths, chunk_idx))
    if name == "intersect_next":
        nbrs_v, nbrs_p, prev = args[:3]
        return 8.0 * (nbrs_v.numel() + nbrs_p.numel()) + 17.0 * prev.numel()
    if name == "intersect_csr":
        _, offsets, v, prev, _, dmax = args[:6]
        return _segment_bytes(offsets, dmax, v, prev) + 22.0 * v.numel()
    if name == "fused_rewalk_step":
        store, s = args
        b = s.cur.numel()
        need = s.is_prefix & ~s.pend_hit & (s.lo < s.hi)
        c0 = s.lo[need] // CHUNK
        win = (c0[:, None] + torch.arange(s.window, device=c0.device)[None]).clamp(
            0, store.widths.shape[0] - 1)
        nbytes = (35.0 * b + 4.0 * float(s.pend_hit.sum()) + 4.0 * float(need.sum())
                  + _chunk_bytes(store.widths, win))
        if s.offsets is not None:
            emit = ~s.is_prefix
            nbytes += (_segment_bytes(s.offsets, s.dmax, s.cur[emit], s.prev[emit])
                       + 12.0 * float(emit.sum()))
        return nbytes
    if name == "sgns_step":
        u, v_pos, v_neg = args
        return 8.0 * (_nbytes(u) + _nbytes(v_pos) + _nbytes(v_neg)) + 4.0 * u.shape[0]
    raise KeyError(name)


# ------------------------------------------------------------- the counter


class _Counter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active, times `mult`."""

    def __init__(self, scale_loops: bool):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.scale_loops = scale_loops
        self.mult = 1.0
        self.paused = 0
        self.totals = Totals()
        # (opcode, op, out dtype, out shape) -> [bytes, flops, calls]
        self.rows = defaultdict(lambda: [0.0, 0.0, 0.0])
        self._kinds = {}

    def _kind(self, func):
        """(flop formula or None, decomposes, byte rule) of an op, once."""
        kind = self._kinds.get(func)
        if kind is None:
            packet = func._overloadpacket
            formula = self.registry.get(packet)
            decomposes = (formula is None and func is not torch.ops.prim.device.default
                          and func.has_kernel_for_dispatch_key(
                              torch._C.DispatchKey.CompositeImplicitAutograd))
            name = packet.__name__
            rule = ("gather" if name in _GATHERS else "scatter" if name in _SCATTERS
                    else "none" if name in _NO_TRAFFIC or _is_view(func) else "all")
            kind = self._kinds[func] = (formula, decomposes, rule, name, str(func))
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            # DTensor runs it on the local shards, which come back here
            return NotImplemented
        if self.paused or _has_fake(types):
            return func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NS:
            return self._collective_op(func, args, kwargs)
        formula, decomposes, rule, name, op = self._kind(func)
        if decomposes:
            # as FlopCounterMode: an op with a decomposition is counted as it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        flops = 0.0 if formula is None else float(formula(*args, **kwargs, out_val=out))
        if rule == "gather":
            nbytes = float(2 * sum(_nbytes(t) for t in _tensors(out))
                           + sum(_nbytes(t) for t in _tensors((args[1:], kwargs))))
        elif rule == "scatter":
            nbytes = float(2 * sum(_nbytes(t) for t in _tensors((args[1:], kwargs))))
        elif rule == "all":
            nbytes = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in _tensors(out)))
        else:
            nbytes = 0.0
        if not (nbytes or flops):
            return out
        m = self.mult
        t = self.totals
        t.flops += flops * m
        t.mem_bytes += nbytes * m
        first = next(_tensors(out), None)
        dt = None if first is None else first.dtype
        if flops:
            key = str(dt).replace("torch.", "")
            t.flops_by_dtype[key] = t.flops_by_dtype.get(key, 0.0) + flops * m
        row = self.rows[(name, op, dt, None if first is None else tuple(first.shape))]
        row[0] += nbytes * m
        row[1] += flops * m
        row[2] += m
        return out

    def _collective_op(self, func, args, kwargs):
        # DTensor's own all-to-all op runs a collective inside: that one is it
        outer = func.namespace == "_dtensor"
        self.paused += outer
        try:
            out = func(*args, **kwargs)
        finally:
            self.paused -= outer
        kind = _COLLECTIVES.get(func._overloadpacket.__name__)
        if kind is not None:
            self.collective(kind, float(sum(_nbytes(t) for t in _tensors(out))))
        return out

    # -- reported by kernels/ops.py and distr/collectives.py

    def kernel(self, name: str, args):
        """The context of one kernel call: its aten ops are not counted,
        and a call inside another (a wrapper's plain twin) is the outer
        call's."""
        if self.paused:
            return contextlib.nullcontext()
        counter = self

        class _Call:
            def __enter__(self):
                counter.paused += 1

            def __exit__(self, *exc):
                try:
                    if exc[0] is None:
                        nbytes = kernel_bytes(name, args) * counter.mult
                        t = counter.totals
                        t.kernel_calls[name] += counter.mult
                        t.kernel_bytes[name] += nbytes
                        t.mem_bytes += nbytes
                        first = next(_tensors(args), None)
                        row = counter.rows[("kernel", name, None if first is None else first.dtype,
                                            None if first is None else tuple(first.shape))]
                        row[0] += nbytes
                        row[2] += counter.mult
                finally:
                    counter.paused -= 1
        return _Call()

    def collective(self, kind: str, nbytes: float) -> None:
        self.totals.coll_bytes[kind] += nbytes * self.mult
        self.totals.coll_counts[kind] += self.mult

    @contextlib.contextmanager
    def suspended(self):
        """No op is counted within the block: a collective's own copies,
        which it records as one collective."""
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _has_fake(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types)


@contextlib.contextmanager
def _reshard_as_all_to_all(counter):
    """Within the block DTensor's Shard(i) -> Shard(j) move counts as one
    all-to-all of its output: a CPU mesh runs it as an all-gather and a
    chunk (gloo has no all-to-all there), a card's mesh as an all-to-all."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or counter.paused:
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        counter.paused += 1
        try:
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter.paused -= 1
        counter.collective("all-to-all", float(_nbytes(out)))
        return out

    pt.shard_dim_alltoall = counted
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def active() -> Optional[_Counter]:
    """The counter of the analysis running in this context, if any."""
    return _ACTIVE.get()


def uniform_loop(items):
    """Iterate `items` whose iterations all run the same ops. Under a
    loop-scaling analysis only the first runs, counted len(items) times."""
    counter = _ACTIVE.get()
    n = len(items)
    if counter is None or not counter.scale_loops or n <= 1:
        yield from items
        return
    counter.mult *= n
    try:
        yield items[0]
    finally:
        counter.mult /= n


def meta_args(plan):
    """The plan's meta args, a 0-d integer arg (the decode step's cache
    length) as the host int 0: a meta scalar has no value to index by."""
    return tuple(0 if isinstance(a, torch.Tensor) and a.dim() == 0
                 and not a.is_floating_point() else a for a in plan.args)


def _count(fn, args, scale_loops: bool):
    """(`fn(*args)`, its counter): the ops this thread runs."""
    from repro_torch.distr import collectives
    from repro_torch.kernels import _observe
    counter = _Counter(scale_loops)
    token = _ACTIVE.set(counter)
    try:
        with _observe.observe(counter), collectives.observe(counter), \
                _reshard_as_all_to_all(counter), counter:
            out = fn(*args)
    finally:
        _ACTIVE.reset(token)
    counter.totals.output_bytes = float(sum(_local_nbytes(t) for t in _tensors(out)))
    return out, counter


def counted_call(fn, *args, scale_loops: bool = True, top: Optional[int] = 25):
    """One call `fn(*args)` counted -> (its outputs, `analyze`'s totals,
    `breakdown`'s rows, the `top` heaviest; all with `top` None)."""
    out, counter = _count(fn, args, scale_loops)
    rows = [(b, fl, opc, name, _shape_str(dt, shape), m)
            for (opc, name, dt, shape), (b, fl, m) in counter.rows.items()]
    rows.sort(key=lambda r: (r[0], r[1]), reverse=True)
    return out, counter.totals, rows if top is None else rows[:top]


def counted_run(plan, args=None, scale_loops: bool = True, top: int = 25):
    """One run of `plan.fn` on `args` (default: the plan's meta args),
    uniform loops scaled by their trip counts unless `scale_loops` is
    False -> (its outputs, `analyze`'s totals, `breakdown`'s rows)."""
    args = meta_args(plan) if args is None else args
    return counted_call(plan.fn, *args, scale_loops=scale_loops, top=top)


def analyze(plan, args=None, scale_loops: bool = True) -> Totals:
    """The counts of one run of `plan.fn` (`counted_run`)."""
    return counted_run(plan, args, scale_loops)[1]


def breakdown(plan, top: int = 25, args=None, scale_loops: bool = True):
    """Per (op, output shape) rows, heaviest bytes first, as the walker's:
    (bytes, flops, opcode, name, shape, calls) with loop multipliers
    applied; a kernel's row has opcode "kernel" and its name."""
    return counted_run(plan, args, scale_loops, top)[2]
