"""Logical activation-sharding constraints (port of
`repro/models/act_sharding.py`).

Model code calls `constrain(x, "batch", None, "tp")` with logical axis
names, one a tensor dim. Under `launch.mesh.set_mesh(mesh)` the names
resolve to the mesh dims that exist ("pod"/"data"/"model"), and a DTensor
`x` is redistributed to those placements; a plain tensor, or any tensor
with no mesh set, passes through unchanged. So the model stays one source
for one card and for a mesh of ranks.

The helpers below serve the models' partitioned steps (DTensors under
`set_mesh`, `launch.steps.partition`); each is the identity, or the plain
op, on plain tensors:
  * `reshard`: the port's own placements (`constrain`'s, but a spec that
    names no mesh dim makes `x` whole);
  * `on_mesh`: a tensor a step makes itself, replicated on its inputs'
    mesh; `gather_fsdp`: a weight with its FSDP dims gathered where the
    activations' batch is cut;
  * written on each rank's shards: `row_lookup` (a masked lookup of
    row-sharded tables), `gather_rows` (an edge gather), `on_rows` (an op
    within each row) and `on_whole` (an op on every rank's whole copy);
  * `from_local` / `to_local`: DTensor's, as autograd Functions whose
    gradient placements are the same in every torch release;
  * `spanning`, `cut`, `shard_range`, `extent`, `all_reduce`, `whole`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import current_mesh

# logical -> candidate mesh dims (those the mesh has are used, in order)
_LOGICAL = {
    "batch": ("pod", "data"),   # data-parallel batch shards
    "fsdp": ("data",),
    "tp": ("model",),           # tensor/vocab/head/expert parallel
    "seq": ("model",),          # sequence sharding (context parallel)
    "expert": ("model",),
    None: (),
}


def _resolve(logical, axis_names) -> Optional[Tuple[str, ...]]:
    if logical is None:
        return None
    axes = tuple(a for a in _LOGICAL[logical] if a in axis_names)
    return axes if axes else None


def extent(logical) -> int:
    """The number of shards the ambient mesh cuts a logical axis into (1
    without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    n = 1
    for a in _resolve(logical, mesh.mesh_dim_names) or ():
        n *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return n


def resolved_placements(mesh, *logical_spec):
    """The DTensor placements (one a mesh dim) of a logical spec on
    `mesh`, or None where it names no dim of the mesh."""
    from repro_torch.launch.sharding import P, placements
    spec = tuple(_resolve(name, mesh.mesh_dim_names) for name in logical_spec)
    if all(s is None for s in spec):
        return None
    return placements(P(*spec), mesh.mesh_dim_names)


def constrain(x, *logical_spec):
    """`x` redistributed to the logical spec's placements on the ambient
    mesh (a DTensor under `set_mesh`; else `x`); a spec that names no mesh
    dim leaves `x` as it is, as the reference's."""
    return _place(x, logical_spec, explicit=False)


def reshard(x, *logical_spec):
    """`constrain` for the port's own placements: a spec that names no
    mesh dim makes `x` whole (replicated) on the mesh, and a logical axis
    whose mesh dims do not divide its tensor dim leaves that dim whole (a
    batch of one is not cut)."""
    return _place(x, logical_spec, explicit=True)


def _place(x, logical_spec, explicit: bool):
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    if explicit:
        logical_spec = [name if name is None or x.shape[d] % extent(name) == 0 else None
                        for d, name in enumerate(logical_spec)]
    place = resolved_placements(mesh, *logical_spec)
    if place is None:
        if not explicit:
            return x
        place = (Replicate(),) * mesh.ndim
    if tuple(place) == tuple(x.placements):
        return x
    return x.redistribute(mesh, place)


def on_mesh(t, like):
    """`t`, made inside a step, as a DTensor replicated on the mesh of
    `like` when `like` is a DTensor; else `t` unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def spanning(x, dim: int) -> Tuple[int, ...]:
    """The mesh dims whose placement shards tensor dim `dim` of DTensor
    `x`, in mesh order."""
    from torch.distributed.tensor import Shard
    d = dim % x.dim()
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim % x.dim() == d)


def cut(n: int, mesh, mesh_dims) -> Tuple[int, int]:
    """(start, size) of this rank's slice of a dim of `n` that the mesh
    dims `mesh_dims` shard: each cuts it as `torch.chunk` does, in mesh
    order (rank 0's slice is the largest where a dim does not divide)."""
    coord = mesh.get_coordinate()
    start = 0
    for i in mesh_dims:
        size = -(-n // mesh.shape[i])
        lo = min(n, coord[i] * size)
        start, n = start + lo, min(n, lo + size) - lo
    return start, n


def shard_range(x, dim: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of tensor dim `dim` of DTensor
    `x` (`cut`)."""
    return cut(x.shape[dim], x.device_mesh, spanning(x, dim))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _FromLocal(torch.autograd.Function):
    """`DTensor.from_local` whose gradient reaches `local` whole where the
    placements are partial sums (each rank's term of a sum has the sum's
    gradient), in every torch release: torch 2.11's own `from_local` turns
    a replicated gradient into partial terms again on the way back."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape, stride):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        ctx.mesh = mesh
        ctx.grad_placements = tuple(Replicate() if isinstance(p, Partial) else p
                                    for p in placements)
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.grad_placements:
            grad = grad.redistribute(ctx.mesh, ctx.grad_placements)
        return grad.to_local(), None, None, None, None


def from_local(local, mesh, placements, shape):
    """A DTensor of global `shape` (contiguous) whose shard here is `local`
    (`_FromLocal`)."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return _FromLocal.apply(local.contiguous(), mesh, tuple(placements), torch.Size(shape),
                            tuple(reversed(stride)))


class _ToLocal(torch.autograd.Function):
    """A DTensor's local shard whose gradient comes back with the given
    placements (`DTensor.to_local`'s `grad_placements`, which not every
    torch release has)."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.mesh, ctx.grad_placements = x.device_mesh, grad_placements
        ctx.shape, ctx.stride = x.shape, x.stride()
        return x.to_local().view_as(x.to_local())

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(grad, ctx.mesh, ctx.grad_placements, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride), None


def to_local(x, *cut_by):
    """The local shard of DTensor `x` for a computation with operands
    `cut_by`: where `x` is whole on a mesh dim that cuts one of them, each
    rank's gradient of its copy is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    grad = tuple(Partial() if isinstance(p, Replicate)
                 and any(isinstance(o.placements[i], Shard) for o in cut_by) else p
                 for i, p in enumerate(x.placements))
    if grad == tuple(x.placements):
        return x.to_local()
    return _ToLocal.apply(x, grad)


def row_lookup(table, idx):
    """`table[idx]` of a DTensor table whose rows (dim 0) are cut over
    mesh dims (a vocab, a feature table, a neighbor array): each rank
    looks up the ids its rows hold, zeros elsewhere, and the partial rows
    are summed over those mesh dims. The rows are never gathered. A mesh
    dim that cuts both `idx` and another dim of the table (FSDP) is
    gathered on the table first. -> placed as `idx` on its dims, a table
    dim still cut on a mesh dim cut the same in the output."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    table = gather_fsdp(table, idx, dim=None)
    mesh = table.device_mesh
    rows = spanning(table, 0)
    idx = idx.redistribute(mesh, [Replicate() if i in rows else p
                                  for i, p in enumerate(idx.placements)])
    r0, n_rows = shard_range(table, 0)
    local, ids = to_local(table, idx), idx.to_local().long()
    mine = (ids >= r0) & (ids < r0 + n_rows)
    out = local[torch.where(mine, ids - r0, 0)]
    out = out * mine.reshape(mine.shape + (1,) * (local.dim() - 1)).to(out.dtype)
    k = idx.dim()
    place = [Partial() if i in rows else Shard(tp.dim - 1 + k) if isinstance(tp, Shard)
             else ip for i, (tp, ip) in enumerate(zip(table.placements, idx.placements))]
    out = from_local(out, mesh, place, tuple(idx.shape) + tuple(table.shape[1:]))
    return out.redistribute(mesh, [Replicate() if i in rows else p for i, p in enumerate(place)])


def all_reduce(t, op: str, mesh, dims):
    """`t` reduced by `op` ("sum", "max") over the mesh dims `dims`, one
    functional all-reduce a mesh dim."""
    import torch.distributed._functional_collectives as funcol
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
    return t


def gather_fsdp(w, x, dim=0):
    """Weight `w` as a product with activations `x` takes it: where `x`'s
    batch (dim 0; any dim with `dim` None) is cut over a mesh dim that
    also cuts `w` (FSDP), that mesh dim of `w` is gathered, so each rank
    multiplies its batch rows by whole columns; where the batch is whole
    (a single stream), `w` stays cut and the product is partial. `w`
    unchanged off a mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(w, DTensor) and isinstance(x, DTensor)):
        return w
    place = [Replicate() if isinstance(xp, Shard) and (dim is None or xp.dim == dim)
             and isinstance(wp, Shard) else wp
             for xp, wp in zip(x.placements, w.placements)]
    return w.redistribute(w.device_mesh, place) if place != list(w.placements) else w


def whole(x):
    """The whole value of DTensor `x` on this rank, a plain tensor
    (gathered where it is cut); `x` itself when it is plain."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim).to_local()


def gather_rows(x, ids):
    """`x[ids]` of a DTensor `x` and index tensor `ids` (a DTensor, or a
    plain one the same on every rank): `x` gathered whole on every rank,
    each rank indexing with its own ids. -> placed as `ids` on its dims."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    ids = on_mesh(ids, x)
    xr = x.redistribute(mesh, (Replicate(),) * mesh.ndim)
    out = to_local(xr, ids)[ids.to_local()]
    return from_local(out, mesh, ids.placements, tuple(ids.shape) + tuple(x.shape[1:]))


def on_rows(fn, x, *more):
    """`fn(x, *more)` of tensors whose dim 0 is the same rows: on a DTensor
    `x`, each rank applies it to its own rows (the other dims made whole)
    and the result keeps `x`'s placements; plain `fn` otherwise. For ops
    that act within a row (an index along dim 1)."""
    if not is_dtensor(x):
        return fn(x, *more)
    x = reshard(x, "batch", *[None] * (x.dim() - 1))
    mesh = x.device_mesh
    more = [m.redistribute(mesh, x.placements) for m in more]
    out = fn(to_local(x), *(to_local(m) for m in more))
    return from_local(out, mesh, x.placements, (x.shape[0],) + tuple(out.shape[1:]))


def on_whole(fn, *xs):
    """`fn(*xs)` on every rank's whole copy of DTensor `xs` (made whole
    first), the result replicated; plain `fn` on plain tensors. For ops
    that read every row (the MoE's capacity slots), and for ops DTensor
    cannot take (`index_put`'s backward in torch 2.11)."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import Replicate
    mesh = xs[0].device_mesh
    whole_place = (Replicate(),) * mesh.ndim
    out = fn(*(to_local(x.redistribute(mesh, whole_place)) for x in xs))
    return from_local(out, mesh, whole_place, tuple(out.shape))
