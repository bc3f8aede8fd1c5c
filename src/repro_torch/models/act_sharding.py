"""Logical activation-sharding constraints (port of
`repro/models/act_sharding.py`).

Model code calls `constrain(x, "batch", None, "tp")` with logical axis
names, one a tensor dim. Under `launch.mesh.set_mesh(mesh)` the names
resolve to the mesh dims that exist ("pod"/"data"/"model"), and a DTensor
`x` is redistributed to those placements; a plain tensor, or any tensor
with no mesh set, passes through unchanged. So the model stays one source
for one card and for a mesh of ranks.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def resolved_placements(mesh, *logical_spec):
    """The DTensor placements (one a mesh dim) of a logical spec on
    `mesh`, or None where it names no dim of the mesh."""
    from repro_torch.launch.sharding import P, placements
    spec = tuple(_resolve(name, mesh.mesh_dim_names) for name in logical_spec)
    if all(s is None for s in spec):
        return None
    return placements(P(*spec), mesh.mesh_dim_names)


def constrain(x, *logical_spec):
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    place = resolved_placements(mesh, *logical_spec)
    if place is None:
        return x
    return x.redistribute(mesh, place)
