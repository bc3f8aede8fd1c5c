"""Production meshes and the card's roofline constants (port of
`repro/launch/mesh.py`).

Single pod:  (data=16, model=16)          = 256 ranks
Multi-pod:   (pod=2, data=16, model=16)   = 512 ranks

Axis roles, as the reference's:
  pod    pure DP across pods (gradient all-reduce)
  data   FSDP / batch within a pod; also the walk-shard axis for Wharf
  model  TP / EP / embedding-row / vertex-shard axis

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
an initialized default process group (one process a card; a process group
of the "fake" backend builds one in a single process, as the dry-run and
the tests do). `set_mesh` makes a mesh the ambient one for
`models/act_sharding.py`, where the reference uses `jax.set_mesh`.
Importing this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib

import torch

# the ambient mesh, process-wide: autograd runs a card's backward (and
# its checkpointed recompute) on a thread of its own, which a ContextVar
# would not reach
_AMBIENT = [None]


def production_shape(multi_pod: bool = False):
    """(shape, dim names) of the single-pod or the multi-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the default process group's ranks, whose
    world size must be the mesh's (256 or 512). `device_type` "cpu" builds
    it for CPU tensors (the tests, the meta dry-run)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A mesh of `shape` and dim `names` over a process group of the
    "fake" backend of its size in this process (rank 0; no collective
    moves data), destroyed after: what the dry-run counts a rank on."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", world_size=math.prod(shape), rank=0, store=FakeStore())
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def batch_axes(mesh) -> tuple:
    """Mesh dims over which the global batch is sharded."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def mesh_size(mesh) -> int:
    return mesh.size()


@contextlib.contextmanager
def set_mesh(mesh):
    """Make `mesh` the ambient mesh inside the block (`jax.set_mesh`)."""
    saved, _AMBIENT[0] = _AMBIENT[0], mesh
    try:
        yield mesh
    finally:
        _AMBIENT[0] = saved


def current_mesh():
    """The ambient mesh, or None outside `set_mesh`."""
    return _AMBIENT[0]


# NVIDIA H100 80GB HBM3 (SXM, 700 W) roofline constants, per card, from
# NVIDIA's data sheet: dense rates without sparsity.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s each way (900 GB/s both ways)


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for products in `dtype`: bf16/f16 on the
    tensor cores, every other type at the f32 rate outside them."""
    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) else PEAK_FLOPS_F32
