"""The port's wharf-family cell plans (repro_torch/launch/steps.py
`_wharf_plan`) against the JAX package's on a 1 x 1 mesh (no
`jax.set_mesh`: 12 of the 13 reference plans refuse to lower under it), on
the CPU.

Held, for all 13 shapes of WHARF_SHAPES at the smoke and the full
configs: the step name, every argument leaf's path and shape with its
dtype in the port's representation (u64 codes biased int64, u32 columns
int32, PRNG keys int64), `model_flops` and the donated arguments. Then at
the smoke config the update and serve plans' steps on the same seeded
inputs, the reference's jitted: every output leaf bit for bit (the stream
cells: tests/test_torch_wharf_streams.py). The reference behaviours
the port keeps: stream_10k and stream_100k have one `model_flops`; smoke
plans keep the shape's 10,000-edge batches; the update plans merge by
lexsort unless the shape says otherwise; a plan of an explicit-backend
shape installs it process-wide (the megakernel cell turns the fused step
on: "cuda" in the port, "pallas" in the reference, which on the CPU
resolves to its interpret math, the port's "torch")."""
import pytest

from _torch_wharf import (SHAPES, check_smoke_run, jax_mesh, port_leaf_dtypes,  # noqa: F401
                          registries)
from repro.launch import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.kernels import megakernel
from repro_torch.launch import steps
from repro_torch.tree import leaf_paths

KEY_ARG = {"walk_update_step": 5, "walk_stream_step": 2, "walk_stream_sharded_step": 1}


def _leaves(plan) -> dict:
    out = {}
    for k, v in leaf_paths(plan.args).items():
        assert v.is_meta, k
        out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def test_shapes_are_the_registry():
    assert tuple(get_arch("wharf-stream").shapes) == SHAPES


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_matches_jax(shape, smoke, registries):
    want = jsteps.build_cell("wharf-stream", shape, jax_mesh(), smoke=smoke)
    got = steps.build_cell("wharf-stream", shape, smoke=smoke)
    assert (got.arch, got.shape, got.step_name) == (want.arch, want.shape, want.step_name)
    ki = KEY_ARG.get(want.step_name)
    keys = () if ki is None else (str(ki),)
    assert _leaves(got) == port_leaf_dtypes(want.args, keys)
    assert got.model_flops == want.model_flops
    assert (got.donate_argnums, got.static_argnums) == (want.donate_argnums,
                                                        want.static_argnums)
    assert got.in_shardings is None and got.out_shardings is None


def test_reference_behaviours_are_kept(registries):
    smoke = {s: steps.build_cell("wharf-stream", s, smoke=True) for s in
             ("stream_10k", "stream_100k", "stream_10k_pipelined")}
    assert smoke["stream_10k"].model_flops == smoke["stream_100k"].model_flops
    assert smoke["stream_10k"].args[2].shape == (10_000,)      # not the smoke 16
    assert smoke["stream_10k_pipelined"].args[3].shape == (8, 10_000)
    assert megakernel.default_backend_request() is None
    steps.build_cell("wharf-stream", "stream_10k_n2v_megakernel", smoke=True)
    assert megakernel.default_backend_request() == "cuda"


RUN_HERE = ("stream_10k", "stream_100k", "stream_10k_interleave", "stream_10k_nomerge",
            "serve_batched_q16", "serve_batched_q256")


@pytest.mark.parametrize("shape", RUN_HERE)
def test_smoke_plan_runs_like_jax(shape, registries, tmp_path):
    """The update and serve cells (the stream cells:
    tests/test_torch_wharf_streams.py)."""
    check_smoke_run(shape, tmp_path)
