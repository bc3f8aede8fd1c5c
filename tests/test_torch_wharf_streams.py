"""The wharf family's stream cell plans (repro_torch/launch/steps.py
`_wharf_plan`, kinds walk_stream and walk_stream_sharded) at the smoke
config on the CPU: each plan's step on seeded inputs against the JAX
package's plan on a 1 x 1 mesh, jitted, every output leaf bit for bit
(graph, store, affected counts; the sharded cell's stacked state on a
one-rank gloo group against the one-device shard_map, and it raises
without a process group). The fused-step cell runs the port's "torch"
fused step, the math the reference's "pallas" runs off the TPU. The
metadata of every plan and the other cells' runs:
tests/test_torch_wharf_plans.py."""
import pytest

from _torch_wharf import check_smoke_run, registries  # noqa: F401

STREAMS = ("stream_10k_pipelined", "stream_10k_pipelined_eager", "stream_10k_mixed",
           "stream_10k_sharded", "stream_10k_n2v_rejection", "stream_10k_n2v_factorized",
           "stream_10k_n2v_megakernel")


@pytest.mark.parametrize("shape", STREAMS)
def test_smoke_plan_runs_like_jax(shape, registries, tmp_path):
    check_smoke_run(shape, tmp_path)
