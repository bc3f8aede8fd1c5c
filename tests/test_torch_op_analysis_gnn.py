"""The port's work counter on the GNN plans against the JAX package's HLO
walker (the reference plan compiled on a 1 x 1 mesh), at the smoke
configs, on the CPU: every full-graph and sampled cell of the four archs.
equiformer-v2 differs by one product, and the gap is asserted: its species
embedding `[N, 1] x [1, w]` contracts over a dim of 1 (an outer product,
which XLA rewrites as a broadcast multiply and the walker does not count),
and so does the weight gradient of that one-row weight, `[1, N] x [N, w]`
seen from the single species column; the sampled cell runs the forward
alone (no gradient), so only the forward product is missing there."""
import pytest

from repro_torch.configs import GNN_SHAPES
from repro_torch.launch import op_analysis, steps
from repro_torch.tree import leaf_paths
from test_torch_op_analysis import walker_flops

CELLS = [(a, s) for a in ("meshgraphnet", "equiformer-v2", "gat-cora", "graphsage-reddit")
         for s in GNN_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_equal_the_walkers(arch, shape):
    plan = steps.build_cell(arch, shape, smoke=True)
    got = op_analysis.analyze(plan).flops
    gap = 0
    if arch == "equiformer-v2":
        w = leaf_paths(plan.args[0])["embed/0/w"]
        assert w.shape[0] == 1
        sampled = GNN_SHAPES[shape]["kind"] == "sampled"
        if sampled:
            info = GNN_SHAPES[shape]
            f1, f2 = info["fanout"]
            n = info["batch_nodes"] * (1 + f1 + f1 * f2)
        else:
            n = plan.args[2]["species"].shape[0]
        gap = (1 if sampled else 2) * 2 * n * w.shape[1]
    assert got - walker_flops(arch, shape) == gap
