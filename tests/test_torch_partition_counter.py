"""The work counter on partitioned steps (repro_torch/launch/op_analysis.py
on DTensors), the placement helpers of `steps.partition` and
`models/act_sharding.py`, the gloo routes of `distr/collectives.py`, and
the `--mesh` front ends of the dry-run and `profile_cell`, on the CPU over
a "fake" process group of 256 ranks (the 16 x 16 mesh; no collective moves
data).

Held: a DTensor product counts its local FLOPs at the shard shapes and the
all-gather of its weight by its output bytes a rank; a Partial -> Shard
move is one reduce-scatter, a Shard(0) -> Shard(1) move one all-to-all
(where the CPU mesh runs an all-gather and a chunk); the ops of sharding
propagation (FakeTensors) count nothing; a uniform loop of DTensors is
scaled exactly; rank 0's shard shapes follow `torch.chunk`; the gloo route
of the Shard -> Shard move equals DTensor's own on 4 gloo ranks;
`profile_cell --multi` prints one rank's table and collectives; the CLI
keys its records by mesh."""
import json
import types

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distr import ranks
from repro_torch.launch import dryrun, op_analysis, profile_cell, steps
from repro_torch.models.act_sharding import from_local, shard_range


@pytest.fixture
def mesh():
    with dryrun.fake_mesh(False) as m:
        yield m


def meta(mesh, shape, placements):
    """A meta DTensor of global `shape`: rank 0's shard."""
    local = torch.empty(steps.local_shape(shape, placements, mesh), device="meta")
    return from_local(local, mesh, placements, shape)


def count(fn, *args, scale_loops=True):
    return op_analysis.analyze(types.SimpleNamespace(fn=fn, args=args), args,
                               scale_loops=scale_loops)


def kinds(t):
    return {k: (t.coll_counts[k], t.coll_bytes[k]) for k in t.coll_counts if t.coll_counts[k]}


def test_matmul_counts_local_flops_and_the_gather_of_its_weight(mesh):
    x = meta(mesh, (64, 32), (Shard(0), Replicate()))       # the batch over "data"
    w = meta(mesh, (32, 64), (Shard(0), Shard(1)))          # FSDP rows, TP columns
    t = count(lambda x, w: x @ w.redistribute(mesh, (Replicate(), Shard(1))), x, w)
    assert t.flops == 2 * 4 * 32 * 4 and t.flops_by_dtype == {"float32": t.flops}
    assert kinds(t) == {"all-gather": (1, 32 * 4 * 4)}      # the gathered [32, 4] shard


def test_partial_to_shard_is_one_reduce_scatter(mesh):
    p = from_local(torch.empty(16, 16, device="meta"), mesh, (Partial(), Replicate()), (16, 16))
    t = count(lambda p: p.redistribute(mesh, (Shard(0), Replicate())), p)
    assert kinds(t) == {"reduce-scatter": (1, 1 * 16 * 4)}


def test_shard_to_shard_is_one_all_to_all(mesh):
    x = meta(mesh, (32, 32), (Shard(0), Replicate()))
    t = count(lambda x: x.redistribute(mesh, (Shard(1), Replicate())), x)
    assert kinds(t) == {"all-to-all": (1, 32 * 2 * 4)}      # its output shard, no gather


def test_sharding_propagation_counts_nothing(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = meta(mesh, (64, 32), (Shard(0), Replicate()))

    def fn(x):
        with FakeTensorMode():
            a = torch.empty(8, 8)
            a @ a
        return x * 2.0
    t = count(fn, x)
    assert t.flops == 0 and t.mem_bytes == 2 * 4 * 32 * 4   # the local mul alone
    assert not kinds(t)


def test_uniform_loop_of_dtensors_scales_exactly(mesh):
    xs = meta(mesh, (4, 64, 32), (Shard(1), Replicate()))
    w = meta(mesh, (32, 64), (Replicate(), Shard(1)))

    def fn(xs, w):
        return [x @ w for x in op_analysis.uniform_loop(xs)]
    scaled, full = count(fn, xs, w), count(fn, xs, w, scale_loops=False)
    assert scaled.flops == full.flops == 4 * 2 * 4 * 32 * 4
    assert scaled.mem_bytes == full.mem_bytes


def test_rank_zero_holds_the_largest_shard(mesh):
    assert steps.local_shape((10, 40, 7), (Shard(0), Shard(1)), mesh) == (1, 3, 7)
    assert steps.local_shape((33,), (Shard(0), Shard(0)), mesh) == (1,)
    x = meta(mesh, (10, 40, 7), (Shard(0), Shard(1)))
    assert [shard_range(x, d) for d in range(3)] == [(0, 1), (0, 3), (0, 7)]
    assert tuple(x.to_local().shape) == (1, 3, 7)


def rank_shard_dim_route(rank, _):
    """DTensor's Shard(0) -> Shard(1) move and the gloo route of it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distr import collectives
    m = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    full = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    d = distribute_tensor(full, m, (Replicate(), Shard(0)))
    want = d.redistribute(m, (Replicate(), Shard(1))).to_local()
    got = collectives._shard_dim_all_to_all(d.to_local(), 0, 1, m.get_group(1).group_name)
    return torch.equal(got, want), tuple(got.shape)


def test_gloo_route_of_the_shard_to_shard_move(tmp_path):
    out = ranks.spawn(rank_shard_dim_route, 4, None, str(tmp_path))
    assert out == [(True, (8, 6, 3))] * 4


def test_profile_cell_multi_prints_one_ranks_table(capsys):
    assert profile_cell.main(["--arch", "dlrm-rm2", "--shape", "serve_p99", "--multi",
                              "--top", "4"]) == 0
    text = capsys.readouterr().out
    assert "dlrm-rm2 x serve_p99 (serve_step) on the 2x16x16 mesh, one rank" in text
    assert "collectives: all-reduce 1 x 1.065e+05B" in text
    assert "float32[16,256]" in text                          # 512 rows over 32 batch shards


def test_cli_keys_records_by_mesh(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--cell", "dlrm-rm2/serve_p99", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert sorted(recs) == ["dlrm-rm2|serve_p99|multi", "dlrm-rm2|serve_p99|single"]
    assert [recs[f"dlrm-rm2|serve_p99|{m}"]["mesh"] for m in ("single", "multi")] == [
        "16x16", "2x16x16"]
    assert recs["dlrm-rm2|serve_p99|single"]["memory"]["argument_bytes"] < 26 * 10**6 * 64 * 4
