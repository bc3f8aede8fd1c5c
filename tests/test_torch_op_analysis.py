"""The port's work counter (repro_torch/launch/op_analysis.py) against the
JAX package's HLO walker (repro/launch/hlo_analysis.py), on the CPU.

`tests/test_dryrun.py`'s walker tests parse HLO text, which the port has
none of; what replaces them here: the FLOPs the port counts from the aten
ops a plan executes equal the walker's count of the reference plan
compiled on a 1 x 1 mesh, at the smoke configs, for the LM train,
prefill and decode plans and for DLRM's serve and retrieval plans (the
GNN plans: tests/test_torch_op_analysis_gnn.py). One gap is XLA's, and
is asserted: a product whose contracted dim is 1 is an outer product,
which XLA rewrites as a broadcast multiply and the walker does not count,
where torch runs it as a product; DLRM's train step has one (the top MLP's
last layer, [B, 16] x [16, 1], whose input gradient contracts over 1).

Then: the loop scaling is exact (a train plan's microbatch loop counted
once and scaled gives the counts of the unscaled run, which equal
`FlopCounterMode`'s); the bytes of a small op sequence are its hand count;
each kernel's calls in a smoke wharf cell equal the calls of its plain
twin, counted by wrapping the twins, and its bytes the bound formula on
them; the sharded cell's collectives are one all-reduce a batch and one
all-to-all a rewalk step; and the breakdown's rows sum to the totals."""
import jax
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from _torch_wharf import jax_inputs, jax_mesh, port_args, registries  # noqa: F401
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro_torch.core import packed_store
from repro_torch.kernels import delta, szudzik
from repro_torch.launch import op_analysis, steps
from repro_torch.launch.steps import CellPlan
from repro_torch.tree import leaf_paths


def walker_flops(arch, shape) -> float:
    jp = jsteps.build_cell(arch, shape, jax_mesh(), smoke=True)
    compiled = jax.jit(jp.fn, in_shardings=jp.in_shardings, out_shardings=jp.out_shardings,
                       donate_argnums=jp.donate_argnums).lower(*jp.args).compile()
    return hlo_analyze(compiled.as_text()).flops


EXACT = [("gemma2-2b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
EXACT += [("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
          ("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "retrieval_cand")]


@pytest.mark.parametrize("arch,shape", EXACT)
def test_flops_equal_the_walkers(arch, shape):
    got = op_analysis.analyze(steps.build_cell(arch, shape, smoke=True))
    assert got.flops == walker_flops(arch, shape)
    assert sum(got.flops_by_dtype.values()) == got.flops


def test_dlrm_train_counts_the_product_xla_rewrites():
    plan = steps.build_cell("dlrm-rm2", "train_batch", smoke=True)
    got = op_analysis.analyze(plan).flops
    b = plan.args[2].shape[0]
    w = leaf_paths(plan.args[0])["top/1/w"]
    assert tuple(w.shape) == (16, 1)
    # the last layer's input gradient: [B, 1] x [1, 16], contracted over 1
    assert got - walker_flops("dlrm-rm2", "train_batch") == 2 * b * 16 == 2_097_152


def test_loop_scaling_is_exact():
    """gemma2-2b's train plan at a global batch of 4 (four one-sequence
    microbatches): the first microbatch counted 4x = all four run."""
    cfg = steps.get_arch("gemma2-2b").make_config(True)
    plan = steps._lm_train_plan("gemma2-2b", cfg, dict(kind="train", global_batch=4,
                                                       seq_len=32), None)
    scaled = op_analysis.analyze(plan)
    full = op_analysis.analyze(plan, scale_loops=False)
    assert (scaled.flops, scaled.mem_bytes, scaled.flops_by_dtype) == (
        full.flops, full.mem_bytes, full.flops_by_dtype)
    assert scaled.flops > 0 and scaled.mem_bytes > 0
    with FlopCounterMode(display=False) as fc:
        plan.fn(*plan.args)
    assert fc.get_total_flops() == full.flops
    rows = op_analysis.breakdown(plan, top=10_000)
    assert sum(r[0] for r in rows) == scaled.mem_bytes
    assert sum(r[1] for r in rows) == scaled.flops
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)


def test_bytes_are_the_hand_count():
    def fn(a, b, idx):
        c = a @ b                   # reads 128 + 512 B, writes 256 B; 1,024 FLOPs
        d = c + 1                   # reads 256 B, writes 256 B
        d.reshape(-1)               # a view: no bytes
        torch.empty(5)              # a bare allocation: no bytes
        d.add_(1)                   # in place: d read and written: 512 B
        g = d[idx]                  # a gather: 2 x its 192 B + the 24-B index
        d.index_add_(0, idx, g)     # a scatter: 2 x (index 24 + updates 192)
        return d

    plan = CellPlan("a", "s", "step", fn, (torch.ones(4, 8), torch.ones(8, 16),
                                           torch.tensor([0, 2, 3])), None, None, 0.0)
    t = op_analysis.analyze(plan)
    assert (t.flops, t.mem_bytes, t.output_bytes) == (
        1024.0, 896.0 + 512.0 + 512.0 + 408.0 + 432.0, 256.0)
    assert t.flops_by_dtype == {"float32": 1024.0}
    assert [r[2:] for r in op_analysis.breakdown(plan)] == [
        ("mm", "aten.mm.default", "float32[4,16]", 1.0),
        ("add", "aten.add.Tensor", "float32[4,16]", 1.0),
        ("add_", "aten.add_.Tensor", "float32[4,16]", 1.0),
        ("index_add_", "aten.index_add_.default", "float32[4,16]", 1.0),
        ("index", "aten.index.Tensor", "float32[3,16]", 1.0)]


# where the CPU route finds each twin: the pair, unpair and decode
# wrappers call theirs; packed FINDNEXT's "torch" backend calls its own
TWINS = {"szudzik_pair": (szudzik, "pair_plain"), "szudzik_unpair": (szudzik, "unpair_plain"),
         "delta_decode": (delta, "decode_rows_plain"),
         "find_next_packed": (packed_store, "find_next_packed_plain")}


@pytest.mark.parametrize("shape", ["stream_10k", "serve_batched_q16"])
def test_kernel_calls_are_the_plain_twins_calls(shape, monkeypatch, registries):
    """Each wrapper call on the CPU runs its plain twin once: the counted
    calls = the twins' calls, wrapped here; the pair and unpair bytes = 16
    a code over the twins' operands; none of the twins' own aten ops
    reach the totals."""
    want_plan = jsteps.build_cell("wharf-stream", shape, jax_mesh(), smoke=True)
    plan = steps.build_cell("wharf-stream", shape, smoke=True)
    args = port_args(plan, jax_inputs(want_plan))
    calls = dict.fromkeys(TWINS, 0)
    codes = dict.fromkeys(TWINS, 0)
    for name, (mod, attr) in TWINS.items():
        def counted(*a, _f=getattr(mod, attr), _n=name):
            calls[_n] += 1
            if _n.startswith("szudzik"):
                codes[_n] += torch.broadcast_shapes(*(x.shape for x in a)).numel()
            return _f(*a)
        monkeypatch.setattr(mod, attr, counted)
    with torch.no_grad():
        t = op_analysis.analyze(plan, args)
    assert {k: t.kernel_calls[k] for k in TWINS} == calls
    assert calls["szudzik_pair"] > 0 and calls["szudzik_unpair"] > 0
    assert calls["find_next_packed"] == (8 if shape.startswith("serve") else 0)
    for k in ("szudzik_pair", "szudzik_unpair"):
        assert t.kernel_bytes[k] == 16.0 * codes[k]
    for k in ("intersect_next", "intersect_csr", "fused_rewalk_step", "sgns_step"):
        assert t.kernel_calls[k] == t.kernel_bytes[k] == 0
    assert t.mem_bytes > sum(t.kernel_bytes.values())


def test_sharded_cell_collectives(registries, tmp_path):
    shape = "stream_10k_sharded"
    want_plan = jsteps.build_cell("wharf-stream", shape, jax_mesh(), smoke=True)
    plan = steps.build_cell("wharf-stream", shape, smoke=True)
    args = port_args(plan, jax_inputs(want_plan))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        with torch.no_grad():
            t = op_analysis.analyze(plan, args)
    finally:
        dist.destroy_process_group()
    cfg = steps.get_arch("wharf-stream").make_config(True)
    nb = plan.args[1].shape[0]
    assert t.coll_counts["all-reduce"] == nb
    assert t.coll_counts["all-to-all"] == nb * cfg.length
    # the MAV combine: one int64 key a walk
    n_walks = cfg.n_vertices * cfg.n_walks_per_vertex
    assert t.coll_bytes["all-reduce"] == nb * 8 * n_walks
    assert t.coll_total == t.coll_bytes["all-reduce"] + t.coll_bytes["all-to-all"]
