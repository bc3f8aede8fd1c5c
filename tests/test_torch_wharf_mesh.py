"""The wharf cells on a mesh (repro_torch/launch/steps.py `_wharf_plan`
with a mesh, launch/lockstep.py, launch/dryrun.py), on the CPU: the ranks
of a (2, 4) mesh as 8 lockstep threads of this process, at the smoke
config (64 vertices, 2 walks of 8 a vertex, the shapes' 10,000-edge
batches) on an ER graph of mean degree 10 drawn from a seed.

Held: for each of the ten order-1 cells, the 8 ranks' rows, unsharded
(`steps.unshard_rows`), equal the one-card plan's outputs on the same
inputs bit for bit, and every rank's affected counts the one card's (the
serve cells replicate every argument: every rank's outputs equal the one
card's); the one-card plans are held against the reference's by
tests/test_torch_wharf_plans.py and test_torch_wharf_streams.py. The
counted rank's table is the same whichever rank is delayed at the
collectives, and holds no op of a collective's own copies: the rank that
combines each collective (the last) counts the ops of a rank that does
not. A rank that raises fails the run, naming the rank; a rank that
holds its turn past the timeout fails it with TimeoutError. The dry-run
CLI (`--include-wharf --mesh both`, the production meshes cut to (2, 4)
and (2, 2, 2) here) writes the `|single` and `|multi` keys of an order-1
cell and the one-card record of an order-2 cell, with the line that says
why; `profile_cell` on a mesh lists rank 0's table and its op count, and
refuses an order-2 cell. The reference's 8-device shard_map run and
compiled collectives:
tests/test_torch_wharf_mesh_ref.py."""
import json
import threading
import time
from collections import Counter

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, lockstep, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.tree import leaf_paths

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED, DEGREE, RANKS = 7, 10, 8
ORDER1 = ("stream_10k", "stream_100k", "stream_10k_interleave", "stream_10k_nomerge",
          "stream_10k_pipelined", "stream_10k_pipelined_eager", "stream_10k_mixed",
          "stream_10k_sharded", "serve_batched_q16", "serve_batched_q256")


def smoke():
    return get_arch("wharf-stream").make_config(True)


@pytest.fixture
def mesh():
    with tmesh.fake_mesh((2, 4), ("data", "model")) as m:
        yield m


def mesh_run(shape, mesh, info=None, counted=0, **kw):
    """(plan, args, Run) of a cell's mesh plan on 8 lockstep ranks."""
    cfg = smoke()
    plan = steps.build_cell("wharf-stream", shape, mesh=mesh, smoke=True, info=info)
    one = steps.build_cell("wharf-stream", shape, smoke=True, info=info)
    args, setup, oargs = dryrun.wharf_mesh_inputs(plan, cfg, SEED, CPU, DEGREE, one_card=one)
    # the one-card args of these draws are the draws made anew
    assert_trees_equal(oargs, dryrun.wharf_inputs(one, cfg, SEED, CPU, DEGREE), shape)
    run = lockstep.run(lambda r, _: plan.fn(*args), RANKS, device=CPU, setup=setup,
                       counted=counted, **kw)
    return plan, args, run


def one_card(shape, info=None):
    """The one-card plan's outputs on the same inputs (the sharded cell on
    one lockstep rank: an in-process group of one)."""
    plan = steps.build_cell("wharf-stream", shape, smoke=True, info=info)
    args = dryrun.wharf_inputs(plan, smoke(), SEED, CPU, DEGREE)
    run = lockstep.run(lambda r, _: plan.fn(*args), 1, device=CPU, counted=None)
    return run.outputs[0]


def assert_trees_equal(got, want, what):
    g, w = leaf_paths(got), leaf_paths(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    for k, v in w.items():
        assert g[k].dtype == v.dtype and torch.equal(g[k], v), f"{what}: {k}"


@pytest.mark.parametrize("shape", ORDER1)
def test_cell_on_8_lockstep_ranks_equals_one_card(shape, mesh):
    plan, args, run = mesh_run(shape, mesh)
    want = one_card(shape)
    cfg = smoke()
    if plan.step_name == "walk_serve_step":
        for r, out in enumerate(run.outputs):
            assert_trees_equal(out, want, f"{shape} rank {r}")
        assert run.totals.coll_total == 0
        return
    graph, store, overflow = steps.unshard_rows(args[0], cfg)
    assert not overflow
    if plan.step_name == "walk_update_step":
        assert_trees_equal(store, want, shape)
        assert all(out is args[0]["store"] for out in run.outputs)
    elif plan.step_name == "walk_stream_step":
        assert_trees_equal({"g": graph, "s": store}, {"g": want[0], "s": want[1]}, shape)
        for out in run.outputs:
            assert torch.equal(out[2][0], want[2])
    else:
        w_graph, w_store, _ = steps.unshard_rows(want[0], cfg)
        assert_trees_equal({"g": graph, "s": store}, {"g": w_graph, "s": w_store}, shape)
        for out in run.outputs:
            assert torch.equal(out[1][0], want[1][0])
    # the counted rank pairs its emits each rewalk step and unpairs in its
    # MAV gather and merge
    n_batches = get_arch("wharf-stream").shapes[shape].get("n_batches", 1)
    assert run.totals.kernel_calls["szudzik_pair"] == cfg.length * n_batches
    assert run.totals.kernel_calls["szudzik_unpair"] > 0


def op_calls(rows) -> Counter:
    """Calls by op name of a counted rank's rows (every shape summed)."""
    out = Counter()
    for _, _, opc, name, _, calls in rows:
        out[(opc, name)] += calls
    return out


def test_count_is_deterministic_and_holds_no_collective_copies(mesh, monkeypatch):
    info = dryrun.cut_info("stream_10k_sharded", 2)
    _, _, base = mesh_run("stream_10k_sharded", mesh, info=info, counted=0)
    # the last rank combines every collective: counted, it counts a rank's
    # ops and no more
    _, _, last = mesh_run("stream_10k_sharded", mesh, info=info, counted=RANKS - 1)
    _, _, other = mesh_run("stream_10k_sharded", mesh, info=info, counted=RANKS - 2)
    assert op_calls(last.rows) == op_calls(other.rows)
    assert not any(opc == "amin" for _, _, opc, _, _, _ in last.rows)
    # delay ranks 0 and 5 at each collective: rank 0's table is the same
    post = lockstep.LockstepGroup._collective

    def slow(self, name, t, combine):
        if self.rank() in (0, 5):
            time.sleep(0.002)
        return post(self, name, t, combine)

    monkeypatch.setattr(lockstep.LockstepGroup, "_collective", slow)
    _, _, delayed = mesh_run("stream_10k_sharded", mesh, info=info, counted=0)
    assert delayed.rows == base.rows
    assert delayed.totals.coll_counts == base.totals.coll_counts
    assert delayed.totals.coll_bytes == base.totals.coll_bytes
    cfg = smoke()
    nb, n_walks = 2, cfg.n_vertices * cfg.n_walks_per_vertex
    assert base.totals.coll_counts["all-reduce"] == nb
    assert base.totals.coll_bytes["all-reduce"] == nb * n_walks * 8
    assert base.totals.coll_counts["all-to-all"] == nb * cfg.length
    assert base.totals.coll_bytes["all-to-all"] == (
        nb * cfg.length * RANKS * cfg.shard_spec(RANKS).slab * 8)


def test_a_failing_rank_fails_the_run(mesh):
    plan = steps.build_cell("wharf-stream", "stream_10k", mesh=mesh, smoke=True)
    args, setup, _ = dryrun.wharf_mesh_inputs(plan, smoke(), SEED, CPU, DEGREE)

    def step(rank, _):
        if rank == 3:
            raise ValueError("rank 3 fails")
        return plan.fn(*args)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 3 fails") as e:
        lockstep.run(step, RANKS, device=CPU, setup=setup, timeout=30)
    assert any("rank 3 of 8" in n for n in e.value.__notes__)
    assert time.monotonic() - t0 < 30
    assert not [t for t in threading.enumerate() if t.name.startswith("lockstep-rank")]


def test_a_stuck_rank_times_out():
    release = threading.Event()

    def step(rank, _):
        if rank == 1:
            release.wait(20)      # holds its turn past the timeout
        return rank

    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError, match="rank 1 holds it"):
            lockstep.run(step, 4, device=CPU, timeout=0.5, counted=None)
        assert time.monotonic() - t0 < 10
    finally:
        release.set()
    assert lockstep.run(step, 4, device=CPU, counted=None).outputs == [0, 1, 2, 3]


def test_cli_records_the_mesh_keys(tmp_path, monkeypatch):
    small = {False: ((2, 4), ("data", "model")), True: ((2, 2, 2), ("pod", "data", "model"))}
    monkeypatch.setattr(tmesh, "production_shape", lambda multi_pod=False: small[multi_pod])
    out = tmp_path / "dry.json"
    cells = ["--cell", "wharf-stream/stream_10k", "--cell", "wharf-stream/stream_10k_n2v_rejection",
             "--cell", "wharf-stream/serve_batched_q16"]
    assert dryrun.main(["--arch", "wharf-stream", "--include-wharf", "--mesh", "both",
                        "--smoke", "--device", "cpu", "--wharf-batches", "1", "--out",
                        str(out)] + cells) == 0
    recs = json.loads(out.read_text())
    assert sorted(recs) == ["wharf-stream|serve_batched_q16|multi",
                            "wharf-stream|serve_batched_q16|single",
                            "wharf-stream|stream_10k_n2v_rejection|smoke",
                            "wharf-stream|stream_10k|multi", "wharf-stream|stream_10k|single"]
    serve = recs["wharf-stream|serve_batched_q16|single"]
    assert serve["n_cards"] == 8 and serve["partition"].startswith("replicated")
    assert serve["flops_per_card"] > 0 and sum(serve["collective_counts"].values()) == 0
    for key in ("wharf-stream|stream_10k|single", "wharf-stream|stream_10k|multi"):
        r = recs[key]
        assert r["n_cards"] == 8 and r["partition"].startswith("explicit")
        assert r["collective_counts"]["all-reduce"] == 1
        assert r["collective_counts"]["all-to-all"] == smoke().length
        assert r["kernel_calls"]["szudzik_pair"] > 0 and r["memory"]["peak_bytes"] is None
        assert r["cut"]["n_vertices"] == 64 and r["memory"]["peak_note"] == dryrun.PEAK_NOTE
    assert recs["wharf-stream|stream_10k|single"]["mesh"] == "2x4"
    assert recs["wharf-stream|stream_10k|multi"]["mesh"] == "2x2x2"
    r2 = recs["wharf-stream|stream_10k_n2v_rejection|smoke"]
    assert (r2["mesh"], r2["n_cards"], r2["note"]) == ("1", 1, dryrun.ORDER2_NOTE)
    assert r2["cut"]["n_batches"] == 1


def test_profile_cell_lists_a_rank_table(mesh, capsys):
    from repro_torch.launch import profile_cell
    prof = profile_cell.profile_cell("wharf-stream", "stream_10k", smoke=True, device="cpu",
                                     mesh=mesh, top=5)
    assert prof["mesh"] == "2x4" and len(prof["static"]) == 5 and "device_ops" not in prof
    assert prof["op_calls"] > sum(r[5] for r in prof["static"])
    assert prof["totals"].coll_counts["all-to-all"] == smoke().length
    profile_cell.print_profile(prof)
    out = capsys.readouterr().out
    assert "on the 2x4 mesh, one rank" in out and "ops counted" in out
    with pytest.raises(ValueError, match="order 1 only"):
        profile_cell.profile_cell("wharf-stream", "stream_10k_n2v_rejection", smoke=True,
                                  device="cpu", mesh=mesh)
