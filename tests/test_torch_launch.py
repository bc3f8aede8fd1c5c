"""The port's launcher (`repro_torch.launch.train`) against the JAX
package's on the CPU, at the `wharf-stream` smoke config: `wharf_trainer`
and `downstream_trainer` through each package's TrainLoop with the same
seed (6 steps, a checkpoint every 3), a crash and resume, and `main()`.

Held: the engine states bit for bit; the metrics dicts exactly, apart from
the f32 loss (rtol 1e-5, the maintainer's tolerance); the SGNS tables
within rtol 2e-4 / atol 1e-5 (the reference's own for a scatter-added
step). A resumed `--mode downstream` run equals the uninterrupted one bit
for bit in every leaf; a resumed `--mode stream` run continues from a
freshly built engine, as the reference's does (its carry holds only the
store's codes)."""
import inspect

import numpy as np
import pytest
import torch

from _torch_parity import TABLE_TOL, assert_state_dicts_equal, jax_state_to_numpy
from repro_torch import convert
from repro_torch.launch import train as tlaunch
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.runtime import TrainLoop
from repro_torch.tree import leaf_paths

ARCH, BATCH_EDGES, DIM, STEPS, EVERY = "wharf-stream", 32, 16, 6, 3


def run_loop(pkg: str, mode: str, ckpt_dir, steps: int, resume: bool = False):
    """Build `pkg`'s trainer ("jax" or "torch") and run `steps` TrainLoop
    steps (after `resume` when asked) -> (carry, metrics by step, engine,
    first step)."""
    if pkg == "jax":
        from repro.launch import train as launch
        from repro.train.checkpoint import CheckpointManager as Mgr
        from repro.train.runtime import TrainLoop as Loop
        dev = {}
    else:
        launch, Mgr, Loop, dev = tlaunch, CheckpointManager, TrainLoop, {"device": "cpu"}
    on_restore = None
    if mode == "downstream":
        state, step_fn, batch_fn, on_restore = launch.downstream_trainer(
            ARCH, True, BATCH_EDGES, DIM, **dev)
    else:
        state, step_fn, batch_fn = launch.wharf_trainer(ARCH, True, BATCH_EDGES, **dev)
    loop = Loop(step_fn=step_fn, batch_fn=batch_fn, ckpt=Mgr(str(ckpt_dir)),
                ckpt_every=EVERY, on_restore=on_restore, **dev)
    start = 0
    if resume:
        state, start = loop.resume(state)
    metrics = {}
    state = loop.run(state, start, steps,
                     lambda step, dt, m: metrics.__setitem__(step, m))
    closure = inspect.getclosurevars(step_fn).nonlocals
    engine = (closure["mt"].state.engine if mode == "downstream"
              else closure["engine"].state)
    return state, metrics, engine, start


def assert_metrics_match(got: dict, want: dict):
    """The loop's straggler flag is a matter of timing: not compared."""
    assert sorted(got) == sorted(want)
    for step, m in want.items():
        g = {k: v for k, v in got[step].items() if k != "straggler"}
        m = {k: v for k, v in m.items() if k != "straggler"}
        assert set(g) == set(m), step
        for k, v in m.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            else:
                assert g[k] == v and type(g[k]) is type(v), (step, k)


def assert_engines_match(t_engine, j_engine):
    assert_state_dicts_equal(jax_state_to_numpy(j_engine),
                             convert.state_to_numpy(t_engine))


def test_downstream_trainer_matches_jax_and_resumes(tmp_path):
    jstate, jm, jeng, _ = run_loop("jax", "downstream", tmp_path / "j", STEPS)
    tstate, tm, teng, _ = run_loop("torch", "downstream", tmp_path / "t", STEPS)
    assert_metrics_match(tm, jm)
    assert_engines_match(tstate.engine, jstate.engine)
    assert teng is tstate.engine        # the maintainer holds the carry
    tables = convert.params_to_numpy(tstate.params)
    for k in ("in", "out"):
        np.testing.assert_allclose(tables[k], np.asarray(jstate.params[k]),
                                   err_msg=k, **TABLE_TOL)
    assert int(tstate.opt["step"]) == int(jstate.opt["step"]) == STEPS
    assert int(tstate.opt["pairs"]) == int(jstate.opt["pairs"]) > 0
    assert sorted(CheckpointManager(str(tmp_path / "t")).all_steps()) == [2, 5]
    # a crash after step 2, and a fresh trainer that resumes
    _, m1, _, _ = run_loop("torch", "downstream", tmp_path / "r", 3)
    rstate, m2, _, start = run_loop("torch", "downstream", tmp_path / "r", 3,
                                    resume=True)
    assert start == 3
    assert_metrics_match({**m1, **m2}, tm)
    want = leaf_paths(tstate)
    for k, v in leaf_paths(rstate).items():
        assert type(v) is type(want[k]), k
        assert (torch.equal(v, want[k]) if isinstance(v, torch.Tensor)
                else v == want[k]), k


def test_wharf_trainer_matches_jax_and_resumes_as_the_reference(tmp_path):
    jstate, jm, jeng, _ = run_loop("jax", "stream", tmp_path / "j", STEPS)
    tstate, tm, teng, _ = run_loop("torch", "stream", tmp_path / "t", STEPS)
    assert_metrics_match(tm, jm)
    assert_engines_match(teng, jeng)
    assert teng.epoch == STEPS
    np.testing.assert_array_equal(convert.state_to_numpy(teng)["store.code"],
                                  convert._TO["u64"](tstate["store_code"]))
    # resumed: the carry is restored, the engine is built afresh (both packages)
    for pkg in ("jax", "torch"):
        run_loop(pkg, "stream", tmp_path / f"r{pkg}", 3)
    jstate2, jm2, jeng2, js = run_loop("jax", "stream", tmp_path / "rjax", 3, resume=True)
    tstate2, tm2, teng2, ts = run_loop("torch", "stream", tmp_path / "rtorch", 3,
                                       resume=True)
    assert js == ts == 3
    assert_metrics_match(tm2, jm2)
    assert_engines_match(teng2, jeng2)
    assert teng2.epoch == 3                 # not 6: a fresh engine went on


def test_main_on_the_cpu(tmp_path, capsys):
    """`main()` with `--device cpu`: both wharf modes and the LM route
    (gemma2-2b smoke, `--batch 2 --seq 16`) run, print a line a step and
    resume from their checkpoints; gnn and recsys exit as the reference
    does."""
    args = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch-edges", "16",
            "--device", "cpu", "--ckpt-every", "1"]
    tlaunch.main(args + ["--mode", "downstream", "--ckpt-dir", str(tmp_path / "d")])
    tlaunch.main(args + ["--mode", "downstream", "--ckpt-dir", str(tmp_path / "d")])
    tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "s")])
    out = capsys.readouterr().out
    assert out.count("starting at step 0") == 2 and "starting at step 2" in out
    assert out.count("'affected_walks'") == 6 and out.count("'loss'") == 4
    lm = ["--arch", "gemma2-2b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
          "--device", "cpu", "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "lm")]
    tlaunch.main(lm)
    tlaunch.main(lm)
    out = capsys.readouterr().out
    assert out.count("starting at step 0") == 1 and "starting at step 2" in out
    assert out.count("'gnorm'") == 4 and out.count("'loss'") == 4
    assert "step 3:" in out
    with pytest.raises(SystemExit, match="family gnn"):
        tlaunch.main(["--arch", "gat-cora", "--device", "cpu"])
    with pytest.raises(SystemExit, match="family recsys"):
        tlaunch.main(["--arch", "dlrm-rm2", "--device", "cpu"])
    with pytest.raises(KeyError):
        tlaunch.main(["--arch", "no-such-arch", "--device", "cpu"])


def test_main_default_checkpoint_dir_and_refused_options(tmp_path, monkeypatch, capsys):
    """Without `--ckpt-dir` the checkpoints go to `repro_torch_ckpt` under
    the process's temporary directory (TMPDIR), and a second run resumes
    from them. `--batch` and `--seq` are taken (only the LM trainer reads
    them), and no abbreviation of `--batch-edges` is."""
    import tempfile
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    args = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch-edges", "16",
            "--device", "cpu", "--ckpt-every", "1", "--mode", "downstream"]
    tlaunch.main(args)
    tlaunch.main(args)
    assert (tmp_path / "repro_torch_ckpt" / "step_1").is_dir()
    out = capsys.readouterr().out
    assert "starting at step 0" in out and "starting at step 2" in out
    tlaunch.main(args + ["--batch", "8", "--seq", "64"])
    assert "starting at step 4" in capsys.readouterr().out
    for extra in (["--batch-edge", "8"], ["--batch-e", "8"]):
        with pytest.raises(SystemExit):
            tlaunch.main(args + extra)


def test_trainers_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for make in (lambda: tlaunch.wharf_trainer(ARCH, True, 16),
                 lambda: tlaunch.downstream_trainer(ARCH, True, 16, 8),
                 lambda: tlaunch.lm_trainer("gemma2-2b", True, 2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
