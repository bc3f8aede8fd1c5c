"""The launcher's LM route (`repro_torch.launch.train.lm_trainer`) against
the JAX package's `lm_trainer` on the CPU, at the gemma2-2b smoke config,
both driven by their own TrainLoop with the same seed: 3 steps, a
checkpoint every 2.

Held: each step's tokens bit for bit (`randint(key, (batch, seq + 1), 0,
vocab, int32)` of the loop's key); the loss and the gradients' global norm
within rtol 1e-5; AdamW's moments after the 3 steps within rtol 1e-4 /
atol 1e-6, the parameters within rtol 1e-4 / atol 1e-5 (PARAM_TOL), the
step count exactly. A crash after step 2
and a fresh trainer that resumes from the checkpoint equal the
uninterrupted port run bit for bit in every leaf."""
import numpy as np
import torch

from _torch_lm import flat, jax_tree_to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.runtime import TrainLoop
from repro_torch.tree import leaf_paths

ARCH, BATCH, SEQ, STEPS, EVERY = "gemma2-2b", 4, 64, 3, 2
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
# AdamW moves an element by ~lr = 1e-3 a step whatever its gradient's size
# (m / sqrt(v)): where the gradients are ~1e-7, their f32 rounding (~1e-9
# in m) is a few tenths of a percent of that step. One w_gate element of
# the 16,384 ends 4.4e-6 from the reference's; atol is lr / 100.
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def run_loop(pkg: str, ckpt_dir, steps: int, resume: bool = False):
    """`pkg`'s ("jax" or "torch") LM trainer through its TrainLoop ->
    (carry, metrics by step, tokens by step, first step)."""
    if pkg == "jax":
        from repro.launch import train as launch
        from repro.train.checkpoint import CheckpointManager as Mgr
        from repro.train.runtime import TrainLoop as Loop
        dev = {}
    else:
        launch, Mgr, Loop, dev = tlaunch, CheckpointManager, TrainLoop, {"device": "cpu"}
    state, step_fn, batch_fn = launch.lm_trainer(ARCH, True, BATCH, SEQ, **dev)
    tokens = {}

    def batches(step, key):
        t = batch_fn(step, key)
        tokens[step] = np.asarray(t)
        return t

    loop = Loop(step_fn=step_fn, batch_fn=batches, ckpt=Mgr(str(ckpt_dir)),
                ckpt_every=EVERY, **dev)
    start = 0
    if resume:
        state, start = loop.resume(state)
    metrics = {}
    state = loop.run(state, start, steps,
                     lambda step, dt, m: metrics.__setitem__(step, m))
    return state, metrics, tokens, start


def test_lm_trainer_matches_jax_and_resumes(tmp_path):
    jstate, jm, jtok, _ = run_loop("jax", tmp_path / "j", STEPS)
    tstate, tm, ttok, _ = run_loop("torch", tmp_path / "t", STEPS)
    assert sorted(ttok) == sorted(jtok) == list(range(STEPS))
    for s in jtok:
        assert ttok[s].dtype == np.int32 and ttok[s].shape == (BATCH, SEQ + 1)
        np.testing.assert_array_equal(ttok[s], jtok[s], err_msg=f"tokens of step {s}")
    for s in jm:
        for k in ("loss", "gnorm"):
            assert isinstance(tm[s][k], float)
            np.testing.assert_allclose(tm[s][k], jm[s][k], rtol=1e-5, err_msg=f"{k}, step {s}")
    want, got = flat(jax_tree_to_numpy(jstate)), flat(tstate)
    assert set(got) == set(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == STEPS
    for k in want:
        tol = PARAM_TOL if k.startswith("params/") else MOMENT_TOL
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert sorted(CheckpointManager(str(tmp_path / "t")).all_steps()) == [1, 2]
    # a crash after step 2 (its checkpoint committed), and a fresh trainer
    _, m1, _, _ = run_loop("torch", tmp_path / "r", 2)
    rstate, m2, _, start = run_loop("torch", tmp_path / "r", STEPS - 2, resume=True)
    assert start == 2
    assert {**m1, **m2}.keys() == tm.keys()
    for s in tm:
        for k in ("loss", "gnorm"):
            assert {**m1, **m2}[s][k] == tm[s][k], (s, k)
    want = leaf_paths(tstate)
    for k, v in leaf_paths(rstate).items():
        assert torch.equal(v, want[k]), k

