"""The port's four example drivers (examples/*_torch.py) against the JAX
package's (examples/*.py) on the CPU: each JAX driver runs in a subprocess
while the port's `main(["--device", "cpu", ...])` runs in this process,
and their printed lines are held together under `chip_smoke.EXAMPLE_RULES`
(the rules chip_smoke's phase 12 holds the card's runs to against the
CPU's): every integer and walk-derived id exact; ids ranked by f32 scores
exact but where two scores lie within the stated tie tolerance; losses,
accuracies and SMAPE within the tolerances stated there, beside the worst
case measured here. Two lines are never compared: quickstart's resolved
FINDNEXT backend, and streaming_embeddings' checkpoint step (the JAX
driver's fixed directory keeps earlier runs' steps), which is held against
the snapshot index instead.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from repro_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TIMEOUT_S = 170
# the port's intra-op threads while its driver runs beside the JAX one (the
# JAX driver takes the others); results move with the count only within the
# stated float tolerances
PORT_THREADS = 2

# runs a JAX driver with its checkpoint directory moved to argv[2]: the
# driver's own is a fixed path outside the test's directory
REDIRECT_CKPT = """
import runpy, sys
import repro.train.checkpoint as checkpoint
class Redirected(checkpoint.CheckpointManager):
    def __init__(self, directory, *args, **kwargs):
        super().__init__(sys.argv[2], *args, **kwargs)
checkpoint.CheckpointManager = Redirected
runpy.run_path(sys.argv[1], run_name="__main__")
"""


def _start_jax(name: str, args=(), ckpt_dir=None) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    script = os.path.join(ROOT, "examples", f"{name}.py")
    cmd = ([sys.executable, "-c", REDIRECT_CKPT, script, ckpt_dir] if ckpt_dir
           else [sys.executable, script, *args])
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _jax_lines(proc: subprocess.Popen) -> list:
    out, err = proc.communicate(timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    return out.splitlines()


def _both(name: str, port_args=(), jax_args=(), jax_ckpt=None):
    """The JAX driver (a subprocess) and the port's (this process) at once
    -> (port lines, JAX lines)."""
    proc = _start_jax(name, jax_args, jax_ckpt)
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        lines = chip_smoke.load_example(name).main(["--device", "cpu", *port_args])
    except BaseException:
        proc.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    return lines, _jax_lines(proc)


def test_quickstart_matches_jax():
    lines, want = _both("quickstart")
    assert lines[8] == "find_next backend: torch"
    chip_smoke.example_lines_match("quickstart", lines, want, lines.values)


def test_ppr_serving_matches_jax():
    lines, want = _both("ppr_serving")
    chip_smoke.example_lines_match("ppr_serving", lines, want, lines.values)


def test_streaming_embeddings_matches_jax(tmp_path):
    port_dir = str(tmp_path / "port")
    lines, want = _both("streaming_embeddings", ["--ckpt-dir", port_dir],
                        jax_ckpt=str(tmp_path / "jax"))
    chip_smoke.example_lines_match("streaming_embeddings", lines, want, {})
    chip_smoke.checkpoint_steps_match(lines)
    assert lines[-1] == f"done; embeddings checkpointed to {port_dir}"
    assert CheckpointManager(port_dir).all_steps() == [1, 2, 3]   # 3 kept


def test_train_lm_matches_jax(tmp_path):
    lines, want = _both(
        "train_lm", ["--steps", "2", "--ckpt-dir", str(tmp_path / "port")],
        ["--steps", "2", "--ckpt-dir", str(tmp_path / "jax")])
    assert len(lines) == 3 and lines[0] == "starting at step 0"
    chip_smoke.example_lines_match("train_lm", lines, want, {})


@pytest.mark.parametrize("name", chip_smoke.EXAMPLE_DRIVERS)
def test_driver_imports_no_jax(name):
    """A driver imports torch, numpy, the standard library and repro_torch,
    and nothing of jax or repro."""
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert roots <= {"argparse", "contextlib", "io", "os", "sys", "tempfile",
                     "numpy", "torch", "repro_torch"}, roots


@pytest.mark.parametrize("name", chip_smoke.EXAMPLE_DRIVERS)
def test_driver_raises_without_a_card(name, monkeypatch, tmp_path):
    """With no card, the default device raises before any work: no driver
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = chip_smoke.example_argv(name, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.load_example(name).main(argv)
