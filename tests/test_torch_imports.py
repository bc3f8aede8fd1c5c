"""Import hygiene of the port and its card-free behaviour on the CPU.

`repro_torch` and chip_smoke.py import neither JAX nor the JAX package;
every module imports without a card, nvcc or triton; an entry point asked
for the card (the default) raises when there is none."""
import ast
import importlib
import os
import pathlib
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "triton"}, (path, roots)


def test_every_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
    from repro_torch.kernels import _build
    assert _build._lib is None          # nothing was built at import
    assert _build.library_path().name.startswith("librepro_kernels_")
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "szudzik.cu", "delta.cu", "range_search.cu", "intersect.cu",
        "megakernel.cu", "sgns.cu"}
    assert set(_build.SIGNATURES) == {
        "repro_szudzik_pair", "repro_szudzik_unpair", "repro_delta_decode",
        "repro_find_next_packed", "repro_intersect_next",
        "repro_intersect_csr", "repro_fused_rewalk_step", "repro_sgns_step"}
    from repro_torch.kernels import ops
    assert set(ops.KERNELS) == {n.removeprefix("repro_") for n in _build.SIGNATURES}


@pytest.mark.parametrize("module", ["repro_torch.kernels.ops",
                                    "repro_torch.kernels.range_search",
                                    "repro_torch.kernels.megakernel",
                                    "repro_torch.kernels.sgns",
                                    "repro_torch.core.overlay",
                                    "repro_torch.models.embeddings",
                                    "repro_torch.downstream",
                                    "repro_torch.core.ppr",
                                    "repro_torch.obs.export",
                                    "repro_torch.obs.staleness",
                                    "repro_torch.serve",
                                    "repro_torch.data.streams",
                                    "repro_torch.core.baselines",
                                    "repro_torch.configs",
                                    "repro_torch.configs.wharf_stream"])
def test_each_module_imports_first_in_a_fresh_process(module):
    """The core and the kernel wrappers import each other; any one of them
    imported first must still work."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", f"import {module}"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import convert
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingGraph.empty(8, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jr.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"in": [[0.0]], "out": [[0.0]]})
    from repro_torch.core import packed_store
    from repro_torch.data import streams
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streams.rmat_edges([0, 1], 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_store.get_default_backend()


def test_kernel_wrappers_never_fall_back():
    """CPU tensors take the plain version; a CUDA request on the CPU, or
    operands on two devices, raise."""
    from repro_torch.core.packed_store import resolve_backend
    from repro_torch.kernels import ops, szudzik
    x = torch.arange(5)
    assert torch.equal(ops.szudzik_pair(x, x), szudzik.pair_plain(x, x))
    assert ops.launches["szudzik_pair"] == 0 or torch.cuda.is_available()
    with pytest.raises(ValueError):
        szudzik.pair_cuda(x, x)
    with pytest.raises(ValueError):
        resolve_backend("cuda", torch.device("cpu"))
    with pytest.raises(ValueError):
        ops.szudzik_pair(x, x.to("meta"))


def test_order2_wrappers_never_fall_back():
    """The intersect and fused-step wrappers take their plain versions on
    CPU tensors only; their kernels and an explicit "cuda" request raise
    for CPU tensors."""
    from repro_torch.kernels import intersect, megakernel, ops
    from repro_torch.kernels.megakernel import FusedStep
    win = torch.full((2, 128), intersect.SENT)
    win[:, :3] = torch.tensor([1, 2, 3])
    prev, u = torch.tensor([2, 9]), torch.tensor([0.5, 0.25])
    before = dict(ops.launches)
    got = ops.intersect_next(win, win, prev, u, u, 1.0, 1.0)
    assert torch.equal(got[0], intersect.factorized_plain(win, win, prev, u, u,
                                                          1.0, 1.0)[0])
    assert ops.launches == before or torch.cuda.is_available()
    with pytest.raises(ValueError):
        intersect.factorized_cuda(win, win, prev, u, u, 1.0, 1.0)
    with pytest.raises(ValueError):
        intersect.factorized_next(win, win, prev, u, u, 1.0, 1.0,
                                  backend="cuda")
    with pytest.raises(ValueError):
        megakernel.resolve_backend("cuda", torch.device("cpu"))
    z = torch.zeros(2, dtype=torch.int64)
    step = FusedStep(z, z, z, z.to(torch.int32), z, z, z, z.bool(), z.bool(),
                     False, 8, ext_nxt=z)
    with pytest.raises(ValueError):
        megakernel.fused_step_cuda(types.SimpleNamespace(
            packed=torch.zeros((1, 256), dtype=torch.int32),
            widths=torch.zeros(1, dtype=torch.int32),
            anchors_hi=torch.zeros(1, dtype=torch.int32),
            anchors_lo=torch.zeros(1, dtype=torch.int32),
            epoch=torch.zeros(1, dtype=torch.int32), n_chunks=1), step)
    with pytest.raises(ValueError):
        ops.intersect_next(win, win.to("meta"), prev, u, u, 1.0, 1.0)
