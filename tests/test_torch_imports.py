"""Import hygiene of the port and its card-free behaviour on the CPU.

`repro_torch` and chip_smoke.py import neither JAX nor the JAX package;
every module imports without a card, nvcc or triton; an entry point asked
for the card (the default) raises when there is none."""
import ast
import importlib
import pathlib

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
        "szudzik.cu", "delta.cu", "range_search.cu"}


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingGraph.empty(8, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jr.PRNGKey(0)


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
