"""Kernel 7's plain versions (the port's `kernels/sgns.py`) against the JAX
package's SGNS backends on the CPU, and the registry's contract.

Inputs come from seeded numpy. Tolerances are the reference's own
(tests/test_sgns.py): loss rtol 1e-6, gradients rtol 1e-4 / atol 1e-5 —
the closed form and autograd (or XLA's einsum) sum the same products in
different orders. The loss also gets atol 1e-6: a logit summed in another
order differs by ~1e-7 absolute, which is more than rtol 1e-6 of a loss
near 1e-4 (a row with a well-separated pair and negatives). The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64, as the reference runs)
from repro.kernels import sgns as jsgns
from repro_torch.kernels import ops
from repro_torch.kernels import sgns

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def make_inputs(b, k, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((b, d), (b, d), (b, k, d))]


def extreme_rows(d=128):
    """Logits of exactly ±100 (one non-zero column) and all-zero rows."""
    u = np.zeros((4, d), np.float32)
    vp = np.zeros((4, d), np.float32)
    vn = np.zeros((4, 3, d), np.float32)
    u[:3, 0] = 10.0
    vp[0, 0], vn[0, :, 0] = 10.0, [-10.0, 10.0, -10.0]     # pos +100
    vp[1, 0], vn[1, :, 0] = -10.0, [10.0, 10.0, -10.0]     # pos -100
    vp[2, 0], vn[2, :, 0] = 10.0, [10.0, 10.0, 10.0]
    return [u, vp, vn]


def assert_close(got, want):
    names = ("loss", "du", "dvp", "dvn")
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        tol = LOSS_TOL if name == "loss" else GRAD_TOL
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **tol)
        assert np.isfinite(g).all(), name


SHAPES = [(64, 5, 128), (13, 1, 64), (1, 3, 96), (37, 7, 200), (8, 16, 256)]


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_plain_versions_match_jax(backend, b, k, d):
    """The closed form ("torch") and the autograd oracle ("ref") against
    the reference's closed form ("interpret") and its AD ("xla-ref")."""
    args = make_inputs(b, k, d, seed=b * 31 + k)
    got = sgns.sgns_apply(*map(torch.from_numpy, args), backend=backend)
    for jb in ("interpret", "xla-ref"):
        assert_close(got, jsgns.sgns_apply(*map(jnp.asarray, args), jb))


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """The reference's kernel body itself (pallas_call, interpret=True) at
    the tile shape it accepts."""
    args = make_inputs(16, 4, 128, seed=2)
    want = jsgns.sgns_apply(*map(jnp.asarray, args), "pallas-interpret")
    assert_close(sgns.sgns_plain(*map(torch.from_numpy, args)), want)


@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_extreme_and_zero_rows(backend):
    """Logits of ±100 stay finite (a stable softplus), and zero rows give
    6 ln 2 ... (K + 1) ln 2 with zero gradients where the table is 0."""
    args = extreme_rows()
    got = sgns.sgns_apply(*map(torch.from_numpy, args), backend=backend)
    assert_close(got, jsgns.sgns_apply(*map(jnp.asarray, args), "interpret"))
    loss, du, dvp, dvn = got
    np.testing.assert_allclose(loss[3].item(), 4 * np.log(2), rtol=1e-6)
    assert float(du[3].abs().max()) == 0.0 and float(dvn[3].abs().max()) == 0.0
    np.testing.assert_allclose(loss[0].item(), 100.0, rtol=1e-6)


def test_closed_form_equals_autograd():
    args = [torch.from_numpy(a) for a in make_inputs(48, 5, 128, seed=9)]
    want = sgns.sgns_apply(*args, backend="ref")
    got = sgns.sgns_apply(*args, backend="torch")
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_registry_resolution_and_raises():
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert sgns.resolve_backend(None, cpu) == "torch"
    assert sgns.resolve_backend("auto", card) == "cuda"
    assert sgns.resolve_backend("ref", cpu) == "ref"
    with pytest.raises(ValueError, match="needs tensors on the card"):
        sgns.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="unknown sgns backend"):
        sgns.resolve_backend("pallas", cpu)
    sgns.set_default_backend("ref")
    try:
        assert sgns.resolve_backend(None, card) == "ref"
        assert sgns.resolve_backend("auto", cpu) == "ref"
    finally:
        sgns.set_default_backend(None)
    with pytest.raises(ValueError, match="unknown sgns backend"):
        sgns.set_default_backend("nope")
    assert sgns.ROWS == 8 and sgns.MAX_K == 16


def test_wrapper_takes_plain_version_on_cpu_and_never_falls_back():
    args = [torch.from_numpy(a) for a in make_inputs(8, 2, 32, seed=1)]
    before = ops.launches["sgns_step"]
    got = ops.sgns_step(*args)
    assert ops.launches["sgns_step"] == before
    for g, w in zip(got, sgns.sgns_plain(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgns.sgns_cuda(*args)
    with pytest.raises(ValueError, match="needs tensors on the card"):
        sgns.sgns_apply(*args, backend="cuda")
    with pytest.raises(ValueError, match="several devices"):
        ops.sgns_step(args[0], args[1].to("meta"), args[2])
