"""Shared helpers of the LM and DLRM parity tests: the reference's
parameters carried into the port through `repro_torch.convert`, gradients
of both packages as flat {path: numpy} dicts, and the reference's jitted
functions compiled with or without XLA's excess precision."""
from __future__ import annotations

import numpy as np
import torch

import _torch_parity  # noqa: F401  (x64 as the other parity tests, one torch thread)
from repro_torch import convert
from repro_torch.tree import leaf_paths, rebuild

LM_ARCHS = ["mistral-nemo-12b", "qwen1.5-110b", "gemma2-2b",
            "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
# f32 forward, loss and gradients: rtol 1e-4 / atol 1e-5 (sums in another
# order, XLA's own exp/tanh/rsqrt and FMAs; measured ~1e-6 relative)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def jax_tree_to_numpy(tree) -> dict:
    """A JAX pytree of arrays -> the same nested dicts/lists of numpy
    arrays (bf16 stays numpy's ml_dtypes bfloat16)."""
    import jax
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict:
    """{path: numpy} of a numpy, JAX or torch tree (bf16 as float32)."""
    out = {}
    for k, v in leaf_paths(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy()
        else:
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                v = v.astype(np.float32)
        out[k] = v
    return out


def bits(tree) -> dict:
    """{path: raw bytes as uint8} of a numpy tree (bf16 as uint16 bits)."""
    return {k: np.ascontiguousarray(np.asarray(v)).view(np.uint8)
            for k, v in leaf_paths(tree).items()}


def port_lm_params(jparams, cfg) -> dict:
    return convert.lm_params_from_numpy(jax_tree_to_numpy(jparams), cfg, device="cpu")


def torch_value_and_grad(fn, params, *args):
    """(loss, grads tree) of fn(params, *args) through autograd."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaf_paths(params).items()}
    loss = fn(rebuild(params, leaves), *args)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
    return float(loss.detach()), rebuild(params, dict(zip(leaves, grads)))


def assert_trees_close(got, want, what: str, **tol) -> None:
    g, w = flat(got), flat(want)
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=f"{what}: {k}", **tol)


def strict_jit(fn, *args):
    """fn jitted and compiled with XLA's excess precision off: every bf16
    rounding the code asks for is made (the CPU backend's default keeps
    f32 between fused bf16 operations)."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)
