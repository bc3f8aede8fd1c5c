"""The transformer's serving path (`prefill`, `init_kv_cache`,
`decode_step`) against the JAX package's on the CPU, at each LM arch's
smoke config (f32): the last logits and the KV cache of a prefill, one
decode step from a cache filled as tests/test_archs.py fills it (its
logits and the written cache), within rtol 1e-4 / atol 1e-5; and the
port's decode against its own forward at gemma2's smoke config (sliding
window, softcaps, GQA) within the reference test's 2e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32_TOL, LM_ARCHS, port_lm_params
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_lm_params(jp, cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jlast, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(jp, toks[:, :8])
    last, cache = tfm.prefill(tp, torch.from_numpy(toks[:, :8]), cfg)
    assert last.shape == (2, cfg.vocab_size) and last.dtype == torch.float32
    assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **F32_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **F32_TOL)
    # tests/test_archs.py:43-50: the prefill's cache in the first 8 of 16
    # positions, then one decode step at position 8
    full = jtfm.init_kv_cache(jcfg, 2, 16)
    full["k"] = full["k"].at[:, :, :8].set(jcache["k"])
    full["v"] = full["v"].at[:, :, :8].set(jcache["v"])
    jlg, jc2 = jax.jit(lambda p, t, c, n: jtfm.decode_step(p, t, c, n, jcfg))(
        jp, toks[:, 8:9], full, jnp.asarray(8))
    tfull = tfm.init_kv_cache(cfg, 2, 16, device="cpu")
    for k in ("k", "v"):
        tfull[k][:, :, :8] = torch.from_numpy(np.array(jcache[k]))
    lg, c2 = tfm.decode_step(tp, torch.from_numpy(toks[:, 8:9]), tfull, 8, cfg)
    assert lg.shape == (2, 1, cfg.vocab_size) and c2 is tfull
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(c2[k].numpy(), np.asarray(jc2[k]), **F32_TOL)
        assert not c2[k][:, :, 9:].any()
    # a 0-d tensor position is the same step
    tfull2 = tfm.init_kv_cache(cfg, 2, 16, device="cpu")
    for k in ("k", "v"):
        tfull2[k][:, :, :8] = torch.from_numpy(np.array(jcache[k]))
    lg2, _ = tfm.decode_step(tp, torch.from_numpy(toks[:, 8:9]), tfull2,
                             torch.tensor(8), cfg)
    assert torch.equal(lg2, lg)


def test_decode_matches_own_forward_past_the_window():
    """tests/test_archs.py::test_lm_decode_matches_forward on the port:
    gemma2 smoke (window 4) decoded one token at a time over 9 positions,
    every step's logits within 2e-3 of one forward over the 9."""
    cfg = get_arch("gemma2-2b").make_config(True)
    params = tfm.init_params(jr.PRNGKey(0, "cpu"), cfg)
    toks = jr.randint(jr.PRNGKey(2, "cpu"), (1, 9), 0, cfg.vocab_size, dtype=torch.int32)
    full = tfm.forward(params, toks, cfg).detach()
    cache = tfm.init_kv_cache(cfg, 1, 16, device="cpu")
    outs = []
    for p in range(9):
        lg, cache = tfm.decode_step(params, toks[:, p:p + 1], cache, p, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
    # prefill of 6, then 3 decode steps: the same logits
    last, pc = tfm.prefill(params, toks[:, :6], cfg)
    np.testing.assert_allclose(last.numpy(), full[:, 5].numpy(), rtol=2e-3, atol=2e-3)
    cache = tfm.init_kv_cache(cfg, 1, 16, device="cpu")
    cache["k"][:, :, :6], cache["v"][:, :, :6] = pc["k"], pc["v"]
    for p in range(6, 9):
        lg, cache = tfm.decode_step(params, toks[:, p:p + 1], cache, p, cfg)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, p].numpy(),
                                   rtol=2e-3, atol=2e-3)
