"""The port's transformer (repro_torch/models/transformer.py) against the
JAX package's on the CPU, at each LM arch's smoke config (f32).

Held: `init_params` bit for bit (the reference's own call, outside jit as
its `lm_trainer` and tests/test_archs.py make it: under jit XLA folds
`sqrt(2) * erfinv(u) * scale` into one constant and ~30% of the draws move
by an ulp), the converter's round trip bit for bit, and `forward`,
`lm_loss` and every gradient leaf of the jitted reference within rtol 1e-4
/ atol 1e-5."""
import jax
import numpy as np
import pytest
import torch

from _torch_lm import (F32_TOL, LM_ARCHS, assert_trees_close, bits, flat,
                       jax_tree_to_numpy, port_lm_params, torch_value_and_grad)
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaf_paths, tree_leaves


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_bit_for_bit_and_round_trip(arch):
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    want = jax_tree_to_numpy(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    got = tfm.init_params(jr.PRNGKey(0, "cpu"), cfg)
    got_np = convert.lm_params_to_numpy(got)
    wb, gb = bits(want), bits(got_np)
    assert set(wb) == set(gb)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    # the meta specs the converter checks against are init's shapes and dtypes
    def layout(tree):
        return {k: (tuple(v.shape), v.dtype) for k, v in leaf_paths(tree).items()}
    assert layout(tfm.param_specs(cfg)) == layout(got)
    back = convert.lm_params_from_numpy(want, cfg, device="cpu")
    assert layout(back) == layout(got)
    for k, v in bits(convert.lm_params_to_numpy(back)).items():
        np.testing.assert_array_equal(v, wb[k], err_msg=k)


def test_init_params_bf16_and_one_layer_alone():
    """bf16 leaves and the padded experts' 1/sqrt(e_padded) scale: a
    qwen2-moe smoke config with 6 experts padded to 8, in bf16."""
    from repro.models.transformer import MoEConfig as JMoE
    from repro_torch.models.transformer import MoEConfig
    jcfg = jax_arch("qwen2-moe-a2.7b").make_config(True)
    jcfg = jcfg.replace(dtype=jax.numpy.bfloat16, moe=JMoE(
        n_experts=6, top_k=2, d_expert=32, n_shared=1, d_shared=64, pad_experts_to=8))
    cfg = get_arch("qwen2-moe-a2.7b").make_config(True).replace(
        dtype=torch.bfloat16, moe=MoEConfig(n_experts=6, top_k=2, d_expert=32,
                                            n_shared=1, d_shared=64, pad_experts_to=8))
    want = bits(jax_tree_to_numpy(jtfm.init_params(jax.random.PRNGKey(5), jcfg)))
    got = bits(convert.lm_params_to_numpy(tfm.init_params(jr.PRNGKey(5, "cpu"), cfg)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lw = bits(jax_tree_to_numpy(jtfm.init_layer_params(jax.random.PRNGKey(9), jcfg)))
    lg = bits(convert.lm_params_to_numpy(tfm.init_layer_params(jr.PRNGKey(9, "cpu"), cfg)))
    assert set(lw) == set(lg)
    for k in lw:
        np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)


def test_converter_refuses_wrong_leaves():
    cfg = get_arch("gemma2-2b").make_config(True)
    good = convert.lm_params_to_numpy(tfm.init_params(jr.PRNGKey(0, "cpu"), cfg))
    bad = dict(good, unembed=np.zeros((cfg.d_model, cfg.vocab_size), np.float32))
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(bad, cfg, device="cpu")
    bad = dict(good, final_ln=np.zeros((3,), np.float32))
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(bad, cfg, device="cpu")
    bad = dict(good, embed=good["embed"].astype(np.float64))
    with pytest.raises(TypeError):
        convert.lm_params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_and_gradients_match_jax(arch):
    jcfg, cfg = jax_arch(arch).make_config(True), get_arch(arch).make_config(True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_lm_params(jp, cfg)
    toks = tokens(cfg, (2, 17))
    want = np.asarray(jax.jit(lambda p, t: jtfm.forward(p, t, jcfg))(jp, toks[:, :-1]))
    got = tfm.forward(tp, torch.from_numpy(toks[:, :-1]), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32_TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.lm_loss(p, t, jcfg)))(jp, toks)
    loss, grads = torch_value_and_grad(lambda p, t: tfm.lm_loss(p, t, cfg), tp,
                                       torch.from_numpy(toks))
    np.testing.assert_allclose(loss, float(jloss), **F32_TOL)
    assert_trees_close(grads, jax_tree_to_numpy(jgrads), arch, **F32_TOL)


def test_remat_changes_nothing():
    """`cfg.remat` (one checkpoint a scan body: a (local, global) pair for
    gemma2) gives the same loss and gradients bit for bit."""
    for arch in ("gemma2-2b", "qwen2-moe-a2.7b"):
        cfg = get_arch(arch).make_config(True)
        p = tfm.init_params(jr.PRNGKey(0, "cpu"), cfg)
        toks = torch.from_numpy(tokens(cfg, (2, 9)))
        l0, g0 = torch_value_and_grad(lambda q, t: tfm.lm_loss(q, t, cfg), p, toks)
        rcfg = cfg.replace(remat=True)
        l1, g1 = torch_value_and_grad(lambda q, t: tfm.lm_loss(q, t, rcfg), p, toks)
        assert l0 == l1
        for k, v in flat(g0).items():
            np.testing.assert_array_equal(flat(g1)[k], v, err_msg=k)


def test_param_counts_match_jax():
    for arch in LM_ARCHS:
        for smoke in (False, True):
            j, t = jax_arch(arch).make_config(smoke), get_arch(arch).make_config(smoke)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    def stored(arch):
        return sum(m.numel() for m in tree_leaves(
            tfm.param_specs(get_arch(arch).make_config())))
    # the full-width stores chip_smoke's phase 9 reckons with
    assert stored("gemma2-2b") == get_arch("gemma2-2b").make_config().param_count() \
        == 2_614_222_080
    # 64 padded experts and the q, k, v biases (6,144 a layer)
    assert stored("qwen2-moe-a2.7b") == 15_146_207_232
