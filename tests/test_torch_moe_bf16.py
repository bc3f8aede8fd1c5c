"""The MoE dispatch and the bf16 numerics of the port's transformer
against the JAX package's on the CPU.

MoE (`ffn_moe`, `moe_route`): the reference's own routing, recorded from
an eager call (its `lax.top_k` and the `jnp.where(keep, pos, cap)` that
sends dropped rows to the trash row), equals the port's exactly: top_e,
pos and keep; the output within rtol 1e-4 / atol 1e-5. Cases: a random
router, a skewed one that drops rows beyond capacity, a saturated one
whose losing experts tie at probability 0 (`lax.top_k` keeps the lower
index), and 6 experts stored padded to 8.

bf16: with integer-valued inputs every product and sum is exact in any
order, so the casts and the attention scale (rounded to bf16 first, as a
JAX weak-typed scalar) are held bit for bit against the reference
compiled with XLA's excess precision off (the CPU backend's default keeps
f32 between fused bf16 ops and skips the casts the code asks for). Whole
gemma2 and qwen2-moe forwards in bf16 at smoke widths are held within a
stated tolerance against the reference as it compiles by default and as
the code reads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32_TOL, jax_tree_to_numpy, port_lm_params, strict_jit
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm

BF = jnp.bfloat16


def moe_configs(padded: bool):
    jcfg = jax_arch("qwen2-moe-a2.7b").make_config(True)
    cfg = get_arch("qwen2-moe-a2.7b").make_config(True)
    if padded:
        from repro.models.transformer import MoEConfig as JMoE
        kw = dict(n_experts=6, top_k=2, d_expert=32, n_shared=1, d_shared=64,
                  pad_experts_to=8)
        jcfg = jcfg.replace(moe=JMoE(**kw))
        cfg = cfg.replace(moe=tfm.MoEConfig(**kw))
    return jcfg, cfg


def jax_routing(x, p, jcfg, monkeypatch):
    """The reference's eager `ffn_moe` -> (output, top_e, pos, keep), the
    routing recorded from its own calls."""
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def rec_top_k(v, k):
        out = top_k(v, k)
        seen.setdefault("top", out)
        return out

    def rec_where(c, a, b):
        if "keep" not in seen and type(b) is int:
            seen["keep"], seen["pos"] = c, a      # jnp.where(keep, pos, cap)
        return where(c, a, b)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "where", rec_where)
    out = jtfm.ffn_moe(jnp.asarray(x), p, jcfg)
    monkeypatch.undo()
    return (np.asarray(out), np.asarray(seen["top"][1]), np.asarray(seen["pos"]),
            np.asarray(seen["keep"]))


@pytest.mark.parametrize("case", ["random", "skewed", "saturated", "padded"])
def test_moe_routing_exact_and_output(case, monkeypatch):
    jcfg, cfg = moe_configs(case == "padded")
    jp = jtfm.init_layer_params(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if case == "skewed":        # expert 0 takes most tokens: rows dropped
        jp["router"] = jp["router"].at[:, 0].multiply(4.0)
        x[..., :8] = np.abs(x[..., :8])
        jp["router"] = jp["router"].at[:8, 0].set(np.abs(np.asarray(jp["router"][:8, 0])))
    if case == "saturated":     # the other experts' probabilities are 0.0
        x[..., 0] = 5.0
        jp["router"] = jp["router"].at[0, 0].set(100.0)
    want, top_e, pos, keep = jax_routing(x, jp, jcfg, monkeypatch)
    tp = convert.lm_params_from_numpy(
        {"embed": np.zeros((cfg.vocab_size, cfg.d_model), np.float32),
         "final_ln": np.ones((cfg.d_model,), np.float32),
         "unembed": np.zeros((cfg.d_model, cfg.vocab_size), np.float32),
         "layers": {k: np.asarray(v)[None] for k, v in jax_tree_to_numpy(jp).items()}},
        cfg.replace(n_layers=1), device="cpu")["layers"]
    tp = {k: v[0] for k, v in tp.items()}
    xt = torch.from_numpy(x)
    _, t_e, t_pos, t_keep, cap = tfm.moe_route(xt.reshape(-1, cfg.d_model),
                                               tp["router"], cfg.moe)
    np.testing.assert_array_equal(t_e.numpy(), top_e)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert cap == max(1, int(32 * cfg.moe.top_k * 1.25 / cfg.moe.n_experts))
    got = tfm.ffn_moe(xt, tp, cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if case in ("skewed", "saturated"):
        assert not keep.all(), "no row was dropped beyond capacity"
    if case == "saturated":     # ties at 0.0 go to the lowest index, expert 1
        assert (top_e[..., 0] == 0).all() and (top_e[..., 1] == 1).all()
    assert top_e.max() < cfg.moe.n_experts


def int_bf16(rng, shape, lo, hi):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


def test_attention_scale_and_casts_bit_for_bit_at_head_dim_128():
    """Integer q, k in [-4, 4] (each q·k exact in f32, so both packages
    round the same integer to bf16), one-hot v rows (so the output is the
    probabilities themselves), head_dim 128, a window of 2 (two keys a
    row: the softmax's sum has one order). The port equals the
    reference bit for bit; dividing by the unrounded f32 scalar, as torch
    would, does not."""
    rng = np.random.default_rng(0)
    b, s, nh, nkv, d = 2, 128, 4, 2, 128
    q, k = int_bf16(rng, (b, s, nh, d), -4, 4), int_bf16(rng, (b, s, nkv, d), -4, 4)
    v = np.zeros((b, s, nkv, d), np.float32)
    v[:, np.arange(s), :, np.arange(s)] = 1.0
    mask = np.array(jtfm._causal_mask(s, s, 0, 2))[None]
    jq, jk, jv = (jnp.asarray(a, BF) for a in (q, k, v))
    want = np.asarray(strict_jit(lambda q, k, v: jtfm.attention(
        q, k, v, jnp.asarray(mask), None), jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tmask = torch.from_numpy(mask.copy())
    got = tfm.attention(tq, tk, tv, tmask).float().numpy()
    np.testing.assert_array_equal(got, want)
    # the same with the softcap (f32 tanh, ulps apart in the two packages,
    # and gone in the bf16 cast of the probabilities here)
    want_cap = np.asarray(strict_jit(lambda q, k, v: jtfm.attention(
        q, k, v, jnp.asarray(mask), 50.0), jq, jk, jv).astype(jnp.float32))
    np.testing.assert_array_equal(tfm.attention(tq, tk, tv, tmask, 50.0).float().numpy(),
                                  want_cap)
    # the test has the power to see the scale: the unrounded scalar differs
    scores = torch.einsum("bskgd,btkd->bkgst", tq.reshape(b, s, nkv, 2, d), tk) / d ** 0.5
    scores = torch.where(tmask[:, None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, -1).to(torch.bfloat16)
    f32_scale = torch.einsum("bkgst,btkd->bskgd", probs, tv).reshape(b, s, nh, d)
    assert (f32_scale.float().numpy() != want).sum() > 0   # 25 of 131,072 here


def test_rmsnorm_casts_bit_for_bit():
    rng = np.random.default_rng(1)
    x = int_bf16(rng, (4, 32, 128), -8, 8)
    w = int_bf16(rng, (128,), 1, 3)
    jx = jnp.asarray(x, BF)
    want = np.asarray(strict_jit(lambda x, w: jtfm.rmsnorm(x, w, 1e-6), jx,
                                 jnp.asarray(w)).astype(jnp.float32))
    got = tfm.rmsnorm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# bf16 logits at smoke widths: within this of the reference as the code
# reads (strict: the same roundings, XLA's own exp, tanh and rsqrt and
# other sum orders flip a bf16 rounding now and then) and as XLA compiles
# it by default (f32 kept between fused bf16 ops: the activations differ
# by a bf16 rounding, 2^-8 relative, in every op). The logits are O(1)
# and leave the bf16 unembedding with bf16's step (2^-7 from 1 to 2), so
# strict allows ~4 steps, default ~6.
BF16_TOL = {"strict": dict(rtol=0.02, atol=0.03), "default": dict(rtol=0.05, atol=0.05)}
# the router sees bf16 activations ~2^-8 apart in the two packages: a
# token whose top-k differs must be this near a tie in the reference's
# own router probabilities (relative to its largest)
NEAR_TIE = 2.0 ** -5


def test_bf16_forward_within_tolerance_gemma2():
    jcfg = jax_arch("gemma2-2b").make_config(True).replace(dtype=BF)
    cfg = get_arch("gemma2-2b").make_config(True).replace(dtype=torch.bfloat16)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_lm_params(jp, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    got = tfm.forward(tp, torch.from_numpy(toks), cfg).detach().numpy()
    fn = lambda p, t: jtfm.forward(p, t, jcfg)  # noqa: E731
    for mode, want in (("strict", strict_jit(fn, jp, toks)),
                       ("default", jax.jit(fn)(jp, toks))):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=mode, **BF16_TOL[mode])


def test_bf16_forward_within_tolerance_qwen2_moe(monkeypatch):
    """The qwen2-moe forward in bf16. Both packages' routing is recorded
    layer by layer (the reference run eagerly, which rounds as its strict
    compile does); a token whose top-k or keep differs must be a near tie
    of the reference's router probabilities, or (keep only) follow such a
    token in its expert's buffer; every other token's logits lie within
    BF16_TOL["strict"] of the strict reference's. The default compile's
    routing is not observable, so it is not compared here."""
    jcfg = jax_arch("qwen2-moe-a2.7b").make_config(True).replace(dtype=BF)
    cfg = get_arch("qwen2-moe-a2.7b").make_config(True).replace(dtype=torch.bfloat16)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_lm_params(jp, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ported = []
    route = tfm.moe_route

    def rec_route(xt, router, m):
        out = route(xt, router, m)
        ported.append((out[1].numpy(), out[3].numpy()))
        return out

    monkeypatch.setattr(tfm, "moe_route", rec_route)
    got = tfm.forward(tp, torch.from_numpy(toks), cfg).detach().numpy()
    monkeypatch.undo()
    seen, top_k, where = [], jax.lax.top_k, jnp.where

    def rec_top_k(v, k):
        out = top_k(v, k)
        seen.append({"probs": np.asarray(v), "top_e": np.asarray(out[1])})
        return out

    def rec_where(c, a, b):
        if type(b) is int:                       # jnp.where(keep, pos, cap)
            seen[-1]["keep"] = np.asarray(c)
        return where(c, a, b)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "where", rec_where)
    with jax.disable_jit():
        eager = np.asarray(jtfm.forward(jp, toks, jcfg))
    monkeypatch.undo()
    want = np.asarray(strict_jit(lambda p, t: jtfm.forward(p, t, jcfg), jp, toks))
    assert len(seen) == len(ported) == cfg.n_layers
    agree = np.ones(toks.size, bool)
    for (p_e, p_keep), ref in zip(ported, seen):
        moved = (p_e != ref["top_e"]).any(-1)
        probs = ref["probs"]
        for t in np.nonzero(moved)[0]:
            ranked = np.sort(probs[t])[::-1][:cfg.moe.top_k]
            assert np.abs(probs[t, p_e[t]] - ranked).max() <= NEAR_TIE * ranked[0], t
        for t in np.nonzero((p_keep != ref["keep"]).any(-1) & ~moved)[0]:
            experts = set(p_e[t]) | set(ref["top_e"][t])
            assert any(moved[u] and experts & (set(p_e[u]) | set(ref["top_e"][u]))
                       for u in range(t)), t
        agree &= ~(moved | (p_keep != ref["keep"]).any(-1))
    assert agree.sum() >= toks.size // 2
    got, want = got.reshape(toks.size, -1), want.reshape(toks.size, -1)
    np.testing.assert_allclose(got[agree], want[agree], **BF16_TOL["strict"])
    np.testing.assert_allclose(eager.reshape(toks.size, -1)[agree], want[agree],
                               rtol=1e-6, atol=1e-6)
