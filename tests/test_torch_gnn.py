"""The port's GNN family (repro_torch/models/gnn.py, configs/gnn_archs.py)
against the JAX package's on the CPU, at each arch's smoke config with
numpy-seeded inputs (n 40, e 160, duplicate edges, self-loops and empty
segments), as tests/test_archs.py::test_gnn_smoke drives them.

Held: the inits bit for bit (outside jit, as the reference's tests call
them) and the converter's round trip; the forward and the gradient of
`(o ** 2).mean()` of the jitted reference within GNN_TOL (the matmuls and
XLA's exp are not torch's: `_torch_gnn.GNN_TOL` says why);
`segment_sum`/`segment_max` bit for bit against `jax.ops` and
`segment_softmax` within tolerance, empty segments included; GAT's and
GraphSAGE's weight pairs drawn from one key (equal); the RBF centres bit
for bit against `jnp.linspace` (f64 under x64, f32 without); the configs
and the registry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gnn import GNN_ARCHS, GNN_TOL, JAX_INITS, features, graph, jax_forward, port_forward
from _torch_lm import assert_trees_close, bits, jax_tree_to_numpy, torch_value_and_grad
from repro.configs import get_arch as jax_arch
from repro.models import gnn as jg
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import get_arch
from repro_torch.models import gnn
from repro_torch.tree import leaf_paths


def init_both(arch: str, smoke: bool = True, seed: int = 0):
    jcfg, cfg = jax_arch(arch).make_config(smoke), get_arch(arch).make_config(smoke)
    jp = getattr(jg, JAX_INITS[arch])(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, gnn.INITS[arch](jr.PRNGKey(seed, "cpu"), cfg)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_bit_for_bit_and_round_trip(arch):
    jcfg, cfg, jp, tp = init_both(arch)
    want = jax_tree_to_numpy(jp)
    wb, gb = bits(want), bits(convert.gnn_params_to_numpy(tp))
    assert set(wb) == set(gb) and len(wb) > 0
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    back = convert.gnn_params_to_numpy(convert.gnn_params_from_numpy(want, arch, cfg, "cpu"))
    for k, v in bits(back).items():
        np.testing.assert_array_equal(v, wb[k], err_msg=k)
    # the meta specs the converter checks against are init's shapes
    specs = gnn.param_specs(arch, cfg)
    assert {k: tuple(v.shape) for k, v in leaf_paths(specs).items()} == \
        {k: np.shape(v) for k, v in leaf_paths(want).items()}
    with pytest.raises(ValueError):
        convert.gnn_params_from_numpy({"layers": []}, arch, cfg, "cpu")


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_and_gradients_match_jax(arch):
    jcfg, cfg, jp, tp = init_both(arch, seed=3)
    n, e = 40, 160
    snd, rcv = graph(n, e)
    feats = features(arch, cfg, n, e)
    want = np.asarray(jax.jit(lambda p: jax_forward(arch, p, feats, snd, rcv, jcfg))(jp))
    got = port_forward(arch, tp, feats, snd, rcv, cfg)
    d_out = cfg.d_out if arch in ("meshgraphnet", "equiformer-v2") else cfg.n_classes
    assert got.shape == want.shape == (n, d_out)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), want, **GNN_TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: (jax_forward(arch, p, feats, snd, rcv, jcfg) ** 2).mean()))(jp)
    loss, grads = torch_value_and_grad(
        lambda p: (port_forward(arch, p, feats, snd, rcv, cfg) ** 2).mean(), tp)
    np.testing.assert_allclose(loss, float(jloss), **GNN_TOL)
    assert_trees_close(grads, jax_tree_to_numpy(jgrads), arch, **GNN_TOL)


def test_segment_ops_against_jax_with_empty_segments():
    """segment_sum and segment_max bit for bit (ties and empty segments
    included: -inf there), for [E] and [E, H]; segment_softmax within
    tolerance, each non-empty segment summing to 1 and no NaN."""
    rng = np.random.default_rng(5)
    e, n = 300, 50
    ids = rng.integers(0, n - 7, e).astype(np.int32)      # the last 7 empty
    for shape in ((e,), (e, 3)):
        data = rng.standard_normal(shape).astype(np.float32)
        data[:20] = data[20:40]                           # exact ties
        ids[:20] = ids[20:40]
        t, ti = torch.from_numpy(data), torch.from_numpy(ids)
        want_sum = np.asarray(jax.ops.segment_sum(data, ids, num_segments=n))
        want_max = np.asarray(jax.ops.segment_max(data, ids, num_segments=n))
        np.testing.assert_array_equal(gnn.segment_sum(t, ti, n).numpy(), want_sum)
        np.testing.assert_array_equal(gnn.segment_max(t, ti, n).numpy(), want_max)
        assert np.isneginf(want_max[-7:]).all()
        got = gnn.segment_softmax(t, ti, n)
        if len(shape) == 1:
            want = jg.segment_softmax(jnp.asarray(data), jnp.asarray(ids), n)
        else:
            want = jax.vmap(lambda lg: jg.segment_softmax(lg, jnp.asarray(ids), n),
                            in_axes=1, out_axes=1)(jnp.asarray(data))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GNN_TOL)
        sums = gnn.segment_sum(got, ti, n).numpy()
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(sums[:n - 7], 1.0, rtol=1e-6)
        np.testing.assert_array_equal(sums[n - 7:], 0.0)


@pytest.mark.parametrize("smoke", [True, False])
def test_weight_pairs_drawn_from_one_key_are_equal(smoke):
    """The reference draws GAT's a_src and a_dst from one key, and
    GraphSAGE's w_self and w_nbr: the port keeps the pairs equal."""
    gat = gnn.gat_init(jr.PRNGKey(0, "cpu"), get_arch("gat-cora").make_config(smoke))
    for layer in gat["layers"]:
        assert torch.equal(layer["a_src"], layer["a_dst"])
    sage = gnn.sage_init(jr.PRNGKey(0, "cpu"), get_arch("graphsage-reddit").make_config(smoke))
    for layer in sage["layers"]:
        assert torch.equal(layer["w_self"], layer["w_nbr"])


@pytest.mark.parametrize("n_rbf", [2, 5, 7, 8, 32, 100])
def test_rbf_centres_are_linspace_bit_for_bit(n_rbf):
    """float64, as the reference computes them under x64 (its package
    enables it)."""
    want = np.asarray(jnp.linspace(0.0, 5.0, n_rbf))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(gnn.rbf_centres(n_rbf).numpy(), want)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).replace("torch.", "")
    return out


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_and_registry_match_jax(arch):
    spec, jspec = get_arch(arch), jax_arch(arch)
    assert (spec.name, spec.family, spec.notes, spec.shapes) == \
        (jspec.name, jspec.family, jspec.notes, jspec.shapes)
    for smoke in (True, False):
        want = dataclasses.asdict(jspec.make_config(smoke))
        want["dtype"] = np.dtype(want["dtype"]).name
        assert _fields(spec.make_config(smoke)) == want
    full = spec.make_config(False)
    if arch == "equiformer-v2":
        sizes = [len(b) for b in gnn.m_block_indices(full.l_max, full.m_max)]
        assert sizes == [len(b) for b in jg._m_blocks(full.l_max, full.m_max)]
        assert sum(sizes) == 29 and full.n_irreps == 49
