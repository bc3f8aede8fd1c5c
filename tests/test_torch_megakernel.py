"""The fused rewalk step: the port's fused path ("torch", the kernel's plain
version, and "ref", the composed oracle) = the port's unfused path = the
JAX package's fused path ("interpret"), bit for bit, on the walk models of
tests/test_megakernel.py (window overflow at dmax=8 included, and a
one-chunk FINDNEXT window so that the wide-range fix-up runs); and the
registry and guards."""
import types

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (STORE_FIELDS, drive_per_batch, jax_state_to_numpy,
                           make_jax_engine, make_stream, port_engine_like,
                           store_dict)
from repro_torch import convert
from repro_torch.core import packed_store
from repro_torch.core.corpus import WalkConfig
from repro_torch.core.walkers import WalkModel
from repro_torch.kernels import megakernel

_MODELS = {
    "deepwalk": dict(order=1),
    "n2v-rejection": dict(order=2, sampler="rejection"),
    "n2v-factorized": dict(order=2, sampler="factorized", dmax=64),
    "n2v-factorized-overflow": dict(order=2, sampler="factorized", dmax=8),
}


@pytest.mark.parametrize("model", list(_MODELS))
def test_fused_matches_unfused_and_reference(model, monkeypatch):
    kw = _MODELS[model]
    length = 6 if kw["order"] == 2 else 8
    jeng = make_jax_engine(length=length, megakernel="interpret", **kw)
    engines = {mk: port_engine_like(jeng, cfg=convert.config_from(
        jeng.cfg)._replace(megakernel=mk)) for mk in ("off", "torch", "ref")}
    stream = make_stream(n_batches=3)
    drive_per_batch(jeng, jax.random.PRNGKey(11), stream)
    want = jax_state_to_numpy(jeng.state)
    if model == "n2v-factorized":
        # one candidate chunk per FINDNEXT: wide ranges take the fix-up scan
        monkeypatch.setattr(packed_store, "_default_window", 1)
    for mk, eng in engines.items():
        eng.run_stream(np.asarray(jax.random.PRNGKey(11)), *stream)
        got = convert.state_to_numpy(eng.state)
        for k in convert.FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{mk}:{k}")
    jeng.merge()
    for mk, eng in engines.items():
        eng.merge()
        a, b = store_dict(jeng.store), store_dict(eng.store)
        for f in STORE_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{mk}:{f}")


def test_registry_roundtrip_and_auto(monkeypatch):
    cpu = torch.device("cpu")
    assert megakernel.default_backend_request() is None
    for name in ("auto", None, "off"):
        assert megakernel.resolve_backend(name, cpu) is None
    for bad in ("nope", "pallas", "interpret"):
        with pytest.raises(ValueError):
            megakernel.resolve_backend(bad, cpu)
        with pytest.raises(ValueError):
            megakernel.set_default_backend(bad)
    with pytest.raises(ValueError, match="card"):
        megakernel.resolve_backend("cuda", cpu)
    jeng = make_jax_engine(length=7)
    ref = port_engine_like(jeng)
    auto = port_engine_like(jeng)
    stream = make_stream(n_batches=2)
    calls = []
    plain = megakernel.fused_step_plain
    monkeypatch.setattr(megakernel, "fused_step_plain",
                        lambda *a: calls.append(1) or plain(*a))
    try:
        megakernel.set_default_backend("torch")
        assert megakernel.resolve_backend("auto", cpu) == "torch"
        auto.run_stream(np.asarray(jax.random.PRNGKey(4)), *stream)
    finally:
        megakernel.set_default_backend(None)
    assert len(calls) == 2 * 7       # one fused step per position and batch
    ref.run_stream(np.asarray(jax.random.PRNGKey(4)), *stream)
    a, b = convert.state_to_numpy(ref.state), convert.state_to_numpy(auto.state)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert megakernel.resolve_backend("auto", cpu) is None


def test_guards_refuse_rather_than_fall_back():
    big = types.SimpleNamespace(n_walks=1 << 20, length=1 << 13)
    small = types.SimpleNamespace(n_walks=64, length=8)
    deep = WalkConfig()
    for b in ("cuda", "torch"):
        with pytest.raises(ValueError, match="u32"):
            megakernel.check_supported(big, deep, b)
    megakernel.check_supported(big, deep, "ref")
    off_tile = WalkConfig(model=WalkModel(order=2, sampler="factorized",
                                          dmax=64))
    with pytest.raises(ValueError, match="dmax"):
        megakernel.check_supported(small, off_tile, "cuda")
    megakernel.check_supported(small, off_tile, "torch")
    megakernel.check_supported(small, off_tile._replace(
        model=off_tile.model._replace(dmax=256)), "cuda")
    jeng = make_jax_engine(order=2, sampler="factorized", length=6)
    eng = port_engine_like(jeng, cfg=convert.config_from(jeng.cfg)._replace(
        megakernel="cuda"))
    with pytest.raises(ValueError):
        eng.insert_edges(np.asarray(jax.random.PRNGKey(0)), [1], [2])
