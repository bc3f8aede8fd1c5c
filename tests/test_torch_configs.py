"""The port's config registry (repro_torch/configs) against the JAX
package's: `WharfStreamConfig` field by field with its defaults,
`_wharf(smoke=True)`, `WHARF_SHAPES` and `walk_config()`, all after the
backend-name map of `repro_torch.convert` ("pallas" -> "cuda",
"interpret" -> "torch", "xla-ref" -> "ref"); and `select_backend()`, which
installs the three process-wide backends as the reference's does."""
import dataclasses

import pytest
import torch

import repro.configs as ref_configs
from repro.configs import wharf_stream as ref
from repro_torch import configs, convert
from repro_torch.configs import wharf_stream
from repro_torch.core import packed_store
from repro_torch.kernels import intersect, megakernel


def _port_shapes(shapes: dict) -> dict:
    return {k: _port_shape(v) for k, v in shapes.items()}


def _port_shape(shape: dict) -> dict:
    out = dict(shape)
    if "megakernel" in out:
        out["megakernel"] = convert.MEGAKERNEL_NAMES[out["megakernel"]]
    return out


def test_fields_and_defaults_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(ref.WharfStreamConfig)}
    got = {f.name: f.default for f in dataclasses.fields(wharf_stream.WharfStreamConfig)}
    assert list(got) == list(want)
    assert got == want      # every default is "auto" or a number: no name to map
    for smoke in (False, True):
        assert (convert.wharf_config_from(ref._wharf(smoke))
                == wharf_stream._wharf(smoke))


def test_backend_fields_are_mapped():
    jcfg = ref.WharfStreamConfig(find_next_backend="pallas",
                                 intersect_backend="xla-ref",
                                 megakernel="interpret", order=2,
                                 sampler="factorized")
    cfg = convert.wharf_config_from(jcfg)
    assert (cfg.find_next_backend, cfg.intersect_backend, cfg.megakernel) == (
        "cuda", "ref", "torch")
    assert cfg.walk_config() == convert.config_from(jcfg.walk_config())


def test_shapes_and_registry_match_jax():
    assert {k: _port_shape(v) for k, v in ref.WHARF_SHAPES.items()} == \
        wharf_stream.WHARF_SHAPES
    assert wharf_stream.WHARF_SHAPES["stream_10k_n2v_megakernel"]["megakernel"] == "cuda"
    arch, jarch = configs.get_arch("wharf-stream"), ref_configs.get_arch("wharf-stream")
    assert (arch.name, arch.family, arch.notes) == (jarch.name, jarch.family, jarch.notes)
    assert arch.shapes is wharf_stream.WHARF_SHAPES
    # the reference's whole registry: every family is ported
    ported = ref_configs.all_archs()
    assert configs.all_archs() == ported
    assert len(ported) == 11    # five LMs, four GNNs, dlrm-rm2, wharf-stream
    assert configs.all_cells() == ref_configs.all_cells()
    for name in ported:
        arch, jarch = configs.get_arch(name), ref_configs.get_arch(name)
        assert (arch.name, arch.family, arch.notes, arch.shapes) == \
            (jarch.name, jarch.family, jarch.notes, _port_shapes(jarch.shapes)), name
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert getattr(configs, name) == getattr(ref_configs, name)
    with pytest.raises(KeyError):
        configs.get_arch("qwen3-32b")


@pytest.mark.parametrize("order,sampler", [(1, "rejection"), (2, "rejection"),
                                           (2, "factorized")])
def test_walk_config_matches_jax(order, sampler):
    for smoke in (False, True):
        jcfg = dataclasses.replace(ref._wharf(smoke), order=order, sampler=sampler,
                                   metrics=smoke)
        cfg = convert.wharf_config_from(jcfg)
        assert cfg.walk_config() == convert.config_from(jcfg.walk_config())


@pytest.fixture
def registries():
    """Leave the three process-wide registries as they were."""
    saved = (packed_store._default_backend, packed_store._default_window,
             intersect._default_backend, megakernel._default_backend)
    yield
    (packed_store._default_backend, packed_store._default_window,
     intersect._default_backend, megakernel._default_backend) = saved


def test_select_backend_installs_like_jax(registries):
    """Explicit fields install (the FINDNEXT window with the FINDNEXT
    backend only); "auto" leaves a registry untouched, as the reference's
    contract says; the FINDNEXT default resolves per device."""
    cpu = torch.device("cpu")
    cfg = wharf_stream.WharfStreamConfig
    assert cfg().select_backend(cpu) == "torch"
    assert packed_store.get_default_window() == 8
    assert cfg(find_next_backend="ref", find_next_window=3,
               intersect_backend="torch", megakernel="ref").select_backend(cpu) == "ref"
    assert packed_store.get_default_window() == 3
    assert intersect.default_backend_request() == "torch"
    assert megakernel.default_backend_request() == "ref"
    # "auto" everywhere: nothing another component installed is reset
    assert cfg(find_next_window=5).select_backend(cpu) == "ref"
    assert packed_store.get_default_window() == 3
    assert intersect.default_backend_request() == "torch"
    assert megakernel.default_backend_request() == "ref"
    # an intersect-only config keeps the installed window
    cfg(intersect_backend="ref", find_next_window=6).select_backend(cpu)
    assert packed_store.get_default_window() == 3
    assert intersect.default_backend_request() == "ref"
    # the megakernel field "off" clears the registry
    cfg(megakernel="off").select_backend(cpu)
    assert megakernel.default_backend_request() is None
    # the installed FINDNEXT default is what a request of None takes
    assert packed_store.resolve_backend(None, cpu) == "ref"
    assert packed_store.resolve_backend("torch", cpu) == "torch"
    packed_store.set_default_backend("auto")
    assert packed_store.resolve_backend(None, cpu) == "torch"
    assert packed_store.resolve_backend(None, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        packed_store.set_default_backend("pallas")
    with pytest.raises(ValueError):
        packed_store.set_default_window(0)


def test_default_backend_reaches_store_reads(registries):
    """`find_next` with no backend resolves through the installed default:
    "cuda" on CPU tensors raises, never falls back."""
    from repro_torch import random as jr
    from repro_torch.core import StreamingGraph, WalkConfig, generate_corpus
    from repro_torch.data.streams import rmat_edges
    src, dst = rmat_edges(jr.PRNGKey(0, device="cpu"), 300, 6)
    g = StreamingGraph.from_edges(src, dst, 64, 4096, device="cpu")
    store = generate_corpus(jr.PRNGKey(1, device="cpu"), g, WalkConfig(2, 8))
    w = torch.arange(8)
    v = store.traverse(w, w // 2, 7)
    want = store.find_next(v[:, 3], w, torch.full_like(w, 3))
    packed_store.set_default_backend("ref")
    got = store.find_next(v[:, 3], w, torch.full_like(w, 3))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    packed_store.set_default_backend("cuda")
    with pytest.raises(ValueError, match="card"):
        store.find_next(v[:, 3], w, torch.full_like(w, 3))


def _port_fields(cfg) -> dict:
    """A model config's fields, nested configs included, with JAX dtypes
    as their names (jnp.float32 -> "float32", torch.float32 -> "float32")."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _port_fields(v)
        elif f.name == "dtype":
            v = str(v).replace("torch.", "").replace("<class 'jax.numpy.", "") \
                .replace("'>", "")
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "qwen1.5-110b", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
                                  "dlrm-rm2"])
def test_model_configs_match_jax_field_for_field(name):
    """Full and smoke configs of the LM archs and dlrm-rm2: every field
    (the MoE config's too) equal, the dtype mapped; the derived sizes."""
    for smoke in (False, True):
        jcfg = ref_configs.get_arch(name).make_config(smoke)
        cfg = configs.get_arch(name).make_config(smoke)
        assert type(cfg).__name__ == type(jcfg).__name__
        assert _port_fields(cfg) == _port_fields(jcfg), (name, smoke)
        want = {"bfloat16", "float32"}
        assert _port_fields(cfg)["dtype"] in want
        for prop in ("hd", "d_interact"):
            if hasattr(jcfg, prop):
                assert getattr(cfg, prop) == getattr(jcfg, prop)
