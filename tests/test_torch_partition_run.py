"""A cell's step partitioned over 4 gloo CPU ranks on a (data 2, model 2)
mesh equals the same step unsharded, at the smoke configs
(`repro_torch.launch.partitioned.check`: one spawn runs every case; each
rank compares its output shards with the matching slices of the unsharded
outputs and counts the collectives it made).

Held, for gemma2-2b's train step (f32; also with remat, and with one KV
head, whose queries are cut along the sequence, once with the CPU ranks'
all-gathers and Shard -> Shard moves run through the card's gloo routes),
its decode step (the cache's length cut over "model") and its single-
stream decode (the length cut over every dim), qwen2-moe-a2.7b's prefill
and train step, dlrm-rm2's serve and train steps and the full-graph train
steps of graphsage-reddit, gat-cora (the segment max) and equiformer-v2
(the index ops over the irreps, on each rank's rows): the forwards within rtol 1e-5 / atol 1e-6 (GNN_TOL), a train
step's loss and parameters within rtol 1e-4 / atol 1e-5
(tests/test_torch_lm_trainer.py's PARAM_TOL); the MoE routing of every
layer exact; each rank's collectives by kind and count those the meta
count of rank 0's partition makes, rank 0's bytes equal (another rank's
shard is no larger: the smoke vocab of 199 does not divide); no kernel
launched. qwen2-moe-a2.7b's steps are held in f64: in f32 its prefill's logits
differ by up to 3.9e-6 (magnitudes up to 3.3), the rounding of the
row-parallel products' partial sums carried through two layers; in f64
they agree to 1e-12 with the routing exact."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import partitioned


def smoke(arch, **kw):
    return dataclasses.replace(get_arch(arch).make_config(True), **kw)


TRAIN = {"kind": "train", "seq_len": 16, "global_batch": 4}
GRAPH = {"kind": "full", "n_nodes": 40, "n_edges": 120, "d_feat": 16}
CASES = {
    "gemma2_train": dict(arch="gemma2-2b", shape="train_4k", info=TRAIN,
                         config=smoke("gemma2-2b")),
    "gemma2_train_remat": dict(arch="gemma2-2b", shape="train_4k", info=TRAIN,
                               config=smoke("gemma2-2b", remat=True)),
    "gemma2_train_seq_cut": dict(arch="gemma2-2b", shape="train_4k", info=TRAIN,
                                 config=smoke("gemma2-2b", n_kv_heads=1)),
    "gemma2_train_gloo_routes": dict(arch="gemma2-2b", shape="train_4k", info=TRAIN,
                                     config=smoke("gemma2-2b", n_kv_heads=1), route_cpu=True),
    "gemma2_decode": dict(arch="gemma2-2b", shape="decode_32k",
                          info={"kind": "decode", "seq_len": 32, "global_batch": 4},
                          config=smoke("gemma2-2b")),
    "gemma2_decode_single_stream": dict(arch="gemma2-2b", shape="long_500k",
                                        info={"kind": "decode", "seq_len": 32,
                                              "global_batch": 1},
                                        config=smoke("gemma2-2b")),
    "qwen2_moe_prefill": dict(arch="qwen2-moe-a2.7b", shape="prefill_32k",
                              info={"kind": "prefill", "seq_len": 16, "global_batch": 4},
                              config=smoke("qwen2-moe-a2.7b", dtype=torch.float64),
                              routes=True),
    "dlrm_serve": dict(arch="dlrm-rm2", shape="serve_p99", info={"kind": "serve", "batch": 8},
                       config=smoke("dlrm-rm2")),
    "dlrm_train": dict(arch="dlrm-rm2", shape="train_batch", info={"kind": "train", "batch": 8},
                       config=smoke("dlrm-rm2")),
    "graphsage_full_graph_train": dict(arch="graphsage-reddit", shape="full_graph_sm",
                                       info=GRAPH, config=smoke("graphsage-reddit")),
    "gat_full_graph_train": dict(arch="gat-cora", shape="full_graph_sm", info=GRAPH,
                                 config=smoke("gat-cora")),
    "equiformer_full_graph_train": dict(arch="equiformer-v2", shape="full_graph_sm",
                                        info=GRAPH, config=smoke("equiformer-v2")),
    "qwen2_moe_train": dict(arch="qwen2-moe-a2.7b", shape="train_4k", info=TRAIN,
                            config=smoke("qwen2-moe-a2.7b", dtype=torch.float64)),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = partitioned.check(list(CASES.values()), device="cpu",
                            workdir=str(tmp_path_factory.mktemp("ranks")))
    return dict(zip(CASES, out))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_unsharded(results, name):
    r = results[name]
    assert len(r["ranks"]) == 4
    for i, rank in enumerate(r["ranks"]):
        bad = {k: c for k, c in rank["compare"].items() if c["excess"] > 0}
        assert not bad, (i, bad)
        assert partitioned.collectives_match(r["meta"], rank["collectives"], i), (
            i, rank["collectives"], r["meta"])
        assert not any(rank["launches"].values()), rank["launches"]
        if CASES[name].get("routes"):
            assert rank["routes_equal"], i
    assert partitioned.passed(r)
    routed = r["ranks"][0]["routed"]
    if CASES[name].get("route_cpu"):
        assert routed["_gather"] > 0 and routed["_reduce"] > 0 and routed["_reduce_scatter"] > 0
    else:
        assert not any(routed.values()), routed
    if name.startswith("gemma2_train"):
        assert len(r["ranks"][0]["compare"]) > 10         # every parameter and moment
