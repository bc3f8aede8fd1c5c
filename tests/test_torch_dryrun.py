"""The port's dry-run (repro_torch/launch/dryrun.py) and cell profile
(launch/profile_cell.py), on the CPU.

Held: a meta cell's record (counted FLOPs and bytes, `model_flops` and
their ratio, the roofline terms against the H100 constants of
launch/mesh.py and the dominant one, argument and output bytes, no peak
off the card); the CLI over the recsys cells into its `--out` file and
the wharf cells' refusal to run off the card unless asked; a wharf cell
counted on real inputs on the CPU at a cut config (its kernels' calls,
no FLOP, memory-bound); the static table of a meta cell; a wharf cell's
profile on the CPU at the smoke config."""
import json

import pytest
import torch

from _torch_wharf import registries  # noqa: F401
from repro_torch.launch import dryrun, mesh, profile_cell


def test_meta_cell_record():
    rec = dryrun.run_cell("gemma2-2b", "decode_32k", verbose=False)
    assert (rec["device"], rec["card"], rec["mesh"], rec["step"]) == ("meta", None, "1",
                                                                       "serve_step")
    fl, nb = rec["flops_per_card"], rec["bytes_per_card"]
    assert fl == rec["flops_by_dtype"]["bfloat16"] > 0 and nb > 0
    assert rec["flops_ratio_model_over_count"] == rec["model_flops"] / fl
    assert rec["roofline"] == {"compute_s": fl / mesh.PEAK_FLOPS_BF16,
                               "memory_s": nb / mesh.HBM_BW, "collective_s": 0.0}
    assert rec["bottleneck"] == "memory_s"
    mem = rec["memory"]
    assert mem["argument_bytes"] > 5e9 and mem["output_bytes"] > 0 and mem["peak_bytes"] is None
    assert mesh.peak_flops(torch.float32) == mesh.PEAK_FLOPS_F32 == 67e12


def test_cli_records_cells(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "dlrm-rm2", "--mesh", "1", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert sorted(recs) == [f"dlrm-rm2|{s}|full" for s in
                            ("retrieval_cand", "serve_bulk", "serve_p99", "train_batch")]
    assert all(r["flops_by_dtype"].keys() == {"float32"} for r in recs.values())
    if not torch.cuda.is_available():
        # the wharf cells run on the card unless the caller asks for the CPU
        assert dryrun.main(["--arch", "wharf-stream", "--shape", "stream_10k",
                            "--include-wharf", "--wharf-log2-n", "8",
                            "--out", str(out)]) == 1


def test_wharf_cell_on_the_cpu(registries):
    cfg = dryrun.wharf_config(8, max_pending=4)
    assert (cfg.n_vertices, cfg.edge_capacity, cfg.rewalk_capacity) == (256, 256 * 128, 2560)
    rec = dryrun.run_cell("wharf-stream", "stream_10k", config=cfg, device="cpu",
                          verbose=False)
    calls = rec["kernel_calls"]
    assert rec["device"] == "cpu" and rec["memory"]["peak_bytes"] is None
    assert calls["szudzik_pair"] >= cfg.length and calls["szudzik_unpair"] > 0
    assert calls["intersect_csr"] == calls["fused_rewalk_step"] == calls["sgns_step"] == 0
    assert rec["flops_per_card"] == 0 and rec["flops_ratio_model_over_count"] is None
    assert rec["bottleneck"] == "memory_s" and rec["bytes_per_card"] > 0


def test_static_profile_of_a_meta_cell():
    prof = profile_cell.profile_cell("gemma2-2b", "train_4k", smoke=True, top=5)
    rows = prof["static"]
    assert len(rows) == 5 and "device_ops" not in prof
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert prof["totals"].flops == 7141054218240.0       # the reference walker's count


def test_wharf_profile_on_the_cpu(registries, capsys):
    prof = profile_cell.profile_cell("wharf-stream", "stream_10k", smoke=True,
                                     device="cpu", top=8)
    dt = prof["device_ops"]
    assert dt["device"] == "cpu" and dt["busy_ms"] is None and len(dt["top"]) <= 8
    assert any(r[2] == "kernel" and r[3] == "szudzik_pair" for r in
               profile_cell.profile_cell("wharf-stream", "stream_10k", smoke=True,
                                         device="cpu", top=200, static_only=True)["static"])
    profile_cell.print_profile(prof)
    assert "wharf-stream x stream_10k (walk_update_step)" in capsys.readouterr().out
    assert [profile_cell.kernel_of(s) for s in (
        "unpair_kernel(long long const*, long long*, long long*, long long)",
        "void intersect_rows<4, CsrSrc>(CsrSrc, int, float, float)",
        "fused_step_kernel(StepArgs)", "at::native::vectorized_elementwise_kernel")] == [
        "szudzik_unpair", "intersect_csr", "fused_rewalk_step", None]


def test_wharf_cell_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("wharf-stream", "stream_10k", smoke=True, verbose=False)
