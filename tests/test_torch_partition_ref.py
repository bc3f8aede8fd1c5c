"""The port's partitioned dry-run (`dryrun.run_partitioned`, the records
of `python -m repro_torch.launch.dryrun --mesh single`) against the
reference's per-chip counts of the same cells compiled for the 16 x 16
mesh (tests/_torch_partition.py: a subprocess with 256 forced host devices
on Auto axes), on the CPU.

Held: dlrm-rm2 x serve_p99 is the reference's partition exactly (FLOPs a
rank, and one all-reduce of the masked lookup's partial bags, 212,992
bytes, nothing else); the decode cells' FLOPs a rank within 1% of the
reference's; the train and prefill cells' within 2x (the partitioners
place their activations differently; the ratio is printed); no work is
lost: FLOPs a rank x 256 >= the one-card count of the whole cell."""
import pytest

from _torch_partition import finish_reference, one_card_counts, port_counts, start_reference

N, MESH = 256, "16x16"
EXACT = "dlrm-rm2/serve_p99"
WITHIN_1PCT = ("gemma2-2b/decode_32k", "gemma2-2b/long_500k", "qwen2-moe-a2.7b/decode_32k")
WITHIN_2X = ("gemma2-2b/prefill_32k", "gemma2-2b/train_4k")
CELLS = (EXACT,) + WITHIN_1PCT + WITHIN_2X


@pytest.fixture(scope="module")
def counts():
    proc = start_reference(N, CELLS)
    try:
        port, whole = port_counts(False, CELLS), one_card_counts(CELLS)
    except BaseException:
        proc.kill()
        raise
    return finish_reference(proc), port, whole


def test_records_are_one_ranks(counts):
    _, port, _ = counts
    for cell, rec in port.items():
        assert (rec["mesh"], rec["n_cards"], rec["device"]) == (MESH, N, "meta"), cell
        assert rec["flops_per_card"] > 0 and rec["bytes_per_card"] > 0, cell
        assert rec["flops_ratio_model_over_count"] == pytest.approx(
            rec["model_flops"] / (rec["flops_per_card"] * N)), cell


def test_dlrm_serve_is_the_references_partition(counts):
    ref, port, _ = counts
    got, want = port[EXACT], ref[EXACT]
    assert got["flops_per_card"] == want["flops"] == 34_852_864
    assert got["collective_breakdown"]["all-reduce"] == want["coll_bytes"]["all-reduce"] == 212_992
    assert got["collective_counts"]["all-reduce"] == want["coll_counts"]["all-reduce"] == 1
    assert got["collective_bytes_per_card"] == 212_992


@pytest.mark.parametrize("cell", WITHIN_1PCT)
def test_decode_flops_within_one_percent(counts, cell):
    ref, port, _ = counts
    assert port[cell]["flops_per_card"] == pytest.approx(ref[cell]["flops"], rel=0.01)


@pytest.mark.parametrize("cell", WITHIN_2X)
def test_train_and_prefill_flops_within_twice(counts, cell):
    ref, port, _ = counts
    ratio = port[cell]["flops_per_card"] / ref[cell]["flops"]
    print(f"{cell} on {MESH}: port / reference FLOPs a rank = {ratio:.3f}")
    assert 0.5 <= ratio <= 2.0


@pytest.mark.parametrize("cell", CELLS)
def test_no_work_lost(counts, cell):
    _, port, whole = counts
    assert port[cell]["flops_per_card"] * N >= whole[cell]["flops_per_card"]
