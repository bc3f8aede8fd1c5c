"""The port's order-2 `run_stream` with the factorized sampler against the JAX
package's, both merge policies x both merge impls, bit for bit (graph
codes, every store array, slot_epoch, pending blocks, traversed corpus)."""
import pytest

from _torch_parity import check_order2_stream


@pytest.mark.parametrize("policy", ["on-demand", "eager"])
@pytest.mark.parametrize("merge_impl", ["interleave", "lexsort"])
def test_order2_factorized_run_stream_matches_reference(policy, merge_impl):
    check_order2_stream("factorized", policy, merge_impl)
