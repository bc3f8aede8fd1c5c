"""The 95th percentile over all of the window's batches of one synchronised
call of the entry, merge included (host clock): how stale walks get."""
from perfbench.harness.stats import percentile


def read(run):
    if not run.batches:
        return None
    return percentile([b.seconds for b in run.batches], 95) * 1e3
