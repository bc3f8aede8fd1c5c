"""Edge updates a second: every insert and delete of every batch the window
completed, over the window's wall time (host clock, first dispatch to the
synchronise after the last batch, merges inside)."""
from perfbench.harness.stats import rate


def read(run):
    if not run.batches:
        return None
    return rate(sum(b.edges for b in run.batches), run.window_s)
