"""The mean over the window's batches of the affected-walk count that the
entry returns (the MAV's output)."""


def read(run):
    if not run.batches:
        return None
    return sum(b.affected for b in run.batches) / len(run.batches)
