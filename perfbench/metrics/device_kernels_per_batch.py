"""Device operations (kernels, copies, sets) a traced batch, from the
profiler's device records."""


def read(run):
    t = run.trace
    if t is None or not run.traced_batches or not t.ops:
        return None
    return len(t.ops) / run.traced_batches
