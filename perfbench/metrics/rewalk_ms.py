"""Device ms a traced batch of the operations inside the `wharf.rewalk`
scope, from the profiler's device records."""


def read(run):
    t = run.trace
    if t is None or not run.traced_batches or not t.has_layer("wharf.rewalk"):
        return None
    return t.layer_s("wharf.rewalk") / run.traced_batches * 1e3
