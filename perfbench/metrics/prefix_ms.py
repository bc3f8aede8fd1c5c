"""Device ms a traced batch of the operations inside the `wharf.prefix`
scope, from the profiler's device records."""


def read(run):
    t = run.trace
    if t is None or not run.traced_batches or not t.has_layer("wharf.prefix"):
        return None
    return t.layer_s("wharf.prefix") / run.traced_batches * 1e3
