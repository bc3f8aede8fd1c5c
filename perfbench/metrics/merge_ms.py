"""Device ms a traced merge of the operations inside the `wharf.merge`
scope, from the profiler's device records."""


def read(run):
    t = run.trace
    if t is None or not run.traced_merges or not t.has_layer("wharf.merge"):
        return None
    return t.layer_s("wharf.merge") / run.traced_merges * 1e3
