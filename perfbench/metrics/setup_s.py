"""Process start to the first timed batch: kernel build (cold or found),
graph, corpus, engine, stream and warm-up (host clock)."""


def read(run):
    return run.setup_s
