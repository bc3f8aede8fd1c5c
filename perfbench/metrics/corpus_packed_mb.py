"""MB of the packed corpus (`WalkStore.nbytes_packed`) after the window's
last merge."""


def read(run):
    b = run.counters.get("corpus_packed_bytes")
    return None if b is None else b / 1e6
