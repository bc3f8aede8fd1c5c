"""torch.cuda.max_memory_allocated() over the window, reset after set-up:
the resident graph, corpus and pending blocks count."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
