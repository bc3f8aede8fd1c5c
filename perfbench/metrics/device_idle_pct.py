"""The share of the traced cycle's wall time in which no operation ran on
the device (the union of the device records' intervals against the host
clock's window)."""


def read(run):
    t = run.trace
    if t is None or not run.traced_s or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / run.traced_s)
