"""Kernel 5's share of its roofline over the traced cycle: the sum over its
calls of each call's bound (the larger of its bytes over 3.35 TB/s and its
operations over 67 T/s, counted by perfbench/harness/work.py from the
operands of each call) over the kernel's device time in the trace."""

KERNEL = "intersect_rows"


def read(run):
    t = run.trace
    bound = run.counters.get("k5_bound_s")
    if t is None or not run.counters.get("k5_calls") or not bound:
        return None
    device_s = t.op_s(KERNEL)
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
