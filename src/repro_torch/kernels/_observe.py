"""Who is told of kernel calls: an observer installed by `observe`
(`launch/op_analysis.py`) runs each observed call inside
`observer.kernel(name, args)`. The wrappers of `kernels/ops.py` are
observed, and so are the plain twins that a CPU route calls without a
wrapper (the FINDNEXT, intersect, fused-step and SGNS twins), under their
kernel's name, so that a count on the CPU sees what a count on the card
sees. A twin called inside an observed wrapper is the wrapper's call."""
from __future__ import annotations

import contextlib
import functools

_observer = None


@contextlib.contextmanager
def observe(observer):
    """Within the block, each observed call runs inside
    `observer.kernel(name, args)`."""
    global _observer
    saved, _observer = _observer, observer
    try:
        yield observer
    finally:
        _observer = saved


def observed(name: str, args_of=None):
    """Report the decorated function's calls as kernel `name`'s, with
    `args_of(args)` (default: the args) as the kernel's operands."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args):
            if _observer is None:
                return fn(*args)
            with _observer.kernel(name, args if args_of is None else args_of(args)):
                return fn(*args)
        return wrapper
    return deco
