"""Who is told of kernel calls: an observer installed by `observe`
(`launch/op_analysis.py`) runs each observed call inside
`observer.kernel(name, args)`. The wrappers of `kernels/ops.py` are
observed, and so are the plain twins that a CPU route calls without a
wrapper (the FINDNEXT, intersect, fused-step and SGNS twins), under their
kernel's name, so that a count on the CPU sees what a count on the card
sees. A twin called inside an observed wrapper is the wrapper's call.
The observer is the calling thread's: a counter of one rank of ranks run
as threads (`launch/lockstep.py`) sees that rank's calls alone."""
from __future__ import annotations

import contextlib
import functools
import threading

_tls = threading.local()


@contextlib.contextmanager
def observe(observer):
    """Within the block, each observed call this thread makes runs inside
    `observer.kernel(name, args)`."""
    saved, _tls.observer = getattr(_tls, "observer", None), observer
    try:
        yield observer
    finally:
        _tls.observer = saved


def observed(name: str, args_of=None):
    """Report the decorated function's calls as kernel `name`'s, with
    `args_of(args)` (default: the args) as the kernel's operands."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args):
            observer = getattr(_tls, "observer", None)
            if observer is None:
                return fn(*args)
            with observer.kernel(name, args if args_of is None else args_of(args)):
                return fn(*args)
        return wrapper
    return deco
