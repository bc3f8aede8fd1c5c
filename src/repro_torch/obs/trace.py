"""Host-side phase tracing: profiler annotations + a JSONL span log; port
of `repro/obs/trace.py`.

Two complementary mechanisms behind one `phase(...)` context manager:

  * `torch.profiler.record_function(name)` — the span shows up on the host
    timeline of a `torch.profiler` trace, and the operators and kernels
    launched inside it are grouped under the name there (the reference
    opens `jax.profiler.TraceAnnotation` + `jax.named_scope`).
  * an optional process-global `TraceLog` — each span is appended as one
    Chrome-trace "complete" (`"ph": "X"`) event per line to a JSONL file.
    `python -c 'import json,sys; print(json.dumps([json.loads(l) for l in
    sys.stdin]))' < spans.jsonl > trace.json` produces a file chrome://
    tracing / Perfetto loads directly; keeping the log line-oriented means
    crashes lose at most one span and runs can append concurrently.

Phase taxonomy — use these constants so trace consumers can group spans:
FINDNEXT (packed-chunk decode / prefix traversal), INTERSECT (order-2
neighbor intersection), SAMPLE (SAMPLENEXT draws), WRITE_BACK
(version-block append + slot-epoch bump), MERGE (pending consolidation),
COLLECTIVE (cross-shard exchange), plus free-form "serve/<query>" spans
from the serving layer.

A span measures HOST wall time between enter and exit, and does not
synchronise the device. On the card, where kernels run asynchronously, a
span around a query therefore measures its launch time plus whatever the
host waited for inside it (a `.item()`, a host copy), not the device time
of its kernels: a caller that wants device-inclusive time calls
`torch.cuda.synchronize()` before leaving the span, and a device profile
is the `record_function` side of the same span under `torch.profiler`.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

from torch.profiler import record_function

# engine phases
FINDNEXT = "findnext"
INTERSECT = "intersect"
SAMPLE = "sample"
WRITE_BACK = "write_back"
MERGE = "merge"
COLLECTIVE = "collective"
PHASES = (FINDNEXT, INTERSECT, SAMPLE, WRITE_BACK, MERGE, COLLECTIVE)


class TraceLog:
    """Append-only Chrome-trace JSONL span sink (one event object per line).

    Timestamps are microseconds since the log was opened (`ts`), durations
    microseconds (`dur`) — the Chrome trace-event "X" convention."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def event(self, name: str, cat: str, ts_us: float, dur_us: float,
              args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(ts_us, 3), "dur": round(dur_us, 3),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        line = json.dumps(ev, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")

    def close(self) -> None:
        self._f.close()


_LOG: Optional[TraceLog] = None

# span observers: callables (name, cat, dur_us, args, error) notified on
# every phase() exit (whether or not a TraceLog is installed) — the hook
# obs/slo.py rides to build latency histograms without touching the query
# code. `error` is the exception instance if the span body raised, else
# None. Observers must not raise on the serving hot path; exceptions are
# deliberately NOT swallowed here (an observer bug should fail tests, not
# silently drop telemetry).
_OBSERVERS: list = []


def add_observer(fn) -> None:
    """Register a span observer `(name, cat, dur_us, args, error)`."""
    if fn not in _OBSERVERS:
        _OBSERVERS.append(fn)


def remove_observer(fn) -> None:
    if fn in _OBSERVERS:
        _OBSERVERS.remove(fn)


def install(path: str) -> TraceLog:
    """Open `path` as the process-global span log (appending). Subsequent
    `phase(...)` spans are recorded until `uninstall()`."""
    global _LOG
    if _LOG is not None:
        _LOG.close()
    _LOG = TraceLog(path)
    return _LOG


def uninstall() -> None:
    global _LOG
    if _LOG is not None:
        _LOG.close()
    _LOG = None


def active() -> Optional[TraceLog]:
    return _LOG


@contextlib.contextmanager
def phase(name: str, cat: str = "engine", **args):
    """Span a host-side phase: profiler annotation + JSONL.

    `name` is free-form ("serve/ppr_row") or one of the PHASES constants;
    `args` become the Chrome-trace event's `args` payload. Cheap beyond
    the `record_function` scope when no TraceLog or observer is
    installed.

    A raised query still flushes its span: the exception is captured in
    the event's `args.error` field ("TypeName: message") and re-raised, so
    the JSONL tail holds the failing span instead of silently losing it,
    and SLO observers see the error for their error-rate counters."""
    log = _LOG
    t0 = time.perf_counter()
    err: Optional[BaseException] = None
    with record_function(name):
        try:
            yield
        except BaseException as e:
            err = e
            raise
        finally:
            dur = (time.perf_counter() - t0) * 1e6
            payload = dict(args) if args else None
            if err is not None:
                payload = dict(payload or {})
                payload["error"] = f"{type(err).__name__}: {err}"
            if log is not None:
                log.event(name, cat, (t0 - log._t0) * 1e6, dur, payload)
            for fn in list(_OBSERVERS):
                fn(name, cat, dur, args or {}, err)


def read_spans(path: str) -> list:
    """Parse a JSONL span log back into a list of event dicts (helper for
    tests and for wrapping into a chrome://tracing-loadable JSON array)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
