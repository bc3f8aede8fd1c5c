"""Serve-side SLO layer: latency histograms, QPS, burn rates; port of
`repro/obs/slo.py` (pure Python over `trace`).

The serving frontend (serve/walk_queries.py) already spans every query
with `trace.phase("serve/<kind>", cat="serve")`; this module turns those
spans into SLO signals WITHOUT touching the query code — a `ServeSLO`
collector registers as a trace span observer (`trace.add_observer`) and
folds every `cat="serve"` span into a log-bucketed latency histogram
keyed (kind, view, mode):

  * kind — the span name ("serve/ppr_rows", ...);
  * view — "live" or "pinned" (the span's `view=` arg; queries without a
    snapshot label default live);
  * mode — "batched" when the span's `batch=` arg is > 1, else "percall"
    (the batched-vs-per-call axis).

Histogram buckets are powers of two in microseconds (bucket 0 = [0, 1us),
bucket b = [2^(b-1), 2^b) us, last open-ended): percentile estimates
(p50/p95/p99) report the upper bound of the covering bucket — a <=2x
conservative bound, stable and mergeable, which is what SLO evaluation
wants (exact order statistics would need unbounded per-request storage).

SLO targets are config-declared: `SLOTarget(latency_us, objective)` reads
"fraction `objective` of requests complete within `latency_us`". Burn
rate = observed violation fraction / allowed violation fraction — the
standard error-budget form: <= 1.0 means within budget, 2.0 means burning
budget twice as fast as allowed. Violations are counted exactly at
observe time (not re-derived from buckets), so a target placed between
bucket bounds still evaluates exactly.

Host-side `ValueError` validations (id/hops/restart_prob/k checks) are
counted per kind via `validation_error()` — the serving layer notifies the
installed collector, and `WalkQueryService.obs_counters()` exports the
total as `serve_validation_errors`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.obs import trace

# bucket b upper bound = 2^b us; last bucket open-ended (~67s)
N_BUCKETS = 28

SERVE_CAT = "serve"
VIEWS = ("live", "pinned")
MODES = ("batched", "percall")


def bucket_of(dur_us: float) -> int:
    """Index of the log2 bucket covering a duration."""
    if dur_us < 1.0:
        return 0
    b = 1
    while b < N_BUCKETS - 1 and dur_us >= float(1 << b):
        b += 1
    return b


def bucket_upper_us(b: int) -> float:
    """Upper bound of bucket b (the percentile estimate it reports)."""
    return float(1 << b)


class LatencyHistogram:
    """Log2-bucketed latency accumulator (counts + sum, like a Prometheus
    histogram): O(1) observe, percentile upper bounds from the buckets."""

    __slots__ = ("counts", "count", "sum_us")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum_us = 0.0

    def observe(self, dur_us: float) -> None:
        self.counts[bucket_of(dur_us)] += 1
        self.count += 1
        self.sum_us += dur_us

    def quantile_us(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation
        (0.0 for an empty histogram)."""
        if self.count == 0:
            return 0.0
        rank = max(1, -(-int(q * 1e6) * self.count // 1_000_000))
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return bucket_upper_us(b)
        return bucket_upper_us(N_BUCKETS - 1)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_us": round(self.sum_us / self.count, 3) if self.count
            else 0.0,
            "p50_us": self.quantile_us(0.50),
            "p95_us": self.quantile_us(0.95),
            "p99_us": self.quantile_us(0.99),
        }


@dataclass(frozen=True)
class SLOTarget:
    """Fraction `objective` of a kind's requests must finish within
    `latency_us` (e.g. SLOTarget(50_000, 0.99): p99 under 50ms)."""

    latency_us: float
    objective: float = 0.99


class ServeSLO:
    """Span-observer SLO collector over the serving layer's phase spans.

    `install(collector)` wires it to `trace.phase`; every `cat="serve"`
    span lands in the (kind, view, mode) histogram. Thread-safe (the
    serving layer is host-side and may be driven from multiple threads)."""

    def __init__(self, targets: Optional[Dict[str, SLOTarget]] = None,
                 clock=time.perf_counter):
        self.targets = dict(targets or {})
        self._hist: Dict[Tuple[str, str, str], LatencyHistogram] = {}
        self._viol: Dict[str, int] = {}      # exact target violations
        self._errors: Dict[str, int] = {}    # spans that raised
        self._validation: Dict[str, int] = {}  # host-side input rejections
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- ingest

    def on_span(self, name: str, cat: str, dur_us: float, args: dict,
                error) -> None:
        """trace.add_observer entry point: fold one finished span."""
        if cat != SERVE_CAT:
            return
        view = str(args.get("view", "live"))
        batch = args.get("batch")
        mode = "batched" if batch is not None and int(batch) > 1 \
            else "percall"
        self.observe(name, dur_us, view=view, mode=mode,
                     error=error is not None)

    def observe(self, kind: str, dur_us: float, view: str = "live",
                mode: str = "percall", error: bool = False) -> None:
        with self._lock:
            key = (kind, view, mode)
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = LatencyHistogram()
            h.observe(dur_us)
            if error:
                self._errors[kind] = self._errors.get(kind, 0) + 1
            t = self.targets.get(kind)
            if t is not None and dur_us > t.latency_us:
                self._viol[kind] = self._viol.get(kind, 0) + 1

    def validation_error(self, kind: str) -> None:
        """Count one host-side input rejection (ValueError) for `kind`."""
        with self._lock:
            self._validation[kind] = self._validation.get(kind, 0) + 1

    # ------------------------------------------------------------ readout

    def window_s(self) -> float:
        return max(self._clock() - self._t0, 1e-9)

    def kind_count(self, kind: str) -> int:
        return sum(h.count for (k, _, _), h in self._hist.items()
                   if k == kind)

    def burn_rates(self) -> Dict[str, float]:
        """Error-budget burn per targeted kind: violation fraction over
        the allowed fraction (<= 1.0 means the SLO holds)."""
        out = {}
        for kind, t in self.targets.items():
            n = self.kind_count(kind)
            if n == 0:
                continue
            allowed = max(1.0 - t.objective, 1e-9)
            out[kind] = round((self._viol.get(kind, 0) / n) / allowed, 4)
        return out

    def summary(self) -> dict:
        """Stable JSON-ready SLO summary (the `summary-v2 "slo"` cell)."""
        with self._lock:
            window = self.window_s()
            kinds: Dict[str, dict] = {}
            for (kind, view, mode), h in sorted(self._hist.items()):
                k = kinds.setdefault(kind, {
                    "count": 0, "errors": self._errors.get(kind, 0),
                    "validation_errors": self._validation.get(kind, 0),
                    "by": {}})
                k["count"] += h.count
                k["by"][f"{view}/{mode}"] = h.summary()
            # kind-level percentiles over the merged buckets
            for kind, k in kinds.items():
                merged = LatencyHistogram()
                for (kk, _, _), h in self._hist.items():
                    if kk == kind:
                        for b, c in enumerate(h.counts):
                            merged.counts[b] += c
                        merged.count += h.count
                        merged.sum_us += h.sum_us
                k.update(merged.summary())
                k["qps"] = round(k["count"] / window, 3)
            # validation errors with no recorded span (rejected before the
            # phase body ran) still surface per kind
            for kind, n in self._validation.items():
                kinds.setdefault(kind, {"count": 0, "errors": 0, "by": {},
                                        **LatencyHistogram().summary(),
                                        "qps": 0.0}
                                 )["validation_errors"] = n
            return {
                "window_s": round(window, 6),
                "kinds": kinds,
                "targets": {k: {"latency_us": t.latency_us,
                                "objective": t.objective}
                            for k, t in sorted(self.targets.items())},
                "burn_rates": self.burn_rates(),
            }


# ---------------------------------------------------------- process hookup

_ACTIVE: Optional[ServeSLO] = None


def install(collector: Optional[ServeSLO] = None) -> ServeSLO:
    """Make `collector` (or a fresh default one) THE process SLO sink:
    registers it as a trace span observer and as the target of the serving
    layer's validation_error notifications."""
    global _ACTIVE
    uninstall()
    _ACTIVE = collector if collector is not None else ServeSLO()
    trace.add_observer(_ACTIVE.on_span)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        trace.remove_observer(_ACTIVE.on_span)
    _ACTIVE = None


def active() -> Optional[ServeSLO]:
    return _ACTIVE
