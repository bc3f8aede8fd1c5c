"""Stream telemetry and serving observability; port of `repro/obs/`.

  * obs/metrics.py — `StreamMetrics`, device counters the stream loops
    update when `WalkConfig.metrics` is on (OFF runs none of it).
  * obs/staleness.py — walk-freshness counters nested in StreamMetrics:
    the per-walk epoch-lag histogram, the stale-walk fraction, and the
    K-sample divergence auditor.
  * obs/trace.py — host-side phase spans (`torch.profiler.record_function`)
    and a Chrome-trace-compatible JSONL span log, with span observers.
  * obs/slo.py — serve-side SLO layer fed by the trace observers.
  * obs/export.py — stable JSON summaries (schema v2) and Prometheus text.
  * obs/regress.py — the regression sentinel over BENCH-style JSON cells.
"""
from repro_torch.obs.metrics import (NEVER, OVERFLOW_SOURCES,  # noqa: F401
                                     PMIN_BUCKETS, StreamMetrics,
                                     combine_shards)
from repro_torch.obs.staleness import (LAG_BUCKETS,  # noqa: F401
                                       LAG_THRESHOLDS, STALE_LAG,
                                       StalenessMetrics)
