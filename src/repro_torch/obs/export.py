"""Render a finished `StreamMetrics` to stable JSON and Prometheus text;
port of `repro/obs/export.py`.

`summary()` is the stable schema (v2: the `"staleness"` section and an
optional `"slo"` section); keys are append-only. `upgrade_summary()`
normalizes a v1 or v2 summary to the v2 shape, zero-filling the sections
v1 predates. `to_prometheus()` renders the same numbers in Prometheus
exposition format: every metric gets `# HELP`/`# TYPE` lines, and label
VALUES are escaped per the exposition format (backslash, double-quote,
newline). Given the same counters, both produce exactly the reference's
dicts and text.

Both accept a single-device metrics tree or an [S, ...]-stacked per-shard
one (reduced via `metrics.combine_shards`), plus optional host-side serve
counters (`WalkQueryService.obs_counters()`).
"""
from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np

from repro_torch.obs.metrics import (NEVER, OVERFLOW_SOURCES, PMIN_BUCKETS,
                               StreamMetrics, combine_shards)
from repro_torch.obs.staleness import (LAG_BUCKETS, LAG_THRESHOLDS, STALE_LAG,
                                 StalenessMetrics)
from repro_torch.tree import tree_map

SCHEMA = 2


def _as_host(m: StreamMetrics) -> StreamMetrics:
    """The metrics tree with every leaf moved to the CPU (one copy each)."""
    m = tree_map(lambda t: t.detach().cpu(), m)
    if m.n_steps.ndim == 1:  # [S, ...]-stacked per-shard metrics
        m = combine_shards(m)
    return m


def _staleness_summary(st: StalenessMetrics) -> dict:
    """The summary-v2 `"staleness"` section from a host-side pytree."""
    wsteps = int(st.walk_steps)
    stale = int(st.stale_walk_steps)
    transitions = int(st.audit_transitions)
    invalid = int(st.audit_invalid)
    return {
        "walk_lag_hist": {
            # bucket 0 = lag 0 (refreshed this batch); bucket b = lag in
            # [lower_bounds[b], lower_bounds[b+1]); last bucket open-ended
            "n_buckets": LAG_BUCKETS,
            "lower_bounds": [0, *LAG_THRESHOLDS],
            "counts": [int(c) for c in np.asarray(st.lag_hist)],
        },
        "walk_steps": wsteps,
        "lag_mean": round(float(st.lag_sum) / wsteps, 4) if wsteps else 0.0,
        "lag_max": int(st.lag_max),
        "stale_lag_threshold": STALE_LAG,
        "stale_walk_steps": stale,
        "stale_fraction": round(stale / wsteps, 6) if wsteps else 0.0,
        "audit": {
            "walks": int(st.audit_walks),
            "transitions": transitions,
            "invalid": invalid,
            "divergence_rate": round(invalid / transitions, 6)
            if transitions else 0.0,
        },
    }


def summary(m: StreamMetrics, serve: Optional[dict] = None,
            slo: Optional[dict] = None) -> dict:
    """Stable JSON-serializable counter summary (plain python scalars).

    `slo` is an already-JSON-ready SLO summary (`ServeSLO.summary()`),
    passed through under the `"slo"` key."""
    m = _as_host(m)
    steps = int(m.n_steps)
    aff = int(m.affected_total)
    sent = int(m.handoff_sent)
    first = np.asarray(m.overflow_first_epoch, dtype=np.uint32)
    out = {
        "schema": SCHEMA,
        "steps": steps,
        "affected": {
            "total": aff,
            "max_per_step": int(m.affected_max),
            "mean_per_step": round(aff / steps, 3) if steps else 0.0,
        },
        "rewalk_suffix_hist": {
            # bucket b counts affected lanes with suffix fraction
            # (l - p_min)/l in [b/NB, (b+1)/NB); full re-walks land last
            "n_buckets": PMIN_BUCKETS,
            "edges": [round(b / PMIN_BUCKETS, 4)
                      for b in range(PMIN_BUCKETS + 1)],
            "counts": [int(c) for c in np.asarray(m.pmin_hist)],
        },
        "pending": {"high_water_mark": int(m.pending_hwm)},
        "merges": {"forced": int(m.merges_forced),
                   "eager": int(m.merges_eager)},
        "order2": {"deg_fallback_lane_steps": int(m.deg_fallback_lanes)},
        "handoff": {
            "sent_total": sent,
            "cross_shard_total": int(m.handoff_cross),
            "max_dest_load_per_step": int(m.handoff_max_load),
            "mean_sent_per_step": round(sent / steps, 3) if steps else 0.0,
        },
        "overflow_first_epoch": {
            name: (None if int(first[i]) == NEVER else int(first[i]))
            for i, name in enumerate(OVERFLOW_SOURCES)
        },
        "staleness": _staleness_summary(m.staleness),
    }
    if serve is not None:
        out["serve"] = {k: int(v) for k, v in serve.items()}
    if slo is not None:
        out["slo"] = slo
    return out


def upgrade_summary(s: dict) -> dict:
    """Normalize a v1 OR v2 summary dict to the v2 shape (round-trip
    contract: the schema is append-only, so a v1 cell upgrades by zero-
    filling the sections it predates and nothing else changes; a v2 cell
    passes through unchanged). Raises on unknown schema versions."""
    v = s.get("schema")
    if v not in (1, SCHEMA):
        raise ValueError(f"unknown counters schema {v!r}; "
                         f"this build reads v1..v{SCHEMA}")
    out = dict(s)
    out["schema"] = SCHEMA
    if "staleness" not in out:
        out["staleness"] = _staleness_summary(StalenessMetrics.empty("cpu"))
    return out


def escape_label_value(v) -> str:
    """Escape a Prometheus label VALUE per the exposition format
    (backslash, double-quote, newline — in that order)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metric_name(s) -> str:
    """Sanitize a string into a legal Prometheus metric-name fragment."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", str(s))


def to_prometheus(m, serve: Optional[dict] = None, slo: Optional[dict] = None,
                  prefix: str = "wharf") -> str:
    """Prometheus exposition-format text of the same counters.

    Accepts a StreamMetrics or an already-built `summary()` dict."""
    s = m if isinstance(m, dict) else summary(m, serve=serve, slo=slo)
    lines = []

    def counter(name, value, help_txt, labels=""):
        lines.append(f"# HELP {prefix}_{name} {help_txt}")
        lines.append(f"# TYPE {prefix}_{name} counter")
        lines.append(f"{prefix}_{name}{labels} {value}")

    def gauge(name, value, help_txt, labels=""):
        lines.append(f"# HELP {prefix}_{name} {help_txt}")
        lines.append(f"# TYPE {prefix}_{name} gauge")
        lines.append(f"{prefix}_{name}{labels} {value}")

    def histogram_header(name, help_txt):
        lines.append(f"# HELP {prefix}_{name} {help_txt}")
        lines.append(f"# TYPE {prefix}_{name} histogram")

    counter("stream_steps_total", s["steps"], "stream update steps observed")
    counter("affected_walks_total", s["affected"]["total"],
            "cumulative |MAV| affected walks")
    gauge("affected_walks_max_per_step", s["affected"]["max_per_step"],
          "max per-step |MAV|")
    hist = s["rewalk_suffix_hist"]
    histogram_header("rewalk_suffix_fraction",
                     "re-walked suffix fraction (l - p_min)/l per lane")
    cum = 0
    for i, c in enumerate(hist["counts"]):
        cum += c
        lines.append(f'{prefix}_rewalk_suffix_fraction_bucket'
                     f'{{le="{hist["edges"][i + 1]}"}} {cum}')
    lines.append(f"{prefix}_rewalk_suffix_fraction_count {cum}")
    gauge("pending_high_water", s["pending"]["high_water_mark"],
          "pending version-block fill high-water mark")
    counter("merges_total", s["merges"]["forced"],
            "in-scan pending consolidations", labels='{cause="forced"}')
    lines.append(f'{prefix}_merges_total{{cause="eager"}} '
                 f'{s["merges"]["eager"]}')
    counter("order2_deg_fallback_lane_steps_total",
            s["order2"]["deg_fallback_lane_steps"],
            "deg>dmax rejection-fallback sampling lane-steps")
    counter("handoff_lanes_sent_total", s["handoff"]["sent_total"],
            "frontier lanes routed through all_to_all")
    counter("handoff_lanes_cross_shard_total",
            s["handoff"]["cross_shard_total"],
            "frontier lanes that changed shards")
    gauge("handoff_max_dest_load", s["handoff"]["max_dest_load_per_step"],
          "max lanes aimed at one destination shard in any step")
    tripped = [(name, epoch)
               for name, epoch in s["overflow_first_epoch"].items()
               if epoch is not None]
    if tripped:
        lines.append(f"# HELP {prefix}_overflow_first_epoch first stream "
                     f"epoch a capacity overflow tripped (absent = never)")
        lines.append(f"# TYPE {prefix}_overflow_first_epoch gauge")
        for name, epoch in tripped:
            lines.append(f'{prefix}_overflow_first_epoch'
                         f'{{source="{escape_label_value(name)}"}} {epoch}')
    if "staleness" in s:
        st = s["staleness"]
        lh = st["walk_lag_hist"]
        histogram_header("walk_freshness_lag",
                         "epochs since each walk was last refreshed")
        cum = 0
        bounds = lh["lower_bounds"][1:] + ["+Inf"]
        for i, c in enumerate(lh["counts"]):
            cum += c
            lines.append(f'{prefix}_walk_freshness_lag_bucket'
                         f'{{le="{bounds[i]}"}} {cum}')
        lines.append(f"{prefix}_walk_freshness_lag_count {cum}")
        gauge("walk_stale_fraction", st["stale_fraction"],
              f"fraction of walk observations with lag >= "
              f"{st['stale_lag_threshold']}")
        gauge("walk_freshness_lag_max", st["lag_max"],
              "max walk lag observed")
        counter("audit_transitions_total", st["audit"]["transitions"],
                "walk transitions replayed by the divergence auditor")
        counter("audit_invalid_transitions_total", st["audit"]["invalid"],
                "replayed transitions with no live edge")
        gauge("audit_divergence_rate", st["audit"]["divergence_rate"],
              "invalid fraction of audited transitions")
    if "serve" in s:
        for k, v in s["serve"].items():
            # counters already carrying the serve_ prefix (e.g.
            # serve_validation_errors) must not come out doubled
            base = k[6:] if k.startswith("serve_") else k
            counter(f"serve_{metric_name(base)}_total", v,
                    f"serving-layer {k}")
    if "slo" in s:
        sl = s["slo"]
        histogram_header("serve_latency_us",
                         "serving span latency by kind/view/mode (summary "
                         "quantile upper bounds)")
        kinds = sorted(sl.get("kinds", {}).items())
        for kind, kd in kinds:
            kl = escape_label_value(kind)
            lines.append(f'{prefix}_serve_latency_us_count'
                         f'{{kind="{kl}"}} {kd["count"]}')
            for q in ("p50", "p95", "p99"):
                lines.append(
                    f'{prefix}_serve_latency_us{{kind="{kl}",'
                    f'quantile="{q}"}} {kd[f"{q}_us"]}')
        # HELP/TYPE once per metric family, then one line per kind
        lines.append(f"# HELP {prefix}_serve_qps serving requests per "
                     f"second over the SLO window")
        lines.append(f"# TYPE {prefix}_serve_qps gauge")
        for kind, kd in kinds:
            lines.append(f'{prefix}_serve_qps{{kind='
                         f'"{escape_label_value(kind)}"}} '
                         f'{kd.get("qps", 0.0)}')
        lines.append(f"# HELP {prefix}_serve_span_errors_total serving "
                     f"spans that raised")
        lines.append(f"# TYPE {prefix}_serve_span_errors_total counter")
        for kind, kd in kinds:
            lines.append(f'{prefix}_serve_span_errors_total{{kind='
                         f'"{escape_label_value(kind)}"}} '
                         f'{kd.get("errors", 0)}')
        if sl.get("burn_rates"):
            lines.append(f"# HELP {prefix}_slo_burn_rate SLO error-budget "
                         f"burn (<=1 within budget)")
            lines.append(f"# TYPE {prefix}_slo_burn_rate gauge")
            for kind, rate in sorted(sl["burn_rates"].items()):
                lines.append(f'{prefix}_slo_burn_rate{{kind='
                             f'"{escape_label_value(kind)}"}} {rate}')
    return "\n".join(lines) + "\n"


def write_summary(path: str, m: StreamMetrics,
                  serve: Optional[dict] = None,
                  slo: Optional[dict] = None) -> dict:
    """Dump `summary()` as JSON to `path`; returns the summary dict."""
    s = summary(m, serve=serve, slo=slo)
    with open(path, "w") as f:
        json.dump(s, f, indent=2, sort_keys=True)
        f.write("\n")
    return s
