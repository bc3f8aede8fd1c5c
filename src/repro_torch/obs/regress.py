"""Bench regression sentinel: diff BENCH_*.json cells against baselines;
port of `repro/obs/regress.py` (pure Python, the port's own copy).

Benchmark cells record wins and losses alike; this module compares
them against committed baselines so that a regression surfaces by itself:

  * `flatten()` turns a BENCH payload into dotted-path cells
    ("under_stream.ppr_rows.live.p99_us" -> number/bool/string);
  * `Rule`s pattern-match cell paths (fnmatch, FIRST match wins) and carry
    per-cell noise thresholds: `max_rel_delta` (relative, in the WORSE
    direction only when `direction` says which way is worse),
    `max_abs_delta` (an absolute noise floor — both must be exceeded to
    breach), and `gate` (False = informational: recorded in the verdict,
    never fails it — raw timing cells on shared CI runners are info-only
    by default, counts/ratios/booleans gate);
  * `compare()` produces a machine-readable verdict dict (schema'd,
    append-only like the counters summary) with per-cell status:
    "pass" | "fail" | "info" (non-gating breach) | "new" (no baseline
    cell) | "missing" (baseline cell gone — informational: schema moves
    are legitimate, deleting a cell to hide a loss shows up in review).

The JAX package drives this from `benchmarks/check_regression.py`; the
port has no benchmark of its own yet, so nothing here calls it, and the
rules and verdicts are the reference's, byte for byte.
"""
from __future__ import annotations

import fnmatch
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple, Union

VERDICT_SCHEMA = 1

Cell = Union[int, float, bool, str]


@dataclass(frozen=True)
class Rule:
    """One threshold rule; fields mirror regression_thresholds.json."""

    pattern: str                 # fnmatch over dotted cell paths
    max_rel_delta: Optional[float] = None  # None: any numeric change passes
    max_abs_delta: float = 0.0   # noise floor: |delta| must also exceed this
    direction: str = "both"      # "both" | "lower_better" | "higher_better"
    gate: bool = True            # False: breaches are "info", never "fail"
    note: str = ""


# defaults, first match wins. Raw timings are informational: shared CI
# runners are too noisy to gate wall-clock, but large moves (past the
# non-gating band below) still land in the verdict as "info" for humans.
# Deterministic cells (counts, ratios, booleans, config shapes) gate —
# those only move when code or seeds change.
DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule("*.config.*", max_rel_delta=0.0, note=(
        "bench shape contract: changing workload sizes requires "
        "regenerating the committed baselines in the same PR")),
    Rule("*window_s*", max_rel_delta=0.5, max_abs_delta=2.0, gate=False,
         note="wall-clock"),
    Rule("*_us", max_rel_delta=0.5, max_abs_delta=20.0, gate=False,
         note="wall-clock"),
    Rule("*_us_*", max_rel_delta=0.5, max_abs_delta=20.0, gate=False,
         note="wall-clock"),
    Rule("*_ms", max_rel_delta=0.5, max_abs_delta=20.0, gate=False,
         note="wall-clock"),
    Rule("*_s", max_rel_delta=0.5, max_abs_delta=2.0, gate=False,
         note="wall-clock"),
    Rule("*per_s*", max_rel_delta=0.5, max_abs_delta=0.5, gate=False,
         note="wall-clock-derived"),
    Rule("*per_query*", max_rel_delta=0.5, max_abs_delta=20.0, gate=False,
         note="wall-clock-derived"),
    Rule("*per_call*", max_rel_delta=0.5, max_abs_delta=20.0, gate=False,
         note="wall-clock-derived"),
    Rule("*speedup*", max_rel_delta=0.5, max_abs_delta=0.5, gate=False,
         note="wall-clock-derived"),
    Rule("*qps*", max_rel_delta=0.5, max_abs_delta=0.5, gate=False,
         note="wall-clock-derived"),
    Rule("*.count", max_rel_delta=0.25, max_abs_delta=2.0, gate=False,
         note="SLO observation counts include per-run warmup variation"),
    # max_rel_delta=0.0 + an absolute band: ANY move in the worse direction
    # breaches once it exceeds the abs floor (a pure-absolute threshold)
    Rule("*acc*", max_rel_delta=0.0, max_abs_delta=0.15,
         direction="higher_better", note="accuracy within noise band"),
    Rule("*quality_gap*", max_rel_delta=0.0, max_abs_delta=0.10,
         direction="lower_better", note="accuracy-gap noise band"),
    Rule("*counters*", max_rel_delta=0.05, max_abs_delta=2.0, note=(
        "deterministic stream counters (fixed seeds); small abs floor "
        "covers rounding of derived means")),
    Rule("*", max_rel_delta=0.15, max_abs_delta=0.05,
         note="default band for derived numeric cells"),
)


def flatten(obj, prefix: str = "") -> Dict[str, Cell]:
    """BENCH payload -> {dotted.path: scalar}. Lists index numerically;
    None cells are skipped (absent and null are equivalent here)."""
    out: Dict[str, Cell] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}.{i}" if prefix else str(i)))
    elif obj is not None:
        out[prefix] = obj
    return out


def match_rule(path: str, rules) -> Rule:
    for r in rules:
        if fnmatch.fnmatch(path, r.pattern):
            return r
    return Rule("*")  # unreachable with the catch-all default present


def _numeric(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def compare_cell(path: str, base: Cell, cur: Cell, rule: Rule) -> dict:
    """Verdict for one cell present in both baseline and current."""
    cell = {"path": path, "baseline": base, "current": cur,
            "rule": rule.pattern}
    if _numeric(base) and _numeric(cur):
        delta = cur - base
        rel = delta / max(abs(base), 1e-12)
        cell["delta"] = round(delta, 6)
        cell["rel_delta"] = round(rel, 6)
        if rule.direction == "lower_better":
            worse = max(rel, 0.0)
        elif rule.direction == "higher_better":
            worse = max(-rel, 0.0)
        else:
            worse = abs(rel)
        breach = (rule.max_rel_delta is not None
                  and worse > rule.max_rel_delta
                  and abs(delta) > rule.max_abs_delta)
    else:
        breach = base != cur
        if breach:
            cell["delta"] = "changed"
    cell["status"] = ("pass" if not breach
                      else "fail" if rule.gate else "info")
    if breach and rule.note:
        cell["note"] = rule.note
    return cell


def compare(baseline: dict, current: dict, rules=DEFAULT_RULES) -> dict:
    """Diff two BENCH payloads cell by cell -> one file's verdict dict."""
    b, c = flatten(baseline), flatten(current)
    cells: List[dict] = []
    for path in sorted(set(b) | set(c)):
        if path not in b:
            cells.append({"path": path, "current": c[path],
                          "status": "new"})
        elif path not in c:
            cells.append({"path": path, "baseline": b[path],
                          "status": "missing"})
        else:
            cells.append(compare_cell(path, b[path], c[path],
                                      match_rule(path, rules)))
    counts = {s: sum(1 for x in cells if x["status"] == s)
              for s in ("pass", "fail", "info", "new", "missing")}
    return {
        "verdict": "fail" if counts["fail"] else "pass",
        "counts": counts,
        # passing cells are elided from the report (the counts carry them)
        "cells": [x for x in cells if x["status"] != "pass"],
    }


@dataclass
class Verdict:
    """Top-level multi-file verdict (what check_regression.py writes)."""

    mode: str                      # "smoke" | "full"
    files: Dict[str, dict] = field(default_factory=dict)

    def add(self, name: str, file_verdict: dict) -> None:
        self.files[name] = file_verdict

    @property
    def verdict(self) -> str:
        return ("fail" if any(f.get("verdict") == "fail"
                              for f in self.files.values()) else "pass")

    def to_json(self) -> dict:
        return {"schema": VERDICT_SCHEMA, "mode": self.mode,
                "verdict": self.verdict, "files": self.files}


def load_rules(path: str) -> Tuple[Rule, ...]:
    """Read threshold rules from JSON: {"rules": [{pattern, ...}, ...]}.
    Listed rules take priority over (and are followed by) the defaults, so
    a project override only needs the cells it cares about."""
    with open(path) as f:
        cfg = json.load(f)
    rules = tuple(Rule(**r) for r in cfg.get("rules", []))
    return rules + DEFAULT_RULES


def rules_to_json(rules) -> dict:
    return {"rules": [asdict(r) for r in rules]}
