"""Reading a torch.profiler trace from its raw records.

The device's own records give its time: every kernel, copy and set on the
device counts toward busy time, and a layer's device time is that of the
device operations that ran inside the layer's span on the device (the
profiler projects each `record_function` scope onto the device timeline).
The port launches its CUDA kernels through ctypes, inside no PyTorch
operator, so a sum over host operators would leave them out; and
`prof.events()` / `key_averages()` build a Python tree of every host
operator first, which takes minutes for a batch, so the raw records are
read instead.

Device operations inside the harness's own scopes (`perfbench.*`: the work
counts of a roofline) are left out of every number.
"""
from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field

from perfbench.harness.stats import union_seconds

OWN = "perfbench."
SCOPES = ("wharf.", "maintainer.", OWN)
GAP_MIN_US = 5.0          # shorter idle gaps are launch latency


def _kind(e, device_type) -> str:
    """The record's kind: 'span' (one of the port's or the harness's scopes
    on the device), 'op' (any other device record: a kernel, copy or set)
    or 'host'. By name, since the card's torch records carry no activity
    type."""
    if e.device_type() != device_type.CUDA:
        return "host"
    return "span" if e.name().startswith(SCOPES) else "op"


@dataclass
class Trace:
    """The device operations, device-side spans and host events of a traced
    window, in microseconds of one clock."""

    ops: list = field(default_factory=list)        # (start, end, name)
    spans: dict = field(default_factory=dict)      # name -> [(start, end)]
    host: list = field(default_factory=list)       # (start, end, name, thread)
    host_spans: list = field(default_factory=list)  # (start, end, name)
    kinds: dict = field(default_factory=dict)      # activity kind -> records

    @staticmethod
    def from_profiler(prof) -> "Trace":
        from torch.autograd import DeviceType
        t = Trace()
        own = []
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e, DeviceType)
            t.kinds[kind] = t.kinds.get(kind, 0) + 1
            s, end, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
            if kind == "op":
                t.ops.append((s, end, name))
            elif kind == "span":
                if name.startswith(OWN):
                    own.append((s, end))
                else:
                    t.spans.setdefault(name, []).append((s, end))
            elif kind == "host":
                t.host.append((s, end, name, e.start_thread_id()))
                if name.startswith(SCOPES[:2]):
                    t.host_spans.append((s, end, name))
        if own:
            mine = SpanIndex(own)
            t.ops = [op for op in t.ops if not mine.covers(op[0], op[1])]
        return t

    # ----------------------------------------------------------- device time

    def busy_s(self) -> float:
        return union_seconds((s, e) for s, e, _ in self.ops) / 1e6

    def layer_s(self, name: str, op_filter: str = "") -> float:
        """Device seconds of the operations inside the scope `name`."""
        spans = self.spans.get(name)
        if not spans:
            return 0.0
        index = SpanIndex(spans)
        return sum(e - s for s, e, n in self.ops
                   if op_filter in n and index.covers(s, e)) / 1e6

    def has_layer(self, name: str) -> bool:
        return bool(self.spans.get(name))

    def op_s(self, name_part: str) -> float:
        return sum(e - s for s, e, n in self.ops if name_part in n) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for s, e, n in self.ops:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:160], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    # --------------------------------------------------------- idle and host

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle gaps between its first and last operation,
        summed by what the host was doing at each gap's middle: the port's
        innermost layer scope and the innermost host event there."""
        ops = sorted((s, e) for s, e, _ in self.ops)
        gaps, end = [], None
        for s, e in ops:
            if end is not None and s - end >= GAP_MIN_US:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        if not gaps:
            return []
        thread = _main_thread(self.host)
        events = sorted((s, e, n) for s, e, n, th in self.host if th == thread)
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        labels = _innermost(events, [m for m, _ in mids])
        layers = _innermost(sorted(self.host_spans), [m for m, _ in mids])
        by = {}
        for (m, dur), op, layer in zip(mids, labels, layers):
            key = f"{layer or '-'} / {op or '-'}"
            by[key] = by.get(key, 0.0) + dur / 1e6
        return [[n[:160], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class SpanIndex:
    """Spans sorted by start with the running latest end: an operation lies
    inside a span if a span that starts before it ends after it."""

    def __init__(self, spans):
        ordered = sorted(spans)
        self.starts = [a for a, _ in ordered]
        self.ends = list(itertools.accumulate((b for _, b in ordered), max))

    def covers(self, start: float, end: float) -> bool:
        i = bisect.bisect_right(self.starts, start)
        return bool(i) and self.ends[i - 1] >= end


def _main_thread(host) -> int:
    counts = {}
    for _, _, name, th in host:
        if name.startswith("wharf."):
            counts[th] = counts.get(th, 0) + 1
    if not counts:
        for _, _, _, th in host:
            counts[th] = counts.get(th, 0) + 1
    return max(counts, key=counts.get) if counts else -1


def _innermost(events, points) -> list:
    """For sorted points, the name of the latest-starting event of `events`
    (sorted by start, properly nested) that covers each point, or None."""
    out, stack, j = [], [], 0
    for m in points:
        while j < len(events) and events[j][0] <= m:
            while stack and stack[-1][1] < events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out
