"""The reduction of a profiler trace to what the per-layer metrics
read.

A traced run profiles a stretch of its window with torch.profiler and
exports the trace in Chrome's JSON format.  The benchmark's own spans
(`torch.profiler.record_function` ranges named `flamebench.<layer>`)
are in it beside the device's operations (kernels, copies, fills) and
the host calls that launched them, joined by a correlation id.  Each
device operation belongs to the innermost benchmark span whose host
interval holds its launch.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "flamebench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the label of host time inside no benchmark span but the stretch
BETWEEN = "between frames"


@dataclass
class DeviceOp:
    name: str
    start: float          # seconds, the trace's clock
    dur: float
    span: Optional[str]   # the innermost span that launched it


@dataclass
class Trace:
    """A profiled stretch: its spans (layer, start, end), its device
    operations, and the stretch's own interval."""
    spans: List[Tuple[str, float, float]]
    ops: List[DeviceOp]
    window: Tuple[float, float]
    _seg_starts: List[float] = field(default_factory=list, repr=False)
    _seg_labels: List[Optional[str]] = field(default_factory=list,
                                             repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def count(self, layer: str) -> int:
        """How many spans of `layer` the stretch holds."""
        return sum(1 for name, _s, _e in self.spans if name == layer)

    def device_s(self, layer: Optional[str] = None,
                 name_has: Optional[str] = None,
                 name_lacks: Optional[str] = None) -> float:
        """Device seconds of the operations launched in `layer` (any
        layer when None), whose name holds `name_has` and does not
        hold `name_lacks`."""
        return sum(op.dur for op in self.ops
                   if (layer is None or op.span == layer)
                   and (name_has is None or name_has in op.name)
                   and (name_lacks is None or name_lacks not in op.name))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to
        the stretch."""
        lo, hi = self.window
        merged: List[Tuple[float, float]] = []
        for s, e in sorted((op.start, op.start + op.dur) for op in self.ops):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def host_label(self, t: float) -> str:
        """The innermost benchmark span the host was in at `t`."""
        k = bisect.bisect_right(self._seg_starts, t) - 1
        label = self._seg_labels[k] if k >= 0 else None
        return label or BETWEEN

    def idle_by_host(self) -> Dict[str, float]:
        """The stretch's idle device seconds, split by the span the host
        was in meanwhile."""
        out: Dict[str, float] = defaultdict(float)
        cursor = self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1],) * 2]:
            for label, sec in self._host_pieces(cursor, s):
                out[label] += sec
            cursor = max(cursor, e)
        return dict(out)

    def _host_pieces(self, a: float, b: float):
        """(label, seconds) of each piece of host time [a, b) by the
        innermost benchmark span."""
        starts, labels = self._seg_starts, self._seg_labels
        k = bisect.bisect_right(starts, a) - 1
        t = a
        while t < b:
            end = min(starts[k + 1] if k + 1 < len(starts) else b, b)
            if end > t:
                yield (labels[k] if k >= 0 else None) or BETWEEN, end - t
                t = end
            k += 1

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The `n` device operations that took most time, by
        `short_name`."""
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[short_name(op.name)] += op.dur
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list: `void (anonymous namespace)::win_flush_kernel<true>(
    long long const*, ...)` is `win_flush_kernel<true>`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:limit]


def _segments(spans):
    """(starts, labels): the host timeline cut where a span opens or
    closes, each piece labelled by the innermost open span."""
    bounds = []
    for i, (_name, s, e) in enumerate(spans):
        bounds.append((s, 1, i))
        bounds.append((e, 0, i))
    bounds.sort(key=lambda b: (b[0], b[1]))
    stack: List[int] = []
    starts, labels = [], []
    for t, opening, i in bounds:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        labels.append(spans[stack[-1]][0] if stack else None)
    return starts, labels


def from_events(events, window_span: str) -> Trace:
    """A Trace from a Chrome trace's event list; `window_span` names the
    span (without the prefix) that marks the profiled stretch."""
    spans, launches, device = [], {}, []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            layer = name[len(SPAN_PREFIX):]
            if layer == window_span:
                window = (ts, ts + dur)
            else:
                spans.append((layer, ts, ts + dur))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((name, ts, dur, corr))
    if window is None:
        raise ValueError(f"the trace holds no {SPAN_PREFIX}{window_span} "
                         "span")
    spans.sort(key=lambda s: s[1])
    starts, labels = _segments(spans)
    trace = Trace(spans=spans, ops=[], window=window, _seg_starts=starts,
                  _seg_labels=labels)
    for name, ts, dur, corr in device:
        launched = launches.get(corr)
        span = None
        if launched is not None:
            label = trace.host_label(launched)
            span = None if label == BETWEEN else label
        trace.ops.append(DeviceOp(name=name, start=ts, dur=dur, span=span))
    return trace


def load(path: str, window_span: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_events(events, window_span)
