"""The program's own spans in a profiled stretch, and the seven
per-layer readings taken from them.

The program marks its render path with `torch.profiler.record_function`
ranges named `cuburn.<name>` (cuburn_tpu_torch/utils/trace.py): the
genome's upload (`params`), the trajectories' draws (`trajectories`),
a temporal sample (`sample`), a chunk (`chunk`), the sort (`sort`), the
plotted count (`count`), the filter (`filter`), the readback
(`readback`) and every host wait for the stream (`sync`).  They nest,
and they lie in the same Chrome trace as the benchmark's own
`flamebench.<layer>` spans (flamebench/trace.py) on the same clock.

`ProgramSpans.from_events` reads them beside a `trace.Trace` of the same
events: each device operation gets the path of program spans open at its
launch, and each idle stretch of the device the benchmark layer and the
program path the host was in meanwhile.  `METRICS` holds the readings,
each a frame's worth (per `flamebench.accumulate` span), each None
where its program span is absent.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from flamebench import trace as trace_mod

PREFIX = "cuburn."
Path = Tuple[str, ...]


@dataclass
class ProgramSpans:
    """The program spans (name, start, end) of the stretch that `trace`
    reduces, and each device operation's (name, start, dur, path of
    program spans at its launch) in the order of `Trace.ops`."""
    trace: trace_mod.Trace
    spans: List[Tuple[str, float, float]]
    ops: List[Tuple[str, float, float, Path]]
    _seg_starts: List[float] = field(default_factory=list, repr=False)
    _seg_paths: List[Path] = field(default_factory=list, repr=False)

    @classmethod
    def from_events(cls, events, trace: trace_mod.Trace) -> "ProgramSpans":
        spans, launches, device = [], {}, []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
            corr = (ev.get("args") or {}).get("correlation")
            if cat == "user_annotation" and name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], ts, ts + dur))
            elif cat in trace_mod.LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            elif cat in trace_mod.DEVICE_CATS:
                device.append((name, ts, dur, corr))
        spans.sort(key=lambda s: (s[1], -s[2]))
        starts, paths = _segments(spans)
        out = cls(trace=trace, spans=spans, ops=[], _seg_starts=starts,
                  _seg_paths=paths)
        for name, ts, dur, corr in device:
            launched = launches.get(corr)
            path = () if launched is None else out.path_at(launched)
            out.ops.append((name, ts, dur, path))
        return out

    def path_at(self, t: float) -> Path:
        """The program spans open at `t`, outermost first."""
        k = bisect.bisect_right(self._seg_starts, t) - 1
        return self._seg_paths[k] if k >= 0 else ()

    def count(self, name: str) -> int:
        return sum(1 for n, _s, _e in self.spans if n == name)

    def durations(self, name: str) -> List[float]:
        """Host seconds of each span of `name`."""
        return [e - s for n, s, e in self.spans if n == name]

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside a span of
        `name`, at any depth."""
        return sum(dur for _n, _s, dur, path in self.ops if name in path)

    def idle_s(self, name: str) -> float:
        """Idle device seconds of the stretch while the host is inside a
        span of `name`, at any depth."""
        inside = _union([(s, e) for n, s, e in self.spans if n == name])
        total, j = 0.0, 0
        for a, b in _idle(self.trace):
            while j < len(inside) and inside[j][1] <= a:
                j += 1
            k = j
            while k < len(inside) and inside[k][0] < b:
                total += min(b, inside[k][1]) - max(a, inside[k][0])
                k += 1
        return total

    def idle_gaps(self) -> Dict[str, float]:
        """The stretch's idle device seconds by what the host was in:
        the benchmark layer (`Trace.host_label`), then the program path,
        joined by "/" (`accumulate/params/sync`).  Summed by their first
        part they are `Trace.idle_by_host()`."""
        bounds = sorted(set(self.trace._seg_starts) | set(self._seg_starts))
        out: Dict[str, float] = {}
        for a, b in _idle(self.trace):
            t = a
            k = bisect.bisect_right(bounds, t)
            while t < b:
                end = min(bounds[k], b) if k < len(bounds) else b
                label = "/".join((self.trace.host_label(t),
                                  *self.path_at(t)))
                out[label] = out.get(label, 0.0) + (end - t)
                t, k = end, k + 1
        return out


def _segments(spans) -> Tuple[List[float], List[Path]]:
    """(starts, paths): the host timeline cut where a program span
    opens or closes, each piece with the path of spans open in it.  At
    equal times spans close before others open, and of spans opening
    together the longer is the parent; a span of no length holds no
    piece."""
    bounds = []
    for i, (_n, s, e) in enumerate(spans):
        if e <= s:
            continue
        bounds.append((s, 1, -e, i))
        bounds.append((e, 0, -s, i))
    bounds.sort()
    stack: List[int] = []
    starts, paths = [], []
    for t, opening, _key, i in bounds:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        paths.append(tuple(spans[j][0] for j in stack))
    return starts, paths


def _union(intervals):
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _idle(trace: trace_mod.Trace) -> List[Tuple[float, float]]:
    """The stretch's intervals with no device operation running, as
    `Trace.idle_by_host` walks them."""
    out, cursor = [], trace.window[0]
    for s, e in trace.busy_intervals() + [(trace.window[1],) * 2]:
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    return out


# -- the readings --------------------------------------------------------

def _per_frame(span: str, value: Callable[[ProgramSpans], float]):
    def read(prog: ProgramSpans) -> Optional[float]:
        frames = prog.trace.count("accumulate")
        if frames == 0 or prog.count(span) == 0:
            return None
        return value(prog) / frames
    return read


def _chunk_host_us(prog: ProgramSpans) -> Optional[float]:
    durations = prog.durations("chunk")
    if not durations or prog.trace.count("accumulate") == 0:
        return None
    return 1e6 * statistics.median(durations)


# name -> reading of a ProgramSpans; units as BENCHMARK.json would give
# them: ms, ms, ms, ms, ms, us, syncs
METRICS: Dict[str, Callable[[ProgramSpans], Optional[float]]] = {
    "sort.device_ms": _per_frame("sort", lambda p: 1e3 * p.device_s("sort")),
    "count.device_ms": _per_frame("count",
                                  lambda p: 1e3 * p.device_s("count")),
    "params.idle_ms": _per_frame("params", lambda p: 1e3 * p.idle_s("params")),
    "trajectories.idle_ms": _per_frame(
        "trajectories", lambda p: 1e3 * p.idle_s("trajectories")),
    "readback.idle_ms": _per_frame("readback",
                                   lambda p: 1e3 * p.idle_s("readback")),
    "chunk.host_us": _chunk_host_us,
    "host.syncs_per_frame": _per_frame("sync", lambda p: p.count("sync")),
}


def read_all(prog: ProgramSpans) -> Dict[str, Optional[float]]:
    return {name: read(prog) for name, read in METRICS.items()}
