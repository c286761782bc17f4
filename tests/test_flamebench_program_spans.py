"""The benchmark's reading of the program's own spans
(`flamebench/program_spans.py`) on a hand-built Chrome trace.

Contracts:
- `cuburn.` spans leave flamebench/trace.py's readings as they are: its
  spans, each operation's span, counts, device time, busy time, host
  labels, idle split, and the four accepted per-layer readers;
- each of the seven readings gives its hand-computed value, and None
  without its span;
- the idle gaps labelled by benchmark layer and program path sum, by
  their first part, to the benchmark's own split.
"""

import pytest

from flamebench import harness, program_spans, spec
from flamebench import trace as trace_mod

US = 1e-6


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, kernel, start, dur, cat="kernel"):
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, corr),
            _ev(cat, kernel, start, dur, corr)]


# program spans of one frame of 100 us: (name, start, duration)
PROGRAM = [
    ("params", 0, 10), ("sync", 2, 2), ("sync", 5, 2),
    # a span and its first child share their start
    ("trajectories", 10, 10), ("sync", 10, 2),
    ("sample", 20, 40),
    ("chunk", 20, 20), ("sort", 22, 8), ("count", 30, 2),
    ("chunk", 40, 20), ("sort", 42, 8), ("count", 50, 2),
    ("filter", 60, 20), ("params", 60, 5),
    ("readback", 80, 20), ("sync", 80, 15),
]


def events(program=PROGRAM):
    """A stretch of 100 us: accumulate, filter and readback spans of the
    benchmark, the program's spans inside them, and seven operations:
    idle 0-21, 24-25, 37-43, 54-66, 75-90 and 92-100 us."""
    ev = [_ev("user_annotation", "flamebench.stretch", 0, 100),
          _ev("user_annotation", "flamebench.accumulate", 0, 60),
          _ev("user_annotation", "flamebench.filter", 60, 20),
          _ev("user_annotation", "flamebench.readback", 80, 20)]
    ev += [_ev("user_annotation", "cuburn." + n, s, d)
           for n, s, d in program]
    ev += _launch(1, 21, "chaos_iterate_kernel", 21, 3)
    ev += _launch(2, 23, "first_pass_kernel", 25, 10)
    ev += _launch(3, 31, "reduce_kernel", 35, 2)
    ev += _launch(4, 43, "later_pass_kernel", 43, 10)
    ev += _launch(5, 51, "reduce_kernel", 53, 1)
    ev += _launch(6, 61, "conv_depthwise", 66, 9)
    ev += _launch(7, 81, "Memcpy DtoH", 90, 2, cat="gpu_memcpy")
    return ev


def _both(program=PROGRAM):
    ev = events(program)
    tr = trace_mod.from_events(ev, "stretch")
    return tr, program_spans.ProgramSpans.from_events(ev, tr)


def _ctx(tr):
    return harness.LayerContext(trace=tr, cell=spec.cell("ff1080-q1000"),
                                samples_per_frame=1000, lanes_per_frame=10,
                                ref_plotted=900.0, ref_touched_bins=100.0)


def test_program_spans_leave_the_benchmarks_readings_alone():
    with_ = trace_mod.from_events(events(), "stretch")
    without = trace_mod.from_events(events([]), "stretch")
    assert with_.spans == without.spans
    assert [(o.name, o.start, o.dur, o.span) for o in with_.ops] == \
        [(o.name, o.start, o.dur, o.span) for o in without.ops]
    for layer in ("accumulate", "filter", "readback"):
        assert with_.count(layer) == without.count(layer) == 1
        assert with_.device_s(layer) == without.device_s(layer)
    assert with_.busy_intervals() == without.busy_intervals()
    assert with_.busy_s() == without.busy_s()
    for t in (0.0, 21e-6, 60e-6, 80e-6, 99e-6):
        assert with_.host_label(t) == without.host_label(t)
    assert with_.idle_by_host() == without.idle_by_host()
    cell = spec.cell("ff1080-q1000")
    got = spec.per_layer(cell.per_layer, _ctx(with_))
    assert got == spec.per_layer(cell.per_layer, _ctx(without))
    assert set(got) == {"chaos_roofline", "flush_roofline",
                        "filter.device_ms", "device.idle_pct"}


def test_operations_carry_the_program_path_of_their_launch():
    _tr, prog = _both()
    paths = {name: path for name, _s, _d, path in prog.ops}
    assert paths["chaos_iterate_kernel"] == ("sample", "chunk")
    assert paths["first_pass_kernel"] == ("sample", "chunk", "sort")
    assert paths["later_pass_kernel"] == ("sample", "chunk", "sort")
    assert paths["conv_depthwise"] == ("filter", "params")
    assert paths["Memcpy DtoH"] == ("readback", "sync")
    # spans that share a start: the longer is the parent
    assert prog.path_at(10.5e-6) == ("trajectories", "sync")
    assert prog.path_at(12.5e-6) == ("trajectories",)
    assert prog.count("sync") == 4 and prog.count("chunk") == 2
    assert prog.durations("chunk") == pytest.approx([20 * US, 20 * US])


def test_the_seven_readings_by_hand():
    _tr, prog = _both()
    got = program_spans.read_all(prog)
    assert got == pytest.approx({
        "sort.device_ms": 20e-3,          # 10 + 10 us
        "count.device_ms": 3e-3,          # 2 + 1 us
        "params.idle_ms": 15e-3,          # 0-10 and 60-65 us
        "trajectories.idle_ms": 10e-3,    # 10-20 us
        "readback.idle_ms": 18e-3,        # 80-90 and 92-100 us
        "chunk.host_us": 20.0,
        "host.syncs_per_frame": 4.0})


@pytest.mark.parametrize("metric,span", [
    ("sort.device_ms", "sort"), ("count.device_ms", "count"),
    ("params.idle_ms", "params"), ("trajectories.idle_ms", "trajectories"),
    ("readback.idle_ms", "readback"), ("chunk.host_us", "chunk"),
    ("host.syncs_per_frame", "sync")])
def test_a_reading_without_its_span_is_none(metric, span):
    _tr, prog = _both([p for p in PROGRAM if p[0] != span])
    assert program_spans.METRICS[metric](prog) is None
    _tr, prog = _both()
    assert program_spans.METRICS[metric](prog) is not None


def test_readings_are_a_frames_worth():
    two = events() + [_ev("user_annotation", "flamebench.accumulate",
                          95, 3)]
    tr = trace_mod.from_events(two, "stretch")
    prog = program_spans.ProgramSpans.from_events(two, tr)
    assert tr.count("accumulate") == 2
    assert program_spans.METRICS["host.syncs_per_frame"](prog) == 2.0
    assert program_spans.METRICS["sort.device_ms"](prog) == \
        pytest.approx(10e-3)


def test_idle_gaps_sum_to_the_benchmarks_split():
    tr, prog = _both()
    gaps = prog.idle_gaps()
    assert gaps == pytest.approx({
        "accumulate/params": 6 * US, "accumulate/params/sync": 4 * US,
        "accumulate/trajectories": 8 * US,
        "accumulate/trajectories/sync": 2 * US,
        "accumulate/sample/chunk": 12 * US,
        "accumulate/sample/chunk/sort": 2 * US,
        "filter/filter/params": 5 * US, "filter/filter": 6 * US,
        "readback/readback/sync": 13 * US, "readback/readback": 5 * US})
    by_layer = {}
    for label, sec in gaps.items():
        first = label.split("/")[0]
        by_layer[first] = by_layer.get(first, 0.0) + sec
    expected = tr.idle_by_host()
    assert set(by_layer) == set(expected)
    for layer, sec in expected.items():
        assert by_layer[layer] == pytest.approx(sec, rel=1e-12, abs=1e-18)
