"""The benchmark's arithmetic on the CPU: the roofline bounds, the
window's accounting and seeds, and the reduction of a profiler trace
to spans and device time."""

import json
import math

import numpy as np
import pytest

from flamebench import compare, harness, roofline, spec
from flamebench import trace as trace_mod


# -- roofline ------------------------------------------------------------------

def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12) == (1.0, "bytes")
    assert roofline.bound_s(0, 67e12) == (1.0, "operations")
    s, by = roofline.bound_s(3.35e12, 2 * 67e12)
    assert (s, by) == (2.0, "operations")


def test_chaos_bound_counts_operations_records_and_state():
    lane_steps, lanes, ops = 2_073_600_000, 131072, 166
    s, by = roofline.chaos_bound_s(lane_steps, ops, lanes)
    assert by == "operations"
    assert s == pytest.approx(lane_steps * ops / 67e12)
    # a light key binds on its records and state instead
    s, by = roofline.chaos_bound_s(lane_steps, 10, lanes)
    assert by == "bytes"
    assert s == pytest.approx((lane_steps * 4 + lanes * 72) / 3.35e12)


def test_flush_bound_reads_records_once_and_bins_twice():
    s, by = roofline.flush_bound_s(1e9, 1e6)
    assert by == "bytes"
    assert s == pytest.approx((4e9 + 32e6) / 3.35e12)


def test_lanes_follow_the_programs_batch_rule():
    assert roofline.lanes_for(1 << 17, 32, 2_073_600_000) == 1 << 17
    assert roofline.lanes_for(1 << 17, 32, 1 << 20) == 4096
    assert roofline.lanes_for(1 << 17, 32, 10) == 1024


# -- the window --------------------------------------------------------------

def test_frame_seeds_are_distinct_and_fit_the_program():
    seeds = [0, 1, 2, 2**31 - 1, 2**31, 2**32 + 5, 2**40, 123456789012]
    bases = [harness.base_seed(s) for s in seeds]
    assert len(set(bases)) == len(bases)
    for b in bases:
        # frames base + k of two runs never meet within a run's frames
        assert 0 <= b < 2**40
        assert (b + 10**6) * 7919 < 2**63
    assert harness.base_seed(42) == harness.base_seed(42)


def test_sample_is_drawn_from_the_seed():
    def draw(seed, n):
        s = harness.Sample(3, seed)
        for k in range(n):
            s.offer(k)
        return sorted(s.kept)
    assert draw(1, 2) == [0, 1]
    assert draw(5, 100) == draw(5, 100)
    counts = np.zeros(20)
    for seed in range(3000):
        for k in draw(seed, 20):
            counts[k] += 1
    assert counts.min() > 0.8 * counts.mean()


class _Stats:
    plotted_samples = 7


class FakeStills:
    """A Renderer stand-in whose frames take `dt` seconds each."""

    def __init__(self, dt):
        self.dt = dt
        self.calls = []

    def render_frame(self, t, seed):
        import time
        self.calls.append(seed)
        time.sleep(self.dt)
        return np.zeros((2, 2, 4), np.uint8), _Stats()


class FakeAnimation(FakeStills):
    def frame_times(self):
        return [(i, i / 4) for i in range(4)]

    def frames_overlapped(self, seed):
        import time
        for i in range(4):
            self.calls.append(seed + i)
            time.sleep(self.dt)
            yield np.zeros((2, 2, 4), np.uint8), _Stats()


def _cell(driver):
    return spec.Cell(name="x", chips=1, config={}, traffic={
        "driver": driver, "time": 0.0}, check={}, end_to_end=[],
        per_layer=[])


@pytest.mark.parametrize("driver,fake", [("stills", FakeStills),
                                         ("animation", FakeAnimation)])
def test_window_counts_frames_done_before_the_deadline(driver, fake):
    r = fake(0.02)
    sample = harness.Sample(2, 3)
    w = harness.DRIVERS[driver](r, _cell(driver), 1000, 0.3, sample, None)
    n = len(w.frame_s)
    # one frame past the deadline ran and is not counted
    assert len(r.calls) in (n + 1, n + 2)
    assert 8 <= n <= 15
    assert w.wall_s <= 0.3
    assert w.wall_s == pytest.approx(sum(w.frame_s), rel=0.2)
    assert all(f >= 0.015 for f in w.frame_s)
    # frame k renders with seed base + k, across restarts of a sequence
    assert r.calls[:n] == [1000 + k for k in range(n)]
    assert len(w.kept) == 2 and {k[2] for k in w.kept} <= set(r.calls[:n])


# -- the comparison ------------------------------------------------------------

def test_gaps_of_equal_frames_are_zero_and_a_block_shows():
    a = np.random.default_rng(1).integers(0, 256, (64, 80, 3), np.uint8)
    g = compare.frame_gaps(a, a)
    assert g == {"mean_gap": 0.0, "block_gap": 0.0}
    b = a.astype(np.int64)
    b[16:32, 16:32] = np.clip(b[16:32, 16:32] + 40, 0, 255)
    g = compare.frame_gaps(b.astype(np.uint8), a)
    assert g["block_gap"] > 20 and g["mean_gap"] < 2
    limits = {"mean_gap": 2, "block_gap": 50}
    assert compare.verdict(g, limits)
    assert not compare.verdict(g, dict(limits, block_gap=10))
    g["mean_gap"] = math.nan
    assert not compare.verdict(g, limits)


# -- the trace -----------------------------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """A stretch of 1000 us: one frame whose accumulate launches a chaos
    kernel and a sort, whose filter launches a conv, and a readback
    copy; a kernel launched between frames."""
    return [
        _ev("user_annotation", "flamebench.stretch", 0, 1000),
        _ev("user_annotation", "flamebench.frame", 10, 900),
        _ev("user_annotation", "flamebench.accumulate", 20, 300),
        _ev("user_annotation", "flamebench.readback", 400, 500),
        _ev("user_annotation", "flamebench.filter", 410, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 420, 5, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 700, 5, corr=4),
        _ev("cuda_driver", "cuLaunchKernel", 950, 5, corr=5),
        _ev("kernel", "chaos_iterate_kernel", 50, 100, corr=1),
        _ev("kernel", "later_pass_kernel", 150, 150, corr=2),
        _ev("kernel", "conv_depthwise", 430, 170, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 710, 40, corr=4),
        _ev("kernel", "stray", 960, 80, corr=5),
        _ev("gpu_user_annotation", "flamebench.filter", 430, 170),
    ]


def test_trace_attributes_device_time_to_the_launching_span():
    tr = trace_mod.from_events(synthetic_trace(), "stretch")
    assert tr.window == (0.0, 1e-3)
    assert tr.count("accumulate") == 1 and tr.count("filter") == 1
    assert tr.device_s("accumulate", name_has="chaos") == \
        pytest.approx(100e-6)
    assert tr.device_s("accumulate", name_lacks="chaos") == \
        pytest.approx(150e-6)
    assert tr.device_s("filter") == pytest.approx(170e-6)
    assert tr.device_s("readback") == pytest.approx(40e-6)
    stray = [op for op in tr.ops if op.name == "stray"]
    assert stray[0].span is None
    # busy: 50-300, 430-600, 710-750, 960-1000 (clipped)
    assert tr.busy_s() == pytest.approx(250e-6 + 170e-6 + 40e-6 + 40e-6)
    idle = tr.idle_by_host()
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s())
    assert idle["between frames"] == pytest.approx((10 + 50) * 1e-6)
    assert idle["accumulate"] == pytest.approx(30e-6 + 20e-6)
    assert idle["filter"] == pytest.approx(20e-6 + 10e-6)
    assert idle["readback"] == pytest.approx((10 + 100 + 150) * 1e-6)
    assert idle["frame"] == pytest.approx((10 + 80 + 10) * 1e-6)
    assert tr.top_ops(2)[0] == ("conv_depthwise", pytest.approx(170e-6))


def test_kernel_names_are_shortened():
    assert trace_mod.short_name(
        "void (anonymous namespace)::win_flush_kernel<true>(long long "
        "const*, long long, float4 const*)") == "win_flush_kernel<true>"
    assert trace_mod.short_name(
        "(anonymous namespace)::chaos_iterate_kernel(ChaosArgs)") == \
        "chaos_iterate_kernel"
    assert trace_mod.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH "


def test_trace_loads_from_a_chrome_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic_trace()}))
    assert trace_mod.load(str(path), "stretch").count("accumulate") == 1
    with pytest.raises(ValueError):
        trace_mod.from_events(synthetic_trace()[1:], "stretch")


def _ctx(cell, tr):
    return harness.LayerContext(trace=tr, cell=cell, samples_per_frame=1000,
                                lanes_per_frame=10, ref_plotted=900.0,
                                ref_touched_bins=100.0)


def test_per_layer_readers_on_a_synthetic_trace():
    cell = spec.cell("ff1080-q1000")
    tr = trace_mod.from_events(synthetic_trace(), "stretch")
    got = spec.per_layer(cell.per_layer, _ctx(cell, tr))
    chaos_s = roofline.chaos_bound_s(1000, 166, 10)[0]
    assert got["chaos_roofline"]["value"] == pytest.approx(
        100 * chaos_s / 100e-6)
    flush_s = roofline.flush_bound_s(900, 100)[0]
    assert got["flush_roofline"]["value"] == pytest.approx(
        100 * flush_s / 150e-6)
    assert got["filter.device_ms"]["value"] == pytest.approx(0.17)
    assert got["device.idle_pct"]["value"] == pytest.approx(50.0)
    assert {v["unit"] for v in got.values()} == {"%", "ms"}


def test_readers_find_nothing_in_an_empty_stretch():
    cell = spec.cell("ff1080-q1000")
    tr = trace_mod.from_events(synthetic_trace()[:1], "stretch")
    assert spec.per_layer(cell.per_layer, _ctx(cell, tr)) == {}
