"""The render path's spans and counters (`cuburn_tpu_torch/utils/trace.py`).

Contracts:
- with no profiler recording, `span()` is the one shared null context
  and never enters `record_function`; a wait is counted all the same;
- under torch.profiler a still of full_feature and two overlapped
  frames of animated_spark (T = 4) export every span of the render
  path, their counts equal the frames' FrameStats, and no span is open
  across a yield;
- the counters of a frame are the sites of the render path, counted
  the same on the CPU as on the card: its host-to-device copies as
  `uploads`, queued without a wait, and its real waits as `syncs` (a
  still 3: the plotted count, the sync, the readback; an overlapped
  frame 1, its readback's event);
- images are bit-equal with the profiler on and off;
- the filter's stages (`logscale`, `de`, `downsample`, `colorclip`) are
  spans nested in `filter`, once each a frame, in a still and in
  overlapped frames, and the null context without a profiler;
- where the chunk loop runs in C (the card's unsorted packed flush,
  stood in for here), one `loop` span a sample wraps the call in place
  of the `chunk` and `count` spans, and COUNTS["looped_chunks"] counts
  its chunks beside COUNTS["chunks"]; the Python loop counts none.
"""

import collections
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.bench import _card  # noqa: E402
from cuburn_tpu_torch.genome.specs import GenomeParams  # noqa: E402
from cuburn_tpu_torch.models import get_genome  # noqa: E402
from cuburn_tpu_torch.ops import de as de_mod  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops import tiled_sort  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch.utils import timing, trace  # noqa: E402

STAGES = ("logscale", "de", "downsample", "colorclip")
SPANS = ("params", "trajectories", "sample", "chunk", "sort", "count",
         "filter", "readback", "sync") + STAGES
STILL = dict(width=32, height=24, quality=4, batch=1024,
             hist_backend="pallas_win")
ANIM = dict(STILL, temporal_samples=4, duration=2 / 24.0)
LEAVES = len(dataclasses.fields(GenomeParams))


# the interpolator's uploads a blurred frame: the shutter times (its
# scalar slots are host ints, read without a wait)
EVAL_UPLOADS = 1


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans(events, prefix="cuburn."):
    """(name without the prefix, start, end) of every span of `prefix`,
    in microseconds."""
    return [(e["name"][len(prefix):], e["ts"], e["ts"] + e.get("dur", 0))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _still():
    return trender.Renderer(get_genome("full_feature"),
                            RenderProfile(**STILL), device="cpu")


def _anim():
    return trender.Renderer(get_genome("animated_spark"),
                            RenderProfile(**ANIM), device="cpu")


def _overlapped(r, n, mark=None):
    """The first n frames of frames_overlapped (seed 3); `mark` opens a
    span of its own around the consumer's side of each yield."""
    frames = r.frames_overlapped(seed=3)
    out = []
    try:
        for _ in range(n):
            out.append(next(frames))
            if mark is not None:
                with torch.profiler.record_function(mark):
                    pass
    finally:
        frames.close()
    return out


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("chunk") is trace.span("sort") is trace._NULL
    before = trace.counters()
    with trace.wait():
        pass
    assert trace.upload(np.ones(3, np.float32), "cpu").dtype == \
        torch.float32
    timing.sync("cpu")
    assert trace.since(before) == {"chunks": 0, "records": 0, "syncs": 2,
                                   "uploads": 1, "looped_chunks": 0,
                                   "launches": 0}


@pytest.mark.parametrize("a", [np.arange(6, dtype=np.int64).reshape(2, 3),
                               np.float32(0.5), torch.ones(4)])
def test_an_upload_counts_one_upload_and_no_sync(a):
    """On the CPU an upload is `as_tensor` as it was, counted as one
    upload and no wait, with the profiler off and on."""
    for recording in (False, True):
        before = trace.counters()
        if recording:
            with profile(activities=[ProfilerActivity.CPU]):
                got = trace.upload(a, "cpu", torch.float64)
        else:
            got = trace.upload(a, "cpu", torch.float64)
        counted = trace.since(before)
        assert (counted["uploads"], counted["syncs"]) == (1, 0)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert torch.equal(got, torch.as_tensor(a, dtype=torch.float64))


def test_still_spans_equal_its_counters(tmp_path):
    r = _still()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _img, stats = r.render_frame(0.0, seed=3)
    spans = _spans(_events(prof, tmp_path))
    counts = collections.Counter(n for n, _s, _e in spans)
    assert set(counts) == set(SPANS)
    assert counts["chunk"] == stats.chunks == 1
    assert counts["sync"] == stats.syncs
    assert counts["sample"] == 1 and counts["sort"] == counts["chunk"]
    assert counts["count"] == counts["chunk"]
    assert stats.records == 1024 * r.profile.iters_per_chunk
    assert stats.launches == 0            # the CPU launches no kernel
    # every sort and count lies inside a chunk, every chunk in a sample
    for inner, outer in (("sort", "chunk"), ("count", "chunk"),
                         ("chunk", "sample")):
        for _n, s, e in (x for x in spans if x[0] == inner):
            assert any(o[0] == outer and o[1] <= s and e <= o[2]
                       for o in spans)


def _filter_uploads(r):
    """The filter's uploads: the genome's leaves, the quality scalar,
    the DE's taps (one a rung blurred directly, two a pyramid rung) and
    the spatial filter's taps."""
    radii, taps = de_mod.band_ladder(r._static_de_r)
    de = sum(1 if de_mod._pyramid_plan(rad, half, r.cam.acc_width)[0] == 1
             else 2 for rad, half in zip(radii, taps))
    return LEAVES + 1 + de + (1 if r._static_sf > 0 else 0)


def test_still_counts_every_wait_of_its_sites():
    """A still's waits, site by site: the plotted count and the sync,
    and the u8 frame's copy; its uploads: the genome's leaves, the
    trajectories' four draws and the filter's."""
    r = _still()
    _img, stats = r.render_frame(0.0, seed=3)
    assert stats.syncs == 2 + 1
    assert stats.uploads == LEAVES + 4 + _filter_uploads(r)
    # the same frame again counts the same
    again = r.render_frame(0.0, seed=4)[1]
    assert (again.syncs, again.uploads) == (stats.syncs, stats.uploads)


def test_overlapped_spans_equal_counters_and_close_before_yields(tmp_path):
    r = _anim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = _overlapped(r, 2, mark="test.consumer")
    events = _events(prof, tmp_path)
    spans = _spans(events)
    counts = collections.Counter(n for n, _s, _e in spans)
    assert set(counts) == set(SPANS)
    stats = [s for _img, s in frames]
    assert counts["chunk"] == sum(s.chunks for s in stats) > 0
    assert counts["sync"] == sum(s.syncs for s in stats)
    assert counts["sample"] == 2 * r.profile.temporal_samples
    assert all(s.chunks == r.profile.temporal_samples for s in stats)
    # frame 1's one wait is its readback's; its uploads are the
    # interpolator's, the trajectories' and the filter's
    assert stats[1].syncs == 1
    assert stats[1].uploads == EVAL_UPLOADS + 4 + _filter_uploads(r)
    marks = _spans(events, "test.")
    assert len(marks) == 2
    for _m, t, _e in marks:
        assert not [x for x in spans if x[1] < t < x[2]]


def test_overlapped_frames_count_their_own_work():
    """Each overlapped frame's counters hold the work of the serial
    loop's frame at the same time and seed, its readback's wait
    included; the serial frame reads its plotted count, syncs and
    copies its image, where the overlapped one waits for its event."""
    r = _anim()
    over = [s for _img, s in _overlapped(r, 2)]
    serial = [s for _img, s in r.frames(seed=3)][:2]
    for a, b in zip(over, serial):
        assert (a.chunks, a.records, a.launches) == \
            (b.chunks, b.records, b.launches)
    assert serial[1].syncs == 2 + 1
    assert serial[1].uploads == EVAL_UPLOADS + 4 + _filter_uploads(r)
    # the first frame packs the genome's knots; the second does not
    assert over[0].uploads > over[1].uploads == serial[1].uploads
    assert over[0].syncs == over[1].syncs == serial[1].syncs - 2 == 1


def test_images_are_bit_equal_with_the_profiler_on_and_off():
    off = _still().render_frame(0.0, seed=5)[0]
    with profile(activities=[ProfilerActivity.CPU]):
        on = _still().render_frame(0.0, seed=5)[0]
    np.testing.assert_array_equal(on, off)
    r = _anim()
    off = [img for img, _s in _overlapped(r, 2)]
    with profile(activities=[ProfilerActivity.CPU]):
        on = [img for img, _s in _overlapped(r, 2)]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def _stages_nest_in_filters(spans, frames):
    """Each filter stage opens once a frame, inside a `filter` span,
    and each `filter` span holds one of each."""
    filters = [x for x in spans if x[0] == "filter"]
    assert len(filters) == frames
    for name in STAGES:
        inner = [x for x in spans if x[0] == name]
        assert len(inner) == frames, name
        for f in filters:
            assert sum(f[1] <= s and e <= f[2] for _n, s, e in inner) == 1


def test_filter_stages_nest_in_the_filter_of_a_still(tmp_path):
    r = trender.Renderer(get_genome("classic_swirl"),
                         RenderProfile(**STILL), device="cpu")
    assert r._de_on(r.genome.eval_at(0.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame(0.0, seed=3)
        r.render_frame(0.0, seed=4)
    _stages_nest_in_filters(_spans(_events(prof, tmp_path)), 2)


def test_filter_stages_nest_in_the_filter_of_overlapped_frames(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _overlapped(_anim(), 2)
    _stages_nest_in_filters(_spans(_events(prof, tmp_path)), 2)


def test_filter_stages_without_a_profiler_are_the_null_context(
        monkeypatch):
    r = trender.Renderer(get_genome("classic_swirl"),
                         RenderProfile(**STILL), device="cpu")
    hist, _stats = r.accumulate(0.0, seed=3)
    expected = r.finalize_frame(hist, 0.0)

    def refuse(*a, **kw):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert all(trace.span(n) is trace._NULL for n in STAGES)
    np.testing.assert_array_equal(r.finalize_frame(hist, 0.0), expected)


def test_classic_swirl_is_bit_equal_with_the_profiler_on_and_off():
    prof = RenderProfile(**dict(STILL, ss=2, quality=20))

    def still():
        return trender.Renderer(get_genome("classic_swirl"), prof,
                                device="cpu").render_frame(0.0, seed=6)[0]
    off = still()
    with profile(activities=[ProfilerActivity.CPU]):
        on = still()
    np.testing.assert_array_equal(on, off)


def test_launch_counters_have_one_reader():
    assert _card.COUNTERS == trace.launch_counters()
    before = trace.counters()
    tiled_sort.LAUNCHES["bitonic_sort"] += 3
    try:
        assert trace.since(before)["launches"] == 3
        assert _card.launches()["bitonic_sort"] >= 3
    finally:
        tiled_sort.LAUNCHES["bitonic_sort"] -= 3


def test_metrics_line_carries_the_counters():
    stats = trender.FrameStats(plotted_samples=9, total_iters=10,
                               iterate_s=0.5, filter_s=0.25)
    stats.count({"chunks": 2, "records": 64, "launches": 34, "syncs": 3,
                 "uploads": 78})
    rec = tmain._stats_record(0, 0.0, stats)
    assert (rec["chunks"], rec["records"], rec["launches"],
            rec["syncs"], rec["uploads"]) == (2, 64, 34, 3, 78)


def _c_loop_stand_in(monkeypatch):
    """Take the C loop's branch on the CPU, its call replaced by one that
    returns the state and a zero count: the spans and counters around
    it are the iterate_accumulate's own."""
    calls = []

    def looped(plan, state, recs, hist, palette_hi, n_chunks, weight):
        calls.append(n_chunks)
        return state, torch.zeros((), dtype=torch.float32)
    monkeypatch.setattr(tit, "takes_c_loop", lambda backend, device: True)
    monkeypatch.setattr(tit.chaos, "launch_accumulate", looped)
    return calls


@pytest.mark.parametrize("make", ["still", "anim"])
def test_loop_span_and_looped_chunks_where_the_loop_is_in_c(
        make, monkeypatch, tmp_path):
    r = _still() if make == "still" else _anim()
    calls = _c_loop_stand_in(monkeypatch)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _hist, stats = r.accumulate(0.0, seed=3)
    counted = trace.since(before)
    spans = _spans(_events(prof, tmp_path))
    counts = collections.Counter(n for n, _s, _e in spans)
    samples = r.profile.temporal_samples
    assert len(calls) == counts["loop"] == counts["sample"] == samples
    assert counts["chunk"] == counts["count"] == 0
    assert counted["looped_chunks"] == counted["chunks"] == stats.chunks \
        == sum(calls) > 0
    for _n, s, e in (x for x in spans if x[0] == "loop"):
        assert any(o[0] == "sample" and o[1] <= s and e <= o[2]
                   for o in spans)


def test_python_loop_counts_no_looped_chunks(tmp_path):
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _hist, stats = _still().accumulate(0.0, seed=3)
    counts = collections.Counter(
        n for n, _s, _e in _spans(_events(prof, tmp_path)))
    assert trace.since(before)["looped_chunks"] == counts["loop"] == 0
    assert counts["chunk"] == counts["count"] == stats.chunks > 0
