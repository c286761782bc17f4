"""The port's tuner (`retune.py`), the Renderer's consumption of its
record, and `utils.timing.time_fn`, against the JAX package's.

Contracts:
- `pick_tiled_backend` picks as `cuburn_tpu.retune.pick_tiled_backend`
  on the JAX tests' synthetic race records;
- `retune._load_tune` gives {} for a missing or malformed file, skips a record
  for another device (the repo's TPU record on the CPU) with one stderr
  line, applies a "cpu" record on the CPU, and warns once a path about
  a dated record or one of another code rev;
- `retune.backend_and_flush`'s flush size equals the JAX package's
  `_resolve_iters_per_chunk` on the same records and profiles where
  the histogram is not tiled; a tiled
  histogram (past the card's L2, monkeypatched here) takes the record's
  `tiled_flush_records` under pallas_win/pallas_rgb16, and without a
  record nothing changes (32);
- on the CPU, `auto` is scatter under any record;
- the tuner runs end to end on the CPU at toy sizes and writes a record
  a CPU Renderer applies; it races every row twice and keeps a pick
  only where its lead is larger than the largest move of a row between
  the passes (a fake race);
- `time_fn` chains every call from the previous output and returns
  (seconds a call, last output).
"""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu import retune as jretune  # noqa: E402
from cuburn_tpu.models import sierpinski as jsierpinski  # noqa: E402
from cuburn_tpu.profile import RenderProfile as JProfile  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch import retune as tretune  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.models import sierpinski  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch.utils.timing import time_fn  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(width=32, height=32, quality=5, batch=1024)

# the JAX package's synthetic race records (tests/test_render.py
# test_rgb16_promotion_threshold): a clear rgb16 win, one inside the
# margin, rgb16 slower, rgb16 missing, rgb16 failed
_BASE = {"scatter@720p": 10.0, "scatter_sorted@720p": 20.0,
         "pallas_win@720p": 100.0}
RACE_RECORDS = [
    dict(_BASE, **{"pallas_rgb16@720p": 106.0}),
    dict(_BASE, **{"pallas_rgb16@720p": 104.9}),
    dict(_BASE, **{"pallas_rgb16@720p": 80.0}),
    dict(_BASE),
    dict(_BASE, **{"pallas_rgb16@720p": "compile failed: x"}),
]


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


@pytest.fixture
def fresh_tune(monkeypatch):
    """No announcement made yet in this process, and a fixed code rev."""
    monkeypatch.setattr(tretune, "_TUNE_ANNOUNCED", set())
    monkeypatch.setattr(tretune, "_current_git_rev", lambda: "abc1234")
    monkeypatch.delenv("CUBURN_ITERS_PER_CHUNK", raising=False)


def _write(tmp_path, monkeypatch, rec, name="tune.json"):
    path = tmp_path / name
    path.write_text(rec if isinstance(rec, str) else json.dumps(rec))
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(path))
    return path


@pytest.mark.parametrize("case", range(len(RACE_RECORDS)))
def test_pick_tiled_backend_matches_jax(case):
    m = RACE_RECORDS[case]
    cands = ("scatter", "scatter_sorted", "pallas_win")
    want = jretune.pick_tiled_backend(m, cands)
    assert tretune.pick_tiled_backend(m, cands, label="720p") == want
    relabelled = {k.replace("@720p", "@tiled"): v for k, v in m.items()}
    assert tretune.pick_tiled_backend(relabelled, cands) == want
    assert tretune.RGB16_PROMOTE_MARGIN == jretune.RGB16_PROMOTE_MARGIN


@pytest.mark.parametrize("text", ["not json {", "[1, 2]", "{}"])
def test_load_tune_malformed_gives_nothing(text, tmp_path, monkeypatch,
                                           fresh_tune, capsys):
    _write(tmp_path, monkeypatch, text)
    assert tretune._load_tune("cpu") == {}
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(tmp_path / "missing.json"))
    assert tretune._load_tune("cpu") == {}
    assert capsys.readouterr().err == ""


def test_load_tune_skips_the_repos_tpu_record(monkeypatch, fresh_tune,
                                              capsys):
    rec = json.loads((REPO / "cuburn_tune.json").read_text())
    assert rec["device"] != "cpu"
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(REPO / "cuburn_tune.json"))
    assert tretune._load_tune("cpu") == {}
    err = capsys.readouterr().err
    assert "skipped" in err and rec["device"] in err
    # said once a path
    assert tretune._load_tune("cpu") == {}
    assert capsys.readouterr().err == ""
    r = trender.Renderer(sierpinski(), RenderProfile(**SMALL,
                                                     iters_per_chunk=0),
                         device="cpu")
    assert r.backend == "scatter"
    assert r.profile.iters_per_chunk == tretune.DEFAULT_ITERS_PER_CHUNK


def test_default_tune_file_is_the_ports_own(tmp_path, monkeypatch,
                                            fresh_tune):
    """Without CUBURN_TUNE_FILE the port reads ./cuburn_tune_cuda.json,
    never the JAX tuner's ./cuburn_tune.json."""
    monkeypatch.delenv("CUBURN_TUNE_FILE", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "cuburn_tune.json").write_text(json.dumps(
        {"device": "cpu", "flush_records": 1 << 20}))
    assert tretune._load_tune("cpu") == {}
    rec = {"device": "cpu", "flush_records": 1024 * 48}
    (tmp_path / tretune.TUNE_FILE).write_text(json.dumps(rec))
    assert tretune._load_tune("cpu") == rec


def test_cpu_record_applies_and_auto_stays_scatter(tmp_path, monkeypatch,
                                                   fresh_tune, capsys):
    rec = {"device": "cpu", "hist_backend": "pallas_win",
           "hist_backend_tiled": "pallas_rgb16", "flush_records": 1024 * 48}
    path = _write(tmp_path, monkeypatch, rec)
    r = trender.Renderer(sierpinski(), RenderProfile(**SMALL,
                                                     iters_per_chunk=0),
                         device="cpu")
    assert "applying tune record" in capsys.readouterr().err
    assert r.profile.iters_per_chunk == 48
    assert r.backend == "scatter"           # a record steers auto on a GPU
    # the tiled key does not reach the CPU either
    monkeypatch.setattr(thist, "histogram_tiled", lambda n, d: True)
    assert trender.Renderer(sierpinski(), RenderProfile(**SMALL),
                            device="cpu").backend == "scatter"
    # a record for another device is not applied
    path.write_text(json.dumps(dict(rec, device="NVIDIA H100 80GB HBM3")))
    monkeypatch.setattr(tretune, "_TUNE_ANNOUNCED", set())
    r = trender.Renderer(sierpinski(), RenderProfile(**SMALL,
                                                     iters_per_chunk=0),
                         device="cpu")
    assert r.profile.iters_per_chunk == tretune.DEFAULT_ITERS_PER_CHUNK
    assert "skipped" in capsys.readouterr().err


@pytest.mark.parametrize("key", ["hist_backend", "hist_backend_tiled"])
def test_cpu_record_naming_atomic_leaves_auto_scatter(key, tmp_path,
                                                      monkeypatch,
                                                      fresh_tune, capsys):
    """`atomic`, the card's default, is a backend a record may name; on
    the CPU `auto` stays `scatter` under it, as under any record."""
    assert thist.BACKENDS["atomic"].tunable
    _write(tmp_path, monkeypatch, {"device": "cpu", key: "atomic"})
    monkeypatch.setattr(thist, "histogram_tiled", lambda n, d: True)
    r = trender.Renderer(sierpinski(), RenderProfile(**SMALL),
                         device="cpu")
    assert "applying tune record" in capsys.readouterr().err
    assert r.backend == "scatter"
    # named by the profile, it runs on the CPU as its plain version
    r = trender.Renderer(sierpinski(), RenderProfile(**SMALL,
                                                     hist_backend="atomic"),
                         device="cpu")
    assert r.backend == "atomic"


def test_stale_record_warns_once_a_path(tmp_path, monkeypatch, fresh_tune,
                                        capsys):
    _write(tmp_path, monkeypatch, {
        "device": "cpu", "flush_records": 4096,
        "timestamp": "2020-01-01T00:00:00+00:00", "git_rev": "0000000"})
    assert tretune._load_tune("cpu")["flush_records"] == 4096
    err = capsys.readouterr().err
    assert "days old" in err and "code rev" in err
    tretune._load_tune("cpu")
    err = capsys.readouterr().err
    assert "days old" not in err and "code rev" not in err
    # a fresh record of this rev: applied without warnings
    _write(tmp_path, monkeypatch,
           tretune.stamp({"device": "cpu", "flush_records": 4096}),
           name="fresh.json")
    tretune._load_tune("cpu")
    err = capsys.readouterr().err
    assert "applying" in err
    assert "days old" not in err and "code rev" not in err


@pytest.mark.parametrize("tune,fields,env", [
    ({"flush_records": 4096 * 96}, {"batch": 4096}, None),
    ({"flush_records": 8192 * 96}, {"batch": 4096}, None),
    ({"flush_records": 4096 * 96}, {"batch": 8192}, None),
    ({"flush_records": 100}, {"batch": 4096}, None),
    ({"iters_per_chunk": 48}, {"batch": 4096}, None),
    ({}, {"batch": 4096}, None),
    ({"flush_records": 4096 * 96}, {"batch": 4096, "iters_per_chunk": 20},
     None),
    ({"flush_records": 4096 * 96}, {"batch": 4096}, "40"),
    ({"flush_records": 4096 * 96}, {"batch": 4096}, "0"),
])
def test_resolve_iters_per_chunk_matches_jax(tune, fields, env, monkeypatch,
                                             fresh_tune):
    if env is not None:
        monkeypatch.setenv("CUBURN_ITERS_PER_CHUNK", env)
    base = dict(SMALL, iters_per_chunk=0, hist_backend="scatter")
    jprof = JProfile(**{**base, **fields})
    tprof = RenderProfile(**{**base, **fields})
    jr = jrender.Renderer(jsierpinski(), jprof)
    tr = trender.Renderer(sierpinski(), tprof, device="cpu")
    assert tretune.backend_and_flush(tprof, "cpu", tr.packed, tr.cam.n_bins,
                                     tune)[1] == \
        jr._resolve_iters_per_chunk(jprof, tune)


@pytest.mark.parametrize("backend,tune,want", [
    ("pallas_win", {}, 32),
    ("pallas_rgb16", {}, 32),
    ("pallas_win", {"tiled_flush_records": 1 << 21}, 64),
    ("pallas_rgb16", {"tiled_flush_records": 1 << 23}, 256),
    ("pallas_win", {"tiled_flush_records": 1 << 18}, 32),
    ("pallas_win", {"flush_records": 1 << 22,
                    "tiled_flush_records": 1 << 21}, 128),
    ("scatter", {"tiled_flush_records": 1 << 21}, 32),
    ("pallas", {"tiled_flush_records": 1 << 21}, 32),
])
def test_resolve_iters_per_chunk_tiled(backend, tune, want, monkeypatch,
                                       fresh_tune):
    prof = RenderProfile(**dict(SMALL, batch=1 << 15, iters_per_chunk=0,
                                hist_backend=backend))
    r = trender.Renderer(sierpinski(), prof, device="cpu")

    def flush_iters():
        return tretune.backend_and_flush(prof, "cpu", r.packed,
                                         r.cam.n_bins, tune)[1]
    assert flush_iters() == (
        max(1, tune["flush_records"] // prof.batch)
        if "flush_records" in tune else 32)     # never tiled on the CPU
    monkeypatch.setattr(thist, "histogram_tiled", lambda n, d: True)
    assert flush_iters() == want


def test_tuner_races_the_tables_tunable_backends():
    """The candidate filters over the table give the tuples they
    replaced, in their order, and a record may pick any of them."""
    assert tretune.CANDIDATES == ("scatter", "scatter_sorted", "pallas_win",
                                  "atomic")
    assert tretune.TILED_CANDIDATES == tretune.CANDIDATES + ("pallas_rgb16",)
    assert set(tretune.TILED_CANDIDATES) == {
        n for n, b in thist.BACKENDS.items() if b.tunable}


def test_histogram_tiled_never_on_the_cpu():
    assert not thist.histogram_tiled(1 << 30, "cpu")
    assert tretune.device_name("cpu") == "cpu"


def test_retune_end_to_end_on_the_cpu(tmp_path, monkeypatch, fresh_tune,
                                      capsys):
    """The tuner at toy sizes (the JAX package's
    test_retune_tool_end_to_end): both races, both K sweeps, a record
    gated to "cpu" that a CPU Renderer applies."""
    out = tmp_path / "tune.json"
    monkeypatch.setenv("CUBURN_RETUNE_BATCH", "512")
    monkeypatch.setenv("CUBURN_RETUNE_CHUNKS", "1")
    monkeypatch.setattr(tretune, "TILED_DIMS", (96, 64))
    assert tretune.main(["--cpu", "--quick", "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = json.loads(out.read_text())
    assert last["tune_written"] == str(out)
    assert rec["device"] == "cpu" and rec["l2_bytes"] is None
    assert rec["torch"] == torch.__version__
    assert rec["hist_backend"] in tretune.CANDIDATES
    assert rec["hist_backend_tiled"] in tretune.TILED_CANDIDATES
    # a flush size only where it stood out of the passes' spread
    assert rec.get("flush_records", 0) % 512 == 0
    assert rec.get("tiled_flush_records", 0) % 512 == 0
    assert not any(k.startswith("sort_") for k in rec)
    assert "dim_cap" not in rec
    # quick: 4 + 5 backend races, 2 K values, 2 tiled K values, each
    # the mean of its two passes
    m = rec["measurements"]
    assert len(m) == 13
    assert all(isinstance(v, float) and v > 0 for v in m.values())
    assert set(rec["passes"]) == set(m)
    assert all(len(rs) == 2 and min(rs) <= m[row] <= max(rs)
               for row, rs in rec["passes"].items())
    assert rec["spread"] == pytest.approx(
        tretune.race_spread(rec["passes"]), abs=1e-4)
    assert rec["timestamp"]
    for k in ("hist_backend", "hist_backend_tiled", "flush_records",
              "tiled_flush_records"):
        assert last[k] == rec.get(k)
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(out))
    prof = RenderProfile(**dict(SMALL, batch=512, iters_per_chunk=0))
    r = trender.Renderer(sierpinski(), prof, device="cpu")
    assert r.profile.iters_per_chunk == \
        rec.get("flush_records", 32 * 512) // 512
    assert r.backend == "scatter"


# the tuner's races, M iters/s by (backend, tiled size, K): at 512x512
# scatter_sorted leads atomic, the default, and K=64 leads K=32; at the
# tiled size pallas_rgb16 leads past RGB16_PROMOTE_MARGIN and K=256
# leads K=32
_RATES = {("scatter", False, 64): 10.0, ("scatter_sorted", False, 64): 20.0,
          ("pallas_win", False, 64): 12.0, ("atomic", False, 64): 15.0,
          ("atomic", False, 32): 10.0,
          ("scatter", True, 64): 5.0, ("scatter_sorted", True, 64): 6.0,
          ("pallas_win", True, 64): 6.5, ("atomic", True, 64): 7.0,
          ("pallas_rgb16", True, 64): 9.0,
          ("pallas_win", True, 32): 4.0, ("pallas_win", True, 256): 5.5}


@pytest.mark.parametrize("spread,picks", [
    (0.1, {"hist_backend": "scatter_sorted",
           "hist_backend_tiled": "pallas_rgb16",
           "flush_records": 512 * 64, "tiled_flush_records": 512 * 256}),
    (0.3, {"hist_backend": "atomic", "hist_backend_tiled": "atomic",
           "flush_records": None, "tiled_flush_records": None}),
])
def test_retune_picks_only_outside_the_spread(spread, picks, tmp_path,
                                               monkeypatch, fresh_tune,
                                               capsys):
    """Every row raced twice, the whole list then again (each rate x
    (1 - spread) in the first pass, x (1 + spread) in the second); a
    lead stands only where it is larger than the largest move of a row
    between passes (here (1 + spread) / (1 - spread) - 1: 22% and 86%),
    else the default backend and no flush-size key.  A CPU Renderer
    applies what stands."""
    calls = []

    def fake_race(key, cam, params, cdf, ppu, backend, B, K, n_chunks,
                  iters=1):
        calls.append(backend)
        rate = _RATES[backend, cam.width == tretune.TILED_DIMS[0], K]
        return rate * (1 - spread if len(calls) <= 13 else 1 + spread)

    monkeypatch.setenv("CUBURN_RETUNE_BATCH", "512")
    monkeypatch.setattr(tretune, "race", fake_race)
    out = tmp_path / "tune.json"
    assert tretune.main(["--cpu", "--quick", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert len(calls) == 26
    assert rec["passes"]["scatter_sorted@512"] == [
        round(20.0 * (1 - spread), 3), round(20.0 * (1 + spread), 3)]
    assert rec["spread"] == pytest.approx((1 + spread) / (1 - spread) - 1,
                                          abs=1e-3)
    assert {k: rec.get(k) for k in picks} == picks
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(out))
    prof = RenderProfile(**dict(SMALL, batch=512, iters_per_chunk=0))
    r = trender.Renderer(sierpinski(), prof, device="cpu")
    assert r.profile.iters_per_chunk == (
        (picks["flush_records"] or 32 * 512) // 512)


def test_retune_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tretune.main(["--quick", "--out", "unused.json"])


@dataclasses.dataclass
class _State:
    x: torch.Tensor
    n: int


@pytest.mark.parametrize("warmup,iters", [(1, 3), (0, 2), (2, 1)])
def test_time_fn_chains_calls(warmup, iters):
    calls = []

    def fn(st):
        calls.append(float(st.x))
        return _State(st.x + 1, st.n + 1), "aux"

    dt, out = time_fn(fn, _State(torch.zeros(()), 0), warmup=warmup,
                      iters=iters, chain=lambda out, _args: (out[0],))
    assert isinstance(dt, float) and dt >= 0
    assert calls == [float(i) for i in range(warmup + iters)]
    assert out[0].n == warmup + iters and float(out[0].x) == warmup + iters
    # without chain every call gets the first arguments
    calls.clear()
    _dt, out = time_fn(fn, _State(torch.zeros(()), 0), warmup=warmup,
                       iters=iters)
    assert calls == [0.0] * (warmup + iters) and out[0].n == 1
