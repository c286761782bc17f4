"""The bench tools' port (cuburn_tpu_torch/bench/) against the JAX
package's bench.py and bench/ tools, on the CPU.

Contracts:
- `_card.density` and `tv` equal bench/tpuparity.py's, and
  `bin_differential` equals bench.py:177-203's formulas, exactly, on
  seeded histograms with integer densities (as the renders give);
- the headline with `--cpu` prints one JSON line with bench.py's
  schema, whose `extra` holds every key bench.py assigns into `extra`
  but `jax_backend` and the `*_error` keys, with both backends' density
  equal in every bin;
- the five profiles equal bench/configs.py's, the binding sizes on its
  accelerator branch and the 0.1 scale on its CPU branch, with
  `dim_cap` and `dispatch_iter_cap` left out;
- sortcum's float64 prefix sums round each bin to float32 once;
- tileddiff (with the histogram taken as tiled), sortbench, breakdown
  and parity run at toy sizes and hold their checks, and exit non-zero
  when a check fails; tileddiff refuses a geometry that is not tiled;
- no fallback: without `--cpu` on a machine without a GPU every entry
  point raises RuntimeError;
- no module of the subpackage imports jax or cuburn_tpu.
The configs suite through both packages is in test_torch_bench_configs.py.
On the card the tools run in chip_smoke.py phase 15.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu_torch.bench import _card  # noqa: E402
from cuburn_tpu_torch.bench import (breakdown, configs, headline,  # noqa: E402
                                    parity, sortbench, tileddiff)
from cuburn_tpu_torch.ops import flush as tflush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "cuburn_tpu_torch" / "bench"
MODULES = ("_card", "headline", "configs", "parity", "tileddiff",
           "sortbench", "breakdown")
FORBIDDEN = {"cuburn_tpu", "jax", "jaxlib"}
# the config bench/ tools set when they are imported, restored after
JAX_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                     "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _load_jax_tool(name):
    """bench/<name>.py as a module, its compilation-cache settings
    undone at once."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_OPTIONS}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        mp.delenv("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES",
                  raising=False)
        spec = importlib.util.spec_from_file_location(
            f"bench_{name}", REPO / "bench" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jparity():
    return _load_jax_tool("tpuparity")


@pytest.fixture(scope="module")
def jconfigs():
    return _load_jax_tool("configs")


def _jax_differential(s, w):
    """bench.py:177-203 on two logical histograms without their junk
    bin (transcribed: importing bench.py starts its device watchdog)."""
    ms = float(jnp.sum(s[:, 3]))
    mw = float(jnp.sum(w[:, 3]))
    dens_err = float(jnp.max(jnp.abs(s[:, 3] - w[:, 3])))
    rgb_rel = float(jnp.max(jnp.abs(s[:, :3] - w[:, :3])
                            / jnp.maximum(s[:, 3:4], 1.0)))
    return {"mass_parity": round(mw / max(ms, 1e-9), 6),
            "max_bin_err_density": dens_err,
            "max_bin_err_rgb_rel": round(rgb_rel, 6)}


def _histograms(seed, n_bins=4096):
    """Two logical histograms with their junk bin: integer densities
    (a quarter of the bins empty), rgb a palette colour times the
    density; the second with a few bins moved."""
    rng = np.random.RandomState(seed)
    dens = rng.randint(0, 200, n_bins + 1).astype(np.float32)
    dens[rng.rand(n_bins + 1) < 0.25] = 0.0
    a = np.concatenate([rng.rand(n_bins + 1, 3).astype(np.float32)
                        * dens[:, None], dens[:, None]], axis=1)
    b = a.copy()
    idx = rng.randint(0, n_bins, 8)
    b[idx, 3] += rng.randint(-3, 4, 8).astype(np.float32)
    b[idx, :3] *= np.float32(1.0) + rng.rand(8, 3).astype(np.float32) * 0.01
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_density_and_tv_equal_tpuparity(jparity, seed):
    a, b = _histograms(seed)
    np.testing.assert_array_equal(_card.density(a), jparity.density(a))
    assert _card.tv(a, b) == jparity.tv(a, b)
    assert _card.tv(a, a) == jparity.tv(a, a) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("same", [True, False])
def test_bin_differential_equals_bench_py(seed, same):
    a, b = _histograms(seed)
    if same:
        b = a.copy()
    got = _card.bin_differential(torch.from_numpy(a[:-1]),
                                 torch.from_numpy(b[:-1]))
    assert got == _jax_differential(jnp.asarray(a[:-1]), jnp.asarray(b[:-1]))
    if same:
        assert got == {"mass_parity": 1.0, "max_bin_err_density": 0.0,
                       "max_bin_err_rgb_rel": 0.0}
    else:
        assert got["max_bin_err_density"] > 0.0


def _run(main, argv):
    """(exit code, JSON lines of stdout) of an entry point."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, [json.loads(ln) for ln in lines]


def _bench_py_extra_keys():
    """The keys bench.py assigns into `extra` by name."""
    src = (REPO / "bench.py").read_text()
    return set(re.findall(r'extra\["([^"]+)"\]\s*=', src))


def test_headline_cpu_json_contract():
    rc, lines = _run(headline.main, ["--cpu"])
    assert rc == 0 and len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "ifs_samples_per_sec_per_chip"
    assert rec["unit"] == "samples/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 400e6, 4)
    extra = rec["extra"]
    want = {k for k in _bench_py_extra_keys()
            if k != "jax_backend" and not k.endswith("_error")}
    assert len(want) >= 18
    assert want | {"device", "samples_per_sec_scatter",
                   "samples_per_sec_pallas_win"} <= set(extra)
    assert "jax_backend" not in extra
    assert not [k for k in extra if k.endswith("_error")]
    assert extra["device"] == "cpu" and extra["tuned"] is None
    assert extra["max_bin_err_density"] == 0.0
    assert extra["mass_parity"] == 1.0
    assert extra["max_bin_err_rgb_rel"] < 0.02
    assert extra["total_iters"] == extra["chunks"] * (1 << 12) * 16
    assert extra["chunks"] == (1 << 19) // ((1 << 12) * 16)
    assert 0 < extra["plotted"] <= extra["total_iters"]
    # the CPU skips the 1080p run; its keys stay, null
    assert all(extra[k] is None for k in headline.KEYS_1080P)
    # the CPU launches no kernel
    assert extra["launches"] == {"scatter": {}, "pallas_win": {}}


def test_headline_flush_size_from_tune_record(tmp_path, monkeypatch):
    rec = tmp_path / "tune.json"
    rec.write_text(json.dumps({"device": "cpu",
                               "flush_records": 32 << 12}))
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(rec))
    monkeypatch.setattr(headline, "sizes",
                        lambda cpu: (32, 1 << 12, 16, 1 << 17))
    rc, [line] = _run(headline.main, ["--cpu"])
    extra = line["extra"]
    assert rc == 0 and extra["tuned"] == {"K": 32}
    assert extra["iters_per_chunk"] == 32 and extra["chunks"] == 1


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5])
def test_profiles_equal_bench_configs(jconfigs, monkeypatch, idx, backend):
    """The profile bench/configs.py hands its Renderer, captured there,
    on its accelerator branch at full scale (1920x1080 for 3 and 4) and
    on its CPU branch, with no dim_cap binding."""
    import cuburn_tpu.render as jrender

    class Captured(Exception):
        pass

    def capture(genome, prof):
        raise Captured(genome, prof)

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jrender, "Renderer", capture)
    monkeypatch.setenv("CUBURN_BENCH_DIM_CAP", "100000")
    with pytest.raises(Captured) as got:
        jconfigs.run_config(idx, quick=False)
    jg, jprof = got.value.args
    on_tpu = backend == "tpu"
    g, prof = configs.profile(idx, 1.0 if on_tpu else 0.1,
                              1 << 15 if on_tpu else 1 << 12)
    assert g.name == jg.name
    want = {k: v for k, v in dataclasses.asdict(jprof).items()
            if k != "dispatch_iter_cap"}
    assert dataclasses.asdict(prof) == {**want, "dispatch_iter_cap": None}
    if on_tpu:
        assert (prof.width, prof.height) == {
            1: (512, 512), 2: (1280, 720), 3: (1920, 1080),
            4: (1920, 1080), 5: (1280, 720)}[idx]


def test_profile_refuses_unknown_config():
    with pytest.raises(ValueError, match="no configuration 6"):
        configs.profile(6, 1.0, 1 << 15)


TILED_ARGV = ["--cpu", "--width", "64", "--height", "48", "--ipc", "24",
              "--chunks", "2"]


def test_tileddiff_density_exact(monkeypatch):
    monkeypatch.setattr(tileddiff.render, "histogram_tiled",
                        lambda n_bins, device: True)
    rc, lines = _run(tileddiff.main, TILED_ARGV)
    assert rc == 0
    head, *backends, out = lines
    assert head["tiled"] and head["n_bins"] == 64 * 48 and head["B"] == 2048
    assert [b["backend"] for b in backends] == ["scatter", "pallas_win"]
    assert backends[0]["plotted"] == backends[1]["plotted"] > 0
    assert out["ok"] and out["max_bin_err_density"] == 0.0
    assert out["mass_parity"] == 1.0 and out["mass"] > 0
    assert out["max_bin_err_rgb_rel"] < 0.02


def test_tileddiff_refuses_untiled_geometry():
    with pytest.raises(ValueError, match="not tiled"):
        _run(tileddiff.main, TILED_ARGV)


SORT_ROWS = ["scatter", "scatter_sorted", "sortcum", "pallas",
             "pallas_merged", "pallas_win", "scatter (dense)",
             "scatter_sorted (dense)", "pallas_win (dense)",
             "torch.sort keys (library)", "bitonic (tiled kernel)"]


def test_sortbench_every_backend_within_bound():
    rc, lines = _run(sortbench.main, ["12", "10", "--cpu"])
    assert rc == 0 and lines[-1] == {"sortbench_ok": True}
    rows = {ln["row"]: ln for ln in lines if "row" in ln}
    assert [r for r in rows if "left_out" not in rows[r]] == SORT_ROWS
    for name in SORT_ROWS:
        assert rows[name]["ok"] and rows[name]["max_err"] <= \
            rows[name]["bound"], name
    assert rows["bitonic (tiled kernel)"]["max_err"] == 0.0
    assert {"pallas_win_merge", "pallas_win_m (dense)"} <= {
        r for r in rows if "left_out" in rows[r]}


def test_sortbench_fails_on_a_wrong_flush(monkeypatch):
    def off_by_one(hist, *args, **kw):
        out = tflush.accumulate_windowed_reference(hist, *args, **kw)
        out[0, 3] += 1.0
        return out

    monkeypatch.setattr(sortbench.fl, "accumulate_windowed", off_by_one)
    rc, lines = _run(sortbench.main, ["12", "10", "--cpu"])
    rows = {ln["row"]: ln for ln in lines if "ok" in ln and "row" in ln}
    assert rc == 1 and lines[-1] == {"sortbench_ok": False}
    assert not rows["pallas_win"]["ok"] and rows["pallas"]["ok"]


def test_sortcum_rounds_each_bin_once():
    """sortcum's float64 prefix sums: each bin is its float64 sum
    rounded to float32 once (float32 prefix sums drift with the records
    of the scan; on an H100 sortbench's defaults read 4.70 where the
    bound is 0.5)."""
    rng = np.random.RandomState(1)
    n, n_bins = 1 << 16, 1 << 10
    addr = np.where(rng.rand(n) < 0.3, 7, rng.randint(0, n_bins, n))
    rgba = rng.rand(n, 4).astype(np.float32)
    want = np.zeros((n_bins + 1, 4))
    for c in range(4):
        want[:, c] = np.bincount(addr, rgba[:, c].astype(np.float64),
                                 minlength=n_bins + 1)
    got = thist.accumulate_sortcum(
        thist.alloc(n_bins, "cpu"), torch.from_numpy(addr.astype(np.int64)),
        torch.from_numpy(rgba)).numpy().astype(np.float64)
    assert (np.abs(got - want) <= np.spacing(want.astype(np.float32))).all()


def test_breakdown_rows(monkeypatch):
    monkeypatch.setattr(breakdown, "sizes", lambda cpu: (0, 0, 0, 1 << 13))
    rc, lines = _run(breakdown.main, ["10", "4", "--cpu"])
    assert rc == 0
    assert lines[0]["breakdown"] == {"device": "cpu", "B": 1024, "K": 4,
                                     "chunks": 2, "total_iters": 8192}
    rows = [ln["row"] for ln in lines[1:]]
    assert rows == ["iterate (discard)", "iterate + pack", "full (scatter)",
                    "full (pallas_win)"]
    assert "left_out" in lines[1]
    assert all(ln["ms"] > 0 for ln in lines[2:])


def test_parity_ok():
    rc, lines = _run(parity.main, ["65536", "--cpu"])
    verdict = lines[-1]["card_cpu_parity"]
    assert rc == 0 and verdict["ok"]
    # the "card" is the CPU here: the same seed gives the same histogram
    assert verdict["tv_scatter_vs_cpu"] == verdict["tv_pallas_win_vs_cpu"] \
        == 0.0
    assert 0.0 < verdict["noise_floor"] < 0.05


def test_parity_fails_past_the_floor(monkeypatch):
    real = parity.accumulate

    def shifted(backend, seed, quality, device):
        hist = real(backend, seed, quality, device)
        if backend == "pallas_win":
            hist[:-1] = np.roll(hist[:-1], 64, axis=0)
        return hist

    monkeypatch.setattr(parity, "accumulate", shifted)
    rc, lines = _run(parity.main, ["65536", "--cpu"])
    verdict = lines[-1]["card_cpu_parity"]
    assert rc == 1 and not verdict["ok"]
    assert verdict["tv_scatter_vs_cpu"] == 0.0
    assert verdict["tv_pallas_win_vs_cpu"] > 0.05


ENTRY_POINTS = {
    "headline": (headline.main, []),
    "configs suite": (configs.main, ["--quick"]),
    "configs one": (configs.main, ["--config", "1", "--quick"]),
    "parity": (parity.main, ["4096"]),
    "tileddiff": (tileddiff.main, []),
    "sortbench": (sortbench.main, ["12", "10"]),
    "breakdown": (breakdown.main, ["10", "4"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_cpu_fallback(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = ENTRY_POINTS[name]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert buf.getvalue() == ""


def test_module_entry_point_fails_without_gpu():
    """`python -m cuburn_tpu_torch.bench` on a machine without a GPU:
    non-zero, no JSON line."""
    out = subprocess.run(
        [sys.executable, "-m", "cuburn_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_bench_modules_import_no_jax():
    files = sorted(p.stem for p in BENCH.glob("*.py"))
    assert files == sorted(MODULES + ("__init__", "__main__"))
    bad = {p.name: sorted(_imported_roots(p) & FORBIDDEN)
           for p in BENCH.glob("*.py") if _imported_roots(p) & FORBIDDEN}
    assert bad == {}
    mods = [f"cuburn_tpu_torch.bench.{m}" for m in MODULES + ("__main__",)]
    script = (
        "import importlib, sys\n"
        "sys.modules['cuburn_tpu'] = sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "imported\n"
