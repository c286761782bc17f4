"""BENCHMARK.json and the files it names, found by name; the refusal
to run without a card; the check that no run imports JAX or the JAX
package."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from flamebench import compare, harness, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for path in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, path))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_config_file_lies_under_the_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        data = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["ops_per_lane_step"] == sum(
            v for v in data["ops_per_lane_step_counted"].values()
            if isinstance(v, int))


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert cell.traffic["driver"] in harness.DRIVERS
    assert set(cell.check["limits"]) == set(compare.NAMES)
    assert cell.check["frames"] >= 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "flamebench", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = _run(["--workload", CELLS[0], "--seed", "3000000000",
              "--seconds", "1", "--trace", "0"], spec.ROOT)
    assert p.returncode == 2
    assert p.stdout == ""
    assert "no result" in p.stderr


def test_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "flamebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", CELLS[0], "--seed", "7", "--seconds", "1",
              "--trace", "0"], str(tmp_path))
    assert p.returncode != 0
    assert p.stdout == ""


def test_forbidden_names_are_compared_whole():
    names = ["cuburn_tpu_torch", "cuburn_tpu_torch.render", "jaxtyping",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax",
             "cuburn_tpu", "cuburn_tpu.ops.iterate", "numpy"]
    assert harness.forbidden_modules(names) == [
        "cuburn_tpu", "cuburn_tpu.ops.iterate", "flax", "jax", "jax.numpy",
        "jaxlib.xla_client"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    root = os.path.join(spec.HERE, sub)
    for dirpath, _dirs, files in os.walk(root):
        if "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_the_benchmark_imports_no_jax():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in (*harness.FORBIDDEN,
                                             "cuburn_tpu_torch"), (path, mod)


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from flamebench import harness, spec, calibrate, trace, roofline\n"
        "from flamebench.reference import render\n"
        "import cuburn_tpu_torch.render, cuburn_tpu_torch.models\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
