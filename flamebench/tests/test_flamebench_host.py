"""The run's process on the host: one intra-op thread for a run on the
card, set before the Renderer is built; the environment the harness
pins; the host's CPU seconds it logs; and the result line's keys,
unchanged by any of it."""

import os
import time

import pytest
import torch

from flamebench import harness


class Built(Exception):
    """Raised by the fake Renderer once it has read the process's
    state, to end the run there."""


@pytest.mark.parametrize("device,threads", [
    ("cuda", harness.HOST_THREADS), ("cpu", None)])
def test_the_renderer_is_built_under_the_host_rule(device, threads,
                                                   monkeypatch):
    from cuburn_tpu_torch import render
    from test_flamebench_reference import toy
    seen = {}

    def fake(*_a, **_kw):
        seen["threads"] = torch.get_num_threads()
        seen["tune"] = os.environ.get("CUBURN_TUNE_FILE")
        raise Built
    monkeypatch.setattr(render, "Renderer", fake)
    for k in harness.CLEARED_ENV:
        monkeypatch.setenv(k, "1")
    before = torch.get_num_threads()
    try:
        with pytest.raises(Built):
            harness.run_cell(toy("spark720-anim-t4"), 3, 1.0, False,
                             time.perf_counter(), device=device)
    finally:
        torch.set_num_threads(before)
    assert seen["threads"] == (before if threads is None else threads)
    assert seen["tune"] == harness.PINNED_ENV["CUBURN_TUNE_FILE"]
    assert not set(harness.CLEARED_ENV) & set(os.environ)


def test_pin_environment_clears_and_pins(monkeypatch):
    for k in harness.CLEARED_ENV:
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("CUBURN_TUNE_FILE", "elsewhere.json")
    harness.pin_environment()
    assert not set(harness.CLEARED_ENV) & set(os.environ)
    for k, v in harness.PINNED_ENV.items():
        assert os.environ[k] == v


def test_host_cpu_seconds_move_forward():
    user0, sys0 = harness.host_cpu_s()
    sum(i * i for i in range(300000))
    user1, sys1 = harness.host_cpu_s()
    assert user1 + sys1 > user0 + sys0


@pytest.mark.parametrize("traced", [False, True])
def test_a_cpu_run_keeps_the_result_line_keys(traced):
    from test_flamebench_reference import toy
    cell = toy("spark720-anim-t4")
    logged = []
    res = harness.run_cell(cell, 2**33 + 7, 1.0, traced, time.perf_counter(),
                           device="cpu", log=logged.append)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[:5] == keys and list(res)[-1] == "checks"
    assert set(res) == set(keys) | {"checks"} | (
        {"breakdown"} if traced else set())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    reported = {m["name"] for m in
                (cell.per_layer if traced else cell.end_to_end)}
    assert set(res["metrics"]) <= reported
    if not traced:
        assert set(res["metrics"]) == reported
    host = [line for line in logged if line.startswith("host: ")]
    assert len(host) == 1 and "s user and" in host[0]
