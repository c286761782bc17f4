"""The plain reference against the program on the CPU at a toy size,
and the faults a run has to catch: a whole run on the CPU (the card
check skipped) with the timed path broken underneath comes out not
correct under the cell's own limits."""

import dataclasses
import time

import numpy as np
import pytest

from flamebench import compare, harness, spec
from flamebench.reference.render import Frames

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _no_tune_record(monkeypatch):
    harness.pin_environment()


def toy(name, backend="pallas_win", quality=20, frames=6, width=64,
        height=36, batch=2048):
    """The cell at a toy size on the CPU (64x36, a 2048-lane batch by
    default): its genome, driver, temporal samples and limits."""
    c = spec.cell(name)
    cfg = dict(c.config, width=width, height=height, batch=batch,
               hist_backend=backend)
    traffic = dict(c.traffic, quality=quality,
                   trace={"skip_frames": 1, "frames": 2})
    if traffic["driver"] == "animation":
        traffic["frames"] = frames
    return dataclasses.replace(c, config=cfg, traffic=traffic,
                               check=dict(c.check, frames=2))


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(name):
    from cuburn_tpu_torch import models
    from cuburn_tpu_torch.render import Renderer
    cell = toy(name)
    r = Renderer(getattr(models, cell.config["genome"])(),
                 harness.profile_for(cell), device="cpu")
    ref = Frames(cell.config["genome"],
                 harness.settings_for(cell, r.profile.iters_per_chunk),
                 "cpu")
    for t, seed in ((0.0, 11), (0.37, 2**40 + 5)):
        img, stats = r.render_frame(t, seed=seed)
        got = ref.render(t, seed)
        assert got.plotted == stats.plotted_samples > 0
        np.testing.assert_array_equal(img[..., :3], got.image)
        assert 0 < got.touched_bins < r.cam.n_bins


def run(cell, seed=5):
    return harness.run_cell(cell, seed, 1.0, False, time.perf_counter(),
                            device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = run(toy(name))
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.cell(name).end_to_end}


def _state_unchanged(monkeypatch):
    from cuburn_tpu_torch.ops import iterate
    real = iterate.iterate_records

    def stuck(plan, state, recs):
        real(plan, state, recs)
        return state
    monkeypatch.setattr(iterate, "iterate_records", stuck)


def _half_batch(monkeypatch):
    from cuburn_tpu_torch.ops import iterate
    real = iterate.PACKED_FLUSHES["pallas_win"]

    def half(hist, recs, palette_hi, n_bins, bits, weight=None):
        recs[:, recs.shape[1] // 2:] = n_bins << bits
        return real(hist, recs, palette_hi, n_bins, bits,
                    2.0 * (1.0 if weight is None else weight))
    monkeypatch.setitem(iterate.PACKED_FLUSHES, "pallas_win", half)


def _answer_altered(monkeypatch):
    from cuburn_tpu_torch import render
    real = render.to_u8

    def altered(img):
        out = real(img).clone()
        out[:16, :16, :3] = 255 - out[:16, :16, :3]
        return out
    monkeypatch.setattr(render, "to_u8", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(toy(name))
    assert res["correct"] is False
    assert res["failed"] >= 1
    over = [k for k in compare.NAMES
            if res["checks"][k]["value"] > res["checks"][k]["limit"]]
    assert over, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The control, the program with its bfloat16-rgb histogram
    (`pallas_rgb16`), fails the cell's limits at 128x72 and quality
    100; on the card it is read at the cell's own size by
    `python -m flamebench.calibrate`."""
    from cuburn_tpu_torch import models
    from cuburn_tpu_torch.render import Renderer
    cell = toy(name, backend="pallas_rgb16", quality=100, width=128,
               height=72, batch=4096)
    r = Renderer(getattr(models, cell.config["genome"])(),
                 harness.profile_for(cell), device="cpu")
    assert r.backend == "pallas_rgb16"
    kept = [(0, 0.4, 91, r.render_frame(0.4, seed=91)[0])]
    readings, failed, _refs = harness.check_frames(
        cell, kept, r.profile.iters_per_chunk, "cpu")
    assert failed == 1
    assert not compare.verdict(readings, cell.check["limits"]), readings
