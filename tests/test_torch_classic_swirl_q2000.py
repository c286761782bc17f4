"""BASELINE config 4 as the benchmark runs it: `classic_swirl` at the
`quality2000` preset (flamebench's `classic_swirl-q2000` configuration,
cell `swirl1080-q2000-de`).

Contracts:
- the configuration file states the preset's geometry, and its
  operation count is the sum of its counted parts;
- the benchmark's reference genome is the port's `classic_swirl`: the
  same structure key and the same parameters at every time;
- at a toy size (64x36, ss 2, DE on, a 2048-lane batch, the cell's
  quality 2000) the port's frame meets the plain reference's within
  the cell's own limits (`mean_gap`, `block_gap`), for `classic_swirl`
  and for three seeded variants of it (affines, variation weights and
  colours jittered, the same variation set), plotting the same points.
  The port flushes through `atomic`, the backend `auto` takes on the
  card; on the CPU `auto` is `scatter`, whose unquantised palette
  coordinate the reference's 8-bit records do not follow.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu_torch.models import gallery as port_gallery  # noqa: E402
from cuburn_tpu_torch.profile import PROFILES  # noqa: E402
from cuburn_tpu_torch.render import Renderer  # noqa: E402
from flamebench import compare, harness, spec  # noqa: E402
from flamebench.reference import gallery as ref_gallery  # noqa: E402
from flamebench.reference import render as ref_render  # noqa: E402

CELL = "swirl1080-q2000-de"
VARIANT_SEEDS = (101, 202, 303)


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record():
    """No tune record reaches these tests (the benchmark's own pin)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in harness.CLEARED_ENV:
            mp.delenv(k, raising=False)
        for k, v in harness.PINNED_ENV.items():
            mp.setenv(k, v)
        yield


def test_configuration_is_the_quality2000_preset():
    cell = spec.cell(CELL)
    c, p = cell.config, PROFILES["quality2000"]
    assert c["genome"] == "classic_swirl"
    assert (c["width"], c["height"], c["ss"], c["batch"], c["fuse"]) == \
        (p.width, p.height, p.ss, p.batch, p.fuse)
    assert c["iters_per_chunk"] == p.iters_per_chunk == 0
    assert c["hist_backend"] == p.hist_backend == "auto"
    assert c["de_enabled"] is p.de_enabled is True
    assert cell.traffic["quality"] == p.quality == 2000
    assert cell.traffic["temporal_samples"] == p.temporal_samples == 1
    assert c["reduced"] == []
    # the harness hands the Renderer the preset itself
    prof = harness.profile_for(cell)
    for f in ("width", "height", "ss", "quality", "fuse", "batch",
              "iters_per_chunk", "hist_backend", "de_enabled",
              "temporal_samples", "transparent"):
        assert getattr(prof, f) == getattr(p, f), f


def test_operation_count_is_the_sum_of_its_parts():
    c = spec.cell(CELL).config
    parts = {k: v for k, v in c["ops_per_lane_step_counted"].items()
             if isinstance(v, int)}
    assert sum(parts.values()) == c["ops_per_lane_step"]
    # a count for each variation of the genome's structure key
    key = port_gallery.classic_swirl().structure_key()
    assert set(key.variations) <= set(parts)
    assert key.n_xforms == parts["select"]


def _params_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name)),
            err_msg=f.name)


def test_reference_genome_is_the_ports():
    port, ref = port_gallery.classic_swirl(), ref_gallery.classic_swirl()
    assert repr(port.structure_key()) == repr(ref.structure_key())
    assert tuple(port.size) == tuple(ref.size)
    assert port.time_range == ref.time_range
    for t in (0.0, 0.5, 1.0):
        _params_equal(port.eval_at(t), ref.eval_at(t))


def _jittered(genome, seed: int):
    """`genome` with each xform's weight, colour, affine and variation
    weights moved by draws from `seed`; the same variation set."""
    rng = np.random.default_rng(seed)
    xforms = []
    for xf in genome.xforms:
        affine = [float(a(0.0)) + rng.uniform(-0.1, 0.1) for a in xf.affine]
        xforms.append(dataclasses.replace(
            xf, weight=float(xf.weight(0.0)) * rng.uniform(0.5, 1.5),
            color=rng.uniform(0.0, 1.0), affine=tuple(affine),
            vars={k: float(v(0.0)) * rng.uniform(0.5, 1.5)
                  for k, v in xf.vars.items()}))
    return dataclasses.replace(genome, xforms=xforms)


def _toy_cell():
    c = spec.cell(CELL)
    return dataclasses.replace(
        c, config=dict(c.config, width=64, height=36, batch=2048,
                       hist_backend="atomic"))


@pytest.mark.parametrize("variant", (None,) + VARIANT_SEEDS)
def test_port_meets_the_reference_within_the_cells_limits(variant,
                                                         monkeypatch):
    cell = _toy_cell()
    port, ref = port_gallery.classic_swirl(), ref_gallery.classic_swirl()
    if variant is not None:
        port, ref = _jittered(port, variant), _jittered(ref, variant)
        _params_equal(port.eval_at(0.0), ref.eval_at(0.0))
        assert repr(port.structure_key()) == repr(ref.structure_key())
    monkeypatch.setattr(ref_render, "get_genome", lambda _name: ref)
    r = Renderer(port, harness.profile_for(cell), device="cpu")
    assert r.backend == "atomic"
    assert r.profile.de_enabled and r.cam.ss == 2
    frames = ref_render.Frames(
        "classic_swirl", harness.settings_for(cell, r.profile.iters_per_chunk),
        "cpu")
    seed = harness.base_seed(7 if variant is None else variant)
    img, stats = r.render_frame(0.0, seed=seed)
    got = frames.render(0.0, seed)
    assert got.plotted == stats.plotted_samples > 0
    gaps = compare.frame_gaps(img, got.image)
    assert compare.verdict(gaps, cell.check["limits"]), gaps
    assert img[..., :3].max() > 0
