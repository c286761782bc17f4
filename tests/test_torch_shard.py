"""The port's sharded renderer (`cuburn_tpu_torch/parallel/`) on gloo
ranks on the CPU, against the port's one-device Renderer and against
the JAX package's ShardedRenderer.

Each world (2 and 4 ranks) is spawned once for the module and runs
every scenario (`_world`); the tests read its results.  The ranks
import this module, so JAX is imported only inside the tests, and the
ranks check that they never import it.

Contracts:
- *exact:* the port's band windows and blocks equal the JAX package's
  `_band_geometry` rows below `PYRAMID_MIN_WIDTH`, and above it contain
  them plus `de.band_context`'s; the port's blocks of a JAX histogram
  equal the density of JAX's own scattered blocks;
- *exact:* from one seed, with a batch that both halve alike, the
  density of the replicated, scattered (block by block) and
  stripe-parallel histograms equals `Renderer.accumulate`'s in every
  bin, for all seven backends, with equal plotted counts; a resumed
  histogram's mass is carried once, not world times;
- *bounded:* rgb, from the formula of each sum: a float32 sum of a
  bin's d records rounds once an add in each path and once a rank in
  the reduction, within (2d + n) 2^-24 of the larger value; `sortcum`
  takes a bin as the difference of two float32 prefix sums of a flush's
  m sorted rows, within (2m + n) 2^-24 of the channel's total;
  `pallas_rgb16` rounds rgb to bf16 once a flush in each of F flushes
  and once a reduction, within (2F + n - 1) 2^-8 of the larger value;
  a motion-blurred frame (box filter: counts) the same way;
- *bounded:* replicated and scattered frames within one u8 step, every
  rank the same frame; the sharded and scattered band filters within
  one u8 step of `finalize_frame` where the DE takes its pyramid path
  (`PYRAMID_MIN_WIDTH` lowered to 32), where the JAX package's
  margin-only rows miss;
- *distributional:* from JAX-made trajectories, the sharded sierpinski
  histogram within 2x JAX's two-seed floor of JAX's sharded one by TV
  distance, frames within one u8 step.
"""

import dataclasses
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.genome.spline import Spline  # noqa: E402
from cuburn_tpu_torch.models import get_genome  # noqa: E402
from cuburn_tpu_torch.ops import de as tde  # noqa: E402
from cuburn_tpu_torch.parallel import launch  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402

BACKENDS = ("scatter", "scatter_sorted", "sortcum", "pallas",
            "pallas_merged", "pallas_win", "pallas_rgb16")
WORLDS = (2, 4)
# batch 1024: neither the one-device rule (floor 1024) nor the sharded
# one (floor 1024 x world) halves it, so both run the same trajectories
FAST = RenderProfile(width=48, height=40, quality=20, batch=1024,
                     iters_per_chunk=16, fuse=16, de_enabled=True)
# the pyramid case: 60 x 70 at ss 2 with PYRAMID_MIN_WIDTH lowered to 32
PYRAMID = RenderProfile(width=60, height=70, ss=2, quality=20, batch=1024,
                        iters_per_chunk=16, fuse=16, de_enabled=True,
                        hist_backend="scatter")
JAX_SEED = 11
SIERPINSKI = RenderProfile(width=64, height=64, quality=40, batch=2048,
                           iters_per_chunk=8, fuse=8, de_enabled=True,
                           hist_backend="scatter")


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _profile(backend):
    return dataclasses.replace(FAST, hist_backend=backend)


def _pyramid_genome():
    g = get_genome("full_feature")
    g.estimator_radius = Spline(9.0)
    return g


def _world(rank, device, jax_states):
    """Every scenario of one world, run in every rank."""
    from cuburn_tpu_torch.parallel.shard import ShardedRenderer
    torch.set_num_threads(1)
    out = {"foreign": sorted(m for m in ("jax", "cuburn_tpu")
                             if m in sys.modules)}
    g = get_genome("full_feature")
    for b in BACKENDS:
        r = ShardedRenderer(g, _profile(b), device)
        hist, st = r.accumulate(0.0, seed=3)
        block, sb = r.accumulate_scattered(0.0, seed=3)
        striped, ss = r.accumulate_striped(0.0, seed=3)
        out[b] = {
            "hist": hist, "plotted": st.plotted_samples,
            "total_iters": st.total_iters, "block": block,
            "block_plotted": sb.plotted_samples, "striped": striped,
            "striped_plotted": ss.plotted_samples,
            "frame": r.finalize_frame(hist, 0.0),
            "frame_scattered": r.finalize_frame_scattered(block, 0.0)}

    # a resumed histogram, and a motion-blurred frame
    r = ShardedRenderer(get_genome("sierpinski"), _profile("scatter"), device)
    h1, _ = r.accumulate(0.0, seed=3)
    h2, _ = r.accumulate(0.0, seed=3, hist0=h1.numpy())
    out["resume"] = (float(h1[:, 3].sum()), float(h2[:, 3].sum()))
    blur = dataclasses.replace(_profile("pallas_win"), temporal_samples=3)
    out["temporal"] = ShardedRenderer(
        get_genome("animated_spark"), blur, device).accumulate(0.5, seed=6)

    # the DE's pyramid path: both sharded filters against the whole one
    saved = tde.PYRAMID_MIN_WIDTH
    tde.PYRAMID_MIN_WIDTH = 32
    try:
        r = ShardedRenderer(_pyramid_genome(), PYRAMID, device)
        hist, _ = r.accumulate(0.0, seed=3)
        block, _ = r.accumulate_scattered(0.0, seed=3)
        out["pyramid"] = {
            "whole": trender.Renderer(_pyramid_genome(), PYRAMID,
                                      device).finalize_frame(hist, 0.0),
            "sharded": r.finalize_frame(hist, 0.0),
            "scattered": r.finalize_frame_scattered(block, 0.0),
            "band_context": tde.band_context(r._static_de_r,
                                             r.cam.acc_width)}
    finally:
        tde.PYRAMID_MIN_WIDTH = saved

    if jax_states is not None:
        # sierpinski from the JAX package's trajectories for the seed
        from cuburn_tpu_torch import params as tparams

        def init_state(generator, batch, device):
            leaves = jax_states[generator.initial_seed()]
            assert leaves[0].shape == (batch,)
            return tparams.state_from_numpy(*leaves, device=device)
        trender.init_state = init_state
        r = ShardedRenderer(get_genome("sierpinski"), SIERPINSKI, device)
        hist, _ = r.accumulate(0.0, seed=JAX_SEED)
        out["jax_injected"] = {
            "hist": hist, "frame": r.render_frame(0.0, seed=JAX_SEED)[0],
            "frame_scattered": r.render_frame_scattered(
                0.0, seed=JAX_SEED)[0]}
    return out


def _jax_states():
    """The JAX package's starting trajectories for SIERPINSKI at
    JAX_SEED on a 2-device mesh: {seed: numpy leaves}."""
    import jax

    from cuburn_tpu.models import sierpinski
    from cuburn_tpu.ops import iterate as jit_
    from cuburn_tpu.parallel import ShardedRenderer, make_mesh
    from cuburn_tpu.profile import RenderProfile as JProfile
    jr = ShardedRenderer(sierpinski(), JProfile(**SIERPINSKI.__dict__),
                         mesh=make_mesh(2))
    seed = JAX_SEED * 7919
    js = jit_.init_state(jax.random.PRNGKey(seed),
                         jr._halved_batch(SIERPINSKI.total_iters))
    return {seed: tuple(np.asarray(v) for v in (
        js.x, js.y, js.color, js.last_xf, js.age, js.rng))}


@pytest.fixture(scope="module")
def worlds():
    return {n: launch.spawn(_world, ["cpu"] * n, "gloo",
                            _jax_states() if n == 2 else None)
            for n in WORLDS}


@pytest.fixture(scope="module")
def one_device():
    """Renderer.accumulate of every backend, from the same seed."""
    out = {}
    for b in BACKENDS:
        r = trender.Renderer(get_genome("full_feature"), _profile(b),
                             device="cpu")
        hist, st = r.accumulate(0.0, seed=3)
        out[b] = (r, hist, st)
    return out


def _bands_of(r, n):
    """(h_band, layout) of one band a rank of an n-rank world."""
    return r._band_layout(n, r._de_on(r.genome.eval_at(0.0)))


# -- band geometry and blocks against the JAX package ----------------------

def _jax_sharded(genome_name, prof, n, **edits):
    from cuburn_tpu.genome.spline import Spline as JSpline
    from cuburn_tpu.models import get_genome as jget_genome
    from cuburn_tpu.parallel import ShardedRenderer, make_mesh
    from cuburn_tpu.profile import RenderProfile as JProfile
    g = jget_genome(genome_name)
    for k, v in edits.items():
        setattr(g, k, JSpline(v))
    return ShardedRenderer(g, JProfile(**prof.__dict__), mesh=make_mesh(n))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("width,height,ss,de_r", [
    (48, 40, 1, 9.0), (60, 70, 2, 9.0), (72, 50, 1, 4.0), (64, 64, 2, 20.0)])
def test_band_layout_matches_jax_geometry(n, width, height, ss, de_r,
                                          monkeypatch):
    """Below PYRAMID_MIN_WIDTH the port's windows are JAX's block rows;
    above it (the width lowered to 32) they hold JAX's rows and
    band_context's rows on either side, their first row on the grid."""
    prof = dataclasses.replace(FAST, width=width, height=height, ss=ss,
                               hist_backend="scatter")
    g = get_genome("full_feature")
    g.estimator_radius = Spline(de_r)
    r = trender.Renderer(g, prof, device="cpu")
    jr = _jax_sharded("full_feature", prof, n, estimator_radius=de_r)
    h_band, band_rows, margin, block_rows, pad_bot = jr._band_geometry(True)
    got_h, layout = _bands_of(r, n)
    assert (got_h, layout.margin) == (h_band, margin)
    jax_rows = [(r.cam.gutter + k * band_rows - margin,
                 r.cam.gutter + k * band_rows - margin + block_rows)
                for k in range(n)]
    assert [(r0, r1) for _d0, r0, r1 in layout.windows] == jax_rows
    assert (layout.ctx, layout.block_rows) == (0, block_rows)
    assert all(d0 == r0 for d0, r0, _r1 in layout.windows)
    assert layout.bottom == pad_bot
    monkeypatch.setattr(tde, "PYRAMID_MIN_WIDTH", 32)
    ctx, align = tde.band_context(r._static_de_r, r.cam.acc_width)
    _h, pyr = _bands_of(r, n)
    assert pyr.ctx == ctx
    assert (ctx > 0) == (de_r * ss >= 9)     # rungs wide enough to coarsen
    for (d0, r0, r1), (j0, j1) in zip(pyr.windows, jax_rows):
        assert (r0, r1) == (j0, j1)
        assert d0 % align == 0 and r0 - align < d0 + ctx <= r0


@pytest.mark.parametrize("n", [2, 4])
def test_blocks_of_a_jax_histogram_match_jax_scattered_blocks(n):
    """The port's block stacking applied to JAX's replicated histogram
    gives the density of JAX's own accumulate_scattered blocks
    (JAX's test_scattered_blocks_density_exact, on the port's side)."""
    prof = dataclasses.replace(FAST, width=64, height=64, quality=25,
                               batch=2048, iters_per_chunk=8, fuse=8,
                               hist_backend="scatter")
    jr = _jax_sharded("sierpinski", prof, n)
    hist, _ = jr.accumulate(0.0, seed=7)
    jblocks, _ = jr.accumulate_scattered(0.0, seed=7)
    r = trender.Renderer(get_genome("sierpinski"), prof, device="cpu")
    _h, layout = _bands_of(r, n)
    cam = r.cam
    mine = layout.blocks(torch.as_tensor(np.array(hist))[:-1].reshape(
        cam.acc_height, cam.acc_width, 4)).numpy()
    jblocks = np.asarray(jblocks)
    assert mine.shape == jblocks.shape
    np.testing.assert_array_equal(mine[..., 3], jblocks[..., 3])
    assert mine[..., 3].sum() > 0


def _margin_only(layout):
    """The layout with the JAX package's rows: band_margin alone."""
    return dataclasses.replace(
        layout, ctx=0, top=layout.margin, bottom=layout.bottom - layout.ctx,
        windows=tuple((r0, r0, r1) for _d0, r0, r1 in layout.windows))


@pytest.mark.parametrize("n", WORLDS)
def test_margin_only_bands_miss_on_the_pyramid(n, monkeypatch):
    """Where the DE takes its pyramid path, bands with JAX's
    margin-only rows miss the whole-frame filter, and the port's rows
    (with band_context's) do not."""
    monkeypatch.setattr(tde, "PYRAMID_MIN_WIDTH", 32)
    r = trender.Renderer(_pyramid_genome(), PYRAMID, device="cpu")
    hist, _ = r.accumulate(0.0, seed=3)
    whole = r.finalize_frame(hist, 0.0)[..., :3].astype(int)
    params, q_cell, kw = r._filter_inputs(0.0)
    _h, layout = _bands_of(r, n)
    himg = hist[:-1].reshape(r.cam.acc_height, r.cam.acc_width, 4)
    diffs = {}
    for name, lay in (("port", layout), ("jax", _margin_only(layout))):
        bands = trender._filter_banded_device(
            himg, lay, params, q_cell, r.cam.ss, r.cam.gutter, **kw)
        img = bands.reshape(-1, *bands.shape[2:])[:PYRAMID.height].numpy()
        diffs[name] = np.abs(img.astype(int) - whole)
    assert diffs["port"].max() <= 1
    assert (diffs["port"] > 0).any(-1).mean() < 0.005
    assert diffs["jax"].max() > 1 and (diffs["jax"] > 0).any(-1).mean() > 0.05


# -- sharded against one device, in the port -------------------------------

def test_ranks_import_no_jax(worlds):
    for n, ranks in worlds.items():
        assert [o["foreign"] for o in ranks] == [[]] * n


@pytest.mark.parametrize("mode", ["replicated", "scattered", "striped"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_density_equals_one_device(n, backend, mode, worlds,
                                           one_device):
    r, hist, st = one_device[backend]
    ranks = [o[backend] for o in worlds[n]]
    if mode == "scattered":
        _h, layout = _bands_of(r, n)
        want = layout.blocks(hist[:-1].reshape(
            r.cam.acc_height, r.cam.acc_width, 4))
        for k, o in enumerate(ranks):
            assert torch.equal(o["block"][..., 3], want[k][..., 3]), k
            assert o["block_plotted"] == st.plotted_samples
        return
    key = "hist" if mode == "replicated" else "striped"
    for o in ranks:
        assert torch.equal(o[key][:-1, 3], hist[:-1, 3])
        assert o[f"{'plotted' if key == 'hist' else 'striped_plotted'}"] \
            == st.plotted_samples
    assert float(hist[:-1, 3].sum()) == st.plotted_samples > 0
    if mode == "replicated":
        assert ranks[0]["total_iters"] == st.total_iters


def _rgb_bound(r, backend, hist, st, got, n):
    a, b = hist[:-1, :3].double(), got[:-1, :3].double()
    larger = torch.maximum(a.abs(), b.abs())
    per_chunk = r._batch_for(r.profile.total_iters) * r.profile.iters_per_chunk
    if backend == "pallas_rgb16":
        flushes = st.total_iters // per_chunk
        return (2 * flushes + n - 1) * 2.0 ** -8 * larger
    if backend == "sortcum":
        return (2 * per_chunk + n) * 2.0 ** -24 * a.abs().sum(0)
    return (2 * hist[:-1, 3:].double() + n) * 2.0 ** -24 * larger


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_rgb_within_its_bound(n, backend, worlds, one_device):
    r, hist, st = one_device[backend]
    for o in worlds[n]:
        for key in ("hist", "striped"):
            got = o[backend][key]
            err = (hist[:-1, :3].double() - got[:-1, :3].double()).abs()
            tol = _rgb_bound(r, backend, hist, st, got, n)
            assert bool((err <= tol).all()), (key, float(err.max()))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_frames(n, backend, worlds, one_device):
    """Every rank returns the same frame; the scattered frame is within
    one u8 step of the replicated one (the split flush's bf16 rgb is
    summed in bf16 by the all_reduce and in float32 by the scatter, so
    it is held to the one-device frame's filter of its own histogram)."""
    ranks = [o[backend] for o in worlds[n]]
    r = one_device[backend][0]
    for o in ranks:
        assert np.array_equal(o["frame"], ranks[0]["frame"])
        assert np.array_equal(o["frame_scattered"],
                              ranks[0]["frame_scattered"])
    rep, sc = ranks[0]["frame"], ranks[0]["frame_scattered"]
    assert rep.shape == sc.shape == (FAST.height, FAST.width, 4)
    assert rep[..., :3].any()
    if backend == "pallas_rgb16":
        rep = r.finalize_frame(ranks[0]["hist"], 0.0)
        assert np.abs(rep.astype(int) - ranks[0]["frame"].astype(int)) \
            .max() <= 1
    else:
        assert np.abs(rep.astype(int) - sc.astype(int)).max() <= 1


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_resume_mass_not_multiplied(n, worlds):
    m1, m2 = worlds[n][0]["resume"]
    assert m1 > 0 and m2 == pytest.approx(2.0 * m1, rel=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_temporal_matches_one_device(n, worlds):
    """animated_spark's box filter weighs every sample 1.0, so the
    density of the blurred frame is a count too."""
    blur = dataclasses.replace(_profile("pallas_win"), temporal_samples=3)
    r = trender.Renderer(get_genome("animated_spark"), blur, device="cpu")
    assert r._temporal_times(0.5)[1].tolist() == [1.0, 1.0, 1.0]
    hist, st = r.accumulate(0.5, seed=6)
    got, sg = worlds[n][0]["temporal"]
    assert torch.equal(got[:-1, 3], hist[:-1, 3])
    err = (got[:-1, :3].double() - hist[:-1, :3].double()).abs()
    assert bool((err <= _rgb_bound(r, "pallas_win", hist, st, got, n)).all())
    assert sg.plotted_samples == st.plotted_samples
    assert sg.total_iters == st.total_iters
    assert float(hist[:-1, 3].sum()) > 0


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_filters_on_the_pyramid(n, worlds):
    res = worlds[n][0]["pyramid"]
    assert res["band_context"][0] > 0
    whole = res["whole"].astype(int)
    assert whole[..., :3].any()
    for key in ("sharded", "scattered"):
        d = np.abs(res[key].astype(int) - whole)
        assert d.max() <= 1 and (d > 0).any(-1).mean() < 0.005, key


# -- against the JAX package's ShardedRenderer -----------------------------

def _tv(a, b):
    a = np.asarray(a, np.float64)[:-1, 3]
    b = np.asarray(b, np.float64)[:-1, 3]
    return 0.5 * np.abs(a / a.sum() - b / b.sum()).sum()


def test_sharded_matches_jax_sharded_renderer(worlds):
    jr = _jax_sharded("sierpinski", SIERPINSKI, 2)
    j11, _ = jr.accumulate(0.0, seed=JAX_SEED)
    j12, _ = jr.accumulate(0.0, seed=JAX_SEED + 1)
    res = worlds[2][0]["jax_injected"]
    floor = _tv(j11, j12)
    assert _tv(res["hist"].numpy(), j11) < 2.0 * floor
    jimg, _ = jr.render_frame(0.0, seed=JAX_SEED)
    jimg = np.asarray(jimg).astype(int)
    assert jimg[..., :3].any()
    for key in ("frame", "frame_scattered"):
        assert np.abs(res[key].astype(int) - jimg).max() <= 1, key


# -- ranks, and the command line --------------------------------------------

def _fail_in_rank_1(rank, device):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.all_reduce(torch.zeros(1))      # rank 0 waits for rank 1
    return rank


def test_a_failing_rank_ends_the_run():
    """Rank 1 raises while rank 0 waits in a collective: the run ends
    at once with an error (rank 1's, or rank 0's lost connection,
    whichever the parent sees first), long before the timeout."""
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|Connection reset|"
                             "Connection closed by peer"):
        launch.spawn(_fail_in_rank_1, ["cpu", "cpu"], "gloo", timeout_s=60)
    assert time.perf_counter() - t0 < 45


def test_cli_devices_on_the_cpu(tmp_path, capsys):
    from PIL import Image
    out = tmp_path / "s.png"
    assert tmain.main(["gallery:sierpinski", "--cpu", "--devices", "2",
                       "-o", str(out), "--width", "64", "--height",
                       "64"]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (64, 64, 4) and img[..., :3].any()


def test_cli_reduce_scatter_refuses_partitions():
    """The JAX CLI's refusal; without --devices, and --devices without a
    GPU, are tests/test_torch_render.py::test_cli_refuses_unported_flags."""
    with pytest.raises(SystemExit, match="incompatible with stripes"):
        tmain.main(["gallery:sierpinski", "--cpu", "--devices", "2",
                    "--reduce-scatter", "--stripes", "2"])
