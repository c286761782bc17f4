"""The port's frame partitions and unpacked records against the JAX
package: striped accumulation, banded filtering, `iterate_chunk` and
the full-record flush, and the Renderer's rule for frames whose
records do not pack into 32 bits.

Contracts:
- *exact:* `band_margin` and `_merge_stripe` equal the JAX functions;
  `iterate_chunk`'s addresses equal JAX's from the same injected state
  (sierpinski: affine maps, so the trajectories stay together);
- *exact on the CPU:* a striped histogram equals the whole frame's
  (`np.array_equal`) for the same seed, as the JAX package's own tests
  hold it: full_feature, rotated, ss 2 with a gutter,
  opacity-extended records, every backend; motion blur at rtol 1e-5,
  atol 1e-4; plotted counts equal and total_iters n_stripes times;
- *bounded:* a banded frame within 1 u8 step of the whole-frame
  filter with under 0.5% of pixels differing, in the port and against
  JAX's `finalize_frame_banded` on the same histogram; `iterate_chunk`'s
  rgba within float32 rounding of JAX's (rtol 1e-5, atol 1e-6); the
  full-record flush against the packed one as `tests/test_ops.py`
  holds it (the same plotted count, density within 1e-3, rgb within
  the palette quantization);
- *exact:* `density_filter(skip_empty=True)` equals `skip_empty=False`.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu.genome.spline import Spline as JSpline  # noqa: E402
from cuburn_tpu.models import get_genome as jget_genome  # noqa: E402
from cuburn_tpu.ops import camera as jcam  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu.profile import RenderProfile as JProfile  # noqa: E402
from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.genome.spline import Spline  # noqa: E402
from cuburn_tpu_torch.models import get_genome  # noqa: E402
from cuburn_tpu_torch.ops import de as tde  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops.camera import CameraSpec  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile, get_profile  # noqa: E402

FAST = RenderProfile(width=48, height=48, quality=30, batch=1024,
                     iters_per_chunk=16, fuse=16, hist_backend="scatter",
                     de_enabled=False)
PACKED_BACKENDS = ("pallas", "pallas_merged", "pallas_win", "pallas_rgb16")


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _renderer(genome, **fields):
    return trender.Renderer(genome, dataclasses.replace(FAST, **fields),
                            device="cpu")


def _assert_striped_equals_whole(r, n_stripes, seed=7, t=0.0):
    whole, sw = r.accumulate(t, seed=seed)
    striped, ss = r.accumulate_striped(t, seed=seed, n_stripes=n_stripes)
    np.testing.assert_array_equal(whole[:-1].numpy(), striped[:-1].numpy())
    assert float(striped[-1].abs().sum()) == 0.0      # junk row stays 0
    assert ss.total_iters == n_stripes * sw.total_iters
    assert float(whole[:-1, 3].sum()) > 0
    return sw, ss


# -- band_margin and _merge_stripe -----------------------------------------

@pytest.mark.parametrize("shape", ["gaussian", "mitchell"])
@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("sf", [0.0, 0.5, 1.5])
def test_band_margin_matches_jax(shape, ss, sf):
    for de_on in (False, True):
        for de_r in (0.0, 2.5, 9.0, 18.0, 40.0):      # 40 > MAX_RADIUS_CAP
            assert trender.band_margin(de_on, de_r, sf, shape, ss) == \
                jrender.band_margin(de_on, de_r, sf, shape, ss)


@pytest.mark.parametrize("full_h,n_stripes", [(12, 3), (13, 4), (10, 4)])
def test_merge_stripe_matches_jax(full_h, n_stripes):
    """Every stripe of a frame merged in turn, the last one's rows past
    the frame included in the stripe and masked off, into a histogram
    padded as the JAX package pads it."""
    acc_w = 7
    th = -(-full_h // n_stripes)
    rs = np.random.RandomState(full_h)
    pad_rows = max(full_h * acc_w + 1, n_stripes * th * acc_w)
    j = jnp.asarray(rs.rand(pad_rows, 4).astype(np.float32))
    t = torch.as_tensor(np.array(j))
    for s in range(n_stripes):
        stripe = rs.rand(th * acc_w, 4).astype(np.float32)
        rows = min(th, full_h - s * th)
        j = jrender._merge_stripe(j, jnp.asarray(stripe), jnp.int32(s * th),
                                  jnp.int32(rows), acc_w)
        out = trender._merge_stripe(t, torch.as_tensor(stripe), s * th,
                                    rows, acc_w)
        assert out is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- striped accumulation --------------------------------------------------

@pytest.mark.parametrize("backend", ["scatter", *PACKED_BACKENDS])
def test_striped_matches_whole_frame(backend):
    """full_feature in 3 stripes, the plain version of each flush."""
    r = _renderer(get_genome("full_feature"), hist_backend=backend)
    assert r.backend == backend
    _assert_striped_equals_whole(r, 3)


def test_striped_plotted_count_and_iterations():
    """The JAX package's case (96 x 96, 3 stripes): the plotted counts
    of the stripes add up to the whole frame's."""
    r = trender.Renderer(get_genome("full_feature"), dataclasses.replace(
        FAST, width=96, height=96, quality=20, batch=2048), device="cpu")
    sw, ss = _assert_striped_equals_whole(r, 3)
    assert ss.plotted_samples == sw.plotted_samples > 0
    img = r.finalize_frame(r.accumulate_striped(0.0, 7, 3)[0], 0.0)
    assert img[..., :3].max() > 0


@pytest.mark.parametrize("genome,n_stripes", [("full_feature", 4),
                                              ("classic_swirl", 3)])
def test_striped_with_rotation(genome, n_stripes):
    g = get_genome(genome)
    g.rotate = Spline(37.0)
    r = _renderer(g)
    assert not r.cam.no_rotation
    _assert_striped_equals_whole(r, n_stripes, seed=8)


def test_striped_with_supersample_and_gutter():
    g = get_genome("sierpinski")
    g.estimator_radius = Spline(5.0)
    r = _renderer(g, ss=2, de_enabled=True, width=32, height=32)
    assert r.cam.gutter > 0
    _assert_striped_equals_whole(r, 4, seed=2)


@pytest.mark.parametrize("backend", ["scatter", "pallas_win"])
def test_striped_with_opacity(backend):
    """Opacity-extended records: the stripe packs at the full frame's
    depth (layout_bins), op_bits from the full camera."""
    g = get_genome("sierpinski")
    g.xforms[1].opacity = Spline(0.5)
    g.xforms[2].opacity = Spline(0.25)
    r = _renderer(g, hist_backend=backend)
    assert r.op_bits > 0
    _assert_striped_equals_whole(r, 3, seed=4)


def test_striped_pallas_win_matches_striped_scatter():
    g = get_genome("sierpinski")
    h_s, _ = _renderer(g).accumulate_striped(0.0, seed=4, n_stripes=2)
    h_w, _ = _renderer(g, hist_backend="pallas_win").accumulate_striped(
        0.0, seed=4, n_stripes=2)
    a, b = h_s[:-1].numpy(), h_w[:-1].numpy()
    # density exact; rgb differs by the palette quantization (8 colour
    # bits for the windowed flush, 10 for scatter)
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=5e-3,
                               atol=5e-3 * a[:, 3:].max())


@pytest.mark.parametrize("backend", ["scatter", "pallas_win"])
def test_striped_motion_blur_matches_whole_frame(backend):
    r = _renderer(get_genome("animated_spark"), temporal_samples=3,
                  hist_backend=backend)
    whole, _ = r.accumulate(0.5, seed=6)
    striped, _ = r.accumulate_striped(0.5, seed=6, n_stripes=2)
    np.testing.assert_allclose(whole[:-1].numpy(), striped[:-1].numpy(),
                               rtol=1e-5, atol=1e-4)
    assert float(whole[:-1, 3].sum()) > 0


def test_stripe_camera_keeps_the_full_frame_depth():
    r = trender.Renderer(get_genome("full_feature"), get_profile("1080p"),
                         device="cpu")
    cam = r.cam
    th = -(-cam.acc_height // 4)
    scam = dataclasses.replace(cam, tile_row0=th,
                               full_acc_height=cam.acc_height,
                               tile_acc_height=th)
    assert scam.n_bins == th * cam.acc_width and scam.layout_bins == cam.n_bins
    assert tit.record_bits(r.key, scam, "pallas_win") == \
        tit.record_bits(r.key, cam, "pallas_win") == (8, 8)
    assert tit.color_bits_for(scam.n_bins) != tit.color_bits_for(cam.n_bins)


# -- banded filtering ------------------------------------------------------

def _banded_case(transparent=False, earlyclip=False):
    g = get_genome("full_feature")
    g.estimator_radius = Spline(5.0)
    g.spatial_filter_shape = "mitchell"
    g.earlyclip = earlyclip
    return g, dataclasses.replace(FAST, width=40, height=44, ss=2,
                                  de_enabled=True, transparent=transparent)


@pytest.mark.parametrize("transparent,earlyclip,n_bands", [
    (False, False, 3), (True, False, 3), (False, True, 4)])
def test_banded_matches_whole_frame(transparent, earlyclip, n_bands):
    g, prof = _banded_case(transparent, earlyclip)
    r = trender.Renderer(g, prof, device="cpu")
    hist, _ = r.accumulate(0.0, seed=6)
    whole = r.finalize_frame(hist, 0.0)
    stats = trender.FrameStats()
    banded = r.finalize_frame_banded(hist, 0.0, stats, n_bands=n_bands)
    assert banded.shape == whole.shape == (44, 40, 4)
    diff = np.abs(banded.astype(int) - whole.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005
    assert whole[..., :3].any() and stats.filter_s > 0
    assert (banded[..., 3] < 255).any() == transparent


@pytest.mark.parametrize("de_r", [9.0, 20.0])
def test_banded_matches_whole_frame_on_the_pyramid(de_r, monkeypatch):
    """Frames at least PYRAMID_MIN_WIDTH wide blur their wide DE rungs
    at a coarser octave, in row blocks counted from the accumulator's
    row 0: each band carries band_context's rows and starts on that
    grid, so the bands give the whole filter's rows (a band boxed on
    its own grid is up to 5 u8 steps off on half the pixels here)."""
    monkeypatch.setattr(tde, "PYRAMID_MIN_WIDTH", 32)
    g = get_genome("full_feature")
    g.estimator_radius = Spline(de_r)
    r = _renderer(g, width=60, height=70, ss=2, de_enabled=True)
    rows, align = tde.band_context(r._static_de_r, r.cam.acc_width)
    assert rows > trender.band_margin(True, r._static_de_r, 0.0,
                                      "gaussian", 2) and align > 1
    hist, _ = r.accumulate(0.0, seed=3)
    whole = r.finalize_frame(hist, 0.0)
    for n_bands in (2, 3):
        banded = r.finalize_frame_banded(hist, 0.0, n_bands=n_bands)
        diff = np.abs(banded.astype(int) - whole.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_band_context_without_the_pyramid():
    assert tde.band_context(18.0, tde.PYRAMID_MIN_WIDTH - 1) == (0, 1)
    assert tde.band_context(1.0, 4096) == (0, 1)      # rungs too narrow
    assert tde.band_context(48.0, 4096) == tde.band_context(24.0, 4096)


def test_banded_matches_jax_on_the_same_histogram():
    g, prof = _banded_case()
    r = trender.Renderer(g, prof, device="cpu")
    hist, _ = r.accumulate(0.0, seed=6)
    jg = jget_genome("full_feature")
    jg.estimator_radius = JSpline(5.0)
    jg.spatial_filter_shape = "mitchell"
    jr = jrender.Renderer(jg, JProfile(**prof.__dict__))
    assert tparams.genome_from_jax(jg).to_json() == g.to_json()
    h = hist.numpy()
    a = jr.finalize_frame_banded(h, 0.0, n_bands=3)
    b = r.finalize_frame_banded(h, 0.0, n_bands=3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert b[..., :3].any()


def test_banded_skip_empty_from_the_environment(monkeypatch):
    g, prof = _banded_case()
    r = trender.Renderer(g, prof, device="cpu")
    hist, _ = r.accumulate(0.0, seed=6)
    plain = r.finalize_frame_banded(hist, 0.0, n_bands=2)
    calls = []
    real = tde.density_filter

    def spy(*args, **kwargs):
        calls.append(kwargs["skip_empty"])
        return real(*args, **kwargs)
    monkeypatch.setattr(tde, "density_filter", spy)
    monkeypatch.setenv("CUBURN_DE_SKIP_EMPTY", "1")
    np.testing.assert_array_equal(
        r.finalize_frame_banded(hist, 0.0, n_bands=2), plain)
    assert calls == [True, True]


@pytest.mark.parametrize("density", ["uniform", "sparse"])
def test_density_filter_skip_empty_is_exact(density):
    """Uniform density puts every pixel on one or two rungs, so most
    rungs are empty; a sparse image leaves some empty too."""
    rs = np.random.RandomState(3)
    if density == "uniform":
        d = np.full((40, 36), 7.0, np.float32)
    else:
        d = np.where(rs.rand(40, 36) < 0.2, rs.randint(1, 500, (40, 36)),
                     0).astype(np.float32)
    img = torch.as_tensor(rs.rand(40, 36, 4).astype(np.float32)) \
        * torch.as_tensor(d > 0)[..., None]
    args = (img, torch.as_tensor(d), torch.tensor(9.0), torch.tensor(0.0),
            torch.tensor(0.4))
    a = tde.density_filter(*args, static_max_radius=9.0)
    b = tde.density_filter(*args, static_max_radius=9.0, skip_empty=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a.abs().sum()) > 0


# -- unpacked records ------------------------------------------------------

def test_iterate_chunk_matches_jax():
    jg = jget_genome("sierpinski")
    g = tparams.genome_from_jax(jg)
    key = jg.structure_key()
    cam_args = dict(width=64, height=48, ss=2, no_rotation=True, gutter=3)
    jc, tc = jcam.CameraSpec(**cam_args), CameraSpec(**cam_args)
    jp = jax.tree_util.tree_map(jnp.asarray, jg.eval_at(0.0))
    tp = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    js = jit_.init_state(jax.random.PRNGKey(3), 1024)
    ts = tparams.state_from_numpy(*(np.asarray(v) for v in (
        js.x, js.y, js.color, js.last_xf, js.age, js.rng)))
    cdf = jit_.xform_cdf_rows(jp)
    ppu = jp.ppu * jnp.float32(64 / jg.size[0])
    js2, ja, jrgba = jit_.iterate_chunk(key, jc, jp, cdf, js, ppu, 24, 8)
    ts2, ta, trgba = tit.iterate_chunk(
        key, tc, tp, torch.as_tensor(np.array(cdf)),
        ts, torch.as_tensor(np.array(ppu)), 24, 8)
    assert ta.shape == (24, 1024) and trgba.shape == (24, 1024, 4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts2.rng.numpy(),
                                  np.asarray(js2.rng, np.int64))
    np.testing.assert_allclose(trgba.numpy(), np.asarray(jrgba),
                               rtol=1e-5, atol=1e-6)
    live = ta.numpy() != tc.junk_bin
    assert live[:7].sum() == 0 and live.sum() > 1024 * 8   # fuse, then plots
    # unit opacity: density 1 on every record, the junk bin's too
    assert (trgba[..., 3] == 1.0).all()


def test_iterate_chunk_opacity_rgba():
    g = get_genome("sierpinski")
    g.xforms[1].opacity = Spline(0.5)
    key = g.structure_key()
    cam = CameraSpec(32, 32)
    p = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    state = tit.init_state(torch.Generator().manual_seed(1), 512, "cpu")
    _s, addr, rgba = tit.iterate_chunk(key, cam, p, tit.xform_cdf_rows(p),
                                       state, p.ppu * (32 / g.size[0]), 40, 8)
    op = rgba[..., 3]
    assert set(op.unique().tolist()) <= {0.0, 0.5, 1.0} and (op == 0.5).any()
    assert (rgba[..., :3] <= op[..., None] + 1e-6).all()


@pytest.mark.parametrize("backend", ["scatter", "scatter_sorted", "sortcum"])
def test_full_records_match_packed(backend):
    g = get_genome("sierpinski")
    key = g.structure_key()
    cam = CameraSpec(64, 64, 1)
    p = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    cdf = tit.xform_cdf_rows(p)
    ppu = p.ppu * float(np.float32(64 / g.size[0]))
    outs = {}
    for packed in (True, False):
        state = tit.init_state(torch.Generator().manual_seed(4), 1024, "cpu")
        _s, h, n = tit.iterate_accumulate(
            key, cam, backend, p, cdf, state, thist.alloc(cam.n_bins, "cpu"),
            ppu, 4, 16, 16, packed=packed)
        outs[packed] = (h.numpy(), float(n))
    assert outs[True][1] == outs[False][1] > 0
    a, b = outs[True][0][:-1], outs[False][0][:-1]
    np.testing.assert_allclose(a[:, 3], b[:, 3], atol=1e-3)
    np.testing.assert_allclose(a[:, :3], b[:, :3], atol=2e-3, rtol=2e-2)


def test_full_records_weighted_and_temporal(monkeypatch):
    """weight scales the full records' mass, the plotted count stays
    unweighted; the temporal driver passes `packed` on."""
    r = _renderer(get_genome("animated_spark"), temporal_samples=2)
    key, cam = r.key, r.cam
    p = tparams.params_from_genome(r.genome.eval_at(0.0), "cpu")
    ppu = p.ppu * float(np.float32(48 / r.genome.size[0]))
    outs = []
    for w in (None, 0.25):
        state = tit.init_state(torch.Generator().manual_seed(2), 1024, "cpu")
        _s, h, n = tit.iterate_accumulate(
            key, cam, "scatter", p, tit.xform_cdf_rows(p), state,
            thist.alloc(cam.n_bins, "cpu"), ppu, 2, 8, 4, packed=False,
            weight=w)
        outs.append((h, float(n)))
    assert outs[0][1] == outs[1][1] > 0
    np.testing.assert_allclose(outs[1][0].numpy(), 0.25 * outs[0][0].numpy(),
                               rtol=1e-6)
    seen = []
    real = tit.iterate_accumulate

    def spy(*args, **kwargs):
        seen.append(kwargs["packed"])
        return real(*args, **kwargs)
    monkeypatch.setattr(tit, "iterate_accumulate", spy)
    forced = _renderer(get_genome("animated_spark"), temporal_samples=2)
    forced.packed = False
    _h, stats = forced.accumulate(0.5, seed=1)
    assert seen == [False, False] and stats.plotted_samples > 0


@pytest.mark.parametrize("backend", PACKED_BACKENDS)
def test_packed_flush_refuses_full_records(backend):
    g = get_genome("sierpinski")
    p = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    cam = CameraSpec(32, 32)
    state = tit.init_state(torch.Generator().manual_seed(1), 64, "cpu")
    with pytest.raises(ValueError, match="requires packed records"):
        tit.iterate_accumulate(
            g.structure_key(), cam, backend, p, tit.xform_cdf_rows(p), state,
            thist.alloc(cam.n_bins, "cpu"), p.ppu, 1, 2, 1, packed=False)


def test_4k_profile_builds_unpacked(monkeypatch):
    """33,852,736 bins need 26 address bits: no room for 8 colour bits.
    The Renderer takes scatter and allocates nothing at construction."""
    def refuse(*args, **kwargs):
        raise AssertionError("a histogram was allocated")
    monkeypatch.setattr(trender, "hist_alloc_for", refuse)
    monkeypatch.setattr(thist, "alloc", refuse)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = trender.Renderer(get_genome("full_feature"), get_profile("4k"),
                             device="cpu")
    assert (r.cam.acc_width, r.cam.acc_height) == (7736, 4376)
    assert r.cam.n_bins == 33_852_736
    assert r.packed is False and r.backend == "scatter"
    with pytest.warns(UserWarning, match="needs packed records"):
        rw = trender.Renderer(get_genome("full_feature"),
                              get_profile("4k", hist_backend="pallas_win"),
                              device="cpu")
    assert rw.backend == "scatter"


@pytest.mark.parametrize("backend", ["auto", "pallas_merged"])
def test_forced_unpacked_frame_renders(monkeypatch, backend):
    monkeypatch.setattr(trender, "color_bits_for", lambda n_bins: 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = trender.Renderer(get_genome("sierpinski"), dataclasses.replace(
            FAST, width=32, height=32, hist_backend=backend), device="cpu")
    assert r.packed is False and r.backend == "scatter"
    assert any("needs packed records" in str(w.message) for w in caught) \
        == (backend != "auto")
    img, stats = r.render_frame(0.0, seed=3)
    assert img[..., :3].any() and stats.plotted_samples > 0
    hist, stats = r.accumulate(0.0, seed=3)
    assert float(hist[:-1, 3].sum()) == stats.plotted_samples
    # the unpacked path stripes exactly too
    _assert_striped_equals_whole(r, 2, seed=3)


def test_cli_stripes_and_bands_on_the_4k_path(monkeypatch, tmp_path):
    """The CLI's still path on a frame forced unpacked, striped and
    banded: a PNG and a stitched histogram."""
    monkeypatch.setattr(trender, "color_bits_for", lambda n_bins: 0)
    out, hist = tmp_path / "s.png", tmp_path / "h.npy"
    assert tmain.main(["gallery:sierpinski", "-o", str(out), "--cpu",
                       "--width", "32", "--height", "32", "--quality", "20",
                       "--stripes", "2", "--bands", "2",
                       "--save-hist", str(hist)]) == 0
    h = np.load(hist)
    assert h.shape == (34 * 34 + 1, 4) and h[:-1, 3].sum() > 0
    assert h[-1].sum() == 0 and out.stat().st_size > 0
