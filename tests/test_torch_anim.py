"""The port's animation path against the JAX package's: the packed-knot
interpolator, temporal sampling, weighted flushes, the frame loops
and `--animate`.

Contracts:
- *bounded:* `eval_packed`, `_palette_at` and `eval_params` evaluate
  the JAX package's float32 formula on the same knot tables: rtol 1e-6
  with atol 1e-7; against the float64 host spline at the JAX test's
  rtol 2e-4 / atol 2e-5;
- *exact:* `temporal_filter_weights`, `frame_dt`, `_temporal_times`
  and `frame_times` equal the JAX functions;
- *exact:* one temporal sample at weight 1.0 is `iterate_accumulate`
  bit for bit on every backend;
- *bounded:* a weight of 0.25 gives 0.25 times the weight-1.0 histogram
  at rtol 1e-6 with equal plotted counts; the split bf16 layout within
  a bf16 ulp (2^-8 relative) for rgb and rtol 1e-6 for density;
- *distributional:* a T = 4 gaussian frame against the JAX Renderer's
  from the same injected trajectories, TV under 2x JAX's two-seed floor;
- *exact on the CPU:* `frames_overlapped` yields the frames of `frames`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu.genome.spline import Spline  # noqa: E402
from cuburn_tpu.models import get_genome as jget_genome  # noqa: E402
from cuburn_tpu.ops import interp as jinterp  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu.profile import RenderProfile as JProfile  # noqa: E402
from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.genome.convert import genome_to_flame_xml  # noqa: E402
from cuburn_tpu_torch.genome.specs import GenomeParams  # noqa: E402
from cuburn_tpu_torch.models import get_genome  # noqa: E402
from cuburn_tpu_torch.ops import interp as tinterp  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops.camera import CameraSpec  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile as TProfile  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
GENOMES = ("sierpinski", "full_feature", "animated_spark", "kaleido")
TIMES = (0.0, 0.3, 0.77, 1.0)


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


# -- the interpolator ------------------------------------------------------

def _random_tables(seed=0, n=40):
    """The 40 random splines of the JAX package's interpolator test, as
    (splines, knot_t, knot_v, counts)."""
    rng = np.random.RandomState(seed)
    splines = []
    for _ in range(n):
        nk = rng.randint(1, 6)
        ts = np.sort(rng.rand(nk) * 2.0)
        splines.append(Spline(np.stack([ts, rng.randn(nk)], 1)))
    kmax = max(len(s.knots) for s in splines)
    knot_t = np.zeros((n, kmax), np.float32)
    knot_v = np.zeros((n, kmax), np.float32)
    counts = np.zeros((n,), np.int32)
    for p, s in enumerate(splines):
        k = len(s.knots)
        knot_t[p, :k], knot_v[p, :k] = s.knots[:, 0], s.knots[:, 1]
        knot_t[p, k:], knot_v[p, k:] = s.knots[-1, 0], s.knots[-1, 1]
        counts[p] = k
    return splines, knot_t, knot_v, counts


def _t(a):
    return torch.as_tensor(np.array(a))


def test_eval_packed_matches_jax_and_host_spline():
    splines, knot_t, knot_v, counts = _random_tables()
    assert (counts == 1).any() and (counts == 5).any()
    # before the first knot, after the last, and the knots themselves
    query = np.concatenate([np.linspace(-0.2, 2.2, 23),
                            knot_t[:, 0], knot_t[:, -1]]).astype(np.float32)
    got = tinterp.eval_packed(_t(knot_t), _t(knot_v), _t(counts),
                              _t(query)).numpy()
    want = np.asarray(jinterp.eval_packed(
        jnp.asarray(knot_t), jnp.asarray(knot_v), jnp.asarray(counts),
        jnp.asarray(query)))
    assert got.shape == want.shape == (query.size, 40)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for p, s in enumerate(splines):
        np.testing.assert_allclose(
            got[:, p], s.evaluate(query.astype(np.float64)), rtol=2e-4,
            atol=2e-5)


@pytest.mark.parametrize("kmax", [1, 4])
def test_eval_packed_one_knot_slots(kmax):
    """A one-knot slot (every padded constant of pack_genome) has its
    segment clamp's upper bound under the lower one; it evaluates to
    its value at every time, alone in a (P, 1) table or padded."""
    knot_t = np.zeros((3, kmax), np.float32)
    knot_v = np.repeat(np.float32([[1.5], [-2.0], [0.0]]), kmax, axis=1)
    counts = np.ones(3, np.int64)
    ts = np.float32([-1.0, 0.0, 0.5, 7.0])
    got = tinterp.eval_packed(_t(knot_t), _t(knot_v), _t(counts), _t(ts))
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(knot_v[:, 0], (4, 3)))
    want = np.asarray(jinterp.eval_packed(
        jnp.asarray(knot_t), jnp.asarray(knot_v),
        jnp.asarray(counts.astype(np.int32)), jnp.asarray(ts)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [1, 2, 4])
def test_palette_at_matches_jax(q):
    rs = np.random.RandomState(q)
    pals = rs.rand(q, 256, 3).astype(np.float32)
    times = np.sort(rs.rand(q)).astype(np.float32)
    if q == 4:
        times[2] = times[1]            # a repeated keyframe time
    ts = np.concatenate([np.float32([-0.5, 1.5]), times,
                         rs.rand(5).astype(np.float32)])
    got = tinterp._palette_at(_t(pals), _t(times), _t(ts)).numpy()
    want = np.asarray(jinterp._palette_at(
        jnp.asarray(pals), jnp.asarray(times), jnp.asarray(ts)))
    assert got.shape == (ts.size, 256, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", GENOMES)
def test_pack_genome_matches_jax(name):
    """The port packs the JAX package's knot tables bit for bit, and
    every GenomeParams field (enumerated, so a new one cannot escape)
    of `eval_params` agrees with JAX's and with the host's eval_at."""
    jg, g = jget_genome(name), get_genome(name)
    jp, tp = jinterp.pack_genome(jg), tinterp.pack_genome(g, "cpu")
    for table in ("knot_t", "knot_v", "counts", "palettes",
                  "palette_times"):
        np.testing.assert_array_equal(getattr(tp, table).numpy(),
                                      np.asarray(getattr(jp, table)))
    # JAX's own tables through the port's evaluators
    ts = np.float32(TIMES)
    np.testing.assert_allclose(
        tinterp.eval_packed(_t(jp.knot_t), _t(jp.knot_v), _t(jp.counts),
                            _t(ts)).numpy(),
        np.asarray(jinterp.eval_packed(jp.knot_t, jp.knot_v, jp.counts,
                                       jnp.asarray(ts))),
        rtol=RTOL, atol=ATOL)
    got, want = tp.eval_params(ts), jp.eval_params(ts)
    for k, t in enumerate(TIMES):
        host = g.eval_at(t)
        one = tinterp.sample_params(got, k)
        for f in dataclasses.fields(GenomeParams):
            a = getattr(one, f.name).numpy()
            assert a.dtype == np.float32, f.name
            assert a.shape == np.shape(getattr(host, f.name)), f.name
            np.testing.assert_allclose(
                a, np.asarray(getattr(want, f.name))[k], rtol=RTOL,
                atol=ATOL, err_msg=f"{f.name} at t={t} against JAX")
            np.testing.assert_allclose(
                a, getattr(host, f.name), rtol=2e-4, atol=2e-5,
                err_msg=f"{f.name} at t={t} against eval_at")


def test_eval_params_temporal_axis():
    p = tinterp.pack_genome(get_genome("animated_spark"), "cpu") \
        .eval_params(np.linspace(0, 1, 5))
    assert p.affine.shape[0] == 5 and p.palette.shape == (5, 256, 3)
    assert p.ppu.shape == (5,)
    assert not torch.allclose(p.affine[0], p.affine[-1])


# -- temporal sampling and frame times -------------------------------------

@pytest.mark.parametrize("args", [
    (1, "box", 1.0, 0.0), (4, "box", 1.0, 0.0), (4, "gaussian", 1.0, 0.0),
    (8, "gauss", 2.0, 0.0), (6, "exp", 1.0, 2.0), (6, "exp", 1.0, -2.0),
    (5, "exp", 0.5, 0.0)])
def test_temporal_filter_weights_equal_jax(args):
    got = trender.temporal_filter_weights(*args)
    want = jrender.temporal_filter_weights(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if args[:2] == (4, "gaussian"):
        np.testing.assert_allclose(got[1][[0, 1]], [0.011109, 0.324652],
                                   rtol=1e-4)


def test_temporal_filter_unknown_type():
    with pytest.raises(ValueError, match="unknown temporal filter"):
        trender.temporal_filter_weights(4, "triangle")


FAST = dict(width=32, height=32, quality=5, batch=1024, iters_per_chunk=8,
            fuse=16, de_enabled=False)


@pytest.mark.parametrize("case", [
    dict(fps=4.0), dict(fps=4.0, duration=3.0), dict(fps=8.0, skip=3),
    dict(fps=4.0, duration=0.1), dict(fps=24.0, duration=0.75, skip=2),
    dict(fps=4.0, time_range=(0.0, 2.0)),
    dict(fps=4.0, time_range=(0.5, 0.5))])
def test_frame_times_and_shutter_equal_jax(case):
    case = dict(case)
    span = case.pop("time_range", None)
    jg, g = jget_genome("animated_spark"), get_genome("animated_spark")
    for x in (jg, g):
        x.temporal_filter_type = "gaussian"
        if span:
            x.time_range = span
    jr = jrender.Renderer(jg, JProfile(**FAST, temporal_samples=4, **case))
    tr = trender.Renderer(g, TProfile(**FAST, temporal_samples=4, **case),
                          device="cpu")
    assert tr.frame_dt() == jr.frame_dt()
    assert tr.frame_times() == jr.frame_times()
    assert len(tr.frame_times()) >= 1
    for t in (0.0, 0.4, 1.0):
        got, want = tr._temporal_times(t), jr._temporal_times(t)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
    still = trender.Renderer(g, TProfile(**FAST, **case), device="cpu")
    times, w, s = still._temporal_times(0.4)
    assert times == [0.4] and w.tolist() == [1.0] and s == 1.0


# -- weighted flushes and the temporal accumulate --------------------------

def _accumulate_args(backend, name="animated_spark", batch=1024, seed=3):
    g = get_genome(name)
    key = g.structure_key()
    cam = CameraSpec(64, 64, 1)
    params_T = tinterp.pack_genome(g, "cpu").eval_params([0.25])
    ppu_T = params_T.ppu * float(np.float32(64 / g.size[0]))
    state = tit.init_state(torch.Generator().manual_seed(seed), batch,
                           "cpu")
    hist = tit.hist_alloc_for(backend, cam.n_bins, "cpu")
    return key, cam, params_T, ppu_T, state, hist


def _logical(backend, hist, cam):
    return tit.hist_to_logical(backend, hist, cam.n_bins).numpy()


@pytest.mark.parametrize("backend", trender.BACKENDS)
def test_one_sample_weight_one_is_the_plain_path(backend):
    key, cam, params_T, ppu_T, state, hist = _accumulate_args(backend)
    s1, h1, n1 = tit.iterate_accumulate_temporal(
        key, cam, backend, params_T, state, hist, ppu_T, 2, 4, 8,
        weights_T=[1.0])
    assert all(a is b for a, b in zip(h1, hist)) \
        if isinstance(hist, tuple) else h1 is hist      # in place
    params = tinterp.sample_params(params_T, 0)
    s2, h2, n2 = tit.iterate_accumulate(
        key, cam, backend, params, tit.xform_cdf_rows(params), state,
        tit.hist_alloc_for(backend, cam.n_bins, "cpu"), ppu_T[0], 2, 4, 8)
    np.testing.assert_array_equal(_logical(backend, h1, cam),
                                  _logical(backend, h2, cam))
    assert float(n1) == float(n2) > 0
    for f in dataclasses.fields(tit.IterState):
        assert torch.equal(getattr(s1, f.name), getattr(s2, f.name))
    # no weights at all is weight 1.0
    _s, h3, n3 = tit.iterate_accumulate_temporal(
        key, cam, backend, params_T, state,
        tit.hist_alloc_for(backend, cam.n_bins, "cpu"), ppu_T, 2, 4, 8)
    np.testing.assert_array_equal(_logical(backend, h1, cam),
                                  _logical(backend, h3, cam))


@pytest.mark.parametrize("backend", trender.BACKENDS)
def test_weight_scales_mass_and_not_counts(backend):
    out = {}
    for w in (1.0, 0.25):
        key, cam, params_T, ppu_T, state, hist = _accumulate_args(backend)
        params = tinterp.sample_params(params_T, 0)
        _s, h, n = tit.iterate_accumulate(
            key, cam, backend, params, tit.xform_cdf_rows(params), state,
            hist, ppu_T[0], 2, 16, 8, weight=w)
        out[w] = (_logical(backend, h, cam), float(n))
    (h1, n1), (h2, n2) = out[1.0], out[0.25]
    assert n1 == n2 > 0                     # counts stay unweighted
    assert h1[:-1, 3].sum() == n1
    np.testing.assert_allclose(h2[:, 3], h1[:, 3] * 0.25, rtol=1e-6)
    # the split layout rounds each flush's rgb to bf16: one ulp a flush
    rtol = 2 * 2.0 ** -8 if backend == "pallas_rgb16" else 1e-6
    np.testing.assert_allclose(h2[:, :3], h1[:, :3] * 0.25, rtol=rtol)


@pytest.mark.parametrize("backend", ["scatter", "pallas_win"])
def test_temporal_mass_is_the_weighted_plotted_count(backend, monkeypatch):
    """Sample k's flushes carry weights_T[k]: the density mass of the
    frame is the sum of weight times that sample's plotted count."""
    per_sample = []
    plain = tit.iterate_accumulate

    def recording(*args, **kwargs):
        out = plain(*args, **kwargs)
        per_sample.append((kwargs["weight"], float(out[2])))
        return out
    monkeypatch.setattr(tit, "iterate_accumulate", recording)
    g = get_genome("animated_spark")
    key, cam = g.structure_key(), CameraSpec(64, 64, 1)
    params_T = tinterp.pack_genome(g, "cpu").eval_params([0.1, 0.2, 0.3])
    ppu_T = params_T.ppu * float(np.float32(64 / g.size[0]))
    state = tit.init_state(torch.Generator().manual_seed(5), 1024, "cpu")
    weights = [0.011, 0.325, 1.0]
    _s, hist, n = tit.iterate_accumulate_temporal(
        key, cam, backend, params_T, state,
        tit.hist_alloc_for(backend, cam.n_bins, "cpu"), ppu_T, 2, 8, 8,
        weights_T=weights)
    assert [w for w, _ in per_sample] == weights
    assert float(n) == sum(c for _, c in per_sample)
    want = sum(np.float32(w) * c for w, c in per_sample)
    assert float(hist[:-1, 3].sum()) == pytest.approx(want, rel=1e-5)


# -- whole frames ----------------------------------------------------------

def _inject_jax_state(monkeypatch):
    """The port's Renderer starts from the trajectories JAX's Renderer
    seeds for the same seed."""
    def init_state(generator, batch, device):
        js = jit_.init_state(jax.random.PRNGKey(generator.initial_seed()),
                             batch)
        return tparams.state_from_numpy(
            *(np.asarray(v) for v in (js.x, js.y, js.color, js.last_xf,
                                      js.age, js.rng)), device=device)
    monkeypatch.setattr(trender, "init_state", init_state)


def _tv(a, b):
    da = np.asarray(a, np.float64)[:-1, 3]
    db = np.asarray(b, np.float64)[:-1, 3]
    return 0.5 * np.abs(da / da.sum() - db / db.sum()).sum()


BLUR = dict(width=64, height=64, quality=100, batch=4096,
            iters_per_chunk=16, fuse=20, de_enabled=False,
            temporal_samples=4, fps=4.0)


def test_blurred_frame_matches_jax_by_distribution(monkeypatch):
    _inject_jax_state(monkeypatch)
    jg, g = jget_genome("animated_spark"), get_genome("animated_spark")
    jg.temporal_filter_type = g.temporal_filter_type = "gaussian"
    jr = jrender.Renderer(jg, JProfile(**BLUR, hist_backend="scatter"))
    j11, jstats = jr.accumulate(0.5, seed=11)
    j12, _ = jr.accumulate(0.5, seed=12)
    tr = trender.Renderer(g, TProfile(**BLUR, hist_backend="pallas_win"),
                          device="cpu")
    t11, stats = tr.accumulate(0.5, seed=11)
    assert stats.total_iters == jstats.total_iters
    assert stats.plotted_samples > 0.5 * stats.total_iters
    # gaussian weights: the mass is well under the plotted count
    mass = float(t11[:-1, 3].sum())
    assert 0.2 * stats.plotted_samples < mass < 0.5 * stats.plotted_samples
    assert mass == pytest.approx(float(np.asarray(j11)[:-1, 3].sum()),
                                 rel=0.02)
    d, floor = _tv(t11.numpy(), j11), _tv(j11, j12)
    assert d < 2.0 * floor, (d, floor)
    # within a couple of LSB of JAX's image on most pixels is not the
    # contract (different trajectories); the mean brightness is close
    img = tr.finalize_frame(t11, 0.5)
    jimg = np.asarray(jr.finalize_frame(j11, 0.5))
    assert img.shape == jimg.shape == (64, 64, 4)
    assert img[..., :3].astype(np.float64).mean() == pytest.approx(
        jimg[..., :3].astype(np.float64).mean(), rel=0.05)


def test_motion_blur_differs_from_the_still():
    g = get_genome("animated_spark")
    blurred = trender.Renderer(g, TProfile(**BLUR), device="cpu")
    still = trender.Renderer(g, TProfile(**{**BLUR, "temporal_samples": 1}),
                             device="cpu")
    hb, sb = blurred.accumulate(0.5, seed=2)
    hs, ss = still.accumulate(0.5, seed=2)
    # each of the 4 samples rounds its share up to whole chunks
    assert 0 <= sb.total_iters - ss.total_iters < 4 * 4096 * 16
    # the shutter smears the attractor: far over the two-seed floor
    hs2, _ = still.accumulate(0.5, seed=3)
    assert _tv(hb.numpy(), hs.numpy()) > 1.5 * _tv(hs.numpy(), hs2.numpy())


def test_gaussian_filter_preserves_brightness():
    """sumfilt: a gaussian temporal filter leaves the overall brightness
    where the box filter has it."""
    prof = TProfile(**{**BLUR, "temporal_samples": 6})
    g = get_genome("animated_spark")
    img_box, _ = trender.Renderer(g, prof, device="cpu").render_frame(
        0.5, seed=4)
    g2 = get_genome("animated_spark")
    g2.temporal_filter_type = "gaussian"
    img_g, _ = trender.Renderer(g2, prof, device="cpu").render_frame(
        0.5, seed=4)
    assert not np.array_equal(img_box, img_g)
    assert img_g[..., :3].astype(np.float64).mean() == pytest.approx(
        img_box[..., :3].astype(np.float64).mean(), rel=0.15)


def test_batch_rule_halves_on_the_frames_iterations():
    """The batch is sized on iters_per_sample * T, as one sample's
    frame of the same quality: the trajectories carry over."""
    g = get_genome("animated_spark")
    prof = dict(width=32, height=32, quality=256, batch=8192,
                iters_per_chunk=4, fuse=16, de_enabled=False)
    still = trender.Renderer(g, TProfile(**prof), device="cpu")
    blurred = trender.Renderer(g, TProfile(**prof, temporal_samples=4),
                               device="cpu")
    total = still.profile.total_iters
    assert still._batch_for(total) == 2048 < prof["batch"]
    assert still._batch_for(total / 4) == 1024
    _h, stats = blurred.accumulate(0.0, seed=1)
    per_chunk = 2048 * 4
    assert stats.total_iters == 4 * per_chunk * int(
        np.ceil(total / 4 / per_chunk))


# -- the frame loops -------------------------------------------------------

ANIM = dict(width=48, height=48, quality=20, batch=1024, iters_per_chunk=8,
            fuse=16, temporal_samples=2, fps=4.0, duration=0.75)


@pytest.mark.parametrize("backend", ["scatter", "pallas_win",
                                     "pallas_rgb16"])
def test_overlapped_frames_equal_serial(backend):
    g = get_genome("animated_spark")
    r = trender.Renderer(g, TProfile(**ANIM, hist_backend=backend),
                         device="cpu")
    serial = list(r.frames(seed=3))
    over = list(r.frames_overlapped(seed=3))
    assert len(serial) == len(over) == 3
    for (a, sa), (b, sb) in zip(serial, over):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (48, 48, 4) and (a[..., 3] == 255).all()
        assert sa.plotted_samples == sb.plotted_samples > 0
        assert sa.total_iters == sb.total_iters
    assert not np.array_equal(serial[0][0], serial[2][0])   # it animates
    # frame i is render_frame at its time with seed + i
    (_i, t2) = r.frame_times()[2]
    np.testing.assert_array_equal(r.render_frame(t2, seed=5)[0],
                                  serial[2][0])


def test_transparent_overlapped_frames_equal_serial():
    g = get_genome("animated_spark")
    r = trender.Renderer(g, TProfile(**ANIM, transparent=True),
                         device="cpu")
    for (a, _), (b, _) in zip(r.frames(seed=1), r.frames_overlapped(seed=1)):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (48, 48, 4) and (a[..., 3] < 255).any()


def test_frames_partitioned_switches_loops(monkeypatch):
    r = trender.Renderer(get_genome("animated_spark"), TProfile(**ANIM),
                         device="cpu")
    calls = []
    monkeypatch.setattr(r, "frames_overlapped",
                        lambda seed=0: calls.append(seed) or iter(()))
    assert list(r.frames_partitioned(seed=7, overlap=True)) == []
    assert calls == [7]
    assert len(list(r.frames_partitioned(seed=7))) == 3
    assert calls == [7]


@pytest.mark.parametrize("kw", [dict(n_stripes=2), dict(n_bands=2),
                                dict(n_stripes=2, overlap=True)])
def test_frames_partitioned_yields_partitioned_frames(kw, monkeypatch):
    """Stripes or bands give every frame through the partitioned path
    (`overlap` does not apply to it), each frame within one u8 step of
    frames()'s (bit-identical when striped only)."""
    r = trender.Renderer(get_genome("animated_spark"), TProfile(**ANIM),
                         device="cpu")
    monkeypatch.setattr(r, "frames_overlapped", None)
    got = list(r.frames_partitioned(seed=3, **kw))
    want = list(r.frames(seed=3))
    assert len(got) == len(want) == 3
    for (a, sa), (b, sb) in zip(got, want):
        assert a.shape == b.shape == (48, 48, 4) and a[..., :3].any()
        d = np.abs(a.astype(int) - b.astype(int)).max()
        assert d == 0 if "n_bands" not in kw else d <= 1
        assert sa.total_iters == kw.get("n_stripes", 1) * sb.total_iters
        assert sa.plotted_samples == sb.plotted_samples


def test_skip_keeps_frame_seeds():
    """A skip preview renders the full render's frames: the index that
    seeds a frame is its unskipped number."""
    g = get_genome("animated_spark")
    full = trender.Renderer(g, TProfile(**{**ANIM, "duration": 1.25}),
                            device="cpu")
    prev = trender.Renderer(g, TProfile(**{**ANIM, "duration": 1.25},
                                        skip=2), device="cpu")
    assert [i for i, _ in prev.frame_times()] == [0, 2, 4]
    a, b = list(full.frames(seed=2)), list(prev.frames(seed=2))
    for k, (img, _) in enumerate(b):
        np.testing.assert_array_equal(img, a[2 * k][0])


# -- the command line ------------------------------------------------------

SMALL = ["--cpu", "--width", "48", "--height", "48", "--quality", "10"]


def _n_frames(path):
    return path.read_bytes().count(b"FRAME\n")


def test_cli_animate_writes_every_frame(tmp_path, capsys):
    a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
    args = ["gallery:animated_spark", "--animate", *SMALL, "--fps", "4",
            "--duration", "0.75", "--temporal-samples", "2"]
    metrics = tmp_path / "m.jsonl"
    assert tmain.main([*args, "-o", str(a), "--stats", "--metrics-json",
                       str(metrics)]) == 0
    cap = capsys.readouterr()
    assert "wrote 3 frames" in cap.out and "frame 3:" in cap.err
    assert len(metrics.read_text().splitlines()) == 3
    assert tmain.main([*args, "-o", str(b), "--no-overlap"]) == 0
    assert _n_frames(a) == 3
    assert a.read_bytes() == b.read_bytes()


def test_cli_blend_renders_an_edge(tmp_path):
    out = tmp_path / "edge.y4m"
    assert tmain.main(["gallery:sierpinski", "--blend", "gallery:kaleido",
                       "--blend-spin", "1", "--animate", *SMALL, "--fps",
                       "3", "--duration", "1", "-o", str(out)]) == 0
    assert _n_frames(out) == 3
    still = tmp_path / "mid.png"
    assert tmain.main(["gallery:sierpinski", "--blend", "gallery:kaleido",
                       "--time", "0.5", *SMALL, "-o", str(still)]) == 0
    assert still.stat().st_size > 0


@pytest.mark.parametrize("extra,frames", [([], 5), (["--no-harmonize"], 5),
                                          (["--loops", "1"], 11)])
def test_cli_sequence_has_no_doubled_junction_frame(tmp_path, extra,
                                                    frames):
    """Three keyframes at 3 fps over 2 s: two edges of 3 frames, the
    second without its first (the junction pose), so 5 and not 6; a
    loop segment per keyframe makes five segments of 3 frames, 11."""
    xml = "<flames>%s%s%s</flames>" % tuple(
        genome_to_flame_xml(get_genome(n))
        for n in ("sierpinski", "classic_swirl", "sierpinski"))
    p = tmp_path / "seq3.flam3"
    p.write_text(xml)
    out = tmp_path / "seq3.y4m"
    duration = "2" if not extra or extra[0] != "--loops" else "5"
    assert tmain.main([str(p), "-o", str(out), "--animate", *SMALL,
                       "--fps", "3", "--duration", duration, *extra]) == 0
    assert _n_frames(out) == frames


@pytest.mark.parametrize("flag", [["--time", "0.5"],
                                  ["--save-hist", "h.npy"],
                                  ["--resume-hist", "h.npy"]])
def test_cli_animate_refuses_still_only_flags(flag):
    with pytest.raises(SystemExit, match="apply to stills"):
        tmain.main(["gallery:sierpinski", "--cpu", "--animate", *flag])


def test_cli_temporal_samples_on_a_still(tmp_path, capsys):
    """A still with motion blur renders (it used to end in a traceback)."""
    out = tmp_path / "s.png"
    assert tmain.main(["gallery:animated_spark", "--temporal-samples", "4",
                       "--time", "0.5", *SMALL, "-o", str(out)]) == 0
    assert out.stat().st_size > 0
    assert f"wrote {out}" in capsys.readouterr().out


def test_cli_animate_without_gpu_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts "
                    "without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain.main(["gallery:animated_spark", "--animate", "-o",
                    str(tmp_path / "a.y4m")])
