"""Parity of the port's filter stage with the JAX package's.

Contracts: the float stages (logscale, colorclip, downsample, density
estimation) agree within float32 rounding of convolutions summed in
another order; the u8 frame of `_filter_frame` on one JAX-made
logical histogram agrees within 1 LSB, with density estimation off,
on, and with the pyramid path forced.  The pyramid gate is read while
JAX traces `_filter_frame`, so each case uses a camera shape no other
test traces.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu.models import full_feature  # noqa: E402
from cuburn_tpu.ops import de as jde  # noqa: E402
from cuburn_tpu.ops import filtering as jfl  # noqa: E402
from cuburn_tpu.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.ops import de as tde  # noqa: E402
from cuburn_tpu_torch.ops import filtering as tfl  # noqa: E402

T = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _img(seed, h=30, w=34, sparse=0.5):
    rs = np.random.RandomState(seed)
    img = rs.rand(h, w, 4).astype(np.float32) * 3.0
    img *= rs.binomial(1, sparse, (h, w, 1)).astype(np.float32)
    img[..., 3] = np.exp(rs.rand(h, w) * 7).astype(np.float32) \
        * (img[..., 3] > 0)
    return img


def test_logscale_matches():
    hist = _img(0)
    j = jfl.logscale(jnp.asarray(hist), jnp.float32(4.0),
                     jnp.float32(12.5))
    t = tfl.logscale(T(hist), torch.tensor(4.0), torch.tensor(12.5))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6,
                               atol=1e-7)


@pytest.mark.parametrize("hp,vib,transparent", [
    (-1.0, 1.0, False), (1.0, 0.6, False), (0.5, 0.2, True),
    (-0.4, 0.8, True)])
def test_colorclip_matches(hp, vib, transparent):
    img = np.array(jfl.logscale(jnp.asarray(_img(1)), jnp.float32(4.0),
                                jnp.float32(2.0)))
    args = dict(gamma=4.0, vibrancy=vib, highlight_power=hp,
                gamma_threshold=0.01)
    bg = np.array([0.1, 0.2, 0.05], np.float32)
    j = jfl.colorclip(jnp.asarray(img),
                      *(jnp.float32(args[k]) for k in args),
                      jnp.asarray(bg), transparent)
    t = tfl.colorclip(T(img), *(torch.tensor(args[k]) for k in args),
                      T(bg), transparent)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=2e-6)


def test_spatial_filter_taps_equal():
    assert set(tfl.SPATIAL_FILTERS) == set(jfl.SPATIAL_FILTERS)
    for shape in jfl.SPATIAL_FILTERS:
        for radius, ss in ((0.5, 1), (0.5, 2), (1.3, 2), (2.0, 3)):
            try:
                want = jfl.spatial_filter_taps(shape, radius, ss)
            except ValueError:
                # a degenerate filter is refused by both packages
                with pytest.raises(ValueError, match="degenerate"):
                    tfl.spatial_filter_taps(shape, radius, ss)
                continue
            np.testing.assert_array_equal(
                tfl.spatial_filter_taps(shape, radius, ss), want)


@pytest.mark.parametrize("ss,radius,shape,gutter", [
    (1, 0.0, "gaussian", 0), (2, 0.0, "gaussian", 4),
    (1, 0.5, "gaussian", 2), (2, 0.5, "gaussian", 6),
    (2, 1.0, "mitchell", (1, 3)), (3, 0.7, "lanczos3", 3)])
def test_downsample_matches(ss, radius, shape, gutter):
    img = _img(2, h=36, w=42)
    j = jfl.downsample(jnp.asarray(img), ss, radius, shape,
                       gutter=gutter)
    t = tfl.downsample(T(img), ss, radius, shape, gutter=gutter)
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pyramid", [False, True])
def test_density_filter_matches(pyramid, monkeypatch):
    if pyramid:
        monkeypatch.setattr(jde, "PYRAMID_MIN_WIDTH", 0)
        monkeypatch.setattr(tde, "PYRAMID_MIN_WIDTH", 0)
    img, dens = _img(3), np.exp(np.random.RandomState(4).rand(30, 34)
                                * 8).astype(np.float32)
    est = (9.0, 0.0, 0.4)
    j = jde.density_filter(jnp.asarray(img), jnp.asarray(dens),
                           *(jnp.float32(v) for v in est),
                           static_max_radius=9.0)
    t = tde.density_filter(T(img), T(dens),
                           *(torch.tensor(v) for v in est),
                           static_max_radius=9.0)
    scale = float(np.abs(np.asarray(j)).max())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6 * scale)
    assert tde.band_ladder(9.0) == jde.band_ladder(9.0)


@pytest.mark.parametrize("case,width,height", [
    ("de_off", 38, 26), ("de_on", 44, 30), ("pyramid", 46, 34)])
def test_filter_frame_u8_within_1lsb(case, width, height, monkeypatch):
    """`_filter_frame` of both packages on one JAX-rendered logical
    histogram: u8 within 1 LSB."""
    if case == "pyramid":
        monkeypatch.setattr(jde, "PYRAMID_MIN_WIDTH", 0)
        monkeypatch.setattr(tde, "PYRAMID_MIN_WIDTH", 0)
    g = full_feature()
    prof = RenderProfile(width=width, height=height, ss=2, quality=60,
                         batch=2048, iters_per_chunk=16, fuse=16,
                         hist_backend="scatter",
                         de_enabled=case != "de_off")
    jr = jrender.Renderer(g, prof)
    tr = trender.Renderer(g, prof, device="cpu")
    assert dataclasses.astuple(tr.cam) == dataclasses.astuple(jr.cam)
    hist, _ = jr.accumulate(0.0, seed=3)
    hist = np.array(hist)
    assert hist[:-1, 3].sum() > 0
    j = np.asarray(jr.finalize_frame(hist, 0.0)).astype(np.int32)
    t = tr.finalize_frame(hist, 0.0).astype(np.int32)
    assert t.shape == j.shape == (height, width, 4)
    assert np.abs(t - j).max() <= 1
    assert (t[..., :3] > 0).mean() > 0.05
