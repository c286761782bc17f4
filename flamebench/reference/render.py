"""The plain frame pipeline that the benchmark holds the program to.

Given a gallery genome, the render settings, a frame time and a seed,
it works the frame out again from nothing the program made: the
genome's parameters (`specs.Genome.eval_at`, or the packed-knot
interpolator of `interp.py` for a motion-blurred frame), the starting
trajectories from the seed, the chaos game one eager step at a time
(`iterate_step`), every plotted point added into a float64 histogram
with `index_add_`, and the filter chain (log density, density
estimation, downsample, colorclip) down to the u8 frame.

The modules beside this one are frozen copies of the plain versions in
`cuburn_tpu_torch` (genome layer, variations, camera, RNG, filter),
with their imports pointed here; the loop and the accumulation below
follow `cuburn_tpu_torch/ops/iterate.py` and `render.py`.  Nothing here
imports the program.  The conventions copied with them: a frame's
seed s starts its trajectories from `torch.Generator().manual_seed(s *
7919)`, the batch shrinks for short frames (`batch_for`), a sample
runs whole flushes of `steps_per_flush` steps, and the palette
coordinate of a plotted point is quantized to 2^8 levels (flam3's
256-entry palette).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from flamebench.reference import de as de_mod
from flamebench.reference import rng as rng_mod
from flamebench.reference.camera import CameraSpec, project, project_3d
from flamebench.reference.filtering import (colorclip, downsample, logscale,
                                            spatial_filter_taps, to_u8)
from flamebench.reference.gallery import get_genome
from flamebench.reference.interp import pack_genome, sample_params
from flamebench.reference.specs import GenomeParams
from flamebench.reference.xform import (apply_final_xform, apply_xforms,
                                        build_xform_table, select_and_fetch)

BADVALUE_LIMIT = float(np.float32(1e10))
_INV24 = 1.0 / (1 << 24)
MASK32 = rng_mod.MASK32
SEED_MULTIPLIER = 7919
COLOR_LEVELS_BITS = 8


@dataclass(frozen=True)
class Settings:
    """How a frame is rendered: the configuration's render fields and
    the flush length the sample's steps come in whole multiples of."""
    width: int
    height: int
    ss: int
    quality: int
    fuse: int
    batch: int
    de_enabled: bool
    transparent: bool
    fps: float
    temporal_samples: int
    steps_per_flush: int
    duration: float | None = None

    @property
    def total_iters(self) -> int:
        return self.quality * self.width * self.height


@dataclass
class IterState:
    x: torch.Tensor
    y: torch.Tensor
    color: torch.Tensor
    last_xf: torch.Tensor
    age: torch.Tensor
    rng: torch.Tensor


@dataclass
class FrameResult:
    """The reference's frame: u8 (H, W, 3), the points it plotted, and
    the accumulator bins they touched."""
    image: np.ndarray
    plotted: int
    touched_bins: int


def params_on(params: GenomeParams, device) -> GenomeParams:
    return GenomeParams(**{
        f.name: torch.as_tensor(
            np.array(getattr(params, f.name), np.float32), device=device)
        for f in dataclasses.fields(GenomeParams)})


def init_state(seed: int, batch: int, device) -> IterState:
    gen = torch.Generator().manual_seed(seed * SEED_MULTIPLIER)
    xy = torch.rand((2, batch), generator=gen) * 2.0 - 1.0
    color = torch.rand((batch,), generator=gen)
    rng = rng_mod.seed(gen, batch, device)
    zeros = torch.zeros((batch,), dtype=torch.int64, device=device)
    return IterState(x=xy[0].to(device), y=xy[1].to(device),
                     color=color.to(device), last_xf=zeros,
                     age=zeros.clone(), rng=rng)


def xform_cdf_rows(params) -> torch.Tensor:
    probs = torch.clamp(params.weights[None, :], min=0.0) \
        * torch.clamp(params.xaos, min=0.0)
    row_sum = probs.sum(dim=1, keepdim=True)
    probs = torch.where(row_sum > 0, probs, 1.0)
    cdf = torch.cumsum(probs, dim=1)
    total = torch.clamp(cdf[:, -1:], min=float(np.float32(1e-20)))
    return cdf / total


def palette_rgb(palette, color):
    f = torch.clamp(color, 0.0, 1.0) * 255.0
    i0 = torch.floor(f).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=255)
    frac = (f - i0.to(torch.float32))[..., None]
    return palette[i0] * (1.0 - frac) + palette[i1] * frac


def expand_palette(palette, color_bits: int):
    n = 1 << color_bits
    coords = torch.arange(n - 1, dtype=torch.float32,
                          device=palette.device) \
        * float(np.float32(1.0 / (n - 1)))
    coords = torch.cat([coords, coords.new_ones((1,))])
    return palette_rgb(palette, coords)


def quantize_color(color_bits: int, pcolor):
    levels = float((1 << color_bits) - 1)
    return (torch.clamp(pcolor, 0.0, 1.0) * levels + 0.5).to(torch.int64)


def _mul32(a, m: int):
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def respawn_xy(bits):
    h1 = _mul32(bits, 0x9E3779B9)
    h1 = h1 ^ (h1 >> 15)
    h2 = _mul32(bits ^ 0x5BD1E995, 0xC2B2AE35)
    h2 = h2 ^ (h2 >> 13)
    rx = (h1 >> 8).to(torch.float32) * _INV24 * 2.0 - 1.0
    ry = (h2 >> 8).to(torch.float32) * _INV24 * 2.0 - 1.0
    return rx, ry


def iterate_step(key, cam: CameraSpec, fuse: int, params, cdf_rows, ppu,
                 state: IterState, table):
    """One chaos-game step of every trajectory: (new state, address
    (junk bin where not plotted), palette coordinate, opacity)."""
    stream = rng_mod.RngStream(state.rng)
    bits = stream.bits()
    u = (bits >> 8).to(torch.float32) * _INV24
    idx, prow = select_and_fetch(key, cdf_rows, table, state.last_xf, u)
    nx, ny, ncolor, opacity = apply_xforms(
        key, params, prow, state.x, state.y, state.color, stream)
    bad = ~(torch.isfinite(nx) & torch.isfinite(ny)) \
        | (torch.abs(nx) > BADVALUE_LIMIT) \
        | (torch.abs(ny) > BADVALUE_LIMIT)
    rx, ry = respawn_xy(bits)
    nx = torch.where(bad, rx, nx)
    ny = torch.where(bad, ry, ny)
    ncolor = torch.where(bad, u, ncolor)
    age = torch.where(bad, 0, state.age + 1)
    px, py, pcolor = apply_final_xform(key, params, nx, ny, ncolor, stream)
    if key.cam_mode:
        if key.cam_mode >= 2:
            px, py = project_3d(params.cam3d, px, py,
                                stream.uniform(), stream.uniform())
        else:
            px, py = project_3d(params.cam3d, px, py)
    addr, in_bounds = project(cam, params.center, ppu, params.rotate,
                              px, py, rot_center=params.rot_center)
    visible = (age >= fuse) & in_bounds & (opacity > 0.0)
    addr = torch.where(visible, addr, cam.junk_bin)
    return (IterState(x=nx, y=ny, color=ncolor, last_xf=idx, age=age,
                      rng=stream.state), addr, pcolor, opacity)


def temporal_filter_weights(n: int, ftype: str = "box", width: float = 1.0,
                            filter_exp: float = 0.0):
    """flam3's create_temporal_filter: (offsets, weights, mean weight)."""
    i = np.arange(n, dtype=np.float64)
    deltas = (i / n - 0.5) * width
    if n <= 1:
        return np.zeros(1), np.ones(1), 1.0
    if ftype in ("gaussian", "gauss"):
        half = n / 2.0
        x = 1.5 * np.abs(i - half) / half
        w = np.exp(-2.0 * x * x)
    elif ftype == "exp":
        slpx = (i + 1.0) / n if filter_exp >= 0 else (n - i) / n
        w = slpx ** abs(filter_exp)
    elif ftype == "box":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown temporal filter type {ftype!r}")
    w = w / w.max()
    return deltas, w, float(w.mean())


def _spline_range_max(sp, time_range) -> float:
    t0, t1 = time_range
    if sp.is_constant or t1 <= t0:
        return float(sp(t0))
    return float(np.max(sp.evaluate(np.linspace(t0, t1, 33))))


class Frames:
    """The reference renderer of one genome under one set of
    settings."""

    def __init__(self, genome_name: str, settings: Settings, device):
        self.genome = get_genome(genome_name)
        self.s = settings
        self.device = torch.device(device)
        g, s = self.genome, settings
        self.key = g.structure_key()
        self.static_de_r = _spline_range_max(g.estimator_radius,
                                             g.time_range) * s.ss
        self.static_sf = _spline_range_max(g.spatial_filter, g.time_range)
        gutter = (int(np.ceil(1.5 * min(self.static_de_r,
                                        de_mod.MAX_RADIUS_CAP)))
                  if (s.de_enabled and self.static_de_r > 0) else 0)
        if self.static_sf > 0:
            gutter += (spatial_filter_taps(g.spatial_filter_shape,
                                           self.static_sf, s.ss).shape[0]
                       - s.ss) // 2
        no_rot = g.rotate.is_constant and g.rotate(0.0) == 0.0
        self.cam = CameraSpec(s.width, s.height, s.ss, no_rotation=no_rot,
                              gutter=gutter)
        addr_bits = int(np.ceil(np.log2(self.cam.n_bins + 2)))
        if addr_bits + COLOR_LEVELS_BITS > 32:
            raise ValueError("the reference quantizes the palette "
                             "coordinate to 8 bits beside a 24-bit address")
        self._packed = None

    # -- genome time ------------------------------------------------------

    def frame_times(self) -> List[float]:
        t0, t1 = self.genome.time_range
        span = (self.s.duration if self.s.duration is not None
                else t1 - t0)
        n = max(1, int(round(span * self.s.fps)))
        return [t0 + (t1 - t0) * (i / max(n - 1, 1)) if n > 1 else t0
                for i in range(n)]

    def _frame_dt(self) -> float:
        t0, t1 = self.genome.time_range
        n = len(self.frame_times())
        if n > 1:
            return (t1 - t0) / (n - 1)
        return (t1 - t0) if t1 > t0 else 1.0 / self.s.fps

    def _temporal(self, t: float):
        n = self.s.temporal_samples
        g = self.genome
        if n <= 1:
            return [t], np.ones(1), 1.0
        deltas, w, sumfilt = temporal_filter_weights(
            n, g.temporal_filter_type, float(g.temporal_filter_width(t)),
            float(g.temporal_filter_exp(t)))
        dt = self._frame_dt()
        return [t + float(d) * dt for d in deltas], w, sumfilt

    def batch_for(self, iters: float) -> int:
        batch = self.s.batch
        min_life = 8 * max(self.s.fuse, 1)
        while batch > 1024 and iters / batch < min_life:
            batch //= 2
        return batch

    # -- the chaos game and the histogram ----------------------------------

    def _run(self, params, state, hist, ppu, steps: int, weight: float):
        key, cam = self.key, self.cam
        if any(float(o) != 1.0 for o in params.opacity.tolist()):
            raise ValueError("the reference plots unit opacities only")
        cdf = xform_cdf_rows(params)
        table = build_xform_table(key, params)
        pal = expand_palette(params.palette, COLOR_LEVELS_BITS) \
            .to(torch.float64)
        plotted = 0
        for _ in range(steps):
            state, addr, pcolor, _op = iterate_step(
                key, cam, self.s.fuse, params, cdf, ppu, state, table)
            rgba = torch.cat([pal[quantize_color(COLOR_LEVELS_BITS, pcolor)],
                              torch.ones_like(pcolor, dtype=torch.float64)
                              [:, None]], dim=1)
            hist.index_add_(0, addr, rgba if weight == 1.0
                            else rgba * weight)
            plotted += int((addr != cam.junk_bin).sum())
        return state, plotted

    def accumulate(self, t: float, seed: int):
        """The frame's float64 histogram (n_bins+1, 4) with the junk
        bin last, and its plotted count."""
        s, g, cam = self.s, self.genome, self.cam
        hist = torch.zeros((cam.n_bins + 1, 4), dtype=torch.float64,
                           device=self.device)
        times, weights, _sumfilt = self._temporal(t)
        scale = float(np.float32(s.width / g.size[0]))
        if len(times) == 1:
            params = params_on(g.eval_at(times[0]), self.device)
            batch = self.batch_for(s.total_iters)
            steps = self._steps(s.total_iters, batch)
            state = init_state(seed, batch, self.device)
            _state, plotted = self._run(params, state, hist,
                                        params.ppu * scale, steps, 1.0)
            return hist, plotted
        if self._packed is None:
            self._packed = pack_genome(g, self.device)
        params_T = self._packed.eval_params(np.asarray(times, np.float32))
        per_sample = s.total_iters / len(times)
        batch = self.batch_for(per_sample * len(times))
        steps = self._steps(per_sample, batch)
        state = init_state(seed, batch, self.device)
        plotted = 0
        for k, w in enumerate(np.asarray(weights, np.float32)):
            params_k = sample_params(params_T, k)
            state, n = self._run(params_k, state, hist,
                                 params_T.ppu[k] * scale, steps, float(w))
            plotted += n
        return hist, plotted

    def _steps(self, iters: float, batch: int) -> int:
        per_flush = batch * self.s.steps_per_flush
        return max(1, int(np.ceil(iters / per_flush))) \
            * self.s.steps_per_flush

    # -- the filter ---------------------------------------------------------

    def finalize(self, hist, t: float) -> np.ndarray:
        """logscale -> DE -> downsample -> colorclip -> u8 (H, W, 3)."""
        s, g, cam = self.s, self.genome, self.cam
        host = g.eval_at(t)
        params = params_on(host, self.device)
        _times, _w, sumfilt = self._temporal(t)
        q_cell = torch.tensor(np.float32(s.quality * sumfilt
                                         / (cam.ss * cam.ss)),
                              device=self.device)
        de_on = s.de_enabled and float(host.estimator_radius) > 0.0
        img = hist[:-1].to(torch.float32).reshape(cam.acc_height,
                                                  cam.acc_width, 4)
        raw_density = img[..., 3]
        img = logscale(img, params.brightness, q_cell)
        if de_on:
            img = de_mod.density_filter(
                img, raw_density, params.estimator_radius * cam.ss,
                params.estimator_minimum * cam.ss, params.estimator_curve,
                static_max_radius=(self.static_de_r if self.static_de_r > 0
                                   else 9.0))
        clip = dict(gamma=params.gamma, vibrancy=params.vibrancy,
                    highlight_power=params.highlight_power,
                    gamma_threshold=params.gamma_threshold,
                    background=params.background,
                    transparent=s.transparent)
        ds = dict(ss=cam.ss, spatial_filter=self.static_sf,
                  filter_shape=g.spatial_filter_shape,
                  gutter=(cam.gutter, cam.gutter))
        if g.earlyclip:
            img = torch.clamp(downsample(colorclip(img, **clip), **ds),
                              0.0, 1.0)
        else:
            img = colorclip(downsample(img, **ds), **clip)
        return to_u8(img)[..., :3].cpu().numpy()

    def render(self, t: float, seed: int) -> FrameResult:
        hist, plotted = self.accumulate(t, seed)
        touched = int((hist[:-1, 3] > 0).sum())
        image = self.finalize(hist, t)
        return FrameResult(image=image, plotted=plotted,
                           touched_bins=touched)


def render_frames(genome_name: str, settings: Settings,
                  frames: Sequence[Tuple[float, int]],
                  device) -> List[FrameResult]:
    """Every (time, seed) of `frames`, one after the other."""
    ref = Frames(genome_name, settings, device)
    return [ref.render(t, seed) for t, seed in frames]
