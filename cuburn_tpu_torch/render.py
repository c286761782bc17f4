"""The frame pipeline: genome + profile -> rendered frames.

Port of `cuburn_tpu/render.py` for one device.  Per frame:

  evaluate the genome at the frame time                 [host]
    (motion blur: at the T shutter times, by the packed-knot
    interpolator of ops/interp.py on the device)
  chaos game in chunks, each chunk flushed into the histogram
    (`iterate_accumulate`; on a GPU a chunk is one launch of the
    chaos-game kernel and the flush is a CUDA kernel too; a temporal
    sample's flushes carry its filter weight)
  logscale -> density estimation -> downsample -> colorclip -> u8
  u8 readback                                           [host]

Frames past what one whole-frame pass should hold split it: striped
accumulation (`accumulate_striped`) runs the chaos game once per
horizontal stripe of the accumulator, each into its own small
histogram, and banded filtering (`finalize_frame_banded`) filters
horizontal bands with enough context rows.  A frame whose records do
not pack into 32 bits (past 2^24 bins, the `4k` profile) accumulates
full (addr, rgba) records through `scatter`.

The histogram a caller sees is the logical (n_bins+1, 4) float32
tensor on the device; it is also the checkpoint format shared with the
JAX package.  The `pallas_rgb16` backend accumulates into its split
layout (f32 density, bf16 rgb) and converts at the edges.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cuburn_tpu_torch import retune
from cuburn_tpu_torch.device import resolve_device
from cuburn_tpu_torch.genome.specs import Genome
from cuburn_tpu_torch.ops import chaos
from cuburn_tpu_torch.ops import de as de_mod
from cuburn_tpu_torch.ops import histogram as hist_mod
from cuburn_tpu_torch.ops.camera import CameraSpec
from cuburn_tpu_torch.ops.interp import pack_genome
from cuburn_tpu_torch.ops.filtering import (colorclip, downsample,
                                            logscale,
                                            spatial_filter_taps, to_u8)
from cuburn_tpu_torch.ops.histogram import (hist_alloc_for, hist_to_layout,
                                            hist_to_logical)
from cuburn_tpu_torch.ops.iterate import (color_bits_for, init_state,
                                          iterate_accumulate,
                                          iterate_accumulate_temporal,
                                          opacity_bits_for,
                                          xform_cdf_rows)
from cuburn_tpu_torch.params import params_from_genome
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.utils import trace
from cuburn_tpu_torch.utils.timing import sync


def _spline_range_max(sp, time_range) -> float:
    """Max of a genome spline over the render's time range (33-point
    sample + both endpoints), so static filter geometry covers every
    frame."""
    t0, t1 = time_range
    if sp.is_constant or t1 <= t0:
        return float(sp(t0))
    ts = np.linspace(t0, t1, 33)
    return float(np.max(sp.evaluate(ts)))


def temporal_filter_weights(n: int, ftype: str = "box",
                            width: float = 1.0,
                            filter_exp: float = 0.0):
    """flam3's create_temporal_filter (flam3.c): per-temporal-sample
    shutter offsets and contribution weights.

    Returns (deltas (n,), weights (n,), sumfilt):
      deltas   -- sample times in frame-interval units, centered on the
                 frame time: (i/n - 0.5) * width  (flam3's exact rule)
      weights  -- filter values normalized so max == 1; each sample's
                 histogram contribution is scaled by its weight
      sumfilt  -- mean weight: the factor flam3 folds into k2 so overall
                 brightness is independent of the filter shape
    """
    i = np.arange(n, dtype=np.float64)
    deltas = (i / n - 0.5) * width
    if n <= 1:
        return np.zeros(1), np.ones(1), 1.0
    if ftype in ("gaussian", "gauss"):
        half = n / 2.0
        # flam3 evaluates its gaussian spatial kernel (support 1.5,
        # exp(-2x^2)) at 1.5*|i-half|/half; the sqrt(2/pi) prefactor
        # cancels under max-normalization
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


@dataclass
class FrameStats:
    """Per-frame observability record.  `chunks` (chunks run),
    `records` (records flushed), `launches` (hand-written kernels
    launched), `syncs` (host waits for the stream) and `uploads`
    (host-to-device copies queued without a wait) count the frame's
    own work, its readback included (utils/trace.py)."""
    plotted_samples: int = 0
    total_iters: int = 0
    iterate_s: float = 0.0
    filter_s: float = 0.0
    chunks: int = 0
    records: int = 0
    launches: int = 0
    syncs: int = 0
    uploads: int = 0

    def count(self, counted: dict) -> None:
        """Add what `trace.since` counted to the frame's counters."""
        self.chunks += counted["chunks"]
        self.records += counted["records"]
        self.launches += counted["launches"]
        self.syncs += counted["syncs"]
        self.uploads += counted["uploads"]

    @property
    def retention(self) -> float:
        return self.plotted_samples / max(self.total_iters, 1)

    @property
    def samples_per_sec(self) -> float:
        return self.plotted_samples / max(self.iterate_s, 1e-9)


def _filter_frame(cam: CameraSpec, transparent: bool, de_on: bool,
                  hist, params, quality_per_cell,
                  de_static_r: float = 9.0,
                  spatial_filter: float = 0.0,
                  filter_shape: str = "gaussian",
                  earlyclip: bool = False):
    """logscale -> DE -> downsample -> colorclip -> u8 on a logical
    histogram without its junk bin.  Returns the u8 frame, rgb only
    for opaque output."""
    u8 = _filter_band(
        hist.reshape(cam.acc_height, cam.acc_width, 4), params,
        quality_per_cell, cam.ss, cam.gutter, cam.gutter, transparent,
        de_on, de_static_r, spatial_filter, filter_shape,
        earlyclip=earlyclip)
    return u8 if transparent else u8[..., :3]


def band_margin(de_on: bool, de_r: float, spatial_filter: float,
                filter_shape: str, ss: int) -> int:
    """Context rows a band needs above and below: 1.5x the (capped)
    static DE radius plus the spatial filter's half-width, plus one,
    rounded up to a multiple of ss."""
    de_half = (int(np.ceil(1.5 * min(max(de_r, 0.0),
                                     de_mod.MAX_RADIUS_CAP)))
               if de_on else 0)
    pad = 0
    if spatial_filter > 0:
        pad = (spatial_filter_taps(filter_shape, spatial_filter,
                                   ss).shape[0] - ss) // 2
    return ss * int(np.ceil((de_half + pad + 1) / ss))


def _filter_band(hist_band, params, quality_per_cell, ss: int,
                 margin: int, gutter_x: int, transparent: bool,
                 de_on: bool, de_static_r: float, spatial_filter: float,
                 filter_shape: str, skip_empty: bool = False,
                 earlyclip: bool = False, de_rows=(0, 0)):
    """logscale -> DE -> downsample -> colorclip -> u8 on an
    (rows, acc_w, 4) accumulator image (earlyclip swaps the last two
    stages, flam3's pre-2008 order).  `margin` rows above and below and
    `gutter_x` columns on each side are context that the downsample
    drops: a whole frame's gutter, or a band's context rows.  `de_rows`
    (top, bottom) are further rows that only the DE reads, dropped
    after it.  Every stage is local (the DE's reach, the spatial
    filter's half-width), so a band with enough context rows gives the
    whole-frame filter's rows up to float reassociation.  Returns u8
    rgba.  Each stage is a span of its own (`logscale`, `de`,
    `downsample`, `colorclip`), nested in `filter` on the whole-frame
    path (finalize_frame_device) and once a band on the banded one."""
    img = hist_band
    raw_density = img[..., 3]
    with trace.span("logscale"):
        img = logscale(img, params.brightness, quality_per_cell)
    if de_on:
        with trace.span("de"):
            img = de_mod.density_filter(
                img, raw_density,
                params.estimator_radius * ss,
                params.estimator_minimum * ss,
                params.estimator_curve,
                static_max_radius=de_static_r,
                skip_empty=skip_empty)
    img = img[de_rows[0]:img.shape[0] - de_rows[1]]
    if earlyclip:
        with trace.span("colorclip"):
            img = colorclip(
                img, params.gamma, params.vibrancy, params.highlight_power,
                params.gamma_threshold, params.background, transparent)
        with trace.span("downsample"):
            img = downsample(img, ss, spatial_filter, filter_shape,
                             gutter=(margin, gutter_x))
        img = torch.clamp(img, 0.0, 1.0)
    else:
        with trace.span("downsample"):
            img = downsample(img, ss, spatial_filter, filter_shape,
                             gutter=(margin, gutter_x))
        with trace.span("colorclip"):
            img = colorclip(
                img, params.gamma, params.vibrancy, params.highlight_power,
                params.gamma_threshold, params.background, transparent)
    return to_u8(img)


def _merge_stripe(full, stripe, row0: int, rows: int, acc_w: int):
    """Add a stripe's logical histogram rows [0, rows) into the full
    histogram at row offset row0, in place; returns full.  The last
    stripe's rows past `rows` lie beyond the frame and are left out,
    as the whole-frame render's bounds test leaves those points out."""
    n = rows * acc_w
    full[row0 * acc_w:row0 * acc_w + n] += stripe[:n]
    return full


def stripe_cameras(cam: CameraSpec, n_stripes: int):
    """The camera of every stripe of `cam`'s accumulator cut into
    n_stripes horizontal stripes of ceil(acc_h / n_stripes) rows.  A
    stripe projects in full-frame coordinates (`tile_row0`) and packs
    its records at the full frame's depth (`layout_bins`); the last
    stripe's camera ends at the frame's last row, and a stripe that
    would start past the last row is left out."""
    full_h = cam.acc_height
    th = -(-full_h // n_stripes)
    return [dataclasses.replace(cam, tile_row0=s * th, full_acc_height=full_h,
                                tile_acc_height=min(th, full_h - s * th))
            for s in range(-(-full_h // th))]


@dataclass(frozen=True)
class BandLayout:
    """The accumulator rows each band of a banded filter reads.

    Band b is rows [r0, r1) of the accumulator: its band_rows with
    `margin` context rows above and below, which the downsample drops.
    Its DE reads rows [d0, r1 + ctx): where the DE takes the pyramid
    path, de_mod.band_context's rows above and below, d0 on a multiple
    of the pyramid's block height from the accumulator's row 0, as the
    whole frame's blocks lie (ctx 0 and d0 = r0 elsewhere).  `top` and
    `bottom` zero rows padded above and below the image hold every
    window."""
    margin: int
    ctx: int
    top: int
    bottom: int
    windows: Tuple[Tuple[int, int, int], ...]     # (d0, r0, r1) a band

    def window_rows(self, b: int) -> int:
        d0, _r0, r1 = self.windows[b]
        return r1 + self.ctx - d0

    @property
    def block_rows(self) -> int:
        """The longest window: every band's block when all the blocks
        take one shape."""
        return max(self.window_rows(b) for b in range(len(self.windows)))

    def pad(self, himg, extra: int = 0):
        """The (acc_h, acc_w, C) image with its zero rows (and `extra`
        more below); accumulator row r sits at r + top."""
        return F.pad(himg, (0, 0, 0, 0, self.top, self.bottom + extra))

    def blocks(self, himg):
        """(n_bands, block_rows, acc_w, C): band b's block starts at its
        d0 and runs block_rows rows, past its window where another
        window is longer."""
        rows = self.block_rows
        padded = self.pad(himg, rows - min(
            self.window_rows(b) for b in range(len(self.windows))))
        return torch.stack([padded[d0 + self.top:d0 + self.top + rows]
                            for d0, _r0, _r1 in self.windows])


def band_layout(n_bands: int, band_rows: int, margin: int, gutter: int,
                acc_h: int, acc_w: int, de_on: bool,
                de_static_r: float) -> BandLayout:
    """The rows of n_bands bands of band_rows accumulator rows each,
    the first starting at the gutter, with `margin` rows of context
    (band_margin) and, where the DE takes the pyramid path, its
    context too (de_mod.band_context)."""
    ctx, align = (de_mod.band_context(de_static_r, acc_w) if de_on
                  else (0, 1))
    need_h = gutter + n_bands * band_rows + 2 * margin
    windows = []
    for b in range(n_bands):
        r0 = gutter - margin + band_rows * b
        windows.append(((r0 - ctx) // align * align, r0,
                        r0 + band_rows + 2 * margin))
    return BandLayout(margin=margin, ctx=ctx, top=margin + ctx + align - 1,
                      bottom=max(0, need_h - margin - acc_h) + ctx,
                      windows=tuple(windows))


def _filter_window(rows, layout: BandLayout, b: int, params,
                   quality_per_cell, ss: int, gutter_x: int, **kw):
    """Band b of `layout` through _filter_band.  `rows` starts at the
    band's d0; rows past its window are left out.  `kw` are
    _filter_band's keywords (transparent, de_on, de_static_r,
    spatial_filter, filter_shape, earlyclip, skip_empty).  Returns
    (band_rows/ss, W, C) u8, C = 3 for opaque output, 4 for
    transparent."""
    d0, r0, _r1 = layout.windows[b]
    out = _filter_band(rows[:layout.window_rows(b)], params,
                       quality_per_cell, ss, layout.margin, gutter_x,
                       de_rows=(r0 - d0, layout.ctx), **kw)
    return out if kw["transparent"] else out[..., :3]


def _filter_banded_device(himg, layout: BandLayout, params, quality_per_cell,
                          ss: int, gutter_x: int, **kw):
    """Every band of `layout` on the device: the (acc_h, acc_w, 4)
    image padded as the layout says, then one _filter_window per band
    (`kw` as there).  Returns (n_bands, band_rows/ss, W, C) u8, C = 3
    for opaque output (alpha is the constant the host fills in), 4 for
    transparent."""
    padded = layout.pad(himg)
    return torch.stack([
        _filter_window(padded[d0 + layout.top:], layout, b, params,
                       quality_per_cell, ss, gutter_x, **kw)
        for b, (d0, _r0, _r1) in enumerate(layout.windows)])


def _with_alpha(img_np: np.ndarray) -> np.ndarray:
    """Pad an rgb-only u8 frame to RGBA (alpha=255)."""
    if img_np.shape[-1] == 3:
        out = np.empty(img_np.shape[:-1] + (4,), np.uint8)
        out[..., :3] = img_np
        out[..., 3] = 255
        return out
    return img_np


class Renderer:
    """Renders stills and animations of one genome under one profile
    on one device.

    `device` defaults to CUDA and raises when there is no GPU; the
    CPU runs only when asked for by name ("cpu").  The histogram
    backend is a name of `hist_mod.BACKENDS` or `auto`, resolved with
    the flush size by `retune.backend_and_flush`: `auto` is `atomic`
    on a GPU and `scatter` on the CPU unless a tune record for this GPU
    picks another.  Each `pallas*` backend launches its CUDA kernel on
    a GPU and runs the kernel's plain version on the CPU.  A frame
    whose records do not pack into 32 bits (`packed` False) accumulates
    full records through `scatter`, as the JAX package does."""

    def __init__(self, genome: Genome, profile: RenderProfile,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.genome = genome
        self._packed_genome = None      # built at the first blurred frame
        self.profile = profile
        self.key = genome.structure_key()
        if self.device.type == "cuda":
            # the key's chaos kernel: its build stays out of iterate_s
            chaos.load(self.key)
        no_rot = genome.rotate.is_constant and genome.rotate(0.0) == 0.0
        self._static_de_r = _spline_range_max(
            genome.estimator_radius, genome.time_range) * profile.ss
        self._static_sf = _spline_range_max(
            genome.spatial_filter, genome.time_range)
        if not genome.spatial_filter.is_constant:
            warnings.warn(
                "spatial_filter animates; the filter width is fixed "
                f"at the time-range maximum ({self._static_sf:.3g})")
        de_r0 = self._static_de_r
        # gutter: the DE support (1.5x the radius) plus the spatial
        # filter's half-width, so neither clips at the frame border
        gutter = (int(np.ceil(1.5 * min(de_r0, de_mod.MAX_RADIUS_CAP)))
                  if (profile.de_enabled and de_r0 > 0) else 0)
        if self._static_sf > 0:
            gutter += (spatial_filter_taps(
                genome.spatial_filter_shape, self._static_sf,
                profile.ss).shape[0] - profile.ss) // 2
        self.cam = CameraSpec(profile.width, profile.height, profile.ss,
                              no_rotation=no_rot, gutter=gutter)
        # packed u32 records: unit opacities pack addr+color; other
        # opacities fold the xform id into an opacity-extended palette
        # coordinate when the record fits 32 bits
        unit_op = all(xf.opacity.is_constant and xf.opacity(0.0) == 1.0
                      for xf in genome.xforms)
        self.op_bits = 0
        if unit_op:
            self.packed = color_bits_for(self.cam.n_bins) > 0
        else:
            ob, cb = opacity_bits_for(self.cam.n_bins,
                                      len(genome.xforms))
            self.packed = cb > 0
            self.op_bits = ob
        self.backend, iters = retune.backend_and_flush(
            profile, self.device, self.packed, self.cam.n_bins)
        self.profile = dataclasses.replace(profile, iters_per_chunk=iters)

    # -- frame rendering -------------------------------------------------

    def render_frame(self, t: float = 0.0, seed: int = 0,
                     hist0: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, FrameStats]:
        """Render one frame at genome time t.  Returns (u8 image
        (H, W, 4), FrameStats).  `hist0` resumes accumulation from a
        logical (n_bins+1, 4) histogram (pallas_rgb16 rounds its rgb
        to bf16 once, on the way into the split layout)."""
        hist, stats = self.accumulate(t, seed, hist0)
        img = self.finalize_frame(hist, t, stats)
        return img, stats

    def accumulate(self, t: float = 0.0, seed: int = 0,
                   hist0: Optional[np.ndarray] = None,
                   ) -> Tuple[torch.Tensor, FrameStats]:
        """Run the chaos game for one frame's quality budget; returns
        the logical (n_bins+1, 4) histogram on the device and stats.
        Ends in a device sync, so iterate_s is the true device time."""
        stats = FrameStats()
        before = trace.counters()
        t0 = time.perf_counter()
        hist, n_plot, n_iter = self.accumulate_async(t, seed, hist0)
        with trace.wait():
            stats.plotted_samples += int(n_plot)
        stats.total_iters += n_iter
        sync(self.device)
        stats.iterate_s = time.perf_counter() - t0
        stats.count(trace.since(before))
        return hist_to_logical(self.backend, hist, self.cam.n_bins), \
            stats

    def accumulate_async(self, t: float = 0.0, seed: int = 0,
                         hist0: Optional[np.ndarray] = None):
        """Queue one frame's accumulation without waiting for it.

        Returns (hist in the backend's layout, plotted-count device
        scalar, total_iters int).
        A `hist0` costs one readback of its mass, which is mixed into
        the seed so a resumed pass adds fresh samples instead of
        replaying the same trajectories."""
        prof, cam = self.profile, self.cam
        eff_seed = seed * 7919
        if hist0 is not None:
            hist = trace.upload(np.asarray(hist0, np.float32),
                                self.device).clone()
            if hist.shape != (cam.n_bins + 1, 4):
                raise ValueError(
                    f"resume histogram shape {tuple(hist.shape)} != "
                    f"{(cam.n_bins + 1, 4)}")
            with trace.wait():
                mass = int(min(float(hist[:, 3].sum()), 2.0 ** 62))
            eff_seed = (eff_seed ^ (mass * 0x9E3779B9)) & 0x7FFFFFFF
            hist = hist_to_layout(self.backend, hist)
        else:
            hist = hist_alloc_for(self.backend, cam.n_bins, self.device)
        ts_times, ts_weights, _sumfilt = self._temporal_times(t)
        if len(ts_times) == 1:
            params = self._params_at(ts_times[0])
            return self._accumulate_sample(params, hist, seed=eff_seed,
                                           iters=prof.total_iters)
        # motion blur: parameters of every temporal sample from the
        # packed-knot interpolator, contributions weighted by the
        # flam3 temporal filter
        return self._accumulate_temporal(
            ts_times, ts_weights, hist, seed=eff_seed,
            iters_per_sample=prof.total_iters / len(ts_times))

    def accumulate_striped(self, t: float = 0.0, seed: int = 0,
                           n_stripes: int = 4,
                           ) -> Tuple[torch.Tensor, FrameStats]:
        """accumulate(), as n_stripes horizontal stripes of the
        accumulator, each run into a histogram of its own rows.

        A stripe's camera projects in full-frame coordinates
        (`tile_row0`) and packs its records at the full frame's depth
        (`layout_bins`), so with the same seed the stripes partition
        the whole frame's trajectories exactly and the stitched
        histogram equals accumulate()'s.  Every stripe replays the
        whole trajectory stream: total_iters is n_stripes times the
        whole frame's.  The last stripe's camera ends at the frame's
        last row, so the plotted counts of the stripes add up to the
        whole frame's (the JAX package gives every stripe the same
        height and counts the points that land past the frame); a
        stripe that would start past the last row is not run.  The junk
        bin of the result stays 0.  Returns the logical (n_bins+1, 4)
        histogram on the device and stats; ends in a device sync."""
        prof, cam = self.profile, self.cam
        stats = FrameStats()
        before = trace.counters()
        full = hist_mod.alloc(cam.n_bins, self.device)
        ts_times, ts_weights, _sumfilt = self._temporal_times(t)
        t0 = time.perf_counter()
        for scam in stripe_cameras(cam, n_stripes):
            hist = hist_alloc_for(self.backend, scam.n_bins, self.device)
            if len(ts_times) == 1:
                params = self._params_at(ts_times[0])
                hist, n_plot, n_iter = self._accumulate_sample(
                    params, hist, seed=seed * 7919,
                    iters=prof.total_iters, cam=scam)
            else:
                hist, n_plot, n_iter = self._accumulate_temporal(
                    ts_times, ts_weights, hist, seed=seed * 7919,
                    iters_per_sample=prof.total_iters / len(ts_times),
                    cam=scam)
            h_log = hist_to_logical(self.backend, hist, scam.n_bins)
            _merge_stripe(full, h_log[:scam.n_bins], scam.tile_row0,
                          scam.acc_height, cam.acc_width)
            with trace.wait():
                stats.plotted_samples += int(n_plot)
            stats.total_iters += n_iter
        sync(self.device)
        stats.iterate_s = time.perf_counter() - t0
        stats.count(trace.since(before))
        return full, stats

    def finalize_frame(self, hist, t: float = 0.0,
                       stats: Optional[FrameStats] = None) -> np.ndarray:
        """logscale -> DE -> downsample -> colorclip a logical
        histogram into a u8 (H, W, 4) numpy frame."""
        before = trace.counters()
        t1 = time.perf_counter()
        img_dev = self.finalize_frame_device(hist, t)
        with trace.span("readback"):
            with trace.wait():
                img = img_dev.cpu()
            img = _with_alpha(img.numpy())
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
            stats.count(trace.since(before))
        return img

    def finalize_frame_device(self, hist, t: float = 0.0):
        """finalize_frame without the readback: the u8 frame as a
        device tensor, (H, W, 3) for opaque profiles (alpha is the
        constant the host fills in) and (H, W, 4) for transparent.  One
        `filter` span."""
        with trace.span("filter"):
            params, q_cell, kw = self._filter_inputs(t)
            hist = self._hist_on_device(hist)
            return _filter_frame(self.cam, hist=hist_mod.finalize(hist),
                                 params=params, quality_per_cell=q_cell,
                                 **kw)

    def _hist_on_device(self, hist) -> torch.Tensor:
        """A logical histogram as float32 on the device: uploaded (a
        counted upload) unless it is a tensor there already."""
        if isinstance(hist, torch.Tensor) \
                and hist.device.type == self.device.type:
            return hist.to(torch.float32)
        return trace.upload(hist, self.device, torch.float32)

    def _params_at(self, t: float):
        """The genome at `t` as device parameters: a `params` span."""
        with trace.span("params"):
            return params_from_genome(self.genome.eval_at(t), self.device)

    def _filter_inputs(self, t: float):
        """What every filter of the frame at `t` takes: (params on the
        device, quality per accumulator cell, the filter's keywords:
        transparent, de_on, de_static_r, spatial_filter, filter_shape,
        earlyclip).  One `params` span."""
        prof, cam = self.profile, self.cam
        with trace.span("params"):
            host_params = self.genome.eval_at(t)
            _times, _w, sumfilt = self._temporal_times(t)
            q_cell = trace.upload(
                np.float32(prof.quality * sumfilt / (cam.ss * cam.ss)),
                self.device)
            de_r = self._static_de_r
            return params_from_genome(host_params, self.device), q_cell, \
                dict(transparent=prof.transparent,
                     de_on=self._de_on(host_params),
                     de_static_r=de_r if de_r > 0 else 9.0,
                     spatial_filter=self._static_sf,
                     filter_shape=self.genome.spatial_filter_shape,
                     earlyclip=self.genome.earlyclip)

    def finalize_frame_banded(self, hist, t: float = 0.0,
                              stats: Optional[FrameStats] = None,
                              n_bands: int = 4,
                              skip_empty: Optional[bool] = None
                              ) -> np.ndarray:
        """finalize_frame as n_bands horizontal bands, each filtered
        with band_margin rows of context above and below (and, where
        the DE takes its pyramid path, de.band_context's rows for the
        DE), so only a band's images are live at once.  The output equals the
        whole-frame filter's up to float reassociation (<= 1 u8 step
        at rounding boundaries).  `skip_empty` (None: the
        CUBURN_DE_SKIP_EMPTY env var, "1" for on) skips empty DE rungs,
        one device sync each.  One device-to-host copy for all bands;
        an opaque frame's alpha is filled on the host."""
        prof, cam = self.profile, self.cam
        before = trace.counters()
        t1 = time.perf_counter()
        params, q_cell, kw = self._filter_inputs(t)
        H, W = prof.height, prof.width
        h_band, layout = self._band_layout(n_bands, kw["de_on"])
        if skip_empty is None:
            skip_empty = os.environ.get("CUBURN_DE_SKIP_EMPTY") == "1"
        himg = self._hist_on_device(hist)[:-1].reshape(
            cam.acc_height, cam.acc_width, 4)
        bands = _filter_banded_device(
            himg, layout, params, q_cell, cam.ss, cam.gutter,
            skip_empty=bool(skip_empty), **kw)
        with trace.wait():
            bands = bands.cpu().numpy()
        out = np.zeros((H, W, 4), np.uint8)
        if not prof.transparent:
            out[..., 3] = 255
        ch = bands.shape[-1]
        for b in range(n_bands):
            rows = min(h_band, H - b * h_band)
            if rows > 0:
                out[b * h_band:b * h_band + rows, :, :ch] = bands[b][:rows]
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
            stats.count(trace.since(before))
        return out

    def _de_on(self, host_params) -> bool:
        return (self.profile.de_enabled and
                float(host_params.estimator_radius) > 0.0)

    def _band_layout(self, n_bands: int, de_on: bool):
        """(output rows a band, band_layout of the frame in n_bands
        bands of ceil(H / n_bands) output rows)."""
        cam = self.cam
        h_band = -(-self.profile.height // n_bands)
        de_r = self._static_de_r
        margin = band_margin(de_on, de_r, self._static_sf,
                             self.genome.spatial_filter_shape, cam.ss)
        return h_band, band_layout(
            n_bands, h_band * cam.ss, margin, cam.gutter, cam.acc_height,
            cam.acc_width, de_on, de_r if de_r > 0 else 9.0)

    def frame_dt(self) -> float:
        """The per-frame genome-time step.  It matches frame_times()'s
        stepping, so the motion-blur shutter covers one inter-frame
        interval for any time_range span or explicit duration."""
        t0, t1 = self.genome.time_range
        n_frames = self._n_frames()
        if n_frames > 1:
            return (t1 - t0) / (n_frames - 1)
        # single frame: no inter-frame step exists; use the whole range
        # (or one nominal frame at fps for a still node)
        return (t1 - t0) if t1 > t0 else 1.0 / self.profile.fps

    def _n_frames(self) -> int:
        """Frames of the whole animation before `skip`; a sub-frame
        duration still renders one frame."""
        prof = self.profile
        t0, t1 = self.genome.time_range
        span = prof.duration if prof.duration is not None else t1 - t0
        return max(1, int(round(span * prof.fps)))

    def _temporal_times(self, t: float):
        """Genome evaluation times + flam3 temporal-filter weights for
        one frame's shutter.  Returns (times, weights (n,), sumfilt)."""
        n = self.profile.temporal_samples
        g = self.genome
        if n <= 1:
            return [t], np.ones(1), 1.0
        deltas, weights, sumfilt = temporal_filter_weights(
            n, g.temporal_filter_type,
            float(g.temporal_filter_width(t)),
            float(g.temporal_filter_exp(t)))
        dt = self.frame_dt()
        return [t + float(d) * dt for d in deltas], weights, sumfilt

    def _batch_for(self, iters: float) -> int:
        """The trajectory batch, capped so every point lives >= ~8x
        fuse iterations of the frame's `iters`; otherwise warmup
        dominates and retention craters."""
        batch = self.profile.batch
        min_life = 8 * max(self.profile.fuse, 1)
        while batch > 1024 and iters / batch < min_life:
            batch //= 2
        return batch

    def _trajectories(self, seed: int, batch: int):
        """The starting state of the batch's trajectories that this
        renderer runs: all of them on one device.  A `trajectories`
        span."""
        with trace.span("trajectories"):
            return init_state(torch.Generator().manual_seed(seed), batch,
                              self.device)

    def _sample_setup(self, params, seed: int, iters: float):
        """What the chaos game of one sample of ~`iters` iterations
        starts from: (state, selection CDF rows, ppu, n_chunks, records
        a chunk)."""
        prof = self.profile
        batch = self._batch_for(iters)
        per_chunk = batch * prof.iters_per_chunk
        ppu = params.ppu * float(np.float32(
            prof.width / self.genome.size[0]))
        return (self._trajectories(seed, batch), xform_cdf_rows(params),
                ppu, max(1, int(np.ceil(iters / per_chunk))), per_chunk)

    def _accumulate_sample(self, params, hist, seed: int, iters: float,
                           cam: Optional[CameraSpec] = None):
        """Run the chaos game for ~`iters` iterations into hist through
        `cam` (default the frame's camera; a stripe's for
        accumulate_striped).  The chaos game is a `sample` span."""
        prof = self.profile
        state, cdf_rows, ppu, n_chunks, per_chunk = self._sample_setup(
            params, seed, iters)
        with trace.span("sample"):
            _state, hist, plotted = iterate_accumulate(
                self.key, cam or self.cam, self.backend, params, cdf_rows,
                state, hist, ppu, n_chunks, prof.iters_per_chunk,
                prof.fuse, op_bits=self.op_bits, packed=self.packed)
        return hist, plotted, n_chunks * per_chunk

    def _temporal_setup(self, ts_times, ts_weights, seed: int,
                        iters_per_sample: float):
        """What the chaos game of a motion-blurred frame starts from:
        (params_T, ppu_T, the sample weights as Python floats, state,
        n_chunks a sample, records a chunk).  The batch is sized on the
        frame's iterations, not one sample's: the trajectories carry
        over between samples."""
        prof = self.profile
        with trace.span("params"):
            if self._packed_genome is None:
                self._packed_genome = pack_genome(self.genome, self.device)
            params_T = self._packed_genome.eval_params(
                np.asarray(ts_times, np.float32))
        ppu_T = params_T.ppu * float(np.float32(
            prof.width / self.genome.size[0]))
        batch = self._batch_for(iters_per_sample * len(ts_times))
        per_chunk = batch * prof.iters_per_chunk
        # Python floats: a flush takes its weight as a kernel argument
        weights = [float(w) for w in np.asarray(ts_weights, np.float32)]
        return (params_T, ppu_T, weights, self._trajectories(seed, batch),
                max(1, int(np.ceil(iters_per_sample / per_chunk))),
                per_chunk)

    def _accumulate_temporal(self, ts_times, ts_weights, hist,
                             seed: int, iters_per_sample: float,
                             cam: Optional[CameraSpec] = None):
        """Run the chaos game for ~`iters_per_sample` iterations at each
        of the T shutter times into hist through `cam` (as in
        _accumulate_sample), each sample's flushes scaled by its
        temporal-filter weight."""
        prof = self.profile
        params_T, ppu_T, weights, state, n_chunks, per_chunk = \
            self._temporal_setup(ts_times, ts_weights, seed,
                                 iters_per_sample)
        _state, hist, plotted = iterate_accumulate_temporal(
            self.key, cam or self.cam, self.backend, params_T, state, hist,
            ppu_T, n_chunks, prof.iters_per_chunk, prof.fuse,
            weights_T=weights, op_bits=self.op_bits, packed=self.packed)
        return hist, plotted, n_chunks * per_chunk * len(ts_times)

    # -- animation -------------------------------------------------------

    def frame_times(self):
        """(frame_index, genome_time) pairs frames() steps through
        (profile fps/skip over the genome's time range).  The index is
        the unskipped frame number, so a skip>1 preview renders the
        exact frames (same per-frame seed) of the full render."""
        t0, t1 = self.genome.time_range
        n_frames = self._n_frames()
        return [(i, t0 + (t1 - t0) * (i / max(n_frames - 1, 1))
                 if n_frames > 1 else t0)
                for i in range(0, n_frames, self.profile.skip)]

    def frames(self, seed: int = 0) -> Iterator[Tuple[np.ndarray,
                                                      FrameStats]]:
        """Yield (image, stats) across the genome's time range at
        profile fps, one frame finished before the next begins."""
        return self.frames_partitioned(seed=seed)

    def frames_overlapped(self, seed: int = 0
                          ) -> Iterator[Tuple[np.ndarray, FrameStats]]:
        """frames() with frame N's launches queued before frame N-1 is
        read back, so the host's wait for N-1's image and its encode
        run while the device works on N.

        Everything runs on the current stream.  A plain `.cpu()` of
        frame N-1 made after frame N's launches would wait for frame
        N too, so each frame's device-to-host copy (into pinned memory)
        and a CUDA event are queued right behind its own launches, and
        the yield waits on that event only.  Nothing else in a frame
        waits for the stream: its uploads are queued (`trace.upload`)
        and the interpolator reads nothing back.  On the CPU the same
        calls run in the same order with no events.

        Images are those of frames(): the same kernels on the same
        inputs in the same order.  They are bit-identical where the
        flush is (every backend on the CPU, `pallas_rgb16` on the
        card); the float atomics of the other CUDA flushes may round a
        sum's last bit differently between any two runs.  FrameStats
        differ: iterate_s is the
        dispatch-to-dispatch wall time, what an encoder waits for a
        frame, and filter_s the wait for the readback alone.  A frame's
        counters hold its own readback's wait, made after the next
        frame's launches."""
        pending = None
        t_prev = time.perf_counter()
        for i, t in self.frame_times():
            before = trace.counters()
            hist, n_plot, n_iter = self.accumulate_async(t, seed + i)
            logical = hist_to_logical(self.backend, hist,
                                      self.cam.n_bins)
            img_dev = self.finalize_frame_device(logical, t)
            queued = self._queue_readback(img_dev, n_plot) + (
                n_iter, trace.since(before))
            now = time.perf_counter()
            if pending is not None:
                yield self._resolve_pending(pending, now - t_prev)
            t_prev = now
            pending = queued
        if pending is not None:
            yield self._resolve_pending(
                pending, time.perf_counter() - t_prev)

    def _queue_readback(self, img_dev, n_plot):
        """Queue the copies of a frame's image and plotted count to the
        host behind the frame's launches.  Returns (image, count,
        event): pinned host tensors that are valid once the event has
        passed, or the CPU tensors themselves and no event.  A
        `readback` span."""
        if self.device.type != "cuda":
            return img_dev, n_plot, None
        with trace.span("readback"):
            host = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True) for v in (img_dev, n_plot)]
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return host[0], host[1], event

    @staticmethod
    def _resolve_pending(pending, wall_s: float):
        """The frame of `_queue_readback`'s (image, count, event) and
        (total_iters, counted since the frame began): a `readback` span
        whose wait for the event counts on the CPU too."""
        img_host, n_plot, event, n_iter, counted = pending
        stats = FrameStats()
        before = trace.counters()
        t1 = time.perf_counter()
        with trace.span("readback"):
            with trace.wait():
                if event is not None:
                    event.synchronize()
            img = img_host.numpy()
            # an RGBA frame is copied out of the pinned buffer, which
            # the allocator hands to a later frame
            img = _with_alpha(img) if img.shape[-1] == 3 else img.copy()
        stats.filter_s = time.perf_counter() - t1
        stats.plotted_samples = int(n_plot)
        stats.total_iters = int(n_iter)
        stats.iterate_s = wall_s
        stats.count(counted)
        stats.count(trace.since(before))
        return img, stats

    def frames_partitioned(self, seed: int = 0, n_stripes: int = 0,
                           n_bands: int = 0, overlap: bool = False
                           ) -> Iterator[Tuple[np.ndarray, FrameStats]]:
        """frames() through striped accumulation (n_stripes > 1) and/or
        banded filtering (n_bands > 1), frame after frame.  With
        neither it is frames(), and `overlap` switches to
        frames_overlapped() (the same images); the partitioned paths
        sync per stripe, so `overlap` does not apply to them."""
        if overlap and n_stripes <= 1 and n_bands <= 1:
            return self.frames_overlapped(seed=seed)
        return (self._render_partitioned(t, seed + i, n_stripes, n_bands)
                for i, t in self.frame_times())

    def _render_partitioned(self, t: float, seed: int, n_stripes: int,
                            n_bands: int) -> Tuple[np.ndarray, FrameStats]:
        """render_frame, striped when n_stripes > 1 and banded when
        n_bands > 1."""
        if n_stripes > 1:
            hist, stats = self.accumulate_striped(t, seed, n_stripes)
        else:
            hist, stats = self.accumulate(t, seed)
        if n_bands > 1:
            return self.finalize_frame_banded(hist, t, stats,
                                              n_bands=n_bands), stats
        return self.finalize_frame(hist, t, stats), stats
