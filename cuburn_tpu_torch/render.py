"""The frame pipeline: genome + profile -> a rendered still.

Port of `cuburn_tpu/render.py` for one device.  Per frame:

  evaluate the genome at the frame time                 [host]
  chaos game in chunks, each chunk flushed into the histogram
    (`iterate_accumulate`; the flush is the CUDA kernel on a GPU)
  logscale -> density estimation -> downsample -> colorclip -> u8
  u8 readback                                           [host]

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
from typing import Optional, Tuple

import numpy as np
import torch

from cuburn_tpu_torch.device import resolve_device
from cuburn_tpu_torch.genome.specs import Genome
from cuburn_tpu_torch.ops import de as de_mod
from cuburn_tpu_torch.ops import histogram as hist_mod
from cuburn_tpu_torch.ops.camera import CameraSpec
from cuburn_tpu_torch.ops.filtering import (colorclip, downsample,
                                            logscale,
                                            spatial_filter_taps, to_u8)
from cuburn_tpu_torch.ops.iterate import (PACKED_FLUSHES, color_bits_for,
                                          hist_alloc_for, hist_to_layout,
                                          hist_to_logical, init_state,
                                          iterate_accumulate,
                                          opacity_bits_for,
                                          xform_cdf_rows)
from cuburn_tpu_torch.ops.variations import VARIATION_IMPLS
from cuburn_tpu_torch.params import params_from_genome
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.utils.timing import sync

# every histogram backend of the JAX package: the packed-record
# flushes of ops/flush.py and the XLA backends of ops/histogram.py
BACKENDS = (*PACKED_FLUSHES, *hist_mod.BACKENDS)
# Records per flush = batch * iters_per_chunk.  Provisional: the JAX
# package's default, until an H100 sweep of the flush size sets it.
DEFAULT_ITERS_PER_CHUNK = 32


def _spline_range_max(sp, time_range) -> float:
    """Max of a genome spline over the render's time range (33-point
    sample + both endpoints), so static filter geometry covers every
    frame."""
    t0, t1 = time_range
    if sp.is_constant or t1 <= t0:
        return float(sp(t0))
    ts = np.linspace(t0, t1, 33)
    return float(np.max(sp.evaluate(ts)))


@dataclass
class FrameStats:
    """Per-frame observability record."""
    plotted_samples: int = 0
    total_iters: int = 0
    iterate_s: float = 0.0
    filter_s: float = 0.0

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
    histogram without its junk bin (earlyclip swaps the last two
    stages, flam3's pre-2008 order).  Returns the u8 frame, rgb only
    for opaque output."""
    img = hist.reshape(cam.acc_height, cam.acc_width, 4)
    raw_density = img[..., 3]
    img = logscale(img, params.brightness, quality_per_cell)
    if de_on:
        img = de_mod.density_filter(
            img, raw_density,
            params.estimator_radius * cam.ss,
            params.estimator_minimum * cam.ss,
            params.estimator_curve,
            static_max_radius=de_static_r)
    if earlyclip:
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
        img = downsample(img, cam.ss, spatial_filter, filter_shape,
                         gutter=cam.gutter)
        img = torch.clamp(img, 0.0, 1.0)
    else:
        img = downsample(img, cam.ss, spatial_filter, filter_shape,
                         gutter=cam.gutter)
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
    u8 = to_u8(img)
    return u8 if transparent else u8[..., :3]


def _with_alpha(img_np: np.ndarray) -> np.ndarray:
    """Pad an rgb-only u8 frame to RGBA (alpha=255)."""
    if img_np.shape[-1] == 3:
        out = np.empty(img_np.shape[:-1] + (4,), np.uint8)
        out[..., :3] = img_np
        out[..., 3] = 255
        return out
    return img_np


class Renderer:
    """Renders still frames of one genome under one profile on one
    device.

    `device` defaults to CUDA and raises when there is no GPU; the
    CPU runs only when asked for by name ("cpu").  The histogram
    backend follows the JAX package's names (`BACKENDS`): `auto` is
    `pallas_win` (the windowed flush, a CUDA kernel) on a GPU and
    `scatter` on the CPU.  Each `pallas*` backend launches its CUDA
    kernel on a GPU and runs the kernel's plain version on the CPU."""

    def __init__(self, genome: Genome, profile: RenderProfile,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        if profile.temporal_samples > 1:
            raise NotImplementedError(
                "motion blur (temporal_samples > 1) is not ported yet "
                "(ROADMAP.md queue A: iterate_accumulate_temporal)")
        self.genome = genome
        self.profile = profile
        self.key = genome.structure_key()
        used = set(self.key.variations) | set(
            self.key.final_variations or ())
        missing = sorted(used - set(VARIATION_IMPLS))
        if missing:
            raise NotImplementedError(
                f"variations not ported yet: {', '.join(missing)} "
                "(ROADMAP.md queue A)")
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
        if not self.packed:
            raise NotImplementedError(
                f"{self.cam.n_bins} bins do not fit packed 32-bit "
                "records; the unpacked path is not ported yet "
                "(ROADMAP.md queue A: iterate_chunk)")
        backend = profile.hist_backend
        if backend == "auto":
            backend = ("pallas_win" if self.device.type == "cuda"
                       else "scatter")
        elif backend not in BACKENDS:
            raise ValueError(f"unknown histogram backend {backend!r}; "
                             f"have {sorted(BACKENDS)}")
        self.backend = backend
        self.profile = dataclasses.replace(
            profile, iters_per_chunk=self._resolve_iters_per_chunk(
                profile))

    @staticmethod
    def _resolve_iters_per_chunk(profile) -> int:
        """Records per flush = batch * iters_per_chunk.  The
        CUBURN_ITERS_PER_CHUNK env var (0 = auto), then the profile
        field (0 = auto), then DEFAULT_ITERS_PER_CHUNK."""
        env = os.environ.get("CUBURN_ITERS_PER_CHUNK")
        if env and int(env) > 0:
            return int(env)
        if profile.iters_per_chunk > 0:
            return profile.iters_per_chunk
        return DEFAULT_ITERS_PER_CHUNK

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
        t0 = time.perf_counter()
        hist, n_plot, n_iter = self.accumulate_async(t, seed, hist0)
        stats.plotted_samples += int(n_plot)     # reads back: syncs
        stats.total_iters += n_iter
        sync(self.device)
        stats.iterate_s = time.perf_counter() - t0
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
            hist = torch.as_tensor(np.asarray(hist0, np.float32)) \
                .to(self.device).clone()
            if hist.shape != (cam.n_bins + 1, 4):
                raise ValueError(
                    f"resume histogram shape {tuple(hist.shape)} != "
                    f"{(cam.n_bins + 1, 4)}")
            mass = int(min(float(hist[:, 3].sum()), 2.0 ** 62))
            eff_seed = (eff_seed ^ (mass * 0x9E3779B9)) & 0x7FFFFFFF
            hist = hist_to_layout(self.backend, hist)
        else:
            hist = hist_alloc_for(self.backend, cam.n_bins, self.device)
        (t_s,), _weights, _sumfilt = self._temporal_times(t)
        params = params_from_genome(self.genome.eval_at(t_s),
                                    self.device)
        return self._accumulate_sample(params, hist, seed=eff_seed,
                                       iters=prof.total_iters)

    def finalize_frame(self, hist, t: float = 0.0,
                       stats: Optional[FrameStats] = None) -> np.ndarray:
        """logscale -> DE -> downsample -> colorclip a logical
        histogram into a u8 (H, W, 4) numpy frame."""
        t1 = time.perf_counter()
        img = _with_alpha(
            self.finalize_frame_device(hist, t).cpu().numpy())
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
        return img

    def finalize_frame_device(self, hist, t: float = 0.0):
        """finalize_frame without the readback: the u8 frame as a
        device tensor, (H, W, 3) for opaque profiles (alpha is the
        constant the host fills in) and (H, W, 4) for transparent."""
        prof, cam = self.profile, self.cam
        host_params = self.genome.eval_at(t)
        params = params_from_genome(host_params, self.device)
        _times, _w, sumfilt = self._temporal_times(t)
        q_cell = torch.tensor(
            np.float32(prof.quality * sumfilt / (cam.ss * cam.ss)),
            device=self.device)
        hist = torch.as_tensor(hist, dtype=torch.float32).to(self.device)
        de_r = self._static_de_r
        return _filter_frame(
            cam, prof.transparent, self._de_on(host_params),
            hist_mod.finalize(hist), params, q_cell,
            de_static_r=de_r if de_r > 0 else 9.0,
            spatial_filter=self._static_sf,
            filter_shape=self.genome.spatial_filter_shape,
            earlyclip=self.genome.earlyclip)

    def _de_on(self, host_params) -> bool:
        return (self.profile.de_enabled and
                float(host_params.estimator_radius) > 0.0)

    def _temporal_times(self, t: float):
        """Genome evaluation times + temporal-filter weights for one
        frame: a single sample at t (motion blur is not ported).
        Returns (times, weights (n,), sumfilt)."""
        return [t], np.ones(1), 1.0

    def _accumulate_sample(self, params, hist, seed: int, iters: float):
        """Run the chaos game for ~`iters` iterations into hist."""
        prof, cam = self.profile, self.cam
        cdf_rows = xform_cdf_rows(params)
        # cap the trajectory batch so every point lives >= ~8x fuse
        # iterations; otherwise warmup dominates and retention craters
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while batch > 1024 and iters / batch < min_life:
            batch //= 2
        state = init_state(torch.Generator().manual_seed(seed), batch,
                           self.device)
        ppu = params.ppu * float(np.float32(
            prof.width / self.genome.size[0]))
        per_chunk = batch * prof.iters_per_chunk
        n_chunks = max(1, int(np.ceil(iters / per_chunk)))
        _state, hist, plotted = iterate_accumulate(
            self.key, cam, self.backend, params, cdf_rows, state, hist,
            ppu, n_chunks, prof.iters_per_chunk, prof.fuse,
            op_bits=self.op_bits)
        return hist, plotted, n_chunks * per_chunk
