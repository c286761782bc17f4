"""One frame on several devices: `cuburn_tpu/parallel/shard.py` on
torch.distributed.

The JAX package shards a frame's trajectory batch over a device mesh
inside `shard_map`.  Here every device is a rank (`launch.spawn`); a
`ShardedRenderer` in each makes the same calls in lockstep, and JAX's
collectives become torch.distributed's on the renderer's group:

  replicated (the default): every rank runs batch/world of the frame's
      trajectories into a zero histogram; `all_reduce` sums the ranks'
      histograms (each tensor of the backend's layout: `pallas_rgb16`
      has f32 density and bf16 rgb) and the plotted counts, and the
      input histogram is added once (`sharded_accumulate`,
      `sharded_accumulate_temporal`);
  reduce-scatter: the same trajectories, then the summed histogram is
      cut into the n overlapping blocks of rows that the n filter bands
      read and `reduce_scatter_tensor` leaves rank k with block k only
      (`sharded_accumulate_scattered`,
      `sharded_accumulate_temporal_scattered`);
  stripe-parallel: rank k runs stripe k of the frame from the whole
      trajectory stream; `all_gather_into_tensor` brings the stripes
      together (`ShardedRenderer.accumulate_striped`).

The filter runs one band a rank and `all_gather_into_tensor` gathers
the u8 bands, so every rank returns the same frame.  Bands and blocks
take their rows from `render.band_layout`, which carries the DE
pyramid's context rows; the JAX package's `_band_geometry`
(`cuburn_tpu/parallel/shard.py:556-572`) sizes them from `band_margin`
alone and misses where the DE takes its pyramid path.

Every rank draws the whole batch's starting trajectories from the seed
and keeps its own batch/world lanes, as the JAX package's sharded
`device_put` keeps each device's, so the ranks together run one
device's trajectories: a frame's density equals `Renderer.accumulate`'s
where the batch halves alike (`_batch_for`).

Left out, as the port leaves them out everywhere: `dispatch_iter_cap`
(each frame is one uncapped call a rank), `sort_segments`, `sort_impl`
and the tune record's `iters_per_chunk`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from cuburn_tpu_torch.genome.specs import Genome
from cuburn_tpu_torch.ops import histogram as hist_mod
from cuburn_tpu_torch.ops.histogram import hist_alloc_for, hist_to_logical
from cuburn_tpu_torch.ops.iterate import (IterState, iterate_accumulate,
                                          iterate_accumulate_temporal)
from cuburn_tpu_torch.params import params_from_genome
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.render import (FrameStats, Renderer, _filter_window,
                                     _merge_stripe, _with_alpha,
                                     stripe_cameras)
from cuburn_tpu_torch.utils import trace
from cuburn_tpu_torch.utils.timing import sync


def _zeros_like(hist):
    if isinstance(hist, tuple):
        return tuple(torch.zeros_like(h) for h in hist)
    return torch.zeros_like(hist)


def _reduce_into(hist, delta, group=None):
    """hist + the sum over the group of every rank's delta, in place
    (JAX: `h + psum(d)`), for each tensor of the backend's layout."""
    if isinstance(hist, tuple):
        return tuple(_reduce_into(h, d, group) for h, d in zip(hist, delta))
    dist.all_reduce(delta, group=group)
    return hist.add_(delta)


def _reduce_count(plotted, group=None):
    """The group's sum of the ranks' plotted counts, in float64 (each
    rank's float32 count is an integer, so the sum is exact)."""
    total = plotted.to(torch.float64)
    dist.all_reduce(total, group=group)
    return total


@contextlib.contextmanager
def _old_collective_names():
    """torch 2.13 warns that `reduce_scatter_tensor` and
    `all_gather_into_tensor` are now `*_single`; older releases have
    only the old names, which both still run."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _block_scatter(backend: str, cam, layout, delta, group=None):
    """The scattered modes' reduction (JAX's `_make_block_scatter`):
    this rank's delta as the logical accumulator image, cut into the
    layout's n blocks; `reduce_scatter_tensor` leaves rank k with the
    group's sum of block k."""
    h_log = hist_to_logical(backend, delta, cam.n_bins)
    blocks = layout.blocks(
        h_log[:cam.n_bins].reshape(cam.acc_height, cam.acc_width, 4))
    mine = torch.empty(blocks.shape[1:], dtype=blocks.dtype,
                       device=blocks.device)
    # the blocks one after another along dim 0, as gloo wants them
    with _old_collective_names():
        dist.reduce_scatter_tensor(
            mine, blocks.reshape(-1, *mine.shape[1:]), group=group)
    return mine


def _gather(part, group=None):
    """(world, *part.shape): every rank's `part`, in rank order."""
    part = part.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * part.shape[0], *part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    with _old_collective_names():
        dist.all_gather_into_tensor(out, part, group=group)
    return out.reshape(n, *part.shape)


def sharded_accumulate(key, cam, backend: str, params, cdf_rows,
                       state: IterState, hist, ppu, n_chunks: int,
                       n_iters: int, fuse: int, packed: bool = True,
                       op_bits: int = 0, group=None):
    """n_chunks x n_iters steps of this rank's trajectories (`state`
    holds its lanes) into zeros, summed over the group and added to
    `hist` once, so a resumed histogram's mass is not multiplied by the
    world size.  Returns (state', hist', plotted) with hist' the same on
    every rank and plotted the group's float64 total."""
    state, delta, n = iterate_accumulate(
        key, cam, backend, params, cdf_rows, state, _zeros_like(hist), ppu,
        n_chunks, n_iters, fuse, op_bits=op_bits, packed=packed)
    return state, _reduce_into(hist, delta, group), _reduce_count(n, group)


def sharded_accumulate_temporal(key, cam, backend: str, params_T,
                                state: IterState, hist, ppu_T,
                                weights_T, n_chunks: int, n_iters: int,
                                fuse: int, packed: bool = True,
                                op_bits: int = 0, group=None):
    """A motion-blurred frame's T samples of this rank's trajectories,
    reduced as in sharded_accumulate: one all_reduce a tensor for the
    whole frame."""
    state, delta, n = iterate_accumulate_temporal(
        key, cam, backend, params_T, state, _zeros_like(hist), ppu_T,
        n_chunks, n_iters, fuse, weights_T=weights_T, op_bits=op_bits,
        packed=packed)
    return state, _reduce_into(hist, delta, group), _reduce_count(n, group)


def sharded_accumulate_scattered(key, cam, backend: str, params, cdf_rows,
                                 state: IterState, ppu, n_chunks: int,
                                 n_iters: int, fuse: int, layout,
                                 packed: bool = True, op_bits: int = 0,
                                 group=None):
    """sharded_accumulate with the reduce-scatter in place of the
    all_reduce: rank k ends up with only block k of the frame's summed
    accumulator image, the rows band k of `layout` filters.  Returns
    (state', block, plotted)."""
    zero = hist_alloc_for(backend, cam.n_bins, state.x.device)
    state, delta, n = iterate_accumulate(
        key, cam, backend, params, cdf_rows, state, zero, ppu, n_chunks,
        n_iters, fuse, op_bits=op_bits, packed=packed)
    return (state, _block_scatter(backend, cam, layout, delta, group),
            _reduce_count(n, group))


def sharded_accumulate_temporal_scattered(key, cam, backend: str,
                                          params_T, state: IterState,
                                          ppu_T, weights_T, n_chunks: int,
                                          n_iters: int, fuse: int, layout,
                                          packed: bool = True,
                                          op_bits: int = 0, group=None):
    """sharded_accumulate_temporal with the reduce-scatter: motion blur
    through the scattered mode, one reduce_scatter for the frame."""
    zero = hist_alloc_for(backend, cam.n_bins, state.x.device)
    state, delta, n = iterate_accumulate_temporal(
        key, cam, backend, params_T, state, zero, ppu_T, n_chunks, n_iters,
        fuse, weights_T=weights_T, op_bits=op_bits, packed=packed)
    return (state, _block_scatter(backend, cam, layout, delta, group),
            _reduce_count(n, group))


class ShardedRenderer(Renderer):
    """Renderer for one rank of a group of devices: the same API and
    frames, with every frame's trajectories sharded over the group.

    Build one in every rank of a group (`launch.spawn`) and make the
    same calls in every rank: each call that reduces, scatters or
    gathers is a collective.  Every rank returns the same histogram and
    the same frame.  `device` is the rank's device, `group` the process
    group (default: the whole world)."""

    def __init__(self, genome: Genome, profile: RenderProfile,
                 device: torch.device | str | None = None, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ShardedRenderer needs a torch.distributed process group: "
                "build it in the ranks of parallel.launch.spawn")
        super().__init__(genome, profile, device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_devices = dist.get_world_size(group)
        if profile.batch % self.n_devices:
            raise ValueError(f"batch {profile.batch} must divide over "
                             f"{self.n_devices} devices")
        # a stripe-parallel rank runs the whole trajectory stream of one
        # stripe, as one device does
        self._one_device = Renderer(genome, profile, self.device)

    def _batch_for(self, iters: float) -> int:
        """The base renderer's trajectory-lifetime cap on the batch, with
        a per-device floor and divisibility by the world size kept (the
        JAX package's `_halved_batch`)."""
        prof, n = self.profile, self.n_devices
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while (batch > 1024 * n and iters / batch < min_life
               and (batch // 2) % n == 0):
            batch //= 2
        return batch

    def _trajectories(self, seed: int, batch: int) -> IterState:
        """This rank's batch/world lanes of the batch's trajectories."""
        lanes = batch // self.n_devices
        full = super()._trajectories(seed, batch)
        sl = slice(self.rank * lanes, (self.rank + 1) * lanes)
        return IterState(**{f.name: getattr(full, f.name)[sl].clone()
                            for f in dataclasses.fields(IterState)})

    def _accumulate_sample(self, params, hist, seed: int, iters: float,
                           cam=None):
        prof = self.profile
        state, cdf_rows, ppu, n_chunks, per_chunk = self._sample_setup(
            params, seed, iters)
        _state, hist, plotted = sharded_accumulate(
            self.key, cam or self.cam, self.backend, params, cdf_rows, state,
            hist, ppu, n_chunks, prof.iters_per_chunk, prof.fuse,
            packed=self.packed, op_bits=self.op_bits, group=self.group)
        return hist, plotted, n_chunks * per_chunk

    def _accumulate_temporal(self, ts_times, ts_weights, hist, seed: int,
                             iters_per_sample: float, cam=None):
        prof = self.profile
        params_T, ppu_T, weights, state, n_chunks, per_chunk = \
            self._temporal_setup(ts_times, ts_weights, seed,
                                 iters_per_sample)
        _state, hist, plotted = sharded_accumulate_temporal(
            self.key, cam or self.cam, self.backend, params_T, state, hist,
            ppu_T, weights, n_chunks, prof.iters_per_chunk, prof.fuse,
            packed=self.packed, op_bits=self.op_bits, group=self.group)
        return hist, plotted, n_chunks * per_chunk * len(ts_times)

    def accumulate_striped(self, t: float = 0.0, seed: int = 0,
                           n_stripes: Optional[int] = None):
        """Stripe-parallel accumulation: rank k runs stripe k of the
        frame (render.stripe_cameras) from the whole trajectory stream,
        as Renderer.accumulate_striped runs it, and the stripes come
        together through all_gather: the histogram equals
        Renderer.accumulate_striped's with the same seed, in a stripe's
        time instead of n_stripes of them.  Any other stripe count, and
        motion blur, run the base class's stripes one after another,
        each sharding its trajectories over the group."""
        n = self.n_devices if n_stripes is None else n_stripes
        ts_times, _w, _sumfilt = self._temporal_times(t)
        if n != self.n_devices or len(ts_times) > 1:
            return super().accumulate_striped(t, seed, n_stripes=n)
        cam, dev = self.cam, self.device
        stats = FrameStats()
        t0 = time.perf_counter()
        cams = stripe_cameras(cam, n)
        th = cams[0].acc_height
        mine = torch.zeros((th * cam.acc_width, 4), device=dev)
        counts = torch.zeros(2, dtype=torch.float64, device=dev)
        if self.rank < len(cams):       # a stripe past the last row: none
            scam = cams[self.rank]
            params = params_from_genome(self.genome.eval_at(ts_times[0]),
                                        dev)
            hist, n_plot, n_iter = self._one_device._accumulate_sample(
                params, hist_alloc_for(self.backend, scam.n_bins, dev),
                seed * 7919, self.profile.total_iters, cam=scam)
            mine[:scam.n_bins] = hist_to_logical(
                self.backend, hist, scam.n_bins)[:scam.n_bins]
            counts[0], counts[1] = n_plot, n_iter
        stripes = _gather(mine, self.group)
        dist.all_reduce(counts, group=self.group)
        full = hist_mod.alloc(cam.n_bins, dev)
        for s, scam in enumerate(cams):
            _merge_stripe(full, stripes[s], scam.tile_row0, scam.acc_height,
                          cam.acc_width)
        sync(dev)
        stats.plotted_samples = int(counts[0])
        stats.total_iters = int(counts[1])
        stats.iterate_s = time.perf_counter() - t0
        return full, stats

    def _gather_frame(self, band):
        """The u8 frame from every rank's band, rows past the frame
        dropped."""
        bands = _gather(band, self.group)
        return bands.reshape(-1, *band.shape[1:])[:self.profile.height]

    def finalize_frame_device(self, hist, t: float = 0.0):
        """Sharded filtering: every rank holds the whole histogram and
        filters band `rank` of the frame, then the u8 bands are
        gathered.  One device, or bands under 2 rows, filter whole."""
        h_band = -(-self.profile.height // self.n_devices)
        if self.n_devices == 1 or h_band < 2:
            return super().finalize_frame_device(hist, t)
        cam = self.cam
        params, q_cell, kw = self._filter_inputs(t)
        _h, layout = self._band_layout(self.n_devices, kw["de_on"])
        himg = torch.as_tensor(hist, dtype=torch.float32).to(self.device)[
            :-1].reshape(cam.acc_height, cam.acc_width, 4)
        d0 = layout.windows[self.rank][0]
        band = _filter_window(layout.pad(himg)[d0 + layout.top:], layout,
                              self.rank, params, q_cell, cam.ss, cam.gutter,
                              **kw)
        return self._gather_frame(band)

    # -- reduce-scatter mode -------------------------------------------
    # The reduction hands each rank the block of rows its filter band
    # reads: no rank holds the whole histogram after it, and each
    # filters its own block.  Density equals the replicated path's;
    # rgb may differ by float32 reduction order (frames within one u8
    # step).  A resumed histogram does not apply here.

    def accumulate_scattered_async(self, t: float = 0.0, seed: int = 0):
        """Queue one frame's scattered accumulation without waiting.
        Returns (this rank's block, plotted-count device scalar,
        total_iters)."""
        prof = self.profile
        _h, layout = self._band_layout(
            self.n_devices, self._de_on(self.genome.eval_at(t)))
        ts_times, ts_weights, _sumfilt = self._temporal_times(t)
        if len(ts_times) == 1:
            params = params_from_genome(self.genome.eval_at(ts_times[0]),
                                        self.device)
            return self._scattered_single(params, seed * 7919, layout)
        return self._scattered_temporal(
            ts_times, ts_weights, seed * 7919,
            prof.total_iters / len(ts_times), layout)

    def _scattered_single(self, params, seed: int, layout):
        prof = self.profile
        state, cdf_rows, ppu, n_chunks, per_chunk = self._sample_setup(
            params, seed, prof.total_iters)
        _state, block, plotted = sharded_accumulate_scattered(
            self.key, self.cam, self.backend, params, cdf_rows, state, ppu,
            n_chunks, prof.iters_per_chunk, prof.fuse, layout,
            packed=self.packed, op_bits=self.op_bits, group=self.group)
        return block, plotted, n_chunks * per_chunk

    def _scattered_temporal(self, ts_times, ts_weights, seed: int,
                            iters_per_sample: float, layout):
        prof = self.profile
        params_T, ppu_T, weights, state, n_chunks, per_chunk = \
            self._temporal_setup(ts_times, ts_weights, seed,
                                 iters_per_sample)
        _state, block, plotted = sharded_accumulate_temporal_scattered(
            self.key, self.cam, self.backend, params_T, state, ppu_T,
            weights, n_chunks, prof.iters_per_chunk, prof.fuse, layout,
            packed=self.packed, op_bits=self.op_bits, group=self.group)
        return block, plotted, n_chunks * per_chunk * len(ts_times)

    def accumulate_scattered(self, t: float = 0.0, seed: int = 0):
        """One frame's accumulation through the reduce-scatter.  Returns
        (this rank's block, stats); ends in a device sync."""
        stats = FrameStats()
        t0 = time.perf_counter()
        block, plotted, total = self.accumulate_scattered_async(t, seed)
        stats.plotted_samples = int(plotted)
        stats.total_iters = total
        sync(self.device)
        stats.iterate_s = time.perf_counter() - t0
        return block, stats

    def finalize_frame_scattered_device(self, block, t: float = 0.0):
        """Filter this rank's block, then gather the u8 bands: the
        frame as a device tensor, (H, W, 3) opaque, (H, W, 4)
        transparent."""
        params, q_cell, kw = self._filter_inputs(t)
        _h, layout = self._band_layout(self.n_devices, kw["de_on"])
        band = _filter_window(block, layout, self.rank, params, q_cell,
                              self.cam.ss, self.cam.gutter, **kw)
        return self._gather_frame(band)

    def finalize_frame_scattered(self, block, t: float = 0.0, stats=None):
        t1 = time.perf_counter()
        img = self.finalize_frame_scattered_device(block, t).cpu().numpy()
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
        return _with_alpha(img)

    def render_frame_scattered(self, t: float = 0.0, seed: int = 0):
        """render_frame through the reduce-scatter mode."""
        block, stats = self.accumulate_scattered(t, seed)
        return self.finalize_frame_scattered(block, t, stats), stats

    def frames_overlapped_scattered(self, seed: int = 0):
        """frames_overlapped through the reduce-scatter mode: frame N's
        launches and collectives are queued before frame N-1 is read
        back.  Frames equal serial render_frame_scattered calls at the
        same per-frame seeds."""
        pending = None
        t_prev = time.perf_counter()
        for i, t in self.frame_times():
            before = trace.counters()
            block, n_plot, n_iter = self.accumulate_scattered_async(
                t, seed + i)
            img_dev = self.finalize_frame_scattered_device(block, t)
            queued = self._queue_readback(img_dev, n_plot) + (
                n_iter, trace.since(before))
            now = time.perf_counter()
            if pending is not None:
                yield self._resolve_pending(pending, now - t_prev)
            t_prev = now
            pending = queued
        if pending is not None:
            yield self._resolve_pending(pending,
                                        time.perf_counter() - t_prev)
