"""One run of one cell: set-up, the measured window, the trace, the
check against the reference, and the result line.

The program under test is `cuburn_tpu_torch`'s `Renderer`; the harness
drives its entries the way its users do (`render_frame` for stills,
`frames_overlapped` for animations, as the CLI does by default) and
takes every end-to-end number itself, on the host's clock.
"""

from __future__ import annotations

import gc
import os
import random
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from flamebench import compare, roofline, spec
from flamebench import trace as trace_mod

# top-level module names that no run may hold once its window has closed:
# JAX, its relatives, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "cuburn_tpu")
# the program's environment switches, pinned so that no tune record or
# override in the run's environment moves what a cell renders
PINNED_ENV = {"CUBURN_TUNE_FILE": os.path.join(spec.HERE, "no-tune-record",
                                               "none.json")}
CLEARED_ENV = ("CUBURN_ITERS_PER_CHUNK", "CUBURN_DE_SKIP_EMPTY")
# torch's intra-op threads in a run on the card.  The host's part of a
# frame is one chain of small tensor ops and launches on the main thread,
# which drives the card; a pool splits each op past torch's grain into a
# parallel region, and its threads spin after every region and take CPU
# time from the main thread.  On the H100 machine torch's default pool
# of 8 spun 28-46 CPU seconds a 20 s window, and the more it spun, the
# slower the run (PERF.md's findings).  One thread draws the same images.
HOST_THREADS = 1
SPAN = trace_mod.SPAN_PREFIX
STRETCH = "stretch"
GIB = float(1 << 30)


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one
    of FORBIDDEN (`cuburn_tpu_torch` is not `cuburn_tpu`)."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def base_seed(seed: int) -> int:
    """A frame-seed base of 40 bits from the run's seed (splitmix64's
    finaliser): frame k of a run renders with seed base + k, so runs of
    different seeds start far apart and a run never repeats a seed."""
    z = (seed + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 24


class Sample:
    """A uniform sample of k of the window's frames, drawn from the
    run's seed while they stream past (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed ^ 0x5EED5EED)
        self.seen = 0
        self.kept: List[tuple] = []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


@dataclass
class Window:
    """What the measured window left: each counted frame's wall
    seconds, the window's wall, and the frames kept for the check as
    (k, time, seed, image)."""
    frame_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    kept: List[tuple] = field(default_factory=list)


def pin_environment() -> None:
    for k in CLEARED_ENV:
        os.environ.pop(k, None)
    os.environ.update(PINNED_ENV)


def host_cpu_s() -> Tuple[float, float]:
    """This process's user and system CPU seconds so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def profile_for(cell: spec.Cell, backend: Optional[str] = None):
    """The program's RenderProfile of the cell: the configuration's
    geometry and settings, the mix's quality, temporal samples and
    sequence."""
    from cuburn_tpu_torch.profile import RenderProfile
    c, m = cell.config, cell.traffic
    fps = float(c.get("fps", 24.0))
    return RenderProfile(
        width=c["width"], height=c["height"], ss=c["ss"],
        quality=m["quality"], fuse=c["fuse"], batch=c["batch"],
        iters_per_chunk=c["iters_per_chunk"],
        hist_backend=backend or c["hist_backend"],
        de_enabled=c["de_enabled"], fps=fps,
        duration=(m["frames"] / fps if m["driver"] == "animation"
                  else None),
        temporal_samples=m["temporal_samples"])


def settings_for(cell: spec.Cell, steps_per_flush: int):
    """The reference's Settings of the cell."""
    from flamebench.reference.render import Settings
    c, m = cell.config, cell.traffic
    fps = float(c.get("fps", 24.0))
    return Settings(
        width=c["width"], height=c["height"], ss=c["ss"],
        quality=m["quality"], fuse=c["fuse"], batch=c["batch"],
        de_enabled=c["de_enabled"], transparent=False, fps=fps,
        temporal_samples=m["temporal_samples"],
        steps_per_flush=steps_per_flush,
        duration=(m["frames"] / fps if m["driver"] == "animation"
                  else None))


def samples_per_frame(cell: spec.Cell) -> int:
    """The samples a frame asks for: quality per output pixel."""
    return cell.traffic["quality"] * cell.config["width"] \
        * cell.config["height"]


# -- tracing ---------------------------------------------------------------

class Tracer:
    """Spans around the Renderer's entries (its methods wrapped on the
    instance) and torch.profiler over a stretch of frames: from frame
    `skip` for `frames` frames."""

    def __init__(self, renderer, skip: int, frames: int, driver: str,
                 cuda: bool = True):
        import torch
        self.torch = torch
        self.cuda = cuda
        self.skip, self.frames = skip, frames
        self.prof = None
        self.stretch = None
        self.done = False
        names = {"stills": {"accumulate": "accumulate",
                            "finalize_frame": "readback",
                            "finalize_frame_device": "filter"},
                 "animation": {"accumulate_async": "accumulate",
                               "finalize_frame_device": "filter",
                               "_resolve_pending": "readback"}}[driver]
        for method, layer in names.items():
            setattr(renderer, method,
                    self._wrap(getattr(renderer, method), layer))

    def _wrap(self, fn: Callable, layer: str) -> Callable:
        record = self.torch.profiler.record_function

        def spanned(*a, **kw):
            with record(SPAN + layer):
                return fn(*a, **kw)
        return spanned

    def span(self, layer: str):
        return self.torch.profiler.record_function(SPAN + layer)

    def before_frame(self, k: int) -> None:
        if k == self.skip and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else []))
            self.prof.start()
            self.stretch = self.span(STRETCH)
            self.stretch.__enter__()

    def after_frame(self, k: int) -> None:
        if self.prof is not None and not self.done \
                and k == self.skip + self.frames - 1:
            self.stretch.__exit__(None, None, None)
            if self.cuda:
                self.torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def reduce(self) -> Optional[trace_mod.Trace]:
        """The stretch's Trace (None when the window ended first)."""
        if not self.done:
            if self.prof is not None:
                self.prof.stop()
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return trace_mod.load(path, STRETCH)
        finally:
            os.unlink(path)


# -- the window --------------------------------------------------------------

def render_stills(renderer, cell, base: int, seconds: float, sample: Sample,
                  tracer: Optional[Tracer]) -> Window:
    """render_frame back to back: a frame counts when its u8 image is on
    the host before the deadline, and its time runs from the call to
    that image.  A traced window runs on past the deadline until its
    profiled stretch has ended."""
    t = float(cell.traffic.get("time", 0.0))
    out = Window()
    start = time.perf_counter()
    deadline = start + seconds
    last, k = start, 0
    while True:
        if tracer:
            tracer.before_frame(k)
        t0 = time.perf_counter()
        with tracer.span("frame") if tracer else nullcontext():
            img, _stats = renderer.render_frame(t, seed=base + k)
        t1 = time.perf_counter()
        if tracer:
            tracer.after_frame(k)
        if t1 <= deadline:
            out.frame_s.append(t1 - t0)
            sample.offer((k, t, base + k, img))
            last = t1
        elif tracer is None or tracer.done:
            break
        k += 1
    out.wall_s = last - start
    out.kept = sample.kept
    return out


def render_animation(renderer, cell, base: int, seconds: float,
                     sample: Sample, tracer: Optional[Tracer]) -> Window:
    """frames_overlapped over the mix's sequence, restarted when it
    ends: a frame counts when the driver yields it before the deadline,
    and its time runs from the previous yield (the first from the
    window's start).  A traced window runs on past the deadline until
    its profiled stretch has ended."""
    out = Window()
    times = [t for _i, t in renderer.frame_times()]
    start = time.perf_counter()
    deadline = start + seconds
    prev, k = start, 0
    running = True
    while running:
        frames = renderer.frames_overlapped(seed=base + k)
        try:
            for t in times:
                if tracer:
                    tracer.before_frame(k)
                img, _stats = next(frames)
                now = time.perf_counter()
                if tracer:
                    tracer.after_frame(k)
                if now <= deadline:
                    out.frame_s.append(now - prev)
                    sample.offer((k, t, base + k, img))
                    prev = now
                elif tracer is None or tracer.done:
                    running = False
                    break
                k += 1
        finally:
            frames.close()
    out.wall_s = sum(out.frame_s)
    out.kept = sample.kept
    return out


DRIVERS = {"stills": render_stills, "animation": render_animation}


def warm_up(renderer, cell, seed: int) -> None:
    """One frame at the cell's own shapes, through the cell's driver
    (two for the overlapped driver, which queues one ahead)."""
    if cell.traffic["driver"] == "stills":
        renderer.render_frame(float(cell.traffic.get("time", 0.0)),
                              seed=seed)
        return
    frames = renderer.frames_overlapped(seed=seed)
    try:
        next(frames)
        next(frames)
    finally:
        frames.close()


# -- the check --------------------------------------------------------------

def check_frames(cell, kept, steps_per_flush: int, device) -> Tuple[
        Dict[str, float], int, List]:
    """The reference's frames of `kept`, the worst of each compared
    number, how many frames fail their limits, and the reference's
    results."""
    import torch
    from flamebench.reference.render import Frames
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Frames(cell.config["genome"], settings_for(cell, steps_per_flush),
                 device)
    gaps, results = [], []
    for _k, t, seed, img in kept:
        r = ref.render(t, seed)
        results.append(r)
        gaps.append(compare.frame_gaps(img, r.image))
    limits = cell.check["limits"]
    failed = sum(not compare.verdict(g, limits) for g in gaps)
    return compare.worst(gaps), failed, results


# -- the run ------------------------------------------------------------------

@dataclass
class LayerContext:
    """What a per-layer metric's reader reads: the profiled stretch,
    the cell, and the work of one frame, counted from the cell's shapes
    and the reference's frames."""
    trace: trace_mod.Trace
    cell: spec.Cell
    samples_per_frame: int
    lanes_per_frame: int
    ref_plotted: float
    ref_touched_bins: float


def card_name() -> Dict[str, object]:
    """The card's name and power limit as nvidia-smi gives them (None
    where it gives nothing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(",", 1))
        return {"nvidia_smi_name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"nvidia_smi_name": None, "power_limit": None}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda",
             log: Callable[[str], None] = lambda s: None) -> dict:
    """One run; returns the result line's object.  `device` "cpu" runs
    the plain versions, for tests at toy sizes."""
    import torch
    pin_environment()
    cuda = device == "cuda"
    if cuda:
        torch.set_num_threads(HOST_THREADS)
    from cuburn_tpu_torch import models
    from cuburn_tpu_torch.render import Renderer
    renderer = Renderer(getattr(models, cell.config["genome"])(),
                        profile_for(cell), device=device)
    base = base_seed(seed)
    warm_up(renderer, cell, seed=base_seed(seed ^ 0xFFFF) + (1 << 41))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps_per_flush = renderer.profile.iters_per_chunk
    log(f"set-up {setup_s:.3f} s: backend {renderer.backend}, "
        f"{steps_per_flush} steps a flush, {renderer.cam.n_bins} bins")

    tracer = None
    if traced:
        tr = cell.traffic["trace"]
        tracer = Tracer(renderer, tr["skip_frames"], tr["frames"],
                        cell.traffic["driver"], cuda)
    sample = Sample(cell.check["frames"], base)
    cpu0 = host_cpu_s()
    window = DRIVERS[cell.traffic["driver"]](
        renderer, cell, base, seconds, sample, tracer)
    cpu1 = host_cpu_s()
    if cuda:
        torch.cuda.synchronize()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    stretch = tracer.reduce() if tracer else None
    n = len(window.frame_s)
    if n == 0:
        raise RuntimeError("no frame finished inside the window")
    half = n // 2
    log(f"window: {n} frames in {window.wall_s:.3f} s; frame median "
        f"{statistics.median(window.frame_s):.6f} s, halves "
        f"{sum(window.frame_s[:half]):.3f} s and "
        f"{sum(window.frame_s[half:]):.3f} s")
    log(f"host: {cpu1[0] - cpu0[0]:.3f} s user and {cpu1[1] - cpu0[1]:.3f} "
        f"s system CPU over the window, {torch.get_num_threads()} "
        f"intra-op thread(s)")

    del renderer, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, failed, refs = check_frames(cell, window.kept,
                                          steps_per_flush, device)
    limits = cell.check["limits"]
    correct = compare.verdict(readings, limits)

    if traced:
        metrics = {}
        if stretch is not None:
            lanes = roofline.lanes_for(
                cell.config["batch"], cell.config["fuse"],
                samples_per_frame(cell)) * cell.traffic["temporal_samples"]
            ctx = LayerContext(
                trace=stretch, cell=cell,
                samples_per_frame=samples_per_frame(cell),
                lanes_per_frame=lanes,
                ref_plotted=statistics.mean(r.plotted for r in refs),
                ref_touched_bins=statistics.mean(r.touched_bins
                                                 for r in refs))
            metrics = spec.per_layer(cell.per_layer, ctx)
    else:
        values = {
            "samples_per_s": n * samples_per_frame(cell) / window.wall_s,
            "peak_mem_gib": window_peak / GIB,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if cuda:
        dev.update(card_name())
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s()
        dev["window_s"] = stretch.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in stretch.top_ops(10)],
            "idle_gaps": [[k, v] for k, v in sorted(
                stretch.idle_by_host().items(), key=lambda kv: -kv[1])][:10]}
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in compare.NAMES}
    return result
