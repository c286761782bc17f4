"""`cuburn-tpu-torch`: render stills and animations with the
PyTorch/CUDA port.

The one-device paths of `cuburn_tpu/main.py`, with its own copy of
that module's argument parser, genome loader and metrics records:

    cuburn-tpu-torch gallery:full_feature -o out.png --profile 1080p
    cuburn-tpu-torch genome.flam3 -o out.png --cpu
    cuburn-tpu-torch gallery:animated_spark --animate -o a.y4m \
        --fps 24 --duration 2 --temporal-samples 4
    cuburn-tpu-torch a.flam3 --blend b.flam3 --animate -o edge.mp4
    cuburn-tpu-torch gallery:full_feature -o big.png --profile 4k \
        --stripes 2 --bands 4
    cuburn-tpu-torch gallery:full_feature -o out.png --devices 4 \
        [--reduce-scatter]

The render runs on CUDA unless `--cpu` asks for the CPU; without a GPU
the CUDA default fails instead of falling back.  `--devices N` shards
each frame over N processes, one a device (`parallel/shard.py`): N GPUs
over NCCL, or with `--cpu` N CPU processes over gloo; rank 0 writes the
output.  `--trace-dir DIR` writes a torch.profiler trace of the render
(Chrome/Perfetto JSON) into DIR, one file a process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from cuburn_tpu_torch.ops.histogram import BACKENDS
    p = argparse.ArgumentParser(
        prog="cuburn-tpu-torch",
        description="fractal flame renderer (flam3/cuburn-compatible) "
                    "on PyTorch and CUDA")
    p.add_argument("genome",
                   help="genome file (.flam3/.flame XML or .json), or "
                        "gallery:<name>")
    p.add_argument("-o", "--output", default="out.png",
                   help="output path (.png/.jpg still, .y4m/.mp4 video)")
    p.add_argument("--profile", default="preview",
                   help="render profile name")
    p.add_argument("--width", type=int, help="override profile width")
    p.add_argument("--height", type=int, help="override profile height")
    p.add_argument("--quality", type=int,
                   help="override samples per output pixel")
    p.add_argument("--ss", type=int, help="override supersampling")
    p.add_argument("--time", type=float, default=0.0,
                   help="genome time for stills")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-overlap", action="store_true",
                   help="disable cross-frame pipeline overlap in "
                        "--animate (overlap yields identical frames; "
                        "disable only for per-frame device timings)")
    p.add_argument("--animate", action="store_true",
                   help="render the full time range as video")
    p.add_argument("--temporal-samples", type=int,
                   help="genome evaluations per frame (motion blur)")
    p.add_argument("--fps", type=float,
                   help="override profile frames per second")
    p.add_argument("--duration", type=float,
                   help="override animation duration in seconds")
    p.add_argument("--hist-backend", choices=("auto", *BACKENDS),
                   help="histogram accumulation backend")
    p.add_argument("--no-de", action="store_true",
                   help="disable density-estimation filtering")
    p.add_argument("--blend", metavar="GENOME2",
                   help="build an animated edge genome sweeping from "
                        "GENOME to GENOME2 (use with --animate)")
    p.add_argument("--no-harmonize", action="store_true",
                   help="skip sequence structure harmonization (one "
                        "compile per edge instead of one total; keeps "
                        "packed opacity records when padding would "
                        "overflow their bit budget)")
    p.add_argument("--loops", type=float, default=0.0,
                   help="insert a loop segment per keyframe in"
                        " sequences: animate-flagged xforms spin this"
                        " many turns in place (flam3-animate loops)")
    p.add_argument("--blend-spin", type=float, default=0.0,
                   help="extra full camera rotations across the edge")
    p.add_argument("--convert", action="store_true",
                   help="convert genome to cuburn-tpu JSON and exit")
    p.add_argument("--flame-index", type=int, default=0,
                   help="which <flame> to use from a multi-flame file")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame render statistics")
    p.add_argument("--metrics-json",
                   help="append one JSON metrics record per frame to "
                        "this file (SURVEY.md §5 observability)")
    p.add_argument("--devices", type=int,
                   help="shard the frame across N local devices, one "
                        "process each (trajectory DP + histogram "
                        "all_reduce)")
    p.add_argument("--reduce-scatter", action="store_true",
                   help="with --devices N: reduce-scatter the "
                        "histogram instead of replicating it (each "
                        "chip owns only its filter band's block — "
                        "~half the ICI bytes, 1/n residency; stills "
                        "and animations, incl. motion blur; no "
                        "checkpoints/stripes/bands)")
    p.add_argument("--save-hist",
                   help="write the raw f32 accumulation histogram to "
                        "this .npy (checkpoint for high-quality stills)")
    p.add_argument("--resume-hist",
                   help="resume accumulation from a saved histogram")
    p.add_argument("--stripes", type=int, default=0,
                   help="render the frame as N horizontal sub-programs"
                        " (exact partition; for frames whose histogram"
                        " exceeds device limits)")
    p.add_argument("--bands", type=int, default=0,
                   help="filter the frame as N horizontal sub-programs"
                        " (pairs with --stripes for frames whose full"
                        " filter program exceeds device limits)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the default is the GPU, "
                        "with no fallback)")
    p.add_argument("--trace-dir",
                   help="capture a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of the render into this directory")
    p.add_argument("--cam-angle-units", default="",
                   choices=("", "degrees", "radians"),
                   help="how to read cam_yaw/cam_pitch in flam3 XML "
                        "(default: the file's cam_angle_units attr, "
                        "else radians with a >2*pi magnitude warning)")
    return p


def _append_metrics(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _stats_record(frame_idx, t, stats):
    return {
        "frame": frame_idx, "time": t,
        "plotted_samples": stats.plotted_samples,
        "total_iters": stats.total_iters,
        "retention": round(stats.retention, 4),
        "samples_per_sec": round(stats.samples_per_sec, 1),
        "iterate_ms": round(stats.iterate_s * 1e3, 2),
        "filter_ms": round(stats.filter_s * 1e3, 2),
        "chunks": stats.chunks, "records": stats.records,
        "launches": stats.launches, "syncs": stats.syncs,
        "uploads": stats.uploads,
    }


def load_genome(spec: str, index: int, angle_units: str = ""):
    from cuburn_tpu_torch.genome.convert import load_genomes
    from cuburn_tpu_torch.models import get_genome
    if spec.startswith("gallery:"):
        try:
            return get_genome(spec.split(":", 1)[1])
        except ValueError as e:
            raise SystemExit(str(e))
    if spec.startswith("random:"):
        # flam3-genome-style deterministic random flame
        from cuburn_tpu_torch.genome.randgen import random_genome
        try:
            seed_val = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"random:<seed> needs an integer, "
                             f"got {spec!r}")
        return random_genome(seed_val)
    try:
        genomes = load_genomes(spec, angle_units=angle_units)
    except FileNotFoundError:
        raise SystemExit(f"genome file not found: {spec}")
    except Exception as e:
        raise SystemExit(f"could not parse {spec}: "
                         f"{type(e).__name__}: {e}")
    if not genomes:
        raise SystemExit(f"no genomes found in {spec}")
    if index >= len(genomes):
        raise SystemExit(
            f"flame index {index} out of range ({len(genomes)} found)")
    return genomes[index]


@contextlib.contextmanager
def _traced(trace_dir, device, rank=None):
    """Profile the body with torch.profiler (the CPU, and CUDA on a
    GPU) when `trace_dir` is set, and write the trace as
    trace_dir/trace.json (trace_rank<rank>.json for a rank) even when
    the body raises."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json" if rank is None
                        else f"trace_rank{rank}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"trace written to {path}", file=sys.stderr)


def _animate(args, renderer, sequence, output_mod, write: bool) -> None:
    """Render the genome's time range (or every edge of a keyframe
    sequence) into a video sink; `write` False renders the frames
    (a rank of a sharded render) and writes nothing."""
    prof = renderer.profile
    sink = (output_mod.make_video_sink(args.output, prof.width,
                                       prof.height, prof.fps)
            if write else None)
    n = 0
    t0 = time.time()

    def run_frames(r, seed):
        # the overlapped frame loop is the default: the same images, and
        # the host encodes frame N-1 while the device works on N
        overlap = not args.no_overlap
        if args.reduce_scatter:
            if overlap:
                return r.frames_overlapped_scattered(seed=seed)
            return (r.render_frame_scattered(t, seed=seed + i)
                    for i, t in r.frame_times())
        return r.frames_partitioned(seed=seed, n_stripes=args.stripes,
                                    n_bands=args.bands, overlap=overlap)

    def frame_iter():
        if sequence is None:
            yield from run_frames(renderer, args.seed)
            return
        total_len = sequence[-1][2] - sequence[0][1]
        total_s = prof.duration or 2.0 * len(sequence)
        # a sharded renderer's segments keep its process group
        group = ({"group": renderer.group} if hasattr(renderer, "group")
                 else {})
        for k, (edge, s, e) in enumerate(sequence):
            # segment wall time proportional to its keyframe span
            # (flam3 `time` attributes set the spacing)
            seg_prof = dataclasses.replace(
                prof, duration=total_s * (e - s) / total_len)
            frames = run_frames(
                type(renderer)(edge, seg_prof, device=renderer.device,
                               **group),
                args.seed + k)
            if k > 0:
                # each edge spans [0, 1] inclusive and edge k's t=1
                # pose is edge k+1's t=0 pose: dropping the first frame
                # of every later segment avoids one doubled frame per
                # interior keyframe
                next(frames, None)
            yield from frames

    try:
        for img, stats in frame_iter():
            n += 1
            if not write:
                continue
            sink.write_frame(img)
            if args.stats:
                print(f"frame {n}: {stats.samples_per_sec/1e6:.1f} "
                      f"Msamples/s, retention "
                      f"{stats.retention:.2f}, "
                      f"{output_mod.encoder()} encoder", file=sys.stderr)
            if args.metrics_json:
                _append_metrics(args.metrics_json,
                                _stats_record(n, None, stats))
    finally:
        if sink is not None:
            sink.close()
    dt = time.time() - t0
    if write:
        print(f"wrote {n} frames to {args.output} in {dt:.1f}s "
              f"({n / max(dt, 1e-9):.2f} fps)")


def _still(args, renderer, output_mod, write: bool) -> None:
    """Render one frame at --time and write it; `write` as in
    _animate."""
    import numpy as np

    hist0 = None
    if args.resume_hist:
        try:
            hist0 = np.load(args.resume_hist)
        except FileNotFoundError:
            raise SystemExit(
                f"resume histogram not found: {args.resume_hist}")
    if args.reduce_scatter:
        img, stats = renderer.render_frame_scattered(args.time,
                                                     seed=args.seed)
    else:
        if args.stripes > 1:
            hist, stats = renderer.accumulate_striped(
                args.time, args.seed, n_stripes=args.stripes)
        else:
            hist, stats = renderer.accumulate(args.time, args.seed,
                                              hist0=hist0)
        if args.save_hist and write:
            np.save(args.save_hist, hist.cpu().numpy())
        if args.bands > 1:
            img = renderer.finalize_frame_banded(hist, args.time, stats,
                                                 n_bands=args.bands)
        else:
            img = renderer.finalize_frame(hist, args.time, stats)
    if not write:
        return
    output_mod.write_image(args.output, img)
    if args.stats:
        print(f"iterate {stats.iterate_s * 1e3:.1f} ms "
              f"({stats.samples_per_sec / 1e6:.1f} Msamples/s, "
              f"retention {stats.retention:.2f}); "
              f"filters {stats.filter_s * 1e3:.1f} ms "
              f"[{renderer.backend} on {renderer.device}]",
              file=sys.stderr)
    if args.metrics_json:
        _append_metrics(args.metrics_json,
                        _stats_record(0, args.time, stats))
    print(f"wrote {args.output}")


def _render(args, renderer, sequence, write: bool) -> None:
    from cuburn_tpu_torch import output as output_mod
    if args.animate:
        _animate(args, renderer, sequence, output_mod, write)
    else:
        _still(args, renderer, output_mod, write)


def _render_rank(rank, device, args, genome, sequence, prof) -> None:
    """One rank of `--devices N`: the same calls as every other rank;
    rank 0 writes."""
    from cuburn_tpu_torch.parallel.shard import ShardedRenderer
    renderer = ShardedRenderer(genome, prof, device)
    with _traced(args.trace_dir, device, rank):
        _render(args, renderer, sequence, write=rank == 0)


def _sharded_devices(args):
    """(devices, backend) of `--devices N`: N CPU processes over gloo
    with --cpu, else the first N GPUs over NCCL."""
    import torch

    from cuburn_tpu_torch.device import resolve_device
    n = args.devices
    if args.cpu:
        return ["cpu"] * n, "gloo"
    try:
        resolve_device("cuda")
    except RuntimeError as e:       # no GPU: say so, do not fall back
        raise SystemExit(f"cuburn-tpu-torch: --devices {n}: {e}")
    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f"cuburn-tpu-torch: --devices {n} needs {n} GPUs; "
                         f"this machine has {have}")
    return [f"cuda:{i}" for i in range(n)], "nccl"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    genome = load_genome(args.genome, args.flame_index,
                         angle_units=args.cam_angle_units)
    sequence = None
    if args.blend:
        from cuburn_tpu_torch.genome.blend import blend_genomes
        target = load_genome(args.blend, 0,
                             angle_units=args.cam_angle_units)
        genome = blend_genomes(genome, target, spin=args.blend_spin)
    elif (args.animate and not args.convert
          and not args.genome.startswith(("gallery:", "random:"))):
        # multi-flame file + --animate = keyframe sequence (the
        # flam3-animate workflow): blend consecutive stills into edges
        from cuburn_tpu_torch.genome.blend import blend_sequence
        from cuburn_tpu_torch.genome.convert import load_genomes
        all_genomes = load_genomes(args.genome,
                                   angle_units=args.cam_angle_units)
        if len(all_genomes) > 1:
            sequence = blend_sequence(all_genomes, spin=args.blend_spin,
                                      loops=args.loops,
                                      harmonize=not args.no_harmonize)
    if args.convert:
        print(genome.to_json())
        return 0

    if args.animate and (args.save_hist or args.resume_hist
                         or args.time):
        # these drive the still path only; silently ignoring a
        # checkpoint request is worse than refusing it
        raise SystemExit(
            "--save-hist/--resume-hist/--time apply to stills; "
            "they have no effect with --animate")
    if args.reduce_scatter:
        if not (args.devices and args.devices > 1):
            raise SystemExit("--reduce-scatter requires --devices N>1")
        if (args.stripes > 1 or args.bands > 1
                or args.save_hist or args.resume_hist):
            raise SystemExit(
                "--reduce-scatter is incompatible with stripes/bands/"
                "checkpoints — each chip never holds a full "
                "histogram")
    if args.resume_hist and args.stripes > 1:
        raise SystemExit(
            "--resume-hist is not supported with --stripes (striped "
            "accumulation rebuilds the histogram from scratch)")

    from cuburn_tpu_torch.profile import get_profile
    from cuburn_tpu_torch.device import resolve_device
    from cuburn_tpu_torch.render import Renderer

    overrides = {}
    for field in ("width", "height", "quality", "ss"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    if args.temporal_samples is not None:
        overrides["temporal_samples"] = args.temporal_samples
    if args.fps is not None:
        overrides["fps"] = args.fps
    if args.duration is not None:
        overrides["duration"] = args.duration
    if args.hist_backend is not None:
        overrides["hist_backend"] = args.hist_backend
    if args.no_de:
        overrides["de_enabled"] = False
    prof = get_profile(args.profile, **overrides)

    if args.devices and args.devices > 1:
        import torch.multiprocessing

        from cuburn_tpu_torch.parallel import launch
        devices, backend = _sharded_devices(args)
        try:
            launch.spawn(_render_rank, devices, backend, args, genome,
                         sequence, prof)
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            raise SystemExit(f"cuburn-tpu-torch: a rank of --devices "
                             f"{args.devices} failed: {e}")
        return 0
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:       # no GPU: say so, do not fall back
        raise SystemExit(f"cuburn-tpu-torch: {e}")
    renderer = Renderer(genome, prof, device=device)
    with _traced(args.trace_dir, device):
        _render(args, renderer, sequence, write=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
