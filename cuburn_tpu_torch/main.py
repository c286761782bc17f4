"""`cuburn-tpu-torch`: render a still frame with the PyTorch/CUDA port.

The stills path of `cuburn_tpu/main.py`, reusing its argument parser
and genome loader (neither imports JAX):

    cuburn-tpu-torch gallery:full_feature -o out.png --profile 1080p
    cuburn-tpu-torch genome.flam3 -o out.png --cpu

The render runs on CUDA unless `--cpu` asks for the CPU; without a GPU
the CUDA default fails instead of falling back.
Flags for paths the port does not have yet are refused.
"""

from __future__ import annotations

import sys


def _refuse_unported(args) -> None:
    refused = [
        ("--animate", args.animate),
        ("--devices", args.devices is not None and args.devices > 1),
        ("--reduce-scatter", args.reduce_scatter),
        ("--stripes", args.stripes > 1),
        ("--bands", args.bands > 1),
        ("--blend", args.blend is not None),
        ("--trace-dir", args.trace_dir is not None),
    ]
    for flag, used in refused:
        if used:
            raise SystemExit(
                f"cuburn-tpu-torch: {flag} is not ported yet (stills on "
                "one device only; see ROADMAP.md queue A)")


def main(argv=None) -> int:
    from cuburn_tpu.main import (_append_metrics, _stats_record,
                                 build_parser, load_genome)
    parser = build_parser()
    parser.prog = "cuburn-tpu-torch"
    parser.description = ("fractal flame renderer (flam3/cuburn-"
                          "compatible) on PyTorch and CUDA")
    args = parser.parse_args(argv)
    _refuse_unported(args)

    genome = load_genome(args.genome, args.flame_index,
                         angle_units=args.cam_angle_units)
    if args.convert:
        print(genome.to_json())
        return 0

    import numpy as np

    from cuburn_tpu import output as output_mod
    from cuburn_tpu.profile import get_profile
    from cuburn_tpu_torch.device import resolve_device
    from cuburn_tpu_torch.render import Renderer

    overrides = {}
    for field in ("width", "height", "quality", "ss"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    if args.temporal_samples is not None:
        overrides["temporal_samples"] = args.temporal_samples
    if args.hist_backend is not None:
        overrides["hist_backend"] = args.hist_backend
    if args.no_de:
        overrides["de_enabled"] = False
    prof = get_profile(args.profile, **overrides)
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:       # no GPU: say so, do not fall back
        raise SystemExit(f"cuburn-tpu-torch: {e}")
    renderer = Renderer(genome, prof, device=device)

    hist0 = None
    if args.resume_hist:
        try:
            hist0 = np.load(args.resume_hist)
        except FileNotFoundError:
            raise SystemExit(
                f"resume histogram not found: {args.resume_hist}")
    if args.save_hist or hist0 is not None:
        hist, stats = renderer.accumulate(args.time, args.seed,
                                          hist0=hist0)
        if args.save_hist:
            np.save(args.save_hist, hist.cpu().numpy())
        img = renderer.finalize_frame(hist, args.time, stats)
    else:
        img, stats = renderer.render_frame(args.time, seed=args.seed)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
