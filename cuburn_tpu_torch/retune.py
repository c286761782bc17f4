"""`cuburn-tpu-torch-retune`: re-tune the renderer's card-dependent
choices on the card it runs on.

The port's counterpart of `cuburn_tpu/retune.py`:

  1. races the histogram backends (scatter / scatter_sorted /
     pallas_win, and pallas_rgb16 where the histogram is tiled)
     in-loop, chained, at two histogram sizes: 512x512, and
     `TILED_DIMS`, the main path's 1080p-ss2 accumulator, whose
     histogram is past the card's L2 cache (render.histogram_tiled)
  3. sweeps the flush size K (records per sort+flush = B*K) at 512x512
     3b. and at the tiled size, escalating until the card runs out of
     memory

Every race row runs twice, the whole list once and then again (in
turns, so a drift of the host's clock spreads over all rows), and both
rates are kept (`passes`).  The largest relative move of any row
between its passes is the race's own noise (`spread`).  A pick
replaces the built-in default only where its mean leads the default's
by more than that (`stands_out`); otherwise the record keeps the
default backend (pallas_win) and leaves the flush-size key out, so the
Renderer keeps its built-in flush size.  Where the loop is bound by
host launches, as on an H100, the rows move more between passes than
the candidates differ, and the record holds the defaults.

The record goes where `Renderer` reads it on the same card
(render._load_tune): the file CUBURN_TUNE_FILE names, or
./cuburn_tune_cuda.json.  Delete the file for the built-in defaults.
The record is gated on the card's name (`torch.cuda.get_device_name`),
so a record for another device is skipped.

The JAX tuner's sections 2, 2b and 2c race the segmented sub-sort
(`sort_segments`) and the sort implementation (`sort_impl`); the port
has one sort (the tiled bitonic kernel on the card) and no segments,
so those sections and keys are left out.  So is its section 4
(`--probe-dims`, the `dim_cap` key): no Renderer reads `dim_cap`.

Usage: cuburn-tpu-torch-retune [--out FILE] [--quick] [--cpu]

It runs on the GPU and fails without one; `--cpu` runs the same races
on the CPU (the kernels' plain versions), for a record gated to "cpu".
CUBURN_RETUNE_BATCH and CUBURN_RETUNE_CHUNKS shrink the sweeps; only
the default sizes measure a tune.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import torch

# the two histogram sizes of the backend race and the flush-size
# sweeps (width, height at ss 1): one well inside the card's L2 cache,
# and the main path's 1080p-ss2 accumulator with full_feature's gutter
# (8.63 M bins, 138 MB), which is past it
UNTILED_DIMS = (512, 512)
TILED_DIMS = (3896, 2216)
CANDIDATES = ("scatter", "scatter_sorted", "pallas_win")
TILED_CANDIDATES = CANDIDATES + ("pallas_rgb16",)
RGB16_PROMOTE_MARGIN = 1.05
# what `auto` takes on the card without a record: the reference a pick
# must stand out from
DEFAULT_BACKEND = "pallas_win"
PASSES = 2


def race(key, cam, params, cdf, ppu, backend, B, K, n_chunks, iters=1):
    """Chained in-loop measurement through utils.timing.time_fn: one
    warm-up call, then `iters` timed calls, each starting from the
    trajectories the previous one left.  Returns M iters/s."""
    from cuburn_tpu_torch.ops.iterate import (hist_alloc_for, init_state,
                                              iterate_accumulate)
    from cuburn_tpu_torch.utils.timing import time_fn
    device = cdf.device
    hist = hist_alloc_for(backend, cam.n_bins, device)
    state = init_state(torch.Generator().manual_seed(0), B, device)

    def fn(st):
        return iterate_accumulate(key, cam, backend, params, cdf, st,
                                  hist, ppu, n_chunks, K, 32)

    dt, _ = time_fn(fn, state, warmup=1, iters=iters,
                    chain=lambda out, _args: (out[0],))
    return n_chunks * B * K / dt / 1e6


def pick_tiled_backend(m: dict, candidates, label: str = "tiled") -> str:
    """Per-geometry tiled-backend choice from the race measurements
    (`m[f"{backend}@{label}"]`).

    The exact-f32 winner among `candidates` takes the slot unless
    pallas_rgb16 (bf16 color, one rounding a bin a flush, traded for
    fewer bytes moved a flush) beats it by more than
    RGB16_PROMOTE_MARGIN: exactness is only traded for a real
    margin."""
    best = max(candidates, key=lambda b: m[f"{b}@{label}"])
    rgb16 = m.get(f"pallas_rgb16@{label}")
    if isinstance(rgb16, (int, float)) \
            and rgb16 > RGB16_PROMOTE_MARGIN * m[f"{best}@{label}"]:
        return "pallas_rgb16"
    return best


def race_spread(passes: dict) -> float:
    """The largest relative move of any race row between its passes:
    the race's own noise."""
    return max((max(rs) - min(rs)) / min(rs) for rs in passes.values())


def stands_out(m: dict, row: str, ref: str, spread: float) -> bool:
    """Whether race row `row` leads row `ref` by more than `spread`."""
    return m[row] > (1 + spread) * m[ref]


def stamp(tune: dict) -> dict:
    """Timestamp and code-rev stamp: render._load_tune warns when it
    applies a dated record or one measured at another rev."""
    from cuburn_tpu_torch.render import _current_git_rev
    tune["timestamp"] = datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")
    rev = _current_git_rev()
    if rev:
        tune["git_rev"] = rev
    return tune


def build_parser() -> argparse.ArgumentParser:
    from cuburn_tpu_torch.render import TUNE_FILE
    ap = argparse.ArgumentParser(
        prog="cuburn-tpu-torch-retune",
        description="race the histogram backends and flush sizes on "
                    "this card and write a tune record")
    ap.add_argument("--out", default=os.environ.get("CUBURN_TUNE_FILE",
                                                    TUNE_FILE),
                    help="where the record goes (default: "
                         "$CUBURN_TUNE_FILE, else ./%(default)s)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer sweep points")
    ap.add_argument("--cpu", action="store_true",
                    help="race on the CPU (the default is the GPU, with "
                         "no fallback)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from cuburn_tpu_torch.device import resolve_device
    from cuburn_tpu_torch.models import full_feature
    from cuburn_tpu_torch.ops.camera import CameraSpec
    from cuburn_tpu_torch.ops.iterate import xform_cdf_rows
    from cuburn_tpu_torch.params import params_from_genome
    from cuburn_tpu_torch.render import DEFAULT_ITERS_PER_CHUNK, device_name

    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:       # no GPU: say so, do not fall back
        raise SystemExit(f"cuburn-tpu-torch-retune: {e}")
    g = full_feature()
    key = g.structure_key()
    params = params_from_genome(g.eval_at(0.0), device)
    cdf = xform_cdf_rows(params)
    # sweep sizes: the env overrides let the tool run end to end at toy
    # sizes (the measured values are then meaningless; only the
    # default sizes give a real tune)
    B = int(os.environ.get("CUBURN_RETUNE_BATCH", 1 << 15))
    n_chunks = int(os.environ.get("CUBURN_RETUNE_CHUNKS",
                                  8 if args.quick else 16))

    l2 = (torch.cuda.get_device_properties(device).L2_cache_size
          if device.type == "cuda" else None)
    tune = {"device": device_name(device), "torch": torch.__version__,
            "cuda": torch.version.cuda, "l2_bytes": l2,
            "measurements": {}}
    m = tune["measurements"]

    def cam_for(W, H):
        return CameraSpec(W, H, 1), \
            params.ppu * float(W / g.size[0])

    def race_at(dims, backend, K, nc):
        cam, ppu = cam_for(*dims)
        return race(key, cam, params, cdf, ppu, backend, B, K, nc)

    # the race rows: (name, dims, backend, K, chunks)
    # 1. the backends at both sizes (pallas_rgb16 halves the rgb bytes
    # a flush moves, which only pays where the histogram is past L2)
    rows = [(f"{b}@{label}", dims, b, 64, n_chunks)
            for label, dims, cands in (("512", UNTILED_DIMS, CANDIDATES),
                                       ("tiled", TILED_DIMS,
                                        TILED_CANDIDATES))
            for b in cands]
    # 3. flush size K, as RECORDS per flush (B*K): the Renderer divides
    # by its profile's own batch.  3b. the same at the tiled size, where
    # a flush streams the histogram, so bigger flushes may amortise it
    # until the sort's O(n log^2 n) growth wins or the card runs out of
    # memory (then the sweep stops escalating).  Each list holds the
    # built-in flush size, the reference a pick must stand out from.
    k_ref = DEFAULT_ITERS_PER_CHUNK
    k_list = (32, 64) if args.quick else (16, 32, 64, 128, 256)
    k_tiled = (32, 256) if args.quick else (32, 64, 128, 256, 512)
    rows += [(f"K={k}", UNTILED_DIMS, "pallas_win", k,
              max(1, n_chunks * 64 // k)) for k in k_list]
    rows += [(f"K_tiled={k}", TILED_DIMS, "pallas_win", k,
              max(1, n_chunks * 64 // k)) for k in k_tiled]

    passes: dict = {}
    oom_k = None                    # the first tiled K out of memory
    for _ in range(PASSES):
        for name, dims, backend, k, nc in rows:
            tiled_k = name.startswith("K_tiled=")
            if tiled_k and oom_k is not None and k >= oom_k:
                continue
            try:
                r = race_at(dims, backend, k, nc)
            except torch.cuda.OutOfMemoryError as e:
                if not tiled_k:
                    raise
                oom_k = k
                m[name] = f"out of memory: {str(e)[:80]}"
                passes.pop(name, None)
                print(json.dumps({"race": name, "ok": False}), flush=True)
                continue
            passes.setdefault(name, []).append(round(r, 3))
            print(json.dumps({"race": name, "M_iters_per_s": round(r, 3)}),
                  flush=True)
    for name, rs in list(passes.items()):
        if len(rs) < PASSES:    # past a tiled K that ran out of memory
            del passes[name]
        else:
            m[name] = round(sum(rs) / len(rs), 3)
    tune["passes"] = passes
    spread = tune["spread"] = round(race_spread(passes), 4)

    best = max(CANDIDATES, key=lambda b: m[f"{b}@512"])
    tune["hist_backend"] = (best if stands_out(
        m, f"{best}@512", f"{DEFAULT_BACKEND}@512", spread)
        else DEFAULT_BACKEND)
    best = pick_tiled_backend(m, CANDIDATES)
    tune["hist_backend_tiled"] = (best if stands_out(
        m, f"{best}@tiled", f"{DEFAULT_BACKEND}@tiled", spread)
        else DEFAULT_BACKEND)
    # a flush size stands only where it leads the built-in one; without
    # the key the Renderer keeps its own
    for prefix, ks, rec_key in (("K", k_list, "flush_records"),
                                ("K_tiled", k_tiled, "tiled_flush_records")):
        if f"{prefix}={k_ref}" not in passes:
            continue
        timed = [k for k in ks if f"{prefix}={k}" in passes]
        best_k = max(timed, key=lambda k: m[f"{prefix}={k}"])
        if stands_out(m, f"{prefix}={best_k}", f"{prefix}={k_ref}",
                      spread):
            tune[rec_key] = B * best_k

    stamp(tune)
    with open(args.out, "w") as f:
        json.dump(tune, f, indent=1)
    print(json.dumps({"tune_written": args.out, "device": tune["device"],
                      "hist_backend": tune["hist_backend"],
                      "hist_backend_tiled": tune["hist_backend_tiled"],
                      "flush_records": tune.get("flush_records"),
                      "tiled_flush_records":
                          tune.get("tiled_flush_records")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
