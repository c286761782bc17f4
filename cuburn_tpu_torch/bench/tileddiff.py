"""The per-bin differential where the histogram is tiled.

Port of `bench/tileddiff.py`.  The headline's scatter-against-pallas_win
check runs at 512x512, whose histogram sits in the card's L2.  This
runs the same differential where the float32 histogram is past L2
(`render.histogram_tiled`, the port's meaning of "tiled"), so win_flush
streams it from device memory.  The JAX probe's 1280x720 default fits
in an H100's 50 MB L2, so the default geometry here is the main path's
accumulator, full_feature's 1080p ss2 frame with its gutter: 3896x2216
at ss 1, 8,633,536 bins, a 138 MB histogram.  A geometry that is not
tiled is refused.

Density must be bit-exact per bin (identical trajectories, integer
counts in any order); rgb is compared relative to each bin's density
(< 0.02).  Batch 2^15 on the card, 2^11 with `--cpu`.

Usage: python -m cuburn_tpu_torch.bench.tileddiff [--ipc 256] [--chunks 4]
       [--width 3896] [--height 2216] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from cuburn_tpu_torch import render
from cuburn_tpu_torch.bench._card import Chaos, bin_differential, card
from cuburn_tpu_torch.ops.iterate import hist_alloc_for, iterate_accumulate
from cuburn_tpu_torch.utils.timing import sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ipc", type=int, default=256,
                    help="steps a flush (records a flush = batch * ipc)")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--width", type=int, default=3896)
    ap.add_argument("--height", type=int, default=2216)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device, name = card(args.cpu)
    ff = Chaos.full_feature(args.width, args.height, device)
    B = 1 << 11 if args.cpu else 1 << 15
    n_bins = ff.cam.n_bins
    tiled = render.histogram_tiled(n_bins, device)
    l2 = (torch.cuda.get_device_properties(device).L2_cache_size
          if device.type == "cuda" else None)
    print(json.dumps({"probe": "tiled-per-bin-differential",
                      "device": name, "n_bins": n_bins,
                      "hist_bytes": (n_bins + 1) * 16, "l2_bytes": l2,
                      "tiled": tiled, "B": B, "ipc": args.ipc,
                      "chunks": args.chunks}), flush=True)
    if not tiled:
        raise ValueError(f"{args.width}x{args.height} is not tiled: its "
                         "histogram fits the card's L2; raise the dims")

    logical = {}
    for backend in ("scatter", "pallas_win"):
        hist = hist_alloc_for(backend, n_bins, device)
        _state, hist, n = iterate_accumulate(
            ff.key, ff.cam, backend, ff.params, ff.cdf, ff.state(B, device),
            hist, ff.ppu, args.chunks, args.ipc, 32)
        sync(device)
        logical[backend] = hist[:-1]
        print(json.dumps({"backend": backend, "plotted": int(n)}),
              flush=True)

    diff = bin_differential(logical["scatter"], logical["pallas_win"])
    out = {"mass": float(torch.sum(logical["scatter"][:, 3])), **diff,
           "ok": diff["max_bin_err_density"] == 0.0
           and diff["max_bin_err_rgb_rel"] < 0.02}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
