"""A whole render on the card against the same render on the CPU.

Port of `bench/tpuparity.py`.  full_feature at 32x32 (batch 4096, 16
steps a flush, fuse 20, DE off) accumulates `n_samples` samples on the
card through `scatter` and through `pallas_win` (the chaos kernel, the
tiled sort and win_flush) and on the CPU through `scatter` (the plain
versions) at seeds 11 and 12; the normalised densities meet by
total-variation distance, against the CPU's own two-seed floor.

Why distributional: the chaos game is chaotic, so one ulp of a
transcendental decorrelates trajectories, and what must agree is the
attractor's measure.  The per-kernel differentials (the headline's per
bin, tileddiff) hold the flushes alone; this holds iterate -> sort ->
flush end to end.  Pass rule, per backend: d < 0.05 and
d < max(4 x floor, 0.03).

The CPU renders run in this process: the JAX probe's subprocess was
there for the TPU plugin.  With `--cpu` the "card" renders run on the
CPU too.

Usage: python -m cuburn_tpu_torch.bench.parity [n_samples=600000] [--cpu]
Prints one JSON line a comparison and a verdict line; exits 1 when the
verdict fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cuburn_tpu_torch.bench._card import card, tv
from cuburn_tpu_torch.models import full_feature
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.render import Renderer

W = H = 32
SEEDS = (11, 12)


def accumulate(backend: str, seed: int, quality: int, device) -> np.ndarray:
    """full_feature's logical histogram at the probe's profile, as
    float64 numpy."""
    prof = RenderProfile(width=W, height=H, quality=quality, batch=4096,
                         iters_per_chunk=16, fuse=20, hist_backend=backend,
                         de_enabled=False)
    hist, _ = Renderer(full_feature(), prof, device).accumulate(0.0,
                                                                seed=seed)
    return hist.cpu().numpy().astype(np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_samples", nargs="?", type=int, default=600_000)
    ap.add_argument("--cpu", action="store_true",
                    help="run the 'card' renders on the CPU as well")
    args = ap.parse_args(argv)
    device, name = card(args.cpu)
    quality = int(np.ceil(args.n_samples / (W * H)))

    cpu = {}
    for seed in SEEDS:
        t0 = time.perf_counter()
        cpu[seed] = accumulate("scatter", seed, quality, "cpu")
        print(json.dumps({"cpu_render": {"seed": seed, "s": round(
            time.perf_counter() - t0, 1)}}), flush=True)
    floor = tv(cpu[11], cpu[12])
    print(json.dumps({"noise_floor_tv_cpu_seed11_vs_12": round(floor, 4)}),
          flush=True)

    results = {"noise_floor": round(floor, 4), "device": name}
    ok = True
    for hb in ("scatter", "pallas_win"):
        hist = accumulate(hb, 11, quality, device)
        d = tv(hist, cpu[11])
        # within the anchor tests' absolute bound and not far above the
        # two-seed floor (when the backends agree, tv ~ floor)
        this_ok = bool(d < 0.05 and d < max(4.0 * floor, 0.03))
        ok = ok and this_ok
        results[f"tv_{hb}_vs_cpu"] = round(d, 4)
        print(json.dumps({"device_backend": hb,
                          "mass": float(hist[:-1, 3].sum()),
                          "tv_vs_cpu": round(d, 4), "ok": this_ok}),
              flush=True)
    results["ok"] = ok
    print(json.dumps({"card_cpu_parity": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
