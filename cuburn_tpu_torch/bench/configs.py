"""The five binding configurations of BASELINE.md, end to end.

Port of `bench/configs.py`.  Each configuration renders (accumulate +
filters) in its own process with synchronised host timing and prints
one JSON record, with the JAX suite's keys; the suite then prints a
summary line.  Sizes as `bench/configs.py:64-92`, at scale 1.0 on the
card and 0.1 with `--quick` or `--cpu`; batch 2^15 (2^12 with `--cpu`),
the flush size and the backend automatic:

  1. sierpinski 512x512, 1M samples, log tonemap (affine only)
  2. classic_swirl 1280x720, q500: classic variations, palette,
     gamma and vibrancy
  3. full_feature 1920x1080, q1000: every variation feature,
     parametric variations, a final xform, xaos
  4. classic_swirl 1920x1080, ss 2, q2000, adaptive DE
  5. animated_spark 1280x720, q200, 4 temporal samples (motion blur)

Configurations 3 and 4 at full scale warm a q1 render and its filter,
then time accumulate + finalize; `CUBURN_BENCH_STRIPED=1` accumulates
them in stripes and `CUBURN_BENCH_BANDS=1` filters them in bands (one
per 1.5 M bins).  The others warm one render_frame and time more.
`CUBURN_BENCH_SHOTS` timed shots (2), the last reported.

Left out of the JAX suite:
- `dim_cap` (`:41-48`), a cap for a dev-TPU worker that neither
  package reads any more, so configurations 3 and 4 run at 1920x1080
  directly instead of through a replacement profile (`:103-105`);
- `dispatch_iter_cap`, a TPU knob the port dropped;
- the sleeps that let a TPU worker come back, and the per-config
  timeout's environment variable: a configuration that takes more
  than CONFIG_TIMEOUT_S fails;
- the catches around the warm filter and the timed finalize: a failure
  raises, the suite runs the other configurations and exits non-zero.

Usage: python -m cuburn_tpu_torch.bench.configs [--quick] [--cpu] [--config N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from cuburn_tpu_torch.bench._card import card
from cuburn_tpu_torch.models import (animated_spark, classic_swirl,
                                     full_feature, sierpinski)
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.render import Renderer

CONFIGS = (1, 2, 3, 4, 5)
# the slowest configuration (4) takes seconds on an H100
CONFIG_TIMEOUT_S = 1500
# bins a stripe or a band holds under CUBURN_BENCH_STRIPED / _BANDS
PART_BINS = 1_500_000


def profile(idx: int, scale: float, batch: int):
    """(genome, RenderProfile) of configuration idx at `scale` of the
    binding sizes, which stand as they are at 1.0 and are otherwise
    rounded down to multiples of 16, at least 64."""
    def sz(x):
        return x if scale == 1.0 else max(64, int(x * scale ** 0.5) // 16 * 16)

    common = dict(batch=batch, iters_per_chunk=0, fuse=32,
                  hist_backend="auto")
    if idx == 1:
        return sierpinski(), RenderProfile(
            width=sz(512), height=sz(512),
            quality=max(4, int(1_000_000 * scale) // (sz(512) ** 2) + 1),
            de_enabled=False, **common)
    if idx == 2:
        return classic_swirl(), RenderProfile(
            width=sz(1280), height=sz(720), quality=max(8, int(500 * scale)),
            de_enabled=False, **common)
    if idx == 3:
        return full_feature(), RenderProfile(
            width=sz(1920), height=sz(1080),
            quality=max(8, int(1000 * scale)), de_enabled=False, **common)
    if idx == 4:
        return classic_swirl(), RenderProfile(
            width=sz(1920), height=sz(1080), ss=2,
            quality=max(8, int(2000 * scale)), de_enabled=True, **common)
    if idx == 5:
        return animated_spark(), RenderProfile(
            width=sz(1280), height=sz(720), quality=max(8, int(200 * scale)),
            temporal_samples=4, de_enabled=False, **common)
    raise ValueError(f"no configuration {idx}; have {CONFIGS}")


def run_config(idx: int, quick: bool, device) -> dict:
    """Render configuration idx on `device`, print its record and
    return it."""
    on_card = device.type == "cuda"
    scale = 1.0 if on_card and not quick else 0.1
    g, prof = profile(idx, scale, 1 << 15 if on_card else 1 << 12)
    r = Renderer(g, prof, device)
    shots = int(os.environ.get("CUBURN_BENCH_SHOTS", "2"))
    shot_rates = []
    stripes = 0
    if idx in (3, 4) and scale == 1.0:
        if os.environ.get("CUBURN_BENCH_STRIPED", "0") == "1":
            stripes = max(2, -(-r.cam.n_bins // PART_BINS))
        n_bands = (max(2, -(-r.cam.n_bins // PART_BINS))
                   if os.environ.get("CUBURN_BENCH_BANDS") == "1" else 1)

        def frame(rr, seed):
            if stripes:
                hist, stats = rr.accumulate_striped(0.2, seed,
                                                    n_stripes=stripes)
            else:
                hist, stats = rr.accumulate(0.2, seed)
            if n_bands > 1:
                rr.finalize_frame_banded(hist, 0.2, stats, n_bands=n_bands)
            else:
                rr.finalize_frame(hist, 0.2, stats)
            return stats

        frame(Renderer(g, dataclasses.replace(prof, quality=1), device), 1)
        for shot in range(shots):
            t0 = time.perf_counter()
            stats = frame(r, 2 + shot)
            wall = time.perf_counter() - t0
            shot_rates.append(round(stats.samples_per_sec, 1))
    else:
        r.render_frame(0.2, seed=1)                     # warm
        for shot in range(shots):
            t0 = time.perf_counter()
            _img, stats = r.render_frame(0.2, seed=2 + shot)
            wall = time.perf_counter() - t0
            shot_rates.append(round(stats.samples_per_sec, 1))
    rec = {
        "config": idx, "genome": g.name,
        "size": f"{prof.width}x{prof.height}", "ss": prof.ss,
        "quality": prof.quality,
        "temporal_samples": prof.temporal_samples,
        "plotted_samples": stats.plotted_samples,
        "samples_per_sec": round(stats.samples_per_sec, 1),
        "retention": round(stats.retention, 3),
        "iterate_ms": round(stats.iterate_s * 1e3, 1),
        "filter_ms": round(stats.filter_s * 1e3, 1),
        "frame_wall_s": round(wall, 2),
        "backend": r.backend,
        "stripes": stripes,
    }
    if len(shot_rates) > 1:
        rec["samples_per_sec_shots"] = shot_rates
    print(json.dumps(rec), flush=True)
    return rec


def run_suite(indices, quick: bool, cpu: bool, device_name: str) -> int:
    """Each configuration of `indices` in its own process; their
    records, an error record for each that failed, and the summary.
    Returns 1 if any failed, else 0."""
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")]))}
    recs, failed = [], []
    for i in indices:
        cmd = [sys.executable, "-m", "cuburn_tpu_torch.bench.configs",
               "--config", str(i)] + ["--quick"] * quick + ["--cpu"] * cpu
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=CONFIG_TIMEOUT_S, env=env)
        except subprocess.TimeoutExpired:
            print(json.dumps({"config": i, "error":
                              f"timeout after {CONFIG_TIMEOUT_S}s"}),
                  flush=True)
            failed.append(i)
            continue
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rec = json.loads(line)
                if "samples_per_sec" in rec:
                    recs.append(rec)
        if out.returncode:
            sys.stderr.write(out.stderr)
            last = (out.stderr.strip().splitlines() or [""])[-1]
            print(json.dumps({"config": i, "error": last[:200],
                              "returncode": out.returncode}), flush=True)
            failed.append(i)
    best = max((r["samples_per_sec"] for r in recs), default=0)
    print(json.dumps({"summary": "best_samples_per_sec", "value": best,
                      "completed": [r["config"] for r in recs],
                      "failed": failed, "device": device_name}), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sizes even on the card")
    ap.add_argument("--config", type=int, help="run only config N (1-5)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (small sizes)")
    args = ap.parse_args(argv)
    device, name = card(args.cpu)
    if args.config:
        run_config(args.config, args.quick, device)
        return 0
    return run_suite(CONFIGS, args.quick, args.cpu, name)


if __name__ == "__main__":
    raise SystemExit(main())
