#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--quality Q]

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit.  Phases, each printed on its own line:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile csrc/win_flush.cu with nvcc (sm_90a)
  3. kernel   the windowed-flush kernel against its plain PyTorch
              version at the main path's shapes (2^22 records into the
              8.63 M-bin 1080p-ss2 histogram): density bit-exact with a
              3-column palette at weight 1.0, every channel within 1e-5
              of the bin's density with the 4-column opacity palette at
              weight 0.37; median of 10 timed calls for both
  4. render   Renderer(full_feature, 1080p profile at quality Q)
              .render_frame on cuda through the kernel; the PNG goes to
              smoke_out/ in the checkout
  5. parity   sierpinski and full_feature at 128x128 on cuda against
              the same render on the CPU (the flush's plain version):
              TV distance of the normalised density histograms under 3x
              the CPU path's two-seed floor

Then one JSON line describing each kernel, and last
{"ok": true, "device": {...}}.  Any failed check exits non-zero before
the last line.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "cuburn_tpu_torch/csrc/win_flush.cu"
KERNEL_REPLACES = "cuburn_tpu/ops/pallas_hist.py:348"


def check(cond, msg):
    """End the run with a non-zero exit and the reason on stderr."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(n, name, **fields):
    print(f"phase {n} {name}: " + json.dumps(fields), flush=True)


def timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def flush_records(torch, n, n_bins, acc_width, bits, gen):
    """Packed records shaped like one 1080p flush: 60% spread over the
    frame, 30% in a hot 128x128 patch mid-frame (~75 records a bin),
    10% junk."""
    n_spread, n_hot = int(n * 0.6), int(n * 0.3)
    spread = torch.randint(0, n_bins, (n_spread,), generator=gen)
    hot = n_bins // 2 + torch.randint(0, 128, (n_hot,), generator=gen) \
        * acc_width + torch.randint(0, 128, (n_hot,), generator=gen)
    junk = torch.full((n - n_spread - n_hot,), n_bins)
    addr = torch.cat([spread, hot, junk])
    q = torch.randint(0, 1 << bits, (n,), generator=gen)
    rec = (addr << bits) | q
    return rec[torch.randperm(n, generator=gen)]


def phase_kernel(torch, flush, thist, n_bins, acc_width):
    """Kernel against its plain version on the card (phase 3)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    n = 1 << 22
    sync = torch.cuda.synchronize
    results, max_err = {}, 0.0
    for cols, bits, weight in ((3, 8, 1.0), (4, 10, 0.37)):
        rec = flush_records(torch, n, n_bins, acc_width, bits,
                            gen).to(dev)
        pal = torch.rand((1 << bits, cols), generator=gen).to(dev)
        if cols == 4:
            pal[:, :3] *= pal[:, 3:]        # rgb * opacity, opacity
        got = flush.accumulate_windowed(thist.alloc(n_bins, dev), rec,
                                        pal, n_bins, bits, weight)
        ref = flush.accumulate_windowed_reference(
            thist.alloc(n_bins, dev), rec, pal, n_bins, bits, weight)
        sync()
        got, ref = got[:n_bins], ref[:n_bins]
        err = (got - ref).abs()
        bound = 1e-5 * torch.clamp(ref[:, 3:], min=1.0)
        check(bool((err <= bound).all()),
              f"kernel disagrees: max err {float(err.max())} "
              f"({cols}-column palette, weight {weight})")
        if cols == 3:
            check(torch.equal(got[:, 3], ref[:, 3]),
                  "density not bit-exact at weight 1.0")
        check(float(ref[:, 3].sum()) > 0, "flush added no mass")
        max_err = max(max_err, float(err.max()))

        hk, hr = thist.alloc(n_bins, dev), thist.alloc(n_bins, dev)
        srt = torch.sort(rec).values
        pal4 = flush._pal4(pal).contiguous()
        k_ms, p_ms, only_ms, sort_ms = [], [], [], []
        for _ in range(11):                 # the first pair warms up
            k_ms.append(timed(lambda: flush.accumulate_windowed(
                hk, rec, pal, n_bins, bits, weight), sync))
            p_ms.append(timed(lambda: flush.accumulate_windowed_reference(
                hr, rec, pal, n_bins, bits, weight), sync))
            only_ms.append(timed(lambda: flush._launch(
                hk, srt, pal4, n_bins, bits, weight), sync))
            sort_ms.append(timed(lambda: torch.sort(rec), sync))
        med = {k: statistics.median(v[1:]) for k, v in (
            ("ms", k_ms), ("plain_ms", p_ms), ("kernel_only_ms", only_ms),
            ("sort_ms", sort_ms))}
        results[cols] = med
        phase(3, "kernel", palette_cols=cols, weight=weight, records=n,
              bins=n_bins, max_abs_err=float(err.max()),
              density_exact=cols == 3, **med)
    return results[3], max_err


def tv_distance(a, b):
    da = a[:-1, 3].double().cpu()
    db = b[:-1, 3].double().cpu()
    return 0.5 * float((da / da.sum() - db / db.sum()).abs().sum())


def phase_render(torch, flush, write_image, r, quality):
    """The main path on the card (phase 4): returns the kernel's
    launches during render_frame."""
    check(r.backend == "pallas_win",
          f"backend {r.backend}, expected pallas_win")
    flush.LAUNCHES = 0
    img, stats = r.render_frame(0.0, seed=1)
    launches = flush.LAUNCHES
    check(launches > 0, "the 1080p render launched no kernel")
    check(stats.plotted_samples > 0, "no samples plotted")
    check(img.shape == (1080, 1920, 4), f"image shape {img.shape}")
    check(bool(img[..., :3].any()), "the image is black")
    out_dir = os.path.join(REPO, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "chip_smoke_full_feature_1080p.png")
    write_image(png, img)
    # the histogram behind such a frame: finite, and its mass is the
    # plotted count (a second pass, after the launches are read).  The
    # mass is exact in float64; the plotted counter is float32, as in
    # the JAX package, so past 2^24 it carries its own rounding.
    hist, st2 = r.accumulate(0.0, seed=2)
    check(bool(torch.isfinite(hist).all()), "non-finite histogram")
    mass = float(hist[:-1, 3].double().sum())
    check(abs(mass - st2.plotted_samples) <= 1e-4 * mass,
          f"histogram mass {mass} != plotted samples "
          f"{st2.plotted_samples}")
    prof, cam = r.profile, r.cam
    phase(4, "render", genome="full_feature", profile="1080p",
          quality=quality, acc=[cam.acc_width, cam.acc_height],
          bins=cam.n_bins, batch=prof.batch,
          iters_per_chunk=prof.iters_per_chunk,
          records_per_flush=prof.batch * prof.iters_per_chunk,
          backend=r.backend, launches=launches,
          plotted_samples=stats.plotted_samples,
          total_iters=stats.total_iters,
          samples_per_s=stats.samples_per_sec,
          iterate_s=stats.iterate_s, filter_s=stats.filter_s,
          lit_fraction=float((img[..., :3] > 0).any(-1).mean()),
          png=os.path.relpath(png, REPO))
    return launches


def phase_parity(torch, Renderer, RenderProfile, g):
    """CUDA against CPU by distribution at 128x128 (phase 5).  One seed
    gives both devices the same starting trajectories."""
    prof = RenderProfile(width=128, height=128, quality=100,
                         hist_backend="pallas_win", de_enabled=False)
    h_cu, s_cu = Renderer(g, prof, device="cuda").accumulate(0.0, seed=11)
    cpu = Renderer(g, prof, device="cpu")
    h_a, _ = cpu.accumulate(0.0, seed=11)
    h_b, _ = cpu.accumulate(0.0, seed=12)
    check(bool(torch.isfinite(h_cu).all()), "non-finite histogram")
    floor = tv_distance(h_a, h_b)
    d = tv_distance(h_cu, h_a)
    phase(5, "parity", genome=g.name, tv_cuda_vs_cpu=d,
          tv_cpu_two_seed_floor=floor, limit=3 * floor,
          plotted=s_cu.plotted_samples)
    check(d < 3 * floor, f"{g.name}: TV {d} >= 3x floor {floor}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quality", type=int, default=100,
                    help="samples per output pixel of the 1080p render")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cuburn_tpu.models import full_feature, sierpinski
    from cuburn_tpu.output import write_image
    from cuburn_tpu.profile import RenderProfile, get_profile
    from cuburn_tpu_torch.kernels import build
    from cuburn_tpu_torch.ops import flush
    from cuburn_tpu_torch.ops import histogram as thist
    from cuburn_tpu_torch.render import Renderer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase(1, "device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = build.build("win_flush")
    build.load("win_flush")
    phase(2, "build", seconds=round(time.perf_counter() - t0, 3),
          library=os.path.relpath(lib, REPO))

    main_r = Renderer(full_feature(),
                      get_profile("1080p", quality=args.quality))
    times, max_err = phase_kernel(torch, flush, thist, main_r.cam.n_bins,
                                  main_r.cam.acc_width)
    launches = phase_render(torch, flush, write_image, main_r,
                            args.quality)
    for genome in (sierpinski, full_feature):
        phase_parity(torch, Renderer, RenderProfile, genome())

    print(json.dumps({"kernels": [{
        "name": "win_flush", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": times["ms"],
        "plain_ms": times["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
