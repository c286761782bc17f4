"""Every histogram backend against a numpy bincount, with its rate.

Port of `sortbench.py` (the reference cuburn's sortbench validated its
radix sort against numpy and reported its rate; this validates every
histogram flush the same way).  Inputs as the JAX tool builds them from
`RandomState(0)`: 2^21 records over 2^18 bins by default, 30% of them
in 64 hot bins, random rgba, colours and palettes; then a dense
distribution (about 64 records a bin).

Rows: `scatter`, `scatter_sorted`, `sortcum` (ops/histogram.py), and
the packed flushes `pallas` (packed_flush), `pallas_merged`
(merged_flush) and `pallas_win` (win_flush, 8 colour bits), each within
0.5 of the bincount in every bin; the dense rows are checked the same
way (the JAX tool only times them).  The raw sort rows: `torch.sort`
(the library call, in place of `lax.sort`) and the tiled bitonic sort
kernel (in place of the roll-based bitonic network), both exactly
numpy's sort.  On the card every row runs its kernel, on the CPU its
plain version.  The JAX rows `pallas_win_merge` (its windowed kernel's
`merge=True`) have no counterpart: the port's run merge lives in
merged_flush, so they print as left out.

A row is validated on its first call, from an empty histogram, and
timed on a second (host clock between device syncs).

Usage: python -m cuburn_tpu_torch.bench.sortbench [n_records_log2=21]
       [n_bins_log2=18] [--cpu]
Prints one JSON line a row and a verdict line; exits 1 when a row's
error exceeds the bound it prints.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cuburn_tpu_torch.bench._card import card
from cuburn_tpu_torch.ops import flush as fl
from cuburn_tpu_torch.ops import histogram as hm
from cuburn_tpu_torch.ops.iterate import (color_bits_for, expand_palette,
                                          pack_records, unpack_records)
from cuburn_tpu_torch.ops.tiled_sort import bitonic_sort_u32_tiled
from cuburn_tpu_torch.utils.timing import sync

FLUSH_BOUND = 0.5
MERGE_LEFT_OUT = ("the port's run merge lives in merged_flush "
                  "(pallas_merged); win_flush has no merge mode")


def bincount(addr: np.ndarray, rgba: np.ndarray, n_bins: int) -> np.ndarray:
    """The (n_bins + 1, 4) float32 ground truth."""
    out = np.zeros((n_bins + 1, 4), np.float32)
    for c in range(4):
        out[:, c] = np.bincount(addr, rgba[:, c], minlength=n_bins + 1)
    return out


def unpacked_truth(bits: int, palette_hi, packed, n_bins: int) -> np.ndarray:
    a, r = unpack_records(bits, palette_hi, packed)
    return bincount(a.cpu().numpy(), r.cpu().numpy(), n_bins)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_records_log2", nargs="?", type=int, default=21)
    ap.add_argument("n_bins_log2", nargs="?", type=int, default=18)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device, name = card(args.cpu)
    M, n_bins = 1 << args.n_records_log2, 1 << args.n_bins_log2
    cbits = color_bits_for(n_bins)
    if not cbits:
        raise ValueError(f"n_bins_log2={args.n_bins_log2} too large for "
                         "packed records (color_bits_for == 0)")
    print(json.dumps({"sortbench": {"device": name, "records": M,
                                    "bins": n_bins}}), flush=True)

    # the JAX tool's draws, in its order
    rng = np.random.RandomState(0)
    hot = rng.randint(0, n_bins, 64)
    mix = rng.rand(M) < 0.3
    addr_np = np.where(mix, hot[rng.randint(0, 64, M)],
                       rng.randint(0, n_bins, M)).astype(np.int32)
    rgba_np = rng.rand(M, 4).astype(np.float32)
    color = torch.from_numpy(rng.rand(M).astype(np.float32)).to(device)
    pal_hi = expand_palette(torch.from_numpy(
        rng.rand(256, 3).astype(np.float32)).to(device), cbits)
    palette = torch.from_numpy(rng.rand(256, 3).astype(np.float32)).to(device)
    bins_d = max(M // 64, 1 << 10)
    addr_d_np = np.where(mix, hot[rng.randint(0, 64, M)] % bins_d,
                         rng.randint(0, bins_d, M)).astype(np.int32)
    rgba_d_np = rng.rand(M, 4).astype(np.float32)

    addr = torch.from_numpy(addr_np.astype(np.int64)).to(device)
    rgba = torch.from_numpy(rgba_np).to(device)
    packed = pack_records(cbits, addr, color)
    pal8 = expand_palette(palette, 8)
    p8 = pack_records(8, addr, color)
    addr_d = torch.from_numpy(addr_d_np.astype(np.int64)).to(device)
    rgba_d = torch.from_numpy(rgba_d_np).to(device)
    p8d = pack_records(8, addr_d, color)

    ok = True

    def row(label, fn, bins, truth, bound=FLUSH_BOUND):
        """fn(hist) flushes into hist in place: validated from an empty
        histogram, then timed on a second call."""
        hist = hm.alloc(bins, device)
        fn(hist)
        err = float(np.abs(hist.cpu().numpy()[:bins] - truth[:bins]).max())
        sync(device)
        t0 = time.perf_counter()
        fn(hist)
        sync(device)
        report(label, time.perf_counter() - t0, err, bound)

    def report(label, dt, err, bound):
        nonlocal ok
        ok = ok and err <= bound
        print(json.dumps({"row": label, "ms": round(dt * 1e3, 3),
                          "mrec_per_s": round(M / dt / 1e6, 1),
                          "max_err": err, "bound": bound,
                          "ok": err <= bound}), flush=True)

    truth = bincount(addr_np, rgba_np, n_bins)
    for label, scatter in hm.BACKENDS.items():
        row(label, lambda h, f=scatter: f(h, addr, rgba), n_bins, truth)
    truth_p = unpacked_truth(cbits, pal_hi, packed, n_bins)
    row("pallas", lambda h: fl.accumulate_packed(h, packed, pal_hi, n_bins,
                                                 cbits), n_bins, truth_p)
    row("pallas_merged", lambda h: fl.accumulate_merged(
        h, packed, pal_hi, n_bins, cbits), n_bins, truth_p)
    row("pallas_win", lambda h: fl.accumulate_windowed(
        h, p8, pal8, n_bins, 8), n_bins, unpacked_truth(8, pal8, p8, n_bins))
    print(json.dumps({"row": "pallas_win_merge", "left_out": MERGE_LEFT_OUT}),
          flush=True)

    # dense flush (~64 records a bin: a small frame at high quality)
    print(json.dumps({"dense": {"records": M, "bins": bins_d}}), flush=True)
    truth_d = bincount(addr_d_np, rgba_d_np, bins_d)
    for label in ("scatter", "scatter_sorted"):
        row(f"{label} (dense)", lambda h, f=hm.BACKENDS[label]: f(
            h, addr_d, rgba_d), bins_d, truth_d)
    row("pallas_win (dense)", lambda h: fl.accumulate_windowed(
        h, p8d, pal8, bins_d, 8), bins_d, unpacked_truth(8, pal8, p8d, bins_d))
    print(json.dumps({"row": "pallas_win_m (dense)",
                      "left_out": MERGE_LEFT_OUT}), flush=True)

    # raw sorts of the packed records: the share of keys out of place
    keys = packed.reshape(-1)
    want = np.sort(keys.cpu().numpy())
    for label, sort in (("torch.sort keys (library)",
                         lambda k: torch.sort(k).values),
                        ("bitonic (tiled kernel)", bitonic_sort_u32_tiled)):
        err = float((sort(keys).cpu().numpy() != want).mean())
        sync(device)
        t0 = time.perf_counter()
        sort(keys)
        sync(device)
        report(label, time.perf_counter() - t0, err, 0.0)

    print(json.dumps({"sortbench_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
