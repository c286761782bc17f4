"""The render loop stage by stage on the card.

Port of `bench/breakdown.py`: full_feature at 512x512, batch 2^15, 64
steps a flush, 2^25 iterations (with `--cpu` the headline's CPU
target, 2^19), each row a warm call and then a timed one from the
state it left (host clock between device syncs):

  iterate + pack     the chaos kernel once a chunk, nothing flushed
  full (scatter)     the chaos game and its flush through scatter
  full (pallas_win)  ... through the tiled sort and win_flush

The JAX tool's "iterate (discard)" row has no counterpart: the chaos
kernel always writes its packed record log, so its line says left out.

Usage: python -m cuburn_tpu_torch.bench.breakdown [batch_log2=15]
       [iters_per_chunk=64] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from cuburn_tpu_torch.bench._card import Chaos, card
from cuburn_tpu_torch.bench.headline import sizes
from cuburn_tpu_torch.ops.histogram import hist_alloc_for
from cuburn_tpu_torch.ops.iterate import iterate_accumulate
from cuburn_tpu_torch.utils.timing import sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch_log2", nargs="?", type=int, default=15)
    ap.add_argument("iters_per_chunk", nargs="?", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device, name = card(args.cpu)
    ff = Chaos.full_feature(512, 512, device)
    B, K = 1 << args.batch_log2, args.iters_per_chunk
    n_chunks = max(1, sizes(args.cpu)[3] // (B * K))
    total = n_chunks * B * K
    print(json.dumps({"breakdown": {"device": name, "B": B, "K": K,
                                    "chunks": n_chunks,
                                    "total_iters": total}}), flush=True)
    print(json.dumps({"row": "iterate (discard)", "left_out":
                      "the chaos kernel always writes its packed record "
                      "log; no variant discards the records"}), flush=True)

    def timed(label, fn):
        state = fn(ff.state(B, device))         # warm
        sync(device)
        t0 = time.perf_counter()
        fn(state)
        sync(device)
        dt = time.perf_counter() - t0
        print(json.dumps({"row": label, "ms": round(dt * 1e3, 3),
                          "m_iters_per_s": round(total / dt / 1e6, 1)}),
              flush=True)

    timed("iterate + pack", lambda s: ff.iterate_only(s, n_chunks, K))
    for backend in ("scatter", "pallas_win"):
        hist = hist_alloc_for(backend, ff.cam.n_bins, device)
        timed(f"full ({backend})", lambda s, b=backend, h=hist:
              iterate_accumulate(ff.key, ff.cam, b, ff.params, ff.cdf, s, h,
                                 ff.ppu, n_chunks, K, 32)[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
