#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--quality Q]

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit.  Phases, each printed on its own line:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile every csrc/*.cu kernel with nvcc (sm_90a), one
              nvcc process per library, all started together: each
              source, and chaos_iterate.cu once for the structure key
              of each genome the script renders (CHAOS_GENOMES, its
              -D definitions from ops/chaos.key_defines); the seconds
              of each, and the registers and spills ptxas reports for
              each chaos library
  3. kernel   the windowed-flush kernel (win_flush.cu) against its plain
              PyTorch version at the main path's shapes (2^22 records
              into the 8.63 M-bin 1080p-ss2 histogram): density
              bit-exact with a 3-column palette at weight 1.0, every
              channel within 1e-5 of the bin's density with the 4-column
              opacity palette at weight 0.37; medians of 10 timed calls
              of the kernel path (the kernel sort, then win_flush), the
              kernel alone, the sort, the plain version and one PyTorch
              call computing the same function (unpack + index_add_),
              each on the host clock (`ms`) and on the device clock
              (`device_ms`), and the bound from the bytes the flush must
              move
  4. render   Renderer(full_feature, 1080p profile at quality Q)
              .render_frame on cuda through the kernels of `auto`'s
              backend, `atomic` (the chaos game and packed_flush once a
              chunk, no sort); the PNG goes to smoke_out/ in
              the checkout.  Then the records of the first two flushes
              of that render (the first holds the fuse steps) against
              the synthetic mix of phases 3 and 6: junk share, touched
              bins, hot-bin shares, the unsorted flush (scatter_flush.cu)
              timed on each, with the atomics it made; and on the
              first and the real flush, win_flush, the unsorted, the
              merged and the split flush checked as in phases 3 and 6,
              and the three sorted flushes timed with their kernel
              paths and alone, beside the sort, the split flush's two
              launches also apart; each mix's bound for the logical
              and for the split histogram.  Then `atomic` against
              `pallas_win` on a real second flush at three geometries:
              that 1080p-ss2 flush (8.63 M bins, past L2), a 720p still
              of animated_spark (982,500 bins) and full_feature at
              retune.UNTILED_DIMS (512x512, ~16 records a bin): density
              bit-exact, rgb within 1e-5 of the bin's density, medians
              of 10 timed calls of each path (ms, device ms), the
              atomics packed_flush made, the bound
  5. parity   sierpinski and full_feature at 128x128 on cuda against
              the same render on the CPU (the flush's plain version):
              TV distance of the normalised density histograms under 3x
              the CPU path's two-seed floor
  6. kernel   the other kernels at the same shapes, each against its
              plain version: the unsorted and merged flushes
              (scatter_flush.cu) as in phase 3, the merged kernel also
              alone on sorted records, the unsorted one with the atomics
              it made; the split flush
              (win_flush_rgb16.cu) from a nonzero split histogram,
              density bit-exact and rgb within one bf16 ulp, and five
              launches on the same sorted records bit-identical; the tiled
              bitonic sort (bitonic_sort.cu) equal to torch.sort at 2^22
              and 2^23 keys, with each pass's device time; times and
              bounds as in phase 3
  7. render   full_feature at 1080p through the backends pallas_win,
              pallas, pallas_merged and pallas_rgb16 at quality Q/2: one
              launch a flush (two for pallas_rgb16), the sort's passes
              before each sorted flush, histogram mass == plotted
              samples, a non-black frame
  8. parity   full_feature at 128x128, CUDA against CPU, for every
              backend besides pallas_win, under 3x the two-seed floor;
              and a motion-blurred frame (animated_spark, 4 temporal
              samples, gaussian filter) the same way
  9. animation  animated_spark with a gaussian temporal filter at 1080p,
              4 temporal samples a frame at quality Q/2, 3 frames through
              Renderer.frames and again through frames_overlapped
              (auto: atomic): per frame one packed_flush launch a flush,
              4 x n_chunks flushes, no sort; histogram mass ==
              sum of weight x plotted count over the samples; frame 0
              differs from frame 2 and a blurred frame from the still at
              its time; a gaussian-filtered frame as bright as a
              box-filtered one within 10%; overlapped frames within one
              u8 step of the serial ones (the flush's atomics), the
              two frame loops' wall times taken in turns (serial, overlapped,
              overlapped, serial), and
              through pallas_rgb16 (2 frames) bit-identical; one blurred
              frame each through pallas_win (18 sort passes a flush),
              pallas and pallas_merged; frames go to smoke_out/
 10. partition  frames past the whole-frame limits.  (a) full_feature at
              1080p, quality Q/2, through pallas_win (asked for by name,
              as in (d) and 11a): accumulate against
              accumulate_striped(n_stripes=4) from the same seed, density
              equal in every bin, rgb within 1e-5 of each bin's density,
              plotted counts equal, win_flush launched 4x the whole
              frame's (one a flush) and the sort 18 passes a flush; a
              real stripe flush (a middle stripe's second) timed and
              checked like phase 4's; then one striped frame each
              through pallas, pallas_merged and pallas_rgb16 at Q/4,
              density equal to that backend's whole frame, launches
              counted.  (b) finalize_frame against
              finalize_frame_banded(n_bands=4) on (a)'s histogram: within
              one u8 step, under 0.5% of pixels apart; filter_s and
              peak device memory of each.  (c) full_feature under the 4k
              profile at quality 10 (33.85 M bins: records do not pack
              into 32 bits): the Renderer unpacked on scatter, pallas_win
              warns and becomes scatter; no flush kernel launched;
              histogram mass == plotted samples, a non-black frame (PNG
              to smoke_out/); 2 stripes against the whole frame as in
              (a); 4 bands against the whole filter within one u8 step;
              iterate_s, filter_s and peak memory of whole and banded.
              (d) one motion-blurred frame of animated_spark (T = 4,
              gaussian) at 1080p, quality Q/4, through
              frames_partitioned(n_stripes=2, n_bands=2) against
              frames(): within one u8 step, twice the flushes
 11. sharded  parallel/shard.py and parallel/farm.py, full_feature at
              1080p, quality Q/4, one process a rank (parallel.launch).
              (a) one rank over NCCL on cuda:0: replicated, scattered
              and stripe-parallel accumulation against Renderer from the
              same seed (density equal in every bin, rgb within the
              rounding of its sums, plotted counts equal, frames within
              one u8 step), win_flush once a flush and the sort's passes
              before each; one sharded frame through pallas,
              pallas_merged and pallas_rgb16 for the launch counts;
              iterate_s and filter_s of the one-device and the sharded
              frame in turns.  (b) two ranks on the one card over gloo
              with CUDA tensors: first a probe of the collectives gloo
              runs on CUDA tensors; each check whose collectives gloo
              refused is named and left out.  Replicated accumulate
              against Renderer.accumulate through pallas_win, pallas,
              pallas_merged and pallas_rgb16 (density equal, rgb within
              its bound), the sharded band filter against
              finalize_frame (the DE's pyramid path at 1080p), scattered
              blocks against the replicated histogram's and the
              scattered frame against the replicated one,
              stripe-parallel against the whole frame, a motion-blurred
              animated_spark frame (T = 4) against frames(), times in
              turns.  (c) a FarmServer thread, a worker thread on
              cuda:0 and a client: 3 frames of animated_spark, frame i
              within one u8 step of Renderer.render_frame(t_i, seed + i).
              It stops if the machine has more than one card.
 12. tools    (a) the tuner (retune.py) at its --quick sizes, 4 chunks
              a race, every row raced twice in turns: the record gated
              to this card, every race row numeric in both passes,
              l2_bytes the card's, win_flush, packed_flush, the split
              flush and the sort launched during the race; both
              passes' rows and
              their spread; under the record a 1080p Renderer takes its
              tiled keys (backend and flush size), under the record
              with its picks set to pallas_rgb16 and 2^23 records it
              takes those, under the repo's TPU record it keeps
              atomic and 32 and says "skipped".
              (b) full_feature at 1080p, quality 10, through the CLI
              with --trace-dir, in turns with the same render untraced
              (off, on, on, off), through auto (atomic: packed_flush, no
              sort): the trace parses, each hand kernel's
              kernel events equal its launch counter over the call;
              iterate times, trace MB.  (c) the native output encoder
              against the Python one on phase 4's still and phase 9's
              middle frame: host ms (medians of 5), bytes, the native
              PNG's rows the Paeth filter of the frame and the Python
              PNG's the frame, the native YCbCr equal to the fixed-point
              formula; it fails where the native encoder is not in use
              (the Y4M sink's; write_image keeps the Python PNG).
 13. chaos    the chaos-game kernel (chaos_iterate.cu) on full_feature
              at 1080p ss2, batch 2^17, 32 steps a chunk.  (a) One chunk
              from the same state (two chunks past the fuse) against its
              plain version, the eager iterate_step loop: RNG words and
              selected xforms exact after 32 steps, step 1's records
              equal in >= 99.9% of lanes and positions within rtol
              1e-4 in >= 99.9%, the records' agreement at every step;
              the chunk's ms and device ms, the plain version's, the
              bound and its share; the full_feature key's library, which
              the Renderer loaded, with ptxas's registers, stack frame
              and spills.  (b) The quality-Q still through the kernel and
              through the eager loop in turns (kernel, eager, eager,
              kernel; seeds 1, 1, 2, 2): iterate_s of each, one launch
              a chunk and none through the eager loop, TV distance under
              3x the eager loop's two-seed floor.  (c) A q1000 still
              through the kernel: iterate_s, samples/s, launches, mass
              == plotted; once more under torch.profiler: the device's
              busy share and its time by kernel.
 14. probe    the bf16 probe (probes/bf16probe.py, bf16_probe.cu), on no
              render path.  Its entry point as a user runs it, the
              launches counted: the three staging variants (3 launches)
              and the rgb16 skeleton (1), every line ok, the skeleton's
              within the TPU probe's own tolerances.  (a) At the probe's
              size, (3, 1024, 128): each variant's kernel bit-equal to its
              plain version and to its input; the skeleton on the probe's
              schedule and on two shuffled ones (blocks in another order,
              1-4 visits a block, each block's visits one run) bit-equal
              to its plain version; a schedule that revisits a block
              refused with ValueError, nothing launched; one launch a
              call.  (b) At the split histogram of the main path (1080p
              ss2's bins with the junk bin in rows of 128, padded to
              whole 256-row blocks: 67,584 rows): each variant bit-equal
              20 times (a missing proxy fence shows as an intermittent
              mismatch), the skeleton at 3 visits a block and on a
              shuffled schedule bit-equal; medians of 10 calls of the
              kernel, the plain version and one PyTorch call (the
              identity, out.copy_(x), for the roundtrip; none for the
              skeleton), called in turns: ms, device ms and the bound
              from the bytes; for each roundtrip variant its persistent
              grid, its share of the bound and out.copy_'s, and its
              device ms over out.copy_'s.
 15. bench    the system's benchmark and validation tools
              (cuburn_tpu_torch/bench/) as a user runs them.  (a) The
              headline, `python -m cuburn_tpu_torch.bench`, in its own
              process: one JSON line with bench.py's schema, the card's
              name and power limit, scatter and pallas_win equal in
              every bin's density and in mass, the pallas_win run's
              launches one chaos_iterate and one win_flush a chunk and
              the sort's passes a flush (the scatter run's one chaos
              launch a chunk), the 1080p q1000 fields present, its
              backend auto's (atomic).  (b) The configs suite:
              BASELINE.md's five configurations at their binding sizes,
              one process each, five records through atomic, exit 0.
              (c) In this process at their defaults, the launches
              counted: parity (ok: scatter and pallas_win on the card
              within the CPU's two-seed TV floor), tileddiff (the
              8,633,536-bin geometry past L2, density equal in every
              bin), sortbench (every row within its bound) and
              breakdown.  Every JSON line of each tool on a line of its
              own.

Every render phase counts the chaos game's launches, one a chunk, and
no launch of the probe's kernels; no phase loads the generic chaos
library, which has no chaos game.
Every phase but 12a runs with CUBURN_TUNE_FILE pointing at a file that
does not exist, so no tune record moves the launch counts.  Then one
JSON line describing each kernel (the probe's with the launches of its
own entry point and 0 on every render path, its times from phase 14b;
`launches_bench` the headline's timed runs and phase 15c's tools),
the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any
failed check exits non-zero before those lines.  Without CUDA it exits
non-zero at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "cuburn_tpu_torch/csrc"
# kernel -> (library built from csrc/<library>.cu, the TPU kernel it
# replaces)
KERNELS = {
    "win_flush": ("win_flush", "cuburn_tpu/ops/pallas_hist.py:348"),
    "packed_flush": ("scatter_flush", "cuburn_tpu/ops/pallas_hist.py:70"),
    "merged_flush": ("scatter_flush", "cuburn_tpu/ops/pallas_hist.py:99"),
    "win_flush_rgb16": ("win_flush_rgb16",
                        "cuburn_tpu/ops/pallas_hist.py:305"),
    "bitonic_sort": ("bitonic_sort", "cuburn_tpu/ops/pallas_sort.py:40"),
    "chaos_iterate": ("chaos_iterate", "bench/fusedprobe.py:61"),
    "bf16_roundtrip": ("bf16_probe", "bench/bf16probe.py:41, :55, :73"),
    "rgb16_skeleton": ("bf16_probe", "bench/bf16probe.py:132"),
}
# the genomes the script renders: phase 2 builds the chaos game's
# library for the structure key of each with the other libraries
CHAOS_GENOMES = ("full_feature", "sierpinski", "animated_spark",
                 "classic_swirl")
# the probe's kernels (phase 14): launched by no render path
PROBE_KERNELS = ("bf16_roundtrip", "rgb16_skeleton")
# the flush kernel of each packed backend
FLUSH_KERNEL = {"pallas_win": "win_flush", "pallas": "packed_flush",
                "pallas_merged": "merged_flush",
                "pallas_rgb16": "win_flush_rgb16", "atomic": "packed_flush"}
# the backends of phase 7's stills at quality Q/2; phase 4's still goes
# through auto's, atomic
STILL_BACKENDS = ("pallas_win", "pallas", "pallas_merged", "pallas_rgb16")
# the backends that flush their records unsorted
UNSORTED = ("pallas", "atomic")
# temporal samples a frame of the animation phase
ANIM_SAMPLES = 4
# CUDA kernel launches of each flush kernel in one flush (the sort's
# passes count under bitonic_sort; the split flush launches its tiles
# kernel and its resolve kernel)
LAUNCHES_PER_FLUSH = {"win_flush": 1, "packed_flush": 1, "merged_flush": 1,
                      "win_flush_rgb16": 2}
# wrapper and plain version of each flush of the logical histogram
LOGICAL_FLUSHES = {
    "win_flush": ("accumulate_windowed", "accumulate_windowed_reference"),
    "packed_flush": ("accumulate_packed", "accumulate_packed_reference"),
    "merged_flush": ("accumulate_merged", "accumulate_merged_reference"),
}
# H100 SXM published peaks (at a 700 W power limit): device memory and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SENTINEL = 0xFFFFFFFF
# palette columns, color bits, weight.  8 bits is what the 1080p
# accumulator leaves (24 address bits), so every record fits 32 bits
FLUSH_CONFIGS = ((3, 8, 1.0), (4, 8, 0.37))
# ~6 ms at the H100's 1.7-2 GHz: the head start the host gets before a
# device timing starts
SLEEP_CYCLES = 10_000_000
# the __global__ functions behind each launch counter, as a profiler
# trace names its kernel events
TRACE_KERNELS = {
    "win_flush": ("win_flush_kernel",),
    "packed_flush": ("packed_flush_kernel",),
    "merged_flush": ("merged_flush_kernel",),
    "win_flush_rgb16": ("rgb16_tiles_kernel", "rgb16_resolve_kernel"),
    "bitonic_sort": ("first_pass_kernel", "later_pass_kernel",
                     "global_pass_kernel"),
    "chaos_iterate": ("chaos_iterate_kernel",),
    "plotted_fold": ("plotted_fold_kernel",),
    "bf16_roundtrip": ("bf16_roundtrip_kernel",),
    "rgb16_skeleton": ("rgb16_skeleton_kernel",),
}
# CUBURN_TUNE_FILE for every phase but the tuner's: a path that does not
# exist, so no tune record in the working directory moves the flush
# size or the backend the earlier phases count launches at
NO_TUNE_RECORD = os.path.join(REPO, "smoke_out", "no-tune-record",
                              "none.json")


def check(cond, msg):
    """End the run with a non-zero exit and the reason on stderr."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(n, name, **fields):
    print(f"phase {n} {name}: " + json.dumps(fields), flush=True)


def timed(torch, fn):
    """(wall ms, device ms) of one call.  Wall: host clock around the
    call, synchronised.  Device: CUDA events around the call with the
    stream held back by a sleep kernel, so the host enqueues everything
    first and the events span the call's kernels back to back, without
    the host's gaps between launches (for calls that enqueue in less
    than the sleep)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return wall, start.elapsed_time(end)


def medians(torch, fns, reps=10):
    """{name: median wall ms, device name: median device ms} of `reps`
    calls after one warm-up, the functions called in turns; the device
    twin of "x_ms" is "x_device_ms" ("device_ms" for "ms")."""
    ms = {k: [] for k in fns}
    for _ in range(reps + 1):
        for k, fn in fns.items():
            ms[k].append(timed(torch, fn))
    out = {}
    for k, v in ms.items():
        out[k] = statistics.median(w for w, _ in v[1:])
        out["device_ms" if k == "ms" else k[:-3] + "_device_ms"] = \
            statistics.median(d for _, d in v[1:])
    return out


def bound(nbytes, ops=0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the float32 rate."""
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


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


def flush_inputs(torch, n, n_bins, acc_width, cols, bits, gen):
    dev = torch.device("cuda")
    rec = flush_records(torch, n, n_bins, acc_width, bits, gen).to(dev)
    pal = torch.rand((1 << bits, cols), generator=gen).to(dev)
    if cols == 4:
        pal[:, :3] *= pal[:, 3:]        # rgb * opacity, opacity
    return rec, pal


def touched_bins(torch, rec, n_bins, bits):
    """Distinct bins this flush's records land in, counted on the card."""
    live = rec[rec != SENTINEL]
    return int(torch.unique(torch.clamp(live >> bits, max=n_bins)).numel())


def library_flush(torch, hist, rec, pal4, n_bins, bits, weight):
    """The one PyTorch call computing a flush: unpack + index_add_."""
    addr = torch.clamp(rec >> bits, max=n_bins)
    return hist.index_add_(0, addr, pal4[rec & ((1 << bits) - 1)],
                           alpha=weight)


def check_flush(torch, flush, thist, name, rec, pal, n_bins, bits, weight,
                what):
    """One flush through kernel `name`'s wrapper against its plain
    version on the card and against the float64 sums: every channel of
    the kernel's real bins within 1e-5 of the bin's density of the
    float64 sums; the plain version there within that plus its own
    worst case (it adds a bin's k records one by one in float32, half
    an ulp of the running sum each, k x 2^-24 of the sum), and so the
    kernel against the plain version; at weight 1.0 with a 3-column
    palette the density bit-exact, the junk bin's too.  Returns the max
    abs error against the plain version."""
    dev = torch.device("cuda")
    kernel, plain = (getattr(flush, f) for f in LOGICAL_FLUSHES[name])
    got = kernel(thist.alloc(n_bins, dev), rec, pal, n_bins, bits, weight)
    ref = plain(thist.alloc(n_bins, dev), rec, pal, n_bins, bits, weight)
    torch.cuda.synchronize()
    if pal.shape[1] == 3 and weight == 1.0:
        check(torch.equal(got[:, 3], ref[:, 3]),
              f"{name} on {what}: density not bit-exact at weight 1.0")
    addr = torch.clamp(rec >> bits, max=n_bins)
    w32 = float(torch.tensor(weight, dtype=torch.float32))
    exact = torch.zeros((n_bins + 1, 4), dtype=torch.float64,
                        device=dev).index_add_(
        0, addr, flush._pal4(pal).double()[rec & ((1 << bits) - 1)],
        alpha=w32)[:n_bins]
    bound = 1e-5 * exact[:, 3:].clamp(min=1.0)
    sequential = torch.bincount(addr, minlength=n_bins + 1)[:n_bins, None] \
        * 2.0 ** -24 * exact.abs()
    for side, h, tol in (("the kernel", got, bound),
                         ("the plain version", ref, bound + sequential)):
        off = (h[:n_bins] - exact).abs()
        check(bool((off <= tol).all()),
              f"{name} on {what}: {side} is {float(off.max())} from the "
              f"float64 sums ({pal.shape[1]}-column palette, weight "
              f"{weight})")
    err = (got[:n_bins] - ref[:n_bins]).abs()
    check(bool((err <= bound + sequential).all()),
          f"{name} on {what} disagrees: max err {float(err.max())} "
          f"({pal.shape[1]}-column palette, weight {weight})")
    check(float(ref[:n_bins, 3].sum()) > 0, f"{name} on {what} added no mass")
    return float(err.max())


def packed_atomics(torch, flush, rec, pal4, n_bins, bits):
    """The atomics packed_flush makes for these records, from the debug
    entry's device counter."""
    dev = torch.device("cuda")
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    rec = flush._aligned(rec.reshape(-1))
    flush._launch("packed_flush_counted", dev, rec.data_ptr(), rec.numel(),
                  pal4.data_ptr(), bits, n_bins, 1.0,
                  torch.zeros((n_bins + 1, 4), device=dev).data_ptr(),
                  count.data_ptr())
    return int(count)


def phase_flush(torch, flush, sort, thist, name, n_bins, acc_width,
                phase_no):
    """A flush kernel of the logical histogram against its plain version
    on the card, at the main path's shapes."""
    kernel, plain = (getattr(flush, f) for f in LOGICAL_FLUSHES[name])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    n = 1 << 22
    results, max_err = {}, 0.0
    for cols, bits, weight in FLUSH_CONFIGS:
        rec, pal = flush_inputs(torch, n, n_bins, acc_width, cols, bits,
                                gen)
        err = check_flush(torch, flush, thist, name, rec, pal, n_bins,
                          bits, weight, "the synthetic mix")
        max_err = max(max_err, err)
        extra = {}

        hk, hr, hl = (thist.alloc(n_bins, dev) for _ in range(3))
        pal4 = flush._pal4(pal).contiguous()
        fns = {
            "ms": lambda: kernel(hk, rec, pal, n_bins, bits, weight),
            "plain_ms": lambda: plain(hr, rec, pal, n_bins, bits, weight),
            "library_ms": lambda: library_flush(torch, hl, rec, pal4,
                                                n_bins, bits, weight),
        }
        if name == "win_flush":
            srt = sort.sort_records(rec)
            fns["kernel_only_ms"] = lambda: flush._launch(
                "win_flush", dev, srt.data_ptr(), srt.numel(),
                pal4.data_ptr(), bits, n_bins, weight, hk.data_ptr())
            fns["sort_ms"] = lambda: sort.sort_records(rec)
        elif name == "packed_flush":
            # the same records without the junk bin's 10%, all of whose
            # atomics hit one address
            live = rec[(rec >> bits) != n_bins]
            fns["no_junk_ms"] = lambda: kernel(hk, live, pal, n_bins,
                                               bits, weight)
            extra["atomics"] = packed_atomics(torch, flush, rec, pal4,
                                              n_bins, bits)
        elif name == "merged_flush":
            # the kernel alone on sorted records: it merges the runs
            # itself, so nothing else stands between the sort and it
            srt = sort.sort_records(rec)
            fns["kernel_only_ms"] = lambda: flush._launch(
                "merged_flush", dev, srt.data_ptr(), srt.numel(),
                pal4.data_ptr(), bits, n_bins, weight, hk.data_ptr())
            fns["sort_ms"] = lambda: sort.sort_records(rec)
            extra["unique_records"] = int(torch.unique(rec).numel())
        med = medians(torch, fns)
        touched = touched_bins(torch, rec, n_bins, bits)
        # records read once, each touched bin's 16 bytes read and
        # written once, the palette read once; ~8 flops a record
        med["bound_ms"], med["bound_by"] = bound(
            n * 8 + touched * 32 + pal.numel() * 4, ops=8.0 * n)
        results[cols] = med
        phase(phase_no, "kernel", kernel=name, palette_cols=cols,
              weight=weight, records=n, bins=n_bins, touched_bins=touched,
              max_abs_err=err, density_exact=cols == 3, **extra, **med)
    return results[3], max_err


def split_start(torch, n_bins, gen):
    """A nonzero logical histogram on the card: rgb up to 50, integer
    density up to 999."""
    dev = torch.device("cuda")
    start = torch.rand((n_bins + 1, 4), generator=gen).to(dev) * 50.0
    start[:, 3] = torch.randint(0, 1000, (n_bins + 1,),
                                generator=gen).to(dev).float()
    return start


def check_rgb16(torch, flush, start, rec, pal, n_bins, bits, weight, what):
    """The split flush through its wrapper against its plain version,
    both from the split layout of `start`: rgb of the real bins within
    one bf16 ulp, their density within 1e-5 of itself, and at weight 1.0
    with a 3-column palette the density bit-exact, the junk bin's too.
    Then five launches of the kernels alone on the same sorted records:
    every one the wrapper's result bit for bit.  Returns the max abs
    error."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    got = flush.accumulate_windowed_rgb16(
        flush.to_split_layout(start), rec, pal, n_bins, bits, weight)
    ref = flush.accumulate_windowed_rgb16_reference(
        flush.to_split_layout(start), rec, pal, n_bins, bits, weight)
    torch.cuda.synchronize()
    name = f"win_flush_rgb16 on {what}"
    # the junk bin is left out of the bounded checks, as in phase 3: with
    # fractional density its sum of ~400K records differs by float32 order
    gd, rd = got[0][:n_bins], ref[0][:n_bins]
    d_err = (gd - rd).abs()
    rg, rr = got[1][:n_bins].float(), ref[1][:n_bins].float()
    ulp = torch.finfo(bf16).eps * rr.abs().clamp(min=torch.finfo(bf16).tiny)
    rgb_err = (rg - rr).abs()
    check(bool((rgb_err <= ulp).all()),
          f"{name}: rgb off by more than one bf16 ulp (max err "
          f"{float(rgb_err.max())}, weight {weight})")
    check(bool((d_err <= 1e-5 * rd.clamp(min=1.0)).all()),
          f"{name}: density max err {float(d_err.max())}")
    if pal.shape[1] == 3 and weight == 1.0:
        check(torch.equal(got[0], ref[0]),
              f"{name}: density not bit-exact at weight 1.0")
    check(float(got[0].double().sum()) > float(start[:, 3].double().sum()),
          f"{name} added no mass")
    srt = flush._aligned(flush.sort_records(rec))
    pal4 = flush._aligned_pal4(pal)
    for call in range(5):
        split = flush.to_split_layout(start)
        flush.rgb16_launch(srt, pal4, bits, n_bins, weight, split[0],
                           split[1], flush.rgb16_scratch(srt.numel(), dev))
        check(torch.equal(split[0], got[0])
              and torch.equal(split[1].view(torch.int16),
                              got[1].view(torch.int16)),
              f"{name}: call {call} on the same records gave other bits")
    return max(float(d_err.max()), float(rgb_err.max()))


def rgb16_alone(torch, flush, srt, pal4, n_bins, bits, weight, split):
    """A call of win_flush_rgb16.cu's kernels alone on sorted records."""
    scratch = flush.rgb16_scratch(srt.numel(), srt.device)
    return lambda: flush.rgb16_launch(srt, pal4, bits, n_bins, weight,
                                      split[0], split[1], scratch)


def phase_rgb16(torch, flush, n_bins, acc_width):
    """The split flush against its plain version from a nonzero split
    histogram (phase 6)."""
    gen = torch.Generator().manual_seed(5)
    n = 1 << 22
    results, max_err = {}, 0.0
    for cols, bits, weight in FLUSH_CONFIGS:
        rec, pal = flush_inputs(torch, n, n_bins, acc_width, cols, bits,
                                gen)
        start = split_start(torch, n_bins, gen)
        err = check_rgb16(torch, flush, start, rec, pal, n_bins, bits,
                          weight, "the synthetic mix")
        max_err = max(max_err, err)

        sk = flush.to_split_layout(start)
        sr = flush.to_split_layout(start)
        del start
        srt = flush._aligned(torch.sort(rec).values)
        med = medians(torch, {
            "ms": lambda: flush.accumulate_windowed_rgb16(
                sk, rec, pal, n_bins, bits, weight),
            "plain_ms": lambda: flush.accumulate_windowed_rgb16_reference(
                sr, rec, pal, n_bins, bits, weight),
            "kernel_only_ms": rgb16_alone(
                torch, flush, srt, flush._aligned_pal4(pal), n_bins, bits,
                weight, sk),
        })
        med["tiles_resolve_device_ms"] = launch_device_ms(
            torch, flush._build, rgb16_alone(
                torch, flush, srt, flush._aligned_pal4(pal), n_bins, bits,
                weight, sk))
        touched = touched_bins(torch, rec, n_bins, bits)
        # records once; per touched bin 4 bytes of density and 6 of rgb,
        # read and written once
        med["bound_ms"], med["bound_by"] = bound(
            n * 8 + touched * 20 + pal.numel() * 4, ops=8.0 * n)
        # no one PyTorch call adds into a bf16 split histogram with one
        # rounding per bin
        med["library_ms"] = None
        results[cols] = med
        phase(6, "kernel", kernel="win_flush_rgb16", palette_cols=cols,
              weight=weight, records=n, bins=n_bins, touched_bins=touched,
              max_abs_err=err, density_exact=cols == 3,
              same_bits_in_5_calls=True,
              launches_per_flush=LAUNCHES_PER_FLUSH["win_flush_rgb16"],
              **med)
    return results[3], max_err


def phase_sort(torch, tiled_sort):
    """The tiled bitonic sort against torch.sort (phase 6), with each
    pass's device time.  Returns the 2^22-key timings and the max error;
    the checked calls launch one kernel per pass."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    sync = torch.cuda.synchronize
    keys = {}
    for log_n in (22, 23):
        k = torch.randint(0, 1 << 32, (1 << log_n,), generator=gen)
        k[:1000] = SENTINEL
        k[1000:2000] = 1 << 31
        keys[log_n] = k.to(dev)
    tiled_sort.LAUNCHES["bitonic_sort"] = 0
    got = {n: tiled_sort.bitonic_sort_u32_tiled(k) for n, k in keys.items()}
    sync()
    launches = tiled_sort.LAUNCHES["bitonic_sort"]
    check(launches == sum(len(tiled_sort.bitonic_schedule(k.numel()))
                          for k in keys.values()),
          f"bitonic sort: {launches} launches, expected one per pass")
    results, max_err = {}, 0.0
    for log_n, k in keys.items():
        ref = torch.sort(k).values
        check(torch.equal(got[log_n], ref),
              f"bitonic sort differs from torch.sort at 2^{log_n}")
        max_err = max(max_err, float((got[log_n] - ref).abs().max()))
        n = k.numel()
        med = medians(torch, {
            "ms": lambda: tiled_sort.bitonic_sort_u32_tiled(k),
            "plain_ms": lambda: tiled_sort.bitonic_sort_reference(k),
            "library_ms": lambda: torch.sort(k),
        }, reps=10 if log_n == 22 else 3)
        passes = tiled_sort.bitonic_schedule(n)
        per_pass = launch_device_ms(
            torch, tiled_sort._build,
            lambda: tiled_sort.bitonic_sort_u32_tiled(k))
        # int64 keys read once and written once; a min and a max for
        # each pair of every substage of the network
        substages = log_n * (log_n + 1) // 2
        med["bound_ms"], med["bound_by"] = bound(
            n * 16, ops=2.0 * (n // 2) * substages)
        results[log_n] = med
        phase(6, "kernel", kernel="bitonic_sort", keys=n,
              tile=tiled_sort.TILE, equal_to_torch_sort=True,
              passes=len(passes), **med,
              pass_device_ms=[[" ".join(map(str, p)), t]
                              for p, t in zip(passes, per_pass)],
              pass_device_ms_sum=sum(per_pass))
    return results[22], max_err


def launch_device_ms(torch, build, fn, reps=5):
    """Device ms of each kernel launch that `fn` makes through
    build.launch, in order: an event after every launch, the host ahead
    of the device (as in timed); medians of `reps` calls after a
    warm-up."""
    launch = build.launch
    events = []

    def marked(*args):
        launch(*args)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    build.launch = marked
    try:
        per = []
        for _ in range(reps + 1):
            events.clear()
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            torch.cuda.synchronize()
            marks = [start, *events]
            per.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    finally:
        build.launch = launch
    return [statistics.median(col) for col in zip(*per[1:])]


def tv_distance(a, b):
    da = a[:-1, 3].double().cpu()
    db = b[:-1, 3].double().cpu()
    return 0.5 * float((da / da.sum() - db / db.sum()).abs().sum())


def phase_render(torch, flush, tiled_sort, tit, write_image, r, quality):
    """The main path on the card (phase 4): returns the launches of its
    kernels (the chaos game and packed_flush, no sort: auto is atomic)
    during render_frame, copies of the records of the first two flushes
    of a second pass, and the frame."""
    from cuburn_tpu_torch.utils import trace
    check(r.backend == "atomic", f"backend {r.backend}, expected atomic")
    reset_launches(flush, tiled_sort)
    looped = trace.COUNTS["looped_chunks"]
    img, stats = r.render_frame(0.0, seed=1)
    now = launches_now(flush, tiled_sort)
    launches = {name: now[name] for name in ("packed_flush", "chaos_iterate")}
    for name, count in launches.items():
        check(count > 0, f"the 1080p render launched no {name}")
    check(launches["chaos_iterate"] == launches["packed_flush"],
          f"{launches}: the chaos game not once a chunk")
    check(now["plotted_fold"] == 1 and trace.COUNTS["looped_chunks"]
          - looped == launches["chaos_iterate"],
          f"{launches}, {now['plotted_fold']} plotted_fold: the chunks "
          "not queued by one C call")
    for name in ("win_flush", "merged_flush", "win_flush_rgb16",
                 "bitonic_sort"):
        check(now[name] == 0, f"the 1080p render launched {name} "
              f"{now[name]} times")
    for name in PROBE_KERNELS:
        check(now[name] == 0, f"the 1080p render launched {name}")
        launches[name] = now[name]
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
    # the JAX package, so past 2^24 it carries its own rounding.  The
    # pass runs through the C loop, as production does, and again on
    # its seed through the Python loop: plotted bit-equal (the C loop's
    # per-chunk counts folded by plotted_fold against the Python loop's
    # f32 sum), density equal.  The Python pass keeps its first two
    # flushes' records for the flush-mix phase.
    hist, st2 = r.accumulate(0.0, seed=2)
    flushes, real = [], tit.PACKED_FLUSHES[r.backend]

    def keep_first(hist, recs, *args):
        if len(flushes) < 2:
            flushes.append(recs.reshape(-1).clone())
        return real(hist, recs, *args)
    tit.PACKED_FLUSHES[r.backend] = keep_first
    try:
        with python_loop(tit):
            py_hist, py_st = r.accumulate(0.0, seed=2)
    finally:
        tit.PACKED_FLUSHES[r.backend] = real
    check(len(flushes) == 2, f"{len(flushes)} flushes kept, expected 2")
    check(bool(torch.isfinite(hist).all()), "non-finite histogram")
    mass = float(hist[:-1, 3].double().sum())
    check(abs(mass - st2.plotted_samples) <= 1e-4 * mass,
          f"histogram mass {mass} != plotted samples "
          f"{st2.plotted_samples}")
    check(st2.plotted_samples == py_st.plotted_samples,
          f"plotted {st2.plotted_samples} through the C loop, "
          f"{py_st.plotted_samples} through the Python loop")
    check(bool(torch.equal(hist[:, 3], py_hist[:, 3])),
          "the C loop's density differs from the Python loop's")
    del py_hist
    prof, cam = r.profile, r.cam
    phase(4, "render", genome="full_feature", profile="1080p",
          quality=quality, acc=[cam.acc_width, cam.acc_height],
          bins=cam.n_bins, batch=prof.batch,
          iters_per_chunk=prof.iters_per_chunk,
          records_per_flush=prof.batch * prof.iters_per_chunk,
          backend=r.backend, launches=launches,
          plotted_samples=stats.plotted_samples,
          c_loop_plotted_samples=st2.plotted_samples,
          python_loop_plotted_samples=py_st.plotted_samples,
          chunks=st2.chunks, total_iters=stats.total_iters,
          samples_per_s=stats.samples_per_sec,
          iterate_s=stats.iterate_s, filter_s=stats.filter_s,
          lit_fraction=float((img[..., :3] > 0).any(-1).mean()),
          png=os.path.relpath(png, REPO))
    return launches, flushes, img


def flush_mix(torch, rec, n_bins, bits, hot_bins=128 * 128):
    """How one flush's records spread over the bins: the junk share,
    the touched bins, and the share of live records in the hottest bin
    and the hottest `hot_bins` bins (the synthetic mix puts 30% of its
    records into 128 x 128 bins)."""
    addr = torch.clamp(rec >> bits, max=n_bins)
    per_bin = torch.bincount(addr, minlength=n_bins + 1)
    live = per_bin[:n_bins]
    n = rec.numel()
    return {"records": n, "junk_share": float(per_bin[n_bins]) / n,
            "touched_bins": int((live > 0).sum()),
            "records_per_touched_bin":
                float(live.sum()) / max(int((live > 0).sum()), 1),
            "hottest_bin_share": float(live.max()) / n,
            f"hottest_{hot_bins}_bins_share":
                float(live.topk(hot_bins).values.sum()) / n}


def phase_flush_mix(torch, flush, sort, thist, flushes, n_bins, acc_width,
                    bits):
    """The records of real 1080p flushes against the synthetic mix of
    the kernel phases (phase 4): how they spread; the unsorted flush
    timed on each, with and without the junk bin's records, and the
    atomics it made; and, on the real records, win_flush and the
    unsorted, merged and split flushes checked against their plain
    versions, and the three sorted flushes timed as kernel path and
    alone, beside the sort.
    The first flush of a render holds the fuse steps, whose points all
    go to the junk bin; the second is what every later flush looks
    like."""
    dev = torch.device("cuda")
    rec = flushes[1]
    gen = torch.Generator().manual_seed(3)
    synth, pal = flush_inputs(torch, rec.numel(), n_bins, acc_width, 3,
                              bits, gen)
    hist = thist.alloc(n_bins, dev)
    split = flush.alloc_split(n_bins, dev)
    pal4 = flush._pal4(pal).contiguous()
    fns, atomics = {}, {}
    errs = dict.fromkeys([*LOGICAL_FLUSHES, "win_flush_rgb16"], 0.0)
    start = split_start(torch, n_bins, gen)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for name, r in (("first", flushes[0]), ("real", rec),
                    ("synthetic", synth)):
        live = r[(r >> bits) < n_bins]
        fns[f"{name}_ms"] = (lambda r=r: flush.accumulate_packed(
            hist, r, pal, n_bins, bits))
        # the flush the C chunk loop launches: the same, counting
        count.zero_()
        flush.accumulate_packed(hist, r, pal, n_bins, bits, count=count)
        check(int(count) == int(((r >> bits) != n_bins).sum()),
              f"the {name} flush counted {int(count)} plotted records")
        fns[f"{name}_tally_ms"] = (lambda r=r: flush.accumulate_packed(
            hist, r, pal, n_bins, bits, count=count))
        fns[f"{name}_no_junk_ms"] = (lambda r=live: flush.accumulate_packed(
            hist, r, pal, n_bins, bits))
        atomics[name] = packed_atomics(torch, flush, r, pal4, n_bins, bits)
        if name == "synthetic":
            continue
        for cols, _bits, weight in FLUSH_CONFIGS:
            p = torch.rand((1 << bits, cols), generator=gen).to(dev)
            if cols == 4:
                p[:, :3] *= p[:, 3:]        # rgb * opacity, opacity
            for kernel in LOGICAL_FLUSHES:
                errs[kernel] = max(errs[kernel], check_flush(
                    torch, flush, thist, kernel, r, p, n_bins, bits,
                    weight, f"the {name} flush"))
            errs["win_flush_rgb16"] = max(
                errs["win_flush_rgb16"], check_rgb16(
                    torch, flush, start, r, p, n_bins, bits, weight,
                    f"the {name} flush"))
        srt = sort.sort_records(r)
        fns[f"{name}_win_ms"] = (lambda r=r: flush.accumulate_windowed(
            hist, r, pal, n_bins, bits))
        fns[f"{name}_win_kernel_only_ms"] = (
            lambda srt=srt: flush._launch(
                "win_flush", dev, srt.data_ptr(), srt.numel(),
                pal4.data_ptr(), bits, n_bins, 1.0, hist.data_ptr()))
        fns[f"{name}_sort_ms"] = lambda r=r: sort.sort_records(r)
        # the other two sorted flushes on the same records, each as its
        # kernel path and alone
        fns[f"{name}_merged_ms"] = (lambda r=r: flush.accumulate_merged(
            hist, r, pal, n_bins, bits))
        fns[f"{name}_merged_kernel_only_ms"] = (
            lambda srt=srt: flush._launch(
                "merged_flush", dev, srt.data_ptr(), srt.numel(),
                pal4.data_ptr(), bits, n_bins, 1.0, hist.data_ptr()))
        fns[f"{name}_rgb16_ms"] = (
            lambda r=r: flush.accumulate_windowed_rgb16(split, r, pal,
                                                        n_bins, bits))
        fns[f"{name}_rgb16_kernel_only_ms"] = rgb16_alone(
            torch, flush, flush._aligned(srt), pal4, n_bins, bits, 1.0,
            split)
    del start
    med = medians(torch, fns)
    # the split flush's two launches apart: its tiles, then its resolve
    for name in ("first", "real"):
        med[f"{name}_rgb16_tiles_resolve_device_ms"] = launch_device_ms(
            torch, flush._build, fns[f"{name}_rgb16_kernel_only_ms"])
    mixes = {name: flush_mix(torch, r, n_bins, bits)
             for name, r in (("first", flushes[0]), ("real", rec),
                             ("synthetic", synth))}
    # a logical flush's bound on each mix: the records read once, each
    # touched bin (and the junk bin) read and written once, the palette
    bounds = {name: bound(m["records"] * 8 + (m["touched_bins"] + 1) * 32
                          + pal4.numel() * 4)[0]
              for name, m in mixes.items()}
    # the split flush's: 4 bytes of density and 6 of rgb a touched bin
    rgb16_bounds = {name: bound(m["records"] * 8
                                + (m["touched_bins"] + 1) * 20
                                + pal4.numel() * 4)[0]
                    for name, m in mixes.items()}
    phase(4, "flush_mix", kernels=["packed_flush", "win_flush",
                                   "bitonic_sort", "merged_flush",
                                   "win_flush_rgb16"], color_bits=bits,
          **mixes, bound_ms=bounds, rgb16_bound_ms=rgb16_bounds,
          packed_flush_atomics=atomics,
          **{f"{k}_max_abs_err": v for k, v in errs.items()}, **med)


@contextlib.contextmanager
def python_loop(it):
    """Renders through the Python chunk loop of ops/iterate.py (`it`),
    which calls the PACKED_FLUSHES entry once a chunk, where the card
    would queue the chunks from C: for a wrapped flush to see each
    chunk's records."""
    c_loop = it.takes_c_loop
    it.takes_c_loop = lambda backend, device: False
    try:
        yield
    finally:
        it.takes_c_loop = c_loop


def second_flush(tit, r, t=0.0, seed=5):
    """(records, palette rows, bits) of the second flush of a frame of
    Renderer `r`: the first past the fuse steps, seen in the Python
    chunk loop (the C loop's records are the same)."""
    real, kept = tit.PACKED_FLUSHES[r.backend], []

    def keep(hist, recs, palette_hi, n_bins, bits, weight=None):
        if len(kept) < 2:
            kept.append((recs.reshape(-1).clone(), palette_hi.clone(), bits))
        return real(hist, recs, palette_hi, n_bins, bits, weight)
    tit.PACKED_FLUSHES[r.backend] = keep
    try:
        with python_loop(tit):
            r.accumulate(t, seed=seed)
    finally:
        tit.PACKED_FLUSHES[r.backend] = real
    check(len(kept) == 2, f"{len(kept)} flushes kept, expected 2")
    return kept[1]


def phase_default_flush(torch, flush, tit, thist, Renderer, get_profile,
                        RenderProfile, full_feature, animated_spark):
    """`atomic` (the default, unsorted) against `pallas_win` (sorted) on
    a real second flush at three geometries (phase 4): full_feature at
    1080p ss2, a 720p still of animated_spark and full_feature at
    retune.UNTILED_DIMS
    (512x512 at batch 2^17 and 32 steps a flush: ~16 records a bin, the
    most contended atomics).  Density bit-exact; rgb within 1e-5 of the
    bin's density plus the float32 rounding of summing its records one
    by one (density x 2^-24 of the sum: the atomics add in no order,
    and a hot bin takes 10^4-10^5 records a flush); medians of each
    path's calls in turns; the atomics packed_flush made; the bound from
    the records and touched bins.  Returns {geometry: fields}."""
    from cuburn_tpu_torch.retune import UNTILED_DIMS
    dev = torch.device("cuda")
    w, h = UNTILED_DIMS
    cases = {}
    for geometry, genome, prof, t in (
            ("1080p", full_feature(), get_profile("1080p", quality=32),
             0.0),
            ("720p", animated_spark(), get_profile("720p", quality=100),
             0.5),
            ("512", full_feature(), RenderProfile(
                width=w, height=h, quality=200, batch=1 << 17), 0.0)):
        r = Renderer(genome, prof)
        check(r.backend == "atomic", f"{geometry}: backend {r.backend}")
        cases[geometry] = (second_flush(tit, r, t), r.cam.n_bins)
    out = {}
    for geometry, ((rec, pal, bits), n_bins) in cases.items():
        hists = {b: thist.alloc(n_bins, dev) for b in ("atomic",
                                                        "pallas_win")}
        for b, hist in hists.items():
            tit.PACKED_FLUSHES[b](hist, rec, pal, n_bins, bits)
        torch.cuda.synchronize()
        a, win = hists["atomic"], hists["pallas_win"]
        check(torch.equal(a[:, 3], win[:, 3]),
              f"{geometry}: atomic's density differs from pallas_win's")
        err = (a[:, :3] - win[:, :3]).abs()
        dens = win[:, 3:].clamp(min=1.0)
        check(bool((err <= 1e-5 * dens + dens * 2.0 ** -24
                    * win[:, :3].abs()).all()),
              f"{geometry}: atomic's rgb {float(err.max())} from "
              "pallas_win's")
        med = medians(torch, {
            f"{b}_ms": (lambda b=b: tit.PACKED_FLUSHES[b](
                hists[b], rec, pal, n_bins, bits))
            for b in ("atomic", "pallas_win")})
        mix = flush_mix(torch, rec, n_bins, bits)
        out[geometry] = dict(
            bins=n_bins, color_bits=bits, **mix,
            atomics=packed_atomics(torch, flush, rec, flush._pal4(pal),
                                   n_bins, bits),
            bound_ms=bound(mix["records"] * 8 + (mix["touched_bins"] + 1)
                           * 32 + pal.shape[0] * 16)[0],
            rgb_max_abs_err=float(err.max()),
            rgb_max_err_over_density=float((err / dens).max()),
            max_density=float(win[:-1, 3].max()), **med,
            pallas_win_over_atomic_device=(med["pallas_win_device_ms"]
                                           / med["atomic_device_ms"]))
        phase(4, "default_flush", geometry=geometry, **out[geometry])
        del hists, a, win
    return out


def phase_render_backend(torch, flush, tiled_sort, tit, Renderer, genome,
                         get_profile, backend, quality):
    """full_feature at 1080p through one more backend (phase 7):
    accumulate + finalize_frame, the two halves of render_frame, so one
    pass gives the launches, the mass and the frame.  Returns the
    launches of its flush kernel and of the sort."""
    from cuburn_tpu_torch.utils import trace
    name = FLUSH_KERNEL[backend]
    r = Renderer(genome, get_profile("1080p", quality=quality,
                                     hist_backend=backend))
    check(r.backend == backend, f"backend {r.backend}, expected {backend}")
    reset_launches(flush, tiled_sort)
    before = trace.counters()
    hist, stats = r.accumulate(0.0, seed=1)
    img = r.finalize_frame(hist, 0.0, stats)
    counted = trace.since(before)
    flushes = counted["chunks"]         # one flush a chunk
    launches = flush.LAUNCHES[name]
    sorts = tiled_sort.LAUNCHES["bitonic_sort"]
    chaos_launches = launches_now(flush, tiled_sort)["chaos_iterate"]
    probe = probe_launches(flush, tiled_sort)
    looped = flushes if tit.takes_c_loop(backend, "cuda") else 0
    check(counted["looped_chunks"] == looped,
          f"the {backend} render queued {counted['looped_chunks']} of "
          f"{flushes} chunks from C, expected {looped}")
    check(probe == dict.fromkeys(PROBE_KERNELS, 0),
          f"the {backend} render launched {probe}")
    check(launches == flushes * LAUNCHES_PER_FLUSH[name] > 0,
          f"the {backend} render launched {name} {launches} times in "
          f"{flushes} flushes, expected {LAUNCHES_PER_FLUSH[name]} a flush")
    check(chaos_launches == flushes, f"the {backend} render launched the "
          f"chaos game {chaos_launches} times in {flushes} chunks")
    per_chunk = r._batch_for(r.profile.total_iters) * r.profile.iters_per_chunk
    passes = 0 if backend in UNSORTED else len(
        tiled_sort.bitonic_schedule(1 << (per_chunk - 1).bit_length()))
    check(sorts == flushes * passes, f"the {backend} render launched "
          f"{sorts} sort passes in {flushes} flushes, expected {passes} a "
          "flush")
    check(bool(torch.isfinite(hist).all()),
          f"{backend}: non-finite histogram")
    mass = float(hist[:-1, 3].double().sum())
    check(abs(mass - stats.plotted_samples) <= 1e-4 * mass,
          f"{backend}: histogram mass {mass} != plotted samples "
          f"{stats.plotted_samples}")
    check(img.shape == (1080, 1920, 4), f"image shape {img.shape}")
    check(bool(img[..., :3].any()), f"{backend}: the image is black")
    cam = r.cam
    phase(7, "render", genome="full_feature", profile="1080p",
          quality=quality, bins=cam.n_bins, backend=backend, kernel=name,
          launches=launches, sort_launches=sorts,
          chaos_launches=chaos_launches, flushes=flushes,
          plotted_samples=stats.plotted_samples,
          total_iters=stats.total_iters, mass=mass,
          samples_per_s=stats.samples_per_sec,
          iterate_s=stats.iterate_s, filter_s=stats.filter_s,
          lit_fraction=float((img[..., :3] > 0).any(-1).mean()))
    return {name: launches, "bitonic_sort": sorts}


def phase_parity(torch, Renderer, RenderProfile, g, backend="pallas_win",
                 phase_no=5, t=0.0, **blur):
    """CUDA against CPU by distribution at 128x128.  One seed gives both
    devices the same starting trajectories.  `blur`: the profile fields
    of a motion-blurred frame."""
    prof = RenderProfile(width=128, height=128, quality=100,
                         hist_backend=backend, de_enabled=False, **blur)
    h_cu, s_cu = Renderer(g, prof, device="cuda").accumulate(t, seed=11)
    cpu = Renderer(g, prof, device="cpu")
    h_a, _ = cpu.accumulate(t, seed=11)
    h_b, _ = cpu.accumulate(t, seed=12)
    check(bool(torch.isfinite(h_cu).all()), "non-finite histogram")
    floor = tv_distance(h_a, h_b)
    d = tv_distance(h_cu, h_a)
    phase(phase_no, "parity", genome=g.name, backend=backend,
          tv_cuda_vs_cpu=d, tv_cpu_two_seed_floor=floor, limit=3 * floor,
          plotted=s_cu.plotted_samples, **blur)
    check(d < 3 * floor, f"{g.name} via {backend}: TV {d} >= 3x floor "
          f"{floor}")


def spark(animated_spark, ftype="gaussian"):
    g = animated_spark()
    g.temporal_filter_type = ftype
    return g


def reset_launches(flush, tiled_sort):
    from cuburn_tpu_torch.ops import chaos
    from cuburn_tpu_torch.probes import bf16probe
    for counts in (flush.LAUNCHES, tiled_sort.LAUNCHES, chaos.LAUNCHES,
                   bf16probe.LAUNCHES):
        for k in counts:
            counts[k] = 0


def frame_flushes(r, stats):
    """Flushes of one frame of Renderer `r`, from its iteration count,
    checked against temporal samples x chunks a sample."""
    prof = r.profile
    per_chunk = r._batch_for(prof.total_iters) * prof.iters_per_chunk
    flushes = stats.total_iters // per_chunk
    n_chunks = -(-prof.total_iters // (prof.temporal_samples * per_chunk))
    check(flushes == prof.temporal_samples * max(1, n_chunks),
          f"{flushes} flushes a frame, expected {prof.temporal_samples} x "
          f"{n_chunks}")
    return flushes, per_chunk


def check_frame_launches(flush, tiled_sort, r, stats, frames, what):
    """`frames` frames of `r` launched the chaos game once a chunk, its
    flush kernel once a flush (the split flush twice) and, where the
    flush sorts, the sort's passes before each.  Returns {kernel:
    launches}."""
    name = FLUSH_KERNEL[r.backend]
    flushes, per_chunk = frame_flushes(r, stats)
    passes = 0 if r.backend in UNSORTED else len(
        tiled_sort.bitonic_schedule(1 << (per_chunk - 1).bit_length()))
    got = {name: flush.LAUNCHES[name],
           "bitonic_sort": tiled_sort.LAUNCHES["bitonic_sort"],
           "chaos_iterate": launches_now(flush, tiled_sort)["chaos_iterate"],
           **probe_launches(flush, tiled_sort)}
    want = {name: frames * flushes * LAUNCHES_PER_FLUSH[name],
            "bitonic_sort": frames * flushes * passes,
            "chaos_iterate": frames * flushes,
            **dict.fromkeys(PROBE_KERNELS, 0)}
    check(got == want and got[name] > 0,
          f"{what}: launches {got}, expected {want}")
    if not passes:
        del got["bitonic_sort"]
    return got


def check_weighted_mass(torch, tit, r, t, seed):
    """One more accumulation of the frame at `t` with every sample's
    plotted count kept apart: the histogram's mass is the sum of weight
    x plotted count.  Returns (mass, the (weight, plotted) pairs)."""
    samples, plain = [], tit.iterate_accumulate

    def recording(*args, **kwargs):
        out = plain(*args, **kwargs)
        samples.append((kwargs["weight"], float(out[2])))
        return out
    tit.iterate_accumulate = recording
    try:
        hist, stats = r.accumulate(t, seed=seed)
    finally:
        tit.iterate_accumulate = plain
    check(bool(torch.isfinite(hist).all()), "non-finite histogram")
    check(len(samples) == r.profile.temporal_samples,
          f"{len(samples)} temporal samples accumulated")
    check([w for w, _ in samples] == [
        float(w) for w in r._temporal_times(t)[1].astype("float32")],
        f"sample weights {samples} are not the temporal filter's")
    mass = float(hist[:-1, 3].double().sum())
    want = sum(w * n for w, n in samples)
    check(abs(mass - want) <= 1e-5 * want,
          f"{r.backend}: histogram mass {mass} != sum of weight x plotted "
          f"{want}")
    check(abs(sum(n for _, n in samples) - stats.plotted_samples)
          <= 1e-6 * stats.plotted_samples, "plotted counts do not add up")
    return mass, samples


def timed_frames(torch, frames):
    """Drive a frame iterator to its end: (list of (image, stats), wall
    seconds, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(frames)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def frame_fields(stats):
    return {"iterate_s": stats.iterate_s, "filter_s": stats.filter_s,
            "samples_per_s": stats.samples_per_sec,
            "plotted_samples": stats.plotted_samples,
            "total_iters": stats.total_iters}


def mean_rgb(img):
    return float(img[..., :3].mean())


def phase_animation(torch, flush, tiled_sort, tit, write_image, Renderer,
                    animated_spark, get_profile, quality):
    """Animation at full width (phase 9).  Returns the launches of every
    kernel while its backend rendered motion-blurred frames, and the
    middle frame."""
    import numpy as np

    from cuburn_tpu_torch.ops.interp import pack_genome
    T = ANIM_SAMPLES

    def renderer(backend="auto", ftype="gaussian", samples=T,
                 frames=3, q=quality):
        return Renderer(spark(animated_spark, ftype), get_profile(
            "1080p", quality=q, temporal_samples=samples, fps=4.0,
            duration=frames / 4.0, hist_backend=backend))

    r = renderer()
    check(r.backend == "atomic" and r.profile.batch == 1 << 17,
          f"backend {r.backend}, batch {r.profile.batch}")
    times = r.frame_times()
    check(len(times) == 3, f"{len(times)} frames, expected 3")
    # the interpolator's host cost for one frame's samples
    packed = pack_genome(r.genome, r.device)
    ts = np.asarray(r._temporal_times(times[1][1])[0], np.float32)
    eval_ms = medians(torch, {"ms": lambda: packed.eval_params(ts)})["ms"]

    # serial frame loop, the launches read frame by frame
    launches = dict.fromkeys(KERNELS, 0)
    serial, serial_s, it = [], 0.0, r.frames(seed=1)
    for k in range(len(times)):
        reset_launches(flush, tiled_sort)
        (frame,), dt = timed_frames(torch, itertools.islice(it, 1))
        got = check_frame_launches(flush, tiled_sort, r, frame[1], 1,
                                   f"frame {k} through frames()")
        for name, n in got.items():
            launches[name] += n
        serial.append(frame)
        serial_s += dt
    check(next(it, None) is None, "frames() yielded a fourth frame")
    out_dir = os.path.join(REPO, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    pngs = []
    for k, (img, stats) in enumerate(serial):
        check(img.shape == (1080, 1920, 4), f"frame {k} shape {img.shape}")
        check(bool(img[..., :3].any()), f"frame {k} is black")
        check(stats.plotted_samples > 0, f"frame {k} plotted nothing")
        pngs.append(os.path.join(out_dir, f"chip_smoke_anim_{k}.png"))
        write_image(pngs[-1], img)
    check(not np.array_equal(serial[0][0], serial[2][0]),
          "frame 0 equals frame 2: nothing animates")

    # overlapped frame loop: the same frames, the launches of all three
    reset_launches(flush, tiled_sort)
    over, over_s = timed_frames(torch, r.frames_overlapped(seed=1))
    check(len(over) == 3, f"frames_overlapped yielded {len(over)} frames")
    check_frame_launches(flush, tiled_sort, r, over[0][1], 3,
                         "3 frames through frames_overlapped()")
    differing = []
    for k, ((a, sa), (b, sb)) in enumerate(zip(serial, over)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        check(int(d.max()) <= 1, f"overlapped frame {k} is {int(d.max())} "
              "u8 steps from the serial one")
        check(sa.total_iters == sb.total_iters, "iteration counts differ")
        differing.append(int((d > 0).any(-1).sum()))
    for name, frames in (("frames", serial), ("frames_overlapped", over)):
        for k, (_img, stats) in enumerate(frames):
            phase(9, "animation", loop=name, frame=k, t=times[k][1],
                  **frame_fields(stats))
    # the two frame loops once more in the other order, wall time only
    _again, over_again_s = timed_frames(torch, r.frames_overlapped(seed=1))
    _again, serial_again_s = timed_frames(torch, r.frames(seed=1))
    del _again

    # the weighted mass, the still at the same time, the box filter
    t1 = times[1][1]
    mass, samples = check_weighted_mass(torch, tit, r, t1, seed=2)
    still, still_stats = renderer(samples=1).render_frame(t1, seed=2)
    check(not np.array_equal(still, serial[1][0]),
          "the motion-blurred frame equals the still at its time")
    box, _ = renderer(ftype="box").render_frame(t1, seed=2)
    m_g, m_box = mean_rgb(serial[1][0]), mean_rgb(box)
    check(abs(m_g - m_box) <= 0.1 * m_box,
          f"gaussian frame mean {m_g} against box {m_box}: over 10% apart")
    flushes, per_chunk = frame_flushes(r, serial[0][1])
    phase(9, "animation", genome="animated_spark", profile="1080p",
          temporal_filter="gaussian", temporal_samples=T, quality=quality,
          bins=r.cam.n_bins, backend=r.backend, frames=3,
          flushes_per_frame=flushes, records_per_flush=per_chunk,
          launches=launches, serial_s=[serial_s, serial_again_s],
          overlapped_s=[over_s, over_again_s],
          eval_params_host_ms=eval_ms, weights=[w for w, _ in samples],
          mass=mass, plotted=[n for _, n in samples],
          pixels_differing_overlapped=differing,
          still=frame_fields(still_stats), mean_rgb_gaussian=m_g,
          mean_rgb_box=m_box, mean_rgb_still=mean_rgb(still),
          png=[os.path.relpath(p, REPO) for p in pngs])

    # the split flush sums in a fixed order: overlapped == serial, bit
    # for bit; the windowed, the unsorted and the merged flush, one
    # blurred frame each
    for backend, n_frames, q in (("pallas_rgb16", 2, quality),
                                 ("pallas_win", 1, max(quality // 2, 1)),
                                 ("pallas", 1, max(quality // 2, 1)),
                                 ("pallas_merged", 1, max(quality // 2, 1))):
        rb = renderer(backend, frames=n_frames, q=q)
        reset_launches(flush, tiled_sort)
        a, a_s = timed_frames(torch, rb.frames(seed=1))
        check(len(a) == n_frames, f"{backend}: {len(a)} frames")
        got = check_frame_launches(flush, tiled_sort, rb, a[0][1], n_frames,
                                   f"{n_frames} frames through {backend}")
        launches[FLUSH_KERNEL[backend]] += got[FLUSH_KERNEL[backend]]
        if backend == "pallas_win":
            launches["bitonic_sort"] += got["bitonic_sort"]
        fields = {}
        if backend == "pallas_rgb16":
            b, b_s = timed_frames(torch, rb.frames_overlapped(seed=1))
            for k, ((x, _), (y, _)) in enumerate(zip(a, b)):
                check(np.array_equal(x, y), f"{backend}: overlapped frame "
                      f"{k} differs from the serial one")
            fields = {"overlapped_s": b_s, "overlapped_equals_serial": True}
        mass, samples = check_weighted_mass(torch, tit, rb,
                                            rb.frame_times()[0][1], seed=2)
        check(bool(a[0][0][..., :3].any()), f"{backend}: a black frame")
        phase(9, "animation", backend=backend, frames=n_frames, quality=q,
              launches=got, serial_s=a_s, **fields, mass=mass,
              iterate_s=[s.iterate_s for _, s in a])
    for name, n in launches.items():
        check(n == 0 if name in PROBE_KERNELS else n > 0,
              f"the animation launched {name} {n} times")
    return launches, serial[1][0]


def check_striped(torch, whole, sw, striped, ss, what, bf16_flushes=0):
    """A striped histogram against the whole frame's from the same seed:
    density (integer counts at weight 1.0) equal in every bin; rgb within
    1e-5 of the bin's density (float atomics add in any order), or for
    the split flush within one bf16 ulp a flush (`bf16_flushes`: a run
    that crosses a tile edge in one layout and not the other is summed
    in another order in float32, and the bf16 rounding of the bin may
    then go the other way); the junk row 0; plotted counts equal within
    1e-6 (the counter is float32, as in the JAX package: past 2^24 a
    running total of other chunks rounds otherwise).  Returns the max
    rgb error."""
    check(torch.equal(whole[:-1, 3], striped[:-1, 3]),
          f"{what}: striped density differs from the whole frame's")
    err = (whole[:-1, :3] - striped[:-1, :3]).abs()
    tol = (bf16_flushes * 2.0 ** -7 * whole[:-1, :3].abs() if bf16_flushes
           else 1e-5 * whole[:-1, 3:].clamp(min=1.0))
    check(bool((err <= tol).all()),
          f"{what}: striped rgb max err {float(err.max())}")
    check(float(striped[-1].abs().sum()) == 0.0, f"{what}: junk row not 0")
    check(sw.plotted_samples > 0 and abs(ss.plotted_samples
                                         - sw.plotted_samples)
          <= 1e-6 * sw.plotted_samples,
          f"{what}: plotted {ss.plotted_samples} striped against "
          f"{sw.plotted_samples} whole")
    return float(err.max())


def launches_now(flush, tiled_sort):
    from cuburn_tpu_torch.ops import chaos
    from cuburn_tpu_torch.probes import bf16probe
    return {**flush.LAUNCHES, **tiled_sort.LAUNCHES, **chaos.LAUNCHES,
            **bf16probe.LAUNCHES}


def probe_launches(flush, tiled_sort):
    """The probe kernels' launches since the last reset."""
    now = launches_now(flush, tiled_sort)
    return {name: now[name] for name in PROBE_KERNELS}


def partition_launches(flush, tiled_sort, r, stats, n_flushes, what):
    """The launches of `r`'s flush kernel, the sort and the chaos game
    since the last reset: one flush kernel launch a flush (two for the
    split flush), the sort's passes before each sorted flush, one chaos
    game launch a chunk."""
    name = FLUSH_KERNEL[r.backend]
    per_chunk = r._batch_for(r.profile.total_iters) * r.profile.iters_per_chunk
    flushes = stats.total_iters // per_chunk
    check(flushes == n_flushes, f"{what}: {flushes} flushes, expected "
          f"{n_flushes}")
    passes = 0 if r.backend in UNSORTED else len(
        tiled_sort.bitonic_schedule(1 << (per_chunk - 1).bit_length()))
    got = {name: flush.LAUNCHES[name],
           "bitonic_sort": tiled_sort.LAUNCHES["bitonic_sort"],
           "chaos_iterate": launches_now(flush, tiled_sort)["chaos_iterate"],
           **probe_launches(flush, tiled_sort)}
    want = {name: flushes * LAUNCHES_PER_FLUSH[name],
            "bitonic_sort": flushes * passes, "chaos_iterate": flushes,
            **dict.fromkeys(PROBE_KERNELS, 0)}
    check(got == want and got[name] > 0,
          f"{what}: launches {got}, expected {want}")
    if not passes:
        del got["bitonic_sort"]
    return got, flushes, passes


def measured_filter(torch, fn):
    """(image, filter_s, peak bytes allocated during fn, bytes allocated
    before it) of one finalize call."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    return (img, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(), start)


def compare_filters(torch, r, hist, n_bands, what):
    """finalize_frame against finalize_frame_banded on one histogram,
    each warmed once and then measured: within one u8 step and under
    0.5% of pixels apart.  Returns (whole image, fields)."""
    import numpy as np
    r.finalize_frame(hist, 0.0)
    r.finalize_frame_banded(hist, 0.0, n_bands=n_bands)
    whole, whole_s, whole_peak, start = measured_filter(
        torch, lambda: r.finalize_frame(hist, 0.0))
    banded, banded_s, banded_peak, _ = measured_filter(
        torch, lambda: r.finalize_frame_banded(hist, 0.0, n_bands=n_bands))
    d = np.abs(whole.astype(np.int16) - banded.astype(np.int16))
    differing = float((d > 0).any(-1).mean())
    check(int(d.max()) <= 1 and differing < 0.005,
          f"{what}: banded frame {int(d.max())} u8 steps from the whole "
          f"filter's, {differing:.4%} of pixels apart")
    check(bool(whole[..., :3].any()), f"{what}: the frame is black")
    return whole, {
        "n_bands": n_bands, "max_u8_step": int(d.max()),
        "pixels_differing": differing, "filter_s_whole": whole_s,
        "filter_s_banded": banded_s, "allocated_before_bytes": start,
        "peak_bytes_whole": whole_peak, "peak_bytes_banded": banded_peak,
        "peak_over_start_bytes_whole": whole_peak - start,
        "peak_over_start_bytes_banded": banded_peak - start}


def phase_partition(torch, flush, sort, tiled_sort, thist, tit, write_image,
                    Renderer, full_feature, animated_spark, get_profile,
                    quality):
    """Phase 10: striped accumulation, banded filtering, the unpacked 4k
    path and both partitions of a motion-blurred frame.  Returns the
    launches of every kernel in the partitioned runs."""
    import warnings

    import numpy as np
    half, quarter = max(quality // 2, 1), max(quality // 4, 1)
    launches = dict.fromkeys(KERNELS, 0)
    out_dir = os.path.join(REPO, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)

    # (a) 1080p through pallas_win, whole frame then 4 stripes; the
    # records of a middle stripe's second flush are kept for timing
    r = Renderer(full_feature(), get_profile("1080p", quality=half,
                                             hist_backend="pallas_win"))
    check(r.backend == "pallas_win", f"backend {r.backend}")
    reset_launches(flush, tiled_sort)
    whole, sw = r.accumulate(0.0, seed=3)
    per_frame, n_flushes, passes = partition_launches(
        flush, tiled_sort, r, sw, sw.total_iters // (
            r._batch_for(r.profile.total_iters) * r.profile.iters_per_chunk),
        "the whole 1080p frame")
    win, calls, kept = tit.PACKED_FLUSHES["pallas_win"], [], {}

    def keep(hist, recs, palette_hi, n_bins, bits, weight=None):
        calls.append(n_bins)
        if len(calls) == n_flushes + 2:      # stripe 1, its second flush
            kept.update(rec=recs.reshape(-1).clone(), n_bins=n_bins,
                        bits=bits)
        return win(hist, recs, palette_hi, n_bins, bits, weight)
    tit.PACKED_FLUSHES["pallas_win"] = keep
    reset_launches(flush, tiled_sort)
    try:
        striped, ss = r.accumulate_striped(0.0, seed=3, n_stripes=4)
    finally:
        tit.PACKED_FLUSHES["pallas_win"] = win
    got, _f, _p = partition_launches(flush, tiled_sort, r, ss, 4 * n_flushes,
                                     "4 stripes of the 1080p frame")
    for name, n in got.items():
        launches[name] += n
    check(got["win_flush"] == 4 * per_frame["win_flush"],
          "the stripes did not launch win_flush 4x the whole frame's")
    stripe_bins = sorted(set(calls))
    check(len(stripe_bins) == 1 and stripe_bins[0] * 4 == r.cam.n_bins,
          f"stripe flushes took n_bins {stripe_bins}")
    rgb_err = check_striped(torch, whole, sw, striped, ss,
                            "pallas_win, 4 stripes")
    phase(10, "partition", part="a", genome="full_feature", profile="1080p",
          quality=half, backend=r.backend, n_stripes=4,
          bins=r.cam.n_bins, stripe_bins=stripe_bins[0],
          flushes_whole=n_flushes, flushes_striped=4 * n_flushes,
          sort_passes_per_flush=passes, launches_whole=per_frame,
          launches_striped=got, density_equal=True, rgb_max_abs_err=rgb_err,
          plotted_samples=ss.plotted_samples,
          iterate_s_whole=sw.iterate_s, iterate_s_striped=ss.iterate_s,
          iterate_ratio=ss.iterate_s / sw.iterate_s,
          total_iters_whole=sw.total_iters, total_iters_striped=ss.total_iters)

    # a real stripe flush: checked against the plain versions, timed
    dev = torch.device("cuda")
    rec, n_bins, bits = kept["rec"], kept["n_bins"], kept["bits"]
    gen = torch.Generator().manual_seed(3)
    pal = torch.rand((1 << bits, 3), generator=gen).to(dev)
    pal4 = flush._pal4(pal).contiguous()
    errs = {k: check_flush(torch, flush, thist, k, rec, pal, n_bins,
                           bits, 1.0, "a stripe flush")
            for k in LOGICAL_FLUSHES}
    hist = thist.alloc(n_bins, dev)
    srt = sort.sort_records(rec)
    med = medians(torch, {
        "ms": lambda: flush.accumulate_windowed(hist, rec, pal, n_bins,
                                                bits),
        "kernel_only_ms": lambda: flush._launch(
            "win_flush", dev, srt.data_ptr(), srt.numel(), pal4.data_ptr(),
            bits, n_bins, 1.0, hist.data_ptr()),
        "sort_ms": lambda: sort.sort_records(rec),
        "plain_ms": lambda: flush.accumulate_windowed_reference(
            hist, rec, pal, n_bins, bits),
        "library_ms": lambda: library_flush(torch, hist, rec, pal4, n_bins,
                                            bits, 1.0)})
    mix = flush_mix(torch, rec, n_bins, bits)
    med["bound_ms"] = bound(mix["records"] * 8 + (mix["touched_bins"] + 1)
                            * 32 + pal4.numel() * 4)[0]
    phase(10, "partition", part="a_stripe_flush", kernel="win_flush",
          stripe=1, flush=2, bins=n_bins, color_bits=bits, **mix,
          **{f"{k}_max_abs_err": v for k, v in errs.items()}, **med)
    del rec, srt, hist, kept

    # the other three flush kernels, one striped frame each at Q/4
    for backend in ("pallas", "pallas_merged", "pallas_rgb16"):
        rb = Renderer(full_feature(), get_profile(
            "1080p", quality=quarter, hist_backend=backend))
        hw, sbw = rb.accumulate(0.0, seed=5)
        reset_launches(flush, tiled_sort)
        hs, sbs = rb.accumulate_striped(0.0, seed=5, n_stripes=4)
        per_chunk = rb._batch_for(rb.profile.total_iters) \
            * rb.profile.iters_per_chunk
        got, flushes, _p = partition_launches(
            flush, tiled_sort, rb, sbs, 4 * (sbw.total_iters // per_chunk),
            f"4 stripes through {backend}")
        for name, n in got.items():
            launches[name] += n
        err = check_striped(
            torch, hw, sbw, hs, sbs, f"{backend}, 4 stripes",
            bf16_flushes=flushes // 4 if backend == "pallas_rgb16" else 0)
        phase(10, "partition", part="a", backend=backend, quality=quarter,
              n_stripes=4, flushes_striped=flushes, launches_striped=got,
              density_equal=True, rgb_max_abs_err=err,
              iterate_s_whole=sbw.iterate_s, iterate_s_striped=sbs.iterate_s)
        del hw, hs

    # (b) banded filtering of (a)'s histogram
    del whole
    _img, fields = compare_filters(torch, r, striped, 4, "1080p")
    phase(10, "partition", part="b", profile="1080p", **fields)
    del striped, r

    # (c) 4k: unpacked records through scatter
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r4 = Renderer(full_feature(), get_profile("4k", quality=10))
        check(not caught, f"the 4k renderer warned: {caught}")
        asked = Renderer(full_feature(), get_profile(
            "4k", quality=10, hist_backend="pallas_win"))
    check(not r4.packed and r4.backend == "scatter",
          f"4k: packed {r4.packed}, backend {r4.backend}")
    check(asked.backend == "scatter" and any(
        "needs packed records" in str(w.message) for w in caught),
        "4k: pallas_win did not warn and become scatter")
    del asked
    scatter, chunk = thist.BACKENDS["scatter"], []

    def keep_second(hist, addr, rgba):
        chunk.append(None)
        if len(chunk) == 2:
            chunk[1] = (addr.reshape(-1).clone(), rgba.reshape(-1, 4).clone())
        return scatter.accumulate(hist, addr, rgba)
    thist.BACKENDS["scatter"] = dataclasses.replace(scatter,
                                                    accumulate=keep_second)
    reset_launches(flush, tiled_sort)
    torch.cuda.reset_peak_memory_stats()
    try:
        h4, s4 = r4.accumulate(0.0, seed=4)
    finally:
        thist.BACKENDS["scatter"] = scatter
    acc_peak = torch.cuda.max_memory_allocated()
    n4 = launches_now(flush, tiled_sort)
    chunks4 = s4.total_iters // (r4._batch_for(r4.profile.total_iters)
                                 * r4.profile.iters_per_chunk)
    check(n4.pop("chaos_iterate") == chunks4 and not any(n4.values()),
          f"4k: launches {launches_now(flush, tiled_sort)}, expected "
          f"chaos_iterate once a chunk ({chunks4}) and no packed-record "
          "kernel")
    check(bool(torch.isfinite(h4).all()), "4k: non-finite histogram")
    mass = float(h4[:-1, 3].double().sum())
    check(abs(mass - s4.plotted_samples) <= 1e-4 * mass,
          f"4k: histogram mass {mass} != plotted {s4.plotted_samples}")
    # one flush of full records (the second, past the fuse steps) timed
    # alone: index_add_ of 24-byte records into the 542 MB histogram
    addr, rgba = chunk[1]
    del chunk
    h_t = thist.alloc(r4.cam.n_bins, torch.device("cuda"))
    scatter_med = medians(torch, {
        "scatter_flush_ms": lambda: thist.accumulate_scatter(h_t, addr,
                                                             rgba)}, reps=5)
    live = addr[addr != r4.cam.junk_bin]
    touched = int(torch.unique(live).numel())
    scatter_med["scatter_flush_bound_ms"] = bound(
        addr.numel() * 24 + (touched + 1) * 32)[0]
    scatter_med.update(scatter_flush_records=addr.numel(),
                       scatter_flush_touched_bins=touched,
                       scatter_flush_junk_share=1 - live.numel()
                       / addr.numel())
    del addr, rgba, live, h_t
    h4s, s4s = r4.accumulate_striped(0.0, seed=4, n_stripes=2)
    err4 = check_striped(torch, h4, s4, h4s, s4s, "4k, 2 stripes")
    del h4s
    img4, fields4 = compare_filters(torch, r4, h4, 4, "4k")
    check(img4.shape == (r4.profile.height, r4.profile.width, 4),
          f"4k image shape {img4.shape}")
    png = os.path.join(out_dir, "chip_smoke_full_feature_4k.png")
    write_image(png, img4)
    cam = r4.cam
    per_chunk = r4._batch_for(r4.profile.total_iters) \
        * r4.profile.iters_per_chunk
    phase(10, "partition", part="c", genome="full_feature", profile="4k",
          quality=10, acc=[cam.acc_width, cam.acc_height], bins=cam.n_bins,
          packed=r4.packed, backend=r4.backend, records_per_flush=per_chunk,
          flushes=s4.total_iters // per_chunk,
          plotted_samples=s4.plotted_samples, total_iters=s4.total_iters,
          mass=mass, iterate_s=s4.iterate_s,
          samples_per_s=s4.samples_per_sec,
          accumulate_peak_bytes=acc_peak, **scatter_med,
          iterate_s_striped_2=s4s.iterate_s,
          striped_density_equal=True, striped_rgb_max_abs_err=err4,
          **fields4, lit_fraction=float((img4[..., :3] > 0).any(-1).mean()),
          png=os.path.relpath(png, REPO))
    del h4, r4, img4

    # (d) motion blur with both partitions
    rd = Renderer(spark(animated_spark), get_profile(
        "1080p", quality=quarter, temporal_samples=ANIM_SAMPLES, fps=4.0,
        duration=0.25, hist_backend="pallas_win"))
    check(len(rd.frame_times()) == 1, "10d: expected one frame")
    reset_launches(flush, tiled_sort)
    (plain,) = list(rd.frames(seed=1))
    n_plain = flush.LAUNCHES["win_flush"]
    reset_launches(flush, tiled_sort)
    (part,) = list(rd.frames_partitioned(seed=1, n_stripes=2, n_bands=2))
    got, flushes, _p = partition_launches(
        flush, tiled_sort, rd, part[1], 2 * n_plain, "10d, 2 stripes")
    for name, n in got.items():
        launches[name] += n
    d = np.abs(plain[0].astype(np.int16) - part[0].astype(np.int16))
    check(int(d.max()) <= 1, f"10d: partitioned frame {int(d.max())} u8 "
          "steps from frames()'")
    check(bool(part[0][..., :3].any()), "10d: the frame is black")
    phase(10, "partition", part="d", genome="animated_spark",
          temporal_samples=ANIM_SAMPLES, quality=quarter, n_stripes=2,
          n_bands=2, flushes=flushes, launches=got, max_u8_step=int(d.max()),
          pixels_differing=float((d > 0).any(-1).mean()),
          iterate_s=[plain[1].iterate_s, part[1].iterate_s],
          filter_s=[plain[1].filter_s, part[1].filter_s])
    for name in ("win_flush", "bitonic_sort", "packed_flush", "merged_flush",
                 "win_flush_rgb16"):
        check(launches[name] > 0, f"the partitioned runs launched no {name}")
    return launches


# -- phase 11: several ranks (parallel/shard.py, parallel/farm.py) ---------
# Rank functions run in processes of their own (parallel.launch.spawn),
# which import this file without running main(); each returns a dict of
# plain values that the parent prints.

# the collectives each 2-rank check needs, as the gloo probe names them
GLOO_NEEDS = {
    "replicated": ("all_reduce float32", "all_reduce float64"),
    "replicated_rgb16": ("all_reduce float32", "all_reduce bfloat16",
                         "all_reduce float64"),
    "band_filter": ("all_gather_into_tensor uint8",),
    "scattered": ("reduce_scatter_tensor float32", "all_reduce float64",
                  "all_gather_into_tensor uint8",
                  "all_gather_into_tensor float32"),
    "striped": ("all_gather_into_tensor float32", "all_reduce float64"),
    "motion_blur": ("all_reduce float32", "all_reduce float64",
                    "all_gather_into_tensor uint8"),
}


def check_sharded_hist(torch, want, sw, got, sg, n, what, bf16_flushes=0):
    """A sharded histogram (or block) against the one-device one from
    the same seed: density (integer counts at weight 1.0) equal in every
    bin; rgb within the rounding of its sums: a float32 sum of a bin's
    d records rounds at most once an add and once a product in each
    path, and the reduction once a rank, so (2d + n + 1) 2^-24 of the
    larger value; the split flush rounds to bf16 once a flush in each of
    F flushes and once a reduction, so (2F + n - 1) 2^-8.  Plotted counts
    within 1e-6 (float32 running totals).  Returns the max rgb error."""
    check(torch.equal(want[..., 3], got[..., 3]),
          f"{what}: density differs from the one-device histogram")
    a, b = want[..., :3].double(), got[..., :3].double()
    larger = torch.maximum(a.abs(), b.abs())
    tol = ((2 * bf16_flushes + n - 1) * 2.0 ** -8 * larger if bf16_flushes
           else (2 * want[..., 3:].double() + n + 1) * 2.0 ** -24 * larger)
    err = (a - b).abs()
    check(bool((err <= tol).all()), f"{what}: rgb max err {float(err.max())}")
    if sw is not None:
        check(sw.plotted_samples > 0 and abs(sg.plotted_samples
                                             - sw.plotted_samples)
              <= 1e-6 * sw.plotted_samples,
              f"{what}: plotted {sg.plotted_samples} sharded against "
              f"{sw.plotted_samples} on one device")
    return float(err.max())


def u8_apart(a, b, what, max_share=1.0):
    """(max u8 step, share of pixels apart) of two frames, checked to be
    within one step and under `max_share` of pixels."""
    import numpy as np
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    share = float((d > 0).any(-1).mean())
    check(a.shape == b.shape and int(d.max()) <= 1 and share <= max_share,
          f"{what}: {int(d.max())} u8 steps apart on {share:.4%} of pixels")
    check(bool(a[..., :3].any()), f"{what}: a black frame")
    return int(d.max()), share


def sort_passes(tiled_sort, records):
    """Launches of the tiled sort of one flush of `records` records."""
    return len(tiled_sort.bitonic_schedule(1 << (records - 1).bit_length()))


def rank_launches(flush, tiled_sort, fn):
    """fn()'s result and the kernel launches it made in this rank."""
    reset_launches(flush, tiled_sort)
    out = fn()
    return out, {k: v for k, v in launches_now(flush, tiled_sort).items()
                 if v}


def timed_in_turns(torch, one, sharded):
    """iterate_s and filter_s of the one-device frame and the sharded
    frame, rendered in turns: one, sharded, sharded, one."""
    out = {"one_device": [], "sharded": []}
    for name in ("one_device", "sharded", "sharded", "one_device"):
        _img, st = (one if name == "one_device" else sharded)()
        out[name].append({"iterate_s": st.iterate_s,
                          "filter_s": st.filter_s})
    return out


def world_1_rank(rank, device, quality):
    """Phase 11a: one rank over NCCL on cuda:0.  Replicated, scattered
    and stripe-parallel modes against the one-device Renderer."""
    import torch

    from cuburn_tpu_torch.models import full_feature
    from cuburn_tpu_torch.ops import flush, tiled_sort
    from cuburn_tpu_torch.parallel.shard import ShardedRenderer
    from cuburn_tpu_torch.profile import get_profile
    from cuburn_tpu_torch.render import Renderer
    prof = get_profile("1080p", quality=quality, hist_backend="pallas_win")
    one = Renderer(full_feature(), prof, device)
    sh = ShardedRenderer(full_feature(), prof, device)
    check(sh.backend == "pallas_win" and sh.n_devices == 1,
          f"11a: backend {sh.backend}, {sh.n_devices} ranks")
    want, sw = one.accumulate(0.0, seed=3)
    (got, sg), launches = rank_launches(
        flush, tiled_sort, lambda: sh.accumulate(0.0, seed=3))
    per_chunk = sh._batch_for(prof.total_iters) * sh.profile.iters_per_chunk
    flushes = sg.total_iters // per_chunk
    passes = sort_passes(tiled_sort, per_chunk)
    check(launches == {"win_flush": flushes,
                       "bitonic_sort": flushes * passes,
                       "chaos_iterate": flushes},
          f"11a: launches {launches} for {flushes} flushes")
    out = {"flushes": flushes, "sort_passes_per_flush": passes,
           "launches_sharded": {"pallas_win": launches}, "rgb_max_abs_err": {
               "replicated": check_sharded_hist(
                   torch, want[:-1], sw, got[:-1], sg, 1, "11a replicated")}}
    img1 = one.finalize_frame(want, 0.0)
    out["u8_apart"] = {"replicated": u8_apart(
        img1, sh.finalize_frame(got, 0.0), "11a replicated frame")}
    block, sb = sh.accumulate_scattered(0.0, seed=3)
    _h, layout = sh._band_layout(1, True)
    img = want[:-1].reshape(sh.cam.acc_height, sh.cam.acc_width, 4)
    out["rgb_max_abs_err"]["scattered"] = check_sharded_hist(
        torch, layout.blocks(img)[0], sw, block, sb, 1, "11a scattered")
    out["u8_apart"]["scattered"] = u8_apart(
        img1, sh.finalize_frame_scattered(block, 0.0), "11a scattered frame")
    striped, ss = sh.accumulate_striped(0.0, seed=3)
    out["rgb_max_abs_err"]["striped"] = check_sharded_hist(
        torch, want[:-1], sw, striped[:-1], ss, 1, "11a stripe-parallel")
    del want, got, block, striped, img
    # one sharded frame through each other flush kernel
    for backend in ("pallas", "pallas_merged", "pallas_rgb16"):
        rb = ShardedRenderer(full_feature(), get_profile(
            "1080p", quality=quality, hist_backend=backend), device)
        (_h, st), out["launches_sharded"][backend] = rank_launches(
            flush, tiled_sort, lambda: rb.accumulate(0.0, seed=4))
        check(st.plotted_samples > 0, f"11a {backend}: nothing plotted")
    out["times"] = timed_in_turns(
        torch, lambda: one.render_frame(0.0, seed=5),
        lambda: sh.render_frame(0.0, seed=5))
    out["collectives"] = {
        "nccl": ["all_reduce float32", "all_reduce float64",
                 "reduce_scatter_tensor float32",
                 "all_gather_into_tensor float32",
                 "all_gather_into_tensor uint8"]}
    return out


def probe_gloo_cuda(torch, dist, device, rank):
    """{collective: None where gloo ran it on CUDA tensors and gave the
    right sums, else why not}, the same on both ranks."""
    n = dist.get_world_size()

    def reduce(dtype):
        x = torch.ones(8, dtype=dtype, device=device)
        dist.all_reduce(x)
        return bool((x == n).all())

    def scatter():
        out = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(out, torch.ones(4 * n, device=device))
        return bool((out == n).all())

    def gather(dtype):
        out = torch.empty(4 * n, dtype=dtype, device=device)
        dist.all_gather_into_tensor(
            out, torch.full((4,), rank, dtype=dtype, device=device))
        return out.cpu().tolist() == [float(k) if dtype.is_floating_point
                                      else k for k in range(n)
                                      for _ in range(4)]
    probes = {
        "all_reduce float32": lambda: reduce(torch.float32),
        "all_reduce float64": lambda: reduce(torch.float64),
        "all_reduce bfloat16": lambda: reduce(torch.bfloat16),
        "reduce_scatter_tensor float32": scatter,
        "all_gather_into_tensor float32": lambda: gather(torch.float32),
        "all_gather_into_tensor uint8": lambda: gather(torch.uint8),
    }
    out = {}
    for name, fn in probes.items():
        try:
            out[name] = None if fn() else "wrong result"
        except (RuntimeError, ValueError, TypeError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    # the ranks agree on what ran (a CPU tensor: gloo always takes those)
    ok = torch.tensor([v is None for v in out.values()], dtype=torch.int64)
    dist.all_reduce(ok)
    return {k: (None if int(c) == n else (v or "refused on another rank"))
            for (k, v), c in zip(out.items(), ok)}


def world_2_rank(rank, device, quality):
    """Phase 11b: two ranks on cuda:0 over gloo with CUDA tensors."""
    import torch
    import torch.distributed as dist

    from cuburn_tpu_torch.models import animated_spark, full_feature
    from cuburn_tpu_torch.ops import flush, tiled_sort
    from cuburn_tpu_torch.parallel.shard import ShardedRenderer, _gather
    from cuburn_tpu_torch.profile import get_profile
    from cuburn_tpu_torch.render import FrameStats, Renderer
    n = dist.get_world_size()
    probe = probe_gloo_cuda(torch, dist, device, rank)
    runs = {k: all(probe[c] is None for c in need)
            for k, need in GLOO_NEEDS.items()}
    out = {"probe": probe, "left_out": {
        k: {c: probe[c] for c in GLOO_NEEDS[k] if probe[c]}
        for k, ok in runs.items() if not ok},
        "rgb_max_abs_err": {}, "u8_apart": {}, "launches_sharded": {}}
    me = rank == 0          # rank 0 renders the one-device references

    def one_device(fn):
        """fn() on rank 0 alone; rank 1 waits."""
        res = fn() if me else None
        dist.barrier()
        return res

    prof = get_profile("1080p", quality=quality)
    sh = ShardedRenderer(full_feature(), prof, device)
    one = Renderer(full_feature(), prof, device)
    want = sw = None
    if runs["replicated"]:
        for backend in ("pallas_win", "pallas", "pallas_merged",
                        "pallas_rgb16"):
            if backend == "pallas_rgb16" and not runs["replicated_rgb16"]:
                continue
            bp = get_profile("1080p", quality=quality, hist_backend=backend)
            rb = ShardedRenderer(full_feature(), bp, device)
            w, s = one_device(lambda: Renderer(full_feature(), bp, device)
                              .accumulate(0.0, seed=3)) or (None, None)
            (got, sg), out["launches_sharded"][backend] = rank_launches(
                flush, tiled_sort, lambda: rb.accumulate(0.0, seed=3))
            per_chunk = rb._batch_for(bp.total_iters) \
                * rb.profile.iters_per_chunk
            if backend == "pallas_win":
                flushes = sg.total_iters // per_chunk
                passes = sort_passes(tiled_sort, per_chunk // n)
                check(out["launches_sharded"][backend] == {
                    "win_flush": flushes, "bitonic_sort": flushes * passes,
                    "chaos_iterate": flushes},
                    f"11b rank {rank}: launches "
                    f"{out['launches_sharded'][backend]} for {flushes} "
                    f"flushes of {per_chunk // n} records")
            if me:
                out["rgb_max_abs_err"][backend] = check_sharded_hist(
                    torch, w[:-1], s, got[:-1], sg, n, f"11b {backend}",
                    bf16_flushes=(sg.total_iters // per_chunk
                                  if backend == "pallas_rgb16" else 0))
            if backend == "pallas_win":
                want, sw, hist = w, s, got
            del w, got
    img_rep = None
    if runs["replicated"] and runs["band_filter"]:
        # the sharded band filter on the pyramid (1080p is 3896 wide)
        img_rep = sh.finalize_frame(hist, 0.0)
        if me:
            out["u8_apart"]["band_filter"] = u8_apart(
                one.finalize_frame(hist, 0.0), img_rep, "11b band filter",
                max_share=0.005)
        _h, layout = sh._band_layout(n, True)
        out["band_windows"] = {"margin": layout.margin, "ctx": layout.ctx,
                               "windows": layout.windows}
    if runs["scattered"] and img_rep is not None:
        block, sb = sh.accumulate_scattered(0.0, seed=3)
        img_sc = sh.finalize_frame_scattered(block, 0.0)
        blocks = _gather(block)       # every rank's block, for the check
        if me:
            _h, layout = sh._band_layout(n, True)
            ref = layout.blocks(hist[:-1].reshape(
                sh.cam.acc_height, sh.cam.acc_width, 4))
            out["rgb_max_abs_err"]["scattered_blocks"] = max(
                check_sharded_hist(torch, ref[k], None, blocks[k], None, n,
                                   f"11b scattered block {k}")
                for k in range(n))
            out["u8_apart"]["scattered"] = u8_apart(
                img_rep, img_sc, "11b scattered against replicated frame")
        del block, blocks
    if runs["striped"]:
        striped, ss = sh.accumulate_striped(0.0, seed=3)
        if me and want is not None:
            out["rgb_max_abs_err"]["striped"] = check_sharded_hist(
                torch, want[:-1], sw, striped[:-1], ss, n,
                "11b stripe-parallel")
        del striped
    if runs["motion_blur"]:
        bp = get_profile("1080p", quality=quality,
                         temporal_samples=ANIM_SAMPLES, fps=4.0,
                         duration=0.25)
        (got,) = list(ShardedRenderer(spark(animated_spark), bp,
                                      device).frames(seed=1))
        ref = one_device(lambda: list(Renderer(
            spark(animated_spark), bp, device).frames(seed=1))[0])
        if me:
            out["u8_apart"]["motion_blur"] = u8_apart(
                ref[0], got[0], "11b motion-blurred frame")
    if runs["replicated"] and runs["band_filter"]:
        out["times"] = timed_in_turns(
            torch, lambda: one_device(lambda: one.render_frame(0.0, seed=5))
            or (None, FrameStats()), lambda: sh.render_frame(0.0, seed=5))
    return out


def phase_farm(torch, write_image, Renderer, animated_spark, get_profile,
               quality):
    """Phase 11c: a FarmServer thread, one worker thread on cuda:0 and a
    client, 3 frames of animated_spark at 1080p; frame i within one u8
    step of Renderer.render_frame(t_i, seed=seed + i)."""
    import threading

    from cuburn_tpu_torch.genome.specs import Genome
    from cuburn_tpu_torch.parallel import farm
    g = spark(animated_spark)
    prof = get_profile("1080p", quality=quality, fps=4.0, duration=0.75)
    times = [t for _i, t in Renderer(g, prof).frame_times()]
    check(len(times) == 3, f"11c: {len(times)} frames")
    server = farm.FarmServer()
    server.serve_background()
    try:
        client = farm.FarmClient(server.address)
        t0 = time.perf_counter()
        ids = client.submit_animation(g, prof, times, seed=7)
        worker = threading.Thread(target=farm.run_worker,
                                  args=(server.address, "cuda:0"),
                                  kwargs={"max_tasks": len(ids)})
        worker.start()
        frames = [client.fetch(i, timeout=300) for i in ids]
        farm_s = time.perf_counter() - t0
        worker.join(timeout=60)
        check(not worker.is_alive(), "11c: the worker did not finish")
        client.close()
    finally:
        server.shutdown()
    ref = Renderer(Genome.from_json(g.to_json()), prof)
    apart = [u8_apart(ref.render_frame(t, seed=7 + i)[0], f,
                      f"11c farm frame {i}")
             for i, (t, f) in enumerate(zip(times, frames))]
    check(not (frames[0] == frames[2]).all(), "11c: frame 0 equals frame 2")
    os.makedirs(os.path.join(REPO, "smoke_out"), exist_ok=True)
    png = os.path.join(REPO, "smoke_out", "chip_smoke_farm_2.png")
    write_image(png, frames[2])
    phase(11, "sharded", part="c", genome="animated_spark", profile="1080p",
          quality=quality, frames=len(frames), times=times, seeds=[7, 8, 9],
          wall_s=farm_s, u8_apart=apart, png=os.path.relpath(png, REPO))


def phase_sharded(torch, write_image, Renderer, animated_spark,
                  get_profile, quality):
    """Phase 11: the sharded renderer in one rank over NCCL (a) and in
    two ranks on the one card over gloo (b), then the farm (c).  Returns
    the launches of each kernel in one sharded frame of one rank."""
    from cuburn_tpu_torch.parallel import launch
    check(torch.cuda.device_count() == 1,
          f"phase 11 plans for one card; this machine has "
          f"{torch.cuda.device_count()}")
    torch.cuda.empty_cache()
    q = max(quality // 4, 1)
    results = {}
    for part, fn, devices, backend in (
            ("a", world_1_rank, ["cuda:0"], "nccl"),
            ("b", world_2_rank, ["cuda:0", "cuda:0"], "gloo")):
        try:
            results[part] = launch.spawn(fn, devices, backend, q,
                                         timeout_s=300)
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            check(False, f"phase 11{part}: a rank failed: {e}")
        r0 = results[part][0]
        phase(11, "sharded", part=part, genome="full_feature",
              profile="1080p", quality=q, backend=backend,
              ranks=len(devices), devices=devices,
              **{k: v for k, v in r0.items() if k != "times"},
              launches_sharded_per_rank=[r["launches_sharded"]
                                         for r in results[part]])
        if "times" in r0:
            phase(11, "sharded", part=f"{part}_times", backend=backend,
                  ranks=len(devices), **r0["times"])
    phase_farm(torch, write_image, Renderer, animated_spark, get_profile, q)
    a = results["a"][0]["launches_sharded"]
    # rank_launches keeps nonzero counts, and 11a holds pallas_win's to
    # exactly the flush, the sort and the chaos game
    return {FLUSH_KERNEL[b]: n[FLUSH_KERNEL[b]] for b, n in a.items()} | {
        name: a["pallas_win"].get(name, 0) for name in (
            "bitonic_sort", "chaos_iterate", *PROBE_KERNELS)}


# -- phase 12: the tools (retune.py, --trace-dir, the native encoder) ------

def phase_tuner(torch, flush, tiled_sort, Renderer, full_feature,
                get_profile, chunks=4):
    """The tuner at its --quick sizes, `chunks` chunks a race (phase
    12a): it races every row twice in turns and keeps only picks that
    lead by more than a row moved between the passes.  The record is gated to this card, every
    race row numeric in both passes, l2_bytes the card's; win_flush,
    packed_flush, the split flush and the sort were launched during the
    race.  Then a
    1080p Renderer applies the record's tiled keys, the same record
    with its picks set (pallas_rgb16, 2^23 records a tiled flush) moves
    the Renderer to them, and the repo's TPU record is skipped."""
    from cuburn_tpu_torch import retune
    from cuburn_tpu_torch.ops import histogram as thist
    kind = torch.cuda.get_device_name(0)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    out_dir = os.path.join(REPO, "smoke_out")
    path = os.path.join(out_dir, "tune_cuda.json")
    reset_launches(flush, tiled_sort)
    os.environ["CUBURN_RETUNE_CHUNKS"] = str(chunks)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = retune.main(["--quick", "--out", path])
    finally:
        del os.environ["CUBURN_RETUNE_CHUNKS"]
    seconds = time.perf_counter() - t0
    launches = launches_now(flush, tiled_sort)
    check(rc == 0, f"retune returned {rc}")
    with open(path) as f:
        rec = json.load(f)
    check(rec["device"] == kind,
          f"tune record for {rec['device']!r}, this card is {kind!r}")
    check(rec["l2_bytes"] == l2, f"l2_bytes {rec['l2_bytes']} != {l2}")
    m, passes = rec["measurements"], rec["passes"]
    check(len(m) == 13 and all(isinstance(v, (int, float)) and v > 0
                               for v in m.values()),
          f"retune: race rows {m}")
    check(set(passes) == set(m) and all(
        len(rs) == 2 and all(isinstance(v, (int, float)) and v > 0
                             for v in rs) for rs in passes.values()),
          f"retune: passes {passes}")
    for name in ("win_flush", "packed_flush", "win_flush_rgb16",
                 "bitonic_sort", "chaos_iterate"):
        check(launches[name] > 0, f"retune launched no {name}")
    picks = {key: rec.get(key) for key in (
        "hist_backend", "hist_backend_tiled", "flush_records",
        "tiled_flush_records")}
    phase(12, "tools", part="a_tuner", seconds=seconds, chunks=chunks,
          device=rec["device"], l2_bytes=l2, picks=picks,
          launches=launches, unit="M iters/s", passes=passes,
          race_spread=rec["spread"],
          spread={row: (max(rs) - min(rs)) / min(rs)
                  for row, rs in passes.items()})

    # the record applied by the main path's Renderer (its tiled keys, as
    # the 1080p-ss2 histogram is past L2), then the same record with its
    # picks set, which must move the Renderer to them
    forced = dict(rec, hist_backend_tiled="pallas_rgb16",
                  tiled_flush_records=1 << 23)
    forced_path = os.path.join(out_dir, "tune_cuda_forced.json")
    with open(forced_path, "w") as f:
        json.dump(forced, f)
    prof = get_profile("1080p")
    try:
        for rec_path, want in ((path, rec), (forced_path, forced),
                               (os.path.join(REPO, "cuburn_tune.json"),
                                None)):
            os.environ["CUBURN_TUNE_FILE"] = rec_path
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                r = Renderer(full_feature(), prof)
            check(thist.histogram_tiled(r.cam.n_bins, r.device),
                  "the 1080p-ss2 histogram is not past L2")
            if want is not None:
                backend = want["hist_backend_tiled"]
                ipc = (want["flush_records"] // prof.batch
                       if want.get("flush_records") else 32)
                if backend in ("pallas_win", "pallas_rgb16") and \
                        want.get("tiled_flush_records"):
                    ipc = max(ipc, want["tiled_flush_records"] // prof.batch)
                said = "applying tune record"
            else:
                backend, ipc, said = "atomic", 32, "skipped"
            check(r.backend == backend and r.profile.iters_per_chunk == ipc
                  and said in err.getvalue(),
                  f"under {rec_path}: backend {r.backend}, iters_per_chunk "
                  f"{r.profile.iters_per_chunk}, expected {backend}, {ipc} "
                  f"and {said!r} on stderr ({err.getvalue()!r})")
            phase(12, "tools", part="a_applied",
                  record=os.path.relpath(rec_path, REPO), backend=r.backend,
                  iters_per_chunk=r.profile.iters_per_chunk,
                  stderr=err.getvalue().strip())
    finally:
        os.environ["CUBURN_TUNE_FILE"] = NO_TUNE_RECORD


def trace_kernel_counts(path):
    """{kernel: its kernel events in the Chrome trace at `path`}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events
             if str(e.get("cat", "")).lower() == "kernel"]
    return {k: sum(any(fn in n for fn in fns) for n in names)
            for k, fns in TRACE_KERNELS.items()}, len(names), len(events)


def phase_trace(torch, flush, tiled_sort, quality=10):
    """A 1080p render through the CLI with --trace-dir (phase 12b), in
    turns with the same render untraced (off, on, on, off): the trace
    parses, holds each hand kernel as many times as the launch counters
    say, and the iterate times of both.  Returns the traced render's
    launches."""
    from cuburn_tpu_torch import main as tmain
    out_dir = os.path.join(REPO, "smoke_out")
    trace_dir = os.path.join(out_dir, "trace")
    trace = os.path.join(trace_dir, "trace.json")
    metrics = os.path.join(out_dir, "trace_metrics.jsonl")
    runs = {"off": [], "on": []}
    traced = None
    for mode in ("off", "on", "on", "off"):
        if os.path.exists(metrics):
            os.remove(metrics)
        argv = ["gallery:full_feature", "--profile", "1080p", "--quality",
                str(quality), "-o", os.path.join(out_dir, "trace.png"),
                "--metrics-json", metrics]
        if mode == "on":
            argv += ["--trace-dir", trace_dir]
        reset_launches(flush, tiled_sort)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tmain.main(argv)
        wall = time.perf_counter() - t0
        check(rc == 0, f"the {mode} render returned {rc}")
        launches = launches_now(flush, tiled_sort)
        with open(metrics) as f:
            iterate_ms = json.loads(f.readlines()[-1])["iterate_ms"]
        run = {"iterate_ms": iterate_ms, "wall_s": wall}
        if mode == "on":
            counts, n_kernels, n_events = trace_kernel_counts(trace)
            for name, n in launches.items():
                check(counts[name] == n,
                      f"the trace holds {counts[name]} {name} kernel "
                      f"events, the counters {n} launches")
            check(launches["packed_flush"] > 0 and
                  launches["bitonic_sort"] == 0 and
                  launches["chaos_iterate"] == launches["packed_flush"],
                  f"the traced render launched {launches}")
            run.update(trace_mb=os.path.getsize(trace) / 1e6,
                       kernel_events=n_kernels, events=n_events,
                       hand_kernel_events=counts)
            traced = launches
        runs[mode].append(run)
    phase(12, "tools", part="b_trace", genome="full_feature",
          profile="1080p", quality=quality, order="off,on,on,off",
          launches=traced, **runs)
    return traced


def png_rows(png: bytes) -> bytes:
    """The decompressed scanlines of a PNG's IDAT chunks."""
    pos, idat = 8, []
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        if png[pos + 4:pos + 8] == b"IDAT":
            idat.append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b"".join(idat))


def paeth_reference(np, rgba):
    """PNG filter type 4 of every row of an (H, W, 4) u8 frame, in
    numpy."""
    h, w = rgba.shape[:2]
    x = rgba.reshape(h, 4 * w).astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 4:] = x[:, :-4]
    b[1:] = x[:-1]
    c[1:, 4:] = x[:-1, :-4]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, 1 + 4 * w), np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = (x - pred).astype(np.uint8)
    return rows.tobytes()


def ycbcr_reference(np, rgba):
    """fastout's x1024 fixed-point BT.601 full-range YCbCr, in numpy."""
    r, g, b = (rgba[..., i].astype(np.int32) for i in range(3))
    planes = ((306 * r + 601 * g + 117 * b + 512) >> 10,
              ((-173 * r - 339 * g + 512 * b + 512) >> 10) + 128,
              ((512 * r - 429 * g - 83 * b + 512) >> 10) + 128)
    return b"".join(np.clip(p, 0, 255).astype(np.uint8).tobytes()
                    for p in planes)


def host_ms(fn, reps=5):
    """Median host ms of `reps` calls after one warm-up."""
    fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def phase_encoder(frames):
    """The native encoder against the Python one on real frames (phase
    12c): host ms (medians of 5; the native PNG's Paeth filter also
    alone), bytes, the native PNG's scanlines the
    Paeth filter of the frame and the Python PNG's the frame itself (so
    both decode to its pixels), and the native YCbCr equal to the
    fixed-point formula."""
    import numpy as np

    from cuburn_tpu_torch import native, output
    check(output.encoder() == "native",
          "the native output encoder is not in use on this machine")
    for name, img in frames.items():
        rgba = np.ascontiguousarray(img, np.uint8)
        h, w = rgba.shape[:2]
        png_n = output.encode_png_native(rgba)
        png_p = output.encode_png(rgba)
        check(png_rows(png_n) == paeth_reference(np, rgba),
              f"{name}: the native PNG's rows are not the Paeth filter")
        rows_p = np.frombuffer(png_rows(png_p), np.uint8).reshape(h, -1)
        check(bool((rows_p[:, 0] == 0).all())
              and np.array_equal(rows_p[:, 1:], rgba.reshape(h, -1)),
              f"{name}: the Python PNG's rows are not the frame")
        ycc_n = native.rgb_to_ycbcr444(rgba)
        ycc_p = output.ycbcr444(rgba)
        check(ycc_n == ycbcr_reference(np, rgba),
              f"{name}: the native YCbCr is not the fixed-point formula")
        step = np.abs(np.frombuffer(ycc_n, np.uint8).astype(np.int16)
                      - np.frombuffer(ycc_p, np.uint8))
        phase(12, "tools", part="c_encoder", frame=name, shape=[h, w],
              png_native_ms=host_ms(lambda: output.encode_png_native(rgba)),
              png_native_filter_ms=host_ms(lambda: native.paeth_rows(rgba)),
              png_python_ms=host_ms(lambda: output.encode_png(rgba)),
              png_native_bytes=len(png_n), png_python_bytes=len(png_p),
              ycbcr_native_ms=host_ms(lambda: native.rgb_to_ycbcr444(rgba)),
              ycbcr_python_ms=host_ms(lambda: output.ycbcr444(rgba)),
              ycbcr_max_step=int(step.max()),
              ycbcr_share_apart=float((step > 0).mean()))


# -- phase 13: the chaos game (chaos_iterate.cu) ---------------------------

CHAOS_BATCH = 1 << 17
CHAOS_STEPS = 32
# float operations of one full_feature lane-step, a transcendental,
# division, compare or conversion one each (a lower bound: the integer
# RNG and address work left out): the selection over 3 CDF entries, the
# affine, r2 / r / two atan2s, the six variations of the union and
# their sums, the post transform, the colour, the badvalue test, the
# final xform (affine, precalc, bubble, linear, sums, colour), the
# projection and the record
FULL_FEATURE_STEP_OPS = {
    "select": 3, "affine": 8, "precalc": 6, "linear": 2, "spherical": 4,
    "julian": 17, "pdj": 12, "curl": 25, "blur": 10, "sums": 12,
    "post": 8, "color": 4, "badvalue": 6, "final": 29, "project": 15,
    "record": 5}


@contextlib.contextmanager
def eager_loop(it):
    """The Renderer's chunks through the kernel's plain version (the
    eager iterate_step loop of ops/iterate.py, `it`) instead of the
    kernel, in the Python chunk loop (the C loop launches the kernel
    itself)."""
    kernel = it.iterate_records
    it.iterate_records = it.iterate_records_reference
    try:
        with python_loop(it):
            yield
    finally:
        it.iterate_records = kernel


def chaos_chunk(torch, chaos, it, r, seed):
    """(plan, state) for a chunk of Renderer r's still at t = 0: its
    sample's plan and trajectories two chunks in, past the fuse."""
    from cuburn_tpu_torch.params import params_from_genome
    params = params_from_genome(r.genome.eval_at(0.0), r.device)
    state, cdf, ppu, _n, _per_chunk = r._sample_setup(
        params, seed, r.profile.total_iters)
    check(state.x.shape[0] == CHAOS_BATCH,
          f"batch {state.x.shape[0]}, expected {CHAOS_BATCH}")
    cbits, tot_bits = it.record_bits(r.key, r.cam, r.backend, r.op_bits)
    plan = chaos.plan(r.key, r.cam, params, cdf, ppu, r.profile.fuse,
                      cbits, tot_bits, r.op_bits)
    warm = torch.empty((2 * CHAOS_STEPS, CHAOS_BATCH), dtype=torch.int64,
                       device=r.device)
    return plan, it.iterate_records(plan, state, warm)


def device_busy(torch, fn):
    """(fn()'s result, wall ms, device ms by kernel name) of one call
    under torch.profiler; {} when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us:
                by_name[e.key] = us / 1e3
    return out, wall, by_name


def phase_chaos(torch, flush, tiled_sort, Renderer, full_feature,
                get_profile, quality):
    """The chaos game's kernel on the main path's chunk and renders
    (phase 13).  Returns its times, bound and position error."""
    from cuburn_tpu_torch.ops import chaos
    from cuburn_tpu_torch.ops import iterate as it
    from cuburn_tpu_torch.kernels import build
    r = Renderer(full_feature(), get_profile("1080p", quality=quality))
    check(r.backend == "atomic" and
          r.profile.iters_per_chunk == CHAOS_STEPS,
          f"backend {r.backend}, {r.profile.iters_per_chunk} steps a chunk")
    check((chaos.LIBRARY, chaos.key_defines(r.key)) in build._LOADED,
          "chaos: the Renderer did not load its key's library")
    B, K, dev = CHAOS_BATCH, CHAOS_STEPS, r.device
    plan, state = chaos_chunk(torch, chaos, it, r, seed=1)

    # (a) one chunk from the same state: the draws and the selection
    # exact after K steps, step 1's records and positions bounded
    rec_k = torch.empty((K, B), dtype=torch.int64, device=dev)
    rec_p = torch.empty_like(rec_k)
    sk = it.iterate_records(plan, state, rec_k)
    sp = it.iterate_records_reference(plan, state, rec_p)
    torch.cuda.synchronize()
    check(torch.equal(sk.rng, sp.rng), "chaos: RNG words differ after "
          f"{K} steps")
    check(torch.equal(sk.last_xf, sp.last_xf),
          f"chaos: the selected xforms differ after {K} steps")
    agree = (rec_k == rec_p).double().mean(dim=1).tolist()
    live = float(((rec_k[0] >> plan.tot_bits) != r.cam.junk_bin)
                 .double().mean())
    check(agree[0] >= 0.999 and live > 0.5,
          f"chaos: step 1's records agree in {agree[0]} of lanes "
          f"({live} plotted)")
    one_k = torch.empty((1, B), dtype=torch.int64, device=dev)
    one_p = torch.empty_like(one_k)
    s1k = it.iterate_records(plan, state, one_k)
    s1p = it.iterate_records_reference(plan, state, one_p)
    kept = (s1k.age > 0) & (s1p.age > 0)
    err = max(float((a - b)[kept].abs().max())
              for a, b in ((s1k.x, s1p.x), (s1k.y, s1p.y)))
    close = float((torch.isclose(s1k.x, s1p.x, rtol=1e-4, atol=1e-5)
                   & torch.isclose(s1k.y, s1p.y, rtol=1e-4, atol=1e-5))
                  .double().mean())
    check(close >= 0.999 and torch.equal(one_k, rec_k[:1]),
          f"chaos: step 1's positions within rtol 1e-4 in {close} of lanes")

    # the chunk's time: kernel, plain version, bound
    t = medians(torch, {
        "ms": lambda: it.iterate_records(plan, state, rec_k),
        "plain_ms": lambda: it.iterate_records_reference(plan, state,
                                                            rec_p)},
        reps=5)
    # the function's bytes at its own widths: a lane's state (x, y,
    # colour f32; last_xf, age i32; four u32 RNG words) in and out, a
    # 4-byte record a lane-step.  The port's tensors widen the ints and
    # the records to int64: layout_bytes, a reading beside the bound
    state_bytes = B * (3 * 4 + 2 * 4 + 4 * 4)
    nbytes = 2 * state_bytes + K * B * 4
    layout_bytes = 2 * B * (3 * 4 + 2 * 8 + 4 * 8) + K * B * 8
    ops_per_step = sum(FULL_FEATURE_STEP_OPS.values())
    b_ms, b_by = bound(nbytes, ops_per_step * K * B)
    times = {**t, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    # the key's library, built in phase 2 and loaded by the Renderer
    key_lib = chaos.library_path(r.key)
    phase(13, "chaos", part="a_chunk", genome="full_feature",
          library=os.path.relpath(key_lib, REPO),
          ptxas=ptxas_numbers(key_lib),
          share_of_bound=b_ms / t["device_ms"],
          profile="1080p", batch=B, steps=K, rng_exact=True,
          last_xf_exact=True, records_agree_by_step=agree,
          plotted_step_1=live, positions_close_step_1=close,
          max_abs_err_step_1=err, ops_per_lane_step=ops_per_step,
          bound_bytes=nbytes, bound_bytes_ms=bound(nbytes)[0],
          bound_ops_ms=bound(0, ops_per_step * K * B)[0],
          layout_bytes=layout_bytes, layout_bytes_ms=bound(layout_bytes)[0],
          **times)
    del rec_k, rec_p, sk, sp

    # (b) the still through the kernel and the eager loop in turns
    flushes = -(-r.profile.total_iters // (B * K))
    hists, runs = {}, []
    for loop, seed in (("kernel", 1), ("eager", 1), ("eager", 2),
                       ("kernel", 2)):
        reset_launches(flush, tiled_sort)
        with (eager_loop(it) if loop == "eager"
              else contextlib.nullcontext()):
            hists[loop, seed], st = r.accumulate(0.0, seed=seed)
        n = chaos.LAUNCHES["chaos_iterate"]
        check(n == (flushes if loop == "kernel" else 0),
              f"chaos: the {loop} render launched the kernel {n} times, "
              f"{flushes} chunks")
        runs.append({"loop": loop, "seed": seed, "iterate_s": st.iterate_s,
                     "samples_per_s": st.samples_per_sec,
                     "chaos_launches": n})
    floor = tv_distance(hists["eager", 1], hists["eager", 2])
    tv = [tv_distance(hists["kernel", s], hists["eager", s]) for s in (1, 2)]
    check(max(tv) < 3 * floor, f"chaos: q{quality} TV kernel/eager {tv} "
          f"against 3x the floor {floor}")
    del hists
    phase(13, "chaos", part="b_turns", quality=quality, flushes=flushes,
          runs=runs, tv_kernel_vs_eager=tv, tv_eager_two_seed_floor=floor,
          limit=3 * floor)

    # (c) a q1000 still through the kernel, then once under the profiler
    r1k = Renderer(full_feature(), get_profile("1080p", quality=1000))
    reset_launches(flush, tiled_sort)
    hist, st = r1k.accumulate(0.0, seed=3)
    n = launches_now(flush, tiled_sort)
    check(n["chaos_iterate"] == n["packed_flush"] > 0
          and n["bitonic_sort"] == 0,
          f"chaos: the q1000 still launched {n}")
    check(bool(torch.isfinite(hist).all()), "q1000: non-finite histogram")
    mass = float(hist[:-1, 3].double().sum())
    check(abs(mass - st.plotted_samples) <= 1e-4 * mass,
          f"q1000: histogram mass {mass} != plotted {st.plotted_samples}")
    del hist
    (_h, st2), wall, by_name = device_busy(
        torch, lambda: r1k.accumulate(0.0, seed=4))
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    phase(13, "chaos", part="c_q1000", quality=1000,
          launches={k: v for k, v in n.items() if v},
          iterate_s=st.iterate_s, samples_per_s=st.samples_per_sec,
          plotted_samples=st.plotted_samples, total_iters=st.total_iters,
          profiled_wall_ms=wall, profiled_iterate_s=st2.iterate_s,
          device_busy_ms=busy if by_name else "not measured",
          device_busy_share=busy / wall if by_name else "not measured",
          device_ms_by_kernel=top)
    return times, err


# -- phase 14: the bf16 probe (probes/bf16probe.py, bf16_probe.cu) --------

PROBE_REPEATS = 20


def same_bits(torch, a, b):
    """a and b hold the same bits (bf16 as int16, f32 as int32)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view), b.view(view))


def contiguous_schedule(np, seed, n_blocks):
    """(perm, rbg) int32: every block in a shuffled order, 1-4 visits a
    block in one run, rbg's entries shuffled and perm undoing that."""
    rng = np.random.RandomState(seed)
    steps = np.repeat(rng.permutation(n_blocks),
                      rng.randint(1, 5, n_blocks)).astype(np.int32)
    perm = rng.permutation(steps.size).astype(np.int32)
    rbg = np.empty_like(steps)
    rbg[perm] = steps
    return perm, rbg


def probe_schedules(np, bp, n_blocks, shuffled):
    """The probe's schedule (3 visits a block, in order) and `shuffled`
    contiguous ones."""
    v = bp.SKELETON_VISITS
    return {"probe": (np.arange(n_blocks * v, dtype=np.int32),
                      np.repeat(np.arange(n_blocks, dtype=np.int32), v)),
            **{f"shuffled_{s}": contiguous_schedule(np, s, n_blocks)
               for s in range(shuffled)}}


def skeleton_inputs(torch, np, rows, seed):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    return (torch.tensor(rng.rand(1, rows, 128).astype(np.float32),
                         device=dev),
            torch.tensor(rng.rand(3, rows, 128).astype(np.float32))
            .to(torch.bfloat16).to(dev),
            torch.tensor(rng.rand(4, 256, 128).astype(np.float32),
                         device=dev))


def check_skeleton(torch, bp, dens0, rgb0, add, perm, rbg, what, reps=1):
    """The skeleton's kernel bit-equal to its plain version from the same
    state, `reps` times, one launch a call; returns the max abs error
    between them."""
    dr, cr = dens0.clone(), rgb0.clone()
    bp.skeleton_reference(dr, cr, add, perm, rbg)
    for _ in range(reps):
        d, c = dens0.clone(), rgb0.clone()
        before = bp.LAUNCHES["rgb16_skeleton"]
        bp.skeleton(d, c, add, perm, rbg)
        torch.cuda.synchronize()
        check(bp.LAUNCHES["rgb16_skeleton"] == before + 1,
              f"{what}: not one launch")
        check(same_bits(torch, d, dr) and same_bits(torch, c, cr),
              f"{what}: the skeleton kernel differs from its plain version "
              f"(density {float((d - dr).abs().max())}, rgb "
              f"{float((c.float() - cr.float()).abs().max())})")
    return max(float((d - dr).abs().max()),
               float((c.float() - cr.float()).abs().max()))


def check_roundtrip(torch, bp, x, variant, what, reps=1):
    """The roundtrip kernel bit-equal to its plain version and to x,
    `reps` times, one launch a call; returns its max abs error."""
    want = bp.roundtrip_reference(x, variant)
    check(same_bits(torch, want, x), f"{what}: the plain version is not "
          "the identity")
    for _ in range(reps):
        before = bp.LAUNCHES["bf16_roundtrip"]
        got = bp.roundtrip(x, variant)
        torch.cuda.synchronize()
        check(bp.LAUNCHES["bf16_roundtrip"] == before + 1,
              f"{what}: not one launch")
        check(same_bits(torch, got, want),
              f"{what}: the roundtrip kernel differs from its plain version")
    return float((got.float() - x.float()).abs().max())


def roundtrip_times(torch, bp, xq, variant):
    """Medians of the roundtrip kernel, its plain version and the
    identity as one PyTorch call (out.copy_(x)), with the bound."""
    lib_out = torch.empty_like(xq)
    t = medians(torch, {
        "ms": lambda: bp.roundtrip(xq, variant),
        "plain_ms": lambda: bp.roundtrip_reference(xq, variant),
        "library_ms": lambda: lib_out.copy_(xq)})
    nbytes = 2 * xq.numel() * xq.element_size()
    # the bf16 variants convert every element twice
    b_ms, b_by = bound(nbytes, 0 if variant == "f32" else 2 * xq.numel())
    return {"bound_bytes": nbytes, **t, "bound_ms": b_ms, "bound_by": b_by,
            "grid": bp.roundtrip_grid(xq.shape[1],
                                      torch.cuda.get_device_properties(
                                          xq.device).multi_processor_count),
            "share_of_bound": b_ms / t["device_ms"],
            "library_share_of_bound": b_ms / t["library_device_ms"],
            "device_ms_over_library":
                t["device_ms"] / t["library_device_ms"]}


def skeleton_times(torch, bp, dens0, rgb0, add, perm, rbg):
    """Medians of the skeleton kernel and its plain version, in place on
    copies of the state, with the bound; no one PyTorch call computes
    it."""
    d, c = dens0.clone(), rgb0.clone()
    t = medians(torch, {
        "ms": lambda: bp.skeleton(d, c, add, perm, rbg),
        "plain_ms": lambda: bp.skeleton_reference(d, c, add, perm, rbg)})
    check(bool(torch.isfinite(d).all()), "the skeleton: non-finite density")
    # density and rgb read and written once, add and the schedule read
    # once; one float add an element a visit, a conversion each way
    nbytes = 2 * (d.numel() * 4 + c.numel() * 2) + add.numel() * 4 \
        + 2 * perm.size * 4
    b_ms, b_by = bound(nbytes, perm.size * add.numel() + 2 * c.numel())
    return {"visits": int(perm.size), "bound_bytes": nbytes, **t,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_probe(torch, n_bins, kind):
    """The bf16 probe (phase 14): its entry point with its launches
    counted, then (a) the probe's size and (b) the main path's split
    histogram.  Returns (launches, times, errs) by kernel."""
    import numpy as np

    from cuburn_tpu_torch.probes import bf16probe as bp
    dev = torch.device("cuda")

    # the probe's main path, as `python -m ...bf16probe [--skeleton]`
    for k in bp.LAUNCHES:
        bp.LAUNCHES[k] = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rcs = [bp.main([]), bp.main(["--skeleton"])]
    launches = dict(bp.LAUNCHES)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    check(rcs == [0, 0] and all(ln["device"] == kind for ln in lines)
          and all(ln["ok"] for ln in lines[1:]) and len(lines) == 5,
          f"the probe returned {rcs}: {lines}")
    check(launches == {"bf16_roundtrip": 3, "rgb16_skeleton": 1},
          f"the probe launched {launches}")
    phase(14, "probe", part="main", lines=lines, launches=launches)

    # (a) the probe's size
    rows = bp.NB * bp.BR
    x = np.random.RandomState(0).rand(3, rows, 128).astype(np.float32)
    a_err, a_times = {}, {}
    for v, (_code, dtype, _name) in bp.VARIANTS.items():
        xq = torch.from_numpy(x).to(dtype).to(dev)
        a_err[v] = check_roundtrip(torch, bp, xq, v, f"14a {v}")
        check(a_err[v] == 0.0, f"14a {v}: max_err {a_err[v]}")
        a_times[v] = roundtrip_times(torch, bp, xq, v)
    dens0, rgb0, add = skeleton_inputs(torch, np, rows, 1)
    scheds = probe_schedules(np, bp, bp.NB, 2)
    for name, (perm, rbg) in scheds.items():
        check_skeleton(torch, bp, dens0, rgb0, add, perm, rbg,
                       f"14a skeleton {name}")
    a_times["skeleton"] = skeleton_times(torch, bp, dens0, rgb0, add,
                                         *scheds["probe"])
    before = dict(bp.LAUNCHES)
    d = dens0.clone()
    try:
        bp.skeleton(d, rgb0.clone(), add, np.arange(8, dtype=np.int32),
                    np.array([0, 0, 1, 0, 2, 3, 3, 1], np.int32))
        check(False, "14a: a revisiting schedule was not refused")
    except ValueError as e:
        refused = str(e)
    torch.cuda.synchronize()
    check(bp.LAUNCHES == before and torch.equal(d, dens0),
          "14a: the refused schedule launched or wrote")
    phase(14, "probe", part="a_probe_size", rows=rows, max_err=a_err,
          skeleton_schedules={k: rbg[perm].tolist()
                              for k, (perm, rbg) in scheds.items()},
          revisit_refused=refused, times=a_times)

    # (b) the main path's split histogram: (n_bins + 1) bins in rows of
    # 128, padded to whole blocks
    rows = -(-(-(-(n_bins + 1) // 128)) // bp.BR) * bp.BR
    gen = torch.Generator().manual_seed(14)
    times, b_err = {}, {}
    for v, (_code, dtype, _name) in bp.VARIANTS.items():
        xq = torch.rand((3, rows, 128), generator=gen).to(dtype).to(dev)
        b_err[v] = check_roundtrip(torch, bp, xq, v, f"14b {v}",
                                   reps=PROBE_REPEATS)
        check(b_err[v] == 0.0, f"14b {v}: max_err {b_err[v]}")
        times[v] = roundtrip_times(torch, bp, xq, v)
        del xq
    dens0, rgb0, add = skeleton_inputs(torch, np, rows, 2)
    n_blocks = rows // bp.BR
    scheds = probe_schedules(np, bp, n_blocks, 1)
    skel_err = max(check_skeleton(torch, bp, dens0, rgb0, add, perm, rbg,
                                  f"14b skeleton {name}", reps=3)
                   for name, (perm, rbg) in scheds.items())
    times["skeleton"] = skeleton_times(torch, bp, dens0, rgb0, add,
                                       *scheds["probe"])
    phase(14, "probe", part="b_split_hist", rows=rows, bins=n_bins + 1,
          blocks=n_blocks, repeats=PROBE_REPEATS, max_err=b_err,
          shuffled_visits=int(scheds["shuffled_0"][0].size), times=times)
    del dens0, rgb0, add
    torch.cuda.empty_cache()
    return (launches,
            {"bf16_roundtrip": times["multi"],
             "rgb16_skeleton": times["skeleton"]},
            {"bf16_roundtrip": max(b_err.values()),
             "rgb16_skeleton": skel_err})


# -- phase 15: the bench tools (cuburn_tpu_torch/bench/) -------------------

# BASELINE.md's five configurations at their binding sizes: genome, size,
# ss, quality, temporal samples
BENCH_CONFIGS = {1: ("sierpinski", "512x512", 1, 4, 1),
                 2: ("classic_swirl", "1280x720", 1, 500, 1),
                 3: ("full_feature", "1920x1080", 1, 1000, 1),
                 4: ("classic_swirl", "1920x1080", 2, 2000, 1),
                 5: ("animated_spark", "1280x720", 1, 200, 4)}
# the bench tools phase 15 runs in this process, at their defaults
BENCH_TOOLS = ("parity", "tileddiff", "sortbench", "breakdown")


def bench_subprocess(module, timeout):
    """The JSON lines of `python -m <module>` run from the checkout;
    every line of its standard output is one, and it exits 0."""
    out = subprocess.run([sys.executable, "-m", module], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0,
          f"{module} exited {out.returncode}: {out.stderr[-3000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines()]


def bench_tool(flush, tiled_sort, name):
    """One bench tool's entry point in this process, as `python -m
    cuburn_tpu_torch.bench.<name>` runs it: (its JSON lines, the
    launches it made).  It exits 0 and launches none of the probe's
    kernels."""
    import importlib
    main = importlib.import_module(f"cuburn_tpu_torch.bench.{name}").main
    reset_launches(flush, tiled_sort)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    launches = launches_now(flush, tiled_sort)
    for ln in lines:
        phase(15, "bench", tool=name, line=ln)
    check(rc == 0, f"bench.{name} exited {rc}")
    check(not any(launches[k] for k in PROBE_KERNELS),
          f"bench.{name} launched the probe's kernels: {launches}")
    return lines, launches


def phase_bench(torch, flush, tiled_sort, kind):
    """The system's benchmark and validation tools (phase 15).
    Returns every kernel's launches over the headline's timed runs and
    the four tools run in this process."""
    from cuburn_tpu_torch.bench.headline import KEYS_1080P, sizes
    torch.cuda.empty_cache()
    total = dict.fromkeys(KERNELS, 0)

    # (a) the headline, as `python -m cuburn_tpu_torch.bench` runs it
    t0 = time.perf_counter()
    lines = bench_subprocess("cuburn_tpu_torch.bench", 600)
    check(len(lines) == 1, f"the headline printed {len(lines)} lines")
    head = lines[0]
    ex = head["extra"]
    phase(15, "bench", tool="headline", seconds=round(
        time.perf_counter() - t0, 3), line=head)
    check(head["metric"] == "ifs_samples_per_sec_per_chip"
          and head["value"] > 0 and ex["device"].startswith(kind),
          f"the headline's line: {head}")
    check(ex["mass_parity"] == 1.0 and ex["max_bin_err_density"] == 0.0,
          f"the headline's differential: {ex['mass_parity']}, "
          f"{ex['max_bin_err_density']}")
    check(all(ex[k] is not None for k in KEYS_1080P)
          and ex["backend_1080p"] == "atomic",
          f"the headline's 1080p run: {[ex[k] for k in KEYS_1080P]}")
    n, batch = ex["chunks"], sizes(False)[1]
    passes = len(tiled_sort.bitonic_schedule(batch * ex["iters_per_chunk"]))
    want = {"pallas_win": {"chaos_iterate": n, "win_flush": n,
                           "bitonic_sort": n * passes},
            "scatter": {"chaos_iterate": n}}
    check(ex["launches"] == want,
          f"the headline's launches {ex['launches']}, expected {want}")
    for got in ex["launches"].values():
        for k, v in got.items():
            total[k] += v

    # (b) the five configurations at their binding sizes
    t0 = time.perf_counter()
    lines = bench_subprocess("cuburn_tpu_torch.bench.configs", 900)
    recs = {ln["config"]: ln for ln in lines if "samples_per_sec" in ln}
    for ln in lines:
        phase(15, "bench", tool="configs", line=ln)
    got = {i: (r["genome"], r["size"], r["ss"], r["quality"],
               r["temporal_samples"]) for i, r in recs.items()}
    check(got == BENCH_CONFIGS and len(lines) == 6
          and lines[-1]["failed"] == [],
          f"configs: {got} against {BENCH_CONFIGS}; {lines[-1]}")
    check(all(r["plotted_samples"] > 0 and r["backend"] == "atomic"
              for r in recs.values()), f"configs: {recs}")
    phase(15, "bench", tool="configs",
          seconds=round(time.perf_counter() - t0, 3))

    # (c) the tools in this process
    lines = {}
    for name in BENCH_TOOLS:
        lines[name], launches = bench_tool(flush, tiled_sort, name)
        for k in total:
            total[k] += launches[k]
    verdict = lines["parity"][-1]["card_cpu_parity"]
    check(verdict["ok"], f"parity: {verdict}")
    head, *_backends, out = lines["tileddiff"]
    check(head["tiled"] and head["n_bins"] == 3896 * 2216 and out["ok"]
          and out["max_bin_err_density"] == 0.0, f"tileddiff: {head} {out}")
    rows = [ln for ln in lines["sortbench"] if "ok" in ln]
    check(len(rows) == 11 and all(r["ok"] for r in rows)
          and lines["sortbench"][-1] == {"sortbench_ok": True},
          f"sortbench: {rows}")
    check([ln.get("row") for ln in lines["breakdown"][1:]]
          == ["iterate (discard)", "iterate + pack", "full (scatter)",
              "full (pallas_win)"], f"breakdown: {lines['breakdown']}")
    torch.cuda.empty_cache()
    return total


def build_jobs(chaos, get_genome):
    """{label: (library, -D definitions)} of every library the script
    launches: each csrc/*.cu of KERNELS, the chaos game's once for the
    structure key of each of CHAOS_GENOMES ("chaos_iterate[name]")."""
    jobs = {lib: (lib, ()) for lib, _ in KERNELS.values()
            if lib != chaos.LIBRARY}
    for name in CHAOS_GENOMES:
        key = get_genome(name).structure_key()
        jobs[f"{chaos.LIBRARY}[{name}]"] = (chaos.LIBRARY,
                                            chaos.key_defines(key))
    return jobs


def build_all(build, jobs):
    """Every library of `jobs`, one nvcc each, all started together, then
    loaded: {label: (path, build seconds)}."""
    def timed_build(label):
        t0 = time.perf_counter()
        path = build.build(*jobs[label])
        return path, time.perf_counter() - t0
    labels = sorted(jobs)
    with concurrent.futures.ThreadPoolExecutor(len(labels)) as pool:
        built = dict(zip(labels, pool.map(timed_build, labels)))
    for label in labels:
        build.load(*jobs[label])
    return built


def ptxas_lines(path):
    """The registers and spills that ptxas reported for a library built
    with -Xptxas -v (its .log), else []."""
    log = path.with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "Compiling entry" in ln or "registers" in ln
            or "spill" in ln]


def ptxas_numbers(path):
    """{registers, stack_frame, spill_stores, spill_loads} (bytes but the
    first) of the one kernel of a library built with -Xptxas -v."""
    text = "\n".join(ptxas_lines(path))
    regs = re.search(r"Used (\d+) registers", text)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", text)
    check(regs and frame, f"{path}: no ptxas report")
    return {"registers": int(regs[1]), "stack_frame": int(frame[1]),
            "spill_stores": int(frame[2]), "spill_loads": int(frame[3])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quality", type=int, default=100,
                    help="samples per output pixel of the 1080p renders")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # before any Renderer is built (the ranks of phase 11 inherit it)
    check(not os.path.exists(NO_TUNE_RECORD), f"{NO_TUNE_RECORD} exists")
    os.environ["CUBURN_TUNE_FILE"] = NO_TUNE_RECORD
    from cuburn_tpu_torch.kernels import build
    from cuburn_tpu_torch.models import (animated_spark, full_feature,
                                         sierpinski)
    from cuburn_tpu_torch.models.gallery import get_genome
    from cuburn_tpu_torch.ops import chaos
    from cuburn_tpu_torch.ops import flush, sort, tiled_sort
    from cuburn_tpu_torch.ops import histogram as thist
    from cuburn_tpu_torch.ops import iterate as tit
    from cuburn_tpu_torch.output import write_image
    from cuburn_tpu_torch.profile import RenderProfile, get_profile
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
    libs = build_all(build, build_jobs(chaos, get_genome))
    phase(2, "build", seconds=round(time.perf_counter() - t0, 3),
          libraries={k: os.path.relpath(v, REPO)
                     for k, (v, _s) in libs.items()},
          library_seconds={k: round(s, 3) for k, (_v, s) in libs.items()},
          ptxas={k: ptxas_lines(v) for k, (v, _s) in libs.items()
                 if ptxas_lines(v)})

    main_r = Renderer(full_feature(),
                      get_profile("1080p", quality=args.quality))
    n_bins, acc_width = main_r.cam.n_bins, main_r.cam.acc_width
    times, errs, launches = {}, {}, {}
    times["win_flush"], errs["win_flush"] = phase_flush(
        torch, flush, sort, thist, "win_flush", n_bins, acc_width, 3)
    main_launches, real_flushes, main_frame = phase_render(
        torch, flush, tiled_sort, tit, write_image, main_r, args.quality)
    launches.update(main_launches)
    phase_flush_mix(torch, flush, sort, thist, real_flushes, n_bins,
                    acc_width,
                    tit.record_bits(main_r.key, main_r.cam, main_r.backend,
                                    main_r.op_bits)[1])
    del real_flushes
    phase_default_flush(torch, flush, tit, thist, Renderer, get_profile,
                        RenderProfile, full_feature, animated_spark)
    for genome in (sierpinski, full_feature):
        phase_parity(torch, Renderer, RenderProfile, genome())

    for name in ("packed_flush", "merged_flush"):
        times[name], errs[name] = phase_flush(
            torch, flush, sort, thist, name, n_bins, acc_width, 6)
    times["win_flush_rgb16"], errs["win_flush_rgb16"] = phase_rgb16(
        torch, flush, n_bins, acc_width)
    times["bitonic_sort"], errs["bitonic_sort"] = phase_sort(
        torch, tiled_sort)
    del main_r
    half = max(args.quality // 2, 1)
    # a still's launches: packed_flush through auto's backend (phase 4),
    # every other flush kernel through its own, the sort through
    # pallas_win's
    for backend in STILL_BACKENDS:
        got = phase_render_backend(
            torch, flush, tiled_sort, tit, Renderer, full_feature(),
            get_profile, backend, half)
        if backend != "pallas":
            launches[FLUSH_KERNEL[backend]] = got[FLUSH_KERNEL[backend]]
        if backend == "pallas_win":
            launches["bitonic_sort"] = got["bitonic_sort"]
    for backend in ("pallas", "pallas_merged", "pallas_rgb16", "atomic",
                    "scatter", "scatter_sorted", "sortcum"):
        phase_parity(torch, Renderer, RenderProfile, full_feature(),
                     backend, phase_no=8)
    phase_parity(torch, Renderer, RenderProfile, spark(animated_spark),
                 phase_no=8, t=0.5, temporal_samples=ANIM_SAMPLES, fps=4.0)
    anim_launches, anim_frame = phase_animation(
        torch, flush, tiled_sort, tit, write_image, Renderer,
        animated_spark, get_profile, half)
    part_launches = phase_partition(
        torch, flush, sort, tiled_sort, thist, tit, write_image, Renderer,
        full_feature, animated_spark, get_profile, args.quality)
    sharded_launches = phase_sharded(torch, write_image, Renderer,
                                     animated_spark, get_profile,
                                     args.quality)
    phase_tuner(torch, flush, tiled_sort, Renderer, full_feature,
                get_profile)
    traced_launches = phase_trace(torch, flush, tiled_sort)
    phase_encoder({"still": main_frame, "animation": anim_frame})
    times["chaos_iterate"], errs["chaos_iterate"] = phase_chaos(
        torch, flush, tiled_sort, Renderer, full_feature, get_profile,
        args.quality)
    for got, of_probe in zip((launches, times, errs),
                             phase_probe(torch, n_bins, kind)):
        got.update(of_probe)
    bench_launches = phase_bench(torch, flush, tiled_sort, kind)

    check((chaos.LIBRARY, ()) not in build._LOADED,
          "the generic chaos library (no chaos game) was loaded")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
        "replaces": replaces, "launches": launches[name],
        "launches_animation": anim_launches[name],
        "launches_partitioned": part_launches[name],
        "launches_sharded": sharded_launches[name],
        "launches_traced": traced_launches[name],
        "launches_bench": bench_launches[name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "device_ms": times[name]["device_ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": times[name]["library_ms"]}
        for name, (lib, replaces) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
