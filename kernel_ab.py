#!/usr/bin/env python3
"""Time the tiled sort, the flushes, the chaos game and the bf16 round
trip of two checkouts of the port on one NVIDIA GPU, in turns.

    python3 kernel_ab.py OLD_DIR NEW_DIR [--rounds R]

OLD_DIR and NEW_DIR are checkouts of this repository (say the parent
commit unpacked with `git archive`, and this tree).  Each checkout runs
in a process of its own, since both packages are `cuburn_tpu_torch`, in
the order OLD, NEW, NEW, OLD (R times).  Every process builds its own
checkout's kernels and times its own wrappers with `medians` of the
`chip_smoke.py` next to this script: the host clock around a
synchronised call (`*_ms`) and CUDA events around the same call with the
stream held back (`*_device_ms`), medians of 10 calls.  On the inputs of
chip_smoke.py's phases 3 and 6 (2^22 records of the synthetic mix into
the 8,633,536-bin 1080p-ss2 histogram, 8 colour bits; random u32 keys
with sign-bit and sentinel values) it times:

  sort_22, sort_23      bitonic_sort_u32_tiled of 2^22 and 2^23 keys,
                        checked equal to torch.sort
  torch_sort_22         torch.sort of the same 2^22 keys
  win_flush_c3, _c4     the win_flush kernel alone on records sorted by
                        torch.sort, 3-column palette at weight 1.0 and
                        4-column at 0.37; density checked bit-exact
                        against the plain version at weight 1.0
  path_c3, _c4          accumulate_windowed: the checkout's own sort,
                        then win_flush (the pallas_win kernel path)
  packed_c3, _c4        accumulate_packed (backend pallas, no sort)
  merged_c3, _c4        accumulate_merged (the pallas_merged kernel
                        path: the sort, then whatever the checkout runs
                        up to and including its merged_flush kernel)
  merged_kernel_c3,     the merged_flush kernel alone: on sorted records
  _c4                   where the checkout's kernel merges the runs
                        itself, else on the unique records and counts
                        its torch merge made beforehand
  rgb16_c3, _c4         accumulate_windowed_rgb16 (the pallas_rgb16
                        kernel path: the sort, then the split flush's
                        kernels)
  rgb16_kernel_c3, _c4  the split flush's kernels alone on sorted
                        records, with whatever scratch the checkout's
                        kernels need made ready as a flush must (a
                        checkout whose scratch has to be zero zeroes it
                        inside the timed call)

and, on the records of the first two flushes of the checkout's own
full_feature 1080p render (the first holds the fuse steps, 97% junk; the
second is what every later flush looks like), 3-column palette at
weight 1.0: packed_first, packed_real, merged_first, merged_real,
merged_kernel_first, merged_kernel_real, rgb16_first, rgb16_real,
rgb16_kernel_first, rgb16_kernel_real.  Every packed, merged and split
flush is checked against its plain version first: density bit-exact at
weight 1.0, channels within 1e-5 of the bin's density, the split
flush's rgb within one bf16 ulp.  Then:

  chaos_chunk           one chaos_iterate launch of the checkout's own
                        kernel: a chunk of full_feature at 1080p (2^17
                        lanes x 32 steps) from trajectories two chunks
                        past the fuse (chip_smoke.chaos_chunk, seed 1),
                        checked bit-exact to its eager loop (RNG words,
                        selected xforms, positions and every record)
  roundtrip_bf16,       probes/bf16probe.roundtrip, "multi",
  roundtrip_per_plane,  "per_plane" and "f32", at the 1080p-ss2 split
  roundtrip_f32         histogram's 67,584 rows (chip_smoke phase 14b),
                        checked bit-equal to the input
  copy_bf16, copy_f32   out.copy_(x) of the same arrays, the identity
                        as one PyTorch call

Prints one JSON line per process, then the card's nvidia-smi line and a
last JSON line with, for each timing, the values of OLD's and NEW's
processes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the 1080p-ss2 accumulator of chip_smoke.py's full_feature render:
# 3896 x 2216 bins (a 28-pixel gutter)
ACC_WIDTH, ACC_HEIGHT = 3896, 2216


def _chip_smoke():
    """chip_smoke.py beside this script, whichever checkout is timed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_flushes(torch):
    """The records of the first two flushes of the imported checkout's
    full_feature 1080p render (two flushes' worth of quality)."""
    from cuburn_tpu_torch.models import full_feature
    from cuburn_tpu_torch.ops import iterate as tit
    from cuburn_tpu_torch.profile import get_profile
    from cuburn_tpu_torch.render import Renderer
    r = Renderer(full_feature(), get_profile("1080p", quality=32,
                                             hist_backend="pallas_win"))
    flushes, win = [], tit.PACKED_FLUSHES["pallas_win"]

    def keep(hist, recs, *args):
        flushes.append(recs.reshape(-1).clone())
        return win(hist, recs, *args)
    tit.PACKED_FLUSHES["pallas_win"] = keep
    try:
        r.accumulate(0.0, seed=2)
    finally:
        tit.PACKED_FLUSHES["pallas_win"] = win
    bits = tit.record_bits(r.key, r.cam, "pallas_win", r.op_bits)[1]
    return flushes[:2], r.cam.n_bins, bits


def merged_kernel_alone(torch, flush, rec, pal4, hist, n_bins, bits, weight):
    """A call of the checkout's merged_flush kernel alone on `rec`."""
    dev = hist.device
    if len(flush._ENTRIES["merged_flush"][2]) == 8:
        # the kernel takes unique records and counts, merged beforehand
        uniq, counts = flush.merge_records(rec, n_bins, bits)
        return lambda: flush._launch(
            "merged_flush", dev, uniq.data_ptr(), counts.data_ptr(),
            uniq.numel(), pal4.data_ptr(), bits, n_bins, weight,
            hist.data_ptr())
    srt = flush.sort_records_reference(rec)
    return lambda: flush._launch(
        "merged_flush", dev, srt.data_ptr(), srt.numel(), pal4.data_ptr(),
        bits, n_bins, weight, hist.data_ptr())


def rgb16_kernel_alone(torch, flush, rec, pal4, split, n_bins, bits,
                       weight):
    """A call of the checkout's split-flush kernels alone on `rec`,
    sorted here."""
    srt = flush._aligned(torch.sort(rec.reshape(-1)).values)
    if hasattr(flush, "rgb16_scratch"):
        scratch = flush.rgb16_scratch(srt.numel(), srt.device)
        return lambda: flush.rgb16_launch(srt, pal4, bits, n_bins, weight,
                                          split[0], split[1], scratch)
    # a carry row per RGB16_RUN records, zero before every flush
    carry = torch.zeros((-(-srt.numel() // flush.RGB16_RUN), 4),
                        device=srt.device)

    def zero_and_launch():
        carry.zero_()
        flush.rgb16_launch(srt, pal4, bits, n_bins, weight, split[0],
                           split[1], carry)
    return zero_and_launch


def rgb16_timings(torch, cs, flush, tree, tag, rec, pal, n_bins, bits,
                  weight):
    """{name: call} for the split flush's kernel path and its kernels
    alone on one set of records, the path checked against its plain
    version first."""
    dev = rec.device
    got = flush.accumulate_windowed_rgb16(
        flush.alloc_split(n_bins, dev), rec, pal, n_bins, bits, weight)
    ref = flush.accumulate_windowed_rgb16_reference(
        flush.alloc_split(n_bins, dev), rec, pal, n_bins, bits, weight)
    torch.cuda.synchronize()
    if pal.shape[1] == 3 and weight == 1.0:
        cs.check(torch.equal(got[0], ref[0]),
                 f"{tree}: rgb16 density not bit-exact ({tag})")
    d_err = (got[0][:n_bins] - ref[0][:n_bins]).abs()
    cs.check(bool((d_err <= 1e-5 * ref[0][:n_bins].clamp(min=1.0)).all()),
             f"{tree}: rgb16 density disagrees ({tag}): "
             f"{float(d_err.max())}")
    rr = ref[1][:n_bins].float()
    ulp = torch.finfo(torch.bfloat16).eps * rr.abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    rgb_err = (got[1][:n_bins].float() - rr).abs()
    cs.check(bool((rgb_err <= ulp).all()),
             f"{tree}: rgb16 rgb off by more than one bf16 ulp ({tag}): "
             f"{float(rgb_err.max())}")
    split = flush.alloc_split(n_bins, dev)
    pal4 = flush._pal4(pal).contiguous().clone()
    return {
        f"rgb16_{tag}_ms": lambda: flush.accumulate_windowed_rgb16(
            split, rec, pal, n_bins, bits, weight),
        f"rgb16_kernel_{tag}_ms": rgb16_kernel_alone(
            torch, flush, rec, pal4, split, n_bins, bits, weight)}


def scatter_timings(torch, cs, flush, thist, tree, tag, rec, pal, n_bins,
                    bits, weight):
    """{name: call} for the packed and merged flushes on one set of
    records, each checked against its plain version first."""
    dev = rec.device
    pal4 = flush._pal4(pal).contiguous().clone()
    hist = thist.alloc(n_bins, dev)
    fns = {}
    for name, kernel, plain in (
            ("packed", flush.accumulate_packed,
             flush.accumulate_packed_reference),
            ("merged", flush.accumulate_merged,
             flush.accumulate_merged_reference)):
        got = kernel(thist.alloc(n_bins, dev), rec, pal, n_bins, bits,
                     weight)
        ref = plain(thist.alloc(n_bins, dev), rec, pal, n_bins, bits,
                    weight)
        torch.cuda.synchronize()
        if pal.shape[1] == 3 and weight == 1.0:
            cs.check(torch.equal(got[:, 3], ref[:, 3]),
                     f"{tree}: {name} density not bit-exact ({tag})")
        err = (got[:n_bins] - ref[:n_bins]).abs()
        cs.check(bool((err <= 1e-5 * ref[:n_bins, 3:].clamp(min=1.0)).all()),
                 f"{tree}: {name} disagrees ({tag}): {float(err.max())}")
        fns[f"{name}_{tag}_ms"] = (
            lambda kernel=kernel: kernel(hist, rec, pal, n_bins, bits,
                                         weight))
    fns[f"merged_kernel_{tag}_ms"] = merged_kernel_alone(
        torch, flush, rec, pal4, hist, n_bins, bits, weight)
    return fns


def worker(tree: str) -> dict:
    """Time one checkout's kernels in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import cuburn_tpu_torch
    from cuburn_tpu_torch.ops import flush, tiled_sort
    from cuburn_tpu_torch.ops import histogram as thist
    cs = _chip_smoke()
    cs.check(torch.cuda.is_available(), "no CUDA device")
    package = os.path.dirname(os.path.abspath(cuburn_tpu_torch.__file__))
    cs.check(package == os.path.join(tree, "cuburn_tpu_torch"),
             f"imported {package}, not the checkout {tree}")
    dev = torch.device("cuda")
    n_bins = ACC_WIDTH * ACC_HEIGHT

    gen = torch.Generator().manual_seed(7)
    keys = {}
    for log_n in (22, 23):
        k = torch.randint(0, 1 << 32, (1 << log_n,), generator=gen)
        k[:1000] = cs.SENTINEL
        k[1000:2000] = 1 << 31
        keys[log_n] = k.to(dev)
        cs.check(torch.equal(tiled_sort.bitonic_sort_u32_tiled(keys[log_n]),
                             torch.sort(keys[log_n]).values),
                 f"{tree}: the sort of 2^{log_n} keys differs from "
                 "torch.sort")
    fns = {"sort_22_ms": lambda: tiled_sort.bitonic_sort_u32_tiled(keys[22]),
           "sort_23_ms": lambda: tiled_sort.bitonic_sort_u32_tiled(keys[23]),
           "torch_sort_22_ms": lambda: torch.sort(keys[22])}

    gen = torch.Generator().manual_seed(3)
    for cols, bits, weight in cs.FLUSH_CONFIGS:
        rec, pal = cs.flush_inputs(torch, 1 << 22, n_bins, ACC_WIDTH, cols,
                                   bits, gen)
        srt = torch.sort(rec).values
        pal4 = flush._pal4(pal).contiguous().clone()
        hist = thist.alloc(n_bins, dev)

        def alone(srt=srt, pal4=pal4, hist=hist, bits=bits, weight=weight):
            flush._launch("win_flush", dev, srt.data_ptr(), srt.numel(),
                          pal4.data_ptr(), bits, n_bins, weight,
                          hist.data_ptr())
        alone()
        ref = flush.accumulate_windowed_reference(
            thist.alloc(n_bins, dev), rec, pal, n_bins, bits, weight)
        torch.cuda.synchronize()
        if cols == 3:
            cs.check(torch.equal(hist[:, 3], ref[:, 3]),
                     f"{tree}: win_flush density not bit-exact")
        fns[f"win_flush_c{cols}_ms"] = alone
        fns[f"path_c{cols}_ms"] = (
            lambda hist=hist, rec=rec, pal=pal, bits=bits, weight=weight:
            flush.accumulate_windowed(hist, rec, pal, n_bins, bits, weight))
        fns.update(scatter_timings(torch, cs, flush, thist, tree,
                                   f"c{cols}", rec, pal, n_bins, bits,
                                   weight))
        fns.update(rgb16_timings(torch, cs, flush, tree, f"c{cols}", rec,
                                 pal, n_bins, bits, weight))
    flushes, r_bins, r_bits = render_flushes(torch)
    cs.check(r_bins == n_bins, f"the render has {r_bins} bins")
    pal = torch.rand((1 << r_bits, 3), generator=gen).to(dev)
    for tag, rec in zip(("first", "real"), flushes):
        fns.update(scatter_timings(torch, cs, flush, thist, tree, tag, rec,
                                   pal, n_bins, r_bits, 1.0))
        fns.update(rgb16_timings(torch, cs, flush, tree, tag, rec, pal,
                                 n_bins, r_bits, 1.0))
    fns.update(chaos_and_probe(torch, cs, tree, gen))
    return {"tree": tree, **cs.medians(torch, fns)}


def chaos_and_probe(torch, cs, tree, gen):
    """The chaos_chunk, roundtrip_* and copy_* calls of the imported
    checkout, each checked first."""
    from cuburn_tpu_torch.models import full_feature
    from cuburn_tpu_torch.ops import chaos
    from cuburn_tpu_torch.ops import iterate as tit
    from cuburn_tpu_torch.probes import bf16probe as bp
    from cuburn_tpu_torch.profile import get_profile
    from cuburn_tpu_torch.render import Renderer
    dev = torch.device("cuda")
    r = Renderer(full_feature(), get_profile("1080p", quality=100))
    plan, state = cs.chaos_chunk(torch, chaos, tit, r, seed=1)
    rec = torch.empty((cs.CHAOS_STEPS, cs.CHAOS_BATCH), dtype=torch.int64,
                      device=dev)
    ref = torch.empty_like(rec)
    got = tit.iterate_records(plan, state, rec)
    want = tit.iterate_records_reference(plan, state, ref)
    cs.check(torch.equal(rec, ref) and all(
        torch.equal(getattr(got, f), getattr(want, f))
        for f in ("x", "y", "color", "last_xf", "age", "rng")),
        f"{tree}: the chaos chunk is not bit-exact to its eager loop")
    fns = {"chaos_chunk_ms": lambda: tit.iterate_records(plan, state, rec)}
    rows = -(-(-(-(ACC_WIDTH * ACC_HEIGHT + 1) // 128)) // bp.BR) * bp.BR
    for variant, tag in (("multi", "bf16"), ("per_plane", "per_plane"),
                         ("f32", "f32")):
        x = torch.rand((3, rows, 128), generator=gen).to(
            bp.VARIANTS[variant][1]).to(dev)
        cs.check(cs.same_bits(torch, bp.roundtrip(x, variant), x),
                 f"{tree}: the {variant} round trip is not the identity")
        fns[f"roundtrip_{tag}_ms"] = \
            lambda x=x, variant=variant: bp.roundtrip(x, variant)
        if variant != "per_plane":
            out = torch.empty_like(x)
            fns[f"copy_{tag}_ms"] = lambda x=x, out=out: out.copy_(x)
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="checkout timed first and last")
    ap.add_argument("new", nargs="?", help="checkout timed in between")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeats of the order OLD, NEW, NEW, OLD")
    ap.add_argument("--worker", action="store_true",
                    help="time OLD alone in this process (used internally)")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.old)), flush=True)
        return 0
    if args.new is None:
        ap.error("give two checkouts")
    old, new = os.path.abspath(args.old), os.path.abspath(args.new)
    runs = {old: [], new: []}
    for _ in range(args.rounds):
        for tree in (old, new, new, old):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 tree], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[tree].append(json.loads(line))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    keys = [k for k in runs[old][0] if k != "tree"]
    print(json.dumps({k: {"old": [r[k] for r in runs[old]],
                          "new": [r[k] for r in runs[new]]}
                      for k in keys}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
