"""python -m flamebench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds 3,4,...]

The readings that a cell's limits are set from, on the card, at the
cell's own sizes: for each seed, the frames a run of that seed checks
first (frames 0 .. n-1 of its window, n the cell's checks file's
`frames`) rendered through the cell's driver, once by the program as
the configuration states it and, for the control seeds, once by the
program with its bfloat16-rgb histogram (`pallas_rgb16`, the precision
step below the configuration's float32), each held to the reference's
frame.  One JSON line a seed and side, then the largest reading of the
program's seeds and the smallest of the control's for each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()

CONTROL_BACKEND = "pallas_rgb16"


def frames_of(renderer, cell, base: int, n: int):
    """(k, time, seed, image) of frames 0 .. n-1 of a window
    whose seed base is `base`, through the cell's driver."""
    from flamebench import harness
    sample = harness.Sample(n, base)
    if cell.traffic["driver"] == "stills":
        t = float(cell.traffic.get("time", 0.0))
        for k in range(n):
            img, _st = renderer.render_frame(t, seed=base + k)
            sample.offer((k, t, base + k, img))
        return sample.kept
    frames = renderer.frames_overlapped(seed=base)
    try:
        for k, (_i, t) in enumerate(renderer.frame_times()[:n]):
            img, _st = next(frames)
            sample.offer((k, t, base + k, img))
    finally:
        frames.close()
    return sample.kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flamebench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from flamebench import compare, harness, spec
    from flamebench.reference.render import Frames
    cell = spec.cell(args.workload)
    harness.pin_environment()
    from cuburn_tpu_torch import models
    from cuburn_tpu_torch.render import Renderer
    genome = getattr(models, cell.config["genome"])
    sides = {"program": Renderer(genome(), harness.profile_for(cell),
                                 device="cuda")}
    seeds = {"program": [int(s) for s in args.seeds.split(",") if s]}
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if control:
        sides["control"] = Renderer(
            genome(), harness.profile_for(cell, CONTROL_BACKEND),
            device="cuda")
        seeds["control"] = control
    for r in sides.values():
        harness.warm_up(r, cell, seed=1 << 41)
    steps = sides["program"].profile.iters_per_chunk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Frames(cell.config["genome"], harness.settings_for(cell, steps),
                 "cuda")
    n = cell.check["frames"]
    worst = {}
    refs = {}
    for side, r in sides.items():
        for seed in seeds[side]:
            kept = frames_of(r, cell, harness.base_seed(seed), n)
            gaps = []
            for _k, t, fseed, img in kept:
                if (t, fseed) not in refs:
                    refs[t, fseed] = ref.render(t, fseed)
                gaps.append(compare.frame_gaps(img, refs[t, fseed].image))
            reading = compare.worst(gaps)
            print(json.dumps({"workload": cell.name, "side": side,
                              "backend": r.backend, "seed": seed,
                              **reading,
                              "ref_plotted": [refs[t, s].plotted
                                              for _k, t, s, _i in kept],
                              "ref_touched_bins": [
                                  refs[t, s].touched_bins
                                  for _k, t, s, _i in kept]}),
                  flush=True)
            agg = max if side == "program" else min
            worst[side] = {k: agg(worst[side][k], reading[k])
                           if side in worst else reading[k]
                           for k in compare.NAMES}
    print(json.dumps({"workload": cell.name,
                      "program_largest": worst.get("program"),
                      "control_smallest": worst.get("control"),
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
