"""python -m flamebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json on the CUDA cards of this
machine.  The last line of standard output is the result (JSON); the
numbers compared against the reference, each beside its limit, are the
last lines of standard error.  Without the cards the cell asks for it
exits 2 and prints no result; with JAX or the JAX package loaded once
its window has closed it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flamebench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from flamebench import harness, spec
    cell = spec.cell(args.workload)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"flamebench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), this machine has {have}; no result",
              file=sys.stderr)
        return 2

    def log(line):
        print(f"flamebench: {line}", file=sys.stderr, flush=True)

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"flamebench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
