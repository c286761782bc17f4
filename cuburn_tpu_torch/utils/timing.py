"""Device synchronisation and a chained timing harness for honest
host-clock timings.

Counterpart of `cuburn_tpu/utils/timing.py`.  PyTorch launches CUDA
work asynchronously, so a host clock read after a launch measures only
the enqueue; `sync` waits for the device first, and `time_fn` times a
call between two syncs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Tuple

import torch


def sync(device: torch.device | str) -> None:
    """Wait until every kernel queued on `device` has finished: a
    `torch.cuda.synchronize()` on CUDA, nothing on the CPU (which
    executes eagerly)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _devices(x) -> set:
    """The devices of every tensor in `x`: a tensor, or tuples, lists
    and dataclasses of them."""
    if isinstance(x, torch.Tensor):
        return {x.device}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return set().union(*(_devices(v) for v in x))
    return set()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            chain: Callable = None) -> Tuple[float, object]:
    """Time fn(*args): `warmup` untimed calls, then `iters` timed ones
    between two syncs of the devices of the output's tensors (of the
    arguments' where no call has returned yet).

    If `chain` is given, it maps (prev_output, args) -> next args so
    successive calls are data-dependent: each call starts from the
    state the previous one left.  `warmup=0` times the very first call.
    Returns (seconds_per_call, last_output)."""
    out = None
    for _ in range(warmup):
        if chain is not None and out is not None:
            args = chain(out, args)
        out = fn(*args)
    for device in _devices(args if out is None else out):
        sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        # `out is not None` guard: with warmup=0 the first timed call
        # has no previous output to chain from
        if chain is not None and out is not None:
            args = chain(out, args)
        out = fn(*args)
    for device in _devices(out):
        sync(device)
    return (time.perf_counter() - t0) / iters, out
