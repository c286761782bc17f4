"""One process a device: the ranks that render a frame together.

The JAX package drives every chip of a mesh from one controller
(`shard_map`, `cuburn_tpu/parallel/shard.py::make_mesh`).  The port's
frame time is host launches, so one Python thread driving n cards would
be n times as launch-bound: each device gets a process of its own, a
rank of `torch.distributed`, and every rank makes the same calls in
lockstep.

`spawn(fn, devices, backend, *args)` runs `fn(rank, device, *args)`
once a device, with the spawn start method (CUDA needs it), and returns
what each rank returned, in rank order.  The ranks meet through a
`file://` store in a temporary directory, so concurrent runs never
compete for a port.  Each rank sets its CUDA device before its first
launch (the kernels launch on the current device's stream), joins the
group with a timeout, and leaves it at its end.  A rank that raises
ends the run: the others are terminated and `spawn` raises
`torch.multiprocessing.ProcessRaisedException` (or
`ProcessExitedException` for a rank that exited or was killed).

The backend is the caller's: `nccl` for CUDA devices, `gloo` for the
CPU (and gloo also takes CUDA tensors for some collectives).  Nothing
here switches it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT_S = 900.0


def init_group(rank: int, world_size: int, backend: str, init_method: str,
               device: torch.device | str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Make this process rank `rank` of a group of `world_size` on
    `device`: set the current CUDA device first, then join through
    `init_method`.  Returns the device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(rank: int, fn: Callable, devices: Sequence[str],
               backend: str, tmp: str, timeout_s: float, args) -> None:
    device = init_group(rank, len(devices), backend,
                        f"file://{os.path.join(tmp, 'store')}",
                        devices[rank], timeout_s)
    try:
        out = fn(rank, device, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence[torch.device | str],
          backend: str, *args, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run `fn(rank, device, *args)` in one new process a device of
    `devices` (rank r on devices[r]), all in one group of `backend`.
    `fn` and `args` cross to the ranks by pickling, so `fn` is a
    module-level function.  Returns the ranks' return values, in rank
    order."""
    devices = [str(torch.device(d)) for d in devices]
    with tempfile.TemporaryDirectory(prefix="cuburn-ranks-") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, devices, backend, tmp, timeout_s, args),
            nprocs=len(devices), join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]
