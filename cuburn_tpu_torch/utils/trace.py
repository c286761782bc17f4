"""Spans and counters of the render path.

`span(name)` marks a stretch of the host's time as `cuburn.<name>` in a
torch.profiler trace, on the clock of the device's own events, while a
profiler records (`main.py --trace-dir`, or any caller's
`torch.profiler.profile`); otherwise it is one shared null context, a
single guarded call.  Spans nest: a span's parent is the span open
around it.

Every call at which the host waits for the device's stream on CUDA goes
through `wait()`: a `sync` span, counted in COUNTS["syncs"] with the
profiler on or off.  Reading a device value on the host is such a call,
as are the explicit synchronisations.  Every host-to-device copy goes
through `upload()`, which stages the data in page-locked memory and
queues the copy without waiting: counted in COUNTS["uploads"], not as a
sync.  A site counts the same on the CPU, where it waits for nothing,
so the CPU's counts are the card's.

COUNTS holds running totals beside the kernels' LAUNCHES dicts, read
the same way: `counters()` takes a snapshot of both, `since(before)`
the difference.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "cuburn."
_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled

# chunks run, records flushed, host waits for the stream, host-to-device
# copies queued, and the chunks of those queued by one C call
# (ops/chaos.py launch_accumulate)
COUNTS = {"chunks": 0, "records": 0, "syncs": 0, "uploads": 0,
          "looped_chunks": 0}


def span(name: str):
    """`cuburn.<name>` around a `with` block while a profiler records;
    the shared null context otherwise."""
    if _profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


def wait():
    """The `sync` span of one call at which the host waits for the
    stream, counted whether or not a profiler records."""
    COUNTS["syncs"] += 1
    return span("sync")


def upload(a, device, dtype=None) -> torch.Tensor:
    """`a` as a tensor of `dtype` on `device`.  Unless `a` is a tensor on
    a CUDA device already, that copies host memory: one counted upload.

    To a CUDA device the host data is first copied into a page-locked
    block, so the caller may change its array as soon as this returns,
    and the block is copied to the device on the current stream without
    a wait, queued behind the work before it.  PyTorch's caching host
    allocator records the copy's event on the block and hands the block
    out again only after the copy has run."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device, dtype)
    COUNTS["uploads"] += 1
    if torch.device(device).type != "cuda":
        return torch.as_tensor(a, dtype=dtype, device=device)
    host = torch.as_tensor(a, dtype=dtype)
    staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    return staged.copy_(host).to(device, non_blocking=True)


def launch_counters():
    """The render path's kernel launch counters: the LAUNCHES dicts of
    ops/chaos.py, ops/flush.py and ops/tiled_sort.py."""
    from cuburn_tpu_torch.ops import chaos, flush, tiled_sort
    return chaos.LAUNCHES, flush.LAUNCHES, tiled_sort.LAUNCHES


def launches() -> dict:
    """Every render-path kernel's launches so far, by kernel."""
    return {k: v for counts in launch_counters() for k, v in counts.items()}


def counters() -> dict:
    """A snapshot of COUNTS and of the render path's kernel launches
    (summed under "launches")."""
    return dict(COUNTS, launches=sum(launches().values()))


def since(before: dict) -> dict:
    """What the counters of `before` (a `counters()` snapshot) have
    counted since."""
    now = counters()
    return {k: now[k] - before[k] for k in now}
