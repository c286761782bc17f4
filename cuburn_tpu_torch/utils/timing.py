"""Device synchronisation for honest host-clock timings.

Counterpart of `cuburn_tpu/utils/timing.py::hard_sync`.  PyTorch
launches CUDA work asynchronously, so a host clock read after a launch
measures only the enqueue; `sync` waits for the device first.
"""

from __future__ import annotations

import torch


def sync(device: torch.device | str) -> None:
    """Wait until every kernel queued on `device` has finished: a
    `torch.cuda.synchronize()` on CUDA, nothing on the CPU (which
    executes eagerly)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
