"""Sorting packed log records.

Port of `cuburn_tpu/ops/sort.py::sort_records`.  The JAX package sorts
with XLA (a bitonic network or `lax.sort`), not with a Pallas kernel,
so the port uses the library sort, `torch.sort`.  The records are
int64 tensors holding u32 values.
"""

from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF


def sort_records(records: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a flat array of packed records (any length).

    Pads to the next power of two with 0xFFFFFFFF sentinels that sort
    to the end, as the JAX counterpart does; the flush skips them."""
    flat = records.reshape(-1)
    n = flat.shape[0]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 != n:
        flat = torch.cat([flat, flat.new_full((pow2 - n,), SENTINEL)])
    return torch.sort(flat).values
