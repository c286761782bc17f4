"""Sorting and run-merging packed log records.

Port of `cuburn_tpu/ops/sort.py::sort_records` and
`merge_sorted_records`.  The JAX package sorts with XLA (a bitonic
network or `lax.sort`), not with a Pallas kernel, so the port uses the
library sort, `torch.sort`.  Its Pallas tiled sort has its own port in
`ops/tiled_sort.py`.  The records are int64 tensors holding u32 values.
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


def merge_sorted_records(sorted_recs: torch.Tensor, junk_record: int):
    """Run-length merge of a SORTED record stream.

    Returns (unique_records (N,) int64, counts (N,) int32): the first U
    positions hold each distinct record with its multiplicity, the rest
    are `junk_record` with count 0.  Fixed shapes, no host sync: the
    u-th run start is found by searchsorted over the running run id,
    as the JAX counterpart does."""
    n = sorted_recs.shape[0]
    is_start = torch.ones_like(sorted_recs, dtype=torch.bool)
    is_start[1:] = sorted_recs[1:] != sorted_recs[:-1]
    seg_id = torch.cumsum(is_start, 0) - 1
    positions = torch.arange(n, device=sorted_recs.device)
    starts = torch.searchsorted(seg_id, positions)
    valid = positions <= seg_id[-1]
    uniq = torch.where(valid, sorted_recs[torch.clamp(starts, max=n - 1)],
                       junk_record)
    next_start = torch.cat([starts[1:], starts.new_full((1,), n)])
    counts = torch.where(valid, next_start - starts, 0)
    return uniq, counts.to(torch.int32)
