"""Sorting and run-merging packed log records.

Port of `cuburn_tpu/ops/sort.py::sort_records` and
`merge_sorted_records`.  The JAX package's default sort is its bitonic
network; the port sorts CUDA tensors with its hand-written tiled bitonic
sort (`ops/tiled_sort.py`, the port of the Pallas tiled sort) and CPU
tensors with `torch.sort`.  The records are int64 tensors holding u32
values.
"""

from __future__ import annotations

import torch

from cuburn_tpu_torch.ops.tiled_sort import bitonic_sort_u32_tiled
from cuburn_tpu_torch.utils import trace

SENTINEL = 0xFFFFFFFF


def pad_records(records: torch.Tensor) -> torch.Tensor:
    """The flat records padded to the next power of two with 0xFFFFFFFF
    sentinels, which sort to the end, as the JAX counterpart does; the
    flushes skip them."""
    flat = records.reshape(-1)
    n = flat.shape[0]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 != n:
        flat = torch.cat([flat, flat.new_full((pow2 - n,), SENTINEL)])
    return flat.contiguous()


def sort_records(records: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a flat array of packed records (any length),
    padded by pad_records.  The records are u32 values: CUDA tensors
    launch the tiled bitonic sort kernel (one launch a pass), which keeps
    each record's low 32 bits unchecked; CPU tensors take torch.sort, and
    the CPU flushes refuse records outside u32 before they sort.  One
    `sort` span."""
    with trace.span("sort"):
        flat = pad_records(records)
        if flat.device.type == "cuda":
            return bitonic_sort_u32_tiled(flat)
        return torch.sort(flat).values


def sort_records_reference(records: torch.Tensor) -> torch.Tensor:
    """sort_records by torch.sort on any device: the plain flushes sort
    with it, so that a plain version never launches a kernel.  One
    `sort` span."""
    with trace.span("sort"):
        return torch.sort(pad_records(records)).values


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
