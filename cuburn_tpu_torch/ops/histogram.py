"""Histogram accumulation: plotted points -> (n_bins+1, 4) f32 buckets.

Port of `cuburn_tpu/ops/histogram.py`.  The layout is the one every
backend of both packages shares, and the checkpoint format: RGB plus
density per bin, float32, with a junk bin at index n_bins that
receives masked and out-of-bounds points.  Density can pass 2^24, so
the histogram is always f32.

The registry holds `scatter` only.  The windowed flush (`pallas_win`)
consumes packed records and lives in `ops/flush.py`.
"""

from __future__ import annotations

import torch

def alloc(n_bins: int, device: torch.device | str) -> torch.Tensor:
    """A zeroed histogram with its junk bin."""
    return torch.zeros((n_bins + 1, 4), dtype=torch.float32,
                       device=device)


def finalize(hist: torch.Tensor) -> torch.Tensor:
    """Drop the junk bin."""
    return hist[:-1]


def accumulate_scatter(hist, addr, rgba):
    """Add rgba rows (..., 4) into hist at addr, in place (index_add_);
    addr may hold the junk bin.  Returns hist."""
    return hist.index_add_(0, addr.reshape(-1), rgba.reshape(-1, 4))


BACKENDS = {
    "scatter": accumulate_scatter,
}


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown histogram backend {name!r}; have {sorted(BACKENDS)}")
