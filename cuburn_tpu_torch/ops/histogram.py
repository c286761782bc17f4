"""Histogram accumulation: plotted points -> (n_bins+1, 4) f32 buckets.

Port of `cuburn_tpu/ops/histogram.py`.  The layout is the one every
backend of both packages shares, and the checkpoint format: RGB plus
density per bin, float32, with a junk bin at index n_bins that
receives masked and out-of-bounds points.  Density can pass 2^24, so
the histogram is always f32.

The registry holds the XLA backends of the JAX package, as plain
PyTorch: `scatter` (index_add_), `scatter_sorted` (sort by address,
then index_add_) and `sortcum` (sort, float64 prefix sums, run-end
placement, running max, difference: no scatter-add at all).  None is a
kernel.  Every backend updates `hist` in place and returns it.  The
flushes of packed records (`pallas`, `pallas_merged`, `pallas_win`,
`pallas_rgb16`, `atomic`) live in `ops/flush.py`.
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


def _sort_by_addr(addr, rgba):
    """(addr, rgba) flattened and stably sorted by address."""
    flat_addr = addr.reshape(-1)
    order = torch.sort(flat_addr, stable=True).indices
    return flat_addr[order], rgba.reshape(-1, 4)[order]


def accumulate_scatter_sorted(hist, addr, rgba):
    """Sort rows by address, then index_add_ them in that order: the
    JAX package's sort + `indices_are_sorted` scatter.  Exact: each
    bin's adds are a reordering of the same f32 values."""
    sa, rows = _sort_by_addr(addr, rgba)
    return hist.index_add_(0, sa, rows)


def accumulate_sortcum(hist, addr, rgba):
    """Scatter-free accumulation: sort by address, per-channel prefix
    sums, the prefix sum at each run end copied to its bin, gaps filled
    with a running maximum (prefix sums of nonnegative mass are
    monotone), then adjacent bins differenced.  The prefix sums and what
    follows them run in float64, and a bin's sum is rounded to float32
    once, when it is added: in float32 a bin's error is the prefix sums'
    rounding, which CUDA's scan makes up to 37 ulps of the flush's mass
    (4.70 at 2^21 records of mass 1.05e6 per channel on an H100, 0.12 on
    the CPU)."""
    n_bins_p1 = hist.shape[0]
    sa, rows = _sort_by_addr(addr, rgba)
    csum = torch.cumsum(rows, dim=0, dtype=torch.float64)
    is_end = torch.ones_like(sa, dtype=torch.bool)
    is_end[:-1] = sa[:-1] != sa[1:]
    # run ends have unique addresses; every other row goes to a spare
    # slot past the end, which is cut off
    idx = torch.where(is_end, sa, n_bins_p1)
    dense = csum.new_zeros((n_bins_p1 + 1, 4)).index_copy_(
        0, idx, csum)[:n_bins_p1]
    filled = torch.cummax(dense, dim=0).values
    return hist.add_(torch.diff(filled, dim=0,
                                prepend=filled.new_zeros((1, 4)))
                     .to(hist.dtype))


BACKENDS = {
    "scatter": accumulate_scatter,
    "scatter_sorted": accumulate_scatter_sorted,
    "sortcum": accumulate_sortcum,
}


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown histogram backend {name!r}; have {sorted(BACKENDS)}")
