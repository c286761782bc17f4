"""Histogram accumulation: plotted points -> (n_bins+1, 4) f32 buckets.

Port of `cuburn_tpu/ops/histogram.py`.  The layout is the one every
backend of both packages shares, and the checkpoint format: RGB plus
density per bin, float32, with a junk bin at index n_bins that
receives masked and out-of-bounds points.  Density can pass 2^24, so
the histogram is always f32.

`BACKENDS` is the one table of what each histogram backend is.  The
XLA backends of the JAX package are here, as plain PyTorch: `scatter`
(index_add_), `scatter_sorted` (sort by address, then index_add_) and
`sortcum` (sort, float64 prefix sums, run-end placement, running max,
difference: no scatter-add at all).  None is a kernel.  Every backend
updates `hist` in place and returns it.  The flushes of packed records
(`pallas`, `pallas_merged`, `pallas_win`, `pallas_rgb16`, `atomic`)
live in `ops/flush.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cuburn_tpu_torch.ops import flush as flush_mod


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


@dataclass(frozen=True)
class Backend:
    """What a histogram backend is: every fact the render path would
    otherwise test by the backend's name."""
    # its accumulate on unpacked (addr, rgba) rows; None for a flush of
    # packed u32 records only (ops/iterate.PACKED_FLUSHES)
    accumulate: Optional[Callable] = None
    color_bits: Optional[int] = None    # cap on a record's colour bits
    split: bool = False         # f32 density, bf16 rgb (hist_alloc_for)
    c_loop: bool = False        # the card's C chunk loop queues its flush
    tunable: bool = False       # a tune record may pick it for `auto`
    tiled_flush: bool = False   # `tiled_flush_records` sets its flush size

    @property
    def packed(self) -> bool:
        return self.accumulate is None


# the JAX package's backends and the port's own `atomic`: `pallas`'s
# unsorted flush on `pallas_win`'s 8-bit records (a TPU has no
# scatter-add).  8 colour bits are flam3's palette resolution, and keep
# `pallas_win`'s records bit-identical to the JAX package's.
BACKENDS = {
    "scatter": Backend(accumulate_scatter, tunable=True),
    "scatter_sorted": Backend(accumulate_scatter_sorted, tunable=True),
    "sortcum": Backend(accumulate_sortcum),
    "pallas": Backend(c_loop=True),
    "pallas_merged": Backend(),
    "pallas_win": Backend(color_bits=8, tunable=True, tiled_flush=True),
    "pallas_rgb16": Backend(color_bits=8, split=True, tunable=True,
                            tiled_flush=True),
    "atomic": Backend(color_bits=8, c_loop=True, tunable=True),
}


def get_backend(name: str) -> Backend:
    """The backend named `name`; ValueError for a name not in BACKENDS."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown histogram backend {name!r}; have {sorted(BACKENDS)}")


def hist_alloc_for(backend: str, n_bins: int, device):
    """The zeroed histogram in the layout the backend accumulates into:
    the split (density f32, rgb bf16) pair for a `split` backend, the
    logical (n_bins+1, 4) float32 tensor for every other backend."""
    if get_backend(backend).split:
        return flush_mod.alloc_split(n_bins, device)
    return alloc(n_bins, device)


def hist_to_layout(backend: str, hist):
    """Logical (n_bins+1, 4) -> the backend's layout.  The split layout
    rounds rgb to bf16 once."""
    if get_backend(backend).split:
        return flush_mod.to_split_layout(hist)
    return hist


def hist_to_logical(backend: str, hist, n_bins: int):
    """Backend layout -> logical (n_bins+1, 4) float32."""
    if get_backend(backend).split:
        return flush_mod.from_split_layout(*hist)
    return hist


def histogram_tiled(n_bins: int, device: torch.device | str) -> bool:
    """Whether a histogram of n_bins bins is "tiled" on `device`: its
    logical float32 form ((n_bins+1) x 16 bytes) exceeds the card's L2
    cache, so a flush streams it from device memory.  This is where
    the tune record's `*_tiled` keys apply, as the JAX package applies
    them where its histogram leaves VMEM.  Never on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return (n_bins + 1) * 16 > l2
