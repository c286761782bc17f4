"""Windowed histogram flush: sorted packed records -> histogram.

Port of `cuburn_tpu/ops/pallas_hist.py::accumulate_windowed_pallas`
and its Pallas kernel `_win_kernel`.  On a CUDA tensor the flush sorts
the records (`torch.sort`) and launches the hand-written kernel in
`csrc/win_flush.cu`; on a CPU tensor it runs the plain PyTorch version
beside it, `accumulate_windowed_reference`.  A CUDA tensor never falls
back to the plain version: the kernel launches or the call raises.

Both update the logical (n_bins + 1, 4) histogram IN PLACE, like the
JAX package's in-place mode, and both add into the junk bin.
"""

from __future__ import annotations

import ctypes

import torch

from cuburn_tpu_torch.kernels import build as _build
from cuburn_tpu_torch.ops.sort import SENTINEL, sort_records

# Launches of the CUDA kernel in this process: one per flush that went
# through win_flush.cu.  Callers reset it to count a run.
LAUNCHES = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p)


def _pal4(palette_hi: torch.Tensor) -> torch.Tensor:
    """Palette rows as (K, 4): a 3-column palette gets density 1
    appended; a 4-column (opacity-extended) one is used as it is."""
    if palette_hi.shape[1] == 4:
        return palette_hi
    ones = palette_hi.new_ones((palette_hi.shape[0], 1))
    return torch.cat([palette_hi, ones], dim=1)


def _check(hist, packed_records, palette_hi, n_bins, color_bits):
    if hist.dtype != torch.float32 or hist.shape != (n_bins + 1, 4) \
            or not hist.is_contiguous():
        raise ValueError(
            f"hist must be a contiguous float32 ({n_bins + 1}, 4) tensor, "
            f"got {hist.dtype} {tuple(hist.shape)}")
    if packed_records.dtype != torch.int64:
        raise ValueError("packed records must be int64 (u32 values), "
                         f"got {packed_records.dtype}")
    if palette_hi.dtype != torch.float32 or palette_hi.dim() != 2 \
            or palette_hi.shape[1] not in (3, 4) \
            or palette_hi.shape[0] != 1 << color_bits:
        raise ValueError(
            f"palette must be float32 ({1 << color_bits}, 3 or 4), got "
            f"{palette_hi.dtype} {tuple(palette_hi.shape)}")
    devices = {hist.device, packed_records.device, palette_hi.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def accumulate_windowed_reference(hist, packed_records, palette_hi,
                                  n_bins: int, color_bits: int,
                                  weight=None):
    """The plain PyTorch flush: sort, unpack, then index_add_ of
    weight * pal4[q] * count per record, where sentinels count 0.
    Updates hist in place; returns it."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    recs = sort_records(packed_records)
    count = (recs != SENTINEL).to(torch.float32)
    addr = torch.clamp(recs >> color_bits, max=n_bins)
    q = recs & ((1 << color_bits) - 1)
    rows = _pal4(palette_hi)[q] * count[:, None]
    w = 1.0 if weight is None else float(weight)
    return hist.index_add_(0, addr, rows, alpha=w)


def _launch(hist, sorted_records, pal4, n_bins, color_bits, weight):
    """One win_flush.cu launch on the current stream (no sync)."""
    global LAUNCHES
    lib = _build.load("win_flush")
    fn = lib.win_flush
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(hist.device).cuda_stream
    err = fn(sorted_records.data_ptr(), sorted_records.numel(),
             pal4.data_ptr(), color_bits, n_bins, weight,
             hist.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"win_flush launch failed: CUDA error {err}")
    LAUNCHES += 1


def accumulate_windowed(hist, packed_records, palette_hi, n_bins: int,
                        color_bits: int, weight=None):
    """Flush packed records `addr << color_bits | q` into the logical
    histogram IN PLACE and return it: each record adds weight *
    palette row q (rgb and density 1 for a 3-column palette, the
    4-column opacity-extended row as it is) into bin addr.

    CPU tensors take the plain version; CUDA tensors sort with
    torch.sort and launch the CUDA kernel, which adds weight times
    each sorted run's sum.  Density is exact at weight 1.0 with a
    3-column palette; rgb agrees within float32 reassociation."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    if hist.device.type == "cpu":
        return accumulate_windowed_reference(
            hist, packed_records, palette_hi, n_bins, color_bits, weight)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    pal4 = _pal4(palette_hi).contiguous()
    if pal4.data_ptr() % 16:
        pal4 = pal4.clone()     # the kernel reads rows as float4
    recs = sort_records(packed_records).contiguous()
    w = 1.0 if weight is None else float(weight)
    _launch(hist, recs, pal4, n_bins, color_bits, w)
    return hist
