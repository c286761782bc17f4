"""Tiled bitonic sort: tile-local fused passes plus global substages.

Port of `cuburn_tpu/ops/pallas_sort.py::bitonic_sort_u32_tiled` and its
Pallas kernel `_tile_kernel`.  The ascending bitonic network over N =
2^m keys runs as a schedule of passes (`bitonic_schedule`):

    local(all stages 1..log TILE)            # every tile sorted alone
    for each later stage (block size 2^s):
        global substages, stride 2^(s-1) .. TILE
        local(size 2^s: strides TILE/2 .. 1) # one fused pass

A compare-exchange pair (i, i + k) sorts descending when i & size is
set, with i the GLOBAL index, so each tile-local pass leaves exactly
the bitonic intermediate the next global stage expects.

On a CUDA tensor `bitonic_sort_u32_tiled` narrows the keys to 32 bits
and runs the schedule through `csrc/bitonic_sort.cu` (TILE = 2^15 keys
in shared memory; the TPU's 2^16 does not fit a Hopper block); on a CPU
tensor it runs the same schedule as torch compare-exchange steps
(`bitonic_sort_reference`).  The JAX Renderer never calls this sort,
and neither does the port's: it sorts with `torch.sort`.
"""

from __future__ import annotations

import ctypes

import torch

from cuburn_tpu_torch.kernels import build as _build

TILE_LOG = 15                 # csrc/bitonic_sort.cu kTileLog
TILE = 1 << TILE_LOG
MASK32 = 0xFFFFFFFF

# CUDA kernel launches of the sort in this process: one per pass of
# bitonic_schedule, so len(bitonic_schedule(n)) per sort of n keys.
# Callers reset it to count a run.
LAUNCHES = {"bitonic_sort": 0}
# argtypes of bitonic_sort.cu's C entries, before the stream
_LOCAL_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64)
_GLOBAL_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                ctypes.c_int)


def bitonic_schedule(n: int, tile: int = TILE):
    """The passes that sort n keys (n and tile powers of two, n >=
    tile): ("local", 0) runs stages 1..log2(tile) inside each tile;
    ("global", size, k) one substage of stride k >= tile over the whole
    array; ("local", size) the strides tile/2..1 of stage `size` inside
    each tile."""
    log_n, tile_log = n.bit_length() - 1, tile.bit_length() - 1
    if n & (n - 1) or tile & (tile - 1) or n < tile:
        raise ValueError(f"n = {n} and tile = {tile} must be powers of "
                         "two with n >= tile")
    passes = [("local", 0)]
    for stage in range(tile_log + 1, log_n + 1):
        passes += [("global", 1 << stage, 1 << sub)
                   for sub in range(stage - 1, tile_log - 1, -1)]
        passes.append(("local", 1 << stage))
    return passes


def compare_exchange(x: torch.Tensor, size: int, k: int) -> torch.Tensor:
    """One bitonic substage of stride k in bitonic blocks of `size`:
    elements i and i + k (i with its k-bit clear) keep (min, max), or
    (max, min) where i & size is set."""
    v = x.reshape(-1, 2, k)
    lo = torch.minimum(v[:, 0], v[:, 1])
    hi = torch.maximum(v[:, 0], v[:, 1])
    first = torch.arange(v.shape[0], device=x.device) * (2 * k)
    desc = ((first & size) != 0)[:, None]
    return torch.stack([torch.where(desc, hi, lo),
                        torch.where(desc, lo, hi)], dim=1).reshape(-1)


def run_passes(x: torch.Tensor, passes, tile: int = TILE) -> torch.Tensor:
    """Apply schedule passes to the flat keys as compare-exchange steps
    (a local pass's strides are all below `tile`, so each of its steps
    stays inside a tile)."""
    tile_log = tile.bit_length() - 1
    for p in passes:
        if p[0] == "global":
            x = compare_exchange(x, p[1], p[2])
        elif p[1] == 0:
            for stage in range(1, tile_log + 1):
                for sub in range(stage - 1, -1, -1):
                    x = compare_exchange(x, 1 << stage, 1 << sub)
        else:
            for sub in range(tile_log - 1, -1, -1):
                x = compare_exchange(x, p[1], 1 << sub)
    return x


def _check(keys):
    n = keys.shape[0] if keys.dim() == 1 else -1
    if keys.dtype != torch.int64 or n < 2 * TILE or n & (n - 1) \
            or not keys.is_contiguous():
        raise ValueError(
            "keys must be a contiguous 1-D int64 tensor (u32 values) "
            f"whose length is a power of two >= {2 * TILE}, got "
            f"{keys.dtype} {tuple(keys.shape)}")


def bitonic_sort_reference(keys: torch.Tensor,
                           tile: int = TILE) -> torch.Tensor:
    """The plain tiled sort: the same schedule as the kernel, in torch
    compare-exchange steps, on int64 keys holding u32 values."""
    return run_passes(keys.reshape(-1), bitonic_schedule(keys.numel(),
                                                         tile), tile)


def bitonic_sort_u32_tiled(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a (N,) int64 tensor of u32 values, N a power of
    two >= 2 * TILE: the values torch.sort gives, as int64.  CPU tensors
    take bitonic_sort_reference; CUDA tensors narrow to 32 bits and run
    the schedule through the CUDA kernels."""
    _check(keys)
    if keys.device.type == "cpu":
        return bitonic_sort_reference(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.numel()
    # u32 bit patterns in an int32 buffer: the kernels read them unsigned
    x = torch.where(keys > 0x7FFFFFFF, keys - (1 << 32), keys) \
        .to(torch.int32)
    for p in bitonic_schedule(n):
        if p[0] == "global":
            _build.launch(LAUNCHES, "bitonic_sort", "bitonic_sort",
                          "bitonic_global_substage", _GLOBAL_ARGS,
                          keys.device, x.data_ptr(), n, p[1],
                          p[2].bit_length() - 1)
        else:
            _build.launch(LAUNCHES, "bitonic_sort", "bitonic_sort",
                          "bitonic_local_pass", _LOCAL_ARGS, keys.device,
                          x.data_ptr(), n, p[1])
    return x.to(torch.int64) & MASK32
