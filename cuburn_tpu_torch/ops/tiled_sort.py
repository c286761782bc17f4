"""Tiled bitonic sort: tile-local fused passes plus fused global passes.

Port of `cuburn_tpu/ops/pallas_sort.py::bitonic_sort_u32_tiled` and its
Pallas kernel `_tile_kernel`.  The ascending bitonic network over N =
2^m keys runs as a schedule of passes (`bitonic_schedule`):

    local(all stages 1..log TILE)            # every tile sorted alone
    for each later stage (block size 2^s):
        global passes, strides 2^(s-1) .. TILE, up to FUSE consecutive
        strides a pass
        local(size 2^s: strides TILE/2 .. 1) # one fused pass

N <= TILE is one local pass (on the card one tile, padded with
0xFFFFFFFF past N).  A compare-exchange pair (i, i + k) sorts
descending when i & size is set, with i the GLOBAL index, so each
tile-local pass leaves exactly the bitonic intermediate the next global
stage expects.

On a CUDA tensor `bitonic_sort_u32_tiled` runs the schedule through
`csrc/bitonic_sort.cu`, one launch a pass (TILE = 2^15 keys in shared
memory; the TPU's 2^16 does not fit a Hopper block): the first pass
reads the int64 keys and the last writes int64, the passes between work
on u32.  On a CPU tensor it runs the same schedule as torch
compare-exchange steps (`bitonic_sort_reference`).

The keys are u32 values held in int64.  The CPU refuses any other
value; on the card the check would cost a sync, so the first pass keeps
each key's low 32 bits unchecked (a key below 0 or above 0xFFFFFFFF
comes back truncated).  `record_bits` keeps every record of a render
inside u32.
"""

from __future__ import annotations

import ctypes

import torch

from cuburn_tpu_torch.kernels import build as _build

TILE_LOG = 15                 # csrc/bitonic_sort.cu kTileLog
TILE = 1 << TILE_LOG
FUSE = 4                      # strides a global pass fuses: the kernel's
                              # 4-bit window of 16 keys a thread (kKeysLog)

# CUDA kernel launches of the sort in this process: one per pass of
# bitonic_schedule, so len(bitonic_schedule(n)) per sort of n keys.
# Callers reset it to count a run.
LAUNCHES = {"bitonic_sort": 0}
_P, _I64, _U64, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                        ctypes.c_int)
# argtypes of bitonic_sort.cu's C entries, before the stream
_LOCAL_ARGS = (_P, _P, _I64, _U64, _INT)
_GLOBAL_ARGS = (_P, _I64, _U64, _INT, _INT)


def bitonic_schedule(n: int, tile: int = TILE):
    """The passes that sort n keys (n and tile powers of two):
    ("local", 0) runs stages 1..log2(min(n, tile)) inside each tile;
    ("global", size, k_hi, k_lo) the strides k_hi, k_hi/2, .., k_lo
    (at most FUSE of them, all >= tile) of stage `size` over the whole
    array; ("local", size) the strides tile/2..1 of stage `size` inside
    each tile.  n <= tile is the single local pass."""
    log_n, tile_log = n.bit_length() - 1, tile.bit_length() - 1
    if n < 1 or n & (n - 1) or tile < 2 or tile & (tile - 1):
        raise ValueError(f"n = {n} and tile = {tile} must be powers of "
                         "two (tile >= 2)")
    passes = [("local", 0)]
    for stage in range(tile_log + 1, log_n + 1):
        for hi in range(stage - 1, tile_log - 1, -FUSE):
            lo = max(hi - FUSE + 1, tile_log)
            passes.append(("global", 1 << stage, 1 << hi, 1 << lo))
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
    (a local pass's strides are all below min(n, tile), so each of its
    steps stays inside a tile)."""
    tile_log = min(tile, x.numel()).bit_length() - 1
    for p in passes:
        if p[0] == "global":
            k = p[2]
            while k >= p[3]:
                x = compare_exchange(x, p[1], k)
                k //= 2
        elif p[1] == 0:
            for stage in range(1, tile_log + 1):
                for sub in range(stage - 1, -1, -1):
                    x = compare_exchange(x, 1 << stage, 1 << sub)
        else:
            for sub in range(tile_log - 1, -1, -1):
                x = compare_exchange(x, p[1], 1 << sub)
    return x


def _check(keys):
    """Shape and type; the u32 value range on the CPU only."""
    n = keys.shape[0] if keys.dim() == 1 else -1
    if keys.dtype != torch.int64 or n < 1 or n & (n - 1) \
            or not keys.is_contiguous():
        raise ValueError(
            "keys must be a contiguous 1-D int64 tensor (u32 values) "
            "whose length is a power of two, got "
            f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device.type == "cpu" and (int(keys.min()) < 0
                                      or int(keys.max()) > 0xFFFFFFFF):
        raise ValueError("keys must be u32 values, got "
                         f"[{int(keys.min())}, {int(keys.max())}]")


def bitonic_sort_reference(keys: torch.Tensor,
                           tile: int = TILE) -> torch.Tensor:
    """The plain tiled sort: the same schedule as the kernel, in torch
    compare-exchange steps, on int64 keys holding u32 values."""
    _check(keys)
    return run_passes(keys.reshape(-1), bitonic_schedule(keys.numel(),
                                                         tile), tile)


def bitonic_sort_u32_tiled(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a (N,) int64 tensor of u32 values, N a power of
    two: the values torch.sort gives, as a new int64 tensor.  CPU
    tensors take bitonic_sort_reference, which refuses keys outside u32;
    CUDA tensors launch one kernel per pass of the schedule, or raise,
    and keep each key's low 32 bits unchecked."""
    _check(keys)
    if keys.device.type == "cpu":
        return bitonic_sort_reference(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.numel()
    if keys.data_ptr() % 16:        # the kernels read 16-byte vectors
        keys = keys.clone()
    passes = bitonic_schedule(n)
    out = torch.empty_like(keys)
    # the u32 keys between the first pass and the last
    x = out if len(passes) == 1 else torch.empty(n, dtype=torch.int32,
                                                 device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    for i, p in enumerate(passes):
        last = i == len(passes) - 1
        if p[0] == "global":
            _build.launch(LAUNCHES, "bitonic_sort", "bitonic_sort",
                          "bitonic_global_pass", _GLOBAL_ARGS, stream,
                          x.data_ptr(), n, p[1], p[2].bit_length() - 1,
                          p[3].bit_length() - 1)
        else:
            src = keys if i == 0 else x
            dst = out if last else x
            _build.launch(LAUNCHES, "bitonic_sort", "bitonic_sort",
                          "bitonic_local_pass", _LOCAL_ARGS, stream,
                          src.data_ptr(), dst.data_ptr(), n, p[1], last)
    return out
