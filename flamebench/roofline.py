"""The least time the card could take for a function's work: the table
of peaks and the operations and bytes of each function.

The peaks and `bound_s` are `chip_smoke.py`'s (`PEAK_*`, `bound`),
in seconds.  The work is counted per function from the frame's shapes
and the reference's own counts (its plotted points and the bins they
touch), never per kernel or per flush, so a radix sort, a fused flush,
4-byte records or another flush size reads against the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense rates at a 700 W power limit:
# device memory, and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# a lane's chaos-game state at its own widths: x, y, colour (f32), the
# last xform and the age (i32), four u32 RNG words
STATE_BYTES = 3 * 4 + 2 * 4 + 4 * 4
# the smallest record of a plotted point: a 24-bit address beside an
# 8-bit palette coordinate
RECORD_BYTES = 4
# a bin of the float32 rgba accumulator
BIN_BYTES = 16


def bound_s(nbytes: float, ops: float = 0.0):
    """(seconds, "bytes" | "operations"): the larger of bytes over the
    memory rate and operations over the float32 rate."""
    b = nbytes / PEAK_BYTES_PER_S
    o = ops / PEAK_F32_OPS_PER_S
    return (b, "bytes") if b >= o else (o, "operations")


def chaos_bound_s(lane_steps: float, ops_per_lane_step: float,
                  lanes: float):
    """The chaos game's least time: every lane-step's float operations
    and its 4-byte record, and each lane's state read and written once.
    `lanes` counts a lane once per temporal sample."""
    return bound_s(lane_steps * RECORD_BYTES + lanes * 2 * STATE_BYTES,
                   lane_steps * ops_per_lane_step)


def flush_bound_s(records: float, bins: float):
    """The least time of "records into the histogram": each record read
    once, each bin it touches read and written once."""
    return bound_s(records * RECORD_BYTES + bins * 2 * BIN_BYTES)


def lanes_for(batch: int, fuse: int, iters: float) -> int:
    """The trajectories a sample of `iters` iterations runs: the batch,
    halved while a lane would live fewer than 8 x fuse steps (the
    program's rule, `Renderer._batch_for`)."""
    min_life = 8 * max(fuse, 1)
    while batch > 1024 and iters / batch < min_life:
        batch //= 2
    return batch
