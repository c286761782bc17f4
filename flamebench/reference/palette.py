"""Palette keyframe interpolation: a frozen copy of
`cuburn_tpu_torch/genome/palette.py`'s `palette_at`."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def palette_at(keyframes: Sequence[Tuple[float, np.ndarray]],
               t: float) -> np.ndarray:
    """Interpolate palette keyframes [(time, (256,3))...] at time t.

    Linear RGB interpolation between the two bracketing keyframes,
    clamped at the ends — matching the reference's treatment of palettes
    as time-interpolated lookup textures."""
    if not keyframes:
        raise ValueError("no palette keyframes")
    times = [kt for kt, _ in keyframes]
    if t <= times[0]:
        return np.asarray(keyframes[0][1], dtype=np.float64)
    if t >= times[-1]:
        return np.asarray(keyframes[-1][1], dtype=np.float64)
    hi = int(np.searchsorted(np.asarray(times), t, side="right"))
    lo = hi - 1
    t0, t1 = times[lo], times[hi]
    w = (t - t0) / (t1 - t0) if t1 > t0 else 0.0
    p0 = np.asarray(keyframes[lo][1], dtype=np.float64)
    p1 = np.asarray(keyframes[hi][1], dtype=np.float64)
    return (1.0 - w) * p0 + w * p1
