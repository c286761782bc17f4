"""Catmull-Rom splines over time for animated genome parameters.

Behavioral equivalent of the reference's host-side spline evaluation
(cuburn/genome/spline.py `SplEval`, SURVEY.md §2b): every scalar genome
parameter is a list of (time, value) knots evaluated with a Catmull-Rom
interpolant, clamped to the end values outside the knot range.  A bare
scalar is treated as a constant spline.

This module is pure numpy (host side), the port's own copy of
`cuburn_tpu/genome/spline.py`.  The batched on-device evaluation of all
packed parameters at all temporal-sample times (cuburn's GPU interp
kernels, cuburn/code/interp.py) is not ported yet; when it is, it must
match these semantics exactly.
"""

from __future__ import annotations

import numbers
from typing import Sequence, Union

import numpy as np

KnotsLike = Union[numbers.Real, Sequence[float], "Spline"]


class Spline:
    """A 1-D Catmull-Rom spline over (time, value) knots.

    Accepts:
      * a scalar                      -> constant spline
      * a flat list [t0,v0,t1,v1,..]  -> knots (cuburn JSON convention)
      * a list of (t, v) pairs
      * another Spline                -> copy
    """

    __slots__ = ("knots",)

    def __init__(self, knots: KnotsLike):
        if isinstance(knots, Spline):
            self.knots = knots.knots.copy()
            return
        if isinstance(knots, numbers.Real):
            self.knots = np.array([[0.0, float(knots)]], dtype=np.float64)
            return
        arr = np.asarray(knots, dtype=np.float64)
        if arr.ndim == 1:
            if arr.size == 1:
                arr = np.array([[0.0, arr[0]]])
            else:
                if arr.size % 2:
                    raise ValueError(
                        f"flat knot list must have even length, got {arr.size}")
                arr = arr.reshape(-1, 2)
        elif arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"bad knot shape {arr.shape}")
        if arr.shape[0] == 0:
            raise ValueError("spline needs at least one knot")
        order = np.argsort(arr[:, 0], kind="stable")
        self.knots = arr[order]

    # -- queries ----------------------------------------------------------

    @property
    def is_constant(self) -> bool:
        return len(self.knots) == 1 or np.all(self.knots[:, 1] == self.knots[0, 1])

    def __call__(self, t: float) -> float:
        return float(self.evaluate(np.asarray([t]))[0])

    def evaluate(self, ts: np.ndarray) -> np.ndarray:
        """Evaluate at an array of times (vectorized host-side)."""
        ts = np.asarray(ts, dtype=np.float64)
        k = self.knots
        if len(k) == 1:
            return np.full(ts.shape, k[0, 1])
        t_k, v_k = k[:, 0], k[:, 1]
        # Segment index i such that t in [t_k[i], t_k[i+1]); clamp ends.
        i = np.clip(np.searchsorted(t_k, ts, side="right") - 1, 0, len(k) - 2)
        t0, t1 = t_k[i], t_k[i + 1]
        dt = np.where(t1 > t0, t1 - t0, 1.0)
        s = np.clip((ts - t0) / dt, 0.0, 1.0)
        p1, p2 = v_k[i], v_k[i + 1]
        # Endpoint-clamped neighbor values (duplicate end knots).
        p0 = v_k[np.maximum(i - 1, 0)]
        p3 = v_k[np.minimum(i + 2, len(k) - 1)]
        # Non-uniform Catmull-Rom tangents (finite-difference form), which
        # reduces to the classic (p2-p0)/2 form on uniform knot spacing.
        t_prev = t_k[np.maximum(i - 1, 0)]
        t_next = t_k[np.minimum(i + 2, len(k) - 1)]
        d_prev = np.where(t1 - t_prev > 0, t1 - t_prev, 1.0)
        d_next = np.where(t_next - t0 > 0, t_next - t0, 1.0)
        m1 = (p2 - p0) * dt / d_prev
        m2 = (p3 - p1) * dt / d_next
        h00, h10, h01, h11 = _hermite_basis(s)
        out = h00 * p1 + h10 * m1 + h01 * p2 + h11 * m2
        # Outside the knot range: hold end values.
        out = np.where(ts <= t_k[0], v_k[0], out)
        out = np.where(ts >= t_k[-1], v_k[-1], out)
        return out

    # -- serialization ----------------------------------------------------

    def __repr__(self):
        return f"Spline({self.to_json()!r})"

    def __eq__(self, other):
        return isinstance(other, Spline) and np.array_equal(self.knots, other.knots)


def _hermite_basis(s):
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return h00, h10, h01, h11


def spline(x: KnotsLike) -> Spline:
    return x if isinstance(x, Spline) else Spline(x)
