"""Adaptive density-estimation (DE) filtering.

Port of `cuburn_tpu/ops/de.py`: flam3's adaptive blur, where each
accumulator cell splats its log-scaled energy with a Gaussian whose
radius shrinks with the cell's own density,

    r(d) = clamp(max_radius / d^curve, min_radius, max_radius),

computed as the banded decomposition: radii quantize onto a static
geometric ladder of N_BANDS rungs, every pixel splats into its two
adjacent rungs with linear hat weights in log radius, and each rung is
one separable Gaussian blur.  Wide rungs on accumulators at least
PYRAMID_MIN_WIDTH wide run at octave-downsampled resolution (the
pyramid path).  The blurs are depthwise convolutions with TF32 off.

Radius is in accumulator (supersampled) pixels; callers pre-scale the
genome's estimator radius by ss.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cuburn_tpu_torch.ops.filtering import depthwise_conv
from cuburn_tpu_torch.utils import trace

N_BANDS = 8
MAX_RADIUS_CAP = 24          # absolute clamp on DE radius, px
MIN_BAND_RADIUS = 0.5        # radii below this are effectively identity

PYRAMID_MIN_HALF = 8          # bands narrower than this stay direct
PYRAMID_COARSE_HALF = 4       # target coarse-scale half-width
# the pyramid is a ~2% rel-L2 approximation, so it engages only on
# accumulators at least this wide (1080p-ss2-class frames and up)
PYRAMID_MIN_WIDTH = 2048


def _sep_blur(img, taps, half: int):
    """Separable blur of (H, W, C) with 1-D taps on both axes, zero
    padding at the edges."""
    if half == 0:
        return img
    x = img.permute(2, 0, 1)[None]          # (1, C, H, W)
    x = depthwise_conv(x, taps, taps, padding=(half, half))
    return x[0].permute(1, 2, 0)


def _gaussian_taps(radius: float, half: int, device):
    x = np.arange(-half, half + 1, dtype=np.float32)
    sigma = max(radius * 0.5, 1e-3)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return trace.upload(k / k.sum(), device)


def _pyramid_plan(radius: float, half: int, width: int):
    """(f, coarse radius, coarse half-width) of one rung on an
    accumulator `width` wide; f = 1 blurs directly.  The pyramid takes
    rungs at least PYRAMID_MIN_HALF wide on frames at least
    PYRAMID_MIN_WIDTH wide, at the octave that brings the half-width
    near PYRAMID_COARSE_HALF."""
    if half < PYRAMID_MIN_HALF or width < PYRAMID_MIN_WIDTH:
        return 1, radius, half
    f = 1 << max(int(np.floor(np.log2(half / PYRAMID_COARSE_HALF))), 0)
    if f <= 1:
        return 1, radius, half
    sigma = max(radius * 0.5, 1e-3)
    sigma_c = float(np.sqrt(max(sigma * sigma - f * f / 3.0, 0.25))) / f
    r_c = 2.0 * sigma_c
    return f, r_c, max(int(np.ceil(1.5 * r_c)), 1)


def band_context(static_max_radius: float, width: int):
    """(rows, align) that a horizontal band of a `width`-wide
    accumulator needs for its DE to equal the whole frame's: the
    pyramid boxes rows in blocks of f counted from the accumulator's
    row 0, so a band's rows must start at a multiple of `align` (the
    largest f), and an output row reads up to f * (coarse half-width
    + 2) rows away, past the direct blur's 1.5 x radius; `rows` is the
    largest such reach.  (0, 1) when no rung takes the pyramid."""
    radii, taps = band_ladder(static_max_radius)
    rows, align = 0, 1
    for radius, half in zip(radii, taps):
        f, _r_c, half_c = _pyramid_plan(radius, half, width)
        if f > 1:
            rows, align = max(rows, f * (half_c + 2)), max(align, f)
    return rows, align


def _sep_blur_band(img, radius: float, half: int):
    """One band's separable Gaussian, octave-downsampled by
    _pyramid_plan's f: box down by f, blur with a coarse Gaussian whose
    composed variance matches the target, then linear interpolation
    back up."""
    dev = img.device
    f, r_c, half_c = _pyramid_plan(radius, half, img.shape[1])
    if f == 1:
        return _sep_blur(img, _gaussian_taps(radius, half, dev), half)
    H, W, C = img.shape
    Hp, Wp = -(-H // f) * f, -(-W // f) * f
    x = F.pad(img, (0, 0, 0, Wp - W, 0, Hp - H))
    # box down (mean keeps per-cell scale; mass/f^2)
    x = x.reshape(Hp // f, f, Wp // f, f, C).mean(dim=(1, 3))
    x = _sep_blur(x, _gaussian_taps(r_c, half_c, dev), half_c)
    # repeat + normalized triangle = linear interpolation between block
    # centers (mass * f^2, so net mass is preserved)
    x = x.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)
    tri = np.maximum(
        1.0 - np.abs(np.arange(-(f - 1), f, dtype=np.float32)) / f, 0.0)
    x = _sep_blur(x, trace.upload(tri / f, dev), f - 1)
    return x[:H, :W]


@functools.lru_cache(maxsize=None)
def band_ladder(static_max_radius: float):
    """Static geometric radius ladder + per-band tap counts.
    Returns (radii tuple, half-widths tuple); band 0 is the widest."""
    max_r = float(np.clip(static_max_radius, MIN_BAND_RADIUS,
                          MAX_RADIUS_CAP))
    g = (MIN_BAND_RADIUS / max_r) ** (1.0 / (N_BANDS - 1))
    radii = tuple(max_r * g ** k for k in range(N_BANDS))
    # Gaussian sigma = r/2, support to 3 sigma = 1.5 r
    taps = tuple(int(np.ceil(1.5 * r)) for r in radii)
    return radii, taps


def radius_for_density(density, max_radius, min_radius, curve):
    """flam3's estimator formula (density in raw counts)."""
    d = torch.clamp(density, min=1.0)
    r = max_radius / torch.pow(d, curve)
    return torch.clamp(r, min_radius, torch.maximum(max_radius,
                                                    min_radius))


def density_filter(img, density, max_radius, min_radius, curve,
                   static_max_radius: float = None,
                   skip_empty: bool = False):
    """Banded adaptive DE blur with two-rung interpolation.

    img     (H, W, 4) log-scaled premultiplied rgba
    density (H, W)    raw accumulator counts (pre-logscale)
    max_radius/min_radius/curve: 0-d tensors of the flam3 estimator
        parameters, which set each pixel's rung weights
    static_max_radius: the radius that fixes the band ladder
        (default 9, flam3's)
    skip_empty: a rung whose hat weights are all zero adds nothing, so
        its two convolutions are skipped.  The test is a host read of
        `(w > 0).any()`: one device sync per rung.  The result is the
        same either way."""
    if static_max_radius is None:
        static_max_radius = 9.0
    radii, taps = band_ladder(static_max_radius)

    r_px = radius_for_density(
        density, torch.clamp(max_radius, 0.0, MAX_RADIUS_CAP),
        min_radius, curve)
    logr = torch.log(torch.clamp(r_px, min=MIN_BAND_RADIUS))
    log_g = float(np.log(radii[1] / radii[0])) if N_BANDS > 1 else 0.0
    if log_g == 0.0:
        # degenerate ladder: all rungs equal, everything through band 0
        u = torch.zeros_like(logr)
    else:
        u = torch.clamp((logr - float(np.float32(np.log(radii[0]))))
                        / float(np.float32(log_g)), 0.0, N_BANDS - 1.0)

    out = torch.zeros_like(img)
    for k in range(N_BANDS):
        # linear hat: weight 1 at rung k, 0 beyond the neighbours
        w = torch.clamp(1.0 - torch.abs(u - k), min=0.0)[..., None]
        if skip_empty:
            with trace.wait():
                empty = not bool((w > 0).any())
            if empty:
                continue
        out = out + _sep_blur_band(img * w, radii[k], taps[k])
    return out
