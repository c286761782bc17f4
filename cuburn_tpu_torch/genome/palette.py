"""Palette handling: decode/encode flam3 palettes, keyframe interpolation.

Covers the palette duties of the reference's cuburn/genome/convert.py
(hex-block decode) and cuburn/code/interp.py (palette interpolation
across time into a lookup texture) — SURVEY.md §2b.  Host side is numpy;
the per-temporal-sample palette array is shipped to the device inside
GenomeParams and sampled there with a gather + lerp.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np

PALETTE_SIZE = 256


def decode_hex_block(text: str, count: int = PALETTE_SIZE) -> np.ndarray:
    """Decode a flam3 XML hex palette block into a (count, 3) float array
    in [0, 1].  Accepts whitespace-separated hex, 6 chars (RGB) or 8 chars
    (ARGB, alpha ignored) per entry."""
    clean = re.sub(r"\s+", "", text)
    if not clean:
        raise ValueError("empty palette block")
    if len(clean) % count == 0 and len(clean) // count in (6, 8):
        stride = len(clean) // count
    elif len(clean) % 6 == 0:
        # RGB first: it is flam3's default format, and any RGB block
        # whose entry count is divisible by 4 is also divisible by 8
        # chars — guessing ARGB first parsed 64 red entries as 48
        # blue ones
        stride, count = 6, len(clean) // 6
    elif len(clean) % 8 == 0:
        stride, count = 8, len(clean) // 8
    else:
        raise ValueError(f"bad palette block length {len(clean)}")
    out = np.zeros((count, 3), dtype=np.float64)
    for i in range(count):
        entry = clean[i * stride:(i + 1) * stride]
        rgb = entry[-6:]  # drop leading alpha byte if present
        out[i] = [int(rgb[j:j + 2], 16) / 255.0 for j in (0, 2, 4)]
    return resize_palette(out, PALETTE_SIZE)


def encode_palette(pal: np.ndarray) -> str:
    """Encode a (256, 3) float palette as a flam3-style RGB hex string."""
    u8 = np.clip(np.asarray(pal) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return "".join(f"{r:02x}{g:02x}{b:02x}" for r, g, b in u8)


def decode_palette(obj) -> np.ndarray:
    """Decode a palette from JSON form: hex string or nested list."""
    if isinstance(obj, str):
        return decode_hex_block(obj)
    arr = np.asarray(obj, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"bad palette shape {arr.shape}")
    return resize_palette(arr, PALETTE_SIZE)


def resize_palette(pal: np.ndarray, count: int) -> np.ndarray:
    """Linearly resample a palette to `count` entries."""
    pal = np.asarray(pal, dtype=np.float64)
    if pal.shape[0] == count:
        return pal
    src = np.linspace(0.0, 1.0, pal.shape[0])
    dst = np.linspace(0.0, 1.0, count)
    return np.stack([np.interp(dst, src, pal[:, c]) for c in range(3)], axis=1)


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


def builtin_palette(index: int) -> np.ndarray:
    """Deterministic stand-in for flam3's built-in palette table.

    Old flam3/electricsheep XML can reference a gradient by number
    (`<flame palette="15">`) instead of embedding it; the real table
    lives in flam3's palettes.xml, which is data (not algorithm) and is
    not available in this offline environment.  To keep such files
    renderable, map the index to a deterministic, loop-closed palette:
    a seeded random walk through HSV anchor points, piecewise-linearly
    interpolated in RGB.  Same index -> same palette, every run.
    Callers should warn that this is NOT the flam3 gradient of that
    number (genome/convert.py does)."""
    rng = np.random.RandomState(0xF1A3 ^ (int(index) & 0x7FFFFFFF))
    n_anchor = int(rng.randint(4, 7))
    h0 = rng.uniform(0.0, 1.0)
    # hues drift around the wheel; saturation/value stay vivid
    hs = np.mod(h0 + np.cumsum(rng.uniform(-0.25, 0.25, n_anchor)), 1.0)
    ss = rng.uniform(0.45, 1.0, n_anchor)
    vs = rng.uniform(0.35, 1.0, n_anchor)
    import colorsys
    anchors = np.array([colorsys.hsv_to_rgb(h, s, v)
                        for h, s, v in zip(hs, ss, vs)])
    # close the loop so palette-coordinate wraparound is seamless
    pts = np.vstack([anchors, anchors[:1]])
    src = np.linspace(0.0, 1.0, pts.shape[0])
    dst = np.linspace(0.0, 1.0, PALETTE_SIZE, endpoint=False)
    out = np.stack([np.interp(dst, src, pts[:, c]) for c in range(3)],
                   axis=1)
    return np.clip(out, 0.0, 1.0)
