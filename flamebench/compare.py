"""The comparison that decides `correct`: a frame of the program beside
the reference's frame of the same genome, time and seed.

The reference starts the same trajectories from the seed and draws the
same random words, so it plots nearly the same points: what is left
between the two frames is float rounding in the chaos game, the order
of the histogram's additions, and the u8 rounding they move.  Two
numbers are compared, each the largest over the frames checked:

- `mean_gap`: the mean |program - reference| over every pixel and
  colour channel, in u8 steps;
- `block_gap`: the largest mean |program - reference| of a block of
  BLOCK x BLOCK pixels, in u8 steps, which a local change cannot hide
  in the frame's mean.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

BLOCK = 16
NAMES = ("mean_gap", "block_gap")


def frame_gaps(image: np.ndarray, ref_image: np.ndarray) -> Dict[str, float]:
    """The numbers of one frame; `image` may carry an alpha channel,
    which is left out."""
    a = np.asarray(image)[..., :3].astype(np.float64)
    b = np.asarray(ref_image)[..., :3].astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"frame shape {a.shape} against the reference's "
                         f"{b.shape}")
    d = np.abs(a - b).mean(axis=-1)
    h, w = d.shape
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)
    padded = np.zeros((hb * BLOCK, wb * BLOCK))
    count = np.zeros_like(padded)
    padded[:h, :w] = d
    count[:h, :w] = 1.0
    sums = padded.reshape(hb, BLOCK, wb, BLOCK).sum(axis=(1, 3))
    cells = count.reshape(hb, BLOCK, wb, BLOCK).sum(axis=(1, 3))
    return {"mean_gap": float(d.mean()),
            "block_gap": float((sums / cells).max())}


def worst(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over the frames checked."""
    return {k: max(g[k] for g in gaps) for k in NAMES}


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number lies within its limit (NaN fails)."""
    return all(readings[k] <= limits[k] for k in NAMES)
