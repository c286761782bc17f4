"""Render profiles: named device/quality presets.

The port's own copy of `cuburn_tpu/profile.py`, field for field, so a
profile of either package converts to the other with
`RenderProfile(**other.__dict__)`.  The port ignores
`dispatch_iter_cap` and `sort_segments` (TPU-only knobs).

Equivalent of the reference's cuburn/profile.py (SURVEY.md §2 layer 5):
a profile carries everything about *how* to render (resolution, quality,
supersampling, fps) as opposed to *what* (the genome).  The three-tier
config system is preserved exactly: genome JSON/XML -> profile -> CLI
flags (SURVEY.md §5 config table).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional


@dataclass(frozen=True)
class RenderProfile:
    width: int = 640
    height: int = 480
    ss: int = 1                  # supersampling factor (flam3 oversample)
    quality: int = 50            # iterations per output pixel
    fuse: int = 32               # warmup iterations before plotting
    batch: int = 1 << 17         # trajectories advanced in lockstep
    # scan length between histogram flushes (records per flush =
    # batch * iters_per_chunk).  0 = auto: the per-card tune record's
    # flush size (its tiled one for a histogram past L2), else 32
    # (render.py _resolve_iters_per_chunk).
    iters_per_chunk: int = 0
    hist_backend: str = "auto"   # auto | scatter | sortcum | pallas | pallas_merged | pallas_win | pallas_rgb16 (auto picks pallas_win on a GPU, scatter on the CPU)
    de_enabled: bool = True
    transparent: bool = False
    fps: float = 24.0
    duration: Optional[float] = None   # seconds; None = single frame
    temporal_samples: int = 1    # genome evaluations per frame (motion blur)
    skip: int = 1                # render every skip-th frame
    # split accumulation into device calls of at most this many
    # iterations (None = one call per frame/sample).  For environments
    # whose TPU worker kills long-running executions; the same
    # compiled program serves every call (traced chunk count).
    dispatch_iter_cap: Optional[int] = None
    # pallas_win flush: sort the per-flush log as this many independent
    # sub-sorts (power of two; fewer bitonic substages, wider windows —
    # ops/pallas_hist.py).  0 = auto (measured default per chip class,
    # bench/segsweep.py); CUBURN_SORT_SEGMENTS env overrides.
    sort_segments: int = 0

    @property
    def total_iters(self) -> int:
        return self.quality * self.width * self.height


PROFILES: Dict[str, RenderProfile] = {
    "preview": RenderProfile(width=512, height=512, quality=50, ss=1),
    "512": RenderProfile(width=512, height=512, quality=200, ss=1),
    "720p": RenderProfile(width=1280, height=720, quality=500, ss=1),
    "1080p": RenderProfile(width=1920, height=1080, quality=1000, ss=2),
    "4k": RenderProfile(width=3840, height=2160, quality=1000, ss=2),
    # the binding benchmark config (BASELINE.md #4): quality 2000, 2x ss
    "quality2000": RenderProfile(width=1920, height=1080, quality=2000,
                                 ss=2),
}


def get_profile(name: str, **overrides) -> RenderProfile:
    if name not in PROFILES:
        raise ValueError(f"unknown profile {name!r}; have {sorted(PROFILES)}")
    p = PROFILES[name]
    return replace(p, **overrides) if overrides else p
