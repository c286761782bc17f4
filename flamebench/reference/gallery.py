"""The gallery genomes the benchmark's configurations name, built from
the reference's own genome layer: a frozen copy of
`cuburn_tpu_torch/models/gallery.py`'s four BASELINE genomes.

These correspond to the binding benchmark configurations
(BASELINE.md / BASELINE.json `configs` 1-5):
  1. sierpinski       — 3-xform affine-only, 512^2, log tonemap
  2. classic_swirl    — classic variations + palette + gamma/vibrancy
  3. full_feature     — parametric variations + final xform + xaos
  4. (profile "quality2000" on any of the above adds DE + 2x ss)
  5. animated_spark   — spline-animated genome with motion blur
"""

from __future__ import annotations

import numpy as np

from flamebench.reference.specs import Genome, XForm


def _fire_palette() -> np.ndarray:
    """A 256-entry fire-like palette (black -> red -> yellow -> white)."""
    t = np.linspace(0.0, 1.0, 256)
    r = np.clip(t * 3.0, 0, 1)
    g = np.clip(t * 3.0 - 1.0, 0, 1)
    b = np.clip(t * 3.0 - 2.0, 0, 1)
    return np.stack([r, g, b], axis=1)


def _rainbow_palette() -> np.ndarray:
    t = np.linspace(0.0, 1.0, 256)
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (t + 0.00)),
        0.5 + 0.5 * np.sin(2 * np.pi * (t + 0.33)),
        0.5 + 0.5 * np.sin(2 * np.pi * (t + 0.67)),
    ], axis=1)


def sierpinski() -> Genome:
    """Benchmark config 1: 3-xform affine-only Sierpinski triangle."""
    corners = [(-1.0, -0.866), (1.0, -0.866), (0.0, 0.866)]
    xforms = [
        XForm(weight=1.0, color=i / 2.0, color_speed=0.5,
              affine=(0.5, 0.0, 0.5 * cx, 0.0, 0.5, 0.5 * cy),
              vars={"linear": 1.0})
        for i, (cx, cy) in enumerate(corners)
    ]
    return Genome(xforms=xforms, name="sierpinski",
                  center=(0.0, 0.0), scale=220.0, brightness=4.0,
                  gamma=4.0, estimator_radius=0.0, size=(512, 512),
                  palettes=[(0.0, _rainbow_palette())])


def classic_swirl() -> Genome:
    """Benchmark config 2: classic variations + palette colorization."""
    xforms = [
        XForm(weight=0.8, color=0.0,
              affine=(0.62, -0.4, 0.1, 0.4, 0.62, 0.1),
              vars={"spherical": 0.7, "linear": 0.3}),
        XForm(weight=0.6, color=0.45,
              affine=(0.55, 0.3, -0.4, -0.3, 0.55, 0.2),
              vars={"swirl": 0.8, "sinusoidal": 0.2}),
        XForm(weight=0.4, color=0.8,
              affine=(0.7, 0.0, 0.3, 0.0, 0.7, -0.3),
              vars={"horseshoe": 0.5, "julia": 0.5}),
    ]
    return Genome(xforms=xforms, name="classic_swirl",
                  center=(0.0, 0.0), scale=240.0, brightness=4.0,
                  gamma=4.0, vibrancy=1.0, size=(1280, 720),
                  palettes=[(0.0, _fire_palette())])


def full_feature() -> Genome:
    """Benchmark config 3: parametric variations, final xform, xaos."""
    xforms = [
        XForm(weight=1.0, color=0.1,
              affine=(0.6, 0.2, -0.3, -0.2, 0.6, 0.2),
              vars={"julian": 0.8, "linear": 0.2},
              params={"julian_power": 3.0, "julian_dist": 1.0}),
        XForm(weight=0.7, color=0.5,
              affine=(0.5, -0.35, 0.3, 0.35, 0.5, -0.2),
              vars={"pdj": 0.6, "spherical": 0.4},
              params={"pdj_a": 1.1, "pdj_b": -0.9, "pdj_c": 1.4,
                      "pdj_d": 0.8}),
        XForm(weight=0.5, color=0.9,
              affine=(0.8, 0.0, 0.0, 0.0, 0.8, 0.4),
              post=(0.9, 0.1, 0.0, -0.1, 0.9, 0.0),
              vars={"curl": 0.7, "blur": 0.05, "linear": 0.25},
              params={"curl_c1": 0.4, "curl_c2": 0.2}),
    ]
    xaos = [[1.0, 0.5, 1.5],
            [2.0, 1.0, 0.0],
            [1.0, 1.0, 1.0]]
    final = XForm(color=0.5, color_speed=0.1,
                  affine=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                  vars={"bubble": 0.8, "linear": 0.2})
    return Genome(xforms=xforms, final_xform=final, xaos=xaos,
                  name="full_feature", center=(0.0, 0.1), scale=260.0,
                  brightness=4.0, gamma=4.0, size=(1920, 1080),
                  palettes=[(0.0, _rainbow_palette())])


def animated_spark() -> Genome:
    """Benchmark config 5: spline-animated genome for motion blur."""
    xforms = [
        XForm(weight=1.0, color=[0.0, 0.0, 1.0, 0.6],
              affine=([0.0, 0.6, 1.0, 0.75], 0.2, -0.3,
                      -0.2, [0.0, 0.6, 1.0, 0.5], 0.2),
              vars={"spherical": 0.6,
                    "swirl": [0.0, 0.1, 1.0, 0.7]}),
        XForm(weight=0.8, color=0.7,
              affine=(0.5, [0.0, -0.4, 1.0, 0.4], 0.35,
                      [0.0, 0.4, 1.0, -0.4], 0.5, -0.25),
              vars={"linear": 0.4, "sinusoidal": 0.6}),
    ]
    return Genome(xforms=xforms, name="animated_spark",
                  center=(0.0, [0.0, -0.1, 1.0, 0.1]),
                  scale=[0.0, 200.0, 1.0, 260.0],
                  rotate=[0.0, 0.0, 1.0, 90.0],
                  brightness=4.0, gamma=4.0, size=(1280, 720),
                  palettes=[(0.0, _fire_palette()),
                            (1.0, _rainbow_palette())],
                  time_range=(0.0, 1.0))


GALLERY = {
    "sierpinski": sierpinski,
    "classic_swirl": classic_swirl,
    "full_feature": full_feature,
    "animated_spark": animated_spark,
}


def get_genome(name: str) -> Genome:
    if name not in GALLERY:
        raise ValueError(f"unknown genome {name!r}; have {sorted(GALLERY)}")
    return GALLERY[name]()
