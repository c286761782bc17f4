"""Genome schema: the flam3-compatible scene description.

A frozen copy of `cuburn_tpu_torch/genome/specs.py` without its JSON
serialization.

Equivalent of the reference's cuburn/genome/specs.py + use.py wrappers
(SURVEY.md §2b "Genome spec DSL"): a declarative schema of the whole
genome where every scalar is a time-varying Catmull-Rom spline.

The key architectural divergence from the reference (SURVEY.md §7): where
cuburn walks a genome and *generates CUDA source* for exactly the
variations it uses (cuburn/code/iter.py), this framework derives a static
`StructureKey` from the genome — the set of variations used anywhere,
plus has-post / has-final / has-xaos flags — and specializes one
program per key.  All *values* (weights, affines, variation parameters, palette,
camera) are runtime arrays packed into a `GenomeParams` record by
`Genome.eval_at(t)`, so animation and spline interpolation never
retrace or recompile.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flamebench.reference.spline import Spline, spline
from flamebench.reference.variation_params import (
    PARAM_DEFAULTS,
    VARIATION_PARAMS,
    is_variation,
)
from flamebench.reference import palette as palette_mod

IDENTITY_AFFINE = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _splinify_affine(coefs) -> Tuple[Spline, ...]:
    coefs = tuple(coefs)
    if len(coefs) != 6:
        raise ValueError(f"affine needs 6 coefficients, got {len(coefs)}")
    return tuple(spline(c) for c in coefs)


@dataclass
class XForm:
    """One transform of the IFS.

    Affine convention matches flam3 XML `coefs="a b c d e f"`:
        x' = a*x + b*y + c ;  y' = d*x + e*y + f
    """

    weight: Spline = field(default_factory=lambda: Spline(1.0))
    color: Spline = field(default_factory=lambda: Spline(0.0))
    color_speed: Spline = field(default_factory=lambda: Spline(0.5))
    opacity: Spline = field(default_factory=lambda: Spline(1.0))
    affine: Tuple[Spline, ...] = field(
        default_factory=lambda: _splinify_affine(IDENTITY_AFFINE))
    post: Optional[Tuple[Spline, ...]] = None
    # variation name -> weight spline
    vars: Dict[str, Spline] = field(default_factory=dict)
    # parametric knob attribute name (e.g. "julian_power") -> spline
    params: Dict[str, Spline] = field(default_factory=dict)
    animate: float = 0.0  # flam3 animate flag (used by blending)

    def __post_init__(self):
        self.weight = spline(self.weight)
        self.color = spline(self.color)
        self.color_speed = spline(self.color_speed)
        self.opacity = spline(self.opacity)
        self.affine = _splinify_affine(self.affine)
        if self.post is not None:
            self.post = _splinify_affine(self.post)
        for name in self.vars:
            if not is_variation(name):
                raise ValueError(f"unknown variation {name!r}")
        self.vars = {k: spline(v) for k, v in self.vars.items()}
        for attr in self.params:
            if attr not in PARAM_DEFAULTS:
                raise ValueError(
                    f"unknown variation parameter {attr!r}")
        self.params = {k: spline(v) for k, v in self.params.items()}

    def param(self, attr: str, t: float) -> float:
        """Evaluate a parametric knob at time t, falling back to its
        flam3 default."""
        if attr in self.params:
            return self.params[attr](t)
        return PARAM_DEFAULTS[attr]


# --------------------------------------------------------------------------
# Structure key: the static shape of the compiled program.
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StructureKey:
    """Everything a compiled program treats as static about a genome.

    Two genomes with equal StructureKeys share one compiled pipeline;
    their differing parameter *values* flow in as arrays.  This replaces
    the reference's per-genome CUDA codegen (cuburn/code/iter.py
    IterCode) with trace-time specialization (SURVEY.md §7).
    """

    n_xforms: int
    variations: Tuple[str, ...]          # sorted union over normal xforms
    has_post: bool
    has_xaos: bool
    final_variations: Optional[Tuple[str, ...]]  # None = no final xform
    final_has_post: bool
    # Apophysis-7X 3-D camera (ops/camera.py project_3d): 0 = all five
    # cam_* splines identically zero (the transform is statically
    # elided), 1 = yaw/pitch/perspective/zpos in play, 2 = additionally
    # cam_dof (the projection consumes two RNG draws per point)
    cam_mode: int = 0

    @property
    def param_slots(self) -> Tuple[Tuple[str, str], ...]:
        """Deterministic packing of parametric knobs: ordered
        (variation, attr) slots for the union variation set."""
        return variation_param_slots(self.variations)

    @property
    def final_param_slots(self) -> Tuple[Tuple[str, str], ...]:
        if self.final_variations is None:
            return ()
        return variation_param_slots(self.final_variations)


def variation_param_slots(variations: Sequence[str]):
    slots = []
    for v in variations:
        for attr, _default in VARIATION_PARAMS[v]:
            slots.append((v, attr))
    return tuple(slots)


# --------------------------------------------------------------------------
# GenomeParams: the runtime values consumed by the device pipeline.
# --------------------------------------------------------------------------

@dataclass
class GenomeParams:
    """All animated genome values evaluated at one instant, as arrays.

    This is the equivalent of the reference's packed per-temporal-sample
    parameter array filled by the GPU interp kernels (cuburn/code/interp.py
    GenomePacker, SURVEY.md §2b) — except here it is an ordinary
    dataclass of arrays (`params.params_from_genome` moves it onto a
    device as tensors).

    Shapes (N = n_xforms, V = len(key.variations), P = len(param_slots)):
      weights (N,), xaos (N, N), affine (N, 6), post (N, 6),
      color (N,), color_speed (N,), opacity (N,),
      var_weights (N, V), var_params (N, P),
      final_* analogous with leading dim dropped,
      palette (256, 3), plus camera / tonemap / DE scalars.
    """

    weights: np.ndarray
    xaos: np.ndarray
    affine: np.ndarray
    post: np.ndarray
    color: np.ndarray
    color_speed: np.ndarray
    opacity: np.ndarray
    var_weights: np.ndarray
    var_params: np.ndarray
    final_affine: np.ndarray
    final_post: np.ndarray
    final_color: np.ndarray
    final_color_speed: np.ndarray
    final_var_weights: np.ndarray
    final_var_params: np.ndarray
    palette: np.ndarray
    center: np.ndarray        # (2,)
    rot_center: np.ndarray    # (2,) rotation pivot (flam3 rot_center)
    ppu: np.ndarray           # pixels per world unit, scalar
    rotate: np.ndarray        # degrees, scalar
    brightness: np.ndarray
    gamma: np.ndarray
    gamma_threshold: np.ndarray
    vibrancy: np.ndarray
    highlight_power: np.ndarray
    background: np.ndarray    # (3,)
    estimator_radius: np.ndarray
    estimator_minimum: np.ndarray
    estimator_curve: np.ndarray
    spatial_filter: np.ndarray
    # (5,) [cam_yaw, cam_pitch, cam_perspective, cam_zpos, cam_dof]
    # (radians / world units; ops/camera.py project_3d)
    cam3d: np.ndarray




# --------------------------------------------------------------------------
# Genome
# --------------------------------------------------------------------------

@dataclass
class Genome:
    xforms: List[XForm] = field(default_factory=list)
    final_xform: Optional[XForm] = None
    # xaos[i][j]: multiplier on the probability of choosing xform j when
    # the previous xform was i (flam3 per-xform `chaos` rows).
    xaos: Optional[List[List[Spline]]] = None
    # palette keyframes: list of (time, (256,3) float array in [0,1]).
    palettes: List[Tuple[float, np.ndarray]] = field(default_factory=list)
    center: Tuple[Spline, Spline] = None
    # flam3 `rot_center`: the point the camera rotation pivots on;
    # None = pivot on `center` (flam3's own default)
    rot_center: Optional[Tuple[Spline, Spline]] = None
    scale: Spline = None            # pixels per unit (flam3 `scale`)
    # flam3 `zoom`: effective ppu = scale * 2^zoom (flam3 rect.c;
    # flam3 also scales sample density by 4^zoom to hold noise
    # constant — here the quality budget is profile-driven, so only
    # the geometric part applies)
    zoom: Spline = None
    # Apophysis-7X 3-D camera (cam_yaw/cam_pitch in radians;
    # ops/camera.py project_3d documents the published algorithm)
    cam_yaw: Spline = None
    cam_pitch: Spline = None
    cam_perspective: Spline = None
    cam_zpos: Spline = None
    cam_dof: Spline = None
    rotate: Spline = None           # degrees
    brightness: Spline = None
    gamma: Spline = None
    gamma_threshold: Spline = None
    vibrancy: Spline = None
    highlight_power: Spline = None
    background: Tuple[Spline, Spline, Spline] = None
    estimator_radius: Spline = None
    estimator_minimum: Spline = None
    estimator_curve: Spline = None
    # flam3 `filter`: spatial filter radius for the supersample
    # reduction (0 = box average)
    spatial_filter: Spline = None
    # flam3 `filter_shape`: spatial filter kernel family
    # (gaussian | box | triangle | hermite | mitchell | ...)
    spatial_filter_shape: str = "gaussian"
    # flam3 temporal filter: how temporal samples across the shutter
    # are weighted (box | gaussian | exp) with width/exp knobs
    temporal_filter_type: str = "box"
    temporal_filter_width: Spline = None
    temporal_filter_exp: Spline = None
    size: Tuple[int, int] = (640, 480)   # nominal size `scale` refers to
    name: str = "untitled"
    time_range: Tuple[float, float] = (0.0, 1.0)
    # flam3 <flame time="..."> keyframe position within a multi-flame
    # sequence (None = use list order; see blend.blend_sequence)
    flame_time: Optional[float] = None
    # flam3 <flame interpolation="linear|smooth">: smooth pulls
    # Catmull-Rom tangents from neighboring keyframes in sequences
    interpolation: str = "linear"
    # flam3 `earlyclip`: the pre-2008 pipeline order — gamma/clip each
    # supersampled accumulator bucket AFTER density estimation but
    # BEFORE the spatial filter, instead of clipping filtered output
    # pixels (flam3 rect.c: the earlyclip block runs over `accumulate`
    # ahead of the filtered decimation; the final loop then only
    # clips).  Static flag: changes filter-program structure, never a
    # traced value.
    earlyclip: bool = False

    def __post_init__(self):
        defaults = {
            "center": (0.0, 0.0), "scale": 100.0, "zoom": 0.0,
            "rotate": 0.0,
            "brightness": 4.0, "gamma": 4.0, "gamma_threshold": 0.01,
            "vibrancy": 1.0, "highlight_power": -1.0,
            "background": (0.0, 0.0, 0.0),
            "estimator_radius": 9.0, "estimator_minimum": 0.0,
            "estimator_curve": 0.4,
            "spatial_filter": 0.5,
            "temporal_filter_width": 1.0,
            "temporal_filter_exp": 0.0,
            "cam_yaw": 0.0, "cam_pitch": 0.0, "cam_perspective": 0.0,
            "cam_zpos": 0.0, "cam_dof": 0.0,
        }
        for name, dflt in defaults.items():
            cur = getattr(self, name)
            if cur is None:
                cur = dflt
            if isinstance(dflt, tuple):
                # any sequence counts as per-component values — an
                # np.ndarray center=(x, y) must NOT fall through to
                # the broadcast branch, where Spline would read the
                # 1-D vector as a flat (t, v) knot list and silently
                # collapse both coordinates to one constant
                if isinstance(cur, (tuple, list, np.ndarray)):
                    cur = tuple(cur)
                else:
                    cur = tuple([cur] * len(dflt))
                setattr(self, name, tuple(spline(c) for c in cur))
            else:
                setattr(self, name, spline(cur))
        if self.rot_center is not None:
            self.rot_center = tuple(spline(c)
                                    for c in tuple(self.rot_center))
        if not self.xforms:
            raise ValueError(
                "a genome needs at least one xform (flam3 rule)")
        if self.xaos is not None:
            n = len(self.xforms)
            if len(self.xaos) != n or any(len(r) != n for r in self.xaos):
                raise ValueError("xaos must be n_xforms x n_xforms")
            self.xaos = [[spline(v) for v in row] for row in self.xaos]
        if not self.palettes:
            # default grayscale ramp
            ramp = np.repeat(np.linspace(0, 1, 256)[:, None], 3, axis=1)
            self.palettes = [(0.0, ramp)]
        self.palettes = [
            (float(t), np.asarray(p, dtype=np.float64).reshape(256, 3))
            for t, p in sorted(self.palettes, key=lambda tp: tp[0])
        ]

    # -- static structure ------------------------------------------------

    def structure_key(self) -> StructureKey:
        union = set()
        for xf in self.xforms:
            # an xform with EMPTY vars is an implicit linear map (the
            # same rule eval_at applies to vars-less final xforms)
            union.update(xf.vars or {"linear"})
        if not union:
            union = {"linear"}
        fx = self.final_xform

        def live(s: Spline) -> bool:
            return bool(np.any(s.knots[:, 1] != 0.0))

        cam_mode = 0
        if any(live(s) for s in (self.cam_yaw, self.cam_pitch,
                                 self.cam_perspective, self.cam_zpos,
                                 self.cam_dof)):
            cam_mode = 2 if live(self.cam_dof) else 1
        return StructureKey(
            n_xforms=len(self.xforms),
            variations=tuple(sorted(union)),
            has_post=any(xf.post is not None for xf in self.xforms),
            has_xaos=self.xaos is not None,
            final_variations=(None if fx is None
                              else tuple(sorted(fx.vars or {"linear"}))),
            final_has_post=fx is not None and fx.post is not None,
            cam_mode=cam_mode,
        )

    # -- evaluation ------------------------------------------------------

    def eval_at(self, t: float) -> GenomeParams:
        """Evaluate every spline at time t into a GenomeParams record."""
        key = self.structure_key()
        n = len(self.xforms)
        f32 = np.float32

        def affine_row(coefs):
            return np.array([s(t) for s in coefs], dtype=f32)

        weights = np.array([xf.weight(t) for xf in self.xforms], dtype=f32)
        affine = np.stack([affine_row(xf.affine) for xf in self.xforms])
        post = np.stack([
            affine_row(xf.post) if xf.post is not None
            else np.array(IDENTITY_AFFINE, dtype=f32)
            for xf in self.xforms])
        color = np.array([xf.color(t) for xf in self.xforms], dtype=f32)
        speed = np.array([xf.color_speed(t) for xf in self.xforms], dtype=f32)
        opacity = np.array([xf.opacity(t) for xf in self.xforms], dtype=f32)

        V = len(key.variations)
        var_weights = np.zeros((n, V), dtype=f32)
        for i, xf in enumerate(self.xforms):
            if not xf.vars:
                # implicit linear (see structure_key): without this
                # the row is all-zero and the xform collapses every
                # point to its post-affine origin
                var_weights[i, key.variations.index("linear")] = 1.0
                continue
            for j, vname in enumerate(key.variations):
                if vname in xf.vars:
                    var_weights[i, j] = xf.vars[vname](t)

        slots = key.param_slots
        var_params = np.zeros((n, max(len(slots), 1)), dtype=f32)
        for i, xf in enumerate(self.xforms):
            for p, (vname, attr) in enumerate(slots):
                var_params[i, p] = xf.param(attr, t)

        if self.xaos is not None:
            xaos = np.array([[v(t) for v in row] for row in self.xaos],
                            dtype=f32)
        else:
            xaos = np.ones((n, n), dtype=f32)

        # final xform (display-only)
        fx = self.final_xform
        if fx is not None:
            fkey_vars = key.final_variations
            f_affine = affine_row(fx.affine)
            f_post = (affine_row(fx.post) if fx.post is not None
                      else np.array(IDENTITY_AFFINE, dtype=f32))
            f_vw = np.array(
                [fx.vars[v](t) if v in fx.vars else
                 (1.0 if (not fx.vars and v == "linear") else 0.0)
                 for v in fkey_vars], dtype=f32)
            fslots = key.final_param_slots
            f_vp = np.zeros((max(len(fslots), 1),), dtype=f32)
            for p, (vname, attr) in enumerate(fslots):
                f_vp[p] = fx.param(attr, t)
            f_color = np.array(fx.color(t), dtype=f32)
            f_speed = np.array(fx.color_speed(t), dtype=f32)
        else:
            f_affine = np.array(IDENTITY_AFFINE, dtype=f32)
            f_post = np.array(IDENTITY_AFFINE, dtype=f32)
            f_vw = np.zeros((1,), dtype=f32)
            f_vp = np.zeros((1,), dtype=f32)
            f_color = np.array(0.0, dtype=f32)
            f_speed = np.array(0.0, dtype=f32)

        return GenomeParams(
            weights=weights, xaos=xaos, affine=affine, post=post,
            color=color, color_speed=speed, opacity=opacity,
            var_weights=var_weights, var_params=var_params,
            final_affine=f_affine, final_post=f_post,
            final_color=f_color, final_color_speed=f_speed,
            final_var_weights=f_vw, final_var_params=f_vp,
            palette=palette_mod.palette_at(self.palettes, t).astype(f32),
            center=np.array([self.center[0](t), self.center[1](t)], dtype=f32),
            rot_center=np.array(
                [(self.rot_center or self.center)[0](t),
                 (self.rot_center or self.center)[1](t)], dtype=f32),
            ppu=np.array(self.scale(t) * 2.0 ** self.zoom(t),
                         dtype=f32),
            rotate=np.array(self.rotate(t), dtype=f32),
            brightness=np.array(self.brightness(t), dtype=f32),
            gamma=np.array(self.gamma(t), dtype=f32),
            gamma_threshold=np.array(self.gamma_threshold(t), dtype=f32),
            vibrancy=np.array(self.vibrancy(t), dtype=f32),
            highlight_power=np.array(self.highlight_power(t), dtype=f32),
            background=np.array([s(t) for s in self.background], dtype=f32),
            estimator_radius=np.array(self.estimator_radius(t), dtype=f32),
            estimator_minimum=np.array(self.estimator_minimum(t), dtype=f32),
            estimator_curve=np.array(self.estimator_curve(t), dtype=f32),
            spatial_filter=np.array(self.spatial_filter(t), dtype=f32),
            cam3d=np.array([self.cam_yaw(t), self.cam_pitch(t),
                            self.cam_perspective(t), self.cam_zpos(t),
                            self.cam_dof(t)], dtype=f32),
        )
