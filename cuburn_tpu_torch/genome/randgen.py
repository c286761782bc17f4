"""Seeded random genome generation — the flam3-genome workflow.

The reference ecosystem's flam3-genome tool produces random flames
(random xform count, contractive-ish affines, a small set of variations
per xform, random palette); cuburn consumed its output.  This is a
deterministic, renderable-by-construction equivalent: same seed, same
genome, every run.  Also the fuzz harness for the variation library
(tests/test_render.py::TestRandomGenomes renders a spread of seeds).
"""

from __future__ import annotations

import numpy as np

from cuburn_tpu_torch.genome.palette import builtin_palette
from cuburn_tpu_torch.genome.specs import Genome, XForm

# variations safe to throw together blindly: bounded or contractive
# enough that random weighted sums still form attractors
_SAFE_VARS = [
    "linear", "sinusoidal", "spherical", "swirl", "horseshoe", "polar",
    "heart", "disc", "spiral", "diamond", "ex", "julia", "bent",
    "waves", "fisheye", "eyefish", "bubble", "cylinder", "blob", "pdj",
    "fan2", "rings2", "perspective", "julian", "juliascope", "blur",
    "gaussian_blur", "popcorn2", "curl", "ngon", "tangent", "square",
    "cross", "waves2", "exp", "sin", "cos", "cell", "mobius",
]

_PARAM_RANGES = {
    "blob_low": (0.2, 0.7), "blob_high": (0.8, 1.2),
    "blob_waves": (2.0, 6.0),
    "pdj_a": (-2.0, 2.0), "pdj_b": (-2.0, 2.0),
    "pdj_c": (-2.0, 2.0), "pdj_d": (-2.0, 2.0),
    "fan2_x": (-1.0, 1.0), "fan2_y": (-1.0, 1.0),
    "rings2_val": (0.2, 1.0),
    "perspective_angle": (0.2, 0.8), "perspective_dist": (1.0, 3.0),
    "julian_power": (2.0, 6.0), "julian_dist": (0.5, 2.0),
    "juliascope_power": (2.0, 6.0), "juliascope_dist": (0.5, 2.0),
    "popcorn2_x": (-0.5, 0.5), "popcorn2_y": (-0.5, 0.5),
    "popcorn2_c": (0.5, 3.0),
    "curl_c1": (-1.0, 1.0), "curl_c2": (-0.5, 0.5),
    "ngon_sides": (3.0, 7.0), "ngon_power": (1.0, 3.0),
    "ngon_circle": (0.5, 1.5), "ngon_corners": (0.5, 2.0),
    "cell_size": (0.4, 1.2),
    "mobius_re_a": (0.5, 1.5), "mobius_im_a": (-0.3, 0.3),
    "mobius_re_b": (-0.3, 0.3), "mobius_im_b": (-0.3, 0.3),
    "mobius_re_c": (-0.3, 0.3), "mobius_im_c": (-0.3, 0.3),
    "mobius_re_d": (0.5, 1.5), "mobius_im_d": (-0.3, 0.3),
}


def _random_affine(rng) -> tuple:
    """Contractive-ish random affine: rotation x scale 0.25-0.85 plus
    a small shear, translation in the bi-unit square (the flam3-genome
    recipe keeps the IFS from escaping)."""
    ang = rng.uniform(0, 2 * np.pi)
    sx = rng.uniform(0.25, 0.85) * rng.choice([-1.0, 1.0])
    sy = rng.uniform(0.25, 0.85)
    shear = rng.uniform(-0.2, 0.2)
    ca, sa = np.cos(ang), np.sin(ang)
    a, b = sx * ca, sx * -sa + shear
    d, e = sy * sa, sy * ca
    c, f = rng.uniform(-0.9, 0.9), rng.uniform(-0.9, 0.9)
    return (a, b, c, d, e, f)


def random_genome(seed: int, size=(640, 640)) -> Genome:
    """Deterministic random genome (flam3-genome equivalent)."""
    rng = np.random.RandomState(0x5EED ^ (int(seed) & 0x7FFFFFFF))
    n = int(rng.randint(2, 5))
    from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS

    def pick_vars():
        k = int(rng.randint(1, 4))
        names = list(rng.choice(_SAFE_VARS, size=k, replace=False))
        total = rng.uniform(0.7, 1.1)
        raw = rng.uniform(0.2, 1.0, k)
        weights = raw / raw.sum() * total
        vars_ = {nm: float(w) for nm, w in zip(names, weights)}
        params = {}
        for nm in names:
            for attr, _d in VARIATION_PARAMS[nm]:
                lo, hi = _PARAM_RANGES.get(attr, (0.0, 1.0))
                params[attr] = float(rng.uniform(lo, hi))
        return vars_, params

    xforms = []
    for _ in range(n):
        vars_, params = pick_vars()
        xforms.append(XForm(
            weight=float(rng.uniform(0.3, 1.0)),
            color=float(rng.uniform(0, 1)),
            color_speed=float(rng.uniform(0.3, 0.8)),
            affine=_random_affine(rng),
            post=(_random_affine(rng) if rng.rand() < 0.2 else None),
            vars=vars_, params=params))

    final = None
    if rng.rand() < 0.3:
        vars_, params = pick_vars()
        final = XForm(color=float(rng.uniform(0, 1)),
                      color_speed=float(rng.uniform(0.0, 0.5)),
                      affine=_random_affine(rng),
                      vars=vars_, params=params)

    xaos = None
    if rng.rand() < 0.25:
        xaos = rng.uniform(0.1, 1.5, (n, n)).round(3).tolist()

    return Genome(
        xforms=xforms, final_xform=final, xaos=xaos,
        palettes=[(0.0, builtin_palette(int(rng.randint(0, 1 << 16))))],
        # ppu proportional to the nominal width so the framing is
        # resolution-independent (flam3-genome ties scale to size;
        # identical to before at the default 640)
        scale=float(rng.uniform(60, 140)) * size[0] / 640.0, size=size,
        brightness=4.0, gamma=4.0,
        name=f"random_{seed}")


# -- mutation / crossover (the rest of the flam3-genome workflow) -----------

def mutate(genome: Genome, seed: int, kind: str = None) -> Genome:
    """Deterministic mutation of a genome (flam3-genome's mutate modes).

    kinds: affine (jitter every coefficient), weights (reroll xform
    weights), colors (reroll color coordinates/speeds), palette (swap
    for another stand-in gradient), variation (add one random variation
    to one xform).  kind=None picks one from the seed."""
    import copy
    rng = np.random.RandomState(0xA117 ^ (int(seed) & 0x7FFFFFFF))
    kinds = ("affine", "weights", "colors", "palette", "variation")
    if kind is None:
        kind = kinds[int(rng.randint(len(kinds)))]
    if kind not in kinds:
        raise ValueError(f"unknown mutation kind {kind!r}; "
                         f"have {kinds}")
    out = copy.deepcopy(genome)
    out.name = f"{genome.name}:mut_{kind}_{seed}"
    if kind == "affine":
        from cuburn_tpu_torch.genome.spline import Spline
        for xf in out.xforms:
            jit = rng.uniform(-0.1, 0.1, 6)
            # offset every KNOT value so animated affines stay animated
            xf.affine = tuple(
                Spline([v for kt, kv in s.knots
                        for v in (float(kt), float(kv) + float(j))])
                if not s.is_constant else float(s(0.0)) + float(j)
                for s, j in zip(xf.affine, jit))
    elif kind == "weights":
        for xf in out.xforms:
            xf.weight = float(rng.uniform(0.2, 1.0))
    elif kind == "colors":
        for xf in out.xforms:
            xf.color = float(rng.uniform(0, 1))
            xf.color_speed = float(rng.uniform(0.2, 0.9))
    elif kind == "palette":
        out.palettes = [(0.0, builtin_palette(
            int(rng.randint(0, 1 << 16))))]
    elif kind == "variation":
        from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS
        # pick an xform that still has room; if every xform already
        # carries the whole safe set, degrade to an affine jitter
        # instead of crashing
        open_xfs = [x for x in out.xforms
                    if any(v not in x.vars for v in _SAFE_VARS)]
        if not open_xfs:
            return mutate(genome, seed, "affine")
        xf = open_xfs[int(rng.randint(len(open_xfs)))]
        name = str(rng.choice(
            [v for v in _SAFE_VARS if v not in xf.vars]))
        xf.vars = dict(xf.vars)
        xf.vars[name] = float(rng.uniform(0.2, 0.6))
        params = dict(xf.params)
        for attr, _d in VARIATION_PARAMS[name]:
            lo, hi = _PARAM_RANGES.get(attr, (0.0, 1.0))
            params[attr] = float(rng.uniform(lo, hi))
        xf.params = params
    # re-splinify every field touched with raw floats/tuples (and
    # re-validate new variation sets)
    for xf in out.xforms:
        xf.__post_init__()
    return out


def crossover(a: Genome, b: Genome, seed: int) -> Genome:
    """flam3-genome union crossover: each xform slot drawn from one
    parent at random; ALL camera/color/DE/filter state inherited intact
    from a random parent (not reset to defaults), palette from another
    random pick."""
    import copy
    rng = np.random.RandomState(0xC505 ^ (int(seed) & 0x7FFFFFFF))
    n = max(len(a.xforms), len(b.xforms))
    cam = a if rng.rand() < 0.5 else b
    pal = a if rng.rand() < 0.5 else b
    # start from a full copy of the camera parent so every genome-level
    # field (rotate, background, vibrancy, estimator_*, spatial filter,
    # temporal filter, time_range, ...) carries over
    out = copy.deepcopy(cam)
    out.xforms = []
    for i in range(n):
        pool = [g.xforms[i] for g in (a, b) if i < len(g.xforms)]
        out.xforms.append(copy.deepcopy(
            pool[int(rng.randint(len(pool)))]))
    out.final_xform = copy.deepcopy(
        (a if rng.rand() < 0.5 else b).final_xform)
    out.palettes = copy.deepcopy(pal.palettes)
    # the camera parent's xaos rows are sized for ITS xform count;
    # keep only when it still matches the child's
    if out.xaos is not None and len(out.xaos) != n:
        out.xaos = None
    out.name = f"{a.name}x{b.name}_{seed}"
    return out
