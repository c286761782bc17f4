"""Variation parameter schema: names, parametric knobs, flam3 defaults.

Equivalent of the reference's cuburn/genome/variations.py (SURVEY.md §2b):
one schema entry per flam3 variation, listing its extra scalar parameters
using flam3's XML attribute names, so genomes written for flam3/cuburn
parse unchanged.  The port's own copy of the JAX package's schema; the
device implementations live in cuburn_tpu_torch/ops/variations.py and
are keyed by the same names.

Defaults follow flam3's xform initialization.  SURVEY.md §2c is the
authoritative set list ([H] confidence); the reference mount was empty so
defaults carry [M] confidence and are unit-tested for self-consistency
rather than against reference source.
"""

from __future__ import annotations

from typing import Dict, Tuple

# name -> ordered tuple of (param_attribute_name, default)
# Non-parametric variations map to an empty tuple.
VARIATION_PARAMS: Dict[str, Tuple[Tuple[str, float], ...]] = {
    # -- simple (no extra params) ----------------------------------------
    "linear": (), "sinusoidal": (), "spherical": (), "swirl": (),
    "horseshoe": (), "polar": (), "handkerchief": (), "heart": (),
    "disc": (), "spiral": (), "hyperbolic": (), "diamond": (), "ex": (),
    "julia": (), "bent": (), "waves": (), "fisheye": (), "popcorn": (),
    "exponential": (), "power": (), "cosine": (), "rings": (), "fan": (),
    "eyefish": (), "bubble": (), "cylinder": (), "noise": (), "blur": (),
    "gaussian_blur": (), "arch": (), "tangent": (), "square": (),
    "rays": (), "blade": (), "secant2": (), "twintrian": (), "cross": (),
    "boarders": (), "butterfly": (), "edisc": (), "elliptic": (),
    "foci": (), "loonie": (), "pre_blur": (), "scry": (),
    "unpolar": (), "polar2": (),
    "exp": (), "log": (), "sin": (), "cos": (), "tan": (), "sec": (),
    "csc": (), "cot": (), "sinh": (), "cosh": (), "tanh": (),
    "sech": (), "csch": (), "coth": (),
    # -- parametric ------------------------------------------------------
    "oscilloscope": (("oscope_separation", 1.0), ("oscope_frequency", 3.141592653589793),
                     ("oscope_amplitude", 1.0), ("oscope_damping", 0.0)),
    "blob": (("blob_low", 0.5), ("blob_high", 1.0), ("blob_waves", 1.0)),
    "pdj": (("pdj_a", 0.0), ("pdj_b", 0.0), ("pdj_c", 0.0), ("pdj_d", 0.0)),
    "fan2": (("fan2_x", 0.0), ("fan2_y", 0.0)),
    "rings2": (("rings2_val", 0.0),),
    "perspective": (("perspective_angle", 0.0), ("perspective_dist", 0.0)),
    "julian": (("julian_power", 1.0), ("julian_dist", 1.0)),
    "juliascope": (("juliascope_power", 1.0), ("juliascope_dist", 1.0)),
    "radial_blur": (("radial_blur_angle", 0.0),),
    "pie": (("pie_slices", 6.0), ("pie_rotation", 0.0),
            ("pie_thickness", 0.5)),
    "ngon": (("ngon_sides", 5.0), ("ngon_power", 3.0),
             ("ngon_circle", 1.0), ("ngon_corners", 2.0)),
    "curl": (("curl_c1", 1.0), ("curl_c2", 0.0)),
    "rectangles": (("rectangles_x", 1.0), ("rectangles_y", 1.0)),
    "disc2": (("disc2_rot", 0.0), ("disc2_twist", 0.0)),
    "super_shape": (("super_shape_rnd", 0.0), ("super_shape_m", 0.0),
                    ("super_shape_n1", 1.0), ("super_shape_n2", 1.0),
                    ("super_shape_n3", 1.0), ("super_shape_holes", 0.0)),
    "flower": (("flower_petals", 0.0), ("flower_holes", 0.0)),
    "conic": (("conic_eccentricity", 1.0), ("conic_holes", 0.0)),
    "parabola": (("parabola_height", 0.0), ("parabola_width", 0.0)),
    "bent2": (("bent2_x", 1.0), ("bent2_y", 1.0)),
    "bipolar": (("bipolar_shift", 0.0),),
    "cell": (("cell_size", 1.0),),
    "cpow": (("cpow_r", 1.0), ("cpow_i", 0.0), ("cpow_power", 1.0)),
    "curve": (("curve_xamp", 0.0), ("curve_yamp", 0.0),
              ("curve_xlength", 1.0), ("curve_ylength", 1.0)),
    "escher": (("escher_beta", 0.0),),
    "lazysusan": (("lazysusan_spin", 0.0), ("lazysusan_space", 0.0),
                  ("lazysusan_twist", 0.0), ("lazysusan_x", 0.0),
                  ("lazysusan_y", 0.0)),
    "modulus": (("modulus_x", 0.0), ("modulus_y", 0.0)),
    "popcorn2": (("popcorn2_x", 0.0), ("popcorn2_y", 0.0),
                 ("popcorn2_c", 0.0)),
    "separation": (("separation_x", 0.0), ("separation_xinside", 0.0),
                   ("separation_y", 0.0), ("separation_yinside", 0.0)),
    "split": (("split_xsize", 0.0), ("split_ysize", 0.0)),
    "splits": (("splits_x", 0.0), ("splits_y", 0.0)),
    "stripes": (("stripes_space", 0.0), ("stripes_warp", 0.0)),
    "wedge": (("wedge_angle", 0.0), ("wedge_hole", 0.0),
              ("wedge_count", 1.0), ("wedge_swirl", 0.0)),
    "wedge_julia": (("wedge_julia_angle", 0.0), ("wedge_julia_count", 1.0),
                    ("wedge_julia_power", 1.0), ("wedge_julia_dist", 0.0)),
    "wedge_sph": (("wedge_sph_angle", 0.0), ("wedge_sph_count", 1.0),
                  ("wedge_sph_hole", 0.0), ("wedge_sph_swirl", 0.0)),
    "whorl": (("whorl_inside", 0.0), ("whorl_outside", 0.0)),
    "waves2": (("waves2_freqx", 0.0), ("waves2_scalex", 0.0),
               ("waves2_freqy", 0.0), ("waves2_scaley", 0.0)),
    "auger": (("auger_sym", 0.0), ("auger_weight", 0.5),
              ("auger_freq", 1.0), ("auger_scale", 1.0)),
    "flux": (("flux_spread", 0.0),),
    "mobius": (("mobius_re_a", 0.0), ("mobius_im_a", 0.0),
               ("mobius_re_b", 0.0), ("mobius_im_b", 0.0),
               ("mobius_re_c", 0.0), ("mobius_im_c", 0.0),
               ("mobius_re_d", 0.0), ("mobius_im_d", 0.0)),
}

ALL_VARIATIONS = tuple(sorted(VARIATION_PARAMS))

# Variations that consume RNG inside their body (SURVEY.md §2c: the RNG
# plumbing must reach variation bodies, not just xform selection).
STOCHASTIC_VARIATIONS = frozenset({
    "noise", "blur", "gaussian_blur", "radial_blur", "julia", "julian",
    "juliascope", "pie", "square", "arch", "rays", "blade", "twintrian",
    "super_shape", "wedge_julia", "cpow", "boarders", "pre_blur",
    "conic", "flower", "parabola",
})

# Variations whose formula reads the xform's own affine coefficients
# (SURVEY.md §2c: popcorn, rings, fan, waves use c/f of the affine).
AFFINE_DEPENDENT_VARIATIONS = frozenset({
    "popcorn", "rings", "fan", "waves",
})


def is_variation(name: str) -> bool:
    return name in VARIATION_PARAMS


# flat attr -> flam3 default, for O(1) fallback lookup (every attr name
# is globally unique across variations)
PARAM_DEFAULTS = {attr: default
                  for pairs in VARIATION_PARAMS.values()
                  for attr, default in pairs}
