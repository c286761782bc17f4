"""flam3 XML <-> Genome conversion.

Equivalent of the reference's cuburn/genome/convert.py (SURVEY.md §2b,
§3.3): parse `<flame>` elements (coefs, post, chaos rows, color /
symmetry, variation attributes, parametric knobs, palette hex blocks or
`<color>` entries) into the schema of specs.py, entirely host-side.

flam3 attribute conventions honored here:
  * `coefs="A B C D E F"` is stored column-wise in flam3 (c[i][j]); with
    our convention x' = a*x + b*y + c, y' = d*x + e*y + f, the attribute
    order maps as a=A, d=B, b=C, e=D, c=E, f=F.  Same for `post`.
  * `symmetry` (legacy) maps to color_speed = (1 - symmetry) / 2; an
    explicit `color_speed` attribute wins.
  * `chaos="..."` rows are right-padded with 1.0 (flam3 default).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from cuburn_tpu_torch.genome import palette as palette_mod
from cuburn_tpu_torch.genome.specs import Genome, XForm, IDENTITY_AFFINE
from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS, is_variation

# flam3 xform attributes that are not variation names
_XFORM_META_ATTRS = {
    "weight", "color", "color_speed", "symmetry", "opacity", "coefs",
    "post", "chaos", "animate", "var", "var1", "name", "plotmode",
    "motion_frequency", "motion_function",
}

_FLAME_SCALAR_ATTRS = {
    "brightness": 4.0, "gamma": 4.0, "gamma_threshold": 0.01,
    "vibrancy": 1.0, "highlight_power": -1.0,
    "estimator_radius": 9.0, "estimator_minimum": 0.0,
    "estimator_curve": 0.4, "scale": 100.0, "zoom": 0.0,
    "rotate": 0.0,
    "filter": 0.5, "temporal_filter_width": 1.0,
    "temporal_filter_exp": 0.0,
}

_ALL_PARAM_ATTRS = {
    attr for pairs in VARIATION_PARAMS.values() for attr, _ in pairs
}


def _parse_floats(s: str) -> List[float]:
    return [float(x) for x in s.replace(",", " ").split()]


# -- flam3 <motion> elements -------------------------------------------------
# flam3's periodic per-xform animation (flam3.c motion_funcs /
# apply_motion_parameters): each <motion> child carries a frequency, a
# waveform, and amplitude attributes; the animated value is
#     base + sum_m amp_m * func_m(freq_m * t)
# with t in loop periods.  All waveforms are 0 at integral t (except
# hill, which is flam3's raised-cosine) and peak at |1|.  We lower each
# affected attribute to a DENSELY SAMPLED spline over one period, so
# motion flows through every downstream path (host eval, device
# packed-knot interp, JSON round-trip) as ordinary knots.

def _motion_func(name: str):
    if name in ("sin", "0", ""):
        return lambda tv: np.sin(2.0 * np.pi * tv)
    if name in ("triangle", "1"):
        def tri(tv):
            fr = np.mod(tv, 1.0)
            return np.where(fr <= 0.25, 4.0 * fr,
                            np.where(fr <= 0.75, -4.0 * fr + 2.0,
                                     4.0 * fr - 4.0))
        return tri
    if name in ("hill", "2"):
        return lambda tv: (1.0 - np.cos(2.0 * np.pi * tv)) * 0.5
    raise ValueError(f"unknown motion_function {name!r}")


_MOTION_SAMPLES_PER_CYCLE = 32


def _apply_motion(motions, attr_amp, base):
    """Lower (base value + motion offsets) to a flat knot list.

    motions: list of (freq, func) per <motion> element;
    attr_amp: per-element amplitude for this attribute (0 if absent).
    """
    active = [(f, fn, a) for (f, fn), a in zip(motions, attr_amp)
              if a != 0.0]
    if not active:
        return base
    max_freq = max(abs(f) for f, _fn, _a in active)
    n = _MOTION_SAMPLES_PER_CYCLE * max(int(np.ceil(max_freq)), 1) + 1
    ts = np.linspace(0.0, 1.0, n)
    vals = np.full(n, float(base))
    for f, fn, a in active:
        vals = vals + a * fn(f * ts)
    return [x for tv in zip(ts, vals) for x in tv]


def _parse_affine(attr: str):
    v = _parse_floats(attr)
    if len(v) != 6:
        raise ValueError(f"coefs needs 6 values, got {len(v)}")
    A, B, C, D, E, F = v
    # flam3 order: a d b e c f  (see module docstring)
    return (A, C, E, B, D, F)


def _parse_xform(el: ET.Element, n_xforms: int):
    attrs = dict(el.attrib)
    mels = el.findall("motion")
    motions = [(float(m.get("motion_frequency", 1.0)),
                _motion_func(m.get("motion_function", "sin")))
               for m in mels]

    def amps(attr, idx=None):
        out = []
        for m in mels:
            if attr in m.attrib:
                v = m.attrib[attr]
                out.append(_parse_floats(v)[idx]
                           if idx is not None else float(v))
            else:
                out.append(0.0)
        return out

    def mo(attr, base, idx=None):
        """Attribute value with motion offsets lowered to knots."""
        if not mels:
            return base
        return _apply_motion(motions, amps(attr, idx), base)

    vars_, params = {}, {}
    for k, val in attrs.items():
        if k in _XFORM_META_ATTRS:
            continue
        if is_variation(k):
            vars_[k] = mo(k, float(val))
        elif k in _ALL_PARAM_ATTRS:
            params[k] = mo(k, float(val))
        # unknown attributes are ignored (forward compat, like flam3)
    # motion may animate variations/params absent from the parent
    # (base 0 / flam3 default), flam3 apply_motion_parameters style
    for m in mels:
        for k in m.attrib:
            if is_variation(k) and k not in vars_:
                vars_[k] = mo(k, 0.0)
            elif k in _ALL_PARAM_ATTRS and k not in params:
                for pairs in VARIATION_PARAMS.values():
                    for name, default in pairs:
                        if name == k:
                            params[k] = mo(k, default)

    if "color_speed" in attrs:
        speed = float(attrs["color_speed"])
    elif "symmetry" in attrs:
        speed = (1.0 - float(attrs["symmetry"])) / 2.0
    else:
        speed = 0.5

    base_affine = (_parse_affine(attrs["coefs"]) if "coefs" in attrs
                   else IDENTITY_AFFINE)
    if any("coefs" in m.attrib for m in mels):
        # flam3 attr order A B C D E F maps to our (a,b,c,d,e,f) via
        # indices (0,2,4,1,3,5) — see _parse_affine
        affine = tuple(
            mo("coefs", base_affine[j], idx=(0, 2, 4, 1, 3, 5)[j])
            for j in range(6))
    else:
        affine = base_affine
    post = None
    if "post" in attrs or any("post" in m.attrib for m in mels):
        base_post = (_parse_affine(attrs["post"]) if "post" in attrs
                     else IDENTITY_AFFINE)
        if any("post" in m.attrib for m in mels):
            post = tuple(
                mo("post", base_post[j], idx=(0, 2, 4, 1, 3, 5)[j])
                for j in range(6))
        else:
            post = base_post

    xf = XForm(
        weight=mo("weight", float(attrs.get("weight", 1.0))),
        # legacy flam3 files can carry two values (color="c1 c2");
        # flam3's sscanf reads the first, so do we
        color=mo("color",
                 _parse_floats(attrs["color"])[0]
                 if "color" in attrs else 0.0),
        color_speed=speed,
        opacity=mo("opacity", float(attrs.get("opacity", 1.0))),
        affine=affine,
        post=post,
        vars=vars_,
        params=params,
        animate=float(attrs.get("animate", 0.0)),
    )
    chaos = None
    if "chaos" in attrs:
        row = _parse_floats(attrs["chaos"])
        chaos = (row + [1.0] * n_xforms)[:n_xforms]
    return xf, chaos


def _symmetry_xforms(kind: int) -> List[XForm]:
    """flam3's flam3_add_symmetry (flam3.c) lowered to explicit xforms.

    kind > 1: rotational symmetry — kind-1 linear xforms rotating by
    2*pi*i/kind.  kind < 0: dihedral — one mirror xform (x -> -x) plus
    |kind|-1 rotations.  All added xforms: weight 1, color_speed 0
    (so they never disturb the color coordinate), linear variation
    only, not animated.  Colors follow flam3's spread: rotations get
    (i-1)/(sym-2) for sym >= 3 else 0, the mirror gets 1.0.
    [M — reconstructed from flam3's published source; the reference
    mount is empty (SURVEY.md §0), so the exact color constants and
    xform count for the dihedral case are recalled, not re-verified.]
    """
    out: List[XForm] = []

    def sym_xf(affine, color):
        return XForm(weight=1.0, color=color, color_speed=0.0,
                     affine=affine, vars={"linear": 1.0})

    n = kind
    if kind < 0:
        out.append(sym_xf((-1.0, 0.0, 0.0, 0.0, 1.0, 0.0), 1.0))
        n = -kind
    for i in range(1, n):
        a = 2.0 * np.pi * i / n
        c = (0.0 if n < 3 else (i - 1.0) / (n - 2.0))
        out.append(sym_xf((np.cos(a), -np.sin(a), 0.0,
                           np.sin(a), np.cos(a), 0.0), c))
    return out


def flame_to_genome(flame: ET.Element,
                    angle_units: str = "") -> Genome:
    """Convert one parsed <flame> element to a Genome.

    angle_units: "" (honor cam_angle_units attr / magnitude
    heuristic), "degrees", or "radians" — how to read
    cam_yaw/cam_pitch (CLI --cam-angle-units)."""
    attrs = dict(flame.attrib)
    xform_els = flame.findall("xform")
    n = len(xform_els)

    xforms, chaos_rows = [], []
    for el in xform_els:
        xf, chaos = _parse_xform(el, n)
        xforms.append(xf)
        chaos_rows.append(chaos)

    # <symmetry kind="N"/>: lower to explicit linear xforms appended
    # after the parsed ones (flam3_add_symmetry).  kind 0 asks flam3
    # for a RANDOM symmetry; stay deterministic and skip it.
    sel = flame.find("symmetry")
    if sel is not None:
        kind = int(float(sel.get("kind", "0")))
        if kind in (0, 1):
            if kind == 0:
                import warnings
                warnings.warn("<symmetry kind=\"0\"> requests a random "
                              "symmetry; ignored for determinism")
        else:
            added = _symmetry_xforms(kind)
            xforms.extend(added)
            chaos_rows.extend([None] * len(added))
            n = len(xforms)

    xaos = None
    if any(c is not None for c in chaos_rows):
        # chaos rows were written against the pre-symmetry xform count;
        # flam3 pads missing entries (and whole missing rows) with 1.0
        xaos = [(c + [1.0] * n)[:n] if c is not None else [1.0] * n
                for c in chaos_rows]

    final = None
    fel = flame.find("finalxform")
    if fel is not None:
        final, _ = _parse_xform(fel, n)

    # palette: <palette> hex block, Apophysis <colors count data>,
    # <color index rgb> entries, or a legacy palette="N" index
    pal = None
    pel = flame.find("palette")
    cel_blk = flame.find("colors")
    if pel is not None and pel.text:
        pal = palette_mod.decode_hex_block(
            pel.text, int(pel.get("count", palette_mod.PALETTE_SIZE)))
    elif cel_blk is not None and cel_blk.get("data"):
        # Apophysis-style: hex entries in a `data` attribute (8 chars
        # per entry, leading alpha byte)
        pal = palette_mod.decode_hex_block(
            cel_blk.get("data"),
            int(cel_blk.get("count", palette_mod.PALETTE_SIZE)))
    else:
        colors = flame.findall("color")
        if colors:
            pal = np.zeros((palette_mod.PALETTE_SIZE, 3))
            for cel in colors:
                idx = int(cel.get("index", 0))
                if "rgb" in cel.attrib:
                    rgb = _parse_floats(cel.get("rgb"))
                    pal[idx] = [c / 255.0 for c in rgb]
        elif "palette" in attrs:
            # legacy numeric gradient reference; the real flam3
            # palettes.xml data is unavailable offline — substitute a
            # deterministic smooth palette so the file still renders
            import warnings
            idx = int(float(attrs["palette"]))
            warnings.warn(
                f"flame references built-in palette {idx}; flam3's "
                "palettes.xml is not available — using a deterministic "
                "stand-in gradient (colors will differ from flam3)")
            pal = palette_mod.builtin_palette(idx)
    palettes = [(0.0, pal)] if pal is not None else []

    size = tuple(int(x) for x in
                 _parse_floats(attrs.get("size", "640 480")))[:2]
    center = tuple(_parse_floats(attrs.get("center", "0 0")))[:2]
    rot_center = (tuple(_parse_floats(attrs["rot_center"]))[:2]
                  if "rot_center" in attrs else None)
    # flam3's pre-2008 pipeline order: gamma/clip each accumulator
    # bucket after DE but BEFORE the spatial filter (flam3 rect.c
    # earlyclip block; render._filter_frame implements both orders).
    # Parse TOLERANTLY: editors write "1"/"yes"/"true"; the attr being
    # present and not an explicit negative means set (float() on
    # "yes" raised — round-4 advisor finding).
    _ec_raw = str(attrs.get("earlyclip", "0")).strip().lower()
    if _ec_raw in ("", "0", "no", "false", "off"):
        earlyclip = False
    else:
        try:
            earlyclip = bool(float(_ec_raw))
        except ValueError:
            earlyclip = True
    # Apophysis-7X 3-D camera attrs (cam_persp is the Apophysis
    # spelling, cam_perspective the Ember/fractorium one).  Angles are
    # taken as RADIANS — the Ember XML convention; editors that write
    # degrees exist, but radians is the convention the published
    # renderer implementations consume directly (ops/camera.py
    # project_3d documents the algorithm).  An explicit
    # cam_angle_units attr ("degrees"/"radians") or the angle_units=
    # argument (CLI --cam-angle-units) overrides; with neither, a
    # magnitude heuristic WARNS when |yaw| or |pitch| > 2π — no
    # radian camera exceeds a full turn, so such values are almost
    # certainly Apophysis-style degrees and would render garbage
    # silently otherwise.
    cam_yaw = float(attrs.get("cam_yaw", 0.0))
    cam_pitch = float(attrs.get("cam_pitch", 0.0))
    units = (angle_units or attrs.get("cam_angle_units", "")).lower()
    if units.startswith("deg"):
        cam_yaw = math.radians(cam_yaw)
        cam_pitch = math.radians(cam_pitch)
    elif not units.startswith("rad"):
        if max(abs(cam_yaw), abs(cam_pitch)) > 2 * math.pi:
            import warnings
            warnings.warn(
                f"cam_yaw={cam_yaw:g} / cam_pitch={cam_pitch:g} "
                "exceed 2*pi and are being read as RADIANS; if this "
                "file came from an Apophysis-lineage editor they are "
                "probably DEGREES — set cam_angle_units=\"degrees\" "
                "in the XML or pass --cam-angle-units degrees")
    cam_persp = float(attrs.get("cam_perspective",
                                attrs.get("cam_persp", 0.0)))
    cam_zpos = float(attrs.get("cam_zpos", 0.0))
    cam_dof = float(attrs.get("cam_dof", 0.0))
    background = tuple(
        _parse_floats(attrs.get("background", "0 0 0")))[:3]
    scalars = {k: float(attrs.get(k, d))
               for k, d in _FLAME_SCALAR_ATTRS.items()}

    return Genome(
        xforms=xforms, final_xform=final, xaos=xaos, palettes=palettes,
        center=center, rot_center=rot_center,
        scale=scalars["scale"], zoom=scalars["zoom"],
        rotate=scalars["rotate"],
        cam_yaw=cam_yaw, cam_pitch=cam_pitch,
        cam_perspective=cam_persp, cam_zpos=cam_zpos, cam_dof=cam_dof,
        brightness=scalars["brightness"], gamma=scalars["gamma"],
        gamma_threshold=scalars["gamma_threshold"],
        vibrancy=scalars["vibrancy"],
        highlight_power=scalars["highlight_power"],
        background=background,
        estimator_radius=scalars["estimator_radius"],
        estimator_minimum=scalars["estimator_minimum"],
        estimator_curve=scalars["estimator_curve"],
        spatial_filter=scalars["filter"],
        spatial_filter_shape=attrs.get("filter_shape", "gaussian"),
        temporal_filter_type=attrs.get("temporal_filter_type", "box"),
        temporal_filter_width=scalars["temporal_filter_width"],
        temporal_filter_exp=scalars["temporal_filter_exp"],
        size=size, name=attrs.get("name", "untitled"),
        flame_time=(float(attrs["time"]) if "time" in attrs else None),
        interpolation=attrs.get("interpolation", "linear"),
        earlyclip=earlyclip,
    )


def parse_flam3(text: str, angle_units: str = "") -> List[Genome]:
    """Parse a flam3 XML document (one or more <flame> elements)."""
    text = text.strip()
    root = ET.fromstring(text)
    if root.tag == "flame":
        return [flame_to_genome(root, angle_units=angle_units)]
    return [flame_to_genome(f, angle_units=angle_units)
            for f in root.iter("flame")]


def load_genomes(path: str, angle_units: str = "") -> List[Genome]:
    """Load genomes from a file: flam3 XML (.flam3/.flame/.xml) or
    cuburn-style JSON."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("<"):
        return parse_flam3(text, angle_units=angle_units)
    return [Genome.from_json(text)]


# ---------------------------------------------------------------------------
# Genome -> flam3 XML (round-trip support)
# ---------------------------------------------------------------------------

def _fmt_affine(coefs, t: float = 0.0) -> str:
    a, b, c, d, e, f = [s(t) for s in coefs]
    return " ".join(f"{v:.9g}" for v in (a, d, b, e, c, f))


def genome_to_flame_xml(g: Genome, t: float = 0.0) -> str:
    """Serialize a genome (sampled at time t) as a flam3 <flame> element."""
    flame = ET.Element("flame", {
        "name": g.name,
        "size": f"{g.size[0]} {g.size[1]}",
        "center": f"{g.center[0](t):.9g} {g.center[1](t):.9g}",
        **({"rot_center": f"{g.rot_center[0](t):.9g} "
                          f"{g.rot_center[1](t):.9g}"}
           if g.rot_center is not None else {}),
        "scale": f"{g.scale(t):.9g}",
        "zoom": f"{g.zoom(t):.9g}",
        "rotate": f"{g.rotate(t):.9g}",
        "brightness": f"{g.brightness(t):.9g}",
        "gamma": f"{g.gamma(t):.9g}",
        "gamma_threshold": f"{g.gamma_threshold(t):.9g}",
        "vibrancy": f"{g.vibrancy(t):.9g}",
        "highlight_power": f"{g.highlight_power(t):.9g}",
        "estimator_radius": f"{g.estimator_radius(t):.9g}",
        "estimator_minimum": f"{g.estimator_minimum(t):.9g}",
        "estimator_curve": f"{g.estimator_curve(t):.9g}",
        "background": " ".join(f"{s(t):.9g}" for s in g.background),
        "filter": f"{g.spatial_filter(t):.9g}",
        "filter_shape": g.spatial_filter_shape,
        "temporal_filter_type": g.temporal_filter_type,
        "temporal_filter_width": f"{g.temporal_filter_width(t):.9g}",
        "temporal_filter_exp": f"{g.temporal_filter_exp(t):.9g}",
    })
    for k in ("cam_yaw", "cam_pitch", "cam_perspective", "cam_zpos",
              "cam_dof"):
        if getattr(g, k)(t) != 0.0:
            flame.set(k, f"{getattr(g, k)(t):.9g}")
    if g.flame_time is not None:
        flame.set("time", f"{g.flame_time:.9g}")
    if g.interpolation != "linear":
        flame.set("interpolation", g.interpolation)
    if g.earlyclip:
        flame.set("earlyclip", "1")

    def emit_xform(tag: str, xf: XForm, chaos_row=None):
        at = {
            "weight": f"{xf.weight(t):.9g}",
            "color": f"{xf.color(t):.9g}",
            "color_speed": f"{xf.color_speed(t):.9g}",
            "opacity": f"{xf.opacity(t):.9g}",
            "coefs": _fmt_affine(xf.affine, t),
        }
        if xf.post is not None:
            at["post"] = _fmt_affine(xf.post, t)
        if xf.animate:
            at["animate"] = f"{xf.animate:.9g}"
        for name, w in xf.vars.items():
            at[name] = f"{w(t):.9g}"
        for name, p in xf.params.items():
            at[name] = f"{p(t):.9g}"
        if chaos_row is not None:
            at["chaos"] = " ".join(f"{v(t):.9g}" for v in chaos_row)
        if tag == "finalxform":
            at.pop("weight")
            at.pop("chaos", None)
        ET.SubElement(flame, tag, at)

    for i, xf in enumerate(g.xforms):
        emit_xform("xform", xf,
                   g.xaos[i] if g.xaos is not None else None)
    if g.final_xform is not None:
        emit_xform("finalxform", g.final_xform)

    pal = palette_mod.palette_at(g.palettes, t)
    pel = ET.SubElement(flame, "palette",
                        {"count": "256", "format": "RGB"})
    hexstr = palette_mod.encode_palette(pal)
    pel.text = "\n" + "\n".join(
        hexstr[i:i + 48] for i in range(0, len(hexstr), 48)) + "\n"
    return ET.tostring(flame, encoding="unicode")
