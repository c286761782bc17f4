"""Keyframe blending: build animated "edge" genomes between two stills.

Equivalent of the reference's cuburn/genome/blend.py (SURVEY.md §2b
"Keyframe blending"): given two node genomes, produce one animated
genome whose splines sweep from A (t=0) to B (t=1):

  * xform alignment: both ends padded to the same xform count with
    identity xforms of weight 0 (flam3's padding rule), so every xform
    interpolates against a partner
  * variation union per aligned pair: a variation present at only one
    end fades in/out through a weight-0 knot at the other end
  * affine interpolation knot-by-knot; rotation sweeps are expressed by
    the caller via `spin` (extra full turns on the `rotate` camera
    parameter, flam3's edge spin)
  * palettes become two keyframes (device-side lerp handles the sweep)

The reference's matching heuristics (which xform of A pairs with which
of B) are a greedy min-cost pairing here (variation-set Jaccard +
weight + color + affine distance, `_greedy_pairing`), with index-order
and weight-sorted modes available [M confidence vs the reference's
exact algorithm, SURVEY.md §0].
"""

from __future__ import annotations


from typing import Dict, Optional

import numpy as np

from cuburn_tpu_torch.genome.palette import palette_at
from cuburn_tpu_torch.genome.specs import Genome, XForm, IDENTITY_AFFINE
from cuburn_tpu_torch.genome.spline import Spline
from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS


def _materialize_implicit_linear(fx: XForm) -> XForm:
    """flam3 rule: a final xform with EMPTY vars is an implicit
    linear map (Genome.eval_at's fallback); any code about to ADD
    variation entries must make that explicit first or the final
    zeroes out.  Returns a copy when materialization was needed."""
    if fx.vars:
        return fx
    import copy
    fx = copy.deepcopy(fx)
    fx.vars = {"linear": Spline(1.0)}
    return fx


def _identity_xform() -> XForm:
    return XForm(weight=0.0, color=0.0, color_speed=0.0, opacity=1.0,
                 affine=IDENTITY_AFFINE, vars={"linear": 1.0})


def _edge_spline(va: float, vb: float, ease: float = 0.0) -> Spline:
    """Two-knot spline from va at t=0 to vb at t=1.  `ease` adds
    interior knots for smoother starts/stops."""
    if va == vb:
        return Spline(va)
    if ease > 0:
        return Spline([0.0, va, ease, va, 1.0 - ease, vb, 1.0, vb])
    return Spline([0.0, va, 1.0, vb])


def _edge_spline4(vp, va, vb, vn) -> Spline:
    """Four-knot spline: Catmull-Rom over (prev, a, b, next) keyframe
    values with outer knots at t=-1 and t=2 — flam3's `smooth`
    sequence interpolation (tangents at the segment ends come from the
    neighboring keyframes).  Degenerates to _edge_spline when the
    neighbors extrapolate linearly."""
    if vp == va == vb == vn:
        return Spline(va)
    return Spline([-1.0, vp, 0.0, va, 1.0, vb, 2.0, vn])


def _blend_xform(xa: XForm, xb: XForm, t_a: float, t_b: float,
                 xp: Optional[XForm] = None,
                 xn: Optional[XForm] = None) -> XForm:
    """Blend one aligned xform pair.  With neighbor xforms (xp, xn)
    given, weight/color/opacity/affines interpolate with flam3-smooth
    4-keyframe tangents; variation weights/params stay 2-knot (smooth
    overshoot would swing fading variations negative)."""
    smooth = xp is not None and xn is not None

    def v(attr: str) -> Spline:
        a = getattr(xa, attr)(t_a)
        b = getattr(xb, attr)(t_b)
        if smooth:
            return _edge_spline4(getattr(xp, attr)(0.0), a, b,
                                 getattr(xn, attr)(0.0))
        return _edge_spline(a, b)

    def aff(attr: str, i: int) -> Spline:
        def coef(xf, t):
            c = getattr(xf, attr)
            return (c[i] if c is not None
                    else Spline(IDENTITY_AFFINE[i]))(t)
        if smooth:
            return _edge_spline4(coef(xp, 0.0), coef(xa, t_a),
                                 coef(xb, t_b), coef(xn, 0.0))
        return _edge_spline(coef(xa, t_a), coef(xb, t_b))

    vars_union = sorted(set(xa.vars) | set(xb.vars))
    vars_out: Dict[str, Spline] = {}
    params_out: Dict[str, Spline] = {}
    for name in vars_union:
        wa = xa.vars[name](t_a) if name in xa.vars else 0.0
        wb = xb.vars[name](t_b) if name in xb.vars else 0.0
        vars_out[name] = _edge_spline(wa, wb)
        for attr, _default in VARIATION_PARAMS[name]:
            pa = xa.param(attr, t_a)
            pb = xb.param(attr, t_b)
            params_out[attr] = _edge_spline(pa, pb)

    return XForm(
        weight=v("weight"),
        color=v("color"),
        color_speed=v("color_speed"),
        opacity=v("opacity"),
        affine=tuple(aff("affine", i) for i in range(6)),
        post=(tuple(aff("post", i) for i in range(6))
              if (xa.post is not None or xb.post is not None
                  or (smooth and (xp.post is not None
                                  or xn.post is not None)))
              else None),
        vars=vars_out,
        params=params_out,
    )


def _pair_cost(xa: XForm, xb: XForm, t_a: float, t_b: float) -> float:
    """Dissimilarity between two xforms for edge pairing: variation-set
    Jaccard distance (dominant — morphing spherical into spherical
    beats morphing it into julia), relative weight difference, palette
    coordinate distance, and normalized affine distance."""
    va, vb = set(xa.vars) or {"linear"}, set(xb.vars) or {"linear"}
    union = va | vb
    jac = 1.0 - len(va & vb) / len(union)
    wa, wb = xa.weight(t_a), xb.weight(t_b)
    wterm = abs(wa - wb) / (wa + wb + 1e-9)
    cterm = abs(xa.color(t_a) - xb.color(t_b))
    aa = np.array([s(t_a) for s in xa.affine])
    ab = np.array([s(t_b) for s in xb.affine])
    aterm = np.linalg.norm(aa - ab) / (
        np.linalg.norm(aa) + np.linalg.norm(ab) + 1e-9)
    return 2.0 * jac + wterm + 0.5 * cterm + 0.5 * aterm


def _greedy_pairing(xa, xb, t_a: float, t_b: float):
    """Greedy min-cost assignment: returns perm with xb[perm[i]]
    paired to xa[i].  O(n^3), n is xform count (tiny)."""
    n = len(xa)
    cost = np.array([[_pair_cost(xa[i], xb[j], t_a, t_b)
                      for j in range(n)] for i in range(n)])
    perm = [-1] * n
    used_i, used_j = set(), set()
    flat = sorted(((cost[i, j], i, j)
                   for i in range(n) for j in range(n)))
    for _c, i, j in flat:
        if i in used_i or j in used_j:
            continue
        perm[i] = j
        used_i.add(i)
        used_j.add(j)
        if len(used_i) == n:
            break
    return perm


def align_xforms(a: Genome, b: Genome, sort_by_weight: bool = False,
                 pairing: str = "greedy", t_a: float = 0.0,
                 t_b: float = 0.0):
    """Pad both genomes' xform lists to equal length with identity
    xforms (flam3 padding), then pair each A-xform with its best
    B-partner.

    pairing: "greedy" (default) — min-cost assignment on variation
    overlap + weight + color + affine similarity, so structurally
    matching xforms morph into each other instead of whatever shares
    their list index; "index" — reference-style positional pairing.
    `sort_by_weight` (legacy) sorts both sides by descending weight
    before index pairing.

    Returns (xa, xb, n, perm_a, perm_b): perm_x[i] is the position in
    the PADDED original list of the xform now at slot i (needed to
    permute xaos rows/columns consistently)."""
    xa = list(a.xforms)
    xb = list(b.xforms)
    n = max(len(xa), len(xb))
    while len(xa) < n:
        xa.append(_identity_xform())
    while len(xb) < n:
        xb.append(_identity_xform())
    perm_a = list(range(n))
    perm_b = list(range(n))
    if sort_by_weight:
        perm_a = sorted(perm_a, key=lambda i: -xa[i].weight(0.0))
        perm_b = sorted(perm_b, key=lambda i: -xb[i].weight(0.0))
        xa = [xa[i] for i in perm_a]
        xb = [xb[i] for i in perm_b]
    elif pairing == "greedy":
        perm_b = _greedy_pairing(xa, xb, t_a, t_b)
        xb = [xb[j] for j in perm_b]
    elif pairing != "index":
        raise ValueError(f"unknown pairing mode {pairing!r}")
    return xa, xb, n, perm_a, perm_b


def blend_genomes(a: Genome, b: Genome, t_a: float = 0.0,
                  t_b: float = 0.0, spin: float = 0.0,
                  sort_by_weight: bool = False,
                  pairing: str = "greedy",
                  name: Optional[str] = None,
                  prev: Optional[Genome] = None,
                  nxt: Optional[Genome] = None) -> Genome:
    """Build the edge genome sweeping from a@t_a to b@t_b over t in
    [0, 1].  `spin` adds that many extra full camera rotations across
    the edge (flam3's edge spin).

    `prev`/`nxt` (neighboring sequence keyframes) enable flam3's
    `smooth` interpolation: Catmull-Rom tangents at the segment ends
    come from the neighbors, paired locally against a and b."""
    xa, xb, n, perm_a, perm_b = align_xforms(
        a, b, sort_by_weight, pairing, t_a, t_b)
    smooth = prev is not None and nxt is not None
    if smooth:
        xp_l = list(prev.xforms)[:n]
        xn_l = list(nxt.xforms)[:n]
        while len(xp_l) < n:
            xp_l.append(_identity_xform())
        while len(xn_l) < n:
            xn_l.append(_identity_xform())
        # pair each neighbor against its adjacent endpoint
        xp_l = [xp_l[j] for j in _greedy_pairing(xa, xp_l, t_a, 0.0)]
        xn_l = [xn_l[j] for j in _greedy_pairing(xb, xn_l, t_b, 0.0)]
        xforms = [_blend_xform(xa[i], xb[i], t_a, t_b,
                               xp_l[i], xn_l[i]) for i in range(n)]
    else:
        xforms = [_blend_xform(xa[i], xb[i], t_a, t_b)
                  for i in range(n)]

    def tv(get) -> Spline:
        """Top-level camera/color spline: smooth when neighbors."""
        if smooth:
            return _edge_spline4(get(prev)(0.0), get(a)(t_a),
                                 get(b)(t_b), get(nxt)(0.0))
        return _edge_spline(get(a)(t_a), get(b)(t_b))

    # xaos: pad both to n x n with 1.0, permute rows+columns the same
    # way the xform lists were permuted, blend entrywise
    def xaos_at(g: Genome, t: float, perm) -> np.ndarray:
        m = np.ones((n, n))
        if g.xaos is not None:
            k = len(g.xforms)
            for i in range(k):
                for j in range(k):
                    m[i, j] = g.xaos[i][j](t)
        return m[np.ix_(perm, perm)]

    xaos = None
    if a.xaos is not None or b.xaos is not None:
        ma = xaos_at(a, t_a, perm_a)
        mb = xaos_at(b, t_b, perm_b)
        xaos = [[_edge_spline(ma[i, j], mb[i, j]) for j in range(n)]
                for i in range(n)]

    final = None
    if a.final_xform is not None or b.final_xform is not None:
        def _final_for_blend(fx):
            if fx is None:
                return _identity_xform()
            return _materialize_implicit_linear(fx)
        fa = _final_for_blend(a.final_xform)
        fb = _final_for_blend(b.final_xform)
        final = _blend_xform(fa, fb, t_a, t_b)

    # camera rotation takes the short way plus requested spins
    rot_a = a.rotate(t_a)
    rot_b = b.rotate(t_b)
    delta = (rot_b - rot_a + 180.0) % 360.0 - 180.0
    rot_spline = _edge_spline(rot_a, rot_a + delta + spin * 360.0)

    return Genome(
        xforms=xforms, final_xform=final, xaos=xaos,
        palettes=[(0.0, palette_at(a.palettes, t_a)),
                  (1.0, palette_at(b.palettes, t_b))],
        spatial_filter=tv(lambda g: g.spatial_filter),
        center=(tv(lambda g: g.center[0]), tv(lambda g: g.center[1])),
        # rot_center is Optional; when either endpoint pins a pivot,
        # blend it (absent side falls back to its center, matching
        # GenomeParams.at's own fallback) — otherwise stay None
        rot_center=(
            (tv(lambda g: (g.rot_center or g.center)[0]),
             tv(lambda g: (g.rot_center or g.center)[1]))
            if (a.rot_center is not None or b.rot_center is not None)
            else None),
        scale=tv(lambda g: g.scale),
        # zoom blends linearly in its own (log2) domain — exactly
        # flam3's log-scale zoom interpolation
        zoom=tv(lambda g: g.zoom),
        cam_yaw=tv(lambda g: g.cam_yaw),
        cam_pitch=tv(lambda g: g.cam_pitch),
        cam_perspective=tv(lambda g: g.cam_perspective),
        cam_zpos=tv(lambda g: g.cam_zpos),
        cam_dof=tv(lambda g: g.cam_dof),
        rotate=rot_spline,
        brightness=tv(lambda g: g.brightness),
        gamma=tv(lambda g: g.gamma),
        gamma_threshold=tv(lambda g: g.gamma_threshold),
        vibrancy=tv(lambda g: g.vibrancy),
        highlight_power=tv(lambda g: g.highlight_power),
        background=tuple(
            tv(lambda g, i=i: g.background[i]) for i in range(3)),
        estimator_radius=tv(lambda g: g.estimator_radius),
        estimator_minimum=tv(lambda g: g.estimator_minimum),
        estimator_curve=tv(lambda g: g.estimator_curve),
        # filter-shape strings can't interpolate; carry endpoint a's
        # (earlyclip is a static pipeline-order flag, same rule)
        spatial_filter_shape=a.spatial_filter_shape,
        earlyclip=a.earlyclip,
        temporal_filter_type=a.temporal_filter_type,
        temporal_filter_width=tv(lambda g: g.temporal_filter_width),
        temporal_filter_exp=tv(lambda g: g.temporal_filter_exp),
        size=a.size,
        name=name or f"{a.name}=>{b.name}",
        time_range=(0.0, 1.0),
    )


_LOOP_KNOTS = 33


def loop_genome(g: Genome, periods: float = 1.0) -> Genome:
    """flam3-animate's LOOP segment: the flame holds still while every
    xform whose `animate` flag is set rotates its affine linear part
    through `periods` full turns over t in [0, 1] (the signature
    spinning-flame idle between sequence edges).

    The rotation is lowered to densely sampled splines on the affine
    coefficients (A' = A @ R(-2*pi*t*periods)), so it flows through
    every downstream path like any other animation."""
    import copy
    out = copy.deepcopy(g)
    out.time_range = (0.0, 1.0)
    out.name = f"{g.name}:loop"
    ts = np.linspace(0.0, 1.0, _LOOP_KNOTS)
    for xf in out.xforms:
        if not xf.animate:
            continue
        a, b, c, d, e, f = (s(0.0) for s in xf.affine)
        th = -2.0 * np.pi * periods * ts
        ct, st = np.cos(th), np.sin(th)
        # x' = A R(th) x + translation: columns (a,d),(b,e) rotate
        knots = lambda vals: [x for tv in zip(ts, vals) for x in tv]
        xf.affine = (
            Spline(knots(a * ct + b * st)),
            Spline(knots(-a * st + b * ct)),
            Spline(c),
            Spline(knots(d * ct + e * st)),
            Spline(knots(-d * st + e * ct)),
            Spline(f),
        )
    return out


def blend_sequence(genomes, spin: float = 0.0,
                   sort_by_weight: bool = False,
                   smooth: Optional[bool] = None,
                   loops: float = 0.0,
                   harmonize: bool = True):
    """Build the edge list for an animation through a keyframe list —
    the flam3-animate workflow (SURVEY.md §3.2): a multi-flame file's
    stills become N-1 edge genomes, each sweeping its own [0, 1].

    Segment bounds come from the flames' `time` attributes when every
    keyframe carries one and they strictly increase (flam3-animate's
    keyframe spacing); otherwise list order with unit spacing.

    `smooth` (default: on when any flame declares
    interpolation="smooth") gives interior segments 4-keyframe
    Catmull-Rom tangents from their neighbors — flam3's smooth
    sequence interpolation.  End segments clamp to their own keyframe.

    `loops` > 0 inserts a flam3-animate LOOP segment before each edge
    (each keyframe holds for 1 time unit while its animate-flagged
    xforms spin that many full turns — see loop_genome).

    `harmonize` (default) pads every segment genome to one shared
    StructureKey (harmonize_structures) so the WHOLE sequence renders
    with a single compiled program instead of one compile per edge —
    compiles cost minutes on slow-compile environments.

    Returns [(edge_genome, seg_start, seg_end)] with segment bounds in
    global time."""
    if len(genomes) < 2:
        raise ValueError("a sequence needs at least two keyframes")
    if smooth is None:
        smooth = any(getattr(g, "interpolation", "linear") == "smooth"
                     for g in genomes)
    times = [g.flame_time for g in genomes]
    if (all(t is not None for t in times)
            and all(b > a for a, b in zip(times, times[1:]))):
        bounds = [float(t) for t in times]
    else:
        bounds = [float(i) for i in range(len(genomes))]
    out = []
    t_off = 0.0
    for i in range(len(genomes) - 1):
        if loops:
            out.append((loop_genome(genomes[i], loops),
                        bounds[i] + t_off, bounds[i] + t_off + 1.0))
            t_off += 1.0
        kw = {}
        if smooth:
            kw = {"prev": genomes[max(i - 1, 0)],
                  "nxt": genomes[min(i + 2, len(genomes) - 1)]}
        edge = blend_genomes(genomes[i], genomes[i + 1], spin=spin,
                             sort_by_weight=sort_by_weight,
                             name=f"seq[{i}]", **kw)
        out.append((edge, bounds[i] + t_off, bounds[i + 1] + t_off))
    if loops:
        out.append((loop_genome(genomes[-1], loops),
                    bounds[-1] + t_off, bounds[-1] + t_off + 1.0))
    if harmonize and len(out) > 1:
        hs = harmonize_structures([g for g, _s, _e in out])
        out = [(h, s, e) for h, (_g, s, e) in zip(hs, out)]
    return out


def harmonize_structures(genomes):
    """Pad a list of genomes to ONE shared StructureKey.

    Animation sequences compile one XLA program per structure key
    (SURVEY.md §7 trace-time specialization); consecutive edges of a
    keyframe sequence naturally have different variation unions, so an
    N-edge animation pays N compiles (minutes each on slow-compile
    environments).  Harmonizing pads every genome to the union
    structure — max xform count (identity weight-0 xforms), the union
    variation set (zero-weight entries, annihilated exactly by the
    w=0 gating that test_zero_weight_is_zero enforces), matching
    has_post/has_xaos, and a shared final-xform structure — so ONE
    compile serves the whole sequence.

    Values are untouched; only zero-weight/identity structure is
    added.  NOTE: adding a zero-weight STOCHASTIC variation still
    consumes RNG draws per iteration, so harmonized renders of
    genomes that lacked it are statistically identical but not
    bit-identical to their unharmonized renders.  Also, padding the
    xform count can push genomes with non-unit opacities past
    opacity_bits_for's per-frame-size xform limit, dropping them off
    the packed fast path — pass harmonize=False to blend_sequence if
    that trade is wrong for your workload.

    Returns new genomes (inputs are not mutated)."""
    import copy

    gs = [copy.deepcopy(g) for g in genomes]
    n = max(len(g.xforms) for g in gs)
    # surfacing the docstring's perf caveat at run time: padding the
    # xform count grows opacity_bits_for's xform-id field; a genome
    # with non-unit opacities whose id field widens can fall off the
    # packed fast path at large frame sizes
    for g in genomes:
        n0 = len(g.xforms)
        if n0 < n and int(np.ceil(np.log2(max(n0, 2)))) \
                < int(np.ceil(np.log2(max(n, 2)))):
            nonunit = any(not (xf.opacity.is_constant
                               and xf.opacity(0.0) == 1.0)
                          for xf in g.xforms)
            if nonunit:
                import warnings
                warnings.warn(
                    f"harmonize_structures pads genome "
                    f"{getattr(g, 'name', '?')!r} from {n0} to {n} "
                    f"xforms, widening the packed record's xform-id "
                    f"field; with its non-unit opacities this can "
                    f"drop large frames off the packed fast path — "
                    f"pass harmonize=False (--no-harmonize) if "
                    f"renders slow down")
    all_vars = set()
    final_vars = set()
    any_post = False
    any_xaos = any(g.xaos is not None for g in gs)
    any_final = any(g.final_xform is not None for g in gs)
    final_post = False
    for g in gs:
        for xf in g.xforms:
            all_vars.update(xf.vars)
            any_post = any_post or xf.post is not None
        if g.final_xform is not None:
            final_vars.update(g.final_xform.vars or {"linear"})
            final_post = final_post or g.final_xform.post is not None
    if not all_vars:
        all_vars = {"linear"}
    if any(len(g.xforms) < n for g in gs):
        # xform-count padding appends identity (linear) xforms, so
        # linear must join everyone's union or keys still differ
        all_vars = all_vars | {"linear"}
    if any_final and (not final_vars
                      or any(g.final_xform is None
                             or not g.final_xform.vars for g in gs)):
        # genomes lacking a final get an identity (linear) one, and a
        # final with EMPTY vars means implicit linear — both put
        # linear into the target final union
        final_vars = final_vars | {"linear"}

    for g in gs:
        while len(g.xforms) < n:
            g.xforms.append(_identity_xform())
        # the structure key unions variations across xforms, so zero
        # -weight entries on xform 0 cover the whole genome
        missing = all_vars - set().union(*(set(xf.vars)
                                           for xf in g.xforms))
        if missing:
            xf = g.xforms[0]
            xf.vars = dict(xf.vars)
            for name in sorted(missing):
                xf.vars[name] = Spline(0.0)
        if any_post and not any(xf.post is not None
                                for xf in g.xforms):
            g.xforms[0].post = IDENTITY_AFFINE
        if any_xaos and g.xaos is None:
            g.xaos = [[Spline(1.0) for _ in range(n)]
                      for _ in range(n)]
        elif g.xaos is not None and len(g.xaos) < n:
            # grown xform count: extend existing rows/add unit rows
            g.xaos = [[row[j] if j < len(row) else Spline(1.0)
                       for j in range(n)]
                      for row in g.xaos] + \
                     [[Spline(1.0) for _ in range(n)]
                      for _ in range(n - len(g.xaos))]
        if any_final:
            if g.final_xform is None:
                g.final_xform = XForm(color=0.0, color_speed=0.0,
                                      affine=IDENTITY_AFFINE,
                                      vars={"linear": 1.0})
            g.final_xform = _materialize_implicit_linear(
                g.final_xform)
            fx = g.final_xform
            fmissing = final_vars - set(fx.vars)
            if fmissing:
                fx.vars = dict(fx.vars)
                for name in sorted(fmissing):
                    fx.vars[name] = Spline(0.0)
            if final_post and fx.post is None:
                fx.post = IDENTITY_AFFINE
        # re-validate / re-splinify the touched xforms
        for xf in g.xforms:
            xf.__post_init__()
        if g.final_xform is not None:
            g.final_xform.__post_init__()
    return gs
