"""The flam3 variation library as PyTorch functions on point batches.

Port of `cuburn_tpu/ops/variations.py`: the same 100-entry registry,
the same contract and the same float32 arithmetic, written with torch
ops instead of jax.numpy.

    impl(ctx, w, P) -> (dx, dy)

`w` is the per-point variation weight, applied inside the body because
several flam3 variations use it nonlinearly; `(dx, dy)` is the
variation's full contribution to the output sum.  `ctx` carries the
post-affine point, flam3's lazily computed precalc values (r2, r,
atan = atan2(tx, ty), atanyx = atan2(ty, tx)), the active xform's
affine as six per-point tensors, and the `RngStream` that stochastic
variations draw from.  `P(name)` returns the per-point tensor of a
parametric knob.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from flamebench.reference.rng import RngStream


def _max(a, b):
    """Elementwise maximum of a tensor and a tensor or a scalar
    (jnp.maximum's two forms; NaN propagates in both)."""
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=float(b))


EPS = float(np.float32(1e-10))
PI = float(np.float32(np.pi))
M_1_PI = float(np.float32(1.0 / np.pi))
M_2_PI = float(np.float32(2.0 / np.pi))


class VarCtx:
    """Lazy precalc context (flam3's precalc_sqrt / precalc_atan /
    precalc_atanyx): each value is computed on first access, so a
    genome whose variations never read e.g. atan pays nothing for it."""

    __slots__ = ("tx", "ty", "affine", "rng", "_r2", "_r", "_atan",
                 "_atanyx")

    def __init__(self, tx, ty, affine, rng: RngStream):
        self.tx = tx
        self.ty = ty
        self.affine = affine
        self.rng = rng
        self._r2 = None
        self._r = None
        self._atan = None
        self._atanyx = None

    @property
    def r2(self):
        if self._r2 is None:
            self._r2 = self.tx * self.tx + self.ty * self.ty
        return self._r2

    @property
    def r(self):
        if self._r is None:
            self._r = torch.sqrt(self.r2)
        return self._r

    @property
    def atan(self):          # atan2(tx, ty) — flam3 arg order
        if self._atan is None:
            self._atan = torch.atan2(self.tx, self.ty)
        return self._atan

    @property
    def atanyx(self):        # atan2(ty, tx)
        if self._atanyx is None:
            self._atanyx = torch.atan2(self.ty, self.tx)
        return self._atanyx


def make_ctx(tx, ty, affine, rng: RngStream) -> VarCtx:
    return VarCtx(tx, ty, affine, rng)


VARIATION_IMPLS: Dict[str, Callable] = {}


def variation(name):
    def register(fn):
        VARIATION_IMPLS[name] = fn
        return fn
    return register


# ---------------------------------------------------------------------------
# simple variations
# ---------------------------------------------------------------------------

@variation("linear")
def v_linear(c, w, P):
    return w * c.tx, w * c.ty


@variation("sinusoidal")
def v_sinusoidal(c, w, P):
    return w * torch.sin(c.tx), w * torch.sin(c.ty)


@variation("spherical")
def v_spherical(c, w, P):
    s = w / (c.r2 + EPS)
    return s * c.tx, s * c.ty


@variation("swirl")
def v_swirl(c, w, P):
    sr, cr = torch.sin(c.r2), torch.cos(c.r2)
    return w * (sr * c.tx - cr * c.ty), w * (cr * c.tx + sr * c.ty)


@variation("horseshoe")
def v_horseshoe(c, w, P):
    s = w / (c.r + EPS)
    return s * (c.tx - c.ty) * (c.tx + c.ty), s * 2.0 * c.tx * c.ty


@variation("polar")
def v_polar(c, w, P):
    return w * c.atan * M_1_PI, w * (c.r - 1.0)


@variation("handkerchief")
def v_handkerchief(c, w, P):
    return (w * c.r * torch.sin(c.atan + c.r),
            w * c.r * torch.cos(c.atan - c.r))


@variation("heart")
def v_heart(c, w, P):
    a = c.atan * c.r
    return w * c.r * torch.sin(a), -w * c.r * torch.cos(a)


@variation("disc")
def v_disc(c, w, P):
    a = c.atan * M_1_PI * w
    rpi = PI * c.r
    return a * torch.sin(rpi), a * torch.cos(rpi)


@variation("spiral")
def v_spiral(c, w, P):
    s = w / (c.r + EPS)
    return (s * (torch.cos(c.atan) + torch.sin(c.r)),
            s * (torch.sin(c.atan) - torch.cos(c.r)))


@variation("hyperbolic")
def v_hyperbolic(c, w, P):
    return (w * torch.sin(c.atan) / (c.r + EPS),
            w * torch.cos(c.atan) * c.r)


@variation("diamond")
def v_diamond(c, w, P):
    return (w * torch.sin(c.atan) * torch.cos(c.r),
            w * torch.cos(c.atan) * torch.sin(c.r))


@variation("ex")
def v_ex(c, w, P):
    n0 = torch.sin(c.atan + c.r)
    n1 = torch.cos(c.atan - c.r)
    m0 = n0 * n0 * n0 * c.r
    m1 = n1 * n1 * n1 * c.r
    return w * (m0 + m1), w * (m0 - m1)


@variation("julia")
def v_julia(c, w, P):
    # random branch: add 0 or pi to theta/2
    branch = (c.rng.bits() & 1).to(torch.float32) * PI
    a = 0.5 * c.atan + branch
    sr = w * torch.sqrt(c.r)
    return sr * torch.cos(a), sr * torch.sin(a)


@variation("bent")
def v_bent(c, w, P):
    nx = torch.where(c.tx < 0.0, c.tx * 2.0, c.tx)
    ny = torch.where(c.ty < 0.0, c.ty * 0.5, c.ty)
    return w * nx, w * ny


@variation("waves")
def v_waves(c, w, P):
    _a, b, cc, _d, e, f = c.affine
    dx2 = 1.0 / (cc * cc + EPS)
    dy2 = 1.0 / (f * f + EPS)
    return (w * (c.tx + b * torch.sin(c.ty * dx2)),
            w * (c.ty + e * torch.sin(c.tx * dy2)))


@variation("fisheye")
def v_fisheye(c, w, P):
    s = 2.0 * w / (c.r + 1.0)
    return s * c.ty, s * c.tx  # note: swapped, per flam3


@variation("popcorn")
def v_popcorn(c, w, P):
    _a, _b, cc, _d, _e, f = c.affine
    return (w * (c.tx + cc * torch.sin(torch.tan(3.0 * c.ty))),
            w * (c.ty + f * torch.sin(torch.tan(3.0 * c.tx))))


@variation("exponential")
def v_exponential(c, w, P):
    d = w * torch.exp(c.tx - 1.0)
    return d * torch.cos(PI * c.ty), d * torch.sin(PI * c.ty)


@variation("power")
def v_power(c, w, P):
    sa = torch.sin(c.atan)
    p = w * torch.pow(c.r + EPS, sa)
    return p * torch.cos(c.atan), p * sa


@variation("cosine")
def v_cosine(c, w, P):
    a = c.tx * PI
    return (w * torch.cos(a) * torch.cosh(c.ty),
            -w * torch.sin(a) * torch.sinh(c.ty))


@variation("rings")
def v_rings(c, w, P):
    cc = c.affine[2]
    dx = cc * cc + EPS
    rr = torch.fmod(c.r + dx, 2.0 * dx) - dx + c.r * (1.0 - dx)
    # flam3 var21_rings emits (cosa, sina) = (y/r, x/r) — one of the
    # variations whose axes are deliberately swapped in flam3/the paper
    # (unlike blob/disc which use (sina, cosa))
    return w * rr * torch.cos(c.atan), w * rr * torch.sin(c.atan)


@variation("fan")
def v_fan(c, w, P):
    cc, f = c.affine[2], c.affine[5]
    dx = PI * (cc * cc + EPS)
    dx2 = 0.5 * dx
    a = c.atan
    a = torch.where(torch.fmod(a + f, dx) > dx2, a - dx2, a + dx2)
    # flam3 var22_fan: (cos a, sin a) with a measured from +y (atan2(x,y))
    return w * c.r * torch.cos(a), w * c.r * torch.sin(a)


@variation("blob")
def v_blob(c, w, P):
    lo, hi, waves = P("blob_low"), P("blob_high"), P("blob_waves")
    rr = c.r * (lo + (hi - lo) * (0.5 + 0.5 * torch.sin(waves * c.atan)))
    return w * rr * torch.sin(c.atan), w * rr * torch.cos(c.atan)


@variation("pdj")
def v_pdj(c, w, P):
    a, b, cc, d = P("pdj_a"), P("pdj_b"), P("pdj_c"), P("pdj_d")
    return (w * (torch.sin(a * c.ty) - torch.cos(b * c.tx)),
            w * (torch.sin(cc * c.tx) - torch.cos(d * c.ty)))


@variation("fan2")
def v_fan2(c, w, P):
    px, py = P("fan2_x"), P("fan2_y")
    dx = PI * (px * px + EPS)
    dx2 = 0.5 * dx
    a = c.atan
    # flam3 folds with a C (int) cast — truncation toward zero, NOT
    # floor: for negative a+fan2_y, t lands in (-dx, 0] and flam3
    # always takes the a+dx2 branch there.
    t = a + py - dx * torch.trunc((a + py) / dx)
    a = torch.where(t > dx2, a - dx2, a + dx2)
    return w * c.r * torch.sin(a), w * c.r * torch.cos(a)


@variation("rings2")
def v_rings2(c, w, P):
    val = P("rings2_val")
    dx = val * val + EPS
    rr = c.r - 2.0 * dx * torch.trunc((c.r + dx) / (2.0 * dx)) \
        + c.r * (1.0 - dx)
    return w * rr * torch.sin(c.atan), w * rr * torch.cos(c.atan)


@variation("eyefish")
def v_eyefish(c, w, P):
    s = 2.0 * w / (c.r + 1.0)
    return s * c.tx, s * c.ty


@variation("bubble")
def v_bubble(c, w, P):
    s = w / (0.25 * c.r2 + 1.0)
    return s * c.tx, s * c.ty


@variation("cylinder")
def v_cylinder(c, w, P):
    return w * torch.sin(c.tx), w * c.ty


@variation("perspective")
def v_perspective(c, w, P):
    ang = P("perspective_angle") * (PI / 2.0)
    dist = P("perspective_dist")
    t = 1.0 / (dist - c.ty * torch.sin(ang) + EPS)
    return (w * dist * c.tx * t,
            w * dist * torch.cos(ang) * c.ty * t)


@variation("noise")
def v_noise(c, w, P):
    r1 = c.rng.uniform()
    a = 2.0 * PI * c.rng.uniform()
    return w * r1 * c.tx * torch.cos(a), w * r1 * c.ty * torch.sin(a)


@variation("julian")
def v_julian(c, w, P):
    power, dist = P("julian_power"), P("julian_dist")
    t_rnd = torch.trunc(torch.abs(power) * c.rng.uniform())
    a = (c.atanyx + 2.0 * PI * t_rnd) / power
    rr = w * torch.pow(c.r2 + EPS, dist / power * 0.5)
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("juliascope")
def v_juliascope(c, w, P):
    power, dist = P("juliascope_power"), P("juliascope_dist")
    t_rnd = torch.trunc(torch.abs(power) * c.rng.uniform())
    # flam3 var31: the reflection sign comes from the PARITY of the
    # branch index t_rnd, not an independent draw — an independent
    # sign doubles the branch set (4 angles instead of 2 at power 2:
    # a visibly, wrongly symmetric render)
    parity_even = torch.remainder(t_rnd, 2.0) < 0.5
    signed_atan = torch.where(parity_even, c.atanyx, -c.atanyx)
    a = (2.0 * PI * t_rnd + signed_atan) / power
    rr = w * torch.pow(c.r2 + EPS, dist / power * 0.5)
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("blur")
def v_blur(c, w, P):
    r1 = c.rng.uniform() * w
    a = 2.0 * PI * c.rng.uniform()
    return r1 * torch.cos(a), r1 * torch.sin(a)


@variation("gaussian_blur")
def v_gaussian_blur(c, w, P):
    g = w * c.rng.gaussian_ish()
    a = 2.0 * PI * c.rng.uniform()
    return g * torch.cos(a), g * torch.sin(a)


@variation("radial_blur")
def v_radial_blur(c, w, P):
    ang = P("radial_blur_angle") * (PI / 2.0)
    spin, zoom = torch.sin(ang), torch.cos(ang)
    g = w * c.rng.gaussian_ish()
    a = c.atanyx + spin * g
    rz = zoom * g - 1.0
    return (c.r * torch.cos(a) + rz * c.tx,
            c.r * torch.sin(a) + rz * c.ty)


@variation("pie")
def v_pie(c, w, P):
    slices, rot, thick = P("pie_slices"), P("pie_rotation"), P("pie_thickness")
    sl = torch.trunc(c.rng.uniform() * slices + 0.5)
    a = rot + 2.0 * PI * (sl + c.rng.uniform() * thick) / slices
    rr = w * c.rng.uniform()
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("ngon")
def v_ngon(c, w, P):
    sides, power = P("ngon_sides"), P("ngon_power")
    circle, corners = P("ngon_circle"), P("ngon_corners")
    cpower = -0.5 * power
    csides = 2.0 * PI / sides
    csidesinv = 1.0 / csides
    rfac = torch.pow(c.r2 + EPS, cpower)
    phi = c.atanyx - csides * torch.floor(c.atanyx * csidesinv)
    phi = torch.where(phi > 0.5 * csides, phi - csides, phi)
    amp = (corners * (1.0 / (torch.cos(phi) + EPS) - 1.0) + circle) \
        * w * rfac
    return amp * c.tx, amp * c.ty


@variation("curl")
def v_curl(c, w, P):
    c1, c2 = P("curl_c1"), P("curl_c2")
    re = 1.0 + c1 * c.tx + c2 * (c.tx * c.tx - c.ty * c.ty)
    im = c1 * c.ty + 2.0 * c2 * c.tx * c.ty
    s = w / (re * re + im * im + EPS)
    return s * (c.tx * re + c.ty * im), s * (c.ty * re - c.tx * im)


@variation("rectangles")
def v_rectangles(c, w, P):
    px, py = P("rectangles_x"), P("rectangles_y")
    nx = torch.where(torch.abs(px) < EPS, c.tx,
                   (2.0 * torch.floor(c.tx / torch.where(
                       torch.abs(px) < EPS, 1.0, px)) + 1.0) * px - c.tx)
    ny = torch.where(torch.abs(py) < EPS, c.ty,
                   (2.0 * torch.floor(c.ty / torch.where(
                       torch.abs(py) < EPS, 1.0, py)) + 1.0) * py - c.ty)
    return w * nx, w * ny


@variation("arch")
def v_arch(c, w, P):
    ang = c.rng.uniform() * w * PI
    sa, ca = torch.sin(ang), torch.cos(ang)
    return w * sa, w * sa * sa / (ca + EPS)


@variation("tangent")
def v_tangent(c, w, P):
    return (w * torch.sin(c.tx) / (torch.cos(c.ty) + EPS),
            w * torch.tan(c.ty))


@variation("square")
def v_square(c, w, P):
    return (w * (c.rng.uniform() - 0.5),
            w * (c.rng.uniform() - 0.5))


@variation("rays")
def v_rays(c, w, P):
    ang = w * c.rng.uniform() * PI
    rr = w / (c.r2 + EPS)
    tanr = w * torch.tan(ang) * rr
    return tanr * torch.cos(c.tx), tanr * torch.sin(c.ty)


@variation("blade")
def v_blade(c, w, P):
    rr = c.rng.uniform() * w * c.r
    sr, cr = torch.sin(rr), torch.cos(rr)
    return w * c.tx * (cr + sr), w * c.tx * (cr - sr)


@variation("secant2")
def v_secant2(c, w, P):
    cr = torch.cos(w * c.r)
    # sign-preserving guard: +EPS for a near-zero NEGATIVE cos would
    # flip the pole's direction vs flam3
    safe = torch.where(cr < 0.0, -EPS, EPS)
    icr = 1.0 / torch.where(torch.abs(cr) < EPS, safe, cr)
    dy = torch.where(cr < 0.0, w * (icr + 1.0), w * (icr - 1.0))
    return w * c.tx, dy


@variation("twintrian")
def v_twintrian(c, w, P):
    rr = c.rng.uniform() * w * c.r
    sr, cr = torch.sin(rr), torch.cos(rr)
    diff = torch.log10(sr * sr + EPS) + cr
    diff = torch.where(torch.isfinite(diff), diff, -30.0)
    return w * c.tx * diff, w * c.tx * (diff - sr * PI)


@variation("cross")
def v_cross(c, w, P):
    d = c.tx * c.tx - c.ty * c.ty
    s = w * torch.sqrt(1.0 / (d * d + EPS))
    return s * c.tx, s * c.ty


@variation("disc2")
def v_disc2(c, w, P):
    rot, twist = P("disc2_rot"), P("disc2_twist")
    timespi = rot * PI
    sinadd, cosadd = torch.sin(twist), torch.cos(twist) - 1.0
    k_hi = torch.where(twist > 2.0 * PI, 1.0 + twist - 2.0 * PI, 1.0)
    k_lo = torch.where(twist < -2.0 * PI, 1.0 + twist + 2.0 * PI, 1.0)
    sinadd = sinadd * k_hi * k_lo
    cosadd = cosadd * k_hi * k_lo
    t = timespi * (c.tx + c.ty)
    rr = w * c.atan * M_1_PI
    return (rr * (torch.sin(t) + cosadd), rr * (torch.cos(t) + sinadd))


@variation("super_shape")
def v_super_shape(c, w, P):
    m, n1, n2, n3 = (P("super_shape_m"), P("super_shape_n1"),
                     P("super_shape_n2"), P("super_shape_n3"))
    holes, rnd = P("super_shape_holes"), P("super_shape_rnd")
    theta = (m / 4.0) * c.atanyx + PI / 4.0
    t1 = torch.pow(torch.abs(torch.cos(theta)) + EPS, n2)
    t2 = torch.pow(torch.abs(torch.sin(theta)) + EPS, n3)
    mix = rnd * c.rng.uniform() + (1.0 - rnd) * c.r
    rr = w * (mix - holes) * torch.pow(t1 + t2, -1.0 / n1) / (c.r + EPS)
    return rr * c.tx, rr * c.ty


@variation("flower")
def v_flower(c, w, P):
    petals, holes = P("flower_petals"), P("flower_holes")
    rr = w * (c.rng.uniform() - holes) * torch.cos(petals * c.atanyx) \
        / (c.r + EPS)
    return rr * c.tx, rr * c.ty


@variation("conic")
def v_conic(c, w, P):
    ecc, holes = P("conic_eccentricity"), P("conic_holes")
    ct = c.tx / (c.r + EPS)
    rr = w * (c.rng.uniform() - holes) * ecc / (1.0 + ecc * ct + EPS) \
        / (c.r + EPS)
    return rr * c.tx, rr * c.ty


@variation("parabola")
def v_parabola(c, w, P):
    h, wd = P("parabola_height"), P("parabola_width")
    sr, cr = torch.sin(c.r), torch.cos(c.r)
    return (h * w * sr * sr * c.rng.uniform(),
            wd * w * cr * c.rng.uniform())


@variation("bent2")
def v_bent2(c, w, P):
    px, py = P("bent2_x"), P("bent2_y")
    nx = torch.where(c.tx < 0.0, c.tx * px, c.tx)
    ny = torch.where(c.ty < 0.0, c.ty * py, c.ty)
    return w * nx, w * ny


@variation("bipolar")
def v_bipolar(c, w, P):
    shift = P("bipolar_shift")
    x2y2 = c.r2
    t = x2y2 + 1.0
    x2 = 2.0 * c.tx
    ps = -0.5 * PI * shift
    y = 0.5 * torch.atan2(2.0 * c.ty, x2y2 - 1.0) + ps
    y = torch.where(y > 0.5 * PI,
                  -0.5 * PI + torch.fmod(y + 0.5 * PI, PI), y)
    y = torch.where(y < -0.5 * PI,
                  0.5 * PI - torch.fmod(0.5 * PI - y, PI), y)
    num = _max(t + x2, EPS)
    den = _max(t - x2, EPS)
    return (w * 0.25 * M_2_PI * torch.log(num / den),
            w * M_2_PI * y)


@variation("boarders")
def v_boarders(c, w, P):
    rx, ry = torch.round(c.tx), torch.round(c.ty)
    ox, oy = c.tx - rx, c.ty - ry
    # inner branch (25% of samples)
    in_x = ox * 0.5 + rx
    in_y = oy * 0.5 + ry
    # edge branch
    absx_ge = torch.abs(ox) >= torch.abs(oy)
    sx = torch.where(ox >= 0.0, 0.25, -0.25)
    sy = torch.where(oy >= 0.0, 0.25, -0.25)
    safe_ox = torch.where(torch.abs(ox) < EPS, EPS, ox)
    safe_oy = torch.where(torch.abs(oy) < EPS, EPS, oy)
    ex_x = torch.where(absx_ge, ox * 0.5 + rx + sx,
                     ox * 0.5 + rx + sy * ox / safe_oy)
    ex_y = torch.where(absx_ge, oy * 0.5 + ry + sx * oy / safe_ox,
                     oy * 0.5 + ry + sy)
    # flam3 var57_boarders: the plain interior branch fires when
    # random >= 0.75 (25% of samples); the other 75% take the edge
    # branch.  (Round-1 had this inverted.)
    inner = c.rng.uniform() >= 0.75
    return (w * torch.where(inner, in_x, ex_x),
            w * torch.where(inner, in_y, ex_y))


@variation("butterfly")
def v_butterfly(c, w, P):
    wx = w * float(np.float32(1.3029400317411197908970256609023))
    y2 = 2.0 * c.ty
    rr = wx * torch.sqrt(torch.abs(c.tx * c.ty) / (EPS + c.tx * c.tx + y2 * y2))
    return rr * c.tx, rr * y2


@variation("cell")
def v_cell(c, w, P):
    size = P("cell_size")
    inv = 1.0 / torch.where(torch.abs(size) < EPS, EPS, size)
    x = torch.floor(c.tx * inv)
    y = torch.floor(c.ty * inv)
    dx = c.tx - x * size
    dy = c.ty - y * size
    x2 = torch.where(x >= 0.0, 2.0 * x, -(2.0 * x + 1.0))
    y2 = torch.where(y >= 0.0, 2.0 * y, -(2.0 * y + 1.0))
    return w * (dx + x2 * size), -w * (dy + y2 * size)


@variation("cpow")
def v_cpow(c, w, P):
    pr, pi, power = P("cpow_r"), P("cpow_i"), P("cpow_power")
    a = c.atanyx
    lnr = 0.5 * torch.log(c.r2 + EPS)
    va = 2.0 * PI / power
    vc = pr / power
    vd = pi / power
    ang = vc * a + vd * lnr + va * torch.floor(power * c.rng.uniform())
    m = w * torch.exp(vc * lnr - vd * a)
    return m * torch.cos(ang), m * torch.sin(ang)


@variation("curve")
def v_curve(c, w, P):
    xa, ya = P("curve_xamp"), P("curve_yamp")
    xl, yl = P("curve_xlength"), P("curve_ylength")
    pc_xlen = _max(xl * xl, float(np.float32(1e-20)))
    pc_ylen = _max(yl * yl, float(np.float32(1e-20)))
    return (w * (c.tx + xa * torch.exp(-c.ty * c.ty / pc_xlen)),
            w * (c.ty + ya * torch.exp(-c.tx * c.tx / pc_ylen)))


@variation("edisc")
def v_edisc(c, w, P):
    tmp = c.r2 + 1.0
    tmp2 = 2.0 * c.tx
    r1 = torch.sqrt(_max(tmp + tmp2, 0.0))
    r2_ = torch.sqrt(_max(tmp - tmp2, 0.0))
    xmax = 0.5 * (r1 + r2_)
    a1 = torch.log(xmax + torch.sqrt(_max(xmax - 1.0, 0.0)))
    a2 = -torch.acos(torch.clamp(c.tx / _max(xmax, EPS), -1.0, 1.0))
    ww = w / float(np.float32(11.57034632))
    snv = torch.where(c.ty > 0.0, -torch.sin(a1), torch.sin(a1))
    return ww * torch.cosh(a2) * torch.cos(a1), ww * torch.sinh(a2) * snv


@variation("elliptic")
def v_elliptic(c, w, P):
    tmp = c.r2 + 1.0
    x2 = 2.0 * c.tx
    xmax = 0.5 * (torch.sqrt(_max(tmp + x2, 0.0)) +
                  torch.sqrt(_max(tmp - x2, 0.0)))
    a = c.tx / _max(xmax, EPS)
    b = torch.sqrt(_max(1.0 - a * a, 0.0))
    ssx = torch.sqrt(_max(xmax - 1.0, 0.0))
    ww = w * M_2_PI
    dy = ww * torch.log(xmax + ssx)
    return (ww * torch.atan2(a, b),
            torch.where(c.ty > 0.0, dy, -dy))


@variation("escher")
def v_escher(c, w, P):
    beta = P("escher_beta")
    a = c.atanyx
    lnr = 0.5 * torch.log(c.r2 + EPS)
    seb, ceb = torch.sin(beta), torch.cos(beta)
    vc = 0.5 * (1.0 + ceb)
    vd = 0.5 * seb
    m = w * torch.exp(vc * lnr - vd * a)
    n = vc * a + vd * lnr
    return m * torch.cos(n), m * torch.sin(n)


@variation("foci")
def v_foci(c, w, P):
    expx = 0.5 * torch.exp(c.tx)
    expnx = 0.25 / _max(expx, EPS)
    sn, cn = torch.sin(c.ty), torch.cos(c.ty)
    tmp = w / torch.where(
        torch.abs(expx + expnx - cn) < EPS, EPS, expx + expnx - cn)
    return tmp * (expx - expnx), tmp * sn


@variation("lazysusan")
def v_lazysusan(c, w, P):
    lx, ly = P("lazysusan_x"), P("lazysusan_y")
    spin, space, twist = (P("lazysusan_spin"), P("lazysusan_space"),
                          P("lazysusan_twist"))
    x = c.tx - lx
    y = c.ty + ly
    rr = torch.sqrt(x * x + y * y)
    inside = rr < w
    a = torch.atan2(y, x) + spin + twist * (w - rr)
    # flam3 adds the +-lx/ly offsets unscaled, but it only evaluates
    # ACTIVE variations; under union evaluation (ops/xform.py) every
    # point sees every variation with gathered weight, so the
    # weight-independent terms must be gated on w != 0 to preserve
    # flam3 semantics.
    active = (w != 0.0).to(x.dtype)
    r_in = w * rr
    dx_in = r_in * torch.cos(a) + active * lx
    dy_in = r_in * torch.sin(a) - active * ly
    r_out = w * (1.0 + space / (rr + EPS))
    dx_out = r_out * x + active * lx
    dy_out = r_out * y - active * ly
    return (torch.where(inside, dx_in, dx_out),
            torch.where(inside, dy_in, dy_out))


@variation("loonie")
def v_loonie(c, w, P):
    w2 = w * w
    inside = c.r2 < w2
    rr = w * torch.sqrt(_max(w2 / _max(c.r2, EPS) - 1.0, 0.0))
    s = torch.where(inside, rr, w)
    return s * c.tx, s * c.ty


@variation("pre_blur")
def v_pre_blur(c, w, P):
    # handled as a pre-transform in xform.py; as a regular variation it
    # contributes nothing (flam3 treats it specially the same way).
    z = torch.zeros_like(c.tx)
    return z, z


@variation("modulus")
def v_modulus(c, w, P):
    mx, my = P("modulus_x"), P("modulus_y")
    xr = 2.0 * mx
    yr = 2.0 * my
    safe_xr = torch.where(torch.abs(xr) < EPS, 1.0, xr)
    safe_yr = torch.where(torch.abs(yr) < EPS, 1.0, yr)
    nx = torch.where(c.tx > mx, -mx + torch.fmod(c.tx + mx, safe_xr),
                   torch.where(c.tx < -mx,
                             mx - torch.fmod(mx - c.tx, safe_xr), c.tx))
    ny = torch.where(c.ty > my, -my + torch.fmod(c.ty + my, safe_yr),
                   torch.where(c.ty < -my,
                             my - torch.fmod(my - c.ty, safe_yr), c.ty))
    return w * nx, w * ny


@variation("oscilloscope")
def v_oscilloscope(c, w, P):
    sep, freq = P("oscope_separation"), P("oscope_frequency")
    amp, damp = P("oscope_amplitude"), P("oscope_damping")
    tpf = 2.0 * PI * freq
    t = torch.where(torch.abs(damp) < EPS,
                  amp * torch.cos(tpf * c.tx) + sep,
                  amp * torch.exp(-torch.abs(c.tx) * damp)
                  * torch.cos(tpf * c.tx) + sep)
    ny = torch.where(torch.abs(c.ty) <= t, -c.ty, c.ty)
    return w * c.tx, w * ny


@variation("polar2")
def v_polar2(c, w, P):
    vvar = w * M_1_PI
    return vvar * c.atan, 0.5 * vvar * torch.log(c.r2 + EPS)


@variation("unpolar")
def v_unpolar(c, w, P):
    # Inverse of flam3's polar map (u, v) -> (r sin(pi u), r cos(pi u))
    # with r = v + 1; Apophysis-compatible-class [SURVEY.md §2c marks
    # unpolar as approximate].
    a = PI * c.tx
    rr = c.ty + 1.0
    return w * rr * torch.sin(a), w * rr * torch.cos(a)


@variation("popcorn2")
def v_popcorn2(c, w, P):
    px, py, pc = P("popcorn2_x"), P("popcorn2_y"), P("popcorn2_c")
    return (w * (c.tx + px * torch.sin(torch.tan(c.ty * pc))),
            w * (c.ty + py * torch.sin(torch.tan(c.tx * pc))))


@variation("scry")
def v_scry(c, w, P):
    t = c.r2
    rr = 1.0 / _max(c.r * (t + 1.0 / (w + EPS)), EPS)
    return rr * c.tx, rr * c.ty


@variation("separation")
def v_separation(c, w, P):
    sx = P("separation_x") ** 2
    sy = P("separation_y") ** 2
    xin, yin = P("separation_xinside"), P("separation_yinside")
    nx = torch.where(c.tx > 0.0,
                   torch.sqrt(c.tx * c.tx + sx) - c.tx * xin,
                   -(torch.sqrt(c.tx * c.tx + sx) + c.tx * xin))
    ny = torch.where(c.ty > 0.0,
                   torch.sqrt(c.ty * c.ty + sy) - c.ty * yin,
                   -(torch.sqrt(c.ty * c.ty + sy) + c.ty * yin))
    return w * nx, w * ny


@variation("split")
def v_split(c, w, P):
    xs, ys = P("split_xsize"), P("split_ysize")
    dy = torch.where(torch.cos(c.tx * xs * PI) >= 0.0, w * c.ty, -w * c.ty)
    dx = torch.where(torch.cos(c.ty * ys * PI) >= 0.0, w * c.tx, -w * c.tx)
    return dx, dy


@variation("splits")
def v_splits(c, w, P):
    px, py = P("splits_x"), P("splits_y")
    return (w * torch.where(c.tx >= 0.0, c.tx + px, c.tx - px),
            w * torch.where(c.ty >= 0.0, c.ty + py, c.ty - py))


@variation("stripes")
def v_stripes(c, w, P):
    space, warp = P("stripes_space"), P("stripes_warp")
    rx = torch.floor(c.tx + 0.5)
    ox = c.tx - rx
    return (w * (ox * (1.0 - space) + rx),
            w * (c.ty + ox * ox * warp))


@variation("wedge")
def v_wedge(c, w, P):
    angle, hole = P("wedge_angle"), P("wedge_hole")
    count, swirl = P("wedge_count"), P("wedge_swirl")
    rr = c.r
    a = c.atanyx + swirl * rr
    cc = torch.floor((count * a + PI) * M_1_PI * 0.5)
    comp = 1.0 - angle * count * M_1_PI * 0.5
    a = a * comp + cc * angle
    rr = w * (rr + hole)
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("wedge_julia")
def v_wedge_julia(c, w, P):
    angle, count = P("wedge_julia_angle"), P("wedge_julia_count")
    power, dist = P("wedge_julia_power"), P("wedge_julia_dist")
    cf = 1.0 - angle * count * M_1_PI * 0.5
    rN = torch.abs(power)
    cn = dist / power / 2.0
    rr = w * torch.pow(c.r2 + EPS, cn)
    t_rnd = torch.trunc(rN * c.rng.uniform())
    a = (c.atanyx + 2.0 * PI * t_rnd) / power
    cc = torch.floor((count * a + PI) * M_1_PI * 0.5)
    a = a * cf + cc * angle
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("wedge_sph")
def v_wedge_sph(c, w, P):
    angle, count = P("wedge_sph_angle"), P("wedge_sph_count")
    hole, swirl = P("wedge_sph_hole"), P("wedge_sph_swirl")
    rr = 1.0 / (c.r + EPS)
    a = c.atanyx + swirl * rr
    cc = torch.floor((count * a + PI) * M_1_PI * 0.5)
    comp = 1.0 - angle * count * M_1_PI * 0.5
    a = a * comp + cc * angle
    rr = w * (rr + hole)
    return rr * torch.cos(a), rr * torch.sin(a)


@variation("whorl")
def v_whorl(c, w, P):
    inside, outside = P("whorl_inside"), P("whorl_outside")
    denom = w - c.r
    denom = torch.where(torch.abs(denom) < EPS,
                      torch.where(denom < 0.0, -EPS, EPS), denom)
    a = c.atanyx + torch.where(c.r < w, inside / denom, outside / denom)
    return w * c.r * torch.cos(a), w * c.r * torch.sin(a)


@variation("waves2")
def v_waves2(c, w, P):
    fx, sx = P("waves2_freqx"), P("waves2_scalex")
    fy, sy = P("waves2_freqy"), P("waves2_scaley")
    return (w * (c.tx + sx * torch.sin(c.ty * fx)),
            w * (c.ty + sy * torch.sin(c.tx * fy)))


# -- complex-plane trig family ---------------------------------------------

@variation("exp")
def v_exp(c, w, P):
    e = w * torch.exp(c.tx)
    return e * torch.cos(c.ty), e * torch.sin(c.ty)


@variation("log")
def v_log(c, w, P):
    return w * 0.5 * torch.log(c.r2 + EPS), w * c.atanyx


@variation("sin")
def v_sin(c, w, P):
    return (w * torch.sin(c.tx) * torch.cosh(c.ty),
            w * torch.cos(c.tx) * torch.sinh(c.ty))


@variation("cos")
def v_cos(c, w, P):
    return (w * torch.cos(c.tx) * torch.cosh(c.ty),
            -w * torch.sin(c.tx) * torch.sinh(c.ty))


@variation("tan")
def v_tan(c, w, P):
    den = torch.cos(2.0 * c.tx) + torch.cosh(2.0 * c.ty)
    den = w / torch.where(torch.abs(den) < EPS, EPS, den)
    return den * torch.sin(2.0 * c.tx), den * torch.sinh(2.0 * c.ty)


@variation("sec")
def v_sec(c, w, P):
    den = torch.cos(2.0 * c.tx) + torch.cosh(2.0 * c.ty)
    den = 2.0 * w / torch.where(torch.abs(den) < EPS, EPS, den)
    return (den * torch.cos(c.tx) * torch.cosh(c.ty),
            den * torch.sin(c.tx) * torch.sinh(c.ty))


@variation("csc")
def v_csc(c, w, P):
    den = torch.cosh(2.0 * c.ty) - torch.cos(2.0 * c.tx)
    den = 2.0 * w / torch.where(torch.abs(den) < EPS, EPS, den)
    return (den * torch.sin(c.tx) * torch.cosh(c.ty),
            -den * torch.cos(c.tx) * torch.sinh(c.ty))


@variation("cot")
def v_cot(c, w, P):
    den = torch.cosh(2.0 * c.ty) - torch.cos(2.0 * c.tx)
    den = w / torch.where(torch.abs(den) < EPS, EPS, den)
    return den * torch.sin(2.0 * c.tx), -den * torch.sinh(2.0 * c.ty)


@variation("sinh")
def v_sinh(c, w, P):
    return (w * torch.sinh(c.tx) * torch.cos(c.ty),
            w * torch.cosh(c.tx) * torch.sin(c.ty))


@variation("cosh")
def v_cosh(c, w, P):
    return (w * torch.cosh(c.tx) * torch.cos(c.ty),
            w * torch.sinh(c.tx) * torch.sin(c.ty))


@variation("tanh")
def v_tanh(c, w, P):
    den = torch.cos(2.0 * c.ty) + torch.cosh(2.0 * c.tx)
    den = w / torch.where(torch.abs(den) < EPS, EPS, den)
    return den * torch.sinh(2.0 * c.tx), den * torch.sin(2.0 * c.ty)


@variation("sech")
def v_sech(c, w, P):
    den = torch.cos(2.0 * c.ty) + torch.cosh(2.0 * c.tx)
    den = 2.0 * w / torch.where(torch.abs(den) < EPS, EPS, den)
    return (den * torch.cos(c.ty) * torch.cosh(c.tx),
            -den * torch.sin(c.ty) * torch.sinh(c.tx))


@variation("csch")
def v_csch(c, w, P):
    den = torch.cosh(2.0 * c.tx) - torch.cos(2.0 * c.ty)
    den = 2.0 * w / torch.where(torch.abs(den) < EPS, EPS, den)
    return (den * torch.sinh(c.tx) * torch.cos(c.ty),
            -den * torch.cosh(c.tx) * torch.sin(c.ty))


@variation("coth")
def v_coth(c, w, P):
    den = torch.cosh(2.0 * c.tx) - torch.cos(2.0 * c.ty)
    den = w / torch.where(torch.abs(den) < EPS, EPS, den)
    return den * torch.sinh(2.0 * c.tx), den * torch.sin(2.0 * c.ty)


@variation("auger")
def v_auger(c, w, P):
    sym, aw = P("auger_sym"), P("auger_weight")
    freq, scale = P("auger_freq"), P("auger_scale")
    s = torch.sin(freq * c.tx)
    t = torch.sin(freq * c.ty)
    dy = c.ty + aw * (scale * s * 0.5 + torch.abs(c.ty) * s)
    dx = c.tx + aw * (scale * t * 0.5 + torch.abs(c.tx) * t)
    return w * (c.tx + sym * (dx - c.tx)), w * dy


@variation("flux")
def v_flux(c, w, P):
    spread = P("flux_spread")
    xpw = c.tx + w
    xmw = c.tx - w
    num = torch.sqrt(c.ty * c.ty + xpw * xpw)
    den = torch.sqrt(c.ty * c.ty + xmw * xmw)
    # flam3 var97_flux: avgr = w*(2+spread)*sqrt(d+ / d-) where d+/d-
    # are the focus distances (exactly ONE sqrt of their ratio)
    avgr = w * (2.0 + spread) * torch.sqrt(num / _max(den, EPS))
    avga = (torch.atan2(c.ty, xmw) - torch.atan2(c.ty, xpw)) * 0.5
    return avgr * torch.cos(avga), avgr * torch.sin(avga)


@variation("mobius")
def v_mobius(c, w, P):
    ra, ia = P("mobius_re_a"), P("mobius_im_a")
    rb, ib = P("mobius_re_b"), P("mobius_im_b")
    rc, ic = P("mobius_re_c"), P("mobius_im_c")
    rd, id_ = P("mobius_re_d"), P("mobius_im_d")
    re_u = ra * c.tx - ia * c.ty + rb
    im_u = ra * c.ty + ia * c.tx + ib
    re_v = rc * c.tx - ic * c.ty + rd
    im_v = rc * c.ty + ic * c.tx + id_
    rad = w / (re_v * re_v + im_v * im_v + EPS)
    return (rad * (re_u * re_v + im_u * im_v),
            rad * (im_u * re_v - re_u * im_v))
