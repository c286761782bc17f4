"""Tonemap and color pipeline: logscale, colorclip, downsample, u8.

Port of `cuburn_tpu/ops/filtering.py`.  Images are (H, W, C) float32
tensors, the JAX package's layout, at every public function.  The
supersample reduction is a depthwise strided convolution; on the GPU
it runs with TF32 off (see `no_tf32`) so it stays float32-exact.

Functional forms follow flam3 (rect.c), with colors in [0, 1]:

  logscale:  ls(d) = k1 * log(1 + d*k2) / d,
             k1 = brightness * 268/256,  k2 = ss^2 / quality
  colorclip: alpha = gamma(d) with a linear segment below
             gamma_threshold; vibrancy blends alpha-driven gamma with
             per-channel gamma; highlight_power desaturates >1
             channels toward white; background blend or alpha
             un-premultiply.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from cuburn_tpu_torch.utils import trace

EPS = float(np.float32(1e-9))
_K1 = float(np.float32(268.0 / 256.0))


def no_tf32():
    """cuDNN convolutions in full float32: PyTorch lets cuDNN use TF32
    for float32 convolutions by default, which keeps ~3 decimal
    digits."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False)


def depthwise_conv(x, taps_h, taps_w, stride=(1, 1), padding=(0, 0)):
    """Separable depthwise correlation of (1, C, H, W) with 1-D taps:
    rows with taps_h (stride[0], padding[0]), then columns with taps_w
    (stride[1], padding[1]).  TF32 off."""
    c = x.shape[1]
    kh = taps_h.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = taps_w.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    ctx = no_tf32() if x.is_cuda else contextlib.nullcontext()
    with ctx:
        x = F.conv2d(x, kh, stride=(stride[0], 1),
                     padding=(padding[0], 0), groups=c)
        x = F.conv2d(x, kw, stride=(1, stride[1]),
                     padding=(0, padding[1]), groups=c)
    return x


def logscale(hist, brightness, quality_per_cell):
    """hist (..., 4) raw accumulator -> log-scaled (premultiplied) rgba.
    quality_per_cell = quality / ss^2 (expected samples per cell)."""
    d = hist[..., 3:4]
    k1 = brightness * _K1
    k2 = 1.0 / torch.clamp(quality_per_cell, min=EPS)
    ls = k1 * torch.log1p(d * k2) / torch.clamp(d, min=EPS)
    return hist * ls


def _calc_alpha(density, inv_gamma, linrange):
    """flam3_calc_alpha: power curve with a linear segment below
    gamma_threshold."""
    linrange = torch.clamp(linrange, min=EPS)
    funcval = torch.pow(linrange, inv_gamma)
    frac = density / linrange
    lin = (1.0 - frac) * density * (funcval / linrange) \
        + frac * torch.pow(torch.clamp(density, min=EPS), inv_gamma)
    nonlin = torch.pow(torch.clamp(density, min=EPS), inv_gamma)
    alpha = torch.where(density < linrange, lin, nonlin)
    return torch.where(density > 0.0, alpha, 0.0)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=EPS), 0.0)
    safe_delta = torch.clamp(delta, min=EPS)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)

    def select(*vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v),
                        select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def colorclip(img, gamma, vibrancy, highlight_power, gamma_threshold,
              background, transparent: bool = False):
    """img (..., 4) log-scaled premultiplied rgba -> (..., 4) in [0,1],
    following flam3 rect.c's final accumulation loop."""
    inv_gamma = 1.0 / torch.clamp(gamma, min=EPS)
    d = img[..., 3]
    rgb = img[..., :3]

    alpha = _calc_alpha(d, inv_gamma, gamma_threshold)
    alpha = torch.clamp(alpha, 0.0, 1.0)
    ls = vibrancy * alpha / torch.clamp(d, min=EPS)

    # highlight handling (flam3_calc_newrgb, with 255 -> 1.0 white level)
    maxc = torch.amax(rgb, dim=-1)
    maxa = maxc * ls
    newls = 1.0 / torch.clamp(maxc, min=EPS)
    hp = highlight_power

    # case 1: highpow >= 0 and maxa > 1: rescale to white then desaturate
    lsratio = torch.pow(
        torch.clamp(newls / torch.clamp(ls, min=EPS), min=EPS),
        torch.clamp(hp, min=0.0))
    hsv = _rgb_to_hsv(rgb * newls[..., None])
    hsv = torch.stack([hsv[..., 0], hsv[..., 1] * lsratio, hsv[..., 2]],
                      dim=-1)
    rgb_hi = _hsv_to_rgb(hsv)

    # case 2: highpow < 0 (or maxa <= 1): blend of newls and ls
    adjhlp = torch.clamp(-hp, 0.0, 1.0)
    adjhlp = torch.where(maxa <= 1.0, 1.0, adjhlp)
    k = (1.0 - adjhlp) * newls + adjhlp * ls
    rgb_lo = rgb * k[..., None]

    use_hi = (hp >= 0.0) & (maxa > 1.0)
    newrgb = torch.where(use_hi[..., None], rgb_hi, rgb_lo)

    # vibrancy blend: add (1 - vib) * per-channel gamma; pow(0, g) = 0
    newrgb = newrgb + (1.0 - vibrancy) * \
        torch.pow(torch.clamp(rgb, min=0.0), inv_gamma)

    if transparent:
        newrgb = newrgb / torch.clamp(alpha[..., None], min=EPS)
        out_a = alpha
    else:
        newrgb = newrgb + (1.0 - alpha[..., None]) * background
        out_a = torch.ones_like(alpha)
    return torch.cat([torch.clamp(newrgb, 0.0, 1.0), out_a[..., None]],
                     dim=-1)


# -- flam3 spatial filter kernel family --------------------------------------
# (flam3 filters.c flam3_create_spatial_filter; each entry is
# (support, f(x)) with x in [0, support]).  numpy, evaluated once per
# filter geometry.

def _sinc(x):
    x = np.where(x == 0, 1e-9, x) * np.pi
    return np.sin(x) / x


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    ax = np.abs(x)
    p0 = (6.0 - 2.0 * b) / 6.0
    p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
    p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
    q0 = (8.0 * b + 24.0 * c) / 6.0
    q1 = (-12.0 * b - 48.0 * c) / 6.0
    q2 = (6.0 * b + 30.0 * c) / 6.0
    q3 = (-b - 6.0 * c) / 6.0
    return np.where(
        ax < 1.0, p0 + ax * ax * (p2 + ax * p3),
        np.where(ax < 2.0, q0 + ax * (q1 + ax * (q2 + ax * q3)), 0.0))


def _catrom(x):
    ax = np.abs(x)
    return np.where(
        ax < 1.0, 1.0 - ax * ax * (2.5 - 1.5 * ax),
        np.where(ax < 2.0,
                 2.0 - ax * (4.0 - ax * (2.5 - 0.5 * ax)), 0.0))


def _quadratic(x):
    ax = np.abs(x)
    return np.where(ax < 0.5, 0.75 - ax * ax,
                    np.where(ax < 1.5, 0.5 * (ax - 1.5) ** 2, 0.0))


def _bspline(x):
    ax = np.abs(x)
    return np.where(
        ax < 1.0, (4.0 + ax * ax * (-6.0 + 3.0 * ax)) / 6.0,
        np.where(ax < 2.0, ((2.0 - ax) ** 3) / 6.0, 0.0))


SPATIAL_FILTERS = {
    "gaussian": (1.5, lambda x: np.exp(-2.0 * x * x)),
    "box": (0.5, lambda x: (np.abs(x) < 0.5).astype(np.float64)),
    "triangle": (1.0, lambda x: np.maximum(1.0 - np.abs(x), 0.0)),
    "hermite": (1.0, lambda x: np.where(
        np.abs(x) < 1.0,
        (2.0 * np.abs(x) - 3.0) * x * x + 1.0, 0.0)),
    "bell": (1.5, _quadratic),
    "quadratic": (1.5, _quadratic),
    "b_spline": (2.0, _bspline),
    "mitchell": (2.0, _mitchell),
    "catrom": (2.0, _catrom),
    "lanczos2": (2.0, lambda x: np.where(np.abs(x) < 2.0,
                                         _sinc(x) * _sinc(x / 2.0),
                                         0.0)),
    "lanczos3": (3.0, lambda x: np.where(np.abs(x) < 3.0,
                                         _sinc(x) * _sinc(x / 3.0),
                                         0.0)),
    "blackman": (1.0, lambda x: 0.42 + 0.5 * np.cos(np.pi * x)
                 + 0.08 * np.cos(2.0 * np.pi * x)),
    "hamming": (1.0, lambda x: 0.54 + 0.46 * np.cos(np.pi * x)),
    "hanning": (1.0, lambda x: 0.5 + 0.5 * np.cos(np.pi * x)),
}


def spatial_filter_taps(shape: str, radius: float, ss: int):
    """flam3's spatial filter row: width fw = 2 * support * ss * radius
    accumulator pixels, rounded up with parity matched to ss; samples
    at cell centers stretched by flam3's `adjust`; sum-normalized.
    Returns float32 numpy taps."""
    if shape not in SPATIAL_FILTERS:
        raise ValueError(f"unknown spatial filter {shape!r}; have "
                         f"{sorted(SPATIAL_FILTERS)}")
    support, fn = SPATIAL_FILTERS[shape]
    fw = 2.0 * support * ss * radius
    fwidth = int(fw) + 1
    if (fwidth ^ ss) & 1:
        fwidth += 1
    fwidth = max(fwidth, ss)
    adjust = support * fwidth / fw if fw > 0 else 1.0
    x = ((2.0 * np.arange(fwidth) + 1.0) / fwidth - 1.0) * adjust
    t = fn(np.abs(x)).astype(np.float64)
    s = t.sum()
    if s <= 0:
        raise ValueError(
            f"degenerate spatial filter {shape!r} radius {radius}")
    return (t / s).astype(np.float32)


def downsample(img, ss: int, spatial_filter: float = 0.0,
               filter_shape: str = "gaussian", gutter=0):
    """Supersample reduction: gutter-framed accumulator -> (H, W, C).

    `spatial_filter` (output-pixel units) is flam3's `filter` and
    `filter_shape` its kernel family: each output pixel is the
    kernel-weighted window of accumulator cells at stride ss.  Radius
    <= 0 is a plain box average.  `gutter` (int, or (gy, gx)) is real
    border context: the filtered path keeps `pad` of it so edge pixels
    read true accumulator data, zero-padding any shortfall."""
    gy, gx = (gutter, gutter) if isinstance(gutter, int) else gutter
    H, W, C = img.shape
    if not spatial_filter or spatial_filter <= 0.0:
        img = img[gy:H - gy if gy else H, gx:W - gx if gx else W]
        if ss == 1:
            return img
        hs, ws, c = img.shape
        h, w = hs // ss, ws // ss
        return img.reshape(h, ss, w, ss, c).mean(dim=(1, 3))
    taps = trace.upload(
        spatial_filter_taps(filter_shape, float(spatial_filter), ss),
        img.device)
    fwidth = taps.shape[0]
    pad = (fwidth - ss) // 2
    py, px = max(pad - gy, 0), max(pad - gx, 0)
    img = img[max(gy - pad, 0):H - gy + pad,
              max(gx - pad, 0):W - gx + pad]
    if py or px:
        img = F.pad(img, (0, 0, px, px, py, py))
    x = img.permute(2, 0, 1)[None]                 # (1, C, H, W)
    x = depthwise_conv(x, taps, taps, stride=(ss, ss))
    return x[0].permute(1, 2, 0)


def to_u8(img):
    """float [0,1] -> uint8 with rounding."""
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
