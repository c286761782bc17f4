"""Branch-free xform application over the whole point batch.

Port of `cuburn_tpu/ops/xform.py`.  Every per-xform parameter sits in
one (N, K) table; each point fetches its xform's row, and each distinct
variation of the genome's union set is evaluated once per point with
per-point weights (zero where the point's xform does not use it).

The JAX package fetches rows with a one-hot matmul at HIGHEST
precision, which is exact.  Here the fetch is a gather (`table[idx]`),
exact with no tensor cores involved.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flamebench.reference.specs import StructureKey
from flamebench.reference import variations as V
from flamebench.reference.rng import RngStream

_TWO_PI = float(np.float32(2.0 * np.pi))


def _apply_affine(aff, x, y):
    a, b, c, d, e, f = (aff[..., i] for i in range(6))
    return a * x + b * y + c, d * x + e * y + f


def _param_accessor(param_slots, gathered_params):
    """Build P(attr) -> per-point tensor, resolving packed slots."""
    slot_of = {attr: i for i, (_v, attr) in enumerate(param_slots)}

    def P(attr: str):
        return gathered_params[..., slot_of[attr]]
    return P


def apply_variation_stack(
    var_names: Tuple[str, ...],
    param_slots,
    tx, ty,
    var_weights,       # (..., V) gathered per-point weights
    var_params,        # (..., P) gathered per-point parametric knobs
    affine_rows,       # (..., 6) the xform's own affine (for waves etc.)
    rng: RngStream,
):
    """Evaluate the weighted variation sum at (tx, ty) (post-affine)."""
    P = _param_accessor(param_slots, var_params)
    aff = tuple(affine_rows[..., i] for i in range(6))

    # pre_blur perturbs the input point before the variation sum and
    # before the precalc values are derived
    if "pre_blur" in var_names:
        i = var_names.index("pre_blur")
        w_pb = var_weights[..., i]
        g = w_pb * rng.gaussian_ish()
        a = _TWO_PI * rng.uniform()
        tx = tx + g * torch.cos(a)
        ty = ty + g * torch.sin(a)

    ctx = V.make_ctx(tx, ty, aff, rng)
    ox = torch.zeros_like(tx)
    oy = torch.zeros_like(ty)
    for i, name in enumerate(var_names):
        if name == "pre_blur":
            continue
        dx, dy = V.VARIATION_IMPLS[name](ctx, var_weights[..., i], P)
        ox = ox + dx
        oy = oy + dy
    return ox, oy


def build_xform_table(key: StructureKey, params) -> torch.Tensor:
    """Every per-xform parameter in one (N, K) tensor.

    Column layout: [affine 0:6][color][speed][opacity]
                   [post 9:15 when has_post][var_weights][var_params]."""
    cols = [params.affine,
            params.color[:, None], params.color_speed[:, None],
            params.opacity[:, None]]
    if key.has_post:
        cols.append(params.post)
    cols.append(params.var_weights)
    cols.append(params.var_params)
    return torch.cat(cols, dim=1)


def select_and_fetch(key: StructureKey, cdf_rows, table, last_xf, u):
    """Xform selection by CDF (row `last_xf` of `cdf_rows` under xaos)
    and the gather of the selected xform's parameter row.
    Returns (xf_idx (B,) int64, row (B, K))."""
    if key.has_xaos:
        cdf = cdf_rows[last_xf]                         # (B, N)
    else:
        cdf = cdf_rows[0][None, :]
    step = u[:, None] >= cdf
    idx = torch.clamp(step.sum(dim=1), max=key.n_xforms - 1)
    return idx, table[idx]


def apply_xforms(
    key: StructureKey,
    params,            # GenomeParams of tensors
    row,               # (B, K) fetched parameter rows
    x, y, color,       # (B,) point state
    rng: RngStream,
):
    """One chaos-game step body: affine -> variations -> post -> color.
    Returns (nx, ny, ncolor, opacity)."""
    n_vars = len(key.variations)
    n_par = max(len(key.param_slots), 1)
    aff = row[:, 0:6]
    xf_color = row[:, 6]
    speed = row[:, 7]
    opacity = row[:, 8]
    off = 9
    if key.has_post:
        post = row[:, off:off + 6]
        off += 6
    vw = row[:, off:off + n_vars]
    vp = row[:, off + n_vars:off + n_vars + n_par]

    tx, ty = _apply_affine(aff, x, y)
    ox, oy = apply_variation_stack(
        key.variations, key.param_slots, tx, ty, vw, vp, aff, rng)

    if key.has_post:
        ox, oy = _apply_affine(post, ox, oy)

    ncolor = color * (1.0 - speed) + xf_color * speed
    return ox, oy, ncolor, opacity


def apply_final_xform(key: StructureKey, params, x, y, color,
                      rng: RngStream):
    """Display-only final xform, applied to a copy of the point for
    plotting and never fed back."""
    if key.final_variations is None:
        return x, y, color
    shape = x.shape
    aff = params.final_affine.expand(shape + (6,))
    vw = params.final_var_weights.expand(
        shape + params.final_var_weights.shape)
    vp = params.final_var_params.expand(
        shape + params.final_var_params.shape)
    tx, ty = _apply_affine(aff, x, y)
    ox, oy = apply_variation_stack(
        key.final_variations, key.final_param_slots,
        tx, ty, vw, vp, aff, rng)
    if key.final_has_post:
        post = params.final_post.expand(shape + (6,))
        ox, oy = _apply_affine(post, ox, oy)
    speed = params.final_color_speed
    ncolor = color * (1.0 - speed) + params.final_color * speed
    return ox, oy, ncolor
