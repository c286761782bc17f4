"""Packed-knot genome interpolation: all animated parameters at all
temporal-sample times of a frame in one batched evaluation.

Port of `cuburn_tpu/ops/interp.py`.  The genome's spline knots are
packed once into (P, Kmax) tables on the device; a motion-blurred frame
evaluates every packed parameter at its T shutter times in float32
there, so the host does not walk the genome T times a frame.  JAX's
`vmap` over times is a broadcast over a leading T axis here, with the
arithmetic in the same order.

Semantics match genome/spline.py `Spline.evaluate` (non-uniform
Catmull-Rom, end clamping).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

import numpy as np
import torch

from cuburn_tpu_torch.genome.specs import (IDENTITY_AFFINE, Genome,
                                           GenomeParams)
from cuburn_tpu_torch.genome.spline import Spline
from cuburn_tpu_torch.genome.variations import PARAM_DEFAULTS
from cuburn_tpu_torch.utils import trace


@dataclasses.dataclass
class PackedGenome:
    """Device-resident knot tables + the slot of every GenomeParams leaf.

    knot_t / knot_v: (P, Kmax) f32, padded by repeating the last knot
    counts:          (P,) int64 -- real knots per slot
    palettes:        (Q, 256, 3) f32 keyframes, palette_times (Q,)
    slots:           leaf name -> its slot: a Python int for a scalar
                     leaf, an int64 index tensor on the device otherwise
    zoom:            the zoom's slot (ppu is scale * 2^zoom)
    """
    knot_t: torch.Tensor
    knot_v: torch.Tensor
    counts: torch.Tensor
    palettes: torch.Tensor
    palette_times: torch.Tensor
    slots: Dict[str, Union[int, torch.Tensor]]
    zoom: int

    def eval_params(self, ts) -> GenomeParams:
        """Evaluate at times ts (T,) -> GenomeParams with a leading
        temporal axis (T, ...) on every leaf; `sample_params` takes
        sample k.  Queues one upload and reads nothing back: a scalar
        leaf's slot is a host int."""
        ts = trace.upload(np.atleast_1d(np.asarray(ts, np.float32)),
                          self.knot_t.device)
        vals = eval_packed(self.knot_t, self.knot_v, self.counts, ts)
        leaves = {name: vals[:, ix] for name, ix in self.slots.items()}
        # flam3 zoom: effective ppu = scale * 2^zoom (specs.eval_at)
        leaves["ppu"] = leaves["ppu"] * 2.0 ** vals[:, self.zoom]
        return GenomeParams(
            palette=_palette_at(self.palettes, self.palette_times, ts),
            **leaves)


def sample_params(params_T: GenomeParams, k: int) -> GenomeParams:
    """Temporal sample k of an `eval_params` result."""
    return GenomeParams(**{
        f.name: getattr(params_T, f.name)[k]
        for f in dataclasses.fields(GenomeParams)})


def eval_packed(knot_t, knot_v, counts, ts):
    """Batched non-uniform Catmull-Rom: (P, K) knots at (T,) times ->
    (T, P) values.  Mirrors Spline.evaluate."""
    counts = counts.to(torch.int64)
    slot = torch.arange(knot_t.shape[0], device=knot_t.device)[None, :]
    t = ts[:, None]                                      # (T, 1)

    def g(arr, idx):
        return arr[slot, idx]                            # (T, P)

    # segment index per slot; a one-knot slot has its upper bound under
    # the lower one and comes out at -1, which the maximum lifts to 0
    i = (knot_t[None] <= t[:, :, None]).sum(dim=2) - 1   # (T, P)
    i = torch.clamp(i, min=torch.zeros_like(counts), max=counts - 2)
    i = torch.clamp(i, min=0)
    im1 = torch.clamp(i - 1, min=0)
    ip1 = torch.minimum(i + 1, counts - 1)
    ip2 = torch.minimum(i + 2, counts - 1)
    t0, t1 = g(knot_t, i), g(knot_t, ip1)
    p0, p1, p2, p3 = (g(knot_v, im1), g(knot_v, i),
                      g(knot_v, ip1), g(knot_v, ip2))
    t_prev, t_next = g(knot_t, im1), g(knot_t, ip2)
    dt = torch.where(t1 > t0, t1 - t0, 1.0)
    s = torch.clamp((t - t0) / dt, 0.0, 1.0)
    d_prev = torch.where(t1 - t_prev > 0, t1 - t_prev, 1.0)
    d_next = torch.where(t_next - t0 > 0, t_next - t0, 1.0)
    m1 = (p2 - p0) * dt / d_prev
    m2 = (p3 - p1) * dt / d_next
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    out = h00 * p1 + h10 * m1 + h01 * p2 + h11 * m2
    first_t = knot_t[:, 0]
    last_idx = torch.clamp(counts - 1, min=0)[None, :]
    last_t = g(knot_t, last_idx)
    first_v = knot_v[:, 0]
    last_v = g(knot_v, last_idx)
    out = torch.where(t <= first_t, first_v, out)
    out = torch.where(t >= last_t, last_v, out)
    out = torch.where(counts == 1, first_v, out)
    return out


def _palette_at(palettes, times, ts):
    """(Q, 256, 3) keyframes at (T,) times -> (T, 256, 3), linear."""
    q = palettes.shape[0]
    if q == 1:
        return palettes[0].expand(ts.shape[0], -1, -1)
    hi = torch.clamp((times[None, :] <= ts[:, None]).sum(dim=1), 1, q - 1)
    lo = hi - 1
    t0, t1 = times[lo], times[hi]
    w = torch.where(
        t1 > t0,
        (ts - t0) / torch.clamp(t1 - t0, min=float(np.float32(1e-20))),
        0.0)
    w = torch.clamp(w, 0.0, 1.0)[:, None, None]
    return (1.0 - w) * palettes[lo] + w * palettes[hi]


def pack_genome(genome: Genome, device="cpu") -> PackedGenome:
    """Walk the genome exactly like Genome.eval_at and register every
    spline into packed knot tables on `device`."""
    key = genome.structure_key()
    n = len(genome.xforms)
    splines: List[Spline] = []

    def reg(s) -> int:
        splines.append(s)
        return len(splines) - 1

    def reg_affine(coefs):
        return [reg(c) for c in coefs]

    idx = {}
    idx["weights"] = [reg(xf.weight) for xf in genome.xforms]
    idx["affine"] = [reg_affine(xf.affine) for xf in genome.xforms]
    const = lambda v: reg(Spline(v))
    idx["post"] = [
        reg_affine(xf.post) if xf.post is not None
        else [const(v) for v in IDENTITY_AFFINE]
        for xf in genome.xforms]
    idx["color"] = [reg(xf.color) for xf in genome.xforms]
    idx["color_speed"] = [reg(xf.color_speed) for xf in genome.xforms]
    idx["opacity"] = [reg(xf.opacity) for xf in genome.xforms]

    # empty vars = implicit linear weight 1 (Genome.eval_at's rule)
    idx["var_weights"] = [
        [reg(xf.vars[v]) if v in xf.vars
         else const(1.0 if (not xf.vars and v == "linear") else 0.0)
         for v in key.variations]
        for xf in genome.xforms]
    slots = key.param_slots
    idx["var_params"] = [
        [reg(xf.params[attr]) if attr in xf.params
         else const(_param_default(attr))
         for (_v, attr) in slots] or [const(0.0)]
        for xf in genome.xforms]

    if genome.xaos is not None:
        idx["xaos"] = [[reg(v) for v in row] for row in genome.xaos]
    else:
        idx["xaos"] = [[const(1.0)] * n for _ in range(n)]

    fx = genome.final_xform
    if fx is not None:
        fvars = key.final_variations
        idx["final_affine"] = reg_affine(fx.affine)
        idx["final_post"] = (reg_affine(fx.post) if fx.post is not None
                             else [const(v) for v in IDENTITY_AFFINE])
        idx["final_color"] = reg(fx.color)
        idx["final_color_speed"] = reg(fx.color_speed)
        idx["final_var_weights"] = [
            reg(fx.vars[v]) if v in fx.vars
            else const(1.0 if (not fx.vars and v == "linear") else 0.0)
            for v in fvars]
        fslots = key.final_param_slots
        idx["final_var_params"] = [
            reg(fx.params[attr]) if attr in fx.params
            else const(_param_default(attr))
            for (_v, attr) in fslots] or [const(0.0)]
    else:
        idx["final_affine"] = [const(v) for v in IDENTITY_AFFINE]
        idx["final_post"] = [const(v) for v in IDENTITY_AFFINE]
        idx["final_color"] = const(0.0)
        idx["final_color_speed"] = const(0.0)
        idx["final_var_weights"] = [const(0.0)]
        idx["final_var_params"] = [const(0.0)]

    idx["center"] = [reg(genome.center[0]), reg(genome.center[1])]
    rc = genome.rot_center or genome.center
    idx["rot_center"] = [reg(rc[0]), reg(rc[1])]
    idx["ppu"] = reg(genome.scale)
    zoom = reg(genome.zoom)
    idx["rotate"] = reg(genome.rotate)
    for name in ("brightness", "gamma", "gamma_threshold", "vibrancy",
                 "highlight_power"):
        idx[name] = reg(getattr(genome, name))
    idx["background"] = [reg(s) for s in genome.background]
    idx["estimator_radius"] = reg(genome.estimator_radius)
    idx["estimator_minimum"] = reg(genome.estimator_minimum)
    idx["estimator_curve"] = reg(genome.estimator_curve)
    idx["spatial_filter"] = reg(genome.spatial_filter)
    idx["cam3d"] = [reg(getattr(genome, k)) for k in
                    ("cam_yaw", "cam_pitch", "cam_perspective",
                     "cam_zpos", "cam_dof")]

    # pack knots
    kmax = max(len(s.knots) for s in splines)
    P = len(splines)
    knot_t = np.zeros((P, kmax), np.float32)
    knot_v = np.zeros((P, kmax), np.float32)
    counts = np.zeros((P,), np.int64)
    for p, s in enumerate(splines):
        k = len(s.knots)
        knot_t[p, :k] = s.knots[:, 0]
        knot_v[p, :k] = s.knots[:, 1]
        # pad by repeating the final knot (keeps the search monotone)
        knot_t[p, k:] = s.knots[-1, 0]
        knot_v[p, k:] = s.knots[-1, 1]
        counts[p] = k

    pal_times = np.asarray([t for t, _ in genome.palettes], np.float32)
    pals = np.stack([p for _, p in genome.palettes]).astype(np.float32)

    def on_device(a):
        return trace.upload(a, device)

    def slot(ix):
        a = np.asarray(ix, np.int64)
        return int(a) if a.ndim == 0 else on_device(a)

    return PackedGenome(
        knot_t=on_device(knot_t), knot_v=on_device(knot_v),
        counts=on_device(counts), palettes=on_device(pals),
        palette_times=on_device(pal_times),
        slots={name: slot(ix) for name, ix in idx.items()}, zoom=zoom)


def _param_default(attr: str) -> float:
    # PARAM_DEFAULTS is the flat attr -> default map the schema
    # maintains (genome/variations.py guarantees attr-name uniqueness)
    return PARAM_DEFAULTS[attr]
