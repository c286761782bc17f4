"""What the bench tools share: the device and its name, the
total-variation helpers of `bench/tpuparity.py:63-69`, the per-bin
differential of `bench.py:177-203`, full_feature's chaos game at one
geometry, and the kernels' launch counters."""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import numpy as np
import torch

from cuburn_tpu_torch.device import resolve_device
from cuburn_tpu_torch.models import full_feature
from cuburn_tpu_torch.ops import chaos
from cuburn_tpu_torch.ops import flush as flush_mod
from cuburn_tpu_torch.ops import tiled_sort
from cuburn_tpu_torch.ops.camera import CameraSpec
from cuburn_tpu_torch.ops.iterate import (IterState, init_state,
                                          iterate_records, record_bits,
                                          xform_cdf_rows)
from cuburn_tpu_torch.params import params_from_genome


def card(cpu: bool):
    """(device, name): the CPU, named "cpu", when `cpu`; else the CUDA
    device (RuntimeError when there is none), named by its name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them."""
    device = resolve_device("cpu" if cpu else None)
    if device.type == "cpu":
        return device, "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return device, out.stdout.strip().splitlines()[0]


def density(hist):
    """The normalised density column of a logical histogram (numpy),
    junk bin dropped."""
    d = np.asarray(hist, np.float64)[:-1, 3]
    return d / d.sum()


def tv(a, b):
    """Total-variation distance between two histograms' densities."""
    return 0.5 * np.abs(density(a) - density(b)).sum()


def bin_differential(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Two logical histograms without their junk bin, `a` the
    reference: the mass ratio b / a, the largest density difference of
    a bin (identical trajectories give integer counts in float32, so 0.0
    in any accumulation order), and the largest rgb difference of a bin
    relative to its density in `a` (at least 1): the two backends round
    the palette coordinate to different widths and add in different
    orders."""
    ms = float(torch.sum(a[:, 3]))
    mw = float(torch.sum(b[:, 3]))
    rgb_rel = float(torch.max(torch.abs(a[:, :3] - b[:, :3])
                              / torch.clamp(a[:, 3:4], min=1.0)))
    return {"mass_parity": round(mw / max(ms, 1e-9), 6),
            "max_bin_err_density": float(torch.max(torch.abs(
                a[:, 3] - b[:, 3]))),
            "max_bin_err_rgb_rel": round(rgb_rel, 6)}


@dataclass
class Chaos:
    """full_feature's chaos game at t = 0 through a width x height
    camera at ss 1, as the JAX tools set it up."""
    key: object
    cam: CameraSpec
    params: object
    cdf: torch.Tensor
    ppu: torch.Tensor

    @classmethod
    def full_feature(cls, width: int, height: int, device) -> "Chaos":
        g = full_feature()
        params = params_from_genome(g.eval_at(0.0), device)
        return cls(key=g.structure_key(), cam=CameraSpec(width, height, 1),
                   params=params, cdf=xform_cdf_rows(params),
                   ppu=params.ppu * float(np.float32(width / g.size[0])))

    def state(self, batch: int, device) -> IterState:
        """The tools' trajectories: seed 0."""
        return init_state(torch.Generator().manual_seed(0), batch, device)

    def iterate_only(self, state: IterState, n_chunks: int,
                     iters_per_chunk: int) -> IterState:
        """n_chunks chunks of the chaos game (fuse 32), nothing flushed.
        The kernel writes every chunk's packed record log (the
        pallas_win layout) all the same, so this ceiling includes those
        writes."""
        cbits, tot_bits = record_bits(self.key, self.cam, "pallas_win")
        plan = chaos.plan(self.key, self.cam, self.params, self.cdf,
                          self.ppu, 32, cbits, tot_bits)
        recs = torch.empty((iters_per_chunk, state.x.shape[0]),
                           dtype=torch.int64, device=state.x.device)
        for _ in range(n_chunks):
            state = iterate_records(plan, state, recs)
        return state


COUNTERS = (chaos.LAUNCHES, flush_mod.LAUNCHES, tiled_sort.LAUNCHES)


def reset_launches() -> None:
    for counts in COUNTERS:
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    """The render path's kernel launches since the last reset, those
    that launched."""
    return {k: v for counts in COUNTERS for k, v in counts.items() if v}
