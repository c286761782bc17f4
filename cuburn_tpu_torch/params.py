"""Genome values and trajectory state as tensors.

`params_from_genome` carries `Genome.eval_at(t)`'s numpy leaves onto a
device (the JAX package moved the same pytree with `jnp.asarray`).
`state_from_numpy` builds the port's `IterState` from the leaves of a
JAX `IterState`, so tests can run both packages from the same
trajectories.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuburn_tpu.genome.specs import GenomeParams
from cuburn_tpu_torch.ops.iterate import IterState


def params_from_genome(params: GenomeParams, device) -> GenomeParams:
    """A GenomeParams whose leaves are float32 tensors on `device`."""
    return GenomeParams(**{
        f.name: torch.as_tensor(
            np.array(getattr(params, f.name), np.float32), device=device)
        for f in dataclasses.fields(GenomeParams)})


def state_from_numpy(x, y, color, last_xf, age, rng,
                     device="cpu") -> IterState:
    """IterState from numpy arrays: x, y, color (B,) float32; last_xf,
    age (B,) integers; rng (B, 4) uint32 xorshift words."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.array(a, np.int64), device=device)
    return IterState(x=f32(x), y=f32(y), color=f32(color),
                     last_xf=i64(last_xf), age=i64(age), rng=i64(rng))
