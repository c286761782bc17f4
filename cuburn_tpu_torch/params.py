"""Genome values and trajectory state as tensors.

`params_from_genome` carries `Genome.eval_at(t)`'s numpy leaves onto a
device (the JAX package moved the same record with `jnp.asarray`).
`state_from_numpy` builds the port's `IterState` from the leaves of a
JAX `IterState`, and `genome_from_jax` carries a JAX package genome
across as the port's own, so tests can run both packages from the same
genome and trajectories.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuburn_tpu_torch.genome.specs import Genome, GenomeParams
from cuburn_tpu_torch.ops.iterate import IterState
from cuburn_tpu_torch.utils import trace


def genome_from_jax(genome) -> Genome:
    """The port's Genome equal to a JAX package Genome (or anything with
    its `to_json` and `palettes`): through the shared JSON form, with
    the palette keyframes copied as they are, since JSON stores them
    as 8-bit hex."""
    out = Genome.from_json(genome.to_json())
    out.palettes = [(float(t), np.array(p, np.float64))
                    for t, p in genome.palettes]
    return out


def params_from_genome(params: GenomeParams, device) -> GenomeParams:
    """A GenomeParams whose leaves are float32 tensors on `device`: one
    upload a leaf, queued without a wait (`utils/trace.py`)."""
    return GenomeParams(**{
        f.name: trace.upload(np.array(getattr(params, f.name), np.float32),
                             device)
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
