"""Per-trajectory xorshift128 RNG streams for the chaos game.

Port of `cuburn_tpu/ops/rng.py`: every trajectory owns four 32-bit
words of Marsaglia xorshift128 state, and a step yields one 32-bit
word.  The step arithmetic is bit-exact with the JAX package's
`next_bits` and its numpy mirror `host_next_bits`.

PyTorch has no usable uint32 shifts on the CPU, so state and draws are
int64 tensors holding values in [0, 2^32): every left shift is masked
back to 32 bits, and right shifts of non-negative values are logical.
"""

from __future__ import annotations

import torch

from cuburn_tpu_torch.utils import trace

MASK32 = 0xFFFFFFFF
# 1/2^24 — uniforms are built from the top 24 bits so they are exact f32.
_INV24 = 1.0 / (1 << 24)
_NONZERO_WORD = 0x9E3779B9


def seed(generator: torch.Generator, n: int,
         device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-lane RNG state (n, 4) int64 drawn from a torch.Generator.

    This replaces the JAX package's threefry seeding, so the streams
    differ from JAX's for the same integer seed; parity tests inject
    JAX-made state instead (`cuburn_tpu_torch.params.state_from_numpy`).
    The state is drawn on the generator's device and then moved (from a
    CPU generator, an upload queued without a wait), so one seed gives
    the same trajectories on every device.  A lane whose four words are
    all zero would stay zero forever, so it gets one nonzero word."""
    bits = torch.randint(0, 1 << 32, (n, 4), generator=generator,
                         dtype=torch.int64, device=generator.device)
    row_zero = (bits == 0).all(dim=-1)
    bits[:, 0] = torch.where(row_zero, _NONZERO_WORD, bits[:, 0])
    return trace.upload(bits, device)


def _step(x, y, z, w):
    """One xorshift128 step on the four state words: x^=x<<11;
    x^=x>>8; w^=w>>19; w^=x; rotate words.  Returns the new words."""
    t = x ^ ((x << 11) & MASK32)
    t = t ^ (t >> 8)
    w_new = (w ^ (w >> 19)) ^ t
    return y, z, w, w_new


def next_bits(state: torch.Tensor):
    """Advance every lane one step: (new_state (B, 4), bits (B,))."""
    words = _step(*state.unbind(-1))
    return torch.stack(words, dim=-1), words[3]


def uniform(state: torch.Tensor):
    """(new_state, u) with u ~ U[0,1) float32, one per lane."""
    state, bits = next_bits(state)
    return state, (bits >> 8).to(torch.float32) * _INV24


class RngStream:
    """Threads RNG state through one iteration's variation bodies.

    Variations call `uniform()` / `bits()` as many times as they need;
    the stream keeps the four words apart between draws and stacks
    them only when `state` is read."""

    def __init__(self, state: torch.Tensor):
        self._words = state.unbind(-1)

    @property
    def state(self) -> torch.Tensor:
        return torch.stack(self._words, dim=-1)

    def bits(self) -> torch.Tensor:
        self._words = _step(*self._words)
        return self._words[3]

    def uniform(self) -> torch.Tensor:
        return (self.bits() >> 8).to(torch.float32) * _INV24

    def gaussian_ish(self) -> torch.Tensor:
        """Sum-of-4-uniforms minus 2: flam3/cuburn's cheap approximate
        Gaussian used by gaussian_blur / radial_blur / pre_blur."""
        return (self.uniform() + self.uniform() +
                self.uniform() + self.uniform() - 2.0)
