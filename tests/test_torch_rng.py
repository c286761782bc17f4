"""Parity of the PyTorch port's RNG with the JAX package's.

Contract: exact.  The xorshift128 step is integer arithmetic, so the
port's int64-held u32 words must equal the JAX streams (and the numpy
mirror `host_next_bits`) bit for bit; uniforms built from them must
equal as float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.ops import rng as jrng  # noqa: E402
from cuburn_tpu_torch.ops import rng as trng  # noqa: E402


def _state(seed, n=256):
    """(n, 4) uint32 state from a numpy seed, given to both packages."""
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, (n, 4), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_next_bits_exact_over_64_steps():
    s = _state(0)
    j_state, h_state, t_state = jnp.asarray(s), s.copy(), _t(s)
    for _ in range(64):
        j_state, j_bits = jrng.next_bits(j_state)
        h_state, h_bits = jrng.host_next_bits(h_state)
        t_state, t_bits = trng.next_bits(t_state)
        np.testing.assert_array_equal(t_bits.numpy(),
                                      np.asarray(j_bits, np.int64))
        np.testing.assert_array_equal(t_bits.numpy(),
                                      h_bits.astype(np.int64))
    np.testing.assert_array_equal(t_state.numpy(),
                                  np.asarray(j_state, np.int64))


def test_uniform_exact():
    s = _state(1)
    j_state, t_state = jnp.asarray(s), _t(s)
    for _ in range(16):
        j_state, ju = jrng.uniform(j_state)
        t_state, tu = trng.uniform(t_state)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_stream_draw_sequence_exact():
    """A mixed draw sequence (bits, uniform, gaussian_ish) through both
    RngStreams leaves identical draws and identical final state."""
    s = _state(2)
    js, ts = jrng.RngStream(jnp.asarray(s)), trng.RngStream(_t(s))
    for draw in ("bits", "uniform", "gaussian_ish", "uniform", "bits"):
        a = np.asarray(getattr(js, draw)())
        b = getattr(ts, draw)().numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    np.testing.assert_array_equal(ts.state.numpy(),
                                  np.asarray(js.state, np.int64))


def test_seed_from_generator():
    """Port seeding: (n, 4) int64 words in [0, 2^32), deterministic per
    generator seed, different across seeds, and the same state whatever
    device it is moved to."""
    a = trng.seed(torch.Generator().manual_seed(5), 1000)
    b = trng.seed(torch.Generator().manual_seed(5), 1000)
    c = trng.seed(torch.Generator().manual_seed(6), 1000)
    assert a.shape == (1000, 4) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not (a == 0).all(dim=-1).any()
    # every word is a full 32-bit value: the top bit is set about half
    # the time
    assert 0.45 < float(((a >> 31) & 1).float().mean()) < 0.55


def test_seeded_uniforms_statistics():
    state = trng.seed(torch.Generator().manual_seed(0), 10000)
    draws = []
    for _ in range(20):
        state, u = trng.uniform(state)
        draws.append(u.numpy())
    u = np.concatenate(draws)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1 / 12) < 0.01
