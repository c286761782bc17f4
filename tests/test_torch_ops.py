"""Parity of the PyTorch port's chaos-game ops with the JAX package's.

Every test feeds the same numpy-made inputs to the JAX function and to
its port.  Contracts:

- camera: integer addresses equal except at float ulp boundaries
  (>= 99.9% of points);
- variations, at points with r > 1e-3: |port - jax64| <= 1e-4 |jax64|
  + 8 spread + 8 ulp * (1 + r), where jax64 is the JAX formula run in
  float64 (under `jax.enable_x64`), a reference independent of the
  port, and spread is the largest change of jax64 when tx, ty or the
  weight moves by one float32 ulp.  The spread is the formula's
  conditioning at the point: it decides the last digits wherever
  float32 cancels (tan near its poles, differences of nearly equal
  terms), on any machine, where the error of one float32 run of JAX
  depends on the code XLA made for the host.  The ulp term covers
  cancellation between terms of the input's magnitude;
- xform selection, record packing and the respawn hash: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.extend.core  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.genome.variations import VARIATION_PARAMS  # noqa: E402
from cuburn_tpu.models import (classic_swirl, full_feature,  # noqa: E402
                               sierpinski)
from cuburn_tpu.ops import camera as jcam  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu.ops import rng as jrng  # noqa: E402
from cuburn_tpu.ops import variations as jvar  # noqa: E402
from cuburn_tpu.ops import xform as jxf  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch.ops import camera as tcam  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops import rng as trng  # noqa: E402
from cuburn_tpu_torch.ops import variations as tvar  # noqa: E402
from cuburn_tpu_torch.ops import xform as txf  # noqa: E402

B = 4096
_ULP8 = 8.0 * 2.0 ** -24


def _u32_state(seed, n=B):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, (n, 4), dtype=np.uint64).astype(np.uint32)


def _jparams(g, t=0.0):
    return jax.tree_util.tree_map(jnp.asarray, g.eval_at(t))


# -- camera -----------------------------------------------------------------

@pytest.mark.parametrize("rotate,rot_center", [
    (0.0, None), (33.0, None), (-71.5, (0.31, -0.2))])
def test_project_addresses(rotate, rot_center):
    rs = np.random.RandomState(3)
    x = rs.uniform(-1.5, 1.5, 20000).astype(np.float32)
    y = rs.uniform(-1.5, 1.5, 20000).astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, 1e30, 0, 0, 0, 0]
    center = np.array([0.05, -0.1], np.float32)
    rc = None if rot_center is None else np.array(rot_center, np.float32)
    ppu = np.float32(41.3)
    jspec = jcam.CameraSpec(96, 64, 2, no_rotation=rotate == 0.0,
                            gutter=5)
    tspec = tcam.CameraSpec(96, 64, 2, no_rotation=rotate == 0.0,
                            gutter=5)
    ja, jin = jcam.project(
        jspec, jnp.asarray(center), jnp.asarray(ppu),
        jnp.float32(rotate), jnp.asarray(x), jnp.asarray(y),
        rot_center=None if rc is None else jnp.asarray(rc))
    ta, tin = tcam.project(
        tspec, torch.as_tensor(center), torch.as_tensor(ppu),
        torch.tensor(rotate, dtype=torch.float32), torch.as_tensor(x),
        torch.as_tensor(y),
        rot_center=None if rc is None else torch.as_tensor(rc))
    ja, jin = np.asarray(ja), np.asarray(jin)
    assert (ta.numpy() == ja).mean() >= 0.999
    assert (tin.numpy() == jin).mean() >= 0.999
    assert (ta.numpy()[:4] == tspec.junk_bin).all()
    assert tspec.n_bins == jspec.n_bins


def test_project_3d_matches():
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, 5000).astype(np.float32)
    y = rs.uniform(-1, 1, 5000).astype(np.float32)
    u1, u2 = (rs.rand(5000).astype(np.float32) for _ in range(2))
    cam3d = np.array([0.15, 0.55, 0.35, 1.0, 0.12], np.float32)
    jx, jy = jcam.project_3d(jnp.asarray(cam3d), jnp.asarray(x),
                             jnp.asarray(y), jnp.asarray(u1),
                             jnp.asarray(u2))
    tx, ty = tcam.project_3d(torch.as_tensor(cam3d), torch.as_tensor(x),
                             torch.as_tensor(y), torch.as_tensor(u1),
                             torch.as_tensor(u2))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


# -- variations -------------------------------------------------------------

def test_variation_registry_complete():
    """Every JAX registry entry is ported (ROADMAP lists none as left)."""
    assert set(tvar.VARIATION_IMPLS) == set(jvar.VARIATION_IMPLS)


def _points():
    rs = np.random.RandomState(11)
    tx = rs.uniform(-2.0, 2.0, B).astype(np.float32)
    ty = rs.uniform(-2.0, 2.0, B).astype(np.float32)
    return tx, ty


_AFFINE = (1.1, 0.2, 0.3, -0.2, 0.9, 0.15)


def _run_torch(name, tx, ty, state, params, w):
    n = tx.shape[0]
    f32 = torch.float32
    stream = trng.RngStream(torch.as_tensor(state.astype(np.int64)))
    aff = tuple(torch.full((n,), v, dtype=f32) for v in _AFFINE)
    ctx = tvar.make_ctx(torch.as_tensor(tx), torch.as_tensor(ty), aff,
                        stream)
    dx, dy = tvar.VARIATION_IMPLS[name](
        ctx, torch.full((n,), w, dtype=f32),
        lambda a: torch.full((n,), params[a], dtype=f32))
    return dx.double().numpy(), dy.double().numpy()


def _run_jax(name, tx, ty, state, params, w, dtype):
    n = tx.shape[0]
    stream = jrng.RngStream(jnp.asarray(state))
    aff = tuple(jnp.full((n,), v, dtype) for v in _AFFINE)
    ctx = jvar.make_ctx(jnp.asarray(tx, dtype), jnp.asarray(ty, dtype),
                        aff, stream)
    dx, dy = jvar.VARIATION_IMPLS[name](
        ctx, jnp.full((n,), w, dtype),
        lambda a: jnp.full((n,), params[a], dtype))
    return np.asarray(dx, np.float64), np.asarray(dy, np.float64)


def _run_jax64(*args):
    """The JAX formula in float64: the reference the port is held to."""
    with jax.enable_x64(True):
        return _run_jax(*args, jnp.float64)


# draws of the rounded float64 run, the relative size of one float32
# ulp, and the multiple of the draws' largest change that the tolerance
# takes as its conditioning term
_DRAWS = 8
_ULP = 2.0 ** -23
_COND = 4.0
# primitives whose float32 result is exact: they round nothing
_EXACT = frozenset((
    "max", "min", "neg", "abs", "sign", "floor", "ceil", "round",
    "select_n", "clamp", "convert_element_type", "copy", "reshape",
    "squeeze", "stop_gradient"))


def _eval_rounded(jaxpr, consts, args, rs, n):
    """Evaluate a jaxpr equation by equation, and move every floating
    result of a rounding primitive by one float32 ulp, up or down at
    random, in all but the first `n` elements of each (copies * n,)
    array: the first copy of the points is the plain float64 run, the
    others are runs whose every intermediate carries a float32-sized
    rounding error."""
    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        if isinstance(v, jax.extend.core.Literal):
            return jnp.asarray(v.val, v.aval.dtype)
        return env[v]
    for eqn in jaxpr.eqns:
        invals = [read(v) for v in eqn.invars]
        if eqn.primitive.name in ("jit", "pjit"):
            sub = eqn.params["jaxpr"]
            outs = _eval_rounded(sub.jaxpr, sub.consts, invals, rs, n)
        else:
            outs = eqn.primitive.bind(*invals, **eqn.params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
            if eqn.primitive.name not in _EXACT:
                outs = [_round_off(o, rs, n) for o in outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def _round_off(x, rs, n):
    if not jnp.issubdtype(x.dtype, jnp.floating) or x.ndim != 1 \
            or x.shape[0] <= n:
        return x
    sign = rs.choice((-1.0, 1.0), x.shape[0])
    sign[:n] = 0.0
    return (x * jnp.asarray(1.0 + _ULP * sign)).astype(x.dtype)


def _jax64_rounding_spread(name, tx, ty, state, params, w):
    """Per output of the JAX formula in float64, (its value, how far the
    value moves at each point when every intermediate is rounded as
    float32 rounds it): the largest change over _DRAWS runs of
    _eval_rounded.  This is the formula's own conditioning, its inputs'
    (whorl's pole at r = w: w and r each move by an ulp) and its
    intermediates' (conic's 1 + tx / r), the same on every machine;
    the error of one float32 run of JAX is not, since it depends on
    the code XLA made for the host."""
    n, copies = tx.shape[0], _DRAWS + 1
    rs = np.random.RandomState(13)
    with jax.enable_x64(True):
        f64 = jnp.float64
        nstate = jnp.asarray(np.tile(state, (copies, 1)))

        def formula(x, y):
            full = x.shape
            aff = tuple(jnp.full(full, v, f64) for v in _AFFINE)
            ctx = jvar.make_ctx(x, y, aff, jrng.RngStream(nstate))
            return jvar.VARIATION_IMPLS[name](
                ctx, jnp.full(full, w, f64),
                lambda a: jnp.full(full, params[a], f64))
        args = [jnp.asarray(np.tile(v, copies), f64) for v in (tx, ty)]
        closed = jax.make_jaxpr(formula)(*args)
        outs = _eval_rounded(closed.jaxpr, closed.consts, args, rs, n)
        outs = [np.asarray(o, np.float64).reshape(copies, n) for o in outs]
    with np.errstate(invalid="ignore"):
        moved = [np.abs(o[1:] - o[0]) for o in outs]
    # a draw that is not finite: the point sits on a pole
    return [(o[0], np.where(np.isfinite(d), d, np.inf).max(axis=0))
            for o, d in zip(outs, moved)]


@pytest.mark.parametrize("name", sorted(jvar.VARIATION_IMPLS))
def test_variation_matches_jax(name):
    tx, ty = _points()
    state = _u32_state(12)
    r = np.sqrt(tx.astype(np.float64) ** 2 + ty.astype(np.float64) ** 2)
    defaults = dict(VARIATION_PARAMS[name])
    bumped = {a: d * 1.3 + 0.4 for a, d in defaults.items()}
    for params in (defaults, bumped):
        for w in (0.7, -0.45):
            jout = _run_jax(name, tx, ty, state, params, w,
                            jnp.float32)
            ref64 = _run_jax64(name, tx, ty, state, params, w)
            cond = _jax64_rounding_spread(name, tx, ty, state, params, w)
            tout = _run_torch(name, tx, ty, state, params, w)
            for j, t, f, (f0, spread) in zip(jout, tout, ref64, cond):
                # the first copy of the rounded run rounds nothing
                np.testing.assert_array_equal(f0, f)
                np.testing.assert_array_equal(np.isfinite(t),
                                              np.isfinite(j))
                m = (r > 1e-3) & np.isfinite(j) & np.isfinite(f)
                tol = (1e-4 * np.abs(f) + _COND * spread
                       + _ULP8 * (1.0 + r))
                over = np.abs(t - f) - tol
                assert not (m & (over > 0)).any(), \
                    (name, params, w, float(over[m].max()))


# -- xforms -----------------------------------------------------------------

@pytest.mark.parametrize("genome", [sierpinski, classic_swirl,
                                    full_feature])
def test_select_fetch_and_apply_xforms(genome):
    g = genome()
    key = g.structure_key()
    jp = _jparams(g)
    tp = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    rs = np.random.RandomState(5)
    u = (rs.randint(0, 1 << 24, B) * (1.0 / (1 << 24))).astype(np.float32)
    last = rs.randint(0, key.n_xforms, B)
    cdf = np.array(jit_.xform_cdf_rows(jp))
    np.testing.assert_allclose(tit.xform_cdf_rows(tp).numpy(), cdf,
                               rtol=1e-6)
    jtable = jxf.build_xform_table(key, jp)
    ttable = txf.build_xform_table(key, tp)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(jtable))
    jidx, jrow = jxf.select_and_fetch(key, jnp.asarray(cdf), jtable,
                                      jnp.asarray(last, jnp.int32),
                                      jnp.asarray(u))
    tidx, trow = txf.select_and_fetch(key, torch.as_tensor(cdf), ttable,
                                      torch.as_tensor(last),
                                      torch.as_tensor(u))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))

    x = rs.uniform(-1, 1, B).astype(np.float32)
    y = rs.uniform(-1, 1, B).astype(np.float32)
    c = rs.rand(B).astype(np.float32)
    state = _u32_state(6)
    jout = jxf.apply_xforms(key, jp, jrow, jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(c),
                            jrng.RngStream(jnp.asarray(state)))
    tout = txf.apply_xforms(key, tp, trow, torch.as_tensor(x),
                            torch.as_tensor(y), torch.as_tensor(c),
                            trng.RngStream(torch.as_tensor(
                                state.astype(np.int64))))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    jf = jxf.apply_final_xform(key, jp, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(c),
                               jrng.RngStream(jnp.asarray(state)))
    tf = txf.apply_final_xform(key, tp, torch.as_tensor(x),
                               torch.as_tensor(y), torch.as_tensor(c),
                               trng.RngStream(torch.as_tensor(
                                   state.astype(np.int64))))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# -- packing, palettes, respawn ---------------------------------------------

def test_bit_budgets_match():
    for n in (100, 4096, 2 ** 20 - 3, 2 ** 22, 8_633_336, 2 ** 24 - 2,
              2 ** 24, 2 ** 26):
        assert tit.color_bits_for(n) == jit_.color_bits_for(n)
        for nx in (1, 2, 3, 5, 9):
            assert tit.opacity_bits_for(n, nx) == \
                jit_.opacity_bits_for(n, nx)


def test_pack_unpack_and_palettes_exact():
    rs = np.random.RandomState(8)
    pal = rs.rand(256, 3).astype(np.float32)
    jhi = np.asarray(jit_.expand_palette(jnp.asarray(pal), 8))
    thi = tit.expand_palette(torch.as_tensor(pal), 8)
    np.testing.assert_array_equal(thi.numpy(), jhi)
    op = np.array([0.3, 1.0, 0.75], np.float32)
    jext = jit_.extend_palette_opacity(jnp.asarray(jhi), jnp.asarray(op),
                                       2)
    text = tit.extend_palette_opacity(thi, torch.as_tensor(op), 2)
    np.testing.assert_array_equal(text.numpy(), np.asarray(jext))

    addr = rs.randint(0, 5000, 3000)
    color = rs.rand(3000).astype(np.float32)
    color[:3] = [-0.5, 1.0, 1.7]
    jrec = np.asarray(jit_.pack_records(
        10, jnp.asarray(addr, jnp.int32), jnp.asarray(color)))
    trec = tit.pack_records(10, torch.as_tensor(addr),
                            torch.as_tensor(color))
    np.testing.assert_array_equal(trec.numpy(), jrec.astype(np.int64))
    pal10 = jit_.expand_palette(jnp.asarray(pal), 10)
    ja, jrgba = jit_.unpack_records(10, pal10, jnp.asarray(jrec))
    ta, trgba = tit.unpack_records(10, tit.expand_palette(
        torch.as_tensor(pal), 10), trec)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(trgba.numpy(), np.asarray(jrgba))


def test_respawn_hash_exact():
    bits = np.random.RandomState(9).randint(
        0, 2 ** 32, 10000, dtype=np.uint64).astype(np.uint32)
    bits[:3] = [0, 0xFFFFFFFF, 0x5BD1E995]
    jx, jy = jit_.respawn_xy(jnp.asarray(bits))
    tx, ty = tit.respawn_xy(torch.as_tensor(bits.astype(np.int64)))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("genome", [sierpinski, full_feature])
def test_iterate_step_matches(genome):
    """One chaos-game step from the same state: RNG state and selected
    xforms exact, positions within float32 rounding, addresses equal
    except at ulp boundaries."""
    g = genome()
    key = g.structure_key()
    cam_args = dict(width=64, height=48, ss=2, no_rotation=True,
                    gutter=3)
    jc, tc = jcam.CameraSpec(**cam_args), tcam.CameraSpec(**cam_args)
    jp = _jparams(g)
    tp = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    js = jit_.init_state(jax.random.PRNGKey(3), B)
    js = dataclasses.replace(js, age=js.age + 40)     # past the fuse
    leaves = [np.asarray(v) for v in (js.x, js.y, js.color, js.last_xf,
                                      js.age, js.rng)]
    ts = tparams.state_from_numpy(*leaves)
    cdf = jit_.xform_cdf_rows(jp)
    ppu = jp.ppu * jnp.float32(64 / g.size[0])
    js2, jaddr, jpc, jop = jit_.iterate_step(key, jc, 20, jp, cdf, ppu,
                                             js)
    ts2, taddr, tpc, top = tit.iterate_step(
        key, tc, 20, tp, torch.as_tensor(np.array(cdf)),
        torch.as_tensor(np.array(ppu)), ts)
    np.testing.assert_array_equal(ts2.rng.numpy(),
                                  np.asarray(js2.rng, np.int64))
    np.testing.assert_array_equal(ts2.last_xf.numpy(),
                                  np.asarray(js2.last_xf))
    np.testing.assert_array_equal(ts2.age.numpy(), np.asarray(js2.age))
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts2.y.numpy(), np.asarray(js2.y),
                               rtol=1e-4, atol=1e-5)
    assert (taddr.numpy() == np.asarray(jaddr)).mean() >= 0.999
    assert (taddr.numpy() != tc.junk_bin).sum() > B // 4


def test_state_from_numpy_roundtrip():
    js = jit_.init_state(jax.random.PRNGKey(1), 64)
    leaves = [np.asarray(v) for v in (js.x, js.y, js.color, js.last_xf,
                                      js.age, js.rng)]
    ts = tparams.state_from_numpy(*leaves)
    assert ts.rng.dtype == torch.int64 and ts.x.dtype == torch.float32
    np.testing.assert_array_equal(ts.rng.numpy(),
                                  leaves[5].astype(np.int64))
    np.testing.assert_array_equal(ts.x.numpy(), leaves[0])
