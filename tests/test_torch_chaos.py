"""The chaos-game kernel's lane code (csrc/chaos_iterate.cu) on the CPU.

The kernel's source also builds as host C++ (`c++ -O2
-ffp-contract=off -DCHAOS_HOST`, no `__global__` function), into
test-only libraries whose C entries run the same lane code in plain
loops: one a structure key, with the key's -D definitions
(ops/chaos.key_defines), as the card's libraries are built, and the
generic one of chaos_variation.  These tests hold those builds against
the port's plain version (ops/iterate.py's eager step) and the JAX
package, on inputs made from a numpy seed.  They skip where the host
has no C++ compiler.  Contracts:

- every variation of the registry, alone: (dx, dy) within the tolerance
  of test_torch_ops.test_variation_matches_jax, |host - jax64| <=
  1e-4 |jax64| + 4 spread + 8 ulp * (1 + r) at points with r > 1e-3
  (jax64 the JAX formula in float64, spread its largest move when every
  intermediate rounds by one float32 ulp); finite where the plain
  version is; its RNG words exact;
- 8 steps of a chunk (xaos, post, final xform; the 3-D camera with and
  without its depth-of-field draws; opacity-extended records; a stripe
  camera; rotation; the unpacked outputs) from JAX-made state: the RNG
  words and the selected xform exact at every step against the plain
  version (the draws do not depend on the data); one 8-step launch
  equal to 8 one-step launches; from the same state, step 1's records
  equal to the plain version's and to JAX's iterate_step's in >= 99.9%
  of lanes, positions within rtol 1e-4, atol 1e-5;
- every variation of the registry inside a key's union, 12-13 a key
  (test_torch_cuda.VARIATION_GROUPS): after 8 steps of one launch the
  RNG words and the selected xforms exact against the plain version,
  positions finite where its are; step 1's records equal in >= 99.9% of
  lanes;
- a 64x64 render through the host build: TV distance of its normalised
  density histogram to the plain path's under 2x the plain path's
  two-seed floor (the chaos game turns ulps into other trajectories);
- a key's library path: another for another key, the same for two
  genomes with equal keys; a key whose build fails raises with the
  compiler's output and nothing falls back;
- the chunk loop in C (chaos_accumulate), its flush a ctypes callback
  running the plain counting flush: for 0-3 chunks at weight 1 and at a
  temporal weight, the final state, the records, the histogram, the
  chunks' counts and the float32 plotted total bit-equal to a Python
  loop over the same host chaos_iterate and flush, the caller's state
  never written; the fold of counts past 2^24 bit-equal to the
  sequential float32 sum.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.genome.spline import Spline as JSpline  # noqa: E402
from cuburn_tpu.genome.variations import VARIATION_PARAMS  # noqa: E402
from cuburn_tpu.models import (classic_swirl, full_feature,  # noqa: E402
                               sierpinski)
from cuburn_tpu.ops import camera as jcam  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.genome.spline import Spline as TSpline  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.models.gallery import get_genome  # noqa: E402
from cuburn_tpu_torch.ops import camera as tcam  # noqa: E402
from cuburn_tpu_torch.ops import chaos  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops import rng as trng  # noqa: E402
from cuburn_tpu_torch.ops import variations as tvar  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402
from test_torch_cuda import (VARIATION_GROUPS,  # noqa: E402
                             variation_group_genome, variation_group_plan)
from test_torch_ops import (_AFFINE, _COND, _ULP8,  # noqa: E402
                            _jax64_rounding_spread, _points, _run_jax64,
                            _u32_state)

B = 4096
K = 8
FUSE = 20


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


HOST_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-DCHAOS_HOST",
              "-shared", "-fPIC", "-x", "c++")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/chaos_iterate.cu built as host C++ into test libraries, one
    a structure key, built at its first use and kept for the module:
    host_lib(key) is the key's (its chaos_iterate), host_lib() the
    generic one (its chaos_variation)."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler (c++) on this host")
    out_dir = tmp_path_factory.mktemp("chaos")
    libs = {}

    def lib_for(key=None):
        defines = chaos.key_defines(key) if key is not None else ()
        lib = libs.get(defines)
        if lib is None:
            out = out_dir / f"libchaos_host_{len(libs)}.so"
            subprocess.run([cxx, *HOST_FLAGS, *(f"-D{d}" for d in defines),
                            str(build.CSRC_DIR / "chaos_iterate.cu"), "-o",
                            str(out)], check=True, capture_output=True)
            lib = ctypes.CDLL(str(out))
            entry = lib.chaos_iterate if defines else lib.chaos_variation
            entry.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            entry.restype = ctypes.c_int
            libs[defines] = lib
        return lib
    return lib_for


def host_records(host_lib, plan, state, n_iters, unpacked=False):
    """The host build of plan.key's chaos_iterate: (new state, records)
    or, unpacked, (new state, addr, pcolor, opacity)."""
    lib = host_lib(plan.key)
    new = chaos.empty_state(state)
    if unpacked:
        outs = chaos.full_outputs(state, n_iters)
    else:
        outs = (torch.empty((n_iters, state.x.shape[0]), dtype=torch.int64),)
    args = chaos.chaos_args(lib, plan, state, new, *outs)
    assert lib.chaos_iterate(ctypes.addressof(args), None) == 0
    return (new, *outs)


# -- (a) every variation alone ----------------------------------------------

def _host_variation(host_lib, name, tx, ty, state, params, w):
    lib = host_lib()
    n = tx.shape[0]
    f32 = torch.float32
    vals = [params[a] for a, _d in VARIATION_PARAMS[name]] or [0.0]
    rng = torch.as_tensor(state.astype(np.int64))
    dx, dy = torch.empty(n, dtype=f32), torch.empty(n, dtype=f32)
    args = chaos.variation_args(
        lib, name, torch.as_tensor(tx), torch.as_tensor(ty),
        torch.full((n,), w, dtype=f32), torch.tensor(vals, dtype=f32),
        torch.tensor(_AFFINE, dtype=f32), rng, dx, dy)
    assert lib.chaos_variation(ctypes.addressof(args), None) == 0
    return dx.double().numpy(), dy.double().numpy(), rng.numpy()


def _plain_variation(name, tx, ty, state, params, w):
    n = tx.shape[0]
    f32 = torch.float32
    stream = trng.RngStream(torch.as_tensor(state.astype(np.int64)))
    aff = tuple(torch.full((n,), v, dtype=f32) for v in _AFFINE)
    ctx = tvar.make_ctx(torch.as_tensor(tx), torch.as_tensor(ty), aff,
                        stream)
    dx, dy = tvar.VARIATION_IMPLS[name](
        ctx, torch.full((n,), w, dtype=f32),
        lambda a: torch.full((n,), params[a], dtype=f32))
    return dx.double().numpy(), dy.double().numpy(), stream.state.numpy()


def test_registry_has_every_variation(host_lib):
    assert set(chaos.variation_ids(host_lib())) == set(tvar.VARIATION_IMPLS)
    assert set().union(*VARIATION_GROUPS) == set(tvar.VARIATION_IMPLS)
    assert not hasattr(host_lib(), "chaos_iterate")


@pytest.mark.parametrize("name", sorted(tvar.VARIATION_IMPLS))
def test_variation_matches_jax_and_plain(host_lib, name):
    tx, ty = _points()
    state = _u32_state(12)
    r = np.sqrt(tx.astype(np.float64) ** 2 + ty.astype(np.float64) ** 2)
    defaults = dict(VARIATION_PARAMS[name])
    bumped = {a: d * 1.3 + 0.4 for a, d in defaults.items()}
    for params in (defaults, bumped):
        for w in (0.7, -0.45, 0.0):
            hx, hy, hrng = _host_variation(host_lib, name, tx, ty, state,
                                           params, w)
            px, py, prng = _plain_variation(name, tx, ty, state, params, w)
            np.testing.assert_array_equal(hrng, prng)
            ref64 = _run_jax64(name, tx, ty, state, params, w)
            cond = _jax64_rounding_spread(name, tx, ty, state, params, w)
            for h, p, f, (_f0, spread) in zip((hx, hy), (px, py), ref64,
                                              cond):
                np.testing.assert_array_equal(np.isfinite(h),
                                              np.isfinite(p))
                m = (r > 1e-3) & np.isfinite(h) & np.isfinite(f)
                tol = (1e-4 * np.abs(f) + _COND * spread
                       + _ULP8 * (1.0 + r))
                over = np.abs(h - f) - tol
                assert not (m & (over > 0)).any(), \
                    (name, params, w, float(over[m].max()))


# -- (b) chunks from JAX-made state -------------------------------------------

def _opacity(g):
    g.xforms[1].opacity = JSpline(0.5)
    g.xforms[2].opacity = JSpline(0.25)
    return g


def _tilted(dof=0.12):
    """The port gallery's `tilted` as a JAX package genome: classic_swirl
    through the 3-D camera, with depth of field (cam_mode 2) or without
    (cam_mode 1)."""
    g = classic_swirl()
    g.cam_pitch, g.cam_yaw = JSpline(0.55), JSpline(0.15)
    g.cam_perspective, g.cam_zpos = JSpline(0.35), JSpline(1.0)
    g.cam_dof = JSpline(dof)
    return g


# name -> (genome, camera arguments, rotate degrees, opacity-extended)
CHUNK_CASES = {
    "full_feature": (full_feature, {}, 0.0, False),
    "cam_mode_1": (lambda: _tilted(0.0), {}, 0.0, False),
    "cam_mode_2": (_tilted, {}, 0.0, False),
    "op_bits": (lambda: _opacity(full_feature()), {}, 0.0, True),
    "stripe": (full_feature, dict(tile_row0=40, full_acc_height=102,
                                  tile_acc_height=30), 0.0, False),
    "rotated": (full_feature, {}, 33.0, False),
}


def _chunk_setup(case):
    genome, cam_extra, rotate, opacity = CHUNK_CASES[case]
    g = genome()
    key = g.structure_key()
    cam_args = dict(width=64, height=48, ss=2, gutter=3,
                    no_rotation=rotate == 0.0, **cam_extra)
    jc, tc = jcam.CameraSpec(**cam_args), tcam.CameraSpec(**cam_args)
    jp = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
    jp = dataclasses.replace(jp, rotate=jnp.float32(rotate))
    tp = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    tp = dataclasses.replace(tp, rotate=torch.tensor(rotate))
    js = jit_.init_state(jax.random.PRNGKey(3), B)
    js = dataclasses.replace(js, age=js.age + 40)     # past the fuse
    ts = tparams.state_from_numpy(*(np.asarray(v) for v in (
        js.x, js.y, js.color, js.last_xf, js.age, js.rng)))
    cdf = jit_.xform_cdf_rows(jp)
    ppu = jp.ppu * jnp.float32(64 / g.size[0])
    op_bits = tit.opacity_bits_for(tc.layout_bins, key.n_xforms)[0] \
        if opacity else 0
    cbits, tot_bits = tit.record_bits(key, tc, "pallas_win", op_bits)
    plan = chaos.plan(key, tc, tp, torch.as_tensor(np.array(cdf)),
                      torch.as_tensor(np.array(ppu)), FUSE, cbits,
                      tot_bits, op_bits)
    jax_step = (key, jc, jp, cdf, ppu, js)
    return plan, ts, jax_step


def _jax_records(jax_step, cbits, tot_bits, op_bits):
    key, jc, jp, cdf, ppu, js = jax_step
    js2, addr, pcolor, _op = jit_.iterate_step(key, jc, FUSE, jp, cdf, ppu,
                                               js)
    levels = np.float32((1 << cbits) - 1)
    q = (np.clip(np.asarray(pcolor), 0.0, 1.0) * levels
         + np.float32(0.5)).astype(np.int64)
    rec = (np.asarray(addr, np.int64) << tot_bits) | q
    if op_bits:
        rec |= np.asarray(js2.last_xf, np.int64) << cbits
    return js2, rec


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_matches_plain_and_jax(host_lib, case):
    plan, ts, jax_step = _chunk_setup(case)
    assert plan.key.cam_mode == {"cam_mode_1": 1, "cam_mode_2": 2}.get(
        case, 0)
    # step by step: the draws and the selection exact at every step
    host, plain = ts, ts
    host_steps = []
    for k in range(K):
        host, hrec = host_records(host_lib, plan, host, 1)
        prec = torch.empty_like(hrec)
        plain_next = tit.iterate_records_reference(plan, plain, prec)
        np.testing.assert_array_equal(host.rng.numpy(),
                                      plain_next.rng.numpy())
        np.testing.assert_array_equal(host.last_xf.numpy(),
                                      plain_next.last_xf.numpy())
        if k == 0:
            # from the same state: records and positions bounded
            assert (hrec.numpy() == prec.numpy()).mean() >= 0.999
            np.testing.assert_array_equal(host.age.numpy(),
                                          plain_next.age.numpy())
            for a, b in ((host.x, plain_next.x), (host.y, plain_next.y)):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           rtol=1e-4, atol=1e-5)
            js2, jrec = _jax_records(jax_step, plan.cbits, plan.tot_bits,
                                     plan.op_bits)
            np.testing.assert_array_equal(host.rng.numpy(),
                                          np.asarray(js2.rng, np.int64))
            np.testing.assert_array_equal(host.last_xf.numpy(),
                                          np.asarray(js2.last_xf))
            assert (hrec.numpy()[0] == jrec).mean() >= 0.999
            assert ((hrec.numpy() >> plan.tot_bits)
                    != plan.cam.junk_bin).sum() > B // 8
        host_steps.append(hrec[0])
        plain = plain_next
    # one launch of K steps is K launches of one step
    whole, wrec = host_records(host_lib, plan, ts, K)
    np.testing.assert_array_equal(wrec.numpy(),
                                  torch.stack(host_steps).numpy())
    for f in ("x", "y", "color", "last_xf", "age", "rng"):
        np.testing.assert_array_equal(getattr(whole, f).numpy(),
                                      getattr(host, f).numpy())


@pytest.mark.parametrize("case", ["full_feature", "cam_mode_2"])
def test_unpacked_chunk_matches_plain(host_lib, case):
    plan, ts, _ = _chunk_setup(case)
    plan = dataclasses.replace(plan, cbits=0, tot_bits=0, op_bits=0)
    host, haddr, hpc, hop = host_records(host_lib, plan, ts, K,
                                         unpacked=True)
    plain, paddr, ppc, pop = tit.iterate_full_reference(plan, ts, K)
    np.testing.assert_array_equal(host.rng.numpy(), plain.rng.numpy())
    np.testing.assert_array_equal(host.last_xf.numpy(),
                                  plain.last_xf.numpy())
    # the selected xforms are exact, so are their opacities
    np.testing.assert_array_equal(hop.numpy(), pop.numpy())
    assert (haddr[0].numpy() == paddr[0].numpy()).mean() >= 0.999
    np.testing.assert_allclose(hpc[0].numpy(), ppc[0].numpy(), rtol=1e-4,
                               atol=1e-5)


# -- (c) a render through the host build --------------------------------------

def _density(hist):
    d = np.asarray(hist, np.float64)[:-1, 3]
    return d / d.sum()


def _tv(a, b):
    return 0.5 * np.abs(_density(a) - _density(b)).sum()


@pytest.mark.parametrize("genome,backend", [
    ("full_feature", "pallas_win"), ("tilted", "pallas_win"),
    ("full_feature", "scatter")])
def test_render_through_host_build(host_lib, monkeypatch, genome, backend):
    g = get_genome(genome)
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         iters_per_chunk=16, fuse=20, de_enabled=False,
                         hist_backend=backend)
    r = trender.Renderer(g, prof, device="cpu")
    plain11, _ = r.accumulate(0.0, seed=11)
    plain12, _ = r.accumulate(0.0, seed=12)
    floor = _tv(plain11.numpy(), plain12.numpy())

    def records(plan, state, recs):
        new, out = host_records(host_lib, plan, state, recs.shape[0])
        recs.copy_(out)
        return new
    monkeypatch.setattr(tit, "iterate_records", records)
    host11, stats = r.accumulate(0.0, seed=11)
    assert float(host11[:-1, 3].sum()) == stats.plotted_samples > 0
    d = _tv(host11.numpy(), plain11.numpy())
    assert d < 2.0 * floor, (d, floor)


def test_unpacked_render_through_host_build(host_lib, monkeypatch):
    """The full-record path (records past 32 bits, forced here on a
    small frame) through the host build's unpacked outputs."""
    monkeypatch.setattr(trender, "color_bits_for", lambda n: 0)
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         iters_per_chunk=16, fuse=20, de_enabled=False,
                         hist_backend="scatter")
    r = trender.Renderer(get_genome("full_feature"), prof, device="cpu")
    assert not r.packed
    plain11, _ = r.accumulate(0.0, seed=11)
    plain12, _ = r.accumulate(0.0, seed=12)
    floor = _tv(plain11.numpy(), plain12.numpy())
    monkeypatch.setattr(tit, "iterate_full",
                        lambda plan, state, n: host_records(
                            host_lib, plan, state, n, unpacked=True))
    host11, stats = r.accumulate(0.0, seed=11)
    assert stats.plotted_samples > 0
    assert _tv(host11.numpy(), plain11.numpy()) < 2.0 * floor


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the library: the wrappers run the plain
    version, which launches nothing."""
    def no_load(name):
        raise AssertionError(f"loaded {name} for a CPU tensor")
    monkeypatch.setattr(build, "load", no_load)
    g = sierpinski()
    key = g.structure_key()
    tp = tparams.params_from_genome(g.eval_at(0.0), "cpu")
    cam = tcam.CameraSpec(32, 32, 1)
    st = tit.init_state(torch.Generator().manual_seed(1), 256, "cpu")
    plan = chaos.plan(key, cam, tp, tit.xform_cdf_rows(tp), tp.ppu, 0, 8, 8)
    before = dict(chaos.LAUNCHES)
    recs = torch.empty((4, 256), dtype=torch.int64)
    new = tit.iterate_records(plan, st, recs)
    ref = torch.empty_like(recs)
    ref_state = tit.iterate_records_reference(plan, st, ref)
    assert torch.equal(recs, ref) and torch.equal(new.rng, ref_state.rng)
    assert chaos.LAUNCHES == before


def test_launch_refuses_a_cpu_tensor(monkeypatch):
    """The launch itself takes CUDA tensors only: handed CPU tensors it
    raises before it loads the library or counts a launch."""
    def no_load(name):
        raise AssertionError(f"loaded {name} for a CPU tensor")
    monkeypatch.setattr(build, "load", no_load)
    tp = tparams.params_from_genome(sierpinski().eval_at(0.0), "cpu")
    st = tit.init_state(torch.Generator().manual_seed(1), 64, "cpu")
    plan = chaos.plan(sierpinski().structure_key(), tcam.CameraSpec(32, 32, 1),
                      tp, tit.xform_cdf_rows(tp), tp.ppu, 0, 8, 8)
    before = dict(chaos.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        chaos.launch_records(plan, st, torch.empty((2, 64),
                                                   dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        chaos.launch_full(plan, st, 2)
    assert chaos.LAUNCHES == before


# -- (d) every variation inside a key's union ---------------------------------

@pytest.mark.parametrize("group", range(len(VARIATION_GROUPS)))
def test_variation_group_matches_plain(host_lib, group):
    """K steps of a key whose union is 12-13 variations of the registry,
    one launch of its specialised host build against the plain version:
    RNG words and selected xforms exact, positions finite where the
    plain version's are, step 1's records equal in >= 99.9% of lanes."""
    plan, st = variation_group_plan(group, "cpu", B)
    assert plan.key.variations == VARIATION_GROUPS[group]
    host, hrec = host_records(host_lib, plan, st, K)
    prec = torch.empty_like(hrec)
    plain = tit.iterate_records_reference(plan, st, prec)
    np.testing.assert_array_equal(host.rng.numpy(), plain.rng.numpy())
    np.testing.assert_array_equal(host.last_xf.numpy(),
                                  plain.last_xf.numpy())
    for f in ("x", "y", "color"):
        np.testing.assert_array_equal(np.isfinite(getattr(host, f).numpy()),
                                      np.isfinite(getattr(plain, f).numpy()))
    agree = (hrec[0] == prec[0]).double().mean()
    plotted = ((hrec[0] >> plan.tot_bits) != plan.cam.junk_bin).sum()
    assert float(agree) >= 0.999 and int(plotted) > B // 8


def test_library_path_follows_the_key():
    """One library a structure key: another key builds another library,
    a genome with other values and the same key shares it, and the
    generic library is none of them."""
    ff = get_genome("full_feature")
    same = get_genome("full_feature")
    same.xforms[1].opacity = TSpline(0.5)
    same.xforms[0].weight = TSpline(0.3)
    assert same.structure_key() == ff.structure_key()
    keys = [ff.structure_key(), get_genome("sierpinski").structure_key(),
            get_genome("tilted").structure_key(),
            *(variation_group_genome(i).structure_key() for i in range(2))]
    paths = [chaos.library_path(k) for k in keys]
    assert len(set(paths)) == len(paths)
    assert chaos.library_path(same.structure_key()) == paths[0]
    assert chaos.library_path() not in paths
    assert all(p.parent == build.BUILD_DIR and
               p.name.startswith("libchaos_iterate-") for p in paths)


def test_failed_key_build_raises_without_fallback(tmp_path, monkeypatch):
    """A key whose nvcc build fails raises with the compiler's output; no
    library is loaded for it and the generic one is not touched."""
    fake = tmp_path / "nvcc"
    log = tmp_path / "argv"
    fake.write_text(f"#!/bin/sh\necho \"$@\" > {log}\n"
                    "echo 'chaos_iterate.cu: error: no room' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    key = get_genome("full_feature").structure_key()
    with pytest.raises(RuntimeError, match="no room"):
        chaos.load(key)
    argv = log.read_text()
    assert all(f"-D{d}" in argv for d in chaos.key_defines(key))
    assert build._LOADED == {}
    assert not list((tmp_path / "build").glob("*.so"))


# -- (e) the chunk loop in C -------------------------------------------------

# csrc/chaos_iterate.cu's TallyFlush
TALLY_FLUSH = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p)


def _loop_setup(n_iters=4):
    plan, ts, _ = _chunk_setup("full_feature")
    n_bins = plan.cam.n_bins
    palette = tit.expand_palette(plan.params.palette, plan.cbits)
    recs = torch.empty((n_iters, B), dtype=torch.int64)
    hist = torch.rand((n_bins + 1, 4),
                      generator=torch.Generator().manual_seed(5))
    return plan, ts, palette, recs, hist


def _host_loop(host_lib, plan, state, recs, hist, palette, n_chunks,
               weight, forced=None):
    """chaos_accumulate of the host build, its flush a callback into
    accumulate_packed_reference with its count; `forced` replaces chunk
    k's count by forced[k].  Returns (state, plotted, counts, the
    records of each chunk)."""
    pal4 = flush._aligned_pal4(palette)
    seen = []

    def tally(rec_p, n, pal_p, cbits, n_bins, w, hist_p, count_p, _s):
        assert (rec_p, n, pal_p, hist_p) == (
            recs.data_ptr(), recs.numel(), pal4.data_ptr(),
            hist.data_ptr())
        assert (cbits, n_bins) == (plan.tot_bits, plan.cam.n_bins)
        count = torch.zeros((), dtype=torch.int64)
        flush.accumulate_packed_reference(hist, recs, palette, n_bins,
                                          cbits, w, count=count)
        slot = ctypes.c_int64.from_address(count_p)
        slot.value += int(count) if forced is None else forced[len(seen)]
        seen.append(recs.clone())
        return 0
    callback = TALLY_FLUSH(tally)
    fn = ctypes.cast(callback, ctypes.c_void_p).value
    new, plotted, counts = chaos.accumulate_call(
        host_lib(plan.key), plan, state, recs, n_chunks, fn, pal4,
        plan.cam.n_bins, weight, hist, None)
    return new, plotted, counts, seen


@pytest.mark.parametrize("weight", [1.0, 0.325])
@pytest.mark.parametrize("n_chunks", [0, 1, 2, 3])
def test_c_loop_matches_the_python_loop(host_lib, n_chunks, weight):
    plan, ts, palette, recs, hist = _loop_setup()
    keep = {f: getattr(ts, f).clone() for f in chaos.STATE_FIELDS}
    want_hist = hist.clone()
    state, want_plotted, want_counts, want_recs = ts, \
        torch.zeros((), dtype=torch.float32), [], []
    for _ in range(n_chunks):
        state, out = host_records(host_lib, plan, state, recs.shape[0])
        count = torch.zeros((), dtype=torch.int64)
        flush.accumulate_packed_reference(
            want_hist, out, palette, plan.cam.n_bins, plan.tot_bits,
            float(np.float32(weight)), count=count)
        want_plotted = want_plotted + count.to(torch.float32)
        want_counts.append(int(count))
        want_recs.append(out)
    got, plotted, counts, seen = _host_loop(
        host_lib, plan, ts, recs, hist, palette, n_chunks, weight)
    for f in chaos.STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(state, f)), f
        assert torch.equal(getattr(ts, f), keep[f]), f
    assert len(seen) == n_chunks
    assert all(torch.equal(a, b) for a, b in zip(seen, want_recs))
    assert counts.tolist() == want_counts
    assert n_chunks == 0 or sum(want_counts) > 0
    assert torch.equal(hist, want_hist)
    assert plotted.dtype == torch.float32
    assert plotted.view(torch.int32) == want_plotted.view(torch.int32)


def test_c_loop_folds_counts_past_2_24_as_float32(host_lib):
    """Counts whose float32 running total rounds: the C fold adds each
    chunk's count, rounded to float32, in chunk order, bit for bit as
    the Python loop's `plotted + count.to(float32)`."""
    plan, ts, palette, recs, hist = _loop_setup(n_iters=1)
    forced = [(1 << 24) + 1, 3, (1 << 25) + 7, 1, (1 << 31) + 5, 1, 2]
    _s, plotted, counts, _seen = _host_loop(
        host_lib, plan, ts, recs, hist, palette, len(forced), 1.0,
        forced=forced)
    assert counts.tolist() == forced
    want = torch.zeros((), dtype=torch.float32)
    for c in forced:
        want = want + torch.tensor(c, dtype=torch.int64).to(torch.float32)
    assert plotted.view(torch.int32) == want.view(torch.int32)
    # the totals round: the exact sum differs
    assert float(want) != float(sum(forced))
