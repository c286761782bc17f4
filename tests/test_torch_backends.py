"""The port's histogram backends against the JAX package's, from the
merge of sorted records to whole renders.

Contracts:
- `merge_sorted_records` and `scatter_sorted` are exact against the JAX
  functions; `sortcum` within 1e-5 of the flush's mass per channel (its
  error is the prefix sums' rounding, O(ulp(flush mass)) per bin);
- the plain versions of the `pallas`, `pallas_merged` and
  `pallas_rgb16` flushes against the Pallas kernels run in interpret
  mode, as the JAX package's own tests run them: density exact where it
  is a sum of integer counts, rgb within 1e-4 (tests/test_ops.py) or,
  for the bf16 split layout, within 2^-7 of the magnitude
  (tests/test_sort.py);
- the plain tiled bitonic sort runs the JAX package's schedule: equal
  to the Pallas sort's intermediate state after each local pass, to
  XLA's substages after each fused global pass, and to its result; the
  plain versions launch no kernel;
- every backend renders: by TV distance against the JAX Renderer under
  2x JAX's two-seed floor, and on the same seed its density equals
  `pallas_win`'s bit for bit;
- `atomic`, the port's own backend (no JAX counterpart: a TPU has no
  scatter-add), packs `pallas_win`'s records in every geometry and
  flushes them unsorted into the same histogram: density exact at
  weight 1, rgb within float32 reassociation;
- the chunk loop runs in C only on the card and only where the flush is
  accumulate_packed (`atomic`, `pallas`): every other backend, a spy
  wrapped around a flush, and every backend on the CPU take the Python
  loop, one `chunk` a chunk, and never reach the C loop.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu.models import full_feature, sierpinski  # noqa: E402
from cuburn_tpu.ops import histogram as jhist  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu.ops import pallas_hist as ph  # noqa: E402
from cuburn_tpu.ops import pallas_sort as jps  # noqa: E402
from cuburn_tpu.ops import sort as jsort  # noqa: E402
from cuburn_tpu.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.genome.spline import Spline as TSpline  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops import sort as tsort  # noqa: E402
from cuburn_tpu_torch.ops import tiled_sort  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile as TProfile  # noqa: E402
from cuburn_tpu_torch.utils import trace  # noqa: E402

N_BINS = 64 * 64
NEW_BACKENDS = ("pallas", "pallas_merged", "pallas_rgb16", "scatter_sorted",
                "sortcum", "atomic")


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _records(seed, n, bits, n_bins=N_BINS, sentinels=0):
    """Packed u32 records (uint32): uniform bins with the junk bin, a
    hot patch of 40 bins, junk records, optional sentinels."""
    rs = np.random.RandomState(seed)
    addr = np.concatenate([rs.randint(0, n_bins + 1, n // 2),
                           rs.randint(100, 140, n // 4),
                           np.full(n - n // 2 - n // 4, n_bins)])
    rec = (addr.astype(np.uint64) << bits) \
        | rs.randint(0, 1 << bits, n).astype(np.uint64)
    rec = rs.permutation(rec).astype(np.uint32)
    rec[:sentinels] = 0xFFFFFFFF
    return rec


def _palette(seed, rows, cols):
    return np.random.RandomState(seed).rand(rows, cols).astype(np.float32)


def _i64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


# -- merge and the XLA backends --------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "all_equal", "distinct"])
def test_merge_sorted_records_matches_jax(case):
    rs = np.random.RandomState(1)
    if case == "mixed":
        rec = np.sort(_records(2, 3000, 8, sentinels=37))
    elif case == "all_equal":
        rec = np.full(512, 12345, np.uint32)
    else:
        rec = np.sort(rs.choice(1 << 20, 1024, replace=False)
                      .astype(np.uint32))
    junk = N_BINS << 8
    ju, jc = jsort.merge_sorted_records(jnp.asarray(rec), jnp.uint32(junk))
    tu, tc = tsort.merge_sorted_records(_i64(rec), junk)
    assert tc.dtype == torch.int32 and tu.shape == (rec.size,)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju).astype(np.int64))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) == rec.size


def _rows(seed, n, n_bins=500):
    rs = np.random.RandomState(seed)
    addr = np.concatenate([rs.randint(0, n_bins + 1, n // 2),
                           rs.randint(10, 30, n - n // 2)]).astype(np.int32)
    rgba = rs.rand(n, 4).astype(np.float32)
    rgba[:, 3] = 1.0
    start = rs.rand(n_bins + 1, 4).astype(np.float32)
    return addr, rgba, start


@pytest.mark.parametrize("name", ["scatter_sorted", "sortcum"])
def test_xla_backend_matches_jax(name):
    addr, rgba, start = _rows(3, 6000)
    j = np.asarray(jhist.get_backend(name)(
        jnp.asarray(start), jnp.asarray(addr), jnp.asarray(rgba)))
    h = torch.as_tensor(start.copy())
    t = thist.get_backend(name).accumulate(h, _i64(addr),
                                           torch.as_tensor(rgba))
    assert t is h                                       # in place
    if name == "scatter_sorted":
        np.testing.assert_array_equal(t.numpy(), j)
    else:
        mass = rgba.sum(axis=0)
        assert (np.abs(t.numpy() - j) <= 1e-5 * mass).all()
    # against the plain scatter: the same per-bin mass
    sc = thist.accumulate_scatter(torch.as_tensor(start.copy()), _i64(addr),
                                  torch.as_tensor(rgba)).numpy()
    assert (np.abs(t.numpy() - sc) <= 1e-5 * rgba.sum(axis=0)).all()


# -- the plain versions of the Pallas flushes ------------------------------

def _torch_flush(fn, rec, pal, bits, weight):
    hist = thist.alloc(N_BINS, "cpu")
    out = fn(hist, _i64(rec), torch.as_tensor(pal), N_BINS, bits,
             weight=weight)
    assert out is hist
    return out.numpy()


def _jax_packed_flush(fn, rec, pal, bits, weight):
    hp = ph.to_packed_layout(jhist.alloc(N_BINS))
    out = fn(hp, jnp.asarray(rec), jnp.asarray(pal), N_BINS, bits,
             interpret=True,
             weight=None if weight is None else jnp.float32(weight))
    return np.asarray(ph.from_packed_layout(out, N_BINS))


@pytest.mark.parametrize("backend", ["pallas", "pallas_merged"])
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.37)])
def test_plain_flush_matches_jax_pallas(backend, cols, weight):
    plain, jfn = {
        "pallas": (flush.accumulate_packed_reference,
                   ph.accumulate_packed_pallas),
        "pallas_merged": (flush.accumulate_merged_reference,
                          ph.accumulate_merged_pallas),
    }[backend]
    bits = 10
    rec = _records(4, 3000, bits)
    pal = _palette(5, 1 << bits, cols)
    got = _torch_flush(plain, rec, pal, bits, weight)[:N_BINS]
    # the JAX kernels pad to their block size with junk records, so the
    # junk bin differs by design
    ref = _jax_packed_flush(jfn, rec, pal, bits, weight)[:N_BINS]
    if weight is None and cols == 3:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert got[:, 3].sum() > 0


def test_cpu_routes_are_the_plain_versions():
    rec = _records(6, 4000, 8)
    pal = _palette(7, 256, 3)
    for fn, plain in ((flush.accumulate_packed,
                       flush.accumulate_packed_reference),
                      (flush.accumulate_merged,
                       flush.accumulate_merged_reference)):
        np.testing.assert_array_equal(_torch_flush(fn, rec, pal, 8, 0.5),
                                      _torch_flush(plain, rec, pal, 8, 0.5))
    a = flush.accumulate_windowed_rgb16(flush.alloc_split(N_BINS, "cpu"),
                                        _i64(rec), torch.as_tensor(pal),
                                        N_BINS, 8)
    b = flush.accumulate_windowed_rgb16_reference(
        flush.alloc_split(N_BINS, "cpu"), _i64(rec), torch.as_tensor(pal),
        N_BINS, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_merged_density_equals_packed_and_skips_sentinels():
    """Merging changes no bin's mass: density of the merged flush equals
    the unsorted flush's exactly, sentinels of the sort add nothing."""
    rec = _records(8, 5000, 8)
    pal = _palette(9, 256, 3)
    m = _torch_flush(flush.accumulate_merged_reference, rec, pal, 8, None)
    p = _torch_flush(flush.accumulate_packed_reference, rec, pal, 8, None)
    np.testing.assert_array_equal(m[:, 3], p[:, 3])
    assert m[:, 3].sum() == rec.size
    uniq, counts = flush.merge_records(_i64(rec), N_BINS, 8)
    assert uniq.shape == (8192,) and int(counts.sum()) == rec.size


@pytest.mark.parametrize("dist", ["dense", "sparse", "mixed"])
def test_plain_rgb16_matches_jax_pallas(dist):
    """From a nonzero split histogram: density exact against the Pallas
    split flush (it never leaves f32), rgb within a couple of bf16 ulps
    of the magnitude; and against the plain f32 windowed flush, rgb
    rounded once per flush."""
    rs = np.random.RandomState(47)
    bits, n = 8, 3000
    if dist == "dense":
        addr = rs.randint(0, 128, n)
    elif dist == "sparse":
        addr = rs.randint(0, N_BINS, n)
    else:
        addr = np.concatenate([rs.randint(0, 64, n // 2),
                               rs.randint(0, N_BINS, n // 2)])
    rec = ((addr << bits) | rs.randint(0, 1 << bits, n)).astype(np.uint32)
    pal = _palette(10, 1 << bits, 3)
    start = rs.rand(N_BINS + 1, 4).astype(np.float32) * 20.0
    start[:, 3] = rs.randint(0, 1000, N_BINS + 1)
    jd, jr = ph.accumulate_windowed_pallas_rgb16(
        ph.to_split_layout(jnp.asarray(start)), jnp.asarray(rec),
        jnp.asarray(pal), N_BINS, bits, interpret=True)
    j = np.asarray(ph.from_split_layout(jd, jr, N_BINS))
    split = flush.to_split_layout(torch.as_tensor(start))
    dens, rgb = flush.accumulate_windowed_rgb16_reference(
        split, _i64(rec), torch.as_tensor(pal), N_BINS, bits)
    assert dens is split[0] and rgb is split[1]
    t = flush.from_split_layout(dens, rgb).numpy()
    np.testing.assert_array_equal(t[:, 3], j[:, 3])
    scale = np.maximum(np.abs(j[:, :3]), 1.0)
    np.testing.assert_allclose(t[:, :3], j[:, :3],
                               atol=float((scale * 2 ** -7).max()))
    sums = flush.accumulate_windowed_reference(
        thist.alloc(N_BINS, "cpu"), _i64(rec), torch.as_tensor(pal),
        N_BINS, bits)
    want = (flush.to_split_layout(torch.as_tensor(start))[1].float()
            + sums[:, :3]).to(torch.bfloat16).float().numpy()
    # the start rounded once on the way in, one rounding per flush: at
    # most one bf16 ulp from bf16(bf16(start) + f32 sum)
    assert (np.abs(t[:, :3] - want) <= 2 ** -7 * np.abs(want)).all()


def test_rgb16_rounds_once_per_flush_not_per_record():
    """A hot bin fed 4096 records of colour 0.01 in one flush grows by
    ~40.96 in rgb: a bf16 add per record would stop near 256 * 2^-9."""
    pal = np.full((256, 3), 0.01, np.float32)
    rec = np.full(4096, (7 << 8) | 3, np.uint32)
    split = flush.to_split_layout(torch.zeros((N_BINS + 1, 4)))
    split[1][7] = 300.0
    dens, rgb = flush.accumulate_windowed_rgb16_reference(
        split, _i64(rec), torch.as_tensor(pal), N_BINS, 8)
    assert float(dens[7]) == 4096.0
    assert abs(float(rgb[7, 0]) - 340.96) <= 2.0      # one bf16 ulp at 256+


def test_split_layout_round_trip():
    rs = np.random.RandomState(11)
    h = torch.as_tensor(rs.rand(N_BINS + 1, 4).astype(np.float32))
    d, r = flush.to_split_layout(h)
    assert d.dtype == torch.float32 and r.dtype == torch.bfloat16
    back = flush.from_split_layout(d, r)
    assert torch.equal(back[:, 3], h[:, 3])
    assert torch.equal(back[:, :3], h[:, :3].to(torch.bfloat16).float())
    j = ph.from_split_layout(*ph.to_split_layout(jnp.asarray(h.numpy())),
                             N_BINS)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j))
    assert thist.hist_to_logical("pallas_rgb16", thist.hist_to_layout(
        "pallas_rgb16", h), N_BINS).shape == h.shape
    d0, r0 = thist.hist_alloc_for("pallas_rgb16", N_BINS, "cpu")
    assert d0.shape == (N_BINS + 1,) and r0.shape == (N_BINS + 1, 3)


def test_split_argument_checks():
    rec = torch.zeros(16, dtype=torch.int64)
    pal = torch.zeros((256, 3))
    d, r = flush.alloc_split(N_BINS, "cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        flush.accumulate_windowed_rgb16((d, r.float()), rec, pal, N_BINS, 8)
    with pytest.raises(ValueError, match="density"):
        flush.accumulate_windowed_rgb16((d[:-1], r), rec, pal, N_BINS, 8)
    with pytest.raises(ValueError, match="int64"):
        flush.accumulate_merged(thist.alloc(N_BINS, "cpu"), rec.int(), pal,
                                N_BINS, 8)


@pytest.mark.parametrize("bad", [1 << 32, -1])
@pytest.mark.parametrize("backend", ["pallas", "pallas_merged", "pallas_win",
                                     "pallas_rgb16"])
def test_flush_rejects_records_past_u32(backend, bad):
    """Records are u32 values: on the CPU every flush and its plain
    version refuse anything else (0xFFFFFFFF, the sort's padding, is
    one)."""
    rec = _i64(_records(12, 64, 8, sentinels=2))
    pal = torch.as_tensor(_palette(13, 256, 3))
    hist = (flush.alloc_split(N_BINS, "cpu") if backend == "pallas_rgb16"
            else thist.alloc(N_BINS, "cpu"))
    tit.PACKED_FLUSHES[backend](hist, rec, pal, N_BINS, 8)
    rec[5] = bad
    with pytest.raises(ValueError, match="u32 values"):
        tit.PACKED_FLUSHES[backend](hist, rec, pal, N_BINS, 8)


@pytest.mark.parametrize("n_bins", [2 ** 14 - 2, 2 ** 14 - 1, 2 ** 14,
                                    3896 * 2216, 2 ** 24 - 2, 2 ** 24 - 1,
                                    7736 * 4336])
@pytest.mark.parametrize("n_xforms", [1, 5])
def test_record_bits_keep_records_below_the_sentinel(n_bins, n_xforms):
    """The largest record a render can make (the junk bin, every lower
    bit set) stays below 0xFFFFFFFF for every backend and for the
    opacity-extended split, wherever the records pack at all."""
    cam = SimpleNamespace(layout_bins=n_bins, n_bins=n_bins)
    key = SimpleNamespace(n_xforms=n_xforms)
    op_bits = tit.opacity_bits_for(n_bins, n_xforms)[0]
    packed = 0
    for backend in tit.PACKED_FLUSHES:
        for ob in (0, op_bits) if op_bits else (0,):
            cbits, tot = tit.record_bits(key, cam, backend, ob)
            if cbits:
                packed += 1
                assert (n_bins << tot) | ((1 << tot) - 1) < flush.SENTINEL
    assert packed or n_bins > 2 ** 24 - 2


def test_launch_counts_each_kernel_launch(monkeypatch):
    """The shared launch helper counts one per C entry call, each entry
    one kernel: the split flush's tiles and resolve kernels count two,
    in order; an entry that reports a CUDA error raises and is not
    counted."""
    calls = []

    class Lib:
        def __getattr__(self, entry):
            def fn(*args):
                calls.append(entry)
                return 700 if entry == "broken" else 0
            return fn
    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    before = flush.LAUNCHES["win_flush_rgb16"]
    dens, rgb = flush.alloc_split(N_BINS, "cpu")
    recs = torch.zeros(64, dtype=torch.int64)
    flush.rgb16_launch(recs, torch.zeros((256, 4)), 8, N_BINS, 1.0, dens,
                       rgb, flush.rgb16_scratch(64, "cpu"))
    assert calls == ["win_flush_rgb16_tiles", "win_flush_rgb16_resolve"]
    assert flush.LAUNCHES["win_flush_rgb16"] == before + 2
    counts = {"k": 0}
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.launch(counts, "k", "lib", "broken", (), 0)
    assert counts == {"k": 0}


# -- the tiled bitonic sort ------------------------------------------------

def _sign_bit_keys(n, seed=2):
    keys = np.random.RandomState(seed).randint(0, 2 ** 32, n,
                                               dtype=np.uint32)
    keys[:100] = 0xFFFFFFFF
    keys[100:200] = 0x80000000
    keys[200:300] = 0
    return keys


def test_plain_tiled_sort_runs_the_jax_schedule():
    """At the JAX tile (2^16) the plain version's state after the first
    local pass, and after the global substage plus the next local pass,
    equals the Pallas kernel's and XLA's; the result equals the Pallas
    sort's, sign-bit keys included."""
    n, tile = 2 * jps.TILE, jps.TILE
    keys = _sign_bit_keys(n)
    passes = tiled_sort.bitonic_schedule(n, tile)
    assert passes == [("local", 0), ("global", n, tile, tile), ("local", n)]
    x2d = jnp.asarray(keys).reshape(-1, 128)
    sched = [(1 << s, 1 << sub) for s in range(1, jps.TILE_LOG + 1)
             for sub in range(s - 1, -1, -1)]
    j1 = jps._local_pass(x2d, sched, True).reshape(-1)
    t1 = tiled_sort.run_passes(_i64(keys), passes[:1], tile)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    assert not (np.diff(t1.numpy()) >= 0).all()        # not yet sorted
    j2 = jps._xla_substage(j1, jnp.arange(n, dtype=jnp.uint32), n, tile)
    t2 = tiled_sort.run_passes(t1, passes[1:2], tile)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))
    j3 = np.asarray(jps.bitonic_sort_u32_tiled(jnp.asarray(keys),
                                               interpret=True))
    t3 = tiled_sort.run_passes(t2, passes[2:], tile)
    np.testing.assert_array_equal(t3.numpy(), j3.astype(np.int64))
    np.testing.assert_array_equal(
        tiled_sort.bitonic_sort_reference(_i64(keys), tile).numpy(),
        j3.astype(np.int64))


def test_tiled_sort_cpu_route_matches_torch_sort():
    n = 4 * tiled_sort.TILE
    keys = _i64(_sign_bit_keys(n, seed=3))
    passes = tiled_sort.bitonic_schedule(n)
    assert passes[0] == ("local", 0) and passes[-1] == ("local", n)
    # stage 2^16: stride 2^15; stage 2^17: strides 2^16 and 2^15 fused
    assert [p for p in passes if p[0] == "global"] == [
        ("global", 2 * tiled_sort.TILE, tiled_sort.TILE, tiled_sort.TILE),
        ("global", n, 2 * tiled_sort.TILE, tiled_sort.TILE)]
    before = tiled_sort.LAUNCHES["bitonic_sort"]
    out = tiled_sort.bitonic_sort_u32_tiled(keys)
    assert tiled_sort.LAUNCHES["bitonic_sort"] == before   # no kernel on CPU
    assert torch.equal(out, torch.sort(keys).values)


@pytest.mark.parametrize("log_n", [9, 12])
def test_fused_global_pass_equals_xla_substages(log_n):
    """Each global pass of the schedule fuses up to FUSE strides; from the
    state before it, the plain version's state after it equals that many
    XLA substages of the Pallas sort in a row."""
    n, tile = 1 << log_n, 8
    keys = _sign_bit_keys(n, seed=log_n)
    passes = tiled_sort.bitonic_schedule(n, tile)
    idx = jnp.arange(n, dtype=jnp.uint32)
    x = _i64(keys)
    fused = 0
    for p in passes:
        if p[0] == "global":
            strides = [p[2] >> i for i in range(p[2].bit_length())
                       if p[2] >> i >= p[3]]
            assert 1 <= len(strides) <= tiled_sort.FUSE
            fused = max(fused, len(strides))
            j = jnp.asarray(x.numpy().astype(np.uint32))
            for k in strides:
                j = jps._xla_substage(j, idx, p[1], k)
            x = tiled_sort.run_passes(x, [p], tile)
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(j).astype(np.int64))
        else:
            x = tiled_sort.run_passes(x, [p], tile)
    assert fused == tiled_sort.FUSE
    np.testing.assert_array_equal(x.numpy(), np.sort(keys).astype(np.int64))


# passes of the sort of 2^log_n keys at TILE = 2^15: one local pass up to
# TILE; beyond it one local pass a stage plus ceil((s - 15) / 4) global
# passes for stage 2^s (2^22 keys: 8 local + 10 global, against the 8 +
# 28 of one global pass a stride)
SORT_PASSES = {**{log_n: 1 for log_n in range(0, 16)},
               16: 3, 17: 5, 18: 7, 19: 9, 20: 12, 21: 15, 22: 18, 23: 21}


@pytest.mark.parametrize("log_n", range(1, 24))
def test_bitonic_schedule_pass_counts(log_n):
    n = 1 << log_n
    passes = tiled_sort.bitonic_schedule(n)
    assert len(passes) == SORT_PASSES[log_n]
    assert passes[0] == ("local", 0)
    local = [p for p in passes if p[0] == "local"]
    assert len(local) == 1 + max(log_n - tiled_sort.TILE_LOG, 0)
    for p in passes:
        if p[0] == "global":
            assert tiled_sort.TILE <= p[3] <= p[2] < p[1] <= n
            assert p[2] // p[3] < 1 << tiled_sort.FUSE
    # every substage of the network, once, in order
    subs = []
    for p in passes:
        if p[0] == "global":
            k = p[2]
            while k >= p[3]:
                subs.append((p[1], k))
                k //= 2
        elif p[1] == 0:
            subs += [(1 << s, 1 << j)
                     for s in range(1, min(log_n, tiled_sort.TILE_LOG) + 1)
                     for j in range(s - 1, -1, -1)]
        else:
            subs += [(p[1], 1 << j)
                     for j in range(tiled_sort.TILE_LOG - 1, -1, -1)]
    assert subs == [(1 << s, 1 << j) for s in range(1, log_n + 1)
                    for j in range(s - 1, -1, -1)]


@pytest.mark.parametrize("n", [1, 2, 16, 512, 1 << 12, tiled_sort.TILE])
def test_plain_sort_below_two_tiles_matches_torch_sort(n):
    """N < 2 * TILE, which the Pallas sort hands to its plain network: one
    local pass (N <= TILE) sorts everything."""
    keys = _i64(_sign_bit_keys(max(n, 300), seed=n)[:n])
    assert tiled_sort.bitonic_schedule(n) == [("local", 0)]
    want = torch.sort(keys).values
    assert torch.equal(tiled_sort.bitonic_sort_reference(keys), want)
    assert torch.equal(tiled_sort.bitonic_sort_u32_tiled(keys), want)
    assert torch.equal(tsort.sort_records(keys), want)


def test_plain_flushes_launch_nothing(monkeypatch):
    """The plain versions sort with torch.sort, never with sort_records
    (which launches the sort kernel on the card), and launch no kernel."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a plain version launched a kernel")
    monkeypatch.setattr(build, "launch", no_launch)
    monkeypatch.setattr(flush, "sort_records", no_launch)
    monkeypatch.setattr(tsort, "bitonic_sort_u32_tiled", no_launch)
    # 3000 records: the sorted flushes pad them with 1096 sentinels
    rec = _i64(_records(14, 3000, 8))
    pal = torch.as_tensor(_palette(15, 256, 3))
    for plain in (flush.accumulate_windowed_reference,
                  flush.accumulate_packed_reference,
                  flush.accumulate_merged_reference):
        hist = plain(thist.alloc(N_BINS, "cpu"), rec, pal, N_BINS, 8)
        assert float(hist[:, 3].sum()) == 3000
    dens, _ = flush.accumulate_windowed_rgb16_reference(
        flush.alloc_split(N_BINS, "cpu"), rec, pal, N_BINS, 8)
    assert float(dens.sum()) == 3000
    assert torch.equal(tsort.sort_records_reference(rec)[:3000],
                       torch.sort(rec).values)
    assert torch.equal(tiled_sort.bitonic_sort_reference(rec[:2048]),
                       torch.sort(rec[:2048]).values)


def test_launch_types_each_entry_once(monkeypatch):
    """build.launch looks up and types a C entry once per (library,
    entry), not on every launch, and still counts every launch."""
    lookups = []

    class Lib:
        def __getattr__(self, entry):
            lookups.append(entry)
            return lambda *args: 0
    lib = Lib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    counts = {"k": 0}
    for _ in range(3):
        build.launch(counts, "k", "lib", "entry", (ctypes.c_int,), 0, 1)
    assert lookups == ["entry"] and counts == {"k": 3}


def test_tiled_sort_argument_checks():
    with pytest.raises(ValueError, match="power of two"):
        tiled_sort.bitonic_sort_u32_tiled(
            torch.zeros(3 * tiled_sort.TILE, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        tiled_sort.bitonic_sort_u32_tiled(
            torch.zeros(2 * tiled_sort.TILE, dtype=torch.int32))
    with pytest.raises(ValueError, match="powers of two"):
        tiled_sort.bitonic_schedule(1000, 64)


@pytest.mark.parametrize("bad", [-1, 1 << 32])
@pytest.mark.parametrize("fn", ["bitonic_sort_reference",
                                "bitonic_sort_u32_tiled"])
def test_tiled_sort_refuses_keys_outside_u32(fn, bad):
    """The sort's keys are u32 values: on the CPU the plain version
    refuses any other int64 value (the card narrows them unchecked)."""
    keys = torch.arange(1024, dtype=torch.int64)
    keys[517] = bad
    with pytest.raises(ValueError, match="u32"):
        getattr(tiled_sort, fn)(keys)


# -- whole renders ---------------------------------------------------------

def _inject_jax_state(monkeypatch):
    """The port's Renderer starts from the trajectories JAX's Renderer
    seeds for the same seed."""
    def init_state(generator, batch, device):
        js = jit_.init_state(jax.random.PRNGKey(generator.initial_seed()),
                             batch)
        return tparams.state_from_numpy(
            *(np.asarray(v) for v in (js.x, js.y, js.color, js.last_xf,
                                      js.age, js.rng)), device=device)
    monkeypatch.setattr(trender, "init_state", init_state)


def _tv(a, b):
    da = np.asarray(a, np.float64)[:-1, 3]
    db = np.asarray(b, np.float64)[:-1, 3]
    return 0.5 * np.abs(da / da.sum() - db / db.sum()).sum()


PROF = dict(width=48, height=48, quality=100, batch=4096,
            iters_per_chunk=16, fuse=20, de_enabled=False)


@pytest.mark.parametrize("backend", NEW_BACKENDS)
def test_backend_render_matches_jax_by_distribution(backend, monkeypatch):
    """The JAX side runs the same backend where it is XLA and `scatter`
    where it is a Pallas kernel (interpret mode is too slow for a
    render; the JAX package's own tests hold its kernels to scatter)."""
    _inject_jax_state(monkeypatch)
    g = full_feature()
    jb = backend if backend in jhist.BACKENDS else "scatter"
    jr = jrender.Renderer(g, RenderProfile(**PROF, hist_backend=jb))
    j11, _ = jr.accumulate(0.0, seed=11)
    j12, _ = jr.accumulate(0.0, seed=12)
    tr = trender.Renderer(tparams.genome_from_jax(g),
                          TProfile(**PROF, hist_backend=backend),
                          device="cpu")
    assert tr.backend == backend
    t11, stats = tr.accumulate(0.0, seed=11)
    assert t11.shape == (tr.cam.n_bins + 1, 4) and t11.dtype == torch.float32
    assert float(t11[:-1, 3].sum()) == stats.plotted_samples
    d, floor = _tv(t11.numpy(), j11), _tv(j11, j12)
    assert d < 2.0 * floor, (d, floor)
    img = tr.finalize_frame(t11)
    assert img.shape == (48, 48, 4) and img[..., :3].any()


@pytest.mark.parametrize("genome", [sierpinski, full_feature])
def test_every_backend_density_equals_pallas_win(genome):
    g = tparams.genome_from_jax(genome())
    prof = dict(width=40, height=40, quality=30, batch=2048,
                iters_per_chunk=8, fuse=16, de_enabled=False)
    ref, _ = trender.Renderer(g, TProfile(**prof, hist_backend="pallas_win"),
                              device="cpu").accumulate(0.0, seed=3)
    for backend in ("scatter",) + NEW_BACKENDS:
        h, _ = trender.Renderer(g, TProfile(**prof, hist_backend=backend),
                                device="cpu").accumulate(0.0, seed=3)
        assert torch.equal(h[:, 3], ref[:, 3]), backend
        # rgb: other colour depths (10 bits off the windowed flushes) and
        # bf16 storage move it, within a bf16 ulp of a colour sum
        assert float((h[:, :3] - ref[:, :3]).abs().max()) \
            <= 2 ** -7 * float(ref[:, 3].max()) + 1.0, backend


def test_record_bits_cap_windowed_backends_only():
    g = tparams.genome_from_jax(full_feature())
    r = trender.Renderer(g, TProfile(width=32, height=32), device="cpu")
    for backend in ("pallas_win", "pallas_rgb16", "pallas", "pallas_merged",
                    "scatter", "atomic"):
        jb = jit_.color_bits_for(r.cam.layout_bins)
        if backend in ("pallas_win", "pallas_rgb16", "atomic"):
            jb = min(jb, 8)
        assert tit.record_bits(r.key, r.cam, backend) == (jb, jb)
    assert tit.record_bits(r.key, r.cam, "pallas")[0] == 10
    assert tit.record_bits(r.key, r.cam, "atomic")[0] == 8


@pytest.mark.parametrize("n_bins", [32 * 32, 1310 * 750, 2 ** 22 - 2,
                                    3896 * 2216, 2 ** 24 - 2])
@pytest.mark.parametrize("n_xforms", [3, 7])
def test_record_bits_atomic_packs_pallas_wins_records(n_bins, n_xforms):
    """`atomic` caps its colour bits at 8 where `pallas` takes up to 10,
    and packs the records of `pallas_win` in every geometry, the
    opacity-extended split included."""
    cam = SimpleNamespace(layout_bins=n_bins, n_bins=n_bins)
    key = SimpleNamespace(n_xforms=n_xforms)
    op_bits = tit.opacity_bits_for(n_bins, n_xforms)[0]
    for ob in (0, op_bits):
        assert tit.record_bits(key, cam, "atomic", ob) == \
            tit.record_bits(key, cam, "pallas_win", ob)
    cbits = tit.color_bits_for(n_bins)
    assert tit.record_bits(key, cam, "atomic")[0] == min(cbits, 8)
    assert tit.record_bits(key, cam, "pallas")[0] == cbits


@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.37)])
def test_atomic_flushes_as_pallas_win(cols, weight):
    """The same records into the same histogram through `atomic` (no
    sort) and `pallas_win` (sorted): density exact at weight 1 with a
    3-column palette, every channel within float32 reassociation."""
    rec = _i64(_records(21, 6000, 8))
    pal = torch.as_tensor(_palette(22, 256, cols))
    start = torch.as_tensor(_palette(23, N_BINS + 1, 4) * 50.0)
    out = {}
    for backend in ("atomic", "pallas_win"):
        hist = start.clone()
        got = tit.PACKED_FLUSHES[backend](hist, rec.clone(), pal, N_BINS, 8,
                                          weight)
        assert got is hist
        out[backend] = hist
    a, w = out["atomic"], out["pallas_win"]
    assert not torch.equal(a, start)
    if weight is None:
        assert torch.equal(a[:, 3], w[:, 3])
    torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)


def _opacity_genome():
    g = tparams.genome_from_jax(full_feature())
    g.xforms[1].opacity = TSpline(0.5)
    return g


@pytest.mark.parametrize("genome", ["sierpinski", "full_feature",
                                    "opacity"])
def test_atomic_renders_pallas_wins_records(genome, monkeypatch):
    """A CPU render through `atomic` flushes the very records
    `pallas_win` flushes on the same seed (the same colour bits, the
    same chaos game) into the same histogram: density equal bin for
    bin, rgb within float32 reassociation."""
    g = (_opacity_genome() if genome == "opacity" else
         tparams.genome_from_jax({"sierpinski": sierpinski,
                                  "full_feature": full_feature}[genome]()))
    prof = dict(width=40, height=40, quality=20, batch=2048,
                iters_per_chunk=8, fuse=16, de_enabled=False)
    seen, out = {}, {}
    for backend in ("atomic", "pallas_win"):
        real = tit.PACKED_FLUSHES[backend]

        def keep(hist, recs, palette_hi, n_bins, bits, weight=None,
                 _b=backend, _real=real):
            seen.setdefault(_b, []).append((recs.clone(), palette_hi, bits))
            return _real(hist, recs, palette_hi, n_bins, bits, weight)
        monkeypatch.setitem(tit.PACKED_FLUSHES, backend, keep)
        r = trender.Renderer(g, TProfile(**prof, hist_backend=backend),
                             device="cpu")
        assert r.backend == backend
        assert bool(r.op_bits) == (genome == "opacity")
        out[backend], _ = r.accumulate(0.0, seed=5)
    assert len(seen["atomic"]) == len(seen["pallas_win"]) > 1
    for (ra, pa, ba), (rw, pw, bw) in zip(seen["atomic"],
                                          seen["pallas_win"]):
        assert ba == bw and torch.equal(ra, rw) and torch.equal(pa, pw)
    a, w = out["atomic"], out["pallas_win"]
    assert torch.equal(a[:, 3], w[:, 3])
    torch.testing.assert_close(a[:, :3], w[:, :3], rtol=1e-4, atol=1e-4)


def test_rgb16_resume_rounds_rgb_once(monkeypatch):
    """A hist0 resumed through pallas_rgb16 enters the split layout once:
    density keeps its mass exactly, rgb of untouched bins is the bf16
    rounding of hist0's."""
    g = tparams.genome_from_jax(sierpinski())
    prof = TProfile(width=40, height=32, quality=20, batch=2048,
                    iters_per_chunk=8, fuse=16, hist_backend="pallas_rgb16")
    r = trender.Renderer(g, prof, device="cpu")
    rs = np.random.RandomState(12)
    h0 = rs.rand(r.cam.n_bins + 1, 4).astype(np.float32) * 10.0
    h0[:, 3] = rs.randint(0, 50, r.cam.n_bins + 1)
    h1, stats = r.accumulate(0.0, seed=4, hist0=h0)
    h1 = h1.numpy()
    assert h1[:-1, 3].sum() - h0[:-1, 3].sum() == stats.plotted_samples
    untouched = h1[:, 3] == h0[:, 3]
    assert untouched.sum() > 0
    want = torch.as_tensor(h0[:, :3]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(h1[untouched, :3], want[untouched])


@pytest.mark.parametrize("backend", ["pallas_rgb16", "sortcum"])
def test_cli_passes_backend_through(backend, tmp_path, capsys):
    out = tmp_path / "s.png"
    rc = tmain.main(["gallery:sierpinski", "-o", str(out), "--cpu",
                     "--width", "32", "--height", "32", "--quality", "20",
                     "--hist-backend", backend, "--stats"])
    assert rc == 0 and out.stat().st_size > 0
    assert f"[{backend} on cpu]" in capsys.readouterr().err


# each backend's facts as the name tuples the table replaced held them:
# (packed, colour-bit cap, split layout, C loop, tunable, tiled flush)
BACKEND_FACTS = {
    "scatter": (False, None, False, False, True, False),
    "scatter_sorted": (False, None, False, False, True, False),
    "sortcum": (False, None, False, False, False, False),
    "pallas": (True, None, False, True, False, False),
    "pallas_merged": (True, None, False, False, False, False),
    "pallas_win": (True, 8, False, False, True, True),
    "pallas_rgb16": (True, 8, True, False, True, True),
    "atomic": (True, 8, False, True, True, False),
}


@pytest.mark.parametrize("name", sorted(BACKEND_FACTS))
def test_backend_table_holds_each_backends_facts(name):
    """The table's record of each of the eight backends; a packed one
    has a flush in PACKED_FLUSHES, an unpacked one its accumulate."""
    assert set(thist.BACKENDS) == set(BACKEND_FACTS)
    b = thist.BACKENDS[name]
    assert (b.packed, b.color_bits, b.split, b.c_loop, b.tunable,
            b.tiled_flush) == BACKEND_FACTS[name]
    assert (name in tit.PACKED_FLUSHES) == b.packed
    assert b.packed or b.accumulate is getattr(
        thist, f"accumulate_{name}")
    assert thist.get_backend(name) is b
    with pytest.raises(ValueError, match="unknown histogram backend"):
        thist.get_backend(name + "_x")


def test_cli_backend_choices_are_auto_and_the_table():
    action = next(a for a in tmain.build_parser()._actions
                  if a.dest == "hist_backend")
    assert tuple(action.choices) == ("auto", *thist.BACKENDS)


@pytest.mark.parametrize("backend", thist.BACKENDS)
def test_c_loop_only_for_the_unsorted_packed_flush_on_the_card(backend):
    """The loop follows the backend's name and the device alone."""
    c_loop = backend in ("atomic", "pallas")
    assert tit.takes_c_loop(backend, torch.device("cuda")) == c_loop
    assert tit.takes_c_loop(backend, "cuda:0") == c_loop
    assert not tit.takes_c_loop(backend, torch.device("cpu"))


@pytest.mark.parametrize("backend", ["atomic", "pallas"])
def test_a_wrapped_flush_keeps_the_c_loop(backend, monkeypatch):
    """A wrapper around a PACKED_FLUSHES entry does not reroute the
    card's chunks to the Python loop: the C loop is taken, and the
    wrapper is never called."""
    calls = []

    def looped(plan, state, recs, hist, palette_hi, n_chunks, weight):
        calls.append(n_chunks)
        return state, torch.zeros((), dtype=torch.float32)

    def spy(*args, **kwargs):
        raise AssertionError("the wrapped flush ran a chunk")
    monkeypatch.setitem(tit.PACKED_FLUSHES, backend, spy)
    monkeypatch.setattr(tit, "takes_c_loop",
                        lambda b, device, real=tit.takes_c_loop:
                        real(b, "cuda"))
    monkeypatch.setattr(tit.chaos, "launch_accumulate", looped)
    prof = TProfile(width=32, height=32, quality=32, batch=1024,
                    iters_per_chunk=8, fuse=8, de_enabled=False,
                    hist_backend=backend)
    r = trender.Renderer(tparams.genome_from_jax(sierpinski()), prof,
                         device="cpu")
    _hist, stats = r.accumulate(0.0, seed=3)
    assert sum(calls) == stats.chunks > 1


@pytest.mark.parametrize("backend", ["pallas_win", "pallas_merged",
                                     "pallas_rgb16", "pallas", "atomic",
                                     "scatter", "scatter_sorted", "sortcum",
                                     "unpacked"])
def test_python_loop_on_the_cpu_for_every_backend(backend, monkeypatch):
    """A CPU render through every backend (and the unpacked path) keeps
    the Python loop: the C loop is never entered, no chunk counts as
    looped, and the chunks and their plotted count are the frame's."""
    def refuse(*a, **kw):
        raise AssertionError("entered the C loop on the CPU")
    monkeypatch.setattr(tit.chaos, "launch_accumulate", refuse)
    if backend == "unpacked":
        monkeypatch.setattr(trender, "color_bits_for", lambda n_bins: 0)
    prof = TProfile(width=32, height=32, quality=32, batch=1024,
                    iters_per_chunk=8, fuse=8, de_enabled=False,
                    hist_backend="scatter" if backend == "unpacked"
                    else backend)
    r = trender.Renderer(tparams.genome_from_jax(sierpinski()), prof,
                         device="cpu")
    assert r.packed == (backend != "unpacked")
    before = trace.counters()
    hist, stats = r.accumulate(0.0, seed=3)
    counted = trace.since(before)
    assert counted["looped_chunks"] == 0
    assert counted["chunks"] == stats.chunks > 1
    assert float(hist[:-1, 3].sum()) == stats.plotted_samples > 0
