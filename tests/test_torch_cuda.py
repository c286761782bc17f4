"""The port on the GPU: every CUDA kernel against its plain version, no
fallback when a kernel cannot be built, and renders that go through
the kernels.

Every test here carries the `cuda` marker and skips on hosts without
a GPU.  The file imports only the port, so it runs as it is on the GPU
machine:  python -m pytest tests/test_torch_cuda.py -q --noconftest
Contracts as in test_torch_flush.py and test_torch_backends.py: density
exact with a 3-column palette at weight 1.0, every channel within 1e-5
of the bin's density otherwise; the split flush's rgb within one bf16
ulp of its plain version; the tiled sort equal to torch.sort, and the
sort of every sorted flush on the card; a render
on the GPU and on the CPU from the same seed (the same starting
trajectories) agree by TV distance under the CPU's two-seed floor, a
motion-blurred one too; every flush at a gaussian temporal filter's
weights (0.011, 0.325) from a nonzero histogram within 1e-5 of the
bin's density; overlapped frames equal serial ones bit for bit through
the split flush, one wait a frame after the first against the serial
frame's three; an upload queued behind a long kernel returns before
the kernel ends, and 200 uploads through the pinned cache keep their
values; a striped frame's density equal to the whole frame's
in every bin, its flush kernels launched once a flush in every stripe;
a tune record for this card steers `auto` and the flush size and the
repo's TPU record does not; the native output encoder is in use; a
`--trace-dir` render's trace holds each hand kernel's launches.
`auto` without a tune record is `atomic` on the card: a 1080p still
through it launches no sort and one `packed_flush` a chunk, on the
records `pallas_win` flushes; on a real second flush of that render
`atomic` and `pallas_win` give density bit for bit and rgb within 1e-5
of the bin's density.  The
chaos-game kernel against the eager step loop, its plain version: every
variation alone with its RNG words exact and (dx, dy) within rtol 1e-4,
atol 1e-5 in >= 99.9% of points; chunks of the genomes of
test_torch_chaos.py with the RNG words and the selected xforms exact
at every step, step 1's records equal in >= 99.9% of lanes; every
variation inside a key's union (VARIATION_GROUPS) bit-exact to the
eager loop over 32 steps; one launch a chunk on every render path, the
key's library loaded by the Renderer; no fallback when it cannot be
built.
The bf16 probe's kernels (csrc/bf16_probe.cu) bit-equal to their plain
versions, one launch a call, repeated so that a missing proxy fence
shows; a schedule that revisits a block refused before any launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch import retune as tretune  # noqa: E402
from cuburn_tpu_torch.genome.spline import Spline  # noqa: E402
from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.models import (animated_spark, full_feature,  # noqa: E402
                                     sierpinski)
from cuburn_tpu_torch.models.gallery import tilted  # noqa: E402
from cuburn_tpu_torch.ops import camera as tcam  # noqa: E402
from cuburn_tpu_torch.ops import chaos, flush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.ops import iterate as tit  # noqa: E402
from cuburn_tpu_torch.ops import rng as trng  # noqa: E402
from cuburn_tpu_torch.ops import tiled_sort  # noqa: E402
from cuburn_tpu_torch.ops import variations as tvar  # noqa: E402
from cuburn_tpu_torch.probes import bf16probe  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch.utils import trace  # noqa: E402

N_BINS = 300 * 200

pytestmark = pytest.mark.cuda

# the backends that flush their records unsorted
UNSORTED = ("pallas", "atomic")

# wrapper, its plain version and its LAUNCHES key, per logical flush
FLUSHES = {
    "pallas_win": (flush.accumulate_windowed,
                   flush.accumulate_windowed_reference, "win_flush"),
    "pallas": (flush.accumulate_packed, flush.accumulate_packed_reference,
               "packed_flush"),
    "pallas_merged": (flush.accumulate_merged,
                      flush.accumulate_merged_reference, "merged_flush"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _records(seed, n, bits, sentinels):
    rs = np.random.RandomState(seed)
    addr = np.concatenate([rs.randint(0, N_BINS + 1, n // 2),
                           rs.randint(1000, 1100, n // 4),
                           np.full(n - n // 2 - n // 4, N_BINS)])
    rec = (addr.astype(np.int64) << bits) | rs.randint(0, 1 << bits, n)
    rec = rs.permutation(rec)
    rec[:sentinels] = 0xFFFFFFFF
    return rec


def _flush(fn, rec, pal, bits, weight, device):
    hist = thist.alloc(N_BINS, device)
    out = fn(hist, torch.as_tensor(rec, device=device),
             torch.as_tensor(pal, device=device), N_BINS, bits,
             weight=weight)
    assert out is hist
    return out.cpu().numpy()[:N_BINS]


@pytest.mark.parametrize("backend", sorted(FLUSHES))
@pytest.mark.parametrize("cols,bits,weight", [(3, 8, None), (3, 8, 0.37),
                                              (4, 10, 1.0),
                                              (4, 10, 0.37)])
def test_kernel_matches_plain_version(cuda, backend, cols, bits, weight):
    kernel, plain, name = FLUSHES[backend]
    # the unsorted flush takes no sort padding, so no sentinels
    rec = _records(7, 1 << 18, bits,
                   sentinels=0 if backend == "pallas" else 100)
    pal = np.random.RandomState(8).rand(1 << bits, cols) \
        .astype(np.float32)
    before = flush.LAUNCHES[name]
    sorts = tiled_sort.LAUNCHES["bitonic_sort"]
    got = _flush(kernel, rec, pal, bits, weight, cuda)
    torch.cuda.synchronize()
    assert flush.LAUNCHES[name] == before + 1
    # the sorted flushes sort on the card with the tiled bitonic sort
    assert tiled_sort.LAUNCHES["bitonic_sort"] == sorts + (
        0 if backend == "pallas" else len(tiled_sort.bitonic_schedule(
            rec.size)))
    ref = _flush(plain, rec, pal, bits, weight, "cpu")
    if cols == 3 and weight is None:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    bound = 1e-5 * np.maximum(ref[:, 3:4], 1.0)
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("weight", [None, 0.37])
def test_rgb16_kernel_matches_plain_version(cuda, weight):
    """From a nonzero split histogram: density exact at weight 1.0
    (within 1e-5 of itself otherwise), rgb within one bf16 ulp."""
    rs = np.random.RandomState(9)
    rec = _records(10, 1 << 18, 8, sentinels=100)
    pal = rs.rand(256, 3).astype(np.float32)
    start = rs.rand(N_BINS + 1, 4).astype(np.float32) * 50.0
    start[:, 3] = rs.randint(0, 1000, N_BINS + 1)
    outs = []
    for dev in (cuda, "cpu"):
        split = flush.to_split_layout(torch.as_tensor(start, device=dev))
        fn = (flush.accumulate_windowed_rgb16 if dev == cuda
              else flush.accumulate_windowed_rgb16_reference)
        before = flush.LAUNCHES["win_flush_rgb16"]
        dens, rgb = fn(split, torch.as_tensor(rec, device=dev),
                       torch.as_tensor(pal, device=dev), N_BINS, 8,
                       weight=weight)
        assert dens is split[0] and rgb is split[1]
        # two kernels a flush on the card: the tiles, then the resolve
        assert flush.LAUNCHES["win_flush_rgb16"] \
            == before + 2 * (dev == cuda)
        outs.append((dens.cpu(), rgb.cpu()))
    (dg, rg), (dr, rr) = outs
    if weight is None:
        assert torch.equal(dg, dr)
    assert bool(((dg - dr).abs() <= 1e-5 * dr.clamp(min=1.0)).all())
    ulp = torch.finfo(torch.bfloat16).eps * rr.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert bool(((rg.float() - rr.float()).abs() <= ulp).all())


def _sort_keys(kind, n):
    rs = np.random.RandomState(n % 997)
    keys = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    if kind == "equal":
        keys[:] = 0x80000001
    elif kind == "sorted":
        keys.sort()
    elif kind == "reversed":
        keys = np.sort(keys)[::-1].copy()
    elif kind == "sign_bit_sentinel":
        keys[::3] = 0xFFFFFFFF
        keys[1::3] = 0x80000000
        keys[2::6] = 0
    return keys


@pytest.mark.parametrize("kind", ["random", "equal", "sorted", "reversed",
                                  "sign_bit_sentinel"])
@pytest.mark.parametrize("n", [2, 1024, tiled_sort.TILE,
                               2 * tiled_sort.TILE, 1 << 20])
def test_tiled_sort_matches_torch_sort(cuda, n, kind):
    keys = _sort_keys(kind, n)
    k = torch.as_tensor(keys, device=cuda)
    before = tiled_sort.LAUNCHES["bitonic_sort"]
    got = tiled_sort.bitonic_sort_u32_tiled(k)
    assert tiled_sort.LAUNCHES["bitonic_sort"] \
        == before + len(tiled_sort.bitonic_schedule(n))
    assert got.dtype == torch.int64 and got.data_ptr() != k.data_ptr()
    assert torch.equal(got, torch.sort(k).values)
    assert torch.equal(k.cpu(), torch.as_tensor(keys))   # input untouched


# records a block of win_flush.cu (its kTile)
WIN_TILE = 4096


def _sorted_records(case, bits=8):
    """Sorted records (int64 numpy) shaped to hit win_flush.cu's tile
    edges: mostly junk; a run exactly one tile long on a tile boundary;
    one run over many tiles; a tail of sentinels; a length that is no
    multiple of the tile."""
    rs = np.random.RandomState(len(case))
    if case == "junk_97":
        n = 1 << 17
        addr = np.concatenate([rs.randint(0, N_BINS, n * 3 // 100),
                               np.full(n - n * 3 // 100, N_BINS)])
    elif case == "run_one_tile_aligned":
        addr = np.concatenate([np.arange(WIN_TILE) * 3,
                               np.full(WIN_TILE, 20000),
                               rs.randint(20001, N_BINS + 1, 3 * WIN_TILE)])
    elif case == "run_many_tiles":
        addr = np.concatenate([rs.randint(0, 777, 5000),
                               np.full(5 * WIN_TILE + 123, 777),
                               rs.randint(778, N_BINS, 7000)])
    elif case == "sentinel_tail":
        addr = rs.randint(0, N_BINS + 1, 5000)
    else:   # ragged
        addr = np.concatenate([rs.randint(0, N_BINS, 3 * WIN_TILE + 77),
                               rs.randint(500, 520, 300)])
    rec = np.sort((addr.astype(np.int64) << bits)
                  | rs.randint(0, 1 << bits, addr.size))
    if case == "sentinel_tail":
        rec = np.concatenate([rec, np.full(8192 - rec.size, 0xFFFFFFFF)])
    return rec


@pytest.mark.parametrize("case", ["junk_97", "run_one_tile_aligned",
                                  "run_many_tiles", "sentinel_tail",
                                  "ragged"])
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_win_flush_tile_edges(cuda, case, cols, weight):
    """win_flush.cu on sorted records, launched alone and through its
    wrapper, against the plain version: density exact at weight 1.0
    (the junk bin too), every channel of the real bins within 1e-5 of
    the bin's density.  Palette entries are multiples of 2^-8 and the
    weight 3/8, so every sum here is exact in float32 in any order: a
    run of 20K records of random float32 colours carries ~2e-5 of
    rounding in the plain version's own sequential sum."""
    rec = _sorted_records(case)
    pal = (np.random.RandomState(3).randint(0, 256, (256, cols))
           / 256.0).astype(np.float32)
    ref = flush.accumulate_windowed_reference(
        thist.alloc(N_BINS, "cpu"), torch.as_tensor(rec),
        torch.as_tensor(pal), N_BINS, 8, weight=weight).numpy()
    hist = thist.alloc(N_BINS, cuda)
    r = torch.as_tensor(rec, device=cuda)
    p = flush._aligned_pal4(torch.as_tensor(pal, device=cuda))
    before = flush.LAUNCHES["win_flush"]
    flush._launch("win_flush", cuda, r.data_ptr(), r.numel(), p.data_ptr(),
                  8, N_BINS, 1.0 if weight is None else weight,
                  hist.data_ptr())
    torch.cuda.synchronize()
    assert flush.LAUNCHES["win_flush"] == before + 1
    outs = [hist.cpu().numpy()]
    if case != "ragged":    # the wrapper pads to a power of two
        live = torch.as_tensor(rec[rec != 0xFFFFFFFF], device=cuda)
        outs.append(flush.accumulate_windowed(
            thist.alloc(N_BINS, cuda), live,
            torch.as_tensor(pal, device=cuda), N_BINS, 8,
            weight=weight).cpu().numpy())
    for got in outs:
        if weight is None:
            np.testing.assert_array_equal(got[:, 3], ref[:, 3])
        err = np.abs(got[:N_BINS] - ref[:N_BINS])
        assert (err <= 1e-5 * np.maximum(ref[:N_BINS, 3:4], 1.0)).all()
    assert ref[:N_BINS, 3].sum() > 0


def _rgb16_alone(rec, pal, split, weight, device):
    """win_flush_rgb16.cu's two kernels alone on sorted records `rec`
    (numpy), into `split` in place."""
    r = torch.as_tensor(rec, device=device)
    p = flush._aligned_pal4(torch.as_tensor(pal, device=device))
    before = flush.LAUNCHES["win_flush_rgb16"]
    flush.rgb16_launch(r, p, 8, N_BINS, 1.0 if weight is None else weight,
                       split[0], split[1],
                       flush.rgb16_scratch(r.numel(), device))
    torch.cuda.synchronize()
    assert flush.LAUNCHES["win_flush_rgb16"] == before + 2
    return split


def _split_start(seed, device):
    """A nonzero split histogram: integer density, rgb up to 50."""
    rs = np.random.RandomState(seed)
    start = rs.rand(N_BINS + 1, 4).astype(np.float32) * 50.0
    start[:, 3] = rs.randint(0, 1000, N_BINS + 1)
    return flush.to_split_layout(torch.as_tensor(start, device=device))


# sorted records that put runs on win_flush_rgb16.cu's tile edges: the
# windowed flush's five cases, and the run cases of SCATTER_CASES sorted
RGB16_CASES = ("junk_97", "run_one_tile_aligned", "run_many_tiles",
               "sentinel_tail", "ragged", "run_ends_on_tile",
               "run_across_one_tile_edge", "run_across_three_tiles",
               "all_equal", "all_distinct", "n_1", "n_4097",
               "padding_after_junk")


def _rgb16_records(case):
    if case in ("junk_97", "run_one_tile_aligned", "run_many_tiles",
                "sentinel_tail", "ragged"):
        return _sorted_records(case)
    return np.sort(scatter_records(case, N_BINS))


@pytest.mark.parametrize("case", RGB16_CASES)
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_rgb16_tile_edges(cuda, case, cols, weight):
    """win_flush_rgb16.cu on sorted records, its two kernels alone and
    through the wrapper, from a nonzero split histogram, against the
    plain version.  Palette entries are multiples of 2^-8 and the weight
    3/8, so every sum of a real bin is exact in float32 in any order:
    density and the bf16 rgb equal the plain version's bit for bit, and
    bins without records keep their bits.  The junk bin's count is
    exact at weight 1.0; its sum of up to 127K colours is not."""
    rec = _rgb16_records(case)
    pal = dyadic_palette(cols)
    ref = flush.accumulate_windowed_rgb16_reference(
        _split_start(4, "cpu"), torch.as_tensor(rec), torch.as_tensor(pal),
        N_BINS, 8, weight=weight)
    outs = [_rgb16_alone(rec, pal, _split_start(4, cuda), weight, cuda)]
    live = torch.as_tensor(rec[rec != 0xFFFFFFFF], device=cuda)
    sorts = tiled_sort.LAUNCHES["bitonic_sort"]
    outs.append(flush.accumulate_windowed_rgb16(
        _split_start(4, cuda), live[torch.randperm(live.numel(),
                                                   device=cuda)],
        torch.as_tensor(pal, device=cuda), N_BINS, 8, weight=weight))
    assert tiled_sort.LAUNCHES["bitonic_sort"] == sorts + len(
        tiled_sort.bitonic_schedule(1 << (live.numel() - 1).bit_length()))
    for dens, rgb in outs:
        if weight is None:
            assert torch.equal(dens.cpu(), ref[0])
        assert torch.equal(dens.cpu()[:N_BINS], ref[0][:N_BINS])
        assert torch.equal(rgb.cpu()[:N_BINS].view(torch.int16),
                           ref[1][:N_BINS].view(torch.int16))
    start = _split_start(4, "cpu")
    assert float(ref[0].double().sum()) > float(start[0].double().sum())


@pytest.mark.parametrize("case", ["run_many_tiles", "junk_97", "ragged",
                                  "all_equal"])
def test_rgb16_same_records_same_bits(cuda, case):
    """Five calls on the same sorted records from the same start give the
    same density and the same bf16 bits: the sums are formed in a fixed
    order, never by atomics.  A random float32 palette, so that another
    order would show."""
    rec = _rgb16_records(case)
    pal = np.random.RandomState(12).rand(256, 3).astype(np.float32)
    first = None
    for _ in range(5):
        dens, rgb = _rgb16_alone(rec, pal, _split_start(5, cuda), 0.37,
                                 cuda)
        if first is None:
            first = (dens, rgb)
        assert torch.equal(dens, first[0])
        assert torch.equal(rgb.view(torch.int16), first[1].view(torch.int16))
    ref = flush.accumulate_windowed_rgb16_reference(
        _split_start(5, "cpu"), torch.as_tensor(rec), torch.as_tensor(pal),
        N_BINS, 8, weight=0.37)
    dg, rg = first[0].cpu()[:N_BINS], first[1].cpu()[:N_BINS].float()
    dr, rr = ref[0][:N_BINS], ref[1][:N_BINS].float()
    assert bool(((dg - dr).abs() <= 1e-5 * dr.clamp(min=1.0)).all())
    ulp = torch.finfo(torch.bfloat16).eps * rr.abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert bool(((rg - rr).abs() <= ulp).all())


def test_rgb16_large_junk_run_is_exact(cuda):
    """A junk run over ~2000 tiles, as in a render's first flush: the
    junk bin's density is the exact count, through the resolve kernel's
    scan over all tiles, several tiles a thread."""
    rs = np.random.RandomState(13)
    n = (1 << 22) + 5000            # 2051 tiles: three a resolve thread
    live = np.sort((rs.randint(0, N_BINS, n // 32).astype(np.int64) << 8)
                   | rs.randint(0, 256, n // 32))
    junk = np.sort((np.int64(N_BINS) << 8) | rs.randint(0, 256,
                                                        n - live.size))
    rec = np.concatenate([live, junk])
    dens, rgb = _rgb16_alone(rec, dyadic_palette(3),
                             flush.alloc_split(N_BINS, cuda), None, cuda)
    assert float(dens[N_BINS]) == junk.size
    assert float(dens.double().sum()) == n
    ref = flush.accumulate_windowed_rgb16_reference(
        flush.alloc_split(N_BINS, "cpu"), torch.as_tensor(rec),
        torch.as_tensor(dyadic_palette(3)), N_BINS, 8)
    assert torch.equal(dens.cpu(), ref[0])
    assert torch.equal(rgb.cpu()[:N_BINS].view(torch.int16),
                       ref[1][:N_BINS].view(torch.int16))


# records a block of scatter_flush.cu's merged kernel (its kTile)
MERGED_TILE = 4096
# inputs the unsorted and the merged flush kernels are hard on, by name
# (scatter_records makes them); tests/test_torch_scatter.py holds the
# plain versions to the JAX package's kernels on the same list
SCATTER_CASES = ("junk_97", "run_ends_on_tile", "run_across_one_tile_edge",
                 "run_across_three_tiles", "all_equal", "all_distinct",
                 "n_1", "n_31", "n_33", "n_4097", "past_n_bins_colours",
                 "padding_after_junk")


def scatter_records(case, n_bins, bits=8, tile=MERGED_TILE):
    """Unsorted records (int64 numpy) of one of SCATTER_CASES.  The run
    cases place one run of equal records at known positions of the
    sorted order: ending exactly on a multiple of `tile`, across one
    tile edge, and from inside one tile over three more.  The others:
    97% junk; all records equal (a non-power-of-two count, so the
    sort's padding follows them); all distinct; counts that are no
    multiple of a warp or of a tile; addresses past n_bins with
    different colours; a junk run right in front of the padding."""
    rs = np.random.RandomState(SCATTER_CASES.index(case))
    space = n_bins << bits          # records below it are live

    def uniform(n, lo=0, hi=n_bins + 1):
        return (rs.randint(lo, hi, n).astype(np.int64) << bits) \
            | rs.randint(0, 1 << bits, n)

    def run_at(start, length, total):
        """`total` records: distinct ones below and above a run of
        `length` equal records that starts at sorted position `start`."""
        x = space // 2
        low = rs.choice(x, start, replace=False)
        high = x + 1 + rs.choice(space - x - 1, total - start - length,
                                 replace=False)
        return np.concatenate([low, np.full(length, x), high])
    if case == "junk_97":
        n = 2 * tile
        rec = np.concatenate([uniform(n * 3 // 100, hi=n_bins),
                              uniform(n - n * 3 // 100, lo=n_bins)])
    elif case == "run_ends_on_tile":
        rec = run_at(tile - 100, 100, 2 * tile)
    elif case == "run_across_one_tile_edge":
        rec = run_at(tile - 96, 200, 2 * tile)
    elif case == "run_across_three_tiles":
        rec = run_at(tile - 1096, 3 * tile, 4 * tile)
    elif case == "all_equal":
        rec = np.full(5000, (n_bins // 3 << bits) | 5)
    elif case == "all_distinct":
        rec = rs.choice(space, 2 * tile, replace=False)
    elif case.startswith("n_"):
        rec = uniform(int(case[2:]))
    elif case == "past_n_bins_colours":
        rec = np.concatenate([uniform(1500, lo=n_bins, hi=n_bins + 40),
                              uniform(1500, hi=n_bins)])
    else:   # padding_after_junk: 5000 records, padded to 8192
        rec = np.concatenate([uniform(4000, hi=n_bins),
                              uniform(1000, lo=n_bins)])
    assert rec.max() < 0xFFFFFFFF
    return rs.permutation(rec.astype(np.int64))


def dyadic_palette(cols, bits=8):
    """Palette entries that are multiples of 2^-8: with a weight of 3/8
    every sum of a flush is exact in float32 in any order."""
    return (np.random.RandomState(3).randint(0, 256, (1 << bits, cols))
            / 256.0).astype(np.float32)


@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("backend", ["pallas", "pallas_merged"])
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_scatter_flush_edge_cases(cuda, backend, case, cols, weight):
    """packed_flush and merged_flush (scatter_flush.cu) through their
    wrappers against their plain versions: density exact at weight 1.0
    (the junk bin too), every channel of the real bins within 1e-5 of
    the bin's density; one flush launch, and for the merged flush the
    sort's passes before it."""
    kernel, plain, name = FLUSHES[backend]
    rec = scatter_records(case, N_BINS)
    pal = dyadic_palette(cols)
    before = flush.LAUNCHES[name]
    sorts = tiled_sort.LAUNCHES["bitonic_sort"]
    hist = thist.alloc(N_BINS, cuda)
    got = kernel(hist, torch.as_tensor(rec, device=cuda),
                 torch.as_tensor(pal, device=cuda), N_BINS, 8,
                 weight=weight).cpu().numpy()
    assert flush.LAUNCHES[name] == before + 1
    assert tiled_sort.LAUNCHES["bitonic_sort"] == sorts + (
        0 if backend == "pallas" else len(tiled_sort.bitonic_schedule(
            1 << (rec.size - 1).bit_length())))
    ref = plain(thist.alloc(N_BINS, "cpu"), torch.as_tensor(rec),
                torch.as_tensor(pal), N_BINS, 8, weight=weight).numpy()
    if weight is None:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
        assert got[:, 3].sum() == rec.size
    err = np.abs(got[:N_BINS] - ref[:N_BINS])
    assert (err <= 1e-5 * np.maximum(ref[:N_BINS, 3:4], 1.0)).all()


@pytest.mark.parametrize("case", SCATTER_CASES + ("real_2_22",))
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_packed_flush_counts_its_plotted_records(cuda, case, cols, weight):
    """packed_flush's counting entry adds the records whose address is
    not the junk bin to the count, exactly as the plain version counts
    them (records past the junk bin included), on top of what the count
    held; the histogram as the flush without a count leaves it (density
    exact at weight 1.0, the rest within 1e-5 of the bin's density); one
    launch, counted under packed_flush.  real_2_22: 2^22 records, 3%
    junk, 8192 blocks."""
    if case == "real_2_22":
        rs = np.random.RandomState(22)
        n = 1 << 22
        addr = np.where(rs.rand(n) < 0.03, N_BINS, rs.randint(0, N_BINS, n))
        rec = (addr.astype(np.int64) << 8) | rs.randint(0, 256, n)
    else:
        rec = scatter_records(case, N_BINS)
    rec_d = torch.as_tensor(rec, device=cuda)
    pal = torch.as_tensor(dyadic_palette(cols))
    count = torch.full((), 5, dtype=torch.int64, device=cuda)
    before = flush.LAUNCHES["packed_flush"]
    got = flush.accumulate_packed(thist.alloc(N_BINS, cuda), rec_d,
                                  pal.to(cuda), N_BINS, 8, weight=weight,
                                  count=count).cpu().numpy()
    assert flush.LAUNCHES["packed_flush"] == before + 1
    want = torch.full((), 5, dtype=torch.int64)
    ref = flush.accumulate_packed_reference(
        thist.alloc(N_BINS, "cpu"), torch.as_tensor(rec), pal, N_BINS, 8,
        weight=weight, count=want).numpy()
    assert int(count) == int(want) == 5 + int(((rec >> 8) != N_BINS).sum())
    if weight is None:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    err = np.abs(got[:N_BINS] - ref[:N_BINS])
    assert (err <= 1e-5 * np.maximum(ref[:N_BINS, 3:4], 1.0)).all()


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_merged_kernel_alone_on_sorted_records(cuda, case):
    """merged_flush launched alone on sorted records without the sort's
    power-of-two padding (a ragged last tile), and with it."""
    live = np.sort(scatter_records(case, N_BINS))
    pal = dyadic_palette(3)
    ref = flush.accumulate_merged_reference(
        thist.alloc(N_BINS, "cpu"), torch.as_tensor(live),
        torch.as_tensor(pal), N_BINS, 8).numpy()
    p = flush._aligned_pal4(torch.as_tensor(pal, device=cuda))
    pad = np.full((1 << (live.size - 1).bit_length()) - live.size + 8,
                  0xFFFFFFFF)
    for rec in (live, np.concatenate([live, pad])):
        hist = thist.alloc(N_BINS, cuda)
        r = torch.as_tensor(rec, device=cuda)
        flush._launch("merged_flush", cuda, r.data_ptr(), r.numel(),
                      p.data_ptr(), 8, N_BINS, 1.0, hist.data_ptr())
        np.testing.assert_array_equal(hist.cpu().numpy(), ref)


def test_merged_flush_merges_in_the_kernel(cuda, monkeypatch):
    """On the card nothing runs between the sort and the launch: the
    torch merge of the plain version is never called."""
    def no_merge(*args, **kwargs):
        raise AssertionError("the CUDA merged flush merged with torch ops")
    monkeypatch.setattr(flush, "merge_records", no_merge)
    monkeypatch.setattr(flush, "merge_sorted_records", no_merge)
    rec = torch.as_tensor(_records(11, 5000, 8, 0), device=cuda)
    pal = torch.rand((256, 3), device=cuda)
    hist = flush.accumulate_merged(thist.alloc(N_BINS, cuda), rec, pal,
                                   N_BINS, 8)
    assert float(hist[:, 3].sum()) == 5000


@pytest.mark.parametrize("case,atomics", [
    # one atomic a block of 512 records for junk, whatever its colours
    ("all_junk", 32),
    # one a warp for 32 equal live records: 5000 = 156 x 32 + 8, and the
    # last 8 lie in two loads of a warp
    ("all_equal", 158),
    # one a record where no two share a bin
    ("all_distinct_bins", 8192)])
def test_packed_flush_counts_its_atomics(cuda, case, atomics):
    rs = np.random.RandomState(2)
    if case == "all_junk":
        rec = (np.int64(N_BINS) << 8) | rs.randint(0, 256, 16384)
    elif case == "all_equal":
        rec = scatter_records("all_equal", N_BINS)
    else:
        rec = (rs.choice(N_BINS, 8192, replace=False).astype(np.int64)
               << 8) | rs.randint(0, 256, 8192)
    r = torch.as_tensor(rec, device=cuda)
    p = flush._aligned_pal4(torch.rand((256, 3), device=cuda))
    hist = thist.alloc(N_BINS, cuda)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = flush.LAUNCHES["packed_flush"]
    flush._launch("packed_flush_counted", cuda, r.data_ptr(), r.numel(),
                  p.data_ptr(), 8, N_BINS, 1.0, hist.data_ptr(),
                  count.data_ptr())
    assert flush.LAUNCHES["packed_flush"] == before + 1
    assert int(count) == atomics
    assert float(hist[:, 3].sum()) == rec.size


def test_flush_raises_when_build_fails(cuda, monkeypatch):
    """No fallback: a kernel that cannot be built makes the CUDA flush
    raise instead of returning the plain result."""
    def broken(name):
        raise RuntimeError(f"nvcc failed building {name}.cu")
    monkeypatch.setattr(build, "load", broken)
    rec = torch.as_tensor(_records(9, 1000, 8, 0), device=cuda)
    pal = torch.rand((256, 3), device=cuda)
    sorts = tiled_sort.LAUNCHES["bitonic_sort"]
    for fn, _plain, name in FLUSHES.values():
        hist = thist.alloc(N_BINS, cuda)
        before = flush.LAUNCHES[name]
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(hist, rec, pal, N_BINS, 8)
        assert flush.LAUNCHES[name] == before
        assert float(hist.abs().sum()) == 0.0
    split = flush.alloc_split(N_BINS, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flush.accumulate_windowed_rgb16(split, rec, pal, N_BINS, 8)
    assert float(split[0].abs().sum()) == 0.0
    for n in (2, 2 * tiled_sort.TILE):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tiled_sort.bitonic_sort_u32_tiled(
                torch.zeros(n, dtype=torch.int64, device=cuda))
    assert tiled_sort.LAUNCHES["bitonic_sort"] == sorts


@pytest.mark.parametrize("backend,name", [
    ("pallas_win", "win_flush"), ("pallas", "packed_flush"),
    ("pallas_merged", "merged_flush"),
    ("pallas_rgb16", "win_flush_rgb16"), ("atomic", "packed_flush")])
def test_render_goes_through_kernel(cuda, backend, name):
    prof = RenderProfile(width=128, height=128, quality=20, batch=8192,
                         hist_backend=backend)
    r = trender.Renderer(full_feature(), prof)
    assert r.backend == backend and r.device.type == "cuda"
    flush.LAUNCHES[name] = 0
    tiled_sort.LAUNCHES["bitonic_sort"] = 0
    chaos.LAUNCHES["chaos_iterate"] = 0
    img, stats = r.render_frame(0.0, seed=1)
    assert flush.LAUNCHES[name] > 0
    # every sorted flush sorts with the kernel, one launch a pass
    assert (tiled_sort.LAUNCHES["bitonic_sort"] > 0) == \
        (backend not in UNSORTED)
    assert img.shape == (128, 128, 4) and img[..., :3].any()
    assert stats.plotted_samples > 0
    assert chaos.LAUNCHES["chaos_iterate"] > 0


def test_auto_backend_is_the_windowed_kernel(cuda):
    """`auto` without a tune record: the unsorted flush on the windowed
    flush's records (`atomic`), which took the default from
    `pallas_win`."""
    prof = RenderProfile(width=32, height=32, quality=5, batch=1024)
    assert trender.Renderer(sierpinski(), prof).backend == "atomic"


def _still_launches(r, seed):
    """Renderer r's accumulate on `seed` as production runs it: (hist,
    stats, the launches of each kernel, the chunks counted as looped)."""
    before = (dict(flush.LAUNCHES), tiled_sort.LAUNCHES["bitonic_sort"],
              chaos.LAUNCHES["chaos_iterate"], trace.COUNTS["looped_chunks"])
    hist, stats = r.accumulate(0.0, seed=seed)
    launches = {k: v - before[0][k] for k, v in flush.LAUNCHES.items()}
    launches["bitonic_sort"] = tiled_sort.LAUNCHES["bitonic_sort"] - before[1]
    launches["chaos_iterate"] = chaos.LAUNCHES["chaos_iterate"] - before[2]
    return hist, stats, launches, trace.COUNTS["looped_chunks"] - before[3]


@pytest.fixture(scope="module")
def default_still():
    """A full_feature 1080p still at quality 10 through `auto` and again
    through `pallas_win`, from one seed, with no tune record: each
    backend's launches, histogram and stats as production runs it, and
    again through the Python chunk loop with its flush wrapped, for each
    flush's records (the C loop flushes from C, unseen)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from cuburn_tpu_torch.profile import get_profile
    out = {}
    for asked in ("auto", "pallas_win"):
        r = trender.Renderer(full_feature(),
                             get_profile("1080p", quality=10,
                                         hist_backend=asked))
        hist, stats, launches, looped = _still_launches(r, 7)
        real, seen = tit.PACKED_FLUSHES[r.backend], []

        def keep(hist, recs, palette_hi, n_bins, bits, weight=None):
            seen.append((recs.clone(), palette_hi.clone(), bits))
            return real(hist, recs, palette_hi, n_bins, bits, weight)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(tit.PACKED_FLUSHES, r.backend, keep)
            mp.setattr(tit, "takes_c_loop", lambda backend, device: False)
            py_hist, py_stats = r.accumulate(0.0, seed=7)
        out[asked] = dict(renderer=r, records=seen, launches=launches,
                          looped=looped, hist=hist, stats=stats,
                          python_hist=py_hist, python_stats=py_stats)
    return out


def test_default_still_flushes_unsorted(cuda, default_still):
    """A 1080p still through `auto` resolves to `atomic`: no sort pass,
    one packed_flush a chunk and no other flush, every chunk queued by
    the C loop, on the very records (colour bits, chaos-kernel output)
    that `pallas_win` flushes; the density equals `pallas_win`'s in
    every bin."""
    a, w = default_still["auto"], default_still["pallas_win"]
    assert a["renderer"].backend == "atomic"
    assert thist.histogram_tiled(a["renderer"].cam.n_bins, cuda)
    chunks = a["launches"]["chaos_iterate"]
    assert chunks == len(a["records"]) == a["looped"] > 1
    assert a["launches"] == {"win_flush": 0, "packed_flush": chunks,
                             "merged_flush": 0, "win_flush_rgb16": 0,
                             "bitonic_sort": 0, "chaos_iterate": chunks}
    assert w["launches"]["win_flush"] == chunks
    assert w["launches"]["bitonic_sort"] > 0
    assert w["looped"] == 0
    assert len(w["records"]) == chunks
    for (ra, pa, ba), (rw, pw, bw) in zip(a["records"], w["records"]):
        assert ba == bw == 8
        assert torch.equal(ra, rw) and torch.equal(pa, pw)
    assert a["stats"].plotted_samples == w["stats"].plotted_samples > 0
    assert torch.equal(a["hist"][:, 3], w["hist"][:, 3])


def test_default_still_c_loop_matches_the_python_loop(cuda, default_still):
    """The 1080p still's C loop (hundreds of chunks, their counts folded
    by plotted_fold) against the Python loop on the same seed: plotted
    bit-equal, density equal in every bin, the histogram's mass the
    plotted count."""
    a = default_still["auto"]
    assert a["stats"].plotted_samples == a["python_stats"].plotted_samples
    assert torch.equal(a["hist"][:, 3], a["python_hist"][:, 3])
    mass = float(a["hist"][:-1, 3].double().sum())
    assert abs(mass - a["stats"].plotted_samples) <= 1e-4 * mass


def test_atomic_matches_pallas_win_on_a_real_flush(cuda, default_still):
    """The second flush of the 1080p render (the first past the fuse
    steps) into zeroed histograms through `atomic` and `pallas_win`:
    density bit for bit, rgb within 1e-5 of the bin's density plus the
    float32 rounding of summing the bin's records one by one (density x
    2^-24 of the sum), since the atomics add in no fixed order."""
    r = default_still["auto"]["renderer"]
    recs, pal, bits = default_still["auto"]["records"][1]
    out = {}
    for backend in ("atomic", "pallas_win"):
        hist = thist.alloc(r.cam.n_bins, cuda)
        tit.PACKED_FLUSHES[backend](hist, recs.clone(), pal, r.cam.n_bins,
                                    bits)
        out[backend] = hist
    a, w = out["atomic"], out["pallas_win"]
    assert float(w[:-1, 3].sum()) > 0.9 * recs.numel()
    assert torch.equal(a[:, 3], w[:, 3])
    err = (a[:, :3] - w[:, :3]).abs()
    dens = w[:, 3:].clamp(min=1.0)
    assert bool((err <= 1e-5 * dens + dens * 2.0 ** -24 * w[:, :3].abs())
                .all())


@pytest.mark.parametrize("genome", [sierpinski, full_feature])
@pytest.mark.parametrize("backend", ["pallas_win", "pallas",
                                     "pallas_merged", "pallas_rgb16"])
def test_render_matches_cpu_by_distribution(cuda, genome, backend):
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         hist_backend=backend, de_enabled=False)

    def density(device, seed):
        h, _ = trender.Renderer(genome(), prof, device=device) \
            .accumulate(0.0, seed=seed)
        d = h[:-1, 3].double().cpu()
        return d / d.sum()
    a, b, g = density("cpu", 3), density("cpu", 4), density(cuda, 3)
    floor = 0.5 * float((a - b).abs().sum())
    assert 0.5 * float((g - a).abs().sum()) < floor


# -- animation: weighted flushes, temporal samples, the frame loops --------

# the outer weights of a 4-sample gaussian temporal filter
TEMPORAL_WEIGHTS = (0.011, 0.325)


def _nonzero_start(seed):
    rs = np.random.RandomState(seed)
    start = rs.rand(N_BINS + 1, 4).astype(np.float32) * 50.0
    start[:, 3] = rs.randint(0, 1000, N_BINS + 1)
    return start


@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("backend", sorted(FLUSHES))
@pytest.mark.parametrize("weight", TEMPORAL_WEIGHTS)
def test_weighted_flush_from_nonzero_histogram(cuda, backend, case, weight):
    """A temporal sample's flush: weight well under 1 into a histogram
    that earlier samples filled.  Every channel of the real bins within
    1e-5 of the bin's density, against the float64 sums and against the
    plain version.  Where one bin takes a run of thousands of equal
    records, the plain version adds them one by one in float32 and
    every add rounds the same way: it is held to the float64 sums
    within that sum's worst case, half an ulp a record, there."""
    kernel, plain, name = FLUSHES[backend]
    rec = scatter_records(case, N_BINS)
    pal = np.random.RandomState(21).rand(256, 3).astype(np.float32)
    start = _nonzero_start(22)
    before = flush.LAUNCHES[name]
    got = kernel(torch.as_tensor(start, device=cuda),
                 torch.as_tensor(rec, device=cuda),
                 torch.as_tensor(pal, device=cuda), N_BINS, 8,
                 weight=weight).cpu().numpy()
    assert flush.LAUNCHES[name] == before + 1
    ref = plain(torch.as_tensor(start.copy()), torch.as_tensor(rec),
                torch.as_tensor(pal), N_BINS, 8, weight=weight).numpy()
    exact = start.astype(np.float64)
    pal4 = np.concatenate([pal, np.ones((256, 1), np.float32)], axis=1)
    np.add.at(exact, np.minimum(rec >> 8, N_BINS),
              np.float64(np.float32(weight)) * pal4[rec & 255])
    bound = 1e-5 * np.maximum(exact[:N_BINS, 3:4], 1.0)
    assert (np.abs(got[:N_BINS] - exact[:N_BINS]) <= bound).all()
    long_run = case in ("run_across_three_tiles", "all_equal")
    sequential = rec.size * 2.0 ** -24 * np.abs(exact[:N_BINS]) * long_run
    assert (np.abs(ref[:N_BINS] - exact[:N_BINS])
            <= bound + sequential).all()
    if not long_run:
        assert (np.abs(got[:N_BINS] - ref[:N_BINS]) <= bound).all()
    assert np.abs(ref - start).sum() > 0


@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("weight", TEMPORAL_WEIGHTS)
def test_weighted_rgb16_flush_from_nonzero_histogram(cuda, case, weight):
    """The split flush at a temporal sample's weight: density within
    1e-5 of itself, rgb within one bf16 ulp of the plain version."""
    rec = scatter_records(case, N_BINS)
    pal = np.random.RandomState(23).rand(256, 3).astype(np.float32)
    dg, rg = flush.accumulate_windowed_rgb16(
        _split_start(6, cuda), torch.as_tensor(rec, device=cuda),
        torch.as_tensor(pal, device=cuda), N_BINS, 8, weight=weight)
    dr, rr = flush.accumulate_windowed_rgb16_reference(
        _split_start(6, "cpu"), torch.as_tensor(rec), torch.as_tensor(pal),
        N_BINS, 8, weight=weight)
    dg, rg = dg.cpu()[:N_BINS], rg.cpu()[:N_BINS].float()
    dr, rr = dr[:N_BINS], rr[:N_BINS].float()
    assert bool(((dg - dr).abs() <= 1e-5 * dr.clamp(min=1.0)).all())
    ulp = torch.finfo(torch.bfloat16).eps * rr.abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert bool(((rg - rr).abs() <= ulp).all())


def _spark(ftype="gaussian"):
    g = animated_spark()
    g.temporal_filter_type = ftype
    return g


@pytest.mark.parametrize("backend", ["pallas_win", "pallas",
                                     "pallas_merged", "pallas_rgb16"])
def test_temporal_accumulate_matches_cpu_by_distribution(cuda, backend):
    """A T = 3 gaussian frame: the interpolator and the weighted flushes
    on the card against the CPU path from the same seed."""
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         hist_backend=backend, de_enabled=False,
                         temporal_samples=3, fps=4.0)
    name = {**{b: n for b, (_k, _p, n) in FLUSHES.items()},
            "pallas_rgb16": "win_flush_rgb16"}[backend]

    def run(device, seed):
        r = trender.Renderer(_spark(), prof, device=device)
        return (*r.accumulate(0.5, seed=seed), r)

    def density(h):
        d = h[:-1, 3].double().cpu()
        return d / d.sum()
    flush.LAUNCHES[name] = 0
    hg, sg, r = run(cuda, 3)
    per_chunk = r._batch_for(prof.total_iters) * r.profile.iters_per_chunk
    flushes = sg.total_iters // per_chunk
    assert flushes % 3 == 0
    assert flush.LAUNCHES[name] == flushes * (2 if name.endswith("16") else 1)
    (ha, sa, _), (hb, _, _) = run("cpu", 3), run("cpu", 4)
    assert sg.total_iters == sa.total_iters
    a, b, g = density(ha), density(hb), density(hg)
    floor = 0.5 * float((a - b).abs().sum())
    assert 0.5 * float((g - a).abs().sum()) < floor
    # the weighted mass, not the plotted count
    mass = float(hg[:-1, 3].double().sum())
    assert mass < 0.75 * sg.plotted_samples
    assert mass == pytest.approx(float(ha[:-1, 3].double().sum()), rel=0.02)


def test_overlapped_frames_equal_serial_on_the_card(cuda):
    """Through the split flush, whose sums have a fixed order, the
    frames of `frames_overlapped` are those of `frames` bit for bit."""
    prof = RenderProfile(width=128, height=96, quality=30, batch=8192,
                         hist_backend="pallas_rgb16", temporal_samples=2,
                         fps=4.0, duration=0.75)
    r = trender.Renderer(_spark(), prof)
    serial = list(r.frames(seed=2))
    over = list(r.frames_overlapped(seed=2))
    assert len(serial) == len(over) == 3
    for (a, sa), (b, sb) in zip(serial, over):
        np.testing.assert_array_equal(a, b)
        assert sa.plotted_samples == sb.plotted_samples > 0
    assert not np.array_equal(serial[0][0], serial[2][0])


def test_overlapped_frames_within_one_lsb_through_win_flush(cuda):
    """win_flush adds a tile's edge runs with float atomics, so at
    fractional weights two runs may differ in a sum's last bit: frames
    within one u8 step."""
    prof = RenderProfile(width=128, height=96, quality=30, batch=8192,
                         hist_backend="pallas_win", temporal_samples=2,
                         fps=4.0, duration=0.5, transparent=True)
    r = trender.Renderer(_spark(), prof)
    for (a, _), (b, _) in zip(r.frames(seed=2), r.frames_overlapped(seed=2)):
        assert a.shape == b.shape == (96, 128, 4)
        assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1


def test_overlapped_frames_wait_once_a_frame_on_the_card(cuda):
    """After the first, an overlapped frame waits for the stream once,
    for its readback's event: its uploads are queued and the
    interpolator reads nothing back.  Its images are those of frames()
    bit for bit through the split flush, and it queues the serial
    frame's uploads, where the serial frame waits three times."""
    prof = RenderProfile(width=128, height=96, quality=30, batch=8192,
                         hist_backend="pallas_rgb16", temporal_samples=2,
                         fps=4.0, duration=0.75)
    r = trender.Renderer(_spark(), prof)
    serial = list(r.frames(seed=2))
    over = list(r.frames_overlapped(seed=2))
    assert len(serial) == len(over) == 3
    for (a, sa), (b, sb) in zip(serial, over):
        np.testing.assert_array_equal(a, b)
    assert [s.syncs for _img, s in over[1:]] == [1, 1]
    assert [s.syncs for _img, s in serial[1:]] == [3, 3]
    for (_a, sa), (_b, sb) in zip(serial[1:], over[1:]):
        assert sb.uploads == sa.uploads > 0


# -- uploads: staged in pinned memory, queued without a wait ---------------

# ~0.5 s of the card's clock: long enough to outlast the host's side
LONG_SLEEP_CYCLES = 1 << 30


def test_upload_returns_before_the_kernel_ahead_of_it_ends(cuda):
    """An upload queued behind a long kernel returns while the kernel
    still runs (an event recorded behind the kernel has not passed),
    counts one upload and no wait, leaves the caller free to change its
    array, and has the array's values once the stream has run."""
    want = np.arange(1 << 16, dtype=np.float32)
    a = want.copy()
    trace.upload(a, cuda)                 # the pinned block, allocated
    torch.cuda.synchronize()
    torch.cuda._sleep(LONG_SLEEP_CYCLES)
    behind = torch.cuda.Event()
    behind.record()
    before = trace.counters()
    got = trace.upload(a, cuda)
    assert not behind.query()
    counted = trace.since(before)
    assert (counted["uploads"], counted["syncs"]) == (1, 0)
    a[:] = -1.0
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_uploads_reusing_the_pinned_cache_keep_their_values(cuda):
    """200 uploads of different arrays, all from one host buffer and
    queued behind a long kernel, so that a pinned block handed out
    again before its copy ran would show: each keeps its own values,
    dtype and shape."""
    sizes = (1, 31, 4096, 1 << 15)
    buf = np.empty(1 << 15, np.float64)
    torch.cuda.synchronize()
    torch.cuda._sleep(LONG_SLEEP_CYCLES // 4)
    got, want = [], []
    for i in range(200):
        n = sizes[i % len(sizes)]
        buf[:n] = np.arange(n) + 7.0 * i
        dtype = torch.float32 if i % 2 else torch.int64
        got.append(trace.upload(buf[:n], cuda, dtype))
        want.append(torch.as_tensor(buf[:n].copy(), dtype=dtype))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        assert torch.equal(g.cpu(), w)


# -- frame partitions: stripes through the kernels, unpacked records -------

@pytest.mark.parametrize("backend,name", [
    ("pallas_win", "win_flush"), ("pallas", "packed_flush"),
    ("pallas_merged", "merged_flush"),
    ("pallas_rgb16", "win_flush_rgb16"), ("atomic", "packed_flush")])
def test_striped_render_equals_whole_frame(cuda, backend, name):
    """Every stripe's flushes launch the kernel with the stripe's own
    bin count as the junk bin; density (integer counts at weight 1.0) is
    equal in every bin, rgb within 1e-5 of the bin's density, for the
    split flush within one bf16 ulp a flush (a run summed across a tile
    edge in one layout may round the other way)."""
    prof = RenderProfile(width=128, height=128, quality=20, batch=8192,
                         hist_backend=backend)
    r = trender.Renderer(full_feature(), prof)
    whole, sw = r.accumulate(0.0, seed=1)
    flush.LAUNCHES[name] = 0
    tiled_sort.LAUNCHES["bitonic_sort"] = 0
    striped, ss = r.accumulate_striped(0.0, seed=1, n_stripes=4)
    per_chunk = r._batch_for(prof.total_iters) * r.profile.iters_per_chunk
    flushes = ss.total_iters // per_chunk
    assert ss.total_iters == 4 * sw.total_iters and flushes % 4 == 0
    assert flush.LAUNCHES[name] == flushes * (2 if name.endswith("16") else 1)
    passes = len(tiled_sort.bitonic_schedule(
        1 << (per_chunk - 1).bit_length()))
    assert tiled_sort.LAUNCHES["bitonic_sort"] == \
        (0 if backend in UNSORTED else flushes * passes)
    assert torch.equal(whole[:-1, 3], striped[:-1, 3])
    assert float(striped[-1].abs().sum()) == 0.0
    err = (whole[:-1, :3] - striped[:-1, :3]).abs()
    tol = (flushes // 4 * 2.0 ** -7 * whole[:-1, :3].abs()
           if backend == "pallas_rgb16"
           else 1e-5 * whole[:-1, 3:].clamp(min=1.0))
    assert bool((err <= tol).all())
    assert ss.plotted_samples == sw.plotted_samples > 0


def test_unpacked_frame_scatters_on_the_card(cuda, monkeypatch):
    """A frame forced unpacked takes scatter (index_add_ of full
    records) on the card; striped, its density equals the whole
    frame's."""
    monkeypatch.setattr(trender, "color_bits_for", lambda n_bins: 0)
    prof = RenderProfile(width=128, height=128, quality=20, batch=8192)
    r = trender.Renderer(full_feature(), prof)
    assert r.packed is False and r.backend == "scatter"
    whole, sw = r.accumulate(0.0, seed=1)
    striped, ss = r.accumulate_striped(0.0, seed=1, n_stripes=2)
    assert torch.equal(whole[:-1, 3], striped[:-1, 3])
    assert float(whole[:-1, 3].sum()) == sw.plotted_samples == \
        ss.plotted_samples > 0


def _sharded_world_1(rank, device, backend):
    """One rank over NCCL: the sharded histogram and the one-device one
    from the same seed, on the card."""
    from cuburn_tpu_torch.parallel.shard import ShardedRenderer
    prof = RenderProfile(width=128, height=96, quality=40, batch=4096,
                         iters_per_chunk=16, fuse=16, hist_backend=backend)
    got, sg = ShardedRenderer(full_feature(), prof, device).accumulate(
        0.0, seed=3)
    want, sw = trender.Renderer(full_feature(), prof, device).accumulate(
        0.0, seed=3)
    return (got.cpu(), sg.plotted_samples, want.cpu(), sw.plotted_samples)


@pytest.mark.parametrize("backend", ["pallas_win", "pallas_rgb16"])
def test_sharded_world_1_over_nccl(cuda, backend):
    """ShardedRenderer in one rank over NCCL on the card: density equal
    to the one-device Renderer's in every bin, plotted counts equal."""
    from cuburn_tpu_torch.parallel import launch
    ((got, n_got, want, n_want),) = launch.spawn(
        _sharded_world_1, ["cuda:0"], "nccl", backend, timeout_s=300)
    assert torch.equal(got[:-1, 3], want[:-1, 3])
    assert n_got == n_want > 0


def test_tune_record_for_this_card_steers_auto(cuda, tmp_path, monkeypatch):
    """A record gated to this card picks `auto`'s backend (its tiled key
    for the 1080p-ss2 histogram, past L2) and the flush size; the
    repo's TPU record is skipped."""
    import json
    import os

    from cuburn_tpu_torch.profile import get_profile
    monkeypatch.setattr(tretune, "_TUNE_ANNOUNCED", set())
    monkeypatch.delenv("CUBURN_ITERS_PER_CHUNK", raising=False)
    rec = {"device": torch.cuda.get_device_name(cuda),
           "hist_backend": "scatter_sorted",
           "hist_backend_tiled": "pallas_rgb16",
           "flush_records": 1 << 21, "tiled_flush_records": 1 << 23}
    path = tmp_path / "tune.json"
    path.write_text(json.dumps(rec))
    monkeypatch.setenv("CUBURN_TUNE_FILE", str(path))
    small = RenderProfile(width=32, height=32, quality=5, batch=1024)
    r = trender.Renderer(sierpinski(), small)
    assert r.backend == "scatter_sorted"
    assert r.profile.iters_per_chunk == (1 << 21) // 1024
    big = get_profile("1080p")
    r = trender.Renderer(full_feature(), big)
    assert thist.histogram_tiled(r.cam.n_bins, r.device)
    assert r.backend == "pallas_rgb16"
    assert r.profile.iters_per_chunk == (1 << 23) // big.batch
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("CUBURN_TUNE_FILE",
                       os.path.join(repo, "cuburn_tune.json"))
    r = trender.Renderer(full_feature(), big)
    assert r.backend == "atomic"
    assert r.profile.iters_per_chunk == tretune.DEFAULT_ITERS_PER_CHUNK


def test_native_encoder_in_use(cuda):
    from cuburn_tpu_torch import output
    assert output.encoder() == "native"


# the __global__ functions behind each launch counter
TRACE_NAMES = {"win_flush": ("win_flush_kernel",),
               "bitonic_sort": ("first_pass_kernel", "later_pass_kernel",
                                "global_pass_kernel"),
               "chaos_iterate": ("chaos_iterate_kernel",)}


def test_trace_dir_holds_the_hand_kernels(cuda, tmp_path):
    """A --trace-dir render's trace holds each hand kernel's launches as
    kernel events, as many as the launch counters count."""
    import json

    from cuburn_tpu_torch import main as tmain
    flush.LAUNCHES["win_flush"] = 0
    tiled_sort.LAUNCHES["bitonic_sort"] = 0
    chaos.LAUNCHES["chaos_iterate"] = 0
    assert tmain.main(["gallery:full_feature", "--width", "256", "--height",
                       "256", "--quality", "20", "--hist-backend",
                       "pallas_win", "-o",
                       str(tmp_path / "t.png"), "--trace-dir",
                       str(tmp_path / "tr")]) == 0
    counts = {"win_flush": flush.LAUNCHES["win_flush"],
              "bitonic_sort": tiled_sort.LAUNCHES["bitonic_sort"],
              "chaos_iterate": chaos.LAUNCHES["chaos_iterate"]}
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for name, fns in TRACE_NAMES.items():
        assert counts[name] > 0
        assert sum(any(fn in k for fn in fns) for k in kernels) == \
            counts[name]


# -- the chaos game (csrc/chaos_iterate.cu) ----------------------------------

_AFFINE = (1.1, 0.2, 0.3, -0.2, 0.9, 0.15)


@pytest.mark.parametrize("name", sorted(tvar.VARIATION_IMPLS))
def test_chaos_variation_matches_plain_on_the_card(cuda, name):
    """One variation alone at 2^16 points, default and bumped knobs,
    weights 0.7, -0.45 and 0: RNG words exact, finite where the plain
    version is, (dx, dy) within rtol 1e-4, atol 1e-5 in >= 99.9% of the
    points (the rest sit where a ulp of the libm moves the formula)."""
    n = 1 << 16
    rs = np.random.RandomState(11)
    tx = torch.as_tensor(rs.uniform(-2, 2, n).astype(np.float32),
                         device=cuda)
    ty = torch.as_tensor(rs.uniform(-2, 2, n).astype(np.float32),
                         device=cuda)
    state = rs.randint(0, 2 ** 32, (n, 4), dtype=np.uint64).astype(np.int64)
    lib = chaos.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    defaults = dict(VARIATION_PARAMS[name])
    bumped = {a: d * 1.3 + 0.4 for a, d in defaults.items()}
    aff = torch.tensor(_AFFINE, device=cuda)
    for params in (defaults, bumped):
        vals = [params[a] for a, _d in VARIATION_PARAMS[name]] or [0.0]
        for w in (0.7, -0.45, 0.0):
            wt = torch.full((n,), w, device=cuda)
            rng = torch.as_tensor(state, device=cuda)
            dx, dy = torch.empty_like(tx), torch.empty_like(tx)
            args = chaos.variation_args(
                lib, name, tx, ty, wt, torch.tensor(vals, device=cuda),
                aff, rng, dx, dy)
            build.launch({"v": 0}, "v", chaos.LIBRARY, "chaos_variation",
                         (ctypes.c_void_p,), stream, ctypes.addressof(args))
            plain = trng.RngStream(torch.as_tensor(state, device=cuda))
            ctx = tvar.make_ctx(tx, ty, tuple(aff[i].expand(n)
                                              for i in range(6)), plain)
            px, py = tvar.VARIATION_IMPLS[name](
                ctx, wt, lambda a: torch.full((n,), params[a], device=cuda))
            assert torch.equal(rng, plain.state), (name, params, w)
            for k, p in ((dx, px), (dy, py)):
                assert torch.equal(torch.isfinite(k), torch.isfinite(p))
                fin = torch.isfinite(p)
                close = torch.isclose(k[fin], p[fin], rtol=1e-4, atol=1e-5)
                assert float(close.double().mean()) >= 0.999, (name, w)


# the registry in 8 keys of 12-13 variations (every 8th name in sorted
# order): each variation runs inside a specialised chaos_iterate, here
# on the card and in test_torch_chaos.py through the host build
VARIATION_GROUPS = tuple(tuple(sorted(tvar.VARIATION_IMPLS))[i::8]
                         for i in range(8))


def variation_group_genome(i):
    """A genome whose key's union is VARIATION_GROUPS[i]: two xforms with
    every variation of the group at seeded weights, the first at default
    knobs and the second at bumped ones, and a final xform with the
    group's first three."""
    from cuburn_tpu_torch.genome.specs import Genome, XForm
    from cuburn_tpu_torch.genome.variations import PARAM_DEFAULTS
    group = VARIATION_GROUPS[i]
    rs = np.random.RandomState(100 + i)
    attrs = [a for v in group for a, _d in VARIATION_PARAMS[v]]
    bumped = {a: PARAM_DEFAULTS[a] * 1.3 + 0.4 for a in attrs}
    xforms = [XForm(weight=wt, color=c,
                    affine=(0.55, 0.1, 0.2 * sgn, -0.1, 0.5, -0.15 * sgn),
                    vars={v: float(w) for v, w in zip(
                        group, rs.uniform(0.02, 0.25, len(group)))},
                    params=params)
              for wt, c, sgn, params in ((0.6, 0.1, 1.0, {}),
                                         (0.4, 0.9, -1.0, bumped))]
    final = XForm(color=0.5, vars={v: 0.5 for v in group[:3]})
    return Genome(xforms=xforms, final_xform=final, name=f"group{i}",
                  center=(0.0, 0.0), scale=16.0, size=(64, 48))


def variation_group_plan(i, device, batch):
    """(plan, state) of a 64x48 ss-2 chunk of variation_group_genome(i)
    from seeded trajectories past the fuse."""
    g = variation_group_genome(i)
    key = g.structure_key()
    cam = tcam.CameraSpec(64, 48, 2, gutter=3)
    p = tparams.params_from_genome(g.eval_at(0.0), device)
    st = tit.init_state(torch.Generator().manual_seed(5 + i), batch, device)
    st = dataclasses.replace(st, age=st.age + 40)     # past the fuse
    cbits, tot_bits = tit.record_bits(key, cam, "pallas_win", 0)
    plan = chaos.plan(key, cam, p, tit.xform_cdf_rows(p),
                      p.ppu * float(64 / g.size[0]), 20, cbits, tot_bits)
    return plan, st


def _chaos_opacity():
    g = full_feature()
    g.xforms[1].opacity = Spline(0.5)
    g.xforms[2].opacity = Spline(0.25)
    return g


def _chaos_no_dof():
    g = tilted()
    g.cam_dof = Spline(0.0)
    return g


# test_torch_chaos.py's chunk cases with the port's genomes: name ->
# (genome, camera arguments, rotate degrees, opacity-extended)
CHAOS_CASES = {
    "full_feature": (full_feature, {}, 0.0, False),
    "cam_mode_1": (_chaos_no_dof, {}, 0.0, False),
    "cam_mode_2": (tilted, {}, 0.0, False),
    "op_bits": (_chaos_opacity, {}, 0.0, True),
    "stripe": (full_feature, dict(tile_row0=40, full_acc_height=102,
                                  tile_acc_height=30), 0.0, False),
    "rotated": (full_feature, {}, 33.0, False),
}


def _chaos_setup(case, device, batch=1 << 14):
    genome, cam_extra, rotate, opacity = CHAOS_CASES[case]
    g = genome()
    key = g.structure_key()
    cam = tcam.CameraSpec(64, 48, 2, gutter=3, no_rotation=rotate == 0.0,
                          **cam_extra)
    p = tparams.params_from_genome(g.eval_at(0.0), device)
    p = dataclasses.replace(p, rotate=torch.tensor(rotate, device=device))
    st = tit.init_state(torch.Generator().manual_seed(3), batch, device)
    st = dataclasses.replace(st, age=st.age + 40)     # past the fuse
    op_bits = tit.opacity_bits_for(cam.layout_bins, key.n_xforms)[0] \
        if opacity else 0
    cbits, tot_bits = tit.record_bits(key, cam, "pallas_win", op_bits)
    plan = chaos.plan(key, cam, p, tit.xform_cdf_rows(p),
                      p.ppu * float(64 / g.size[0]), 20, cbits, tot_bits,
                      op_bits)
    return plan, st


@pytest.fixture(scope="module")
def chaos_keys_built():
    """The chaos library of every structure key these tests render or
    launch, built before the first of them, one nvcc each, all started
    together (as chip_smoke.py's phase 2 does)."""
    import concurrent.futures
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    genomes = [full_feature(), sierpinski(), _spark(), *(c[0]() for c in
                                           CHAOS_CASES.values()),
               *(variation_group_genome(i)
                 for i in range(len(VARIATION_GROUPS)))]
    keys = {g.structure_key() for g in genomes}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(lambda k: build.build(
            chaos.LIBRARY, chaos.key_defines(k)), keys))
    return dict(zip(keys, paths))


@pytest.mark.parametrize("case", sorted(CHAOS_CASES))
def test_chaos_chunk_matches_plain_on_the_card(cuda, chaos_keys_built,
                                               case):
    """8 steps one launch at a time against the eager loop: RNG words
    and selected xforms exact at every step; from the same state, step
    1's records in >= 99.9% of lanes and positions within rtol 1e-4,
    atol 1e-5; one 8-step launch equal to the eight."""
    plan, st = _chaos_setup(case, cuda)
    kern, plain, steps = st, st, []
    for k in range(8):
        before = chaos.LAUNCHES["chaos_iterate"]
        rk = torch.empty((1, st.x.shape[0]), dtype=torch.int64, device=cuda)
        kern = tit.iterate_records(plan, kern, rk)
        assert chaos.LAUNCHES["chaos_iterate"] == before + 1
        rp = torch.empty_like(rk)
        nxt = tit.iterate_records_reference(plan, plain, rp)
        assert torch.equal(kern.rng, nxt.rng)
        assert torch.equal(kern.last_xf, nxt.last_xf)
        if k == 0:
            assert float((rk == rp).double().mean()) >= 0.999
            for a, b in ((kern.x, nxt.x), (kern.y, nxt.y)):
                close = torch.isclose(a, b, rtol=1e-4, atol=1e-5)
                assert float(close.double().mean()) >= 0.999
            assert int(((rk >> plan.tot_bits) != plan.cam.junk_bin).sum()) \
                > st.x.shape[0] // 8
        steps.append(rk[0])
        plain = nxt
    whole = torch.empty((8, st.x.shape[0]), dtype=torch.int64, device=cuda)
    ws = tit.iterate_records(plan, st, whole)
    assert torch.equal(whole, torch.stack(steps))
    for f in ("x", "y", "color", "last_xf", "age", "rng"):
        assert torch.equal(getattr(ws, f), getattr(kern, f))


@pytest.mark.parametrize("group", range(len(VARIATION_GROUPS)))
def test_chaos_variation_group_matches_plain_on_the_card(cuda,
                                                        chaos_keys_built,
                                                        group):
    """Every variation inside a key's union (12-13 a key), 32 steps in
    one launch of the key's specialised kernel against the eager loop:
    bit-exact, as on the main path (RNG words, selected xforms and
    positions after 32 steps, every record, step 1's positions)."""
    plan, st = variation_group_plan(group, cuda, 1 << 14)
    before = chaos.LAUNCHES["chaos_iterate"]
    rk = torch.empty((32, st.x.shape[0]), dtype=torch.int64, device=cuda)
    kern = tit.iterate_records(plan, st, rk)
    assert chaos.LAUNCHES["chaos_iterate"] == before + 1
    rp = torch.empty_like(rk)
    plain = tit.iterate_records_reference(plan, st, rp)
    for f in ("rng", "last_xf", "age", "x", "y", "color"):
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert torch.equal(rk, rp)
    one = torch.empty((1, st.x.shape[0]), dtype=torch.int64, device=cuda)
    k1 = tit.iterate_records(plan, st, one)
    p1 = tit.iterate_records_reference(plan, st, torch.empty_like(one))
    assert torch.equal(k1.x, p1.x) and torch.equal(k1.y, p1.y)
    assert int(((rk[0] >> plan.tot_bits) != plan.cam.junk_bin).sum()) \
        > st.x.shape[0] // 8


def test_chaos_unpacked_chunk_matches_plain_on_the_card(cuda):
    plan, st = _chaos_setup("full_feature", cuda)
    plan = dataclasses.replace(plan, cbits=0, tot_bits=0, op_bits=0)
    before = chaos.LAUNCHES["chaos_iterate"]
    ks, ka, kc, ko = tit.iterate_full(plan, st, 8)
    assert chaos.LAUNCHES["chaos_iterate"] == before + 1
    ps, pa, pc, po = tit.iterate_full_reference(plan, st, 8)
    assert torch.equal(ks.rng, ps.rng) and torch.equal(ks.last_xf,
                                                       ps.last_xf)
    assert torch.equal(ko, po)
    assert float((ka[0] == pa[0]).double().mean()) >= 0.999
    assert float(torch.isclose(kc[0], pc[0], rtol=1e-4, atol=1e-5)
                 .double().mean()) >= 0.999


def _chunks(r, stats):
    per_chunk = r._batch_for(r.profile.total_iters) \
        * r.profile.iters_per_chunk
    return stats.total_iters // per_chunk


@pytest.mark.parametrize("path", ["still", "blurred", "unpacked",
                                  "striped"])
def test_every_render_path_launches_the_chaos_game(cuda, monkeypatch, path):
    """One chaos_iterate launch a chunk: a still, a motion-blurred frame
    (T = 3), an unpacked frame and a striped one."""
    if path == "unpacked":
        monkeypatch.setattr(trender, "color_bits_for", lambda n_bins: 0)
    blur = dict(temporal_samples=3, fps=4.0) if path == "blurred" else {}
    prof = RenderProfile(width=128, height=128, quality=20, batch=8192,
                         **blur)
    g = _spark() if path == "blurred" else full_feature()
    r = trender.Renderer(g, prof)
    # the key's library is loaded before any iterate_s
    assert (chaos.LIBRARY, chaos.key_defines(r.key)) in build._LOADED
    chaos.LAUNCHES["chaos_iterate"] = 0
    if path == "striped":
        # stats count every stripe's iterations: each replays the chunks
        _h, stats = r.accumulate_striped(0.0, seed=1, n_stripes=2)
        want = _chunks(r, stats)
    else:
        _h, stats = r.accumulate(0.5, seed=1)
        want = _chunks(r, stats)
    assert chaos.LAUNCHES["chaos_iterate"] == want > 0
    assert stats.plotted_samples > 0


def test_chaos_raises_when_build_fails(cuda, monkeypatch):
    """No fallback: a chaos kernel that cannot be built for the plan's
    key makes the CUDA wrappers and the Renderer raise instead of running
    the eager loop or another library."""
    plan, st = _chaos_setup("full_feature", cuda, batch=1024)

    def broken(name, defines=()):
        assert defines == chaos.key_defines(plan.key)
        raise RuntimeError(f"nvcc failed building {name}.cu")
    monkeypatch.setattr(build, "load", broken)
    before = chaos.LAUNCHES["chaos_iterate"]
    rec = torch.empty((2, 1024), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tit.iterate_records(plan, st, rec)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tit.iterate_full(plan, st, 2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        trender.Renderer(full_feature(), RenderProfile(width=32, height=32))
    assert chaos.LAUNCHES["chaos_iterate"] == before


# -- the chunk loop in C (chaos_accumulate) -----------------------------------

def _launch_counts():
    return (chaos.LAUNCHES["chaos_iterate"], flush.LAUNCHES["packed_flush"],
            chaos.LAUNCHES["plotted_fold"], trace.COUNTS["looped_chunks"])


def _accumulate_both_ways(cuda, n_chunks, weight, monkeypatch):
    """iterate_accumulate through `atomic` from one plan and state, once
    through the C loop and once through the Python loop: {way: (state,
    hist, plotted, launches counted)} and the input state's copy."""
    plan, st = _chaos_setup("full_feature", cuda)
    keep = {f: getattr(st, f).clone() for f in chaos.STATE_FIELDS}
    out = {}
    for way in ("c", "python"):
        if way == "python":
            monkeypatch.setattr(tit, "takes_c_loop", lambda f, d: False)
        hist = thist.alloc(plan.cam.n_bins, cuda)
        before = _launch_counts()
        new, hist, plotted = tit.iterate_accumulate(
            plan.key, plan.cam, "atomic", plan.params, plan.cdf_rows, st,
            hist, plan.ppu, n_chunks, 8, plan.fuse, weight=weight)
        torch.cuda.synchronize()
        out[way] = (new, hist, plotted, tuple(
            a - b for a, b in zip(_launch_counts(), before)))
    return out, st, keep


@pytest.mark.parametrize("weight", [None, 0.325])
@pytest.mark.parametrize("n_chunks", [0, 1, 2, 5])
def test_c_loop_matches_the_python_loop(cuda, chaos_keys_built, n_chunks,
                                        weight, monkeypatch):
    """The C loop against the Python loop on the same plan and state:
    the final state, the plotted float32 total and (at weight 1) the
    density bit-equal; rgb, and density at a temporal weight, within
    1e-5 of the bin's density plus float32 reassociation (the atomics
    add in no fixed order on either path); the same chaos_iterate and
    packed_flush launches, one plotted_fold where there is a chunk; the
    caller's state untouched; the chunks counted as looped."""
    out, st, keep = _accumulate_both_ways(cuda, n_chunks, weight,
                                          monkeypatch)
    (cs, ch, cp, cl), (ps, ph_, pp, pl) = out["c"], out["python"]
    for f in chaos.STATE_FIELDS:
        assert torch.equal(getattr(cs, f), getattr(ps, f)), f
        assert torch.equal(getattr(st, f), keep[f]), f
    assert cp.dtype == pp.dtype == torch.float32
    assert torch.equal(cp.view(torch.int32), pp.view(torch.int32))
    assert cl[:2] == pl[:2] == (n_chunks, n_chunks)
    assert cl[2:] == ((1, n_chunks) if n_chunks else (0, 0))
    assert pl[2:] == (0, 0)
    if weight is None:
        assert torch.equal(ch[:, 3], ph_[:, 3])
        assert float(ch[:-1, 3].sum()) == float(cp)
        assert n_chunks == 0 or float(cp) > 0
    dens = ph_[:, 3:].clamp(min=1.0)
    err = (ch - ph_).abs()
    assert bool((err <= 1e-5 * dens + dens * 2.0 ** -24 * ph_.abs()).all())


def _other_kernels(r, quality, cuda):
    """Renderer r's accumulate at `quality` under torch.profiler: (its
    chunks, the kernel events that are not the loop's hand kernels)."""
    from torch.profiler import ProfilerActivity, profile
    r.profile = dataclasses.replace(r.profile, quality=quality)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _h, stats = r.accumulate(0.0, seed=4)
        torch.cuda.synchronize()
    counted = trace.since(before)
    assert counted["looped_chunks"] == counted["chunks"] == stats.chunks
    hand = ("chaos_iterate_kernel", "packed_flush_kernel",
            "plotted_fold_kernel")
    kernels = [e.name for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    assert sum("packed_flush_kernel" in k for k in kernels) == stats.chunks
    return stats.chunks, sorted(k for k in kernels
                                if not any(h in k for h in hand))


def test_render_launches_no_torch_kernel_a_chunk(cuda):
    """A still through `auto` (`atomic`) queues every chunk from C: the
    torch kernels of its accumulate are the same at two qualities whose
    chunks differ, and every chunk counts as looped."""
    r = trender.Renderer(full_feature(), RenderProfile(
        width=128, height=128, quality=200, batch=8192, de_enabled=False))
    assert r.backend == "atomic"
    r.accumulate(0.0, seed=4)        # warm
    few, a = _other_kernels(r, 200, cuda)
    many, b = _other_kernels(r, 600, cuda)
    assert many > few > 1
    assert a == b


# -- the bf16 probe (csrc/bf16_probe.cu) ------------------------------------

def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("rows", [bf16probe.NB * bf16probe.BR, 320, 1000,
                                  50_001])
@pytest.mark.parametrize("variant", sorted(bf16probe.VARIANTS))
def test_bf16_roundtrip_kernel_matches_plain_version(cuda, variant, rows):
    """The probe's size, a multiple of the kernel's tile that is not one
    of BR (320), a ragged last tile (1000) and enough tiles that every
    persistent block walks its ring of stages more than once (50,001):
    bit-equal to the plain version and to the input, 10 times, one
    launch a call."""
    dtype = bf16probe.VARIANTS[variant][1]
    gen = torch.Generator().manual_seed(rows)
    x = torch.rand((3, rows, 128), generator=gen).to(dtype).to(cuda)
    want = bf16probe.roundtrip_reference(x, variant)
    assert _same_bits(want, x)
    for _ in range(10):
        before = bf16probe.LAUNCHES["bf16_roundtrip"]
        got = bf16probe.roundtrip(x, variant)
        torch.cuda.synchronize()
        assert bf16probe.LAUNCHES["bf16_roundtrip"] == before + 1
        assert _same_bits(got, want)


def _probe_schedule(seed, n_blocks):
    """(perm, rbg): the blocks in a shuffled order, some skipped, 1-4
    visits a block in one run; rbg shuffled and perm undoing it."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n_blocks)[:n_blocks - rng.randint(2)]
    steps = np.repeat(order, rng.randint(1, 5, order.size)).astype(np.int32)
    perm = rng.permutation(steps.size).astype(np.int32)
    rbg = np.empty_like(steps)
    rbg[perm] = steps
    return perm, rbg


def _skeleton_state(seed, rows, device):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.rand(1, rows, 128).astype(np.float32),
                         device=device),
            torch.tensor(rng.rand(3, rows, 128).astype(np.float32))
            .to(torch.bfloat16).to(device),
            torch.tensor(rng.rand(4, bf16probe.BR, 128).astype(np.float32),
                         device=device))


@pytest.mark.parametrize("schedule", ["probe", "shuffled_0", "shuffled_1",
                                      "shuffled_2", "one_block_9_visits"])
@pytest.mark.parametrize("n_blocks", [bf16probe.NB, 9])
def test_rgb16_skeleton_kernel_matches_plain_version(cuda, schedule,
                                                     n_blocks):
    """Bit-equal to the plain version from the same state, 5 times, one
    launch a call; blocks off the schedule keep their bits."""
    BR = bf16probe.BR
    if schedule == "probe":
        perm = np.arange(3 * n_blocks, dtype=np.int32)
        rbg = np.repeat(np.arange(n_blocks, dtype=np.int32), 3)
    elif schedule == "one_block_9_visits":
        perm = np.arange(9, dtype=np.int32)
        rbg = np.full(9, n_blocks - 1, np.int32)
    else:
        perm, rbg = _probe_schedule(int(schedule[-1]), n_blocks)
    dens0, rgb0, add = _skeleton_state(3, n_blocks * BR, cuda)
    dr, cr = dens0.clone(), rgb0.clone()
    bf16probe.skeleton_reference(dr, cr, add, perm, rbg)
    for _ in range(5):
        d, c = dens0.clone(), rgb0.clone()
        before = bf16probe.LAUNCHES["rgb16_skeleton"]
        got = bf16probe.skeleton(d, c, add, perm, rbg)
        torch.cuda.synchronize()
        assert got[0] is d and got[1] is c
        assert bf16probe.LAUNCHES["rgb16_skeleton"] == before + 1
        assert _same_bits(d, dr) and _same_bits(c, cr)
    for b in set(range(n_blocks)) - set(rbg[perm].tolist()):
        rows = slice(b * BR, (b + 1) * BR)
        assert _same_bits(d[:, rows], dens0[:, rows])
        assert _same_bits(c[:, rows], rgb0[:, rows])


@pytest.mark.parametrize("rbg", [[0, 0, 1, 0, 2, 3, 3, 1], [0, 1, 0]])
def test_rgb16_skeleton_refuses_a_revisit_on_the_card(cuda, rbg):
    """The schedule is checked on the host before any upload or launch."""
    dens, rgb, add = _skeleton_state(4, bf16probe.NB * bf16probe.BR, cuda)
    d0 = dens.clone()
    before = dict(bf16probe.LAUNCHES)
    with pytest.raises(ValueError, match="one contiguous run"):
        bf16probe.skeleton(dens, rgb, add, np.arange(len(rbg), dtype=np.int32),
                           np.asarray(rbg, np.int32))
    torch.cuda.synchronize()
    assert bf16probe.LAUNCHES == before and torch.equal(dens, d0)


def test_bf16_probe_never_takes_the_plain_version(cuda, monkeypatch):
    """CUDA tensors launch the kernels: the plain versions, patched to
    raise, are never reached."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(bf16probe, "roundtrip_reference", plain)
    monkeypatch.setattr(bf16probe, "skeleton_reference", plain)
    x = torch.rand((3, 256, 128), device=cuda).to(torch.bfloat16)
    assert _same_bits(bf16probe.roundtrip(x, "multi"), x)
    dens, rgb, add = _skeleton_state(5, bf16probe.BR, cuda)
    bf16probe.skeleton(dens, rgb, add, np.zeros(1, np.int32),
                       np.zeros(1, np.int32))
    torch.cuda.synchronize()


def test_bf16_probe_refuses_misaligned_tensors(cuda):
    """Bulk copies need 16-byte aligned addresses."""
    base = torch.zeros(3 * 256 * 128 + 1, dtype=torch.bfloat16, device=cuda)
    x = base[1:].view(3, 256, 128)
    before = dict(bf16probe.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        bf16probe.roundtrip(x, "multi")
    assert bf16probe.LAUNCHES == before


def test_bf16_probe_raises_when_build_fails(cuda, monkeypatch):
    """No fallback: a probe library that cannot be built makes the
    wrappers raise."""
    def broken(name):
        raise RuntimeError(f"nvcc failed building {name}.cu")
    monkeypatch.setattr(build, "load", broken)
    before = dict(bf16probe.LAUNCHES)
    x = torch.rand((3, 256, 128), device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bf16probe.roundtrip(x, "per_plane")
    dens, rgb, add = _skeleton_state(6, bf16probe.BR, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bf16probe.skeleton(dens, rgb, add, np.zeros(2, np.int32),
                           np.zeros(1, np.int32))
    assert bf16probe.LAUNCHES == before


def test_bf16_probe_main_on_the_card(cuda, capsys):
    """The entry point: 3 launches for the staging variants, 1 for the
    skeleton, every line ok and named by the card."""
    for k in bf16probe.LAUNCHES:
        bf16probe.LAUNCHES[k] = 0
    assert bf16probe.main([]) == 0
    assert bf16probe.main(["--skeleton"]) == 0
    assert bf16probe.LAUNCHES == {"bf16_roundtrip": 3, "rgb16_skeleton": 1}
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 5
    for ln in lines[1:]:
        assert ln["ok"] and ln["device_ms"] > 0
        assert ln["device"] == torch.cuda.get_device_name(0)
