"""The split flush's tile and resolve bookkeeping, on the CPU.

win_flush_rgb16.cu runs only on a GPU, but its one idea does not need
one: runs of a bin inside a tile of sorted records are written at once,
the parts of a run that crosses a tile edge go into per-tile head and
tail slots, and an in-order walk over the tiles writes such a bin once.
`flush.rgb16_tiled_model` is that scheme in plain PyTorch with the tile
size a parameter.  Contracts:
- with palette entries that are multiples of 2^-8 and weight 1 or 3/8
  every sum is exact in float32 in any order, so the model equals the
  plain split flush (`accumulate_windowed_rgb16_reference`) bit for bit,
  density and bf16 rgb; with a random float32 palette density is still
  exact at weight 1.0 and rgb within one bf16 ulp;
- against the JAX package's `accumulate_windowed_pallas_rgb16` in
  interpret mode, as tests/test_torch_backends.py holds the plain
  version: density exact, rgb within 2^-7 of the magnitude;
- every touched bin is written exactly once, and bins without records
  keep their bits.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.ops import pallas_hist as ph  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402

N_BINS = 48 * 40
BITS = 8
SENTINEL = 0xFFFFFFFF
EDGE_CASES = ("run_ends_on_tile_edge", "run_across_one_edge",
              "run_across_many_tiles", "whole_tile_run_between_two_others",
              "junk_run_then_sentinels", "all_sentinel_last_tile",
              "one_record", "n_not_a_multiple_of_the_tile", "all_equal",
              "all_distinct")


def _runs(case, tile):
    """(bin, run length) in sorted order and the sentinels after them,
    placed against tiles of `tile` records."""
    junk = N_BINS
    if case == "run_ends_on_tile_edge":
        runs = [(3, tile - 3), (9, 3), (11, 2), (12, tile - 2)]
    elif case == "run_across_one_edge":
        runs = [(3, tile - 2), (9, 5), (11, tile - 3)]
    elif case == "run_across_many_tiles":
        runs = [(3, 3), (9, 4 * tile + 1), (11, 2)]
    elif case == "whole_tile_run_between_two_others":
        # bin 9 fills the second tile exactly; bins 3 and 11 cross the
        # edges on either side of other tiles
        runs = [(2, 2), (3, tile - 2), (9, tile), (11, tile + 1), (12, 1)]
    elif case == "junk_run_then_sentinels":
        runs = [(5, 3), (junk, 2 * tile + 3)]
        return runs, 2 * tile - 6
    elif case == "all_sentinel_last_tile":
        runs = [(5, tile - 1), (6, tile - 2)]
        return runs, tile + 3
    elif case == "one_record":
        runs = [(17, 1)]
    elif case == "n_not_a_multiple_of_the_tile":
        runs = [(4, tile + 1), (5, 1), (8, tile // 2)]
    elif case == "all_equal":
        runs = [(N_BINS // 3, 3 * tile + 5)]
    else:   # all_distinct
        runs = [(7 * i, 1) for i in range(3 * tile)]
    return runs, 0


def _records(runs, sentinels, seed, past_junk=False):
    """Sorted int64 records of the runs (colours random within a run),
    sentinels last.  `past_junk` sends half of the junk bin's records to
    addresses above it."""
    rs = np.random.RandomState(seed)
    addr = np.concatenate([np.full(length, b) for b, length in runs])
    if past_junk:
        addr = addr + (addr == N_BINS) * rs.randint(0, 9, addr.size)
    rec = (addr.astype(np.int64) << BITS) | rs.randint(0, 1 << BITS,
                                                       addr.size)
    assert rec.max() < SENTINEL
    return np.concatenate([np.sort(rec), np.full(sentinels, SENTINEL)])


def _dyadic_palette(cols, seed=3):
    return (np.random.RandomState(seed).randint(0, 256, (1 << BITS, cols))
            / 256.0).astype(np.float32)


def _start(seed):
    """A nonzero logical histogram: integer density, rgb up to 50."""
    rs = np.random.RandomState(seed)
    start = rs.rand(N_BINS + 1, 4).astype(np.float32) * 50.0
    start[:, 3] = rs.randint(0, 1000, N_BINS + 1)
    return start


def _both(rec, pal, start, weight, tile):
    """(model's dens, rgb, writes) and (plain version's dens, rgb) from
    the same split start."""
    r, p = torch.as_tensor(rec), torch.as_tensor(pal)
    got = flush.rgb16_tiled_model(
        flush.to_split_layout(torch.as_tensor(start)), r, p, N_BINS, BITS,
        weight=weight, tile=tile)
    ref = flush.accumulate_windowed_rgb16_reference(
        flush.to_split_layout(torch.as_tensor(start)), r, p, N_BINS, BITS,
        weight=weight)
    return got, ref


def _assert_one_writer(rec, writes, got, start):
    live = rec[rec != SENTINEL]
    touched = np.unique(np.minimum(live >> BITS, N_BINS))
    want = np.zeros(N_BINS + 1, np.int64)
    want[touched] = 1
    np.testing.assert_array_equal(writes.numpy(), want)
    d0, c0 = flush.to_split_layout(torch.as_tensor(start))
    idle = torch.as_tensor(want == 0)
    assert torch.equal(got[0][idle], d0[idle])
    assert torch.equal(got[1][idle].view(torch.int16),
                       c0[idle].view(torch.int16))


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_tiled_model_equals_plain_version(case, tile, cols, weight):
    runs, sentinels = _runs(case, tile)
    rec = _records(runs, sentinels, seed=len(case) + tile)
    start = _start(1)
    (dens, rgb, writes), (rd, rr) = _both(rec, _dyadic_palette(cols), start,
                                          weight, tile)
    assert torch.equal(dens, rd)
    assert torch.equal(rgb.view(torch.int16), rr.view(torch.int16))
    _assert_one_writer(rec, writes, (dens, rgb), start)
    if weight is None:
        added = float(dens.double().sum()) - float(start[:, 3].sum(
            dtype=np.float64))
        assert added == (rec != SENTINEL).sum()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_tiled_model_float_palette_within_one_bf16_ulp(case):
    """A random float32 palette: the model's sums round in another order
    than the plain version's, so rgb may differ by one bf16 ulp; density
    is a count and stays exact.  Junk records past n_bins with their own
    colours land on the junk bin."""
    runs, sentinels = _runs(case, 16)
    rec = _records(runs, sentinels, seed=5, past_junk=True)
    pal = np.random.RandomState(6).rand(1 << BITS, 3).astype(np.float32)
    start = _start(2)
    (dens, rgb, writes), (rd, rr) = _both(rec, pal, start, None, 16)
    assert torch.equal(dens, rd)
    ulp = torch.finfo(torch.bfloat16).eps * rr.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert bool(((rgb.float() - rr.float()).abs() <= ulp).all())
    _assert_one_writer(rec, writes, (dens, rgb), start)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_tiled_model_matches_jax_pallas(case):
    """Against the Pallas split flush in interpret mode, as
    test_plain_rgb16_matches_jax_pallas holds the plain version: density
    exact, rgb within 2^-7 of the magnitude."""
    runs, sentinels = _runs(case, 16)
    rec = _records(runs, sentinels, seed=7)
    pal = np.random.RandomState(8).rand(1 << BITS, 3).astype(np.float32)
    start = _start(3)
    live = rec[rec != SENTINEL].astype(np.uint32)
    jd, jr = ph.accumulate_windowed_pallas_rgb16(
        ph.to_split_layout(jnp.asarray(start)), jnp.asarray(live),
        jnp.asarray(pal), N_BINS, BITS, interpret=True)
    j = np.asarray(ph.from_split_layout(jd, jr, N_BINS))
    dens, rgb, _ = flush.rgb16_tiled_model(
        flush.to_split_layout(torch.as_tensor(start)), torch.as_tensor(rec),
        torch.as_tensor(pal), N_BINS, BITS, tile=16)
    t = flush.from_split_layout(dens, rgb).numpy()
    np.testing.assert_array_equal(t[:, 3], j[:, 3])
    scale = np.maximum(np.abs(j[:, :3]), 1.0)
    np.testing.assert_allclose(t[:, :3], j[:, :3],
                               atol=float((scale * 2 ** -7).max()))


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), tile=st.sampled_from([4, 8, 16]))
def test_tiled_model_random_run_layouts(seed, tile):
    """Random run layouts from a numpy seed: many short runs, a few long
    ones, sometimes a junk run and a tail of sentinels."""
    rs = np.random.RandomState(seed)
    k = rs.randint(1, 30)
    bins = np.sort(rs.choice(N_BINS + 1, k, replace=False))
    lengths = np.where(rs.rand(k) < 0.2, rs.randint(1, 5 * tile, k),
                       rs.randint(1, 4, k))
    rec = _records(list(zip(bins, lengths)), int(rs.randint(0, 2 * tile + 1)),
                   seed=seed % 1000)
    start = _start(seed % 7)
    weight = None if seed % 2 else 0.375
    (dens, rgb, writes), (rd, rr) = _both(
        rec, _dyadic_palette(3 + seed % 2), start, weight, tile)
    assert torch.equal(dens, rd)
    assert torch.equal(rgb.view(torch.int16), rr.view(torch.int16))
    _assert_one_writer(rec, writes, (dens, rgb), start)


def test_tiled_model_rounds_a_hot_bin_once_across_tiles():
    """4096 records of colour 0.01 in one bin, spread over 256 tiles of
    16: the bin's rgb grows by ~40.96 from 300, which one bf16 rounding
    per tile (steps of 0.16 against an ulp of 2 at 256+) would lose."""
    pal = np.full((256, 3), 0.01, np.float32)
    rec = np.full(4096, (7 << 8) | 3, np.int64)
    split = flush.to_split_layout(torch.zeros((N_BINS + 1, 4)))
    split[1][7] = 300.0
    dens, rgb, writes = flush.rgb16_tiled_model(
        split, torch.as_tensor(rec), torch.as_tensor(pal), N_BINS, 8,
        tile=16)
    assert float(dens[7]) == 4096.0 and int(writes.sum()) == 1
    assert abs(float(rgb[7, 0]) - 340.96) <= 2.0


def test_tiled_model_refuses_unsorted_records():
    rec = torch.as_tensor(np.array([5 << 8, 3 << 8], np.int64))
    with pytest.raises(ValueError, match="sorted"):
        flush.rgb16_tiled_model(flush.alloc_split(N_BINS, "cpu"), rec,
                                torch.zeros((256, 3)), N_BINS, 8)


@pytest.mark.parametrize("n,tiles", [(1, 1), (2048, 1), (2049, 2),
                                     (1 << 22, 2048), ((1 << 22) + 1, 2049)])
def test_scratch_is_three_slots_a_tile(n, tiles):
    """Two sums and a word of flags per tile of 2048 records: 96 KB at
    2^22 records, allocated without a memset."""
    s = flush.rgb16_scratch(n, "cpu")
    assert s.shape == (3, tiles, 4) and s.dtype == torch.float32
    assert s.is_contiguous() and s.data_ptr() % 16 == 0


def test_launch_refuses_a_wrong_scratch(monkeypatch):
    def no_launch(*args):
        raise AssertionError("launched with a scratch of the wrong size")
    monkeypatch.setattr(build, "launch", no_launch)
    dens, rgb = flush.alloc_split(N_BINS, "cpu")
    recs = torch.zeros(5000, dtype=torch.int64)
    with pytest.raises(ValueError, match="rgb16_scratch"):
        flush.rgb16_launch(recs, torch.zeros((256, 4)), 8, N_BINS, 1.0,
                           dens, rgb, flush.rgb16_scratch(2048, "cpu"))


def test_library_name_tracks_shared_headers(tmp_path, monkeypatch):
    """win_flush.cu and win_flush_rgb16.cu share csrc/tile_scan.cuh: a
    change to a header renames, and so rebuilds, every library."""
    for name in ("a.cu", "shared.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("a")
    assert build.library_path("a") == before
    (tmp_path / "shared.cuh").write_text("// changed\n")
    assert build.library_path("a") != before
    assert (build.CSRC_DIR / "shared.cuh").exists()


def test_split_flush_source_has_no_atomics():
    """One writer per bin is the kernel's contract: neither its source
    nor the header it shares forms a sum with an atomic (win_flush.cu
    keeps its own atomicAdd for the f32 histogram's edge runs)."""
    for name in ("win_flush_rgb16.cu", "tile_scan.cuh"):
        assert "atomic" not in (build.CSRC_DIR / name).read_text().replace(
            "by atomics", "")
    assert "atomicAdd" in (build.CSRC_DIR / "win_flush.cu").read_text()
