"""The unsorted and the merged flush on the inputs their CUDA kernels
are hard on, without a GPU.

The case list is tests/test_torch_cuda.py's SCATTER_CASES, shared by
name: there the kernels of csrc/scatter_flush.cu meet their plain
versions on the card; here the plain versions meet the JAX package's
Pallas flushes (`_hist_kernel`, `_hist_kernel_counted`) run in interpret
mode, as the JAX package's own tests run them.  Contract: density exact
(sums of integer counts), rgb within rtol 1e-5.  Palette entries are
multiples of 2^-8 and the weight is 1 or 3/8, so every sum is exact in
float32 in any order: with random float32 colours the plain version's
own sequential sum of a 5000-record run is 1e-4 off.  The JAX kernels
pad to their block size with junk records, so the junk bin is left out.

Also here: what the wrappers do on a CUDA tensor, with the launch
replaced by a recorder: one launch a flush, and nothing but the sort in
front of the merged kernel; with a plotted count, the counting entry.
The plotted count of the plain unsorted flush: it adds
`((recs >> bits) != n_bins).sum()` (records past the junk bin count,
as the render loop's count does) and leaves the histogram as the flush
without a count leaves it.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.ops import histogram as jhist  # noqa: E402
from cuburn_tpu.ops import pallas_hist as ph  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.ops import sort as tsort  # noqa: E402
from tests.test_torch_cuda import (MERGED_TILE, SCATTER_CASES,  # noqa: E402
                                   dyadic_palette, scatter_records)

N_BINS = 64 * 64
BITS = 8

FLUSHES = {
    "pallas": (flush.accumulate_packed, flush.accumulate_packed_reference,
               ph.accumulate_packed_pallas),
    "pallas_merged": (flush.accumulate_merged,
                      flush.accumulate_merged_reference,
                      ph.accumulate_merged_pallas),
}


def _plain(fn, rec, pal, weight):
    return fn(thist.alloc(N_BINS, "cpu"), torch.as_tensor(rec),
              torch.as_tensor(pal), N_BINS, BITS, weight=weight).numpy()


@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("backend", sorted(FLUSHES))
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_plain_flush_matches_jax_pallas_on_edge_cases(backend, case, cols,
                                                      weight):
    _, plain, jfn = FLUSHES[backend]
    rec = scatter_records(case, N_BINS, BITS)
    pal = dyadic_palette(cols)
    got = _plain(plain, rec, pal, weight)
    hp = ph.to_packed_layout(jhist.alloc(N_BINS))
    out = jfn(hp, jnp.asarray(rec.astype(np.uint32)), jnp.asarray(pal),
              N_BINS, BITS, interpret=True,
              weight=None if weight is None else jnp.float32(weight))
    ref = np.asarray(ph.from_packed_layout(out, N_BINS))[:N_BINS]
    if weight is None and cols == 3:
        np.testing.assert_array_equal(got[:N_BINS, 3], ref[:, 3])
        # no record is lost: the junk bin holds the rest
        assert got[:, 3].sum() == rec.size
    np.testing.assert_allclose(got[:N_BINS], ref, rtol=1e-5, atol=1e-6)
    live = (rec >> BITS) < N_BINS
    assert (got[:N_BINS, 3].sum() > 0) == bool(live.any())


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_cases_hold_what_they_name(case):
    """The sorted order of each case has the run, the junk share or the
    count its name promises, at the merged kernel's tile size; and the
    merge of the plain version counts every record once."""
    rec = scatter_records(case, N_BINS, BITS)
    srt = np.sort(rec)
    starts = np.flatnonzero(np.r_[True, srt[1:] != srt[:-1]])
    lengths = np.diff(np.r_[starts, srt.size])
    start, length = starts[lengths.argmax()], lengths.max()
    junk = (rec >> BITS) >= N_BINS
    want = {
        "junk_97": lambda: 0.96 < junk.mean() < 0.98,
        "run_ends_on_tile": lambda: start + length == MERGED_TILE,
        "run_across_one_tile_edge":
            lambda: start < MERGED_TILE < start + length < 2 * MERGED_TILE,
        "run_across_three_tiles":
            lambda: start < MERGED_TILE
            and 3 * MERGED_TILE < start + length < 4 * MERGED_TILE,
        "all_equal": lambda: length == rec.size == 5000,
        "all_distinct": lambda: length == 1 and rec.size == 2 * MERGED_TILE,
        "past_n_bins_colours":
            lambda: len(set(rec[(rec >> BITS) > N_BINS])) > 100,
        "padding_after_junk":
            lambda: junk[np.argsort(rec)][-1000:].all()
            and rec.size & (rec.size - 1),
    }
    if case.startswith("n_"):
        assert rec.size == int(case[2:])
    else:
        assert want[case]()
    uniq, counts = flush.merge_records(torch.as_tensor(rec), N_BINS, BITS,
                                       tsort.sort_records_reference)
    assert int(counts.sum()) == rec.size
    n_uniq = int((counts > 0).sum())
    assert n_uniq == starts.size
    np.testing.assert_array_equal(uniq[:n_uniq].numpy(), srt[starts])
    np.testing.assert_array_equal(counts[:n_uniq].numpy(), lengths)


def _record_launches(monkeypatch):
    """Route the wrappers' CUDA branch through CPU tensors: the device
    reads as cuda, the sort is torch.sort, and a launch is recorded
    instead of made."""
    launched = []
    monkeypatch.setattr(flush, "_device_of", lambda t: "cuda")
    monkeypatch.setattr(flush, "sort_records", tsort.sort_records_reference)
    monkeypatch.setattr(
        flush, "_launch",
        lambda entry, device, *args: launched.append((entry, args)))
    return launched


def _no_torch_merge(*args, **kwargs):
    raise AssertionError("the CUDA branch merged with torch ops")


@pytest.mark.parametrize("n", [1, 33, 5000])
def test_merged_wrapper_is_the_sort_and_one_launch(monkeypatch, n):
    """On a CUDA tensor accumulate_merged hands the sorted, padded
    records to one merged_flush launch: no merge_records, no unique
    records or counts."""
    launched = _record_launches(monkeypatch)
    monkeypatch.setattr(flush, "merge_records", _no_torch_merge)
    monkeypatch.setattr(flush, "merge_sorted_records", _no_torch_merge)
    rec = torch.as_tensor(scatter_records("padding_after_junk", N_BINS)[:n])
    hist = thist.alloc(N_BINS, "cpu")
    out = flush.accumulate_merged(
        hist, rec, torch.as_tensor(dyadic_palette(3)), N_BINS, BITS,
        weight=0.5)
    assert out is hist and float(hist.abs().sum()) == 0.0
    (entry, args), = launched
    assert entry == "merged_flush"
    ptr, count, _pal, bits, n_bins, weight, hist_ptr = args
    assert count == 1 << (n - 1).bit_length()
    assert ptr % 16 == 0 and hist_ptr == hist.data_ptr()
    assert (bits, n_bins, weight) == (BITS, N_BINS, 0.5)


@pytest.mark.parametrize("n", [0, 1, 31, 4097])
def test_packed_wrapper_is_one_launch(monkeypatch, n):
    """accumulate_packed launches once over the records as they are, on
    a 16-byte boundary (the kernel reads two records a load), and not at
    all for no records."""
    launched = _record_launches(monkeypatch)
    # an odd offset into a larger buffer: 8 bytes off the boundary
    rec = torch.as_tensor(scatter_records("all_distinct", N_BINS))[1:n + 1]
    flush.accumulate_packed(
        thist.alloc(N_BINS, "cpu"), rec, torch.as_tensor(dyadic_palette(4)),
        N_BINS, BITS)
    assert len(launched) == (n > 0)
    if n:
        (entry, args), = launched
        assert entry == "packed_flush"
        assert args[0] % 16 == 0 and args[1] == n and args[5] == 1.0


def test_scatter_flush_entries():
    """merged_flush takes sorted records (no counts array any more); the
    counting debug entry and the plotted-count entry are packed_flush's
    signature plus one pointer, and count their launches under
    packed_flush."""
    p, i64, f = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    packed = (p, i64, p, ctypes.c_int, i64, f, p)
    assert flush._ENTRIES["packed_flush"] == ("scatter_flush",
                                              "packed_flush", packed)
    assert flush._ENTRIES["merged_flush"] == ("scatter_flush",
                                              "merged_flush", packed)
    assert flush._ENTRIES["packed_flush_counted"] == (
        "scatter_flush", "packed_flush", packed + (p,))
    assert flush._ENTRIES["packed_flush_tally"] == (
        "scatter_flush", "packed_flush", packed + (p,))
    assert set(kernel for _, kernel, _ in flush._ENTRIES.values()) \
        == set(flush.LAUNCHES)


def _count_records(case):
    """Records of one kind of junk share: every record at the junk bin,
    none, 97% (with a few past it), or addresses past the junk bin."""
    rs = np.random.RandomState(7)
    n = 3000
    q = rs.randint(0, 1 << BITS, n)
    addr = {"all_junk": np.full(n, N_BINS),
            "no_junk": rs.randint(0, N_BINS, n),
            "mixed": np.where(rs.rand(n) < 0.97, N_BINS,
                              rs.randint(0, N_BINS, n)),
            "past_the_junk_bin": rs.randint(N_BINS - 5, N_BINS + 40, n),
            }[case]
    return torch.as_tensor((addr.astype(np.int64) << BITS) | q)


@pytest.mark.parametrize("case", ["all_junk", "no_junk", "mixed",
                                  "past_the_junk_bin"])
@pytest.mark.parametrize("cols,weight", [(3, None), (4, 0.375)])
def test_plain_count_is_the_records_off_the_junk_bin(case, cols, weight):
    rec = _count_records(case)
    pal = torch.as_tensor(dyadic_palette(cols))
    want = int(((rec >> BITS) != N_BINS).sum())
    assert {"all_junk": want == 0, "no_junk": want == rec.numel(),
            "mixed": 0 < want < rec.numel() // 10,
            "past_the_junk_bin": 0 < want < rec.numel()}[case]
    plain = _plain(flush.accumulate_packed_reference, rec, pal, weight)
    for fn in (flush.accumulate_packed_reference, flush.accumulate_packed):
        count = torch.tensor(5, dtype=torch.int64)
        hist = fn(thist.alloc(N_BINS, "cpu"), rec, pal, N_BINS, BITS,
                  weight=weight, count=count)
        assert int(count) == 5 + want
        np.testing.assert_array_equal(hist.numpy(), plain)


def test_count_must_be_one_int64():
    rec, pal = _count_records("mixed"), torch.as_tensor(dyadic_palette(3))
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros((), dtype=torch.float32)):
        with pytest.raises(ValueError, match="one int64"):
            flush.accumulate_packed_reference(
                thist.alloc(N_BINS, "cpu"), rec, pal, N_BINS, BITS,
                count=bad)


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_packed_wrapper_counts_through_the_tally_entry(monkeypatch, n):
    """With a count, accumulate_packed launches the counting entry once,
    the count's pointer last; no records, no launch."""
    launched = _record_launches(monkeypatch)
    rec = torch.as_tensor(scatter_records("junk_97", N_BINS))[:n]
    count = torch.zeros((), dtype=torch.int64)
    flush.accumulate_packed(
        thist.alloc(N_BINS, "cpu"), rec, torch.as_tensor(dyadic_palette(3)),
        N_BINS, BITS, count=count)
    assert len(launched) == (n > 0)
    if n:
        (entry, args), = launched
        assert entry == "packed_flush_tally"
        assert args[1] == n and args[-1] == count.data_ptr()


def test_looped_flush_takes_aligned_cuda_records_only(monkeypatch):
    """The C loop writes the records in place, so its flush refuses what
    the one-flush wrapper would copy: CPU records, and records off a
    16-byte boundary, before any library is loaded."""
    def no_load(*a, **kw):
        raise AssertionError("loaded a library")
    monkeypatch.setattr(flush._build, "load", no_load)
    pal = torch.as_tensor(dyadic_palette(3))
    rec = torch.as_tensor(scatter_records("all_distinct", N_BINS))
    with pytest.raises(ValueError, match="16-byte"):
        flush.looped_flush(thist.alloc(N_BINS, "cpu"), rec, pal, N_BINS,
                           BITS)
    monkeypatch.setattr(flush, "_device_of", lambda t: "cuda")
    off = rec[1:] if rec.data_ptr() % 16 == 0 else rec[2:]
    with pytest.raises(ValueError, match="16-byte"):
        flush.looped_flush(thist.alloc(N_BINS, "cpu"), off, pal, N_BINS,
                           BITS)


@pytest.mark.parametrize("n_records", [0, 64])
def test_looped_flushes_count_one_launch_a_chunk(n_records, monkeypatch):
    """chaos.launch_accumulate counts the launches of its C call where it
    makes it: a chaos_iterate and a packed_flush a chunk (no flush where
    a chunk holds no record) and one plotted_fold.  The call itself is
    stood in, since it runs on the card only."""
    from types import SimpleNamespace

    from cuburn_tpu_torch.ops import chaos
    pal = torch.as_tensor(dyadic_palette(3))
    recs = torch.zeros((1, n_records), dtype=torch.int64)
    plan = SimpleNamespace(key=None, cam=SimpleNamespace(n_bins=N_BINS),
                           tot_bits=BITS)
    seen = {}

    def call(lib, p, state, recs, n_chunks, flush_fn, pal4, n_bins,
             weight, hist, stream):
        seen.update(n_chunks=n_chunks, weight=weight, n_bins=n_bins)
        return state, torch.zeros(()), None
    monkeypatch.setattr(flush, "looped_flush", lambda *a: (0, pal))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(chaos, "load", lambda key: None)
    monkeypatch.setattr(chaos, "accumulate_call", call)
    monkeypatch.setitem(flush.LAUNCHES, "packed_flush", 0)
    monkeypatch.setitem(chaos.LAUNCHES, "chaos_iterate", 0)
    monkeypatch.setitem(chaos.LAUNCHES, "plotted_fold", 0)
    chaos.launch_accumulate(plan, "state", recs, thist.alloc(N_BINS, "cpu"),
                            pal, 7, None)
    assert seen == dict(n_chunks=7, weight=1.0, n_bins=N_BINS)
    assert flush.LAUNCHES["packed_flush"] == (7 if n_records else 0)
    assert chaos.LAUNCHES["chaos_iterate"] == 7
    assert chaos.LAUNCHES["plotted_fold"] == 1
