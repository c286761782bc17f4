"""Histogram flushes of packed records: the ports of the Pallas flushes.

Port of `cuburn_tpu/ops/pallas_hist.py`.  Each flush has a wrapper that
launches a hand-written CUDA kernel on a CUDA tensor and runs its plain
PyTorch version, in this module, on a CPU tensor.  A CUDA tensor never
falls back to the plain version: the kernel launches or the call
raises.

  backend        wrapper                    kernel (csrc/)
  pallas_win     accumulate_windowed        win_flush.cu
  pallas         accumulate_packed          scatter_flush.cu (packed)
  atomic         accumulate_packed          scatter_flush.cu (packed)
  pallas_merged  accumulate_merged          scatter_flush.cu (merged)
  pallas_rgb16   accumulate_windowed_rgb16  win_flush_rgb16.cu

`atomic` is the port's own backend and the card's default: the flush of
`pallas` on `pallas_win`'s records (8 colour bits, ops/iterate.py
record_bits), unsorted.  The JAX package has none, since a TPU has no
scatter-add.

On a CUDA tensor `accumulate_packed` is one launch over the unsorted
records (the junk bin's rows summed per block, equal addresses per
warp, before the atomic), and `accumulate_merged` is `sort_records`
and one launch: the kernel finds the runs of the sorted records and
their counts itself.  `merge_records` (the port of the JAX package's
sort + `merge_sorted_records`) is the plain version's path and the
CPU's only.  `accumulate_windowed_rgb16` is `sort_records` and two
launches, the tiles and the resolve of the runs that cross tile edges;
`rgb16_tiled_model` is that scheme in plain PyTorch, for the tests.

All but the last update the logical (n_bins + 1, 4) float32 histogram
IN PLACE, like the JAX package's in-place mode; `pallas_rgb16` updates
the split layout (density (n_bins + 1,) float32, rgb (n_bins + 1, 3)
bfloat16) in place.  Every flush adds into the junk bin, and clamps
addresses past it onto it.  `LAUNCHES` counts each wrapper's kernel
launches in this process; callers reset it to count a run.
"""

from __future__ import annotations

import ctypes

import torch

from cuburn_tpu_torch.kernels import build as _build
from cuburn_tpu_torch.ops.sort import (SENTINEL, merge_sorted_records,
                                       sort_records, sort_records_reference)

# kernel name -> CUDA kernel launches through its wrapper: one per
# flush for all but win_flush_rgb16, which launches two (its tiles and
# resolve kernels); the sort in front of a sorted flush counts in
# tiled_sort.LAUNCHES
LAUNCHES = {"win_flush": 0, "packed_flush": 0, "merged_flush": 0,
            "win_flush_rgb16": 0}

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry -> (library, kernel it counts under, argtypes before the
# stream); every entry launches one kernel and returns cudaGetLastError()
_ENTRIES = {
    "win_flush": ("win_flush", "win_flush",
                  (_P, _I64, _P, ctypes.c_int, _I64, _F, _P)),
    "packed_flush": ("scatter_flush", "packed_flush",
                     (_P, _I64, _P, ctypes.c_int, _I64, _F, _P)),
    # debug: packed_flush that also counts the atomics it makes
    "packed_flush_counted": ("scatter_flush", "packed_flush",
                             (_P, _I64, _P, ctypes.c_int, _I64, _F, _P,
                              _P)),
    # packed_flush that also adds its plotted count into an int64
    "packed_flush_tally": ("scatter_flush", "packed_flush",
                           (_P, _I64, _P, ctypes.c_int, _I64, _F, _P, _P)),
    "merged_flush": ("scatter_flush", "merged_flush",
                     (_P, _I64, _P, ctypes.c_int, _I64, _F, _P)),
    "win_flush_rgb16_tiles": ("win_flush_rgb16", "win_flush_rgb16",
                              (_P, _I64, _P, ctypes.c_int, _I64, _F, _P, _P,
                               _P)),
    "win_flush_rgb16_resolve": ("win_flush_rgb16", "win_flush_rgb16",
                                (_P, _I64, _F, _P, _P)),
}
# sorted records per block of win_flush_rgb16.cu (its kTile)
RGB16_TILE = 2048


def _pal4(palette_hi: torch.Tensor) -> torch.Tensor:
    """Palette rows as (K, 4): a 3-column palette gets density 1
    appended; a 4-column (opacity-extended) one is used as it is."""
    if palette_hi.shape[1] == 4:
        return palette_hi
    ones = palette_hi.new_ones((palette_hi.shape[0], 1))
    return torch.cat([palette_hi, ones], dim=1)


def _check_inputs(packed_records, palette_hi, color_bits, *tensors):
    """Records are int64 holding u32 values `addr << color_bits | q`.
    0xFFFFFFFF is the sort's padding sentinel, which the sorted flushes
    skip; it is never a record of a render, since `color_bits_for`
    keeps every record below it.  The value range is checked on the CPU
    only: on the card the check would cost a sync per flush."""
    if packed_records.dtype != torch.int64:
        raise ValueError("packed records must be int64 (u32 values), "
                         f"got {packed_records.dtype}")
    if packed_records.device.type == "cpu" and packed_records.numel() \
            and (int(packed_records.min()) < 0
                 or int(packed_records.max()) > SENTINEL):
        raise ValueError("packed records must be u32 values, got "
                         f"[{int(packed_records.min())}, "
                         f"{int(packed_records.max())}]")
    if palette_hi.dtype != torch.float32 or palette_hi.dim() != 2 \
            or palette_hi.shape[1] not in (3, 4) \
            or palette_hi.shape[0] != 1 << color_bits:
        raise ValueError(
            f"palette must be float32 ({1 << color_bits}, 3 or 4), got "
            f"{palette_hi.dtype} {tuple(palette_hi.shape)}")
    devices = {t.device for t in (packed_records, palette_hi, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _check(hist, packed_records, palette_hi, n_bins, color_bits):
    if hist.dtype != torch.float32 or hist.shape != (n_bins + 1, 4) \
            or not hist.is_contiguous():
        raise ValueError(
            f"hist must be a contiguous float32 ({n_bins + 1}, 4) tensor, "
            f"got {hist.dtype} {tuple(hist.shape)}")
    _check_inputs(packed_records, palette_hi, color_bits, hist)


def _check_split(hist_split, packed_records, palette_hi, n_bins,
                 color_bits):
    dens, rgb = hist_split
    if dens.dtype != torch.float32 or dens.shape != (n_bins + 1,) \
            or not dens.is_contiguous():
        raise ValueError(
            f"split density must be a contiguous float32 ({n_bins + 1},) "
            f"tensor, got {dens.dtype} {tuple(dens.shape)}")
    if rgb.dtype != torch.bfloat16 or rgb.shape != (n_bins + 1, 3) \
            or not rgb.is_contiguous():
        raise ValueError(
            f"split rgb must be a contiguous bfloat16 ({n_bins + 1}, 3) "
            f"tensor, got {rgb.dtype} {tuple(rgb.shape)}")
    _check_inputs(packed_records, palette_hi, color_bits, dens, rgb)


def _device_of(t: torch.Tensor) -> str:
    """'cpu' or 'cuda'; raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _weight(weight) -> float:
    return 1.0 if weight is None else float(weight)


def _add_rows(hist, recs, palette_hi, n_bins, color_bits, counts, w):
    """hist[min(addr, n_bins)] += w * counts * pal4[q], in place."""
    addr = torch.clamp(recs >> color_bits, max=n_bins)
    rows = _pal4(palette_hi)[recs & ((1 << color_bits) - 1)]
    if counts is not None:
        rows = rows * counts.to(torch.float32)[:, None]
    return hist.index_add_(0, addr, rows, alpha=w)


def _launch(entry: str, device, *args):
    """One launch of C entry `entry` on the device's current stream (no
    sync), counted in LAUNCHES under its kernel."""
    lib, kernel, argtypes = _ENTRIES[entry]
    _build.launch(LAUNCHES, kernel, lib, entry, argtypes,
                  torch.cuda.current_stream(device).cuda_stream, *args)


def _aligned(t):
    """t contiguous on a 16-byte boundary (the kernels read it in 16-byte
    vectors)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _aligned_pal4(palette_hi):
    """Contiguous (K, 4) palette rows on a 16-byte boundary (the kernels
    read rows as float4)."""
    return _aligned(_pal4(palette_hi))


# -- pallas_win: sorted records, one add per sorted run --------------------

def accumulate_windowed_reference(hist, packed_records, palette_hi,
                                  n_bins: int, color_bits: int,
                                  weight=None):
    """The plain PyTorch flush: torch.sort, unpack, then index_add_ of
    weight * pal4[q] * count per record, where sentinels count 0.
    Updates hist in place; returns it."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    recs = sort_records_reference(packed_records)
    return _add_rows(hist, recs, palette_hi, n_bins, color_bits,
                     recs != SENTINEL, _weight(weight))


def accumulate_windowed(hist, packed_records, palette_hi, n_bins: int,
                        color_bits: int, weight=None):
    """Flush packed records `addr << color_bits | q` into the logical
    histogram IN PLACE and return it: each record adds weight *
    palette row q (rgb and density 1 for a 3-column palette, the
    4-column opacity-extended row as it is) into bin addr.

    CPU tensors take the plain version; CUDA tensors sort with
    sort_records (the tiled bitonic sort kernel) and launch
    win_flush.cu, which adds weight times each sorted run's sum.
    Density is exact at weight 1.0 with a 3-column palette; rgb agrees
    within float32 reassociation."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    if _device_of(hist) == "cpu":
        return accumulate_windowed_reference(
            hist, packed_records, palette_hi, n_bins, color_bits, weight)
    pal4 = _aligned_pal4(palette_hi)
    recs = _aligned(sort_records(packed_records))
    _launch("win_flush", hist.device, recs.data_ptr(), recs.numel(),
            pal4.data_ptr(), color_bits, n_bins, _weight(weight),
            hist.data_ptr())
    return hist


# -- pallas: unsorted records, atomics aggregated per warp and block -------

def _check_count(count, hist):
    if count.dtype != torch.int64 or count.numel() != 1 \
            or count.device != hist.device:
        raise ValueError(
            f"count must be one int64 on {hist.device}, got {count.dtype} "
            f"{tuple(count.shape)} on {count.device}")


def accumulate_packed_reference(hist, packed_records, palette_hi,
                                n_bins: int, color_bits: int,
                                weight=None, count=None):
    """The plain flush of unsorted records: unpack, then index_add_ of
    weight * pal4[q] per record.  With `count` (one int64, updated in
    place) it also adds the plotted count: the records whose address is
    not the junk bin n_bins.  Updates hist in place; returns it."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    recs = packed_records.reshape(-1)
    if count is not None:
        _check_count(count, hist)
        count += ((recs >> color_bits) != n_bins).sum()
    return _add_rows(hist, recs, palette_hi, n_bins, color_bits, None,
                     _weight(weight))


def accumulate_packed(hist, packed_records, palette_hi, n_bins: int,
                      color_bits: int, weight=None, count=None):
    """Flush unsorted packed records into the logical histogram IN
    PLACE: each record adds weight * pal4[q] into bin addr, in no
    particular order (`accumulate_packed_pallas`, backends `pallas` and
    `atomic`).  With `count`, the plotted count as
    accumulate_packed_reference's.
    CUDA tensors launch scatter_flush.cu's packed entry once: a block
    sums its junk-bin rows into one float4 atomicAdd, a warp the rows
    of lanes with equal addresses, every other record adds its own;
    the counting entry counts the records at the junk bin inside the
    same block sum.
    Density is exact at weight 1.0 with a 3-column palette, since its
    sums are integer counts; rgb agrees within float32 reassociation."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    if _device_of(hist) == "cpu":
        return accumulate_packed_reference(
            hist, packed_records, palette_hi, n_bins, color_bits, weight,
            count)
    pal4 = _aligned_pal4(palette_hi)
    recs = _aligned(packed_records.reshape(-1))
    if count is not None:
        _check_count(count, hist)
    if not recs.numel():    # the sorted flushes always get >= 1 record
        return hist
    args = (recs.data_ptr(), recs.numel(), pal4.data_ptr(), color_bits,
            n_bins, _weight(weight), hist.data_ptr())
    if count is None:
        _launch("packed_flush", hist.device, *args)
    else:
        _launch("packed_flush_tally", hist.device, *args, count.data_ptr())
    return hist


def looped_flush(hist, packed_records, palette_hi, n_bins: int,
                 color_bits: int):
    """What a C loop that launches the counting packed flush itself
    needs (ops/chaos.py launch_accumulate): the inputs checked as
    accumulate_packed checks them, then (the address of
    scatter_flush.cu's packed_flush_tally entry, the palette rows as
    the kernel reads them).  The records must already lie on a 16-byte
    boundary, since the loop writes them in place.  CUDA tensors
    only."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    if _device_of(hist) != "cuda" or packed_records.data_ptr() % 16 \
            or not packed_records.is_contiguous():
        raise ValueError("the looped flush takes contiguous CUDA records "
                         "on a 16-byte boundary")
    lib = _build.load(_ENTRIES["packed_flush_tally"][0])
    fn = ctypes.cast(lib.packed_flush_tally, ctypes.c_void_p).value
    return fn, _aligned_pal4(palette_hi)


# -- pallas_merged: sort, run-merge, one add per unique record -------------

def merge_records(packed_records, n_bins: int, color_bits: int,
                  sort=sort_records):
    """sort (sort_records, or the plain version's torch.sort), then
    merge_sorted_records: (unique records, int32 counts), uniques
    first, padded with the junk record at count 0.  The power-of-two
    padding's sentinels merge into one record, whose count is zeroed
    here.  The plain merged flush and the CPU use it; on the card
    scatter_flush.cu's merged entry merges in its own body."""
    uniq, counts = merge_sorted_records(sort(packed_records),
                                        n_bins << color_bits)
    return uniq, torch.where(uniq == SENTINEL, 0, counts)


def accumulate_merged_reference(hist, packed_records, palette_hi,
                                n_bins: int, color_bits: int,
                                weight=None):
    """The plain merged flush: merge_records after torch.sort, then
    index_add_ of weight * count * pal4[q] per unique record.  In
    place."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    uniq, counts = merge_records(packed_records, n_bins, color_bits,
                                 sort_records_reference)
    return _add_rows(hist, uniq, palette_hi, n_bins, color_bits, counts,
                     _weight(weight))


def accumulate_merged(hist, packed_records, palette_hi, n_bins: int,
                      color_bits: int, weight=None):
    """Sort + run-merge + count-weighted flush IN PLACE
    (`accumulate_merged_pallas`, backend `pallas_merged`): duplicate
    records collapse into one update of count * pal4[q].  CUDA tensors
    sort with sort_records and launch scatter_flush.cu's merged entry
    once: it finds the runs of the sorted records and their counts in
    its own body and makes one float4 atomicAdd per distinct record,
    none for the sort's padding.  No PyTorch op runs between the sort
    and the launch."""
    _check(hist, packed_records, palette_hi, n_bins, color_bits)
    if _device_of(hist) == "cpu":
        return accumulate_merged_reference(
            hist, packed_records, palette_hi, n_bins, color_bits, weight)
    pal4 = _aligned_pal4(palette_hi)
    recs = _aligned(sort_records(packed_records))
    _launch("merged_flush", hist.device, recs.data_ptr(), recs.numel(),
            pal4.data_ptr(), color_bits, n_bins, _weight(weight),
            hist.data_ptr())
    return hist


# -- pallas_rgb16: sorted records into f32 density + bf16 rgb --------------

def alloc_split(n_bins: int, device):
    """A zeroed split histogram: (density (n_bins+1,) float32, rgb
    (n_bins+1, 3) bfloat16)."""
    return (torch.zeros((n_bins + 1,), dtype=torch.float32, device=device),
            torch.zeros((n_bins + 1, 3), dtype=torch.bfloat16,
                        device=device))


def to_split_layout(hist):
    """Logical (n_bins+1, 4) float32 -> split (density, bf16 rgb): rgb
    is rounded to bf16 once, density is kept as it is."""
    return (hist[:, 3].contiguous(),
            hist[:, :3].to(torch.bfloat16).contiguous())


def from_split_layout(dens, rgb):
    """Split (density, bf16 rgb) -> logical (n_bins+1, 4) float32."""
    return torch.cat([rgb.to(torch.float32), dens[:, None]], dim=1)


def accumulate_windowed_rgb16_reference(hist_split, packed_records,
                                        palette_hi, n_bins: int,
                                        color_bits: int, weight=None):
    """The plain split flush: every bin's records summed in float32
    (sentinels count 0), then density += weight * sum and rgb =
    bf16(f32(rgb) + weight * sum), one rounding per bin per flush.
    Bins without records keep their value exactly.  In place; returns
    (dens, rgb)."""
    _check_split(hist_split, packed_records, palette_hi, n_bins,
                 color_bits)
    dens, rgb = hist_split
    recs = packed_records.reshape(-1)
    sums = _add_rows(dens.new_zeros((n_bins + 1, 4)), recs, palette_hi,
                     n_bins, color_bits, recs != SENTINEL, 1.0)
    w = _weight(weight)
    dens.add_(sums[:, 3], alpha=w)
    rgb.copy_(torch.add(rgb.to(torch.float32), sums[:, :3], alpha=w))
    return dens, rgb


def accumulate_windowed_rgb16(hist_split, packed_records, palette_hi,
                              n_bins: int, color_bits: int, weight=None):
    """Windowed flush over the split histogram, IN PLACE
    (`accumulate_windowed_pallas_rgb16`, backend `pallas_rgb16`).
    Density never leaves float32, so it stays exact at weight 1.0 with
    a 3-column palette; rgb is rounded to bf16 once per touched bin per
    flush, never once per record.  CUDA tensors sort with sort_records
    and launch win_flush_rgb16.cu's two kernels, which sum each sorted
    run in float32 in a fixed order and write its bin once: the same
    records give the same bits on every call.  No PyTorch op that
    launches a kernel runs between the sort and them.  Returns
    (dens, rgb)."""
    _check_split(hist_split, packed_records, palette_hi, n_bins,
                 color_bits)
    dens, rgb = hist_split
    if _device_of(dens) == "cpu":
        return accumulate_windowed_rgb16_reference(
            hist_split, packed_records, palette_hi, n_bins, color_bits,
            weight)
    pal4 = _aligned_pal4(palette_hi)
    recs = _aligned(sort_records(packed_records))
    rgb16_launch(recs, pal4, color_bits, n_bins, _weight(weight), dens,
                 rgb, rgb16_scratch(recs.numel(), dens.device))
    return dens, rgb


def rgb16_scratch(n: int, device) -> torch.Tensor:
    """The scratch win_flush_rgb16.cu needs for n sorted records: for
    each tile of RGB16_TILE records 16 bytes each for the sum of a run
    that came in from the tile before (head), of one that goes on into
    the tile after (tail), and for the tile's flags.  Uninitialised:
    every tile writes its flags, and a sum is read only where they say
    it was written."""
    return torch.empty((3, -(-n // RGB16_TILE), 4), dtype=torch.float32,
                       device=device)


def rgb16_launch(recs, pal4, color_bits: int, n_bins: int, weight: float,
                 dens, rgb, scratch):
    """win_flush_rgb16.cu's two kernels over sorted records `recs`
    (16-byte aligned): the tiles, then the resolve of the runs that
    cross tile edges, with `scratch` from rgb16_scratch(recs.numel())."""
    n = recs.numel()
    if scratch.shape != (3, -(-n // RGB16_TILE), 4) \
            or scratch.dtype != torch.float32 \
            or not scratch.is_contiguous():
        raise ValueError(
            f"scratch must be rgb16_scratch({n}), got "
            f"{scratch.dtype} {tuple(scratch.shape)}")
    if recs.data_ptr() % 16 or rgb.data_ptr() % 4:
        raise ValueError("sorted records must lie on a 16-byte boundary "
                         "and rgb on a 4-byte one")
    _launch("win_flush_rgb16_tiles", dens.device, recs.data_ptr(), n,
            pal4.data_ptr(), color_bits, n_bins, weight, dens.data_ptr(),
            rgb.data_ptr(), scratch.data_ptr())
    _launch("win_flush_rgb16_resolve", dens.device, scratch.data_ptr(), n,
            weight, dens.data_ptr(), rgb.data_ptr())


def rgb16_tiled_model(hist_split, sorted_records, palette_hi, n_bins: int,
                      color_bits: int, weight=None, tile: int = RGB16_TILE):
    """win_flush_rgb16.cu's bookkeeping in plain PyTorch, for the tests:
    the kernel's scheme at any tile size, not a flush anyone calls.

    Over sorted records (sentinels last), tile by tile: a run of equal
    bins inside a tile is written at once; the part of a run that came
    in from the tile before goes into the tile's head slot, with
    whether the run ends in this tile; the part of a run that starts
    here and goes on into the next tile goes into its tail slot.  Then
    the tiles are walked in order: a head adds to the open sum, a head
    that closes writes its bin from it, a tail opens a new one.  A tile
    of sentinels has empty slots.  Updates (dens, rgb) in place and
    returns (dens, rgb, writes): writes[b] counts the writes of bin
    b."""
    _check_split(hist_split, sorted_records, palette_hi, n_bins,
                 color_bits)
    dens, rgb = hist_split
    recs = sorted_records.reshape(-1)
    n, w = recs.numel(), _weight(weight)
    if n > 1 and bool((recs[1:] < recs[:-1]).any()):
        raise ValueError("records must be sorted ascending")
    none = n_bins + 1                   # the bin of a sentinel
    bins = torch.where(recs >= SENTINEL, none,
                       torch.clamp(recs >> color_bits, max=n_bins))
    rows = _pal4(palette_hi)[recs & ((1 << color_bits) - 1)]
    writes = torch.zeros(n_bins + 1, dtype=torch.int64)

    def write_bin(b, s):
        dens[b] += w * s[3]
        rgb[b] = (rgb[b].to(torch.float32) + w * s[:3]).to(torch.bfloat16)
        writes[b] += 1

    slots = []          # per tile: (head sum, closes, head bin, tail sum)
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        head = tail = head_bin = None
        closes = False
        if bins[lo] != none:
            from_before = lo > 0 and bins[lo - 1] == bins[lo]
            into_next = hi < n and bins[hi] != none \
                and bins[hi] == bins[hi - 1]
            live = lo + int((bins[lo:hi] != none).sum())
            starts = [lo] + [i for i in range(lo + 1, live)
                             if bins[i] != bins[i - 1]]
            for s, e in zip(starts, starts[1:] + [live]):
                run = rows[s:e].sum(dim=0)
                if s == lo and from_before:
                    head, head_bin = run, int(bins[s])
                    closes = not (e == hi and into_next)
                elif e == hi and into_next:
                    tail = run
                else:
                    write_bin(int(bins[s]), run)
        slots.append((head, closes, head_bin, tail))
    open_sum = None
    for head, closes, head_bin, tail in slots:
        if head is not None:
            open_sum = open_sum + head
            if closes:
                write_bin(head_bin, open_sum)
                open_sum = None
        if tail is not None:
            open_sum = tail
    return dens, rgb, writes
