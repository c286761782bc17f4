"""The chaos-game iteration: the hot loop of the renderer.

Port of `cuburn_tpu/ops/iterate.py`.  A batch of B trajectories
advances in lockstep; per iteration, for every point:

    u      = rng.uniform()
    xf     = CDF selection (xaos-conditioned on the previous xform)
    (x,y)  = post( sum_v w_v * V_v( affine * (x,y) ) )     [ops/xform.py]
    c      = c*(1-speed) + xf.color*speed
    badvalue (non-finite / |x|>1e10) -> respawn in the bi-unit square
    if age >= fuse: plot the final-xform copy through the camera as a
             packed u32 record addr << bits | palette coordinate

`iterate_accumulate` collects `iters_per_flush` steps of records and
flushes them into the histogram once per chunk.  On a CUDA tensor a
chunk is one launch of the chaos-game kernel (`iterate_records`,
`iterate_full`: ops/chaos.py, csrc/chaos_iterate.cu); on a CPU tensor
it is the kernel's plain version, `iterate_step` below once a step, a
few hundred small eager ops each.  On the card with the unsorted packed
flush the chunk loop itself runs in C (`chaos.launch_accumulate`).
Records are int64 tensors holding u32 values.  A frame whose records
do not fit 32 bits (past 2^24 bins, or `packed=False`) flushes full
(addr, rgba) records from `iterate_chunk` instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cuburn_tpu_torch.genome.specs import StructureKey
from cuburn_tpu_torch.ops import chaos
from cuburn_tpu_torch.ops import flush as flush_mod
from cuburn_tpu_torch.ops import histogram as hist_mod
from cuburn_tpu_torch.ops import rng as rng_mod
from cuburn_tpu_torch.ops.camera import CameraSpec, project, project_3d
from cuburn_tpu_torch.ops.interp import sample_params
from cuburn_tpu_torch.ops.xform import (apply_final_xform, apply_xforms,
                                        build_xform_table,
                                        select_and_fetch)
from cuburn_tpu_torch.utils import trace

BADVALUE_LIMIT = float(np.float32(1e10))
MASK32 = rng_mod.MASK32
_INV24 = 1.0 / (1 << 24)


@dataclass
class IterState:
    """Per-trajectory state: x, y, color (B,) float32; last_xf, age
    (B,) int64; rng (B, 4) int64 holding u32 words."""
    x: torch.Tensor
    y: torch.Tensor
    color: torch.Tensor
    last_xf: torch.Tensor
    age: torch.Tensor
    rng: torch.Tensor


def init_state(generator: torch.Generator, batch: int,
               device: torch.device | str) -> IterState:
    """Fresh trajectories: uniform in the bi-unit square, random color,
    age 0 (they run `fuse` warmup iterations before plotting).  Drawn
    from `generator` on its own device, then moved to `device`, so the
    streams differ from the JAX package's threefry-seeded ones.  A CPU
    generator's draws are four uploads, queued without a wait."""
    gdev = generator.device
    xy = torch.rand((2, batch), generator=generator,
                    device=gdev) * 2.0 - 1.0
    color = torch.rand((batch,), generator=generator, device=gdev)
    rng = rng_mod.seed(generator, batch, device)
    zeros = torch.zeros((batch,), dtype=torch.int64, device=device)
    return IterState(x=trace.upload(xy[0], device),
                     y=trace.upload(xy[1], device),
                     color=trace.upload(color, device), last_xf=zeros,
                     age=zeros.clone(), rng=rng)


def xform_cdf_rows(params) -> torch.Tensor:
    """(N, N) row-normalized CDFs: row i is the selection CDF over next
    xforms given previous xform i.  Negative weights clamp to zero, and
    an all-zero row falls back to uniform selection."""
    probs = torch.clamp(params.weights[None, :], min=0.0) \
        * torch.clamp(params.xaos, min=0.0)
    row_sum = probs.sum(dim=1, keepdim=True)
    probs = torch.where(row_sum > 0, probs, 1.0)
    cdf = torch.cumsum(probs, dim=1)
    total = torch.clamp(cdf[:, -1:], min=float(np.float32(1e-20)))
    return cdf / total


def _palette_rgb(palette, color):
    """Linear-interp palette lookup; palette (256, 3), color in [0,1]."""
    f = torch.clamp(color, 0.0, 1.0) * 255.0
    i0 = torch.floor(f).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=255)
    frac = (f - i0.to(torch.float32))[..., None]
    return palette[i0] * (1.0 - frac) + palette[i1] * frac


def color_bits_for(n_bins: int) -> int:
    """Palette-coordinate bits available when packing (addr, color)
    into one u32 log record; 0 if packing is impossible."""
    addr_bits = int(np.ceil(np.log2(n_bins + 2)))
    bits = min(10, 32 - addr_bits)
    return bits if bits >= 8 else 0


def quantize_color(color_bits: int, pcolor):
    """Palette coordinate in [0, 1] -> int64 quantized to
    2^color_bits levels."""
    levels = float((1 << color_bits) - 1)
    q = torch.clamp(pcolor, 0.0, 1.0) * levels + 0.5
    return q.to(torch.int64)


def pack_records(color_bits: int, addr, pcolor):
    """(addr, color) -> one u32 record (as int64) per plotted sample."""
    return (addr << color_bits) | quantize_color(color_bits, pcolor)


def unpack_records(color_bits: int, palette_hi, packed):
    """Packed records -> (addr (int64), rgba (..., 4)).  A 4-column
    palette carries its own density column; a 3-column one gets
    density 1 appended."""
    addr = packed >> color_bits
    q = packed & ((1 << color_bits) - 1)
    rgb = palette_hi[q]
    if palette_hi.shape[-1] == 4:
        return addr, rgb
    return addr, torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def expand_palette(palette, color_bits: int):
    """Resample the (256, 3) palette to 2^color_bits entries with the
    same linear interpolation _palette_rgb applies.  The coordinates
    are i * float32(1 / (n - 1)) with an exact 1.0 at the end: the
    values XLA's compiled linspace gives the JAX package, which keeps
    the resampled palettes of the two packages bit-identical."""
    n = 1 << color_bits
    coords = torch.arange(n - 1, dtype=torch.float32,
                          device=palette.device) \
        * float(np.float32(1.0 / (n - 1)))
    coords = torch.cat([coords, coords.new_ones((1,))])
    return _palette_rgb(palette, coords)


def opacity_bits_for(n_bins: int, n_xforms: int):
    """(op_bits, color_bits) for the opacity-extended packed record
    `addr << (ob+cb) | xform_id << cb | color`, used when per-xform
    opacities are not all 1.  (0, 0) when it does not fit 32 bits."""
    addr_bits = int(np.ceil(np.log2(n_bins + 2)))
    ob = max(1, int(np.ceil(np.log2(max(n_xforms, 2)))))
    cb = min(8, 32 - addr_bits - ob)
    return (ob, cb) if cb >= 8 else (0, 0)


def extend_palette_opacity(palette_hi, opacity, op_bits: int):
    """(2^cb, 3) palette + (N,) opacities -> (2^(ob+cb), 4) extended
    palette: row (xf << cb | q) = [rgb*op_xf, op_xf]; rows for xform
    ids >= N are zero."""
    k = palette_hi.shape[0]
    pal4 = torch.cat([palette_hi, palette_hi.new_ones((k, 1))], dim=1)
    n_slots = 1 << op_bits
    op = palette_hi.new_zeros((n_slots,))
    op[:opacity.shape[0]] = torch.clamp(opacity, 0.0, 1.0)
    return (op[:, None, None] * pal4[None]).reshape(n_slots * k, 4)


def _mul32(a, m: int):
    """(a * m) mod 2^32 for a in [0, 2^32) without int64 overflow:
    the multiplier is split into 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def respawn_xy(bits):
    """Badvalue respawn position, uniform in the bi-unit square: two
    independent murmur-style hashes of the selection draw's word."""
    h1 = _mul32(bits, 0x9E3779B9)
    h1 = h1 ^ (h1 >> 15)
    h2 = _mul32(bits ^ 0x5BD1E995, 0xC2B2AE35)
    h2 = h2 ^ (h2 >> 13)
    rx = (h1 >> 8).to(torch.float32) * _INV24 * 2.0 - 1.0
    ry = (h2 >> 8).to(torch.float32) * _INV24 * 2.0 - 1.0
    return rx, ry


def iterate_step(key: StructureKey, cam: CameraSpec, fuse: int, params,
                 cdf_rows, ppu, state: IterState, table=None):
    """One chaos-game iteration for every trajectory.

    Returns (new_state, addr (B,) int64, pcolor (B,), opacity (B,));
    non-plottable points carry the junk-bin address.  `table` is the
    loop-invariant `build_xform_table` result (built here when None)."""
    if table is None:
        table = build_xform_table(key, params)
    stream = rng_mod.RngStream(state.rng)
    bits = stream.bits()
    u = (bits >> 8).to(torch.float32) * _INV24
    idx, prow = select_and_fetch(key, cdf_rows, table, state.last_xf, u)

    nx, ny, ncolor, opacity = apply_xforms(
        key, params, prow, state.x, state.y, state.color, stream)

    bad = ~(torch.isfinite(nx) & torch.isfinite(ny)) \
        | (torch.abs(nx) > BADVALUE_LIMIT) \
        | (torch.abs(ny) > BADVALUE_LIMIT)
    rx, ry = respawn_xy(bits)
    nx = torch.where(bad, rx, nx)
    ny = torch.where(bad, ry, ny)
    ncolor = torch.where(bad, u, ncolor)
    age = torch.where(bad, 0, state.age + 1)

    # plot (display-only final xform on a copy)
    px, py, pcolor = apply_final_xform(key, params, nx, ny, ncolor,
                                       stream)
    if key.cam_mode:
        if key.cam_mode >= 2:
            px, py = project_3d(params.cam3d, px, py,
                                stream.uniform(), stream.uniform())
        else:
            px, py = project_3d(params.cam3d, px, py)
    addr, in_bounds = project(cam, params.center, ppu, params.rotate,
                              px, py, rot_center=params.rot_center)
    visible = (age >= fuse) & in_bounds & (opacity > 0.0)
    addr = torch.where(visible, addr, cam.junk_bin)

    new_state = IterState(x=nx, y=ny, color=ncolor, last_xf=idx,
                          age=age, rng=stream.state)
    return new_state, addr, pcolor, opacity


# the flush of each packed backend of hist_mod.BACKENDS (ops/flush.py);
# the others accumulate unpacked (addr, rgba) rows
PACKED_FLUSHES = {
    "pallas": flush_mod.accumulate_packed,
    "pallas_merged": flush_mod.accumulate_merged,
    "pallas_win": flush_mod.accumulate_windowed,
    "pallas_rgb16": flush_mod.accumulate_windowed_rgb16,
    "atomic": flush_mod.accumulate_packed,
}


def record_bits(key: StructureKey, cam: CameraSpec, backend: str,
                op_bits: int = 0):
    """(color bits, total bits below the address) of the packed
    records: the opacity-extended split when op_bits, else
    color_bits_for, capped at the backend's `color_bits` (8 for the
    windowed flushes and `atomic`)."""
    if op_bits:
        _ob, cbits = opacity_bits_for(cam.layout_bins, key.n_xforms)
        return cbits, op_bits + cbits
    cbits = color_bits_for(cam.layout_bins)
    cap = hist_mod.get_backend(backend).color_bits
    if cap and cbits:
        cbits = min(cbits, cap)
    return cbits, cbits


# -- a chunk of steps: the kernel on the card, the eager loop on the CPU ------

def iterate_records(plan: chaos.ChaosPlan, state: IterState,
                    recs: torch.Tensor) -> IterState:
    """Advance every trajectory recs.shape[0] steps of `plan`, filling
    recs ((n_iters, B) int64) with each step's packed records
    (addr << tot_bits | colour, the xform id spliced in under op_bits).
    Returns the new state.  A CUDA tensor launches chaos_iterate once;
    a CPU tensor runs the plain version."""
    if recs.device.type == "cpu":
        return iterate_records_reference(plan, state, recs)
    return chaos.launch_records(plan, state, recs)


def iterate_full(plan: chaos.ChaosPlan, state: IterState, n_iters: int):
    """Advance every trajectory n_iters steps with the unpacked path's
    outputs: (new_state, addr (n_iters, B) int64, pcolor and opacity
    (n_iters, B) float32), opacity unclipped.  One chaos_iterate launch
    on a CUDA tensor; the plain version on a CPU tensor."""
    if state.x.device.type == "cpu":
        return iterate_full_reference(plan, state, n_iters)
    return chaos.launch_full(plan, state, n_iters)


def iterate_records_reference(plan: chaos.ChaosPlan, state: IterState,
                              recs: torch.Tensor) -> IterState:
    """iterate_records by one eager iterate_step a step, on any
    device: the kernel's plain version."""
    for k in range(recs.shape[0]):
        state, addr, pcolor, _op = _plan_step(plan, state)
        rec = (addr << plan.tot_bits) | quantize_color(plan.cbits, pcolor)
        if plan.op_bits:
            # the selected xform id splices between address and color
            rec = rec | (state.last_xf << plan.cbits)
        recs[k] = rec
    return state


def iterate_full_reference(plan: chaos.ChaosPlan, state: IterState,
                           n_iters: int):
    """iterate_full by one eager iterate_step a step, on any device."""
    addr, pcolor, opacity = chaos.full_outputs(state, n_iters)
    for k in range(n_iters):
        state, addr[k], pcolor[k], opacity[k] = _plan_step(plan, state)
    return state, addr, pcolor, opacity


def _plan_step(plan: chaos.ChaosPlan, state: IterState):
    return iterate_step(plan.key, plan.cam, plan.fuse, plan.params,
                        plan.cdf_rows, plan.ppu, state, table=plan.table)


def iterate_chunk(key: StructureKey, cam: CameraSpec, params, cdf_rows,
                  state: IterState, ppu, n_iters: int, fuse: int,
                  table=None):
    """Advance every trajectory n_iters steps, collecting full records.

    Returns (new_state, addr (n_iters, B) int64, rgba (n_iters, B, 4)
    float32): opacity clipped to [0, 1], rgb the palette colour times
    it, density the opacity.  n_iters x B records of 24 bytes each: the
    unpacked path's flush, for frames whose packed records do not fit
    32 bits.  One chaos_iterate launch on a CUDA tensor."""
    return _full_records(
        chaos.plan(key, cam, params, cdf_rows, ppu, fuse, table=table),
        state, n_iters)


def _full_records(plan: chaos.ChaosPlan, state: IterState, n_iters: int):
    """iterate_chunk on a plan: the steps' addresses, palette
    coordinates and opacities, then their rgba in one pass."""
    state, addrs, pcolor, opacity = iterate_full(plan, state, n_iters)
    opacity = torch.clamp(opacity, 0.0, 1.0)
    rgbas = torch.cat([_palette_rgb(plan.params.palette, pcolor)
                       * opacity[..., None], opacity[..., None]], dim=-1)
    return state, addrs, rgbas


def iterate_accumulate(key: StructureKey, cam: CameraSpec, backend: str,
                       params, cdf_rows, state: IterState, hist, ppu,
                       n_chunks: int, iters_per_flush: int, fuse: int,
                       op_bits: int = 0, weight=None, packed: bool = True):
    """Advance n_chunks * iters_per_flush steps, flushing packed
    records into `hist` (updated in place) once per chunk.

    `weight` (a Python float, default 1) scales every record's
    contribution: the temporal-filter weight of this genome evaluation
    within the shutter interval.  It reaches the CUDA flushes as a
    kernel argument, so a tensor here would cost a device sync per
    flush.  The plotted count stays unweighted.

    `backend` names an entry of hist_mod.BACKENDS: a packed-record flush
    of ops/flush.py (PACKED_FLUSHES; a `split` one on the layout of
    hist_alloc_for) or an ops/histogram.py backend on unpacked rows.
    `op_bits` enables the opacity-extended record.

    With `packed=False`, or where `record_bits` leaves no colour bits
    (the address takes more than 24 bits), each chunk is
    `iterate_chunk`'s full (addr, rgba) records, scattered through the
    ops/histogram.py backend; a packed-record flush raises ValueError
    there, as in the JAX package.  Returns (new_state, hist, plotted)
    with plotted a float32 device scalar, as the JAX counterpart's f32
    counter.

    On the card, for the backends whose flush is the unsorted packed one
    (`c_loop`), one C call queues every chunk
    (`chaos.launch_accumulate`, a `loop` span; COUNTS["looped_chunks"]).
    Every other backend, the unpacked path and the CPU run the Python
    loop (_chunk_loop)."""
    spec = hist_mod.get_backend(backend)
    cbits, tot_bits = (record_bits(key, cam, backend, op_bits) if packed
                       else (0, 0))
    if spec.packed and not cbits:
        raise ValueError("pallas backend requires packed records "
                         "(<= 2^24 bins; see opacity_bits_for)")

    def scatter(hist, addrs, rgbas):
        return spec.accumulate(
            hist, addrs, rgbas if weight is None else rgbas * weight)

    if not cbits:
        plan = chaos.plan(key, cam, params, cdf_rows, ppu, fuse)

        def full_chunk(state, hist):
            state, addrs, rgbas = _full_records(plan, state,
                                                iters_per_flush)
            return state, scatter(hist, addrs, rgbas), addrs
        return _chunk_loop(full_chunk, state, hist, n_chunks,
                           iters_per_flush, 0, cam.junk_bin)
    if spec.packed:
        flush = PACKED_FLUSHES[backend]
    else:
        def flush(hist, recs, palette_hi, n_bins, bits, weight=None):
            return scatter(hist, *unpack_records(bits, palette_hi, recs))

    palette_hi = expand_palette(params.palette, cbits)
    if op_bits:
        palette_hi = extend_palette_opacity(palette_hi, params.opacity,
                                            op_bits)
    plan = chaos.plan(key, cam, params, cdf_rows, ppu, fuse, cbits,
                      tot_bits, op_bits)
    recs = torch.empty((iters_per_flush, state.x.shape[0]),
                       dtype=torch.int64, device=state.x.device)
    if n_chunks and takes_c_loop(backend, recs.device):
        with trace.span("loop"):
            state, plotted = chaos.launch_accumulate(
                plan, state, recs, hist, palette_hi, n_chunks, weight)
        trace.COUNTS["looped_chunks"] += n_chunks
        _count_chunks(n_chunks, recs.numel())
        return state, hist, plotted

    def packed_chunk(state, hist):
        state = iterate_records(plan, state, recs)
        return state, flush(hist, recs, palette_hi, cam.n_bins, tot_bits,
                            weight), recs
    return _chunk_loop(packed_chunk, state, hist, n_chunks, iters_per_flush,
                       tot_bits, cam.junk_bin)


def takes_c_loop(backend: str, device) -> bool:
    """Whether iterate_accumulate queues its chunks from one C call
    rather than its Python loop: on the card, for a `c_loop` backend.
    A caller that needs the Python loop, to see each chunk's records
    through a wrapped PACKED_FLUSHES entry, patches this to False."""
    return hist_mod.get_backend(backend).c_loop and \
        torch.device(device).type == "cuda"


def _count_chunks(n_chunks: int, records_a_chunk: int) -> None:
    trace.COUNTS["chunks"] += n_chunks
    trace.COUNTS["records"] += n_chunks * records_a_chunk


def _chunk_loop(chunk, state: IterState, hist, n_chunks: int,
                iters_per_flush: int, shift: int, junk_bin: int):
    """iterate_accumulate's Python loop: n_chunks calls of `chunk(state,
    hist)` -> (state, hist, the chunk's records), whose addresses are
    `records >> shift`.  Each chunk a `chunk` span and its plotted
    count a `count` span, exact in int64; the running total is f32."""
    plotted = torch.zeros((), dtype=torch.float32, device=state.x.device)
    for _ in range(n_chunks):
        with trace.span("chunk"):
            state, hist, recs = chunk(state, hist)
            with trace.span("count"):
                addrs = recs >> shift if shift else recs
                plotted = plotted + (addrs != junk_bin).sum() \
                    .to(torch.float32)
    _count_chunks(n_chunks, iters_per_flush * state.x.shape[0])
    return state, hist, plotted


def iterate_accumulate_temporal(key: StructureKey, cam: CameraSpec,
                                backend: str, params_T,
                                state: IterState, hist, ppu_T,
                                n_chunks_per_sample: int,
                                iters_per_flush: int, fuse: int,
                                weights_T=None, op_bits: int = 0,
                                packed: bool = True):
    """Accumulate the T temporal samples of a motion-blurred frame into
    `hist` (updated in place), sample after sample.

    `params_T` is `PackedGenome.eval_params`' result (every leaf with a
    leading T axis) and `ppu_T` the (T,) scale; each sample builds its
    selection CDF, palette and xform table anew.  Trajectories carry
    over between samples (the attractor moves smoothly within a shutter
    interval; no re-fuse).  `weights_T` are the temporal filter's
    weights as Python floats (render.temporal_filter_weights): sample
    k's contribution is scaled by weights_T[k].  `pallas_rgb16` rounds
    its rgb to bf16 once per touched bin per flush, whether a frame
    has T flush groups or one (the JAX package's contract too).
    `packed` is iterate_accumulate's.  Returns (new_state, hist,
    plotted), plotted unweighted.  Each sample is a `sample` span."""
    n_samples = ppu_T.shape[0]
    if weights_T is None:
        weights_T = [None] * n_samples
    plotted = torch.zeros((), dtype=torch.float32, device=state.x.device)
    for k in range(n_samples):
        with trace.span("sample"):
            params_k = sample_params(params_T, k)
            state, hist, n = iterate_accumulate(
                key, cam, backend, params_k, xform_cdf_rows(params_k),
                state, hist, ppu_T[k], n_chunks_per_sample,
                iters_per_flush, fuse, op_bits=op_bits,
                weight=weights_T[k], packed=packed)
            plotted = plotted + n
    return state, hist, plotted

