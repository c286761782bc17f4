"""The chaos game as one hand-written CUDA kernel: plan and launch.

Port of the fused chaos-game Pallas kernel (`bench/fusedprobe.py`
`kernel`: `iterate_step` for T steps on resident state, a (T, B) log
of packed records).  `csrc/chaos_iterate.cu` advances every trajectory
n_iters steps in one launch, one thread a trajectory, and writes one
record a step: the packed record that the flushes read
(`launch_records`), or the address, palette coordinate and opacity of
the unpacked path (`launch_full`).  Both take CUDA tensors only and
raise on anything else.  `ops/iterate.py` owns the dispatch
(`iterate_records`, `iterate_full`): the launch on a CUDA tensor, and
on a CPU tensor the plain version, its eager `iterate_step` loop.

The kernel is compiled per structure key: `key_defines` turns a
`StructureKey` (the union's variations in key order and their knob
offsets, the final xform's, has_post, has_xaos, cam_mode, n_xforms)
into `-D` definitions of `csrc/chaos_iterate.cu`, and `load(key)`
builds (at its first use in the checkout, into `_build/`) and loads that
key's library; two genomes with equal keys share it.  Without a key the
same source is the generic library, which holds `chaos_variation` (one
variation at n points, for the tests) and no chaos game: nothing falls
back to an interpreted genome, and a key whose build fails raises with
nvcc's output.  Callers that know their key load it before any timed
work (`Renderer.__init__`, the tuner).

A launch reads one `ChaosArgs` struct, passed by value: the state and
output tensors and the genome evaluation's tensors as pointers, and the
camera and record layout as ints.  Nothing in it is read back from the
device, so a chunk costs no sync.  `plan` gathers a genome evaluation's
tensors once per sample.

`launch_accumulate` queues a whole accumulation from one C call
(`chaos_accumulate`): every chunk's chaos_iterate launch and, through a
pointer to its C entry, scatter_flush.cu's counting `packed_flush`, the
state ping-ponging between two buffers, then one single-thread
`plotted_fold` launch for the float32 plotted total.  No torch
operation runs per chunk.  `LAUNCHES` counts kernel launches in this
process; callers reset it to count a run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from cuburn_tpu_torch.genome.specs import StructureKey
from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS
from cuburn_tpu_torch.kernels import build as _build
from cuburn_tpu_torch.ops import flush as flush_mod
from cuburn_tpu_torch.ops.camera import CameraSpec
from cuburn_tpu_torch.ops.xform import build_xform_table

LIBRARY = "chaos_iterate"
LAUNCHES = {"chaos_iterate": 0, "plotted_fold": 0}

# the registry's size
MAX_VARS = 100
# ChaosArgs.scal: the final xform's affine (6) and post (6), colour and
# speed, center (2), rot_center (2), ppu, rotate, cam3d (5); the final
# xform's weights and knobs follow
SCAL_FIXED = 25

# ops/iterate.IterState's tensors, in ChaosArgs's order
STATE_FIELDS = ("x", "y", "color", "last_xf", "age", "rng")

_P, _I = ctypes.c_void_p, ctypes.c_int


class ChaosArgs(ctypes.Structure):
    """csrc/chaos_iterate.cu's ChaosArgs, field for field: what stays
    run-time (the key is compiled in)."""
    _fields_ = [(name, _P) for name in (
        *STATE_FIELDS, *(f + "_out" for f in STATE_FIELDS), "rec", "pcolor",
        "opacity", "table", "cdf", "scal")] + [(name, _I) for name in (
            "batch", "n_iters", "no_rotation", "ss", "acc_width",
            "acc_height", "full_acc_height", "tile_row0", "junk_bin", "fuse",
            "cbits", "tot_bits", "op_bits", "unpacked")]


class StateBuf(ctypes.Structure):
    """csrc/chaos_iterate.cu's StateBuf: an IterState's tensors as
    pointers, in STATE_FIELDS order."""
    _fields_ = [(name, _P) for name in STATE_FIELDS]


class VariationArgs(ctypes.Structure):
    """csrc/chaos_iterate.cu's VariationArgs: one variation at n points
    (chaos_variation, for the tests)."""
    _fields_ = [(name, _P) for name in (
        "tx", "ty", "w", "params", "aff", "rng", "dx", "dy")] + [
        ("n", _I), ("id", _I)]


@dataclass
class ChaosPlan:
    """What every chunk of one genome evaluation's chaos game reads:
    the step's inputs (as `iterate_step` takes them), the record layout,
    and the tensors the kernel reads: `table` (build_xform_table) and
    `scal` (the final xform's and the camera's floats, SCAL_FIXED
    layout)."""
    key: StructureKey
    cam: CameraSpec
    params: object
    cdf_rows: torch.Tensor
    ppu: torch.Tensor
    fuse: int
    cbits: int
    tot_bits: int
    op_bits: int
    table: torch.Tensor
    scal: torch.Tensor


def plan(key: StructureKey, cam: CameraSpec, params, cdf_rows, ppu,
         fuse: int, cbits: int = 0, tot_bits: int = 0, op_bits: int = 0,
         table=None) -> ChaosPlan:
    """The ChaosPlan of one genome evaluation; `table` is reused when
    given.  Device ops only: a handful of small copies."""
    if table is None:
        table = build_xform_table(key, params)
    dev = table.device
    ppu = torch.as_tensor(ppu, dtype=torch.float32, device=dev)
    scal = torch.cat([t.reshape(-1).to(torch.float32) for t in (
        params.final_affine, params.final_post, params.final_color,
        params.final_color_speed, params.center, params.rot_center, ppu,
        params.rotate, params.cam3d, params.final_var_weights,
        params.final_var_params)])
    return ChaosPlan(key=key, cam=cam, params=params,
                     cdf_rows=cdf_rows.contiguous(), ppu=ppu, fuse=fuse,
                     cbits=cbits, tot_bits=tot_bits, op_bits=op_bits,
                     table=table.contiguous(), scal=scal)


# -- the key's library --------------------------------------------------------

def _knob_offsets(names) -> list:
    """The offset of each variation's first knob in the param_slots
    packing of `names`, in order."""
    offsets, off = [], 0
    for name in names:
        if name not in VARIATION_PARAMS:
            raise ValueError(f"{LIBRARY} has no variation {name!r}")
        offsets.append(off)
        off += len(VARIATION_PARAMS[name])
    return offsets


def table_cols(key: StructureKey) -> int:
    """Columns of build_xform_table for `key`: affine, colour, speed,
    opacity, the post affine under has_post, the union's weights and
    its knobs (one column when it has none)."""
    return (15 if key.has_post else 9) + len(key.variations) + \
        max(len(key.param_slots), 1)


@functools.lru_cache(maxsize=None)
def key_defines(key: StructureKey) -> tuple:
    """The -D definitions that compile csrc/chaos_iterate.cu for `key`:
    the union's and the final xform's variations as V(name) lists in
    key order, their knob offsets as O(n) lists (no commas: nvcc splits
    a -D value at its commas), and the key's flags and counts."""
    def lists(names):
        return ("".join(f"V({n})" for n in names),
                "".join(f"O({o})" for o in _knob_offsets(names)))
    u_vars, u_pars = lists(key.variations)
    f_vars, f_pars = lists(key.final_variations or ())
    return ("CHAOS_KEY", f"CHAOS_N_XFORMS={key.n_xforms}",
            f"CHAOS_N_COLS={table_cols(key)}",
            f"CHAOS_HAS_POST={int(key.has_post)}",
            f"CHAOS_HAS_XAOS={int(key.has_xaos)}",
            f"CHAOS_CAM_MODE={key.cam_mode}",
            f"CHAOS_VARS={u_vars}", f"CHAOS_VAR_PARS={u_pars}",
            f"CHAOS_HAS_FINAL={int(key.final_variations is not None)}",
            f"CHAOS_FINAL_HAS_POST={int(key.final_has_post)}",
            f"CHAOS_FINAL_VARS={f_vars}", f"CHAOS_FINAL_PARS={f_pars}")


def library_path(key: StructureKey | None = None):
    """Where `key`'s library (the generic one without a key) is built."""
    return _build.library_path(LIBRARY, key_defines(key) if key else ())


def load(key: StructureKey | None = None) -> ctypes.CDLL:
    """Build (if needed) and load `key`'s library, whose chaos_iterate
    runs that key's chaos game; without a key, the generic library of
    chaos_variation.  Raises with nvcc's output if the build fails."""
    if key is None:
        return _checked(_build.load(LIBRARY))
    return _checked(_build.load(LIBRARY, key_defines(key)))


_CHECKED: set = set()


def _checked(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib`, once its registry size and its ChaosArgs are this
    module's."""
    if lib not in _CHECKED:
        n = lib.chaos_variation_count()
        if n != MAX_VARS or lib.chaos_args_size() != \
                ctypes.sizeof(ChaosArgs):
            raise RuntimeError(
                f"{LIBRARY}: {n} variations and a {lib.chaos_args_size()}"
                f"-byte ChaosArgs; ops/chaos.py has {MAX_VARS} and "
                f"{ctypes.sizeof(ChaosArgs)}")
        _CHECKED.add(lib)
    return lib


# -- the launch -------------------------------------------------------------


def full_outputs(state, n_iters: int):
    """Empty (addr int64, pcolor f32, opacity f32) logs of n_iters steps
    of `state`'s lanes."""
    batch, dev = state.x.shape[0], state.x.device
    return (torch.empty((n_iters, batch), dtype=torch.int64, device=dev),
            torch.empty((n_iters, batch), dtype=torch.float32, device=dev),
            torch.empty((n_iters, batch), dtype=torch.float32, device=dev))


def empty_state(state):
    """An IterState of empty tensors shaped like `state`'s."""
    return dataclasses.replace(state, **{
        f: torch.empty_like(getattr(state, f)) for f in STATE_FIELDS})


_IDS: dict = {}


def variation_ids(lib: ctypes.CDLL) -> dict:
    """{variation name: its id in the library's registry}, read from the
    library itself; checks that its ChaosArgs is this module's."""
    ids = _IDS.get(lib)
    if ids is None:
        _checked(lib)
        lib.chaos_variation_name.restype = ctypes.c_char_p
        lib.chaos_variation_name.argtypes = (ctypes.c_int,)
        ids = {lib.chaos_variation_name(i).decode(): i
               for i in range(MAX_VARS)}
        _IDS[lib] = ids
    return ids


def _check(t: torch.Tensor, dtype, shape, dev, what: str) -> int:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"{LIBRARY}: {what} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def chaos_args(lib: ctypes.CDLL, p: ChaosPlan, state,
               new, rec, pcolor=None,
               opacity=None) -> ChaosArgs:
    """The ChaosArgs of one launch of `lib`'s chaos_iterate (the library
    of p.key): from `state` into `new` (tensors of the same shapes),
    records into `rec` ((n_iters, B) int64), and with `pcolor` and
    `opacity` the unpacked path's outputs.  Checks every tensor."""
    _checked(lib)
    key, cam = p.key, p.cam
    dev = state.x.device
    batch, n_iters = state.x.shape[0], rec.shape[0]
    a = ChaosArgs()
    f32, i64 = torch.float32, torch.int64
    for st, suffix in ((state, ""), (new, "_out")):
        for name, dtype, shape in (
                ("x", f32, (batch,)), ("y", f32, (batch,)),
                ("color", f32, (batch,)), ("last_xf", i64, (batch,)),
                ("age", i64, (batch,)), ("rng", i64, (batch, 4))):
            setattr(a, name + suffix, _check(getattr(st, name), dtype,
                                             shape, dev, name + suffix))
    a.rec = _check(rec, i64, (n_iters, batch), dev, "rec")
    a.unpacked = int(pcolor is not None)
    if a.unpacked:
        a.pcolor = _check(pcolor, f32, (n_iters, batch), dev, "pcolor")
        a.opacity = _check(opacity, f32, (n_iters, batch), dev, "opacity")
    n_x = key.n_xforms
    a.table = _check(p.table, f32, (n_x, table_cols(key)), dev, "table")
    a.cdf = _check(p.cdf_rows, f32, (n_x, n_x), dev, "cdf_rows")
    # the final xform's weights and knobs as the kernel reads them
    n_final = len(key.final_variations or ())
    if n_final and p.params.final_var_weights.numel() != n_final:
        raise ValueError(f"{LIBRARY}: {p.params.final_var_weights.numel()} "
                         f"final weights for {n_final} final variations")
    a.scal = _check(p.scal, f32, p.scal.shape, dev, "scal")
    a.batch, a.n_iters = batch, n_iters
    a.no_rotation = int(cam.no_rotation)
    a.ss, a.acc_width, a.acc_height = cam.ss, cam.acc_width, cam.acc_height
    a.full_acc_height, a.tile_row0 = cam.full_acc_height, cam.tile_row0
    a.junk_bin, a.fuse = cam.junk_bin, p.fuse
    a.cbits, a.tot_bits, a.op_bits = p.cbits, p.tot_bits, p.op_bits
    a.keep = (p, state, new, rec, pcolor, opacity)    # the pointers' owners
    return a


def launch_records(p: ChaosPlan, state, recs: torch.Tensor):
    """Advance every trajectory recs.shape[0] steps in one chaos_iterate
    launch, filling recs ((n_iters, B) int64) with each step's packed
    records (addr << tot_bits | colour, the xform id spliced in under
    op_bits).  Returns the new state."""
    new = empty_state(state)
    _launch(p, state, new, recs)
    return new


def launch_full(p: ChaosPlan, state, n_iters: int):
    """Advance every trajectory n_iters steps in one chaos_iterate
    launch with the unpacked path's outputs: (new_state, addr (n_iters,
    B) int64, pcolor and opacity (n_iters, B) float32), opacity
    unclipped."""
    new = empty_state(state)
    addr, pcolor, opacity = full_outputs(state, n_iters)
    _launch(p, state, new, addr, pcolor, opacity)
    return new, addr, pcolor, opacity


def _launch(p: ChaosPlan, state, new, rec, pcolor=None,
            opacity=None) -> None:
    if rec.device.type != "cuda":
        raise ValueError(f"{LIBRARY}: the kernel runs on CUDA tensors; "
                         f"got one on {rec.device}")
    args = chaos_args(load(p.key), p, state, new, rec, pcolor, opacity)
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    _build.launch(LAUNCHES, "chaos_iterate", LIBRARY, "chaos_iterate",
                  (_P,), stream, ctypes.addressof(args),
                  defines=key_defines(p.key))


def accumulate_call(lib: ctypes.CDLL, p: ChaosPlan, state, recs,
                    n_chunks: int, flush_fn: int, pal4, n_bins: int,
                    weight: float, hist, stream):
    """One call of `lib`'s chaos_accumulate: n_chunks chunks of p's chaos
    game from `state` (never written), each writing recs ((n_iters, B)
    int64) and flushed by the C function at `flush_fn` (csrc/
    chaos_iterate.cu TallyFlush) into hist with the palette rows pal4,
    then the plotted counts folded.  Returns (new state, plotted (a
    float32 scalar), the chunks' int64 counts).  Raises on a non-zero
    return, before anything is counted."""
    bufs = (empty_state(state), empty_state(state))
    dev = state.x.device
    counts = torch.zeros((n_chunks,), dtype=torch.int64, device=dev)
    plotted = torch.empty((), dtype=torch.float32, device=dev)
    args = chaos_args(lib, p, state, bufs[0], recs)
    spare = StateBuf(*(getattr(bufs[1], f).data_ptr()
                       for f in STATE_FIELDS))
    fn = _build.typed_entry(lib, "chaos_accumulate", (
        _P, _P, _I, _P, _P, ctypes.c_int64, ctypes.c_float, _P, _P, _P))
    err = fn(ctypes.addressof(args), ctypes.addressof(spare), n_chunks,
             flush_fn, pal4.data_ptr(), n_bins, weight, hist.data_ptr(),
             counts.data_ptr(), plotted.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"chaos_accumulate failed: CUDA error {err}")
    # chunk k writes bufs[k % 2]; no chunk leaves the state as it was
    new = bufs[(n_chunks - 1) % 2] if n_chunks else state
    return new, plotted, counts


def launch_accumulate(p: ChaosPlan, state, recs, hist, palette_hi,
                      n_chunks: int, weight=None):
    """accumulate_call on the card with p.key's library on the current
    stream: n_chunks chunks of p's chaos game from `state` (never
    written) into recs, each flushed by scatter_flush.cu's counting
    packed flush into hist with the palette palette_hi at `weight`
    (default 1).  Counts the launches the call makes: n_chunks
    chaos_iterate, n_chunks packed_flush (ops/flush.py's LAUNCHES; none
    where a chunk holds no record) and one plotted_fold.  Returns (new
    state, plotted, a float32 scalar)."""
    flush_fn, pal4 = flush_mod.looped_flush(hist, recs, palette_hi,
                                            p.cam.n_bins, p.tot_bits)
    stream = torch.cuda.current_stream(recs.device).cuda_stream
    new, plotted, _counts = accumulate_call(
        load(p.key), p, state, recs, n_chunks, flush_fn, pal4,
        p.cam.n_bins, flush_mod._weight(weight), hist, stream)
    LAUNCHES["chaos_iterate"] += n_chunks
    if recs.numel():
        flush_mod.LAUNCHES["packed_flush"] += n_chunks
    LAUNCHES["plotted_fold"] += 1
    return new, plotted


def variation_args(lib: ctypes.CDLL, name: str, tx, ty, w, params, aff,
                   rng, dx, dy) -> VariationArgs:
    """The VariationArgs of the generic library's chaos_variation
    (`lib`, `load()`): variation `name` at
    the points (tx, ty) with per-point weights `w`, its knobs `params`
    and the affine `aff` (6,), its draws advancing `rng` ((n, 4) int64)
    in place, into dx and dy.  Every tensor on one device."""
    n, dev, f32 = tx.shape[0], tx.device, torch.float32
    a = VariationArgs(n=n, id=variation_ids(lib)[name])
    for field, t, dtype, shape in (
            ("tx", tx, f32, (n,)), ("ty", ty, f32, (n,)),
            ("w", w, f32, (n,)),
            ("params", params, f32, (len(VARIATION_PARAMS[name]) or 1,)),
            ("aff", aff, f32, (6,)), ("rng", rng, torch.int64, (n, 4)),
            ("dx", dx, f32, (n,)), ("dy", dy, f32, (n,))):
        setattr(a, field, _check(t, dtype, shape, dev, field))
    a.keep = (tx, ty, w, params, aff, rng, dx, dy)    # the pointers' owners
    return a
