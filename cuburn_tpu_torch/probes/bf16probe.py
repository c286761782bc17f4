"""The rgb16 stage path's silicon probe on the card: bf16 staging through
shared memory, and the write-back skeleton of the split flush.

Port of `bench/bf16probe.py`.  Its Pallas kernels become two CUDA
kernels of `csrc/bf16_probe.cu` on Hopper's bulk-copy engine:

- `roundtrip(x, variant)` stages a (3, rows, 128) array through shared
  memory and back: "multi" copies the three planes at once, "per_plane"
  one at a time (both bf16, converted bf16 -> f32 -> bf16 on the way,
  which is the identity), "f32" is the all-f32 control.
- `skeleton(dens, rgb, add, perm, rbg)` updates density (1, rows, 128)
  f32 and rgb (3, rows, 128) bf16 in place, as the aliased TPU call
  does.  Grid step i visits block rbg[perm[i]] of BR rows: the first
  visit of a run loads the block, every visit adds `add` (4, BR, 128)
  in float32, the last rounds rgb to bf16 once and stores it.

The skeleton takes schedules whose visits of each block form one
contiguous run, as the rgb16 flush's group permutation guarantees.  On
a schedule that comes back to a block the TPU's two executions differ
(interpret mode reloads the pre-call input at each first visit, the
aliased buffer on the chip gives the second run the first one's
result), so `schedule` refuses it on every device instead of picking
one.

On a CUDA tensor each wrapper makes one launch, or raises; on a CPU
tensor it runs its plain version (`roundtrip_reference`,
`skeleton_reference`).  `LAUNCHES` counts kernel launches in this
process.  `python -m cuburn_tpu_torch.probes.bf16probe [--skeleton]`
runs the probe on the card; `--cpu` runs the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from cuburn_tpu_torch.device import resolve_device
from cuburn_tpu_torch.kernels import build as _build

BR = 256      # block rows, as in bench/bf16probe.py (csrc kBlockRows)
NB = 4        # blocks of the probe's arrays

LIBRARY = "bf16_probe"
LAUNCHES = {"bf16_roundtrip": 0, "rgb16_skeleton": 0}
# variant -> (csrc Variant, dtype, the TPU probe's name for it)
VARIANTS = {
    "multi": (0, torch.bfloat16, "bf16 3-plane slice DMA"),
    "per_plane": (1, torch.bfloat16, "bf16 per-plane DMA"),
    "f32": (2, torch.float32, "f32 3-plane control"),
}
SKELETON_VISITS = 3
# csrc kRoundRows and kRoundStages: the rows of a roundtrip tile and the
# tiles of a block's ring in shared memory (96 KB in bf16, 192 KB in
# f32, so one persistent block a SM)
ROUND_ROWS = 32
ROUND_STAGES = 4
# the bulk copies' alignment, in bytes
ALIGN = 16
# ~6 ms at the H100's clocks: the head start the host gets before a
# device timing starts
_SLEEP_CYCLES = 10_000_000
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
CONTRACT = ("the rgb16 skeleton takes schedules whose visits of each "
            "block form one contiguous run in perm order")


def _check_planes(t, planes, dtype, what, rows=None):
    """A contiguous (planes, rows, 128) `dtype` tensor; returns rows."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what}: expected a tensor, got {type(t)}")
    ok = (t.dtype == dtype and t.dim() == 3 and t.shape[0] == planes
          and t.shape[2] == 128 and t.shape[1] >= 1 and t.is_contiguous()
          and (rows is None or t.shape[1] == rows))
    if not ok:
        want = "rows" if rows is None else rows
        raise ValueError(f"{what}: expected a contiguous ({planes}, {want}, "
                         f"128) {dtype} tensor, got {tuple(t.shape)} "
                         f"{t.dtype}{'' if t.is_contiguous() else ' strided'}")
    return t.shape[1]


def _check_variant(x, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {sorted(VARIANTS)}")
    _check_planes(x, 3, VARIANTS[variant][1], f"roundtrip({variant!r})")


def _check_cuda(entry, tensors):
    """`tensors` are CUDA tensors of one device, each 16-byte aligned
    for the bulk copies; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{entry}: the kernel runs on CUDA tensors of "
                             f"one device; got {t.device}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{entry}: bulk copies need {ALIGN}-byte "
                             f"aligned tensors; one starts at "
                             f"{t.data_ptr():#x}")
    return dev


def _launch(kernel, argtypes, dev, *args):
    """One launch of csrc/bf16_probe.cu's C entry `kernel` on the current
    stream of `dev`."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch(LAUNCHES, kernel, LIBRARY, kernel, argtypes, stream, *args)


def roundtrip_reference(x: torch.Tensor, variant: str) -> torch.Tensor:
    """The plain version: bf16 staged as f32 and cast back (the
    identity), the f32 control copied."""
    _check_variant(x, variant)
    if variant == "f32":
        return x.clone()
    return x.float().to(torch.bfloat16)


def roundtrip_grid(rows: int, sms: int) -> int:
    """The roundtrip's persistent blocks on a card of `sms` SMs: one a
    SM, no more than there are tiles."""
    return min(sms, -(-rows // ROUND_ROWS))


_SMS: dict = {}


def _sm_count(dev) -> int:
    """The SM count of CUDA device `dev` ("cuda" is the current one),
    asked once a device: the first ask can take milliseconds."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def roundtrip(x: torch.Tensor, variant: str) -> torch.Tensor:
    """x staged through on-chip memory and back, as a new tensor.  `x`
    is a contiguous (3, rows, 128) tensor: bf16 for "multi" and
    "per_plane", float32 for "f32".  One bf16_roundtrip launch on a
    CUDA tensor, the plain version on a CPU one."""
    _check_variant(x, variant)
    if x.device.type == "cpu":
        return roundtrip_reference(x, variant)
    out = torch.empty_like(x)
    dev = _check_cuda("bf16_roundtrip", (x, out))
    _launch("bf16_roundtrip", (_P, _P, _I64, _INT, _INT), dev, x.data_ptr(),
            out.data_ptr(), x.shape[1], VARIANTS[variant][0],
            roundtrip_grid(x.shape[1], _sm_count(dev)))
    return out


def _host_ints(a, what):
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{what}: the schedule is a host array, got a "
                             f"tensor on {a.device}")
        a = a.numpy()
    a = np.asarray(a)
    if a.ndim != 1 or a.dtype.kind not in "iu":
        raise ValueError(f"{what}: expected a 1-D integer array, got "
                         f"{a.shape} {a.dtype}")
    return a.astype(np.int64)


def schedule(perm, rbg, n_blocks: int) -> np.ndarray:
    """The block of each grid step, rbg[perm[i]], as int32, checked on
    the host: every entry names one of n_blocks blocks, and each block's
    visits form one contiguous run.  Raises ValueError otherwise."""
    perm, rbg = _host_ints(perm, "perm"), _host_ints(rbg, "rbg")
    if perm.size == 0:
        raise ValueError("the schedule visits no block")
    if ((perm < 0) | (perm >= rbg.size)).any():
        raise ValueError(f"perm indexes past rbg ({rbg.size} entries)")
    blocks = rbg[perm]
    bad = (blocks < 0) | (blocks >= n_blocks)
    if bad.any():
        raise ValueError(f"step {int(np.argmax(bad))} visits block "
                         f"{int(blocks[bad][0])}; the arrays hold "
                         f"{n_blocks} blocks of {BR} rows")
    starts = np.flatnonzero(np.r_[True, blocks[1:] != blocks[:-1]])
    runs = blocks[starts]
    seen, again = np.unique(runs, return_counts=True)
    if (again > 1).any():
        raise ValueError(f"block {int(seen[again > 1][0])} is visited again "
                         f"after another block's run: {CONTRACT}")
    return blocks.astype(np.int32)


def _check_skeleton(dens, rgb, add):
    rows = _check_planes(dens, 1, torch.float32, "dens")
    _check_planes(rgb, 3, torch.bfloat16, "rgb", rows)
    if rows % BR:
        raise ValueError(f"dens and rgb hold {rows} rows, not a multiple "
                         f"of {BR}")
    if not (isinstance(add, torch.Tensor) and add.dtype == torch.float32
            and tuple(add.shape) == (4, BR, 128) and add.is_contiguous()):
        raise ValueError("add: expected a contiguous (4, 256, 128) float32 "
                         "tensor")
    return rows // BR


def skeleton_reference(dens, rgb, add, perm, rbg):
    """The plain version, in place: the schedule in order; at a run's
    first visit acc = cat(rgb.float(), dens) of its block, at every visit
    acc = acc + add, at its last rgb = acc[:3] rounded to bf16 (to
    nearest even) and dens = acc[3].  Returns (dens, rgb)."""
    blocks = schedule(perm, rbg, _check_skeleton(dens, rgb, add)).tolist()
    acc = None
    for i, b in enumerate(blocks):
        rows = slice(b * BR, (b + 1) * BR)
        if i == 0 or blocks[i - 1] != b:
            acc = torch.cat([rgb[:, rows].float(), dens[:, rows]])
        acc = acc + add
        if i == len(blocks) - 1 or blocks[i + 1] != b:
            rgb[:, rows] = acc[:3].to(torch.bfloat16)
            dens[:, rows] = acc[3:]
    return dens, rgb


def skeleton(dens, rgb, add, perm, rbg):
    """The rgb16 write-back skeleton, in place on dens (1, rows, 128)
    float32 and rgb (3, rows, 128) bf16 (rows a multiple of BR), `add`
    (4, BR, 128) float32, the schedule `perm`, `rbg` int32 host arrays.
    The schedule is checked on the host before anything is uploaded
    (`schedule`).  One rgb16_skeleton launch on CUDA tensors, the plain
    version on CPU ones.  Returns (dens, rgb)."""
    n_blocks = _check_skeleton(dens, rgb, add)
    blocks = schedule(perm, rbg, n_blocks)
    if dens.device.type == "cpu":
        return skeleton_reference(dens, rgb, add, perm, rbg)
    dev = _check_cuda("rgb16_skeleton", (dens, rgb, add))
    # through pinned memory (PyTorch's caching host allocator), queued on
    # the stream without a sync
    sched = torch.from_numpy(blocks).pin_memory().to(dev, non_blocking=True)
    _launch("rgb16_skeleton", (_P, _P, _P, _P, _I64, _I64), dev,
            dens.data_ptr(), rgb.data_ptr(), add.data_ptr(),
            sched.data_ptr(), blocks.size, dens.shape[1])
    return dens, rgb


def _device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _call(fn, device):
    """(fn(), {"device": ..., "device_ms": ...}) for one call: on the card
    the call's time between CUDA events, the stream held back by a sleep
    kernel so that the host's launch costs drop out.  The call is cold:
    the first launch in a process also loads the library's kernels."""
    fields = {"device": _device_name(device)}
    if device.type != "cuda":
        return fn(), fields
    _build.load(LIBRARY)
    _sm_count(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    fields["device_ms"] = start.elapsed_time(end)
    return out, fields


def run(variant: str, device) -> float:
    """bench/bf16probe.py's `run` for one variant: a (3, 1024, 128) array
    from RandomState(0) staged once; prints the variant's line and
    returns its max abs error against the input."""
    rows = NB * BR
    rng = np.random.RandomState(0)
    x = rng.rand(3, rows, 128).astype(np.float32)
    _code, dtype, name = VARIANTS[variant]
    xq = torch.from_numpy(x).to(dtype).to(device)
    out, fields = _call(lambda: roundtrip(xq, variant), device)
    err = float((out.float() - xq.float()).abs().max())
    print(json.dumps({"variant": name, "max_err": err, "ok": err == 0.0,
                      **fields}), flush=True)
    return err


def run_skeleton(device) -> int:
    """bench/bf16probe.py's `run_skeleton`: NB blocks visited 3 times
    each, in contiguous runs, from RandomState(1); prints its line with
    the TPU probe's errors and tolerances and returns 0 if they hold."""
    rows = NB * BR
    visits = SKELETON_VISITS
    rng = np.random.RandomState(1)
    dens0 = rng.rand(1, rows, 128).astype(np.float32)
    rgb0_f = rng.rand(3, rows, 128).astype(np.float32)
    rgb0 = torch.from_numpy(rgb0_f).to(torch.bfloat16)
    add = rng.rand(4, BR, 128).astype(np.float32)
    perm = np.arange(NB * visits, dtype=np.int32)
    rbg = np.repeat(np.arange(NB, dtype=np.int32), visits)
    dens = torch.tensor(dens0, device=device)
    rgb = rgb0.to(device, copy=True)
    add_t = torch.tensor(add, device=device)
    (dens_new, rgb_new), fields = _call(
        lambda: skeleton(dens, rgb, add_t, perm, rbg), device)
    want_dens = dens0.reshape(NB, 1, BR, 128) + visits * add[3]
    got_dens = dens_new.cpu().numpy().reshape(NB, 1, BR, 128)
    e_d = float(np.abs(got_dens - want_dens).max())
    want_rgb = rgb0.float().numpy().reshape(3, NB, BR, 128) \
        + visits * add[:3][:, None]
    got_rgb = rgb_new.float().cpu().numpy().reshape(3, NB, BR, 128)
    e_r = float(np.abs(got_rgb - want_rgb).max())
    # bf16 rounds once at write-back: one bf16 ulp of ~8.  Density: three
    # sequential float adds against numpy's one multiply, a few ulps
    tol = 8 * 2.0 ** -8
    d_tol = 1e-5
    ok = e_d <= d_tol and e_r <= tol
    print(json.dumps({"variant": "full rgb16 skeleton", "dens_err": e_d,
                      "rgb_err": round(e_r, 5), "rgb_tol": tol, "ok": ok,
                      **fields}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skeleton", action="store_true",
                    help="run the rgb16 write-back skeleton instead of the "
                         "three staging variants")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if args.skeleton:
        return run_skeleton(device)
    print(json.dumps({"probe": "bf16-dma", "device": _device_name(device)}),
          flush=True)
    errs = [run(v, device) for v in VARIANTS]
    return 0 if all(e == 0.0 for e in errs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
