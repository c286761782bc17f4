"""The bf16 probe's port (probes/bf16probe.py) against bench/bf16probe.py.

The TPU probe's Pallas kernels run here in interpret mode, built with
its own `run` and `run_skeleton` specs from its `_kernel_*` functions
(those functions return only errors).  Contracts:
- the port's plain versions equal the interpret-mode outputs bit for
  bit: the three staging variants, and the skeleton on the probe's
  schedule and on shuffled schedules whose visits of each block form one
  contiguous run (blocks skipped or visited 1-4 times);
- the port's probe prints the TPU probe's own errors;
- a schedule that comes back to a block is refused (ValueError): there
  interpret mode reloads the pre-call input at each first visit while
  the TPU's aliased buffer gives the second run the first one's result,
  so the two executions of the TPU kernel disagree;
- no CPU fallback: without a GPU the probe's entry point raises unless
  it is asked for the CPU.
The kernels themselves run in tests/test_torch_cuda.py on the card.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from cuburn_tpu_torch.probes import bf16probe as tp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BR, NB = tp.BR, tp.NB
JAX_KERNELS = {"multi": "_kernel_multi", "per_plane": "_kernel_per_plane",
               "f32": "_kernel_f32"}
JAX_DTYPES = {"multi": jnp.bfloat16, "per_plane": jnp.bfloat16,
              "f32": jnp.float32}
# the config bench/bf16probe.py sets at import, restored after loading it
JAX_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                     "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


@pytest.fixture(scope="module")
def jprobe():
    """bench/bf16probe.py as a module.  With no --skeleton in sys.argv
    and no BF16_SKELETON it does not exit at import; its compilation
    cache settings are undone at once."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_OPTIONS}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BF16_SKELETON", raising=False)
        mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        spec = importlib.util.spec_from_file_location(
            "bench_bf16probe", os.path.join(REPO, "bench", "bf16probe.py"))
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
    mod.jax_config_before = saved
    return mod


def _jax_roundtrip(jprobe, variant, x):
    """run's pallas_call in interpret mode on x (numpy float32)."""
    dtype = JAX_DTYPES[variant]
    xq = jnp.asarray(x, dtype)
    scratch = [pltpu.VMEM((3, BR, 128), dtype)]
    if dtype == jnp.bfloat16:
        scratch.append(pltpu.VMEM((3, BR, 128), jnp.float32))
    scratch.append(pltpu.SemaphoreType.DMA)
    out = pl.pallas_call(
        getattr(jprobe, JAX_KERNELS[variant]),
        grid=(x.shape[1] // BR,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(x.shape, dtype),
        scratch_shapes=scratch, interpret=True)(xq)
    return np.asarray(out)


def _jax_skeleton(jprobe, perm, rbg, dens0, rgb0, add):
    """run_skeleton's pallas_call in interpret mode: (dens, rgb) as
    numpy, rgb as bf16."""
    rows = dens0.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(len(perm),),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((4, BR, 128), lambda i, p, rbg: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec(memory_space=pl.ANY),
                   pl.BlockSpec(memory_space=pl.ANY)],
        scratch_shapes=[pltpu.VMEM((4, BR, 128), jnp.float32),
                        pltpu.VMEM((3, BR, 128), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA])
    dens, rgb = pl.pallas_call(
        jprobe._kernel_skeleton, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((1, rows, 128), jnp.float32),
                   jax.ShapeDtypeStruct((3, rows, 128), jnp.bfloat16)],
        input_output_aliases={2: 0, 3: 1}, interpret=True,
    )(jnp.asarray(perm), jnp.asarray(rbg), jnp.asarray(dens0),
      jnp.asarray(rgb0, jnp.bfloat16), jnp.asarray(add))
    return np.asarray(dens), np.asarray(rgb)


def _bits(bf16_tensor):
    return bf16_tensor.contiguous().view(torch.int16).numpy()


def _skeleton_inputs(seed, rows=NB * BR):
    rng = np.random.RandomState(seed)
    dens0 = rng.rand(1, rows, 128).astype(np.float32)
    rgb0 = rng.rand(3, rows, 128).astype(np.float32)
    add = rng.rand(4, BR, 128).astype(np.float32)
    return dens0, rgb0, add


def contiguous_schedule(seed, n_blocks=NB):
    """(perm, rbg): the blocks in a shuffled order, each visited 1-4
    times in one run, some skipped; perm a shuffle of rbg's indices."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n_blocks)[:max(1, n_blocks - rng.randint(2))]
    steps = np.repeat(order, rng.randint(1, 5, order.size)).astype(np.int32)
    perm = rng.permutation(steps.size).astype(np.int32)
    rbg = np.empty_like(steps)
    rbg[perm] = steps              # rbg[perm[i]] == steps[i]
    return perm, rbg


SCHEDULES = {
    "probe": (np.arange(NB * 3, dtype=np.int32),
              np.repeat(np.arange(NB, dtype=np.int32), 3)),
    "one_visit_each_reversed": (np.arange(NB, dtype=np.int32),
                                np.arange(NB, dtype=np.int32)[::-1].copy()),
    **{f"shuffled_{s}": contiguous_schedule(s) for s in range(4)},
}
REVISITING = {
    "two_blocks_come_back": np.array([0, 0, 1, 0, 2, 3, 3, 1], np.int32),
    "back_at_the_end": np.array([2, 1, 1, 3, 2], np.int32),
    "alternating": np.array([0, 1, 0, 1], np.int32),
}


def test_jax_probe_loads_without_exiting(jprobe):
    assert (jprobe.BR, jprobe.NB) == (tp.BR, tp.NB)
    for name in (*JAX_KERNELS.values(), "_kernel_skeleton", "run",
                 "run_skeleton"):
        assert callable(getattr(jprobe, name))
    assert {k: getattr(jax.config, k) for k in JAX_CACHE_OPTIONS} == \
        jprobe.jax_config_before


@pytest.mark.parametrize("variant", sorted(tp.VARIANTS))
def test_roundtrip_equals_interpret_mode(jprobe, variant):
    x = np.random.RandomState(0).rand(3, NB * BR, 128).astype(np.float32)
    want = _jax_roundtrip(jprobe, variant, x)
    xt = torch.from_numpy(x).to(tp.VARIANTS[variant][1])
    before = dict(tp.LAUNCHES)
    for got in (tp.roundtrip(xt, variant),
                tp.roundtrip_reference(xt, variant)):
        assert got.dtype == xt.dtype and got.shape == xt.shape
        if variant == "f32":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_equal(_bits(got),
                                          want.view(np.int16))
        # the identity, bit for bit
        assert torch.equal(got.view(torch.int16), xt.view(torch.int16)) \
            if variant != "f32" else torch.equal(got, xt)
        assert got.data_ptr() != xt.data_ptr()
    assert tp.LAUNCHES == before        # the CPU launches nothing


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_skeleton_equals_interpret_mode(jprobe, name):
    perm, rbg = SCHEDULES[name]
    dens0, rgb0, add = _skeleton_inputs(1)
    want_dens, want_rgb = _jax_skeleton(jprobe, perm, rbg, dens0, rgb0, add)
    before = dict(tp.LAUNCHES)
    for fn in (tp.skeleton, tp.skeleton_reference):
        dens = torch.tensor(dens0)
        rgb = torch.from_numpy(rgb0).to(torch.bfloat16)
        got_dens, got_rgb = fn(dens, rgb, torch.tensor(add), perm, rbg)
        assert got_dens is dens and got_rgb is rgb       # in place
        np.testing.assert_array_equal(got_dens.numpy(), want_dens)
        np.testing.assert_array_equal(_bits(got_rgb), want_rgb.view(np.int16))
    assert tp.LAUNCHES == before
    # blocks off the schedule keep their bits
    visited = set(rbg[perm].tolist())
    for b in set(range(NB)) - visited:
        rows = slice(b * BR, (b + 1) * BR)
        np.testing.assert_array_equal(want_dens[:, rows], dens0[:, rows])


def test_skeleton_adds_once_a_visit_in_order():
    """Three visits are three float32 adds, not one add of 3 x add, and
    rgb is rounded once: the reference's order."""
    dens0, rgb0, add = _skeleton_inputs(5, rows=BR)
    perm, rbg = np.arange(3, dtype=np.int32), np.zeros(3, np.int32)
    dens = torch.tensor(dens0)
    rgb = torch.from_numpy(rgb0).to(torch.bfloat16)
    rgb_f = rgb.float()
    tp.skeleton(dens, rgb, torch.tensor(add), perm, rbg)
    a = torch.tensor(add)
    want = torch.cat([rgb_f, torch.tensor(dens0)])
    for _ in range(3):
        want = want + a
    assert torch.equal(dens, want[3:])
    assert torch.equal(rgb.view(torch.int16),
                       want[:3].to(torch.bfloat16).view(torch.int16))


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _jax_lines(fn, capsys):
    with contextlib.redirect_stderr(io.StringIO()):
        fn()
    return _lines(capsys)


def test_main_cpu_prints_the_jax_probes_errors(jprobe, capsys):
    assert tp.main(["--cpu"]) == 0
    port = _lines(capsys)
    assert port[0] == {"probe": "bf16-dma", "device": "cpu"}
    jax_lines = _jax_lines(lambda: [
        jprobe.run(tp.VARIANTS[v][2], getattr(jprobe, JAX_KERNELS[v]),
                   JAX_DTYPES[v], True) for v in tp.VARIANTS], capsys)
    assert len(port) == 4 and len(jax_lines) == 3
    for got, want in zip(port[1:], jax_lines):
        assert got == {**want, "device": "cpu"}
        assert got["max_err"] == 0.0 and got["ok"]


def test_main_cpu_skeleton_prints_the_jax_probes_errors(jprobe, capsys):
    assert tp.main(["--skeleton", "--cpu"]) == 0
    (port,) = _lines(capsys)
    (want,) = _jax_lines(jprobe.run_skeleton, capsys)
    assert port == {**want, "device": "cpu"}
    assert port["dens_err"] == 4.76837158203125e-07
    assert port["rgb_err"] == 0.00781 and port["ok"]


@pytest.mark.parametrize("name", sorted(REVISITING))
@pytest.mark.parametrize("fn", ["skeleton", "skeleton_reference"])
def test_revisiting_schedule_is_refused(name, fn):
    """A schedule that comes back to a block after another block's run
    is refused before anything runs: for such a schedule interpret mode
    reloads the pre-call input at the second run's first visit while the
    TPU's aliased buffer gives it the first run's result (differing by
    up to 2.0 in density), so there is no one reference to match."""
    rbg = REVISITING[name]
    perm = np.arange(rbg.size, dtype=np.int32)
    dens0, rgb0, add = _skeleton_inputs(2)
    dens = torch.tensor(dens0)
    rgb = torch.from_numpy(rgb0).to(torch.bfloat16)
    with pytest.raises(ValueError, match="one contiguous run"):
        getattr(tp, fn)(dens, rgb, torch.tensor(add), perm, rbg)
    np.testing.assert_array_equal(dens.numpy(), dens0)


def test_schedule_composes_perm_and_rbg():
    perm, rbg = contiguous_schedule(3)
    blocks = tp.schedule(perm, rbg, NB)
    assert blocks.dtype == np.int32
    np.testing.assert_array_equal(blocks, rbg[perm])
    # a permutation can make a non-contiguous rbg contiguous
    assert tp.schedule([1, 3, 0, 2], [0, 1, 0, 1], 2).tolist() == [1, 1, 0,
                                                                   0]
    with pytest.raises(ValueError, match="one contiguous run"):
        tp.schedule([0, 1, 2, 3], [0, 1, 0, 1], 2)


@pytest.mark.parametrize("perm,rbg,match", [
    ([0, 1], [0, 4], "visits block 4"),
    ([0, 1], [0, -1], "visits block -1"),
    ([0, 2], [0, 1], "indexes past rbg"),
    (np.zeros(0, np.int32), [0, 1], "visits no block"),
    ([[0, 1]], [0, 1], "1-D integer"),
    ([0.0, 1.0], [0, 1], "1-D integer"),
])
def test_schedule_refuses_bad_entries(perm, rbg, match):
    with pytest.raises(ValueError, match=match):
        tp.schedule(np.asarray(perm), np.asarray(rbg), NB)


def _rt_input(dtype=torch.bfloat16, rows=BR):
    return torch.rand((3, rows, 128)).to(dtype)


@pytest.mark.parametrize("case", ["wrong_dtype", "two_planes", "width_64",
                                  "strided", "no_rows", "bad_variant",
                                  "numpy"])
def test_roundtrip_refuses(case):
    x, variant = _rt_input(), "multi"
    if case == "wrong_dtype":
        variant = "f32"
    elif case == "two_planes":
        x = x[:2]
    elif case == "width_64":
        x = x[..., :64].contiguous()
    elif case == "strided":
        x = x.transpose(1, 2)
    elif case == "no_rows":
        x = x[:, :0]
    elif case == "bad_variant":
        variant = "bf16"
    else:
        x = x.float().numpy()
    with pytest.raises(ValueError):
        tp.roundtrip(x, variant)
    with pytest.raises(ValueError):
        tp.roundtrip_reference(x, variant)


@pytest.mark.parametrize("case", ["rows_not_blocks", "rgb_rows", "rgb_f32",
                                  "dens_bf16", "add_shape", "add_strided"])
def test_skeleton_refuses(case):
    rows = NB * BR
    dens = torch.rand((1, rows, 128))
    rgb = torch.rand((3, rows, 128)).to(torch.bfloat16)
    add = torch.rand((4, BR, 128))
    if case == "rows_not_blocks":
        dens = dens[:, :rows - 128].contiguous()
        rgb = rgb[:, :rows - 128].contiguous()
    elif case == "rgb_rows":
        rgb = rgb[:, :BR].contiguous()
    elif case == "rgb_f32":
        rgb = rgb.float()
    elif case == "dens_bf16":
        dens = dens.to(torch.bfloat16)
    elif case == "add_shape":
        add = add[:3].contiguous()
    else:
        add = add.transpose(1, 2).contiguous().transpose(1, 2)
    perm, rbg = SCHEDULES["probe"]
    with pytest.raises(ValueError):
        tp.skeleton(dens, rgb, add, perm, rbg)


def test_other_devices_never_take_the_plain_version(monkeypatch):
    """Only a CPU tensor reaches the plain versions; any other device
    goes to the launch, which takes CUDA tensors only."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(tp, "roundtrip_reference", plain)
    monkeypatch.setattr(tp, "skeleton_reference", plain)
    x = torch.empty((3, BR, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.roundtrip(x, "multi")
    dens = torch.empty((1, BR, 128), device="meta")
    rgb = torch.empty((3, BR, 128), dtype=torch.bfloat16, device="meta")
    add = torch.empty((4, BR, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.skeleton(dens, rgb, add, np.zeros(2, np.int32),
                    np.zeros(1, np.int32))


def test_schedule_on_the_card_is_refused():
    """perm and rbg are host arrays: a tensor elsewhere is refused
    (checked without a device read)."""
    perm = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="host array"):
        tp.schedule(perm, np.zeros(1, np.int32), NB)


@pytest.mark.parametrize("rows", [1, 31, 32, 1024, 50_001, 67_584])
def test_roundtrip_grid_is_one_block_a_sm(rows):
    """The roundtrip's persistent grid on a 132-SM card: one block a SM,
    or one a tile where there are fewer tiles, so that the blocks' walks
    (block b takes tiles b, b + grid, ...) take every tile once; a
    block's ring of tiles fits a SM's shared memory in either type."""
    sms, tiles = 132, -(-rows // tp.ROUND_ROWS)
    grid = tp.roundtrip_grid(rows, sms)
    assert grid == min(tiles, sms)
    assert sorted(t for b in range(grid) for t in range(b, tiles, grid)) \
        == list(range(tiles))
    for _code, dtype, _name in tp.VARIANTS.values():
        ring = tp.ROUND_STAGES * 3 * tp.ROUND_ROWS * 128 * dtype.itemsize
        assert ring <= 227 * 1024


def test_main_without_a_gpu_raises(monkeypatch):
    """No CPU fallback: the probe runs on the card unless --cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--skeleton"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.main(argv)
