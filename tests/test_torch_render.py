"""The port's whole slice against the JAX package, and its refusals.

Contracts:
- whole renders are judged by distribution: from the same injected
  initial trajectories, the TV distance between the port's and JAX's
  normalised density histograms stays under 2x JAX's own two-seed
  floor (the chaos game turns one-ulp differences into different
  trajectories, so bitwise equality is not the contract);
- a JAX logical histogram resumed through the port's `hist0` keeps its
  mass exactly, and from the same injected state (sierpinski is affine,
  so trajectories stay together) the finalised frame is within 1 LSB
  of JAX's resumed frame;
- the port never falls back to the CPU: without a GPU the default
  device raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from cuburn_tpu import render as jrender  # noqa: E402
from cuburn_tpu.genome.spline import Spline  # noqa: E402
from cuburn_tpu.models import full_feature, sierpinski  # noqa: E402
from cuburn_tpu.ops import iterate as jit_  # noqa: E402
from cuburn_tpu.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch import device as tdevice  # noqa: E402
from cuburn_tpu_torch import params as tparams  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _inject_jax_state(monkeypatch):
    """Make the port's Renderer start from the trajectories JAX's
    Renderer seeds for the same seed (threefry via init_state)."""
    def init_state(generator, batch, device):
        js = jit_.init_state(jax.random.PRNGKey(generator.initial_seed()),
                             batch)
        return tparams.state_from_numpy(
            *(np.asarray(v) for v in (js.x, js.y, js.color, js.last_xf,
                                      js.age, js.rng)), device=device)
    monkeypatch.setattr(trender, "init_state", init_state)


def _density(hist):
    d = np.asarray(hist, np.float64)[:-1, 3]
    return d / d.sum()


def _tv(a, b):
    return 0.5 * np.abs(_density(a) - _density(b)).sum()


@pytest.mark.parametrize("genome", [sierpinski, full_feature])
def test_slice_matches_jax_by_distribution(genome, monkeypatch):
    _inject_jax_state(monkeypatch)
    g = genome()
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         iters_per_chunk=16, fuse=20, de_enabled=False,
                         hist_backend="scatter")
    jr = jrender.Renderer(g, prof)
    j11, _ = jr.accumulate(0.0, seed=11)
    j12, _ = jr.accumulate(0.0, seed=12)
    floor = _tv(j11, j12)
    tr = trender.Renderer(g, RenderProfile(
        **{**prof.__dict__, "hist_backend": "pallas_win"}), device="cpu")
    assert tr.backend == "pallas_win"
    t11, stats = tr.accumulate(0.0, seed=11)
    assert stats.plotted_samples > 0.5 * stats.total_iters
    assert float(t11[:-1, 3].sum()) == stats.plotted_samples
    d = _tv(t11.numpy(), j11)
    assert d < 2.0 * floor, (d, floor)
    img, _ = tr.render_frame(0.0, seed=11)
    assert img.shape == (64, 64, 4) and img[..., :3].any()


def test_opacity_records_match_jax_by_distribution(monkeypatch):
    """Non-unit xform opacities take the opacity-extended records (the
    xform id spliced into the palette coordinate, a 4-column palette in
    the flush): same distribution contract, and the density mass is the
    opacity-weighted sample count."""
    _inject_jax_state(monkeypatch)
    g = sierpinski()
    g.xforms[1].opacity = Spline(0.5)
    g.xforms[2].opacity = Spline(0.25)
    prof = RenderProfile(width=48, height=48, quality=100, batch=4096,
                         iters_per_chunk=16, fuse=20, de_enabled=False,
                         hist_backend="scatter")
    jr = jrender.Renderer(g, prof)
    tr = trender.Renderer(g, RenderProfile(
        **{**prof.__dict__, "hist_backend": "pallas_win"}), device="cpu")
    assert tr.op_bits == jr.op_bits == 2
    j21, _ = jr.accumulate(0.0, seed=21)
    j22, _ = jr.accumulate(0.0, seed=22)
    t21, stats = tr.accumulate(0.0, seed=21)
    mass = float(t21[:-1, 3].sum())
    assert 0.25 * stats.plotted_samples < mass < 0.8 * stats.plotted_samples
    assert _tv(t21.numpy(), j21) < 2.0 * _tv(j21, j22)


def test_resume_jax_histogram(monkeypatch):
    _inject_jax_state(monkeypatch)
    g = sierpinski()
    prof = RenderProfile(width=48, height=40, quality=40, batch=2048,
                         iters_per_chunk=8, fuse=16,
                         hist_backend="scatter")
    jr = jrender.Renderer(g, prof)
    tr = trender.Renderer(g, RenderProfile(
        **{**prof.__dict__, "hist_backend": "pallas_win"}), device="cpu")
    h0, _ = jr.accumulate(0.0, seed=5)
    h0 = np.array(h0)
    # the checkpoint alone finalises to JAX's frame
    np.testing.assert_allclose(
        tr.finalize_frame(h0).astype(np.int32),
        np.asarray(jr.finalize_frame(h0)).astype(np.int32), atol=1)
    j1, _ = jr.accumulate(0.0, seed=6, hist0=h0)
    t1, stats = tr.accumulate(0.0, seed=6, hist0=h0)
    t1 = t1.numpy()
    assert (t1[:, 3] >= h0[:, 3]).all()
    assert t1[:-1, 3].sum() - h0[:-1, 3].sum() == stats.plotted_samples
    diff = np.abs(tr.finalize_frame(t1).astype(np.int32)
                  - np.asarray(jr.finalize_frame(j1)).astype(np.int32))
    assert diff.max() <= 1


def test_port_imports_and_renders_without_jax(tmp_path):
    """The runtime never imports jax or the JAX package: with both
    blocked, the package imports and renders a 32x32 sierpinski on the
    CPU from its own gallery and profile."""
    script = """
import sys
sys.modules["jax"] = None
sys.modules["cuburn_tpu"] = None
import json
from cuburn_tpu_torch.models import sierpinski
from cuburn_tpu_torch.profile import RenderProfile
from cuburn_tpu_torch.render import Renderer
import cuburn_tpu_torch.main
prof = RenderProfile(width=32, height=32, quality=10, batch=1024)
img, stats = Renderer(sierpinski(), prof, device="cpu").render_frame()
mods = sorted(m for m in sys.modules
              if (m == "jax" or m.startswith(("jax.", "jaxlib", "cuburn_tpu.")))
              and sys.modules[m] is not None)
print(json.dumps({"shape": list(img.shape), "lit": int(img[..., :3].any()),
                  "jax_modules": mods}))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             filter(None, [REPO, os.environ.get(
                                 "PYTHONPATH")]))})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"shape": [32, 32, 4], "lit": 1, "jax_modules": []}


def test_cli_renders_a_still_on_cpu(tmp_path, capsys):
    from cuburn_tpu_torch import main as tmain
    out = tmp_path / "s.png"
    hist = tmp_path / "h.npy"
    rc = tmain.main(["gallery:sierpinski", "-o", str(out), "--cpu",
                     "--width", "32", "--height", "32", "--quality", "50",
                     "--save-hist", str(hist), "--stats"])
    assert rc == 0 and out.stat().st_size > 0
    h = np.load(hist)
    # sierpinski has no DE; the default 0.5 spatial filter adds a
    # 1-pixel gutter
    assert h.shape == (34 * 34 + 1, 4) and h[:-1, 3].sum() > 0
    assert "scatter on cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--reduce-scatter"]])
def test_cli_refuses_unported_flags(flag, monkeypatch):
    """--devices and --reduce-scatter are ported
    (tests/test_torch_shard.py renders them on the CPU); they are
    refused where they cannot run: --devices 2 on CUDA without a GPU
    exits instead of falling back to the CPU, and --reduce-scatter
    without --devices exits with the JAX CLI's message."""
    from cuburn_tpu_torch import main as tmain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    why = {"--devices": "--devices 2: no CUDA device",
           "--reduce-scatter": "requires --devices N>1"}[flag[0]]
    on_cpu = [] if flag[0] == "--devices" else ["--cpu"]
    with pytest.raises(SystemExit, match=why):
        tmain.main(["gallery:sierpinski", *on_cpu, *flag])


@pytest.mark.parametrize("flag", [["--stripes", "3"], ["--bands", "3"]])
def test_cli_partitions_a_still(flag, tmp_path):
    """--stripes and --bands render the still of the whole frame: the
    same histogram, a frame within one u8 step (the JAX package's
    `test_banded_cli_matches_unbanded`)."""
    from PIL import Image

    from cuburn_tpu_torch import main as tmain
    args = ["gallery:classic_swirl", "--cpu", "--width", "64", "--height",
            "64", "--quality", "40"]
    a, b = tmp_path / "whole.png", tmp_path / "part.png"
    ha, hb = tmp_path / "whole.npy", tmp_path / "part.npy"
    assert tmain.main(args + ["-o", str(a), "--save-hist", str(ha)]) == 0
    assert tmain.main(args + ["-o", str(b), "--save-hist", str(hb),
                              *flag]) == 0
    np.testing.assert_array_equal(np.load(ha)[:-1], np.load(hb)[:-1])
    ia, ib = (np.asarray(Image.open(p)).astype(int) for p in (a, b))
    assert ia[..., :3].any() and np.abs(ia - ib).max() <= 1


def test_cli_refuses_resume_with_stripes(tmp_path):
    from cuburn_tpu_torch import main as tmain
    with pytest.raises(SystemExit, match="not supported"):
        tmain.main(["gallery:sierpinski", "--cpu", "-o",
                    str(tmp_path / "x.png"), "--stripes", "2",
                    "--resume-hist", "none.npy"])


def test_renderer_backend_choice():
    """Every backend of the JAX package is accepted by name; `auto` is
    scatter on the CPU; unknown names are refused; a profile with
    motion blur builds."""
    g = sierpinski()
    prof = RenderProfile(width=32, height=32, quality=5, batch=1024)
    assert trender.Renderer(g, prof, device="cpu").backend == "scatter"
    for name in ("scatter", "pallas", "pallas_merged", "pallas_win",
                 "pallas_rgb16", "sortcum", "scatter_sorted"):
        assert trender.Renderer(g, RenderProfile(
            **{**prof.__dict__, "hist_backend": name}),
            device="cpu").backend == name
    with pytest.raises(ValueError, match="unknown histogram backend"):
        trender.Renderer(g, RenderProfile(
            **{**prof.__dict__, "hist_backend": "pallas_fast"}),
            device="cpu")
    blurred = trender.Renderer(g, RenderProfile(
        **{**prof.__dict__, "temporal_samples": 4}), device="cpu")
    assert len(blurred._temporal_times(0.0)[0]) == 4
    r = trender.Renderer(g, prof, device="cpu")
    assert r.profile.iters_per_chunk == trender.DEFAULT_ITERS_PER_CHUNK


def test_no_silent_cpu_fallback():
    """On a host without a GPU the default and explicit CUDA devices
    raise instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.require_cuda()
    g = sierpinski()
    prof = RenderProfile(width=32, height=32, quality=5, batch=1024)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.Renderer(g, prof, device=dev)
    assert tdevice.resolve_device("cpu").type == "cpu"
    from cuburn_tpu_torch import main as tmain
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain.main(["gallery:sierpinski", "-o", "unused.png"])
