"""The port's `--trace-dir` (torch.profiler) and its native output
encoder (native/fastout.c), against the JAX package's encoder.

Contracts:
- `--cpu --trace-dir DIR` writes DIR/trace.json, a Chrome trace whose
  events hold the render's `aten::` operators; `--devices 2` writes one
  trace a rank (trace_rank0.json, trace_rank1.json); a render that
  raises still writes its trace;
- the C encoder's PNG scanlines are the Paeth filter of a numpy
  reference, its PNG decodes (PIL) to the input pixels, and its PNG and
  YCbCr bytes equal those of the JAX package's `fastout.c`, built from
  its source into a temporary directory; its YCbCr is within one step
  of the Python converter; the Y4M sink and `--stats` use it where it
  is built, and write_image keeps the Python PNG.  These tests skip
  only where there is no C compiler.
"""

import importlib.util
import io
import json
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import native  # noqa: E402
from cuburn_tpu_torch import output as toutput  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = ["gallery:sierpinski", "--cpu", "--width", "24", "--height", "24",
        "--quality", "2"]
# frames for the encoders: noise, flat runs (what the filters help), an
# odd size, and a 3-channel frame
FRAMES = {
    "noise": np.random.RandomState(0).randint(0, 256, (13, 29, 4)),
    "steps": np.repeat(np.arange(0, 256, 8), 16 * 4).reshape(32, 16, 4),
    "rgb": np.random.RandomState(1).randint(0, 256, (7, 5, 3)),
}


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_dir_writes_a_trace(tmp_path, capsys):
    trace = tmp_path / "tr"
    assert tmain.main([*TINY, "-o", str(tmp_path / "s.png"),
                       "--trace-dir", str(trace)]) == 0
    assert sorted(p.name for p in trace.iterdir()) == ["trace.json"]
    names = {e.get("name", "") for e in _events(trace / "trace.json")}
    assert any(n.startswith("aten::") for n in names)
    assert "trace written to" in capsys.readouterr().err


def test_trace_dir_one_trace_a_rank(tmp_path):
    trace = tmp_path / "tr"
    assert tmain.main([*TINY, "--devices", "2", "-o", str(tmp_path / "s.png"),
                       "--trace-dir", str(trace)]) == 0
    assert sorted(p.name for p in trace.iterdir()) == [
        "trace_rank0.json", "trace_rank1.json"]
    for p in trace.iterdir():
        assert any(e.get("name", "").startswith("aten::")
                   for e in _events(p))


def test_trace_written_when_the_render_raises(tmp_path, monkeypatch):
    def fail(self, *args, **kwargs):
        torch.zeros(3).add_(1)          # an operator before the failure
        raise RuntimeError("render failed")
    monkeypatch.setattr(trender.Renderer, "accumulate", fail)
    trace = tmp_path / "tr"
    with pytest.raises(RuntimeError, match="render failed"):
        tmain.main([*TINY, "-o", str(tmp_path / "s.png"),
                    "--trace-dir", str(trace)])
    names = {e.get("name", "") for e in _events(trace / "trace.json")}
    assert "aten::add_" in names


@pytest.fixture(scope="module")
def cc():
    if shutil.which("cc") is None:
        pytest.skip("no C compiler (cc) on this host")
    assert native.load() is not None
    return shutil.which("cc")


@pytest.fixture(scope="module")
def jax_fastout(cc, tmp_path_factory):
    """The JAX package's fastout extension, built from its source into a
    temporary directory."""
    out = tmp_path_factory.mktemp("jfastout") / (
        "fastout" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run([cc, "-O3", "-shared", "-fPIC",
                    "-I" + sysconfig.get_paths()["include"],
                    str(REPO / "cuburn_tpu" / "native" / "fastout.c"),
                    "-o", str(out), "-lz"], check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("fastout", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rgba(img):
    img = np.asarray(img, np.uint8)
    if img.shape[2] == 3:
        img = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    return np.ascontiguousarray(img)


def _paeth_reference(rgba):
    """PNG filter type 4 of every row, in numpy (a: left, b: up, c: up
    left; zero outside the frame)."""
    h, w = rgba.shape[:2]
    x = rgba.reshape(h, 4 * w).astype(np.int32)
    a = np.zeros_like(x)
    a[:, 4:] = x[:, :-4]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 4:] = x[:-1, :-4]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, 1 + 4 * w), np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = (x - pred).astype(np.uint8)
    return rows.tobytes()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_native_png_matches_jax_fastout(name, cc, jax_fastout):
    from PIL import Image
    rgba = _rgba(FRAMES[name])
    h, w = rgba.shape[:2]
    assert native.paeth_rows(rgba) == _paeth_reference(rgba)
    png = toutput.encode_png_native(rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  rgba)
    assert png == jax_fastout.encode_png(rgba.tobytes(), w, h)
    for level in (1, 9):
        assert toutput.encode_png_native(rgba, level) == \
            jax_fastout.encode_png(rgba.tobytes(), w, h, level)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_native_ycbcr_matches_jax_fastout(name, cc, jax_fastout):
    img = np.asarray(FRAMES[name], np.uint8)
    h, w = img.shape[:2]
    got = native.rgb_to_ycbcr444(img)
    assert got == jax_fastout.rgb_to_ycbcr444(_rgba(img).tobytes(), w, h)
    plain = np.frombuffer(toutput.ycbcr444(img), np.uint8).astype(int)
    assert np.abs(np.frombuffer(got, np.uint8) - plain).max() <= 1


def test_sinks_use_the_native_encoder(cc, jax_fastout, tmp_path, capsys):
    """The Y4M sink writes fastout's YCbCr bytes, write_image the Python
    PNG (the faster one on the card's host), and an animation's --stats
    names the encoder."""
    img = _rgba(FRAMES["noise"])
    h, w = img.shape[:2]
    assert toutput.encoder() == "native"
    toutput.write_image(str(tmp_path / "n.png"), img[..., :3])
    assert (tmp_path / "n.png").read_bytes() == toutput.encode_png(
        _rgba(img[..., :3]))
    buf = io.BytesIO()
    toutput.Y4MSink(buf, w, h).write_frame(img)
    assert buf.getvalue().endswith(
        b"FRAME\n" + jax_fastout.rgb_to_ycbcr444(img.tobytes(), w, h))
    assert tmain.main([*TINY, "--animate", "--fps", "2", "--duration", "1",
                       "-o", str(tmp_path / "a.y4m"), "--stats"]) == 0
    assert "native encoder" in capsys.readouterr().err


def test_native_refuses_bad_shapes(cc):
    with pytest.raises(ValueError, match="u8 pixels"):
        native.paeth_rows(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="u8 pixels"):
        native.rgb_to_ycbcr444(np.zeros((4, 4), np.uint8))


def test_python_encoders_where_the_build_fails(monkeypatch, tmp_path,
                                               capsys):
    """Without a C compiler the build fails, `load` says so once, and
    the Python encoders write the same pixels."""
    from PIL import Image
    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CC", raising=False)
    assert toutput.encoder() == "python"
    assert "no C compiler" in capsys.readouterr().err
    img = _rgba(FRAMES["steps"])
    toutput.write_image(str(tmp_path / "p.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  img)
    assert toutput.encoder() == "python"
    assert capsys.readouterr().err == ""
