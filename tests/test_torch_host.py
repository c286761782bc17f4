"""The port's own host layers against the JAX package's, and the rule
that the port imports nothing of it.

Contracts:
- no module of `cuburn_tpu_torch/` (`parallel/` included), nor
  `chip_smoke.py` or `kernel_ab.py`, imports `cuburn_tpu` or `jax` (an
  AST scan), and every port module imports with both blocked (the
  ranks that `parallel/launch.py` spawns import only these modules;
  `tests/test_torch_shard.py` checks them);
- the port's copies of the genome layer, gallery, profiles, command-line
  parser and output sinks give the JAX package's results exactly:
  `eval_at(t)` leaves and `structure_key()` of every gallery genome and
  of a real flam3 file, at three times each; `genome_from_jax` carries a
  JAX genome across unchanged; decoded PNG pixels are equal.
"""

import ast
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu import main as jmain  # noqa: E402
from cuburn_tpu import output as joutput  # noqa: E402
from cuburn_tpu import profile as jprofile  # noqa: E402
from cuburn_tpu.genome import convert as jconvert  # noqa: E402
from cuburn_tpu.models import GALLERY as JGALLERY  # noqa: E402
from cuburn_tpu_torch import main as tmain  # noqa: E402
from cuburn_tpu_torch import output as toutput  # noqa: E402
from cuburn_tpu_torch import profile as tprofile  # noqa: E402
from cuburn_tpu_torch.genome import convert as tconvert  # noqa: E402
from cuburn_tpu_torch.genome.specs import Genome  # noqa: E402
from cuburn_tpu_torch.models import GALLERY as TGALLERY  # noqa: E402
from cuburn_tpu_torch.params import genome_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "cuburn_tpu_torch"
SHEEP = REPO / "tests" / "fixtures" / "wild_sheep.flam3"
TIMES = (0.0, 0.37, 1.0)
FORBIDDEN = {"cuburn_tpu", "jax", "jaxlib"}


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "kernel_ab.py"]


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    assert PORT / "ops" / "interp.py" in sources
    assert {PORT / "parallel" / f"{m}.py"
            for m in ("__init__", "launch", "shard", "farm")} <= set(sources)
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in sources if _imported_roots(p) & FORBIDDEN}
    assert bad == {}


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "cuburn_tpu_torch.ops.tiled_sort" in mods
    assert "cuburn_tpu_torch.ops.interp" in mods
    assert {"cuburn_tpu_torch.parallel", "cuburn_tpu_torch.parallel.launch",
            "cuburn_tpu_torch.parallel.shard",
            "cuburn_tpu_torch.parallel.farm", "cuburn_tpu_torch.retune",
            "cuburn_tpu_torch.native",
            "cuburn_tpu_torch.probes.bf16probe"} <= set(mods)
    script = (
        "import importlib, sys\n"
        "sys.modules['cuburn_tpu'] = sys.modules['jax'] = None\n"
        f"for m in {mods!r} + ['chip_smoke', 'kernel_ab']:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n")
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def _assert_same_genome(a, b):
    assert dataclasses.asdict(a.structure_key()) == \
        dataclasses.asdict(b.structure_key())
    for t in TIMES:
        pa, pb = a.eval_at(t), b.eval_at(t)
        for f in dataclasses.fields(pa):
            x = np.asarray(getattr(pa, f.name))
            y = np.asarray(getattr(pb, f.name))
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(JGALLERY))
def test_gallery_genome_matches_jax(name):
    assert sorted(TGALLERY) == sorted(JGALLERY)
    j, t = JGALLERY[name](), TGALLERY[name]()
    assert isinstance(t, Genome)
    _assert_same_genome(j, t)
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("name", sorted(JGALLERY))
def test_genome_from_jax_round_trips(name):
    j = JGALLERY[name]()
    t = genome_from_jax(j)
    assert isinstance(t, Genome)
    _assert_same_genome(j, t)
    assert t.to_json() == j.to_json()


def test_genome_refuses_an_unknown_variation():
    """An xform names only variations the chaos game implements: the
    genome layer refuses any other name, so no Renderer meets one."""
    from cuburn_tpu_torch.genome.specs import XForm
    from cuburn_tpu_torch.genome.variations import VARIATION_PARAMS
    from cuburn_tpu_torch.ops.variations import VARIATION_IMPLS
    assert set(VARIATION_PARAMS) == set(VARIATION_IMPLS)
    with pytest.raises(ValueError, match="unknown variation 'nosuch'"):
        XForm(vars={"linear": 1.0, "nosuch": 0.5})


def test_flam3_file_parses_as_in_jax():
    js = jconvert.load_genomes(str(SHEEP))
    ts = tconvert.load_genomes(str(SHEEP))
    assert len(ts) == len(js) > 0
    for j, t in zip(js, ts):
        assert t.name == j.name
        _assert_same_genome(j, t)
        _assert_same_genome(j, genome_from_jax(j))


def test_profiles_match_jax():
    assert sorted(tprofile.PROFILES) == sorted(jprofile.PROFILES)
    for name, p in jprofile.PROFILES.items():
        assert tprofile.PROFILES[name].__dict__ == p.__dict__
        assert tprofile.get_profile(name).total_iters == p.total_iters
    over = tprofile.get_profile("1080p", quality=7,
                                hist_backend="pallas_rgb16")
    assert over.__dict__ == jprofile.get_profile(
        "1080p", quality=7, hist_backend="pallas_rgb16").__dict__
    with pytest.raises(ValueError, match="unknown profile"):
        tprofile.get_profile("8k")


def test_parser_matches_jax():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices)
                for a in parser._actions}
    ours, theirs = options(tmain.build_parser()), options(jmain.build_parser())
    # --hist-backend takes the port's own `atomic` (the card's default;
    # a TPU has no scatter-add) beside every choice of the JAX package
    flags, default, choices = ours.pop("hist_backend")
    jflags, jdefault, jchoices = theirs.pop("hist_backend")
    assert (flags, default) == (jflags, jdefault)
    assert list(choices) == [*jchoices, "atomic"]
    assert ours == theirs
    args = tmain.build_parser().parse_args(
        ["g.flam3", "--hist-backend", "pallas_merged", "--quality", "3"])
    assert args.hist_backend == "pallas_merged" and args.quality == 3
    args = tmain.build_parser().parse_args(
        ["g.flam3", "--hist-backend", "atomic"])
    assert args.hist_backend == "atomic"


def test_genome_loader_and_records_match_jax(capsys):
    for spec in ("gallery:kaleido", "random:7", str(SHEEP)):
        _assert_same_genome(jmain.load_genome(spec, 0),
                            tmain.load_genome(spec, 0))
    with pytest.raises(SystemExit, match="not found"):
        tmain.load_genome(str(REPO / "no_such.flam3"), 0)
    counters = {"chunks": 3, "records": 96, "launches": 57, "syncs": 3,
                "uploads": 78}
    stats = type("S", (), {"plotted_samples": 90, "total_iters": 100,
                           "retention": 0.9, "samples_per_sec": 1e6,
                           "iterate_s": 0.25, "filter_s": 0.125,
                           **counters})()
    # the JAX package's record, and the port's five counters beside it
    assert tmain._stats_record(2, 0.5, stats) == \
        {**jmain._stats_record(2, 0.5, stats), **counters}
    assert tmain.main(["gallery:sierpinski", "--convert"]) == 0
    assert capsys.readouterr().out.strip() == \
        JGALLERY["sierpinski"]().to_json()


def test_png_pixels_match_jax(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(4)
    for shape in ((17, 23, 4), (9, 31, 3)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        toutput.write_image(str(tmp_path / "t.png"), img)
        joutput.write_image(str(tmp_path / "j.png"), img)
        t = np.asarray(Image.open(tmp_path / "t.png"))
        j = np.asarray(Image.open(tmp_path / "j.png"))
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t[..., :shape[2]], img)
    png = toutput.encode_png(img if img.shape[2] == 4 else np.dstack(
        [img, np.full(img.shape[:2], 255, np.uint8)]))
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (9, 31, 4)


def test_y4m_frames_match_jax_plain_path(monkeypatch):
    """The port's Y4M sink on its Python converter writes the JAX
    package's numpy-path bytes (with the C encoder built it writes
    fastout's: tests/test_torch_tools.py)."""
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (6, 10, 4)).astype(np.uint8)
    t, j = io.BytesIO(), io.BytesIO()
    monkeypatch.setattr(toutput, "encoder", lambda: "python")
    toutput.Y4MSink(t, 10, 6).write_frame(img)
    saved, joutput._fastout = joutput._fastout, None
    try:
        joutput.Y4MSink(j, 10, 6).write_frame(img)
    finally:
        joutput._fastout = saved
    assert t.getvalue() == j.getvalue()
