"""The port on the GPU: the CUDA flush kernel against its plain
version, no fallback when the kernel cannot be built, and renders that
go through the kernel.

Every test here carries the `cuda` marker and skips on hosts without
a GPU.  The file imports no JAX, so it runs as it is on the GPU
machine:  python -m pytest tests/test_torch_cuda.py -q
Contracts as in test_torch_flush.py: density exact with a 3-column
palette at weight 1.0, every channel within 1e-5 of the bin's density
otherwise; a render on the GPU and on the CPU from the same seed (the
same starting trajectories) agree by TV distance under the CPU's
two-seed floor.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu.models import full_feature, sierpinski  # noqa: E402
from cuburn_tpu.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch import render as trender  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402

N_BINS = 300 * 200

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _records(seed, n, bits, sentinels):
    rs = np.random.RandomState(seed)
    addr = np.concatenate([rs.randint(0, N_BINS + 1, n // 2),
                           rs.randint(1000, 1100, n // 4),
                           np.full(n - n // 2 - n // 4, N_BINS)])
    rec = (addr.astype(np.int64) << bits) | rs.randint(0, 1 << bits, n)
    rec = rs.permutation(rec)
    rec[:sentinels] = 0xFFFFFFFF
    return rec


def _flush(fn, rec, pal, bits, weight, device):
    hist = thist.alloc(N_BINS, device)
    out = fn(hist, torch.as_tensor(rec, device=device),
             torch.as_tensor(pal, device=device), N_BINS, bits,
             weight=weight)
    assert out is hist
    return out.cpu().numpy()[:N_BINS]


@pytest.mark.parametrize("cols,bits,weight", [(3, 8, None), (3, 8, 0.37),
                                              (4, 10, 1.0),
                                              (4, 10, 0.37)])
def test_kernel_matches_plain_version(cuda, cols, bits, weight):
    rec = _records(7, 1 << 18, bits, sentinels=100)
    pal = np.random.RandomState(8).rand(1 << bits, cols) \
        .astype(np.float32)
    before = flush.LAUNCHES
    got = _flush(flush.accumulate_windowed, rec, pal, bits, weight, cuda)
    torch.cuda.synchronize()
    assert flush.LAUNCHES == before + 1
    ref = _flush(flush.accumulate_windowed_reference, rec, pal, bits,
                 weight, "cpu")
    if cols == 3 and weight is None:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    bound = 1e-5 * np.maximum(ref[:, 3:4], 1.0)
    assert (np.abs(got - ref) <= bound).all()


def test_flush_raises_when_build_fails(cuda, monkeypatch):
    """No fallback: a kernel that cannot be built makes the CUDA flush
    raise instead of returning the plain result."""
    def broken(_name):
        raise RuntimeError("nvcc failed building win_flush.cu")
    monkeypatch.setattr(build, "load", broken)
    hist = thist.alloc(N_BINS, cuda)
    rec = torch.as_tensor(_records(9, 1000, 8, 0), device=cuda)
    before = flush.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flush.accumulate_windowed(hist, rec,
                                  torch.rand((256, 3), device=cuda),
                                  N_BINS, 8)
    assert flush.LAUNCHES == before
    assert float(hist.abs().sum()) == 0.0


def test_render_goes_through_kernel(cuda):
    prof = RenderProfile(width=128, height=128, quality=20, batch=8192)
    r = trender.Renderer(full_feature(), prof)
    assert r.backend == "pallas_win" and r.device.type == "cuda"
    flush.LAUNCHES = 0
    img, stats = r.render_frame(0.0, seed=1)
    assert flush.LAUNCHES > 0
    assert img.shape == (128, 128, 4) and img[..., :3].any()
    assert stats.plotted_samples > 0


@pytest.mark.parametrize("genome", [sierpinski, full_feature])
def test_render_matches_cpu_by_distribution(cuda, genome):
    prof = RenderProfile(width=64, height=64, quality=100, batch=4096,
                         hist_backend="pallas_win", de_enabled=False)

    def density(device, seed):
        h, _ = trender.Renderer(genome(), prof, device=device) \
            .accumulate(0.0, seed=seed)
        d = h[:-1, 3].double().cpu()
        return d / d.sum()
    a, b, g = density("cpu", 3), density("cpu", 4), density(cuda, 3)
    floor = 0.5 * float((a - b).abs().sum())
    assert 0.5 * float((g - a).abs().sum()) < floor
