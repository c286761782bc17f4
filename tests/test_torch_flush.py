"""The windowed flush: the port's plain version against the JAX
package's Pallas kernel.

Contracts (the reference's own, from the JAX bench's per-bin
differential): with a 3-column palette at weight 1.0 per-bin density
is a sum of integer counts, so it is exact in any order; rgb, and every
channel at another weight or with the opacity-extended palette, agrees
within float32 reassociation, bounded here by 1e-5 relative to the
bin's density.  The JAX kernel runs in interpret mode, as its own CPU
tests run it, at a small size.  The CUDA kernel's own tests are in
test_torch_cuda.py, which runs without JAX on the GPU machine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cuburn_tpu.ops import pallas_hist as ph  # noqa: E402
from cuburn_tpu.ops import histogram as jhist  # noqa: E402
from cuburn_tpu.ops import sort as jsort  # noqa: E402
from cuburn_tpu_torch.kernels import build  # noqa: E402
from cuburn_tpu_torch.ops import flush  # noqa: E402
from cuburn_tpu_torch.ops import histogram as thist  # noqa: E402
from cuburn_tpu_torch.ops import sort as tsort  # noqa: E402

N_BINS = 64 * 64


def _records(seed, n, n_bins, bits, sentinels=0):
    """Packed u32 records with hot pixels (runs), junk-bin records and
    optional 0xFFFFFFFF sentinels, as numpy uint32."""
    rs = np.random.RandomState(seed)
    addr = np.concatenate([
        rs.randint(0, n_bins + 1, n // 2),            # uniform + junk
        rs.randint(100, 140, n // 4),                 # hot pixels
        np.full(n - n // 2 - n // 4, n_bins)])        # junk records
    q = rs.randint(0, 1 << bits, n)
    rec = (addr.astype(np.uint64) << bits) | q.astype(np.uint64)
    rec = rs.permutation(rec).astype(np.uint32)
    if sentinels:
        rec[:sentinels] = 0xFFFFFFFF
    return rec


def _palette(seed, rows, cols):
    return np.random.RandomState(seed).rand(rows, cols).astype(np.float32)


def _jax_flush(rec, pal, bits, weight):
    planes = ph.to_planes_layout(jhist.alloc(N_BINS))
    out = ph.accumulate_windowed_pallas(
        planes, jnp.asarray(rec), jnp.asarray(pal), N_BINS, bits,
        interpret=True,
        weight=None if weight is None else jnp.float32(weight))
    return np.asarray(ph.from_planes_layout(out, N_BINS))


def _torch_flush(fn, rec, pal, bits, weight, device="cpu"):
    hist = thist.alloc(N_BINS, device)
    out = fn(hist, torch.as_tensor(rec.astype(np.int64), device=device),
             torch.as_tensor(pal, device=device), N_BINS, bits,
             weight=weight)
    assert out is hist                                # in place
    return out.cpu().numpy()


def _assert_close_to_density(got, ref, exact_density):
    got, ref = got[:N_BINS], ref[:N_BINS]
    if exact_density:
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    bound = 1e-5 * np.maximum(ref[:, 3:4], 1.0)
    assert (np.abs(got - ref) <= bound).all(), \
        float((np.abs(got - ref) / np.maximum(ref[:, 3:4], 1.0)).max())


def test_sort_records_matches_jax():
    rec = _records(0, 3000, N_BINS, 8)                 # pads to 4096
    j = np.asarray(jsort.sort_records(jnp.asarray(rec), impl="lax"))
    t = tsort.sort_records(torch.as_tensor(rec.astype(np.int64)))
    assert t.shape == (4096,)
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    assert (t.numpy()[3000:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("cols,weight", [(3, None), (3, 0.37),
                                         (4, 1.0), (4, 0.37)])
def test_reference_matches_jax_pallas_win(cols, weight):
    bits = 8
    rec = _records(1, 1 << 13, N_BINS, bits)
    pal = _palette(2, 1 << bits, cols)
    ref = _jax_flush(rec, pal, bits, weight)
    got = _torch_flush(flush.accumulate_windowed_reference, rec, pal,
                       bits, weight)
    _assert_close_to_density(got, ref,
                             exact_density=cols == 3 and weight is None)
    assert got[:N_BINS, 3].sum() > 0


def test_cpu_route_is_the_reference():
    """On CPU tensors accumulate_windowed runs the plain version."""
    rec = _records(3, 5000, N_BINS, 8, sentinels=17)
    pal = _palette(4, 256, 3)
    a = _torch_flush(flush.accumulate_windowed, rec, pal, 8, 0.5)
    b = _torch_flush(flush.accumulate_windowed_reference, rec, pal, 8,
                     0.5)
    np.testing.assert_array_equal(a, b)


def test_reference_skips_sentinels_and_matches_scatter():
    """Sentinels add nothing; per-bin density equals a scatter of the
    same records exactly, junk bin included."""
    rec = _records(5, 6000, N_BINS, 8, sentinels=40)
    pal = _palette(6, 256, 3)
    got = _torch_flush(flush.accumulate_windowed_reference, rec, pal, 8,
                       None)
    live = rec[rec != 0xFFFFFFFF].astype(np.int64)
    addr = torch.as_tensor(live >> 8)
    rgba = torch.cat([torch.as_tensor(pal)[live & 255],
                      torch.ones((live.size, 1))], dim=1)
    sc = thist.accumulate_scatter(thist.alloc(N_BINS, "cpu"), addr,
                                  rgba).numpy()
    np.testing.assert_array_equal(got[:, 3], sc[:, 3])
    assert got[:, 3].sum() == live.size


def test_argument_checks():
    h = thist.alloc(N_BINS, "cpu")
    rec = torch.zeros(16, dtype=torch.int64)
    pal = torch.zeros((256, 3))
    with pytest.raises(ValueError, match="int64"):
        flush.accumulate_windowed(h, rec.int(), pal, N_BINS, 8)
    with pytest.raises(ValueError, match="hist"):
        flush.accumulate_windowed(h[:-1], rec, pal, N_BINS, 8)
    with pytest.raises(ValueError, match="palette"):
        flush.accumulate_windowed(h, rec, pal[:128], N_BINS, 8)


def test_build_reports_missing_nvcc(monkeypatch):
    """Without a CUDA toolkit the build raises; it never substitutes
    anything."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_path_tracks_source():
    p = build.library_path("win_flush")
    assert p.parent == build.BUILD_DIR
    assert p.name.startswith("libwin_flush-") and p.suffix == ".so"
    assert build.library_path("win_flush") == p
