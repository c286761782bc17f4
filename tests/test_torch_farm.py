"""The port's frame farm (`cuburn_tpu_torch/parallel/farm.py`): the JAX
package's `tests/test_blend_farm.py::TestFarm` and `TestFarmCLI` against
the port, and the wire between the packages.

Contracts:
- *exact:* a farm of port workers renders every task as the port's
  Renderer renders it on the same device (task i at seed + i, the
  genome as its JSON form carries it), the same task twice the same
  frame; leases requeue and results are evicted as
  in the JAX package;
- *exact:* the JSON-lines protocol is the JAX package's: a JAX server
  and client with a port worker on the CPU give the port's
  `Renderer.render_frame` frames bit for bit, and a port server and
  client with a JAX worker give JAX's `render_frame` frames.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cuburn_tpu_torch.genome.specs import Genome  # noqa: E402
from cuburn_tpu_torch.models import get_genome  # noqa: E402
from cuburn_tpu_torch.parallel import farm  # noqa: E402
from cuburn_tpu_torch.profile import RenderProfile  # noqa: E402
from cuburn_tpu_torch.render import Renderer  # noqa: E402

PROFILE = RenderProfile(width=48, height=48, quality=20, batch=1024,
                        iters_per_chunk=8, fuse=8, hist_backend="scatter",
                        de_enabled=False)
TIMES = (0.0, 0.0, 0.0)
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _no_tune_record(tmp_path_factory):
    """No tune record reaches these tests: CUBURN_TUNE_FILE names a file
    that does not exist (a test that wants a record sets it itself)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBURN_TUNE_FILE",
                  str(tmp_path_factory.mktemp("tune") / "none.json"))
        yield


def _over_the_wire(genome):
    """The genome a worker renders: its JSON form, whose palettes are
    8-bit hex."""
    return Genome.from_json(genome.to_json())


def _workers(run, address, n_workers, tasks, **kw):
    threads = [threading.Thread(target=run, args=(address,),
                                kwargs={"max_tasks": tasks, **kw})
               for _ in range(n_workers)]
    for w in threads:
        w.start()
    return threads


def _join(threads):
    for w in threads:
        w.join(timeout=120)
        assert not w.is_alive()


class TestFarm:
    def test_end_to_end(self):
        server = farm.FarmServer()
        server.serve_background()
        try:
            client = farm.FarmClient(server.address)
            g = get_genome("sierpinski")
            ids = client.submit_animation(g, PROFILE, TIMES, seed=SEED)
            # a second identical batch: workers must reproduce it exactly
            ids2 = client.submit_animation(g, PROFILE, TIMES, seed=SEED)
            assert len(ids) == 3
            workers = _workers(farm.run_worker, server.address, 2, 3,
                               device="cpu")
            frames = [client.fetch(i, timeout=180) for i in ids]
            frames2 = [client.fetch(i, timeout=180) for i in ids2]
            _join(workers)
            ref = Renderer(_over_the_wire(g), PROFILE, device="cpu")
            for i, (f1, f2) in enumerate(zip(frames, frames2)):
                assert f1.shape == (48, 48, 4) and f1[..., :3].max() > 0
                np.testing.assert_array_equal(f1, f2)
                np.testing.assert_array_equal(
                    f1, ref.render_frame(TIMES[i], seed=SEED + i)[0])
            # task i at seed + i: frames at one t differ
            assert not np.array_equal(frames[0], frames[1])
            client.close()
        finally:
            server.shutdown()

    def test_lease_requeue_on_worker_loss(self):
        st = farm.FarmState(lease_seconds=2.0)
        [tid] = st.submit("{}", {}, [0.0])
        t1 = st.get_task()
        assert t1 is not None and t1.job_id == tid
        assert st.get_task() is None            # leased, not available
        time.sleep(2.2)
        t2 = st.get_task()                      # lease expired: requeued
        assert t2 is not None and t2.job_id == tid
        st.put_result(tid, b"xx", (1, 2))
        assert st.get_task() is None            # done: never re-issued

    def test_fetch_evicts_result_after_grace(self):
        st = farm.FarmState(result_grace_seconds=0.5)
        [tid] = st.submit("{}", {}, [0.0])
        assert st.fetch(tid) is None            # not done yet
        st.get_task()
        st.put_result(tid, b"frame", (1, 5))
        assert st.fetch(tid) == (b"frame", (1, 5))
        assert st.fetch(tid) == (b"frame", (1, 5))   # retry in the window
        assert tid in st.tasks
        time.sleep(0.6)
        assert st.fetch(tid) is None            # grace over: evicted
        assert tid not in st.tasks

    def test_worker_needs_a_gpu_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            farm.run_worker(("127.0.0.1", 1), max_tasks=1)


class TestFarmCLI:
    def test_server_worker_client_roundtrip(self, tmp_path):
        """The three _main entry points driven in-process: server
        thread, client submit, a worker on the CPU, client collect."""
        from PIL import Image
        srv = farm.FarmServer("127.0.0.1", 0, lease_seconds=30)
        srv.serve_background()
        try:
            addr = f"127.0.0.1:{srv.address[1]}"
            gpath = tmp_path / "g.json"
            gpath.write_text(get_genome("sierpinski").to_json())
            outdir = tmp_path / "frames"
            client_rc = {}

            def client():
                client_rc["rc"] = farm._main([
                    "client", addr, str(gpath), "-o", str(outdir),
                    "--frames", "2", "--profile", "preview"])
            th = threading.Thread(target=client, daemon=True)
            th.start()
            deadline = time.time() + 30
            while not srv.state.tasks and time.time() < deadline:
                time.sleep(0.05)
            assert srv.state.tasks, "client never submitted"
            assert farm._main(["worker", addr, "--cpu",
                               "--max-tasks", "2"]) == 0
            th.join(timeout=120)
            assert not th.is_alive() and client_rc.get("rc") == 0
            frames = sorted(outdir.glob("frame_*.png"))
            assert len(frames) == 2
            img = np.asarray(Image.open(frames[0]))
            assert img.shape == (512, 512, 4) and img[..., :3].max() > 0
        finally:
            srv.shutdown()


# -- the wire between the packages ------------------------------------------

def test_jax_server_and_client_with_a_port_worker():
    from cuburn_tpu.models import sierpinski as jsierpinski
    from cuburn_tpu.parallel import farm as jfarm
    from cuburn_tpu.profile import RenderProfile as JProfile
    server = jfarm.FarmServer()
    server.serve_background()
    try:
        client = jfarm.FarmClient(server.address)
        ids = client.submit_animation(
            jsierpinski(), JProfile(**PROFILE.__dict__), TIMES, seed=SEED)
        workers = _workers(farm.run_worker, server.address, 1, len(ids),
                           device="cpu")
        frames = [client.fetch(i, timeout=180) for i in ids]
        _join(workers)
        client.close()
    finally:
        server.shutdown()
    ref = Renderer(_over_the_wire(get_genome("sierpinski")), PROFILE,
                   device="cpu")
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            f, ref.render_frame(TIMES[i], seed=SEED + i)[0])
    assert frames[0][..., :3].any()


def test_port_server_and_client_with_a_jax_worker():
    from cuburn_tpu.genome.specs import Genome as JGenome
    from cuburn_tpu.models import sierpinski as jsierpinski
    from cuburn_tpu.parallel import farm as jfarm
    from cuburn_tpu.profile import RenderProfile as JProfile
    from cuburn_tpu.render import Renderer as JRenderer
    server = farm.FarmServer()
    server.serve_background()
    try:
        client = farm.FarmClient(server.address)
        ids = client.submit_animation(get_genome("sierpinski"), PROFILE,
                                      TIMES, seed=SEED)
        workers = _workers(jfarm.run_worker, server.address, 1, len(ids))
        frames = [client.fetch(i, timeout=180) for i in ids]
        _join(workers)
        client.close()
    finally:
        server.shutdown()
    ref = JRenderer(JGenome.from_json(jsierpinski().to_json()),
                    JProfile(**PROFILE.__dict__))
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            f, np.asarray(ref.render_frame(TIMES[i], seed=SEED + i)[0]))
    assert frames[0][..., :3].any()
