"""Frame-level render farm: job server, workers, submitting client.

The port's own copy of `cuburn_tpu/parallel/farm.py`, whose workers
render with the port's Renderer on the device they are given (CUDA by
default).  The wire protocol is the JAX package's byte for byte, and
the two packages' genomes and profiles convert field for field, so a
worker of either package serves a server of the other.

Equivalent of the reference's dist/ package (SURVEY.md §2b "Dist farm",
§3.4): embarrassingly-parallel frame distribution — a server queues
(genome, profile, frame-time) tasks, workers pull tasks and stream
rendered frames back, a client submits and collects.  No collectives;
fault handling is lease-based task re-queue on worker loss, exactly the
reference's coarse recovery model (SURVEY.md §5 failure-detection row).

The reference used zmq + gevent; this uses stdlib TCP with a JSON-lines
protocol (zero extra dependencies, works across hosts over DCN).
Intra-frame multi-chip parallelism is the other axis — see shard.py.

Wire protocol (one JSON object per line; frame payloads base64):
  client:  {"op":"submit","genome":...,"profile":{...},"times":[...]}
        -> {"ok":true,"job_ids":[...]}
  worker:  {"op":"get_task"} -> {"task":{...}} | {"task":null}
  worker:  {"op":"result","job_id":...,"frame_b64":...,"shape":[h,w,4]}
  client:  {"op":"fetch","job_id":...} -> {"frame_b64":...}|{"pending":true}
"""

from __future__ import annotations

import base64
import dataclasses
import json
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

LEASE_SECONDS = 120.0
RESULT_GRACE_SECONDS = 60.0


@dataclasses.dataclass
class _Task:
    job_id: int
    genome_json: str
    profile: dict
    t: float
    seed: int
    leased_at: Optional[float] = None
    result: Optional[bytes] = None
    shape: Optional[Tuple[int, ...]] = None
    fetched_at: Optional[float] = None


class FarmState:
    def __init__(self, lease_seconds: float = LEASE_SECONDS,
                 result_grace_seconds: float = RESULT_GRACE_SECONDS):
        self.lock = threading.Lock()
        self.tasks: Dict[int, _Task] = {}
        self.next_id = 0
        self.lease_seconds = lease_seconds
        self.result_grace_seconds = result_grace_seconds

    def _sweep_fetched(self, now: float):
        """Evict results a grace period AFTER first fetch (lock held).
        Immediate eviction made a lost fetch response unrecoverable —
        the retried fetch looked like an unknown job id (advisor,
        round 3); the grace window lets a retry succeed while still
        bounding server memory for long animations."""
        dead = [jid for jid, t in self.tasks.items()
                if t.fetched_at is not None
                and now - t.fetched_at > self.result_grace_seconds]
        for jid in dead:
            del self.tasks[jid]

    def submit(self, genome_json: str, profile: dict,
               times: List[float], seed: int = 0) -> List[int]:
        with self.lock:
            ids = []
            for i, t in enumerate(times):
                tid = self.next_id
                self.next_id += 1
                self.tasks[tid] = _Task(tid, genome_json, profile,
                                        float(t), seed + i)
                ids.append(tid)
            return ids

    def get_task(self) -> Optional[_Task]:
        now = time.time()
        with self.lock:
            self._sweep_fetched(now)
            for task in self.tasks.values():
                if task.result is not None:
                    continue
                expired = (task.leased_at is not None and
                           now - task.leased_at > self.lease_seconds)
                if task.leased_at is None or expired:
                    task.leased_at = now   # (re-)lease: requeue on loss
                    return task
            return None

    def put_result(self, job_id: int, frame: bytes, shape):
        with self.lock:
            t = self.tasks[job_id]
            t.result = frame
            t.shape = tuple(shape)

    def fetch(self, job_id: int):
        """Return (frame_bytes, shape) and schedule the task for
        eviction: results leave the table `result_grace_seconds` after
        their FIRST fetch, so a long-running server doesn't accumulate
        every rendered frame (a 1080p RGBA frame is ~8 MB; without
        eviction a 1000-frame animation pins ~8 GB after the client
        has already taken everything) while a fetch whose response was
        lost in transit can still be retried within the grace window.
        Fetching an evicted id returns None, like an unknown id."""
        now = time.time()
        with self.lock:
            self._sweep_fetched(now)
            t = self.tasks.get(job_id)
            if t is None or t.result is None:
                return None
            if t.fetched_at is None:
                t.fetched_at = now
            return t.result, t.shape


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        state: FarmState = self.server.farm_state  # type: ignore
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                self._send({"ok": False, "error": "bad json"})
                continue
            op = msg.get("op")
            if op == "submit":
                ids = state.submit(msg["genome"], msg["profile"],
                                   msg["times"], msg.get("seed", 0))
                self._send({"ok": True, "job_ids": ids})
            elif op == "get_task":
                t = state.get_task()
                if t is None:
                    self._send({"task": None})
                else:
                    self._send({"task": {
                        "job_id": t.job_id, "genome": t.genome_json,
                        "profile": t.profile, "t": t.t,
                        "seed": t.seed}})
            elif op == "result":
                state.put_result(
                    msg["job_id"],
                    base64.b64decode(msg["frame_b64"]), msg["shape"])
                self._send({"ok": True})
            elif op == "fetch":
                r = state.fetch(msg["job_id"])
                if r is None:
                    self._send({"pending": True})
                else:
                    frame, shape = r
                    self._send({
                        "frame_b64": base64.b64encode(frame).decode(),
                        "shape": list(shape)})
            else:
                self._send({"ok": False, "error": f"bad op {op!r}"})

    def _send(self, obj):
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


class FarmServer:
    """Threaded TCP job server (the reference's dist server)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 lease_seconds: float = LEASE_SECONDS,
                 result_grace_seconds: float = RESULT_GRACE_SECONDS):
        self.state = FarmState(lease_seconds, result_grace_seconds)
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.farm_state = self.state  # type: ignore
        self.address = self._srv.server_address

    def serve_background(self):
        th = threading.Thread(target=self._srv.serve_forever,
                              daemon=True)
        th.start()
        return th

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


class _Conn:
    def __init__(self, address):
        self.sock = socket.create_connection(address)
        self.rfile = self.sock.makefile("rb")

    def rpc(self, obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        return json.loads(self.rfile.readline())

    def close(self):
        self.sock.close()


class FarmClient:
    """Submit frames, collect results (the reference's dist client)."""

    def __init__(self, address):
        self.conn = _Conn(address)

    def submit_animation(self, genome, profile, times,
                         seed: int = 0) -> List[int]:
        prof_dict = dataclasses.asdict(profile)
        return self.conn.rpc({
            "op": "submit", "genome": genome.to_json(),
            "profile": prof_dict, "times": list(map(float, times)),
            "seed": seed})["job_ids"]

    def fetch(self, job_id: int, timeout: float = 300.0,
              poll: float = 0.2) -> np.ndarray:
        deadline = time.time() + timeout
        while time.time() < deadline:
            r = self.conn.rpc({"op": "fetch", "job_id": job_id})
            if "frame_b64" in r:
                buf = base64.b64decode(r["frame_b64"])
                return np.frombuffer(buf, np.uint8).reshape(r["shape"])
            time.sleep(poll)
        raise TimeoutError(f"job {job_id} not done after {timeout}s")

    def close(self):
        self.conn.close()


def run_worker(address, device=None, max_tasks: Optional[int] = None,
               poll: float = 0.2):
    """Pull-render-return loop (the reference's dist worker: one per
    accelerator).  Renders with the port's Renderer on `device`: CUDA
    by default, the CPU only when asked for by name."""
    from cuburn_tpu_torch.device import resolve_device
    from cuburn_tpu_torch.genome.specs import Genome
    from cuburn_tpu_torch.profile import RenderProfile
    from cuburn_tpu_torch.render import Renderer

    device = resolve_device(device)
    conn = _Conn(address)
    done = 0
    renderers: Dict[str, Renderer] = {}
    try:
        while max_tasks is None or done < max_tasks:
            r = conn.rpc({"op": "get_task"})
            task = r.get("task")
            if task is None:
                if max_tasks is not None:
                    break
                time.sleep(poll)
                continue
            cache_key = task["genome"] + json.dumps(task["profile"],
                                                    sort_keys=True)
            if cache_key not in renderers:
                genome = Genome.from_json(task["genome"])
                profile = RenderProfile(**task["profile"])
                # LRU of several renderers: queues alternating between
                # genomes/profiles must not re-setup per task (this
                # keeps packed-genome state and host caches warm)
                while len(renderers) >= 8:
                    renderers.pop(next(iter(renderers)))
                renderers[cache_key] = Renderer(genome, profile, device)
            rr = renderers.pop(cache_key)
            renderers[cache_key] = rr          # move to MRU position
            img, _stats = rr.render_frame(task["t"], seed=task["seed"])
            conn.rpc({
                "op": "result", "job_id": task["job_id"],
                "frame_b64": base64.b64encode(
                    np.ascontiguousarray(img).tobytes()).decode(),
                "shape": list(img.shape)})
            done += 1
    finally:
        conn.close()
    return done


def _main(argv=None):
    """CLI: `python -m cuburn_tpu_torch.parallel.farm
    server|worker|client` (the reference's dist/ server/worker/client
    entry points)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="cuburn-tpu-torch-farm")
    sub = p.add_subparsers(dest="role", required=True)

    ps = sub.add_parser("server", help="run the job server")
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--port", type=int, default=7555)
    ps.add_argument("--lease", type=float, default=LEASE_SECONDS,
                    help="task lease seconds before requeue")

    pw = sub.add_parser("worker", help="pull tasks and render")
    pw.add_argument("server", help="host:port of the farm server")
    pw.add_argument("--max-tasks", type=int)
    pw.add_argument("--device", default=None,
                    help="torch device to render on (default: cuda)")
    pw.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the default is the GPU, "
                         "with no fallback)")

    pc = sub.add_parser("client", help="submit an animation and "
                                       "collect frames")
    pc.add_argument("server", help="host:port of the farm server")
    pc.add_argument("genome", help="genome file (.flam3/.json)")
    pc.add_argument("-o", "--output-dir", default="frames")
    pc.add_argument("--profile", default="preview")
    pc.add_argument("--frames", type=int, default=24)
    pc.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)

    def addr(s):
        host, _, port = s.rpartition(":")
        return (host or "127.0.0.1", int(port))

    if args.role == "server":
        srv = FarmServer(args.host, args.port, args.lease)
        print(f"farm server on {srv.address[0]}:{srv.address[1]}",
              file=sys.stderr)
        try:
            srv._srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
        return 0

    if args.role == "worker":
        n = run_worker(addr(args.server),
                       device="cpu" if args.cpu else args.device,
                       max_tasks=args.max_tasks)
        print(f"worker rendered {n} frames", file=sys.stderr)
        return 0

    # client
    import os
    from cuburn_tpu_torch.genome.convert import load_genomes
    from cuburn_tpu_torch.profile import get_profile

    genome = load_genomes(args.genome)[0]
    profile = get_profile(args.profile)
    t0, t1 = genome.time_range
    times = [t0 + (t1 - t0) * i / max(args.frames - 1, 1)
             for i in range(args.frames)]
    client = FarmClient(addr(args.server))
    ids = client.submit_animation(genome, profile, times,
                                  seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    from cuburn_tpu_torch.output import write_image
    for i, jid in enumerate(ids):
        frame = client.fetch(jid)
        path = os.path.join(args.output_dir, f"frame_{i:05d}.png")
        write_image(path, frame)
        print(path, file=sys.stderr)
    client.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
