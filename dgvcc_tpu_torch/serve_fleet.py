"""Serving fleet: N replica processes behind one round-robin proxy,
counterpart of dgvcc_tpu/serve_fleet.py (stdlib only).

    python -m dgvcc_tpu_torch.serve_fleet --config cfg.yml --port 8000 \\
        --replicas 4 --devices 0,1,2,3
        [--aot m.aot | --artifact m.int8 | --quantize [auto] --frames DIR]

Each replica is the command line's HTTP endpoint,
``python -m dgvcc_tpu_torch --task serve --http P --batch B [--device D]
[--ckpt X] [--aot F] [--artifact A] [--quantize [auto]] [--frames DIR]``, pinned to
its card by ``utils/devices.py::chip_env`` (``CUDA_VISIBLE_DEVICES``;
``--devices 0,0`` puts two replicas on one card). The proxy:

- POST /count   -> the next healthy replica, round-robin; a replica that
                   does not answer fails over to the next one within the
                   request. A replica's HTTP error (a bad image) passes
                   through, code and body as they are.
- GET  /healthz -> {"status": "ok" | "degraded" | "down", "replicas": [...]}
- GET  /stats   -> counters summed over the replicas, monotonic: a dead or
                   respawned replica keeps its last-seen totals; and the
                   per-replica list.
- a health loop probes every ``probe_s`` seconds and takes replicas in and
  out of the rotation; with ``restart`` it respawns a dead replica on a
  new port, with exponential backoff.

AOT replicas serve an AOT artifact (``--aot``, ``--task aot``'s output:
no model built, no checkpoint read). Int8 replicas serve an artifact
(``--artifact``, ``--task quantize``'s output) or calibrate their own graph
(``--quantize [auto]`` with ``--frames``). ``--quantize auto`` with
``--artifact`` and ``--quantize`` with neither frames nor an artifact are
refused here, as the command line refuses them, before any replica starts.

A config whose serving mesh has more than one rank (``mesh`` with
``serve_shard``, ``parallel/serving.py``) is refused up front too: a replica
is one process on one card, as the JAX fleet pins one chip a replica;
serve such a config with ``torchrun`` (``--task serve``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Callable, List, Optional

from dgvcc_tpu_torch.serve_http import Server
from dgvcc_tpu_torch.utils.devices import chip_env

_STAT_KEYS = ("frames", "batches", "device_s", "dispatch_fp", "dispatch_int8")


def _free_port() -> int:
    # the port is free when asked and may be taken before the replica binds
    # it: that replica then exits at start-up, and with restart it comes
    # back on another port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ReplicaHTTPError(Exception):
    """A replica answered with an HTTP error: that is the client's answer."""

    def __init__(self, code: int, payload: dict):
        super().__init__(f"replica HTTP {code}")
        self.code = code
        self.payload = payload


class Replica:
    """One serving subprocess and its place in the rotation."""

    def __init__(self, make_cmd: Callable[[int], List[str]], env: dict, port: int):
        self.make_cmd = make_cmd
        self.env = env
        self.port = port
        self.proc: Optional[subprocess.Popen] = None
        self.healthy = False
        self.restarts = 0
        self.next_restart_t = 0.0  # monotonic gate of the backoff
        self.started_t = None
        self.ready_s = None  # seconds from start to the first healthy probe
        # monotonic /stats: totals of earlier incarnations, and the last
        # totals seen from the live one; the lock keeps a respawn's fold
        # from being read half done
        self.retired = dict.fromkeys(_STAT_KEYS, 0)
        self.last_stats = dict.fromkeys(_STAT_KEYS, 0)
        self.stats_lock = threading.Lock()

    def start(self):
        self.started_t = time.monotonic()
        self.ready_s = None
        self.proc = subprocess.Popen(self.make_cmd(self.port), env=self.env)

    def respawn(self):
        """Fold the dead incarnation's counters into the retired base, move
        to a new port (the old one may be what killed it), start again."""
        with self.stats_lock:
            for k in _STAT_KEYS:
                self.retired[k] = self.retired.get(k, 0) + self.last_stats.get(k, 0)
                self.last_stats[k] = 0
            self.restarts += 1
        self.port = _free_port()
        self.start()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def probe(self, timeout: float = 5.0) -> bool:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthz",
                                        timeout=timeout) as r:
                self.healthy = r.status == 200
        except Exception:
            self.healthy = False
        if self.healthy and self.ready_s is None and self.started_t is not None:
            self.ready_s = time.monotonic() - self.started_t
        return self.healthy

    def get(self, path: str, timeout: float = 10.0) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=timeout) as r:
            return json.load(r)

    def stop(self):
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def check_one_card(config: str) -> None:
    """Raise unless the config serves in one process: a fleet's replica is
    one process on one card. A config that is not there is left to the
    replicas, which report it."""
    if not os.path.isfile(config):
        return
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.parallel.serving import serving_mesh_size

    n, shard = serving_mesh_size(load_config(config))
    if n > 1:
        raise ValueError(f"{config} serves on a mesh of {n} ranks ({shard} sharded); a fleet "
                         "replica is one process on one card. Drop the mesh key to serve "
                         "replicas, or serve the mesh with torchrun --nproc_per_node="
                         f"{n} -m dgvcc_tpu_torch --config {config} --task serve")


class FleetServer:
    """Round-robin proxy over replica serving processes. ``device``: the
    replicas' ``--device`` (cuda unless it says cpu); ``devices``: one card
    id per replica for ``CUDA_VISIBLE_DEVICES``."""

    def __init__(self, config: str, replicas: int = 2,
                 devices: Optional[List[str]] = None, port: int = 8000,
                 host: str = "0.0.0.0", batch: int = 4, device: Optional[str] = None,
                 ckpt: Optional[str] = None, restart: bool = False, probe_s: float = 2.0,
                 request_timeout: float = 300.0, aot: Optional[str] = None,
                 artifact: Optional[str] = None, quantize=False,
                 frames_dir: Optional[str] = None):
        if artifact and quantize == "auto":
            # fail in the parent, not in N replicas' crash loops: an int8
            # artifact has no fp weights for auto's bf16 dispatches
            raise ValueError("--quantize auto cannot serve an --artifact: the int8 artifact "
                             "has no fp weights for the bf16 path")
        if quantize is True and not artifact and not frames_dir:
            raise ValueError("--quantize without --artifact needs --frames DIR for scale "
                             "calibration")
        if devices and len(devices) != replicas:
            raise ValueError(f"--devices lists {len(devices)} ids for {replicas} replicas")
        check_one_card(config)
        self.restart = restart
        self.probe_s = probe_s
        self.request_timeout = request_timeout
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._stopping = False
        self._serving = False

        def make_cmd(rport: int) -> List[str]:
            cmd = [sys.executable, "-m", "dgvcc_tpu_torch", "--config", config,
                   "--task", "serve", "--http", str(rport), "--batch", str(batch)]
            if device:
                cmd += ["--device", device]
            if ckpt:
                cmd += ["--ckpt", ckpt]
            if aot:
                cmd += ["--aot", aot]
            if artifact:
                cmd += ["--artifact", artifact]
            if quantize:
                cmd += ["--quantize"] + (["auto"] if quantize == "auto" else [])
            if frames_dir:
                cmd += ["--frames", frames_dir]
            return cmd

        self.replicas = [Replica(make_cmd, chip_env(devices[i] if devices else None),
                                 _free_port())
                         for i in range(replicas)]
        self._httpd = Server((host, port), self._handler_class())
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # ---- lifecycle -------------------------------------------------------

    def _spawn_and_wait(self, ready_timeout: float):
        """Spawn every replica and wait for one to serve; on any failure
        stop them all, so that no process holding a card is left behind."""
        try:
            for rep in self.replicas:
                rep.start()
            self._wait_ready(ready_timeout)
            self._health_thread.start()
        except BaseException:
            for rep in self.replicas:
                rep.stop()
            self._httpd.server_close()
            raise

    def start(self, ready_timeout: float = 300.0) -> threading.Thread:
        """Spawn the replicas, wait until one serves, then serve the proxy
        on a daemon thread (tests, embedding)."""
        self._spawn_and_wait(ready_timeout)
        self._serving = True
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def serve_forever(self, ready_timeout: float = 300.0):
        """Serve until SIGTERM or SIGINT; the replicas are stopped on the way
        out."""
        self._spawn_and_wait(ready_timeout)
        n_up = sum(r.healthy for r in self.replicas)
        print(f"[fleet] {n_up}/{len(self.replicas)} replicas up; proxy on :{self.port}",
              flush=True)
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, lambda *_: threading.Thread(
                    target=self._httpd.shutdown, daemon=True).start())
            except ValueError:  # not the main thread: no handler possible
                pass
        try:
            self._serving = True
            self._httpd.serve_forever()
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)
            self.shutdown()

    def _wait_ready(self, timeout: float):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any([rep.probe(timeout=2.0) for rep in self.replicas]):
                return
            dead = [r for r in self.replicas if not r.alive()]
            if len(dead) == len(self.replicas):
                raise RuntimeError("every replica process exited before becoming ready "
                                   f"(rc={[r.proc.returncode for r in dead]})")
            time.sleep(0.5)
        raise RuntimeError(f"no replica became healthy in {timeout:.0f}s")

    def shutdown(self):
        self._stopping = True
        if self._serving:
            # only while serve_forever runs: on a server that never served,
            # BaseServer.shutdown waits forever
            self._serving = False
            self._httpd.shutdown()
        self._httpd.server_close()
        # the health loop first: a restart in flight could otherwise respawn
        # a replica just stopped
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=self.probe_s + 10.0)
        for rep in self.replicas:
            rep.stop()

    # ---- health ----------------------------------------------------------

    def _health_loop(self):
        while not self._stopping:
            for rep in self.replicas:
                if self._stopping:
                    return
                rep.probe()
                if (self.restart and not rep.alive() and not self._stopping
                        and time.monotonic() >= rep.next_restart_t):
                    old = rep.port
                    rep.respawn()
                    # exponential backoff, at most 60 s: a replica that
                    # cannot start must not become a restart storm
                    rep.next_restart_t = time.monotonic() + min(
                        60.0, self.probe_s * (2 ** min(rep.restarts, 10)))
                    print(f"[fleet] replica :{old} died; restart #{rep.restarts} on "
                          f":{rep.port}", flush=True)
            deadline = time.monotonic() + self.probe_s
            while not self._stopping and time.monotonic() < deadline:
                time.sleep(0.1)

    # ---- routing -----------------------------------------------------------

    def _rotation(self) -> List[Replica]:
        """The healthy replicas from the round-robin cursor on, then the
        others as a last resort (they may have come back since the probe)."""
        with self._rr_lock:
            self._rr += 1
            start = self._rr
        n = len(self.replicas)
        order = [self.replicas[(start + i) % n] for i in range(n)]
        return [r for r in order if r.healthy] + [r for r in order if not r.healthy]

    def _proxy_count(self, body: bytes) -> dict:
        last_err: Exception = RuntimeError("no replicas configured")
        for rep in self._rotation():
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{rep.port}/count",
                                             data=body, method="POST")
                with urllib.request.urlopen(req, timeout=self.request_timeout) as r:
                    return json.load(r)
            except urllib.error.HTTPError as e:
                # the replica is alive and refused the request: relay its JSON
                try:
                    payload = json.load(e)
                except Exception:
                    payload = {"error": e.reason}
                raise _ReplicaHTTPError(e.code, payload) from e
            except Exception as e:  # refused, reset, timed out: the next one
                rep.healthy = False
                last_err = e
        raise ConnectionError(f"all replicas unavailable: {last_err}")

    def _aggregate_health(self) -> dict:
        detail = [{"port": r.port, "healthy": r.healthy, "alive": r.alive(),
                   "restarts": r.restarts} for r in self.replicas]
        up = sum(d["healthy"] for d in detail)
        status = "ok" if up == len(detail) else "degraded" if up else "down"
        return {"status": status, "replicas": detail}

    def _aggregate_stats(self) -> dict:
        """Totals that never fall: each replica adds its retired base and
        the freshest totals seen from its live process (kept when it
        dies)."""
        per = []
        total = dict.fromkeys(_STAT_KEYS, 0)
        for rep in self.replicas:
            live, incarnation = None, rep.restarts
            if rep.healthy:
                try:
                    live = rep.get("/stats")
                except Exception:
                    pass
            with rep.stats_lock:
                if live is not None and rep.restarts == incarnation:
                    for k in _STAT_KEYS:
                        rep.last_stats[k] = live.get(k, 0)
                    per.append({"port": rep.port, **live})
                for k in _STAT_KEYS:
                    total[k] += rep.retired.get(k, 0) + rep.last_stats.get(k, 0)
        total["replicas"] = per
        return total

    # ---- http ----------------------------------------------------------------

    def _handler_class(self):
        fleet = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    h = fleet._aggregate_health()
                    self._json(200 if h["status"] != "down" else 503, h)
                elif self.path == "/stats":
                    self._json(200, fleet._aggregate_stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/count":
                    self._json(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    self._json(200, fleet._proxy_count(body))
                except _ReplicaHTTPError as e:
                    self._json(e.code, e.payload)
                except ConnectionError as e:
                    self._json(503, {"error": str(e)})

        return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--devices", default=None,
                    help="comma-separated card ids, one per replica (CUDA_VISIBLE_DEVICES)")
    ap.add_argument("--device", default=None,
                    help="the replicas' --device: cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4, help="per-replica micro-batch bound")
    ap.add_argument("--ckpt", default=None, help="checkpoint passed to every replica")
    ap.add_argument("--restart", action="store_true", help="respawn dead replicas")
    ap.add_argument("--probe-s", type=float, default=2.0)
    ap.add_argument("--aot", default=None, help="an AOT artifact for every replica")
    ap.add_argument("--artifact", default=None, help="an int8 artifact for every replica")
    ap.add_argument("--quantize", nargs="?", const=True, default=False,
                    choices=[True, False, "auto"], metavar="auto",
                    help="int8 replicas; 'auto' picks int8 or bf16 per dispatch in each")
    ap.add_argument("--frames", default=None,
                    help="calibration imagery directory (with --quantize)")
    args = ap.parse_args(argv)
    try:
        fleet = FleetServer(
            args.config, replicas=args.replicas,
            devices=args.devices.split(",") if args.devices else None,
            port=args.port, batch=args.batch, device=args.device, ckpt=args.ckpt,
            restart=args.restart, probe_s=args.probe_s, aot=args.aot,
            artifact=args.artifact, quantize=args.quantize, frames_dir=args.frames)
    except ValueError as e:
        raise SystemExit(str(e))
    fleet.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
