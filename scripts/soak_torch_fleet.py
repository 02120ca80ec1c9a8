"""Soak of the port's serving fleet (dgvcc_tpu_torch/serve_fleet.py): sustained
load with a replica killed in the middle, counterpart of scripts/soak_fleet.py.

Drives a FleetServer (replica subprocesses behind the round-robin proxy,
restart on) through three phases of equal length: N clients (requests
coalesce in each replica's micro-batcher), 1 client with replica 0
SIGKILLed a third of the way in, and N clients again. It checks that

  * no client request fails: the proxy fails them over to the live replica;
  * the health loop respawns the killed replica and the fleet is "ok" again;
  * the fleet's /stats counters (frames, batches, dispatches) never fall,
    sampled twice a second through the death and the respawn.

Each phase's latencies give p50 / p95 / p99 and requests a second. With
``--aot`` the replicas serve an AOT artifact (nn/aot.py) that this script
exports first, on the CPU, for the card and the CPU (``platforms cuda,cpu``):
one program at B=1 and one at B=``--batch``, of the config's model with
seeded weights. Without it each replica builds the model from the seed.

Exit code 0 when the soak passed. One JSON line on stdout.

Usage:
    python scripts/soak_torch_fleet.py [--replicas 2] [--duration 90]
        [--model mcnn] [--hw 64 64] [--clients 6] [--batch 4] [--aot]
        [--quantize] [--device cuda|cpu] [--devices 0,0]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# fleet /stats counters that must never fall
MONOTONIC = ("frames", "batches", "dispatch_fp", "dispatch_int8")


def frame_bytes(h: int, w: int, seed: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
                    ).save(buf, "PNG")
    return buf.getvalue()


def _get(port: int, path: str, timeout: float = 30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.load(r)


def _post(port: int, body: bytes, timeout: float = 600):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/count", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


class StatsSampler(threading.Thread):
    """Reads the fleet's /stats about twice a second; records any counter
    that fell."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.port = port
        self.stop_evt = threading.Event()
        self.violations = []
        self.samples = 0
        self.last = None

    def run(self):
        while not self.stop_evt.is_set():
            try:
                s = _get(self.port, "/stats", timeout=10)
            except OSError:
                time.sleep(0.5)
                continue
            cur = {k: s.get(k, 0) for k in MONOTONIC}
            if self.last is not None:
                self.violations += [{"key": k, "prev": self.last[k], "now": cur[k]}
                                    for k in MONOTONIC if cur[k] < self.last[k]]
            self.last = cur
            self.samples += 1
            time.sleep(0.5)


def run_phase(port: int, bodies, clients: int, deadline: float, latencies: list,
              errors: list):
    """``clients`` threads post frames in turn until ``deadline``; each
    success appends its latency in seconds, each failure its repr."""

    def client(i):
        k = 0
        while time.monotonic() < deadline:
            body = bodies[(i + k) % len(bodies)]
            k += 1
            t0 = time.perf_counter()
            try:
                _post(port, body)
            except (OSError, ValueError) as e:  # a dropped request: the failure
                errors.append(repr(e))
                continue
            latencies.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def card() -> str:
    """nvidia-smi's name and power limit of the card, as the PERF notes
    record them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def export_artifact(args, path: str) -> dict:
    """The config's model with seeded weights (int8 with ``--quantize``,
    calibrated on seeded frames), exported on the CPU for the card and the
    CPU at B=1 and B=``--batch``. Returns what the export took."""
    import torch

    from dgvcc_tpu_torch.nn.aot import export_serving, save_aot
    from dgvcc_tpu_torch.serve import VideoCounter

    h, w = args.hw
    calib = (np.random.default_rng(99).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
             if args.quantize else None)
    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    counter = VideoCounter.from_checkpoint(args.model, None, dtype=dtype, device="cpu",
                                           seed=0, quantize=bool(args.quantize),
                                           calib_frames=calib)
    t0 = time.perf_counter()
    doc = export_serving(counter, [(1, h, w), (args.batch, h, w)], platforms=["cuda", "cpu"])
    export_s = time.perf_counter() - t0
    save_aot(doc, path)
    return {"export_s": export_s, "bytes": os.path.getsize(path),
            "programs": sorted(doc["programs"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--duration", type=float, default=90.0,
                    help="seconds of load over the three phases")
    ap.add_argument("--model", default="mcnn")
    ap.add_argument("--hw", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--clients", type=int, default=6, help="clients of the loaded phases")
    ap.add_argument("--batch", type=int, default=4, help="a replica's micro-batch bound")
    ap.add_argument("--aot", action="store_true",
                    help="replicas serve an AOT artifact exported here first")
    ap.add_argument("--quantize", action="store_true", help="int8 replicas")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the replicas' device")
    ap.add_argument("--devices", default=None,
                    help="card ids, one per replica (CUDA_VISIBLE_DEVICES), e.g. 0,0")
    args = ap.parse_args()

    import yaml

    from dgvcc_tpu_torch.serve_fleet import FleetServer

    tmp = tempfile.mkdtemp(prefix="soak_torch_")
    summary = {"ok": False}
    fleet = None
    try:
        cfg = {"seed": 0, "version": "soak", "device": args.device, "log_para": 1000,
               "checkpoint": None, "model": {"name": args.model, "params": {}},
               "compute_dtype": "float32" if args.device == "cpu" else "bfloat16",
               "log_dir": os.path.join(tmp, "logs")}
        cfg_path = os.path.join(tmp, "cfg.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        os.environ.setdefault("PYTHONPATH", REPO)
        artifact = None
        calib_dir = None
        if args.aot:
            artifact = os.path.join(tmp, f"{args.model}.aot")
            summary["aot"] = export_artifact(args, artifact)
        elif args.quantize:
            from PIL import Image

            calib_dir = os.path.join(tmp, "calib")
            os.makedirs(calib_dir)
            for i, img in enumerate(np.random.default_rng(99).integers(
                    0, 256, (2,) + tuple(args.hw) + (3,), dtype=np.uint8)):
                Image.fromarray(img).save(os.path.join(calib_dir, f"c{i}.png"))
        fleet = FleetServer(cfg_path, replicas=args.replicas,
                            devices=args.devices.split(",") if args.devices else None,
                            port=0, batch=args.batch, device=args.device, probe_s=0.5,
                            restart=True, aot=artifact,
                            quantize=bool(args.quantize) and not args.aot,
                            frames_dir=calib_dir)
        t0 = time.monotonic()
        fleet.start(ready_timeout=600)
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and _get(fleet.port, "/healthz")["status"] != "ok":
            time.sleep(0.5)
        if _get(fleet.port, "/healthz")["status"] != "ok":
            raise RuntimeError("the fleet did not become fully healthy")
        summary["ready_s"] = time.monotonic() - t0

        bodies = [frame_bytes(*args.hw, seed=s) for s in range(4)]
        for _ in range(2 * args.replicas):  # each replica's first call outside the window
            _post(fleet.port, bodies[0])
        sampler = StatsSampler(fleet.port)
        sampler.start()
        errors: list = []
        phase_s = args.duration / 3
        phases = {}

        lat: list = []
        run_phase(fleet.port, bodies, args.clients, time.monotonic() + phase_s, lat, errors)
        phases["throughput"] = lat

        victim = fleet.replicas[0]
        old_restarts = victim.restarts

        def killer():
            time.sleep(phase_s / 3)
            victim.proc.kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        lat = []
        run_phase(fleet.port, bodies, 1, time.monotonic() + phase_s, lat, errors)
        kt.join()
        phases["latency_with_kill"] = lat

        lat = []
        run_phase(fleet.port, bodies, args.clients, time.monotonic() + phase_s, lat, errors)
        phases["throughput_post_respawn"] = lat

        t_end = time.monotonic() + 300
        while time.monotonic() < t_end and (victim.restarts == old_restarts or
                                            _get(fleet.port, "/healthz")["status"] != "ok"):
            time.sleep(0.5)
        health = _get(fleet.port, "/healthz")["status"]
        stats = _get(fleet.port, "/stats")
        sampler.stop_evt.set()
        sampler.join(timeout=5)

        def pct(lat):
            if not lat:
                return {}
            a = np.asarray(lat) * 1e3
            return {"n": len(lat), "p50_ms": float(np.percentile(a, 50)),
                    "p95_ms": float(np.percentile(a, 95)),
                    "p99_ms": float(np.percentile(a, 99)), "req_per_s": len(lat) / phase_s}

        n_total = sum(len(v) for v in phases.values())
        summary.update({
            "replicas": args.replicas, "model": args.model, "hw": f"{args.hw[0]}x{args.hw[1]}",
            "device": args.device, "card": card() if args.device == "cuda" else None,
            "aot": summary.get("aot", False), "quantize": bool(args.quantize),
            "duration_s": args.duration, "requests": n_total, "dropped": len(errors),
            "errors_sample": errors[:3],
            "killed_replica_respawned": victim.restarts > old_restarts,
            "restarts": [r.restarts for r in fleet.replicas], "health": health,
            "stat_samples": sampler.samples, "counter_violations": sampler.violations,
            "frames": stats.get("frames", 0), "dispatch_fp": stats.get("dispatch_fp", 0),
            "dispatch_int8": stats.get("dispatch_int8", 0),
            **{f"phase_{k}": pct(v) for k, v in phases.items()}})
        summary["ok"] = (not errors and not sampler.violations and n_total > 0
                         and summary["killed_replica_respawned"] and health == "ok")
    finally:
        if fleet is not None:
            fleet.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(summary), flush=True)
    sys.exit(0 if summary.get("ok") else 1)


if __name__ == "__main__":
    main()
