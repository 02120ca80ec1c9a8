"""HTTP load generator for the port's serving front end
(dgvcc_tpu_torch/serve_http.py): concurrent clients post pre-encoded
frames and the script reports request throughput, latency and the mean
micro-batch.

In-process server on the card (or ``--device cpu``), built from a config as
``--task serve`` builds it (its checkpoint, or seeded weights):
    python scripts/stress_torch_http.py --config configs/sta_final.yml --clients 16
Against a running server (a replica, or a fleet's proxy):
    python scripts/stress_torch_http.py --url http://127.0.0.1:8000 --clients 8

The last line of its output is one JSON object: requests, req_per_s,
p50_ms, p95_ms, mean_batch (frames per dispatch during the load, from
/stats), device_fps, errors. ``--json PATH`` also writes it there with
each frame's counts (frames from ``--seed``, JPEG ``--quality``).
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np


def encode_frames(n: int, h: int, w: int, seed: int = 0, fmt: str = "JPEG",
                  quality: int = 90):
    """n distinct (h, w, 3) uint8 frames from ``seed``, encoded."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        buf = io.BytesIO()
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(frame).save(buf, fmt, **({"quality": quality}
                                                 if fmt == "JPEG" else {}))
        out.append(buf.getvalue())
    return out


def post_count(url: str, body: bytes, timeout: float = 600.0) -> float:
    req = urllib.request.Request(url + "/count", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)["count"]


def get_json(url: str, path: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.load(r)


def run_load(url: str, bodies, clients: int, requests: int, timeout: float = 600.0):
    """``requests`` posts of ``bodies`` (in turn) from ``clients`` threads.
    Returns (wall s, {body index: [counts]}, latencies s, errors)."""
    jobs = itertools.count()
    lock = threading.Lock()
    counts, latencies, errors = {}, [], []

    def client():
        while True:
            with lock:
                i = next(jobs)
            if i >= requests:
                return
            k = i % len(bodies)
            t0 = time.perf_counter()
            try:
                c = post_count(url, bodies[k], timeout)
            except Exception as e:  # report it, keep loading
                with lock:
                    errors.append(repr(e))
                continue
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                counts.setdefault(k, []).append(c)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, counts, latencies, errors


def load_report(url: str, bodies, clients: int, requests: int) -> dict:
    """One load and what /stats saw during it."""
    before = get_json(url, "/stats")
    wall, counts, lats, errors = run_load(url, bodies, clients, requests)
    after = get_json(url, "/stats")
    frames = after["frames"] - before["frames"]
    batches = after["batches"] - before["batches"]
    dev = after["device_s"] - before["device_s"]
    n = len(lats)
    return {"clients": clients, "requests": n, "wall_s": wall,
            "req_per_s": n / wall if wall > 0 else 0.0,
            "p50_ms": 1e3 * float(np.percentile(lats, 50)) if n else 0.0,
            "p95_ms": 1e3 * float(np.percentile(lats, 95)) if n else 0.0,
            "mean_batch": frames / batches if batches else 0.0,
            "device_fps": frames / dev if dev > 0 else 0.0,
            "errors": len(errors), "counts": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default=None, help="a running server; omit to start one")
    ap.add_argument("--config", default="configs/sta_final.yml",
                    help="in-process: build the counter as --task serve does")
    ap.add_argument("--device", default="cuda", help="in-process: cuda or cpu")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--frames", type=int, default=8, help="distinct frames posted in turn")
    ap.add_argument("--seed", type=int, default=0, help="the frames' seed")
    ap.add_argument("--quality", type=int, default=90, help="their JPEG quality")
    ap.add_argument("--json", default=None, help="write the report and the counts here")
    ap.add_argument("--hw", type=int, nargs=2, default=(768, 1024))
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--window-ms", type=float, default=5.0)
    args = ap.parse_args(argv)

    bodies = encode_frames(args.frames, *args.hw, seed=args.seed, quality=args.quality)
    srv = None
    url = args.url
    if url is None:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from dgvcc_tpu_torch.cli.main import _build_counter
        from dgvcc_tpu_torch.core.config import load_config
        from dgvcc_tpu_torch.serve_http import CountingServer

        cfg = load_config(args.config)
        srv = CountingServer(_build_counter(cfg, args.device), port=0,
                             model_name=cfg.model["name"], max_batch=args.max_batch,
                             batch_window=args.window_ms / 1e3)
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        post_count(url, bodies[0])  # the first forward's set-up, untimed
    try:
        out = load_report(url, bodies, args.clients, args.requests)
    finally:
        if srv is not None:
            srv.shutdown()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    out.pop("counts")
    print(json.dumps(out))
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
