"""The port's HTTP serving front end (dgvcc_tpu_torch/serve_http.py), the
command line's ``--task serve --http`` and scripts/stress_torch_http.py, on
the CPU: the routes and their keys, counts against the port's count_frames
(1e-6) and the JAX VideoCounter with the same weights (DGModel final at the
tiny geometry, float32: 1e-4), errors, micro-batching with a stub counter,
and a fail-fast shutdown. Every wait on the server or a subprocess has its
own deadline."""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.cli.main import _serve_http, run
from dgvcc_tpu_torch.core.config import load_config
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.serve_http import METRICS, CountingServer
from test_torch_port_helpers import dg_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = {k: [list(w) for w in v] if k == "dec_widths" else
            (list(v) if isinstance(v, tuple) else v) for k, v in TINY_MEM.items()}
DEADLINE = 60  # seconds any one request or join may take


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=DEADLINE) as r:
        return json.load(r)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE) as r:
        return json.load(r)


def _png(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")  # lossless: the decode is the frame
    return buf.getvalue()


@pytest.fixture(scope="module")
def pair():
    jm, variables, pm = dg_pair("final", seed=7)
    return jm, variables, pm


@pytest.fixture(scope="module")
def server(pair):
    _, _, pm = pair
    srv = CountingServer(VideoCounter(pm, dtype=torch.float32, device="cpu"), port=0,
                         model_name="final")
    srv.start()
    yield srv
    srv.shutdown()


def test_healthz(server):
    assert _get(server.port, "/healthz") == {"status": "ok", "model": "final",
                                             "quantized": False}


def test_count_matches_count_frames_and_the_jax_counter(server, pair):
    jm, variables, _ = pair
    frame = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    got = _post(server.port, "/count", _png(frame))["count"]
    np.testing.assert_allclose(got, float(server.counter.count_frames(frame[None])[0]),
                               rtol=1e-6)
    want = float(np.asarray(JaxCounter(jm, variables, dtype=jnp.float32)
                            .count_frames(frame[None]))[0])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_stats_and_metrics_hold_the_same_counters(server):
    frame = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _post(server.port, "/count", _png(frame))
    stats = _get(server.port, "/stats")
    assert set(stats) == {"frames", "requests", "batches", "device_s", "fps",
                          "dispatch_fp", "dispatch_int8"}
    assert stats["frames"] >= 1 and stats["fps"] > 0
    # the counter's own dispatches: the server's batches and direct calls
    assert stats["dispatch_fp"] >= stats["batches"] >= 1 and stats["dispatch_int8"] == 0
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                                timeout=DEADLINE) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    values = dict(line.split() for line in text.splitlines() if not line.startswith("#"))
    assert [f"# TYPE {name} counter" for name, _ in METRICS] == \
        [line for line in text.splitlines() if line.startswith("#")]
    after = _get(server.port, "/stats")
    for name, key in METRICS:
        want = after[key] - (1 if key == "requests" else 0)  # the /stats after it
        assert float(values[name]) == pytest.approx(want, rel=1e-12), name
        if key != "requests":
            assert after[key] == stats[key]


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/count", b"not an image")
    assert e.value.code == 400
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/count", data=b"",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=DEADLINE)
    assert e.value.code == 400
    for method in (_get, lambda p, path: _post(p, path, b"x")):
        with pytest.raises(urllib.error.HTTPError) as e:
            method(server.port, "/nope")
        assert e.value.code == 404


class _StubCounter:
    """Records the dispatched batch sizes; each frame's count is its mean,
    so that a batch cannot hand one request another's answer."""

    quantized = None

    def __init__(self, delay=0.0):
        self.batch_sizes = []
        self.delay = delay
        self.dispatches = {"fp": 0, "int8": 0}

    def count_frames(self, frames):
        time.sleep(self.delay)
        self.batch_sizes.append(len(frames))
        self.dispatches["fp"] += 1
        return frames.reshape(len(frames), -1).mean(axis=1)


def _submit_all(srv, frames):
    out = [None] * len(frames)

    def post(i):
        out[i] = srv._submit(frames[i], timeout=DEADLINE)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE)
        assert not t.is_alive()
    return out


def test_microbatching_groups_same_shape_requests():
    stub = _StubCounter()
    srv = CountingServer(stub, port=0, max_batch=4, batch_window=0.25)
    try:
        rng = np.random.default_rng(2)
        frames = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
        got = _submit_all(srv, frames)
        np.testing.assert_allclose(got, [f.mean() for f in frames], rtol=1e-6)
        assert sum(stub.batch_sizes) == 6 and len(stub.batch_sizes) < 6
        assert max(stub.batch_sizes) <= 4
    finally:
        srv.shutdown()


def test_microbatching_keeps_mixed_shapes_apart():
    stub = _StubCounter()
    srv = CountingServer(stub, port=0, max_batch=8, batch_window=0.2)
    try:
        rng = np.random.default_rng(3)
        frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                  for hw in ((32, 32), (48, 32), (32, 32), (48, 32))]
        got = _submit_all(srv, frames)
        np.testing.assert_allclose(got, [f.mean() for f in frames], rtol=1e-6)
        assert sum(stub.batch_sizes) == 4 and len(stub.batch_sizes) >= 2
    finally:
        srv.shutdown()


def test_shutdown_fails_queued_requests_fast():
    """A request queued behind a slow batch gets an error at shutdown, not
    after its timeout; a request after shutdown is refused."""
    stub = _StubCounter(delay=1.0)
    srv = CountingServer(stub, port=0, max_batch=1, batch_window=0.0)
    frame = np.zeros((8, 8, 3), np.uint8)
    errors = []

    def post():
        try:
            srv._submit(frame, timeout=DEADLINE)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=post) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # the first is on the "card", the others queued
    t0 = time.monotonic()
    srv.shutdown()
    for t in threads:
        t.join(timeout=DEADLINE)
    assert time.monotonic() - t0 < 10
    assert len(errors) == 2 and all("shutting down" in str(e) for e in errors)
    with pytest.raises(RuntimeError, match="shutting down"):
        srv._submit(frame, timeout=1)


def _config(tmp_path, **over):
    d = {"seed": 3, "version": "http", "device": "cpu", "log_para": 1000,
         "checkpoint": None, "compute_dtype": "float32",
         "model": {"name": "final", "params": GEOMETRY}, "log_dir": str(tmp_path / "logs")}
    d.update(over)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def test_cli_serves_http_without_blocking(tmp_path):
    """--task serve --http on the CPU: the config's counter (seed 3) behind
    the server, --batch its micro-batch bound."""
    path = _config(tmp_path)
    srv = run(path, "serve", http=0, batch=3, block=False, device="cpu")
    try:
        assert srv.max_batch == 3 and srv.counter.device.type == "cpu"
        assert _get(srv.port, "/healthz")["model"] == "final"
        frame = np.random.default_rng(4).integers(0, 256, (48, 80, 3), dtype=np.uint8)
        got = _post(srv.port, "/count", _png(frame))["count"]
        want = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                            seed=3, **TINY_MEM).count_frames(frame[None])
        np.testing.assert_allclose(got, float(want[0]), rtol=1e-6)
    finally:
        srv.shutdown()
    srv2 = _serve_http(load_config(path), 0, 2, "cpu", block=False)
    srv2.shutdown()


@pytest.mark.parametrize("flag", [["--quantize"], ["--artifact", "m.i8"], ["--aot", "m.aot"]])
def test_cli_refuses_the_deploy_flags(tmp_path, flag):
    """--quantize needs calibration frames, --artifact and --aot a file
    (int8 serving: test_torch_port_quant_io.py; AOT: test_torch_port_aot_cli.py)."""
    from dgvcc_tpu_torch.cli.main import main

    why = {"--quantize": "needs --frames", "--artifact": "no such file",
           "--aot": "no such file"}[flag[0]]
    with pytest.raises(SystemExit, match=why):
        main(["--config", _config(tmp_path), "--task", "serve", "--http", "0", *flag])


def test_stress_script_end_to_end(tmp_path):
    out = subprocess.run(
        [sys.executable, "scripts/stress_torch_http.py", "--config", _config(tmp_path),
         "--device", "cpu", "--clients", "4", "--requests", "12", "--frames", "3",
         "--hw", "64", "64", "--window-ms", "50"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["requests"] == 12 and data["errors"] == 0
    assert data["req_per_s"] > 0 and data["p95_ms"] >= data["p50_ms"] > 0
    assert data["mean_batch"] >= 1


def test_a_burst_of_connections_is_neither_reset_nor_delayed():
    """32 clients connecting at once: the server's listen backlog (128, not
    the stdlib's 5) takes them all, so none is reset and none waits out a
    SYN retry (a second). A first request pays PIL's plugin set-up before."""
    srv = CountingServer(_StubCounter(), port=0, max_batch=16, batch_window=0.005)
    srv.start()
    body = _png(np.zeros((16, 16, 3), np.uint8))
    _post(srv.port, "/count", body)
    latencies, errors, go = [], [], threading.Event()

    def client():
        go.wait()
        for _ in range(4):
            t0 = time.perf_counter()
            try:
                _post(srv.port, "/count", body)
                latencies.append(time.perf_counter() - t0)
            except Exception as e:
                errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(32)]
    try:
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=DEADLINE)
    finally:
        srv.shutdown()
    assert not errors and len(latencies) == 128
    assert max(latencies) < 0.9
