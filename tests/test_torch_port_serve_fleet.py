"""The port's serving fleet (dgvcc_tpu_torch/serve_fleet.py): replica
processes of ``python -m dgvcc_tpu_torch --task serve --http`` on the CPU
behind the round-robin proxy. The replicas serve DGModel final at the tiny
geometry (the smallest the command line builds from a config), seeded, in
float32, so their counts equal an in-process counter's. Every wait on a
replica or the proxy has its own deadline."""

import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.serve_fleet import FleetServer, main
from dgvcc_tpu_torch.utils.devices import chip_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = {k: [list(w) for w in v] if k == "dec_widths" else
            (list(v) if isinstance(v, tuple) else v) for k, v in TINY_MEM.items()}
READY_S = 120  # a replica's start-up: python, torch, the model
DEADLINE = 60


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/count", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE) as r:
        return json.load(r)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=DEADLINE) as r:
        return json.load(r)


def _wait(pred, seconds, what):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.25)
    raise AssertionError(f"{what}: not within {seconds} s")


@pytest.fixture
def config(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump({
        "seed": 5, "version": "fleet", "device": "cpu", "log_para": 1000,
        "checkpoint": None, "compute_dtype": "float32",
        "model": {"name": "final", "params": GEOMETRY}, "log_dir": str(tmp_path / "logs")}))
    return str(path)


def _frames(n, seed=13):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)
    bodies = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, "PNG")
        bodies.append(buf.getvalue())
    return frames, bodies


def test_fleet_round_robin_and_failover(config):
    """Two CPU replicas: counts equal the in-process counter's, requests
    spread over both, and with one replica stopped the requests still pass
    (failover inside the request) and /healthz says degraded."""
    frames, bodies = _frames(4)
    ref = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                       seed=5, **TINY_MEM).count_frames(frames)
    fleet = FleetServer(config, replicas=2, port=0, batch=2, device="cpu", probe_s=0.5)
    assert all(r.make_cmd(1)[-2:] == ["--device", "cpu"] for r in fleet.replicas)
    fleet.start(ready_timeout=READY_S)
    try:
        _wait(lambda: _get(fleet.port, "/healthz")["status"] == "ok", READY_S, "both up")
        got = [_post(fleet.port, b)["count"] for b in bodies]
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        stats = _get(fleet.port, "/stats")
        assert stats["frames"] == 4 and len(stats["replicas"]) == 2
        assert all(r["frames"] >= 1 for r in stats["replicas"])
        assert all(r.ready_s is not None and r.ready_s > 0 for r in fleet.replicas)

        fleet.replicas[0].stop()
        got2 = [_post(fleet.port, b)["count"] for b in bodies]
        np.testing.assert_allclose(got2, ref, rtol=1e-6)
        _wait(lambda: _get(fleet.port, "/healthz")["status"] == "degraded", DEADLINE,
              "degraded")
        assert _get(fleet.port, "/stats")["frames"] >= 8  # the dead one's 2 kept
    finally:
        fleet.shutdown()
    assert not any(r.alive() for r in fleet.replicas)


def test_fleet_restart_respawns_a_dead_replica(config):
    fleet = FleetServer(config, replicas=1, port=0, device="cpu", restart=True, probe_s=0.5)
    fleet.start(ready_timeout=READY_S)
    try:
        rep = fleet.replicas[0]
        old_port = rep.port
        rep.proc.kill()
        rep.proc.wait(timeout=DEADLINE)
        _wait(lambda: rep.restarts >= 1 and rep.probe(), READY_S, "respawned")
        assert rep.port != old_port and rep.healthy
        assert _get(fleet.port, "/healthz")["status"] == "ok"
        _, bodies = _frames(1)
        assert np.isfinite(_post(fleet.port, bodies[0])["count"])
    finally:
        fleet.shutdown()
    assert not fleet.replicas[0].alive()


def test_fleet_stats_stay_monotonic_across_death_and_respawn():
    fleet = FleetServer("cfg.yml", replicas=2, port=0)
    try:
        a, b = fleet.replicas
        a.last_stats = {"frames": 10, "batches": 5, "device_s": 1.0}
        b.last_stats = {"frames": 4, "batches": 2, "device_s": 0.5}
        total = fleet._aggregate_stats()  # neither healthy: last-seen totals
        assert total["frames"] == 14 and total["batches"] == 7 and total["replicas"] == []
        a.make_cmd = lambda port: ["sleep", "5"]
        old_port = a.port
        a.respawn()
        try:
            assert a.retired["frames"] == 10 and a.last_stats["frames"] == 0
            assert a.port != old_port and a.restarts == 1
            assert fleet._aggregate_stats()["frames"] == 14
        finally:
            a.stop()
    finally:
        fleet._httpd.server_close()


def test_fleet_validates_the_device_list():
    with pytest.raises(ValueError, match="--devices"):
        FleetServer("cfg.yml", replicas=2, devices=["0"], port=0)


def test_replica_env_pins_a_card_and_sets_no_tpu_variable(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = chip_env("1")
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    assert not [k for k in env if k.startswith("TPU_") and k not in os.environ]
    assert "CUDA_VISIBLE_DEVICES" not in chip_env(None)
    fleet = FleetServer("cfg.yml", replicas=2, devices=["0", "0"], port=0)
    try:
        assert [r.env["CUDA_VISIBLE_DEVICES"] for r in fleet.replicas] == ["0", "0"]
        cmd = fleet.replicas[0].make_cmd(1234)
        assert cmd[1:3] == ["-m", "dgvcc_tpu_torch"]
        assert cmd[cmd.index("--http") + 1] == "1234" and "--device" not in cmd
    finally:
        fleet._httpd.server_close()


def test_shutdown_before_serving_returns():
    fleet = FleetServer("cfg.yml", replicas=1, port=0)
    done = threading.Event()
    threading.Thread(target=lambda: (fleet.shutdown(), done.set()), daemon=True).start()
    assert done.wait(timeout=10), "shutdown() hung on a fleet that never served"


def test_startup_failure_stops_the_replicas(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    fleet = FleetServer(str(tmp_path / "missing.yml"), replicas=2, port=0, device="cpu")
    with pytest.raises(RuntimeError, match="exited before becoming ready"):
        fleet.start(ready_timeout=READY_S)
    assert not any(r.alive() for r in fleet.replicas)


@pytest.mark.parametrize("kw,flag", [({"aot": "m.aot"}, "--aot"),
                                     ({"artifact": "m.i8"}, "--artifact"),
                                     ({"quantize": "auto"}, "--quantize"),
                                     ({"quantize": True}, "--quantize")])
def test_deploy_flags_are_refused_before_any_replica(kw, flag, monkeypatch):
    """--aot, --artifact and --quantize reach every replica's command line,
    and --quantize auto with --artifact is refused (an artifact has no fp
    weights), before any replica starts."""
    spawned = []
    monkeypatch.setattr("dgvcc_tpu_torch.serve_fleet.subprocess.Popen",
                        lambda *a, **k: spawned.append(a))
    fleet = FleetServer("cfg.yml", replicas=2, port=0, frames_dir="calib", **kw)
    try:
        cmds = [rep.make_cmd(1234 + i) for i, rep in enumerate(fleet.replicas)]
    finally:
        fleet._httpd.server_close()
    for cmd in cmds:
        assert cmd[cmd.index(flag) + 1:][:1] == (
            [kw[flag[2:]]] if flag in ("--aot", "--artifact")
            else ["auto"] if kw["quantize"] == "auto" else ["--frames"])
    both = dict(artifact="m.i8", quantize="auto")
    with pytest.raises(ValueError, match="artifact"):
        FleetServer("cfg.yml", replicas=2, port=0, **both)
    with pytest.raises(SystemExit, match="artifact"):
        main(["--config", "cfg.yml", "--replicas", "2", "--artifact", "m.i8",
              "--quantize", "auto"])
    assert spawned == []
