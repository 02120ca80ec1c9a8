"""scripts/soak_torch_fleet.py on the CPU: two mcnn replicas serving an AOT
artifact the script exports, 64x64 frames, a few seconds of load with a
replica SIGKILLed in the middle: no request dropped, the replica respawned,
the fleet's counters never falling."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_soak_with_aot_replicas_survives_a_kill():
    out = subprocess.run(
        [sys.executable, "scripts/soak_torch_fleet.py", "--model", "mcnn", "--hw", "64", "64",
         "--replicas", "2", "--duration", "4", "--clients", "3", "--aot", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO))
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and summary["ok"], (summary, out.stderr[-3000:])
    assert summary["aot"]["programs"] == ["1x64x64", "4x64x64"]
    assert summary["dropped"] == 0 and not summary["counter_violations"]
    assert summary["killed_replica_respawned"] and summary["restarts"][0] >= 1
    assert summary["requests"] > 0 and summary["dispatch_fp"] > 0
    assert summary["dispatch_int8"] == 0


def test_the_soak_script_imports_no_jax():
    """It runs on the card's machine, which has no JAX."""
    from pathlib import Path

    from test_torch_port_isolation import _banned, _imports

    bad = [n for n in _imports(Path(REPO) / "scripts" / "soak_torch_fleet.py") if _banned(n)]
    assert not bad, bad
