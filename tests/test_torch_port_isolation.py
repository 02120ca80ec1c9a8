"""The port stands alone: no module of dgvcc_tpu_torch imports JAX, flax,
optax or the JAX package, and its entry points never fall back to the
CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dgvcc_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "dgvcc_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _banned(name):
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 12
    bad = [(str(f.relative_to(REPO)), n) for f in files for n in _imports(f)
           if _banned(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__main__.py")
    code = ("import sys\nbefore = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in mods)
            + "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'dgvcc_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from dgvcc_tpu_torch.serve import VideoCounter, resolve_device
    from dgvcc_tpu_torch.train.state import create_train_state

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoCounter.from_checkpoint("final", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(torch.nn.Linear(2, 1), {"name": "adamw"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoCounter(torch.nn.Identity())
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu").type == "cpu"
