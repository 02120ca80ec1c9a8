"""The port's command line, ``python -m dgvcc_tpu_torch --task serve``,
on two synthetic JPEGs, on the CPU (chosen through the config's
``device:`` or through ``--device``)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.serve import VideoCounter

REPO = Path(__file__).resolve().parent.parent
GEOMETRY = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_MEM.items()}
GEOMETRY["dec_widths"] = [list(w) for w in TINY_MEM["dec_widths"]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(
            frames / f"img{i}.jpg")
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.float32,
                                           device="cpu", seed=3, **TINY_MEM)
    ckpt = root / "final.pth"
    torch.save(counter.model.state_dict(), ckpt)
    return root, frames, ckpt, counter


def _config(root, device):
    path = root / f"cfg_{device}.yml"
    path.write_text(yaml.safe_dump({
        "seed": 0, "version": "t", "device": device, "log_para": 1000,
        "checkpoint": None, "compute_dtype": "float32",
        "model": {"name": "final", "params": GEOMETRY}}))
    return str(path)


@pytest.mark.parametrize("via", ["config", "flag"])
def test_cli_serve_prints_name_count_lines(served, capsys, via):
    root, frames, ckpt, counter = served
    args = ["--config", _config(root, "cpu" if via == "config" else "tpu"),
            "--task", "serve", "--frames", str(frames), "--ckpt", str(ckpt),
            "--batch", "2"]
    if via == "flag":
        args += ["--device", "cpu"]
    main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("[serve] 2 frames in") and "cpu" in lines[-1]
    names = [ln.split()[0] for ln in lines[:-1]]
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    assert names == ["img0.jpg", "img1.jpg"]
    imgs = np.stack([np.asarray(Image.open(frames / n).convert("RGB")) for n in names])
    np.testing.assert_allclose(counts, counter.count_frames(imgs), atol=0.006)


def test_cli_refuses_unported_tasks_and_missing_frames(served):
    root, _, ckpt, _ = served
    with pytest.raises(SystemExit, match="requires --template"):
        main(["--config", _config(root, "cpu"), "--task", "export", "--ckpt", str(ckpt)])
    with pytest.raises(SystemExit, match="requires --out FILE and --shapes"):
        main(["--config", _config(root, "cpu"), "--task", "aot", "--ckpt", str(ckpt)])
    with pytest.raises(SystemExit, match="--frames"):
        main(["--config", _config(root, "cpu"), "--task", "serve"])


def test_python_dash_m_entry_shows_the_serve_surface():
    out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--frames" in out.stdout and "serve" in out.stdout
