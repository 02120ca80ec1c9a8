"""Config keys of the JAX command line that the port's command line reads
too: ``serve_shard: spatial`` without a mesh is refused, as
``dgvcc_tpu/cli/main.py:137-142`` refuses it, and ``compile_cache:``, which
turns on XLA's persistent cache in the JAX package, is reported as having
no effect. Both run on the CPU, before any model is built."""

from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from dgvcc_tpu.cli.main import run as jax_run
from dgvcc_tpu_torch.cli.main import main

REPO = Path(__file__).resolve().parent.parent


def _config(tmp_path, **keys):
    cfg = yaml.safe_load((REPO / "configs" / "sta_final.yml").read_text())
    cfg.update(keys)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def frames(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
                    ).save(d / "img0.jpg")
    return str(d)


def test_serve_shard_spatial_without_a_mesh_is_refused_as_in_the_jax_cli(tmp_path, frames):
    cfg = _config(tmp_path, serve_shard="spatial")
    with pytest.raises(SystemExit, match="serve_shard: spatial needs a mesh") as port:
        main(["--config", cfg, "--task", "serve", "--frames", frames, "--device", "cpu"])
    with pytest.raises(SystemExit, match="serve_shard: spatial needs a mesh") as ref:
        jax_run(cfg, "serve", frames=frames)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("value", [True, "/tmp/xla_cache"])
def test_compile_cache_is_reported_as_having_no_effect(tmp_path, capsys, value):
    cfg = _config(tmp_path, compile_cache=value)
    with pytest.raises(SystemExit, match="--frames"):
        main(["--config", cfg, "--task", "serve", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "compile_cache" in err and "has no effect" in err and "build/torch_ext" in err


def test_no_compile_cache_key_prints_nothing_about_it(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--frames"):
        main(["--config", _config(tmp_path), "--task", "serve", "--device", "cpu"])
    assert "compile_cache" not in capsys.readouterr().err
