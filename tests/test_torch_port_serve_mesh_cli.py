"""``--task serve`` on a mesh through the port's command line
(dgvcc_tpu_torch/cli/main.py, parallel/serving.py, serve_http.py's leader),
on the CPU.

The serving mesh of a config is the JAX command line's
(``dgvcc_tpu/cli/main.py::_build_counter``): ``{spatial: 2}`` with
``serve_shard: spatial`` serves each frame's height over 2 ranks,
``{data: 2}`` the batch, and ``{spatial: 2}`` without ``serve_shard`` one
process. Then 2 gloo ranks, spawned once for the file (the rank side is
tests/test_torch_port_serve_mesh_ranks.py), run ``--task serve --frames``
on the spatial config, which prints on rank 0 alone the counts of one
process (the same seeded weights, float32; the printed 2 decimals), and
``--http`` on the data config, whose rank 0 answers POSTs with the counts
of the one-process counter (1e-4 relative) and whose shutdown stops the
other rank. ``--aot`` with a mesh, the fleet with a mesh config and a mesh
outside torchrun exit with their messages.
"""

import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dgvcc_tpu.cli.main import _build_counter as jax_build_counter
from dgvcc_tpu.core.config import load_config as jax_load_config
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import load_config
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.parallel.serving import serving_mesh_size
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.serve_fleet import main as fleet_main
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_serve_mesh_ranks import run_cases

GEOMETRY = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_MEM.items()}
GEOMETRY["dec_widths"] = [list(w) for w in TINY_MEM["dec_widths"]]
SEED = 5
LINE = re.compile(r"^(img\d\.jpg) (-?\d+\.\d\d)$")


def _config(path, **keys):
    cfg = {"seed": SEED, "version": "mesh", "device": "cpu", "log_para": 1000,
           "checkpoint": None, "compute_dtype": "float32", "mode": "final",
           "num_epochs": 1, "patch_size": 1440,
           "model": {"name": "final", "params": GEOMETRY},
           "loss": {"name": "mse", "params": {}},
           "optimizer": {"name": "adam", "params": {"lr": 1e-4}},
           "scheduler": {"name": "step", "params": {"step_size": 1}},
           "log_dir": str(path.parent / "logs"), **keys}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh_cli")
    frames = d / "frames"
    frames.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (100, 96, 3), dtype=np.uint8)).save(
            frames / f"img{i}.jpg")
    return d


def _images(root):
    paths = sorted((root / "frames").glob("*.jpg"))
    return paths, np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])


@pytest.mark.parametrize("mesh,shard,want", [
    ({"spatial": 2}, "spatial", (2, "spatial")), ({"data": 2}, None, (2, "batch")),
    ({"spatial": 2}, None, (1, "batch"))])
def test_serving_mesh_is_the_jax_clis(tmp_path, mesh, shard, want):
    keys = {"mesh": mesh, **({"serve_shard": shard} if shard else {})}
    path = _config(tmp_path / "cfg.yml", **keys)
    assert serving_mesh_size(load_config(path)) == want
    counter = jax_build_counter(jax_load_config(path))
    assert (counter.n_shards, counter.shard) == want


def test_a_config_that_serves_in_one_process_serves_without_torchrun(root, tmp_path, capsys):
    """``{spatial: 2}`` without ``serve_shard`` is one process, as the JAX
    command line serves it on one device."""
    plain = _config(tmp_path / "plain.yml")
    mesh = _config(tmp_path / "mesh.yml", mesh={"spatial": 2})
    out = []
    for cfg in (plain, mesh):
        main(["--config", cfg, "--task", "serve", "--frames", str(root / "frames")])
        out.append([ln for ln in capsys.readouterr().out.splitlines() if LINE.match(ln)])
    assert len(out[0]) == 3 and out[1] == out[0]


@pytest.fixture(scope="module")
def ranks(root, tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_mesh_cli_ranks")
    spatial = _config(work / "spatial.yml", mesh={"spatial": 2}, serve_shard="spatial")
    data = _config(work / "data.yml", mesh={"data": 2})
    paths, _ = _images(root)
    spec_file(str(work), {
        "frames": ("cli_frames", {"argv": ["--config", spatial, "--task", "serve", "--frames",
                                           str(root / "frames"), "--batch", "2"]}),
        "http": ("cli_http", {"args": (data, "serve"),
                              "kwargs": dict(http=0, batch=2, block=False),
                              "images": [str(p) for p in paths]})})
    launch.run_ranks(run_cases, 2, (str(work),), init_file=str(work / "init"), timeout=300)
    return results(str(work), 2)


def _one_process(root):
    _, imgs = _images(root)
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                           seed=SEED, **TINY_MEM)
    return counter.count_frames(imgs)


def test_serve_frames_on_a_spatial_mesh_prints_on_rank_0_alone(ranks, root):
    out = ranks[0]["frames"].splitlines()
    assert ranks[1]["frames"] == ""
    assert out[-1].startswith("[serve] 3 frames in") and "x 2 ranks (spatial)" in out[-1]
    lines = [LINE.match(ln) for ln in out[:-1]]
    assert all(lines) and [m.group(1) for m in lines] == ["img0.jpg", "img1.jpg", "img2.jpg"]
    np.testing.assert_allclose([float(m.group(2)) for m in lines], _one_process(root),
                               atol=0.006)


def test_serve_http_on_a_data_mesh_answers_and_stops_every_rank(ranks, root):
    got = ranks[0]["http"]
    np.testing.assert_allclose(got["counts"], _one_process(root), rtol=1e-4, atol=1e-6)
    assert got["stats"]["frames"] == 3 and got["stats"]["dispatch_fp"] >= 1
    assert ranks[1]["http"] == {"follower_returned": True}


def test_aot_the_fleet_and_a_mesh_outside_torchrun_exit(root, tmp_path):
    data = _config(tmp_path / "data.yml", mesh={"data": 2})
    with pytest.raises(SystemExit, match="--aot serves single-device programs"):
        main(["--config", data, "--task", "serve", "--http", "0", "--aot", "x.aot"])
    with pytest.raises(SystemExit, match="a fleet replica is one process on one card"):
        fleet_main(["--config", data, "--replicas", "2", "--port", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node=2 .*serve"):
        main(["--config", data, "--task", "serve", "--frames", str(root / "frames")])
