"""The one-process tasks on a config with a mesh key (dgvcc_tpu_torch/cli/
main.py): ``--task vis``, ``generate``, ``quantize`` and ``export`` run in
one process, the mesh ignored with one console line, as the JAX command
line runs them, and write what the same config without the key writes:
the same PNGs, JPEGs, int8 artifact and .pth, byte for byte (vis and
quantize with mesh: {spatial: 2}, generate and export with {data: 2,
model: 2}). ``--task aot`` still refuses either mesh. The tiny DG model and
the tiny generator, on the CPU."""

import os

import numpy as np
import pytest
import torch

from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.registry import MODELS
from test_torch_port_generator import _cfg as _gen_cfg
from test_torch_port_generator import root  # noqa: F401
from test_torch_port_trainer import PARITY, _cfg, _yaml

SPATIAL, TWO_D = {"spatial": 2}, {"data": 2, "model": 2}


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    model = MODELS.build("final", **PARITY)
    model.reset_parameters(torch.Generator().manual_seed(4))
    path = tmp_path_factory.mktemp("mesh_key") / "final.pth"
    torch.save(model.state_dict(), path)
    return path


def _run(cfg, tmp_path, task, mesh, *argv):
    """The task on the config as it is and with ``mesh`` (``{v}`` in
    ``argv``: the run's version); returns the two versions, and checks the
    console line of the run with the key."""
    runs = []
    for k, m in enumerate((None, mesh)):
        version = f"v{k}"
        path = _yaml(dict(cfg, version=version, **({"mesh": m} if m else {})),
                     tmp_path / f"{version}.yml")
        main(["--config", path, "--task", task, "--device", "cpu",
              *[a.replace("{v}", version) for a in argv]])
        runs.append(version)
    return runs


def _mesh_line(task, mesh, out):
    keys = ", ".join(f"{a}: {n}" for a, n in mesh.items())
    assert (f"[mesh] --task {task} runs in one process on one card: mesh: {{{keys}}} "
            "is ignored for it") in out


def test_vis_on_a_mesh_key_config(root, tmp_path, ckpt, capsys):  # noqa: F811
    cfg = _cfg(str(root), tmp_path / "logs", "v", mode="final", checkpoint=str(ckpt))
    runs = _run(cfg, tmp_path, "vis", SPATIAL)
    _mesh_line("vis", SPATIAL, capsys.readouterr().out)
    want = _files(tmp_path / "logs" / runs[0] / "vis")
    assert {"img000.png", "img001.png"} <= set(want)
    for version in runs[1:]:
        assert _files(tmp_path / "logs" / version / "vis") == want


def test_generate_on_a_mesh_key_config(root, tmp_path, capsys):  # noqa: F811
    runs = _run(_gen_cfg(str(root), tmp_path / "logs", "g"), tmp_path, "generate", TWO_D)
    _mesh_line("generate", TWO_D, capsys.readouterr().out)
    want = _files(tmp_path / "logs" / runs[0] / "gen")
    assert sorted(want) == [f"img{k:03d}_a.jpg" for k in range(4)]
    for version in runs[1:]:
        assert _files(tmp_path / "logs" / version / "gen") == want


def test_quantize_on_a_mesh_key_config(root, tmp_path, ckpt, capsys):  # noqa: F811
    cfg = _cfg(str(root), tmp_path / "logs", "q", checkpoint=str(ckpt))
    runs = _run(cfg, tmp_path, "quantize", SPATIAL, "--frames",
                os.path.join(str(root), "test"), "--out", str(tmp_path / "{v}.int8"))
    _mesh_line("quantize", SPATIAL, capsys.readouterr().out)
    want = open(tmp_path / f"{runs[0]}.int8", "rb").read()
    for version in runs[1:]:
        assert open(tmp_path / f"{version}.int8", "rb").read() == want


def test_export_on_a_mesh_key_config(root, tmp_path, ckpt, capsys):  # noqa: F811
    cfg = _cfg(str(root), tmp_path / "logs", "e")
    for k in range(2):  # torch.save names its archive after the file
        (tmp_path / f"v{k}").mkdir()
    runs = _run(cfg, tmp_path, "export", TWO_D, "--ckpt", str(ckpt), "--template", str(ckpt),
                "--out", str(tmp_path / "{v}" / "export.pth"))
    _mesh_line("export", TWO_D, capsys.readouterr().out)
    want = open(tmp_path / runs[0] / "export.pth", "rb").read()
    sd = torch.load(tmp_path / runs[0] / "export.pth", weights_only=True)
    assert sd.keys() == torch.load(ckpt, weights_only=True).keys()
    for version in runs[1:]:
        assert open(tmp_path / version / "export.pth", "rb").read() == want


@pytest.mark.parametrize("mesh", [SPATIAL, TWO_D])
def test_aot_still_refuses_a_mesh(root, tmp_path, ckpt, mesh):  # noqa: F811
    path = _yaml(_cfg(str(root), tmp_path, "a", checkpoint=str(ckpt), mesh=mesh),
                 tmp_path / "a.yml")
    with pytest.raises(SystemExit, match="--task aot with mesh"):
        main(["--config", path, "--task", "aot", "--shapes", "1x64x64", "--out",
              str(tmp_path / "a.aot"), "--device", "cpu"])
    assert not np.any([p.suffix == ".aot" for p in tmp_path.iterdir()])
