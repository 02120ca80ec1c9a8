"""The command line's AOT and export tasks (dgvcc_tpu_torch/cli/main.py) on the
CPU: ``--task aot`` then ``--task serve --aot`` (directory and HTTP), an int8
artifact exported through ``--task aot --artifact``, the refusals the JAX
command line makes (dgvcc_tpu/cli/main.py:82-98, :119-128, :266-305), and
``--task export`` of a JAX ``.ckpt`` against the JAX package's own export of
the same file (nn/torch_export.py), tensor for tensor.

Tolerances: an artifact's counts against the live counter it was exported
from: 1e-6 relative; the printed counts carry two decimals; the exported
``.pth``: equal tensors.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from PIL import Image

from dgvcc_tpu.nn import torch_export, torch_io
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.cli.main import _serve_http, main
from dgvcc_tpu_torch.core.config import load_config
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn import aot
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_baselines import _pair

GEOMETRY = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_MEM.items()}
GEOMETRY["dec_widths"] = [list(w) for w in TINY_MEM["dec_widths"]]


def _config(path, model, params=None, checkpoint=None, **extra):
    path.write_text(yaml.safe_dump(dict({
        "seed": 0, "version": "t", "device": "cpu", "log_para": 1000,
        "checkpoint": checkpoint, "compute_dtype": "float32",
        "model": {"name": model, "params": params or {}},
        "loss": {"name": "mse", "params": {}},
        "optimizer": {"name": "adam", "params": {"lr": 1e-4}},
        "log_dir": str(path.parent / "logs")}, **extra)))
    return str(path)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(root, frames dir, decoded frames, mcnn .pth, its config, the live
    counter)."""
    root = tmp_path_factory.mktemp("aot_cli")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 70, 90, 3), dtype=np.uint8)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(frames / f"img{i}.png")
    counter = VideoCounter.from_checkpoint("mcnn", None, dtype=torch.float32, device="cpu",
                                           seed=3)
    ckpt = root / "mcnn.pth"
    torch.save(counter.model.state_dict(), ckpt)
    return root, frames, imgs, ckpt, _config(root / "cfg.yml", "mcnn", checkpoint=str(ckpt)), \
        counter


def _printed_counts(out):
    lines = out.strip().splitlines()
    return lines[-1], np.array([float(ln.split()[1]) for ln in lines[:-1]])


def test_aot_then_serve_the_artifact(served, capsys):
    root, frames, imgs, _, cfg, counter = served
    path = str(root / "mcnn.aot")
    main(["--config", cfg, "--task", "aot", "--shapes", "2x70x90,1x70x90", "--out", path,
          "--platforms", "cuda,cpu"])
    assert "2 programs ['1x128x128', '2x128x128'] for platforms ['cuda', 'cpu']" in \
        capsys.readouterr().out
    main(["--config", cfg, "--task", "serve", "--frames", str(frames), "--aot", path,
          "--batch", "2"])
    summary, counts = _printed_counts(capsys.readouterr().out)
    assert summary.startswith("[serve] 3 frames") and "cpu" in summary
    np.testing.assert_allclose(counts, counter.count_frames(imgs), atol=0.006)
    srv = _serve_http(load_config(cfg), 0, 2, "cpu", block=False, aot=path)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/count",
                                     data=(frames / "img0.png").read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.load(r)["count"]
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        srv.shutdown()
    np.testing.assert_allclose(got, float(counter.count_frames(imgs[:1])[0]), rtol=1e-6)
    assert stats["dispatch_fp"] == 1 and stats["dispatch_int8"] == 0


def test_aot_of_an_int8_artifact(tmp_path, capsys):
    rng = np.random.default_rng(6)
    frames = tmp_path / "frames"
    frames.mkdir()
    imgs = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(frames / f"img{i}.png")
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                           seed=3, **TINY_MEM)
    ckpt = tmp_path / "final.pth"
    torch.save(counter.model.state_dict(), ckpt)
    cfg = _config(tmp_path / "cfg.yml", "final", GEOMETRY, str(ckpt))
    art, path = str(tmp_path / "final.int8"), str(tmp_path / "final_int8.aot")
    main(["--config", cfg, "--task", "quantize", "--frames", str(frames), "--out", art])
    main(["--config", cfg, "--task", "aot", "--artifact", art, "--shapes", "2x64x96",
          "--out", path])
    assert "(int8)" in capsys.readouterr().out
    a = aot.AotCounter.load(path, device="cpu")
    assert a.quantized is True
    np.testing.assert_allclose(a.count_frames(imgs),
                               VideoCounter.from_artifact(art, device="cpu").count_frames(imgs),
                               rtol=1e-6)


@pytest.mark.parametrize("argv,why", [
    (["--task", "aot", "--shapes", "1x64x64"], "requires --out FILE and --shapes"),
    (["--task", "aot", "--out", "x.aot"], "requires --out FILE and --shapes"),
    (["--task", "aot", "--shapes", "1x64x64", "--out", "x.aot", "--quantize", "auto"],
     "pick the precision"),
    (["--task", "aot", "--shapes", "1x64", "--out", "x.aot"], "--shapes must be BxHxW"),
    (["--task", "aot", "--shapes", "1xax64", "--out", "x.aot"], "--shapes must be BxHxW"),
    (["--task", "aot", "--shapes", "1x64x64", "--out", "x.aot", "--platforms", "tpu"],
     "platforms must name"),
    (["--task", "serve", "--http", "0", "--aot", "missing.aot"], "no such file")])
def test_aot_refusals(served, argv, why):
    _, _, _, _, cfg, _ = served
    with pytest.raises(SystemExit, match=why):
        main(["--config", cfg, *argv])


def test_aot_refuses_no_checkpoint_and_a_mesh(served, tmp_path):
    root = served[0]
    with pytest.raises(SystemExit, match="requires a checkpoint"):
        main(["--config", _config(tmp_path / "bare.yml", "mcnn"), "--task", "aot",
              "--shapes", "1x64x64", "--out", str(tmp_path / "x.aot")])
    mesh = _config(tmp_path / "mesh.yml", "mcnn", checkpoint=str(served[3]),
                   mesh={"data": 2})
    with pytest.raises(SystemExit, match="single-device programs"):
        main(["--config", mesh, "--task", "serve", "--http", "0", "--aot",
              str(root / "mcnn.aot")])
    with pytest.raises(SystemExit, match="--task aot with mesh"):
        main(["--config", mesh, "--task", "aot", "--shapes", "1x64x64", "--out",
              str(tmp_path / "x.aot")])


def test_export_a_jax_ckpt_as_the_jax_package_does(tmp_path, capsys):
    """The port's --task export of a JAX .ckpt against dgvcc_tpu's own export
    of the same file; the .pth strict-loads into the port's model and reads
    back through the JAX package's reader to the same variables. A port .pth
    exports to itself."""
    jm, variables, pm = _pair("mcnn")
    ckpt = tmp_path / "mcnn.ckpt"
    ckpt.write_bytes(serialization.msgpack_serialize(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    template = tmp_path / "template.pth"
    torch.save(MODELS.build("mcnn").state_dict(), template)
    cfg = _config(tmp_path / "cfg.yml", "mcnn", compute_dtype="bfloat16")
    out = tmp_path / "out.pth"
    main(["--config", cfg, "--task", "export", "--ckpt", str(ckpt), "--template",
          str(template), "--out", str(out)])
    got = torch.load(out, weights_only=True)
    assert f"[export] wrote {len(got)} tensors" in capsys.readouterr().out
    want = torch_export.export_reference_checkpoint(
        variables, torch_io.load_torch_state_dict(str(template)), jm)
    ref = torch.load(template, weights_only=True)
    assert list(got) == list(ref) and set(want) == set(ref)
    assert all(got[k].shape == v.shape for k, v in ref.items())
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k
    MODELS.build("mcnn").load_state_dict(got, strict=True)
    back = torch_io.load_reference_checkpoint(variables, torch_io.load_torch_state_dict(
        str(out)), jm)
    for path, leaf in torch_export._flatten(variables):
        assert np.array_equal(np.asarray(torch_export._get(back, path)), leaf), path
    # a .pth in the port's (the reference's) layout exports to itself
    pth = tmp_path / "port.pth"
    torch.save(pm.state_dict(), pth)
    main(["--config", cfg, "--task", "export", "--ckpt", str(pth), "--template",
          str(template), "--out", str(out)])
    again = torch.load(out, weights_only=True)
    assert all(torch.equal(again[k], v) for k, v in pm.state_dict().items())


@pytest.mark.parametrize("case", ["no_template", "no_checkpoint", "joint_gen_only",
                                  "other_family"])
def test_export_refusals(served, tmp_path, case):
    root, _, _, ckpt, cfg, _ = served
    template = tmp_path / "template.pth"
    torch.save(MODELS.build("mcnn").state_dict(), template)
    argv = {"no_template": ["--config", cfg, "--out", "x.pth"],
            "no_checkpoint": ["--config", _config(tmp_path / "bare.yml", "mcnn"),
                              "--template", str(template), "--out", "x.pth"],
            "joint_gen_only": ["--config", _config(tmp_path / "joint.yml", "dgnet",
                                                   checkpoint=["gen.pth"], mode="joint"),
                               "--template", str(template), "--out", "x.pth"],
            "other_family": ["--config", _config(tmp_path / "csr.yml", "csrnet",
                                                 checkpoint=str(ckpt)),
                             "--template", str(template), "--out", "x.pth"]}[case]
    why = {"no_template": "requires --template", "no_checkpoint": "requires a checkpoint",
           "joint_gen_only": "needs the regressor checkpoint too",
           "other_family": "strict load failed"}[case]
    with pytest.raises((SystemExit, ValueError), match=why):
        main([*argv, "--task", "export"])
