"""The BaseTrainer protocol in the port's trainer (dgvcc_tpu_torch/train/
trainer.py: ``eval_patch_size``, ``test_every_epoch`` and their defaults for
the models the reference drove through main_base.py) and mode regression,
against the JAX trainer on the CPU in float32, on a synthetic dataset in the
canonical layout.

The parity runs start the port from the JAX trainer's seeded weights. The
``final`` runs use the tiny geometry with dropout 0, err_thrs 1e9 and
cls_thrs -1 (tests/test_torch_port_trainer.py). ``reg_mem`` has no dropout
knob: both frameworks' ``dropout2d`` take the same seeded masks, mask i of a
train step in step after step (the JAX step is traced once). Tolerances:

  * the first epoch's training loss: rtol 1e-3 (the AdamW steps of the conv
    biases in front of a train-mode batch norm differ by rounding noise);
  * the MAE and MSE of every ``Testing results`` line: rtol 1e-4; 1e-3 for
    the regression run, whose first test follows two AdamW steps of the
    trunk's conv biases (each a step of +-lr where the two frameworks'
    gradients are rounding noise of opposite sign: the running statistics,
    gathered with the old biases, no longer cancel them in eval mode;
    measured 1.8e-4);
  * ``log.txt``: line for line equal with every number and path masked.
"""

import os
import re

import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze
from PIL import Image

import jax.numpy as jnp
from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.models import regressors as jreg
from dgvcc_tpu.nn import layers as jlayers
from dgvcc_tpu.testing import TINY_MEM, TINY_VGG
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config, load_config
from dgvcc_tpu_torch.models import regressors as preg
from dgvcc_tpu_torch.nn import layers as players
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.trainer import DGTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = dict(TINY_MEM, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
TINY_REG_MEM = dict(vgg_cfg=TINY_VGG, stage_splits=(0, 8, 12, 16),
                    dec_widths=((16, 16), (16, 16), (16, 8)), part_num=16, final_dim=16)
LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")
TEST_LINE = re.compile(r"Testing results: mae: ([\d.]+) mse: ([\d.]+)")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs, 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("basetrainer_data")
    rng = np.random.default_rng(11)
    h, w = 96, 112
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        (root / split).mkdir()
        for k in range(n):
            Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(
                root / split / f"img{k:03d}.jpg")
            pts = rng.uniform(0, [w, h], (12, 2)).astype(np.float32)
            np.save(root / split / f"img{k:03d}.npy", pts)
            np.save(root / split / f"img{k:03d}_dmap.npy",
                    dmap.gaussian_density_fixed_np((h, w), pts))
    return str(root)


def _cfg(root, log_dir, version, model="final", params=PARITY, mode="final", **over):
    ds = {"name": "den_cls", "params": {"root": root, "crop_size": 64, "downsample": 1,
                                        "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    d = {"seed": 2112, "version": version, "device": "cpu", "log_para": 1000,
         "patch_size": 1440, "mode": mode, "num_epochs": 2, "checkpoint": None,
         "model": {"name": model, "params": dict(params)},
         "train_dataset": ds, "val_dataset": ds, "test_dataset": ds,
         "train_loader": {"batch_size": 2, "num_workers": 0, "shuffle": True},
         "val_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
         "test_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
         "loss": {"name": "mse", "params": {"reduction": "mean"}},
         "optimizer": {"name": "adamw", "params": {"lr": 0.001, "weight_decay": 0.0001}},
         "scheduler": {"name": "cosine", "params": {"T_max": 2, "eta_min": 1e-5}},
         "compute_dtype": "float32", "log_dir": str(log_dir)}
    d.update(over)
    return d


def _log(trainer):
    return open(os.path.join(trainer.log_dir, "log.txt")).read()


def _masked(text):
    text = re.sub(r"/\S+", "<path>", text)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()


def _parity(root, tmp_path, cfg):
    """The JAX trainer's train_and_test, then the port's from the same
    initial weights; (JAX log, port log, port trainer)."""
    jt = JaxTrainer(JaxConfig.from_dict(dict(cfg, log_dir=str(tmp_path / "jax"))))
    jt.build()
    init = state_dict_from_flax(ptrainer_model(cfg), unfreeze(jt.state.params),
                                unfreeze(jt.state.batch_stats))
    jt.train_and_test()
    t = DGTrainer(Config.from_dict(dict(cfg, log_dir=str(tmp_path / "port"))), device="cpu")
    t.build()
    t.model.load_state_dict(init, strict=True)
    t.train_and_test()
    return _log(jt), _log(t), t


def ptrainer_model(cfg):
    from dgvcc_tpu_torch.core.registry import MODELS

    return MODELS.build(cfg["model"]["name"], **cfg["model"]["params"])


def _check_against(want_log, got_log, test_rtol=1e-4):
    want_loss = {int(e): float(v) for e, v in LOSS_LINE.findall(want_log)}
    got_loss = {int(e): float(v) for e, v in LOSS_LINE.findall(got_log)}
    assert sorted(got_loss) == sorted(want_loss) == [0, 1]
    np.testing.assert_allclose(got_loss[0], want_loss[0], rtol=1e-3)
    want_tests = np.array(TEST_LINE.findall(want_log), float)
    got_tests = np.array(TEST_LINE.findall(got_log), float)
    assert got_tests.shape == want_tests.shape and len(got_tests) >= 1
    np.testing.assert_allclose(got_tests, want_tests, rtol=test_rtol)
    want_lines, got_lines = _masked(want_log), _masked(got_log)
    assert len(got_lines) == len(want_lines) > 10
    for a, b in zip(got_lines, want_lines):
        assert a == b


@pytest.mark.parametrize("key,value", [("eval_patch_size", 64), ("test_every_epoch", True)])
def test_trainer_keys_match_the_jax_trainer(root, tmp_path, key, value):
    """One key set over the tiny `final`: validation and test tiles of 64 px
    on 96x112 images (2x2 tiles, not the whole image), or a test after each
    epoch (two Testing results blocks, not only where validation improved)."""
    cfg = _cfg(root, tmp_path, f"key_{key}", **{key: value})
    want, got, t = _parity(root, tmp_path, cfg)
    _check_against(want, got)
    if key == "eval_patch_size":
        assert t.counter.patch_size == 64
    else:
        assert got.count("Testing results:") == 2


def test_basetrainer_defaults():
    """The BaseTrainer's models (dgnet and dgnet_cls among the ported) tile
    evaluation at 800 px and test after every epoch; the config keys
    override both; the DG and whitening families keep patch_size and the
    test on improvement. The reference configs of dgnet say so too."""
    assert {"dgnet", "dgnet_cls"} <= ptrainer.BASETRAINER_MODELS
    for name in ("dgnet", "dgnet_cls", "csrnet", "bl"):
        cfg = Config.from_dict({"model": {"name": name}, "patch_size": 10000})
        assert ptrainer.eval_patch_size(cfg) == 800
        assert ptrainer.every_epoch_test(cfg) is True
        cfg.extra.update(eval_patch_size=512, test_every_epoch=False)
        assert ptrainer.eval_patch_size(cfg) == 512
        assert ptrainer.every_epoch_test(cfg) is False
    for name in ("final", "reg_mem", "isw"):
        cfg = Config.from_dict({"model": {"name": name}, "patch_size": 10000})
        assert ptrainer.eval_patch_size(cfg) == 10000
        assert ptrainer.every_epoch_test(cfg) is False
    for path in ("mall_base.yml", "sta_reg_base.yml", "stb_reg_base.yml", "sta_dis.yml"):
        cfg = load_config(os.path.join(REPO, "configs", path))
        assert ptrainer.eval_patch_size(cfg) == 800 and ptrainer.every_epoch_test(cfg)


def test_dgnet_trains_evaluates_on_800_px_tiles_and_tests_every_epoch(root, tmp_path, capsys):
    """Full-width dgnet, mode simple, through the CLI for two epochs: the
    counter tiles at 800 px (the console says so), a test after each epoch."""
    cfg = _cfg(root, tmp_path / "logs", "dgnet_base", model="dgnet",
               params={"pretrained": False}, mode="simple", scheduler=None)
    path = tmp_path / "dgnet.yml"
    path.write_text(yaml.safe_dump(cfg))
    main(["--config", str(path), "--task", "train_test"])
    out = capsys.readouterr().out
    assert "on tiles of 800 px (patch_size 1440)" in out
    log = open(tmp_path / "logs" / "dgnet_base" / "log.txt").read()
    assert log.count("Testing results:") == 2
    assert all(np.isfinite(float(v)) for _, v in LOSS_LINE.findall(log))


@pytest.fixture
def same_masks(monkeypatch):
    """Both frameworks' dropout2d keep the channels of seeded mask i % 4 at
    their i-th call: the same four masks in every regression step."""
    def mask(i, n, c, keep):
        return np.random.default_rng(2000 + i % 4).random((n, c)) < keep

    calls = {"jax": 0, "torch": 0}
    torch_orig = players.dropout2d

    def jax_drop(x, rate, rng, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        calls["jax"] += 1
        m = mask(calls["jax"] - 1, x.shape[0], x.shape[-1], 1.0 - rate)
        return jnp.where(m[:, None, None, :], x / (1.0 - rate), 0.0)

    def torch_drop(x, rate, generator=None, mask_=None):
        if rate == 0.0:
            return x
        calls["torch"] += 1
        m = mask(calls["torch"] - 1, x.shape[0], x.shape[1], 1.0 - rate)
        return torch_orig(x, rate, mask=torch.from_numpy(m))

    for mod in (jlayers, jreg):
        monkeypatch.setattr(mod, "dropout2d", jax_drop)
    for mod in (players, preg):
        monkeypatch.setattr(mod, "dropout2d", torch_drop)
    return calls


def test_regression_trainer_matches_the_jax_trainer(root, tmp_path, same_masks):
    """Mode regression on the tiny reg_mem for two epochs (two steps each):
    the epoch-0 loss, the test lines and log.txt against the JAX trainer."""
    cfg = _cfg(root, tmp_path, "reg_parity", model="reg_mem",
               params=dict(TINY_REG_MEM, pretrained=False), mode="regression")
    want, got, t = _parity(root, tmp_path, cfg)
    assert same_masks["torch"] == 4 * 4 and same_masks["jax"] % 4 == 0
    _check_against(want, got, test_rtol=1e-3)
    assert t.counter.patch_size == 1440
