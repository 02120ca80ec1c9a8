"""The port's trainer (dgvcc_tpu_torch/train/trainer.py, checkpoint.py and
the CLI's trainer tasks) against the JAX trainer on the CPU, at the tiny
geometry (dgvcc_tpu.testing.TINY_MEM) in float32, on a synthetic dataset
in the canonical layout.

The parity runs use dropout 0 (random streams cannot match across
frameworks), err_thrs 1e9 (the two-view error mask keeps everything) and
cls_thrs -1 (the classifier map is all ones), so no threshold can flip on
noise at the level of the order of summation. The JAX trainer starts from
its own seeded weights; the port gets them through
``dg_state_dict_from_flax``. Tolerances:

  * ``--task test`` MAE and MSE: rtol 1e-4 (float32, other summation
    order); the printed line, 4 decimals, to 1e-4 of the in-process run;
  * the first epoch's training loss (its last step, after one AdamW
    update): rtol 1e-3 (float32 sums; the Adam steps of the VGG conv biases
    differ by rounding noise, tests/test_torch_port_train.py, but a train-
    mode batch norm removes those biases from the loss);
  * ``log.txt``: line for line equal with every number and path masked.
"""

import os
import re
from glob import glob

import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze
from PIL import Image

from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config, load_config
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.checkpoint import load_checkpoint, sidecar_path
from dgvcc_tpu_torch.train.trainer import DGTrainer

SPLITS = TINY_MEM["stage_splits"]
PARITY = dict(TINY_MEM, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs, 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("trainer_data")
    rng = np.random.default_rng(1)
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


def _cfg(root, log_dir, version, geometry=PARITY, **over):
    ds = {"name": "den_cls", "params": {"root": root, "crop_size": 64, "downsample": 1,
                                        "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    d = {"seed": 2112, "version": version, "device": "cpu", "log_para": 1000,
         "patch_size": 1440, "mode": "final", "num_epochs": 2, "checkpoint": None,
         "model": {"name": "final", "params": dict(geometry)},
         "train_dataset": ds, "val_dataset": ds, "test_dataset": ds,
         # no workers: with threads the JAX den_cls second view can take
         # another sample's crop (ROADMAP.md, Queue 3)
         "train_loader": {"batch_size": 2, "num_workers": 0, "shuffle": True},
         "val_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
         "test_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
         "loss": {"name": "mse", "params": {"reduction": "mean"}},
         "optimizer": {"name": "adamw", "params": {"lr": 0.001, "weight_decay": 0.0001}},
         "scheduler": {"name": "cosine", "params": {"T_max": 2, "eta_min": 1e-5}},
         "compute_dtype": "float32", "log_dir": str(log_dir)}
    d.update(over)
    return d


def _yaml(d, path):
    """The config as a YAML file (tuples written as lists)."""
    def lists(v):
        if isinstance(v, dict):
            return {k: lists(x) for k, x in v.items()}
        return [lists(x) for x in v] if isinstance(v, (list, tuple)) else v
    path.write_text(yaml.safe_dump(lists(d)))
    return str(path)


def _log(trainer):
    return open(os.path.join(trainer.log_dir, "log.txt")).read()


def _losses(log):
    return {int(e): float(v) for e, v in LOSS_LINE.findall(log)}


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    """The JAX trainer: its seeded initial weights as a port .pth, --task
    test on them, then a 2-epoch train_and_test."""
    tmp = tmp_path_factory.mktemp("jax_run")
    jt = JaxTrainer(JaxConfig.from_dict(_cfg(root, tmp / "logs", "parity")))
    jt.build()
    init = tmp / "init.pth"
    torch.save(dg_state_dict_from_flax(unfreeze(jt.state.params),
                                       unfreeze(jt.state.batch_stats), SPLITS), init)
    test = jt.test()
    start = len(_log(jt))
    jt.train_and_test()
    return {"init": str(init), "test": test, "log": _log(jt)[start:]}


def test_task_test_matches_the_jax_trainer(root, jax_run, tmp_path, capsys):
    cfg = _cfg(root, tmp_path / "logs", "parity_test")
    t = DGTrainer(Config.from_dict(cfg), device="cpu")
    got = t.test(checkpoint=jax_run["init"])
    for k in ("mae", "mse"):
        np.testing.assert_allclose(got[k], jax_run["test"][k], rtol=1e-4, err_msg=k)
    main(["--config", _yaml(cfg, tmp_path / "cfg.yml"), "--task", "test",
          "--ckpt", jax_run["init"]])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Testing results:")][-1]
    printed = dict(re.findall(r"(\w+): ([\d.]+)", line))
    for k in ("mae", "mse"):
        assert abs(float(printed[k]) - got[k]) <= 1e-4 + 1e-4 * got[k], (k, line)
    assert os.path.exists(tmp_path / "logs" / "parity_test" / "cfg.yml")  # snapshot


def test_train_and_test_matches_the_jax_trainer_and_its_log(root, jax_run, tmp_path):
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path / "logs", "parity")), device="cpu")
    t.build()
    t.model.load_state_dict(torch.load(jax_run["init"], weights_only=True))
    t.train_and_test()
    log = _log(t)
    want, got = _losses(jax_run["log"]), _losses(log)
    assert sorted(got) == sorted(want) == [0, 1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)

    def masked(text):
        text = re.sub(r"/\S+", "<path>", text)
        return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()

    want_lines, got_lines = masked(jax_run["log"]), masked(log)
    assert len(got_lines) == len(want_lines) > 10
    for a, b in zip(got_lines, want_lines):
        assert a == b


def test_two_epoch_train_test_falls_and_writes_checkpoints(root, tmp_path):
    """The final model's own settings (dropout 0.5, thresholds 0.5) for two
    epochs through the CLI. One batch is the whole train set, cropped to 96
    of its 96x112 images, so the two logged losses are the same images'
    before and after one AdamW step (lr 1e-2, two worker threads). A
    version not starting with 'sta' re-saves the test model below MAE 105."""
    geometry = dict(TINY_MEM)
    cfg = _cfg(root, tmp_path / "logs", "e2e", geometry=geometry, scheduler=None,
               train_loader={"batch_size": 4, "num_workers": 2, "shuffle": True},
               optimizer={"name": "adamw", "params": {"lr": 0.01, "weight_decay": 0.0001}})
    cfg["train_dataset"] = dict(cfg["train_dataset"],
                                params=dict(cfg["train_dataset"]["params"], crop_size=96))
    cfg.update(tensorboard=True, test_report=True)
    path = _yaml(cfg, tmp_path / "e2e.yml")
    main(["--config", path, "--task", "train_test"])
    log_dir = tmp_path / "logs" / "e2e"
    log = open(log_dir / "log.txt").read()
    losses = _losses(log)
    assert sorted(losses) == [0, 1] and all(np.isfinite(list(losses.values())))
    assert losses[1] < losses[0], losses
    for pattern in ("last.pth", "best_*.pth", "test_*.pth", "e2e.yml"):
        assert glob(str(log_dir / pattern)), pattern
    assert len(glob(str(log_dir / "best_*.pth"))) == 1  # rotated
    for ckpt in glob(str(log_dir / "*.pth")):
        assert os.path.exists(sidecar_path(ckpt))
        # the reference key layout: the serving path strict-loads it
        VideoCounter.from_checkpoint("final", ckpt, dtype=torch.float32, device="cpu",
                                     **geometry)
    assert "Testing results: mae:" in log and "Saving test model..." in log
    report = open(log_dir / "test_report.csv").read().splitlines()
    assert report[0] == "name,gt_count,pred_count,abs_err" and len(report) == 3
    assert glob(str(log_dir / "tb" / "events.out.tfevents.*"))


def test_resume_from_last_is_exact(root, tmp_path):
    """Three epochs in one run against two, then a resume from last.pth:
    the third epoch starts where the second ended (weights, AdamW moments,
    scheduler, best), draws the same dropout masks and ends bit-equal."""
    cfg = dict(_cfg(root, tmp_path / "logs", "full", geometry=TINY_MEM), num_epochs=3)
    full = DGTrainer(Config.from_dict(cfg), device="cpu")
    full.train()
    cut = DGTrainer(Config.from_dict(dict(cfg, version="cut", num_epochs=2)), device="cpu")
    cut.train()
    last = os.path.join(cut.log_dir, "last.pth")
    resumed = DGTrainer(Config.from_dict(dict(cfg, version="cut", checkpoint=last)),
                        device="cpu")
    resumed.build()
    resumed.load_ckpt(last)
    moments = resumed.state.optimizer.state_dict()["state"]
    for i, s in cut.state.optimizer.state_dict()["state"].items():
        assert torch.equal(moments[i]["exp_avg"], s["exp_avg"])
        assert torch.equal(moments[i]["exp_avg_sq"], s["exp_avg_sq"])
    assert resumed.state.step == cut.state.step > 0
    resumed.train()
    log = _log(resumed)
    assert "Resuming from epoch 1 (best" in log
    assert log.count("Epoch 2: Training loss") == 1 and log.count("Epoch 0: Training") == 1
    assert _losses(log)[2] == _losses(_log(full))[2]
    assert resumed.scheduler.epoch == full.scheduler.epoch == 3
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_early_stop_counts_epochs_without_improvement(root, tmp_path):
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path, "es", early_stop=2)), device="cpu")
    assert not t._early_stop(epoch=2, best_epoch=1, best_criterion=3.0)
    assert t._early_stop(epoch=3, best_epoch=1, best_criterion=3.0)
    assert "Early stopping at epoch 3" in _log(t)
    t.cfg.extra["early_stop"] = 0
    assert not t._early_stop(epoch=30, best_epoch=1, best_criterion=3.0)


def test_checkpoint_load_is_nonstrict_unless_asked(root, tmp_path):
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path / "logs", "ckpt")), device="cpu")
    t.build()
    sd = t.model.state_dict()
    bad = {k: v.clone() for k, v in sd.items() if k != "mem"}
    bad["den_head.0.conv.weight"] = torch.zeros(1, 2, 1, 1)
    bad["extra.weight"] = torch.zeros(3)
    path = str(tmp_path / "bad.pth")
    torch.save(bad, path)
    extra, warnings = load_checkpoint(path, t.state)
    assert extra == {} and len(warnings) == 3
    assert any("missing in checkpoint: mem" in w for w in warnings)
    assert torch.equal(t.model.state_dict()["den_head.0.conv.weight"],
                       sd["den_head.0.conv.weight"])
    with pytest.raises(ValueError, match="strict load failed"):
        t.load_ckpt(path, strict=True)
    with pytest.raises(ValueError, match="not a .pth, .pt or .ckpt"):
        t.load_ckpt(str(tmp_path / "last.msgpack"))
    with pytest.raises(ValueError, match="pair checkpoint must be"):
        t.load_ckpt([path, path, path])


@pytest.mark.parametrize("key,value", [("mesh", {"spatial": 2}), ("mesh", {"model": 2})])
def test_unported_config_keys_raise(root, tmp_path, key, value):
    """Every key of the JAX trainer is ported; the mesh's spatial and model
    axes, outside a torchrun job, raise naming the command that starts one."""
    cfg = _cfg(root, tmp_path, "x")
    cfg[key] = value
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node=2 -m dgvcc_tpu_torch"):
        DGTrainer(Config.from_dict(cfg), device="cpu")


def test_unported_model_family_raises(root, tmp_path):
    """Every family of the JAX package is registered now: a model name the
    registry lacks raises with the registered names."""
    import dgvcc_tpu.models  # noqa: F401
    from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
    from dgvcc_tpu_torch.core.registry import MODELS

    assert all(name in MODELS for name in JAX_MODELS._fns)
    cfg = _cfg(root, tmp_path, "x")
    cfg["model"] = {"name": "no_such_model", "params": {}}
    with pytest.raises(ValueError, match="Unknown model 'no_such_model'"):
        DGTrainer(Config.from_dict(cfg), device="cpu").build()


def test_cli_test_task_needs_a_checkpoint_and_config_device_rules(root, tmp_path):
    path = _yaml(_cfg(root, tmp_path / "logs", "nockpt"), tmp_path / "c.yml")
    with pytest.raises(SystemExit, match="requires a checkpoint"):
        main(["--config", path, "--task", "test"])
    cfg = load_config(path)
    assert ptrainer.config_device(cfg) == "cpu"
    cfg.device = "tpu"
    assert ptrainer.config_device(cfg) == "cuda"
    assert ptrainer.config_device(cfg, "cuda:1") == "cuda:1"


def test_vis_writes_a_figure_per_test_image(root, tmp_path):
    pytest.importorskip("matplotlib")
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path / "logs", "vis")), device="cpu")
    t.vis()
    names = sorted(os.listdir(tmp_path / "logs" / "vis" / "vis"))
    assert "img000.png" in names and "img000_Cls.png" in names and len(names) == 8
