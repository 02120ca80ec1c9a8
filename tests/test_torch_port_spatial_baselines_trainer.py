"""Spatial sharding of the convolutional baselines through the trainer
(``mesh: {spatial: N}`` with mcnn: dgvcc_tpu_torch/train/trainer.py,
parallel/spatial.py's row rules and refusals) against the JAX trainer on
the CPU, in float32.

The port runs as 2 gloo ranks, spawned once for the file (the rank side is
tests/test_torch_port_spatial_baselines_ranks.py, which imports no JAX):
``train_test`` of mcnn (1 epoch, SGD with momentum, crops of 64 with
``downsample: 4`` as tests/test_spatial.py runs it) against the JAX trainer
with mesh: {spatial: 2}: the epoch-0 loss 1e-3, the test line 1e-4; the
2-rank run's last.pth through one process's ``--task test`` 1e-4. A spatial
step whose target map's height does not divide by N raises, and so do the
families and modes not ported yet (ROADMAP.md, Queue 1 item 1).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.parallel import launch, spatial
from dgvcc_tpu_torch.train import trainer as ptrainer
from test_torch_port_baselines import CCTRANS
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_parallel_trainer import LOSS_LINE, SGD as SGD_MOMENTUM, TEST_LINE
from test_torch_port_parallel_trainer import data_root  # noqa: F401
from test_torch_port_spatial_baselines import FAMILIES, _batch
from test_torch_port_spatial_baselines_ranks import run_cases
from test_torch_port_trainer import _cfg, _yaml


def _sp_cfg(root, log_dir, version):
    ds = {"name": "den", "params": {"root": root, "crop_size": 64, "downsample": 4,
                                    "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    return _cfg(root, log_dir, version, mesh={"spatial": 2}, num_epochs=1,
                optimizer=SGD_MOMENTUM, mode="simple", model={"name": "mcnn", "params": {}},
                train_dataset=ds, val_dataset=ds, test_dataset=ds)


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):  # noqa: F811
    """The JAX trainer of mcnn with mesh: {spatial: 2}: its seeded initial
    weights as a port .pth, then a 1-epoch train_and_test."""
    tmp = tmp_path_factory.mktemp("jax_sp_mcnn")
    jt = JaxTrainer(JaxConfig.from_dict(_sp_cfg(data_root, tmp / "logs", "sp")))
    jt.build()
    init = tmp / "init.pth"
    torch.save(state_dict_from_flax(MODELS.build("mcnn"),
                                    unfreeze(jax.device_get(jt.state.params)),
                                    unfreeze(jax.device_get(jt.state.batch_stats))), init)
    jt.train_and_test()
    return {"init": str(init), "log": open(os.path.join(jt.log_dir, "log.txt")).read()}


@pytest.fixture(scope="module")
def ranks(data_root, jax_run, tmp_path_factory):  # noqa: F811
    """The trainer and the refusal cases on 2 ranks, one launch."""
    work = tmp_path_factory.mktemp("spb_trainer")
    logs = work / "logs"
    cfg = _yaml(_sp_cfg(data_root, logs, "sp"), work / "sp.yml")
    model = MODELS.build("mcnn")
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = _batch("mcnn", 1)
    batch["dmap"] = batch["dmap"][:, :15]  # 15 rows: not divisible by 2
    short = {"name": "mcnn", "params": {}, "state_dict": model.state_dict(), "batch": batch}
    spec_file(str(work), {
        "trainer": ("trainer", {"argv": ["--config", cfg, "--task", "train_test", "--ckpt",
                                         jax_run["init"], "--device", "cpu"]}),
        "unsharded_target": ("unsharded_target", {"family": short})})
    launch.run_ranks(run_cases, 2, (str(work),), init_file=str(work / "init"), timeout=600)
    return {"logs": logs, "cfg": cfg, 2: results(str(work), 2)}


def test_a_target_that_was_not_sharded_raises(ranks):
    for r in ranks[2]:
        assert "the target map's height must divide by" in (r["unsharded_target"] or "")


def test_cli_train_test_of_mcnn_matches_the_jax_trainer(ranks, jax_run):
    log = open(ranks["logs"] / "sp" / "log.txt").read()
    want_loss, got_loss = dict(LOSS_LINE.findall(jax_run["log"])), dict(LOSS_LINE.findall(log))
    assert sorted(got_loss) == sorted(want_loss) == ["0"]
    np.testing.assert_allclose(float(got_loss["0"]), float(want_loss["0"]), rtol=1e-3)
    want_test, got_test = TEST_LINE.findall(jax_run["log"]), TEST_LINE.findall(log)
    assert len(got_test) == len(want_test) == 1
    np.testing.assert_allclose(np.float64(got_test[0]), np.float64(want_test[0]), rtol=1e-4)
    assert "Spatial parallel over 2 devices" in log
    for r in ranks[2]:
        assert r["trainer"]["steps"] == [0, 0]  # 4 train images, 2 a step


def test_row_rules_of_the_families():
    assert {n: spatial.row_rule(MODELS.get(n)) for n in FAMILIES if n != "sasnet"} == {
        "mcnn": 4, "csrnet": 8, "bl": 16, "dssinet": 16}
    assert spatial.row_rule(MODELS.build("sasnet", block_size=48)) == 48  # lcm(16, 48)
    with pytest.raises(ValueError, match="pick a crop_size that is a multiple of 128"):
        spatial.check_rank_rows(96, 4, 32)


# every family still refused: the whitening family, the regressors, the
# generator and CCTrans (ROADMAP.md, Queue 1 item 1)
REFUSED = ("sw", "ibn", "isw", "sw_vgg", "sw_densenet", "ibn_densenet", "dgnet", "dgnet_cls",
           "reg", "reg_mem", "gen", "gen0", "cctrans")


@pytest.mark.parametrize("name", REFUSED)
def test_the_families_not_ported_raise_with_the_queue_pointer(name):
    params = CCTRANS if name == "cctrans" else {}
    model = MODELS.build(name, **params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 1") as err:
        spatial.shard_height(model, None)
    assert f"for model '{type(model).__name__}' is not ported" in str(err.value)


@pytest.mark.parametrize("mode", ["isw", "regression", "discrimination", "generation"])
def test_the_modes_not_ported_raise_with_the_queue_pointer(mode, data_root,  # noqa: F811
                                                          tmp_path):
    cfg = Config.from_dict(_cfg(data_root, tmp_path, "x", mesh={"spatial": 2}, mode=mode))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 1"):
        ptrainer.check_ported(cfg)


def test_one_process_test_of_the_spatial_run(ranks, capsys):
    """The 2-rank run's last.pth through one process's --task test gives its
    test line."""
    from dgvcc_tpu_torch.cli.main import main

    raw = yaml.safe_load(open(ranks["cfg"]))
    raw.pop("mesh")
    one = _yaml(dict(raw, version="one"), ranks["logs"] / "one.yml")
    main(["--config", one, "--task", "test", "--ckpt", str(ranks["logs"] / "sp" / "last.pth")])
    line = TEST_LINE.findall(capsys.readouterr().out)[-1]
    got = TEST_LINE.findall(open(ranks["logs"] / "sp" / "log.txt").read())[0]
    np.testing.assert_allclose(np.float64(line), np.float64(got), rtol=1e-4, atol=1e-4)


def test_the_rank_side_and_the_sharded_modules_stand_alone():
    """The isolation scan reaches the modules this slice changed and the
    ranks' side of these tests: no JAX, nothing of the JAX package."""
    from pathlib import Path

    from test_torch_port_isolation import PORT, _banned, _imports

    files = [PORT / "parallel" / "spatial.py", PORT / "nn" / "collectives.py",
             PORT / "nn" / "layers.py", PORT / "losses" / "bayesian.py",
             Path(__file__).with_name("test_torch_port_spatial_baselines_ranks.py")]
    assert not [(f.name, n) for f in files for n in _imports(f) if _banned(n)]
