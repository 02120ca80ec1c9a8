"""The bank sharded over a 2-D ``(data, model)`` mesh (``mesh: {data: N,
model: M}``: dgvcc_tpu_torch/parallel/tp.py, parallel/mesh.py's 2-D step,
MemoryBank's ``tp_group``, the trainer) against the JAX package's on the
CPU, in float32.

The port runs as 4 gloo ranks (data 2 x model 2, rank d 2 + m), spawned
once for the file (the rank side is tests/test_torch_port_mesh_ranks.py,
which imports no JAX). The JAX side runs on the suite's virtual CPU
devices. Weights are made with numpy from a seed and reach the port through
nn/convert.py; dropout rates are 0 and the thresholds cannot flip
(err_thrs 1e9, cls_thrs -1). The bank is tests/test_tp2d.py's, 32
prototypes of 16, on the tiny encoder. Tolerances, as the largest absolute
difference over the largest absolute JAX value:

  * the 2-D step (SGD) against JAX's ``build_parallel_train_step_2d`` on
    ``make_mesh_2d(2, 2)``: loss parts 1e-4; parameters and running
    statistics after the step 1e-4, the bank gathered from its columns;
  * the 2-D step against the port's 1-D step over the data group: 1e-5;
  * the eval forward with the bank sharded 4 ways against the JAX plain
    model: 1e-4 (tests/test_tp2d.py:96-121);
  * the bank's round trips, a 2-D checkpoint's resume: bit for bit;
  * the trainer (``train_test``, 1 epoch, SGD with momentum) against the
    JAX trainer with the same mesh: the epoch-0 loss 1e-3, the test line
    1e-4, log.txt line for line with numbers and paths masked.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.parallel import mesh as jmesh
from dgvcc_tpu.parallel.tp import MODEL_AXIS as JAX_MODEL_AXIS
from dgvcc_tpu.testing import TINY
from dgvcc_tpu.train.optim import build_optimizer
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.parallel import launch, multihost, tp
from dgvcc_tpu_torch.parallel.tp import MODEL_AXIS
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_helpers import close, jax_variables
from test_torch_port_mesh_ranks import run_cases
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_parallel_trainer import SGD as SGD_MOMENTUM
from test_torch_port_parallel_trainer import LOSS_LINE, TEST_LINE, data_root  # noqa: F401
from test_torch_port_trainer import _cfg, _yaml

GEOMETRY = dict(TINY, mem_size=32, mem_dim=16)
PARITY = dict(GEOMETRY, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
SPLITS = GEOMETRY["stage_splits"]
SGD = {"name": "sgd", "params": {"lr": 0.05}}
B, HW = 4, 32
MESH = {"data": 2, "model": 2}


def _batch(seed):
    rng = np.random.default_rng(seed)
    img1 = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
    return {"img1": img1,
            "img2": (img1 + 0.5 * rng.normal(size=img1.shape)).astype(np.float32),
            "dmap": rng.uniform(0, 2e-3, (B, HW, HW, 1)).astype(np.float32),
            "bmap": (rng.uniform(size=(B, HW // 16, HW // 16, 1)) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_inputs():
    jm = JAX_MODELS.build("final", **PARITY)
    params, stats = jax_variables(jm, np.random.default_rng(41), hw=(HW, HW))
    image = np.random.default_rng(3).normal(size=(1, HW, HW, 3)).astype(np.float32)
    return {"model": jm, "params": params, "stats": stats, "batch": _batch(10),
            "image": image}


def _tp_cfg(root, log_dir, version, **over):
    return _cfg(root, log_dir, version, mesh=MESH, num_epochs=1, optimizer=SGD_MOMENTUM,
                **over)


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):  # noqa: F811
    """The JAX trainer with mesh: {data: 2, model: 2}: its seeded initial
    weights as a port .pth, then a 1-epoch train_and_test."""
    tmp = tmp_path_factory.mktemp("jax_tp")
    jt = JaxTrainer(JaxConfig.from_dict(_tp_cfg(data_root, tmp / "logs", "tp")))
    jt.build()
    init = tmp / "init.pth"
    torch.save(dg_state_dict_from_flax(unfreeze(jax.device_get(jt.state.params)),
                                       unfreeze(jax.device_get(jt.state.batch_stats)),
                                       SPLITS), init)
    jt.train_and_test()
    return {"init": str(init), "log": open(os.path.join(jt.log_dir, "log.txt")).read()}


def _refusal_cfgs(root, logs):
    """(key, config) of each refusal the 4 ranks build; the rank side
    returns each error's text."""
    base = _tp_cfg(root, logs, "r")
    bank = dict(base["model"]["params"])
    return {
        "no_bank": dict(base, model={"name": "base", "params": bank}),
        "family": dict(base, model={"name": "mcnn", "params": {}}),
        "divide": dict(base, model={"name": "final", "params": dict(bank, mem_size=15)}),
        "tp_axis": dict(base, model={"name": "final", "params": dict(bank, tp_axis="model")}),
        "world": dict(base, mesh={"data": 2, "model": 4}),
        "nodes": base,
    }


@pytest.fixture(scope="module")
def ranks(jax_inputs, data_root, jax_run, tmp_path_factory):  # noqa: F811
    """Every 4-rank case in one gloo group."""
    work = tmp_path_factory.mktemp("tp_ranks")
    logs = work / "logs"
    state_dict = dg_state_dict_from_flax(jax_inputs["params"], jax_inputs["stats"], SPLITS)
    parity = _yaml(_tp_cfg(data_root, logs, "tp"), work / "tp.yml")
    cases = {
        "tp": ("tp", {"params": PARITY, "state_dict": state_dict, "workdir": str(work),
                      "batch": jax_inputs["batch"],
                      "image": np.ascontiguousarray(jax_inputs["image"].transpose(0, 3, 1, 2))}),
        "trainer": ("trainer", {"argv": ["--config", parity, "--task", "train_test",
                                         "--ckpt", jax_run["init"], "--device", "cpu"]}),
    }
    for key, cfg in _refusal_cfgs(data_root, logs).items():
        cases[f"refuse_{key}"] = ("refusals", {"config": cfg,
                                               "local_world": 2 if key == "nodes" else None})
    spec_file(str(work), cases)
    launch.run_ranks(run_cases, 4, (str(work),), init_file=str(work / "init"), timeout=300)
    return {"logs": logs, "parity_cfg": parity, "out": results(str(work), 4)}


def _jax_state(params, stats):
    tx = build_optimizer(SGD)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), tx=tx)


def _hold(got, want, rel, what):
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            close(got[k], w.numpy(), rel, f"{what} {k}")


def test_2d_step_matches_jax_2d_step(jax_inputs, ranks):
    """Loss parts and the model after one SGD step, the bank reassembled
    from its columns, against JAX's 2-D step on make_mesh_2d(2, 2)."""
    jm_tp = JAX_MODELS.build("final", tp_axis=JAX_MODEL_AXIS, **PARITY)
    mesh = jmesh.make_mesh_2d(2, 2)
    step = jmesh.build_parallel_train_step_2d(jm_tp, JAX_LOSSES.build("mse"), "final", 1000.0,
                                              mesh, donate=False)
    state = jmesh.shard_state_2d(mesh, _jax_state(jax_inputs["params"], jax_inputs["stats"]))
    state, metrics = step(state, dict(jax_inputs["batch"]), jax.random.PRNGKey(0),
                          jnp.int32(0))
    state = jax.device_get(state)
    want = dg_state_dict_from_flax(unfreeze(state.params), unfreeze(state.batch_stats), SPLITS)
    for r in ranks["out"]:
        got = r["tp"]["2d"]
        assert set(got["metrics"]) == set(metrics)
        for k, v in metrics.items():
            close(got["metrics"][k], float(v), 1e-4, k)
        _hold(got["state_dict"], want, 1e-4, "2-D")
    before = dg_state_dict_from_flax(jax_inputs["params"], jax_inputs["stats"], SPLITS)
    assert not torch.equal(ranks["out"][0]["tp"]["2d"]["state_dict"]["mem"], before["mem"])


def test_2d_step_matches_the_ports_1d_step(ranks):
    """The same rows through the port's 1-D step over the data group, the
    bank whole: 1e-5; each rank kept its own 16 columns of the bank."""
    for rank, r in enumerate(ranks["out"]):
        got, want = r["tp"]["2d"], r["tp"]["1d"]
        for k, v in want["metrics"].items():
            close(got["metrics"][k], v, 1e-5, k)
        _hold(got["state_dict"], want["state_dict"], 1e-5, "2-D vs 1-D")
        m = rank % 2
        assert torch.equal(r["tp"]["local_mem"], got["state_dict"]["mem"][..., 16 * m:16 * m + 16])


def test_tp_eval_forward_matches_the_plain_model(jax_inputs, ranks):
    """The bank sharded over the 4 ranks (8 prototypes each), eval mode,
    against the JAX tp-free model: the density map and the classifier map."""
    variables = {"params": jax_inputs["params"], "batch_stats": jax_inputs["stats"]}
    d, c = jax_inputs["model"].apply(variables, jnp.asarray(jax_inputs["image"]))
    for r in ranks["out"]:
        close(r["tp"]["eval"]["d"].permute(0, 2, 3, 1), np.asarray(d), 1e-4, "density")
        close(r["tp"]["eval"]["c"].permute(0, 2, 3, 1), np.asarray(c), 1e-4, "cls")


def test_bank_round_trip_and_the_2d_checkpoint(ranks):
    """shard / gather round trips bit for bit; a 2-D checkpoint holds the
    whole bank, strict-loads into one process, and loads back into a fresh
    2-D state bit for bit (parameters, AdamW moments, EMA)."""
    for r in ranks["out"]:
        assert r["tp"]["round_trip"]
        res = r["tp"]["resume"]
        assert res["local_shape"] == (1, 16, 16)
        assert res["state_dict"] and res["moments"] and res["ema"]
    path = ranks["out"][0]["tp"]["resume"]["path"]
    sd = torch.load(path, weights_only=True)
    assert sd["mem"].shape == (1, 16, 32)
    side = torch.load(path.replace(".pth", ".state.pt"), weights_only=True)
    assert side["ema"]["mem"].shape == (1, 16, 32)
    assert any(v.get("exp_avg", torch.zeros(0)).shape == (1, 16, 32)
               for v in side["optimizer"]["state"].values())
    one = MODELS.build("final", **PARITY)
    one.load_state_dict(sd, strict=True)


def test_cli_train_test_matches_the_jax_trainer_and_its_log(ranks, jax_run, capsys):
    """4 torchrun-like ranks of the CLI against the JAX trainer with the
    same mesh; log.txt written once, with JAX's mesh line; the 4-rank test
    equals one process's --task test of the same last.pth."""
    log = open(ranks["logs"] / "tp" / "log.txt").read()
    want_loss, got_loss = dict(LOSS_LINE.findall(jax_run["log"])), dict(LOSS_LINE.findall(log))
    assert sorted(got_loss) == sorted(want_loss) == ["0"]
    np.testing.assert_allclose(float(got_loss["0"]), float(want_loss["0"]), rtol=1e-3)
    want_test, got_test = TEST_LINE.findall(jax_run["log"]), TEST_LINE.findall(log)
    assert len(got_test) == len(want_test) == 1
    np.testing.assert_allclose(np.float64(got_test[0]), np.float64(want_test[0]), rtol=1e-4)
    assert log.count("2-D mesh: data=2 x model=2 (memory bank sharded)") == 1

    def masked(text):
        text = re.sub(r"/\S+", "<path>", text)
        return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()

    got_lines = [ln for ln in masked(log) if not ln.startswith("Loading checkpoint from")]
    assert got_lines == masked(jax_run["log"])
    for r in ranks["out"]:
        assert r["trainer"]["steps"] == [0, 0]  # 4 train images, 2 a step
    raw = yaml.safe_load(open(ranks["parity_cfg"]))
    raw.pop("mesh")
    one = _yaml(dict(raw, version="one"), ranks["logs"] / "one.yml")
    main(["--config", one, "--task", "test", "--ckpt", str(ranks["logs"] / "tp" / "last.pth")])
    line = TEST_LINE.findall(capsys.readouterr().out)[-1]
    np.testing.assert_allclose(np.float64(line), np.float64(got_test[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key,message", [
    ("no_bank", "has no memory bank to shard (use_mem=False)"),
    ("family", "model 'mcnn' has no model-axis sharding surface (tp_axis)"),
    ("divide", "mem_size 15 does not divide over model=2 shards"),
    ("tp_axis", "model params must not set tp_axis — use mesh: {data: N, model: M} instead"),
    ("world", "mesh: {data: 2, model: 4} needs 8 ranks but the job has 4"),
    ("nodes", "mesh model-axis sharding is single-node for now")])
def test_the_2d_refusals_raise_with_jax_messages(key, message, ranks):
    for r in ranks["out"]:
        assert message in r[f"refuse_{key}"]


@pytest.mark.parametrize("mode,message", [
    ("joint", "mesh: {model: 2} is not supported for joint mode"),
    ("regression", "mesh: {model: 2} is not supported for mode 'regression'"),
    ("discrimination", "mesh: {model: 2} is not supported for mode 'discrimination'")])
def test_the_model_axis_refuses_joint_and_custom_loss_modes(mode, message, data_root,  # noqa: F811
                                                            tmp_path):
    cfg = Config.from_dict(_tp_cfg(data_root, tmp_path, "x", mode=mode))
    with pytest.raises(ValueError, match=re.escape(message)):
        ptrainer.check_ported(cfg)


def test_2d_mesh_outside_torchrun_raises_with_the_command(data_root, tmp_path,  # noqa: F811
                                                          monkeypatch, capsys):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node=4 -m dgvcc_tpu_torch"):
        DGTrainer(Config.from_dict(_tp_cfg(data_root, tmp_path, "x")), device="cpu")
    path = _yaml(_tp_cfg(data_root, tmp_path, "x"), tmp_path / "x.yml")
    # vis and generate run in one process, the 2-D mesh ignored (generate
    # then refuses the mode, not the mesh); aot still refuses the mesh
    main(["--config", path, "--task", "vis", "--device", "cpu"])
    assert {"img000.png", "img001.png"} <= set(os.listdir(tmp_path / "x" / "vis"))
    with pytest.raises(ValueError, match="generate requires mode 'generation' or 'joint'"):
        main(["--config", path, "--task", "generate", "--device", "cpu"])
    out = capsys.readouterr().out
    for task in ("vis", "generate"):
        assert (f"[mesh] --task {task} runs in one process on one card: mesh: {{data: 2, "
                "model: 2} is ignored for it") in out
    with pytest.raises(SystemExit, match=re.escape("--task aot with mesh: {data: 2, model: 2}")):
        main(["--config", path, "--task", "aot", "--shapes", "1x64x64", "--out",
              str(tmp_path / "x.aot"), "--device", "cpu"])
    # serving on a mesh is ported: the data axis's 2 ranks, as the JAX command
    # line serves it; outside torchrun it names the command
    with pytest.raises(SystemExit, match=r"--task serve: .*torchrun --nproc_per_node=2 .*serve"):
        main(["--config", path, "--task", "serve", "--frames", str(tmp_path), "--device",
              "cpu"])


def test_the_tp_modules_stand_alone():
    """The isolation scan reaches parallel/tp.py and spatial.py and the
    ranks' side of these tests."""
    from pathlib import Path

    from test_torch_port_isolation import PORT, _banned, _imports

    files = [PORT / "parallel" / "tp.py", PORT / "parallel" / "spatial.py",
             Path(__file__).with_name("test_torch_port_mesh_ranks.py")]
    assert not [(f.name, n) for f in files for n in _imports(f) if _banned(n)]
    assert MODEL_AXIS == JAX_MODEL_AXIS
    assert tp.MODEL_AXIS == "model"
