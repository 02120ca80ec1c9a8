"""Spatial sharding of the crop's height (``mesh: {spatial: N}``:
dgvcc_tpu_torch/parallel/spatial.py, the sharded layers of nn/layers.py and
models/dg.py, the trainer) against the JAX package's on the CPU, in
float32.

The port runs as 2 gloo ranks and as 4, each group spawned once for the
file (the rank side is tests/test_torch_port_mesh_ranks.py, which imports
no JAX). The JAX side runs on the suite's virtual CPU devices. ``final``
is tests/test_spatial.py's bank (16 prototypes of 8) on the tiny encoder,
at two-view 64^2 crops (32 rows a rank on 2 ranks, 16 on 4); weights are
made with numpy from a seed and reach the port through nn/convert.py.
Tolerances, as the largest absolute difference over the largest absolute
reference value:

  * the first step (SGD, dropout 0, thresholds that cannot flip) against
    JAX's ``build_spatial_train_step`` on a 2-device spatial mesh and
    against JAX's one-device step: loss parts 1e-5, parameters after the
    step 1e-4, batch-norm running statistics 1e-5;
  * the first step with dropout 0.5 against the port's one-process step
    drawing from a generator seeded the same: loss parts and running
    statistics 1e-5, parameters 1e-4 (the spatial ranks draw the
    one-process masks);
  * the sharded layers alone (halo convolutions, bilinear x2 and x4, the
    instance norm, the batch norm) against the whole tensor in one process:
    output and input gradient 1e-6;
  * the trainer (``train_test``, 1 epoch, SGD with momentum, 2 ranks)
    against the JAX trainer with mesh: {spatial: 2}: the epoch-0 loss 1e-3,
    the test line 1e-4, log.txt line for line with numbers and paths
    masked, but for the mesh line, which names the port's halo exchange.
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
from dgvcc_tpu.parallel import spatial as jspatial
from dgvcc_tpu.parallel.mesh import replicate
from dgvcc_tpu.testing import TINY
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu.train.optim import build_optimizer
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
import dgvcc_tpu_torch.losses  # noqa: F401
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.models.dg import DGModel
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d, instance_norm, upsample
from dgvcc_tpu_torch.parallel import launch, multihost, spatial
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_train_step
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_baselines import CCTRANS
from test_torch_port_helpers import close, jax_variables, nchw
from test_torch_port_mesh_ranks import layer_inputs, run_cases
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_parallel_trainer import SGD as SGD_MOMENTUM
from test_torch_port_parallel_trainer import LOSS_LINE, TEST_LINE, data_root  # noqa: F401
from test_torch_port_trainer import _cfg, _yaml

GEOMETRY = dict(TINY, mem_size=16, mem_dim=8)
PARITY = dict(GEOMETRY, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
DROPOUT = dict(GEOMETRY, den_dropout=0.5, cls_dropout=0.5)
SPLITS = GEOMETRY["stage_splits"]
SGD = {"name": "sgd", "params": {"lr": 0.05}}
B, HW = 2, 64
SEED = 17
WORLDS = (2, 4)
MESH_LINE = ("Spatial parallel over 2 devices (crop height sharded, halo exchange by "
             "send/recv over torch.distributed)")
JAX_MESH_LINE = "Spatial parallel over 2 devices (crop height sharded, GSPMD halo exchange)"


def _batch(seed):
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    return {"img1": img1,
            "img2": (img1 + 0.5 * rng.normal(size=img1.shape)).astype(np.float32),
            "dmap": rng.uniform(0, 0.01, (B, HW, HW, 1)).astype(np.float32),
            "bmap": (rng.uniform(size=(B, HW // 16, HW // 16, 1)) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_inputs():
    rng = np.random.default_rng(42)
    params, stats = jax_variables(JAX_MODELS.build("final", **PARITY), rng, hw=(HW, HW))
    return {"params": params, "stats": stats, "batch": _batch(11),
            "state_dict": dg_state_dict_from_flax(params, stats, SPLITS)}


def _sp_cfg(root, log_dir, version, **over):
    return _cfg(root, log_dir, version, mesh={"spatial": 2}, num_epochs=1,
                optimizer=SGD_MOMENTUM, **over)


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):  # noqa: F811
    """The JAX trainer with mesh: {spatial: 2}: its seeded initial weights
    as a port .pth, then a 1-epoch train_and_test."""
    tmp = tmp_path_factory.mktemp("jax_sp")
    jt = JaxTrainer(JaxConfig.from_dict(_sp_cfg(data_root, tmp / "logs", "sp")))
    jt.build()
    init = tmp / "init.pth"
    torch.save(dg_state_dict_from_flax(unfreeze(jax.device_get(jt.state.params)),
                                       unfreeze(jax.device_get(jt.state.batch_stats)),
                                       SPLITS), init)
    jt.train_and_test()
    return {"init": str(init), "log": open(os.path.join(jt.log_dir, "log.txt")).read()}


@pytest.fixture(scope="module")
def ranks(jax_inputs, data_root, jax_run, tmp_path_factory):  # noqa: F811
    """The cases of each group size, 2 ranks and 4, one launch each."""
    out = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"sp_ranks{world}")
        step = {"params": PARITY, "state_dict": jax_inputs["state_dict"],
                "batch": jax_inputs["batch"]}
        cases = {"parity": ("spatial_step", step),
                 "dropout": ("spatial_step", dict(step, params=DROPOUT, seed=SEED)),
                 "layers": ("spatial_layers", layer_inputs())}
        if world == 2:
            logs = work / "logs"
            cfg = _yaml(_sp_cfg(data_root, logs, "sp"), work / "sp.yml")
            cases["trainer"] = ("trainer", {"argv": ["--config", cfg, "--task", "train_test",
                                                     "--ckpt", jax_run["init"], "--device",
                                                     "cpu"]})
            out["logs"], out["cfg"] = logs, cfg
            for key, cfg in _refusal_cfgs(data_root, logs).items():
                cases[f"refuse_{key}"] = ("refusals", {"config": cfg,
                                                       "local_world": 1 if key == "nodes"
                                                       else None})
        spec_file(str(work), cases)
        launch.run_ranks(run_cases, world, (str(work),), init_file=str(work / "init"),
                         timeout=300)
        out[world] = results(str(work), world)
    return out


def _refusal_cfgs(root, logs):
    base = _sp_cfg(root, logs, "r")
    return {"family": dict(base, model={"name": "cctrans", "params": CCTRANS}),
            "rows": dict(base, train_dataset=dict(base["train_dataset"], params=dict(
                base["train_dataset"]["params"], crop_size=48))),
            "world": dict(base, mesh={"spatial": 4}),
            "nodes": base}


def _jax_state(params, stats):
    tx = build_optimizer(SGD)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), tx=tx)


@pytest.fixture(scope="module")
def jax_steps(jax_inputs):
    """JAX's first step of ``final`` (SGD) on a 2-device spatial mesh and on
    one device: (metrics, the port state_dict after it) of each."""
    jm = JAX_MODELS.build("final", **PARITY)
    loss = JAX_LOSSES.build("mse")
    batch = jax_inputs["batch"]
    out = {}
    mesh = jspatial.make_spatial_mesh(2)
    sharded = jspatial.build_spatial_train_step(jm, loss, "final", 1000.0, mesh, donate=False)
    single = jax.jit(jsteps.build_train_step(jm, loss, "final", 1000.0))
    for key, run in (
            ("spatial", lambda s: sharded(replicate(mesh, s), dict(batch),
                                          jax.random.PRNGKey(0), jnp.int32(0))),
            ("one", lambda s: single(s, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(0), jnp.int32(0)))):
        state, metrics = run(_jax_state(jax_inputs["params"], jax_inputs["stats"]))
        state = jax.device_get(state)
        out[key] = ({k: float(v) for k, v in metrics.items()},
                    dg_state_dict_from_flax(unfreeze(state.params),
                                            unfreeze(state.batch_stats), SPLITS))
    return out


def _hold(got, want, rel_params, rel_stats, params):
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            close(got[k], w.numpy(), rel_params if k in params else rel_stats, k)


PARAM_NAMES = [n for n, _ in MODELS.build("final", **PARITY).named_parameters()]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reference", ["spatial", "one"])
def test_spatial_step_matches_jax(world, reference, ranks, jax_steps):
    """The first step on ``world`` ranks against JAX's spatial step and its
    one-device step: the same loss parts, parameters and running
    statistics; every rank holds the same model."""
    metrics, want = jax_steps[reference]
    got = ranks[world][0]["parity"]
    assert set(got["metrics"]) == set(metrics)
    for k, v in metrics.items():
        close(got["metrics"][k], v, 1e-5, k)
    _hold(got["state_dict"], want, 1e-4, 1e-5, PARAM_NAMES)
    for r in ranks[world][1:]:
        for k, v in got["state_dict"].items():
            assert torch.equal(r["parity"]["state_dict"][k], v), k


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_ranks_draw_the_one_process_masks(world, jax_inputs, ranks):
    """Dropout 0.5, every rank's generator seeded as the one-process step's:
    the ranks' step is the one-process step."""
    model = MODELS.build("final", **DROPOUT)
    model.load_state_dict(jax_inputs["state_dict"], strict=True)
    state = create_train_state(model, SGD, device="cpu")
    step = build_train_step(model, LOSSES.build("mse"), "final", 1000.0)
    batch = {k: nchw(v) for k, v in jax_inputs["batch"].items()}
    _, metrics = step(state, batch, torch.Generator().manual_seed(SEED), 0)
    got = ranks[world][0]["dropout"]
    for k, v in metrics.items():
        close(got["metrics"][k], float(v), 1e-5, k)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    _hold(got["state_dict"], want, 1e-4, 1e-5, PARAM_NAMES)
    # the masks did drop: the step differs from the dropout-free one
    assert abs(got["metrics"]["loss_total"] - ranks[world][0]["parity"]["metrics"]
               ["loss_total"]) > 1e-3


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["conv", "dilated", "up2", "up4", "instance_norm", "bn"])
def test_sharded_layers_match_the_whole_tensor(name, world, ranks):
    """Each rank's rows of the output and of the input gradient of
    sum(y * w), concatenated, against the layer on the whole tensor."""
    spec = layer_inputs()
    x = torch.from_numpy(spec["x"]).requires_grad_()
    if name in ("conv", "dilated"):
        layer = Conv2d(x.shape[1], 6, 3, padding=1 if name == "conv" else 2,
                       dilation=1 if name == "conv" else 2, bias=name == "conv")
        layer.load_state_dict(spec[name])
    elif name == "bn":
        layer = BatchNorm2d(x.shape[1])
        layer.load_state_dict(spec["bn"])
    else:
        layer = {"up2": lambda t: upsample(t, 2), "up4": lambda t: upsample(t, 4),
                 "instance_norm": instance_norm}[name]
    y = layer(x)
    (y * torch.from_numpy(spec["w"][name])).sum().backward()
    parts = [r["layers"][name] for r in ranks[world]]
    close(torch.cat([p["y"] for p in parts], dim=2), y.detach().numpy(), 1e-6, f"{name} y")
    close(torch.cat([p["dx"] for p in parts], dim=2), x.grad.numpy(), 1e-6, f"{name} dx")
    if name == "bn":
        for k, v in layer.named_buffers():
            got = ranks[world][0]["layers"]["bn_buffers"][k]
            if k == "num_batches_tracked":
                assert torch.equal(got, v)
            else:
                close(got, v.numpy(), 1e-6, k)


def test_batch_placement_follows_jax():
    """Image keys shard on the height; a low-resolution key whose height
    does not divide, and the other keys, stay whole; an image whose height
    does not divide raises with JAX's text (tests/test_spatial.py:102-121)."""
    batch = {"img1": np.arange(2 * 64 * 48 * 3, dtype=np.float32).reshape(2, 64, 48, 3),
             "bmap": np.zeros((2, 4, 4, 1), np.float32),
             "isw_masks": np.zeros((3, 16, 16), np.float32)}
    parts = [spatial.shard_batch_spatial(batch, r, 8) for r in range(8)]
    np.testing.assert_array_equal(np.concatenate([p["img1"] for p in parts], axis=1),
                                  batch["img1"])
    assert parts[3]["img1"].shape == (2, 8, 48, 3)
    for k in ("bmap", "isw_masks"):
        assert parts[5][k] is batch[k]
    dmap = spatial.shard_batch_spatial({"dmap": np.zeros((2, 64, 64, 1))}, 1, 8)["dmap"]
    assert dmap.shape == (2, 8, 64, 1)
    with pytest.raises(ValueError, match="divisible") as err:
        spatial.shard_batch_spatial({"img1": np.zeros((2, 60, 48, 3), np.float32)}, 0, 8)
    with pytest.raises(ValueError, match="divisible") as want:
        jspatial.shard_batch_spatial(jspatial.make_spatial_mesh(8),
                                     {"img1": np.zeros((2, 60, 48, 3), np.float32)})
    assert str(err.value) == str(want.value)
    nchw_batch = {"img1": torch.zeros(2, 3, 64, 48)}
    assert spatial.shard_batch_spatial(nchw_batch, 1, 4, dim=2)["img1"].shape == (2, 3, 16, 48)


def test_a_ranks_rows_must_pool_to_whole_rows():
    rule = DGModel.row_rule
    spatial.check_rank_rows(1024, 8, rule)
    spatial.check_rank_rows(64, 4, rule)
    with pytest.raises(ValueError, match="pick a crop_size that is a multiple of 128"):
        spatial.check_rank_rows(320, 8, rule)


def test_cli_train_test_matches_the_jax_trainer_and_its_log(ranks, jax_run, capsys):
    """2 ranks of the CLI against the JAX trainer with mesh: {spatial: 2}:
    log.txt written once, line for line but the mesh line; the 2-rank test
    equals one process's --task test of the same last.pth."""
    log = open(ranks["logs"] / "sp" / "log.txt").read()
    want_loss, got_loss = dict(LOSS_LINE.findall(jax_run["log"])), dict(LOSS_LINE.findall(log))
    assert sorted(got_loss) == sorted(want_loss) == ["0"]
    np.testing.assert_allclose(float(got_loss["0"]), float(want_loss["0"]), rtol=1e-3)
    want_test, got_test = TEST_LINE.findall(jax_run["log"]), TEST_LINE.findall(log)
    assert len(got_test) == len(want_test) == 1
    np.testing.assert_allclose(np.float64(got_test[0]), np.float64(want_test[0]), rtol=1e-4)
    assert log.count(MESH_LINE) == 1 and jax_run["log"].count(JAX_MESH_LINE) == 1

    def masked(text, line):
        text = text.replace(line, "<mesh>")
        text = re.sub(r"/\S+", "<path>", text)
        return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()

    got_lines = [ln for ln in masked(log, MESH_LINE)
                 if not ln.startswith("Loading checkpoint from")]
    assert got_lines == masked(jax_run["log"], JAX_MESH_LINE)
    for r in ranks[2]:
        assert r["trainer"]["steps"] == [0, 0]  # 4 train images, 2 a step
    raw = yaml.safe_load(open(ranks["cfg"]))
    raw.pop("mesh")
    one = _yaml(dict(raw, version="one"), ranks["logs"] / "one.yml")
    main(["--config", one, "--task", "test", "--ckpt", str(ranks["logs"] / "sp" / "last.pth")])
    line = TEST_LINE.findall(capsys.readouterr().out)[-1]
    np.testing.assert_allclose(np.float64(line), np.float64(got_test[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key,message", [
    ("family", "mesh: {spatial: N} for model 'ALTGVT' is not ported"),
    ("rows", "needs each rank's rows to be a multiple of 16"),
    ("world", "mesh: {spatial: 4} but the job has 2 ranks"),
    ("nodes", "mesh spatial-axis sharding is single-node for now")])
def test_the_spatial_refusals_raise_in_a_job(key, message, ranks):
    for r in ranks[2]:
        assert message in (r[f"refuse_{key}"] or ""), r[f"refuse_{key}"]


@pytest.mark.parametrize("mesh,mode,error,message", [
    ({"spatial": 2, "data": 2}, "final", ValueError, "does not compose with data/model axes"),
    ({"spatial": 2, "model": 2}, "final", ValueError, "does not compose with data/model axes"),
    ({"spatial": 2}, "joint", ValueError, "not supported for joint mode"),
    ({"spatial": 2}, "isw", NotImplementedError, "Queue 1 item 1"),
    ({"spatial": 2}, "regression", NotImplementedError, "Queue 1 item 1")])
def test_the_spatial_refusals_of_the_config(mesh, mode, error, message,
                                            data_root, tmp_path):  # noqa: F811
    cfg = Config.from_dict(_cfg(data_root, tmp_path, "x", mesh=mesh, mode=mode))
    with pytest.raises(error, match=message):
        ptrainer.check_ported(cfg)


def test_the_step_and_the_switch_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        spatial.shard_height(MODELS.build("cctrans", **CCTRANS), None)
    model = MODELS.build("final", **PARITY)
    # the Bayesian loss shards now (tests/test_torch_port_spatial_baselines.py);
    # a loss function of a mode's own does not
    for mode, loss_fn in (("isw", None), ("final", lambda *a: None)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
            spatial.build_spatial_train_step(model, LOSSES.build("mse"), mode, 1000.0, None,
                                             loss_fn=loss_fn)


def test_spatial_mesh_outside_torchrun_raises_with_the_command(data_root, tmp_path,  # noqa: F811
                                                               monkeypatch):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node=2 -m dgvcc_tpu_torch"):
        DGTrainer(Config.from_dict(_sp_cfg(data_root, tmp_path, "x")), device="cpu")
