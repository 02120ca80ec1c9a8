"""The data-parallel trainer (``mesh: {data: N}``) through the port's
command line against the JAX trainer, and its refusals, on the CPU.

Two gloo ranks, spawned once for the file (the rank side is
tests/test_torch_port_parallel_ranks.py, which imports no JAX), each run
the port's ``main`` as a torchrun rank runs ``python -m dgvcc_tpu_torch``:
a ``train_test`` from the JAX trainer's seeded initial weights, against
the JAX trainer with ``mesh: {data: 2}`` on the suite's virtual CPU
devices; then a 2-epoch ``train``, the same run stopped by a SIGTERM on
rank 1 alone, and its resume from ``last.pth``. The models are the tiny
``final`` geometry in float32 with dropout 0 and thresholds that cannot
flip (tests/test_torch_port_trainer.py).

The optimizer is SGD with momentum (see ``SGD``). Tolerances: the epoch-0
training loss 1e-3 and the test lines 1e-4 (as the one-process trainer's
parity, tests/test_torch_port_trainer.py), log.txt line for line with
numbers and paths masked, written once; the resumed run bit for bit.
"""

import os
import re

import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.parallel import multihost
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_parallel_ranks import results, run_cases, spec_file
from test_torch_port_trainer import PARITY, SPLITS, _cfg, _yaml

LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")
TEST_LINE = re.compile(r"Testing results: mae: ([\d.]+) mse: ([\d.]+)")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """96x112 JPEGs, 12 head points each, their maps (4 train, 2 val, 2 test)."""
    from PIL import Image

    from dgvcc_tpu_torch.ops import dmap

    root = tmp_path_factory.mktemp("dp_trainer_data")
    rng = np.random.default_rng(1)
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        (root / split).mkdir()
        for k in range(n):
            Image.fromarray(rng.uniform(0, 255, (96, 112, 3)).astype(np.uint8)).save(
                root / split / f"img{k:03d}.jpg")
            pts = rng.uniform(0, [112, 96], (12, 2)).astype(np.float32)
            np.save(root / split / f"img{k:03d}.npy", pts)
            np.save(root / split / f"img{k:03d}_dmap.npy",
                    dmap.gaussian_density_fixed_np((96, 112), pts))
    return str(root)


# SGD, not AdamW: Adam's first steps move a weight whose gradient is
# rounding noise (the VGG conv biases before a train-mode batch norm) by
# +-lr either way, which moves a trained criterion by 1e-3 (ROADMAP.md,
# Queue 3's traps)
SGD = {"name": "sgd", "params": {"lr": 0.01, "momentum": 0.9}}


def _dp_cfg(root, log_dir, version, **over):
    return _cfg(root, log_dir, version, mesh={"data": 2}, num_epochs=1, optimizer=SGD,
                **over)


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):
    """The JAX trainer with mesh: {data: 2}: its seeded initial weights as a
    port .pth, then a 1-epoch train_and_test."""
    tmp = tmp_path_factory.mktemp("jax_dp")
    jt = JaxTrainer(JaxConfig.from_dict(_dp_cfg(data_root, tmp / "logs", "dp")))
    jt.build()
    init = tmp / "init.pth"
    torch.save(dg_state_dict_from_flax(unfreeze(jt.state.params),
                                       unfreeze(jt.state.batch_stats), SPLITS), init)
    jt.train_and_test()
    return {"init": str(init), "log": open(os.path.join(jt.log_dir, "log.txt")).read()}


@pytest.fixture(scope="module")
def ranks(data_root, jax_run, tmp_path_factory):
    """Every 2-rank trainer run in one gloo group."""
    work = tmp_path_factory.mktemp("dp_trainer")
    logs = work / "logs"
    parity = _yaml(_dp_cfg(data_root, logs, "dp"), work / "dp.yml")
    two = dict(_dp_cfg(data_root, logs, "full", geometry=PARITY), num_epochs=2)
    full = _yaml(two, work / "full.yml")
    cut = _yaml(dict(two, version="cut"), work / "cut.yml")
    cpu = ["--device", "cpu"]
    spec_file(str(work), {
        "parity": ("trainer", {"argv": ["--config", parity, "--task", "train_test",
                                        "--ckpt", jax_run["init"], *cpu]}),
        "full": ("trainer", {"argv": ["--config", full, "--task", "train", *cpu]}),
        # rank 1 alone takes a SIGTERM during its first step of epoch 1
        "cut": ("trainer", {"argv": ["--config", cut, "--task", "train", *cpu],
                            "signal_at": (1, 1, 1)}),
        "resume": ("trainer", {"argv": ["--config", cut, "--task", "train", "--ckpt",
                                        str(logs / "cut" / "last.pth"), *cpu]}),
        "world": ("refusals", {"config": dict(_dp_cfg(data_root, logs, "w"),
                                              mesh={"data": 4})}),
    })
    launch.run_ranks(run_cases, 2, (str(work),), init_file=str(work / "init"), timeout=300)
    return {"logs": logs, "parity_cfg": parity, "out": results(str(work), 2)}


def _masked(text):
    text = re.sub(r"/\S+", "<path>", text)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()


def test_cli_train_test_matches_the_jax_trainer_and_its_log(ranks, jax_run, capsys):
    log = open(ranks["logs"] / "dp" / "log.txt").read()
    want_loss = dict(LOSS_LINE.findall(jax_run["log"]))
    got_loss = dict(LOSS_LINE.findall(log))
    assert sorted(got_loss) == sorted(want_loss) == ["0"]
    np.testing.assert_allclose(float(got_loss["0"]), float(want_loss["0"]), rtol=1e-3)
    want_test, got_test = TEST_LINE.findall(jax_run["log"]), TEST_LINE.findall(log)
    assert len(got_test) == len(want_test) == 1
    np.testing.assert_allclose(np.float64(got_test[0]), np.float64(want_test[0]), rtol=1e-4)
    # written once, by rank 0; the port's only extra line is its checkpoint load
    assert log.count("Data parallel over 2 devices") == 1
    got_lines = [ln for ln in _masked(log) if not ln.startswith("Loading checkpoint from")]
    want_lines = _masked(jax_run["log"])
    assert len(got_lines) == len(want_lines) > 10
    for a, b in zip(got_lines, want_lines):
        assert a == b
    assert {s for r in ranks["out"] for s in r["parity"]["steps"]} == {0}
    assert [len(r["parity"]["steps"]) for r in ranks["out"]] == [2, 2]
    # the 2-rank test equals one process's --task test of the same `last`
    cfg = yaml.safe_load(open(ranks["parity_cfg"]))
    cfg.pop("mesh")
    one = _yaml(dict(cfg, version="one"), ranks["logs"] / "one.yml")
    main(["--config", one, "--task", "test", "--ckpt",
          str(ranks["logs"] / "dp" / "last.pth")])
    line = TEST_LINE.findall(capsys.readouterr().out)[-1]
    np.testing.assert_allclose(np.float64(line), np.float64(got_test[0]), rtol=1e-4, atol=1e-4)


def test_a_stop_on_one_rank_stops_both_at_the_same_step_and_resumes_exactly(ranks):
    out = ranks["out"]
    for r in out:
        assert r["full"]["steps"] == [0, 0, 1, 1]
        assert r["cut"]["steps"] == [0, 0, 1]  # the second step of epoch 1 never ran
        assert r["resume"]["steps"] == [1, 1]
    log = open(ranks["logs"] / "cut" / "log.txt").read()
    assert "Received signal" not in log  # rank 1's handler; rank 0 logs alone
    assert "Preemption: last.pth stays at epoch 0" in log
    assert "Resuming from epoch 0" in log
    full = torch.load(ranks["logs"] / "full" / "last.pth", weights_only=True)
    resumed = torch.load(ranks["logs"] / "cut" / "last.pth", weights_only=True)
    assert full.keys() == resumed.keys()
    for k in full:
        assert torch.equal(full[k], resumed[k]), k


def test_a_mesh_of_another_size_than_the_job_raises(ranks):
    for r in ranks["out"]:
        assert "mesh: {data: 4} but the job has 2 ranks" in r["world"]
        assert "torchrun --nproc_per_node=4" in r["world"]


def test_mesh_data_outside_torchrun_raises_with_the_command(data_root, tmp_path, monkeypatch,
                                                           capsys):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node=2 -m dgvcc_tpu_torch"):
        DGTrainer(Config.from_dict(_dp_cfg(data_root, tmp_path, "x")), device="cpu")
    path = _yaml(_dp_cfg(data_root, tmp_path, "x"), tmp_path / "x.yml")
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--config", path, "--task", "train", "--device", "cpu"])
    # vis and generate run in one process, the mesh ignored, as the JAX
    # command line runs them (generate then refuses the mode, not the mesh)
    main(["--config", path, "--task", "vis", "--device", "cpu"])
    assert {"img000.png", "img001.png"} <= set(os.listdir(tmp_path / "x" / "vis"))
    with pytest.raises(ValueError, match="generate requires mode 'generation' or 'joint'"):
        main(["--config", path, "--task", "generate", "--device", "cpu"])
    out = capsys.readouterr().out
    for task in ("vis", "generate"):
        assert (f"[mesh] --task {task} runs in one process on one card: mesh: {{data: 2}} "
                "is ignored for it") in out
    # serving on a mesh is ported: outside torchrun it names the command
    with pytest.raises(SystemExit, match=r"--task serve: .*torchrun --nproc_per_node=2 .*serve"):
        main(["--config", path, "--task", "serve", "--frames", str(tmp_path), "--device",
              "cpu"])


@pytest.mark.parametrize("mesh,mode,error,message", [
    ({"model": 2}, "regression", ValueError, "not supported for mode 'regression'"),
    ({"spatial": 8}, "generation", NotImplementedError, "Queue 1 item 1"),
    ({"data": 2, "model": 2}, "discrimination", ValueError,
     "not supported for mode 'discrimination'"),
    ({"data": 2, "spatial": 2}, "final", ValueError, "does not compose"),
    ({"spatial": 2}, "joint", ValueError, "not supported for joint mode"),
    ({"model": 2}, "joint", ValueError, "not supported for joint mode")])
def test_the_mesh_axes_not_ported_and_the_jax_refusals_raise(mesh, mode, error, message,
                                                             data_root, tmp_path):
    cfg = Config.from_dict(_cfg(data_root, tmp_path, "x", mesh=mesh, mode=mode))
    with pytest.raises(error, match=message):
        ptrainer.check_ported(cfg)


def test_nccl_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="pass --dist-backend gloo"):
        multihost.initialize_distributed("nccl", "cuda")
    with pytest.raises(ValueError, match="takes the gloo backend"):
        multihost.initialize_distributed("nccl", "cpu")
