"""The rest of the `final` training surface in the port, against the JAX
package on the CPU: gradient accumulation (``accum_steps``), EMA shadow
weights (``ema``), ``async_save``, the preemption stop, the JAX
package's msgpack ``.ckpt``, ``pretrained_weights`` and ``profile_epoch``
(dgvcc_tpu_torch/train/state.py, checkpoint.py, jax_ckpt.py, trainer.py,
nn/convert.py, serve.py).

Tolerances, float32:

  * accumulation and EMA against the JAX ``TrainState`` with
    ``optax.MultiSteps``, on the same injected gradients: rtol 1e-6, atol
    1e-7 (torch.optim's AdamW rounds its denominator in another order than
    optax); parameters held inside a window exactly;
  * a checkpoint round trip, a resume inside a window, a resume after a
    preemption: bit for bit;
  * the JAX ``.ckpt`` reader against the ``msgpack`` package on the same
    bytes: equal values, dtypes and shapes; counts of a ``VideoCounter``
    served from a JAX ``last.ckpt`` against the JAX counter's: rtol 1e-4;
  * ``pretrained_weights``: the port's install and the JAX install,
    through the bridge, exactly;
  * ``sta_final_bigcrop.yml`` shrunk in width: the training losses of the
    JAX trainer's epochs 0 and 1 (accumulated over 4 micro steps, the
    EMA on): rtol 1e-3, as tests/test_torch_port_trainer.py.
"""

import os
import re
import signal
import threading
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization
from flax.core import unfreeze
from PIL import Image

import dgvcc_tpu_torch.train.checkpoint as pckpt
from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.nn.torch_io import load_pretrained_backbone
from dgvcc_tpu.serve import VideoCounter as JaxVideoCounter
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu.train.optim import build_optimizer as jax_build_optimizer
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax, install_pretrained
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, feature_layout
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train import jax_ckpt
from dgvcc_tpu_torch.train.checkpoint import (AsyncWriter, CheckpointRotator,
                                              load_checkpoint, save_checkpoint,
                                              sidecar_path)
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_helpers import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = TINY_MEM["stage_splits"]
PARITY = dict(TINY_MEM, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")


# ------------------------------------------------------------ state level

class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([0.5, -0.25, 1.0, 2.0]))
        self.b = torch.nn.Parameter(torch.tensor([[0.1, 0.2], [0.3, -0.4]]))


SPECS = {"adamw": {"name": "adamw", "params": {"lr": 1e-2, "weight_decay": 1e-2}},
         "adam": {"name": "adam", "params": {"lr": 1e-2, "weight_decay": 1e-3}},
         "sgd": {"name": "sgd", "params": {"lr": 1e-2, "momentum": 0.9}}}


def _pair(spec, k, ema):
    """The port's TrainState and the JAX one (MultiSteps for k > 1, the
    EMA at d^(1/k)) on the same parameters."""
    model = Tiny()
    port = create_train_state(model, spec, device="cpu", accum_steps=k, ema=ema)
    params = {n: jnp.asarray(p.detach().numpy().copy()) for n, p in model.named_parameters()}
    tx = jax_build_optimizer(spec)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    jst = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params), tx=tx,
                        ema_params=jax.tree.map(jnp.copy, params) if ema else None,
                        ema_decay=jnp.asarray(ema ** (1.0 / k), jnp.float32) if ema else None)
    return port, jst


def _grads(rng, model):
    return {n: rng.normal(0, 1, tuple(p.shape)).astype(np.float32)
            for n, p in model.named_parameters()}


def _micro_step(port, jst, g):
    for n, p in port.model.named_parameters():
        p.grad = torch.from_numpy(g[n].copy())
    port.apply_gradients()
    return jst.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})


def _assert_params(port, tree, what):
    for n, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[n]), err_msg=f"{what} {n}",
                                   **TOL)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("opt", list(SPECS))
def test_accumulation_and_ema_match_jax_multisteps(opt, k):
    """A window of k micro steps and the next one's first: the parameters
    hold inside the window and move on its k-th step as optax.MultiSteps
    moves them (one update from the mean gradient, held to 1e-6), the EMA
    follows the JAX shadow at d^(1/k) every micro step, and
    TrainState.step counts micro steps. Later updates are not held to
    1e-6: optax forms Adam's bias corrections in float32 (1 - 0.999 is
    1.3e-5 off there), torch.optim in float64, so each update differs by
    up to 6.4e-6 of its size."""
    port, jst = _pair(SPECS[opt], k, ema=0.9)
    rng = np.random.default_rng(k + len(opt))
    for m in range(1, k + 2):
        before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
        jst = _micro_step(port, jst, _grads(rng, port.model))
        held = all(torch.equal(before[n], p) for n, p in port.model.named_parameters())
        assert held == (m % k != 0), m
        if m <= k:
            _assert_params(port, jst.params, f"params after micro step {m}")
        _assert_params_tree(port.ema_params, jst.ema_params, f"ema after micro step {m}")
        assert port.step == int(jst.step) == m
        assert port.mini_step == m % k


def _assert_params_tree(port_tree, jax_tree, what):
    for n, v in port_tree.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jax_tree[n]), err_msg=f"{what} {n}",
                                   **TOL)


def test_learning_rate_set_inside_a_window_reaches_the_update():
    """TrainState.set_learning_rate as the trainer calls it at an epoch's
    start, here in the middle of a window, against the JAX state's."""
    port, jst = _pair(SPECS["adamw"], 3, ema=0.0)
    rng = np.random.default_rng(3)
    jst = _micro_step(port, jst, _grads(rng, port.model))
    port.set_learning_rate(0.03125)
    jst = jst.set_learning_rate(0.03125)
    for _ in range(2):
        jst = _micro_step(port, jst, _grads(rng, port.model))
    assert float(jst.opt_state.inner_opt_state.hyperparams["learning_rate"]) == 0.03125
    _assert_params(port, jst.params, "after the window")


def test_ema_is_a_copy_and_off_by_default_and_validated():
    port, _ = _pair(SPECS["sgd"], 1, ema=0.5)
    for n, p in port.model.named_parameters():
        assert torch.equal(port.ema_params[n], p) and port.ema_params[n] is not p
        assert port.ema_params[n].data_ptr() != p.data_ptr()
    plain, _ = _pair(SPECS["sgd"], 1, ema=0.0)
    assert plain.ema_params is None and plain.acc_grads is None
    with pytest.raises(ValueError, match="ema must be in"):
        create_train_state(Tiny(), SPECS["sgd"], device="cpu", ema=1.5)
    with pytest.raises(ValueError, match="accum_steps"):
        create_train_state(Tiny(), SPECS["sgd"], device="cpu", accum_steps=0)


def test_checkpoint_inside_a_window_resumes_exactly(tmp_path):
    """A save after 2 of 3 micro steps carries the running mean, the window
    position, the moments and the EMA: the resumed state ends the window
    where the uninterrupted one does, bit for bit."""
    rng = np.random.default_rng(5)
    grads = [_grads(rng, Tiny()) for _ in range(6)]
    full, _ = _pair(SPECS["adamw"], 3, ema=0.8)
    for g in grads:
        _micro_step(full, _pair(SPECS["adamw"], 1, 0.0)[1], g)
    cut, _ = _pair(SPECS["adamw"], 3, ema=0.8)
    for g in grads[:4]:
        _micro_step(cut, _pair(SPECS["adamw"], 1, 0.0)[1], g)
    path = str(tmp_path / "mid.pth")
    save_checkpoint(path, cut, {"epoch": 1})
    resumed, _ = _pair(SPECS["adamw"], 3, ema=0.8)
    extra, warnings = load_checkpoint(path, resumed, strict=True)
    assert extra == {"epoch": 1} and warnings == []
    assert resumed.mini_step == 1 and resumed.step == 4
    for g in grads[4:]:
        _micro_step(resumed, _pair(SPECS["adamw"], 1, 0.0)[1], g)
    for n, p in full.model.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[n]), n
        assert torch.equal(full.ema_params[n], resumed.ema_params[n]), n


def test_ema_checkpoint_round_trip_and_seeding_warnings(tmp_path):
    """A saved shadow comes back; an EMA-less checkpoint seeds the shadow
    from its weights; a shadow into an EMA-less run is ignored; strict
    loads accept all three (the shadow is derived state)."""
    rng = np.random.default_rng(6)
    src, _ = _pair(SPECS["adam"], 1, ema=0.7)
    for _ in range(3):
        _micro_step(src, _pair(SPECS["adam"], 1, 0.0)[1], _grads(rng, src.model))
    with_ema = str(tmp_path / "ema.pth")
    save_checkpoint(with_ema, src)
    back, _ = _pair(SPECS["adam"], 1, ema=0.7)
    assert load_checkpoint(with_ema, back, strict=True)[1] == []
    for n, e in src.ema_params.items():
        assert torch.equal(back.ema_params[n], e)
    off, _ = _pair(SPECS["adam"], 1, ema=0.0)
    warnings = load_checkpoint(with_ema, off, strict=True)[1]
    assert off.ema_params is None and any("ema is off" in w for w in warnings)

    plain, _ = _pair(SPECS["adam"], 1, ema=0.0)
    _micro_step(plain, _pair(SPECS["adam"], 1, 0.0)[1], _grads(rng, plain.model))
    no_ema = str(tmp_path / "plain.pth")
    save_checkpoint(no_ema, plain)
    seeded, _ = _pair(SPECS["adam"], 1, ema=0.7)
    warnings = load_checkpoint(no_ema, seeded, strict=True)[1]
    assert any("seeded" in w for w in warnings)
    for n, p in seeded.model.named_parameters():
        assert torch.equal(seeded.ema_params[n], p) and torch.equal(p, dict(
            plain.model.named_parameters())[n])
    # a reference .pth has no sidecar: the shadow is seeded too
    os.remove(sidecar_path(no_ema))
    again, _ = _pair(SPECS["adam"], 1, ema=0.7)
    assert any("seeded" in w for w in load_checkpoint(no_ema, again)[1])


# ------------------------------------------------------------ async_save

def _state_mid_window():
    rng = np.random.default_rng(9)
    st, _ = _pair(SPECS["adamw"], 3, ema=0.9)
    for _ in range(4):
        _micro_step(st, _pair(SPECS["adamw"], 1, 0.0)[1], _grads(rng, st.model))
    return st


def _assert_same_tree(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _files(path):
    return [torch.load(p, weights_only=True) for p in (path, sidecar_path(path))]


def test_async_save_writes_what_a_sync_save_writes(tmp_path):
    """The state is cloned when the save is submitted: a step taken before
    the writer runs does not reach the file."""
    st = _state_mid_window()
    (tmp_path / "sync").mkdir()
    save_checkpoint(str(tmp_path / "sync" / "last.pth"), st, {"epoch": 3, "best": 1.5})
    writer = AsyncWriter()
    gate = threading.Event()
    writer.submit(gate.wait)  # holds the writer until the state has moved
    rot = CheckpointRotator(str(tmp_path), writer=writer)
    rot.save_last(st, {"epoch": 3, "best": 1.5})
    _micro_step(st, _pair(SPECS["adamw"], 1, 0.0)[1], _grads(np.random.default_rng(1), st.model))
    gate.set()
    rot.flush()
    for a, b in zip(_files(str(tmp_path / "last.pth")),
                    _files(str(tmp_path / "sync" / "last.pth"))):
        _assert_same_tree(a, b)
    writer.close()


def test_async_rotation_keeps_only_the_newest_best(tmp_path):
    writer = AsyncWriter()
    rot = CheckpointRotator(str(tmp_path), writer=writer)
    st = _state_mid_window()
    rot.save_best(st, 1, 9.5)
    rot.save_best(st, 2, 8.25)
    rot.save_last(st)
    rot.flush()
    assert sorted(os.listdir(tmp_path)) == ["best_2_8.2500.pth", "best_2_8.2500.state.pt",
                                            "last.pth", "last.state.pt"]
    writer.close()


def test_async_writer_surfaces_a_job_error_and_stays_usable():
    writer = AsyncWriter()
    done = []

    def boom():
        raise OSError("disk full")

    writer.submit(boom)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.flush()
    writer.submit(lambda: done.append(1))
    writer.flush()
    assert done == [1]
    writer.submit(boom)
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.submit(lambda: None)  # the next submit surfaces it too
    writer.close()


# ------------------------------------------------------------ trainer level

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs, 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("extras_data")
    rng = np.random.default_rng(4)
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


def _cfg(root, log_dir, version, geometry=TINY_MEM, **over):
    ds = {"name": "den_cls", "params": {"root": root, "crop_size": 64, "downsample": 1,
                                        "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    d = {"seed": 31, "version": version, "device": "cpu", "log_para": 1000,
         "patch_size": 1440, "mode": "final", "num_epochs": 2, "checkpoint": None,
         "model": {"name": "final", "params": dict(geometry)},
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


def _trainer(cfg):
    return DGTrainer(Config.from_dict(cfg), device="cpu")


def _log(trainer):
    return open(os.path.join(trainer.log_dir, "log.txt")).read()


def _losses(log):
    return {int(e): float(v) for e, v in LOSS_LINE.findall(log)}


def _weights(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_trainer_carries_a_window_across_epochs_and_through_last(root, tmp_path):
    """accum_steps 3 with 2 micro steps an epoch: epoch 0 leaves the weights
    where they started and the window at 2 of 3; epoch 1's first step
    ends the window. A resume from epoch 0's last.pth ends at the same
    weights, EMA and moments as the uninterrupted run, bit for bit."""
    cfg = _cfg(root, tmp_path, "window", accum_steps=3, ema=0.9)
    full = _trainer(cfg)
    full.build()
    start = _weights(full.model)
    full.train(num_epochs=1)
    assert full.state.mini_step == 2 and full.state.step == 2
    for k, v in full.model.named_parameters():
        assert torch.equal(v, start[k]), k
    full.train(checkpoint=os.path.join(full.log_dir, "last.pth"), num_epochs=2)
    assert full.state.mini_step == 1 and full.state.step == 4

    cut = _trainer(dict(cfg, version="window_cut"))
    cut.train(num_epochs=1)
    resumed = _trainer(dict(cfg, version="window_cut"))
    resumed.train(checkpoint=os.path.join(cut.log_dir, "last.pth"), num_epochs=2)
    assert "Resuming from epoch 0" in _log(resumed)
    assert _losses(_log(resumed))[1] == _losses(_log(full))[1]
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k, e in full.state.ema_params.items():
        assert torch.equal(e, resumed.state.ema_params[k]), k
    assert not any(torch.equal(v, start[k]) for k, v in full.model.named_parameters()
                   if k.endswith("conv.weight"))


def test_validation_test_and_vis_evaluate_the_ema_weights(root, tmp_path):
    """The trainer's counts are those of a model holding the shadow; the
    raw weights come back after."""
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.ops.tiling import TiledCounter

    t = _trainer(_cfg(root, tmp_path, "ema_eval", ema=0.5, num_epochs=1))
    t.train()
    raw = _weights(t.model)
    twin = MODELS.build("final", **TINY_MEM)
    twin.load_state_dict(t.state.ema_state_dict())
    counter = TiledCounter(twin, 1000.0, 1440, device="cpu")
    samples = list(t.loaders["val"])
    want = np.mean([abs(counter.count(s["img1"]) - len(s["gt"])) for s in samples])
    got = t.validate(9, 1e10)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert t.test()["mae"] > 0
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, raw[k]), k
    plain = TiledCounter(t.model, 1000.0, 1440, device="cpu")
    assert abs(np.mean([abs(plain.count(s["img1"]) - len(s["gt"])) for s in samples])
               - want) > 1e-6


def test_async_save_trains_like_sync_and_flushes_when_the_loop_raises(root, tmp_path,
                                                                      monkeypatch):
    sync = _trainer(_cfg(root, tmp_path, "sync", num_epochs=1))
    sync.train()
    deferred = _trainer(_cfg(root, tmp_path, "async", num_epochs=1, async_save=True))
    assert deferred.ckpt_writer is not None
    deferred.train()
    for name in ("last.pth",):
        a = _files(os.path.join(sync.log_dir, name))
        b = _files(os.path.join(deferred.log_dir, name))
        _assert_same_tree(a[0], b[0])
        _assert_same_tree(a[1]["optimizer"], b[1]["optimizer"])

    # a write still queued when epoch 1 raises reaches the disk
    slow = pckpt._write

    def slow_write(*a):
        time.sleep(0.3)
        slow(*a)

    monkeypatch.setattr(pckpt, "_write", slow_write)
    t = _trainer(_cfg(root, tmp_path, "async_raise", async_save=True))
    t.build()
    epoch = t.train_epoch

    def failing(e, *a):
        if e == 1:
            raise RuntimeError("loader died")
        return epoch(e, *a)

    t.train_epoch = failing
    with pytest.raises(RuntimeError, match="loader died"):
        t.train()
    extra, _ = load_checkpoint(os.path.join(t.log_dir, "last.pth"), t.state)
    assert extra["epoch"] == 0


class _Loader:
    """The train loader, raising SIGTERM as batch ``batch_at`` of epoch
    ``epoch_at`` is fetched."""

    def __init__(self, inner, epoch, batch):
        self.inner, self.epoch_at, self.batch_at = inner, epoch, batch

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def close(self):
        self.inner.close()

    def __iter__(self):
        for i, b in enumerate(self.inner):
            if self.inner.epoch == self.epoch_at and i == self.batch_at:
                signal.raise_signal(signal.SIGTERM)
            yield b


@pytest.mark.parametrize("batch", [0, 1])
def test_sigterm_mid_epoch_keeps_last_at_the_previous_epoch_and_resumes_exactly(
        root, tmp_path, batch):
    """SIGTERM as batch 0 or 1 of epoch 1 is fetched: the run stops with
    last.pth at epoch 0 (as epoch 0 ended; batch 1 comes after a step of
    epoch 1, which is dropped), ends cleanly and puts the signal handlers
    back; a resume from last.pth gives the uninterrupted run's epoch-1
    loss and weights, bit for bit."""
    cfg = _cfg(root, tmp_path, "full", ema=0.9, accum_steps=3)
    full = _trainer(cfg)
    full.train()
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    cut = _trainer(dict(cfg, version=f"cut{batch}"))
    cut.build()
    cut.loaders["train"] = _Loader(cut.loaders["train"], epoch=1, batch=batch)
    cut.train()
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    log = _log(cut)
    assert f"Received signal {int(signal.SIGTERM)}" in log
    assert ("Preemption: saved last.pth at epoch 0 (mid-epoch stop)" if batch == 0 else
            "Preemption: last.pth stays at epoch 0 (mid-epoch stop; the 1 steps of "
            "epoch 1 are dropped)") in log
    assert "Epoch 1: Training loss" not in log
    last = os.path.join(cut.log_dir, "last.pth")
    assert torch.load(sidecar_path(last), weights_only=True)["extra"]["epoch"] == 0
    resumed = _trainer(dict(cfg, version=f"cut{batch}"))
    resumed.train(checkpoint=last)
    assert _losses(_log(resumed))[1] == _losses(_log(full))[1]
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sigterm_between_epochs_finishes_the_epoch_and_stops(root, tmp_path):
    t = _trainer(_cfg(root, tmp_path, "between", num_epochs=3))
    t.build()
    validate = t.validate

    def signalled(epoch, best):
        if epoch == 0:
            signal.raise_signal(signal.SIGTERM)
        return validate(epoch, best)

    t.validate = signalled
    t.train()
    log = _log(t)
    assert "Epoch 0: Val criterion" in log and "Epoch 1: Training loss" not in log
    assert "Preemption: stopped in or after epoch 0; resume from last.pth" in log
    last = os.path.join(t.log_dir, "last.pth")
    assert torch.load(sidecar_path(last), weights_only=True)["extra"]["epoch"] == 0
    assert "End training at" in log


def test_shutdown_handlers_are_installed_from_the_main_thread_only(root, tmp_path):
    t = _trainer(_cfg(root, tmp_path, "thread"))
    before = signal.getsignal(signal.SIGTERM)
    errors = []

    def run():
        try:
            with t._graceful_shutdown():
                assert signal.getsignal(signal.SIGTERM) == before
        except Exception as e:  # reported to the test's thread
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and errors == []
    with t._graceful_shutdown():
        assert signal.getsignal(signal.SIGTERM) != before
    assert signal.getsignal(signal.SIGTERM) == before


def test_profile_epoch_writes_a_trace(root, tmp_path):
    t = _trainer(_cfg(root, tmp_path, "prof", num_epochs=2, profile_epoch=1))
    t.train()
    trace = os.path.join(t.log_dir, "trace", "epoch1.pt.trace.json")
    assert os.path.getsize(trace) > 0
    assert '"traceEvents"' in open(trace).read(4096)
    assert f"[profiler] tracing epoch 1 -> {os.path.dirname(trace)}" in _log(t)


def test_device_aug_needs_an_mse_den_dataset_and_draws_per_epoch(root, tmp_path,
                                                                  monkeypatch):
    """device_aug trains on RawCropDataset batches with draws of their own
    stream: a resumed epoch draws what the uninterrupted run drew. A train
    set without density maps, or another loss than MSE, raises."""
    cfg = _cfg(root, tmp_path, "aug", device_aug=True)
    bad = _trainer(dict(cfg, version="bad"))
    monkeypatch.setattr(ptrainer.LOSSES, "build",
                        lambda *a, **k: type("Bay", (), {"kind": "bay"})())
    with pytest.raises(ValueError, match="device_aug needs an MSE-mode"):
        bad.build()
    monkeypatch.undo()
    full = _trainer(cfg)
    full.train()
    assert type(full.loaders["train"].dataset).__name__ == "RawCropDataset"
    assert full.loaders["train"].dataset.pre_crop == 64 + 64
    cut = _trainer(dict(cfg, version="aug_cut"))
    cut.train(num_epochs=1)
    resumed = _trainer(dict(cfg, version="aug_cut"))
    resumed.train(checkpoint=os.path.join(cut.log_dir, "last.pth"))
    assert _losses(_log(resumed))[1] == _losses(_log(full))[1]


def test_process_workers_train_as_threads_do_and_end_with_the_run(root, tmp_path):
    """worker_mode: process for the train and val loaders gives the thread
    run's batches, so its losses and val MAE bit for bit; the trainer
    forks the workers at build and ends them when the run ends (under a
    time limit of 120 s, the pools closed in a finally)."""
    threads = _trainer(_cfg(root, tmp_path, "threads",
                            train_loader={"batch_size": 2, "num_workers": 2, "shuffle": True},
                            val_loader={"batch_size": 1, "num_workers": 2}))
    threads.train()
    procs = _trainer(_cfg(root, tmp_path, "procs",
                          train_loader={"batch_size": 2, "num_workers": 2, "shuffle": True,
                                        "worker_mode": "process"},
                          val_loader={"batch_size": 1, "num_workers": 2,
                                      "worker_mode": "process"}))
    try:
        with time_limit():
            procs.build()
            workers = [w for k in ("train", "val") for w in procs.loaders[k]._pool._pool]
            assert len(workers) == 4
            procs.train()
    finally:
        procs._close_loaders()
    assert all(loader._pool is None for loader in procs.loaders.values())
    for w in workers:
        w.join(timeout=30)
        assert not w.is_alive()

    def numbers(log):
        return re.findall(r"(?:Training loss|Val criterion): (\S+)", log)

    assert numbers(_log(procs)) == numbers(_log(threads)) and len(numbers(_log(procs))) == 4


# ------------------------------------------------------------ JAX .ckpt

def _deep_equal(a, b, where=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.astype(np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _deep_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_equal(x, y, f"{where}/{i}")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


PLAIN_DOCS = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -1.5, 3.14159, float("inf"), 1e-300],
    "strings": ["", "a", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é∑", "k" * 70000],
    "bins": [b"", b"\x00\x01", bytes(300), bytes(70000)],
    "containers": {"list": list(range(15)), "long": list(range(16)), "big": list(range(70000)),
                   "map": {str(i): i for i in range(15)}, "big_map": {str(i): i for i in range(17)},
                   "nested": [{"a": [None, True, False]}, []], "nil": None},
}


@pytest.mark.parametrize("doc", list(PLAIN_DOCS))
def test_msgpack_reader_matches_the_msgpack_package(doc):
    data = msgpack.packb(PLAIN_DOCS[doc], use_bin_type=True)
    _deep_equal(jax_ckpt.unpackb(data), msgpack.unpackb(data, raw=False))
    single = msgpack.packb([1.25, -2.5], use_single_float=True)
    _deep_equal(jax_ckpt.unpackb(single), msgpack.unpackb(single))


FLAX_TREES = {
    "dtypes": {k: np.array([[0, 1, -2], [3, 4, 250]]).astype(k) for k in
               ("float32", "float64", "float16", "int8", "int16", "int32", "int64",
                "uint8", "uint32", "bool")},
    "bfloat16": {"w": np.asarray(jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16))},
    "scalars": {"step": np.asarray(7, np.int32), "f": np.float32(0.5), "i": np.int64(-3),
                "extra": {"epoch": np.asarray(4), "best": np.asarray(12.5),
                          "scheduler": {"epoch": 5}}},
    "shapes": {"empty": np.zeros((0, 4), np.float32), "scalar": np.asarray(1.5, np.float32),
               "big": np.random.default_rng(0).normal(size=(70, 300)).astype(np.float32)},
}


@pytest.mark.parametrize("tree", list(FLAX_TREES))
def test_reader_matches_flax_msgpack_restore(tree):
    data = serialization.msgpack_serialize(FLAX_TREES[tree])
    _deep_equal(jax_ckpt.unpackb(data), serialization.msgpack_restore(data))


def test_reader_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(4, 25), "b": {"c": np.ones(3)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _deep_equal(jax_ckpt.unpackb(data), serialization.msgpack_restore(data))
    _deep_equal(jax_ckpt.unpackb(data), tree)


def test_reader_rejects_what_flax_does_not_write():
    with pytest.raises(ValueError, match="truncated"):
        jax_ckpt.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="after the document"):
        jax_ckpt.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="ext type 9"):
        jax_ckpt.unpackb(msgpack.packb(msgpack.ExtType(9, b"x")))


@pytest.fixture(scope="module")
def jax_ckpt_run(root, tmp_path_factory):
    """The JAX trainer at the tiny width with `ema: 0.9`, one epoch of
    train: its last.ckpt, and the JAX counter's counts from it."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    cfg = _cfg(root, tmp / "logs", "jaxrun", ema=0.9, num_epochs=1)
    jt = JaxTrainer(JaxConfig.from_dict(cfg))
    jt.train()
    last = os.path.join(jt.log_dir, "last.ckpt")
    frames = np.random.default_rng(2).integers(0, 256, (2, 96, 112, 3), dtype=np.uint8)
    counts = JaxVideoCounter.from_checkpoint("final", last, dtype=jnp.float32,
                                             **TINY_MEM).count_frames(frames)
    return {"last": last, "frames": frames, "counts": np.asarray(counts), "trainer": jt,
            "cfg": cfg}


def test_video_counter_serves_a_jax_ckpt_with_its_ema(jax_ckpt_run, capsys):
    loaded = jax_ckpt.read_jax_checkpoint(jax_ckpt_run["last"])
    assert "ema_params" in loaded and "opt_state" in loaded
    c = VideoCounter.from_checkpoint("final", jax_ckpt_run["last"], dtype=torch.float32,
                                     device="cpu", **TINY_MEM)
    assert "using EMA-averaged weights" in capsys.readouterr().out
    np.testing.assert_allclose(c.count_frames(jax_ckpt_run["frames"]), jax_ckpt_run["counts"],
                               rtol=1e-4)
    want = dg_state_dict_from_flax(loaded["ema_params"], loaded["batch_stats"], SPLITS)
    for k, v in c.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


def test_trainer_resumes_from_a_jax_ckpt(jax_ckpt_run, tmp_path):
    """Weights, EMA, step and extra come over; the optax state does not,
    with the warning of a changed optimizer."""
    jt = jax_ckpt_run["trainer"]
    t = _trainer(dict(jax_ckpt_run["cfg"], log_dir=str(tmp_path), version="from_jax"))
    t.build()
    t.load_ckpt(jax_ckpt_run["last"])
    log = _log(t)
    assert "optimizer state not restored: the JAX package's optax state" in log
    assert t._resume["epoch"] == 0 and t.state.step == int(jt.state.step) == 2
    assert t._resume_point()[0] == 1
    want = dg_state_dict_from_flax(unfreeze(jt.state.params), unfreeze(jt.state.batch_stats),
                                   SPLITS)
    for k, v in t.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    ema = dg_state_dict_from_flax(unfreeze(jt.state.ema_params), None, SPLITS)
    for k, v in t.state.ema_params.items():
        assert torch.equal(v, ema[k]), k
    with pytest.raises(ValueError, match="not a .pth, .pt or .ckpt"):
        load_checkpoint(str(tmp_path / "weights.npz"), t.state)


# ------------------------------------------------------------ pretrained

FULL_ENC = dict(mem_size=16, mem_dim=16, dec_widths=((16, 16), (16, 16), (16, 8)))


@pytest.fixture(scope="module")
def vgg16_bn(tmp_path_factory):
    """A vgg16_bn state_dict in torchvision's key layout, made with numpy
    (features only: the classifier is never read)."""
    rng = np.random.default_rng(16)
    sd, ch = {}, 3
    for kind, idx, arg in feature_layout(VGG16_CFG, True):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = rng.normal(0, 0.05, (arg, ch, 3, 3))
            sd[f"features.{idx}.bias"] = rng.normal(0, 0.1, arg)
            ch = arg
        elif kind == "bn":
            sd[f"features.{idx}.weight"] = rng.uniform(0.5, 1.5, arg)
            sd[f"features.{idx}.bias"] = rng.normal(0, 0.1, arg)
            sd[f"features.{idx}.running_mean"] = rng.normal(0, 0.1, arg)
            sd[f"features.{idx}.running_var"] = rng.uniform(0.5, 2.0, arg)
            sd[f"features.{idx}.num_batches_tracked"] = np.asarray(7)
    path = tmp_path_factory.mktemp("vgg") / "vgg16_bn.pth"
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32 if v.dtype == np.float64 else
                                               v.dtype)) for k, v in sd.items()}, path)
    return str(path)


def test_pretrained_install_matches_the_jax_install(vgg16_bn):
    import dgvcc_tpu.models  # noqa: F401
    from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
    from dgvcc_tpu_torch.core.registry import MODELS

    jm = JAX_MODELS.build("final", **FULL_ENC)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.zeros((1, 32, 32, 3)))
    variables, desc = load_pretrained_backbone(
        {"params": unfreeze(v["params"]), "batch_stats": unfreeze(v["batch_stats"])},
        "final", {"vgg16_bn": vgg16_bn})
    want = dg_state_dict_from_flax(variables["params"], variables["batch_stats"])
    pm = MODELS.build("final", **FULL_ENC)
    got_desc = install_pretrained(pm, "final", {"vgg16_bn": vgg16_bn})
    assert got_desc == desc == "vgg16_bn → enc1/2/3"
    enc = [k for k in pm.state_dict() if k.startswith("enc")
           and not k.endswith("num_batches_tracked")]
    assert len(enc) == 13 * 2 + 13 * 4
    for k in enc:
        assert torch.equal(pm.state_dict()[k], want[k]), k
    tiny = MODELS.build("final", **TINY_MEM)
    with pytest.raises(ValueError, match="not vgg16_bn's layout"):
        install_pretrained(tiny, "final", {"vgg16_bn": vgg16_bn})


@pytest.mark.parametrize("case", ["installed", "pretrained_false", "other_weights"])
def test_trainer_installs_pretrained_weights_and_reseeds_the_ema(root, tmp_path, vgg16_bn,
                                                                   case):
    params = dict(FULL_ENC, pretrained=case != "pretrained_false")
    weights = {"vgg19": vgg16_bn} if case == "other_weights" else {"vgg16_bn": vgg16_bn}
    t = _trainer(_cfg(root, tmp_path, case, geometry=params, ema=0.99,
                      pretrained_weights=weights))
    t.build()
    tv = torch.load(vgg16_bn, weights_only=True)
    installed = torch.equal(t.model.state_dict()["enc3.1.weight"], tv["features.34.weight"])
    assert installed == (case == "installed")
    log = _log(t)
    if case == "installed":
        assert "Loaded pretrained backbone: vgg16_bn → enc1/2/3" in log
        assert torch.equal(t.model.state_dict()["enc1.1.running_var"],
                           tv["features.1.running_var"])
    elif case == "other_weights":
        assert "Loaded pretrained backbone: no pretrained mapping" in log
    else:
        assert "pretrained backbone" not in log
    for n, p in t.model.named_parameters():
        assert torch.equal(t.state.ema_params[n], p), n


# ------------------------------------------------------------ sta_final_bigcrop.yml

def test_sta_final_bigcrop_builds_and_trains_as_the_jax_trainer(root, tmp_path):
    """configs/tpu/sta_final_bigcrop.yml (accum_steps 4, remat) at the tiny
    width, float32, 64-px crops of the synthetic set, one sample a micro
    step so each epoch is one window, and the EMA on: the training losses
    of epochs 0 and 1 against the JAX trainer's (rtol 1e-3)."""
    with open(os.path.join(REPO, "configs", "tpu", "sta_final_bigcrop.yml")) as f:
        raw = yaml.safe_load(f)
    assert raw["accum_steps"] == 4 and raw["model"]["params"]["remat"] is True
    ds = {"name": raw["train_dataset"]["name"],
          "params": dict(raw["train_dataset"]["params"], root=root, crop_size=64)}
    raw.update(model={"name": raw["model"]["name"],
                      "params": dict(PARITY, remat=True, pretrained=True)},
               train_dataset=ds, val_dataset=ds, test_dataset=ds, num_epochs=2,
               train_loader=dict(raw["train_loader"], batch_size=1, num_workers=0),
               val_loader=dict(raw["val_loader"], num_workers=0),
               test_loader=dict(raw["test_loader"], num_workers=0),
               compute_dtype="float32", device="cpu", ema=0.9,
               log_dir=str(tmp_path / "logs"))
    jt = JaxTrainer(JaxConfig.from_dict(dict(raw, version="big_jax")))
    jt.build()
    init = str(tmp_path / "init.pth")
    torch.save(dg_state_dict_from_flax(unfreeze(jt.state.params),
                                       unfreeze(jt.state.batch_stats), SPLITS), init)
    jt.train()
    t = _trainer(dict(raw, version="big_port"))
    t.build()
    t.model.load_state_dict(torch.load(init, weights_only=True))
    t.state.seed_ema()
    t.train()
    want = _losses(open(os.path.join(jt.log_dir, "log.txt")).read())
    got = _losses(_log(t))
    assert sorted(got) == sorted(want) == [0, 1]
    for e in (0, 1):
        np.testing.assert_allclose(got[e], want[e], rtol=1e-3, err_msg=f"epoch {e}")
    assert t.state.step == 8 and t.state.mini_step == 0 and int(jt.state.step) == 8
