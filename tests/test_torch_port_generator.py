"""The port's generators (dgvcc_tpu_torch/models/regressors.py: gen, gen0), the
rest of its loss zoo (losses/misc.py), modes generation and joint
(train/genjoint.py), the [gen, reg] checkpoint pairs and ``--task generate``
(train/trainer.py, cli/main.py), and the generator's bridge and vgg19
installs (nn/convert.py), against the JAX package on the CPU in float32.

``gen`` runs with the JAX model's tiny encoder (dgvcc_tpu.testing.TINY_VGG19,
stop 9); ``gen0`` has no knob and runs at full width on 32x32 inputs;
``reg_mem`` at the tiny geometry of tests/test_torch_port_regressors.py.
Weights come from numpy seeds into the JAX variables and reach the port
through its bridge. The joint step's dropout (``reg_mem``'s) takes the same
seeded masks in both frameworks, in call order. The JAX joint step applies
its gradients inside; the test takes them from it by replacing the JAX
TrainState's ``apply_gradients`` with one that keeps the gradient as the new
parameters, and runs it eagerly: the jitted step's gradients differ from
JAX's own eager ones by up to 3.5e-3 in relative norm.

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result:
  * forwards (eval and train mode), running statistics, the losses and the
    joint step's loss parts, the validation and test criterion: 1e-4
    (float32, another order of summation);
  * the auxiliary losses: 1e-6;
  * parameter gradients: 1e-3 in relative norm (against 1e-3 of the
    largest gradient norm at least);
  * the first epoch's training loss: rtol 1e-3; the trained generator's
    validation and test criterion 2e-3 (AdamW on rounding-level gradients,
    test_generation_trainer_matches_the_jax_trainer);
  * the bridge and the vgg19 installs: bit for bit;
  * ``--task generate``: each image's uint8 array within 1 of JAX's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.core import unfreeze
from PIL import Image

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.losses  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.losses import misc as jmisc
from dgvcc_tpu.models import regressors as jreg
from dgvcc_tpu.nn import layers as jlayers
from dgvcc_tpu.nn import torch_io
from dgvcc_tpu.testing import TINY_VGG, TINY_VGG19
from dgvcc_tpu.train import checkpoint as jckpt
from dgvcc_tpu.train import genjoint as jgen
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.losses import misc as pmisc
from dgvcc_tpu_torch.models import regressors as preg
from dgvcc_tpu_torch.nn import layers as players
from dgvcc_tpu_torch.nn.convert import install_pretrained, state_dict_from_flax
from dgvcc_tpu_torch.nn.vgg import VGG19_CFG, feature_layout
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.train import genjoint as pgen
from dgvcc_tpu_torch.train import state as pstate
from dgvcc_tpu_torch.train import trainer as ptrainer
from dgvcc_tpu_torch.train.checkpoint import save_checkpoint, sidecar_path
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_loss_fn
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_helpers import close, close_grads, nchw, nhwc, randomize

FWD, AUX, GRAD = 1e-4, 1e-6, 1e-3
TINY_GEN = dict(vgg_cfg=TINY_VGG19, enc_stop=9)
TINY_REG_MEM = dict(vgg_cfg=TINY_VGG, stage_splits=(0, 8, 12, 16),
                    dec_widths=((16, 16), (16, 16), (16, 8)), part_num=16, final_dim=16)
GEOMETRY = {"gen": TINY_GEN, "gen0": {}, "reg_mem": TINY_REG_MEM}
HW = {"gen": (32, 48), "gen0": (32, 32), "reg_mem": (64, 64)}
LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")
VAL_LINE = re.compile(r"Epoch (-?\d+): Val criterion: ([\d.]+)")


def _variable_shapes(jm, hw):
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)},
                                       jnp.zeros((1,) + tuple(hw) + (3,), jnp.float32)))
    return unfreeze(v["params"]), unfreeze(v.get("batch_stats", {}))


def _pair(name, seed, **port_kw):
    """(JAX model, its variables, the port model) with identical f32 weights."""
    jm = JAX_MODELS.build(name, **GEOMETRY[name])
    rng = np.random.default_rng(seed)
    params, stats = _variable_shapes(jm, HW[name])
    variables = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    pm = MODELS.build(name, **GEOMETRY[name], **port_kw)
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    return jm, variables, pm


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _images(seed, b, hw):
    return np.tanh(np.random.default_rng(seed).normal(size=(b,) + tuple(hw) + (3,))) \
        .astype(np.float32)


# ------------------------------------------------------------ forwards, losses

@pytest.mark.parametrize("name", ["gen", "gen0"])
def test_generator_forwards_match_jax(name):
    """The eval forward, and the train-mode forward with the running
    statistics it leaves."""
    jm, variables, pm = _pair(name, 1)
    x = _images(2, 2, HW[name])
    want = jax.jit(lambda v, xx: jm.apply(v, xx))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(nchw(x))
    close(nhwc(got), want, FWD, f"{name} eval")
    want, mut = jax.jit(lambda v, xx: jm.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.train()(nchw(x))
    close(nhwc(got), want, FWD, f"{name} train")
    assert float(got.abs().max()) <= 1.0
    want_sd = state_dict_from_flax(pm, variables["params"], unfreeze(mut["batch_stats"]))
    for k, b in pm.named_buffers():
        if not k.endswith("num_batches_tracked"):
            close(b, want_sd[k].numpy(), FWD, k)


@pytest.mark.parametrize("name", ["gen", "gen0"])
def test_generation_loss_and_gradients_match_jax(name):
    jm, variables, pm = _pair(name, 3)
    x1, x2 = _images(4, 2, HW[name]), _images(5, 2, HW[name])
    jb = {"img1": jnp.asarray(x1), "img2": jnp.asarray(x2)}
    (total, (_, metrics)), grads = jax.jit(jax.value_and_grad(
        jgen.build_generation_loss(jm), has_aux=True))(
        variables["params"], variables["batch_stats"], jb, jax.random.PRNGKey(0),
        jnp.int32(0))
    got_total, got = build_loss_fn(pm, LOSSES.build("mse"), "generation", 1000.0)(
        {"img1": nchw(x1), "img2": nchw(x2)}, None, 0)
    got_total.backward()
    assert set(got) == set(metrics) == {"loss_total", "loss_rec"}
    close(got_total.detach(), total, FWD, "loss")
    want = state_dict_from_flax(pm, unfreeze(grads), None)
    assert {n for n, _ in pm.named_parameters()} == set(want)
    close_grads(pm, want, GRAD)


def test_auxiliary_losses_match_jax():
    """ortho_loss (its mean over all C*C entries), sim_loss, lw_loss with
    and without a mask, jsd_loss."""
    rng = np.random.default_rng(6)
    x, y = (rng.normal(size=(6, 40)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    close(pmisc.ortho_loss(t(x), t(y)), jmisc.ortho_loss(x, y), AUX, "ortho")
    a, b = (rng.normal(size=(2, 5, 4, 3)).astype(np.float32) for _ in range(2))
    close(pmisc.sim_loss(t(a), t(b)), jmisc.sim_loss(a, b), AUX, "sim")
    mask = (rng.random((2, 1, 12)) < 0.7).astype(np.float32)
    close(pmisc.lw_loss(t(a)), jmisc.lw_loss(a), AUX, "lw")
    close(pmisc.lw_loss(t(a), t(mask)), jmisc.lw_loss(a, mask), AUX, "lw masked")
    l1, l2 = (rng.normal(0, 2, (2, 24, 16)).astype(np.float32) for _ in range(2))
    close(pmisc.jsd_loss(t(l1), t(l2)), jmisc.jsd_loss(l1, l2), AUX, "jsd")


# ------------------------------------------------------------ the joint step

@pytest.fixture
def masks(monkeypatch):
    """The same dropout masks in both frameworks: the i-th call of either
    framework's dropout2d keeps the channels of seeded mask i."""
    def mask(i, n, c, keep):
        return np.random.default_rng(3000 + i).random((n, c)) < keep

    calls = {"jax": 0, "torch": 0}
    torch_orig = players.dropout2d

    def jax_drop(x, rate, rng, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        calls["jax"] += 1
        m = mask(calls["jax"] - 1, x.shape[0], x.shape[-1], 1.0 - rate)[:, None, None, :]
        return jnp.where(m, x / (1.0 - rate), 0.0)

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


def test_joint_step_matches_jax(masks, monkeypatch):
    """One build_joint_step on the tiny gen and reg_mem: the loss parts and
    both models' gradients (the regressor's taken on the generator's output
    before its update)."""
    jg, gvars, pg = _pair("gen", 7)
    jr, rvars, pr = _pair("reg_mem", 8, fused_mem=False)
    h, w = HW["reg_mem"]
    rng = np.random.default_rng(9)
    batch = {"img1": _images(10, 2, (h, w)), "img2": _images(11, 2, (h, w)),
             "dmap": rng.uniform(0, 2e-3, (2, h, w, 1)).astype(np.float32),
             "bmap": (rng.random((2, h // 16, w // 16, 1)) < 0.6).astype(np.float32)}
    # the JAX states keep their gradients as their new parameters
    monkeypatch.setattr(JaxTrainState, "apply_gradients",
                        lambda self, grads, new_batch_stats=None: self.replace(
                            params=grads, batch_stats=new_batch_stats))

    def jstate(v):
        tx = optax.sgd(1.0)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                             batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                             tx=tx)

    # eager: the jitted step's gradients differ from JAX's own eager ones by
    # up to 3.5e-3 in relative norm (XLA's fusions; the port is within 1e-5
    # of eager)
    step = jgen.build_joint_step(jg, jr, JAX_LOSSES.build("mse"), 1000.0).__wrapped__
    jgs, jrs, metrics = step(jstate(gvars), jstate(rvars),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0), jnp.int32(0))
    grads = {}
    monkeypatch.setattr(pstate.TrainState, "apply_gradients", lambda self: grads.update(
        {id(self.model): {n: p.grad.clone() for n, p in self.model.named_parameters()}})
        or self)
    gs, rs = (create_train_state(m, {"name": "adamw"}, device="cpu") for m in (pg, pr))
    _, _, got = pgen.build_joint_step(pg, pr, LOSSES.build("mse"), 1000.0)(
        gs, rs, {k: nchw(v) for k, v in batch.items()}, None, 0)
    assert masks["jax"] == masks["torch"] == 4
    assert set(got) == set(metrics)
    for k in ("loss_gen", "loss_rec", "loss_den", "loss_cls", "loss_kl", "loss_total"):
        close(got[k], metrics[k], FWD, k)
    assert float(got["loss_gen"]) > float(got["loss_rec"])  # the ortho term
    for model, js, v in ((pg, jgs, gvars), (pr, jrs, rvars)):
        for p in model.parameters():
            p.grad = None
        for n, p in model.named_parameters():
            p.grad = grads[id(model)][n]
        close_grads(model, state_dict_from_flax(model, unfreeze(js.params), None), GRAD)
        want_stats = state_dict_from_flax(model, v["params"], unfreeze(js.batch_stats))
        for k, b in model.named_buffers():
            if not k.endswith("num_batches_tracked"):
                close(b, want_stats[k].numpy(), FWD, k)


# ------------------------------------------------------------ weights

def test_generator_bridge_round_trips_through_the_jax_reader(tmp_path):
    """Full-width gen: JAX variables -> the port's strict state_dict ->
    generator_checkpoint_to_flax gives them back exactly; gen0's bridge
    strict-loads."""
    jm = JAX_MODELS.build("gen")
    rng = np.random.default_rng(20)
    params, stats = _variable_shapes(jm, (32, 32))
    variables = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    pm = MODELS.build("gen")
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    got_p, got_s = torch_io.generator_checkpoint_to_flax(
        {k: v.numpy() for k, v in pm.state_dict().items()})
    for tree, got in (("params", got_p), ("batch_stats", got_s)):
        want, got = dict(_flat(variables[tree])), dict(_flat(got))
        assert set(got) == set(want), tree
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    _, v0, p0 = _pair("gen0", 21)
    assert sum(1 for _ in _flat(v0["params"])) == sum(1 for _ in p0.parameters())


def _torchvision_vgg19(rng):
    sd, ch = {}, 3
    for kind, idx, arg in feature_layout(VGG19_CFG, False):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (arg, ch, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.1, arg)
                                                          .astype(np.float32))
            ch = arg
    return sd


@pytest.mark.parametrize("name,moved", [("gen", 24), ("gen0", 24)])
def test_vgg19_lands_where_the_jax_mapping_puts_it(name, moved, tmp_path):
    """Full width: load_pretrained_backbone's variables, through the bridge,
    equal the port's model after install_pretrained, key for key (the 12
    convs of vgg19 features[:26], weight and bias)."""
    jm = JAX_MODELS.build(name)
    rng = np.random.default_rng(30)
    params, stats = _variable_shapes(jm, (32, 32))
    variables = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    pm = MODELS.build(name)
    before = state_dict_from_flax(pm, variables["params"], variables["batch_stats"])
    pm.load_state_dict(before, strict=True)
    path = str(tmp_path / "vgg19.pth")
    torch.save(_torchvision_vgg19(rng), path)
    want_vars, want_desc = torch_io.load_pretrained_backbone(variables, name, {"vgg19": path})
    assert install_pretrained(pm, name, {"vgg19": path}) == want_desc
    want = state_dict_from_flax(pm, want_vars["params"], want_vars["batch_stats"])
    got = pm.state_dict()
    changed = {k for k, w in want.items() if not torch.equal(w, before[k])}
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert len(changed) == moved and all(k.startswith("enc") for k in changed)


# ------------------------------------------------------------ the trainer

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs, 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("generator_data")
    rng = np.random.default_rng(12)
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


def _cfg(root, log_dir, version, mode="generation", model="gen", params=None, **over):
    ds = {"name": "den_cls", "params": {"root": root, "crop_size": 64, "downsample": 1,
                                        "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    d = {"seed": 2112, "version": version, "device": "cpu", "log_para": 1000,
         "patch_size": 10000, "mode": mode, "num_epochs": 2, "checkpoint": None,
         "model": {"name": model, "params": dict(TINY_GEN if params is None else params)},
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


def _jax_and_port(cfg, tmp_path):
    """The JAX trainer, built, and the port's, built with its weights."""
    jt = JaxTrainer(JaxConfig.from_dict(dict(cfg, log_dir=str(tmp_path / "jax"))))
    jt.build()
    t = DGTrainer(Config.from_dict(dict(cfg, log_dir=str(tmp_path / "port"))), device="cpu")
    t.build()
    t.model.load_state_dict(state_dict_from_flax(t.model, unfreeze(jt.state.params),
                                                 unfreeze(jt.state.batch_stats)), strict=True)
    return jt, t


def test_generation_trainer_matches_the_jax_trainer(root, tmp_path):
    """The tiny gen: the validation criterion (the masked reconstruction MSE
    of the padded image) from the same weights to 1e-4; then train_and_test
    for two epochs: the epoch-0 loss to 1e-3, every validation and test
    criterion to 1e-3, log.txt line for line. The trained criterion is held
    at 1e-3: AdamW's first steps move each weight by about +-lr whatever the
    gradient's size, and 0.05% of the decoder's conv weights have gradients
    at float32 rounding level (|g| <= 1e-4 of the largest) whose signs
    differ between the frameworks (between JAX's jit and eager runs too);
    after two steps the criterion differs by 1.1e-3 (measured)."""
    jt, t = _jax_and_port(_cfg(root, tmp_path, "gen_parity"), tmp_path)
    want0 = jt.validate(-1, 1e10)
    close(np.float32(t.validate(-1, 1e10)), want0, FWD, "criterion, same weights")
    jt.train_and_test()
    t.train_and_test()
    want, got = _log(jt), _log(t)
    want_loss = {int(e): float(v) for e, v in LOSS_LINE.findall(want)}
    got_loss = {int(e): float(v) for e, v in LOSS_LINE.findall(got)}
    assert sorted(got_loss) == sorted(want_loss) == [0, 1]
    np.testing.assert_allclose(got_loss[0], want_loss[0], rtol=1e-3)
    want_val = np.array([float(v) for _, v in VAL_LINE.findall(want)])
    got_val = np.array([float(v) for _, v in VAL_LINE.findall(got)])
    assert len(got_val) == len(want_val) >= 4 and "Epoch -1: Val criterion" in got
    np.testing.assert_allclose(got_val, want_val, rtol=2e-3)
    want_lines, got_lines = _masked(want), _masked(got)
    assert len(got_lines) == len(want_lines) > 10
    for a, b in zip(got_lines, want_lines):
        assert a == b


def _tiny_joint_models(monkeypatch):
    """The joint trainer builds gen and reg_mem at full width, as the JAX
    trainer does; these CPU runs build them at the tiny geometry."""
    build = ptrainer.MODELS.build
    tiny = {"gen": TINY_GEN, "reg_mem": dict(TINY_REG_MEM, fused_mem=False)}
    monkeypatch.setattr(ptrainer.MODELS, "build",
                        lambda name, **kw: build(name, **{**tiny.get(name, {}), **kw}))


def _jax_pair_names(tmp_path, epoch, criterion):
    """The file names of the JAX rotator's last and best pairs (suffix
    dropped)."""
    jm = JAX_MODELS.build("gen", **TINY_GEN)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))
    tx = optax.sgd(1.0)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    d = tmp_path / "jax_pairs"
    d.mkdir()
    rot = jckpt.CheckpointRotator(str(d))
    extra = {"epoch": epoch, "best": criterion}
    rot.save_last_pair(st, st, extra)
    rot.save_best_pair(st, st, epoch, criterion, extra)
    rot.flush()
    return sorted(f[:-len(".ckpt")] for f in os.listdir(d))


def _state_of(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_joint_run_saves_pairs_and_resumes_exactly_from_one(root, tmp_path, monkeypatch):
    """Mode joint (tiny gen and reg_mem): the pair files are the JAX
    rotator's names, each a .pth with its sidecar; two epochs straight equal
    one epoch, then a resume from [last_gen, last_reg] for the second: both
    models, both optimizers, the scheduler, the loss line."""
    _tiny_joint_models(monkeypatch)
    cfg = _cfg(root, tmp_path / "a", "joint", mode="joint", model="dgnet",
               params={"pretrained": False})
    full = DGTrainer(Config.from_dict(cfg), device="cpu")
    best, best_epoch = full.train()
    names = sorted(f[:-len(".pth")] for f in os.listdir(full.log_dir) if f.endswith(".pth"))
    assert names == _jax_pair_names(tmp_path, best_epoch, best)
    assert all(os.path.exists(sidecar_path(os.path.join(full.log_dir, n + ".pth")))
               for n in names)

    cut = DGTrainer(Config.from_dict(dict(cfg, log_dir=str(tmp_path / "b"))), device="cpu")
    cut.train(num_epochs=1)
    pair = [os.path.join(cut.log_dir, f"last_{m}.pth") for m in ("gen", "reg")]
    resumed = DGTrainer(Config.from_dict(dict(cfg, log_dir=str(tmp_path / "b"),
                                              checkpoint=pair)), device="cpu")
    resumed.train()
    text = _log(resumed)
    assert "Resuming from epoch 0" in text
    assert "Loading generator checkpoint from" in text and "Loading regressor checkpoint" in text
    for a, b in ((full.gen_model, resumed.gen_model), (full.model, resumed.model)):
        want, got = _state_of(a), _state_of(b)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for a, b in ((full.gen_state, resumed.gen_state), (full.state, resumed.state)):
        for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
    assert full.scheduler.state_dict() == resumed.scheduler.state_dict()
    want_loss = dict(LOSS_LINE.findall(_log(full)))
    assert dict(LOSS_LINE.findall(text))["1"] == want_loss["1"]


def test_a_pair_of_jax_ckpt_files_loads_into_the_joint_trainer(root, tmp_path, monkeypatch):
    """The JAX rotator's [last_gen.ckpt, last_reg.ckpt] (tiny gen and
    reg_mem, seeded variables) through the port's msgpack reader and
    bridge: both models hold the JAX weights and statistics exactly, and
    the pair's extra gives the resume point."""
    _tiny_joint_models(monkeypatch)
    states, sds = [], []
    for name, seed in (("gen", 50), ("reg_mem", 51)):
        jm, variables, pm = _pair(name, seed, **({"fused_mem": False} if name == "reg_mem"
                                                  else {}))
        tx = optax.adamw(1e-3)
        states.append(JaxTrainState(step=jnp.asarray(4, jnp.int32), params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=tx.init(variables["params"]), tx=tx))
        sds.append({k: v.clone() for k, v in pm.state_dict().items()})
    rot = jckpt.CheckpointRotator(str(tmp_path / "jax"))
    os.makedirs(rot.log_dir, exist_ok=True)
    rot.save_last_pair(*states, {"epoch": 3, "best": 2.5})
    rot.flush()
    pair = [os.path.join(rot.log_dir, f"last_{m}.ckpt") for m in ("gen", "reg")]
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path / "port", "jax_pair", mode="joint",
                                        model="dgnet", params={"pretrained": False},
                                        checkpoint=pair)), device="cpu")
    t.build()
    t.load_ckpt(pair)
    for model, want in zip((t.gen_model, t.model), sds):
        got = model.state_dict()
        for k, w in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], w), k
    assert t._resume["epoch"] == 3 and t._resume_point()[:2] == (4, 2.5)


def test_pair_rules_of_a_single_model_trainer(root, tmp_path):
    """A 1-list is the trainer's one checkpoint; a 2-list on a trainer that
    is not joint loads the second and says the first was ignored; 0 or 3
    entries raise with the JAX message."""
    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path, "rules")), device="cpu")
    t.build()
    want = _state_of(t.model)
    path = str(tmp_path / "gen.pth")
    save_checkpoint(path, t.state, {"epoch": 3, "best": 0.5})
    with torch.no_grad():
        for p in t.model.parameters():
            p.zero_()
    t.load_ckpt([path])
    assert all(torch.equal(v, want[k]) for k, v in t.model.state_dict().items())
    assert t._resume["epoch"] == 3
    t.load_ckpt(["ignored_gen.pth", path])
    assert "generator entry ignored_gen.pth ignored" in _log(t)
    for bad in ([], [path] * 3):
        with pytest.raises(ValueError, match=r"pair checkpoint must be \[gen_ckpt, reg_ckpt\]"):
            t.load_ckpt(bad)


def test_generate_through_the_cli_matches_the_jax_trainer(root, tmp_path, monkeypatch):
    """--task generate on the port's command line from a saved tiny gen, and
    the JAX trainer's generate() on the same weights: the same file names
    under {log_dir}/gen, each image's uint8 array within 1; existing files
    are kept."""
    arrays = {}
    save = Image.Image.save

    def recording(self, fp, *a, **kw):
        arrays.setdefault(str(fp).split(os.sep + "jax" + os.sep)[0] != str(fp), {})[
            os.path.basename(str(fp))] = np.asarray(self)
        return save(self, fp, *a, **kw)

    monkeypatch.setattr(Image.Image, "save", recording)
    cfg = _cfg(root, tmp_path, "gen_cli")
    jt, t = _jax_and_port(cfg, tmp_path)
    jt.generate()
    ckpt = str(tmp_path / "gen.pth")
    save_checkpoint(ckpt, t.state)
    path = tmp_path / "gen.yml"
    path.write_text(yaml.safe_dump(dict(cfg, log_dir=str(tmp_path / "port"))))
    main(["--config", str(path), "--task", "generate", "--ckpt", ckpt])
    want, got = arrays[True], arrays[False]
    assert sorted(got) == sorted(want) == [f"img{k:03d}_a.jpg" for k in range(4)]
    gen_dir = tmp_path / "port" / "gen_cli" / "gen"
    assert sorted(os.listdir(gen_dir)) == sorted(got)
    for name, w in want.items():
        assert got[name].shape == w.shape == (96, 112, 3)
        assert np.abs(got[name].astype(int) - w.astype(int)).max() <= 1, name
    arrays.clear()
    main(["--config", str(path), "--task", "generate", "--ckpt", ckpt])
    assert not arrays  # every file exists
