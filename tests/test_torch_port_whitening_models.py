"""The port's whitening counters (dgvcc_tpu_torch/models/whitening.py), mode
isw, the covariance trackers, the k-means copy, the weight bridge and the
pretrained mappings (nn/convert.py) and the trainer's ISW protocol, against
the JAX package on the CPU in float32. Inputs and weights come from numpy
seeds; JAX variables reach the port through the bridge.

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result:
  * eval forwards, loss parts, cov_stats and running statistics: 1e-4
    (float32, another order of summation, batch statistics over small maps);
  * parameter gradients: 5e-2 in relative norm against 1e-3 of the largest
    gradient norm at least (a ReLU input within rounding of 0 takes either
    side in either framework, tests/test_torch_port_whitening.py);
  * parameters after one AdamW step: 1e-5 where the two gradients agree to
    a tenth of the JAX one (and it exceeds 1e-6), at least 90% of the
    values; elsewhere the bound of two opposite steps, 2 lr (1 + wd |p|):
    Adam's first step is lr * g / (|g| + eps), so a small gradient that
    the rounding above moves across 0 turns into a step of the other sign;
  * masks, sensitive counts and k-means labels: bit for bit, on the same
    statistics;
  * the trainer: the epoch-0 loss 1e-3, ``--task test`` MAE and MSE 1e-4,
    log.txt line for line with every number and path masked; the masks
    after epoch 0's validation: the same counts, and at most 1% of the
    selected entries trading places with unselected ones (the statistics
    come from weights that one epoch of training left apart by rounding;
    1 of 1008 did so at the stem site, 158 of 65408 at layer2's);
    counts served from the JAX ``last.ckpt`` 1e-4.
"""

import os
import re
from glob import glob

import jax
import jax.numpy as jnp
import numpy as np
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
from dgvcc_tpu.models import whitening as jwm
from dgvcc_tpu.nn import torch_io
from dgvcc_tpu.ops.tiling import TiledCounter as JaxTiledCounter
from dgvcc_tpu.serve import VideoCounter as JaxVideoCounter
from dgvcc_tpu.train import optim as joptim
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu.utils import kmeans1d as jkm
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.models import whitening as pwm
from dgvcc_tpu_torch.nn.convert import install_pretrained, state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.ops.tiling import TiledCounter
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train.checkpoint import load_checkpoint
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_loss_fn, build_train_step
from dgvcc_tpu_torch.train.trainer import DGTrainer, covariance_views
from dgvcc_tpu_torch.utils import kmeans1d as pkm
from test_torch_port_helpers import (close, close_grads, nchw, nhwc, randomize_whitening,
                                     variable_shapes)

FWD, GRAD = 1e-4, 5e-2
ADAMW = {"name": "adamw", "params": {"lr": 0.001, "weight_decay": 0.0001}}
GEOMETRY = {
    "sw": dict(layers=(1, 2, 2)),
    "ibn": dict(layers=(2, 1, 1)),
    "ibn_a": dict(ibn_cfg="a", layers=(1, 1, 1), groups=2, base_width=16, se=True),
    "isw": dict(layers=(1, 1, 1, 1)),
    "sw_vgg": {},
    "sw_densenet": dict(block_config=(2, 2, 4, 2)),
    "ibn_densenet": dict(block_config=(2, 2, 4, 2)),
}


def _model(case):
    return case.split("_a")[0] if case == "ibn_a" else case


def _pair(case, seed, hw=(64, 64)):
    """(JAX model, its variables, the port model) with identical weights."""
    name, geom = _model(case), GEOMETRY[case]
    jm = JAX_MODELS.build(name, **geom)
    rng = np.random.default_rng(seed)
    params, stats = variable_shapes(jm, np.zeros((1,) + hw + (3,), np.float32), train=False)
    variables = {"params": randomize_whitening(params, rng),
                 "batch_stats": randomize_whitening(stats, rng)}
    pm = MODELS.build(name, **geom)
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    return jm, variables, pm


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ------------------------------------------------------------ eval forward

@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_eval_forward_matches_jax(case):
    jm, variables, pm = _pair(case, 1)
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(nchw(x))
    close(nhwc(got), want, FWD, case)


# ------------------------------------------------------------ train losses

def _tracker_masks(seed, tracker_cls=jwm.IswCovTracker):
    """Sensitive-entry masks of the three ISW sites from seeded statistics."""
    rng = np.random.default_rng(seed)
    tracker = tracker_cls()
    tracker.add({f"m{i}": np.triu(rng.gamma(1.0, 1.0, (d, d)), 1)
                 for i, d in enumerate(pwm.ISW_WT_CHANNELS)})
    tracker.set_mask_matrix()
    return tracker


def _batches(mode, seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    batch = {"img1": rng.normal(size=(b, hw, hw, 3)).astype(np.float32),
             "dmap": rng.uniform(0, 2e-3, (b, hw, hw, 1)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: nchw(v) for k, v in batch.items()}
    if mode == "isw":
        jt, pt = _tracker_masks(seed, jwm.IswCovTracker), _tracker_masks(seed, pwm.IswCovTracker)
        for tree, tr in ((jb, jt), (pb, pt)):
            tree.update(zip(("isw_masks", "isw_nums", "isw_margins"), tr.mask_batch()))
    return jb, pb


TRAIN_CASES = [("sw", "simple", 0), ("ibn", "simple", 0), ("isw", "isw", 0), ("isw", "isw", 6)]


@pytest.mark.parametrize("case,mode,epoch", TRAIN_CASES)
def test_train_losses_gradients_and_one_adamw_step_match_jax(case, mode, epoch):
    jm, variables, pm = _pair(case, 10 + epoch)
    jb, pb = _batches(mode, 20 + epoch)
    jloss = jsteps.build_loss_fn(jm, JAX_LOSSES.build("mse"), mode, 1000.0)
    (total, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], variables["batch_stats"], jb, jax.random.PRNGKey(0),
        jnp.int32(epoch))

    loss_fn = build_loss_fn(pm, LOSSES.build("mse"), mode, 1000.0)
    got_total, got = loss_fn(pb, None, epoch)
    got_total.backward()
    assert set(got) == set(metrics)
    for k, w in metrics.items():
        close(got[k], w, FWD, k)
    if mode == "isw":
        assert (got["loss_wt"].item() > 0) == (epoch > 5)
    want_grads = state_dict_from_flax(pm, unfreeze(grads), None)
    assert {n for n, _ in pm.named_parameters()} == set(want_grads)
    close_grads(pm, want_grads, GRAD)
    want_stats = state_dict_from_flax(pm, variables["params"], unfreeze(new_stats))
    for k, b in pm.named_buffers():
        if not k.endswith("num_batches_tracked"):
            close(b, want_stats[k].numpy(), FWD, k)

    # one AdamW step, each framework from the same weights
    jm, variables, pm = _pair(case, 10 + epoch)
    tx = joptim.build_optimizer(ADAMW)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jsteps.build_train_step(jm, JAX_LOSSES.build("mse"), mode, 1000.0)
    jstate, _ = jax.jit(jstep)(jstate, jb, jax.random.PRNGKey(0), jnp.int32(epoch))
    state = create_train_state(pm, ADAMW, device="cpu")
    build_train_step(pm, LOSSES.build("mse"), mode, 1000.0)(state, pb, None, epoch)
    want = state_dict_from_flax(pm, unfreeze(jstate.params), None)
    before = state_dict_from_flax(pm, variables["params"], None)
    lr, wd = ADAMW["params"]["lr"], ADAMW["params"]["weight_decay"]
    tight = total = 0
    for n, p in pm.named_parameters():
        g, wg = p.grad, want_grads[n]
        agree = ((g - wg).abs() < 0.1 * wg.abs()) & (wg.abs() > 1e-6)
        diff = (p.detach() - want[n]).abs()
        assert torch.all(diff[agree] <= 1e-5), n
        bound = 2 * lr * (1 + wd * before[n].abs()) + 1e-7
        assert torch.all(diff[~agree] <= bound[~agree]), n
        tight, total = tight + int(agree.sum()), total + g.numel()
    assert tight >= 0.9 * total, (tight, total)


def test_cov_stats_match_jax():
    jm, variables, pm = _pair("isw", 30)
    x2 = np.random.default_rng(31).normal(size=(4, 64, 80, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx, method=jm.cov_stats))(variables,
                                                                       jnp.asarray(x2))
    with torch.no_grad():
        got = pm.eval().cov_stats(nchw(x2))
    assert sorted(got) == sorted(want) == ["m0", "m1", "m2"]
    for k in want:
        close(got[k], want[k], FWD, k)
        assert not torch.any(torch.tril(got[k]))


# ------------------------------------------------------------ trackers, k-means

@pytest.mark.parametrize("relax_denom", [2.0, 0.0])
def test_isw_tracker_masks_are_the_jax_trackers_bit_for_bit(relax_denom):
    """Two rounds of statistics (the second intersects the first's masks);
    at relax_denom 0 the sensitive count comes from the k-means copy."""
    dims = (64, 256, 512) if relax_denom else (16, 32, 48)
    rng = np.random.default_rng(40)
    jt = jwm.IswCovTracker(dims, relax_denom, 3)
    pt = pwm.IswCovTracker(dims, relax_denom, 3)
    for rnd in range(2):
        for _ in range(3):
            stats = {f"m{i}": np.triu(rng.gamma(0.5, 1.0, (d, d)), 1).astype(np.float32)
                     for i, d in enumerate(dims)}
            jt.add(stats)
            pt.add(stats)
        jt.set_mask_matrix()
        pt.set_mask_matrix()
        for a, b in zip(jt.masks, pt.masks):
            np.testing.assert_array_equal(a, b)
        assert jt.num_sensitive == pt.num_sensitive
        if relax_denom and rnd == 0:
            assert pt.num_sensitive == [1008.0, 16320.0, 65408.0]
    for jtree, ptree in zip(jt.mask_batch(), pt.mask_batch()):
        for k in jtree:
            np.testing.assert_array_equal(np.asarray(jtree[k]), ptree[k].numpy())


@pytest.mark.parametrize("relax_denom", [2.0, 0.0])
def test_irw_tracker_matches_jax(relax_denom):
    jt, pt = jwm.IrwCovTracker(relax_denom=relax_denom), pwm.IrwCovTracker(relax_denom=relax_denom)
    pt.add({})
    pt.set_mask_matrix()
    assert not pt.has_stats()
    for jtree, ptree in zip(jt.mask_batch(), pt.mask_batch()):
        for k in jtree:
            np.testing.assert_array_equal(np.asarray(jtree[k]), ptree[k].numpy())


@pytest.mark.parametrize("values,k", [
    (np.random.default_rng(50).normal(size=400), 3),
    (np.random.default_rng(51).gamma(0.3, 1.0, 257), 5),
    (np.random.default_rng(52).integers(0, 4, 300).astype(np.float64), 3),  # ties
    (np.repeat([1.0, 2.0, 2.0, 7.0], 25), 4),
    (np.array([3.0, 1.0]), 3),                                              # k > n
    (np.array([]), 2),
])
def test_kmeans_copy_gives_jax_cluster_exactly(values, k):
    assert pkm.cluster(values, k) == jkm.cluster(values, k)


# ------------------------------------------------------------ bridge, pretrained

CONVERTERS = {
    "sw": lambda sd: torch_io.sw_counter_checkpoint_to_flax(sd, layers=(1, 2, 2)),
    "ibn": lambda sd: torch_io.ibn_counter_checkpoint_to_flax(sd, layers=(2, 1, 1)),
    "isw": lambda sd: torch_io.isw_counter_checkpoint_to_flax(sd, layers=(1, 1, 1)),
    "sw_vgg": torch_io.sw_vgg_checkpoint_to_flax,
}


@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_bridge_round_trips_through_the_jax_readers(case, tmp_path):
    """JAX variables -> the port's strict state_dict -> the JAX package's
    reader of reference checkpoints gives them back exactly; a reference
    .pth strict-loads into the counter (isw's with the layer4 and fc keys
    its forward never reads)."""
    _, variables, pm = _pair(case, 60)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    params, stats = CONVERTERS[case](sd)
    for tree, got in (("params", params), ("batch_stats", stats)):
        want = dict(_flat(variables[tree]))
        got = dict(_flat(got))
        assert set(got) == set(want), tree
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    ref = {k: v.clone() for k, v in pm.state_dict().items()}
    if case == "isw":
        ref["layer4.0.conv1.weight"] = torch.zeros(512, 1024, 1, 1)
        ref["fc.weight"] = torch.zeros(1000, 2048)
    path = str(tmp_path / "ref.pth")
    torch.save(ref, path)
    c = VideoCounter.from_checkpoint(case, path, dtype=torch.float32, device="cpu",
                                     **GEOMETRY[case])
    for k, v in pm.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    state = create_train_state(MODELS.build(case, **GEOMETRY[case]), ADAMW, device="cpu")
    load_checkpoint(path, state, strict=True)


def _torchvision_resnet50(rng):
    """A torchvision resnet50 state_dict of seeded values (conv1, bn1,
    layer1-4, fc)."""
    from dgvcc_tpu_torch.nn.resnet import ResNetTrunk

    trunk = ResNetTrunk(layers=(3, 4, 6, 3), num_stages=4)
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
             "7": "layer4"}
    sd = {}
    for k, v in trunk.state_dict().items():
        head, rest = k.split(".", 1)
        if not k.endswith("num_batches_tracked"):
            v = torch.from_numpy(rng.normal(0.5, 0.3, tuple(v.shape)).astype(np.float32))
        sd[f"{names[head]}.{rest}"] = v
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    return sd


def _torchvision_densenet(rng, block_config):
    """A torchvision densenet state_dict of seeded values with the given
    blocks, half of its dense layers under the published files' legacy
    names (norm.1 / conv.2)."""
    from dgvcc_tpu_torch.nn.densenet import DenseNetTrunk

    trunk = DenseNetTrunk(block_config=block_config, num_stages=4)
    sd = {}
    for i, (k, v) in enumerate(trunk.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            v = torch.from_numpy(rng.normal(0.5, 0.3, tuple(v.shape)).astype(np.float32))
        if i % 2:
            k = re.sub(r"(denselayer\d+)\.(norm|conv)([12])\.", r"\1.\2.\3.", k)
        sd[f"features.{k}"] = v
    return sd


def _torchvision_vgg19(rng):
    from dgvcc_tpu_torch.nn.vgg import VGG19_CFG, feature_layout

    sd, ch = {}, 3
    for kind, idx, arg in feature_layout(VGG19_CFG, False):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (arg, ch, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.1, arg).astype(np.float32))
            ch = arg
    return sd


@pytest.mark.parametrize("case,key", [("sw", "resnet50"), ("ibn", "resnet50"),
                                      ("isw", "resnet50"), ("sw_densenet", "densenet121"),
                                      ("ibn_densenet", "densenet121"), ("sw_vgg", "vgg19")])
def test_pretrained_mappings_match_jax(case, key, tmp_path):
    jm, variables, pm = _pair(case, 70)
    rng = np.random.default_rng(71)
    tv = {"resnet50": lambda: _torchvision_resnet50(rng),
          "densenet121": lambda: _torchvision_densenet(rng, (2, 2, 4, 2)),
          "vgg19": lambda: _torchvision_vgg19(rng)}[key]()
    path = str(tmp_path / f"{key}.pth")
    torch.save(tv, path)
    want_vars, want_desc = torch_io.load_pretrained_backbone(variables, case, {key: path})
    got_desc = install_pretrained(pm, case, {key: path})
    assert got_desc == want_desc
    want = state_dict_from_flax(pm, want_vars["params"], want_vars["batch_stats"])
    before = state_dict_from_flax(pm, variables["params"], variables["batch_stats"])
    got = pm.state_dict()
    moved = 0
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
            moved += not torch.equal(w, before[k])
    assert moved > 10


# ------------------------------------------------------------ the trainer

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 128x128 JPEGs (a multiple of the whole-image
    bucket, 128), 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("isw_data")
    rng = np.random.default_rng(3)
    h = w = 128
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


def _cfg(root, log_dir, version, **over):
    """configs/baselines/sta_isw.yml at the tiny depth, on the files."""
    raw = yaml.safe_load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                           "baselines", "sta_isw.yml")))
    ds = dict(raw["train_dataset"], params=dict(raw["train_dataset"]["params"], root=root,
                                                crop_size=64))
    raw.update(version=version, device="cpu", num_epochs=2, log_dir=str(log_dir),
               compute_dtype="float32", train_dataset=ds, val_dataset=ds, test_dataset=ds,
               model={"name": "isw", "params": dict(raw["model"]["params"],
                                                    layers=[1, 1, 1, 1])},
               scheduler={"name": "cosine", "params": {"T_max": 2, "eta_min": 1e-5}})
    for split in ("train", "val", "test"):
        raw[f"{split}_loader"] = dict(raw[f"{split}_loader"], num_workers=0,
                                      batch_size=2 if split == "train" else 1)
    raw.update(over)
    return raw


def _record_masks(tracker):
    """Keep a copy of the masks after every set_mask_matrix."""
    seen, select = [], tracker.set_mask_matrix

    def wrapped():
        select()
        seen.append([m.copy() for m in tracker.masks])

    tracker.set_mask_matrix = wrapped
    return seen


def _log(trainer):
    return open(os.path.join(trainer.log_dir, "log.txt")).read()


@pytest.fixture(scope="module")
def jax_isw_run(root, tmp_path_factory):
    """The JAX trainer on sta_isw.yml (tiny depth): its seeded initial
    weights as a port .pth, --task test on them, a 2-epoch train_and_test
    with the masks after each validation, and its counter's counts from
    its last.ckpt."""
    tmp = tmp_path_factory.mktemp("jax_isw")
    jt = JaxTrainer(JaxConfig.from_dict(_cfg(root, tmp / "logs", "sta_isw")))
    jt.build()
    init = str(tmp / "init.pth")
    pm = MODELS.build("isw", layers=(1, 1, 1, 1))
    torch.save(state_dict_from_flax(pm, unfreeze(jt.state.params),
                                    unfreeze(jt.state.batch_stats)), init)
    test = jt.test()
    masks = _record_masks(jt.isw_tracker)
    start = len(_log(jt))
    jt.train_and_test()
    frames = np.random.default_rng(4).integers(0, 256, (2, 96, 112, 3), dtype=np.uint8)
    last = os.path.join(jt.log_dir, "last.ckpt")
    counts = JaxVideoCounter.from_checkpoint("isw", last, dtype=jnp.float32,
                                             layers=(1, 1, 1, 1)).count_frames(frames)
    return {"init": init, "test": test, "log": _log(jt)[start:], "masks": masks,
            "last": last, "frames": frames, "counts": np.asarray(counts)}


def test_isw_train_and_test_matches_the_jax_trainer(root, jax_isw_run, tmp_path, capsys):
    cfg = _cfg(root, tmp_path / "logs", "sta_isw")
    t = DGTrainer(Config.from_dict(cfg), device="cpu")
    got = t.test(checkpoint=jax_isw_run["init"])
    for k in ("mae", "mse"):
        np.testing.assert_allclose(got[k], jax_isw_run["test"][k], rtol=1e-4, err_msg=k)
    path = tmp_path / "sta_isw.yml"
    path.write_text(yaml.safe_dump(cfg))
    main(["--config", str(path), "--task", "test", "--ckpt", jax_isw_run["init"]])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Testing results:")][-1]
    printed = dict(re.findall(r"(\w+): ([\d.]+)", line))
    for k in ("mae", "mse"):
        assert abs(float(printed[k]) - got[k]) <= 1e-4 + 1e-4 * got[k], (k, line)

    t = DGTrainer(Config.from_dict(_cfg(root, tmp_path / "logs2", "sta_isw")), device="cpu")
    t.build()
    t.model.load_state_dict(torch.load(jax_isw_run["init"], weights_only=True))
    masks = _record_masks(t.isw_tracker)
    t.train_and_test()
    log = _log(t)
    losses = {int(e): float(v) for e, v in re.findall(r"Epoch (\d+): Training loss: (\S+)", log)}
    want = {int(e): float(v) for e, v in re.findall(r"Epoch (\d+): Training loss: (\S+)",
                                                    jax_isw_run["log"])}
    assert sorted(losses) == sorted(want) == [0, 1]
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-3)
    assert len(masks) == len(jax_isw_run["masks"]) == 2
    assert [m.shape for m in masks[0]] == [(64, 64), (256, 256), (512, 512)]
    # the statistics come from weights one epoch apart in the two frameworks'
    # rounding: entries within that rounding of the cutoff may trade places
    for a, b in zip(masks[0], jax_isw_run["masks"][0]):
        assert a.sum() == b.sum()
        assert (a != b).sum() / 2 <= 1e-2 * a.sum(), (a != b).sum()
    assert t.isw_tracker.num_sensitive[0] <= 1008

    def masked(text):
        text = re.sub(r"/\S+", "<path>", text)
        return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()

    want_lines, got_lines = masked(jax_isw_run["log"]), masked(log)
    assert len(got_lines) == len(want_lines) > 10
    for a, b in zip(got_lines, want_lines):
        assert a == b
    for pattern in ("last.pth", "best_*.pth"):
        assert glob(os.path.join(t.log_dir, pattern)), pattern


def test_video_counter_serves_an_isw_jax_ckpt(jax_isw_run):
    """The JAX last.ckpt of an isw run: served, and loaded into a train
    state (weights only; the optax state does not carry over)."""
    c = VideoCounter.from_checkpoint("isw", jax_isw_run["last"], dtype=torch.float32,
                                     device="cpu", layers=(1, 1, 1, 1))
    np.testing.assert_allclose(c.count_frames(jax_isw_run["frames"]), jax_isw_run["counts"],
                               rtol=1e-4)
    state = create_train_state(MODELS.build("isw", layers=(1, 1, 1, 1)), ADAMW, device="cpu")
    extra, warnings = load_checkpoint(jax_isw_run["last"], state)
    assert extra["epoch"] == 1 and any("optimizer state not restored" in w for w in warnings)
    for k, v in c.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_cli_serves_a_baseline_config(tmp_path, capsys):
    """--task serve with configs/baselines/sta_sw.yml (full width, random
    weights from its seed, bf16) on two frames, on the CPU."""
    frames = np.random.default_rng(5).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"frame{i}.png")
    cfg = os.path.join(os.path.dirname(__file__), "..", "configs", "baselines", "sta_sw.yml")
    main(["--config", cfg, "--task", "serve", "--frames", str(tmp_path), "--device", "cpu",
          "--batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    counts = [float(ln.split()[1]) for ln in lines if ln.startswith("frame")]
    assert len(counts) == 2 and np.isfinite(counts).all()


@pytest.mark.parametrize("hw", [(96, 112), (128, 128)])
def test_covariance_pass_runs_on_the_image_itself(hw):
    """The port's covariance pass takes the whole image unpadded (the
    reference's predict2); the JAX trainer pads it with black to multiples
    of 128 (dgvcc_tpu/train/trainer.py:742-745). At 128x128 the two are the
    same pass; at 96x112 the padding moves the statistics far outside 1e-4."""
    jm, variables, pm = _pair("isw", 80)
    rng = np.random.default_rng(81)
    sample = {k: rng.normal(size=hw + (3,)).astype(np.float32) for k in ("img1", "img2")}
    counter = TiledCounter(pm, 1000.0, 1440, device="cpu")
    with counter.evaluating():
        (x2,) = covariance_views(counter, sample, 1440)
        got = pm.cov_stats(x2)
    assert tuple(x2.shape) == (2, 3) + hw
    jc = JaxTiledCounter(lambda v, t: jm.apply(v, t), 1000.0, 1440)
    tiles = [jc._whole_image(sample[k])[0] for k in ("img1", "img2")]
    want = jax.jit(lambda v, xx: jm.apply(v, xx, method=jm.cov_stats))(
        variables, jnp.concatenate([jnp.asarray(t) for t in tiles]))
    errs = {}
    for k in want:
        w = np.asarray(want[k])
        errs[k] = float(np.abs(got[k].numpy() - w).max() / np.abs(w).max())
    if hw == (128, 128):
        assert max(errs.values()) <= FWD, errs
    else:
        assert min(errs.values()) > 1e-2, errs


# ------------------------------------------------------------ the 18 configs

BASELINES = sorted(glob(os.path.join(os.path.dirname(__file__), "..", "configs", "baselines",
                                     "*.yml")))
BASELINES = [p for p in BASELINES if re.search(r"_(sw|ibn|isw)\.yml$", p)]


@pytest.mark.parametrize("path", BASELINES, ids=os.path.basename)
def test_whitening_baseline_builds_in_the_trainer_at_full_width(path, tmp_path):
    raw = yaml.safe_load(open(path))
    os.makedirs(tmp_path / "domains")
    for split in ("train", "val", "test"):
        spec = raw[f"{split}_dataset"]
        raw[f"{split}_dataset"] = dict(spec, params=dict(spec["params"], root=str(tmp_path)))
        raw[f"{split}_loader"] = dict(raw[f"{split}_loader"], num_workers=0)
        label = spec["params"].get("domain_label")
        for phase in ("train", "val"):
            if label:
                (tmp_path / "domains" / f"{label}_{phase}.txt").touch()
    raw["log_dir"] = str(tmp_path / "logs")
    t = DGTrainer(Config.from_dict(raw), device="cpu")
    t.build()
    assert type(t.model).__name__ == {"sw": "SWCounterResNet", "ibn": "IBNCounterResNet",
                                      "isw": "ISWCounterResNet"}[raw["model"]["name"]]
    assert (t.isw_tracker is not None) == (raw["mode"] == "isw")
    assert t.state.optimizer.param_groups[0]["lr"] > 0
    with torch.no_grad():
        d = t.model.eval()(torch.zeros(1, 3, 64, 64))
    assert d.shape == (1, 1, 64, 64) and torch.isfinite(d).all()
