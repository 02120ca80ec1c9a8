"""The port's Bayesian loss (dgvcc_tpu_torch/losses/bayesian.py, ``bl``), its
datasets (data/datasets.py ``bay``, data/jhu.py ``jhu_domain_bay``) and a
``sta_bl``-style trainer run, against the JAX package on the CPU in float32.

The JAX loss defaults ``stride: 1``, so given only ``sigma`` and ``c_size``
it builds c_size^2 cells and fails on a stride-8 prediction; the port reads
the stride from the prediction when the config leaves it out (ROADMAP.md,
Queue 3). The parity tests give both sides ``stride: 8``.

Tolerances: the loss and its gradient with respect to the prediction 1e-5
(relative to the largest value); loader batches bit for bit; the trainer's
test from the same weights rtol 1e-4, its first-epoch loss and its test
line after training rtol 1e-3, log.txt line for line.
"""

import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze
from PIL import Image

import dgvcc_tpu.data  # noqa: F401
import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu_torch.data  # noqa: F401
import dgvcc_tpu_torch.losses  # noqa: F401
from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.core.registry import DATASETS as JAX_DATASETS
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.data.loader import build_loader as jax_loader
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.registry import DATASETS, LOSSES
from dgvcc_tpu_torch.data.loader import build_loader
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_helpers import close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LOSS_LINE = re.compile(r"Epoch (\d+): Training loss: ([-\d.naninf]+)")
TEST_LINE = re.compile(r"Testing results: mae: ([\d.]+) mse: ([\d.]+)")


def _batch(seed, counts, c_size=320, n_pad=64, h=40):
    """Padded points (some outside the crop), targets, crop sizes and a
    stride-8 prediction; image i has counts[i] points."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    pts = rng.uniform(-24, c_size + 24, (b, n_pad, 2)).astype(np.float32)
    msk = np.zeros((b, n_pad), bool)
    for i, k in enumerate(counts):
        msk[i, :k] = True
    tgt = (rng.uniform(0.3, 1.0, (b, n_pad)) * msk).astype(np.float32)
    st = rng.uniform(c_size, 2 * c_size, b).astype(np.float32)
    pred = rng.uniform(0, 0.05, (b, h, h, 1)).astype(np.float32)
    return pts, msk, tgt, st, pred


def _port(params, pts, msk, tgt, st, pred):
    p = torch.from_numpy(pred.transpose(0, 3, 1, 2).copy()).requires_grad_()
    loss = LOSSES.build("bl", **params)(*(torch.from_numpy(a) for a in (pts, msk, tgt, st)), p)
    loss.backward()
    return loss.detach(), p.grad.numpy().transpose(0, 2, 3, 1)


def _jax(params, pts, msk, tgt, st, pred):
    loss = JAX_LOSSES.build("bl", **params)
    return jax.value_and_grad(lambda d: loss(*(jnp.asarray(a) for a in (pts, msk, tgt, st)), d))(
        jnp.asarray(pred))


# counts: a no-point image, one point, two (the trim keeps ceil(0.9) = 1
# of 1), eleven (9 of 10 kept: the trim cuts), 50 (45 of 49)
@pytest.mark.parametrize("use_background", [True, False])
@pytest.mark.parametrize("counts", [(0, 1, 2, 11, 50), (3, 64)])
def test_bayesian_loss_and_its_gradient_match_jax(use_background, counts):
    params = dict(sigma=8.0, c_size=320, stride=8, background_ratio=0.15,
                  use_background=use_background, device="cuda")
    args = _batch(sum(counts), counts)
    want, want_grad = _jax(params, *args)
    got, got_grad = _port(params, *args)
    close(got, want, TOL, "loss")
    close(got_grad, want_grad, TOL, "d loss / d pred")
    assert float(got) > 0


def test_a_no_point_image_costs_the_sum_of_its_density():
    pts, msk, tgt, st, pred = _batch(3, (0, 0))
    got, _ = _port(dict(stride=8), pts, msk, tgt, st, pred)
    np.testing.assert_allclose(float(got), pred.reshape(2, -1).sum(1).mean(), rtol=1e-6)


def test_the_stride_comes_from_the_prediction_where_the_config_leaves_it_out():
    """sta_bl.yml's loss without its ``stride`` key: the JAX loss's default
    stride 1 builds 320x320 cells against the (2, 40, 40, 1) prediction of a
    stride-8 model and raises; the port's implied stride (320 // 40 = 8)
    gives what both give with ``stride: 8``. A prediction whose side does
    not divide c_size, or disagrees with a stride given, raises naming both
    numbers."""
    with open(os.path.join(REPO, "configs", "baselines", "sta_bl.yml")) as f:
        shipped = yaml.safe_load(f)["loss"]["params"]
    assert shipped["stride"] == 8
    params = {k: v for k, v in shipped.items() if k != "stride"}
    args = _batch(5, (4, 9))
    with pytest.raises(TypeError, match="dot_general requires contracting dimensions"):
        _jax(params, *args)
    want, want_grad = _jax(dict(params, stride=8), *args)
    got, got_grad = _port(params, *args)
    close(got, want, TOL, "loss")
    close(got_grad, want_grad, TOL, "d loss / d pred")
    with pytest.raises(ValueError, match=r"side 48 does not divide c_size 320"):
        _port(params, *_batch(5, (4, 9), h=48))
    with pytest.raises(ValueError, match=r"stride 4 on c_size 320 gives 80 cells a side, the "
                                         r"prediction has 40"):
        _port(dict(params, stride=4), *args)


# ------------------------------------------------------------ the datasets

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The canonical layout and a JHU domain listing: JPEGs of 96x112 and,
    smaller than the crop on one side, 56x120, with 0 to 40 points each (and
    their maps, for the den test split); domains/jhu_fog_{train,val}.txt."""
    root = tmp_path_factory.mktemp("bay_data")
    rng = np.random.default_rng(13)
    (root / "domains").mkdir()
    listing = {"train": [], "val": []}
    for split, n in (("train", 6), ("val", 2), ("test", 2)):
        (root / split).mkdir()
        for k in range(n):
            h, w = (56, 120) if k % 3 == 1 else (96, 112)
            name = root / split / f"img{k:03d}.jpg"
            Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(name)
            pts = rng.uniform(0, [w, h], ((0, 1, 2, 3, 12, 40)[k % 6], 2)).astype(np.float32)
            np.save(root / split / f"img{k:03d}.npy", pts)
            np.save(root / split / f"img{k:03d}_dmap.npy", dmap.gaussian_density_fixed_np((h, w),
                                                                                         pts))
            if split in listing:
                listing[split].append(str(name))
    for split, names in listing.items():
        (root / "domains" / f"jhu_fog_{split}.txt").write_text("\n".join(names) + "\n")
    return str(root)


def _ds_params(root, name):
    p = {"root": root, "crop_size": 64, "downsample": 1, "is_grey": False, "unit_size": 16}
    if name == "jhu_domain_bay":
        p.update(domain_label="jhu_fog", domain_type="weather")
    return p


@pytest.mark.parametrize("name", ["bay", "jhu_domain_bay"])
def test_loader_batches_match_jax_bit_for_bit(root, name):
    """Two epochs of train batches (B=3, shuffled; points, mask, targets,
    crop sizes, images) and the val samples."""
    params = _ds_params(root, name)
    for split, cfg in (("train", {"batch_size": 3, "shuffle": True, "num_workers": 2}),
                       ("val", {"batch_size": 1, "shuffle": False})):
        jl = jax_loader(JAX_DATASETS.build(name, method=split, **params), cfg, seed=7)
        pl = build_loader(DATASETS.build(name, method=split, **params), cfg, seed=7)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want, got = list(jl), list(pl)
            assert len(got) == len(want) > 0
            for w, g in zip(want, got):
                assert set(g) == set(w), (set(g), set(w))
                for k in w:
                    if isinstance(w[k], np.ndarray):
                        assert g[k].dtype == w[k].dtype, k
                        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")
                    else:
                        assert g[k] == w[k], k
        pl.close()
    train = DATASETS.build(name, method="train", **params)
    sample = train.__getitem__(1, rng=random.Random(3))  # 56x120: padded to the crop
    assert sample["st_size"] == 64.0 and sample["img1"].shape == (64, 64, 3)


# ------------------------------------------------------------ the trainer

def _cfg(root, log_dir):
    ds_bay = {"name": "bay", "params": _ds_params(root, "bay")}
    ds_den = {"name": "den", "params": {"root": root, "crop_size": 64, "downsample": 8,
                                        "is_grey": False, "unit_size": 16, "pre_resize": 1}}
    return {"seed": 2112, "version": "sta_bl_cpu", "device": "cpu", "log_para": 1,
            "patch_size": 1440, "mode": "simple", "num_epochs": 1, "checkpoint": None,
            "model": {"name": "bl", "params": {"pretrained": False}},
            "train_dataset": ds_bay, "val_dataset": ds_bay, "test_dataset": ds_den,
            "train_loader": {"batch_size": 2, "num_workers": 0, "shuffle": True},
            "val_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
            "test_loader": {"batch_size": 1, "num_workers": 0, "shuffle": False},
            "loss": {"name": "bl", "params": {"sigma": 8.0, "c_size": 64, "stride": 8,
                                              "background_ratio": 0.15,
                                              "use_background": True}},
            "optimizer": {"name": "adamw", "params": {"lr": 1e-5, "weight_decay": 1e-4}},
            "scheduler": None, "compute_dtype": "float32", "log_dir": str(log_dir)}


def _masked(text):
    text = re.sub(r"/\S+", "<path>", text)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text).splitlines()


def test_sta_bl_style_trainer_matches_the_jax_trainer(root, tmp_path):
    """Full-width bl (VGG19), the Bayesian loss on bay crops of 64 at stride
    8, log_para 1, one epoch of train_and_test (the BaseTrainer's test after
    the epoch, on den maps at stride 8): a test from the same weights (MAE
    and MSE to 1e-4), then the epoch's loss, the test line and log.txt
    against the JAX trainer. After the three AdamW steps the test's MSE is
    held at 1e-3: AdamW moves each weight by about +-lr whatever its
    gradient's size, and the signs of rounding-level gradients differ
    between the frameworks (the MSE moved by 2.0e-4, measured)."""
    cfg = _cfg(root, tmp_path)
    jt = JaxTrainer(JaxConfig.from_dict(dict(cfg, log_dir=str(tmp_path / "jax"))))
    jt.build()
    t = DGTrainer(Config.from_dict(dict(cfg, log_dir=str(tmp_path / "port"))), device="cpu")
    t.build()
    t.model.load_state_dict(state_dict_from_flax(t.model, unfreeze(jt.state.params),
                                                 unfreeze(jt.state.batch_stats)), strict=True)
    want0 = jt.test()
    got0 = t.test()
    for k in ("mae", "mse"):
        np.testing.assert_allclose(got0[k], want0[k], rtol=1e-4, err_msg=f"{k}, same weights")
    jt.train_and_test()
    t.train_and_test()
    want, got = (open(os.path.join(x.log_dir, "log.txt")).read() for x in (jt, t))
    assert "Saving test model..." in got
    want_loss, got_loss = LOSS_LINE.findall(want), LOSS_LINE.findall(got)
    assert len(got_loss) == len(want_loss) == 1
    np.testing.assert_allclose(float(got_loss[0][1]), float(want_loss[0][1]), rtol=1e-3)
    assert np.isfinite(float(got_loss[0][1])) and float(got_loss[0][1]) > 0
    want_test = np.array(TEST_LINE.findall(want), float)
    got_test = np.array(TEST_LINE.findall(got), float)
    assert got_test.shape == want_test.shape == (2, 2)  # the test before, the one after
    np.testing.assert_allclose(got_test, want_test, rtol=1e-3)
    want_lines, got_lines = _masked(want), _masked(got)
    assert len(got_lines) == len(want_lines) > 12
    for a, b in zip(got_lines, want_lines):
        assert a == b
