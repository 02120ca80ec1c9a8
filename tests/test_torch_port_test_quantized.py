"""The trainer's ``test_quantized: true`` (dgvcc_tpu_torch/train/trainer.py)
against the JAX trainer's (dgvcc_tpu/train/trainer.py:865-913) on the CPU,
at the tiny `final` geometry of tests/test_torch_port_trainer.py, on a
synthetic dataset whose test split has 5 images (4 calibrate, all 5 count).

Both trainers test through an int8 graph in bfloat16 built from the same
weights and calibrated on the same crops; their per-image counts are held at
``INT8_COUNT`` of the JAX count (the int8 tolerance of
tests/test_torch_port_quant.py; the test report prints 3 decimals, so
1e-3 more), the MAE line at that share of the mean count.

The JAX trainer quantizes its raw parameters even when ``ema:`` is on,
while its fp test evaluates the EMA shadow (ROADMAP.md Queue 3); the port
quantizes the weights its test evaluates, which the EMA case holds.
"""

import csv
import os

import numpy as np
import pytest
import torch
from flax.core import unfreeze
from PIL import Image

from dgvcc_tpu.core.config import Config as JaxConfig
from dgvcc_tpu.train.trainer import DGTrainer as JaxTrainer
from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.nn import quant as pq
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.train.trainer import DGTrainer
from test_torch_port_quant import INT8_COUNT
from test_torch_port_trainer import SPLITS, _cfg, _log

N_TEST = 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs with 12 to 40 head points, their maps;
    5 test images."""
    root = tmp_path_factory.mktemp("tq_data")
    rng = np.random.default_rng(3)
    h, w = 96, 112
    for split, n in (("train", 2), ("val", 1), ("test", N_TEST)):
        (root / split).mkdir()
        for k in range(n):
            Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(
                root / split / f"img{k:03d}.jpg")
            pts = rng.uniform(0, [w, h], (int(rng.integers(12, 41)), 2)).astype(np.float32)
            np.save(root / split / f"img{k:03d}.npy", pts)
            np.save(root / split / f"img{k:03d}_dmap.npy",
                    dmap.gaussian_density_fixed_np((h, w), pts))
    return str(root)


def _report(path):
    with open(path) as f:
        return {r["name"]: float(r["pred_count"]) for r in csv.DictReader(f)}


@pytest.fixture(scope="module")
def jax_test(root, tmp_path_factory):
    """The JAX trainer's int8 test of its seeded weights: (the weights as a
    port .pth, its MAE / MSE, its per-image counts, its log)."""
    tmp = tmp_path_factory.mktemp("tq_jax")
    jt = JaxTrainer(JaxConfig.from_dict(_cfg(root, tmp / "logs", "tq", test_quantized=True,
                                             test_report=str(tmp / "jax.csv"))))
    jt.build()
    init = tmp / "init.pth"
    torch.save(dg_state_dict_from_flax(unfreeze(jt.state.params),
                                       unfreeze(jt.state.batch_stats), SPLITS), init)
    got = jt.test()
    return str(init), got, _report(tmp / "jax.csv"), _log(jt)


def _port(root, tmp_path, **over):
    cfg = _cfg(root, tmp_path / "logs", "tq", test_quantized=True,
               test_report=str(tmp_path / "port.csv"), **over)
    return DGTrainer(Config.from_dict(cfg), device="cpu")


def test_test_lines_match_the_jax_trainer(root, jax_test, tmp_path):
    init, want, want_counts, jax_log = jax_test
    t = _port(root, tmp_path)
    got = t.test(checkpoint=init)
    counts = _report(tmp_path / "port.csv")
    assert sorted(counts) == sorted(want_counts) and len(counts) == N_TEST
    for name, w in want_counts.items():
        assert abs(counts[name] - w) <= INT8_COUNT * abs(w) + 1e-3, (name, counts[name], w)
    mean = float(np.mean(np.abs(list(want_counts.values()))))
    for k in ("mae", "mse"):
        assert np.isfinite(got[k])
    assert abs(got["mae"] - want["mae"]) <= INT8_COUNT * mean + 1e-3
    line = "Testing through the int8 PTQ serving graph"
    assert line in jax_log and line in _log(t)
    log = _log(t)
    assert log.index("Start testing at") < log.index(line) < log.index("Testing results:")


def test_calibration_takes_the_first_4_samples_and_replays_them(root, jax_test, tmp_path,
                                                                monkeypatch):
    init = jax_test[0]
    seen = []
    build = pq.build_quantized

    def spy(model, calib, *a, **kw):
        seen.append(np.asarray(calib).copy())
        return build(model, calib, *a, **kw)

    monkeypatch.setattr(pq, "build_quantized", spy)
    t = _port(root, tmp_path)
    t.build()
    samples = list(t.loaders["test"])
    t.test(checkpoint=init)
    assert len(seen) == 1 and seen[0].shape == (4, 96, 96, 3)
    for crop, s in zip(seen[0], samples[:4]):
        assert np.array_equal(crop, s["img1"][:96, :96])
    with open(tmp_path / "port.csv") as f:
        names = sorted(r["name"] for r in csv.DictReader(f))
    assert names == sorted(str(s["name"]) for s in samples) and len(names) == N_TEST


def test_validation_keeps_the_fp_counter(root, jax_test, tmp_path):
    init = jax_test[0]
    t = _port(root, tmp_path)
    t.build()
    t.load_ckpt(init)
    fp = t.counter
    img = next(iter(t.loaders["val"]))["img1"]
    before = fp.count(img)
    t.test()
    assert t.counter is fp and fp.model is t.model
    assert fp.count(img) == before


def test_the_int8_graph_quantizes_the_ema_shadow(root, jax_test, tmp_path, monkeypatch):
    """With ``ema:`` on, the graph is folded from the shadow the fp test
    evaluates, not from the raw parameters (the JAX trainer's fault)."""
    init = jax_test[0]
    folded = []
    build = pq.build_quantized

    def spy(model, calib, *a, **kw):
        folded.append({k: v.detach().clone() for k, v in model.named_parameters()})
        return build(model, calib, *a, **kw)

    monkeypatch.setattr(pq, "build_quantized", spy)
    t = _port(root, tmp_path, ema=0.999)
    t.build()
    t.load_ckpt(init)
    raw = {k: v.detach().clone() for k, v in t.model.named_parameters()}
    for v in t.state.ema_params.values():  # a shadow apart from the weights
        v.mul_(0.5)
    shadow = {k: v.clone() for k, v in t.state.ema_params.items()}
    got = t.test()
    assert np.isfinite(got["mae"]) and len(folded) == 1
    assert all(torch.equal(folded[0][k], shadow[k]) for k in shadow)
    assert not any(torch.equal(folded[0][k], raw[k]) for k in shadow if raw[k].any())
    # the raw parameters come back after the test
    assert all(torch.equal(v, raw[k]) for k, v in t.model.named_parameters())
    assert os.path.exists(tmp_path / "port.csv")
