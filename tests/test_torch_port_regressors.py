"""The port's U-Net regressors (dgvcc_tpu_torch/models/regressors.py: dgnet,
dgnet_cls, reg, reg_mem), their losses (losses/misc.py, train/genjoint.py:
modes regression and discrimination), the weight bridge and the vgg16_bn
mapping (nn/convert.py), against the JAX package on the CPU in float32.

``dgnet``, ``dgnet_cls`` and ``reg`` have no tiny-geometry knob in the JAX
package, so they run at full width on 32x32 inputs; ``reg_mem`` runs at the
tiny geometry (dgvcc_tpu.testing.TINY_VGG, a 16-prototype bank). Weights
come from numpy seeds into the JAX variables and reach the port through its
bridge. Dropout cannot draw the same numbers in both frameworks: the
training tests inject the same masks into both (each framework's
``dropout2d`` replaced by one that takes the i-th mask of a seeded list, in
call order).

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result:
  * eval forwards, forward_train's outputs, loss parts and running
    statistics: 1e-4 (float32, another order of summation);
  * true_jsd, kl_div_batchmean: 1e-6;
  * parameter gradients: 1e-3 in relative norm, against 1e-3 of the largest
    gradient norm at least; 1e-2 for full-width dgnet's discrimination loss,
    whose gradients spread by up to 5.4e-3 between JAX's own jit and eager
    runs (``GRAD_SPREAD``);
  * the bridge and the pretrained mapping: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.losses  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.losses import misc as jmisc
from dgvcc_tpu.models import regressors as jreg
from dgvcc_tpu.nn import layers as jlayers
from dgvcc_tpu.nn import torch_io
from dgvcc_tpu.testing import TINY_VGG
from dgvcc_tpu.train import genjoint as jgen
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.losses.misc import triplet_loss
from dgvcc_tpu_torch.models import regressors as preg
from dgvcc_tpu_torch.nn import layers as players
from dgvcc_tpu_torch.nn.convert import install_pretrained, state_dict_from_flax
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_loss_fn
from test_torch_port_helpers import close, close_grads, nchw, nhwc, randomize

FWD, JSD, GRAD = 1e-4, 1e-6, 1e-3
TINY_REG_MEM = dict(vgg_cfg=TINY_VGG, stage_splits=(0, 8, 12, 16),
                    dec_widths=((16, 16), (16, 16), (16, 8)), part_num=16, final_dim=16)
GEOMETRY = {"dgnet": {}, "dgnet_cls": {}, "reg": {}, "reg_mem": TINY_REG_MEM}
HW = {"dgnet": (32, 32), "dgnet_cls": (32, 32), "reg": (64, 64), "reg_mem": (64, 64)}


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


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    else:
        yield out


# ------------------------------------------------------------ eval forward

@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_eval_forward_matches_jax(name):
    """Every output of the eval forward; reg_mem's bank through the serving
    kernel's plain version (f32) against the JAX einsum path."""
    jm, variables, pm = _pair(name, 1)
    h, w = HW[name]
    x = np.random.default_rng(2).normal(size=(2, h, w + 16, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(nchw(x))
    got, want = list(_leaves(got)), list(_leaves(want))
    assert len(got) == len(want)
    for i, (g, wt) in enumerate(zip(got, want)):
        close(nhwc(g), wt, FWD, f"{name} output {i}")
    if name == "reg_mem":
        assert pm.memory.fused


def test_true_jsd_and_kl_div_batchmean_match_jax():
    rng = np.random.default_rng(3)
    l1, l2 = (rng.normal(0, 2, (2, 24, 16)).astype(np.float32) for _ in range(2))
    close(preg.true_jsd(torch.from_numpy(l1), torch.from_numpy(l2)),
          jreg.true_jsd(jnp.asarray(l1), jnp.asarray(l2)), JSD, "true_jsd")
    log_p = np.log(rng.dirichlet(np.ones(16), (3, 5))).astype(np.float32)
    target = rng.dirichlet(np.ones(16), (3, 5)).astype(np.float32)
    target[0, 0, :4] = 0.0  # zero targets take the clamped log
    close(preg.kl_div_batchmean(torch.from_numpy(log_p), torch.from_numpy(target)),
          jreg.kl_div_batchmean(jnp.asarray(log_p), jnp.asarray(target)), JSD, "kl_div")


def test_triplet_loss_matches_jax():
    rng = np.random.default_rng(4)
    a, p, n = (rng.normal(0, 0.5, (5, 12)).astype(np.float32) for _ in range(3))
    for margin in (0.5, 5.0):
        close(triplet_loss(*(torch.from_numpy(t) for t in (a, p, n)), margin=margin),
              jmisc.triplet_loss(a, p, n, margin=margin), JSD, f"margin {margin}")
    assert float(triplet_loss(torch.from_numpy(a), torch.from_numpy(a),
                              torch.from_numpy(a) + 10.0)) == 0.0


# ------------------------------------------------------------ training

@pytest.fixture
def masks(monkeypatch):
    """The same dropout masks in both frameworks: the i-th call of either
    framework's dropout2d keeps the channels of seeded mask i."""
    def mask(i, n, c, keep):
        return np.random.default_rng(1000 + i).random((n, c)) < keep

    calls = {"jax": 0, "torch": 0}

    def jax_drop(x, rate, rng, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        i = calls["jax"]
        calls["jax"] += 1
        m = mask(i, x.shape[0], x.shape[-1], 1.0 - rate)[:, None, None, :]
        return jnp.where(m, x / (1.0 - rate), 0.0)

    torch_orig = players.dropout2d

    def torch_drop(x, rate, generator=None, mask_=None):
        if rate == 0.0:
            return x
        i = calls["torch"]
        calls["torch"] += 1
        return torch_orig(x, rate, mask=torch.from_numpy(mask(i, x.shape[0], x.shape[1],
                                                              1.0 - rate)))

    for mod in (jlayers, jreg):
        monkeypatch.setattr(mod, "dropout2d", jax_drop)
    for mod in (players, preg):
        monkeypatch.setattr(mod, "dropout2d", torch_drop)
    return calls


def _batch(name, seed, b=2):
    h, w = HW[name]
    rng = np.random.default_rng(seed)
    batch = {"img1": rng.normal(size=(b, h, w, 3)).astype(np.float32),
             "img2": rng.normal(size=(b, h, w, 3)).astype(np.float32),
             "dmap": rng.uniform(0, 2e-3, (b, h, w, 1)).astype(np.float32),
             "bmap": (rng.random((b, h // 16, w // 16, 1)) < 0.6).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: nchw(v) for k, v in batch.items()})


@pytest.mark.parametrize("c_gt", [True, False])
def test_reg_mem_forward_train_matches_jax_with_injected_masks(masks, c_gt):
    jm, variables, pm = _pair("reg_mem", 5, fused_mem=False)
    jb, pb = _batch("reg_mem", 6)
    args = (jb["img1"], jb["img2"], jb["bmap"] if c_gt else None)
    want, _ = jax.jit(lambda v: jm.apply(v, *args, method=jm.forward_train,
                                         mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(0)}))(variables)
    pm.train()
    with torch.no_grad():
        got = pm.forward_train(pb["img1"], pb["img2"], pb["bmap"] if c_gt else None)
    assert masks == {"jax": 4, "torch": 4}
    for i, (g, w) in enumerate(zip(got, want)):
        g = nhwc(g) if g.ndim == 4 else g
        close(g, w, FWD, f"output {i}")
    assert float(got[4]) > 0 and float(got[5]) > 0


LOSS_CASES = [("dgnet", "simple"), ("dgnet", "discrimination"), ("reg_mem", "regression"),
              ("reg_mem", "discrimination")]
# full-width dgnet's triplet gradient in the trunk: the JAX loss's own jit
# and eager runs differ by up to 5.4e-3 in relative norm (stage1.4.weight
# 1.1e-3); the port differs from the jit run by up to 3.4e-3
GRAD_SPREAD = {("dgnet", "discrimination"): 1e-2}


def _jax_loss(jm, mode):
    loss = JAX_LOSSES.build("mse")
    if mode == "regression":
        return jgen.build_regression_loss(jm, loss, 1000.0)
    if mode == "discrimination":
        return jgen.build_discrimination_loss(jm, loss, 1000.0)
    return jsteps.build_loss_fn(jm, loss, mode, 1000.0)


@pytest.mark.parametrize("name,mode", LOSS_CASES)
def test_losses_gradients_and_statistics_match_jax(masks, name, mode):
    jm, variables, pm = _pair(name, 10, **({"fused_mem": False} if name == "reg_mem" else {}))
    jb, pb = _batch(name, 11)
    (_, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jm, mode), has_aux=True))(variables["params"], variables["batch_stats"],
                                            jb, jax.random.PRNGKey(0), jnp.int32(0))
    loss_fn = build_loss_fn(pm, LOSSES.build("mse"), mode, 1000.0)
    total, got = loss_fn(pb, None, 0)
    total.backward()
    assert masks["jax"] == masks["torch"] > 0
    assert set(got) == set(metrics)
    for k, w in metrics.items():
        close(got[k], w, FWD, k)
    if mode == "discrimination":
        assert float(got["loss_tri"].detach()) > 0
    want_grads = state_dict_from_flax(pm, unfreeze(grads), None)
    assert {n for n, _ in pm.named_parameters()} == set(want_grads)
    for n, p in pm.named_parameters():
        if p.grad is None:  # behind a binarised gate: JAX's gradient is a zero
            assert not want_grads[n].any(), n
            p.grad = torch.zeros_like(p)
    close_grads(pm, want_grads, GRAD_SPREAD.get((name, mode), GRAD))
    want_stats = state_dict_from_flax(pm, variables["params"], unfreeze(new_stats))
    for k, b in pm.named_buffers():
        if not k.endswith("num_batches_tracked"):
            close(b, want_stats[k].numpy(), FWD, k)


def test_discrimination_triplet_is_zero_at_batch_one(masks):
    _, _, pm = _pair("reg_mem", 12, fused_mem=False)
    _, pb = _batch("reg_mem", 13, b=1)
    _, got = build_loss_fn(pm, LOSSES.build("mse"), "discrimination", 1000.0)(pb, None, 0)
    assert float(got["loss_tri"]) == 0.0 and float(got["loss_den"]) > 0


def test_discrimination_probe_reads_the_traced_statistics():
    """The statistics the probe normalises with are the buffers the two
    train-mode forwards left, and the probe moves nothing."""
    from dgvcc_tpu_torch.train.genjoint import stride16_features, traced_running_statistics

    _, _, pm = _pair("reg_mem", 14, fused_mem=False)
    _, pb = _batch("reg_mem", 15)
    pm.train()
    with traced_running_statistics(pm) as running:
        for k in ("img1", "img2"):
            pm(pb[k], generator=torch.Generator())
    stats = running()
    for bn, (mean, var) in stats.items():
        close(mean, bn.running_mean.numpy(), 1e-5, "running mean")
        close(var, bn.running_var.numpy(), 1e-5, "running var")
    before = {k: v.clone() for k, v in pm.named_buffers()}
    f = stride16_features(pm, pb["img1"], stats)
    assert pm.training and f.shape[1] == pm.x3_channels and f.requires_grad
    for k, v in pm.named_buffers():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ weights

def test_reg_mem_bridge_round_trips_through_the_jax_reader(tmp_path):
    """Full-width reg_mem: JAX variables -> the port's strict state_dict ->
    regressor_m_checkpoint_to_flax gives them back exactly, and the .pth
    strict-loads into VideoCounter.from_checkpoint("reg_mem", path)."""
    jm = JAX_MODELS.build("reg_mem")
    rng = np.random.default_rng(20)
    params, stats = _variable_shapes(jm, (32, 32))
    variables = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    pm = MODELS.build("reg_mem")
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    got_p, got_s = torch_io.regressor_m_checkpoint_to_flax(sd)
    for tree, got in (("params", got_p), ("batch_stats", got_s)):
        want, got = dict(_flat(variables[tree])), dict(_flat(got))
        assert set(got) == set(want), tree
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    path = str(tmp_path / "reg_mem.pth")
    torch.save(pm.state_dict(), path)
    c = VideoCounter.from_checkpoint("reg_mem", path, dtype=torch.float32, device="cpu")
    for k, v in pm.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    state = create_train_state(MODELS.build("reg_mem"), {"name": "adamw"}, device="cpu")
    from dgvcc_tpu_torch.train.checkpoint import load_checkpoint

    load_checkpoint(path, state, strict=True)


def _torchvision_vgg16_bn(rng):
    from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, feature_layout

    sd, ch = {}, 3
    for kind, idx, arg in feature_layout(VGG16_CFG, True):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (arg, ch, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.1, arg)
                                                          .astype(np.float32))
            ch = arg
        elif kind == "bn":
            for f, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.1, 0.1),
                              ("running_mean", -0.1, 0.1), ("running_var", 0.5, 2.0)):
                sd[f"features.{idx}.{f}"] = torch.from_numpy(
                    rng.uniform(lo, hi, arg).astype(np.float32))
    return sd


@pytest.mark.parametrize("name", ["dgnet", "dgnet_cls", "reg", "reg_mem"])
def test_vgg16_bn_lands_where_the_jax_mapping_puts_it(name, tmp_path):
    """Full width: load_vgg16bn_into_unet's variables, through the bridge,
    equal the port's model after install_pretrained, key for key."""
    jm = JAX_MODELS.build(name)
    rng = np.random.default_rng(30)
    params, stats = _variable_shapes(jm, (32, 32))
    variables = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    pm = MODELS.build(name)
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    path = str(tmp_path / "vgg16_bn.pth")
    torch.save(_torchvision_vgg16_bn(rng), path)
    want_vars, want_desc = torch_io.load_pretrained_backbone(variables, name,
                                                             {"vgg16_bn": path})
    assert install_pretrained(pm, name, {"vgg16_bn": path}) == want_desc
    want = state_dict_from_flax(pm, want_vars["params"], want_vars["batch_stats"])
    before = state_dict_from_flax(pm, variables["params"], variables["batch_stats"])
    got = pm.state_dict()
    moved = set()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
            if not torch.equal(w, before[k]):
                moved.add(k)
    assert len(moved) == 13 * 6 and all(k.startswith("stage") for k in moved)


def test_batch_moments_gradient_is_exact():
    """The discrimination probe's batch statistics (mean and unbiased
    variance per channel) and their hand-written backward, against autograd
    in float64."""
    from dgvcc_tpu_torch.train.genjoint import _BatchMoments

    x = torch.randn(3, 4, 5, 6, dtype=torch.float64, requires_grad=True)
    mean, var = _BatchMoments.apply(x)
    torch.testing.assert_close(mean, x.mean(dim=(0, 2, 3)).float(), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(var, x.var(dim=(0, 2, 3), unbiased=True).float(), rtol=1e-6,
                               atol=1e-7)
    g_mean, g_var = torch.randn(4, dtype=torch.float64), torch.randn(4, dtype=torch.float64)
    (mean.double() * g_mean + var.double() * g_var).sum().backward()
    y = x.detach().clone().requires_grad_()
    (y.mean(dim=(0, 2, 3)) * g_mean + y.var(dim=(0, 2, 3), unbiased=True) * g_var).sum() \
        .backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)
