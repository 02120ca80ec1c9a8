"""The port's training path (dgvcc_tpu_torch: layers, DGModel.forward_train,
the train losses, optimizer, scheduler and step) against the JAX package
on the CPU, in float32, at the tiny geometry (dgvcc_tpu.testing.TINY_MEM)
with identical seeded weights carried over by the port's own bridge and
dropout rates 0 (random streams cannot match across frameworks).

Tolerances: forward outputs, loss parts and updated BN running statistics
rtol 1e-4 / atol 1e-5 (float32, other summation order); parameter
gradients rtol 1e-3 / atol 1e-5 (batch norm over tiny maps amplifies the
order of summation in the backward); parameters after one AdamW step
1e-5 (see the test for the conv biases whose exact gradient is 0); the
learning-rate trace 1e-12 (the same formulas).

The error mask |in(y1) - in(y2)| < err_thrs and the classifier threshold
flip whole blocks on noise at the level of the order of summation, so the
tests place both thresholds in a gap of the JAX model's own values and
assert a margin of more than 1e-3 on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgvcc_tpu.losses  # noqa: F401  (registers the JAX losses)
import dgvcc_tpu_torch.losses  # noqa: F401  (registers the port's)
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.nn import layers as jl
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu.train import optim as joptim
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.nn import layers as tl
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax
from dgvcc_tpu_torch.train import optim as toptim
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_loss_fn, build_train_step
from test_torch_port_helpers import jax_variables, nchw, nhwc

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
MARGIN = 1e-3
SPLITS = TINY_MEM["stage_splits"]
NO_DROPOUT = dict(TINY_MEM, den_dropout=0.0, cls_dropout=0.0)
MODE_VARIANT = {"simple": "base", "base": "base", "add": "memadd", "cls": "cls",
                "final": "final"}
ADAMW = {"name": "adamw", "params": {"lr": 0.001, "weight_decay": 0.0001}}
ONECYCLE = {"name": "onecycle", "params": {"max_lr": 0.001, "epochs": 150,
                                           "steps_per_epoch": 15, "final_div_factor": 1000}}


def _batch(seed, b=2, hw=32):
    """Two views of one scene (the second a perturbed copy, as augmented
    views are), a density map of about 1 after the x1000 scale, and a
    binary foreground map at stride 16."""
    rng = np.random.default_rng(seed)
    img1 = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    return {"img1": img1,
            "img2": (img1 + 0.5 * rng.normal(size=img1.shape)).astype(np.float32),
            "dmap": rng.uniform(0, 2e-3, (b, hw, hw, 1)).astype(np.float32),
            "bmap": (rng.uniform(size=(b, hw // 16, hw // 16, 1)) > 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: nchw(v) for k, v in batch.items()}


def _gap_midpoint(values, lo_q=0.2, hi_q=0.8):
    """The middle of the widest gap between sorted values in the central
    quantiles, and half its width (the margin a threshold there keeps)."""
    v = np.sort(np.asarray(values, np.float64).ravel())
    lo, hi = int(lo_q * (len(v) - 1)), int(hi_q * (len(v) - 1))
    gaps = np.diff(v[lo:hi + 1])
    i = int(np.argmax(gaps))
    return float(v[lo + i] + gaps[i] / 2), float(gaps[i] / 2)


def _thresholds(jm, variables, batch):
    """err_thrs and cls_thrs for which the JAX model's own |in(y1)-in(y2)|
    and classifier probabilities all lie more than MARGIN away."""
    def fn(m, a, b):
        if m.batched_two_view:
            y_cat, x3 = m.forward_fe(jnp.concatenate([a, b]), train=True)
            y1, y2 = jnp.split(m._den_features(y_cat, True), 2)
            cs = [m.cls_head(x3, train=True)] if m.use_cls else []
        else:
            (y_cat1, x3_1), (y_cat2, x3_2) = (m.forward_fe(v, train=True) for v in (a, b))
            y1, y2 = m._den_features(y_cat1, True), m._den_features(y_cat2, True)
            cs = [m.cls_head(x, train=True) for x in (x3_1, x3_2)] if m.use_cls else []
        diff = jnp.abs(jl.instance_norm(y1.astype(jnp.float32))
                       - jl.instance_norm(y2.astype(jnp.float32)))
        return diff, cs

    (diff, cs), _ = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=fn, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        variables, jnp.asarray(batch["img1"]), jnp.asarray(batch["img2"]))
    err_thrs, err_margin = _gap_midpoint(diff)
    assert err_margin > MARGIN, err_margin
    if not cs:
        return {"err_thrs": err_thrs}
    c = np.concatenate([np.asarray(x).ravel() for x in cs])
    cls_thrs, cls_margin = _gap_midpoint(c, 0.25, 0.75)
    assert cls_margin > MARGIN, cls_margin
    assert np.abs(np.asarray(diff) - err_thrs).min() > MARGIN
    assert np.abs(c - cls_thrs).min() > MARGIN
    return {"err_thrs": err_thrs, "cls_thrs": cls_thrs}


def _pair(variant, seed, batch, **flags):
    """(jax_model, variables, port_model in train mode) with identical f32
    weights, dropout 0, thresholds placed with a margin for ``batch``."""
    geometry = dict(NO_DROPOUT, **flags)
    jm = JAX_MODELS.build(variant, **geometry)
    params, stats = jax_variables(jm, np.random.default_rng(seed))
    variables = {"params": params, "batch_stats": stats}
    if variant in ("memadd", "final"):
        geometry.update(_thresholds(jm, variables, batch))
        jm = JAX_MODELS.build(variant, **geometry)
    pm = MODELS.build(variant, fused_mem=False, **geometry)
    pm.load_state_dict(dg_state_dict_from_flax(params, stats, SPLITS), strict=True)
    return jm, variables, pm.train()


def _assert_stats(pm, params, new_stats):
    want = dg_state_dict_from_flax(params, new_stats, SPLITS)
    got = pm.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)


# ---------------------------------------------------------------- layers

def test_instance_norm_matches_jax():
    x = np.random.default_rng(0).normal(2.0, 3.0, size=(2, 5, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(nhwc(tl.instance_norm(nchw(x))),
                               np.asarray(jl.instance_norm(jnp.asarray(x))), **TOL)


def test_dropout2d_with_injected_mask_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 4, 5, 6)).astype(np.float32)
    key, rate = jax.random.PRNGKey(7), 0.4
    want = np.asarray(jl.dropout2d(jnp.asarray(x), rate, key))
    # the mask the JAX function draws from this key: (N, 1, 1, C)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (3, 1, 1, 6))).reshape(3, 6)
    assert 0 < mask.sum() < mask.size
    got = tl.dropout2d(nchw(x), rate, mask=torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-7)


def test_dropout2d_generator_draw_statistics():
    rate, n, c = 0.3, 64, 64
    x = torch.ones(n, c, 3, 3)
    g = torch.Generator().manual_seed(0)
    y = tl.dropout2d(x, rate, g)
    flat = y.reshape(n, c, -1)
    kept = (flat[..., 0] != 0)
    # whole channels: every (n, c) plane is all zero or all 1/keep
    assert torch.all(flat == flat[..., :1])
    torch.testing.assert_close(flat[kept], torch.full_like(flat[kept], 1 / (1 - rate)))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.03  # 4 sigma
    # the same seed gives the same draw; another seed another one
    y2 = tl.dropout2d(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert not torch.equal(y, tl.dropout2d(x, rate, torch.Generator().manual_seed(1)))
    module = tl.Dropout2d(rate).eval()
    assert module(x, g) is x


def test_model_dropout_draws_from_the_forward_generator():
    # seeded weights and input: with the global RNG's, the ReLU density
    # head can give an all-zero map, which no mask changes
    m = MODELS.build("final", **TINY_MEM)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.train()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(9))
    c_gt = torch.ones(2, 1, 2, 2)
    torch.manual_seed(0)
    a = m.forward_train(x, x, c_gt, generator=torch.Generator().manual_seed(5))
    assert a[0].abs().sum() > 0
    torch.manual_seed(1)  # the global RNG is not what the masks come from
    b = m.forward_train(x, x, c_gt, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c = m.forward_train(x, x, c_gt, generator=torch.Generator().manual_seed(6))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        m.forward_train(x, x, c_gt)


# ---------------------------------------------------------- forward_train

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("variant", ["memadd", "final"])
def test_forward_train_matches_jax(variant, batched):
    batch = _batch(3)
    jm, variables, pm = _pair(variant, 20 + batched, batch, batched_two_view=batched)
    args = [jnp.asarray(batch["img1"]), jnp.asarray(batch["img2"])]
    targs = [nchw(batch["img1"]), nchw(batch["img2"])]
    if variant == "final":
        args.append(jnp.asarray(batch["bmap"]))
        targs.append(nchw(batch["bmap"]))
    want, mut = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.forward_train, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(variables, *args)
    with torch.no_grad():
        got = pm.forward_train(*targs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if g.dim() == 0 else nhwc(g)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"output {i}", **TOL)
    if variant == "final":  # the fused cls map is not all-or-nothing
        c_err = np.asarray(want[4])
        assert 0 < (c_err > 0.5).mean() < 1
    _assert_stats(pm, variables["params"], mut["batch_stats"])


def test_remat_changes_no_value_and_updates_bn_once():
    batch = _torch_batch(_batch(4))
    models = []
    for remat in (False, True):
        m = MODELS.build("final", remat=remat, **NO_DROPOUT)
        m.reset_parameters(torch.Generator().manual_seed(0))
        models.append(m.train())
    grads, outs = [], []
    for m in models:
        out = m.forward_train(batch["img1"], batch["img2"], batch["bmap"])
        (out[0].sum() + out[2].sum() + out[5]).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)
    sa, sb = models[0].state_dict(), models[1].state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ------------------------------------------------------------ loss + grads

@pytest.mark.parametrize("mode", list(MODE_VARIANT))
def test_loss_fn_and_gradients_match_jax(mode):
    batch = _batch(5)
    jm, variables, pm = _pair(MODE_VARIANT[mode], 30, batch)
    jloss_fn = jsteps.build_loss_fn(jm, JAX_LOSSES.build("mse"), mode, 1000.0)
    (total, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), jnp.int32(0))

    loss_fn = build_loss_fn(pm, LOSSES.build("mse"), mode, 1000.0)
    got_total, got = loss_fn(_torch_batch(batch), None)  # dropout rates are 0
    got_total.backward()
    assert set(got) == set(metrics)
    for k, w in metrics.items():
        np.testing.assert_allclose(got[k].item(), float(w), err_msg=k, **TOL)
    np.testing.assert_allclose(got_total.item(), float(total), **TOL)

    want_grads = dg_state_dict_from_flax(grads, None, SPLITS)
    got_grads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for n, w in want_grads.items():
        assert got_grads[n] is not None, n
        np.testing.assert_allclose(got_grads[n].numpy(), w.numpy(), err_msg=n, **GRAD_TOL)
    _assert_stats(pm, variables["params"], new_stats)


def test_isw_mode_points_to_the_roadmap():
    """Every mode is ported: isw (tests/test_torch_port_whitening_models.py)
    and generation (tests/test_torch_port_generator.py) have a loss_fn;
    joint, which updates two models a step, points to its own step."""
    for mode in ("isw", "generation"):
        build_loss_fn(torch.nn.Identity(), LOSSES.build("mse"), mode, 1000.0)
    with pytest.raises(ValueError, match="build_joint_step"):
        build_loss_fn(torch.nn.Identity(), LOSSES.build("mse"), "joint", 1000.0)


# ------------------------------------------------------------ step, lr

def test_one_adamw_step_matches_jax():
    batch = _batch(6)
    jm, variables, pm = _pair("final", 40, batch)
    tx = joptim.build_optimizer(ADAMW)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jsteps.build_train_step(jm, JAX_LOSSES.build("mse"), "final", 1000.0)
    jstate, jmetrics = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0), jnp.int32(0))

    state = create_train_state(pm, ADAMW, device="cpu")
    step = build_train_step(pm, LOSSES.build("mse"), "final", 1000.0)
    state, metrics = step(state, _torch_batch(batch), None)  # dropout rates are 0
    assert state.step == 1 and not metrics["loss_total"].requires_grad
    np.testing.assert_allclose(metrics["loss_total"].item(),
                               float(jmetrics["loss_total"]), **TOL)
    want = dg_state_dict_from_flax(jstate.params, jstate.batch_stats, SPLITS)
    before = dg_state_dict_from_flax(variables["params"], variables["batch_stats"], SPLITS)
    got = pm.state_dict()
    # A VGG conv bias feeds a train-mode batch norm, which removes it: its
    # exact gradient is 0 and both frameworks hold rounding noise there,
    # which Adam scales to a step of +-lr either way. Those biases are held
    # to the bound of one AdamW step, every other value to 1e-5.
    noise = {f"{n}.bias" for n, m in pm.named_modules()
             if isinstance(m, torch.nn.Conv2d) and m.bias is not None}
    assert noise
    lr, wd = ADAMW["params"]["lr"], ADAMW["params"]["weight_decay"]
    for k, w in want.items():
        if k in noise:
            step_bound = lr * (1 + wd * before[k].abs()) + 1e-7
            assert torch.all((got[k] - before[k]).abs() <= step_bound), k
        elif not k.endswith("num_batches_tracked"):  # the JAX BatchNorm keeps no count
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    params = [n for n, _ in pm.named_parameters()]
    assert all(not torch.equal(got[n], before[n]) for n in params)


@pytest.mark.parametrize("name,params", [
    ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
    ("adam", {"lr": 0.01, "weight_decay": 0.01}),
    ("adamw", {"lr": 0.01, "weight_decay": 0.05})])
def test_optimizer_updates_match_optax(name, params):
    """Three updates of each optimizer on a small quadratic, against the
    JAX package's optax chain for the same spec."""
    rng = np.random.default_rng(0)
    w0, target = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3))
    tx = joptim.build_optimizer({"name": name, "params": params})
    jw, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(jw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = toptim.build_optimizer({"name": name, "params": params}, [tw])
    for _ in range(3):
        g = jax.grad(lambda w: jnp.sum((w - target) ** 2 * jnp.arange(1, 16).reshape(5, 3)))(jw)
        updates, opt_state = tx.update(g, opt_state, jw)
        jw = optax.apply_updates(jw, updates)
        opt.zero_grad()
        (((tw - torch.from_numpy(target).float()) ** 2)
         * torch.arange(1, 16, dtype=torch.float32).reshape(5, 3)).sum().backward()
        opt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


def test_onecycle_trace_matches_jax_and_leaves_betas_alone():
    want = joptim.build_scheduler(ONECYCLE, 0.001)
    model = torch.nn.Linear(3, 1)
    state = create_train_state(model, ADAMW, ONECYCLE, device="cpu")
    betas = state.optimizer.param_groups[0]["betas"]
    assert isinstance(want, joptim.OneCycleLR) and isinstance(state.scheduler, toptim.OneCycleLR)
    for epoch in range(150):
        lr = state.scheduler.current_lr
        assert abs(lr - want.lr_at(epoch)) <= 1e-12 * max(1.0, abs(want.lr_at(epoch)))
        state.set_learning_rate(lr)
        state.optimizer.zero_grad()
        model(torch.ones(2, 3)).sum().backward()
        state.optimizer.step()
        group = state.optimizer.param_groups[0]
        assert group["lr"] == lr and group["betas"] == betas == (0.9, 0.999)
        state.scheduler.step()
    for name, spec in (("step", {"step_size": 30, "gamma": 0.5}),
                       ("multistep", {"milestones": [10, 40], "gamma": 0.3}),
                       ("cosine", {"T_max": 50, "eta_min": 1e-5})):
        a = toptim.build_scheduler({"name": name, "params": spec}, 0.01)
        b = joptim.build_scheduler({"name": name, "params": spec}, 0.01)
        assert all(abs(a.lr_at(e) - b.lr_at(e)) <= 1e-15 for e in range(150)), name


def test_serving_kernel_flag_is_turned_off_for_training():
    """The serving kernel has no backward: with fused_mem a single-view
    forward that needs gradients raises, and create_train_state turns the
    flag off, so mode base trains a mem model on the einsum path, while
    the two-view pair keeps its training kernels."""
    m = MODELS.build("mem", **NO_DROPOUT).train()
    assert m.memory.fused is True and m.memory.fused_train is True
    batch = _torch_batch(_batch(8))
    with pytest.raises(RuntimeError, match="fused_mem=False"):
        m(batch["img1"])
    with torch.no_grad():
        m(batch["img1"])  # no gradient: the kernel's plain version on the CPU
    state = create_train_state(m, ADAMW, device="cpu")
    assert m.memory.fused is False and m.memory.fused_train is True
    step = build_train_step(m, LOSSES.build("mse"), "base", 1000.0)
    state, metrics = step(state, batch, None)
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
    assert m.mem.grad is not None and m.mem.grad.abs().sum() > 0


def test_bf16_training_keeps_f32_master_weights():
    m = MODELS.build("final", dtype=torch.bfloat16, **TINY_MEM)
    assert m.dec1[0].conv.weight.dtype == torch.bfloat16  # serving keeps bf16
    state = create_train_state(m, ADAMW, ONECYCLE, device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    step = build_train_step(m, LOSSES.build("mse"), "final", 1000.0)
    state, metrics = step(state, _torch_batch(_batch(7)), torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in m.parameters())
    exp_avg = state.optimizer.state[m.mem]["exp_avg"]
    assert exp_avg.dtype == torch.float32
    with torch.no_grad():  # the convolutions still compute in bf16
        assert m.dec1[0].conv(torch.zeros(1, m.dec1[0].conv.in_channels, 4, 4)).dtype \
            == torch.bfloat16
