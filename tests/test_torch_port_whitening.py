"""The port's whitening layers and trunks (dgvcc_tpu_torch/nn/whitening.py,
nn/resnet.py, nn/densenet.py) against the JAX package on the CPU, in
float32, on inputs and weights made from numpy seeds. JAX variables reach
the port through its bridge (nn/convert.py).

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result. One layer: forward outputs and running statistics
1e-5 (float32, another order of summation); gradients 1e-4 (the T=5
Newton-Schulz steps amplify that order's rounding). A trunk: forward
outputs and running statistics 1e-4, as the port's other training tests
(batch statistics over maps of 3x3 to 12x10 amplify the rounding); its
gradients 5e-2 in relative norm (||got - want|| / ||want||): a ReLU input
within float32 rounding of 0 takes either side of the kink in either
framework (seen 1.4e-6 from 0 in layer1's bn2, and in layer3's output),
and one such element moves the gradients below it by up to 2e-2 in that
norm at these map sizes; the JAX package's own jitted and eager runs of
one trunk differ by up to 5.2e-3 for it. A gradient whose exact value is 0 (a bias
in front of a train-mode BN or of an instance norm without affine) is
rounding noise in both, so the norm is also taken against 1e-3 of the
trunk's largest gradient norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from dgvcc_tpu.nn import densenet as jdn
from dgvcc_tpu.nn import resnet as jres
from dgvcc_tpu.nn import whitening as jw
from dgvcc_tpu_torch.nn import densenet as tdn
from dgvcc_tpu_torch.nn import resnet as tres
from dgvcc_tpu_torch.nn import whitening as tw
from dgvcc_tpu_torch.nn.convert import whitening_state_dict_from_flax
from test_torch_port_helpers import (close, close_grads, nchw, nhwc, variable_shapes,
                                     randomize_whitening as randomize)

FWD, GRAD = 1e-5, 1e-4
TRUNK_FWD, TRUNK_GRAD = 1e-4, 5e-2


def port_state(layout, params, stats, prefix="backbone"):
    """A trunk's JAX variables -> the port trunk's state_dict (the bridge's
    names less the model's ``prefix.``)."""
    sd = whitening_state_dict_from_flax(layout, {prefix: params},
                                        {prefix: stats} if stats is not None else None)
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def jax_vjp(fn, primal, cot):
    """fn(primal) -> (out, aux); returns (out, aux, grad of <out, cot>)."""
    out, pull, aux = jax.vjp(jax.jit(fn), primal, has_aux=True)
    return out, aux, pull(jnp.asarray(cot))[0]


# ------------------------------------------------------------ Newton-Schulz

def test_newton_schulz_matches_jax_forward_and_gradient():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 16, 24)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) / 24 + 0.1 * np.eye(16)).astype(np.float32)
    cot = rng.normal(size=cov.shape).astype(np.float32)
    want, pull = jax.vjp(lambda c: jw.newton_schulz_inv_sqrt(c, 5), jnp.asarray(cov))
    (want_g,) = pull(jnp.asarray(cot))
    c = torch.from_numpy(cov).requires_grad_()
    got = tw.newton_schulz_inv_sqrt(c, 5)
    (got * torch.from_numpy(cot)).sum().backward()
    close(got, want, FWD, "Sigma^(-1/2)")
    close(c.grad, want_g, GRAD, "d cov")


# ------------------------------------------------------------ SwitchWhiten

@pytest.mark.parametrize("sw_type", [2, 3, 5])
@pytest.mark.parametrize("train", [True, False])
def test_switch_whiten_matches_jax(sw_type, train):
    """Output, gradients of the input and of every parameter, and (train)
    the running statistics after one forward, from random running ones."""
    rng = np.random.default_rng(10 + sw_type)
    kw = dict(num_pergroup=16, sw_type=sw_type, T=5, momentum=0.9)
    x = rng.normal(1.0, 2.0, (3, 6, 5, 32)).astype(np.float32)
    jm = jw.SwitchWhiten(32, **kw)
    params, stats = variable_shapes(jm, x, train=False)
    params, stats = randomize(params, rng), randomize(stats, rng)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def fn(inputs):
        p, xx = inputs
        out, mut = jm.apply({"params": p, "batch_stats": stats}, xx, train=train,
                            mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, new_stats, (want_gp, want_gx) = jax_vjp(fn, (params, jnp.asarray(x)),
                                                   cot)
    pm = tw.SwitchWhiten(32, **kw)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    pm.train(train)
    xt = nchw(x).requires_grad_()
    got = pm(xt)
    (got * nchw(cot)).sum().backward()
    close(nhwc(got), want, FWD, "out")
    close(nhwc(xt.grad), want_gx, GRAD, "dx")
    for name, p in pm.named_parameters():
        close(p.grad, want_gp[name], GRAD, f"d{name}")
    for name in ("running_mean", "running_cov"):
        close(getattr(pm, name), new_stats[name], FWD, name)


def test_switch_whiten_keeps_the_input_dtype_and_ties_weights():
    pm = tw.SwitchWhiten(32, tie_weight=True)
    assert not hasattr(pm, "sw_var_weight")
    x = torch.randn(2, 32, 4, 4, generator=torch.Generator().manual_seed(0))
    assert pm(x.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sw_type"):
        tw.SwitchWhiten(32, sw_type=4)


# ------------------------------------------------------------ IN, IW, loss, IBN, SE

def test_instance_norm_whitening_and_loss_match_jax():
    rng = np.random.default_rng(20)
    x = rng.normal(0.5, 1.5, (3, 7, 6, 16)).astype(np.float32)
    jm = jw.InstanceNorm(affine=True)
    params = randomize(variable_shapes(jm, x)[0], rng)
    pm = tw.InstanceNorm(16, affine=True)
    pm.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"])})
    close(nhwc(pm(nchw(x))), jm.apply({"params": params}, jnp.asarray(x)), FWD, "IN")
    y, w = tw.InstanceWhitening(16)(nchw(x))
    jy, _ = jw.InstanceWhitening().apply({}, jnp.asarray(x))
    close(nhwc(y), jy, FWD, "IW")
    assert y is w

    mask = np.triu((rng.uniform(size=(16, 16)) > 0.5).astype(np.float32), 1)
    num = np.float32(mask.sum())
    close(tw.get_covariance_matrix(nchw(x)), jw.get_covariance_matrix(jnp.asarray(x)),
          FWD, "covariance")
    for margin in (0.0, 3.0):
        def jloss(xx):
            return jw.instance_whitening_loss(xx, jnp.asarray(mask), margin, num)

        want, want_g = jax.value_and_grad(jloss)(jnp.asarray(x))
        xt = nchw(x).requires_grad_()
        got = tw.instance_whitening_loss(xt, torch.from_numpy(mask), margin,
                                         torch.tensor(num))
        got.backward()
        close(got, want, FWD, f"loss, margin {margin}")
        close(nhwc(xt.grad), want_g, GRAD, f"dx, margin {margin}")


@pytest.mark.parametrize("bn_first", [False, True])
def test_ibn_matches_jax_both_ways(bn_first):
    rng = np.random.default_rng(30 + bn_first)
    x = rng.normal(0.3, 1.2, (4, 5, 6, 20)).astype(np.float32)
    ratio = 0.4 if bn_first else 0.5
    jm = jw.IBN(20, ratio=ratio, bn_first=bn_first)
    params, stats = variable_shapes(jm, x, train=False)
    params, stats = randomize(params, rng), randomize(stats, rng)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def fn(inputs):
        p, xx = inputs
        out, mut = jm.apply({"params": p, "batch_stats": stats}, xx, train=True,
                            mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, new_stats, (want_gp, want_gx) = jax_vjp(fn, (params, jnp.asarray(x)), cot)
    pm = tw.IBN(20, ratio=ratio, bn_first=bn_first)
    sd = whitening_state_dict_from_flax("resnet", {"backbone": {"layer1_0": {"bn1": params}}},
                                        {"backbone": {"layer1_0": {"bn1": stats}}})
    pm.load_state_dict({k[len("backbone.4.0.bn1."):]: v for k, v in sd.items()})
    pm.train()
    xt = nchw(x).requires_grad_()
    got = pm(xt)
    (got * nchw(cot)).sum().backward()
    close(nhwc(got), want, FWD, "out")
    close(nhwc(xt.grad), want_gx, GRAD, "dx")
    close(pm.IN.weight.grad, want_gp["IN"]["scale"], GRAD, "dIN.weight")
    close(pm.BN.weight.grad, want_gp["BN"]["scale"], GRAD, "dBN.weight")
    close(pm.BN.bias.grad, want_gp["BN"]["bias"], GRAD, "dBN.bias")
    close(pm.BN.running_mean, new_stats["BN"]["mean"], FWD, "running_mean")
    close(pm.BN.running_var, new_stats["BN"]["var"], FWD, "running_var")


def test_se_layer_matches_jax():
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 5, 5, 64)).astype(np.float32)
    jm = jw.SELayer(64)
    params = randomize(variable_shapes(jm, x)[0], rng)
    pm = tw.SELayer(64)
    pm.load_state_dict({"fc.0.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
                        "fc.2.weight": torch.from_numpy(params["Dense_1"]["kernel"].T.copy())})
    close(nhwc(pm(nchw(x))), jm.apply({"params": params}, jnp.asarray(x)), FWD, "SE")


# ------------------------------------------------------------ trunks

TRUNKS = {
    "bn": dict(stem_norm="bn"),
    "sw": dict(stem_norm="sw", stage_sw=(True, True, True, False)),
    "ibn_b": dict(stem_norm="in_affine", stage_post=("in", "in", None, None)),
    "ibn_a": dict(stem_norm="bn", stage_ibn_a=(True, True, True, False)),
    "isw": dict(stem_norm="iw", stage_post=("iw", "iw", None, None)),
    "basic_sw": dict(block="basic", stem_norm="sw", stage_sw=(True, True, True, False)),
    "resnext_se": dict(stem_norm="bn", stage_ibn_a=(True, False, False, False), groups=4,
                       base_width=4, se=True),
}


def check_trunk_grads_and_stats(pm, layout, want_g, params, new_stats):
    close_grads(pm, port_state(layout, unfreeze(want_g), None), TRUNK_GRAD)
    want_stats = port_state(layout, params, unfreeze(new_stats))
    for name, b in pm.named_buffers():
        if not name.endswith("num_batches_tracked"):
            close(b, want_stats[name].numpy(), TRUNK_FWD, name)


@pytest.mark.parametrize("spec", sorted(TRUNKS))
def test_resnet_trunk_matches_jax(spec):
    """Train-mode forward (features and the whitened maps), gradients of
    every parameter, and the running statistics after it."""
    kw = dict(layers=(1, 2, 1, 1), num_stages=3, **TRUNKS[spec],
              sw_kwargs=dict(num_pergroup=16, sw_type=2, T=5, momentum=0.9))
    rng = np.random.default_rng(50 + sorted(TRUNKS).index(spec))
    x = rng.normal(size=(2, 48, 40, 3)).astype(np.float32)
    jm = jres.ResNetTrunk(**kw)
    params, stats = variable_shapes(jm, x, train=False)
    params, stats = randomize(params, rng), randomize(stats, rng)

    def fn(p):
        (out, w_arr), mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                     train=True, mutable=["batch_stats"])
        return (out, w_arr), mut["batch_stats"]

    (out, w_arr), pull, new_stats = jax.vjp(jax.jit(fn), params, has_aux=True)
    cot_out = rng.normal(size=out.shape).astype(np.float32)
    cot_w = [rng.normal(size=w.shape).astype(np.float32) for w in w_arr]
    (want_g,) = pull((jnp.asarray(cot_out), [jnp.asarray(c) for c in cot_w]))

    pm = tres.ResNetTrunk(**kw)
    pm.load_state_dict(port_state("resnet", params, stats), strict=True)
    pm.train()
    got, got_w = pm(nchw(x))
    assert len(got_w) == len(w_arr) == (3 if spec == "isw" else 0)
    loss = (got * nchw(cot_out)).sum() + sum((w * nchw(c)).sum() for w, c in zip(got_w, cot_w))
    loss.backward()
    close(nhwc(got), out, TRUNK_FWD, "features")
    for i, (g, w) in enumerate(zip(got_w, w_arr)):
        close(nhwc(g), w, TRUNK_FWD, f"w_arr[{i}]")
    check_trunk_grads_and_stats(pm, "resnet", want_g, params, new_stats)


@pytest.mark.parametrize("mode", ["sw", "ibn"])
def test_densenet_trunk_matches_jax(mode):
    kw = dict(num_init_features=32, growth_rate=16, block_config=(2, 4, 3, 2), num_stages=3,
              norm1_mode=mode, sw_kwargs=dict(num_pergroup=16, sw_type=2, T=5, momentum=0.9))
    rng = np.random.default_rng(60 + len(mode))
    x = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    jm = jdn.DenseNetTrunk(**kw)
    params, stats = variable_shapes(jm, x, train=False)
    params, stats = randomize(params, rng), randomize(stats, rng)

    def fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, pull, new_stats = jax.vjp(jax.jit(fn), params, has_aux=True)
    cot = rng.normal(size=out.shape).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot))
    pm = tdn.DenseNetTrunk(**kw)
    pm.load_state_dict(port_state("densenet", params, stats), strict=True)
    pm.train()
    got = pm(nchw(x))
    (got * nchw(cot)).sum().backward()
    close(nhwc(got), out, TRUNK_FWD, "features")
    check_trunk_grads_and_stats(pm, "densenet", want_g, params, new_stats)
