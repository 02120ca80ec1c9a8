"""Port layers and VGG trunk (dgvcc_tpu_torch.nn) against the JAX ones,
eval mode, float32 on the CPU. Tolerance 1e-5 (float32, other
summation order in the convolutions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from dgvcc_tpu.nn import layers as jl
from dgvcc_tpu.nn import vgg as jv
from dgvcc_tpu.testing import TINY_VGG
from dgvcc_tpu_torch.nn import layers as tl
from dgvcc_tpu_torch.nn import vgg as tv
from test_torch_port_helpers import nchw, nhwc, randomize

TOL = dict(rtol=1e-5, atol=1e-5)


def _flax_to_torch_conv(p):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(p["kernel"], (3, 2, 0, 1))))


@pytest.mark.parametrize("kernel_size,bn,relu", [
    (3, True, True), (1, True, True), (1, False, False), (3, False, True)])
def test_convblock_eval_matches_flax(kernel_size, bn, relu):
    rng = np.random.default_rng(kernel_size + 2 * bn + 4 * relu)
    pad = kernel_size // 2
    jm = jl.ConvBlock(8, kernel_size=kernel_size, padding=pad, bn=bn,
                      relu=relu)
    x = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(unfreeze(v["params"]), rng)
    stats = randomize(unfreeze(v.get("batch_stats", {})), rng)
    golden = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x)))

    tm = tl.ConvBlock(5, 8, kernel_size=kernel_size, padding=pad, bn=bn,
                      relu=relu).eval()
    with torch.no_grad():
        tm.conv.weight.copy_(_flax_to_torch_conv(params["Conv_0"]))
        if bn:
            tm.bn.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
            tm.bn.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
            tm.bn.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
            tm.bn.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
        ours = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(ours, golden, **TOL)


def test_convblock_bf16_normalizes_in_f32():
    """bf16 module: the conv runs in bf16, BN keeps f32 parameters and
    returns bf16 (the JAX BatchNorm's compute-in-f32, cast-back rule)."""
    tm = tl.ConvBlock(4, 6, bn=True, dtype=torch.bfloat16).eval()
    assert tm.conv.weight.dtype == torch.bfloat16
    assert tm.bn.weight.dtype == torch.float32
    x = torch.randn(1, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = tm(x.to(torch.bfloat16))
        conv = tm.conv(x.to(torch.bfloat16))
        ref = torch.relu(torch.nn.functional.batch_norm(
            conv.float(), tm.bn.running_mean, tm.bn.running_var, tm.bn.weight,
            tm.bn.bias, False, 0.0, 1e-5)).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref)


@pytest.mark.parametrize("hw", [(5, 7), (4, 4), (1, 3)])
@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_upsample_matches_jax(hw, scale, mode):
    rng = np.random.default_rng(hw[0] * 10 + hw[1] + scale)
    x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    golden = np.asarray(jl.upsample(jnp.asarray(x), scale, mode=mode))
    ours = nhwc(tl.upsample(nchw(x), scale, mode=mode))
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, **TOL)


@pytest.mark.parametrize("cfg,start,stop,in_shape", [
    (TINY_VGG, 0, 8, (2, 16, 24, 3)),
    (TINY_VGG, 4, 12, (2, 15, 17, 8)),       # starts mid-stage; odd size floors
    (tuple(jv.VGG16_CFG), 23, 33, (1, 8, 10, 256)),
])
def test_vgg_features_slice_matches_flax(cfg, start, stop, in_shape):
    rng = np.random.default_rng(start + stop)
    jm = jv.VGGFeatures(cfg=tuple(cfg), batch_norm=True, start=start, stop=stop)
    x = rng.normal(size=in_shape).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(unfreeze(v["params"]), rng)
    stats = randomize(unfreeze(v["batch_stats"]), rng)
    golden = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x)))

    tm = tv.VGGFeatures(cfg, True, start, stop).eval()
    sd = {}
    for name, p in params.items():
        loc = int(name[len("conv"):] if name.startswith("conv") else name[2:]) - start
        if name.startswith("conv"):
            sd[f"{loc}.weight"] = _flax_to_torch_conv(p)
            sd[f"{loc}.bias"] = torch.from_numpy(p["bias"])
        else:
            sd[f"{loc}.weight"] = torch.from_numpy(p["scale"])
            sd[f"{loc}.bias"] = torch.from_numpy(p["bias"])
            sd[f"{loc}.running_mean"] = torch.from_numpy(stats[name]["mean"])
            sd[f"{loc}.running_var"] = torch.from_numpy(stats[name]["var"])
            sd[f"{loc}.num_batches_tracked"] = torch.tensor(0)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ours = nhwc(tm(nchw(x)))
    assert tm.out_channels == golden.shape[-1]
    np.testing.assert_allclose(ours, golden, **TOL)


def test_feature_layout_and_stage_channels():
    assert tv.feature_layout(tv.VGG16_CFG, True) == jv.feature_layout(jv.VGG16_CFG, True)
    assert [tv.stage_channels(tv.VGG16_CFG, True, s) for s in (23, 33, 43)] == [256, 512, 512]
