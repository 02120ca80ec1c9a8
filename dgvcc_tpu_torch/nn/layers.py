"""Building blocks of the port (NCHW), counterparts of dgvcc_tpu/nn/layers.py.

``ConvBlock`` keeps the reference DGVCC key layout (``.conv`` /
``.bn``) so a reference ``.pth`` loads with a strict ``load_state_dict``.
Batch norm is ``BatchNorm2d``, an ``nn.BatchNorm2d`` kept in float32
whatever the module dtype: given a bfloat16 input it normalizes in float32
and returns bfloat16, which is the JAX ``BatchNorm`` rule (compute in f32,
cast back to the module dtype), and it stores the unbiased running variance
as the JAX ``BatchNorm`` does. With a ``process_group`` its training
forward averages the batch statistics over the group's ranks, as the JAX
``BatchNorm`` with ``axis_name`` does (``sync_statistics``; under ``mesh:
{spatial: N}`` the group is the spatial one, ``parallel/spatial.py``).

Precision: ``Conv2d`` computes in the dtype the model was built with. A
model built in bf16 holds bf16 weights and casts nothing (serving); a
training state holds float32 master weights (``train/state.py``), which
each convolution casts to bf16 on the way in, as a flax ``Conv`` with
``dtype=bf16`` and float32 params does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.nn.collectives import exchange_halo, mean_over_ranks


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (the dtype it was
    built in): input, weight and bias are cast to it where they differ.
    With a ``spatial_group`` (``parallel/spatial.py::shard_height``) the
    input is this rank's rows of the crop: the neighbours' halo rows stand
    in for the padding in height."""

    spatial_group = None

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w, b = self.weight, self.bias
        if w.dtype != dt:
            w = w.to(dt)
            b = None if b is None else b.to(dt)
        if x.dtype != dt:
            x = x.to(dt)
        if self.spatial_group is None:
            return self._conv_forward(x, w, b)
        x = exchange_halo(x, self.padding[0], self.spatial_group)
        return F.conv2d(x, w, b, self.stride, (0, self.padding[1]), self.dilation,
                        self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same state_dict keys) whose training forward,
    once ``process_group`` is set, computes the mean and the mean of squares
    in float32, averages them over the group's ranks (the gradient flows
    through the mean), takes var = E[x^2] - E[x]^2 and stores the running
    variance unbiased with the global count: dgvcc_tpu/nn/layers.py:58-76.
    Without a group, or in eval mode, it is ``nn.BatchNorm2d``.
    ``nn.SyncBatchNorm`` is not used: it refuses CPU tensors, calls
    ``all_gather`` (which gloo does not run on CUDA tensors) and computes
    another formula."""

    process_group = None

    def forward(self, x):
        if self.process_group is None or not self.training:
            return super().forward(x)
        group = self.process_group
        xf = x.float()
        stats = torch.stack([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
        mean, mean2 = mean_over_ranks(stats, group).unbind()
        var = mean2 - mean.square()
        n = (x.numel() // x.shape[1]) * torch.distributed.get_world_size(group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        mul = (self.weight * torch.rsqrt(var + self.eps))[:, None, None]
        y = (xf - mean[:, None, None]) * mul + self.bias[:, None, None]
        return y.to(x.dtype)


def sync_statistics(model: nn.Module, group) -> nn.Module:
    """Build-time switch of the six whitening models (the JAX models with an
    ``axis_name`` field): every batch norm and SwitchWhiten of ``model``
    averages its batch statistics over ``group``'s ranks in training (None:
    each rank its own). Returns the model."""
    from dgvcc_tpu_torch.nn.whitening import SwitchWhiten

    for m in model.modules():
        if isinstance(m, (BatchNorm2d, SwitchWhiten)):
            m.process_group = group
        elif group is not None and isinstance(m, nn.modules.batchnorm._NormBase):
            raise TypeError(f"{type(m).__name__} cannot average its statistics over ranks")
    return model


class Linear(nn.Linear):
    """``nn.Linear`` computing in the dtype it was built in, as ``Conv2d``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis in float32, returning the input's
    dtype (flax's LayerNorm reduces in float32 and casts back)."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class PReLU(nn.PReLU):
    """``nn.PReLU()`` (one slope, 0.25 at init) in the input's dtype."""

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def he_normal_(model: nn.Module, generator: Optional[torch.Generator] = None):
    """He-normal convolution and linear weights (fan_in, ReLU gain), zero
    biases, the norms and PReLUs at their init; seeded from ``generator``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(2.0 / m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.PReLU)):
                m.reset_parameters()


class ConvBlock(nn.Module):
    """conv (no bias unless asked) → optional BN (eps 1e-5) → optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 1, bn: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32, bias: bool = False):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, padding=padding,
                           bias=bias, dtype=dtype)
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        return x


def upsample(x: torch.Tensor, scale_factor: int = 2,
             mode: str = "bilinear", group=None) -> torch.Tensor:
    """NCHW integer-factor upsample.

    ``bilinear`` (``align_corners=False``) is ``jax.image.resize(...,
    "linear")`` (half-pixel centres, edge clamp); ``nearest`` is the
    floor-index repeat ``out[i] = in[i // scale]``. ``group``: x is this
    rank's rows of the crop (``mesh: {spatial: N}``); a bilinear upsample
    then reads the neighbour row above and below where there is one (at the
    crop's ends the clamp, as on the whole crop) and keeps its own rows of
    the output, each computed as on the whole crop.
    """
    if mode == "nearest":
        return F.interpolate(x, scale_factor=scale_factor, mode="nearest")
    if group is None:
        return F.interpolate(x, scale_factor=scale_factor, mode="bilinear",
                             align_corners=False)
    top = int(torch.distributed.get_rank(group) > 0)
    bottom = int(torch.distributed.get_rank(group) < torch.distributed.get_world_size(group) - 1)
    x = exchange_halo(x, 1, group)
    y = upsample(x[:, :, 1 - top:x.shape[2] - 1 + bottom], scale_factor)
    return y[:, :, top * scale_factor:y.shape[2] - bottom * scale_factor]


def resize_bilinear_ac(x: torch.Tensor, hw, group=None) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``hw`` with align_corners=True
    (``F.upsample_bilinear``, ``nn.UpsamplingBilinear2d``): the JAX
    package's ``resize_bilinear_ac``. ``group``: x is this rank's rows of
    the crop and ``hw`` its rows of the output. The sample positions are the
    whole crop's (output row i reads row i (H - 1) / (H' - 1)), so the rank
    takes one neighbour row above and below, places them at their rows of a
    crop-high tensor of zeros and resizes that with the same call as one
    process: its rows of the output are one process's, bit for bit, at the
    cost of a crop-high resize on each rank."""
    h, w = x.shape[2:]
    if (h, w) == tuple(hw):
        return x
    if group is None:
        return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    rows, out_rows = h * n, hw[0] * n
    scale = (rows - 1) / (out_rows - 1)
    first = int(r * hw[0] * scale)
    last = min(int(((r + 1) * hw[0] - 1) * scale) + 1, rows - 1)
    if first < r * h - 1 or last > (r + 1) * h:
        raise ValueError(f"a sharded resize of {rows} rows to {out_rows} reads rows "
                         f"{first}..{last} beyond rank {r}'s {h} and one row of halo")
    x = exchange_halo(x, 1, group)
    lo, hi = max(r * h - 1, 0), min((r + 1) * h + 1, rows)
    # the pad keeps x's memory format, so the one process's kernel runs
    whole = F.pad(x[:, :, lo - r * h + 1:hi - r * h + 1], (0, 0, lo, rows - hi))
    y = F.interpolate(whole, size=(out_rows, hw[1]), mode="bilinear", align_corners=True)
    return y[:, :, r * hw[0]:(r + 1) * hw[0]]


def resize_bilinear(x: torch.Tensor, hw, group=None) -> torch.Tensor:
    """``F.interpolate(x, hw, "bilinear", align_corners=False,
    antialias=False)``: half-pixel centres, no prefilter on a downscale
    (DSSINet's pyramid). ``group``: x is this rank's rows of the crop; an x2
    upsample then takes one neighbour row (``upsample``), and an x0.5
    downsample of an even number of rows, the mean of each pair of rows, is
    the rank's own."""
    h, w = x.shape[2:]
    if group is not None and tuple(hw) == (2 * h, 2 * w):
        return upsample(x, 2, group=group)
    if group is not None and (h % 2 or hw[0] != h // 2):
        raise ValueError(f"a sharded bilinear resize of {h} rows to {hw[0]}: only x2 and "
                         "x0.5 of an even shard shard over rows")
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=False)


def instance_norm(x: torch.Tensor, eps: float = 1e-5, group=None) -> torch.Tensor:
    """Per-(sample, channel) standardization over H and W: biased
    variance, no affine parameters (``F.instance_norm`` of the reference).
    ``group``: x is this rank's rows of the crop; the mean, then the
    centred second moment, are averaged over the group's equal shares."""
    if group is None:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    else:
        mean = mean_over_ranks(x.mean(dim=(2, 3), keepdim=True), group)
        var = mean_over_ranks((x - mean).square().mean(dim=(2, 3), keepdim=True), group)
    return (x - mean) * torch.rsqrt(var + eps)


def dropout2d(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel dropout (``nn.Dropout2d``): one Bernoulli(1 - rate) draw per
    (N, C), kept channels scaled by 1 / (1 - rate). The draw comes from
    ``generator`` (on x's device), never from torch's global RNG, or
    ``mask`` ((N, C) or (N, C, 1, 1) booleans, True = keep) is given from
    outside."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError("dropout2d draws from an explicit torch.Generator "
                             "(or takes a mask); got neither")
        mask = torch.rand((x.shape[0], x.shape[1]), generator=generator,
                          device=x.device) < keep
    mask = mask.reshape(x.shape[0], x.shape[1], 1, 1).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout2d(nn.Module):
    """Channel dropout in training mode, drawing from the generator that
    the model's forward passes down (``generator=``); identity in eval
    mode. It holds no parameter, so the key layout stays the reference's."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training:
            return x
        return dropout2d(x, self.rate, generator)
