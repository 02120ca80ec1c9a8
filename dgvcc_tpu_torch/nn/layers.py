"""Building blocks of the port (NCHW), counterparts of dgvcc_tpu/nn/layers.py.

``ConvBlock`` keeps the reference DGVCC key layout (``.conv`` /
``.bn``) so a reference ``.pth`` loads with a strict ``load_state_dict``.
Batch norm is ``nn.BatchNorm2d`` kept in float32 whatever the module
dtype: given a bfloat16 input it normalizes in float32 and returns
bfloat16, which is the JAX ``BatchNorm`` rule (compute in f32, cast back
to the module dtype), and it stores the unbiased running variance as
the JAX ``BatchNorm`` does.

Precision: ``Conv2d`` computes in the dtype the model was built with. A
model built in bf16 holds bf16 weights and casts nothing (serving); a
training state holds float32 master weights (``train/state.py``), which
each convolution casts to bf16 on the way in, as a flax ``Conv`` with
``dtype=bf16`` and float32 params does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (the dtype it was
    built in): input, weight and bias are cast to it where they differ."""

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
        return self._conv_forward(x, w, b)


class ConvBlock(nn.Module):
    """conv (no bias) → optional BN (eps 1e-5) → optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 1, bn: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, padding=padding,
                           bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        return x


def upsample(x: torch.Tensor, scale_factor: int = 2,
             mode: str = "bilinear") -> torch.Tensor:
    """NCHW integer-factor upsample.

    ``bilinear`` (``align_corners=False``) is ``jax.image.resize(...,
    "linear")`` (half-pixel centres, edge clamp); ``nearest`` is the
    floor-index repeat ``out[i] = in[i // scale]``.
    """
    if mode == "nearest":
        return F.interpolate(x, scale_factor=scale_factor, mode="nearest")
    return F.interpolate(x, scale_factor=scale_factor, mode="bilinear",
                         align_corners=False)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) standardization over H and W: biased
    variance, no affine parameters (``F.instance_norm`` of the reference)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
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
