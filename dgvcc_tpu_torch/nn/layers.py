"""Building blocks of the port (NCHW), counterparts of dgvcc_tpu/nn/layers.py.

``ConvBlock`` keeps the reference DGVCC key layout (``.conv`` /
``.bn``) so a reference ``.pth`` loads with a strict ``load_state_dict``.
Batch norm is ``nn.BatchNorm2d`` kept in float32 whatever the module
dtype: given a bfloat16 input it normalizes in float32 and returns
bfloat16, which is the JAX ``BatchNorm`` rule (compute in f32, cast back
to the module dtype), and it stores the unbiased running variance as
the JAX ``BatchNorm`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """conv (no bias) → optional BN (eps 1e-5) → optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 1, bn: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, padding=padding,
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
