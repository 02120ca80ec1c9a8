"""BL-VGG: VGG19 features without the last pool, an x2 bilinear upsample
(align_corners=True, reference BL.py:25), a conv head and |.| (reference
models/baselines/BL.py:11-56), counterpart of
dgvcc_tpu/models/baselines/bl_vgg.py. Output: the density at stride 8.

``batch_norm`` picks the vgg19_bn trunk (the JAX package's from-scratch
variant). Keys: ``features.{i}`` (torchvision indices), ``reg_layer.{0,2,4}``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import Conv2d, he_normal_, resize_bilinear_ac
from dgvcc_tpu_torch.nn.vgg import VGG19_CFG, VGGFeatures


@MODELS.register("bl")
class BLVGG(nn.Module):
    flax_layout = "bl"
    # mesh: {spatial: N}: VGG19's four pools (parallel/spatial.py); the x2
    # upsample reads the rows around a rank's own
    row_rule = 16
    spatial_group = None

    def __init__(self, pretrained: bool = False, batch_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.batch_norm = batch_norm
        self.features = VGGFeatures(tuple(VGG19_CFG[:-1]), batch_norm, dtype=dtype)
        self.reg_layer = nn.Sequential(
            Conv2d(512, 256, 3, padding=1, dtype=dtype), nn.ReLU(inplace=True),
            Conv2d(256, 128, 3, padding=1, dtype=dtype), nn.ReLU(inplace=True),
            Conv2d(128, 1, 1, dtype=dtype))
        self.reset_parameters()

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here)."""
        y = self.features(x)
        y = resize_bilinear_ac(y, (2 * y.shape[2], 2 * y.shape[3]), self.spatial_group)
        return self.reg_layer(y).abs()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)
