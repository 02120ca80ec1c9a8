"""MCNN: three columns of convolutions with 9/7/5-pixel first kernels
(reference models/baselines/MCNN.py:7-75), counterpart of
dgvcc_tpu/models/baselines/mcnn.py. Output: the density at stride 4.

Keys: ``branch{1,2,3}.{0,3,6,8}`` (convs of the column's Sequential),
``fuse.0``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import Conv2d, he_normal_


def _column(chans, ksizes, dtype):
    """conv-ReLU-pool, conv-ReLU-pool, conv-ReLU, conv-ReLU."""
    layers, cin = [], 3
    for i, (c, k) in enumerate(zip(chans, ksizes)):
        layers += [Conv2d(cin, c, k, padding=k // 2, dtype=dtype), nn.ReLU(inplace=True)]
        if i < 2:
            layers.append(nn.MaxPool2d(2, 2))
        cin = c
    return nn.Sequential(*layers)


@MODELS.register("mcnn")
class MCNN(nn.Module):
    flax_layout = "mcnn"
    # mesh: {spatial: N}: a rank's rows pool to whole rows through the two
    # pools (parallel/spatial.py); the convolutions take their halos
    row_rule = 4
    spatial_group = None

    def __init__(self, pretrained: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.branch1 = _column((16, 32, 16, 8), (9, 7, 7, 7), dtype)
        self.branch2 = _column((20, 40, 20, 10), (7, 5, 5, 5), dtype)
        self.branch3 = _column((24, 48, 24, 12), (5, 3, 3, 3), dtype)
        self.fuse = nn.Sequential(Conv2d(30, 1, 1, dtype=dtype))
        self.reset_parameters()

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here)."""
        return self.fuse(torch.cat([self.branch1(x), self.branch2(x), self.branch3(x)], dim=1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)
