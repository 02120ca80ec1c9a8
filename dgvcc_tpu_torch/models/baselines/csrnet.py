"""CSRNet: a VGG16 front end and a dilated back end (reference
models/baselines/CSRNet.py:10-44), counterpart of
dgvcc_tpu/models/baselines/csrnet.py. Output: the density at stride 8.

Keys: ``frontend.{i}`` / ``backend.{i}`` (make_layers Sequentials: conv and
ReLU per entry, pools), ``output_layer``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import Conv2d, he_normal_

FRONTEND = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
BACKEND = (512, 512, 512, 256, 128, 64)


def conv_stack(cfg: Sequence, in_ch: int, dilation: int = 1,
               dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """make_layers: 3x3 conv (bias) + ReLU per entry, 2x2/2 max pool per 'M'."""
    layers = []
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [Conv2d(in_ch, v, 3, padding=dilation, dilation=dilation, dtype=dtype),
                       nn.ReLU(inplace=True)]
            in_ch = v
    return nn.Sequential(*layers)


@MODELS.register("csrnet")
class CSRNet(nn.Module):
    flax_layout = "csrnet"
    # mesh: {spatial: N}: the front end's three pools (parallel/spatial.py)
    row_rule = 8
    spatial_group = None

    def __init__(self, pretrained: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frontend = conv_stack(FRONTEND, 3, dtype=dtype)
        self.backend = conv_stack(BACKEND, 512, dilation=2, dtype=dtype)
        self.output_layer = Conv2d(64, 1, 1, dtype=dtype)
        self.reset_parameters()

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here)."""
        return self.output_layer(self.backend(self.frontend(x)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)
