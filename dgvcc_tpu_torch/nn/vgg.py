"""VGG feature stacks (NCHW), counterpart of dgvcc_tpu/nn/vgg.py.

``VGGFeatures(cfg, start, stop)`` is the slice ``[start:stop)`` of a
torchvision ``vgg*.features`` ``nn.Sequential``. Its children carry the
LOCAL indices ``0 .. stop-start-1`` (torchvision index minus ``start``),
which is how the reference DGVCC model stores ``enc1/enc2/enc3``
(``features[:23]``, ``[23:33]``, ``[33:43]`` of vgg16_bn).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
from torch import nn

from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d

# torchvision cfgs: 'M' = 2x2/2 max pool
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
             512, 512, 512, 512, "M"]


def feature_layout(cfg: Sequence, batch_norm: bool) -> List[Tuple[str, int, Any]]:
    """Expand a cfg into (kind, torchvision_feature_index, arg) tuples,
    kind in {'conv', 'bn', 'relu', 'pool'}."""
    layout = []
    idx = 0
    for v in cfg:
        if v == "M":
            layout.append(("pool", idx, None))
            idx += 1
        else:
            layout.append(("conv", idx, v))
            idx += 1
            if batch_norm:
                layout.append(("bn", idx, v))
                idx += 1
            layout.append(("relu", idx, None))
            idx += 1
    return layout


def stage_channels(cfg: Sequence, batch_norm: bool, stop: int,
                   in_ch: int = 3) -> int:
    """Channels coming out of ``features[:stop]``."""
    ch = in_ch
    for kind, idx, arg in feature_layout(cfg, batch_norm):
        if kind == "conv" and idx < stop:
            ch = arg
    return ch


class VGGFeatures(nn.Sequential):
    """``features[start:stop]`` with conv bias on, BN eps 1e-5 and
    2x2/2 floor max pools; convs compute in ``dtype``, BN in float32."""

    def __init__(self, cfg: Sequence = tuple(VGG16_CFG), batch_norm: bool = True,
                 start: int = 0, stop: int = 10_000,
                 dtype: torch.dtype = torch.float32):
        layers = []
        ch = stage_channels(cfg, batch_norm, start)
        for kind, idx, arg in feature_layout(cfg, batch_norm):
            if not (start <= idx < stop):
                continue
            if kind == "conv":
                layers.append(Conv2d(ch, arg, 3, padding=1, bias=True,
                                     dtype=dtype))
                ch = arg
            elif kind == "bn":
                layers.append(BatchNorm2d(arg, eps=1e-5, momentum=0.1))
            elif kind == "relu":
                layers.append(nn.ReLU(inplace=True))
            else:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.out_channels = ch
