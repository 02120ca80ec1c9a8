"""SASNet: scale-adaptive selection (reference models/baselines/SASNet.py:
47-256), counterpart of dgvcc_tpu/models/baselines/sasnet.py. A VGG16-BN
encoder in five stages and a U-Net decoder; each of the five scales has a
density head (an inception-style MultiBranch and a 1x1 conv) and a
confidence head over ``block_size`` cells (adaptive average pooling); the
sigmoid-softmax of the confidences soft-selects among the five densities.
Output: full resolution.

Resizes: the decoder's bilinear is align_corners=True
(``F.upsample_bilinear``); a head's map goes to full size by a repeat at
an integer ratio and otherwise by ``jax.image.resize(..., "nearest")``'s
half-pixel rule, torch's ``nearest-exact`` (not ``nearest``). The pooling
is ``F.adaptive_avg_pool2d``, whose cells [floor(i h / o), ceil((i + 1)
h / o)) are the JAX package's.

Keys: the reference's: ``features{1-5}.{i}`` (local indices of vgg16_bn
[0:6], [6:13], [13:23], [23:33], [33:43]), ``de_pred{5-1}.{0,1}.conv``,
``density_head{n}.0.branch*.{conv,bn}`` (batch norm eps 1e-3),
``density_head{n}.1.conv``, ``confidence_head{n}.{0,1}.conv``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.models.baselines.dssinet import conv_bias
from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d, he_normal_, resize_bilinear_ac
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGGFeatures

SPLITS = ((0, 6), (6, 13), (13, 23), (23, 33), (33, 43))
# decoder (in, mid, out) of de_pred5 .. de_pred1, and the heads' widths
DECODER = ((512, 1024, 512), (1024, 512, 256), (512, 256, 128), (256, 128, 64),
           (128, 64, 64))
CONF_MID = (256, 128, 64, 32, 32)


def row_rule(block_size: int) -> int:
    """mesh: {spatial: N}: a rank's rows pool to whole rows through the four
    pools and hold whole ``block_size`` cells (parallel/spatial.py)."""
    return math.lcm(16, block_size)


def check_shard_rows(h: int, block_size: int) -> None:
    """Raises unless a rank's ``h`` rows meet ``row_rule`` (the model's
    forward and its int8 graph's, nn/quant.py::sasnet_forward)."""
    if h % row_rule(block_size):
        raise ValueError(f"sasnet: a rank's {h} rows split a {block_size}-row cell or a "
                         f"pooled row; shard rows in multiples of {row_rule(block_size)}")


class BasicConv(nn.Module):
    """conv (no bias) -> BN (eps 1e-3) -> ReLU."""

    def __init__(self, cin, cout, k, dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.1)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class MultiBranch(nn.Module):
    """1x1->1x1, 1x1->3x3 and 1x1->5x5 branches and the input, concatenated
    (SASNet.py:216-240): 4x the channels."""

    def __init__(self, c, dtype):
        super().__init__()
        self.branch1x1 = BasicConv(c, c // 2, 1, dtype)
        self.branch1x1_1 = BasicConv(c // 2, c, 1, dtype)
        self.branch3x3_1 = BasicConv(c, c // 2, 1, dtype)
        self.branch3x3_2 = BasicConv(c // 2, c, 3, dtype)
        self.branch3x3dbl_1 = BasicConv(c, c // 2, 1, dtype)
        self.branch3x3dbl_2 = BasicConv(c // 2, c, 5, dtype)

    def forward(self, x):
        return torch.cat([self.branch1x1_1(self.branch1x1(x)),
                          self.branch3x3_2(self.branch3x3_1(x)),
                          self.branch3x3dbl_2(self.branch3x3dbl_1(x)), x], dim=1)


def resize_nearest(x, hw):
    h, w = x.shape[2:]
    if hw[0] % h == 0 and hw[1] % w == 0:
        return x.repeat_interleave(hw[0] // h, dim=2).repeat_interleave(hw[1] // w, dim=3)
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


@MODELS.register("sasnet")
class SASNet(nn.Module):
    flax_layout = "sasnet"
    spatial_group = None

    def __init__(self, pretrained: bool = False, block_size: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_size = block_size
        for k, (lo, hi) in enumerate(SPLITS, 1):
            self.add_module(f"features{k}", VGGFeatures(tuple(VGG16_CFG), True, lo, hi, dtype))
        for n, (cin, mid, cout) in zip((5, 4, 3, 2, 1), DECODER):
            self.add_module(f"de_pred{n}", nn.Sequential(
                conv_bias(cin, mid, 3, relu=True, dtype=dtype),
                conv_bias(mid, cout, 3, relu=True, dtype=dtype)))
            self.add_module(f"density_head{n}", nn.Sequential(
                MultiBranch(cout, dtype), conv_bias(4 * cout, 1, 1, relu=True, dtype=dtype)))
            self.add_module(f"confidence_head{n}", nn.Sequential(
                conv_bias(cout, CONF_MID[5 - n], 1, relu=True, dtype=dtype),
                conv_bias(CONF_MID[5 - n], 1, 1, dtype=dtype)))
        self.reset_parameters()

    @property
    def row_rule(self) -> int:
        return row_rule(self.block_size)

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here).
        On a rank's rows (``spatial_group``) the decoder's resizes read the
        neighbour rows; the cells' pooling and the heads' repeats are the
        rank's own while no cell straddles two ranks."""
        h, w = x.shape[2:]
        g = self.spatial_group
        if g is not None:
            check_shard_rows(h, self.block_size)
        feats = []
        for k in range(1, 6):
            x = getattr(self, f"features{k}")(x)
            feats.append(x)
        y = self.de_pred5(feats[4])
        outs = [y]
        for n in (4, 3, 2, 1):
            skip = feats[n - 1]
            y = resize_bilinear_ac(y, skip.shape[2:], g)
            y = getattr(self, f"de_pred{n}")(torch.cat([skip, y], dim=1))
            outs.append(y)
        full = feats[0].shape[2:]
        cells = (h // self.block_size, w // self.block_size)
        dens, conf = [], []
        for n, o in zip((5, 4, 3, 2, 1), outs):
            dens.append(resize_nearest(getattr(self, f"density_head{n}")(o), full))
            cf = getattr(self, f"confidence_head{n}")(F.adaptive_avg_pool2d(o, cells))
            conf.append(resize_nearest(cf, full))
        conf = torch.softmax(torch.sigmoid(torch.cat(conf, dim=1)), dim=1)
        return (torch.cat(dens, dim=1) * conf).sum(dim=1, keepdim=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)
