"""DSSINet (CRFVGG): a shared VGG16-PReLU front end over an image pyramid
(x2, x1, x0.5) whose scales exchange messages after each stage (two
iterations of CRF-style passing: 1x1 convs between branches, a PReLU on
the sum, a ReLU on unary + binary), decoded coarse to fine (reference
models/baselines/DSSINet.py:285-417), counterpart of
dgvcc_tpu/models/baselines/dssinet.py. Output: full resolution.

The pyramid's resize is ``F.interpolate(..., "bilinear",
align_corners=False, antialias=False)``, which is the JAX package's
``jax.image.resize(..., "linear", antialias=False)`` (no prefilter on the
0.5x leg).

Keys: the reference's. ``front_end.features.{0,2,5,...,21}`` are the
stages' convs and ``front_end.features.relu{1,3,6,...,22}`` their PReLUs
(make_layers names, cfg 'F'); ``relu3`` and ``relu22`` sit where the
reference's forward crosses them (after stage 1 in the x2 chain, after the
x0.5 chain's stage 4). The reference's ``relu8`` and ``relu15`` are never
crossed: a reference checkpoint's entries for them are dropped
(``reference_unused``). ``passing{k}.prelu``,
``passing{k}.w_0_{j}_{i}_0.0.conv``, ``decoder{k}.{0,1}.conv``,
``passing_weight{k}.conv``, ``prelu``."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import (Conv2d, ConvBlock, PReLU, he_normal_, resize_bilinear,
                                       upsample)

# (convs, PReLUs between them) of each front-end stage, make_layers names
STAGES = ((("0", "2"), ("relu1",)), (("5", "7"), ("relu6",)),
          (("10", "12", "14"), ("relu11", "relu13")),
          (("17", "19", "21"), ("relu18", "relu20")))
STAGE_CHANNELS = ((3, 64, 64), (64, 128, 128), (128, 256, 256, 256), (256, 512, 512, 512))


class _FrontEnd(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        feats = {}
        for (convs, prelus), chans in zip(STAGES, STAGE_CHANNELS):
            for name, cin, cout in zip(convs, chans[:-1], chans[1:]):
                feats[name] = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
            for name in prelus:
                feats[name] = PReLU()
        feats["relu3"], feats["relu22"] = PReLU(), PReLU()
        self.features = nn.ModuleDict(feats)

    def stage(self, k: int, x):
        """Stage k (0-3): [pool,] convs with PReLUs between, no final act."""
        convs, prelus = STAGES[k]
        if k:
            x = F.max_pool2d(x, 2, 2)
        for i, name in enumerate(convs):
            x = self.features[name](x)
            if i < len(prelus):
                x = self.features[prelus[i]](x)
        return x


class _MessagePassing(nn.Module):
    """Two iterations of pairwise message passing (DSSINet.py:243-283)."""

    def __init__(self, channels, dtype, iters=2):
        super().__init__()
        self.n, self.iters = len(channels), iters
        self.prelu = PReLU()
        for i in range(self.n):
            for j in range(self.n):
                if i != j:
                    self.add_module(f"w_0_{j}_{i}_0", nn.Sequential(
                        conv_bias(channels[j], channels[i], 1, dtype=dtype)))

    def forward(self, states: List[torch.Tensor]):
        hidden = list(states)
        for _ in range(self.iters):
            new = []
            for i in range(self.n):
                binary = None
                for j in range(self.n):
                    if i != j:
                        msg = getattr(self, f"w_0_{j}_{i}_0")(hidden[j])
                        binary = msg if binary is None else binary + msg
                new.append(F.relu(hidden[i] + self.prelu(binary)))
            hidden = new
        return hidden


def conv_bias(cin, cout, k, relu=False, dtype=torch.float32):
    """The reference's Conv2d wrapper: ``.conv`` with its bias, 'same'
    padding, an optional ReLU."""
    return ConvBlock(cin, cout, k, padding=k // 2, relu=relu, dtype=dtype, bias=True)


@MODELS.register("dssinet")
class DSSINet(nn.Module):
    flax_layout = "dssinet"
    reference_unused = ("front_end.features.relu8.", "front_end.features.relu15.")
    # mesh: {spatial: N}: the x0.5 level's three pools (parallel/spatial.py);
    # the pyramid's resizes and the decoder's upsamples read neighbour rows
    row_rule = 16
    spatial_group = None

    def __init__(self, pretrained: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.front_end = _FrontEnd(dtype)
        self.passing1 = _MessagePassing((128, 64), dtype)
        self.passing2 = _MessagePassing((256, 128, 64), dtype)
        self.passing3 = _MessagePassing((512, 256, 128), dtype)
        self.passing4 = _MessagePassing((512, 256), dtype)
        for k, cin in enumerate((512, 768, 896, 448, 192), 1):
            self.add_module(f"decoder{k}", nn.Sequential(
                conv_bias(cin, 128, 1, relu=True, dtype=dtype), conv_bias(128, 1, 3, dtype=dtype)))
        for k in range(1, 5):
            self.add_module(f"passing_weight{k}", conv_bias(1, 1, 3, dtype=dtype))
        self.prelu = PReLU()
        self.reset_parameters()

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here)."""
        h, w = x.shape[2:]
        g = self.spatial_group
        fe = self.front_end
        s1, s3 = resize_bilinear(x, (2 * h, 2 * w), g), resize_bilinear(x, (h // 2, w // 2), g)
        feat = fe.features

        f1_c2 = fe.stage(1, feat["relu3"](fe.stage(0, s1)))
        f2_c1 = fe.stage(0, x)
        f1_c2, f2_c1 = self.passing1([f1_c2, f2_c1])
        agg4 = torch.cat([f1_c2, f2_c1], dim=1)

        f1_c3, f2_c2, f3_c1 = self.passing2([fe.stage(2, f1_c2), fe.stage(1, f2_c1),
                                             fe.stage(0, s3)])
        agg3 = torch.cat([f1_c3, f2_c2, f3_c1], dim=1)

        f1_c4, f2_c3, f3_c2 = self.passing3([fe.stage(3, f1_c3), fe.stage(2, f2_c2),
                                             fe.stage(1, f3_c1)])
        agg2 = torch.cat([f1_c4, f2_c3, f3_c2], dim=1)

        f2_c4, f3_c3 = self.passing4([fe.stage(3, f2_c3), fe.stage(2, f3_c2)])
        agg1 = torch.cat([f2_c4, f3_c3], dim=1)
        f3_c4 = feat["relu22"](fe.stage(3, f3_c3))

        dens = self.prelu(self.decoder1(f3_c4))
        for k, agg in zip((2, 3, 4), (agg1, agg2, agg3)):
            dens = self.prelu(getattr(self, f"decoder{k}")(agg)
                              + getattr(self, f"passing_weight{k - 1}")(
                                  upsample(dens, 2, group=g)))
        return F.relu(self.decoder5(agg4) + self.passing_weight4(upsample(dens, 2, group=g)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)
