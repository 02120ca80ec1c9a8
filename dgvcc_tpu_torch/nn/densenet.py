"""DenseNet-BC trunk with pluggable norm1 sites (NCHW), counterpart of
dgvcc_tpu/nn/densenet.py.

  * SW DenseNet (models/SW/backbones/densenet.py:78-201): the stem norm0
    and norm1 of every 3rd dense layer (i % 3 == 0) of the stages with
    ``stage_with`` are SwitchWhiten;
  * DenseNet-IBN-a (models/ibnnet/densenet_ibn.py:96-186): those norm1
    sites are the BN-first IBN at ratio 0.4.

Geometry is torchvision's DenseNet-BC: 7x7/2 stem, 3x3/2 max pool, dense
layers (norm1-relu-conv1x1[bn_size k]-norm2-relu-conv3x3[k], concatenated),
transitions (norm-relu-conv1x1[half]-avgpool), final norm5. ``num_stages=3``
stops after denseblock3 (stride 16, 1024 channels for densenet121) and
uses transition3's norm as the final norm, as the JAX trunk does.

The reference ships no counter on these trunks, so there is no reference
checkpoint layout; the names are torchvision's ``features`` children
(``conv0``, ``norm0``, ``denseblock{b}.denselayer{l}.{norm1,conv1,norm2,
conv2}``, ``transition{b}.{norm,conv}``, ``norm5``), the ones
``densenet_to_flax`` reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d
from dgvcc_tpu_torch.nn.whitening import IBN, SwitchWhiten

# torchvision block configs (SW/backbones/densenet.py:21-75)
DENSENET_CONFIGS = {
    121: dict(num_init_features=64, growth_rate=32, block_config=(6, 12, 24, 16)),
    169: dict(num_init_features=64, growth_rate=32, block_config=(6, 12, 32, 32)),
    201: dict(num_init_features=64, growth_rate=32, block_config=(6, 12, 48, 32)),
    161: dict(num_init_features=96, growth_rate=48, block_config=(6, 12, 36, 24)),
}


def _bn(ch):
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class _DenseLayer(nn.Module):
    def __init__(self, cin, growth_rate, bn_size, norm1, dtype):
        super().__init__()
        self.norm1 = norm1
        self.conv1 = Conv2d(cin, bn_size * growth_rate, 1, bias=False, dtype=dtype)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False,
                            dtype=dtype)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(y)))


class _DenseBlock(nn.Module):
    def __init__(self, layers):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(f"denselayer{i + 1}", layer)

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class _Transition(nn.Module):
    """norm-relu-conv1x1-avgpool; without ``cout`` only the norm (the
    final norm of a truncated trunk)."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.norm = _bn(cin)
        self.conv = Conv2d(cin, cout, 1, bias=False, dtype=dtype) if cout else None

    def forward(self, x):
        x = F.relu(self.norm(x))
        if self.conv is None:
            return x
        return F.avg_pool2d(self.conv(x), 2, 2)


class DenseNetTrunk(nn.Module):
    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, num_stages: int = 4,
                 norm1_mode: Optional[str] = None,
                 stage_with: Sequence[bool] = (True, True, True, False),
                 sw_kwargs: Optional[dict] = None, dtype: torch.dtype = torch.float32):
        super().__init__()

        def norm1(ch, special):
            if special and norm1_mode == "sw":
                return SwitchWhiten(ch, **(sw_kwargs or {}))
            if special and norm1_mode == "ibn":
                return IBN(ch, ratio=0.4, bn_first=True)
            return _bn(ch)

        self.conv0 = Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False,
                            dtype=dtype)
        self.norm0 = norm1(num_init_features, norm1_mode == "sw")
        self.num_stages = num_stages
        ch = num_init_features
        for b, n_layers in enumerate(block_config[:num_stages]):
            layers = []
            for i in range(n_layers):
                layers.append(_DenseLayer(ch, growth_rate, bn_size,
                                          norm1(ch, bool(stage_with[b]) and i % 3 == 0),
                                          dtype))
                ch += growth_rate
            self.add_module(f"denseblock{b + 1}", _DenseBlock(layers))
            if b == num_stages - 1:
                if b == len(block_config) - 1:
                    self.norm5 = _bn(ch)
                else:  # a truncated trunk ends on this transition's norm
                    self.add_module(f"transition{b + 1}", _Transition(ch, 0, dtype))
            else:
                self.add_module(f"transition{b + 1}", _Transition(ch, ch // 2, dtype))
                ch //= 2
        self.out_channels = ch

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for b in range(self.num_stages):
            out = getattr(self, f"denseblock{b + 1}")(out)
            if hasattr(self, f"transition{b + 1}"):
                out = getattr(self, f"transition{b + 1}")(out)
        if hasattr(self, "norm5"):
            out = F.relu(self.norm5(out))
        return out
