"""The whitening counters (NCHW), counterpart of dgvcc_tpu/models/whitening.py:
sw, sw_vgg, sw_densenet, ibn, ibn_densenet and isw.

The ResNet counters cut the trunk after layer3 (1024 channels, stride 16)
and end in the 3-conv counting head with a bilinear x16 upsample
(align_corners=True). Keys follow the reference torch layout: ``sw`` and
``ibn`` hold ``backbone.{0,1,4,5,6}`` (the reference's Sequential of the
ResNet's first children) and ``head.{0,2,4}``; ``isw`` holds ``layer0``
(conv1, InstanceWhitening, relu, max pool), ``layer1..3`` and ``head``;
``sw_vgg`` holds ``vgg.features`` (conv, SW, relu per VGG19 entry, max
pools) and ``vgg.reg_layer.{0,2,4}``. The DenseNet counters have no
reference checkpoint and use torchvision's DenseNet names under
``backbone``.

ISW's protocol (ISW/__init__.py:70-122):
  (a) in training, ``forward(x, gts=..., masks=..., num_sensitive=...,
      margins=..., apply_wtloss=...)`` returns [count_loss, wt_loss]:
      count_loss = mean((d - gts)^2) on the model's own map (gts is the
      density map times log_para), wt_loss the mean over the three
      whitening sites of the masked covariance loss;
  (b) ``cov_stats(x2)``: per site, the variance over the batch of the
      two concatenated views of each off-diagonal covariance entry;
      ``IswCovTracker`` accumulates them during validation and selects the
      sensitive entries on the host (numpy, as the JAX trackers);
  (c) without gts, the density map.

The six counters take ``process_group`` (the JAX models' ``axis_name``):
under ``mesh: {data: N}`` the trainer builds them with the data group, and
their batch norms and SwitchWhitens average the batch statistics over the
ranks in the training forward (``nn/layers.py::sync_statistics``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.densenet import DENSENET_CONFIGS, DenseNetTrunk
from dgvcc_tpu_torch.nn.layers import Conv2d, sync_statistics
from dgvcc_tpu_torch.nn.resnet import RESNET_BLOCK, RESNET_LAYERS, ResNetTrunk, resnet_forward
from dgvcc_tpu_torch.nn.vgg import VGG19_CFG
from dgvcc_tpu_torch.nn.whitening import (InstanceNorm, SwitchWhiten, get_covariance_matrix,
                                          instance_whitening_loss)

SW_KW = dict(num_pergroup=16, sw_type=2, T=5, tie_weight=False, momentum=0.9,
             affine=True)  # sw_cfg, models/SW/__init__.py:4-10


def _upsample_ac(x, factor):
    """nn.UpsamplingBilinear2d: bilinear with align_corners=True."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=True)


class CountingHead(nn.Sequential):
    """cin -> 512 -> 256 -> 1 convs and a bilinear x16 upsample
    (SW/__init__.py:30-37): keys 0, 2, 4."""

    def __init__(self, cin: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__(Conv2d(cin, 512, 3, padding=1, dtype=dtype), nn.ReLU(),
                         Conv2d(512, 256, 3, padding=1, dtype=dtype), nn.ReLU(),
                         Conv2d(256, 1, 1, dtype=dtype),
                         nn.Upsample(scale_factor=16, mode="bilinear", align_corners=True))


class _Counter(nn.Module):
    """Seeded init of the whitening counters: He-normal convolution and
    linear weights (fan_in, ReLU gain), zero biases, unit norms, SW mix
    weights at one and zero running statistics. ``flax_layout`` names the
    JAX variables' layout for ``nn/convert.py::state_dict_from_flax``."""

    flax_layout = "resnet"

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * math.sqrt(2.0 / m.weight[0].numel()))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.BatchNorm2d, SwitchWhiten, InstanceNorm)):
                    m.reset_parameters()


def _head_channels(block: str) -> int:
    return 256 * (4 if block == "bottleneck" else 1)


@MODELS.register("sw")
class SWCounterResNet(_Counter):
    """SWCounter_ResNet (SW/__init__.py:24-42): resnet-SW through layer3 +
    head. ``depth`` picks the torchvision geometry; ``layers`` overrides
    the block counts (tiny nets in tests)."""

    def __init__(self, pretrained: bool = True, depth: int = 50,
                 layers: Optional[Sequence[int]] = None, dtype: torch.dtype = torch.float32,
                 process_group=None):
        super().__init__()
        block = RESNET_BLOCK[depth]
        self.backbone = ResNetTrunk(layers=layers or RESNET_LAYERS[depth], block=block,
                                    num_stages=3, stem_norm="sw",
                                    stage_sw=(True, True, True, False), sw_kwargs=SW_KW,
                                    dtype=dtype)
        self.head = CountingHead(_head_channels(block), dtype)
        sync_statistics(self, process_group)

    def forward(self, x, generator=None):
        return self.head(self.backbone(x)[0])


@MODELS.register("ibn")
class IBNCounterResNet(_Counter):
    """IBNCounter_ResNet (ibnnet/__init__.py:11-28): resnet50_ibn_b through
    layer3 + head (IN(affine) stem, IN after the residual add of the last
    blocks of stages 1-2). ``ibn_cfg='a'``: IBN as bn1 of every block of
    stages 1-3; ``groups`` / ``base_width`` (ResNeXt) and ``se``."""

    def __init__(self, pretrained: bool = True, depth: int = 50, ibn_cfg: str = "b",
                 groups: int = 1, base_width: int = 64, se: bool = False,
                 layers: Optional[Sequence[int]] = None, dtype: torch.dtype = torch.float32,
                 process_group=None):
        super().__init__()
        if ibn_cfg == "b":
            spec = dict(stem_norm="in_affine", stage_post=("in", "in", None, None))
        else:
            spec = dict(stem_norm="bn", stage_ibn_a=(True, True, True, False))
        block = RESNET_BLOCK[depth]
        self.backbone = ResNetTrunk(layers=layers or RESNET_LAYERS[depth], block=block,
                                    num_stages=3, groups=groups, base_width=base_width,
                                    se=se, dtype=dtype, **spec)
        self.head = CountingHead(_head_channels(block), dtype)
        sync_statistics(self, process_group)

    def forward(self, x, generator=None):
        return self.head(self.backbone(x)[0])


class _DenseNetCounter(_Counter):
    flax_layout = "densenet"

    def __init__(self, norm1_mode: str, depth: int, block_config, dtype, process_group):
        super().__init__()
        cfg = dict(DENSENET_CONFIGS[depth])
        if block_config is not None:
            cfg["block_config"] = tuple(block_config)
        self.backbone = DenseNetTrunk(num_stages=3, norm1_mode=norm1_mode,
                                      stage_with=(True, True, True, False),
                                      sw_kwargs=SW_KW, dtype=dtype, **cfg)
        self.head = CountingHead(self.backbone.out_channels, dtype)
        sync_statistics(self, process_group)

    def forward(self, x, generator=None):
        return self.head(self.backbone(x))


@MODELS.register("sw_densenet")
class SWCounterDenseNet(_DenseNetCounter):
    """DenseNet-SW (SW/backbones/densenet.py:78-201) cut after denseblock3,
    with the counting head."""

    def __init__(self, pretrained: bool = True, depth: int = 121,
                 block_config: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32, process_group=None):
        super().__init__("sw", depth, block_config, dtype, process_group)


@MODELS.register("ibn_densenet")
class IBNCounterDenseNet(_DenseNetCounter):
    """DenseNet-IBN-a (ibnnet/densenet_ibn.py:43-97) cut after
    denseblock3, with the counting head."""

    def __init__(self, pretrained: bool = True, depth: int = 121,
                 block_config: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32, process_group=None):
        super().__init__("ibn", depth, block_config, dtype, process_group)


class _SWVGG(nn.Module):
    """The reference's SW VGG (SW/backbones/vgg.py:16-62): VGG19's 16 convs
    (cfg 'E' without the last pool), SW after each, then x2 bilinear
    (align_corners), the 512 -> 256 -> 128 -> 1 reg head and |.|."""

    def __init__(self, dtype):
        super().__init__()
        layers, ch = [], 3
        for v in VGG19_CFG[:-1]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(ch, v, 3, padding=1, dtype=dtype), SwitchWhiten(v, **SW_KW),
                           nn.ReLU()]
                ch = v
        self.features = nn.Sequential(*layers)
        self.reg_layer = nn.Sequential(Conv2d(512, 256, 3, padding=1, dtype=dtype), nn.ReLU(),
                                       Conv2d(256, 128, 3, padding=1, dtype=dtype), nn.ReLU(),
                                       Conv2d(128, 1, 1, dtype=dtype))

    def forward(self, x):
        return self.reg_layer(_upsample_ac(self.features(x), 2)).abs()


@MODELS.register("sw_vgg")
class SWCounterVGG(_Counter):
    """SWCounter_VGG (SW/__init__.py:12-22): the SW VGG at stride 8, then
    the counter's x8 bilinear upsample (align_corners)."""

    flax_layout = "sw_vgg"

    def __init__(self, pretrained: bool = True, dtype: torch.dtype = torch.float32,
                 process_group=None):
        super().__init__()
        self.vgg = _SWVGG(dtype)
        sync_statistics(self, process_group)

    def forward(self, x, generator=None):
        return _upsample_ac(self.vgg(x), 8)


# channel widths of the three whitening sites (stem, layer1, layer2)
ISW_WT_CHANNELS = (64, 256, 512)


@MODELS.register("isw")
class ISWCounterResNet(_Counter):
    """ISWCounter_ResNet (ISW/__init__.py:21-122). ``relax_denom``,
    ``clusters`` and ``wt_type`` ('isw' or 'irw') are model params of the
    configs that the trainer's covariance tracker reads; the model takes
    and ignores them."""

    flax_layout = "isw"
    # keys of a reference checkpoint its forward never reads
    reference_unused = ("layer4.", "fc.")

    def __init__(self, pretrained: bool = True, relax_denom: float = 2.0, clusters: int = 3,
                 layers: Sequence[int] = (3, 4, 6, 3), wt_type: str = "isw",
                 dtype: torch.dtype = torch.float32, process_group=None):
        super().__init__()
        trunk = ResNetTrunk(layers=layers, num_stages=3, stem_norm="iw",
                            stage_post=("iw", "iw", None, None), dtype=dtype)
        self.layer0 = nn.Sequential(*list(trunk)[:4])
        self.layer1, self.layer2, self.layer3 = trunk[4], trunk[5], trunk[6]
        self.head = CountingHead(1024, dtype)
        sync_statistics(self, process_group)

    def _trunk(self, x, num_stages=None):
        mods = [*self.layer0, self.layer1, self.layer2, self.layer3]
        return resnet_forward(mods, x, num_stages)

    def forward(self, x, gts=None, masks: Optional[Dict[str, torch.Tensor]] = None,
                num_sensitive: Optional[Dict[str, torch.Tensor]] = None,
                margins: Optional[Dict[str, torch.Tensor]] = None, apply_wtloss: bool = True,
                generator=None):
        feats, w_arr = self._trunk(x)
        d = self.head(feats)
        if gts is None:
            return d
        loss1 = torch.mean((d.float() - gts.float()) ** 2)
        wt_loss = torch.zeros((), device=d.device)
        if masks is not None and apply_wtloss:
            for i, w in enumerate(w_arr):
                margin = margins[f"m{i}"] if margins is not None else 0.0
                wt_loss = wt_loss + instance_whitening_loss(w, masks[f"m{i}"], margin,
                                                            num_sensitive[f"m{i}"])
            wt_loss = wt_loss / len(w_arr)
        return [loss1, wt_loss]

    def cov_stats(self, x2) -> Dict[str, torch.Tensor]:
        """Per whitening site, the variance over the batch (the two views
        concatenated, ISW/__init__.py:93-104) of each off-diagonal
        covariance entry, (C, C) float32, zero on and below the diagonal."""
        _, w_arr = self._trunk(x2, num_stages=2)
        out = {}
        for i, w in enumerate(w_arr):
            c = w.shape[1]
            rev_eye = torch.triu(torch.ones(c, c, device=w.device), diagonal=1)
            out[f"m{i}"] = torch.var(get_covariance_matrix(w) * rev_eye, dim=0, unbiased=True)
        return out


# ---------------------------------------------------------------------------
# Host-side covariance tracking and mask selection (CovMatrix_ISW's role)
# ---------------------------------------------------------------------------

def kmeans_1d(values: np.ndarray, k: int):
    """Exact 1-D k-means (utils/kmeans1d.py): (labels, centroids), centroids
    ascending, cluster 0 the smallest values (the insensitive entries)."""
    from dgvcc_tpu_torch.utils.kmeans1d import cluster

    labels, cents = cluster(values, k)
    return np.asarray(labels, np.int64), np.asarray(cents, np.float64)


def _as_batch(masks, nums, margins):
    """numpy masks and counts -> the train batch's dicts of CPU tensors."""
    return ({f"m{i}": torch.from_numpy(np.asarray(m, np.float32)) for i, m in enumerate(masks)},
            {f"m{i}": torch.tensor(float(n), dtype=torch.float32) for i, n in enumerate(nums)},
            {f"m{i}": torch.tensor(float(g), dtype=torch.float32)
             for i, g in enumerate(margins)})


class IswCovTracker:
    """Accumulates the variance of covariance per whitening site and
    selects the sensitive entries (reference cov_settings.py:16-89)."""

    def __init__(self, dims: Sequence[int] = ISW_WT_CHANNELS, relax_denom: float = 2.0,
                 clusters: int = 3):
        self.dims = list(dims)
        self.relax_denom = relax_denom
        self.clusters = clusters
        self.reset()

    def reset(self):
        self.var = [None] * len(self.dims)
        self.count = 0
        self.masks: Optional[List[np.ndarray]] = None
        self.num_sensitive = [0.0] * len(self.dims)

    def add(self, var_covs: Dict[str, np.ndarray]):
        for i in range(len(self.dims)):
            v = np.asarray(var_covs[f"m{i}"], np.float64)
            self.var[i] = v if self.var[i] is None else self.var[i] + v
        self.count += 1

    def has_stats(self) -> bool:
        return self.count > 0

    def set_mask_matrix(self):
        """Select the sensitive covariance entries (cov_settings.py:52-77),
        intersected with the masks selected before."""
        masks, nums = [], []
        for i, dim in enumerate(self.dims):
            flat = (self.var[i] / max(self.count, 1)).ravel()
            num_off = dim * (dim - 1) // 2
            if self.relax_denom == 0:
                labels, _ = kmeans_1d(flat, self.clusters)
                num_sensitive = int(flat.size - np.sum(labels == 0))
            else:
                num_sensitive = int(num_off - num_off // self.relax_denom)
            idx = np.argsort(flat)[::-1][:num_sensitive]
            m = np.zeros(flat.size, np.float32)
            m[idx] = 1.0
            m = m.reshape(dim, dim)
            if self.masks is not None:
                m = (self.masks[i].astype(np.int32) & m.astype(np.int32)).astype(np.float32)
            masks.append(m)
            nums.append(float(m.sum()))
        self.masks = masks
        self.num_sensitive = nums
        self.var = [None] * len(self.dims)
        self.count = 0

    def mask_batch(self):
        """(masks, nums, margins) as dicts of CPU tensors; before any
        statistics all-zero masks (a zero whitening loss). ISW's margins
        are 0 (cov_settings.py:47)."""
        if self.masks is None:
            masks = [np.zeros((d, d), np.float32) for d in self.dims]
            nums = [1.0] * len(self.dims)
        else:
            masks, nums = self.masks, self.num_sensitive
        return _as_batch(masks, nums, [0.0] * len(self.dims))


class IrwCovTracker:
    """CovMatrix_IRW's role (cov_settings.py:91-107): the static full
    off-diagonal (upper triangle) mask, a relax_denom margin subtracted in
    the loss and the off-diagonal count as denominator. It accumulates
    nothing: ``add`` and ``set_mask_matrix`` do nothing."""

    def __init__(self, dims: Sequence[int] = ISW_WT_CHANNELS, relax_denom: float = 0.0,
                 clusters: int = 0):
        self.dims = list(dims)
        self.relax_denom = relax_denom

    def reset(self):
        pass

    def add(self, var_covs):
        pass

    def has_stats(self) -> bool:
        return False

    def set_mask_matrix(self):
        pass

    def mask_batch(self):
        offs = [d * (d - 1) // 2 for d in self.dims]
        return _as_batch([np.triu(np.ones((d, d), np.float32), k=1) for d in self.dims], offs,
                         [n // self.relax_denom if self.relax_denom else 0 for n in offs])
