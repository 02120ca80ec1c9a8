"""ResNet trunk with pluggable normalization (NCHW), counterpart of
dgvcc_tpu/nn/resnet.py.

One trunk serves the SW, IBN and ISW counters through per-stage specs:
  * SW: the stem norm is SwitchWhiten, and so is norm2 of the odd non-first
    blocks of stages with SW (SW/backbones/resnet.py:203-214);
  * IBN-b: IN(affine) stem, IN(affine) after the residual add of the last
    block of stages 1-2; IBN-a: IBN as bn1 of every block;
  * ISW: InstanceWhitening stem, and after the residual add of the last
    block of stages 1-2; their outputs are collected as ``w_arr`` for the
    whitening loss.

Names follow the reference torch layout (the layout
dgvcc_tpu/nn/torch_io.py reads): ``ResNetTrunk`` is the Sequential of the
reference's ``children()[:4 + num_stages]`` (0 conv1, 1 the stem norm,
2 relu, 3 max pool, 4.. the stages); a Bottleneck holds ``conv1``, ``bn1``,
``conv2``, ``bn2`` (``sw2`` where it is SwitchWhiten), ``conv3``, ``bn3``,
``se``, ``downsample.{0,1}`` and the post-residual ``IN``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d
from dgvcc_tpu_torch.nn.whitening import (IBN, InstanceNorm, InstanceWhitening, SELayer,
                                          SwitchWhiten)

# torchvision layer counts by depth
RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
RESNET_BLOCK = {18: "basic", 34: "basic", 50: "bottleneck",
                101: "bottleneck", 152: "bottleneck"}


def _bn(ch):
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _post(kind: Optional[str], ch: int):
    """The module after the residual add: (attribute name, module)."""
    if kind == "in":
        return "IN", InstanceNorm(ch, affine=True)
    if kind == "iw":
        return "instance_norm_layer", InstanceWhitening(ch)
    return None, None


class _Block(nn.Module):
    """The residual add, the post-residual norm and the ReLU of a block;
    returns (out, w), w the whitened map of an 'iw' site or None."""

    def _finish(self, out, x):
        residual = self.downsample(x) if self.downsample is not None else x
        out = out + residual
        w = None
        if self.post_name == "IN":
            out = self.IN(out)
        elif self.post_name is not None:
            out, w = self.instance_norm_layer(out)
        return F.relu(out), w

    def _downsample(self, inplanes, outplanes, stride, dtype):
        if stride == 1 and inplanes == outplanes:
            return None
        return nn.Sequential(Conv2d(inplanes, outplanes, 1, stride=stride, bias=False,
                                    dtype=dtype), _bn(outplanes))

    def _set_post(self, kind, ch):
        self.post_name, mod = _post(kind, ch)
        if mod is not None:
            setattr(self, self.post_name, mod)


class Bottleneck(_Block):
    """3-conv residual block. ``groups`` / ``base_width``: the ResNeXt
    width (resnext_ibn.py:24-48); ``se``: squeeze-excitation after bn3."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 sw_norm2: bool = False, ibn_a: bool = False, post: Optional[str] = None,
                 sw_kwargs: Optional[dict] = None, groups: int = 1, base_width: int = 64,
                 se: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64)) * groups
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, bias=False, dtype=dtype)
        self.bn1 = IBN(width) if ibn_a else _bn(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, groups=groups,
                            bias=False, dtype=dtype)
        self.norm2_name = "sw2" if sw_norm2 else "bn2"
        setattr(self, self.norm2_name,
                SwitchWhiten(width, **(sw_kwargs or {})) if sw_norm2 else _bn(width))
        self.conv3 = Conv2d(width, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = _bn(out_ch)
        self.se = SELayer(out_ch) if se else None
        self.downsample = self._downsample(inplanes, out_ch, stride, dtype)
        self._set_post(post, out_ch)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(getattr(self, self.norm2_name)(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        return self._finish(out, x)


class BasicBlock(_Block):
    """2-conv residual block (resnet18/34); its SW site is norm1 (``sw1``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 sw_norm2: bool = False, ibn_a: bool = False, post: Optional[str] = None,
                 sw_kwargs: Optional[dict] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False,
                            dtype=dtype)
        self.norm1_name = "sw1" if sw_norm2 else "bn1"
        norm1 = (SwitchWhiten(planes, **(sw_kwargs or {})) if sw_norm2
                 else IBN(planes) if ibn_a else _bn(planes))
        setattr(self, self.norm1_name, norm1)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = _bn(planes)
        self.downsample = self._downsample(inplanes, planes, stride, dtype)
        self._set_post(post, planes)

    def forward(self, x):
        out = F.relu(getattr(self, self.norm1_name)(self.conv1(x)))
        return self._finish(self.bn2(self.conv2(out)), x)


def _stem_norm(kind: str, sw_kwargs):
    if kind == "bn":
        return _bn(64)
    if kind == "in_affine":
        return InstanceNorm(64, affine=True)
    if kind == "iw":
        return InstanceWhitening(64)
    if kind == "sw":
        return SwitchWhiten(64, **(sw_kwargs or {}))
    raise ValueError(kind)


class ResNetTrunk(nn.Sequential):
    """ResNet through ``num_stages`` stages (stride 4 * 2^k): the
    reference's ``children()[:4 + num_stages]``. ``forward`` returns
    (features, w_arr), w_arr the whitened maps of the 'iw' sites (stem,
    post-residual) in order."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 num_stages: int = 4, stem_norm: str = "bn",
                 stage_sw: Sequence[bool] = (False,) * 4,
                 stage_ibn_a: Sequence[bool] = (False,) * 4,
                 stage_post: Sequence[Optional[str]] = (None,) * 4,
                 sw_kwargs: Optional[dict] = None, groups: int = 1, base_width: int = 64,
                 se: bool = False, dtype: torch.dtype = torch.float32):
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        mods = [Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype),
                _stem_norm(stem_norm, sw_kwargs), nn.ReLU(), nn.MaxPool2d(3, 2, 1)]
        inplanes = 64
        for k in range(num_stages):
            planes = 64 * 2 ** k
            stride = 1 if k == 0 else 2
            n = layers[k]
            extra = (dict(groups=groups, base_width=base_width, se=se)
                     if block_cls is Bottleneck else {})
            blocks = []
            for i in range(n):
                blocks.append(block_cls(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    sw_norm2=bool(stage_sw[k]) and i != 0 and i % 2 == 1,
                    ibn_a=bool(stage_ibn_a[k]), post=stage_post[k] if i == n - 1 else None,
                    sw_kwargs=sw_kwargs, dtype=dtype, **extra))
                inplanes = planes * block_cls.expansion
            mods.append(nn.Sequential(*blocks))
        super().__init__(*mods)

    def forward(self, x, num_stages: Optional[int] = None):
        """``num_stages``: stop after that many stages (all by default)."""
        return resnet_forward(list(self), x, num_stages)


def resnet_forward(mods, x, num_stages: Optional[int] = None):
    """The trunk's forward over its modules [conv1, norm, relu, pool,
    stage 1, ...] -> (features, w_arr)."""
    w_arr = []
    out = mods[0](x)
    out = mods[1](out)
    if isinstance(out, tuple):  # InstanceWhitening
        out, w = out
        w_arr.append(w)
    out = mods[3](F.relu(out))
    stages = mods[4:] if num_stages is None else mods[4:4 + num_stages]
    for stage in stages:
        for blk in stage:
            out, w = blk(out)
            if w is not None:
                w_arr.append(w)
    return out, w_arr
