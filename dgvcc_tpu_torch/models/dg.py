"""The DGModel family (eval forward), counterpart of dgvcc_tpu/models/dg.py.

NCHW ``nn.Module``s whose state_dict keys are the reference DGVCC
layout (``models/models.py`` of Shimmer93/DGVCC), so a trained
reference ``.pth`` loads with a strict ``load_state_dict``:

  * ``enc1/enc2/enc3``: vgg16_bn ``features[:23] / [23:33] / [33:43]``
    with local indices (strides 4 / 8 / 16);
  * ``dec{3,2,1}.{0,1}``, ``den_dec.0``, ``den_head.0``,
    ``cls_head.{0,2}``: ``ConvBlock``s (``.conv`` / ``.bn``);
  * ``mem``: the prototype bank, shape (1, K, S).

Convolutions run in the model ``dtype``; batch norm, the softmax and
the bank's products accumulate in float32, as in the JAX package. The
two-view training forward is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import ConvBlock, upsample
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGGFeatures, feature_layout
from dgvcc_tpu_torch.ops.mem_attention import memory_attention_fused


class MemoryBank(nn.Module):
    """Attention over the prototype bank (eval path). It holds no
    parameter: the bank is the model's ``mem`` (reference key layout).

    ``fused``: the CUDA kernel (``ops/mem_attention.py``), which keeps the
    attention in float32 into the second product. Otherwise the einsum
    path of the JAX ``MemoryBank``: float32 logits and softmax, the
    attention cast to the compute dtype before the second product.
    """

    def __init__(self, mem_dim: int, fused: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mem_dim = mem_dim
        self.fused = fused
        self.dtype = dtype

    def forward(self, y: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        """y: (B, K, H, W); mem: (K, S) -> (B, K, H, W)."""
        b, k, h, w = y.shape
        if k != self.mem_dim:
            raise ValueError(f"MemoryBank mem_dim={self.mem_dim} but input "
                             f"has {k} channels")
        mem = mem.to(self.dtype)
        # a channels-last y makes this permute a free view
        y_flat = y.permute(0, 2, 3, 1).reshape(b, h * w, k)
        if self.fused:
            y_new = memory_attention_fused(y_flat, mem)
        else:
            logits = torch.matmul(y_flat.float(), mem.float()) / math.sqrt(k)
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            y_new = torch.matmul(attn.float(), mem.float().t()).to(y.dtype)
        return y_new.reshape(b, h, w, k).permute(0, 3, 1, 2)


class DGModel(nn.Module):
    """Configurable DG counter. Variants (reference class -> flags):

    base    -> use_mem=False, use_cls=False
    mem     -> use_mem=True,  use_cls=False
    memadd  -> mem without den_dec dropout (two-view training)
    cls     -> use_mem=False, use_cls=True
    memcls  -> use_mem=True,  use_cls=True
    final   -> memcls without den_dec dropout (two-view training)

    ``fused_mem`` (default on, unlike the JAX model, whose Pallas kernel
    runs only on a TPU): the bank runs the CUDA kernel on a card and its
    plain version on the CPU; off, the einsum path, which rounds the
    attention to the compute dtype.

    ``den_dec`` holds the JAX model's ``_den_features`` (the 1x1 block and,
    for base/mem/cls/memcls, its Dropout2d); ``cls_head`` is the reference
    Sequential (block, Dropout2d, block, Sigmoid).
    """

    def __init__(self, use_mem: bool = False, use_cls: bool = False,
                 mem_size: int = 1024, mem_dim: int = 256,
                 den_dropout: float = 0.5, cls_dropout: float = 0.5,
                 cls_thrs: float = 0.5, den_dec_dropout: bool = True,
                 fused_mem: bool = True, vgg_cfg: Any = None,
                 stage_splits: Any = (0, 23, 33, 43),
                 dec_widths: Any = ((1024, 512), (512, 256), (256, 128)),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_mem, self.use_cls = use_mem, use_cls
        self.cls_thrs = cls_thrs

        cfg = tuple(VGG16_CFG if vgg_cfg is None else vgg_cfg)
        s0, s1, s2, s3 = stage_splits
        n = len(feature_layout(cfg, True))
        if not (0 <= s0 < s1 < s2 < s3 <= n):
            raise ValueError(
                f"stage_splits {tuple(stage_splits)} do not address the "
                f"{n}-slot feature layout of this vgg_cfg — override "
                f"stage_splits together with vgg_cfg")
        self.enc1 = VGGFeatures(cfg, True, s0, s1, dtype)
        self.enc2 = VGGFeatures(cfg, True, s1, s2, dtype)
        self.enc3 = VGGFeatures(cfg, True, s2, s3, dtype)
        c1, c2, c3 = (self.enc1.out_channels, self.enc2.out_channels,
                      self.enc3.out_channels)

        (w3a, w3b), (w2a, w2b), (w1a, w1b) = dec_widths

        def block(cin, cout, **kw):
            return ConvBlock(cin, cout, dtype=dtype, **kw)

        self.dec3 = nn.Sequential(block(c3, w3a, bn=True), block(w3a, w3b, bn=True))
        self.dec2 = nn.Sequential(block(w3b + c2, w2a, bn=True),
                                  block(w2a, w2b, bn=True))
        self.dec1 = nn.Sequential(block(w2b + c1, w1a, bn=True),
                                  block(w1a, w1b, bn=True))

        den_ch = mem_dim if use_mem else 2 * w1b
        den_dec = [block(w1b + w2b + w3b, den_ch, kernel_size=1, padding=0, bn=True)]
        if den_dec_dropout:
            den_dec.append(nn.Dropout2d(den_dropout))
        self.den_dec = nn.Sequential(*den_dec)
        self.den_head = nn.Sequential(block(den_ch, 1, kernel_size=1, padding=0))

        if use_mem:
            self.mem = nn.Parameter(torch.empty(1, mem_dim, mem_size))
            self.memory = MemoryBank(mem_dim, fused=fused_mem, dtype=dtype)
        if use_cls:
            self.cls_head = nn.Sequential(
                block(c3, w2b, bn=True), nn.Dropout2d(cls_dropout),
                block(w2b, 1, kernel_size=1, padding=0, relu=False),
                nn.Sigmoid())
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal convolutions (fan_in, ReLU gain), zero biases, unit
        BN, a standard-normal bank. Seeded from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * math.sqrt(2.0 / fan_in))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
            if self.use_mem:
                self.mem.copy_(torch.randn(self.mem.shape, generator=generator))

    # ---- building blocks -------------------------------------------------

    def forward_fe(self, x):
        """Encoder + decoder -> (multi-scale concat at stride 4, stride-16
        features). y_cat = [dec1, up2(dec2), up4(dec3)]."""
        x1 = self.enc1(x)
        x2 = self.enc2(x1)
        x3 = self.enc3(x2)
        y3 = self.dec3(x3)
        y2 = self.dec2(torch.cat([upsample(y3, 2), x2], dim=1))
        y2_up = upsample(y2, 2)
        y1 = self.dec1(torch.cat([y2_up, x1], dim=1))
        y_cat = torch.cat([y1, y2_up, upsample(y3, 4)], dim=1)
        return y_cat, x3

    def transform_cls_map_gt(self, c_gt):
        return upsample(c_gt, 4, mode="nearest")

    def transform_cls_map_pred(self, c):
        c_bin = (c >= self.cls_thrs).to(c.dtype)
        return upsample(c_bin, 4, mode="nearest")

    # ---- inference forward -----------------------------------------------

    def forward(self, x, c_gt=None):
        """Single-view eval forward. Returns the density map (B, 1, H, W),
        and with a classifier also the cls map at stride 16."""
        y_cat, x3 = self.forward_fe(x)
        y_den = self.den_dec(y_cat)
        if self.use_mem:
            y_den = self.memory(y_den, self.mem[0])
        d = self.den_head(y_den)
        if self.use_cls:
            c = self.cls_head(x3)
            c_resized = (self.transform_cls_map_gt(c_gt) if c_gt is not None
                         else self.transform_cls_map_pred(c))
            return upsample(d * c_resized, 4), c
        return upsample(d, 4)


# the model params of the reference YAML configs that change the eval
# forward; the training-only ones (err_thrs, has_err_loss, remat, ...) and
# `pretrained` (a weight-loading flag) are dropped
_PARAM_NAMES = ("mem_size", "mem_dim", "den_dropout", "cls_dropout",
                "cls_thrs", "fused_mem", "vgg_cfg", "stage_splits",
                "dec_widths", "dtype")


def _variant(name, **flags):
    def build(**params):
        kw = dict(flags)
        kw.update({k: params[k] for k in _PARAM_NAMES if k in params})
        return DGModel(**kw)

    MODELS.register(name, build)
    return build


dg_base = _variant("base", use_mem=False, use_cls=False, den_dec_dropout=True)
dg_mem = _variant("mem", use_mem=True, use_cls=False, den_dec_dropout=True)
dg_memadd = _variant("memadd", use_mem=True, use_cls=False, den_dec_dropout=False)
dg_cls = _variant("cls", use_mem=False, use_cls=True, den_dec_dropout=True)
dg_memcls = _variant("memcls", use_mem=True, use_cls=True, den_dec_dropout=True)
dg_final = _variant("final", use_mem=True, use_cls=True, den_dec_dropout=False)
