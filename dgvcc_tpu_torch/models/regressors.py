"""The U-Net density regressors and the generators (NCHW), counterpart of
dgvcc_tpu/models/regressors.py (the reference's models/models2.py):

  * ``gen`` (Generator): a VGG19[:26] encoder (no batch norm) and a
    ConvBlock decoder with three x2 upsamples, tanh out: an image-to-image
    translator (modes generation and joint). ``vgg_cfg`` / ``enc_stop``
    shrink the encoder for tests, as the JAX model's knobs do;
  * ``gen0`` (Generator0): the skip variant, VGG19 ``enc1-3`` ([:9],
    [9:18], [18:26]) and a U-Net decoder;
  * ``dgnet`` (DensityRegressorBase): VGG16-BN U-Net, a 1x1 density
    decoder with channel dropout, a 1x1 head, x4 upsample;
  * ``dgnet_cls`` (DensityRegressorBaseCls): + a foreground classifier at
    stride 16 whose binarised map gates the density; returns (dc, (d, c));
  * ``reg`` (DensityRegressor): instance norm after each encoder stage and
    deep dropout heads; returns (dc, d, c, x3);
  * ``reg_mem`` (DensityRegressorM): the models2 twin of DGModel ``final``,
    with the prototype bank and the true KL-based JSD between the views'
    attentions; ``forward`` returns (dc, c), ``forward_train`` (dc1, dc2,
    c1, c2, loss_kl, loss_err).

Keys follow the reference models2 layout that
``dgvcc_tpu/nn/torch_io.py::regressor_m_checkpoint_to_flax`` reads for
``reg_mem``: the U-Net at the top level (``stage1-3`` with local indices,
``dec{3,2,1}.{0,1}``), ``den_dec.0``, a direct ``den_head`` block, ``mem``
(1, K, S) and ``cls_head.{0,2}``. ``dgnet``, ``dgnet_cls`` and ``reg`` name
their blocks by the same convention (``den_dec.{0,2,4}``, ``cls_head.{0,2,4,6}``
for ``reg``); those layouts are copied by analogy, not checked against a
reference checkpoint.

``reg_mem``'s evaluation and serving forward (no logits) runs the bank's
serving kernel (#1) when ``fused_mem`` is on (the default, as DGModel's;
``TiledCounter`` turns it on for evaluation); the JAX model takes the
einsum path there. ``forward_train`` needs each view's logits for
``true_jsd`` and takes the bank's einsum path (``MemoryBank.with_logits``),
as the JAX model does. Its dropout comes before the error mask, unlike
DGModel's. Dropout draws from the ``torch.Generator`` a forward is given.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.models.dg import MemoryBank, _run
from dgvcc_tpu_torch.nn.layers import (ConvBlock, Dropout2d, dropout2d, he_normal_,
                                       instance_norm, upsample)
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGG19_CFG, VGGFeatures, feature_layout

DEC_WIDTHS = ((1024, 512), (512, 256), (256, 128))


def _up2():
    return nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False)


@MODELS.register("gen")
class Generator(nn.Module):
    """VGG19[:26] encoder + tanh decoder (models2.py:29-56). Keys: ``enc.{i}``
    (torchvision indices) and ``dec.{i}``, the reference's Sequential with
    its weightless upsamples at 2, 7 and 10 (``generator_checkpoint_to_flax``
    reads this layout)."""

    flax_layout = "generator"

    def __init__(self, pretrained: bool = True, vgg_cfg: Any = None, enc_stop: int = 26,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vgg_cfg = tuple(VGG19_CFG if vgg_cfg is None else vgg_cfg)
        self.enc = VGGFeatures(self.vgg_cfg, False, 0, enc_stop, dtype)
        c = self.enc.out_channels

        def block(cin, cout):
            return ConvBlock(cin, cout, bn=True, dtype=dtype)

        self.dec = nn.Sequential(
            block(c, 512), block(512, 256), _up2(),
            block(256, 256), block(256, 256), block(256, 256), block(256, 128), _up2(),
            block(128, 128), block(128, 64), _up2(),
            block(64, 64), ConvBlock(64, 3, kernel_size=1, padding=0, relu=False, dtype=dtype),
            nn.Tanh())
        self.reset_parameters()

    def forward(self, x):
        return self.dec(self.enc(x))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)


@MODELS.register("gen0")
class Generator0(nn.Module):
    """The skip-connection generator (models2.py:58-103): VGG19 ``enc1-3``
    (local indices) and ``dec{3,2,1}.{0,1}``, ``head.{0,1}``. The JAX
    package reads no reference checkpoint of it; the decoder's names follow
    the U-Net regressors' convention."""

    flax_layout = "generator0"

    def __init__(self, pretrained: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = tuple(VGG19_CFG)
        self.enc1 = VGGFeatures(cfg, False, 0, 9, dtype)
        self.enc2 = VGGFeatures(cfg, False, 9, 18, dtype)
        self.enc3 = VGGFeatures(cfg, False, 18, 26, dtype)

        def block(cin, cout):
            return ConvBlock(cin, cout, bn=True, dtype=dtype)

        c1, c2, c3 = (e.out_channels for e in (self.enc1, self.enc2, self.enc3))
        self.dec3 = nn.Sequential(block(c3, 512), block(512, 256))
        self.dec2 = nn.Sequential(block(256 + c2, 256), block(256, 128))
        self.dec1 = nn.Sequential(block(128 + c1, 128), block(128, 64))
        self.head = nn.Sequential(block(64, 64), ConvBlock(64, 3, kernel_size=1, padding=0,
                                                           relu=False, dtype=dtype))
        self.reset_parameters()

    def forward(self, x):
        x1 = self.enc1(x)
        x2 = self.enc2(x1)
        y = self.dec3(self.enc3(x2))
        y = self.dec2(torch.cat([upsample(y, 2), x2], dim=1))
        y = self.dec1(torch.cat([upsample(y, 2), x1], dim=1))
        return torch.tanh(self.head(upsample(y, 2)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)


def kl_div_batchmean(log_p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``F.kl_div(log_p, target, reduction='batchmean')``:
    sum(target * (log target - log_p)) / batch, in float32."""
    t = target.float()
    return torch.sum(t * (torch.log(torch.clamp(t, min=1e-12)) - log_p.float())) / log_p.shape[0]


def true_jsd(logits1: torch.Tensor, logits2: torch.Tensor) -> torch.Tensor:
    """0.5 / HW * (KL(pm || p1) + KL(pm || p2)), batchmean (models2.py:339-346);
    logits (B, P=HW, S) with the softmax over the prototypes S."""
    l1, l2 = logits1.float(), logits2.float()
    pm = 0.5 * (torch.softmax(l1, dim=-1) + torch.softmax(l2, dim=-1))
    return 0.5 / l1.shape[1] * (kl_div_batchmean(F.log_softmax(l1, dim=-1), pm)
                                + kl_div_batchmean(F.log_softmax(l2, dim=-1), pm))


def _binarize(c: torch.Tensor, thrs: float = 0.5) -> torch.Tensor:
    return (c >= thrs).to(c.dtype).detach()


def _gate(d: torch.Tensor, c_map: torch.Tensor) -> torch.Tensor:
    """The density at stride 4 gated by a stride-16 map, then x4 upsampled."""
    return upsample(d * upsample(c_map, 4, mode="nearest"), 4)


class _VGGUNet(nn.Module):
    """The VGG16-BN U-Net of models2.py:267-290, optionally with an instance
    norm after each encoder stage (``stage_in``, models2.py:150-155); the
    families below extend it, so its keys sit at the top level. The
    tiny-geometry knobs (``vgg_cfg``, ``stage_splits``, ``dec_widths``) are
    DGModel's. ``flax_layout`` names the bridge of ``nn/convert.py``."""

    flax_layout = "regressor"

    def __init__(self, stage_in: bool = False, vgg_cfg: Any = None,
                 stage_splits: Any = (0, 23, 33, 43), dec_widths: Any = DEC_WIDTHS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_in = stage_in
        cfg = tuple(VGG16_CFG if vgg_cfg is None else vgg_cfg)
        self.vgg_cfg, self.stage_splits = cfg, tuple(stage_splits)
        s0, s1, s2, s3 = stage_splits
        n = len(feature_layout(cfg, True))
        if not (0 <= s0 < s1 < s2 < s3 <= n):
            raise ValueError(f"stage_splits {tuple(stage_splits)} do not address the "
                             f"{n}-slot feature layout of this vgg_cfg")
        self.stage1 = VGGFeatures(cfg, True, s0, s1, dtype)
        self.stage2 = VGGFeatures(cfg, True, s1, s2, dtype)
        self.stage3 = VGGFeatures(cfg, True, s2, s3, dtype)
        c1, c2, c3 = (self.stage1.out_channels, self.stage2.out_channels,
                      self.stage3.out_channels)
        (w3a, w3b), (w2a, w2b), (w1a, w1b) = dec_widths
        self.dec3 = nn.Sequential(ConvBlock(c3, w3a, bn=True, dtype=dtype),
                                  ConvBlock(w3a, w3b, bn=True, dtype=dtype))
        self.dec2 = nn.Sequential(ConvBlock(w3b + c2, w2a, bn=True, dtype=dtype),
                                  ConvBlock(w2a, w2b, bn=True, dtype=dtype))
        self.dec1 = nn.Sequential(ConvBlock(w2b + c1, w1a, bn=True, dtype=dtype),
                                  ConvBlock(w1a, w1b, bn=True, dtype=dtype))
        self.cat_channels = w1b + w2b + w3b
        self.x3_channels = c3
        self.dec_widths = tuple(tuple(w) for w in dec_widths)

    def _stage(self, stage, x):
        x = stage(x)
        return instance_norm(x) if self.stage_in else x

    def forward_trunk(self, x):
        """The encoder alone -> x3, the stride-16 features."""
        return self._stage(self.stage3, self._stage(self.stage2, self._stage(self.stage1, x)))

    def forward_fe(self, x):
        """-> (y_cat at stride 4 = [dec1, up2(dec2), up4(dec3)], x3 at stride 16)."""
        x1 = self._stage(self.stage1, x)
        x2 = self._stage(self.stage2, x1)
        x3 = self._stage(self.stage3, x2)
        y3 = self.dec3(x3)
        y2 = self.dec2(torch.cat([upsample(y3, 2), x2], dim=1))
        y2_up = upsample(y2, 2)
        y1 = self.dec1(torch.cat([y2_up, x1], dim=1))
        return torch.cat([y1, y2_up, upsample(y3, 4)], dim=1), x3

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal convolutions, zero biases, unit BN, a standard-normal
        bank; seeded from ``generator``."""
        he_normal_(self, generator)
        if isinstance(getattr(self, "mem", None), nn.Parameter):
            with torch.no_grad():
                self.mem.copy_(torch.randn(self.mem.shape, generator=generator))


def _cls_head(cin: int, widths, out_relu: bool, bn: bool, rate: float, dtype):
    """Blocks of 3x3 convs, each followed by Dropout2d(rate), then a 1x1
    conv to one channel (no ReLU) and a sigmoid."""
    layers = []
    for w in widths:
        layers += [ConvBlock(cin, w, bn=bn, dtype=dtype), Dropout2d(rate)]
        cin = w
    layers += [ConvBlock(cin, 1, kernel_size=1, padding=0, relu=out_relu, dtype=dtype),
               nn.Sigmoid()]
    return nn.Sequential(*layers)


@MODELS.register("dgnet")
class DensityRegressorBase(_VGGUNet):
    """The plain regressor of main_base.py (models2.py:375-432)."""

    def __init__(self, pretrained: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(dtype=dtype)
        self.den_dec = nn.Sequential(
            ConvBlock(self.cat_channels, 256, kernel_size=1, padding=0, dtype=dtype),
            Dropout2d(0.5))
        self.den_head = ConvBlock(256, 1, kernel_size=1, padding=0, dtype=dtype)
        self.reset_parameters()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y_cat, _ = self.forward_fe(x)
        return upsample(self.den_head(_run(self.den_dec, y_cat, generator)), 4)


@MODELS.register("dgnet_cls")
class DensityRegressorBaseCls(_VGGUNet):
    """The plain regressor and a classifier (models2.py:434-511); returns
    (dc, (d, c))."""

    def __init__(self, pretrained: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(dtype=dtype)
        self.den_dec = nn.Sequential(
            ConvBlock(self.cat_channels, 256, kernel_size=1, padding=0, dtype=dtype),
            Dropout2d(0.5))
        self.cls_head = _cls_head(self.x3_channels, (256,), False, False, 0.5, dtype)
        self.den_head = ConvBlock(256, 1, kernel_size=1, padding=0, dtype=dtype)
        self.reset_parameters()

    def forward(self, x, c_gt=None, generator: Optional[torch.Generator] = None):
        y_cat, x3 = self.forward_fe(x)
        y_den = _run(self.den_dec, y_cat, generator)
        c = _run(self.cls_head, x3, generator)
        d = self.den_head(y_den)
        return _gate(d, c_gt if c_gt is not None else _binarize(c)), (d, c)


@MODELS.register("reg")
class DensityRegressor(_VGGUNet):
    """Instance norm after each stage and deep dropout heads
    (models2.py:105-187); returns (dc, d, c, x3)."""

    def __init__(self, pretrained: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(stage_in=True, dtype=dtype)
        self.den_dec = nn.Sequential(
            ConvBlock(self.cat_channels, 256, kernel_size=1, padding=0, dtype=dtype),
            Dropout2d(0.2), ConvBlock(256, 256, dtype=dtype), Dropout2d(0.2),
            ConvBlock(256, 256, dtype=dtype), Dropout2d(0.2))
        self.den_head = ConvBlock(256, 1, kernel_size=1, padding=0, dtype=dtype)
        self.cls_head = _cls_head(self.x3_channels, (256, 256, 256), False, False, 0.2, dtype)
        self.reset_parameters()

    def forward(self, x, c_gt=None, generator: Optional[torch.Generator] = None):
        y_cat, x3 = self.forward_fe(x)
        d = self.den_head(_run(self.den_dec, y_cat, generator))
        c = _run(self.cls_head, x3, generator)
        return _gate(d, c_gt if c_gt is not None else _binarize(c)), d, c, x3


@MODELS.register("reg_mem")
class DensityRegressorM(_VGGUNet):
    """The models2 twin of DGModel ``final`` (models2.py:189-373)."""

    def __init__(self, pretrained: bool = True, thrs: float = 0.5, part_num: int = 1024,
                 final_dim: int = 256, fused_mem: bool = True, vgg_cfg: Any = None,
                 stage_splits: Any = (0, 23, 33, 43), dec_widths: Any = DEC_WIDTHS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vgg_cfg=vgg_cfg, stage_splits=stage_splits, dec_widths=dec_widths,
                         dtype=dtype)
        self.thrs = thrs
        self.den_dec = nn.Sequential(ConvBlock(self.cat_channels, final_dim, kernel_size=1,
                                               padding=0, bn=True, dtype=dtype))
        self.mem = nn.Parameter(torch.empty(1, final_dim, part_num))
        self.memory = MemoryBank(final_dim, fused=fused_mem, dtype=dtype)
        self.den_head = ConvBlock(final_dim, 1, kernel_size=1, padding=0, dtype=dtype)
        self.cls_head = _cls_head(self.x3_channels, (self.dec_widths[1][1],), False, True,
                                  0.5, dtype)
        self.reset_parameters()

    def forward(self, x, c_gt=None, raw: bool = True,
                generator: Optional[torch.Generator] = None):
        """-> (dc, c). Without ``raw`` no gradient reaches the bank's input
        (models2.py:298-300)."""
        y_cat, x3 = self.forward_fe(x)
        y_new = self.memory(self.den_dec(y_cat), self.mem[0])
        if not raw:
            y_new = y_new.detach()
        c = _run(self.cls_head, x3, generator)
        d = self.den_head(y_new)
        return _gate(d, c_gt if c_gt is not None else _binarize(c, self.thrs)), c

    def forward_train(self, img1, img2, c_gt=None,
                      generator: Optional[torch.Generator] = None):
        """Two-view training (models2.py:304-336) -> (dc1, dc2, c1, c2,
        loss_kl, loss_err). The draws, in order: each view's density
        dropout, then each view's classifier dropout."""
        y_cat1, x3_1 = self.forward_fe(img1)
        y_cat2, x3_2 = self.forward_fe(img2)
        y_den1, y_den2 = self.den_dec(y_cat1), self.den_dec(y_cat2)
        y_in1 = instance_norm(y_den1.float())
        y_in2 = instance_norm(y_den2.float())
        e_mask = ((y_in1 - y_in2).abs() < 0.5).to(y_den1.dtype).detach()
        # dropout before the mask here (models2.py:331-332), unlike DGModel
        y_m1 = dropout2d(y_den1, 0.5, generator) * e_mask
        y_m2 = dropout2d(y_den2, 0.5, generator) * e_mask
        loss_err = (y_in1 - y_in2).abs().mean()

        y_new1, logits1 = self.memory.with_logits(y_m1, self.mem[0])
        y_new2, logits2 = self.memory.with_logits(y_m2, self.mem[0])
        loss_kl = true_jsd(logits1, logits2)

        c1 = _run(self.cls_head, x3_1, generator)
        c2 = _run(self.cls_head, x3_2, generator)
        if c_gt is not None:
            c_new1 = c_new2 = c_gt
        else:
            c_new1, c_new2 = _binarize(c1, self.thrs), _binarize(c2, self.thrs)
        dc1 = _gate(self.den_head(y_new1), c_new1)
        dc2 = _gate(self.den_head(y_new2), c_new2)
        return dc1, dc2, c1, c2, loss_kl, loss_err
