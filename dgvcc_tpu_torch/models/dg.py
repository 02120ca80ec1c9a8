"""The DGModel family, counterpart of dgvcc_tpu/models/dg.py.

NCHW ``nn.Module``s whose state_dict keys are the reference DGVCC
layout (``models/models.py`` of Shimmer93/DGVCC), so a trained
reference ``.pth`` loads with a strict ``load_state_dict``:

  * ``enc1/enc2/enc3``: vgg16_bn ``features[:23] / [23:33] / [33:43]``
    with local indices (strides 4 / 8 / 16);
  * ``dec{3,2,1}.{0,1}``, ``den_dec.0``, ``den_head.0``,
    ``cls_head.{0,2}``: ``ConvBlock``s (``.conv`` / ``.bn``);
  * ``mem``: the prototype bank, shape (1, K, S).

Convolutions run in the model ``dtype``; batch norm, the softmax and
the bank's products accumulate in float32, as in the JAX package.
``forward`` is the single-view forward (eval, or train mode for the
one-view training modes); ``forward_train`` the two-view consistency
forward of ``memadd`` / ``final``. Dropout draws from the
``torch.Generator`` a forward is given, never from torch's global RNG.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import (ConvBlock, Dropout2d, dropout2d,
                                       instance_norm, upsample)
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGGFeatures, feature_layout
from dgvcc_tpu_torch.ops.mem_attention import memory_attention_fused
from dgvcc_tpu_torch.ops.mem_attention_train import (
    memory_attention_train, memory_attention_train_reference)
from dgvcc_tpu_torch.parallel.tp import consistency_tp, memory_attention_tp


class MemoryBank(nn.Module):
    """Attention over the prototype bank. It holds no parameter: the bank
    is the model's ``mem`` (reference key layout).

    ``forward`` (one view). ``fused``: the serving kernel
    (``ops/mem_attention.py``): float32 logits and online softmax, the
    attention rounded to the compute dtype before the second product, as
    the einsum path rounds it. That kernel has no backward, so with
    ``fused`` a forward that needs gradients raises; off, ``forward``
    takes the einsum path, as the JAX model's training forward does
    (``create_train_state`` turns ``fused`` off). The einsum path: float32
    logits and softmax, the attention cast to the compute dtype before the
    second product.

    ``pair`` (two views, training). ``fused_train``: True = the training
    kernels (``ops/mem_attention_train.py``) on CUDA tensors and their
    plain version on the CPU; False = the plain version everywhere.

    ``tp_group`` (``parallel/tp.py::shard_model_bank``, under ``mesh: {data:
    N, model: M}``): the bank given is this rank's columns, and ``forward``
    and ``pair`` normalise over the group's whole bank
    (``memory_attention_tp``); ``pair`` then takes each view's attention and
    the consistency summed over the group, as the JAX model under
    ``tp_axis`` does (its dg.py:376-383, :400-404): the training kernels do
    not run there.
    """

    tp_group = None

    def __init__(self, mem_dim: int, fused: bool = True, fused_train: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mem_dim = mem_dim
        self.fused = fused
        self.fused_train = fused_train
        self.dtype = dtype

    def _check(self, k):
        if k != self.mem_dim:
            raise ValueError(f"MemoryBank mem_dim={self.mem_dim} but input "
                             f"has {k} channels")

    def forward(self, y: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        """y: (B, K, H, W); mem: (K, S) -> (B, K, H, W)."""
        b, k, h, w = y.shape
        self._check(k)
        mem = mem.to(self.dtype)
        # a channels-last y makes this permute a free view
        y_flat = y.permute(0, 2, 3, 1).reshape(b, h * w, k)
        if self.tp_group is not None:
            y_new, _ = memory_attention_tp(y_flat, mem, self.tp_group, self.dtype)
        elif self.fused:
            if torch.is_grad_enabled() and (y.requires_grad or mem.requires_grad):
                raise RuntimeError(
                    "MemoryBank: the serving kernel (fused_mem=True) has no backward; "
                    "train through create_train_state, or build the model with "
                    "fused_mem=False")
            y_new = memory_attention_fused(y_flat, mem)
        else:
            y_new, _ = self._einsum(y_flat, mem)
        return y_new.reshape(b, h, w, k).permute(0, 3, 1, 2)

    def _einsum(self, y_flat, mem):
        logits = torch.matmul(y_flat.float(), mem.float()) / math.sqrt(y_flat.shape[-1])
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        return torch.matmul(attn.float(), mem.float().t()).to(y_flat.dtype), logits

    def with_logits(self, y: torch.Tensor, mem: torch.Tensor):
        """The einsum path, whatever ``fused`` says, and its float32 logits:
        y (B, K, H, W), mem (K, S) -> (y_new (B, K, H, W), logits (B, H*W, S))."""
        b, k, h, w = y.shape
        self._check(k)
        y_new, logits = self._einsum(y.permute(0, 2, 3, 1).reshape(b, h * w, k),
                                     mem.to(self.dtype))
        return y_new.reshape(b, h, w, k).permute(0, 3, 1, 2), logits

    def pair(self, y1: torch.Tensor, y2: torch.Tensor, mem: torch.Tensor):
        """Two-view training attention and its consistency loss in one op:
        y1, y2 (B, K, H, W), mem (K, S) -> (y_new1, y_new2, loss_con) with
        loss_con = mean((softmax(l1) - softmax(l2)) ** 2)."""
        b, k, h, w = y1.shape
        self._check(k)
        mem = mem.to(self.dtype)
        flat = [y.permute(0, 2, 3, 1).reshape(b, h * w, k) for y in (y1, y2)]
        if self.tp_group is not None:
            (o1, p1), (o2, p2) = (memory_attention_tp(f, mem, self.tp_group, self.dtype)
                                  for f in flat)
            size = mem.shape[-1] * torch.distributed.get_world_size(self.tp_group)
            return (o1.reshape(b, h, w, k).permute(0, 3, 1, 2),
                    o2.reshape(b, h, w, k).permute(0, 3, 1, 2),
                    consistency_tp(p1, p2, size, self.tp_group))
        fn = (memory_attention_train if self.fused_train
              else memory_attention_train_reference)
        o1, o2, con = fn(flat[0], flat[1], mem)
        return (o1.reshape(b, h, w, k).permute(0, 3, 1, 2),
                o2.reshape(b, h, w, k).permute(0, 3, 1, 2), con)


@contextlib.contextmanager
def _restoring_buffers(module: nn.Module):
    """Put ``module``'s buffers back as they were on exit, however the
    block ends (checkpoint stops a recompute early by raising)."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(module.buffers(), saved):
                b.copy_(v)


def _remat_stage(stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``torch.utils.checkpoint`` of an encoder stage. The backward runs
    the stage again to rebuild its activations; that run restores the BN
    running statistics it moves, so they are updated once per forward, as
    under the JAX model's functional ``nn.remat``."""
    return checkpoint(stage, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _restoring_buffers(stage)))


def _run(seq: nn.Sequential, x, generator):
    """A Sequential whose Dropout2d layers draw from ``generator``."""
    for m in seq:
        x = m(x, generator) if isinstance(m, Dropout2d) else m(x)
    return x


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
    attention to the compute dtype. The kernel has no backward:
    ``create_train_state`` turns it off.

    ``den_dec`` holds the JAX model's ``_den_features`` (the 1x1 block and,
    for base/mem/cls/memcls, its Dropout2d); ``cls_head`` is the reference
    Sequential (block, Dropout2d, block, Sigmoid).

    Parallelism, switched at build time: ``parallel/tp.py::shard_model_bank``
    shards the bank over a model group (``mesh: {data: N, model: M}``);
    ``parallel/spatial.py::shard_height`` makes each rank compute the
    one-process result on its rows of the crop (``mesh: {spatial: N}``:
    ``spatial_group``, read by the bilinear upsamples and the instance norm
    here, by the convolutions and batch norms in ``nn/layers.py``).

    Training knobs, as in the JAX model: ``err_thrs`` and ``has_err_loss``
    (the instance-norm error mask and its loss), ``fused_mem_train`` (the
    bank's ``pair``), ``batched_two_view`` (both views as one 2B batch
    through encoder, decoder and heads: batch-norm statistics over the
    union of the views) and ``remat`` (``torch.utils.checkpoint`` of the
    three encoder stages in training).
    """

    # mesh: {spatial: N}: a rank's rows pool to whole rows through the
    # encoder's four pools (parallel/spatial.py)
    row_rule = 16

    def __init__(self, use_mem: bool = False, use_cls: bool = False,
                 mem_size: int = 1024, mem_dim: int = 256,
                 den_dropout: float = 0.5, cls_dropout: float = 0.5,
                 cls_thrs: float = 0.5, err_thrs: float = 0.5,
                 has_err_loss: bool = False, den_dec_dropout: bool = True,
                 fused_mem: bool = True, fused_mem_train: bool = True,
                 batched_two_view: bool = False, remat: bool = False,
                 vgg_cfg: Any = None,
                 stage_splits: Any = (0, 23, 33, 43),
                 dec_widths: Any = ((1024, 512), (512, 256), (256, 128)),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_mem, self.use_cls = use_mem, use_cls
        self.spatial_group = None
        self.cls_thrs, self.err_thrs = cls_thrs, err_thrs
        self.has_err_loss = has_err_loss
        self.den_dropout = den_dropout
        self.batched_two_view, self.remat = batched_two_view, remat

        cfg = tuple(VGG16_CFG if vgg_cfg is None else vgg_cfg)
        self.vgg_cfg, self.stage_splits = cfg, tuple(stage_splits)
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
            den_dec.append(Dropout2d(den_dropout))
        self.den_dec = nn.Sequential(*den_dec)
        self.den_head = nn.Sequential(block(den_ch, 1, kernel_size=1, padding=0))

        if use_mem:
            self.mem = nn.Parameter(torch.empty(1, mem_dim, mem_size))
            self.memory = MemoryBank(mem_dim, fused=fused_mem,
                                     fused_train=fused_mem_train, dtype=dtype)
        if use_cls:
            self.cls_head = nn.Sequential(
                block(c3, w2b, bn=True), Dropout2d(cls_dropout),
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

    def _stage(self, stage, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return _remat_stage(stage, x)
        return stage(x)

    def forward_fe(self, x):
        """Encoder + decoder -> (multi-scale concat at stride 4, stride-16
        features). y_cat = [dec1, up2(dec2), up4(dec3)]."""
        g = self.spatial_group
        x1 = self._stage(self.enc1, x)
        x2 = self._stage(self.enc2, x1)
        x3 = self._stage(self.enc3, x2)
        y3 = self.dec3(x3)
        y2 = self.dec2(torch.cat([upsample(y3, 2, group=g), x2], dim=1))
        y2_up = upsample(y2, 2, group=g)
        y1 = self.dec1(torch.cat([y2_up, x1], dim=1))
        y_cat = torch.cat([y1, y2_up, upsample(y3, 4, group=g)], dim=1)
        return y_cat, x3

    def transform_cls_map_gt(self, c_gt):
        return upsample(c_gt, 4, mode="nearest")

    def transform_cls_map_pred(self, c):
        c_bin = (c >= self.cls_thrs).to(c.dtype)
        return upsample(c_bin, 4, mode="nearest")

    # ---- inference forward -----------------------------------------------

    def forward(self, x, c_gt=None, generator: Optional[torch.Generator] = None):
        """Single-view forward. Returns the density map (B, 1, H, W), and
        with a classifier also the cls map at stride 16. In training mode
        dropout draws from ``generator``."""
        y_cat, x3 = self.forward_fe(x)
        y_den = _run(self.den_dec, y_cat, generator)
        if self.use_mem:
            y_den = self.memory(y_den, self.mem[0])
        d = self.den_head(y_den)
        if self.use_cls:
            c = _run(self.cls_head, x3, generator)
            c_resized = (self.transform_cls_map_gt(c_gt) if c_gt is not None
                         else self.transform_cls_map_pred(c))
            return upsample(d * c_resized, 4, group=self.spatial_group), c
        return upsample(d, 4, group=self.spatial_group)

    # ---- two-view training forward ----------------------------------------

    def forward_train(self, img1, img2, c_gt=None,
                      generator: Optional[torch.Generator] = None):
        """Two-view consistency training (reference models.py:160-184,
        298-335). Without a classifier (memadd) returns (d1, d2, loss_con);
        with one (final) (dc1, dc2, c1, c2, c_err, loss_con, loss_err).
        ``c_gt``: the foreground map at stride 16 (B, 1, h, w); dropout
        draws from ``generator``."""
        if self.batched_two_view:
            y_cat_b, x3_b = self.forward_fe(torch.cat([img1, img2], dim=0))
            y_den1, y_den2 = _run(self.den_dec, y_cat_b, generator).chunk(2, dim=0)
        else:
            y_cat1, x3_1 = self.forward_fe(img1)
            y_cat2, x3_2 = self.forward_fe(img2)
            y_den1 = _run(self.den_dec, y_cat1, generator)
            y_den2 = _run(self.den_dec, y_cat2, generator)

        g = self.spatial_group
        y_in1 = instance_norm(y_den1.float(), group=g)
        y_in2 = instance_norm(y_den2.float(), group=g)
        with torch.no_grad():
            e_mask = ((y_in1 - y_in2).abs() < self.err_thrs).to(y_den1.dtype)
        loss_err = ((y_in1 - y_in2).abs().mean() if self.has_err_loss
                    else torch.zeros((), device=y_in1.device))
        y_m1 = dropout2d(y_den1 * e_mask, self.den_dropout, generator)
        y_m2 = dropout2d(y_den2 * e_mask, self.den_dropout, generator)

        # the bank has no batch statistics: the paired op gives the batched
        # einsum path's values under batched_two_view as well
        y_new1, y_new2, loss_con = self.memory.pair(y_m1, y_m2, self.mem[0])
        if self.batched_two_view:
            d1, d2 = self.den_head(torch.cat([y_new1, y_new2], dim=0)).chunk(2, dim=0)
        else:
            d1, d2 = self.den_head(y_new1), self.den_head(y_new2)

        if not self.use_cls:
            return upsample(d1, 4, group=g), upsample(d2, 4, group=g), loss_con

        if self.batched_two_view:  # cls_head has BN: union statistics
            c1, c2 = _run(self.cls_head, x3_b, generator).chunk(2, dim=0)
        else:
            c1 = _run(self.cls_head, x3_1, generator)
            c2 = _run(self.cls_head, x3_2, generator)
        c_err = (self.transform_cls_map_pred(c1) - self.transform_cls_map_pred(c2)).abs()
        c_resized = torch.clamp(self.transform_cls_map_gt(c_gt) + c_err, 0.0, 1.0)
        dc1 = upsample(d1 * c_resized, 4, group=g)
        dc2 = upsample(d2 * c_resized, 4, group=g)
        return dc1, dc2, c1, c2, upsample(c_err, 4, group=g), loss_con, loss_err


# the model params of the reference YAML configs; `pretrained` (a
# weight-loading flag, read by the trainer) is not taken, nor `tp_axis`: the
# bank shards by `mesh: {data: N, model: M}` (parallel/tp.py), and the
# trainer refuses the key as the JAX trainer does
_PARAM_NAMES = ("mem_size", "mem_dim", "den_dropout", "cls_dropout",
                "cls_thrs", "err_thrs", "has_err_loss", "fused_mem",
                "fused_mem_train", "batched_two_view", "remat", "vgg_cfg",
                "stage_splits", "dec_widths", "dtype")


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
