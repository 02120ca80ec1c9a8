"""CCTrans: the Twins-ALTGVT pyramid transformer with a multi-scale
regression head (reference models/baselines/CCTrans.py), counterpart of
dgvcc_tpu/models/baselines/cctrans.py. Output: the density at stride 8.

Four stages, each a strided patch embedding (conv + LayerNorm) and blocks
that alternate window attention (LSA, ``GroupAttention``, window ``ws``)
and global sub-sampled attention (GSA, ``GlobalAttention``, keys and values
from an ``sr``-strided conv + LayerNorm): an odd block's ws is 1, which
means global attention. A depthwise 3x3 conv after each stage's first block
is the position encoding (``PosCNN``). The head (``Regression``) fuses
stages 2-4 at stride 8 (align_corners=True bilinear), runs a dilated conv
pyramid and a ReLU.

As the JAX model: the default geometry is alt_gvt_large's (dims
128/256/512/1024, depths 2/2/18/2, ws 8, sr 8/4/2/1), the head's widths;
window attention pads H, W to multiples of ws and masks the padded keys
with -1e30; the strided convs pad as flax's 'SAME' (``conv_same``); the
attention logits and softmax are float32, the attention
cast to the compute dtype before its product with v. The GELU is exact;
the LayerNorms of the patch embedding and of GSA's kv take flax's default
epsilon 1e-6 (not torch's 1e-5), norm1 / norm2 set 1e-6.

Keys: the reference's, which ``altgvt_to_flax`` / ``cctrans_checkpoint_to_flax``
read: ``patch_embeds.{k}.{proj,norm}``, ``pos_block.{k}.proj.0``,
``blocks.{k}.{i}.{norm1,attn.*,norm2,mlp.fc1,mlp.fc2}``,
``regression.{v1,stage1-4}.{0,1}``, ``regression.{v2,v3}.{1,2}`` (an
upsample at 0), ``regression.res.{0,1,3}``."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, he_normal_, resize_bilinear_ac

MASKED = -1e30


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A strided conv with flax's default 'SAME' padding (ceil(n / stride)
    outputs, the zeros split low / high), as the JAX model's patch
    embeddings and sr convs have: on a side the stride does not divide, the
    reference's padding-free conv would drop the rest."""
    k, s = conv.kernel_size[0], conv.stride[0]
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: W, then H
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads) if any(pads) else x)


def _attend(q, k, v, scale, valid=None):
    """softmax(q k^T * scale) v with float32 logits and softmax; ``valid``
    (broadcastable booleans over the keys) masks the others."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if valid is not None:
        logits = logits.masked_fill(~valid, MASKED)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class GroupAttention(nn.Module):
    """Window self-attention over (B, H, W, C) tokens."""

    def __init__(self, dim, num_heads, ws, dtype):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, nh, hd = self.ws, self.num_heads, c // self.num_heads
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hg, wg = (h + ph) // ws, (w + pw) // ws
        qkv = self.qkv(x).reshape(b, hg, ws, wg, ws, 3, nh, hd)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, hg * wg, nh, ws * ws, hd)
        valid = None
        if ph or pw:
            valid = F.pad(torch.ones(h, w, dtype=torch.bool, device=x.device), (0, pw, 0, ph))
            valid = valid.reshape(hg, ws, wg, ws).permute(0, 2, 1, 3).reshape(
                1, hg * wg, 1, 1, ws * ws)
        out = _attend(qkv[0], qkv[1], qkv[2], hd ** -0.5, valid)
        out = out.reshape(b, hg, wg, nh, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
        out = out.reshape(b, h + ph, w + pw, c)[:, :h, :w]
        return self.proj(out)


class GlobalAttention(nn.Module):
    """Global sub-sampled attention: keys and values from an sr-strided conv."""

    def __init__(self, dim, num_heads, sr_ratio, dtype):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, dtype=dtype)
            self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        q = self.q(x).reshape(b, h * w, nh, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(conv_same(self.sr, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        m = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).reshape(b, m, 2, nh, hd).permute(2, 0, 3, 1, 4)
        out = _attend(q, kv[0], kv[1], hd ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class GroupBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, ws, sr_ratio, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalAttention(dim, num_heads, sr_ratio, dtype) if ws == 1
                     else GroupAttention(dim, num_heads, ws, dtype))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PosCNN(nn.Module):
    """PEG: a depthwise 3x3 conv plus the input."""

    def __init__(self, dim, dtype):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype))

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    """NCHW image or features -> (B, H/p, W/p, dim) tokens."""

    def __init__(self, cin, dim, patch, dtype):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, stride=patch, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        return self.norm(conv_same(self.proj, x).permute(0, 2, 3, 1))


def _cbr(cin, cout, k, dil, dtype, upsampled=False):
    """[placeholder for the reference's upsample,] conv, BN, ReLU."""
    layers = [nn.Identity()] if upsampled else []
    layers += [Conv2d(cin, cout, k, padding=dil * (k // 2), dilation=dil, dtype=dtype),
               nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


class Regression(nn.Module):
    """Stages 2-4 (strides 8/16/32) fused at stride 8, a dilated pyramid,
    a 1-channel ReLU density (CCTrans.py:12-86)."""

    def __init__(self, dims, dtype):
        super().__init__()
        self.v1 = _cbr(dims[0], 256, 3, 1, dtype)
        self.v2 = _cbr(dims[1], 256, 3, 1, dtype, upsampled=True)
        self.v3 = _cbr(dims[2], 256, 3, 1, dtype, upsampled=True)
        self.stage1 = _cbr(256, 128, 3, 1, dtype)
        self.stage2 = _cbr(256, 128, 3, 2, dtype)
        self.stage3 = _cbr(256, 128, 3, 3, dtype)
        self.stage4 = _cbr(256, 384, 1, 1, dtype)
        self.res = nn.Sequential(*_cbr(384, 64, 3, 1, dtype), Conv2d(64, 1, 1, dtype=dtype),
                                 nn.ReLU())

    def forward(self, x1, x2, x3):
        hw = x1.shape[2:]
        x = (self.v1(x1) + self.v2(resize_bilinear_ac(x2, hw))
             + self.v3(resize_bilinear_ac(x3, hw)))
        y = torch.cat([self.stage1(x), self.stage2(x), self.stage3(x)], dim=1) + self.stage4(x)
        return self.res(y)


class ALTGVT(nn.Module):
    flax_layout = "cctrans"

    def __init__(self, embed_dims: Sequence[int] = (128, 256, 512, 1024),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4),
                 depths: Sequence[int] = (2, 2, 18, 2), wss: Sequence[int] = (8, 8, 8, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), pretrained: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # the geometry the int8 graph reads (nn/quant_cctrans.py)
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.wss, self.sr_ratios = tuple(wss), tuple(sr_ratios)
        cin = 3
        self.patch_embeds = nn.ModuleList()
        self.pos_block = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for k, dim in enumerate(embed_dims):
            self.patch_embeds.append(PatchEmbed(cin, dim, 4 if k == 0 else 2, dtype))
            self.pos_block.append(PosCNN(dim, dtype))
            self.blocks.append(nn.ModuleList(
                GroupBlock(dim, num_heads[k], mlp_ratios[k], 1 if i % 2 else wss[k],
                           sr_ratios[k], dtype) for i in range(depths[k])))
            cin = dim
        self.regression = Regression(tuple(embed_dims[1:]), dtype)
        self.reset_parameters()

    def forward(self, x, generator=None):
        """``generator``: the dropout stream of the trainer's steps (no dropout here)."""
        outs = []
        for k, blocks in enumerate(self.blocks):
            x = self.patch_embeds[k](x)
            for i, blk in enumerate(blocks):
                x = blk(x)
                if i == 0:
                    x = self.pos_block[k](x)
            outs.append(x.permute(0, 3, 1, 2))
            x = outs[-1]
        return self.regression(*outs[1:])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self, generator)


def _cctrans(**params):
    known = {"embed_dims", "num_heads", "mlp_ratios", "depths", "wss", "sr_ratios",
             "pretrained", "dtype"}
    return ALTGVT(**{k: v for k, v in params.items() if k in known})


MODELS.register("cctrans", _cctrans)
