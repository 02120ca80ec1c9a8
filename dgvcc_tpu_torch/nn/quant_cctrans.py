"""Int8 PTQ graph of CCTrans (Twins-ALTGVT), counterpart of
dgvcc_tpu/nn/quant_cctrans.py.

A pyramid vision transformer spends its operations in its Dense layers
(qkv / q / kv / proj and the 4x MLPs). Each acts on an NHWC tensor, so each
is a 1x1 convolution: the whole model runs on ``nn/quant.py``'s site
primitive, int8 weights per output channel and one activation scale a
site, through the hand-written int8 convolution (``ops/qconv.py``). The
strided sites (the patch embeddings ``pe{k}``, 4x4 / 2x2 at their own
stride, and GSA's ``{pre}_sr``, sr x sr at stride sr) pad as flax's 'SAME'.

What stays in the serving dtype, as in the JAX graph: the LayerNorms (their
parameters under ``__extras__``; flax's fast variance E[x^2] - E[x]^2 in
float32, eps 1e-6), the attention logits and softmax (float32, the
attention cast before its product with v; window attention zero-pads x
before its qkv site and masks the padded keys with -1e30), the exact GELU,
the depthwise PEG (one input channel a group: below any ``min_ch``) and the
head's thin tail, whose ``reg_res2`` is an fp site of the family.

Site names: ``pe{k}``, ``b{k}_{i}_{qkv|q|kv|sr|proj|fc1|fc2}``, ``pos{k}``,
``reg_{v1..v3, stage1..stage4, res1, res2}`` (the head's convolutions with
their batch norms folded).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from dgvcc_tpu_torch.nn.layers import resize_bilinear_ac

MASKED = -1e30
# the head's conv + BN + ReLU blocks, and where the conv sits in each
# Sequential (v2 and v3 lead with the reference's upsample placeholder)
_REG = {"v1": 0, "v2": 1, "v3": 1, "stage1": 0, "stage2": 0, "stage3": 0, "stage4": 0}


def _t(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _dense_site(linear) -> Dict[str, np.ndarray]:
    """A Dense on NHWC is a 1x1 convolution: (Cout, Cin) -> (1, 1, Cin, Cout)."""
    k = _t(linear.weight).T
    b = np.zeros(k.shape[-1], np.float32) if linear.bias is None else _t(linear.bias)
    return {"kernel": np.ascontiguousarray(k[None, None]), "bias": b}


def _ln_params(ln) -> Dict[str, np.ndarray]:
    return {"scale": _t(ln.weight), "bias": _t(ln.bias)}


def cctrans_fold(model) -> Dict:
    """Every site of a port ``ALTGVT`` folded into {name: kernel, bias}, the
    LayerNorms' parameters under ``__extras__``, named as the JAX package
    names them."""
    from dgvcc_tpu_torch.nn.quant import conv_site

    folded: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    for k, blocks in enumerate(model.blocks):
        pe = model.patch_embeds[k]
        folded[f"pe{k}"] = conv_site(pe.proj)
        extras[f"pe{k}_norm"] = _ln_params(pe.norm)
        for i, blk in enumerate(blocks):
            pre = f"b{k}_{i}"
            extras[f"{pre}_norm1"] = _ln_params(blk.norm1)
            extras[f"{pre}_norm2"] = _ln_params(blk.norm2)
            for dn in ("qkv", "q", "kv", "proj"):
                if hasattr(blk.attn, dn):
                    folded[f"{pre}_{dn}"] = _dense_site(getattr(blk.attn, dn))
            if hasattr(blk.attn, "sr"):
                folded[f"{pre}_sr"] = conv_site(blk.attn.sr)
                extras[f"{pre}_srnorm"] = _ln_params(blk.attn.norm)
            folded[f"{pre}_fc1"] = _dense_site(blk.mlp.fc1)
            folded[f"{pre}_fc2"] = _dense_site(blk.mlp.fc2)
        folded[f"pos{k}"] = conv_site(model.pos_block[k].proj[0])
    reg = model.regression
    for name, at in _REG.items():
        block = getattr(reg, name)
        folded[f"reg_{name}"] = conv_site(block[at], block[at + 1])
    folded["reg_res1"] = conv_site(reg.res[0], reg.res[1])
    folded["reg_res2"] = conv_site(reg.res[3])
    folded["__extras__"] = extras
    return folded


def _ln(x, prm, eps=1e-6):
    """flax's LayerNorm at eval: float32, the fast variance E[x^2] - E[x]^2."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * prm["scale"] + prm["bias"]).to(x.dtype)


def _softmax_attend(q, k, v, hd, valid=None):
    """softmax(q k^T / sqrt(hd)) v: float32 logits and softmax, the
    attention cast to v's dtype before its product with v."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    if valid is not None:
        attn = attn.masked_fill(~valid, MASKED)
    return torch.matmul(torch.softmax(attn, dim=-1).to(v.dtype), v)


def _group_attn(qconv, x, pre, heads, ws):
    """LSA: window attention over ws x ws windows, x zero-padded to whole
    windows before its qkv site and the padded keys masked."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    hg, wg = hp // ws, wp // ws
    hd = c // heads
    qkv = qconv(x, f"{pre}_qkv", relu=False)
    qkv = qkv.reshape(b, hg, ws, wg, ws, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    qkv = qkv.reshape(3, b, hg * wg, heads, ws * ws, hd)
    valid = None
    if ph or pw:
        valid = F.pad(torch.ones(h, w, dtype=torch.bool, device=x.device), (0, pw, 0, ph))
        valid = valid.reshape(hg, ws, wg, ws).permute(0, 2, 1, 3).reshape(1, hg * wg, 1, 1,
                                                                          ws * ws)
    out = _softmax_attend(qkv[0], qkv[1], qkv[2], hd, valid)
    out = out.reshape(b, hg, wg, heads, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return qconv(out.reshape(b, hp, wp, c)[:, :h, :w], f"{pre}_proj", relu=False)


def _global_attn(qconv, x, extras, pre, heads, sr):
    """GSA: keys and values from an sr x sr convolution at stride sr."""
    b, h, w, c = x.shape
    hd = c // heads
    q = qconv(x, f"{pre}_q", relu=False).reshape(b, h * w, heads, hd).transpose(1, 2)
    kv_in = x
    if sr > 1:
        kv_in = _ln(qconv(x, f"{pre}_sr", relu=False, stride=sr), extras[f"{pre}_srnorm"])
    m = kv_in.shape[1] * kv_in.shape[2]
    kv = qconv(kv_in, f"{pre}_kv", relu=False).reshape(b, m, 2, heads, hd).permute(2, 0, 3, 1, 4)
    out = _softmax_attend(q, kv[0], kv[1], hd)
    return qconv(out.transpose(1, 2).reshape(b, h, w, c), f"{pre}_proj", relu=False)


def cctrans_forward(qconv, x, extras, depths, heads, wss, sr_ratios):
    """The eval graph of ``models/baselines/cctrans.py::ALTGVT`` on the site
    primitive: NHWC frames -> the density (B, H/8, W/8, 1)."""
    outputs = []
    for k in range(len(depths)):
        x = qconv(x, f"pe{k}", relu=False, stride=4 if k == 0 else 2)
        x = _ln(x, extras[f"pe{k}_norm"])
        for i in range(depths[k]):
            pre = f"b{k}_{i}"
            ws = 1 if i % 2 == 1 else wss[k]
            y = _ln(x, extras[f"{pre}_norm1"])
            if ws == 1:
                y = _global_attn(qconv, y, extras, pre, heads[k], sr_ratios[k])
            else:
                y = _group_attn(qconv, y, pre, heads[k], ws)
            x = x + y
            y = qconv(_ln(x, extras[f"{pre}_norm2"]), f"{pre}_fc1", relu=False)
            x = x + qconv(F.gelu(y), f"{pre}_fc2", relu=False)
            if i == 0:  # the PEG after each stage's first block
                x = x + qconv(x, f"pos{k}", relu=False, padding=((1, 1), (1, 1)),
                              groups=x.shape[-1])
        outputs.append(x)
    x1, x2, x3 = outputs[1:4]
    hw = tuple(x1.shape[1:3])

    def cbr(t, name, k, dil):
        p = dil * (k // 2)
        return qconv(t, f"reg_{name}", relu=True, padding=((p, p), (p, p)), dilation=dil)

    def up(t):
        return resize_bilinear_ac(t.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)

    x = cbr(x1, "v1", 3, 1) + cbr(up(x2), "v2", 3, 1) + cbr(up(x3), "v3", 3, 1)
    y = torch.cat([cbr(x, "stage1", 3, 1), cbr(x, "stage2", 3, 2), cbr(x, "stage3", 3, 3)],
                  dim=-1) + cbr(x, "stage4", 1, 1)
    return qconv(cbr(y, "res1", 3, 1), "reg_res2", relu=True)
