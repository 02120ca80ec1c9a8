"""Weights into the port: from the JAX package's variables, or from a
reference DGVCC ``.pth``.

``dg_state_dict_from_flax`` is the inverse of the JAX package's
reference-checkpoint reader (``dgvcc_tpu/nn/torch_io.py``,
``dg_checkpoint_to_flax``). It takes plain nested dicts of numpy arrays,
so this module needs neither JAX nor flax:

  * flax conv kernel (kh, kw, in, out) -> torch weight (out, in, kh, kw);
  * ``Conv_0`` / ``BatchNorm_0`` (scale, bias | mean, var) ->
    ``.conv`` / ``.bn`` (weight, bias, running_mean, running_var);
  * ``enc*/conv{i}``, ``enc*/bn{i}`` -> ``enc*.{i - lo}`` (local index of
    the stage that starts at torchvision index ``lo``);
  * ``dec3_0`` -> ``dec3.0``; ``den_dec`` -> ``den_dec.0``; ``den_head``
    -> ``den_head.0``; ``cls_conv1`` / ``cls_conv2`` -> ``cls_head.0`` /
    ``cls_head.2``;
  * ``memory/mem`` (K, S) -> ``mem`` (1, K, S).

``install_pretrained`` puts a torchvision ``vgg16_bn`` state_dict into a
DGModel's ``enc1/enc2/enc3`` (the JAX package's
``nn/torch_io.py::load_pretrained_backbone`` for the DG family).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, feature_layout

_BLOCKS = {"den_dec": "den_dec.0", "den_head": "den_head.0",
           "cls_conv1": "cls_head.0", "cls_conv2": "cls_head.2"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if s is None:
        return
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def dg_state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping],
                            stage_splits=(0, 23, 33, 43)) -> Dict[str, torch.Tensor]:
    """JAX DGModel variables -> the port's (reference-layout) state_dict.

    ``stage_splits``: the model's encoder splits, which re-base the
    torchvision feature indices of ``conv{i}`` / ``bn{i}`` to the local
    indices of each stage. With ``batch_stats=None``, ``params`` may be
    any tree of the params' layout, a gradient for one: the result then
    holds the parameters' keys only (no running statistics).
    """
    sd: Dict[str, torch.Tensor] = {}
    for enc, lo in zip(("enc1", "enc2", "enc3"), stage_splits[:3]):
        for name, p in params[enc].items():
            kind, idx = re.fullmatch(r"(conv|bn)(\d+)", name).groups()
            prefix = f"{enc}.{int(idx) - lo}"
            if kind == "conv":
                _conv(sd, prefix, p)
            else:
                _bn(sd, prefix, p, batch_stats and batch_stats[enc][name])
    for name, p in params.items():
        if name.startswith("enc") or name == "memory":
            continue
        m = re.fullmatch(r"(dec\d)_(\d+)", name)
        prefix = f"{m.group(1)}.{m.group(2)}" if m else _BLOCKS[name]
        _conv(sd, f"{prefix}.conv", p["Conv_0"])
        if "BatchNorm_0" in p:
            _bn(sd, f"{prefix}.bn", p["BatchNorm_0"],
                batch_stats and batch_stats[name]["BatchNorm_0"])
    if "memory" in params:
        sd["mem"] = _t(np.asarray(params["memory"]["mem"])[None])
    return sd


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference DGVCC (or port) ``.pth`` state_dict, on the CPU. The
    port's key layout is the reference's, so the result goes straight
    into ``DGModel.load_state_dict(..., strict=True)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


DG_FAMILY = ("base", "mem", "memadd", "cls", "memcls", "final")
# vgg16_bn features[:23] / [23:33] / [33:43] (reference models.py:36-38)
VGG16_BN_STAGES = (("enc1", 0, 23), ("enc2", 23, 33), ("enc3", 33, 43))


def vgg16_bn_to_dg(tv: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16_bn`` keys ``features.{i}.*`` -> the DGModel's
    ``enc{1,2,3}.{i - lo}.*``: conv weight and bias, BN weight, bias and
    running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    fields = {"conv": ("weight", "bias"),
              "bn": ("weight", "bias", "running_mean", "running_var")}
    for enc, lo, hi in VGG16_BN_STAGES:
        for kind, idx, _ in feature_layout(VGG16_CFG, True):
            if lo <= idx < hi and kind in fields:
                for f in fields[kind]:
                    sd[f"{enc}.{idx - lo}.{f}"] = tv[f"features.{idx}.{f}"].float()
    return sd


def install_pretrained(model: torch.nn.Module, model_name: str,
                       weights: Mapping[str, str]) -> str:
    """Install the pretrained backbone of ``weights`` ({name: .pth path})
    that ``model_name`` has a mapping for; returns what was installed, or
    "no pretrained mapping". A checkpoint of other widths raises."""
    if model_name in DG_FAMILY and "vgg16_bn" in weights:
        sd = vgg16_bn_to_dg(load_reference_pth(weights["vgg16_bn"]))
        unexpected = sorted(set(sd) - set(model.state_dict()))
        if unexpected:
            raise ValueError(f"{model_name}'s encoder is not vgg16_bn's layout: no "
                             f"{unexpected[:3]}")
        with torch.no_grad():
            model.load_state_dict(sd, strict=False)
        return "vgg16_bn → enc1/2/3"
    return "no pretrained mapping"
