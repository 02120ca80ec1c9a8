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

``regressor_state_dict_from_flax`` does the same for the U-Net regressors
(``models/regressors.py``): the inverse of the JAX package's
``regressor_m_checkpoint_to_flax`` for ``reg_mem`` (``fe/stage*`` ->
``stage*``, ``fe/dec3_0`` -> ``dec3.0``, ``den_head`` a direct block,
``cls_conv1`` / ``cls_conv2`` -> ``cls_head.0`` / ``.2``), and the same
convention for ``dgnet``, ``dgnet_cls`` and ``reg``, whose reference
layout the JAX package does not read (``cls_dec`` / ``cls_out`` ->
``cls_head.0`` / ``.2``; ``reg``'s ``den_head_blocks_k`` -> ``den_dec.{2k}``,
``den_out`` -> ``den_head``, ``cls_head_blocks_k`` -> ``cls_head.{2k}``,
``cls_out`` -> ``cls_head.6``).

``whitening_state_dict_from_flax`` does the same for the whitening
counters (``models/whitening.py``): the inverse of the JAX package's
``sw_counter_checkpoint_to_flax``, ``ibn_counter_checkpoint_to_flax``,
``isw_counter_checkpoint_to_flax`` and ``sw_vgg_checkpoint_to_flax``
(reference torch layout), and for the DenseNet counters the torchvision
names that ``densenet_to_flax`` reads. ``state_dict_from_flax`` picks the
converter by the model's layout.

``install_pretrained`` puts a torchvision state_dict into a model, as the
JAX package's ``nn/torch_io.py::load_pretrained_backbone`` does:
``vgg16_bn`` into a DGModel's ``enc1/enc2/enc3`` and a regressor's
``stage1/2/3``; ``resnet50`` into the
trunk of ``sw``, ``ibn`` and ``isw``, ``densenet121`` into the trunk of
the DenseNet counters (both non-strict: what has no site of the same
shape keeps its init), ``vgg19`` into ``sw_vgg``'s 16 convolutions.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGG19_CFG, feature_layout
from dgvcc_tpu_torch.nn.whitening import InstanceNorm, SwitchWhiten

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


def _stages(sd, params, batch_stats, names, stage_splits):
    """VGG stages ``conv{i}`` / ``bn{i}`` (torchvision indices) -> ``{stage}.{i - lo}``."""
    for stage, lo in zip(names, stage_splits[:3]):
        for name, p in params[stage].items():
            kind, idx = re.fullmatch(r"(conv|bn)(\d+)", name).groups()
            prefix = f"{stage}.{int(idx) - lo}"
            if kind == "conv":
                _conv(sd, prefix, p)
            else:
                _bn(sd, prefix, p, batch_stats and batch_stats[stage][name])


def _blocks(sd, params, batch_stats, torch_name):
    """Flax ConvBlocks (``Conv_0`` / ``BatchNorm_0``) -> ``.conv`` / ``.bn``
    under ``torch_name(flax name)``; the decoder's ``decN_j`` -> ``decN.j``."""
    for name, p in params.items():
        if not isinstance(p, Mapping) or "Conv_0" not in p:
            continue
        m = re.fullmatch(r"(dec\d)_(\d+)", name)
        prefix = f"{m.group(1)}.{m.group(2)}" if m else torch_name(name)
        _conv(sd, f"{prefix}.conv", p["Conv_0"])
        if "BatchNorm_0" in p:
            _bn(sd, f"{prefix}.bn", p["BatchNorm_0"],
                batch_stats and batch_stats[name]["BatchNorm_0"])


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
    _stages(sd, params, batch_stats, ("enc1", "enc2", "enc3"), stage_splits)
    _blocks(sd, params, batch_stats, _BLOCKS.__getitem__)
    if "memory" in params:
        sd["mem"] = _t(np.asarray(params["memory"]["mem"])[None])
    return sd


def _regressor_block(params: Mapping):
    """flax name of a regressor's head block -> its torch name."""
    cls_out = "cls_head.6" if "cls_head_blocks_0" in params else "cls_head.2"
    fixed = {"den_dec": "den_dec.0", "den_head": "den_head", "den_out": "den_head",
             "cls_conv1": "cls_head.0", "cls_conv2": "cls_head.2", "cls_dec": "cls_head.0",
             "cls_out": cls_out}

    def name(flax_name):
        m = re.fullmatch(r"(den|cls)_head_blocks_(\d+)", flax_name)
        if m:
            return f"{'den_dec' if m.group(1) == 'den' else 'cls_head'}.{2 * int(m.group(2))}"
        return fixed[flax_name]

    return name


def regressor_state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping],
                                   stage_splits=(0, 23, 33, 43)) -> Dict[str, torch.Tensor]:
    """JAX regressor variables (dgnet, dgnet_cls, reg, reg_mem) -> the port's
    state_dict (the models2 layout; ``batch_stats=None`` as in
    ``dg_state_dict_from_flax``)."""
    sd: Dict[str, torch.Tensor] = {}
    fe_stats = batch_stats and batch_stats["fe"]
    _stages(sd, params["fe"], fe_stats, ("stage1", "stage2", "stage3"), stage_splits)
    _blocks(sd, params["fe"], fe_stats, None)
    _blocks(sd, {k: v for k, v in params.items() if k != "fe"}, batch_stats,
            _regressor_block(params))
    if "memory" in params:
        sd["mem"] = _t(np.asarray(params["memory"]["mem"])[None])
    return sd


def _modules(tree: Mapping, prefix=()):
    """(module path, {leaf name: array}) of every module holding leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield prefix, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _modules(v, prefix + (k,))


def _put(sd, prefix: str, leaves: Mapping):
    """One module's flax leaves -> its torch entries: kernels transposed
    (conv HWIO -> OIHW, dense (in, out) -> (out, in)), BN scale / mean /
    var renamed, SwitchWhiten and IN leaves verbatim."""
    for name, a in leaves.items():
        a = np.asarray(a)
        if name == "kernel":
            sd[f"{prefix}.weight"] = _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        elif name == "scale":
            sd[f"{prefix}.weight"] = _t(a)
        elif name == "mean":
            sd[f"{prefix}.running_mean"] = _t(a)
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif name == "var":
            sd[f"{prefix}.running_var"] = _t(a)
        else:  # bias; SwitchWhiten's sw_*_weight, weight, running_mean / _cov
            sd[f"{prefix}.{name}"] = _t(a)


def _block_path(rest, leaves) -> str:
    """A residual block's flax module path -> its torch name."""
    head, sub = rest[0], rest[1:]
    if head in ("bn1", "bn2") and not sub and ("sw_mean_weight" in leaves
                                               or "running_cov" in leaves):
        return "sw" + head[-1]  # build_norm_layer's name of an SW site
    if head == "se":
        return "se.fc." + {"Dense_0": "0", "Dense_1": "2"}[sub[0]]
    head = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
            "post_in": "IN"}.get(head, head)
    return ".".join((head,) + tuple(sub))  # bn1.IN / bn1.BN of an IBN site


def _resnet_path(path, leaves, stem, stage) -> str:
    if len(path) == 1:
        return stem[path[0]]
    k, i = re.fullmatch(r"layer(\d+)_(\d+)", path[0]).groups()
    return f"{stage(int(k))}.{i}.{_block_path(path[1:], leaves)}"


def _head_path(name) -> str:
    return f"head.{2 * (int(name[-1]) - 1)}"


def _sw_vgg_index():
    """flax conv{pos} -> the torch index of that conv in vgg.features (SW
    at index + 1, relu at + 2, one index per pool)."""
    idx, ti = {}, 0
    for pos, v in enumerate(VGG19_CFG[:-1]):
        if v == "M":
            ti += 1
        else:
            idx[pos] = ti
            ti += 3
    return idx


def _flax_path_to_torch(layout: str, path, leaves) -> str:
    if layout == "sw_vgg":
        kind, pos = re.fullmatch(r"(conv|sw|reg)(\d+)", path[0]).groups()
        if kind == "reg":
            return f"vgg.reg_layer.{2 * (int(pos) - 1)}"
        return f"vgg.features.{_sw_vgg_index()[int(pos)] + (kind == 'sw')}"
    if layout == "isw":
        path = path[1:]  # everything is under 'net'
    if path[0] == "head":
        return _head_path(path[1])
    trunk = path[1:]
    if layout == "densenet":
        m = re.fullmatch(r"(denseblock\d+)_(denselayer\d+)_(\w+)", trunk[0]) \
            or re.fullmatch(r"(transition\d+)_(\w+)", trunk[0])
        return ".".join(("backbone",) + (m.groups() if m else (trunk[0],)) + tuple(trunk[1:]))
    if layout == "isw":
        return _resnet_path(trunk, leaves, {"conv1": "layer0.0", "bn1": "layer0.1"},
                            lambda k: f"layer{k}")
    return _resnet_path(trunk, leaves, {"conv1": "backbone.0", "bn1": "backbone.1"},
                        lambda k: f"backbone.{3 + k}")


def whitening_state_dict_from_flax(layout: str, params: Mapping,
                                   batch_stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """JAX whitening-counter variables -> the port's state_dict.

    ``layout``: 'resnet' (sw, ibn), 'isw', 'sw_vgg' or 'densenet' (the
    models' ``flax_layout``). With ``batch_stats=None``, ``params`` may be
    any tree of the params' layout (a gradient): the result then holds the
    parameters' keys only."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaves in _modules(tree):
            _put(sd, _flax_path_to_torch(layout, path, leaves), leaves)
    return sd


def state_dict_from_flax(model: torch.nn.Module, params: Mapping,
                         batch_stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """JAX variables of ``model``'s family -> its state_dict."""
    layout = getattr(model, "flax_layout", None)
    splits = getattr(model, "stage_splits", (0, 23, 33, 43))
    if layout is None:
        return dg_state_dict_from_flax(params, batch_stats, splits)
    if layout == "regressor":
        return regressor_state_dict_from_flax(params, batch_stats, splits)
    return whitening_state_dict_from_flax(layout, params, batch_stats)


def drop_reference_unused(sd: Dict[str, torch.Tensor], model: torch.nn.Module):
    """``sd`` without the reference checkpoint's keys that ``model``'s
    forward never reads (isw: the unused ``layer4`` and ``fc``)."""
    unused = getattr(model, "reference_unused", ())
    return {k: v for k, v in sd.items() if not k.startswith(unused)} if unused else sd


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference DGVCC (or port) ``.pth`` state_dict, on the CPU. The
    port's key layout is the reference's, so the result goes straight
    into ``DGModel.load_state_dict(..., strict=True)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


DG_FAMILY = ("base", "mem", "memadd", "cls", "memcls", "final")
UNET_FAMILY = ("dgnet", "dgnet_cls", "reg", "reg_mem")
# vgg16_bn features[:23] / [23:33] / [33:43] (reference models.py:36-38)
VGG16_BN_STAGES = ((0, 23), (23, 33), (33, 43))


def vgg16_bn_to_dg(tv: Mapping[str, torch.Tensor],
                   stages=("enc1", "enc2", "enc3")) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16_bn`` keys ``features.{i}.*`` -> the DGModel's
    ``enc{1,2,3}.{i - lo}.*`` (a regressor's: ``stage{1,2,3}``): conv weight
    and bias, BN weight, bias and running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    fields = {"conv": ("weight", "bias"),
              "bn": ("weight", "bias", "running_mean", "running_var")}
    for enc, (lo, hi) in zip(stages, VGG16_BN_STAGES):
        for kind, idx, _ in feature_layout(VGG16_CFG, True):
            if lo <= idx < hi and kind in fields:
                for f in fields[kind]:
                    sd[f"{enc}.{idx - lo}.{f}"] = tv[f"features.{idx}.{f}"].float()
    return sd


def _site_fields(mod: torch.nn.Module):
    """What a torchvision conv or BN entry may set at a site, as the JAX
    merge (``_merge_into_backbone``: same leaf name and shape) sets it: a
    SwitchWhiten has no BN ``scale``, so only its bias is taken; an IBN
    site has no leaf of a BN's names, so nothing."""
    if isinstance(mod, SwitchWhiten):
        return ("bias",)
    if isinstance(mod, (nn.Conv2d, InstanceNorm)):
        return ("weight", "bias")
    if isinstance(mod, nn.BatchNorm2d):
        return ("weight", "bias", "running_mean", "running_var")
    return ()


def _install_nonstrict(model: torch.nn.Module, mapped: Mapping[str, torch.Tensor]) -> int:
    """Copy each mapped entry whose site takes it and whose shape matches;
    returns how many were copied."""
    current = model.state_dict()
    sd = {}
    for key, v in mapped.items():
        prefix, field = key.rsplit(".", 1)
        if key not in current or tuple(v.shape) != tuple(current[key].shape):
            continue
        if field in _site_fields(model.get_submodule(prefix)):
            sd[key] = v.float()
    with torch.no_grad():
        model.load_state_dict(sd, strict=False)
    return len(sd)


def resnet50_to_port(tv: Mapping[str, torch.Tensor], model_name: str) -> Dict[str, torch.Tensor]:
    """torchvision resnet50 keys -> the names of the ``sw`` / ``ibn`` trunk
    (``backbone.{0,1,4,5,6}``, an odd block's bn2 at its SW site ``sw2``)
    or of ``isw`` (``layer0.{0,1}``, ``layer1-3``). Keys the model lacks
    (layer4, fc) are dropped by the install."""
    out = {}
    for key, v in tv.items():
        m = re.fullmatch(r"(conv1|bn1)\.(.*)", key)
        if m:
            stem = "layer0" if model_name == "isw" else "backbone"
            out[f"{stem}.{int(m.group(1) == 'bn1')}.{m.group(2)}"] = v
            continue
        m = re.fullmatch(r"layer(\d+)\.(\d+)\.(.*)", key)
        if m is None:
            continue
        k, i, sub = m.groups()
        if model_name == "isw":
            out[f"layer{k}.{i}.{sub}"] = v
            continue
        if model_name == "sw" and int(i) % 2 == 1:
            sub = re.sub(r"^bn2\.", "sw2.", sub)
        out[f"backbone.{3 + int(k)}.{i}.{sub}"] = v
    return out


def densenet_to_port(tv: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision densenet ``features.*`` keys -> ``backbone.*``, the
    published files' legacy ``norm.1`` / ``conv.2`` names re-keyed as
    torchvision does. Keys the truncated trunk lacks (denseblock4, norm5,
    transition3's conv) are dropped by the install."""
    legacy = re.compile(r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\."
                        r"(?:weight|bias|running_mean|running_var))$")
    out = {}
    for key, v in tv.items():
        m = legacy.match(key)
        key = m.group(1) + m.group(2) if m else key
        if key.startswith("features."):
            out["backbone." + key[len("features."):]] = v
    return out


def vgg19_to_sw_vgg(tv: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The k-th conv of torchvision vgg19 -> the k-th conv of the SW VGG
    stack (the reference's idx_dict remap, SW/backbones/vgg.py:29-45)."""
    tv_convs = [idx for kind, idx, _ in feature_layout(VGG19_CFG, False) if kind == "conv"]
    ours = sorted(_sw_vgg_index().values())
    out = {}
    for t, o in zip(tv_convs, ours):
        for f in ("weight", "bias"):
            out[f"vgg.features.{o}.{f}"] = tv[f"features.{t}.{f}"]
    return out


def install_pretrained(model: torch.nn.Module, model_name: str,
                       weights: Mapping[str, str]) -> str:
    """Install the pretrained backbone of ``weights`` ({name: .pth path})
    that ``model_name`` has a mapping for; returns what was installed, or
    "no pretrained mapping". A vgg16_bn or vgg19 checkpoint of other
    widths raises; the resnet50 and densenet121 mappings are non-strict,
    as the JAX package's."""
    if model_name in ("sw", "ibn", "isw") and "resnet50" in weights:
        _install_nonstrict(model, resnet50_to_port(load_reference_pth(weights["resnet50"]),
                                                   model_name))
        return "resnet50 → backbone (non-strict)"
    if model_name in ("sw_densenet", "ibn_densenet") and "densenet121" in weights:
        _install_nonstrict(model, densenet_to_port(load_reference_pth(weights["densenet121"])))
        return "densenet121 → backbone (non-strict)"
    if model_name == "sw_vgg" and "vgg19" in weights:
        sd = vgg19_to_sw_vgg(load_reference_pth(weights["vgg19"]))
        current = model.state_dict()
        bad = [k for k, v in sd.items() if tuple(v.shape) != tuple(current[k].shape)]
        if bad:
            raise ValueError(f"sw_vgg's convolutions are not vgg19's: {bad[:3]}")
        with torch.no_grad():
            model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=False)
        return "vgg19 → conv sites (SW idx remap)"
    if model_name in DG_FAMILY + UNET_FAMILY and "vgg16_bn" in weights:
        unet = model_name in UNET_FAMILY
        sd = vgg16_bn_to_dg(load_reference_pth(weights["vgg16_bn"]),
                            ("stage1", "stage2", "stage3") if unet else ("enc1", "enc2", "enc3"))
        current = model.state_dict()
        bad = sorted(k for k, v in sd.items()
                     if k not in current or tuple(v.shape) != tuple(current[k].shape))
        if bad:
            raise ValueError(f"{model_name}'s encoder is not vgg16_bn's layout: {bad[:3]}")
        with torch.no_grad():
            model.load_state_dict(sd, strict=False)
        return "vgg16_bn → fe/stage1-3" if unet else "vgg16_bn → enc1/2/3"
    return "no pretrained mapping"
