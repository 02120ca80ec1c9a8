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
names that ``densenet_to_flax`` reads. The generators and the classic
baselines map by module path (``_LAYOUT_PATHS``), each the inverse of the
JAX package's reader of that family: ``generator_checkpoint_to_flax``
(``gen``), ``csrnet_``, ``mcnn_``, ``bl_`` (both BN layouts), ``sasnet_``,
``cctrans_`` and ``dssinet_checkpoint_to_flax``; ``gen0``, which the JAX
package does not read, by the regressors' convention.
``state_dict_from_flax`` picks the converter by the model's
``flax_layout``.

``install_pretrained`` puts a torchvision state_dict into a model, as the
JAX package's ``nn/torch_io.py::load_pretrained_backbone`` does:
``vgg16_bn`` into a DGModel's ``enc1/enc2/enc3``, a regressor's
``stage1/2/3`` and SASNet's ``features1-5``; ``resnet50`` into the
trunk of ``sw``, ``ibn`` and ``isw``, ``densenet121`` into the trunk of
the DenseNet counters and ``alt_gvt`` into CCTrans's transformer (all
non-strict: what has no site of the same shape keeps its init); ``vgg19``
into ``sw_vgg``'s 16 convolutions, the generators' encoders and ``bl``'s
features (``vgg19_bn`` for ``bl(batch_norm=True)``), ``vgg16``'s first ten
convolutions into CSRNet's front end and DSSINet's stages.
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
    (conv HWIO -> OIHW, dense (in, out) -> (out, in)), BN and LayerNorm
    scale / mean / var and PReLU alpha renamed, SwitchWhiten and IN leaves
    verbatim."""
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
        elif name == "alpha":  # a PReLU's slope
            sd[f"{prefix}.weight"] = _t(a)
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


def _by_path(to_torch, params: Mapping, batch_stats: Optional[Mapping]):
    """Every module of the params (and batch statistics) trees through
    ``to_torch(flax module path, leaves) -> torch prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaves in _modules(tree):
            _put(sd, to_torch(path, leaves), leaves)
    return sd


def whitening_state_dict_from_flax(layout: str, params: Mapping,
                                   batch_stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """JAX whitening-counter variables -> the port's state_dict.

    ``layout``: 'resnet' (sw, ibn), 'isw', 'sw_vgg' or 'densenet' (the
    models' ``flax_layout``). With ``batch_stats=None``, ``params`` may be
    any tree of the params' layout (a gradient): the result then holds the
    parameters' keys only."""
    return _by_path(lambda path, leaves: _flax_path_to_torch(layout, path, leaves),
                    params, batch_stats)


# ---- the generators and the classic baselines: flax module path -> the
# reference torch name (each the inverse of dgvcc_tpu/nn/torch_io.py's
# reader of that family)

# the reference Generator's dec Sequential index of each flax block
# (torch_io.py::_GEN_DEC_MAP; upsamples at 2, 7, 10)
_GEN_DEC = {"dec0": 0, "dec1": 1, "dec2_0": 3, "dec2_1": 4, "dec2_2": 5, "dec2_3": 6,
            "dec3_0": 8, "dec3_1": 9, "dec4": 11, "out": 12}
_CONVBLOCK = {"Conv_0": "conv", "BatchNorm_0": "bn"}


def _vgg_index(name: str, lo: int = 0) -> str:
    """``conv{i}`` / ``bn{i}`` (torchvision index) -> the local index."""
    return str(int(re.fullmatch(r"(?:conv|bn)(\d+)", name).group(1)) - lo)


def _generator_path(path, leaves) -> str:
    if path[0] == "enc":
        return f"enc.{_vgg_index(path[1])}"
    return f"dec.{_GEN_DEC[path[0]]}.{_CONVBLOCK[path[1]]}"


def _generator0_path(path, leaves) -> str:
    if path[0] in ("enc1", "enc2", "enc3"):
        lo = {"enc1": 0, "enc2": 9, "enc3": 18}[path[0]]
        return f"{path[0]}.{_vgg_index(path[1], lo)}"
    m = re.fullmatch(r"(dec\d|head)_?(\d)", path[0])
    return f"{m.group(1)}.{m.group(2)}.{_CONVBLOCK[path[1]]}"


def _stack_index(cfg, k: int) -> int:
    """The Sequential index of the k-th conv of a make_layers stack (conv and
    ReLU per entry, one pool per 'M')."""
    seq = 0
    for v in cfg:
        if v == "M":
            seq += 1
        elif k == 0:
            return seq
        else:
            seq, k = seq + 2, k - 1
    raise IndexError(k)


def _csrnet_path(path, leaves) -> str:
    from dgvcc_tpu_torch.models.baselines.csrnet import BACKEND, FRONTEND

    if path[0] == "output_layer":
        return "output_layer"
    cfg = FRONTEND if path[0] == "frontend" else BACKEND
    return f"{path[0]}.{_stack_index(cfg, int(path[1][4:]))}"


def _mcnn_path(path, leaves) -> str:
    if path[0] == "fuse":
        return "fuse.0"
    return f"{path[0]}.{(0, 3, 6, 8)[int(path[1][4:])]}"


def _bl_path(path, leaves) -> str:
    if path[0] == "features":
        return f"features.{_vgg_index(path[1])}"
    return f"reg_layer.{2 * (int(path[0][3:]) - 1)}"


_SASNET_BRANCHES = ("branch1x1", "branch1x1_1", "branch3x3_1", "branch3x3_2",
                    "branch3x3dbl_1", "branch3x3dbl_2")


def _sasnet_path(path, leaves) -> str:
    """torch_io.py::sasnet_checkpoint_to_flax's order contracts, inverted:
    ConvRelu_0-9 are de_pred5..1 (two each), ConvRelu_{10+2i, 11+2i} scale
    i's confidence head, MultiBranch_i / Conv_i its density head."""
    from dgvcc_tpu_torch.models.baselines.sasnet import SPLITS

    head, sub = path[0], path[1:]
    if head.startswith("features"):
        return f"{head}.{_vgg_index(sub[0], SPLITS[int(head[-1]) - 1][0])}"
    kind, i = re.fullmatch(r"(ConvRelu|MultiBranch|Conv)_(\d+)", head).groups()
    i = int(i)
    if kind == "Conv":
        return f"density_head{5 - i}.1.conv"
    if kind == "MultiBranch":
        b = int(sub[0].rsplit("_", 1)[1])
        return f"density_head{5 - i}.0.{_SASNET_BRANCHES[b]}.{_CONVBLOCK[sub[1]]}"
    if i < 10:
        return f"de_pred{5 - i // 2}.{i % 2}.conv"
    return f"confidence_head{5 - (i - 10) // 2}.{(i - 10) % 2}.conv"


# the reference Regression head's conv index of each flax name
# (torch_io.py::_CCTRANS_REG_MAP; v2 / v3 lead with an upsample)
_CCTRANS_REG = {"v1": 0, "v2": 1, "v3": 1, "stage1": 0, "stage2": 0, "stage3": 0,
                "stage4": 0, "res1": 0}


def _cctrans_path(path, leaves) -> str:
    head, sub = path[0], path[1:]
    m = re.fullmatch(r"(patch_embed|pos_block)(\d+)", head)
    if m:
        if m.group(1) == "pos_block":
            return f"pos_block.{m.group(2)}.proj.0"
        return f"patch_embeds.{m.group(2)}.{sub[0]}"
    m = re.fullmatch(r"block(\d+)_(\d+)", head)
    if m:
        return ".".join(("blocks", m.group(1), m.group(2)) + tuple(sub))
    name = sub[0]  # regression/{v1,...}_{conv,bn}, res2
    if name == "res2":
        return "regression.res.3"
    stage, kind = name.rsplit("_", 1)
    ci = _CCTRANS_REG[stage] + (kind == "bn")
    return f"regression.{'res' if stage == 'res1' else stage}.{ci}"


def _dssinet_path(path, leaves) -> str:
    from dgvcc_tpu_torch.models.baselines.dssinet import STAGES

    head, sub = path[0], path[1:]
    fe = "front_end.features"
    if re.fullmatch(r"stage\d", head):
        kind, i = re.fullmatch(r"(conv|prelu)(\d+)", sub[0]).groups()
        convs, prelus = STAGES[int(head[-1]) - 1]
        return f"{fe}.{(convs if kind == 'conv' else prelus)[int(i)]}"
    if head in ("stage1_act", "stage4_act"):
        return f"{fe}.{'relu3' if head == 'stage1_act' else 'relu22'}"
    if head == "out_prelu":
        return "prelu"
    if head.startswith("passing"):
        return f"{head}.prelu" if sub[0] == "prelu" else f"{head}.{sub[0]}.0.conv"
    if head.startswith("decoder"):
        return f"{head}.{int(sub[0][1:]) - 1}.conv"
    return f"passing_weight{head[2:]}.conv"  # pw{k}


_LAYOUT_PATHS = {"generator": _generator_path, "generator0": _generator0_path,
                 "csrnet": _csrnet_path, "mcnn": _mcnn_path, "bl": _bl_path,
                 "sasnet": _sasnet_path, "cctrans": _cctrans_path, "dssinet": _dssinet_path}


def state_dict_from_flax(model: torch.nn.Module, params: Mapping,
                         batch_stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """JAX variables of ``model``'s family -> its state_dict (with
    ``batch_stats=None``, ``params`` may be a gradient tree)."""
    layout = getattr(model, "flax_layout", None)
    splits = getattr(model, "stage_splits", (0, 23, 33, 43))
    if layout is None:
        return dg_state_dict_from_flax(params, batch_stats, splits)
    if layout == "regressor":
        return regressor_state_dict_from_flax(params, batch_stats, splits)
    if layout in _LAYOUT_PATHS:
        return _by_path(_LAYOUT_PATHS[layout], params, batch_stats)
    return whitening_state_dict_from_flax(layout, params, batch_stats)


def drop_reference_unused(sd: Dict[str, torch.Tensor], model: torch.nn.Module):
    """``sd`` without the reference checkpoint's keys that ``model``'s
    forward never reads (isw: the unused ``layer4`` and ``fc``)."""
    unused = getattr(model, "reference_unused", ())
    return {k: v for k, v in sd.items() if not k.startswith(unused)} if unused else sd


def export_reference_state_dict(model: torch.nn.Module,
                                template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``model``'s weights under ``template``'s keys and shapes (the
    reference's key layout is the port's): each floating tensor as float32,
    the template's other entries (``num_batches_tracked``, the keys the
    model never reads, as isw's ``layer4``) as the template has them, as
    the JAX package's ``nn/torch_export.py`` passes them through. Raises on
    a weight the template lacks or holds at another shape."""
    sd = model.state_dict()
    lacking = sorted(k for k, v in sd.items() if v.is_floating_point() and k not in template)
    if lacking:
        raise ValueError(f"the template lacks {len(lacking)} of the model's weights "
                         f"({lacking[:3]}...): not a same-architecture reference .pth")
    out = {}
    for key, ref in template.items():
        v = sd.get(key)
        if v is None or not v.is_floating_point():
            out[key] = ref.clone()
        elif v.shape != ref.shape:
            raise ValueError(f"{key}: the model's {tuple(v.shape)} against the template's "
                             f"{tuple(ref.shape)}")
        else:
            out[key] = v.detach().to("cpu", torch.float32).clone()
    return out


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


def vgg_to_stages(tv: Mapping[str, torch.Tensor], cfg, batch_norm: bool,
                  stages) -> Dict[str, torch.Tensor]:
    """torchvision VGG keys ``features.{i}.*`` -> ``{prefix}.{i - lo}.*`` for
    each (prefix, lo, hi) of ``stages``: conv weight and bias, BN weight,
    bias and running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    fields = {"conv": ("weight", "bias"),
              "bn": ("weight", "bias", "running_mean", "running_var")}
    for prefix, lo, hi in stages:
        for kind, idx, _ in feature_layout(cfg, batch_norm):
            if lo <= idx < hi and kind in fields:
                for f in fields[kind]:
                    sd[f"{prefix}.{idx - lo}.{f}"] = tv[f"features.{idx}.{f}"].float()
    return sd


def vgg16_bn_to_dg(tv: Mapping[str, torch.Tensor],
                   stages=("enc1", "enc2", "enc3")) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16_bn`` -> the DGModel's ``enc{1,2,3}.{i - lo}.*``
    (a regressor's: ``stage{1,2,3}``)."""
    return vgg_to_stages(tv, VGG16_CFG, True,
                         [(e, lo, hi) for e, (lo, hi) in zip(stages, VGG16_BN_STAGES)])


def vgg_convs_to(tv: Mapping[str, torch.Tensor], cfg, names) -> Dict[str, torch.Tensor]:
    """The k-th conv of a torchvision VGG (plain, ``cfg``) -> ``names[k]``,
    for as many as ``names`` holds (CSRNet's front end, DSSINet's stages)."""
    convs = [idx for kind, idx, _ in feature_layout(cfg, False) if kind == "conv"]
    return {f"{name}.{f}": tv[f"features.{idx}.{f}"].float()
            for name, idx in zip(names, convs) for f in ("weight", "bias")}


def _install_strict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor], what: str):
    """Copy ``sd`` into ``model``; raises unless every key exists with its shape."""
    current = model.state_dict()
    bad = sorted(k for k, v in sd.items()
                 if k not in current or tuple(v.shape) != tuple(current[k].shape))
    if bad:
        raise ValueError(f"{what}: {bad[:3]}")
    with torch.no_grad():
        model.load_state_dict(sd, strict=False)


def _site_fields(mod: torch.nn.Module):
    """What a pretrained conv, linear, norm or BN entry may set at a site, as
    the JAX merge (``_merge_into_backbone``: same leaf name and shape) sets it: a
    SwitchWhiten has no BN ``scale``, so only its bias is taken; an IBN
    site has no leaf of a BN's names, so nothing."""
    if isinstance(mod, SwitchWhiten):
        return ("bias",)
    if isinstance(mod, (nn.Conv2d, nn.Linear, nn.LayerNorm, InstanceNorm)):
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


# the pretrained mappings of the generators and the classic baselines:
# (model, torchvision weights) -> (description, its state_dict for the model)
_VGG19_GEN0 = (("enc1", 0, 9), ("enc2", 9, 18), ("enc3", 18, 26))


def _csrnet_frontend(tv):
    """vgg16's first ten convs -> CSRNet's front end, positionally."""
    from dgvcc_tpu_torch.models.baselines.csrnet import FRONTEND

    return vgg_convs_to(tv, VGG16_CFG, [f"frontend.{_stack_index(FRONTEND, k)}"
                                        for k in range(10)])


def _dssinet_stages(tv):
    """vgg16's first ten convs -> DSSINet's front-end stages, positionally."""
    from dgvcc_tpu_torch.models.baselines.dssinet import STAGES

    return vgg_convs_to(tv, VGG16_CFG, [f"front_end.features.{name}"
                                        for convs, _ in STAGES for name in convs])


def _sasnet_features(tv):
    """vgg16_bn -> SASNet's features1-5 (local indices)."""
    from dgvcc_tpu_torch.models.baselines.sasnet import SPLITS

    return vgg_to_stages(tv, VGG16_CFG, True, [(f"features{k}", lo, hi)
                                               for k, (lo, hi) in enumerate(SPLITS, 1)])


_BASELINE_PRETRAINED = {
    ("gen", "vgg19"): ("vgg19 → enc",
                       lambda tv: vgg_to_stages(tv, VGG19_CFG, False, (("enc", 0, 26),))),
    ("gen0", "vgg19"): ("vgg19 → enc1-3",
                        lambda tv: vgg_to_stages(tv, VGG19_CFG, False, _VGG19_GEN0)),
    ("csrnet", "vgg16"): ("vgg16 → frontend", _csrnet_frontend),
    ("dssinet", "vgg16"): ("vgg16 → stage1-4", _dssinet_stages),
    ("sasnet", "vgg16_bn"): ("vgg16_bn → features1-5", _sasnet_features),
}
# CCTrans's backbone keys; the regression head trains from scratch
_ALTGVT_PREFIXES = ("patch_embeds.", "pos_block.", "blocks.")


def install_pretrained(model: torch.nn.Module, model_name: str,
                       weights: Mapping[str, str]) -> str:
    """Install the pretrained backbone of ``weights`` ({name: .pth path})
    that ``model_name`` has a mapping for; returns what was installed, or
    "no pretrained mapping" (with the reason where ``bl`` was given the
    other vgg19). A VGG checkpoint of other widths raises; the resnet50,
    densenet121 and alt_gvt mappings are non-strict, as the JAX package's."""
    if model_name in ("sw", "ibn", "isw") and "resnet50" in weights:
        _install_nonstrict(model, resnet50_to_port(load_reference_pth(weights["resnet50"]),
                                                   model_name))
        return "resnet50 → backbone (non-strict)"
    if model_name in ("sw_densenet", "ibn_densenet") and "densenet121" in weights:
        _install_nonstrict(model, densenet_to_port(load_reference_pth(weights["densenet121"])))
        return "densenet121 → backbone (non-strict)"
    if model_name == "sw_vgg" and "vgg19" in weights:
        sd = vgg19_to_sw_vgg(load_reference_pth(weights["vgg19"]))
        _install_strict(model, sd, "sw_vgg's convolutions are not vgg19's")
        return "vgg19 → conv sites (SW idx remap)"
    if model_name in DG_FAMILY + UNET_FAMILY and "vgg16_bn" in weights:
        unet = model_name in UNET_FAMILY
        sd = vgg16_bn_to_dg(load_reference_pth(weights["vgg16_bn"]),
                            ("stage1", "stage2", "stage3") if unet else ("enc1", "enc2", "enc3"))
        _install_strict(model, sd, f"{model_name}'s encoder is not vgg16_bn's layout")
        return "vgg16_bn → fe/stage1-3" if unet else "vgg16_bn → enc1/2/3"
    if model_name == "bl":
        # the layout follows the model's batch_norm flag: the other one would
        # land its first conv only
        key = "vgg19_bn" if model.batch_norm else "vgg19"
        if key in weights:
            sd = vgg_to_stages(load_reference_pth(weights[key]), VGG19_CFG, model.batch_norm,
                               (("features", 0, 10_000),))
            _install_strict(model, sd, f"bl's features are not {key}'s layout")
            return f"{key} → features"
        wrong = "vgg19" if model.batch_norm else "vgg19_bn"
        if wrong in weights:
            return (f"no pretrained mapping: bl(batch_norm={model.batch_norm}) needs "
                    f"'{key}' weights but only '{wrong}' was provided")
    if model_name == "cctrans" and "alt_gvt" in weights:
        tv = load_reference_pth(weights["alt_gvt"])
        _install_nonstrict(model, {k: v for k, v in tv.items()
                                   if k.startswith(_ALTGVT_PREFIXES)})
        return "alt_gvt → transformer backbone (non-strict)"
    for (name, key), (desc, mapping) in _BASELINE_PRETRAINED.items():
        if model_name == name and key in weights:
            sd = mapping(load_reference_pth(weights[key]))
            _install_strict(model, sd, f"{model_name} does not take {key}'s layout")
            return desc
    return "no pretrained mapping"
