"""Int8 post-training quantization (PTQ) serving graphs, counterpart of
dgvcc_tpu/nn/quant.py.

The DG family (``QuantizedDG``), the feed-forward conv(+BN) baselines
csrnet, mcnn, bl, sasnet and dssinet, and CCTrans (``QuantizedConvNet``, one
fold and one forward spec a family, sites below ``min_ch`` channels left in
bf16; CCTrans's graph is ``nn/quant_cctrans.py``) become an eval-only
serving graph, built by ``build_quantized``:

  1. batch norm folded into its convolution (``fold_bn``): exact up to
     float rounding;
  2. weights quantized per output channel, symmetric int8
     (``quantize_weight``: absmax / 127);
  3. each int8 site's input scale calibrated over a few frames on the folded
     f32 graph with TF32 off (``calibrate``, ``calibrate_graph``: absmax /
     127, floored at 1e-12 / 127). Serving quantizes the site's input with
     it (``ops/qconv.py::quantize_activation``: a true division, rounding
     half to even) and runs the hand-written int8 convolution
     (``ops/qconv.py::qconv_int8``, ``csrc/qconv.cu``) with its f32
     epilogue fused. A concatenation feeding an int8 site quantizes its
     parts first and concatenates int8 (a per-tensor scale commutes with
     it), as the JAX graph does.

The sites keep the JAX package's names (``enc1/conv0`` .. ``dec3_0`` ..
``den_dec``, ``den_head``, ``cls_conv1``, ``cls_conv2``; ``frontend/conv0``,
``features/conv{i}``, ``MultiBranch_{i}/BasicConv_{b}``,
``stage{k}/conv{i}@f{j}``, ...) and its layout (``kernel`` / ``w8`` HWIO,
``ws`` and ``bias`` f32), so an artifact crosses between the packages
(``nn/quant_io.py``). They are folded from the port's own modules. On the
device an int8 site holds ``w8`` as (Cout, kh, kw, Cin), the kernel's
layout, and an fp site its kernel in the serving dtype, the same way. The
graphs run NHWC tensors (a channels-last view on the card), as the JAX
graphs do; the fp convolutions and the glue (pools, resizes, the bank) are
PyTorch's, the bank kernel #1 on the card at every batch (the JAX graph's
``b >= 8`` rule was measured on a TPU v5e; on the H100 #1 wins from B=1).

Every entry point builds its graph on ``device``: ``cuda`` unless the
caller asks for ``"cpu"``, and raises when CUDA is asked for and absent.

``weight_only``: int8 weights dequantized to the serving dtype at use,
bf16 activations, cuDNN's convolution; no calibration.

On a spatial serving mesh (``parallel/spatial.py::shard_graph_height``)
the DG graph, and the graph of csrnet, mcnn, bl, sasnet or dssinet (a
family with a ``row_rule``), holds a rank's rows of each frame: each site
taller than one row exchanges a halo of dilation (kh - 1) / 2 rows with the
ranks around it (int8 rows at an int8 site, quantized first) and runs SAME
on the haloed block, keeping its own output rows; each bilinear resize
reads one neighbour row (a forward reads the group from its site
primitive's ``group``). Pools, nearest resizes at an integer ratio, the x0.5
pyramid level, sasnet's cell pooling, 1x1 sites, the classifier's
threshold and the bank are row-local.

The whitening counters are refused as in the JAX package: they compute
instance statistics at eval, which no fold can take.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dgvcc_tpu_torch.nn.collectives import exchange_halo
from dgvcc_tpu_torch.nn.layers import resize_bilinear, resize_bilinear_ac, upsample
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGG19_CFG, feature_layout
from dgvcc_tpu_torch.ops.mem_attention import memory_attention_fused
from dgvcc_tpu_torch.ops.qconv import pad_cin, qconv_int8, quantize_activation, same_padding
from dgvcc_tpu_torch.serve import resolve_device

_DEC_BLOCKS = ("dec3_0", "dec3_1", "dec2_0", "dec2_1", "dec1_0", "dec1_1")
# sites that stay fp (tiny 1x1 heads; quantizing them saves nothing)
_FP_SITES = frozenset({"den_head", "cls_conv2"})
# CCTrans's batch floor for quantize="auto" (the JAX package's measurement on
# a TPU v5e: its int8 graph ran 0.68x bf16 at B=1, 1.10-1.16x at B=8;
# dgvcc_tpu/nn/quant.py:980-991)
CCTRANS_MIN_BATCH = 8


# ---------------------------------------------------------------------------
# folding and weight quantization (numpy, the JAX package's arithmetic)
# ---------------------------------------------------------------------------

def fold_bn(kernel, bias, scale, bn_bias, mean, var, eps=1e-5):
    """Collapse conv -> BN(eval) into one conv: kernel (kh, kw, cin, cout)
    scaled per output channel, and a bias. Exact up to float rounding."""
    g = scale / np.sqrt(np.asarray(var, np.float64) + eps)
    g = np.asarray(g, np.float32)
    kernel = np.asarray(kernel, np.float32) * g
    b0 = np.zeros(kernel.shape[-1], np.float32) if bias is None else np.asarray(bias, np.float32)
    bias = (b0 - np.asarray(mean, np.float32)) * g + np.asarray(bn_bias, np.float32)
    return kernel, bias


def quantize_weight(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 of an HWIO kernel: (w8, ws[cout])."""
    k = np.asarray(kernel, np.float32)
    absmax = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    ws = np.maximum(absmax, 1e-12) / 127.0
    w8 = np.clip(np.rint(k / ws), -127, 127).astype(np.int8)
    return w8, ws.astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def conv_site(conv, bn=None) -> Dict[str, np.ndarray]:
    """One folded site of a port ``Conv2d`` (and the batch norm after it):
    {kernel: HWIO f32, bias: f32}."""
    kernel = _np(conv.weight).transpose(2, 3, 1, 0)
    bias = None if conv.bias is None else _np(conv.bias)
    if bn is None:
        return {"kernel": np.ascontiguousarray(kernel),
                "bias": np.zeros(kernel.shape[-1], np.float32) if bias is None else bias}
    k, b = fold_bn(kernel, bias, _np(bn.weight), _np(bn.bias), _np(bn.running_mean),
                   _np(bn.running_var), eps=bn.eps)
    return {"kernel": k, "bias": b}


def quantize_sites(folded: Dict, quantized) -> Dict[str, Dict[str, np.ndarray]]:
    """The artifact's sites (the JAX layout): ``w8`` / ``ws`` / ``bias``
    where ``quantized(name)``, else ``kernel`` / ``bias``."""
    out = {}
    for name, site in folded.items():
        if name == "__extras__":
            continue
        if quantized(name):
            w8, ws = quantize_weight(site["kernel"])
            out[name] = {"w8": w8, "ws": ws, "bias": np.asarray(site["bias"], np.float32)}
        else:
            out[name] = {"kernel": np.asarray(site["kernel"], np.float32),
                         "bias": np.asarray(site["bias"], np.float32)}
    return out


def _place(sites: Dict, dtype: torch.dtype, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The sites on the device: an int8 site's ``w8`` as (Cout, kh, kw, Cin)
    int8 with Cin padded by zero channels to a multiple of 16 (the int8
    kernel's tensor maps need it; ``_qconv`` pads the activations to match),
    an fp site's kernel in ``dtype`` as (Cout, kh, kw, Cin); f32 scales and
    biases. A permute of either is the channels-last OIHW weight."""
    out = {}
    for name, site in sites.items():
        bias = torch.as_tensor(np.asarray(site["bias"], np.float32)).to(device)
        if "w8" in site:
            w8 = pad_cin(torch.from_numpy(np.ascontiguousarray(
                np.asarray(site["w8"], np.int8).transpose(3, 0, 1, 2))))
            out[name] = {"w8": w8.contiguous().to(device),
                         "ws": torch.as_tensor(np.asarray(site["ws"], np.float32)).to(device),
                         "bias": bias}
        else:
            k = torch.from_numpy(np.ascontiguousarray(
                np.asarray(site["kernel"], np.float32).transpose(3, 0, 1, 2)))
            out[name] = {"kernel": k.to(device=device, dtype=dtype), "bias": bias}
    return out


# ---------------------------------------------------------------------------
# NHWC glue: the port's NCHW ops on a permuted view
# ---------------------------------------------------------------------------

def _nchw(fn, x, *args, **kwargs):
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def _maxpool(x):
    return _nchw(F.max_pool2d, x, 2, 2)


def _up(x, factor, mode="bilinear", group=None):
    return _nchw(upsample, x, factor, mode, group)


def _halo(x, rows: int, group):
    """NHWC ``x``, this rank's rows, with ``rows`` rows of each neighbour
    above and below (zeros at the frame's top and bottom)."""
    return _nchw(exchange_halo, x, rows, group)


class _Graph:
    """What the two graph classes share: the site primitive and calibration
    capture. ``sites``: the artifact layout (numpy); ``qparams["sites"]``:
    the same on the device."""

    dtype: torch.dtype
    scales: Dict[str, float]
    weight_only = False
    fp_sites = frozenset()
    # the smallest dispatch batch at which ``quantize="auto"`` serves this
    # graph (serve.py::VideoCounter._prefers_int8); stored in artifacts
    int8_min_batch = 1
    # the graph's rows sharded over a group (parallel/spatial.py::
    # shard_graph_height): each site taller than one row convolves its
    # rows with the neighbours' halo and keeps its own output rows
    spatial_group = None
    # the multiple of rows a rank's share must be (its model class's; None:
    # the graph does not shard)
    row_rule = None

    def _init_sites(self, sites, scales, dtype, device):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.scales = {k: float(v) for k, v in scales.items()}
        self.sites = sites
        self.qparams: Dict[str, Any] = {"sites": _place(sites, dtype, self.device)}
        self._capture: Optional[Dict[str, torch.Tensor]] = None

    def int8_sites(self):
        """The sites that run the int8 convolution (weight_only: none)."""
        if self.weight_only:
            return []
        return sorted(n for n, s in self.qparams["sites"].items() if "w8" in s)

    def _qconv(self, x, name: str, relu: bool = True, dilation: int = 1, stride: int = 1,
               padding=None, groups: int = 1):
        """``x``: an NHWC tensor, or a list of the parts of a channel concat.
        ``padding``: None for flax's 'SAME' at the stride, else ((top,
        bottom), (left, right)); ``groups``: an fp site's feature groups (the
        depthwise PEG: its one input channel a group keeps it below any
        ``min_ch``)."""
        site = self.qparams["sites"][name]
        parts = list(x) if isinstance(x, (list, tuple)) else None
        if self._capture is not None and name not in self.fp_sites:
            # a concat's absmax is the largest of its parts'
            m = torch.stack([p.float().abs().amax() for p in (parts or [x])]).amax()
            prev = self._capture.get(name)
            self._capture[name] = m if prev is None else torch.maximum(prev, m)
        dt = self.dtype
        window = (site["w8"] if "w8" in site else site["kernel"]).shape[1:3]
        same = tuple(same_padding(n, k, dilation, stride)
                     for n, k in zip((parts or [x])[0].shape[1:3], window))
        padding = same if padding is None else tuple(tuple(p) for p in padding)
        group = self.spatial_group if window[0] > 1 else None
        halo = dilation * (window[0] - 1) // 2
        if group is not None and (stride != 1 or padding != same):
            raise ValueError(f"site {name}: only stride-1 SAME sites shard over rows")
        if "w8" not in site or self.weight_only:  # fp activations
            if parts is not None:
                x = torch.cat(parts, dim=-1)
            if group is not None:  # SAME on the haloed rows, then its own rows
                x = _halo(x, halo, group)
            if "w8" in site:  # weight-only: dequantize at use (without the padding)
                w8 = site["w8"][..., :x.shape[-1] // groups]
                kernel = w8.to(dt) * site["ws"].to(dt)[:, None, None, None]
            else:
                kernel = site["kernel"]
            (t, b), (l, r) = padding
            xc = x.to(dt).permute(0, 3, 1, 2)
            if (t, l) != (b, r):  # uneven: the zeros go in first
                xc, t, l = F.pad(xc, (l, r, t, b)), 0, 0
            y = F.conv2d(xc, kernel.permute(0, 3, 1, 2), stride=stride, padding=(t, l),
                         dilation=dilation, groups=groups).permute(0, 2, 3, 1)
            y = y + site["bias"].to(dt)
            y = F.relu(y) if relu else y
            return y if group is None else y[:, halo:-halo]
        if groups != 1 or padding != same:
            raise ValueError(f"int8 site {name}: the int8 convolution takes one group and "
                             "SAME padding")
        s = self.scales[name]
        xq = (torch.cat([quantize_activation(p, s) for p in parts], dim=-1)
              if parts is not None else quantize_activation(x, s))
        if group is not None:
            # the halo travels in int8: the scale is global, and a zero row
            # is SAME's zero fill (symmetric, no zero point)
            xq = _halo(xq, halo, group)
        xq = pad_cin(xq, site["w8"].shape[-1])
        y = qconv_int8(xq, site["w8"], site["ws"], s, site["bias"], relu=relu,
                       dilation=dilation, out_dtype=dt, stride=stride)
        return y if group is None else y[:, halo:-halo]

    @contextlib.contextmanager
    def capturing(self):
        """Record each quantizable site's input absmax over the forwards run
        inside; yields the {site: 0-d tensor} dict."""
        self._capture = {}
        try:
            yield self._capture
        finally:
            self._capture = None


class GraphModule(torch.nn.Module):
    """An int8 graph as an NCHW module (frames in, the density out): what
    ``ops/tiling.py::TiledCounter`` drives (the trainer's
    ``test_quantized``)."""

    def __init__(self, graph: "_Graph"):
        super().__init__()
        self.graph = graph

    def forward(self, x):
        out = self.graph(x.permute(0, 2, 3, 1))
        return (out[0] if isinstance(out, tuple) else out).permute(0, 3, 1, 2)


@contextlib.contextmanager
def _calibration_backends():
    """TF32 off for convolutions and matmuls (calibration runs the folded
    graph in full f32, as the JAX package does), and cuDNN's timed search
    off: calibration runs each shape once, so timing every algorithm first
    costs more than it can save."""
    b = torch.backends
    saved = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark = saved


def _absmax_over(graph: "_Graph", calib_frames: torch.Tensor) -> Dict[str, float]:
    with torch.inference_mode(), _calibration_backends(), graph.capturing() as caps:
        graph(calib_frames.to(graph.device, torch.float32))
    return {k: float(v) for k, v in caps.items()}


# ---------------------------------------------------------------------------
# the DG family
# ---------------------------------------------------------------------------

def _dg_geometry(model):
    """(vgg cfg, the three encoder stages' (name, lo, hi)) of a DGModel."""
    cfg = tuple(VGG16_CFG if getattr(model, "vgg_cfg", None) is None else model.vgg_cfg)
    return cfg, _enc_splits(getattr(model, "stage_splits", (0, 23, 33, 43)))


def _enc_splits(stage_splits):
    s0, s1, s2, s3 = stage_splits
    return ("enc1", s0, s1), ("enc2", s1, s2), ("enc3", s2, s3)


def fold_variables(model) -> Dict[str, Dict[str, np.ndarray]]:
    """Every conv(+BN) site of a port DGModel folded into {name: kernel,
    bias}, named as the JAX package names them."""
    cfg, enc_splits = _dg_geometry(model)
    folded: Dict[str, Dict[str, np.ndarray]] = {}
    for enc, lo, hi in enc_splits:
        stage = getattr(model, enc)
        for kind, idx, _ in feature_layout(cfg, True):
            if kind == "conv" and lo <= idx < hi:
                folded[f"{enc}/conv{idx}"] = conv_site(stage[idx - lo], stage[idx - lo + 1])
    blocks = {name: getattr(model, name[:4])[int(name[-1])] for name in _DEC_BLOCKS}
    blocks["den_dec"], blocks["den_head"] = model.den_dec[0], model.den_head[0]
    if model.use_cls:
        blocks["cls_conv1"], blocks["cls_conv2"] = model.cls_head[0], model.cls_head[2]
    for name, block in blocks.items():
        folded[name] = conv_site(block.conv, block.bn)
    return folded


def _bank(model) -> Optional[np.ndarray]:
    return _np(model.mem[0]) if model.use_mem else None


class QuantizedDG(_Graph):
    """Int8 serving graph of a DGModel (eval forward only): call with NHWC
    frames for (density NHWC, cls map or None), as the model's forward in
    eval mode within quantization tolerance. ``flags``: the model's
    ``use_mem``, ``use_cls``, ``cls_thrs`` and encoder geometry."""

    @property
    def row_rule(self) -> int:
        from dgvcc_tpu_torch.models.dg import DGModel

        return DGModel.row_rule

    def __init__(self, sites: Dict, scales: Dict[str, float], flags: Dict[str, Any],
                 mem: Optional[np.ndarray], dtype=torch.bfloat16, device="cuda",
                 weight_only: bool = False):
        self._init_sites(sites, scales, dtype, device)
        self.flags = dict(flags)
        self.use_mem, self.use_cls = flags["use_mem"], flags["use_cls"]
        self.cls_thrs = flags["cls_thrs"]
        self.weight_only = weight_only
        self.fp_sites = _FP_SITES
        if mem is not None:
            self.qparams["mem"] = torch.as_tensor(np.asarray(mem, np.float32)).to(
                device=self.device, dtype=dtype)

    @staticmethod
    def model_flags(model) -> Dict[str, Any]:
        cfg, enc_splits = _dg_geometry(model)
        return {"use_mem": model.use_mem, "use_cls": model.use_cls,
                "cls_thrs": float(model.cls_thrs), "vgg_cfg": cfg,
                "stage_splits": tuple(getattr(model, "stage_splits", (0, 23, 33, 43)))}

    @classmethod
    def from_folded(cls, folded, scales, model, mem, dtype=torch.bfloat16, device="cuda",
                    weight_only: bool = False) -> "QuantizedDG":
        """Quantize the folded sites: the non-fp sites with a scale, or all of
        them under ``weight_only``; the rest stay fp."""
        sites = quantize_sites(
            folded, lambda n: n not in _FP_SITES and (weight_only or n in scales))
        return cls(sites, scales, cls.model_flags(model), mem, dtype, device, weight_only)

    @classmethod
    def from_model(cls, model, calib_frames=None, dtype=torch.bfloat16, device="cuda",
                   weight_only: bool = False, share=None) -> "QuantizedDG":
        """Fold, calibrate on ``calib_frames`` (NHWC float, normalised), and
        quantize. ``weight_only`` needs no frames. ``share``: see
        ``build_quantized``."""
        folded = fold_variables(model)
        mem = _bank(model)
        if weight_only:
            return cls.from_folded(folded, {}, model, mem, dtype, device, weight_only=True)
        caps = _shared(lambda: calibrate(model, folded, mem, calib_frames, device), share)
        # floored like quantize_weight: a site dead on every calibration frame
        # would otherwise divide by 0
        scales = {k: max(v, 1e-12) / 127.0 for k, v in caps.items()}
        return cls.from_folded(folded, scales, model, mem, dtype, device)

    def _encoder(self, x):
        feats = []
        cfg, enc_splits = self.flags["vgg_cfg"], _enc_splits(self.flags["stage_splits"])
        for enc, lo, hi in enc_splits:
            for kind, idx, _ in feature_layout(cfg, True):
                if not lo <= idx < hi:
                    continue
                if kind == "conv":
                    x = self._qconv(x, f"{enc}/conv{idx}")
                elif kind == "pool":
                    x = _maxpool(x)
            feats.append(x)
        return feats  # x1 (stride 4), x2 (8), x3 (16)

    def __call__(self, frames):
        """frames (B, H, W, 3) -> (density (B, H, W, 1), cls (B, H/16, W/16, 1)
        or None), in the serving dtype; DGModel.forward's eval path."""
        x = frames.to(self.dtype)
        g = self.spatial_group
        x1, x2, x3 = self._encoder(x)
        y3 = self._qconv(self._qconv(x3, "dec3_0"), "dec3_1")
        y2 = self._qconv(self._qconv([_up(y3, 2, group=g), x2], "dec2_0"), "dec2_1")
        y1 = self._qconv(self._qconv([_up(y2, 2, group=g), x1], "dec1_0"), "dec1_1")
        y_den = self._qconv([y1, _up(y2, 2, group=g), _up(y3, 4, group=g)], "den_dec")
        if self.use_mem:
            b, h, w, k = y_den.shape
            y_den = memory_attention_fused(y_den.reshape(b, h * w, k),
                                           self.qparams["mem"]).reshape(b, h, w, k)
        d = self._qconv(y_den, "den_head")
        if not self.use_cls:
            return _up(d, 4, group=g), None
        c = self._qconv(x3, "cls_conv1")
        c = torch.sigmoid(self._qconv(c, "cls_conv2", relu=False))
        c_bin = (c >= self.cls_thrs).to(d.dtype)
        return _up(d * _up(c_bin, 4, "nearest"), 4, group=g), c


def calibrate(model, folded: Dict, mem: Optional[np.ndarray], calib_frames,
              device="cuda") -> Dict[str, float]:
    """Per-site input absmax over ``calib_frames`` (NHWC) through the folded
    f32 graph, TF32 off: the same activations as the batch-norm graph."""
    graph = QuantizedDG.from_folded(folded, {}, model, mem, torch.float32, device)
    return _absmax_over(graph, torch.as_tensor(np.asarray(calib_frames, np.float32)))


def fp_folded_forward(model, frames, dtype=torch.float32, device="cuda"):
    """The folded fp graph, no quantization (exactness harness)."""
    graph = QuantizedDG.from_folded(fold_variables(model), {}, model, _bank(model), dtype,
                                    device)
    with torch.inference_mode():
        return graph(torch.as_tensor(np.asarray(frames, np.float32)).to(graph.device))


# ---------------------------------------------------------------------------
# feed-forward conv(+BN) baselines
# ---------------------------------------------------------------------------

class QuantizedConvNet(_Graph):
    """Int8 serving graph of a feed-forward conv(+BN) baseline. A family is a
    fold (``fold(model) -> {site: {kernel, bias}}``, PReLU slopes under
    ``__extras__``) and a forward written against the site primitive
    (``forward(qconv, x[, extras]) -> density NHWC``; ``qconv.group`` is
    the graph's ``spatial_group``). The same forward serves the fp folded
    graph (no scales), calibration and int8 serving. ``row_rule``: the
    model's (``of``), for a graph that shards over rows."""

    def __init__(self, sites: Dict, scales: Dict[str, float], forward_fn: Callable,
                 fp_sites=frozenset(), extras: Optional[Dict] = None, dtype=torch.bfloat16,
                 device="cuda", row_rule: Optional[int] = None):
        self._init_sites(sites, scales, dtype, device)
        self.forward_fn = forward_fn
        self.fp_sites = frozenset(fp_sites)
        self.row_rule = row_rule
        if extras is not None:
            self.qparams["extras"] = _tree_to(extras, self.device)

    @classmethod
    def of(cls, model, sites, scales, extras, dtype, device) -> "QuantizedConvNet":
        """The graph of ``model``'s family (``_family_spec``) over ``sites``,
        with the model's row rule."""
        _, forward_fn, fp_sites = _family_spec(model)
        return cls(sites, scales, forward_fn, fp_sites, extras, dtype, device,
                   getattr(model, "row_rule", None))

    @classmethod
    def from_folded(cls, folded, scales, forward_fn, fp_sites, dtype=torch.bfloat16,
                    device="cuda") -> "QuantizedConvNet":
        sites = quantize_sites(folded, lambda n: n not in fp_sites and n in scales)
        return cls(sites, scales, forward_fn, fp_sites, folded.get("__extras__"), dtype,
                   device)

    def __call__(self, frames):
        x = frames.to(self.dtype)

        def qconv(t, name, **kw):
            return self._qconv(t, name, **kw)

        qconv.group = self.spatial_group
        if "extras" in self.qparams:
            return self.forward_fn(qconv, x, self.qparams["extras"])
        return self.forward_fn(qconv, x)


def tree_map(fn, tree):
    """``fn`` on each leaf of a nested dict (an artifact's ``extras``)."""
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _tree_to(tree, device):
    """A nested dict of arrays as float32 tensors on ``device``; a leaf of
    one value (a PReLU slope) as shape (1,)."""
    return tree_map(lambda v: torch.as_tensor(np.asarray(v, np.float32)).reshape(
        np.shape(v) or (1,)).to(device), tree)


def calibrate_graph(folded: Dict, forward_fn, fp_sites, calib_frames,
                    device="cuda") -> Dict[str, float]:
    """Per-site input absmax over the calibration frames via the fp folded
    graph (f32, TF32 off)."""
    graph = QuantizedConvNet.from_folded(folded, {}, forward_fn, fp_sites, torch.float32,
                                         device)
    return _absmax_over(graph, torch.as_tensor(np.asarray(calib_frames, np.float32)))


# -- CSRNet: a BN-free vgg16 front end and a dilated back end ------------------

def csrnet_fold(model) -> Dict:
    from dgvcc_tpu_torch.models.baselines.csrnet import BACKEND, FRONTEND

    folded = {}
    for stack, cfg in (("frontend", FRONTEND), ("backend", BACKEND)):
        convs = [m for m in getattr(model, stack) if isinstance(m, torch.nn.Conv2d)]
        assert len(convs) == sum(v != "M" for v in cfg)
        for i, conv in enumerate(convs):
            folded[f"{stack}/conv{i}"] = conv_site(conv)
    folded["output_layer"] = conv_site(model.output_layer)
    return folded


def csrnet_forward(qconv, x):
    from dgvcc_tpu_torch.models.baselines.csrnet import BACKEND, FRONTEND

    i = 0
    for v in FRONTEND:
        if v == "M":
            x = _maxpool(x)
        else:
            x = qconv(x, f"frontend/conv{i}")
            i += 1
    for i in range(len(BACKEND)):
        x = qconv(x, f"backend/conv{i}", dilation=2)
    return qconv(x, "output_layer", relu=False)


# -- MCNN: three columns, pools after convs 0-1 -------------------------------

_MCNN_BRANCHES = (("branch1", 4), ("branch2", 4), ("branch3", 4))


def mcnn_fold(model) -> Dict:
    folded = {}
    for bname, n in _MCNN_BRANCHES:
        col = getattr(model, bname)
        for i in range(n):
            folded[f"{bname}/conv{i}"] = conv_site(col[(0, 3, 6, 8)[i]])
    folded["fuse"] = conv_site(model.fuse[0])
    return folded


def mcnn_forward(qconv, x):
    outs = []
    for bname, n in _MCNN_BRANCHES:
        y = x
        for i in range(n):
            y = qconv(y, f"{bname}/conv{i}")
            if i < 2:
                y = _maxpool(y)
        outs.append(y)
    return qconv(outs, "fuse", relu=False)


# -- BL-VGG: vgg19 features, x2 up (align_corners), reg head, |.| --------------

def bl_fold(model) -> Dict:
    folded = {}
    for kind, idx, _ in feature_layout(tuple(VGG19_CFG[:-1]), model.batch_norm):
        if kind == "conv":
            bn = model.features[idx + 1] if model.batch_norm else None
            folded[f"features/conv{idx}"] = conv_site(model.features[idx], bn)
    for k, name in enumerate(("reg1", "reg2", "reg3")):
        folded[name] = conv_site(model.reg_layer[2 * k])
    return folded


def bl_forward(qconv, x, batch_norm: bool = False):
    for kind, idx, _ in feature_layout(tuple(VGG19_CFG[:-1]), batch_norm):
        if kind == "conv":
            x = qconv(x, f"features/conv{idx}")
        elif kind == "pool":
            x = _maxpool(x)
    x = _nchw(resize_bilinear_ac, x, (2 * x.shape[1], 2 * x.shape[2]),
              getattr(qconv, "group", None))
    x = qconv(x, "reg1")
    x = qconv(x, "reg2")
    return qconv(x, "reg3", relu=False).abs()


# -- SASNet: vgg16_bn in five stages, a U decoder, five heads ------------------

_SAS_SPLITS = (("features1", 0, 6), ("features2", 6, 13), ("features3", 13, 23),
               ("features4", 23, 33), ("features5", 33, 43))
_SAS_BRANCHES = ("branch1x1", "branch1x1_1", "branch3x3_1", "branch3x3_2",
                 "branch3x3dbl_1", "branch3x3dbl_2")


def sasnet_fold(model) -> Dict:
    folded = {}
    for st, lo, hi in _SAS_SPLITS:
        stage = getattr(model, st)
        for kind, idx, _ in feature_layout(VGG16_CFG, True):
            if kind == "conv" and lo <= idx < hi:
                folded[f"{st}/conv{idx}"] = conv_site(stage[idx - lo], stage[idx - lo + 1])
    # ConvRelu_0-9: de_pred5 .. de_pred1, two each; MultiBranch_i / Conv_i:
    # density_head(5 - i); ConvRelu_{10 + 2i, 11 + 2i}: confidence_head(5 - i)
    for i in range(10):
        folded[f"ConvRelu_{i}"] = conv_site(getattr(model, f"de_pred{5 - i // 2}")[i % 2].conv)
    for i in range(5):
        head = getattr(model, f"density_head{5 - i}")
        for b, branch in enumerate(_SAS_BRANCHES):
            basic = getattr(head[0], branch)
            folded[f"MultiBranch_{i}/BasicConv_{b}"] = conv_site(basic.conv, basic.bn)
        folded[f"Conv_{i}"] = conv_site(head[1].conv)
    for i in range(10, 20):
        conf = getattr(model, f"confidence_head{5 - (i - 10) // 2}")
        folded[f"ConvRelu_{i}"] = conv_site(conf[(i - 10) % 2].conv)
    return folded


def sasnet_forward(qconv, x, block_size: int = 32):
    from dgvcc_tpu_torch.models.baselines.sasnet import check_shard_rows, resize_nearest

    size_hw = x.shape[1:3]
    group = getattr(qconv, "group", None)
    if group is not None:
        check_shard_rows(size_hw[0], block_size)
    feats = []
    for st, lo, hi in _SAS_SPLITS:
        for kind, idx, _ in feature_layout(VGG16_CFG, True):
            if not lo <= idx < hi:
                continue
            if kind == "conv":
                x = qconv(x, f"{st}/conv{idx}")
            elif kind == "pool":
                x = _maxpool(x)
        feats.append(x)
    outs = [qconv(qconv(feats[4], "ConvRelu_0"), "ConvRelu_1")]
    for k, skip in enumerate(reversed(feats[:4]), 1):
        y = _nchw(resize_bilinear_ac, outs[-1], skip.shape[1:3], group)
        y = qconv([skip, y], f"ConvRelu_{2 * k}")
        outs.append(qconv(y, f"ConvRelu_{2 * k + 1}"))
    full = feats[0].shape[1:3]
    cells = (size_hw[0] // block_size, size_hw[1] // block_size)
    densities, confis = [], []
    for i, o in enumerate(outs):
        mb = f"MultiBranch_{i}/BasicConv_"
        b1 = qconv(qconv(o, mb + "0"), mb + "1")
        b3 = qconv(qconv(o, mb + "2"), mb + "3")
        b5 = qconv(qconv(o, mb + "4"), mb + "5")
        d = qconv([b1, b3, b5, o], f"Conv_{i}")  # the density 1x1 head is ReLU'd
        densities.append(_nchw(resize_nearest, d, full))
        cf = _nchw(F.adaptive_avg_pool2d, o, cells)
        cf = qconv(qconv(cf, f"ConvRelu_{10 + 2 * i}"), f"ConvRelu_{11 + 2 * i}", relu=False)
        confis.append(_nchw(resize_nearest, cf, full))
    conf = torch.softmax(torch.sigmoid(torch.cat(confis, dim=-1).float()), dim=-1)
    dens = torch.cat(densities, dim=-1).float()
    return (dens * conf).sum(dim=-1, keepdim=True)


# -- DSSINet: a shared VGG-PReLU pyramid and CRF message passing (BN-free) ------
# A shared stage runs once per pyramid chain (f1 / f2 / f3) and each
# message-passing conv once per iteration: every application is a site of its
# own (its own activation scale) over the same weights. PReLU slopes ride
# ``__extras__`` and stay fp.

_DSSI_STAGES = (("stage1", 2, False), ("stage2", 2, True), ("stage3", 3, True),
                ("stage4", 3, True))
_DSSI_PASSINGS = (("passing1", 2), ("passing2", 3), ("passing3", 3), ("passing4", 2))


def dssinet_fold(model) -> Dict:
    from dgvcc_tpu_torch.models.baselines.dssinet import STAGES

    feats = model.front_end.features
    folded: Dict[str, Any] = {}
    extras: Dict[str, np.ndarray] = {}
    for k, (sname, n, _) in enumerate(_DSSI_STAGES):
        convs, prelus = STAGES[k]
        for app in ("f1", "f2", "f3"):
            for i in range(n):
                folded[f"{sname}/conv{i}@{app}"] = conv_site(feats[convs[i]])
        for i in range(n - 1):
            extras[f"{sname}/prelu{i}"] = _np(feats[prelus[i]].weight)
    extras["stage1_act"] = _np(feats["relu3"].weight)
    extras["stage4_act"] = _np(feats["relu22"].weight)
    extras["out_prelu"] = _np(model.prelu.weight)
    for pname, n in _DSSI_PASSINGS:
        passing = getattr(model, pname)
        extras[f"{pname}/prelu"] = _np(passing.prelu.weight)
        for i in range(n):
            for j in range(n):
                if i != j:
                    for it in (0, 1):
                        folded[f"{pname}/w_0_{j}_{i}_0@it{it}"] = conv_site(
                            getattr(passing, f"w_0_{j}_{i}_0")[0].conv)
    for k in range(1, 6):
        dec = getattr(model, f"decoder{k}")
        folded[f"decoder{k}/c1"] = conv_site(dec[0].conv)
        folded[f"decoder{k}/c2"] = conv_site(dec[1].conv)
    for k in range(1, 5):
        folded[f"pw{k}"] = conv_site(getattr(model, f"passing_weight{k}").conv)
    folded["__extras__"] = extras
    return folded


def dssinet_forward(qconv, x, extras):
    group = getattr(qconv, "group", None)

    def prelu(t, name):
        a = extras[name].to(t.dtype)
        return torch.where(t >= 0, t, a * t)

    stage_map = {s: (n, pool) for s, n, pool in _DSSI_STAGES}

    def stage(t, sname, app):
        n, pool = stage_map[sname]
        if pool:
            t = _maxpool(t)
        for i in range(n):
            t = qconv(t, f"{sname}/conv{i}@{app}", relu=False)
            if i < n - 1:
                t = prelu(t, f"{sname}/prelu{i}")
        return t

    def passing(states, pname):
        hidden = list(states)
        for it in range(2):
            new = []
            for i in range(len(hidden)):
                binary = None
                for j in range(len(hidden)):
                    if i != j:
                        msg = qconv(hidden[j], f"{pname}/w_0_{j}_{i}_0@it{it}", relu=False)
                        binary = msg if binary is None else binary + msg
                new.append(F.relu(hidden[i] + prelu(binary, f"{pname}/prelu")))
            hidden = new
        return hidden

    def decoder(t, k):
        return qconv(qconv(t, f"decoder{k}/c1"), f"decoder{k}/c2", relu=False)

    h, w = x.shape[1:3]
    s1 = _nchw(resize_bilinear, x, (h * 2, w * 2), group)
    s3 = _nchw(resize_bilinear, x, (h // 2, w // 2), group)
    f1_c2 = stage(prelu(stage(s1, "stage1", "f1"), "stage1_act"), "stage2", "f1")
    f2_c1 = stage(x, "stage1", "f2")
    f1_c2, f2_c1 = passing([f1_c2, f2_c1], "passing1")
    agg4 = [f1_c2, f2_c1]
    f1_c3, f2_c2, f3_c1 = passing([stage(f1_c2, "stage3", "f1"), stage(f2_c1, "stage2", "f2"),
                                   stage(s3, "stage1", "f3")], "passing2")
    agg3 = [f1_c3, f2_c2, f3_c1]
    f1_c4, f2_c3, f3_c2 = passing([stage(f1_c3, "stage4", "f1"), stage(f2_c2, "stage3", "f2"),
                                   stage(f3_c1, "stage2", "f3")], "passing3")
    agg2 = [f1_c4, f2_c3, f3_c2]
    f2_c4, f3_c3 = passing([stage(f2_c3, "stage4", "f2"), stage(f3_c2, "stage3", "f3")],
                           "passing4")
    agg1 = [f2_c4, f3_c3]
    f3_c4 = prelu(stage(f3_c3, "stage4", "f3"), "stage4_act")
    dens = prelu(decoder(f3_c4, 1), "out_prelu")
    for k, agg in zip((2, 3, 4), (agg1, agg2, agg3)):
        dens = prelu(decoder(agg, k) + qconv(_up(dens, 2, group=group), f"pw{k - 1}",
                                             relu=False), "out_prelu")
    return F.relu(decoder(agg4, 5) + qconv(_up(dens, 2, group=group), "pw4", relu=False))


_WHITENING = ("int8 quantization supports the DG family and the conv(+BN) baselines "
              "csrnet/mcnn/bl/sasnet/dssinet/cctrans; got {} (whitening counters need "
              "instance statistics at eval and stay fp)")


def _family_spec(model):
    """(fold, forward, fp sites) of a baseline; None for a model without one.
    The fp sites are the tiny 1x1 heads and SASNet's confidence chains."""
    from dgvcc_tpu_torch.models.baselines.bl_vgg import BLVGG
    from dgvcc_tpu_torch.models.baselines.cctrans import ALTGVT
    from dgvcc_tpu_torch.models.baselines.csrnet import CSRNet
    from dgvcc_tpu_torch.models.baselines.dssinet import DSSINet
    from dgvcc_tpu_torch.models.baselines.mcnn import MCNN
    from dgvcc_tpu_torch.models.baselines.sasnet import SASNet

    if isinstance(model, CSRNet):
        return csrnet_fold, csrnet_forward, frozenset({"output_layer"})
    if isinstance(model, MCNN):
        return mcnn_fold, mcnn_forward, frozenset({"fuse"})
    if isinstance(model, BLVGG):
        bn = model.batch_norm
        return bl_fold, lambda qc, x: bl_forward(qc, x, bn), frozenset({"reg3"})
    if isinstance(model, SASNet):
        bs = model.block_size
        fp = frozenset({f"Conv_{i}" for i in range(5)}
                       | {f"ConvRelu_{i}" for i in range(10, 20)})
        return sasnet_fold, lambda qc, x: sasnet_forward(qc, x, block_size=bs), fp
    if isinstance(model, DSSINet):
        fp = frozenset({f"decoder{k}/c2" for k in range(1, 6)}
                       | {f"pw{k}" for k in range(1, 5)})
        return dssinet_fold, dssinet_forward, fp
    if isinstance(model, ALTGVT):
        from dgvcc_tpu_torch.nn.quant_cctrans import cctrans_fold, cctrans_forward

        geometry = dict(depths=model.depths, heads=model.num_heads, wss=model.wss,
                        sr_ratios=model.sr_ratios)
        return (cctrans_fold, lambda qc, x, ex: cctrans_forward(qc, x, ex, **geometry),
                frozenset({"reg_res2"}))
    return None


def family_min_batch(model) -> int:
    """The smallest dispatch batch at which ``quantize="auto"`` serves a
    family's int8 graph: CCTrans's ``CCTRANS_MIN_BATCH``, else 1."""
    from dgvcc_tpu_torch.models.baselines.cctrans import ALTGVT

    return CCTRANS_MIN_BATCH if isinstance(model, ALTGVT) else 1


def check_quantizable(model) -> None:
    """Raise unless ``build_quantized`` takes ``model``: ValueError for a
    family without an int8 graph."""
    from dgvcc_tpu_torch.models.dg import DGModel

    if not isinstance(model, DGModel) and _family_spec(model) is None:
        raise ValueError(_WHITENING.format(type(model).__name__))


def _shared(calibrate_fn: Callable, share=None):
    return calibrate_fn() if share is None else share(calibrate_fn)


def build_quantized(model, calib_frames, dtype=torch.bfloat16, device="cuda",
                    min_ch: int = 128, share=None):
    """Quantize a supported model for serving: the DG family ->
    ``QuantizedDG``; csrnet / mcnn / bl / sasnet / dssinet / cctrans ->
    ``QuantizedConvNet``, whose sites with fewer than ``min_ch`` input or
    output channels stay in the serving dtype (MCNN, 48 channels at most,
    keeps none; CCTrans's depthwise PEG, one input channel a group, always).
    The graph carries its family's ``int8_min_batch``. ``calib_frames``: NHWC
    float frames, normalised. ``share``: how the calibration's absmax
    readings are shared out on a mesh (``share(calibrate)`` runs it on rank
    0 and returns its result on every rank: ``parallel/serving.py::
    MeshCounts.rank0``); None: this process calibrates."""
    from dgvcc_tpu_torch.models.dg import DGModel

    if isinstance(model, DGModel):
        return QuantizedDG.from_model(model, calib_frames, dtype, device, share=share)
    spec = _family_spec(model)
    if spec is None:
        raise ValueError(_WHITENING.format(type(model).__name__))
    fold_fn, fwd_fn, fp_sites = spec
    folded = fold_fn(model)
    caps = _shared(lambda: calibrate_graph(folded, fwd_fn, fp_sites, calib_frames, device),
                   share)
    scales = {}
    for k, v in caps.items():
        _, _, cin, cout = folded[k]["kernel"].shape
        if min(cin, cout) >= min_ch:
            scales[k] = max(v, 1e-12) / 127.0
    sites = quantize_sites(folded, lambda n: n not in fp_sites and n in scales)
    q = QuantizedConvNet.of(model, sites, scales, folded.get("__extras__"), dtype, device)
    q.int8_min_batch = family_min_batch(model)
    return q
