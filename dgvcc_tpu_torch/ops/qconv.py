"""Int8 convolution with a fused epilogue: the int8 serving path's convolution.

    acc = conv(xq, w8)                    int8 x int8 -> int32, SAME, stride u
    y   = float(acc) * (ws * s) + bias    [, ReLU]  -> f32 or bf16

SAME is flax's / XLA's: ceil(n / u) outputs on a side of n, the zeros
``max((ceil(n / u) - 1) u + (k - 1) d + 1 - n, 0)`` split with the smaller
half low (``same_padding``). Windows are odd, or even at their own stride
(k x k at stride k: CCTrans's patch embeddings and GSA's sr convolutions).

No Pallas kernel of the JAX package computes this: there XLA runs it
(``dgvcc_tpu/nn/quant.py:290-295`` and ``:508-514``, ``conv_general_dilated``
of int8 operands with ``preferred_element_type=int32`` and the f32
epilogue). PyTorch has no CUDA int8 convolution, so ``qconv_int8`` launches
the hand-written kernel ``csrc/qconv.cu`` (s8 wgmma fed by TMA) on a CUDA
tensor. On a CPU tensor, the caller's explicit choice, it computes
``qconv_int8_reference``, the plain PyTorch version. A CUDA tensor never
takes the plain version: the kernel launches or the call raises.

The kernel's tensor maps need Cin to be a multiple of 16 (TMA's 16-byte
strides). ``qconv_int8`` pads any other Cin with zero channels first
(``pad_cin``), which leaves the accumulator exact; the int8 graphs pad a
site's weights once when they place it (``nn/quant.py::_place``), so that a
call pads only its activations.

Layouts: ``xq`` (N, H, W, Cin) int8 (channels last, as the JAX graph's
NHWC), ``w8`` (Cout, kh, kw, Cin) int8, ``ws`` and ``bias`` (Cout,) f32,
``s`` the site's activation scale; the output is (N, ceil(H / u),
ceil(W / u), Cout).
``quantize_activation`` is the JAX graph's ``q8``:
``clip(round(x_f32 / s), -127, 127)``, a true division and rounding half to
even.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.

``qconv_int8`` is also the ``torch.library`` custom op
``dgvcc_tpu_torch::qconv_int8`` (CPU: the plain version; CUDA: the kernel;
a fake implementation for the output's shape and dtype), which the wrapper
emits only while ``torch.export`` traces (``nn/aot.py``), so that an
exported int8 graph holds the op and not a float64 convolution. Eager calls
skip the dispatcher: an int8 forward makes one call a site.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from dgvcc_tpu_torch.ops import _build

LAUNCHES = 0
# the largest stride: TMA's element strides, by which the kernel reads a
# strided window, stop at 8
MAX_STRIDE = 8
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def quantize_activation(x: torch.Tensor, s: float) -> torch.Tensor:
    """int8 of ``clip(round(float32(x) / s), -127, 127)``. ``s`` goes in as a
    float32 tensor on x's device: a true division (a CPU scalar would let
    the CUDA division multiply by its reciprocal), rounding half to even."""
    st = torch.tensor(s, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / st), -127, 127).to(torch.int8)


def same_padding(n: int, k: int, dilation: int = 1, stride: int = 1) -> Tuple[int, int]:
    """(low, high) zeros of flax's / XLA's 'SAME' on a side of ``n``."""
    total = max((-(-n // stride) - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def conv_acc_reference(xq: torch.Tensor, w8: torch.Tensor, dilation: int = 1,
                       stride: int = 1) -> torch.Tensor:
    """The int32 accumulator: ``F.conv2d`` in float64 on the int8 values,
    which is exact (|acc| <= 127^2 kh kw Cin < 2^53), rounded and cast."""
    (t, b), (l, r) = (same_padding(xq.shape[1], w8.shape[1], dilation, stride),
                      same_padding(xq.shape[2], w8.shape[2], dilation, stride))
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (l, r, t, b))
    y = F.conv2d(x, w8.permute(0, 3, 1, 2).double(), stride=stride, dilation=dilation)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def epilogue_reference(acc: torch.Tensor, ws: torch.Tensor, s: float, bias: torch.Tensor,
                       relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """``float(acc) * (ws * s) + bias``, each product and sum rounded to
    float32 on its own, then ReLU and the cast (round to nearest even)."""
    st = torch.tensor(s, dtype=torch.float32, device=acc.device)
    y = acc.float() * (ws.float() * st)
    y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def qconv_int8_reference(xq, w8, ws, s, bias, relu: bool = True, dilation: int = 1,
                         out_dtype: torch.dtype = torch.bfloat16, acc: bool = False,
                         stride: int = 1):
    """Plain version of ``qconv_int8`` (same arguments)."""
    a = conv_acc_reference(xq, w8, dilation, stride)
    return a if acc else epilogue_reference(a, ws, s, bias, relu, out_dtype)


def pad_cin(t: torch.Tensor, cin: int = None) -> torch.Tensor:
    """``t`` (..., C) with zero channels added up to ``cin`` (default: the
    next multiple of 16); ``t`` itself when nothing is added."""
    c = t.shape[-1]
    cin = -(-c // 16) * 16 if cin is None else cin
    return t if cin == c else F.pad(t, (0, cin - c))


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("qconv")
        lib.qconv_int8_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.qconv_int8_fwd.restype = ctypes.c_int
        lib.qconv_int8_plan.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        lib.qconv_int8_plan.restype = ctypes.c_int
        lib.qconv_int8_error_string.argtypes = [ctypes.c_int]
        lib.qconv_int8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def plan(xq_shape, w8_shape, dilation: int = 1, stride: int = 1) -> dict:
    """The schedule and tiling the kernel takes for these shapes (it needs
    the card: the choice reads its SM count): {schedule ("halo" or
    "per_tap"), bn, bk, tw, th, stages}; Cin padded as ``qconv_int8`` pads
    it. The shapes alone decide: see ``csrc/qconv.cu``."""
    n, h, w, cin = xq_shape
    cout, kh, kw, _ = w8_shape
    out = (ctypes.c_int * 6)()
    err = _kernel().qconv_int8_plan(n, h, w, -(-cin // 16) * 16, cout, kh, kw, dilation, stride,
                                    out)
    if err:
        raise ValueError(f"qconv_int8: no schedule for {xq_shape}, {w8_shape}: "
                         + _kernel().qconv_int8_error_string(err).decode())
    return dict(schedule="halo" if out[0] else "per_tap", bn=out[1], bk=out[2], tw=out[3],
                th=out[4], stages=out[5])


def qconv_int8(xq: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor, s: float,
               bias: torch.Tensor, relu: bool = True, dilation: int = 1,
               out_dtype: torch.dtype = torch.bfloat16, acc: bool = False,
               stride: int = 1) -> torch.Tensor:
    """xq (N, H, W, Cin) int8, w8 (Cout, kh, kw, Cin) int8 with odd kh, kw
    (or kh = kw = ``stride``), ws / bias (Cout,) f32, s the activation
    scale -> y (N, ceil(H / stride), ceil(W / stride), Cout) in ``out_dtype``
    (f32 or bf16), SAME padding. ``acc=True``: the int32 accumulator alone."""
    if xq.dim() != 4 or w8.dim() != 4 or xq.shape[-1] != w8.shape[-1]:
        raise ValueError(f"qconv_int8: xq {tuple(xq.shape)} and w8 {tuple(w8.shape)} do not "
                         "form (N, H, W, Cin), (Cout, kh, kw, Cin)")
    if xq.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"qconv_int8 takes int8 xq and w8; got {xq.dtype} and {w8.dtype}")
    cout, kh, kw, _ = w8.shape
    if (dilation < 1 or not 1 <= stride <= MAX_STRIDE
            or not (kh % 2 == kw % 2 == 1 or kh == kw == stride)):
        raise ValueError(f"qconv_int8: a {kh}x{kw} window, dilation {dilation}, stride "
                         f"{stride}; it takes dilation >= 1, stride 1 to {MAX_STRIDE}, and odd "
                         "windows or a k x k window at stride k")
    if not acc and (ws.shape != (cout,) or bias.shape != (cout,)):
        raise ValueError(f"qconv_int8: ws {tuple(ws.shape)}, bias {tuple(bias.shape)} for "
                         f"Cout={cout}")
    if not acc and out_dtype not in _OUT_KIND:
        raise TypeError(f"qconv_int8 writes f32 or bf16, not {out_dtype}")
    if torch.compiler.is_exporting():
        return torch.ops.dgvcc_tpu_torch.qconv_int8(xq, w8, ws, float(s), bias, relu, dilation,
                                                    out_dtype, acc, stride)
    tensors = (xq, w8) if acc else (xq, w8, ws, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return qconv_int8_reference(xq, w8, ws, s, bias, relu, dilation, out_dtype, acc, stride)
    return _launch(xq, w8, ws, s, bias, relu, dilation, out_dtype, acc, stride)


def _launch(xq: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor, s: float,
            bias: torch.Tensor, relu: bool, dilation: int, out_dtype: torch.dtype,
            acc: bool, stride: int) -> torch.Tensor:
    """The kernel on CUDA tensors (checked here); counts the launch."""
    global LAUNCHES
    tensors = (xq, w8) if acc else (xq, w8, ws, bias)
    if xq.device.type != "cuda" or any(t.device != xq.device for t in tensors):
        raise ValueError("qconv_int8: every tensor must be on one CUDA device, or all on "
                         "the CPU")
    n, h, w, _ = xq.shape
    cout, kh, kw, _ = w8.shape
    xq, w8 = pad_cin(xq).contiguous(), pad_cin(w8).contiguous()
    xq, w8 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xq, w8))
    if not acc:
        ws = ws.to(torch.float32).contiguous()
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=torch.int32 if acc else out_dtype, device=xq.device)
    lib = _kernel()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qconv_int8_fwd(
            xq.data_ptr(), w8.data_ptr(), 0 if acc else ws.data_ptr(),
            0 if acc else bias.data_ptr(), 0.0 if acc else float(s), out.data_ptr(),
            n, h, w, xq.shape[-1], cout, kh, kw, dilation, stride, int(relu),
            2 if acc else _OUT_KIND[out_dtype], stream)
    if err:
        raise RuntimeError("qconv_int8 kernel launch failed: "
                           + lib.qconv_int8_error_string(err).decode())
    LAUNCHES += 1
    return out


@torch.library.custom_op("dgvcc_tpu_torch::qconv_int8", mutates_args=(), device_types="cpu")
def _qconv_int8_op(xq: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor, s: float,
                   bias: torch.Tensor, relu: bool, dilation: int, out_dtype: torch.dtype,
                   acc: bool, stride: int) -> torch.Tensor:
    return qconv_int8_reference(xq, w8, ws, s, bias, relu, dilation, out_dtype, acc, stride)


_qconv_int8_op.register_kernel("cuda")(_launch)


@_qconv_int8_op.register_fake
def _(xq, w8, ws, s, bias, relu, dilation, out_dtype, acc, stride):
    n, h, w, _ = xq.shape
    return xq.new_empty((n, -(-h // stride), -(-w // stride), w8.shape[0]),
                        dtype=torch.int32 if acc else out_dtype)
