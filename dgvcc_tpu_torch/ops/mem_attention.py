"""Prototype-memory attention, counterpart of dgvcc_tpu/ops/mem_attention.py.

    out = softmax_S(y . M / sqrt(K)) . M^T      y: (B, P, K), M: (K, S)

``memory_attention_fused`` launches the hand-written CUDA kernel
(``csrc/mem_attention.cu``) on a CUDA tensor. On a CPU tensor, which is
the caller's explicit choice, it computes ``memory_attention_reference``,
the plain PyTorch version. A CUDA tensor never takes the plain version:
the kernel launches or the call raises.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dgvcc_tpu_torch.ops import _build

LAUNCHES = 0
KERNEL_WIDTHS = (16, 32, 64, 128, 256)  # the K values csrc/mem_attention.cu instantiates
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def memory_attention_reference(y: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """Plain version: the logits and the softmax in float32; the attention
    rounded to y's dtype before the second product (a no-op in float32),
    as the bf16 kernel rounds p; that product in float32, the result cast
    back to y's dtype."""
    k = y.shape[-1]
    logits = torch.matmul(y.float(), mem.float()) / math.sqrt(k)
    attn = torch.softmax(logits, dim=-1).to(y.dtype).float()
    return torch.matmul(attn, mem.float().t()).to(y.dtype)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mem_attention")
        lib.mem_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mem_attention_fwd.restype = ctypes.c_int
        lib.mem_attention_error_string.argtypes = [ctypes.c_int]
        lib.mem_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def memory_attention_fused(y: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """y: (B, P, K) pixel features; mem: (K, S) prototypes -> (B, P, K)
    in y's dtype. Any P; K in ``KERNEL_WIDTHS``; bf16 or f32."""
    global LAUNCHES
    if y.dim() != 3 or mem.dim() != 2 or y.shape[-1] != mem.shape[0]:
        raise ValueError(f"memory_attention_fused: y {tuple(y.shape)} and "
                         f"mem {tuple(mem.shape)} do not form (B,P,K), (K,S)")
    if y.device.type == "cpu" and mem.device.type == "cpu":
        return memory_attention_reference(y, mem)
    if y.device.type != "cuda" or mem.device != y.device:
        raise ValueError(f"memory_attention_fused: y on {y.device}, mem on "
                         f"{mem.device}; both must be on one CUDA device or "
                         "both on the CPU")
    if y.dtype not in _DTYPE_CODE or mem.dtype != y.dtype:
        raise TypeError(f"memory_attention_fused takes bf16 or f32 y and mem "
                        f"of one dtype; got {y.dtype} and {mem.dtype}")
    b, p, k = y.shape
    if k not in KERNEL_WIDTHS:
        raise ValueError(f"memory_attention_fused: K={k} has no kernel "
                         f"instantiation (have {KERNEL_WIDTHS})")
    # contiguous rows from 16-byte aligned bases (the bf16 kernel's TMA
    # tensor maps need both)
    y, mem = y.contiguous(), mem.contiguous()
    if y.data_ptr() % 16:
        y = y.clone()
    s = mem.shape[1]
    if y.dtype == torch.bfloat16 and s % 8:
        # and a row pitch of M that is a multiple of 16 bytes: zero columns
        # up to a multiple of 8, which the kernel never reads (s >= S)
        mem = torch.nn.functional.pad(mem, (0, 8 - s % 8))
    elif mem.data_ptr() % 16:
        mem = mem.clone()
    out = torch.empty_like(y)
    lib = _kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mem_attention_fwd(y.data_ptr(), mem.data_ptr(), out.data_ptr(),
                                    b * p, k, s, mem.shape[1], _DTYPE_CODE[y.dtype],
                                    stream)
    if err:
        raise RuntimeError("mem_attention kernel launch failed: "
                           + lib.mem_attention_error_string(err).decode())
    LAUNCHES += 1
    return out
