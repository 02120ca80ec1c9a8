"""Two-view memory attention for training, counterpart of
dgvcc_tpu/ops/mem_attention_train.py.

    p_i      = softmax_S(y_i . M / sqrt(K))          float32
    out_i    = (p_i cast to M's dtype) . M^T         float32 sums, y's dtype
    loss_con = mean((p_1 - p_2) ** 2)                float32

``memory_attention_train`` is differentiable in y1, y2 and M. On CUDA
tensors its forward launches the hand-written forward kernel and its
backward the backward kernels (``csrc/mem_attention_train.cu``); neither
view's (B, P, S) probabilities reach device memory. On CPU tensors, the
caller's explicit choice, it computes ``memory_attention_train_reference``,
the plain PyTorch version, whose gradient plain autograd gives. A CUDA
tensor never takes the plain version: the kernels launch or the call
raises.

The backward takes each row's D = <dp_i, p_i>_S from what the forward
saves rather than from a sweep over S (the flash-attention identity):
<dout_i . M, p_i>_S = <dout_i, p_i . M^T>_K, which is <dout_i, out_i>_K up
to out's rounding, and the consistency term's share is gc (q_ii - q_12)
with the forward's row sums q = (<p1, p1>_S, <p2, p2>_S, <p1, p2>_S).
``saved_reference`` and ``dsum_reference`` are the plain versions of what
the forward saves (lse, q) and of that rule.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches (and nothing
else), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from dgvcc_tpu_torch.ops import _build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
KERNEL_WIDTHS = (16, 256)  # the K values csrc/mem_attention_train.cu instantiates
LAZY_LOG2 = 8.0  # its bf16 forward's kLazyF
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def memory_attention_train_reference(y1: torch.Tensor, y2: torch.Tensor,
                                     mem: torch.Tensor):
    """Plain version (the JAX package's einsum twin): float32 logits and
    softmax; the probabilities cast to M's dtype before the second
    product, summed in float32 and cast to y's dtype. (float64 inputs stay
    float64 throughout.)"""
    k = y1.shape[-1]
    acc = torch.promote_types(mem.dtype, torch.float32)
    mf = mem.to(acc)

    def view(y):
        logits = torch.matmul(y.to(acc), mf) / math.sqrt(k)
        p = torch.softmax(logits, dim=-1)
        out = torch.matmul(p.to(mem.dtype).to(acc), mf.t())
        return p, out.to(y.dtype)

    p1, out1 = view(y1)
    p2, out2 = view(y2)
    return out1, out2, torch.mean((p1 - p2) ** 2)


def saved_reference(y1: torch.Tensor, y2: torch.Tensor, mem: torch.Tensor):
    """What the forward kernel saves for the backward, in float32: lse
    (2, rows), each row's logsumexp of y_i . M / sqrt(K), and q (3, rows),
    each row's <p1, p1>_S, <p2, p2>_S and <p1, p2>_S."""
    k = y1.shape[-1]
    mf = mem.float()
    lse, p = [], []
    for y in (y1, y2):
        logits = torch.matmul(y.reshape(-1, k).float(), mf) / math.sqrt(k)
        lse.append(torch.logsumexp(logits, dim=-1))
        p.append(torch.softmax(logits, dim=-1))
    q = torch.stack([(p[0] * p[0]).sum(-1), (p[1] * p[1]).sum(-1), (p[0] * p[1]).sum(-1)])
    return torch.stack(lse), q


def online_forward_reference(y1: torch.Tensor, y2: torch.Tensor, mem: torch.Tensor,
                             chunk: int = 64):
    """The bf16 forward kernel's algorithm in plain PyTorch, for tests:
    (out1, out2, loss_con, lse, q) as ``memory_attention_train_forward``
    returns them, from one sweep over S in chunks of ``chunk`` prototypes.

    Per view, an online softmax: running max m, sum l and out accumulator
    o, rescaled by alpha = exp(m_old - m) when m moves, which it does only
    when a chunk's max passes it by more than ``LAZY_LOG2`` log2 units (so
    e < 2^LAZY_LOG2);
    o += round(e) . Mc^T with e = exp(logits - m) rounded to M's dtype (not
    the normalised p that the plain version rounds), out = o / l. The loss term and q
    without cancellation: with u_i = e_i / l_i in units of the running
    normaliser, the sums D = <u1 - u2, u1 - u2> and C = <u1 - u2, u2> over
    the chunks so far are carried to a new normaliser (u_i -> beta_i u_i,
    beta_i = alpha_i l_i / l_i') with U = <u2, u2> exactly:

        D' = beta1^2 D + 2 beta1 (beta1 - beta2) C + (beta1 - beta2)^2 U
        C' = beta1 beta2 C + beta2 (beta1 - beta2) U

    and at the end D is the row's sum of (p1 - p2)^2. q = (<u1, u1>, <u2,
    u2>, <u1, u2>) is summed directly beside them, each rescaled by its
    betas. Forming the loss term as q11 + q22 - 2 q12 instead cancels to
    f32 rounding once the views agree (see the tests)."""
    k = y1.shape[-1]
    acc = torch.promote_types(mem.dtype, torch.float32)
    mf = mem.to(acc)
    rows, s = y1.numel() // k, mem.shape[1]
    logits = [torch.matmul(y.reshape(rows, k).to(acc), mf) / math.sqrt(k) for y in (y1, y2)]
    m = [torch.full((rows, 1), -math.inf, dtype=acc) for _ in range(2)]
    l = [torch.zeros(rows, 1, dtype=acc) for _ in range(2)]
    o = [torch.zeros(rows, k, dtype=acc) for _ in range(2)]
    dd, dc, q11, q22, q12 = (torch.zeros(rows, 1, dtype=acc) for _ in range(5))
    for s0 in range(0, s, chunk):
        mc = mf[:, s0:s0 + chunk]
        e, beta, inv = [], [], []
        for i in range(2):
            lc = logits[i][:, s0:s0 + chunk]
            cmax = lc.amax(-1, keepdim=True)
            m_new = torch.where(cmax > m[i] + LAZY_LOG2 * math.log(2.0), cmax, m[i])
            alpha = torch.exp(m[i] - m_new)
            e.append(torch.exp(lc - m_new))
            l_new = alpha * l[i] + e[i].sum(-1, keepdim=True)
            o[i] = alpha * o[i] + torch.matmul(e[i].to(mem.dtype).to(acc), mc.t())
            beta.append(alpha * l[i] / l_new)
            inv.append(1.0 / l_new)
            m[i], l[i] = m_new, l_new
        b1, b2 = beta
        db = b1 - b2
        dd = b1 * b1 * dd + 2 * b1 * db * dc + db * db * q22
        dc = b1 * b2 * dc + b2 * db * q22
        q11, q22, q12 = b1 * b1 * q11, b2 * b2 * q22, b1 * b2 * q12
        u1, u2 = e[0] * inv[0], e[1] * inv[1]
        d = u1 - u2
        for acc_, x in ((dd, d * d), (dc, d * u2), (q11, u1 * u1), (q22, u2 * u2),
                        (q12, u1 * u2)):
            acc_ += x.sum(-1, keepdim=True)
    out1, out2 = ((o[i] / l[i]).to(y.dtype).reshape(y.shape) for i, y in enumerate((y1, y2)))
    lse = torch.cat([m[i] + torch.log(l[i]) for i in range(2)], 1).t().float()
    q = torch.cat([q11, q22, q12], 1).t().float()
    return out1, out2, (dd.sum() / (rows * s)).float(), lse, q


def dsum_reference(do1, do2, out1, out2, q, dcon, s: int) -> torch.Tensor:
    """The backward's D_i = <dp_i, p_i>_S (2, rows) float32, from the
    forward's outputs and q: <dout_i, out_i>_K + gc (q_ii - q_12), gc = 2 g /
    (rows * S) the consistency loss's chain factor."""
    rows = q.shape[1]
    gc = 2.0 * dcon.float() / (rows * s)
    dots = [(d.reshape(rows, -1).float() * o.reshape(rows, -1).float()).sum(-1)
            for d, o in ((do1, out1), (do2, out2))]
    return torch.stack([dots[0] + gc * (q[0] - q[2]), dots[1] + gc * (q[1] - q[2])])


def _bind(lib):
    """The C entry points' argument types on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mem_attention_train_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, i32, i32, i32, i32,
        ctypes.c_float, ptr]
    lib.mem_attention_train_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_longlong, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
    lib.mem_attention_train_fwd.restype = i32
    lib.mem_attention_train_bwd.restype = i32
    lib.mem_attention_train_tile.argtypes = [i32, i32]
    lib.mem_attention_train_tile.restype = i32
    lib.mem_attention_train_error_string.argtypes = [i32]
    lib.mem_attention_train_error_string.restype = ctypes.c_char_p
    return lib


def _kernel():
    global _lib
    if _lib is None:
        _lib = _bind(_build.load("mem_attention_train"))
    return _lib


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"mem_attention_train {what} kernel launch failed: "
                           + lib.mem_attention_train_error_string(err).decode())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous rows from a 16-byte aligned base (the kernels read
    16-byte vectors)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _pitched(mem: torch.Tensor, code: int) -> torch.Tensor:
    """M as the kernels read it: the bf16 kernels through a tensor map,
    whose rows must be 16-byte aligned, so its columns padded to a multiple
    of 8."""
    s = mem.shape[1]
    return torch.nn.functional.pad(mem, (0, 8 - s % 8)) if code == 1 and s % 8 else mem


def memory_attention_train_forward(y1, y2, mem):
    """Kernel #2 on validated, aligned CUDA tensors -> (out1, out2,
    loss_con, lse, q): lse (2, B*P) and q (3, B*P) float32 as
    ``saved_reference`` gives them."""
    global FWD_LAUNCHES
    lib = _kernel()
    b, p, k = y1.shape
    s = mem.shape[1]
    rows, code = b * p, _DTYPE_CODE[y1.dtype]
    dev = y1.device
    out1, out2 = torch.empty_like(y1), torch.empty_like(y2)
    lse = torch.empty(2, rows, dtype=torch.float32, device=dev)
    q = torch.empty(3, rows, dtype=torch.float32, device=dev)
    tile = lib.mem_attention_train_tile(code, 0)
    partial = torch.empty(-(-rows // tile), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    mem = _pitched(mem, code)
    with torch.cuda.device(dev):
        err = lib.mem_attention_train_fwd(
            y1.data_ptr(), y2.data_ptr(), mem.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), lse.data_ptr(), q.data_ptr(), partial.data_ptr(),
            loss.data_ptr(), rows, k, s, mem.shape[1], code, 1.0 / (rows * s), _stream(dev))
    _check(lib, err, "forward")
    FWD_LAUNCHES += 1
    return out1, out2, loss, lse, q


def _splits(rows: int, s: int, dtype: torch.dtype, device) -> int:
    """Row ranges of the dM kernel: S-slices x splits blocks make one wave
    on the card (one block per SM), at most one range per row tile."""
    lib = _kernel()
    code = _DTYPE_CODE[dtype]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    slices = -(-s // lib.mem_attention_train_tile(code, 1))
    row_tiles = -(-rows // lib.mem_attention_train_tile(code, 2))
    return max(1, min(n_sm // slices, row_tiles))


def memory_attention_train_backward(y1, y2, mem, lse, q, out1, out2, do1, do2, dcon):
    """Kernel #3 -> (dy1, dy2, dM), with lse, q, out1 and out2 from the
    forward: dout cast to y's dtype, dM summed in float32 and returned in
    M's dtype, as the JAX ``bwd_rule`` does."""
    global BWD_LAUNCHES
    lib = _kernel()
    b, p, k = y1.shape
    s = mem.shape[1]
    rows, code = b * p, _DTYPE_CODE[y1.dtype]
    dev = y1.device
    do1, do2 = _aligned(do1.to(y1.dtype)), _aligned(do2.to(y2.dtype))
    g = dcon.to(device=dev, dtype=torch.float32).reshape(()).contiguous()
    splits = _splits(rows, s, y1.dtype, dev)
    dy1, dy2 = torch.empty_like(y1), torch.empty_like(y2)
    dsum = torch.empty(2, rows, dtype=torch.float32, device=dev)
    scratch = torch.empty(splits, k, s, dtype=torch.float32, device=dev)
    dm = torch.empty(k, s, dtype=torch.float32, device=dev)
    mem = _pitched(mem, code)
    with torch.cuda.device(dev):
        err = lib.mem_attention_train_bwd(
            y1.data_ptr(), y2.data_ptr(), mem.data_ptr(), do1.data_ptr(),
            do2.data_ptr(), out1.data_ptr(), out2.data_ptr(), lse.data_ptr(),
            q.data_ptr(), g.data_ptr(), dy1.data_ptr(),
            dy2.data_ptr(), dsum.data_ptr(), scratch.data_ptr(), dm.data_ptr(),
            rows, k, s, mem.shape[1], code, splits, 2.0 / (rows * s), _stream(dev))
    _check(lib, err, "backward")
    BWD_LAUNCHES += 1
    return dy1, dy2, dm.to(mem.dtype)


class _MemoryAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y1, y2, mem):
        out1, out2, loss, lse, q = memory_attention_train_forward(y1, y2, mem)
        ctx.save_for_backward(y1, y2, mem, lse, q, out1, out2)
        return out1, out2, loss

    @staticmethod
    @once_differentiable
    def backward(ctx, do1, do2, dcon):
        return memory_attention_train_backward(*ctx.saved_tensors, do1, do2, dcon)


def memory_attention_train(y1: torch.Tensor, y2: torch.Tensor, mem: torch.Tensor):
    """y1, y2: (B, P, K) pixel features of the two views; mem: (K, S)
    prototypes -> (out1, out2, loss_con). Any P; K in ``KERNEL_WIDTHS``;
    y1, y2 and mem all bf16 or all f32."""
    if (y1.dim() != 3 or y1.shape != y2.shape or mem.dim() != 2
            or y1.shape[-1] != mem.shape[0]):
        raise ValueError(f"memory_attention_train: y1 {tuple(y1.shape)}, y2 "
                         f"{tuple(y2.shape)} and mem {tuple(mem.shape)} do not "
                         "form (B,P,K), (B,P,K), (K,S)")
    devices = {y1.device, y2.device, mem.device}
    if devices == {torch.device("cpu")}:
        return memory_attention_train_reference(y1, y2, mem)
    if len(devices) != 1 or y1.device.type != "cuda":
        raise ValueError(f"memory_attention_train: tensors on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device or all on the CPU")
    if y1.dtype not in _DTYPE_CODE or {y2.dtype, mem.dtype} != {y1.dtype}:
        raise TypeError(f"memory_attention_train takes bf16 or f32 y1, y2 and mem "
                        f"of one dtype; got {y1.dtype}, {y2.dtype} and {mem.dtype}")
    if y1.shape[-1] not in KERNEL_WIDTHS:
        raise ValueError(f"memory_attention_train: K={y1.shape[-1]} has no kernel "
                         f"instantiation (have {KERNEL_WIDTHS})")
    if y1.numel() == 0:
        raise ValueError("memory_attention_train: no rows")
    return _MemoryAttentionTrain.apply(_aligned(y1), _aligned(y2), _aligned(mem))
