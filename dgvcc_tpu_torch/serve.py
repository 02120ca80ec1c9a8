"""Video-stream serving on the GPU, counterpart of dgvcc_tpu/serve.py.

Host work stops at decoded uint8 frames. The frames cross to the card as
uint8 (pinned host memory, a non-blocking copy on a side stream), and
everything after runs there: normalize, pad to the shape bucket or cut
into tiles, the forward, and the masked per-frame count.

Usage:
    counter = VideoCounter.from_checkpoint("final", "ref.pth")
    counts = counter.count_frames(frames_uint8)   # (B, H, W, 3) uint8
    for c in counter.stream(frame_batches):       # pipelined streaming
        ...

Only the full-precision path is ported: a device mesh (``mesh`` /
``shard``) raises ``NotImplementedError`` (ROADMAP.md, Queue 1 item 1), as
do int8 (``quantize``), ``auto_threshold`` and ``from_artifact`` (item 2).
It serves every counting family of the port: the DG family, the whitening
counters, the regressors and the classic baselines (a model that predicts
at a coarser stride is masked at its own grid). For
the HTTP server (``serve_http.py``) a counter keeps ``quantized`` (None:
no int8 graph) and ``dispatches``, its batches by precision.
"""

from __future__ import annotations

import collections
import math
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from dgvcc_tpu_torch.core.registry import MODELS

_NOT_PORTED = "is not ported to dgvcc_tpu_torch yet; see ROADMAP.md, Queue 1"
_PARALLEL = f"{_NOT_PORTED} item 1"
_INT8 = f"{_NOT_PORTED} item 2"


def resolve_device(device="cuda") -> torch.device:
    """The device to serve on. CUDA unless the caller asks for the CPU;
    raises when CUDA is asked for and absent, never falling back."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda[:N] or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


class _Pending:
    """A dispatched batch's counts: a device-to-host copy in flight."""

    def __init__(self, counts: torch.Tensor):
        self.event = None
        if counts.is_cuda:
            self.host = torch.empty(counts.shape, dtype=counts.dtype,
                                    pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = counts

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


def serving_state_dict(path: str, model: torch.nn.Module):
    """(state_dict in the reference layout, whether it is the EMA shadow)
    of checkpoint ``path`` for ``model``: the shadow where the checkpoint
    keeps one (the port's sidecar, a JAX ``ema_params``), the raw weights
    otherwise. A reference checkpoint's keys that ``model`` never reads
    (isw's layer4) are dropped."""
    from dgvcc_tpu_torch.nn.convert import (drop_reference_unused, load_reference_pth,
                                            state_dict_from_flax)
    from dgvcc_tpu_torch.train.checkpoint import JAX_SUFFIX, sidecar_path
    from dgvcc_tpu_torch.train.jax_ckpt import read_jax_checkpoint

    if path.endswith(JAX_SUFFIX):
        loaded = read_jax_checkpoint(path)
        ema = "ema_params" in loaded
        return state_dict_from_flax(model, loaded["ema_params" if ema else "params"],
                                    loaded.get("batch_stats", {})), ema
    sd = drop_reference_unused(load_reference_pth(path), model)
    side = sidecar_path(path)
    shadow = (torch.load(side, map_location="cpu", weights_only=True).get("ema")
              if os.path.exists(side) else None)
    if shadow:
        sd.update(shadow)
    return sd, bool(shadow)


class VideoCounter:
    """Batched, shape-bucketed crowd counting over raw uint8 frames."""

    def __init__(self, model: torch.nn.Module, log_para: float = 1000.0,
                 bucket: int = 64, dtype: torch.dtype = torch.bfloat16,
                 quantize=False, tile_size: int = 768,
                 tile_threshold: int = 4096, mesh=None, shard: str = "batch",
                 auto_threshold: Optional[int] = None, device="cuda"):
        if quantize:
            raise NotImplementedError(f"int8 serving (quantize) {_INT8}")
        if mesh is not None or shard != "batch":
            raise NotImplementedError(f"mesh / spatial serving {_PARALLEL}")
        if auto_threshold is not None:
            raise NotImplementedError(f"auto_threshold (quantize='auto') {_INT8}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            # NHWC is the tensor cores' layout, and it makes the memory
            # bank's (B, P, K) view of its input a free permute
            self.model.to(memory_format=torch.channels_last)
            self._h2d = torch.cuda.Stream(self.device)
        self.log_para = log_para
        self.bucket = bucket
        self.dtype = dtype
        # frames whose larger side exceeds tile_threshold are cut into
        # tile_size x tile_size tiles forwarded as one batch; 0 disables
        self.tile_size = tile_size
        self.tile_threshold = tile_threshold
        # what the HTTP server reports: no int8 graph, batches by precision
        self.quantized = None
        self.dispatches = {"fp": 0, "int8": 0}

    @classmethod
    def from_checkpoint(cls, model_name: str, ckpt_path: Optional[str] = None,
                        log_para: float = 1000.0, dtype=torch.bfloat16,
                        quantize=False, tile_size: int = 768,
                        tile_threshold: int = 4096,
                        mesh=None, shard: str = "batch", bucket: int = 64,
                        auto_threshold: Optional[int] = None, device="cuda",
                        seed: int = 0, **model_params):
        """A counter for ``model_name`` with the weights of ``ckpt_path``,
        strict-loaded, or without one, random weights from ``seed``.
        ``ckpt_path``: a reference DGVCC ``.pth`` or one the port saved
        (same layout; the EMA shadow of its training-state sidecar, when
        there is one, in place of the raw parameters), or the JAX package's
        ``.ckpt`` (its ``ema_params`` when present)."""
        import dgvcc_tpu_torch.models  # noqa: F401

        resolve_device(device)
        model = MODELS.build(model_name, dtype=dtype, **model_params)
        if ckpt_path:
            sd, ema = serving_state_dict(str(ckpt_path), model)
            if ema:
                print("[serve ckpt] using EMA-averaged weights")
            model.load_state_dict(sd, strict=True)
        else:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(model, log_para=log_para, dtype=dtype, quantize=quantize,
                   tile_size=tile_size,
                   tile_threshold=tile_threshold, mesh=mesh, shard=shard,
                   bucket=bucket, auto_threshold=auto_threshold, device=device)

    @classmethod
    def from_artifact(cls, path: str, **kwargs):
        raise NotImplementedError(f"int8 serving artifacts {_INT8}")

    # ---- device-side steps ------------------------------------------------

    def _to_device(self, frames: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return host
        host = host.pin_memory()
        with torch.cuda.stream(self._h2d):
            dev = host.to(self.device, non_blocking=True)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self._h2d)
        dev.record_stream(compute)
        return dev

    def masked_counts(self, frames_u8: torch.Tensor, vh: torch.Tensor,
                      vw: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N,) counts over each element's valid
        extent (vh, vw), divided by log_para."""
        x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
        x = ((x - 0.5) / 0.5).to(self.dtype)  # Normalize(0.5, 0.5)
        out = self.model(x)
        d = (out[0] if isinstance(out, tuple) else out).float()
        h_idx = torch.arange(d.shape[2], device=d.device)[None, None, :, None]
        w_idx = torch.arange(d.shape[3], device=d.device)[None, None, None, :]
        scale_h = d.shape[2] / frames_u8.shape[1]
        scale_w = d.shape[3] / frames_u8.shape[2]
        mask = ((h_idx < vh[:, None, None, None] * scale_h)
                & (w_idx < vw[:, None, None, None] * scale_w))
        return (d * mask).sum(dim=(1, 2, 3)) / self.log_para

    def _pad(self, frames: torch.Tensor) -> torch.Tensor:
        """Zero-pad H and W up to multiples of ``bucket``."""
        b, h, w, c = frames.shape
        bh = math.ceil(h / self.bucket) * self.bucket
        bw = math.ceil(w / self.bucket) * self.bucket
        if (bh, bw) == (h, w):
            return frames
        out = frames.new_zeros((b, bh, bw, c))
        out[:, :h, :w] = frames
        return out

    def _tile(self, frames: torch.Tensor):
        """(B, H, W, 3) -> (B*T, t, t, 3) tiles, row-major per frame, and
        each tile's valid extents (vh, vw), each (B*T,)."""
        b, h, w, c = frames.shape
        t = self.tile_size
        nh, nw = math.ceil(h / t), math.ceil(w / t)
        padded = frames.new_zeros((b, nh * t, nw * t, c))
        padded[:, :h, :w] = frames
        tiles = (padded.reshape(b, nh, t, nw, t, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(b * nh * nw, t, t, c))
        dev = frames.device
        vh = (h - torch.arange(nh, device=dev) * t).clamp(0, t)
        vw = (w - torch.arange(nw, device=dev) * t).clamp(0, t)
        vh = vh[:, None].expand(nh, nw).reshape(-1).repeat(b)
        vw = vw[None, :].expand(nh, nw).reshape(-1).repeat(b)
        return tiles, vh, vw

    def _launch(self, frames: np.ndarray) -> _Pending:
        """Dispatch one batch; the counts come back through a pending copy."""
        b, h, w, _ = frames.shape
        self.dispatches["fp"] += 1
        with torch.inference_mode():
            dev = self._to_device(frames)
            if self.tile_size and max(h, w) > self.tile_threshold:
                tiles, vh, vw = self._tile(dev)
                counts = self.masked_counts(tiles, vh, vw).reshape(b, -1).sum(1)
            else:
                vh = torch.full((b,), h, device=dev.device)
                vw = torch.full((b,), w, device=dev.device)
                counts = self.masked_counts(self._pad(dev), vh, vw)
            return _Pending(counts)

    # ---- public API -------------------------------------------------------

    def count_frames(self, frames: np.ndarray) -> np.ndarray:
        """frames: (B, H, W, 3) uint8 -> (B,) predicted counts."""
        return self._launch(np.asarray(frames)).result()

    def stream(self, frame_batches: Iterable[np.ndarray],
               prefetch: int = 2) -> Iterator[np.ndarray]:
        """Pipelined streaming: keeps ``prefetch`` batches in flight so host
        decode and the uint8 upload overlap the card's compute."""
        in_flight = collections.deque()
        for frames in frame_batches:
            in_flight.append(self._launch(np.asarray(frames)))
            if len(in_flight) > prefetch:
                yield in_flight.popleft().result()
        while in_flight:
            yield in_flight.popleft().result()
