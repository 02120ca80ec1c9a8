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

Int8 serving (``nn/quant.py``): ``quantize=True`` serves the int8 graph,
calibrated on ``calib_frames`` or lazily on the first batch;
``quantize="auto"`` keeps both graphs and picks one per dispatch
(``_prefers_int8``); ``from_artifact`` serves a saved int8 graph
(``nn/quant_io.py``). The int8 graphs run the hand-written int8 convolution
(``ops/qconv.py``) through the padded and the tiled path alike. It serves
every counting family of the port: the DG family, the whitening counters,
the regressors and the classic baselines (a model that predicts at a
coarser stride is masked at its own grid); int8 the DG family and csrnet,
mcnn, bl, sasnet, dssinet and cctrans. For the HTTP server
(``serve_http.py``) a counter keeps ``quantized`` (None: no int8 graph) and
``dispatches``, its batches by precision.

On a mesh (``mesh``: the process group of ``parallel/mesh.py::make_mesh``,
one process a rank; ``parallel/serving.py``) every rank calls the counter
with the same frames and gets the whole batch's counts back:

  * ``shard="batch"``, every family: the batch is padded with zero frames
    to a multiple of N and each rank forwards its rows (the tiled path: its
    frames' tiles); the counts are all-gathered and sliced back to B;
  * ``shard="spatial"``, the DG family and the baselines mcnn, csrnet,
    bl, sasnet and dssinet (fp and int8): each frame's height is padded to
    a multiple of lcm(bucket, R N), R the family's row rule
    (``parallel/spatial.py::row_rule``: 16 for the DG family), so that each
    rank's rows pool to whole rows, and each rank forwards its rows with halo
    exchanges (``parallel/spatial.py::shard_height``; the int8 graph's
    sites likewise); the tiled path splits each frame's tiles instead,
    padded with zero tiles of zero extent. Each rank masks its rows at
    their global offset and the partial sums are all-reduced.

Rank 0 calibrates an int8 graph and every rank takes its scales.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from dgvcc_tpu_torch.core.registry import MODELS

# quantize="auto": the smallest dispatch batch at which the int8 graph
# serves. None: int8 measured faster than bf16 at no batch: DGModel final at
# 768x1024 served 0.49-0.74x bf16's frames/s at B=1, 4 and 16 on an NVIDIA
# H100 80GB HBM3 at 700 W with the wgmma int8 kernel (0.33-0.53x with the
# first one; chip_smoke.py phase 14; PERF.md section 2): the int8 graph's
# activation quantize passes take more device time than its convolutions
# save (scripts/profile_torch_serve.py --quantize). So "auto" serves bf16
# under the default law. An integer auto_threshold opts a deployment into
# its own per-dispatch batch rule. The JAX package's constants (and its
# per-pixel floor) were measured on a TPU v5e and are not carried over.
AUTO_INT8_MIN_BATCH: Optional[int] = None


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


def upload(array: np.ndarray, device: torch.device, h2d) -> torch.Tensor:
    """``array`` as a tensor on ``device``; to the card from pinned memory,
    a non-blocking copy on the side stream ``h2d`` that the compute stream
    waits for."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    host = host.pin_memory()
    with torch.cuda.stream(h2d):
        dev = host.to(device, non_blocking=True)
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(h2d)
    dev.record_stream(compute)
    return dev


class _Pending:
    """A dispatched batch's counts: a device-to-host copy in flight, and on
    a mesh the collective that ``finish`` issues once they are read."""

    def __init__(self, counts: torch.Tensor, finish=None):
        self.finish = finish
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
        counts = self.host.numpy().copy()
        return counts if self.finish is None else self.finish(counts)


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

    def __init__(self, model: Optional[torch.nn.Module], log_para: float = 1000.0,
                 bucket: int = 64, dtype: torch.dtype = torch.bfloat16,
                 quantize=False, calib_frames: Optional[np.ndarray] = None,
                 tile_size: int = 768, tile_threshold: int = 4096, mesh=None,
                 shard: str = "batch", quantized=None,
                 auto_threshold: Optional[int] = None, device="cuda",
                 fold_model: Optional[torch.nn.Module] = None):
        """``fold_model``: the float32 twin of ``model`` whose weights the int8
        graph folds (``from_checkpoint`` builds one); default ``model``.
        ``quantized``: a built int8 graph (a loaded artifact); with one,
        ``model`` may be None, and then the counter holds no fp weights."""
        if shard not in ("batch", "spatial"):
            raise ValueError(f"shard must be 'batch' or 'spatial', got {shard!r}")
        self._row_rule = None
        if mesh is not None and shard == "spatial":
            from dgvcc_tpu_torch.parallel.spatial import row_rule

            self._row_rule = row_rule(model if model is not None else quantized)
        if quantize not in (False, True, "auto"):
            raise ValueError(f"quantize must be False, True or 'auto'; got {quantize!r}")
        self.auto = quantize == "auto"
        if self.auto and quantized is not None:
            raise ValueError("quantize='auto' needs fp weights; an int8 artifact carries "
                             "none (serve it with the default quantize)")
        if model is None and (quantized is None or self.auto):
            raise ValueError("a counter without a model serves a built int8 graph "
                             "(quantized=) under the default quantize")
        from dgvcc_tpu_torch.parallel.serving import MeshCounts, mesh_geometry

        self.mesh, self.shard = mesh, shard
        self.n_shards, self.rank = mesh_geometry(mesh)
        self.comm = None if mesh is None else MeshCounts(mesh)
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device).eval()
        if self._spatial and self.model is not None:
            from dgvcc_tpu_torch.parallel.spatial import shard_height

            shard_height(self.model, mesh)
        self._h2d = None
        if self.device.type == "cuda":
            if self.model is not None:
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
        self.auto_threshold = auto_threshold
        self.quantized = None if quantized is None else self._place(quantized)
        self._quant_pending = False
        self._fold_model = None
        self.dispatches = {"fp": 0, "int8": 0}  # batches by precision
        if quantize and quantized is None:
            from dgvcc_tpu_torch.nn.quant import check_quantizable

            check_quantizable(model)
            self._fold_model = fold_model if fold_model is not None else model
            if calib_frames is None:
                self._quant_pending = True
            else:
                self._build_quantized(np.asarray(calib_frames))

    def _build_quantized(self, calib_frames: np.ndarray):
        """Fold, calibrate and quantize on real frames (uint8, or already
        normalised float). The calibration crop is capped at 768x768 (a
        multiple of 64), as the JAX counter caps it: the absmax needs
        representative pixels, not a whole giant frame in f32."""
        from dgvcc_tpu_torch.nn.quant import build_quantized

        c = np.asarray(calib_frames)
        if c.dtype == np.uint8:  # the serving normalisation
            c = (c.astype(np.float32) / 255.0 - 0.5) / 0.5
        ch, cw = min(c.shape[1], 768), min(c.shape[2], 768)
        c = c[:, :max(ch - ch % 64, 64), :max(cw - cw % 64, 64)]
        share = None if self.comm is None else self.comm.rank0
        self.quantized = self._place(build_quantized(self._fold_model, c, dtype=self.dtype,
                                                     device=self.device, share=share))
        self._quant_pending = False
        self._fold_model = None

    @property
    def _spatial(self) -> bool:
        return self.mesh is not None and self.shard == "spatial"

    def _place(self, graph):
        """An int8 graph as this counter serves it: with its sites' rows
        sharded on a spatial mesh."""
        if self._spatial:
            from dgvcc_tpu_torch.parallel.spatial import shard_graph_height

            shard_graph_height(graph, self.mesh)
        return graph

    @contextlib.contextmanager
    def _whole_rows(self):
        """The model and the int8 graph without their rows sharded, for the
        whole tiles a spatial rank forwards on the tiled path."""
        from dgvcc_tpu_torch.parallel.spatial import shard_graph_height, shard_height

        def switch(group):
            if self.model is not None:
                shard_height(self.model, group)
            if self.quantized is not None:
                shard_graph_height(self.quantized, group)

        switch(None)
        try:
            yield
        finally:
            switch(self.mesh)

    def _tiled(self, h: int, w: int) -> bool:
        return bool(self.tile_size) and max(h, w) > self.tile_threshold

    def _dispatch_batch(self, frames: np.ndarray) -> int:
        """The batch of the forward a dispatch runs on each rank: its frames,
        or their tiles, of this rank's share (dgvcc_tpu/serve.py:277-299)."""
        b, h, w, _ = frames.shape
        n = self.n_shards
        if self._tiled(h, w):
            t = self.tile_size
            n_tiles = math.ceil(h / t) * math.ceil(w / t)
            if self.shard == "spatial" and n > 1:
                return b * math.ceil(n_tiles / n)  # each rank its share of the tiles
            b *= n_tiles
        if n > 1:
            # spatial: each rank holds 1/n of every frame's rows
            b = math.ceil(b / n) if self.shard == "batch" else max(math.ceil(b / n), 1)
        return b

    def _family_min_batch(self) -> int:
        """The graph's own batch floor (an artifact stores it); before
        calibration the family's (CCTrans 8): a CCTrans stream below it must
        not pay for a fold and a calibration the rule would never dispatch."""
        if self.quantized is not None:
            return getattr(self.quantized, "int8_min_batch", 1)
        from dgvcc_tpu_torch.nn.quant import family_min_batch

        return family_min_batch(self._fold_model)

    def _prefers_int8(self, frames: np.ndarray) -> bool:
        """quantize="auto"'s choice for this dispatch: int8 from the dispatch
        batch ``auto_threshold`` (an integer) or else ``AUTO_INT8_MIN_BATCH``
        (None: never), and never below the graph's own floor."""
        threshold = (AUTO_INT8_MIN_BATCH if self.auto_threshold is None
                     else int(self.auto_threshold))
        if threshold is None:
            return False
        return self._dispatch_batch(frames) >= max(threshold, self._family_min_batch())

    def _maybe_calibrate(self, frames: np.ndarray):
        """Lazy calibration on the first batch; in auto mode only once a
        dispatch would take the int8 graph."""
        if not self._quant_pending or (self.auto and not self._prefers_int8(frames)):
            return
        self._build_quantized(frames)

    def _select(self, frames: np.ndarray) -> bool:
        """Whether this dispatch runs the int8 graph; counted by precision."""
        use_q = self.quantized is not None and (not self.auto or self._prefers_int8(frames))
        self.dispatches["int8" if use_q else "fp"] += 1
        return use_q

    @classmethod
    def from_checkpoint(cls, model_name: str, ckpt_path: Optional[str] = None,
                        log_para: float = 1000.0, dtype=torch.bfloat16,
                        quantize=False, calib_frames: Optional[np.ndarray] = None,
                        tile_size: int = 768, tile_threshold: int = 4096,
                        mesh=None, shard: str = "batch", bucket: int = 64,
                        auto_threshold: Optional[int] = None, device="cuda",
                        seed: int = 0, **model_params):
        """A counter for ``model_name`` with the weights of ``ckpt_path``,
        strict-loaded, or without one, random weights from ``seed``.
        ``ckpt_path``: a reference DGVCC ``.pth`` or one the port saved
        (same layout; the EMA shadow of its training-state sidecar, when
        there is one, in place of the raw parameters), or the JAX package's
        ``.ckpt`` (its ``ema_params`` when present). With ``quantize`` the
        int8 graph folds a float32 twin of the same weights."""
        import dgvcc_tpu_torch.models  # noqa: F401

        resolve_device(device)

        def build(dt, say=False):
            model = MODELS.build(model_name, dtype=dt, **model_params)
            if ckpt_path:
                sd, ema = serving_state_dict(str(ckpt_path), model)
                if ema and say:
                    print("[serve ckpt] using EMA-averaged weights")
                model.load_state_dict(sd, strict=True)
            else:
                model.reset_parameters(torch.Generator().manual_seed(seed))
            return model

        model = build(dtype, say=True)
        fold = build(torch.float32) if quantize and dtype != torch.float32 else None
        return cls(model, log_para=log_para, dtype=dtype, quantize=quantize,
                   calib_frames=calib_frames, tile_size=tile_size,
                   tile_threshold=tile_threshold, mesh=mesh, shard=shard,
                   bucket=bucket, auto_threshold=auto_threshold, device=device,
                   fold_model=fold)

    @classmethod
    def from_artifact(cls, path: str, log_para: float = 1000.0, dtype=None,
                      tile_size: int = 768, tile_threshold: int = 4096, mesh=None,
                      shard: str = "batch", bucket: int = 64, device="cuda"):
        """Serve a saved int8 artifact (``nn/quant_io.py``): no checkpoint, no
        calibration frames, no fp weights. ``dtype`` overrides
        the stored serving dtype (float32 on the CPU)."""
        from dgvcc_tpu_torch.nn.quant_io import load_quantized

        art = load_quantized(path, dtype=dtype, device=resolve_device(device))
        return cls(None, log_para=log_para, bucket=bucket, dtype=art.quantized.dtype,
                   tile_size=tile_size, tile_threshold=tile_threshold, mesh=mesh,
                   shard=shard, quantized=art.quantized, device=device)

    # ---- device-side steps ------------------------------------------------

    def _to_device(self, frames: np.ndarray) -> torch.Tensor:
        return upload(frames, self.device, self._h2d)

    def masked_counts(self, frames_u8: torch.Tensor, vh: torch.Tensor,
                      vw: torch.Tensor, use_q: bool = False, row0: int = 0) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N,) counts over each element's valid
        extent (vh, vw), divided by log_para; ``use_q``: through the int8
        graph (NHWC in and out). ``row0``: the frame row of the first of
        ``frames_u8``'s rows (a spatial rank's share)."""
        x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
        x = ((x - 0.5) / 0.5).to(self.dtype)  # Normalize(0.5, 0.5)
        if use_q:
            out = self.quantized(x.permute(0, 2, 3, 1))
            d = (out[0] if isinstance(out, tuple) else out).permute(0, 3, 1, 2).float()
        else:
            out = self.model(x)
            d = (out[0] if isinstance(out, tuple) else out).float()
        h_idx = torch.arange(d.shape[2], device=d.device)[None, None, :, None]
        w_idx = torch.arange(d.shape[3], device=d.device)[None, None, None, :]
        scale_h = d.shape[2] / frames_u8.shape[1]
        scale_w = d.shape[3] / frames_u8.shape[2]
        mask = ((h_idx + row0 * scale_h < vh[:, None, None, None] * scale_h)
                & (w_idx < vw[:, None, None, None] * scale_w))
        return (d * mask).sum(dim=(1, 2, 3)) / self.log_para

    def _padded_hw(self, h: int, w: int):
        """The bucketed (H, W); on a spatial mesh H is a multiple of
        lcm(bucket, R N), each rank's rows a multiple of the family's row
        rule R (the JAX package pads to lcm(bucket, N): ROADMAP.md, Queue 3)."""
        hb = (math.lcm(self.bucket, self._row_rule * self.n_shards) if self._spatial
              else self.bucket)
        return math.ceil(h / hb) * hb, math.ceil(w / self.bucket) * self.bucket

    def _pad(self, frames: torch.Tensor, rows=None) -> torch.Tensor:
        """Zero-pad H and W up to the bucketed shape (``rows``: to that many
        rows instead)."""
        b, h, w, c = frames.shape
        bh, bw = self._padded_hw(h, w)
        bh = bh if rows is None else rows
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

    def _rank_tiles(self, frames: np.ndarray):
        """A spatial rank's share of each frame's tiles, cut on the host so
        that only they are uploaded: (B*k, t, t, 3) uint8 and each tile's
        valid extents (vh, vw), (B*k,) each. The tile list (row-major) is
        padded to a multiple of N with zero tiles of zero extent
        (dgvcc_tpu/serve.py:513-526)."""
        b, h, w, c = frames.shape
        t = self.tile_size
        nh, nw = math.ceil(h / t), math.ceil(w / t)
        per = math.ceil(nh * nw / self.n_shards)
        tiles = np.zeros((b, per, t, t, c), frames.dtype)
        valid = np.zeros((per, 2), np.int64)
        for k, i in enumerate(range(self.rank * per, (self.rank + 1) * per)):
            if i < nh * nw:
                r0, c0 = (i // nw) * t, (i % nw) * t
                piece = frames[:, r0:r0 + t, c0:c0 + t]
                tiles[:, k, :piece.shape[1], :piece.shape[2]] = piece
                valid[k] = piece.shape[1:3]
        valid = np.tile(valid, (b, 1))
        return tiles.reshape((b * per, t, t, c)), valid[:, 0], valid[:, 1]

    def _forward(self, frames: np.ndarray, use_q: bool) -> torch.Tensor:
        """This rank's counts of a batch: the whole batch's in one process;
        its frames' on a batch mesh; its partial sums of every frame on a
        spatial one."""
        b, h, w, _ = frames.shape
        dev = self.device
        if self._spatial and self._tiled(h, w):
            tiles, vh, vw = self._rank_tiles(frames)
            with self._whole_rows():
                counts = self.masked_counts(self._to_device(tiles),
                                            torch.from_numpy(vh).to(dev),
                                            torch.from_numpy(vw).to(dev), use_q)
            return counts.reshape(b, -1).sum(1)
        if self._spatial:
            rows = self._padded_hw(h, w)[0] // self.n_shards
            row0 = self.rank * rows
            mine = frames[:, row0:row0 + rows]
            x = (self._to_device(mine) if mine.shape[1]
                 else torch.zeros(mine.shape, dtype=torch.uint8, device=dev))
            vh = torch.full((b,), h, device=dev)
            vw = torch.full((b,), w, device=dev)
            return self.masked_counts(self._pad(x, rows), vh, vw, use_q, row0=row0)
        x = self._to_device(frames)
        if self._tiled(h, w):
            tiles, vh, vw = self._tile(x)
            return self.masked_counts(tiles, vh, vw, use_q).reshape(b, -1).sum(1)
        vh = torch.full((b,), h, device=dev)
        vw = torch.full((b,), w, device=dev)
        return self.masked_counts(self._pad(x), vh, vw, use_q)

    def _launch(self, frames: np.ndarray) -> _Pending:
        """Dispatch one batch; the counts come back through a pending copy
        (on a mesh, and the collective that completes them)."""
        b = frames.shape[0]
        self._maybe_calibrate(frames)
        use_q = self._select(frames)
        finish = None
        if self.mesh is not None and self.shard == "batch":
            from dgvcc_tpu_torch.parallel.mesh import shard_rows

            n = self.n_shards
            if b % n:  # zero frames, whose counts are dropped
                frames = np.concatenate(
                    [frames, np.zeros((n - b % n,) + frames.shape[1:], frames.dtype)])
            frames = frames[shard_rows(len(frames), self.rank, n)]

            def finish(counts):
                return self.comm.gather(counts)[:b]
        elif self.mesh is not None:
            finish = self.comm.sum
        with torch.inference_mode():
            return _Pending(self._forward(frames, use_q), finish)

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
