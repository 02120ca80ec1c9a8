"""Arbitrary-size evaluation by patch tiling, counterpart of
dgvcc_tpu/ops/tiling.py.

The same count semantics as the JAX package (reference utils/misc.py:47-67,
trainers/dgtrainer.py:71-84):

  1. an image with a side of at least ``patch_size`` is padded up to a
     multiple of the tile size with black pixels (``BLACK``, the normalized
     value of intensity 0) and cut into (T, ps, ps, 3) tiles, the tile
     count padded up to a bucket with black tiles;
  2. a smaller image is padded to multiples of ``bucket`` (128) and
     forwarded whole;
  3. the density on that padding is masked out (the dataset's own
     unit_size padding stays, for parity with the reference's metric)
     and the rest summed, divided by ``log_para``.

The serving path pads to multiples of 64 instead (``serve.py``), which
changes counts near the border: the two are not interchangeable.

Images arrive as NHWC numpy (the datasets' layout), are tiled on the
counter's device, and go through the model as NCHW. ``TiledCounter`` runs
the model in eval mode under ``torch.inference_mode()`` with every
``MemoryBank``'s serving kernel on (``fused``, kernel #1), whatever the
training state set, and puts both back afterwards.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch

from dgvcc_tpu_torch.models.dg import MemoryBank
from dgvcc_tpu_torch.serve import resolve_device

# value of a black pixel after Normalize(mean=0.5, std=0.5)
BLACK = -1.0


def _bucket(n: int, buckets=(1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / 16)) * 16


def tile_image(img: torch.Tensor, patch_size: int) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """img (H, W, C) -> (T_bucket, ps, ps, C) tiles, row-major, and
    (T_bucket, ps, ps, 1) masks that are 1 where a pixel came from the
    image; on img's device."""
    h, w, c = img.shape
    ps = patch_size
    nh, nw = math.ceil(h / ps), math.ceil(w / ps)
    t = nh * nw
    tb = _bucket(t)
    padded = img.new_full((nh * ps, nw * ps, c), BLACK)
    padded[:h, :w] = img
    mask = img.new_zeros((nh * ps, nw * ps, 1), dtype=torch.float32)
    mask[:h, :w] = 1.0
    tiles = padded.reshape(nh, ps, nw, ps, c).permute(0, 2, 1, 3, 4).reshape(t, ps, ps, c)
    masks = mask.reshape(nh, ps, nw, ps, 1).permute(0, 2, 1, 3, 4).reshape(t, ps, ps, 1)
    if tb > t:
        tiles = torch.cat([tiles, img.new_full((tb - t, ps, ps, c), BLACK)])
        masks = torch.cat([masks, masks.new_zeros((tb - t, ps, ps, 1))])
    return tiles, masks, nh, nw


def pool_mask_to(masks: torch.Tensor, d_shape) -> torch.Tensor:
    """Pool a full-resolution (N, 1, H, W) pixel mask to a model's (N, 1,
    h, w) density grid: a model that predicts at a coarser stride weights
    each density cell by its real-pixel fraction."""
    if masks.shape[2] == d_shape[2]:
        return masks
    n, _, mh, mw = masks.shape
    f = mh // d_shape[2]
    return masks.reshape(n, 1, d_shape[2], f, d_shape[3], f).mean(dim=(3, 5))


class TiledCounter:
    """Patch-tiled density counting of one model, which it moves to
    ``device`` (CUDA unless the caller asks for the CPU; raises when CUDA is
    asked for and absent).

    The model returns the density map (N, 1, H, W), or a tuple whose first
    element it is, at the tile's resolution (or a coarser stride)."""

    def __init__(self, model: torch.nn.Module, log_para: float, patch_size: int,
                 bucket: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.log_para = log_para
        self.patch_size = patch_size
        self.bucket = bucket  # whole-image mode pads H, W to this multiple

    @contextlib.contextmanager
    def evaluating(self):
        """Eval mode, inference mode, and the banks' serving kernel on;
        the model's mode and the banks' flags are put back on exit."""
        banks = [m for m in self.model.modules() if isinstance(m, MemoryBank)]
        fused = [b.fused for b in banks]
        was_training = self.model.training
        self.model.eval()
        for b in banks:
            b.fused = True
        try:
            with torch.inference_mode():
                yield
        finally:
            for b, f in zip(banks, fused):
                b.fused = f
            self.model.train(was_training)

    def forward(self, tiles: torch.Tensor):
        """NHWC tiles on the device -> the model's output (call inside
        ``evaluating``)."""
        return self.model(tiles.permute(0, 3, 1, 2))

    def _density(self, tiles: torch.Tensor) -> torch.Tensor:
        out = self.forward(tiles)
        return (out[0] if isinstance(out, tuple) else out).float()

    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(img)).to(self.device)

    def _whole_image(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad H, W to multiples of ``bucket``: (1, bh, bw, C) and its
        (1, bh, bw, 1) mask."""
        h, w, c = img.shape
        bh = math.ceil(h / self.bucket) * self.bucket
        bw = math.ceil(w / self.bucket) * self.bucket
        padded = img.new_full((bh, bw, c), BLACK)
        padded[:h, :w] = img
        mask = img.new_zeros((bh, bw, 1), dtype=torch.float32)
        mask[:h, :w] = 1.0
        return padded[None], mask[None]

    def _tiles(self, img: torch.Tensor):
        h, w, _ = img.shape
        if h >= self.patch_size or w >= self.patch_size:
            return tile_image(img, self.patch_size)
        tiles, masks = self._whole_image(img)
        return tiles, masks, 0, 0

    def count(self, img: np.ndarray) -> float:
        """Predicted count of one (H, W, 3) normalized image."""
        with self.evaluating():
            tiles, masks, _, _ = self._tiles(self._upload(img))
            d = self._density(tiles)
            masks = pool_mask_to(masks.permute(0, 3, 1, 2), d.shape)
            return float((d * masks).sum() / self.log_para)

    def density_map(self, img: np.ndarray) -> np.ndarray:
        """Stitched density map (reference dgtrainer.py:104-120). A model
        that predicts at a coarser stride f gives an f-times smaller map."""
        h, w, _ = img.shape
        ps = self.patch_size
        with self.evaluating():
            tiles, _, nh, nw = self._tiles(self._upload(img))
            d = self._density(tiles)[:, 0]
        if nh:
            f = ps // d.shape[1]
            psd = ps // f
            d = d[: nh * nw].reshape(nh, nw, psd, psd).permute(0, 2, 1, 3)
            d = d.reshape(nh * psd, nw * psd)
        else:
            d = d[0]
            f = tiles.shape[1] // d.shape[0]
        return d[: h // f, : w // f].cpu().numpy()
