"""Data-parallel evaluation, counterpart of dgvcc_tpu/parallel/eval.py:
an image's tile batch shared out over the ranks.

Every rank walks the whole validation or test set. For each image,
``ShardedTiledCounter.count`` tiles it as ``TiledCounter`` does, pads the
tiles with zero tiles (and zero masks) to a multiple of the number of
ranks, counts its contiguous share through the model (kernel #1 for a
memory-bank model), and all-reduces the masked sums: every rank gets the
same count, so the criterion, the best epoch and the early stop agree.
``density_map``, ``_whole_image`` and ``forward`` (vis, the ISW covariance
pass, the generator's reconstruction) stay on the rank's own counter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dgvcc_tpu_torch.ops.tiling import TiledCounter, pool_mask_to
from dgvcc_tpu_torch.parallel.mesh import shard_rows


class ShardedTiledCounter(TiledCounter):
    """``TiledCounter`` whose ``count`` shares the tiles over ``group``'s
    ranks (call it on every rank, in the same order)."""

    def __init__(self, model: torch.nn.Module, log_para: float, patch_size: int,
                 group=None, bucket: int = 128, device="cuda"):
        super().__init__(model, log_para, patch_size, bucket=bucket, device=device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def count(self, img: np.ndarray) -> float:
        with self.evaluating():
            tiles, masks, _, _ = self._tiles(self._upload(img))
            pad = (-tiles.shape[0]) % self.world
            if pad:
                tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])])
                masks = torch.cat([masks, masks.new_zeros((pad,) + masks.shape[1:])])
            rows = shard_rows(tiles.shape[0], self.rank, self.world)
            d = self._density(tiles[rows])
            masks = pool_mask_to(masks[rows].permute(0, 3, 1, 2), d.shape)
            local = ((d * masks).sum() / self.log_para).reshape(1)
            dist.all_reduce(local, group=self.group)
            return float(local)
