"""Pixel MSE count loss, counterpart of dgvcc_tpu/losses/count.py.

``nn.MSELoss`` on the predicted density map against the ground-truth map
times ``log_para`` (reference trainers/dgtrainer.py:50-57), in float32.
The x1000 scale keeps densities of about 1e-4 clear of bf16's rounding
near zero.
"""

from __future__ import annotations

import dataclasses

import torch

from dgvcc_tpu_torch.core.registry import LOSSES


def mse_count_loss(pred: torch.Tensor, gt_dmap: torch.Tensor, log_para: float = 1000.0,
                   weights=None) -> torch.Tensor:
    pred = pred.float()
    gt = gt_dmap.float() * log_para
    if weights is not None:
        pred = pred * weights
        gt = gt * weights
    return torch.mean((pred - gt) ** 2)


@dataclasses.dataclass
class MSECountLoss:
    """The reference's 'mse' loss entry (main.py:54-55)."""

    reduction: str = "mean"  # accepted for YAML compatibility; only 'mean' is used

    kind = "mse"

    def __call__(self, pred, gt_dmap, log_para: float = 1000.0, weights=None):
        return mse_count_loss(pred, gt_dmap, log_para, weights)


LOSSES.register("mse", lambda **kw: MSECountLoss(**kw))
