"""Auxiliary losses, counterpart of dgvcc_tpu/losses/misc.py: the triplet
loss of mode discrimination. The generator's ``ortho_loss`` comes with
mode joint (ROADMAP.md, Queue 1 item 1)."""

from __future__ import annotations

import torch


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 0.5) -> torch.Tensor:
    """Margin triplet loss on squared distances (reference losses/triplet.py:
    mean(max(margin + |a - p|^2 - |a - n|^2, 0))), rows of (B, C)."""
    d_p = ((anchor - positive) ** 2).sum(dim=1)
    d_n = ((anchor - negative) ** 2).sum(dim=1)
    return torch.clamp(margin + d_p - d_n, min=0.0).mean()
