"""Auxiliary losses, counterpart of dgvcc_tpu/losses/misc.py (reference
losses/{ortho,sim,lw,triplet}.py): the orthogonality loss of mode joint,
the triplet loss of mode discrimination, and the self-similarity,
instance-whitening and JSD-as-MSE losses of the JAX package's zoo."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ortho_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean^2 of the strictly upper triangle of Gram(x, y^T) (ortho.py:5-12);
    x, y (C, P). The mean runs over all C*C entries, zeros included, as the
    reference's."""
    return torch.triu(x @ y.T, diagonal=1).square().mean()


def sim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pixel self-similarity cross-entropy (sim.py:5-13): logits[b, p, q] =
    <y[:, p], x[:, q]> over (N, C, ...) inputs, axis 1 the classes, target
    the identity permutation."""
    n = x.shape[0]
    x_, y_ = x.reshape(n, x.shape[1], -1), y.reshape(n, y.shape[1], -1)
    logits = torch.einsum("bcp,bcq->bpq", y_, x_)
    labels = torch.arange(logits.shape[-1], device=x.device).expand(n, -1)
    return F.cross_entropy(logits, labels)


def lw_loss(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instance-whitening loss (lw.py:5-19): each (n, c) standardised over
    its pixels (unbiased variance), then the sum of the squared strictly
    upper Gram entries; ``mask`` broadcastable to (N, 1, P)."""
    n, c = x.shape[0], x.shape[1]
    x = x.reshape(n, c, -1)
    x = x - x.mean(dim=2, keepdim=True)
    x = x / torch.sqrt(x.var(dim=2, keepdim=True, unbiased=True) + 1e-5)
    if mask is not None:
        x = x * mask.reshape(n, 1, -1)
    return torch.triu(torch.einsum("bcp,bdp->bcd", x, x), diagonal=1).square().sum()


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 0.5) -> torch.Tensor:
    """Margin triplet loss on squared distances (reference losses/triplet.py:
    mean(max(margin + |a - p|^2 - |a - n|^2, 0))), rows of (B, C)."""
    d_p = ((anchor - positive) ** 2).sum(dim=1)
    d_n = ((anchor - negative) ** 2).sum(dim=1)
    return torch.clamp(margin + d_p - d_n, min=0.0).mean()


def jsd_loss(logits1: torch.Tensor, logits2: torch.Tensor) -> torch.Tensor:
    """JSD as the MSE of the prototype softmaxes (models/dg.py's jsd_as_mse),
    in float32."""
    p1 = torch.softmax(logits1.float(), dim=-1)
    p2 = torch.softmax(logits2.float(), dim=-1)
    return (p1 - p2).square().mean()
