"""Bayesian loss (Ma et al. 2019), counterpart of dgvcc_tpu/losses/bayesian.py
(reference losses/bl.py), batched over padded points:

  * the posterior of each density cell p over the annotations n of its
    image, softmax_n(-|cell_p - point_n|^2 / (2 sigma^2)), padded points
    masked out; with ``use_background`` a background row (st_size *
    background_ratio - sqrt(min_n dis))^2, present only where the image has
    a point (bl.py:38-42);
  * each point's expected count, the posterior times the density;
  * per image the L1 of target - expected with the reference's trimming
    (bl.py:75-78): of the first count - 1 entries the ceil(0.9 (count - 1))
    smallest are kept (a stable sort ranks ties by position, as the JAX
    package's), the last always; an image without points gives |sum(pred)|;
  * the mean over the batch.

``stride``: the density's stride on the ``c_size`` crop. When the config
leaves it out it is read from the prediction, ``c_size // h``, and a
prediction whose side does not divide ``c_size`` raises. The JAX loss
defaults ``stride: 1`` instead, which fails on any stride-8 model (ROADMAP.md,
Queue 3). The posterior is float32 and takes no gradient; the loss's
gradient reaches the prediction only.

On a rank's rows of the crop (``over_rows``, ``mesh: {spatial: N}``) the
cell centres carry the rank's row offset, each cell's posterior is its own,
and each point's expected count, the background's and a pointless image's
sum of the density are summed over the group (``sum_over_ranks``, whose
backward sums too): every rank computes the one-process loss.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from dgvcc_tpu_torch.core.registry import LOSSES
from dgvcc_tpu_torch.nn.collectives import sum_over_ranks

NEG = -1e30


def _posterior(points, mask, st_sizes, cood_y, cood_x, sigma, bg_ratio, use_bg):
    """(B, N + 1, R * C): each cell's distribution over the points and the
    background row (last; all zero without ``use_bg``). points (B, N, 2) xy,
    mask (B, N), cood_y (R,) and cood_x (C,) the cells' centres."""
    b, n, _ = points.shape
    c = cood_y.shape[0] * cood_x.shape[0]
    x_dis = (points[..., 0:1] - cood_x) ** 2                     # (B, N, C)
    y_dis = (points[..., 1:2] - cood_y) ** 2                     # (B, N, R)
    dis = (y_dis[..., :, None] + x_dis[..., None, :]).reshape(b, n, c)
    logits = torch.where(mask[..., None], -dis / (2.0 * sigma ** 2), NEG)
    if use_bg:
        min_dis = torch.where(mask[..., None], dis, -NEG).amin(dim=1, keepdim=True).clamp(min=0)
        bg = -(st_sizes[:, None, None] * bg_ratio - torch.sqrt(min_dis)) ** 2 / (2.0 * sigma ** 2)
        bg = torch.where(mask.any(dim=1)[:, None, None], bg, NEG)
    else:
        bg = torch.full((b, 1, c), NEG, device=points.device)
    logits = torch.cat([logits, bg], dim=1)
    m = logits.amax(dim=1, keepdim=True)
    e = torch.exp(logits - m.clamp(min=NEG / 2))
    denom = e.sum(dim=1, keepdim=True)
    return torch.where(denom > 0, e / denom.clamp(min=1e-30), 0.0)


def _trimmed_l1(res, count):
    """res (B, M) with the live rows first; count (B,) live rows. The
    ceil(0.9 (count - 1)) smallest of rows 0 .. count - 2, plus row
    count - 1."""
    m = res.shape[1]
    idx = torch.arange(m, device=res.device)
    live = idx < (count[:, None] - 1)
    num = torch.ceil(torch.tensor(0.9, dtype=torch.float32) * (count.float() - 1.0)).long()
    order = torch.argsort(torch.where(live, res, 3e38).detach(), dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(1, order, idx.expand_as(order).contiguous())
    keep = live & (ranks < num[:, None])
    last = idx == (count[:, None] - 1)
    return torch.where(keep, res, 0.0).sum(dim=1) + torch.where(last, res, 0.0).sum(dim=1)


@dataclasses.dataclass
class BayesianLoss:
    """Registered as ``bl``. Call with padded batches: points (B, N, 2),
    masks (B, N), targets (B, N), st_sizes (B,), pred (B, 1, h, w) with
    h = w = c_size / stride."""

    sigma: float = 8.0
    c_size: int = 320
    stride: Optional[int] = None
    background_ratio: float = 0.15
    use_background: bool = True

    kind = "bl"
    # the spatial group whose ranks hold the prediction's rows (over_rows)
    group = None

    def __post_init__(self):
        if self.stride is not None and self.c_size % self.stride:
            raise ValueError(f"bl: stride {self.stride} does not divide c_size {self.c_size}")

    def over_rows(self, group) -> "BayesianLoss":
        """This loss on a rank's rows of the crop, over ``group``."""
        loss = copy.copy(self)
        loss.group = group
        return loss

    def stride_for(self, h: int) -> int:
        """The stride of a prediction with ``h`` rows on the crop."""
        if self.stride is None:
            if self.c_size % h:
                raise ValueError(f"bl: the prediction's side {h} does not divide c_size "
                                 f"{self.c_size}; set the loss's stride")
            return self.c_size // h
        if self.c_size // self.stride != h:
            raise ValueError(f"bl: stride {self.stride} on c_size {self.c_size} gives "
                             f"{self.c_size // self.stride} cells a side, the prediction "
                             f"has {h}")
        return self.stride

    def __call__(self, points, masks, targets, st_sizes, pred):
        b, _, h, w = pred.shape
        g = self.group
        world, rank = (1, 0) if g is None else (dist.get_world_size(g), dist.get_rank(g))
        if h * world != w:
            raise ValueError(f"bl: the prediction is {h * world}x{w}, not the square crop's")
        stride = self.stride_for(w)
        dev = pred.device
        cood = torch.arange(0, self.c_size, stride, dtype=torch.float32, device=dev) + stride / 2.0
        mask = masks.bool()
        with torch.no_grad():
            prob = _posterior(points.float(), mask, st_sizes.float(),
                              cood[rank * h:(rank + 1) * h], cood, self.sigma,
                              self.background_ratio, self.use_background)
        den = pred.float().reshape(b, -1)
        expected = torch.einsum("bnp,bp->bn", prob, den)                # (B, N + 1)
        total = den.sum(dim=1)
        if g is not None:
            expected, total = sum_over_ranks(torch.cat([expected, total[:, None]], dim=1),
                                             g).split([expected.shape[1], 1], dim=1)
            total = total[:, 0]
        n_pts = mask.sum(dim=1)
        row = torch.arange(expected.shape[1], device=dev)[None]
        tgt = torch.cat([targets.float(), torch.zeros(b, 1, device=dev)], dim=1)
        tgt = torch.where(row < n_pts[:, None], tgt, 0.0)
        if self.use_background:
            # the background's expectation moves to row n_pts, just after the points
            bg = expected[:, -1:].expand_as(expected)
            expected = torch.where(row < n_pts[:, None], expected,
                                   torch.where(row == n_pts[:, None], bg, 0.0))
            count = n_pts + 1
        else:
            expected = torch.where(row < n_pts[:, None], expected, 0.0)
            count = n_pts
        loss = _trimmed_l1((tgt - expected).abs(), count)
        loss = torch.where(n_pts == 0, total.abs(), loss)
        return loss.mean()


# reference BL configs carry a torch ``device`` string: dropped, as the JAX
# package drops it
LOSSES.register("bl", lambda **kw: BayesianLoss(**{k: v for k, v in kw.items()
                                                   if k != "device"}))
