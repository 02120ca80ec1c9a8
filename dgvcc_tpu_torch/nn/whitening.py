"""Whitening layers (NCHW), counterpart of dgvcc_tpu/nn/whitening.py.

  * ``SwitchWhiten``: per group of ``num_pergroup`` channels, a learned
    softmax mixes batch- and instance-whitening statistics (+ LN for
    sw_type 3, + BN/IN variances and LN for sw_type 5); the whitening
    matrix Sigma^(-1/2) comes from T Newton-Schulz steps, all batched
    (N*g, c, c) products;
  * ``InstanceNorm`` (affine or not), ``InstanceWhitening`` (IN without
    affine that also returns its output for the whitening loss),
    ``get_covariance_matrix`` and ``instance_whitening_loss``;
  * ``IBN``: IN(affine) on one part of the channels, BN on the rest;
  * ``SELayer``: squeeze-excitation.

Parameter and buffer names are the reference torch modules' (SW:
``sw_mean_weight``, ``sw_var_weight``, ``weight``, ``bias``,
``running_mean``, ``running_cov``; IBN: ``IN`` and ``BN``; SE: ``fc.0``,
``fc.2``), so a reference ``.pth`` strict-loads.

Precision: the statistics, the Newton-Schulz steps and the whitening
product run in float32 whatever the input dtype (float64 for a float64
input), and the output is cast back to it. Their products must not use
TF32 (it changes the whitening matrix), so a forward on CUDA raises if
TF32 matmuls are allowed. With a ``process_group`` (set by
``nn/layers.py::sync_statistics`` on the six whitening models under
``mesh: {data: N}``), SwitchWhiten's training forward averages its batch
mean and then its batch covariance over the group's ranks, and IBN's batch
norm its statistics (dgvcc_tpu/nn/whitening.py:110-117); the gradient flows
through both averages. Without one, the batch statistics are this rank's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dgvcc_tpu_torch.nn.layers import BatchNorm2d
from dgvcc_tpu_torch.parallel.mesh import mean_over_ranks


def _check_full_f32(x: torch.Tensor):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the whitening layers' float32 products must not use TF32 "
                           "(torch.backends.cuda.matmul.allow_tf32 is True)")


def newton_schulz_inv_sqrt(cov: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Sigma^(-1/2) of SPD ``cov`` (..., c, c) by trace-normalised
    Newton-Schulz: P_0 = I; P <- 1.5 P - 0.5 P^3 (cov / tr); P_T / sqrt(tr)."""
    c = cov.shape[-1]
    r_tr = 1.0 / torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    cov_n = cov * r_tr
    p = torch.eye(c, dtype=cov.dtype, device=cov.device).expand_as(cov)
    for _ in range(iters):
        p3 = torch.matmul(torch.matmul(p, p), p)
        p = 1.5 * p - 0.5 * torch.matmul(p3, cov_n)
    return p * torch.sqrt(r_tr)


def _diag(m: torch.Tensor) -> torch.Tensor:
    """The diagonal matrix of m's diagonal."""
    return torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))


class SwitchWhiten(nn.Module):
    """Switchable Whitening over NCHW inputs. Running mean (g, c, 1) and
    covariance (g, c, c) start at zero and move as ``m * running + (1 - m)
    * batch`` in training (the JAX convention: ``momentum`` is the weight
    of the old value). ``process_group``: the ranks whose batch statistics
    are averaged (None: this rank's alone)."""

    process_group = None

    def __init__(self, num_features: int, num_pergroup: int = 16, sw_type: int = 2,
                 T: int = 5, tie_weight: bool = False, eps: float = 1e-5,
                 momentum: float = 0.99, affine: bool = True):
        super().__init__()
        if sw_type not in (2, 3, 5):
            raise ValueError(f"sw_type must be 2, 3 or 5, got {sw_type}")
        if num_features % num_pergroup:
            raise ValueError(f"{num_features} channels do not split into groups of "
                             f"{num_pergroup}")
        self.num_features, self.num_pergroup = num_features, num_pergroup
        self.sw_type, self.T, self.eps, self.momentum = sw_type, T, eps, momentum
        self.tie_weight, self.affine = tie_weight, affine
        g = num_features // num_pergroup
        self.sw_mean_weight = nn.Parameter(torch.ones(sw_type))
        if not tie_weight:
            self.sw_var_weight = nn.Parameter(torch.ones(sw_type))
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(g, num_pergroup, 1))
        self.register_buffer("running_cov", torch.zeros(g, num_pergroup, num_pergroup))

    def reset_parameters(self):
        with torch.no_grad():
            for p in self.parameters():
                p.fill_(1.0)
            if self.affine:
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_cov.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_full_f32(x)
        n, ch, h, w = x.shape
        c = self.num_pergroup
        g, hw = ch // c, h * w
        xf = x if x.dtype == torch.float64 else x.float()
        data = xf.reshape(n, g, c, hw)
        if self.training:
            mean_bn = data.mean(dim=(0, 3))[..., None]  # (g, c, 1)
            if self.process_group is not None:
                mean_bn = mean_over_ranks(mean_bn, self.process_group)
            centered = data - mean_bn
            cov_bn = torch.einsum("ngcp,ngdp->gcd", centered, centered) / (n * hw)
            if self.process_group is not None:
                cov_bn = mean_over_ranks(cov_bn, self.process_group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean_bn.detach())
                self.running_cov.mul_(m).add_((1 - m) * cov_bn.detach())
        else:
            mean_bn, cov_bn = self.running_mean, self.running_cov

        mean_in = data.mean(dim=3, keepdim=True)  # (N, g, c, 1)
        x_in = data - mean_in
        cov_in = torch.matmul(x_in, x_in.transpose(-1, -2)) / hw  # (N, g, c, c)
        eye = torch.eye(c, dtype=xf.dtype, device=x.device)
        mw = torch.softmax(self.sw_mean_weight.to(xf.dtype), 0)
        var_weight = self.sw_mean_weight if self.tie_weight else self.sw_var_weight
        vw = torch.softmax(var_weight.to(xf.dtype), 0)
        mean_bn_b = mean_bn[None].expand(n, g, c, 1)
        cov_bn_b = cov_bn[None].expand(n, g, c, c)

        if self.sw_type == 2:
            mean = mw[0] * mean_bn_b + mw[1] * mean_in
            cov = vw[0] * cov_bn_b + vw[1] * cov_in + self.eps * eye
        else:
            flat = xf.reshape(n, -1)
            mean_ln = flat.mean(dim=1).reshape(n, 1, 1, 1)
            var_ln = flat.var(dim=1, unbiased=True).reshape(n, 1, 1, 1)
            if self.sw_type == 3:
                mean = mw[0] * mean_bn_b + mw[1] * mean_in + mw[2] * mean_ln
                cov = (vw[0] * cov_bn_b + vw[1] * cov_in + vw[2] * var_ln * eye
                       + self.eps * eye)
            else:  # 5: the reference's mix (switchwhiten.py:158-164)
                mean = ((mw[0] + mw[2]) * mean_bn_b + (mw[1] + mw[3]) * mean_in
                        + mw[4] * mean_ln)
                cov = (vw[0] * cov_bn_b + vw[1] * cov_in + vw[0] * _diag(cov_bn_b)
                       + vw[1] * _diag(cov_in) + vw[4] * var_ln * eye + self.eps * eye)

        wm = newton_schulz_inv_sqrt(cov, self.T)  # (N, g, c, c)
        x_hat = torch.matmul(wm, data - mean).reshape(n, ch, h, w)
        if self.affine:
            x_hat = x_hat * self.weight[:, None, None] + self.bias[:, None, None]
        return x_hat.to(x.dtype)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d`` (eps 1e-5, biased variance, no running
    statistics), computed in float32 and cast back."""

    def __init__(self, num_features: int, affine: bool = False):
        super().__init__()
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def reset_parameters(self):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class InstanceWhitening(InstanceNorm):
    """IN without affine; returns (x, w) with w = x
    (reference models/ISW/instance_whitening.py:5-16)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, affine=False)

    def forward(self, x):
        y = super().forward(x)
        return y, y


def get_covariance_matrix(f_map: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C): the uncentred f f^T / (HW - 1) + 1e-5 I,
    in float32."""
    b, c, h, w = f_map.shape
    f = f_map.float().reshape(b, c, h * w)
    cov = torch.bmm(f, f.transpose(1, 2)) / (h * w - 1)
    return cov + 1e-5 * torch.eye(c, dtype=torch.float32, device=f_map.device)


def instance_whitening_loss(f_map, mask_matrix, margin, num_remove_cov):
    """Masked mean |off-diagonal covariance| less the margin, over the
    count of masked entries (instance_whitening.py:19-27)."""
    masked = get_covariance_matrix(f_map) * mask_matrix
    off_diag_sum = masked.abs().sum(dim=(1, 2)) - margin
    denom = torch.clamp(torch.as_tensor(num_remove_cov, dtype=torch.float32,
                                        device=f_map.device), min=1.0)
    return torch.clamp(off_diag_sum / denom, min=0.0).mean()


class IBN(nn.Module):
    """Instance-Batch Norm: IN(affine) on the first ``int(planes * ratio)``
    channels, BN on the rest (models/ibnnet/modules.py:5-25); ``bn_first``:
    BN on the first ``int(planes * (1 - ratio))``, IN on the rest (the
    DenseNet-IBN variant, densenet_ibn.py:28-40)."""

    def __init__(self, planes: int, ratio: float = 0.5, bn_first: bool = False):
        super().__init__()
        self.bn_first = bn_first
        self.half = int(planes * (1 - ratio)) if bn_first else int(planes * ratio)
        n_in = planes - self.half if bn_first else self.half
        self.IN = InstanceNorm(n_in, affine=True)
        self.BN = BatchNorm2d(planes - n_in, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x1, x2 = x[:, :self.half], x[:, self.half:]
        if self.bn_first:
            return torch.cat([self.BN(x1), self.IN(x2)], dim=1)
        return torch.cat([self.IN(x1), self.BN(x2)], dim=1)


class SELayer(nn.Module):
    """Squeeze-excitation (models/ibnnet/modules.py:28-43); its products
    run in the input's dtype."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channel, int(channel / reduction), bias=False),
                                nn.ReLU(),
                                nn.Linear(int(channel / reduction), channel, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = F.relu(F.linear(y, self.fc[0].weight.to(y.dtype)))
        y = torch.sigmoid(F.linear(y, self.fc[2].weight.to(y.dtype)))
        return x * y[:, :, None, None]
