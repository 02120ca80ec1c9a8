"""The reconstructed training modes of the regressors and the generator,
counterpart of dgvcc_tpu/train/genjoint.py (the reference ships their
configs, sta_gen.yml, sta_joint.yml, sta_reg.yml and sta_dis.yml, but not
their trainers; the JAX package reconstructs them from the shipped models
and losses):

  generation     — the generator maps the photometric view img2 back to
                   the clean view img1: pixel L1 + MSE;
  joint          — the generator and ``reg_mem`` in one step, in the JAX
                   step's order: the generator's forward, its loss (L1 to
                   img1 + 1e-6 * ortho_loss of the per-sample-centred
                   pixels) and its update; then the regressor's
                   ``forward_train`` on (img1, the generator's output of
                   that forward, detached) and its update
                   (``build_joint_step``);
  regression     — ``reg_mem.forward_train`` on the two views: the count
                   loss on both densities + 10 * BCE(cls) + 10 * true_jsd;
  discrimination — the count loss of both views (batch-norm statistics
                   through both in turn) + a triplet loss on the stride-16
                   features pooled per sample (anchor img1, positive img2,
                   negative the batch rolled by one; 0 at B=1), probed with
                   batch norm in eval mode on the running statistics the
                   two forwards left. In the JAX loss those statistics are
                   functions of the parameters, so the triplet's gradient
                   also flows through them; the port keeps that path
                   (``traced_running_statistics``), which moves the trunk's
                   gradients by several percent.

Each build_*_loss function returns loss_fn(batch, generator, epoch=0) ->
(total, metrics), as ``train/steps.py::build_loss_fn``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from dgvcc_tpu_torch.losses.misc import ortho_loss, triplet_loss
from dgvcc_tpu_torch.train.steps import _count_loss, _first, apply_update, bce


def build_generation_loss(model):
    """mode 'generation': the de-augmentation reconstruction, L1 + MSE of
    gen(img2) against img1, in float32."""

    def loss_fn(batch, generator, epoch: int = 0):
        model.train()
        out = model(batch["img2"]).float()
        target = batch["img1"].float()
        loss_rec = (out - target).abs().mean() + (out - target).square().mean()
        return loss_rec, {"loss_total": loss_rec, "loss_rec": loss_rec}

    return loss_fn


def build_joint_step(gen_model, reg_model, loss, log_para: float, gen_sync=None,
                     reg_sync=None):
    """mode 'joint': returns step(gen_state, reg_state, batch, generator,
    epoch=0) -> (gen_state, reg_state, metrics). The regressor's dropout
    draws from ``generator`` (the JAX step's second key; the generator has
    no dropout). Both states are updated in place and returned; the metrics
    are detached device tensors. ``gen_sync`` / ``reg_sync`` make each
    update data-parallel (``train/steps.py::apply_update``)."""
    reg_loss = build_regression_loss(reg_model, loss, log_para)

    def step(gen_state, reg_state, batch, generator, epoch: int = 0):
        gen_state.optimizer.zero_grad(set_to_none=True)
        gen_model.train()
        fake = gen_model(batch["img2"])
        target = batch["img1"].float()
        loss_rec = (fake.float() - target).abs().mean()
        # the style-diversity regulariser: no cross-sample correlation between
        # the generated and the clean pixels, so the generator does not
        # collapse onto the identity
        x = fake.float().reshape(fake.shape[0], -1)
        y = target.reshape(target.shape[0], -1)
        loss_ortho = ortho_loss(x - x.mean(dim=1, keepdim=True),
                                y - y.mean(dim=1, keepdim=True)) * 1e-6
        gtotal = loss_rec + loss_ortho
        gtotal.backward()
        apply_update(gen_state, gen_sync)

        reg_state.optimizer.zero_grad(set_to_none=True)
        rtotal, rmetrics = reg_loss(dict(batch, img2=fake.detach()), generator, epoch)
        rtotal.backward()
        apply_update(reg_state, reg_sync)
        metrics = {"loss_total": rtotal + gtotal, "loss_gen": gtotal, "loss_rec": loss_rec,
                   **{k: rmetrics[k] for k in ("loss_den", "loss_kl", "loss_cls")}}
        return gen_state, reg_state, {k: v.detach() for k, v in metrics.items()}

    return step


def build_regression_loss(model, loss, log_para: float):
    """mode 'regression': the DensityRegressorM composite."""

    def loss_fn(batch, generator, epoch: int = 0):
        model.train()
        dc1, dc2, c1, c2, loss_kl, loss_err = model.forward_train(
            batch["img1"], batch["img2"], batch["bmap"], generator=generator)
        loss_den = (_count_loss(loss, dc1, batch, log_para)
                    + _count_loss(loss, dc2, batch, log_para))
        loss_cls = bce(c1, batch["bmap"]) + bce(c2, batch["bmap"])
        total = loss_den + 10.0 * loss_cls + 10.0 * loss_kl
        return total, {"loss_total": total, "loss_den": loss_den, "loss_cls": loss_cls,
                       "loss_kl": loss_kl, "loss_err": loss_err}

    return loss_fn


class _BatchMoments(torch.autograd.Function):
    """Per-channel mean and unbiased variance of x (N, C, H, W) in float32,
    the statistics a train-mode batch norm folds into its running ones. The
    backward rebuilds its input's gradient from x, which the batch norm
    keeps anyway, so no float32 copy of x is held for it."""

    @staticmethod
    def forward(ctx, x):
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        ctx.save_for_backward(x, mean)
        n = x.numel() // x.shape[1]
        return mean, var * (n / max(n - 1, 1))

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        g_mean = torch.zeros_like(mean) if g_mean is None else g_mean
        g_var = torch.zeros_like(mean) if g_var is None else g_var
        # d mean / dx = 1 / n; d var_unbiased / dx = 2 (x - mean) / (n - 1)
        scale = (2.0 / max(n - 1, 1)) * g_var
        dx = (x.float() - mean[None, :, None, None]) * scale[None, :, None, None]
        return (dx + (g_mean / n)[None, :, None, None]).to(x.dtype)


@contextlib.contextmanager
def traced_running_statistics(model):
    """Inside, each batch norm's train-mode calls are recorded; yields a
    function that returns {bn: (running mean, running var)} as they stand
    after those calls, computed from the batch statistics with their
    gradient (the JAX BatchNorm's update: the biased variance in float32,
    stored unbiased; the buffers move as usual)."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    start = {bn: (bn.running_mean.clone(), bn.running_var.clone()) for bn in bns}
    calls = {bn: [] for bn in bns}

    def record(bn, inputs):
        if bn.training:
            calls[bn].append(_BatchMoments.apply(inputs[0]))

    def running():
        out = {}
        for bn, (rm, rv) in start.items():
            for mean, var in calls[bn]:
                rm = (1.0 - bn.momentum) * rm + bn.momentum * mean
                rv = (1.0 - bn.momentum) * rv + bn.momentum * var
            out[bn] = (rm, rv)
        return out

    handles = [bn.register_forward_pre_hook(record) for bn in bns]
    try:
        yield running
    finally:
        for h in handles:
            h.remove()


def _eval_bn(bn, mean, var, x):
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    y = (x.float() - mean[None, :, None, None]) * scale[None, :, None, None]
    return (y + bn.bias[None, :, None, None]).to(x.dtype)


@contextlib.contextmanager
def normalising_with(stats):
    """Each batch norm of ``stats`` normalises in eval mode with the given
    (mean, var), a gradient flowing through them."""
    for bn, (mean, var) in stats.items():
        bn.forward = lambda x, bn=bn, mean=mean, var=var: _eval_bn(bn, mean, var, x)
    try:
        yield
    finally:
        for bn in stats:
            del bn.forward


def stride16_features(model, x: torch.Tensor, stats) -> torch.Tensor:
    """The trunk's stride-16 features, batch norm in eval mode on ``stats``
    (``traced_running_statistics``); nothing of the model moves. The JAX
    probe runs the whole U-Net and keeps x3 (XLA drops the decoder); this
    runs the encoder alone."""
    with normalising_with(stats):
        return model.forward_trunk(x)


def build_discrimination_loss(model, loss, log_para: float):
    """mode 'discrimination': count loss + domain-invariance triplet."""

    def loss_fn(batch, generator, epoch: int = 0):
        model.train()
        with traced_running_statistics(model) as running:
            d1 = _first(model(batch["img1"], generator=generator))
            d2 = _first(model(batch["img2"], generator=generator))
        loss_den = (_count_loss(loss, d1, batch, log_para)
                    + _count_loss(loss, d2, batch, log_para))
        stats = running()
        emb1 = stride16_features(model, batch["img1"], stats).float().mean(dim=(2, 3))
        emb2 = stride16_features(model, batch["img2"], stats).float().mean(dim=(2, 3))
        if emb1.shape[0] > 1:
            loss_tri = triplet_loss(emb1, emb2, torch.roll(emb1, 1, dims=0), margin=0.5)
        else:  # the rolled negative would be the anchor itself
            loss_tri = torch.zeros((), device=emb1.device)
        total = loss_den + loss_tri
        return total, {"loss_total": total, "loss_den": loss_den, "loss_tri": loss_tri}

    return loss_fn
