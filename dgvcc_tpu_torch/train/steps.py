"""Per-mode train steps, counterpart of dgvcc_tpu/train/steps.py.

Batches are dicts of tensors on the model's device, images NCHW:
    img1 (B,3,H,W), img2 (B,3,H,W)?, dmap (B,1,H,W)?, bmap (B,1,H/16,W/16)?,
    points (B,N,2)?, pt_mask (B,N)?, targets (B,N)?, st_sizes (B,)?
    (the Bayesian loss's), isw_masks / isw_nums / isw_margins ({"m0": ...})?

Modes (reference dgtrainer.py:149-204):
    simple  — one view, count loss (a DG model's tuple or a counter's map)
    base    — two views, count loss on both
    add     — model.forward_train → + consistency loss
    cls     — density + 10x BCE on the foreground classifier
    final   — forward_train → den + 10*BCE + con_weight*consistency
              (the error loss is computed, reported and not added)
    isw     — the model returns [task_loss, wt_loss] (its own count loss
              and the whitening loss on the batch's masks); total = task +
              0.6 * wt from epoch 6 on
    regression, discrimination, generation — the reconstructed modes of
              the regressors and the generator (``train/genjoint.py``);
              joint trains the generator and ``reg_mem`` together, a step of
              its own (``genjoint.build_joint_step``)
The count loss is the MSE on the density map or the Bayesian loss on the
batch's points (``_count_loss``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dgvcc_tpu_torch.train.state import TrainState

MODES = ("simple", "base", "add", "cls", "final", "isw", "regression", "discrimination",
         "generation", "joint")


def bce(pred_prob: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """F.binary_cross_entropy on probabilities, clamped like torch, in f32."""
    p = pred_prob.float().clamp(eps, 1.0 - eps)
    t = target.float()
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _count_loss(loss, pred, batch, log_para):
    """compute_count_loss (dgtrainer.py:50-69): the MSE on the density map,
    or the Bayesian loss on the padded points."""
    if getattr(loss, "kind", "mse") == "mse":
        return loss(pred, batch["dmap"], log_para=log_para)
    return loss(batch["points"], batch["pt_mask"], batch["targets"], batch["st_sizes"], pred)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def build_loss_fn(model: torch.nn.Module, loss, mode: str, log_para: float,
                  con_weight: float = 10.0) -> Callable:
    """Returns loss_fn(batch, generator, epoch=0) -> (total, metrics) on
    the model's current parameters, in training mode (batch-norm
    statistics update, dropout draws from the ``torch.Generator``; None
    only where every dropout rate is 0).

    con_weight: weight of the two-view consistency term in 'final' mode
    (10.0 in the reference, dgtrainer.py:189; the 'nocon' ablation sets it
    to 0)."""
    if mode not in MODES:
        raise ValueError(f"Unknown mode: {mode}")
    if mode == "joint":
        raise ValueError("mode 'joint' updates two models a step: "
                         "train/genjoint.py::build_joint_step")
    if mode in ("regression", "discrimination", "generation"):
        from dgvcc_tpu_torch.train import genjoint

        if mode == "generation":
            return genjoint.build_generation_loss(model)
        build = (genjoint.build_regression_loss if mode == "regression"
                 else genjoint.build_discrimination_loss)
        return build(model, loss, log_para)

    def loss_fn(batch: Dict[str, torch.Tensor], generator, epoch: int = 0):
        model.train()
        metrics = {}
        if mode == "simple":
            loss_den = _count_loss(loss, _first(model(batch["img1"], generator=generator)),
                                   batch, log_para)
            total = loss_den
            metrics["loss_den"] = loss_den
        elif mode == "base":
            # each view is its own forward: batch stats are updated twice
            out1 = model(batch["img1"], generator=generator)
            out2 = model(batch["img2"], generator=generator)
            loss_den = (_count_loss(loss, _first(out1), batch, log_para)
                        + _count_loss(loss, _first(out2), batch, log_para))
            total = loss_den
            metrics["loss_den"] = loss_den
        elif mode == "add":
            d1, d2, loss_con = model.forward_train(batch["img1"], batch["img2"],
                                                   generator=generator)
            loss_den = (_count_loss(loss, d1, batch, log_para)
                        + _count_loss(loss, d2, batch, log_para))
            total = loss_den + loss_con
            metrics.update(loss_den=loss_den, loss_con=loss_con)
        elif mode == "cls":
            d1, c1 = model(batch["img1"], c_gt=batch["bmap"], generator=generator)
            d2, c2 = model(batch["img2"], c_gt=batch["bmap"], generator=generator)
            loss_den = (_count_loss(loss, d1, batch, log_para)
                        + _count_loss(loss, d2, batch, log_para))
            loss_cls = bce(c1, batch["bmap"]) + bce(c2, batch["bmap"])
            total = loss_den + 10.0 * loss_cls
            metrics.update(loss_den=loss_den, loss_cls=loss_cls)
        elif mode == "isw":
            # the model's own count loss (not _count_loss) and the whitening
            # loss on the masks the batch carries; the epoch is a Python int
            wt_on = epoch > 5
            task_loss, wt_loss = model(batch["img1"], gts=batch["dmap"] * log_para,
                                       masks=batch.get("isw_masks"),
                                       num_sensitive=batch.get("isw_nums"),
                                       margins=batch.get("isw_margins"),
                                       apply_wtloss=wt_on, generator=generator)
            total = task_loss + 0.6 * wt_loss if wt_on else task_loss
            metrics.update(loss_den=task_loss, loss_wt=wt_loss)
        else:  # final
            dc1, dc2, c1, c2, _, loss_con, loss_err = model.forward_train(
                batch["img1"], batch["img2"], batch["bmap"], generator=generator)
            loss_den = (_count_loss(loss, dc1, batch, log_para)
                        + _count_loss(loss, dc2, batch, log_para))
            loss_cls = bce(c1, batch["bmap"]) + bce(c2, batch["bmap"])
            # the error loss is computed but not added, as dgtrainer.py:189
            total = loss_den + 10.0 * loss_cls + con_weight * loss_con
            metrics.update(loss_den=loss_den, loss_cls=loss_cls, loss_con=loss_con,
                           loss_err=loss_err)
        metrics["loss_total"] = total
        return total, metrics

    return loss_fn


def build_train_step(model: torch.nn.Module, loss, mode: str, log_para: float,
                     loss_fn: Optional[Callable] = None,
                     con_weight: float = 10.0, sync=None) -> Callable:
    """Returns step(state, batch, generator, epoch=0) -> (state, metrics):
    gradients of the mode's loss, then ``state.apply_gradients()``: one
    optimizer update, or one micro step of an accumulation window, and
    the EMA (the state is updated in place and returned). The metrics are
    detached device tensors, so a step never waits for the card; read
    them when needed (the trainer reads the loss once per epoch).

    ``sync`` (``parallel/mesh.py::DataParallel``) makes it a data-parallel
    step: the gradients of an update are averaged over the ranks before the
    optimizer steps, and ``sync.after_update()`` runs after it."""
    loss_fn = loss_fn or build_loss_fn(model, loss, mode, log_para, con_weight)

    def step(state: TrainState, batch: Dict[str, Any], generator, epoch: int = 0):
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, generator, epoch)
        total.backward()
        apply_update(state, sync)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def apply_update(state: TrainState, sync=None) -> None:
    """``state.apply_gradients()``, with ``sync``'s all-reduce of the
    update's gradients and its step afterwards where there is one."""
    if sync is None:
        state.apply_gradients()
        return
    state.apply_gradients(reduce=sync.reduce_gradients)
    sync.after_update()
