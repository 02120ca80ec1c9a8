"""Per-mode train steps, counterpart of dgvcc_tpu/train/steps.py.

Batches are dicts of NCHW tensors on the model's device:
    img1 (B,3,H,W), img2 (B,3,H,W)?, dmap (B,1,H,W), bmap (B,1,H/16,W/16)?

Modes (reference dgtrainer.py:149-204):
    simple  — one view, count loss
    base    — two views, count loss on both
    add     — model.forward_train → + consistency loss
    cls     — density + 10x BCE on the foreground classifier
    final   — forward_train → den + 10*BCE + con_weight*consistency
              (the error loss is computed, reported and not added)
Mode ``isw`` and the Bayesian loss are not ported (ROADMAP.md, Queue 1
item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dgvcc_tpu_torch.train.state import TrainState

MODES = ("simple", "base", "add", "cls", "final")


def bce(pred_prob: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """F.binary_cross_entropy on probabilities, clamped like torch, in f32."""
    p = pred_prob.float().clamp(eps, 1.0 - eps)
    t = target.float()
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _count_loss(loss, pred, batch, log_para):
    """compute_count_loss (dgtrainer.py:50-69), MSE branch."""
    return loss(pred, batch["dmap"], log_para=log_para)


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
    if mode == "isw":
        raise NotImplementedError("mode 'isw' is not ported to dgvcc_tpu_torch yet; "
                                  "see ROADMAP.md, Queue 1 item 6")
    if mode not in MODES:
        raise ValueError(f"Unknown mode: {mode}")
    if getattr(loss, "kind", "mse") != "mse":
        raise NotImplementedError("only the 'mse' count loss is ported; the Bayesian "
                                  "loss is ROADMAP.md, Queue 1 item 6")

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
                     con_weight: float = 10.0) -> Callable:
    """Returns step(state, batch, generator, epoch=0) -> (state, metrics):
    gradients of the mode's loss, one optimizer update (the state
    is updated in place and returned). The metrics are detached device
    tensors, so a step never waits for the card; read them when needed
    (the trainer reads the loss once per epoch)."""
    loss_fn = loss_fn or build_loss_fn(model, loss, mode, log_para, con_weight)

    def step(state: TrainState, batch: Dict[str, Any], generator, epoch: int = 0):
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, generator, epoch)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
