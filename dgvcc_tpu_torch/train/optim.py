"""Optimizers and epoch-stepped LR schedulers, counterpart of
dgvcc_tpu/train/optim.py.

The optimizers are ``torch.optim``'s, built from the reference YAML spec
(main.py:80-88). Their update rules are the JAX package's optax chains:

  * ``adamw``: ``torch.optim.AdamW`` decays the weights decoupled from the
    gradient, ``p -= lr * (adam_update + wd * p)``, as ``optax.adamw``;
  * ``adam``: ``torch.optim.Adam``'s ``weight_decay`` adds ``wd * p`` to
    the gradient, as ``add_decayed_weights`` before ``optax.adam``;
  * ``sgd``: ``torch.optim.SGD`` with L2 decay the same way, and a momentum
    trace ``t = g + momentum * t`` as ``optax.sgd``.

The schedulers are copies of the JAX package's pure ``lr_at(epoch)``
formulas, stepped once per epoch as the reference does
(trainers/trainer.py:82-87); the trainer writes their value into the
optimizer (``TrainState.set_learning_rate``). They schedule the learning
rate only: ``torch.optim.lr_scheduler.OneCycleLR`` would also cycle AdamW's
beta1 between 0.85 and 0.95 (its default ``cycle_momentum=True``), which
the JAX package never does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch

from dgvcc_tpu_torch.core.registry import OPTIMIZERS, SCHEDULERS

# --------------------------------------------------------------------------
# Optimizers (reference main.py:80-88: sgd / adam / adamw)
# --------------------------------------------------------------------------


def _sgd(params, lr: float = 0.01, momentum: float = 0.0, weight_decay: float = 0.0, **_):
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def _adam(params, lr: float = 1e-3, weight_decay: float = 0.0, betas=(0.9, 0.999),
          eps: float = 1e-8, **_):
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def _adamw(params, lr: float = 1e-3, weight_decay: float = 1e-2, betas=(0.9, 0.999),
           eps: float = 1e-8, **_):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


OPTIMIZERS.register("sgd", _sgd)
OPTIMIZERS.register("adam", _adam)
OPTIMIZERS.register("adamw", _adamw)


def build_optimizer(spec: Dict[str, Any], params: Iterable[torch.nn.Parameter]):
    """spec = {'name': ..., 'params': {...}} as in the reference YAML."""
    return OPTIMIZERS.build(spec["name"], params=params, **spec.get("params", {}))


# --------------------------------------------------------------------------
# Schedulers (reference main.py:90-102: step/multistep/cosine/plateau/onecycle)
# --------------------------------------------------------------------------

class Scheduler:
    """Epoch-stepped LR source. ``step(metric)`` advances one epoch and
    returns the LR to use for the *next* epoch; ``current_lr`` is the LR
    for the epoch about to run. Matches torch's convention that the
    constructor-time LR applies to epoch 0 and step() is called after
    each epoch."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.epoch = 0

    def lr_at(self, epoch: int) -> float:
        raise NotImplementedError

    @property
    def current_lr(self) -> float:
        return self.lr_at(self.epoch)

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        return self.current_lr

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, d):
        self.epoch = d["epoch"]


class StepLR(Scheduler):
    def __init__(self, base_lr, step_size: int, gamma: float = 0.1, **_):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def lr_at(self, e):
        return self.base_lr * self.gamma ** (e // self.step_size)


class MultiStepLR(Scheduler):
    def __init__(self, base_lr, milestones, gamma: float = 0.1, **_):
        super().__init__(base_lr)
        self.milestones, self.gamma = sorted(milestones), gamma

    def lr_at(self, e):
        k = sum(1 for m in self.milestones if m <= e)
        return self.base_lr * self.gamma**k


class CosineLR(Scheduler):
    def __init__(self, base_lr, T_max: int, eta_min: float = 0.0, **_):
        super().__init__(base_lr)
        self.T_max, self.eta_min = T_max, eta_min

    def lr_at(self, e):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * e / self.T_max)
        ) / 2


class PlateauLR(Scheduler):
    """torch ReduceLROnPlateau (mode='min'), epoch-stepped with the val
    criterion."""

    def __init__(self, base_lr, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, **_):
        super().__init__(base_lr)
        self.factor, self.patience = factor, patience
        self.threshold, self.min_lr = threshold, min_lr
        self._lr = base_lr
        self.best = float("inf")
        self.bad = 0

    def lr_at(self, e):
        return self._lr

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        if metric is None:
            return self._lr
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.bad = 0
        return self._lr

    def state_dict(self):
        return {"epoch": self.epoch, "lr": self._lr, "best": self.best, "bad": self.bad}

    def load_state_dict(self, d):
        self.epoch, self._lr, self.best, self.bad = d["epoch"], d["lr"], d["best"], d["bad"]


class OneCycleLR(Scheduler):
    """torch OneCycleLR's learning rate (cos strategy), evaluated at
    integer step() counts. Because the reference steps it per epoch,
    `total_steps = epochs * steps_per_epoch` is far larger than the number
    of steps actually taken — preserved verbatim."""

    def __init__(self, base_lr=None, max_lr=None, epochs: int = 100,
                 steps_per_epoch: int = 1, total_steps: Optional[int] = None,
                 pct_start: float = 0.3, div_factor: float = 25.0,
                 final_div_factor: float = 1e4, **_):
        max_lr = max_lr if max_lr is not None else base_lr
        super().__init__(max_lr)
        self.total_steps = total_steps or epochs * steps_per_epoch
        self.pct_start = pct_start
        self.initial_lr = max_lr / div_factor
        self.max_lr = max_lr
        self.min_lr = self.initial_lr / final_div_factor

    @staticmethod
    def _annealing_cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)

    def lr_at(self, e):
        up = float(self.pct_start * self.total_steps) - 1
        if e <= up:
            return self._annealing_cos(self.initial_lr, self.max_lr, e / max(up, 1))
        down = float(self.total_steps - up - 1)
        return self._annealing_cos(self.max_lr, self.min_lr, (e - up) / max(down, 1))


SCHEDULERS.register("step", lambda base_lr, **kw: StepLR(base_lr, **kw))
SCHEDULERS.register("multistep", lambda base_lr, **kw: MultiStepLR(base_lr, **kw))
SCHEDULERS.register("cosine", lambda base_lr, **kw: CosineLR(base_lr, **kw))
SCHEDULERS.register("plateau", lambda base_lr, **kw: PlateauLR(base_lr, **kw))
SCHEDULERS.register("onecycle", lambda base_lr, **kw: OneCycleLR(base_lr, **kw))


def build_scheduler(spec: Optional[Dict[str, Any]], base_lr: float) -> Optional[Scheduler]:
    if spec is None:
        return None
    return SCHEDULERS.build(spec["name"], base_lr=base_lr, **spec.get("params", {}))
