"""Train state, counterpart of dgvcc_tpu/train/state.py: the model (its
parameters and batch-norm statistics), the optimizer with its moments,
the epoch scheduler, the step count, and two optional parts of the JAX
state:

  * gradient accumulation (``accum_steps: k``, the JAX package's
    ``optax.MultiSteps``): each micro step folds its gradient into a
    running mean over the window, ``acc += (g - acc) / (n + 1)``; the
    optimizer updates only on the k-th micro step, from that mean, and
    the parameters do not move before it. Batch-norm statistics update on
    every micro step, a partial window carries across epochs, and
    ``step`` counts micro steps;
  * EMA shadow weights (``ema: d``): float32 copies of the parameters
    (not of the batch-norm buffers, already an exponential average),
    seeded as copies of the initial parameters and moved every micro step
    by ``e = d' e + (1 - d') p`` with d' = d^(1/k), so that k micro steps
    toward the same parameters make one decay of d per update.

The model's parameters are float32 master weights, as the JAX package's
params are; its convolutions still compute in the dtype the model was
built with (``nn/layers.py::Conv2d``), so gradients and AdamW moments are
float32 while the activations are bf16.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from dgvcc_tpu_torch.models.dg import MemoryBank
from dgvcc_tpu_torch.serve import resolve_device
from dgvcc_tpu_torch.train.optim import Scheduler, build_optimizer, build_scheduler


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Scheduler] = None
    step: int = 0
    accum_steps: int = 1
    # the micro steps folded into acc_grads (0 .. accum_steps - 1)
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    ema_decay: float = 0.0
    # parameter name -> float32 shadow; None without EMA
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def set_learning_rate(self, lr: float) -> "TrainState":
        """Write ``lr`` into every parameter group (the scheduler's value
        for the epoch about to run); nothing else of the optimizer moves.
        Under accumulation it is the lr of the next update."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self

    def apply_gradients(self, reduce: Optional[Callable[[List[torch.Tensor]], None]] = None
                        ) -> "TrainState":
        """One micro step from the gradients in ``p.grad`` (None reads as
        0): the optimizer update, or its share of the window, then the EMA.
        ``reduce`` rewrites in place the gradients an update is about to
        take (the data-parallel mean over ranks): every micro step's without
        accumulation, the window's mean once per update with it."""
        params = list(self.model.parameters())
        if self.accum_steps > 1:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            diff = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc_grads, diff)
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step == 0:
                if reduce is not None:
                    reduce(self.acc_grads)
                for p, acc in zip(params, self.acc_grads):
                    p.grad = acc
                self.optimizer.step()
                for p in params:
                    p.grad = None
                torch._foreach_zero_(self.acc_grads)
        else:
            # a parameter the loss does not reach (a classifier behind a
            # binarised gate) still takes its AdamW decay and step count, as
            # under optax, whose gradient there is a zero
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if reduce is not None:
                reduce([p.grad for p in params])
            self.optimizer.step()
        if self.ema_params is not None:
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, [p.detach() for p in params],
                                alpha=1.0 - self.ema_decay)
        self.step += 1
        return self

    def seed_ema(self) -> None:
        """Restart the shadow from the current parameters (after a load or
        a pretrained install)."""
        if self.ema_params is not None:
            for name, p in self.model.named_parameters():
                self.ema_params[name].copy_(p.detach())

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the shadow in place of the
        parameters (the reference key layout)."""
        sd = dict(self.model.state_dict())
        sd.update(self.ema_params or {})
        return sd

    @contextlib.contextmanager
    def ema_weights(self):
        """The model evaluates the shadow inside; its own parameters come
        back after (a swap of storages, no copy)."""
        if self.ema_params is None:
            yield
            return
        named = dict(self.model.named_parameters())

        def swap():
            for name, e in self.ema_params.items():
                p = named[name]
                p.data, self.ema_params[name] = e, p.data

        swap()
        try:
            yield
        finally:
            swap()


def create_train_state(model: torch.nn.Module, optimizer_spec: Dict[str, Any],
                       scheduler_spec: Optional[Dict[str, Any]] = None,
                       device="cuda", accum_steps: int = 1,
                       ema: float = 0.0) -> TrainState:
    """Move ``model`` to ``device`` (CUDA unless the caller asks for the
    CPU; raises when CUDA is absent) with float32 parameters, in training
    mode, and build its optimizer and scheduler from the reference YAML
    specs. With a scheduler the learning rate is its value for epoch 0.
    ``accum_steps`` > 1 accumulates gradients over that many micro steps;
    ``ema`` in (0, 1) keeps shadow weights with that decay per update.

    The bank's serving kernel has no backward, so every ``MemoryBank`` of
    the model gets ``fused = False``: a single-view forward (modes
    ``simple`` to ``cls``, and evaluation) takes the einsum path, as the
    JAX model does by default. The two-view ``pair`` keeps its training
    kernels (``fused_train``)."""
    if ema and not 0.0 < ema < 1.0:
        raise ValueError(f"ema must be in (0, 1); got {ema}")
    if int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be at least 1; got {accum_steps}")
    dev = resolve_device(device)
    for bank in model.modules():
        if isinstance(bank, MemoryBank):
            bank.fused = False
    model.to(device=dev, dtype=torch.float32).train()
    if dev.type == "cuda":
        # NHWC is the tensor cores' layout and makes the bank's (B, P, K)
        # view of its input a free permute, as in serving
        model.to(memory_format=torch.channels_last)
    optimizer = build_optimizer(optimizer_spec, model.parameters())
    base_lr = optimizer_spec.get("params", {}).get("lr", 1e-3)
    state = TrainState(model, optimizer, build_scheduler(scheduler_spec, base_lr),
                       accum_steps=int(accum_steps))
    if state.accum_steps > 1:
        state.acc_grads = [torch.zeros_like(p) for p in model.parameters()]
    if ema:
        state.ema_decay = float(ema) ** (1.0 / state.accum_steps)
        state.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    if state.scheduler is not None:
        state.set_learning_rate(state.scheduler.current_lr)
    return state
