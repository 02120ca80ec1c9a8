"""Train state, counterpart of dgvcc_tpu/train/state.py: the model (its
parameters and batch-norm statistics), the optimizer with its moments,
the epoch scheduler and the step count.

The model's parameters are float32 master weights, as the JAX package's
params are; its convolutions still compute in the dtype the model was
built with (``nn/layers.py::Conv2d``), so gradients and AdamW moments are
float32 while the activations are bf16. EMA weights, gradient
accumulation and the preemption save are not ported (ROADMAP.md, Queue 1
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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

    def set_learning_rate(self, lr: float) -> "TrainState":
        """Write ``lr`` into every parameter group (the scheduler's value
        for the epoch about to run); nothing else of the optimizer moves."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self


def create_train_state(model: torch.nn.Module, optimizer_spec: Dict[str, Any],
                       scheduler_spec: Optional[Dict[str, Any]] = None,
                       device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (CUDA unless the caller asks for the
    CPU; raises when CUDA is absent) with float32 parameters, in training
    mode, and build its optimizer and scheduler from the reference YAML
    specs. With a scheduler the learning rate is its value for epoch 0.

    The bank's serving kernel has no backward, so every ``MemoryBank`` of
    the model gets ``fused = False``: a single-view forward (modes
    ``simple`` to ``cls``, and evaluation) takes the einsum path, as the
    JAX model does by default. The two-view ``pair`` keeps its training
    kernels (``fused_train``)."""
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
    state = TrainState(model, optimizer, build_scheduler(scheduler_spec, base_lr))
    if state.scheduler is not None:
        state.set_learning_rate(state.scheduler.current_lr)
    return state
