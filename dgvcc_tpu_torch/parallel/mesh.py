"""Data-parallel training over ranks, counterpart of the 1-D step, the 2-D
``(data, model)`` step and the joint step of dgvcc_tpu/parallel/mesh.py.

The JAX package shards the config's batch over N chips of one process
under ``shard_map``. The port runs one process a card (``torchrun``), with
the same semantics:

  * the batch: ``batch_size`` is the global batch, and rank r takes its
    contiguous rows [r B/N, (r+1) B/N) (``shard_rows``, ``shard_batch``;
    JAX ``mesh.py:44-47``). Keys that start with ``isw_`` (the ISW masks)
    are whole on every rank (``mesh.py:55-60``);
  * the gradients: each rank takes the gradient of its own loss. Once the
    backward is done they are all-reduced in flat float32 buckets and
    divided by N, before the optimizer steps (``DataParallel``; JAX
    ``train/steps.py:180-187``). A parameter the loss does not reach takes a
    zero gradient first (``TrainState.apply_gradients``). Under
    ``accum_steps`` the window's mean is all-reduced once per update, which
    equals JAX's all-reduce of every micro step up to rounding;
  * the batch statistics, by two rules chosen per model, as the JAX trainer
    chooses them (``train/trainer.py:160-166``). The six whitening models
    (``sw``, ``sw_densenet``, ``sw_vgg``, ``ibn``, ``ibn_densenet``, ``isw``)
    are built with ``process_group``: their BatchNorm averages the mean and
    the mean of squares over the ranks in the training forward, and their
    SwitchWhiten the batch mean and covariance, through ``mean_over_ranks``
    (``nn/collectives.py``), which the gradient flows through. Every other model normalises each
    rank's rows with their own statistics, and its running statistics are
    averaged over the ranks after the step;
  * the metrics are averaged when they are read (``average_metrics``), not
    every step;
  * dropout: each rank draws from a generator of its own (the trainer
    seeds it from the epoch's seed and the rank; JAX folds the shard index
    into the step's key, ``mesh.py:101-102``).

The gradient all-reduce starts once the backward has ended: DDP's overlap
of communication with the backward is left to a later change.

``mesh: {data: N, model: M}`` (``make_mesh_2d``,
``build_parallel_train_step_2d``): N M ranks, rank d M + m at data index d
and model index m. The batch shards over the data index only, the bank's
columns over the model index (``parallel/tp.py``); each rank's gradients,
its bank columns' too, are averaged over its data group, and so are the
running statistics after the step; dropout draws from a generator seeded
from the data index, so the M ranks of a data index draw the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

# batch keys that are per-step constants, whole on every rank
REPLICATED_PREFIX = "isw_"
# the size of one flat all-reduce of gradients or buffers
BUCKET_BYTES = 64 * 2**20


def torchrun_command(n: int) -> str:
    return (f"torchrun --nproc_per_node={n} -m dgvcc_tpu_torch --config CONFIG "
            "--task {train,test,train_test,serve}")


def make_mesh(n: int):
    """The data group of ``mesh: {data: n}``: every rank of the job. Raises
    outside a distributed job (the message names the torchrun command), and
    when the job has another number of ranks than n: a silently smaller
    mesh would shard less than the config promises, a larger one would
    train every rank on the same rows."""
    if not dist.is_initialized():
        raise RuntimeError(f"mesh: {{data: {n}}} runs one process a card: start it with "
                           f"{torchrun_command(n)}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh: {{data: {n}}} but the job has {world} ranks; start it with "
                         f"{torchrun_command(n)}")
    return dist.group.WORLD


def host_group():
    """A group of every rank whose collectives take CPU tensors (flags,
    numpy statistics): the default group under gloo, else a new gloo group.
    Every rank calls it, in the same order as the other collectives."""
    if dist.get_backend() == dist.Backend.GLOO:
        return dist.group.WORLD
    return dist.new_group(backend=dist.Backend.GLOO)


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` rows."""
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's rows of every key of a global batch; ``isw_`` keys whole."""
    return {k: v if k.startswith(REPLICATED_PREFIX) else v[shard_rows(len(v), rank, world)]
            for k, v in batch.items()}


def syncs_statistics(model: torch.nn.Module) -> bool:
    """Whether the model's norm layers average their batch statistics over
    ranks in the forward (built with ``process_group``)."""
    return any(getattr(m, "process_group", None) is not None for m in model.modules())


def running_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The floating running statistics of the model's norm layers."""
    return [b for name, b in model.named_buffers()
            if name.rsplit(".", 1)[-1].startswith("running_") and b.is_floating_point()]


def _buckets(tensors: Iterable[torch.Tensor], nbytes: int):
    bucket, size = [], 0
    for t in tensors:
        bucket.append(t)
        size += t.numel() * 4
        if size >= nbytes:
            yield bucket
            bucket, size = [], 0
    if bucket:
        yield bucket


def mean_in_place(tensors: List[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks: flat float32
    buckets, all-reduce SUM, / N."""
    n = dist.get_world_size(group)
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class DataParallel:
    """The collectives of one model's data-parallel step: the gradients'
    mean, and, for a model of the second rule, its running statistics'
    mean after the step."""

    def __init__(self, model: torch.nn.Module, group=None):
        self.model = model
        self.group = group
        self.average_buffers = not syncs_statistics(model)

    def reduce_gradients(self, grads: List[torch.Tensor]) -> None:
        mean_in_place(grads, self.group)

    def after_update(self) -> None:
        # the buffers are looked up each time: a later .to() or load may
        # have replaced the tensors
        buffers = running_statistics(self.model) if self.average_buffers else []
        if buffers:
            with torch.no_grad():
                mean_in_place(buffers, self.group)


def average_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The step's metrics averaged over the ranks (one all-reduce)."""
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(keys, flat.unbind()))


def any_rank(flag: bool, group) -> bool:
    """Whether ``flag`` is set on any rank: an all-reduce MAX on the host
    group, so every rank takes the same branch."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_float(value: float, group, src: int = 0) -> float:
    """Rank ``src``'s value on every rank (host group)."""
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=src, group=group)
    return float(t.item())


def build_parallel_train_step(model, loss, mode: str, log_para: float, group=None,
                              loss_fn: Optional[Callable] = None,
                              con_weight: float = 10.0) -> Callable:
    """``train/steps.py::build_train_step`` with the data-parallel
    collectives (``DataParallel``): step(state, batch, generator, epoch)
    on this rank's rows -> (state, metrics of this rank)."""
    from dgvcc_tpu_torch.train.steps import build_train_step

    return build_train_step(model, loss, mode, log_para, loss_fn=loss_fn,
                            con_weight=con_weight, sync=DataParallel(model, group))


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in ``mesh: {data: N, model: M}``: rank d M + m has
    data index d and model index m (JAX reshapes its devices as (N, M));
    ``data`` is the group of the N ranks with its model index (the batch's
    shards, the gradients' mean), ``model`` the group of the M ranks with
    its data index (the same rows, the bank's columns)."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data: Any
    model: Any


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """The groups of ``mesh: {data: n_data, model: n_model}``. Raises outside
    a distributed job (naming the torchrun command) and unless the job has
    n_data * n_model ranks. Every rank creates every data group and every
    model group, in one fixed order (``new_group`` is collective)."""
    n = n_data * n_model
    mesh = f"mesh: {{data: {n_data}, model: {n_model}}}"
    if not dist.is_initialized():
        raise RuntimeError(f"{mesh} runs one process a card: start it with "
                           f"{torchrun_command(n)}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{mesh} needs {n} ranks but the job has {world}; start it with "
                         f"{torchrun_command(n)}")
    data = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    model = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    d, m = divmod(dist.get_rank(), n_model)
    return Mesh2D(n_data, n_model, d, m, data[m], model[d])


def build_parallel_train_step_2d(model, loss, mode: str, log_para: float, mesh: Mesh2D,
                                 con_weight: float = 10.0) -> Callable:
    """The data-parallel step over ``mesh.data`` for a model whose bank is
    sharded over ``mesh.model`` (``parallel/tp.py::shard_model_bank``): the
    gradients, the bank's columns' too, are averaged over the data group;
    the bank's gradient and optimizer state stay this rank's columns. JAX
    ``mesh.py:128-182``."""
    if getattr(getattr(model, "memory", None), "tp_group", None) is not mesh.model:
        raise ValueError("shard the model's bank over the mesh's model group first "
                         "(parallel/tp.py::shard_model_bank)")
    return build_parallel_train_step(model, loss, mode, log_para, mesh.data,
                                     con_weight=con_weight)


def build_parallel_joint_step(gen_model, reg_model, loss, log_para: float,
                              group=None) -> Callable:
    """Mode joint's step with both models' gradients and running statistics
    averaged over the ranks (JAX ``mesh.py:184-207``)."""
    from dgvcc_tpu_torch.train.genjoint import build_joint_step

    return build_joint_step(gen_model, reg_model, loss, log_para,
                            gen_sync=DataParallel(gen_model, group),
                            reg_sync=DataParallel(reg_model, group))
