"""Several processes and several nodes, counterpart of
dgvcc_tpu/parallel/multihost.py.

The port maps one JAX host onto one node and one chip onto one rank (one
card, one process). A single-node ``torchrun --nproc_per_node=N`` job is
the JAX single-host mesh: the config's ``batch_size`` is the global batch.
A job over several nodes (``WORLD_SIZE > LOCAL_WORLD_SIZE``) is the JAX
pod: ``batch_size`` is per node, a ``DistributedSampler`` deals each
shuffled epoch over the nodes, and the node's batch is split over its
ranks. Evaluation loaders stay whole on every rank.

  * ``initialize_distributed``: the process group from torchrun's
    environment; a no-op for a run with none;
  * ``node_layout``: this rank's node and place in it;
  * ``DistributedSampler``: the JAX sampler's indices, bit for bit;
  * ``allgather_sum`` / ``allgather_mean``: numpy trees summed or averaged
    over the ranks, by all-reduce (the port's collectives are all-reduce
    and broadcast only, which gloo also runs on CUDA tensors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def torchrun_env() -> Optional[dict]:
    """torchrun's variables of this process, or None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return {k: os.environ[k] for k in TORCHRUN_ENV if k in os.environ}


def initialize_distributed(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Join the job's process group from torchrun's environment; returns
    whether the process is in one. Already joined: nothing to do. No
    environment: a one-process run, nothing to do. ``backend`` defaults to
    NCCL for the card and gloo for the CPU; NCCL needs a card a rank, so
    more local ranks than cards raise (gloo lets ranks share one). A
    configured job whose bootstrap fails raises: a job silently degraded
    to one process would train on 1/N of the data."""
    if dist.is_initialized():
        return True
    env = torchrun_env()
    if env is None:
        return False
    on_card = not str(device).startswith("cpu")
    backend = backend or (dist.Backend.NCCL if on_card else dist.Backend.GLOO)
    if backend == dist.Backend.NCCL:
        if not on_card:
            raise ValueError("NCCL runs on the card; --device cpu takes the gloo backend")
        local = int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(f"NCCL needs one card a rank: {local} ranks on this node, "
                             f"{cards} card(s) visible; pass --dist-backend gloo to let "
                             "ranks share a card")
    if on_card:
        torch.cuda.set_device(rank_card(int(env.get("LOCAL_RANK", env["RANK"]))))
    dist.init_process_group(backend, init_method="env://")
    return True


def rank_card(local_rank: int) -> int:
    """The card of a local rank: ``cuda:{LOCAL_RANK}``, wrapped onto the
    visible cards when ranks share them (gloo)."""
    return local_rank % max(torch.cuda.device_count(), 1)


@dataclasses.dataclass(frozen=True)
class NodeLayout:
    rank: int
    world: int
    local_rank: int
    local_world: int

    @property
    def node(self) -> int:
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        return self.world // self.local_world


def node_layout() -> NodeLayout:
    """This rank's place: its rank and node, from the process group and
    torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (one node when they
    are absent). torchrun numbers the ranks node by node."""
    rank, world = dist.get_rank(), dist.get_world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    if world % local_world or local_rank != rank % local_world:
        raise ValueError(f"rank {rank} of {world} with LOCAL_RANK {local_rank} of "
                         f"LOCAL_WORLD_SIZE {local_world}: not torchrun's node-by-node "
                         "numbering")
    return NodeLayout(rank, world, local_rank, local_world)


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(np.asarray(tree))
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def allgather_sum(tree, group=None):
    """A tree (dicts, lists, tuples) of numpy arrays or numbers summed over
    the ranks; each leaf keeps its dtype and shape. One process: the tree
    itself. The group must take CPU tensors (``mesh.host_group``)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    leaves = _leaves(tree, [])
    flat = torch.from_numpy(np.concatenate([x.astype(np.float64).ravel() for x in leaves]))
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for x in leaves:
        out.append(flat[offset:offset + x.size].numpy().reshape(x.shape).astype(x.dtype))
        offset += x.size
    return _rebuild(tree, iter(out))


def allgather_mean(tree, group=None):
    """``allgather_sum`` divided by the number of ranks: for statistics
    every rank gathered over the same data (the ISW tracker's, from the
    whole validation set on every rank), so that every rank derives the
    same masks from the same bits."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    n = dist.get_world_size(group)
    summed = allgather_sum(tree, group)
    leaves = [np.asarray(x / n).astype(np.asarray(x).dtype) for x in _leaves(summed, [])]
    return _rebuild(summed, iter(leaves))


class DistributedSampler:
    """Disjoint per-node index slices of each epoch (JAX
    ``multihost.py:136-176``): epoch e shuffles ``arange(n)`` with
    ``default_rng(SeedSequence([seed, e]))``, pads to a whole number of
    ``world_size * batch_size`` by wrapping (every node runs the same number
    of steps), and hands node ``rank`` the stride ``rank::world_size``.
    ``batch_size`` is per node."""

    def __init__(self, n: int, batch_size: int, seed: int = 0, shuffle: bool = True,
                 rank: int = 0, world_size: int = 1):
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = shuffle
        self.rank, self.world_size = int(rank), int(world_size)
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside world {self.world_size}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This node's sample indices for ``epoch``, grouped per batch."""
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).shuffle(idx)
        stride = self.world_size * self.batch_size
        total = len(self) * stride
        if total > self.n:
            idx = np.resize(idx, total)
        return idx[self.rank::self.world_size]

    def __len__(self) -> int:
        """Batches a node runs an epoch (the same on every node)."""
        return max(1, -(-self.n // (self.world_size * self.batch_size)))
