"""Serving on a mesh, counterpart of the mesh lines of dgvcc_tpu/serve.py
(``:59-87``, ``:180-201``, ``:277-335``, ``:466-526``) and of
dgvcc_tpu/cli/main.py:131-158.

The JAX package serves a whole mesh from one process: ``VideoCounter(mesh=,
shard=)`` jits its program with the batch (``shard="batch"``) or each
frame's height (``shard="spatial"``) sharded. The port runs one process a
rank (``torchrun``, or ``parallel/launch.py::run_ranks``) and every rank
calls the counter with the same frames (SPMD). Each rank uploads and
forwards only its share (its frames, or its rows of every frame) and
returns the whole batch's counts:

  * ``serving_mesh``: the config's serving mesh, by the JAX rule: N is
    ``mesh.spatial`` when ``serve_shard: spatial`` and it is above 1, else
    ``mesh.data``; N = 1 serves in one process (None), as the JAX package
    serves on one device;
  * ``MeshCounts``: the counts' collectives, on ``host_group()`` as CPU
    tensors (they are O(B) scalars; this works under NCCL and under gloo
    ranks sharing a card): the batch's all-gather and the spatial partial
    sums' all-reduce, and rank 0's calibration scales broadcast to every
    rank (absmax readings of separate processes can differ in the last
    bit where their cuDNN algorithms differ);
  * ``Leader`` / ``follow``: one HTTP front end for the mesh. Rank 0's
    ``CountingServer`` drives a ``Leader``, whose ``count_frames``
    broadcasts a header (B, H, W) and the uint8 frames before it counts
    them; the other ranks ``follow``: receive, count, until the leader's
    ``close`` sends the stop header. Only the server's dispatcher thread
    issues collectives, so every rank issues them in one order.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgvcc_tpu_torch.parallel.mesh import host_group, make_mesh, torchrun_command

_STOP = (0, 0, 0)


def serving_mesh_size(cfg) -> Tuple[int, str]:
    """(N, shard) of a config's ``--task serve``: N is ``mesh.spatial``
    under ``serve_shard: spatial`` when above 1, else ``mesh.data``
    (dgvcc_tpu/cli/main.py:131-138)."""
    mesh = cfg.mesh or {}
    shard = cfg.extra.get("serve_shard", "batch")
    sp, dp = int(mesh.get("spatial", 1)), int(mesh.get("data", 1))
    return (sp if shard == "spatial" and sp > 1 else dp), shard


def serving_mesh(n: int, backend: Optional[str] = None, device: str = "cuda"):
    """The process group of an N-rank serving mesh (None for N = 1): joins
    the job's group from torchrun's environment if no group is up yet, and
    raises outside a job, or when the job has another number of ranks than
    N (``make_mesh``'s errors, naming the torchrun command)."""
    from dgvcc_tpu_torch.parallel.multihost import initialize_distributed, torchrun_env

    if n <= 1:
        env = torchrun_env()
        world = dist.get_world_size() if dist.is_initialized() else int(
            (env or {}).get("WORLD_SIZE", 1))
        if world > 1:
            raise ValueError(f"the config serves in one process, but the job has {world} "
                             "ranks; set mesh: {data: N} (or mesh: {spatial: N} with "
                             f"serve_shard: spatial) to serve on N ranks with "
                             f"{torchrun_command(world)}")
        return None
    initialize_distributed(backend, device)
    return make_mesh(n)


def mesh_geometry(mesh) -> Tuple[int, int]:
    """(ranks, this rank's index) of a serving mesh; (1, 0) for None."""
    if mesh is None:
        return 1, 0
    if not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed process group "
                        f"(parallel/mesh.py::make_mesh), got {type(mesh).__name__}")
    return dist.get_world_size(mesh), dist.get_rank(mesh)


class MeshCounts:
    """The collectives of a counter on ``mesh``, on one host group made
    once (``host_group`` is collective under NCCL: every rank builds its
    counter at the same point)."""

    def __init__(self, mesh):
        self.world, self.rank = mesh_geometry(mesh)
        self.host = host_group()
        self.root = dist.get_global_rank(mesh, 0)

    def gather(self, local: np.ndarray) -> np.ndarray:
        """Every rank's equal-length counts, in rank order."""
        t = torch.from_numpy(np.ascontiguousarray(local, np.float32))
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.host)
        return torch.cat(parts).numpy()

    def sum(self, local: np.ndarray) -> np.ndarray:
        """The ranks' partial counts summed."""
        t = torch.from_numpy(np.array(local, np.float32))
        dist.all_reduce(t, group=self.host)
        return t.numpy()

    def rank0(self, compute: Callable):
        """``compute()`` on rank 0, its result on every rank (a picklable
        object; the other ranks do not call it)."""
        box = [compute() if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=self.root, group=self.host)
        return box[0]

    # ---- the leader's frames ---------------------------------------------

    def send_frames(self, frames: Optional[np.ndarray]) -> None:
        """Rank 0: the header (B, H, W; zeros to stop), then the frames."""
        head = torch.tensor(_STOP if frames is None else frames.shape[:3], dtype=torch.int64)
        dist.broadcast(head, src=self.root, group=self.host)
        if frames is not None:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(frames, np.uint8)),
                           src=self.root, group=self.host)

    def recv_frames(self) -> Optional[np.ndarray]:
        """Another rank: the leader's next frames, or None on stop."""
        head = torch.zeros(3, dtype=torch.int64)
        dist.broadcast(head, src=self.root, group=self.host)
        b, h, w = (int(v) for v in head)
        if b == 0:
            return None
        frames = torch.empty((b, h, w, 3), dtype=torch.uint8)
        dist.broadcast(frames, src=self.root, group=self.host)
        return frames.numpy()


class Leader:
    """Rank 0's face of a mesh counter for ``serve_http.CountingServer``:
    ``count_frames`` sends the frames to the followers, then counts them
    with them; ``close`` (the dispatcher's last call) stops the followers.
    Every other attribute is the counter's."""

    def __init__(self, counter):
        self.counter = counter

    def __getattr__(self, name):
        return getattr(self.counter, name)

    def count_frames(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.uint8)
        self.counter.comm.send_frames(frames)
        return self.counter.count_frames(frames)

    def close(self) -> None:
        self.counter.comm.send_frames(None)


def follow(counter) -> int:
    """A rank other than 0 of an HTTP mesh: count the leader's frames until
    it stops; returns the number of batches counted. An error in a batch
    is the leader's to answer; the follower goes on."""
    n = 0
    while True:
        frames = counter.comm.recv_frames()
        if frames is None:
            return n
        try:
            counter.count_frames(frames)
        except Exception as e:  # the same batch fails on the leader, which answers it
            print(f"[serve rank {counter.comm.rank}] batch {n}: {type(e).__name__}: {e}",
                  flush=True)
        n += 1
