"""Ranks as processes on one host, without torchrun: the CPU tests (gloo)
and ``chip_smoke.py``'s data-parallel phase use it.

``run_ranks(fn, world, args)`` starts ``world`` processes with the
``spawn`` method. Each sets torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``: ``local_world`` ranks a node), one
torch thread, joins the process group through a ``file://`` rendezvous
(no port to pick, so parallel test workers cannot collide), runs ``fn(rank,
*args)`` and leaves the group. ``fn`` must be a module-level function of a
module whose import is cheap: ``spawn`` imports it again in each child.
A rank that raises or dies fails the run and ends the other ranks; so does
the time limit.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp


def _rank_main(rank: int, fn: Callable, world: int, local_world: int, backend: str,
               init_file: str, threads: int, args: Sequence):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_world), LOCAL_WORLD_SIZE=str(local_world))
    torch.set_num_threads(threads)
    if backend == "nccl":  # one card a rank
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *, init_file: str,
              backend: str = "gloo", local_world: Optional[int] = None,
              timeout: float = 600.0, threads: int = 1) -> None:
    """Run ``fn(rank, *args)`` on ``world`` ranks; raises if a rank fails
    or the run outlasts ``timeout`` seconds. ``init_file`` must not exist
    yet (a fresh path in a temporary directory)."""
    local_world = local_world or world
    if world % local_world:
        raise ValueError(f"{world} ranks do not split into nodes of {local_world}")
    ctx = tmp.start_processes(_rank_main, nprocs=world, join=False, start_method="spawn",
                              args=(fn, world, local_world, backend, init_file, threads,
                                    tuple(args)))
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__qualname__} outlasted "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
