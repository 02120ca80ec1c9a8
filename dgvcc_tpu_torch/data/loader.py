"""Host data loader: seeded shuffling, threaded decode, prefetch.

Counterpart of dgvcc_tpu/data/loader.py, with the same seed keys: the
epoch's order is ``np.random.RandomState((seed * 1_000_003 + epoch) %
2**31)`` shuffling ``arange(n)``, and sample i of epoch e draws from
``random.Random(f"{seed}:{e}:{i}")``. So one seed gives the same batches
as the JAX package's loader, bit for bit, whatever the worker count.

Batches are numpy dicts (NHWC images); the trainer moves them to the
card. ``drop_last`` defaults to ``shuffle``, as in the JAX package.

``worker_mode``: ``thread`` (the default; PIL decode and numpy release the
GIL, the Python between them does not) or ``process``: a ``fork`` pool
that inherits the dataset and maps ``(seed_key, index)`` to samples with
``imap``, one sample a task, a batch at a time with ``prefetch`` batches
in flight as the thread workers have, in order, so its batches are the
thread loader's. ``start()`` forks the workers ahead of the first epoch; the
trainer calls it before its model goes to the card, where the parent is
small and has no CUDA context yet. A worker touches no CUDA and no
tensor in any case: samples are numpy, built by PIL and numpy only. It
goes back to the default SIGTERM and ignores SIGINT, so ``close()`` (also
called by ``__del__`` and at the end of the trainer's runs) can end it
whatever handler the trainer installed.

Data parallel (``mesh: {data: N}``): ``shard=(i, n)`` makes the loader
yield share i of n of each batch, the contiguous rows [i B/n, (i+1) B/n)
of the batch the loader would yield without it, and fetch only those rows:
each rank decodes its own rows of the one-process batch, bit for bit. On
several nodes a ``sampler`` (``parallel/multihost.py::DistributedSampler``)
gives the node its own indices of each epoch, batch_size being per node
(the JAX pod's loader).
"""

from __future__ import annotations

import multiprocessing as mp
import random
import signal
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from dgvcc_tpu_torch.parallel.mesh import shard_rows

WORKER_MODES = ("thread", "process")

# the dataset of a process worker, set in the worker by _init_worker
_worker_dataset = None


def _init_worker(dataset):
    global _worker_dataset
    _worker_dataset = dataset
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)


def _process_fetch(args):
    seed_key, index = args
    return _worker_dataset.__getitem__(index, rng=random.Random(seed_key))


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, drop_last: Optional[bool] = None,
                 seed: int = 0, collate=None, prefetch: int = 2,
                 worker_mode: str = "thread", shard: Optional[Tuple[int, int]] = None,
                 sampler=None):
        self._pool = None
        if worker_mode not in WORKER_MODES:
            raise ValueError(f"worker_mode {worker_mode!r}: not one of {WORKER_MODES}")
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"batch_size {batch_size} does not split over {shard[1]} ranks")
        if sampler is not None and sampler.batch_size != batch_size:
            raise ValueError(f"sampler.batch_size={sampler.batch_size} != loader "
                             f"batch_size={batch_size}; they must match")
        self.shard = shard
        self.sampler = sampler
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.collate = collate if collate is not None else type(dataset).collate
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self.epoch = 0

    def __len__(self):
        if self.sampler is not None:
            return len(self.sampler)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        if self.sampler is not None:  # wrap-padded to whole batches already
            return self.sampler.epoch_indices(self.epoch)
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % (2**31))
            rs.shuffle(idx)
        return idx

    def _seed_key(self, index: int) -> str:
        return f"{self.seed}:{self.epoch}:{int(index)}"

    def _fetch(self, index: int):
        return self.dataset.__getitem__(int(index), rng=random.Random(self._seed_key(index)))

    def start(self):
        """Fork the process workers now (a no-op for threads or no workers)."""
        if self.worker_mode == "process" and self.num_workers > 0 and self._pool is None:
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self):
        """End the process workers (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        self.close()

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [idx[b * self.batch_size : (b + 1) * self.batch_size]
                   for b in range(len(self))]
        if self.shard is not None:
            i, n = self.shard
            batches = [b[shard_rows(len(b), i, n)] for b in batches]
        if self.num_workers <= 0:
            for b in batches:
                yield self._assemble([self._fetch(i) for i in b])
            return
        if self.worker_mode == "process":
            pool = self.start()
            yield from self._pipelined(batches, lambda b: pool.imap(
                _process_fetch, [(self._seed_key(i), int(i)) for i in b]), list)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            yield from self._pipelined(
                batches, lambda b: [pool.submit(self._fetch, i) for i in b],
                lambda futs: [f.result() for f in futs])

    def _pipelined(self, batches, submit, result):
        """Batches in order, keeping ``prefetch`` of them in flight beyond
        the one being read (so a process pool buffers a few batches, not
        the epoch)."""
        pending = []
        bi = 0
        while bi < len(batches) or pending:
            while bi < len(batches) and len(pending) <= self.prefetch:
                pending.append(submit(batches[bi]))
                bi += 1
            yield self._assemble(result(pending.pop(0)))

    def _assemble(self, samples):
        if self.batch_size == 1 and "name" in samples[0]:
            return samples[0]  # val / test: one raw sample dict
        return self.collate(samples)


def build_loader(dataset, spec: dict, seed: int = 0, collate=None,
                 layout=None) -> DataLoader:
    """``spec`` is the reference's {train,val,test}_loader YAML block;
    ``pin_memory`` is accepted and unused (the trainer pins what it
    uploads). ``layout`` (``parallel/multihost.py::NodeLayout``, data
    parallel): a shuffled loader yields this rank's rows, of the node's own
    sampler on several nodes; the others stay whole on every rank."""
    shard = sampler = None
    if layout is not None and spec.get("shuffle", False):
        shard = (layout.local_rank, layout.local_world)
        if layout.nodes > 1:
            from dgvcc_tpu_torch.parallel.multihost import DistributedSampler

            sampler = DistributedSampler(len(dataset), spec.get("batch_size", 1), seed=seed,
                                         rank=layout.node, world_size=layout.nodes)
    return DataLoader(
        dataset,
        batch_size=spec.get("batch_size", 1),
        shuffle=spec.get("shuffle", False),
        num_workers=spec.get("num_workers", 0),
        drop_last=spec.get("drop_last"),
        seed=seed,
        collate=collate,
        prefetch=spec.get("prefetch", 2),
        worker_mode=spec.get("worker_mode", "thread"),
        shard=shard,
        sampler=sampler,
    )
