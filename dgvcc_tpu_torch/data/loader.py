"""Host data loader: seeded shuffling, threaded decode, prefetch.

Counterpart of dgvcc_tpu/data/loader.py, with the same seed keys: the
epoch's order is ``np.random.RandomState((seed * 1_000_003 + epoch) %
2**31)`` shuffling ``arange(n)``, and sample i of epoch e draws from
``random.Random(f"{seed}:{e}:{i}")``. So one seed gives the same batches
as the JAX package's loader, bit for bit, whatever the worker count.

Batches are numpy dicts (NHWC images); the trainer moves them to the
card. ``drop_last`` defaults to ``shuffle``, as in the JAX package. Workers
are threads (PIL decode and numpy release the GIL); the JAX package's
``worker_mode: process`` and multi-host sampler are not ported
(ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, drop_last: Optional[bool] = None,
                 seed: int = 0, collate=None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.collate = collate if collate is not None else type(dataset).collate
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % (2**31))
            rs.shuffle(idx)
        return idx

    def _fetch(self, index: int):
        rng = random.Random(f"{self.seed}:{self.epoch}:{int(index)}")
        return self.dataset.__getitem__(int(index), rng=rng)

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [idx[b * self.batch_size : (b + 1) * self.batch_size]
                   for b in range(len(self))]
        if self.num_workers <= 0:
            for b in batches:
                yield self._assemble([self._fetch(i) for i in b])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # keep `prefetch` batches in flight beyond the one being read
            pending = []
            bi = 0
            while bi < len(batches) or pending:
                while bi < len(batches) and len(pending) <= self.prefetch:
                    pending.append([pool.submit(self._fetch, i) for i in batches[bi]])
                    bi += 1
                futs = pending.pop(0)
                yield self._assemble([f.result() for f in futs])

    def _assemble(self, samples):
        if self.batch_size == 1 and "name" in samples[0]:
            return samples[0]  # val / test: one raw sample dict
        return self.collate(samples)


def build_loader(dataset, spec: dict, seed: int = 0, collate=None) -> DataLoader:
    """``spec`` is the reference's {train,val,test}_loader YAML block;
    ``pin_memory`` is accepted and unused (the trainer pins what it
    uploads)."""
    mode = spec.get("worker_mode", "thread")
    if mode != "thread":
        raise NotImplementedError(
            f"worker_mode {mode!r} is not ported to dgvcc_tpu_torch yet (threads "
            "only); see ROADMAP.md, Queue 1 item 9")
    return DataLoader(
        dataset,
        batch_size=spec.get("batch_size", 1),
        shuffle=spec.get("shuffle", False),
        num_workers=spec.get("num_workers", 0),
        drop_last=spec.get("drop_last"),
        seed=seed,
        collate=collate,
        prefetch=spec.get("prefetch", 2),
    )
