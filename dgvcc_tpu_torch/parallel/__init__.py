"""Data parallelism over ``torch.distributed``, counterpart of the 1-D
``mesh: {data: N}`` path of dgvcc_tpu/parallel/ (``mesh.py``, ``eval.py``,
``multihost.py``): one process a card, started by ``torchrun``.

  * ``multihost.py``: the bootstrap from torchrun's environment, the
    cross-node ``DistributedSampler`` and the numpy-tree reductions;
  * ``mesh.py``: the data group, the rank's rows of a batch, the
    differentiable mean over ranks and the data-parallel train steps;
  * ``eval.py``: ``ShardedTiledCounter``, the tile batch shared out over
    the ranks;
  * ``launch.py``: ranks as spawned processes on one host (the tests and
    ``chip_smoke.py``).

Nothing is imported here: each module is imported where it is used.
"""
