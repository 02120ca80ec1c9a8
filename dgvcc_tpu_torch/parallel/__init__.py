"""Parallelism over ``torch.distributed``, counterpart of
dgvcc_tpu/parallel/ (``mesh.py``, ``tp.py``, ``spatial.py``, ``eval.py``,
``multihost.py``): one process a card, started by ``torchrun``.

  * ``multihost.py``: the bootstrap from torchrun's environment, the
    cross-node ``DistributedSampler`` and the numpy-tree reductions;
  * ``mesh.py``: the data group, the 2-D ``(data, model)`` mesh, the rank's
    rows of a batch and the data-parallel train steps (1-D and 2-D);
  * ``tp.py``: the bank sharded over the model group, its attention's
    collectives, and the whole bank for evaluation and checkpoints;
  * ``spatial.py``: the crop's height sharded over the ranks: the batch's
    rows, the layers' switch and the spatial step;
  * ``eval.py``: ``ShardedTiledCounter``, the tile batch shared out over
    the ranks;
  * ``serving.py``: serving on a mesh (``serve.py``'s ``mesh`` / ``shard``,
    ``--task serve`` under torchrun): the config's serving mesh, the
    counts' collectives, rank 0's scales and the HTTP leader and followers;
  * ``launch.py``: ranks as spawned processes on one host (the tests and
    ``chip_smoke.py``).

The collectives that layers call in their forward (the differentiable mean
over ranks, the halo exchange) are in ``nn/collectives.py``. Nothing is
imported here: each module is imported where it is used.
"""
