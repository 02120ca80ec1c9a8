"""dgvcc_tpu_torch — the PyTorch / CUDA port of dgvcc_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is held
against. It imports torch and never JAX, flax or dgvcc_tpu. It serves the
DGModel family, the whitening counters and the U-Net regressors (eval
forward, VideoCounter, ``--task serve`` from a directory or over HTTP,
``serve_http.py``, and a fleet of replicas, ``serve_fleet.py``), makes the
density maps of a dataset (``data/dmap_cli.py``) and trains and tests it
(datasets and loader in ``data/``, the per-mode train step, ``DGTrainer``
and checkpoints in ``train/``, tiled evaluation in ``ops/tiling.py``,
``--task train/test/vis/train_test``) through hand-written CUDA kernels
(csrc/): the memory attention for serving and for training, and the
Gaussian density map.
"""

__version__ = "0.1.0"
