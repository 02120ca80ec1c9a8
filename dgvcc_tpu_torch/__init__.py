"""dgvcc_tpu_torch — the PyTorch / CUDA port of dgvcc_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is held
against. It imports torch and never JAX, flax or dgvcc_tpu. It serves the
DGModel family (eval forward, VideoCounter, ``--task serve``) and trains
it (two-view ``forward_train``, the per-mode train step, optimizers and
schedulers in ``train/``) through hand-written CUDA memory-attention
kernels (csrc/).
"""

__version__ = "0.1.0"
