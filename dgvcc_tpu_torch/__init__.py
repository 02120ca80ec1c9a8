"""dgvcc_tpu_torch — the PyTorch / CUDA port of dgvcc_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is held
against. It imports torch and never JAX, flax or dgvcc_tpu. This slice
serves the DGModel family (eval forward, VideoCounter, ``--task serve``)
through a hand-written CUDA memory-attention kernel (csrc/).
"""

__version__ = "0.1.0"
