"""The JAX package's checkpoints (``*.ckpt``) read without JAX, flax or
msgpack.

``dgvcc_tpu/train/checkpoint.py`` writes the train state as one msgpack
document through ``flax.serialization``: a map of ``params``,
``batch_stats``, ``opt_state``, ``step``, optionally ``ema_params`` and
``extra`` (epoch, best, the scheduler's state). ``utils/msgpack.py``
decodes the subset of msgpack that writer emits; arrays come back as numpy
arrays (bfloat16 widened to float32, numpy has no bfloat16).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from dgvcc_tpu_torch.utils.msgpack import unpackb

__all__ = ["read_jax_checkpoint", "to_python", "unpackb"]


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's ``.ckpt`` as a dict of numpy trees."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def to_python(tree):
    """0-d arrays in ``extra`` (epoch, best, scheduler state) -> Python
    scalars."""
    if isinstance(tree, dict):
        return {k: to_python(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim == 0:
        return tree.item()
    if isinstance(tree, np.generic):
        return tree.item()
    return tree
