"""Per-card process pinning, counterpart of dgvcc_tpu/utils/devices.py.

The serving fleet (``serve_fleet.py``) restricts each replica process to
one card, as the reference's ``CUDA_VISIBLE_DEVICES=N`` in its train*.sh
does.
"""

from __future__ import annotations

import os
from typing import Optional


def chip_env(device: Optional[str]) -> dict:
    """The environment of a child process pinned to card ``device`` (None:
    inherit every card). It sets ``CUDA_VISIBLE_DEVICES`` and no ``TPU_*``
    variable: the child sees that card alone, as ``cuda:0``."""
    env = dict(os.environ)
    if device is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(device)
    return env
