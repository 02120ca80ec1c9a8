"""Checkpoints, counterpart of dgvcc_tpu/train/checkpoint.py.

The reference's artifact contract (trainers/trainer.py:106-115): a rolling
``last``, a rolling ``best_{epoch}_{criterion:.4f}`` and the
threshold-gated ``test_{mae}``, under the run's log dir. Each is a
``.pth`` holding a plain state_dict in the reference DGVCC key layout, so
a reference DGModel and ``VideoCounter.from_checkpoint`` strict-load it.

Beside each goes a training-state sidecar, ``{stem}.state.pt``: the
optimizer's ``state_dict`` (AdamW moments), the step count and ``extra``
(``epoch``, ``best``, the scheduler's state). With it a resume is exact,
as from the JAX package's ``last.ckpt``. Both files are written to
``.tmp`` names first and renamed only when both are complete; the
rotation purge runs after the write and removes a sidecar with its
checkpoint.

Loading is non-strict like the reference (``load_state_dict(strict=False)``,
trainer.py:41-44): matching weights are restored, a missing, unexpected or
mis-shaped one is a warning; ``strict=True`` raises on any of them.
Reading the JAX package's msgpack ``.ckpt`` is not ported (ROADMAP.md,
Queue 1 item 4).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Dict, List, Optional, Tuple

import torch

from dgvcc_tpu_torch.nn.convert import load_reference_pth

SUFFIX = ".pth"
SIDECAR = ".state.pt"


def sidecar_path(path: str) -> str:
    """The training-state file that goes with checkpoint ``path``."""
    stem = path[: -len(SUFFIX)] if path.endswith(SUFFIX) else path
    return stem + SIDECAR


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state``'s model weights to ``path`` and its optimizer, step
    and ``extra`` to the sidecar; both staged before either rename."""
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    train = {"optimizer": state.optimizer.state_dict(), "step": int(state.step),
             "extra": dict(extra or {})}
    side = sidecar_path(path)
    for p, obj in ((path, weights), (side, train)):
        torch.save(obj, p + ".tmp")
    os.replace(path + ".tmp", path)
    os.replace(side + ".tmp", side)


def load_checkpoint(path: str, state, strict: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    """Restore checkpoint ``path`` (a port or reference ``.pth``) into
    ``state``'s model, and its sidecar, when there is one, into the
    optimizer and step. Returns (extra, warnings); ``extra`` is {} without
    a sidecar."""
    if not str(path).endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"checkpoint {path!r}: the JAX package's msgpack checkpoints are not "
            "ported to dgvcc_tpu_torch yet (ROADMAP.md, Queue 1 item 4); export a "
            ".pth with `python -m dgvcc_tpu.cli.main --task export`")
    loaded = load_reference_pth(path)
    current = state.model.state_dict()
    warnings = [f"unexpected in checkpoint: {k}" for k in loaded if k not in current]
    merged = {}
    for k, v in current.items():
        if k not in loaded:
            warnings.append(f"missing in checkpoint: {k}")
        elif tuple(loaded[k].shape) != tuple(v.shape):
            warnings.append(f"shape mismatch at {k}: ckpt {tuple(loaded[k].shape)} vs "
                            f"model {tuple(v.shape)}")
        else:
            merged[k] = loaded[k]
    if strict and warnings:
        raise ValueError("strict load failed:\n" + "\n".join(warnings))
    state.model.load_state_dict(merged, strict=False)

    side = sidecar_path(str(path))
    if not os.path.exists(side):
        return {}, warnings
    train = torch.load(side, map_location="cpu", weights_only=True)
    try:
        state.optimizer.load_state_dict(train["optimizer"])
    except (ValueError, KeyError) as e:  # the optimizer changed: weights only
        warnings.append(f"optimizer state not restored: {e}")
    state.step = int(train.get("step", state.step))
    return train.get("extra", {}), warnings


class CheckpointRotator:
    """The reference's rolling last / best files (trainer.py:106-115) under
    a log dir."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def _path(self, stem: str) -> str:
        return os.path.join(self.log_dir, stem + SUFFIX)

    def _purge(self, pattern: str, keep: str):
        for old in glob(os.path.join(self.log_dir, pattern + SUFFIX)):
            if old != keep:
                os.remove(old)
                if os.path.exists(sidecar_path(old)):
                    os.remove(sidecar_path(old))

    def _save(self, stem: str, state, extra, purge: Optional[str] = None):
        """One save, then the rotation purge: purging first would open a
        window in which the previous checkpoint is gone and the new one
        not yet written."""
        path = self._path(stem)
        save_checkpoint(path, state, extra)
        if purge:
            self._purge(purge, keep=path)
        return path

    def save_last(self, state, extra=None):
        return self._save("last", state, extra, purge="last*")

    def save_best(self, state, epoch: int, criterion: float, extra=None):
        return self._save(f"best_{epoch}_{criterion:.4f}", state, extra, purge="best*")

    def save_test(self, state, mae: float, extra=None):
        return self._save(f"test_{mae}", state, extra)
