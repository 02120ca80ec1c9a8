"""Optional TensorBoard scalar logging (config key ``tensorboard: true``).

A copy of ``dgvcc_tpu/core/tb.py``: per-epoch train-loss components,
validation criterion and extras, learning rate and epoch wall time as TB
scalars under ``{log_dir}/{version}/tb/``, additive to ``log.txt``.
``torch.utils.tensorboard`` is imported on first use and only when
enabled; every method is a no-op when disabled, and an import or write
failure logs one warning and disables the writer instead of ending the
run.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional


class ScalarWriter:
    """TB scalar writer; inert unless ``enabled`` and torch TB imports."""

    def __init__(self, logdir: str, enabled: bool = False,
                 warn: Optional[Callable[[str], None]] = None):
        self.logdir = logdir
        self.enabled = bool(enabled)
        self._warn = warn or (lambda msg: print(msg, flush=True))
        self._writer = None

    def _get(self):
        if self._writer is None:
            # construction included: an unwritable logdir must disable
            # logging, not end the run
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=self.logdir)
            except Exception as e:
                self._warn(f"[tb] tensorboard disabled ({e})")
                self.enabled = False
                return None
        return self._writer

    def scalar(self, tag: str, value, step: int):
        if not self.enabled:
            return
        w = self._get()
        if w is None:
            return
        try:
            w.add_scalar(tag, float(value), int(step))
        except Exception as e:
            self._warn(f"[tb] write failed, disabling ({e})")
            self.enabled = False

    def scalars(self, values: Mapping[str, float], step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def flush(self):
        # guarded: close runs in the trainer's finally blocks, where a raise
        # would mask the real exception
        if self._writer is not None:
            try:
                self._writer.flush()
            except Exception as e:
                self._warn(f"[tb] flush failed, disabling ({e})")
                self.enabled = False

    def close(self):
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception as e:
                self._warn(f"[tb] close failed ({e})")
            self._writer = None
