"""File and console logger with the reference's log contract.

A copy of ``dgvcc_tpu/core/logging.py``: every message is printed and
appended to ``{log_dir}/log.txt`` like the reference Trainer.log
(trainers/trainer.py:32-39), ``end=' '`` chaining metrics on one line.
"""

from __future__ import annotations

import os


class RunLogger:
    """``write=False`` (a data-parallel rank other than 0) logs nothing:
    rank 0 alone prints and writes log.txt."""

    def __init__(self, log_dir: str, write: bool = True):
        self.log_dir = log_dir
        self.write = write
        if write:
            os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, "log.txt")

    def log(self, msg: str, verbose: bool = True, end: str = "\n"):
        if not self.write:
            return
        if verbose:
            print(msg, end=end, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + end)
