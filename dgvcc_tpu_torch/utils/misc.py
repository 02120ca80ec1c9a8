"""Small host-side helpers: geometry, meters, seeding, progress.

A copy of ``dgvcc_tpu/utils/misc.py`` (reference utils/misc.py:12-148),
so that the port imports nothing of the JAX package. ``seed_everything``
seeds torch as well as python and numpy.
"""

from __future__ import annotations

import os
import random
import sys
import time

import numpy as np
import torch

# Images are normalized with mean=std=0.5 per channel (reference
# utils/misc.py:70-80 and datasets/base_dataset.py:34-46).
NORM_MEAN = 0.5
NORM_STD = 0.5


def random_crop(im_h: int, im_w: int, crop_h: int, crop_w: int, rng: random.Random | None = None):
    """Uniform random top-left corner for a crop (reference utils/misc.py:12-17)."""
    r = rng if rng is not None else random
    i = r.randint(0, im_h - crop_h)
    j = r.randint(0, im_w - crop_w)
    return i, j


def get_padding(h: int, w: int, new_h: int, new_w: int):
    """Centered padding (left, top, right, bottom) to reach (new_h, new_w):
    no shrink, the remainder goes to bottom / right (utils/misc.py:19-37)."""
    if h >= new_h:
        top = bottom = 0
    else:
        dh = new_h - h
        top = dh // 2
        bottom = dh - top
        h = new_h
    if w >= new_w:
        left = right = 0
    else:
        dw = new_w - w
        left = dw // 2
        right = dw - left
        w = new_w
    return (left, top, right, bottom), h, w


def cal_inner_area(c_left, c_up, c_right, c_down, bbox):
    """Intersection area of a crop window with each bbox row (utils/misc.py:39-45)."""
    inner_left = np.maximum(c_left, bbox[:, 0])
    inner_up = np.maximum(c_up, bbox[:, 1])
    inner_right = np.minimum(c_right, bbox[:, 2])
    inner_down = np.minimum(c_down, bbox[:, 3])
    return np.maximum(inner_right - inner_left, 0.0) * np.maximum(inner_down - inner_up, 0.0)


def denormalize(img: np.ndarray) -> np.ndarray:
    """Invert the 0.5/0.5 normalization (reference utils/misc.py:69-80)."""
    return img * NORM_STD + NORM_MEAN


class AverageMeter:
    """Running average (reference utils/misc.py:86-101)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class DictAvgMeter:
    """Per-key running averages (reference utils/misc.py:103-122)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = {}
        self.avg = {}
        self.sum = {}
        self.count = {}

    def update(self, val, n=1):
        for k, v in val.items():
            if k not in self.val:
                self.sum[k] = 0.0
                self.count[k] = 0
            self.val[k] = v
            self.sum[k] += v * n
            self.count[k] += n
            self.avg[k] = self.sum[k] / self.count[k]


def seed_everything(seed: int):
    """Seed python, numpy and torch's global RNGs (utils/misc.py:124-132).
    The port's own random draws (dropout) come from explicit
    ``torch.Generator``s seeded by their callers."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_current_datetime() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


def progress(iterable, description: str = "", enabled=None, stream=None,
             min_interval: float = 0.1):
    """In-loop progress line (reference ``easy_track``, utils/misc.py:147-148).

    Writes a carriage-return status line (`desc  n/total (pct)  elapsed`) to
    stderr on a TTY and nothing otherwise (``enabled=None`` detects it);
    only the loop index is reported, never a metric, so it costs no device
    synchronisation. Throttled to ``min_interval`` seconds.
    """
    if stream is None:
        stream = sys.stderr
    if enabled is None:
        enabled = hasattr(stream, "isatty") and stream.isatty()
    if not enabled:
        yield from iterable
        return
    total = len(iterable) if hasattr(iterable, "__len__") else None
    start = time.time()
    last = 0.0
    n = 0
    wrote = False
    try:
        for item in iterable:
            n += 1
            now = time.time()
            if now - last >= min_interval or n == total:
                last = now
                el = now - start
                if total:
                    msg = (f"\r{description} {n}/{total} "
                           f"({100 * n / max(total, 1):3.0f}%) {el:6.1f}s")
                else:
                    msg = f"\r{description} {n} it {el:6.1f}s"
                stream.write(msg)
                stream.flush()
                wrote = True
            yield item
    finally:
        if wrote:
            stream.write("\n")
            stream.flush()
