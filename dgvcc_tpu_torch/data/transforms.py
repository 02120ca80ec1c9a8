"""Host-side image transforms (PIL + numpy).

A copy of ``dgvcc_tpu/data/transforms.py``: the torchvision transforms of
the reference (datasets/base_dataset.py:34-46,
datasets/den_cls_dataset.py:29-35) with the same probabilities, factor
ranges and op semantics, drawing from an explicit ``random.Random``. The
same draws give the same pixels as the JAX package's pipeline.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance

from dgvcc_tpu_torch.utils.misc import NORM_MEAN, NORM_STD


def to_tensor_normalize(img: Image.Image) -> np.ndarray:
    """PIL RGB -> float32 HWC in [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - NORM_MEAN) / NORM_STD


def adjust_brightness(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Brightness(img).enhance(factor)


def adjust_contrast(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Contrast(img).enhance(factor)


def adjust_saturation(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Color(img).enhance(factor)


def adjust_sharpness(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Sharpness(img).enhance(factor)


def adjust_hue(img: Image.Image, factor: float) -> Image.Image:
    """Shift hue by factor (in turns, [-0.5, 0.5]) — torchvision adjust_hue."""
    if factor == 0:
        return img
    h, s, v = img.convert("HSV").split()
    h_arr = np.asarray(h, dtype=np.int16)
    h_arr = ((h_arr + int(factor * 255)) % 256).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(h_arr, "L"), s, v)).convert("RGB")


def gaussian_blur3(img: Image.Image, sigma: float = 1.0) -> Image.Image:
    """3x3 Gaussian blur, reflect padding — torchvision GaussianBlur(3, sigma)."""
    k = np.exp(-0.5 * (np.array([-1.0, 0.0, 1.0]) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    arr = np.asarray(img, dtype=np.float32)
    padded = np.pad(arr, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    # separable 1-D convolutions
    tmp = k[0] * padded[:, :-2] + k[1] * padded[:, 1:-1] + k[2] * padded[:, 2:]
    out = k[0] * tmp[:-2] + k[1] * tmp[1:-1] + k[2] * tmp[2:]
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


class ColorJitter:
    """torchvision ColorJitter: uniform factors, random op order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: Image.Image, rng: random.Random) -> Image.Image:
        ops = []
        if self.brightness:
            f = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.contrast:
            f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        if self.saturation:
            f = rng.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.hue:
            f = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class TwoViewPhotometric:
    """The den_cls 'more_transform' (den_cls_dataset.py:29-35):
    ColorJitter p=0.8 -> GaussianBlur(3, 1) p=0.5 -> Sharpness(5) p=0.5."""

    def __init__(self):
        self.jitter = ColorJitter(0.5, 0.2, 0.2, 0.1)

    def __call__(self, img: Image.Image, rng: random.Random) -> Image.Image:
        if rng.random() < 0.8:
            img = self.jitter(img, rng)
        if rng.random() < 0.5:
            img = gaussian_blur3(img, 1.0)
        if rng.random() < 0.5:
            img = adjust_sharpness(img, 5.0)
        return img


def pil_pad(img: Image.Image, padding: Tuple[int, int, int, int]) -> Image.Image:
    """(left, top, right, bottom) zero padding."""
    left, top, right, bottom = padding
    if not any(padding):
        return img
    w, h = img.size
    out = Image.new(img.mode, (w + left + right, h + top + bottom), 0)
    out.paste(img, (left, top))
    return out


def np_pad_hw(arr: np.ndarray, padding: Tuple[int, int, int, int]) -> np.ndarray:
    """Zero-pad an (H, W) or (H, W, C) array with (left, top, right, bottom)."""
    left, top, right, bottom = padding
    pads = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads, mode="constant")
