"""The ``den_cls`` training augmentation, batched on the card: counterpart
of dgvcc_tpu/data/device_pipeline.py.

With ``device_aug`` the host only decodes, loads the density map and cuts
one uint8 pre-crop (``data/datasets.py::RawCropDataset``); this module
does the rest on the tensors' device, for a whole batch at once: the
final crop of image and map in lockstep, the horizontal flip, greyscale
(p 0.12, shared by both views), the second view's photometric stack
(color jitter p 0.8, 3x3 Gaussian blur p 0.5, sharpness p 0.5), the
normalisation ``(x - 0.5) / 0.5`` and the 16x16 block-sum foreground map.

The operations are the JAX package's, not torchvision's: contrast blends
with the mean of the PIL-'L' grey image, hue is a rotation in YIQ space,
the blur pads by reflection. Their probabilities and factor laws are
``data/transforms.py``'s; the pixels are not, since the random streams
differ.

The draws are split from their application: ``draw_augmentation`` takes
every per-sample random value from one ``torch.Generator`` (on the
tensors' device), ``apply_augmentation`` applies given draws. Tests
inject draws into the second, because random streams cannot match across
frameworks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

GREY_W = (0.299, 0.587, 0.114)  # PIL 'L' weights
# RGB -> YIQ and back (the JAX package's hue rotation)
T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
T_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))

P_GREY, P_FLIP, P_JITTER, P_BLUR, P_SHARPEN = 0.12, 0.5, 0.8, 0.5, 0.5
# color jitter factor ranges: brightness, contrast, saturation, hue
JITTER_RANGES = {"fb": (0.5, 1.5), "fc": (0.8, 1.2), "fs": (0.8, 1.2), "fh": (-0.1, 0.1)}
GATES = {"flip": P_FLIP, "grey": P_GREY, "jitter": P_JITTER, "blur": P_BLUR,
         "sharpen": P_SHARPEN}


def _factor(f, x: torch.Tensor):
    """A scalar, or one factor per sample of a batch (B,) broadcast over
    (B, H, W, C)."""
    if isinstance(f, torch.Tensor) and f.ndim == 1:
        return f.to(x.dtype).view(-1, *([1] * (x.ndim - 1)))
    return f


def grey(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): the PIL 'L' weighted sum."""
    return x[..., 0] * GREY_W[0] + x[..., 1] * GREY_W[1] + x[..., 2] * GREY_W[2]


def rgb_to_grey3(x: torch.Tensor) -> torch.Tensor:
    return grey(x)[..., None].expand(x.shape)


def adjust_brightness(x: torch.Tensor, f) -> torch.Tensor:
    return x * _factor(f, x)


def adjust_contrast(x: torch.Tensor, f) -> torch.Tensor:
    """Blend with the mean of the grey image (per image)."""
    mean = grey(x).mean(dim=(-2, -1), keepdim=True)[..., None]
    return mean + (x - mean) * _factor(f, x)


def adjust_saturation(x: torch.Tensor, f) -> torch.Tensor:
    g = rgb_to_grey3(x)
    return g + (x - g) * _factor(f, x)


def hue_matrix(f: torch.Tensor) -> torch.Tensor:
    """The colour matrix of a hue rotation by f turns, (..., 3, 3):
    T_RGB @ rot(f) @ T_YIQ, in float32."""
    theta = f.float() * (2.0 * math.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, c, -s], -1),
                       torch.stack([zero, s, c], -1)], -2)
    t_yiq = torch.tensor(T_YIQ, dtype=torch.float32, device=f.device)
    t_rgb = torch.tensor(T_RGB, dtype=torch.float32, device=f.device)
    return (t_rgb @ rot) @ t_yiq


def adjust_hue(x: torch.Tensor, f) -> torch.Tensor:
    """Approximate hue rotation in YIQ space, clipped to [0, 1]. ``f`` is a
    scalar for one image (H, W, 3) or (B,) for a batch (B, H, W, 3)."""
    m = hue_matrix(torch.as_tensor(f, dtype=torch.float32, device=x.device))
    out = x.flatten(-3, -2) @ m.transpose(-1, -2).to(x.dtype)
    return out.reshape(x.shape).clamp(0.0, 1.0)


def _blur_taps(sigma: float):
    """The 3 taps in float32, computed on the host as the JAX package
    computes them."""
    k = torch.exp(-0.5 * (torch.tensor([-1.0, 0.0, 1.0]) / sigma) ** 2)
    return (k / k.sum()).tolist()


def gaussian_blur3(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """3x3 separable Gaussian blur of (..., H, W, C), reflect padding."""
    k0, k1, k2 = _blur_taps(sigma)
    xp = torch.cat([x[..., 1:2, :, :], x, x[..., -2:-1, :, :]], dim=-3)
    x = k0 * xp[..., :-2, :, :] + k1 * xp[..., 1:-1, :, :] + k2 * xp[..., 2:, :, :]
    xp = torch.cat([x[..., :, 1:2, :], x, x[..., :, -2:-1, :]], dim=-2)
    return k0 * xp[..., :, :-2, :] + k1 * xp[..., :, 1:-1, :] + k2 * xp[..., :, 2:, :]


def adjust_sharpness(x: torch.Tensor, f: float = 5.0) -> torch.Tensor:
    """Blend with the image blurred at sigma 0.85, clipped to [0, 1]."""
    smooth = gaussian_blur3(x, sigma=0.85)
    return (smooth + (x - smooth) * f).clamp(0.0, 1.0)


def _gate(b: torch.Tensor) -> torch.Tensor:
    return b.view(-1, 1, 1, 1)


def photometric_view(img: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The second view's stack on (B, H, W, 3) in [0, 1]: jitter
    (brightness, contrast, saturation, hue, clip), blur, sharpness, each
    where its gate is drawn."""
    jit = adjust_hue(adjust_saturation(adjust_contrast(
        adjust_brightness(img, draws["fb"]), draws["fc"]), draws["fs"]), draws["fh"])
    img = torch.where(_gate(draws["jitter"]), jit.clamp(0.0, 1.0), img)
    img = torch.where(_gate(draws["blur"]), gaussian_blur3(img, 1.0), img)
    return torch.where(_gate(draws["sharpen"]), adjust_sharpness(img, 5.0), img)


def draw_augmentation(batch: int, height: int, width: int, crop: int,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every per-sample random value of one batch, on the generator's
    device: the crop's top-left corner (i, j), uniform over the positions
    that fit; the gates flip, grey, jitter, blur, sharpen; the jitter
    factors fb, fc, fs, fh, uniform over ``JITTER_RANGES``."""
    dev = generator.device
    i = torch.randint(0, max(height - crop, 0) + 1, (batch,), generator=generator, device=dev)
    j = torch.randint(0, max(width - crop, 0) + 1, (batch,), generator=generator, device=dev)
    u = torch.rand((len(GATES) + len(JITTER_RANGES), batch), generator=generator, device=dev)
    draws = {"i": i, "j": j}
    for row, (name, p) in enumerate(GATES.items()):
        draws[name] = u[row] < p
    for row, (name, (lo, hi)) in enumerate(JITTER_RANGES.items(), len(GATES)):
        draws[name] = lo + (hi - lo) * u[row]
    return draws


def apply_augmentation(frames_u8: torch.Tensor, dmaps: torch.Tensor,
                       draws: Dict[str, torch.Tensor], crop: int,
                       block: int = 16) -> Dict[str, torch.Tensor]:
    """frames_u8 (B, H, W, 3) uint8 and dmaps (B, H, W, 1) float32, H and W
    at least ``crop``, on one device -> img1, img2 (B, 3, crop, crop),
    dmap (B, 1, crop, crop) and bmap (B, 1, crop/block, crop/block): NCHW
    views of NHWC memory (channels last), float32."""
    b, h, w, _ = frames_u8.shape
    if min(h, w) < crop or crop % block:
        raise ValueError(f"frames of {h}x{w} cannot give {crop}x{crop} crops in "
                         f"{block}x{block} blocks")
    dev = frames_u8.device
    ar = torch.arange(crop, device=dev)
    rows = (draws["i"][:, None] + ar)[:, :, None]
    j = draws["j"][:, None]
    cols = torch.where(draws["flip"][:, None], j + (crop - 1 - ar), j + ar)[:, None, :]
    batch = torch.arange(b, device=dev)[:, None, None]
    img = frames_u8[batch, rows, cols].float() / 255.0
    dmap = dmaps[batch, rows, cols]
    img = torch.where(_gate(draws["grey"]), rgb_to_grey3(img), img)
    img2 = photometric_view(img, draws)
    bh = crop // block
    blocks = dmap[..., 0].reshape(b, bh, block, bh, block).sum(dim=(2, 4))
    bmap = (blocks > 0).float()[..., None]
    nchw = {"img1": (img - 0.5) / 0.5, "img2": (img2 - 0.5) / 0.5, "dmap": dmap,
            "bmap": bmap}
    return {k: v.permute(0, 3, 1, 2) for k, v in nchw.items()}


def augment_two_view_batch(frames_u8: torch.Tensor, dmaps: torch.Tensor,
                           generator: torch.Generator, crop: int, block: int = 16,
                           shard: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """The batched ``den_cls`` train transform on the frames' device, with
    draws from ``generator`` (which must live on that device). ``shard=(i,
    n)``: the frames are share i of n of a batch (a data-parallel rank's
    rows); the draws are those of the whole batch, from the same generator
    on every rank, and each share applies its own rows' draws, so its rows
    are the ones one process would make."""
    if generator.device.type != frames_u8.device.type:
        raise ValueError(f"the generator is on {generator.device}, the frames on "
                         f"{frames_u8.device}")
    b, h, w, _ = frames_u8.shape
    i, n = shard or (0, 1)
    draws = draw_augmentation(b * n, h, w, crop, generator)
    rows = slice(i * b, (i + 1) * b)
    return apply_augmentation(frames_u8, dmaps, {k: v[rows] for k, v in draws.items()},
                              crop, block)
