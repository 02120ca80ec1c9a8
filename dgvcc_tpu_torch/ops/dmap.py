"""Gaussian density maps, counterpart of dgvcc_tpu/ops/dmap.py.

A head point at (x, y) spreads a truncated, scipy-normalised Gaussian
(sigma 4, truncate 7/sigma, radius 7) over the map; mass that falls off
the image is lost, and a point outside the image is dropped whole
(reference utils/dmap_gen.py:53-81). Separable per point:

    density[h, w] = sum_i k(h - y_i) * k(w - x_i)  =  (A . B^T)[h, w]

with ``A[h, i] = k(h - y_i)`` (H x N) and ``B[w, i] = k(w - x_i)`` (W x N).

  * ``gaussian_density_fixed_np`` / ``gaussian_density_adaptive_np``: the
    numpy goldens (own copies of the JAX package's), used by the ``numpy``
    backend of ``data/dmap_cli.py`` and by the tests;
  * ``gaussian_density_reference``: the plain PyTorch version, the A . B^T
    form of the JAX package's ``gaussian_density_jax``;
  * ``gaussian_density``: launches the hand-written CUDA kernel
    (``csrc/dmap.cu``) on a CUDA tensor. On a CPU tensor, the caller's
    explicit choice, it computes ``gaussian_density_reference``. A CUDA
    tensor never takes the plain version: the kernel launches or the call
    raises.

Parity details, shared by all of them: coordinates truncate toward zero
(``int()``, so -0.4 lands on row or column 0), a point whose truncated
coordinates fall outside the image is dropped whole, a ``mask=False`` row
contributes nothing, and the normaliser is the sum of the truncated,
unnormalised kernel.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgvcc_tpu_torch.ops import _build

LAUNCHES = 0
MAX_RADIUS = 63  # csrc/dmap.cu holds at most 2 * 63 + 1 taps
_lib = None


# ---------------------------------------------------------------------------
# 1-D truncated kernels (scipy-compatible) and the numpy goldens
# ---------------------------------------------------------------------------

def _kernel_1d_np(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage _gaussian_kernel1d: exp(-0.5 (x/sigma)^2), normalized."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def scipy_radius(sigma: float, truncate: float) -> int:
    """scipy.ndimage.gaussian_filter radius: int(truncate * sigma + 0.5)."""
    return int(truncate * float(sigma) + 0.5)


def _splat_np(shape, points_int, sigmas, truncates) -> np.ndarray:
    h, w = shape
    density = np.zeros((h, w), dtype=np.float64)
    for (px, py), sigma, truncate in zip(points_int, sigmas, truncates):
        if not (0 <= py < h and 0 <= px < w):
            continue  # the reference skips out-of-bounds points (dmap_gen.py:74-76)
        r = scipy_radius(sigma, truncate)
        k = _kernel_1d_np(sigma, r)
        y0, y1 = py - r, py + r + 1
        x0, x1 = px - r, px + r + 1
        ky = k[max(0, -y0) : 2 * r + 1 - max(0, y1 - h)]
        kx = k[max(0, -x0) : 2 * r + 1 - max(0, x1 - w)]
        density[max(0, y0) : min(h, y1), max(0, x0) : min(w, x1)] += np.outer(ky, kx)
    return density.astype(np.float32)


def gaussian_density_fixed_np(shape, points: np.ndarray, sigma: float = 4.0) -> np.ndarray:
    """Fixed-sigma density map (reference dmap_gen.gaussian_filter_density_fixed).

    ``points`` are (N, 2) in (x, y) = (col, row) order, int-cast like the
    reference (dmap_gen.py:74-75); truncate = 7 / sigma (dmap_gen.py:79).
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(points) == 0:
        return np.zeros(shape, dtype=np.float32)
    n = len(points)
    return _splat_np(shape, points.astype(np.int64), [sigma] * n, [7.0 / sigma] * n)


def gaussian_density_adaptive_np(shape, points: np.ndarray) -> np.ndarray:
    """Adaptive-sigma (kNN) density (reference dmap_gen.gaussian_filter_density):
    sigma_i = 0.1 * (d1 + d2 + d3) of the 3 nearest neighbours when there
    are more than 3 points, else 15; scipy's default truncate=4."""
    from scipy.spatial import KDTree

    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(points) == 0:
        return np.zeros(shape, dtype=np.float32)
    if len(points) > 3:
        tree = KDTree(points.copy(), leafsize=2048)
        distances, _ = tree.query(points, k=4)
        sigmas = (distances[:, 1] + distances[:, 2] + distances[:, 3]) * 0.1
    else:
        sigmas = np.full(len(points), 15.0)
    return _splat_np(shape, points.astype(np.int64), sigmas, [4.0] * len(points))


def _taps(sigma: float, truncate: float):
    """The 2r+1 float32 taps (normalised in float64, as the golden does)."""
    r = scipy_radius(sigma, truncate)
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"gaussian_density: radius {r} (sigma {sigma}, truncate "
                         f"{truncate}) outside 0..{MAX_RADIUS}")
    return r, _kernel_1d_np(float(sigma), r).astype(np.float32)


def _check(points, mask, height, width):
    if points.dim() != 2 or points.shape[1] != 2:
        raise ValueError(f"gaussian_density: points must be (N, 2), got {tuple(points.shape)}")
    if mask.shape != points.shape[:1]:
        raise ValueError(f"gaussian_density: mask {tuple(mask.shape)} does not match "
                         f"{points.shape[0]} points")
    if height <= 0 or width <= 0:
        raise ValueError(f"gaussian_density: empty map {height}x{width}")


# ---------------------------------------------------------------------------
# plain PyTorch version and the kernel's wrapper
# ---------------------------------------------------------------------------

def gaussian_density_reference(points: torch.Tensor, mask: torch.Tensor, height: int,
                               width: int, sigma: float = 4.0,
                               truncate: float = 7.0 / 4.0) -> torch.Tensor:
    """Plain version: A (H x N) and B (W x N) built densely, one float32
    product A . B^T. points (N, 2) (x, y), mask (N,) -> (height, width)
    float32 on the points' device."""
    _check(points, mask, height, width)
    r, taps = _taps(sigma, truncate)
    dev = points.device
    k1d = torch.from_numpy(taps).to(dev)
    pts = torch.trunc(points.float()).to(torch.int32)
    px, py = pts[:, 0], pts[:, 1]
    valid = mask.bool() & (py >= 0) & (py < height) & (px >= 0) & (px < width)

    def axis_kernel(size, centers):
        # (size, N): k1d[coord - center + r] where |coord - center| <= r, else 0
        d = torch.arange(size, dtype=torch.int32, device=dev)[:, None] - centers[None, :]
        idx = torch.clamp(d + r, 0, 2 * r).long()
        return torch.where(d.abs() <= r, k1d[idx], torch.zeros((), device=dev))

    a = axis_kernel(height, py) * valid[None, :].float()
    return torch.matmul(a, axis_kernel(width, px).t())


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("dmap")
        ptr = ctypes.c_void_p
        lib.gaussian_density_fwd.argtypes = [
            ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ptr]
        lib.gaussian_density_fwd.restype = ctypes.c_int
        lib.gaussian_density_error_string.argtypes = [ctypes.c_int]
        lib.gaussian_density_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gaussian_density(points: torch.Tensor, mask: torch.Tensor, height: int, width: int,
                     sigma: float = 4.0, truncate: float = 7.0 / 4.0) -> torch.Tensor:
    """Density map of ``points`` (N, 2) float32 (x, y) where ``mask`` (N,)
    is true -> (height, width) float32, on the points' device. One kernel
    launch on a CUDA tensor, whatever N (also 0)."""
    global LAUNCHES
    _check(points, mask, height, width)
    if points.device.type == "cpu" and mask.device.type == "cpu":
        return gaussian_density_reference(points, mask, height, width, sigma, truncate)
    if points.device.type != "cuda" or mask.device != points.device:
        raise ValueError(f"gaussian_density: points on {points.device}, mask on "
                         f"{mask.device}; both must be on one CUDA device or both "
                         "on the CPU")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"gaussian_density takes float32 points and a bool mask; got "
                        f"{points.dtype} and {mask.dtype}")
    r, taps = _taps(sigma, truncate)
    # the kernel reads (x, y) as one 8-byte vector
    points = points.contiguous()
    if points.data_ptr() % 8:
        points = points.clone()
    mask = mask.contiguous()
    out = torch.empty((height, width), dtype=torch.float32, device=points.device)
    lib = _kernel()
    c_taps = (ctypes.c_float * len(taps))(*taps.tolist())
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gaussian_density_fwd(points.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                       points.shape[0], height, width, c_taps, r, stream)
    if err:
        raise RuntimeError("gaussian_density kernel launch failed: "
                           + lib.gaussian_density_error_string(err).decode())
    LAUNCHES += 1
    return out
