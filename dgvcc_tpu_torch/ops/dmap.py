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
  * ``gaussian_density_binned_reference``: a CPU model of the kernel's
    binned splat (which points each output tile sees, in which order it
    sums them), used by the tests only;
  * ``gaussian_density``: launches the hand-written CUDA kernel
    (``csrc/dmap.cu``: the points binned by 32x32 output tile, then one
    block a tile sums the windows that meet it) on a CUDA tensor. On a CPU
    tensor, the caller's explicit choice, it computes
    ``gaussian_density_reference``. A CUDA tensor never takes the plain
    version: the kernel launches or the call raises.

Parity details, shared by all of them: coordinates truncate toward zero
(``int()``, so -0.4 lands on row or column 0), a point whose truncated
coordinates fall outside the image is dropped whole, a ``mask=False`` row
contributes nothing, and the normaliser is the sum of the truncated,
unnormalised kernel.

``LAUNCHES`` counts calls of the kernel, one per map (each runs three
device kernels), and nothing else, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgvcc_tpu_torch.ops import _build

LAUNCHES = 0
MAX_RADIUS = 63      # csrc/dmap.cu: kMaxRadius (a window reaches 2 tiles each way)
MAX_SIDE = 65535     # csrc/dmap.cu: kMaxSide (x and y packed in 16 bits each)
TILE = 32            # csrc/dmap.cu: kTile, the output tile of a splat block
CAPACITY = 768       # csrc/dmap.cu: kCapacity, the candidates a splat block holds
_lib = None
_device_taps_cache = {}


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


def gaussian_density_binned_reference(points: torch.Tensor, mask: torch.Tensor,
                                      height: int, width: int, sigma: float = 4.0,
                                      truncate: float = 7.0 / 4.0,
                                      capacity: int = CAPACITY, seed: int = 0,
                                      stats: dict | None = None) -> torch.Tensor:
    """CPU model of the kernel's binned splat (csrc/dmap.cu), for the tests:
    the same tile reach and sum order, float32 arithmetic without FMA.

    The valid points are binned by the TILE x TILE tile of their centre,
    each segment shuffled from ``seed`` as the kernel's atomic scatter
    leaves it. A tile's candidates are the segments within ceil(r / TILE)
    tiles; it keeps those whose window meets it, in rounds of ``capacity``
    point indices when there are more than ``capacity`` candidates, sorts
    them by index and adds each one's window in that order. ``stats``, if
    given, receives the most rounds a tile took (``rounds``), the farthest
    tile a kept point came from (``reach``) and the most points a round
    kept (``kept``)."""
    _check(points, mask, height, width)
    r, taps = _taps(sigma, truncate)
    pts = torch.trunc(points.detach().cpu().double()).numpy()
    n = len(pts)
    inside = (pts[:, 0] >= 0) & (pts[:, 0] < width) & (pts[:, 1] >= 0) & (pts[:, 1] < height)
    index = np.flatnonzero(mask.detach().cpu().numpy().astype(bool) & inside)
    px, py = pts[index, 0].astype(np.int64), pts[index, 1].astype(np.int64)
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    tile = (py // TILE) * tiles_x + px // TILE
    shuffled = np.random.default_rng(seed).permutation(len(index))
    order = shuffled[np.argsort(tile[shuffled], kind="stable")]
    counts = np.bincount(tile, minlength=tiles_x * tiles_y)
    ends = np.cumsum(counts)
    starts = ends - counts
    reach = -(-r // TILE)
    out = np.zeros((height, width), np.float32)
    info = dict(rounds=0, reach=0, kept=0)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            cand = np.concatenate([
                order[starts[sy * tiles_x + sx]:ends[sy * tiles_x + sx]]
                for sy in range(max(0, ty - reach), min(tiles_y, ty + reach + 1))
                for sx in range(max(0, tx - reach), min(tiles_x, tx + reach + 1))])
            if not len(cand):
                continue
            x0, y0 = tx * TILE, ty * TILE
            meets = ((px[cand] + r >= x0) & (px[cand] - r < x0 + TILE)
                     & (py[cand] + r >= y0) & (py[cand] - r < y0 + TILE))
            span = n if len(cand) <= capacity else capacity
            block = out[y0:y0 + TILE, x0:x0 + TILE]
            rounds = 0
            for lo in range(0, n, span):
                rounds += 1
                pick = cand[meets & (index[cand] >= lo) & (index[cand] < lo + span)]
                pick = pick[np.argsort(index[pick])]
                info["kept"] = max(info["kept"], len(pick))
                for j in pick:
                    info["reach"] = max(info["reach"], int(abs(px[j] // TILE - tx)),
                                        int(abs(py[j] // TILE - ty)))
                    rows = np.arange(y0, y0 + block.shape[0]) - py[j]
                    cols = np.arange(x0, x0 + block.shape[1]) - px[j]
                    ky = np.where(np.abs(rows) <= r, taps[np.clip(rows + r, 0, 2 * r)], 0)
                    kx = np.where(np.abs(cols) <= r, taps[np.clip(cols + r, 0, 2 * r)], 0)
                    block += np.outer(ky, kx).astype(np.float32)
            info["rounds"] = max(info["rounds"], rounds)
    if stats is not None:
        stats.update(info)
    return torch.from_numpy(out)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("dmap")
        ptr = ctypes.c_void_p
        lib.gaussian_density_fwd.argtypes = [
            ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ptr]
        lib.gaussian_density_fwd.restype = ctypes.c_int
        lib.gaussian_density_error_string.argtypes = [ctypes.c_int]
        lib.gaussian_density_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_taps(sigma: float, truncate: float, device: torch.device):
    """(radius, the float32 taps on ``device``), copied there once per
    (sigma, truncate, device)."""
    key = (float(sigma), float(truncate), device)
    hit = _device_taps_cache.get(key)
    if hit is None:
        r, taps = _taps(sigma, truncate)
        hit = _device_taps_cache[key] = (r, torch.from_numpy(taps).to(device))
    return hit


def workspace_ints(n: int, height: int, width: int) -> int:
    """int32s of scratch the kernel needs (csrc/dmap.cu, workspace_ints,
    which checks it): each tile's count and a block
    counter, padded to a multiple of 4; each tile's segment end, as many;
    the binned list (index, packed x y) of n points."""
    tiles = (-(-height // TILE)) * (-(-width // TILE))
    return 2 * ((tiles + 1 + 3) // 4 * 4) + 2 * n


def gaussian_density(points: torch.Tensor, mask: torch.Tensor, height: int, width: int,
                     sigma: float = 4.0, truncate: float = 7.0 / 4.0) -> torch.Tensor:
    """Density map of ``points`` (N, 2) float32 (x, y) where ``mask`` (N,)
    is true -> (height, width) float32, on the points' device. On a CUDA
    tensor one call of the kernel (three launches on the current stream,
    after a memset when N > 1024), counted once in ``LAUNCHES``."""
    global LAUNCHES
    _check(points, mask, height, width)
    dev = points.device
    if dev.type == "cpu" and mask.device.type == "cpu":
        return gaussian_density_reference(points, mask, height, width, sigma, truncate)
    if dev.type != "cuda" or mask.device != dev:
        raise ValueError(f"gaussian_density: points on {dev}, mask on {mask.device}; both "
                         "must be on one CUDA device or both on the CPU")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"gaussian_density takes float32 points and a bool mask; got "
                        f"{points.dtype} and {mask.dtype}")
    if height > MAX_SIDE or width > MAX_SIDE:
        raise ValueError(f"gaussian_density: {height}x{width} map; the kernel packs a "
                         f"point's x and y in 16 bits each (at most {MAX_SIDE})")
    r, taps = _device_taps(sigma, truncate, dev)
    # the kernel reads (x, y) as one 8-byte vector
    points = points.contiguous()
    if points.data_ptr() % 8:
        points = points.clone()
    mask = mask.contiguous()
    n = points.shape[0]
    out = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_ws = workspace_ints(n, height, width)
    work = torch.empty(n_ws, dtype=torch.int32, device=dev)
    lib = _kernel()
    args = (points.data_ptr(), mask.data_ptr(), taps.data_ptr(), r, out.data_ptr(),
            work.data_ptr(), n_ws, n, height, width)
    if dev.index == torch.cuda.current_device():
        err = lib.gaussian_density_fwd(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.gaussian_density_fwd(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("gaussian_density kernel launch failed: "
                           + lib.gaussian_density_error_string(err).decode())
    LAUNCHES += 1
    return out
