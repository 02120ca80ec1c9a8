"""Density-map generation, counterpart of dgvcc_tpu/data/dmap_cli.py.

    python -m dgvcc_tpu_torch.data.dmap_cli --path ROOT [--phases train val test]
        [--sigma 4] [--backend cuda|cpu|numpy] [--device cuda:N] [--overwrite]

For every image of the canonical layout (``ROOT/{phase}/NAME.{jpg,png}``
with its points ``NAME.npy``; file names holding ``aug`` are skipped, as
in the JAX package) it writes ``NAME_dmap.npy``, float32 (H, W): a
fixed-sigma Gaussian per head point (reference utils/dmap_gen.py, sigma 4,
truncate 7/sigma).

Backends:
  * ``cuda`` (default): the points go to the card and kernel #4
    (``ops/dmap.py::gaussian_density``, ``csrc/dmap.cu``) makes each map
    in one launch; the map comes back and is saved;
  * ``cpu``: the plain PyTorch version on the CPU;
  * ``numpy``: the numpy golden in a process pool (``--workers``).
The JAX package's ``native`` backend (its g++ library) is not ported.

The last line printed names the images done, the kernel's launch count
and the device.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import time
from glob import glob

import numpy as np


def _out_path(img_fn: str) -> str:
    stem, _ = os.path.splitext(img_fn)
    return stem + "_dmap.npy"


def _image_size(img_fn: str):
    from PIL import Image

    with Image.open(img_fn) as im:
        w, h = im.size
    return h, w


def _points(img_fn: str) -> np.ndarray:
    stem, _ = os.path.splitext(img_fn)
    return np.load(stem + ".npy").astype(np.float32).reshape(-1, 2)


def list_images(root: str, phases) -> list:
    """Every phase's .jpg / .png images, ``aug`` images skipped."""
    img_fns = []
    for phase in phases:
        img_fns += glob(os.path.join(root, phase, "*.jpg"))
        img_fns += glob(os.path.join(root, phase, "*.png"))
    return [fn for fn in img_fns if "aug" not in os.path.basename(fn)]


def _process_numpy(img_fn: str, sigma: float, overwrite: bool) -> bool:
    from dgvcc_tpu_torch.ops.dmap import gaussian_density_fixed_np

    out = _out_path(img_fn)
    if os.path.exists(out) and not overwrite:
        return False
    np.save(out, gaussian_density_fixed_np(_image_size(img_fn), _points(img_fn), sigma=sigma))
    return True


def generate(img_fns, sigma: float = 4.0, backend: str = "cuda", device: str = "cuda",
             overwrite: bool = False, workers: int = 8) -> int:
    """Write the maps of ``img_fns``; returns the number written."""
    if backend == "native":
        raise NotImplementedError(
            "--backend native (the JAX package's g++ library) is not ported to "
            "dgvcc_tpu_torch; use --backend cuda, cpu or numpy (ROADMAP.md, "
            "Queue 1 item 3)")
    if backend == "numpy":
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            return sum(pool.starmap(_process_numpy,
                                    [(fn, sigma, overwrite) for fn in img_fns]))
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"unknown backend {backend!r}")
    import torch

    from dgvcc_tpu_torch.ops.dmap import gaussian_density
    from dgvcc_tpu_torch.serve import resolve_device

    dev = resolve_device(device if backend == "cuda" else "cpu")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(f"--backend cuda needs a CUDA --device, got {device!r}")
    done = 0
    for img_fn in img_fns:
        out = _out_path(img_fn)
        if os.path.exists(out) and not overwrite:
            continue
        h, w = _image_size(img_fn)
        pts = torch.from_numpy(_points(img_fn))
        mask = torch.ones(len(pts), dtype=torch.bool)
        # radius 7 whatever sigma, as the reference and the golden (truncate 7 / sigma)
        dmap = gaussian_density(pts.to(dev), mask.to(dev), h, w, sigma=float(sigma),
                                truncate=7.0 / float(sigma))
        np.save(out, dmap.cpu().numpy())
        done += 1
    return done


def build_parser():
    parser = argparse.ArgumentParser(description="generate *_dmap.npy density maps")
    parser.add_argument("--path", required=True, help="canonical dataset root")
    parser.add_argument("--phases", nargs="+", default=["train", "val", "test"])
    parser.add_argument("--sigma", type=float, default=4.0)
    parser.add_argument("--backend", choices=["cuda", "cpu", "numpy", "native"],
                        default="cuda")
    parser.add_argument("--device", default="cuda",
                        help="cuda[:N] for --backend cuda")
    parser.add_argument("--workers", type=int, default=8, help="--backend numpy processes")
    parser.add_argument("--overwrite", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.path):
        raise SystemExit(f"Path does not exist: {args.path}")
    img_fns = list_images(args.path, args.phases)
    print(f"{len(img_fns)} images", flush=True)
    from dgvcc_tpu_torch.ops import dmap

    t0 = time.perf_counter()
    done = generate(img_fns, args.sigma, args.backend, args.device, args.overwrite,
                    args.workers)
    device = {"cuda": args.device, "cpu": "cpu", "numpy": "cpu (numpy)"}[args.backend]
    print(f"[dmap_cli] {done} of {len(img_fns)} images done in "
          f"{time.perf_counter() - t0:.3f}s; gaussian_density kernel launched "
          f"{dmap.LAUNCHES}x; backend {args.backend} on {device}", flush=True)


if __name__ == "__main__":
    main()
