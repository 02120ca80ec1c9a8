"""Command line of the port.

    python -m dgvcc_tpu_torch --config configs/X.yml --task serve \
        --frames DIR [--ckpt x.pth] [--batch N] [--device cpu]

Reads the JAX package's YAML configs (core/config.py). ``--task serve``
streams per-frame counts over a directory of images and prints one
``name count`` line per frame and a throughput summary. The device is
``cuda`` unless ``--device`` or the config's ``device:`` key starts with
``cpu``. The other tasks of ``python -m dgvcc_tpu`` are not ported yet
(ROADMAP.md, Queue 1; train / test / vis / train_test are item 3).
"""

from __future__ import annotations

import argparse
import os
import time

TASKS = ("train", "test", "vis", "train_test", "generate", "serve", "export",
         "quantize", "aot")


def _list_images(frames_dir: str):
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    names = sorted(fn for fn in os.listdir(frames_dir)
                   if fn.lower().endswith(exts))
    if not names:
        raise SystemExit(f"no images under {frames_dir}")
    return names


def _device(cfg, override: str = None) -> str:
    dev = str(override or cfg.device)
    if dev.startswith("cpu"):
        return "cpu"
    return dev if dev.startswith("cuda") else "cuda"


def _build_counter(cfg, device: str):
    """The config's checkpoint (a reference or port ``.pth``), or seeded
    random weights when it names none, in its ``compute_dtype``."""
    import torch

    from dgvcc_tpu_torch.serve import VideoCounter

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return VideoCounter.from_checkpoint(
        cfg.model["name"], cfg.checkpoint, log_para=cfg.log_para,
        dtype=dtype, device=device, seed=cfg.seed,
        **cfg.model.get("params", {}))


def _serve(cfg, frames_dir: str, batch: int, device: str):
    """Stream per-frame crowd counts over a directory of images: decode on
    the host, batch consecutive same-shape frames, pipeline them through
    VideoCounter.stream."""
    import numpy as np
    import torch
    from PIL import Image

    names = _list_images(frames_dir)
    counter = _build_counter(cfg, device)
    # a stream has few shapes (one per bucket): let cuDNN time its choices
    torch.backends.cudnn.benchmark = True

    def batches():
        buf, buf_names = [], []
        for n in names:
            img = np.asarray(Image.open(os.path.join(frames_dir, n))
                             .convert("RGB"), np.uint8)
            if buf and (img.shape != buf[-1].shape or len(buf) >= batch):
                yield buf_names, np.stack(buf)
                buf, buf_names = [], []
            buf.append(img)
            buf_names.append(n)
        if buf:
            yield buf_names, np.stack(buf)

    name_stream = []

    def frame_stream():
        for bn, frames in batches():
            name_stream.append(bn)
            yield frames

    t0 = time.perf_counter()
    total = 0
    for counts in counter.stream(frame_stream()):
        bn = name_stream.pop(0)
        for n, c in zip(bn, counts):
            print(f"{n} {float(c):.2f}")
        total += len(bn)
    dt = time.perf_counter() - t0
    print(f"[serve] {total} frames in {dt:.2f}s = {total / dt:.2f} fps "
          f"on {counter.device}")


def run(config_path: str, task: str, frames: str = None, batch: int = 4,
        ckpt: str = None, device: str = None):
    from dgvcc_tpu_torch.core.config import load_config

    if task in ("train", "test", "vis", "train_test"):
        raise SystemExit(f"--task {task} is not ported to dgvcc_tpu_torch "
                         "yet: it needs the data pipeline and DGTrainer, "
                         "ROADMAP.md Queue 1 item 3 (the train step itself is "
                         "dgvcc_tpu_torch.train; use python -m dgvcc_tpu for "
                         "the task)")
    if task != "serve":
        raise SystemExit(f"--task {task} is not ported to dgvcc_tpu_torch "
                         "yet; see ROADMAP.md, Queue 1 (use python -m "
                         "dgvcc_tpu for it)")
    cfg = load_config(config_path)
    if ckpt is not None:
        cfg.checkpoint = ckpt
    if isinstance(cfg.checkpoint, (list, tuple)):
        raise SystemExit("--task serve takes a single checkpoint path")
    if frames is None:
        raise SystemExit("--task serve requires --frames DIR")
    _serve(cfg, frames, batch, _device(cfg, device))


def build_parser():
    parser = argparse.ArgumentParser(
        description="dgvcc_tpu_torch: the PyTorch / CUDA port of dgvcc_tpu")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--task", type=str, default="serve", choices=TASKS)
    parser.add_argument("--frames", type=str, default=None,
                        help="image directory for --task serve")
    parser.add_argument("--batch", type=int, default=4,
                        help="serving batch size")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="override the config's checkpoint: key (.pth)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda[:N] or cpu; overrides the config's device:")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.config, args.task, frames=args.frames, batch=args.batch,
        ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
