#!/usr/bin/env python3
"""Where the device time of the port's serving forward goes.

Runs dgvcc_tpu_torch's VideoCounter (DGModel ``final``, full width,
seeded random weights, bf16, fused_mem=True) on 768x1024 uint8 frames
under ``torch.profiler`` and prints, per batch, the device time by kernel
group (convolution, batch norm, memory-attention kernel, upsample,
elementwise / copy, other), the top kernels by name, and the device's
idle share of the wall time. Needs one NVIDIA GPU:

    python3 scripts/profile_torch_serve.py [--batch 4] [--iters 3]

The chrome trace goes to build/profile_torch_serve_b{B}.json.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (("memory-attention kernel", ("mem_attention",)),
          ("batch norm", ("batch_norm", "bn_fw")),
          ("upsample", ("upsample",)),
          ("convolution", ("conv", "xmma", "gemm", "cutlass", "implicit",
                           "winograd", "fft", "sm90", "cudnn")),
          ("elementwise / copy / cat", ("elementwise", "copy", "Cat", "fill",
                                        "reduce", "Memcpy", "Memset")))


def group_of(name):
    for group, keys in GROUPS:
        if any(k.lower() in name.lower() for k in keys):
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from dgvcc_tpu_torch.serve import VideoCounter

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cudnn.benchmark = True
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                           fused_mem=True, seed=0)
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, 768, 1024, 3), dtype=np.uint8)
    for _ in range(3):
        counter.count_frames(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            counter.count_frames(frames)
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name = {e.key: (e.count / args.iters,
                        getattr(e, "self_device_time_total", 0) / 1e3 / args.iters)
                for e in kernels}
    busy = sum(ms for _, ms in per_name.values())
    groups = collections.Counter()
    for name, (_, ms) in per_name.items():
        groups[group_of(name)] += ms
    print(f"[profile] {gpu}; batch {args.batch} 768x1024 bf16 fused_mem=True; "
          f"wall {wall_ms:.3f} ms/batch, device busy {busy:.3f} ms/batch, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in groups.most_common():
        print(f"[profile]   {group:<26} {ms:9.3f} ms/batch  {100 * ms / busy:5.1f}%")
    print("[profile] top kernels (launches/batch, ms/batch):")
    for name, (n, ms) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile]   {ms:8.3f} ms {n:5.1f}x  {name[:110]}")
    out = os.path.join(REPO, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"profile_torch_serve_b{args.batch}.json"))


if __name__ == "__main__":
    main()
