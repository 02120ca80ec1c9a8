#!/usr/bin/env python3
"""Where the device time of the port's serving forward goes.

Runs dgvcc_tpu_torch's VideoCounter (DGModel ``final``, full width,
seeded random weights, bf16, fused_mem=True) on 768x1024 uint8 frames
under ``torch.profiler`` and prints, per batch, the device time by kernel
group (convolution, batch norm, memory-attention kernel, upsample,
elementwise / copy, other), the top kernels by name, and the device's
idle share of the wall time. With ``--quantize`` it profiles the int8
graph instead (``quantize=True``, calibrated on 8 seeded frames) and
groups its device time by part: the int8 convolution (``qconv_int8``),
the activation quantize passes, the padding of enc1/conv0's 3 channels to
16, the channel concatenations, the upsamples, the pools, kernel #1, and
the rest (the fp heads, the input cast, the count). The quantize and the
padding are marked with ``torch.profiler.record_function`` around the int8
graph's functions for the run; the rest go by kernel name. Needs one NVIDIA GPU:

    python3 scripts/profile_torch_serve.py [--batch 4] [--iters 3] [--quantize]

The chrome trace goes to build/profile_torch_serve_b{B}[_int8].json.
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


# --quantize: the int8 graph's parts. The kernels the port launches through
# ctypes (qconv_int8, #1) and the ones named for their op go by kernel name;
# the aten passes of the activation quantize and of the Cin padding by the
# profiler range around the function that launched them (their kernels'
# names, a cast, a division, ..., say nothing of where they ran)
INT8_BY_NAME = (("qconv", ("qconv_",)), ("kernel #1", ("mem_attention",)),
                ("upsample", ("upsample",)), ("pool", ("max_pool",)), ("cat", ("CatArray",)))
INT8_PARTS = (("quantize", "quantize_activation"), ("pad Cin", "pad_cin"))


def label_int8_graph():
    """Wrap the int8 graph's quantize and padding functions in
    ``record_function("int8:<part>")`` ranges."""
    from torch.profiler import record_function

    from dgvcc_tpu_torch.nn import quant as pq

    def labelled(label, fn):
        def run(*a, **k):
            with record_function(f"int8:{label}"):
                return fn(*a, **k)
        return run

    for label, name in INT8_PARTS:
        setattr(pq, name, labelled(label, getattr(pq, name)))


def device_total_ms(e):
    return (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--quantize", action="store_true",
                    help="profile the int8 graph, grouped by the part that launched each kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from dgvcc_tpu_torch.serve import VideoCounter

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cudnn.benchmark = True
    quant = {}
    if args.quantize:
        calib = np.random.default_rng(140).integers(0, 256, (8, 768, 1024, 3), dtype=np.uint8)
        quant = dict(quantize=True, calib_frames=calib)
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                           fused_mem=True, seed=0, **quant)
    if args.quantize:
        label_int8_graph()
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
    averages = prof.key_averages()
    # device kernels (not the device-side copies of the int8 ranges)
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("int8:")]
    per_name = {e.key: (e.count / args.iters,
                        getattr(e, "self_device_time_total", 0) / 1e3 / args.iters)
                for e in kernels}
    busy = sum(ms for _, ms in per_name.values())
    groups = collections.Counter()
    if args.quantize:
        for name, (_, ms) in per_name.items():
            for label, keys in INT8_BY_NAME:
                if any(k in name for k in keys):
                    groups[label] += ms
                    break
        # a range's device time: the aten kernels launched inside it
        for e in averages:
            if e.key.startswith("int8:") and e.device_type == torch.autograd.DeviceType.CPU:
                groups[e.key[5:]] += device_total_ms(e) / args.iters
        groups["other (fp heads, input cast, count)"] = busy - sum(groups.values())
    else:
        for name, (_, ms) in per_name.items():
            groups[group_of(name)] += ms
    print(f"[profile] {gpu}; batch {args.batch} 768x1024 "
          f"{'int8 (quantize=True)' if args.quantize else 'bf16'} fused_mem=True; "
          f"wall {wall_ms:.3f} ms/batch, device busy {busy:.3f} ms/batch, "
          f"idle {max(0.0, wall_ms - busy):.3f} ms/batch, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in groups.most_common():
        print(f"[profile]   {group:<26} {ms:9.3f} ms/batch  {100 * ms / busy:5.1f}%")
    print("[profile] top kernels (launches/batch, ms/batch):")
    for name, (n, ms) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile]   {ms:8.3f} ms {n:5.1f}x  {name[:110]}")
    out = os.path.join(REPO, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out, f"profile_torch_serve_b{args.batch}{'_int8' if args.quantize else ''}.json"))


if __name__ == "__main__":
    main()
