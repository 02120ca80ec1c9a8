#!/usr/bin/env python3
"""Where the device time of the port's train step goes.

Builds DGModel ``final`` as configs/sta_final.yml says (bf16 compute,
float32 AdamW master weights, the OneCycle lr of epoch 0; seeded random
weights), takes the synthetic two-view batch of chip_smoke.py (16 crops of
320x320), and profiles train steps under ``torch.profiler``: device time
by kernel group (convolution, batch norm, memory-attention kernels, the
einsum path's f32 GEMMs, optimizer, upsample, elementwise / copy, other),
each memory-attention kernel by name (the training kernels'
forward, backward rows, columns and reduction apart), the top kernels by
name, and the device's idle share of the wall time. Needs one NVIDIA GPU:

    python3 scripts/profile_torch_train.py [--iters 3] [--einsum]

``--einsum`` profiles the einsum path of the bank (fused_mem_train=False)
instead of the training kernels. The chrome trace goes to
build/profile_torch_train_{kernel,einsum}.json.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (("memory-attention kernels", ("mat_fwd", "mat_bwd", "sum_partials",
                                        "reduce_splits")),
          ("bank products, f32 GEMM (einsum path)", ("sgemm", "gemm_f32f32")),
          ("optimizer (AdamW)", ("multi_tensor", "adam", "foreach")),
          ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
          ("upsample", ("upsample",)),
          ("convolution", ("conv", "xmma", "gemm", "cutlass", "implicit", "dgrad",
                           "wgrad", "winograd", "fft", "sm90", "cudnn")),
          ("elementwise / copy / cat / reduce", ("elementwise", "copy", "Cat", "fill",
                                                 "reduce", "Memcpy", "Memset")))


def group_of(name):
    for group, keys in GROUPS:
        if any(k.lower() in name.lower() for k in keys):
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--einsum", action="store_true",
                    help="the bank's einsum path instead of the training kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from chip_smoke import TRAIN_B, TRAIN_CROP, synthetic_batch
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cudnn.benchmark = True
    cfg = load_config(os.path.join(REPO, "configs", "sta_final.yml"))
    model = MODELS.build(cfg.model["name"], dtype=torch.bfloat16,
                         fused_mem_train=not args.einsum,
                         **cfg.model.get("params", {}))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler)
    step = build_train_step(model, LOSSES.build(cfg.loss["name"]), cfg.mode, cfg.log_para)
    batch = synthetic_batch(1)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    for _ in range(3):
        step(state, batch, gen, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step(state, batch, gen, 0)
        torch.cuda.synchronize()
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
    label = "einsum" if args.einsum else "kernel"
    print(f"[profile] {gpu}; train step {label} path, DGModel final, B={TRAIN_B}x2 "
          f"views {TRAIN_CROP}x{TRAIN_CROP} bf16; wall {wall_ms:.3f} ms/step (under the "
          f"profiler), device busy {busy:.3f} ms/step, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in groups.most_common():
        print(f"[profile]   {group:<34} {ms:9.3f} ms/step  {100 * ms / busy:5.1f}%")
    print("[profile] memory-attention kernels by name (launches/step, ms/step, "
          "ms/launch):")
    for name, (n, ms) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        if group_of(name) == GROUPS[0][0]:
            print(f"[profile]   {ms:8.4f} ms {n:5.1f}x {ms / max(n, 1e-9):8.4f} ms/launch  "
                  f"{name[:100]}")
    print("[profile] top kernels (launches/step, ms/step):")
    for name, (n, ms) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile]   {ms:8.3f} ms {n:5.1f}x  {name[:110]}")
    out = os.path.join(REPO, "build")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"profile_torch_train_{label}.json"))


if __name__ == "__main__":
    main()
