#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (dgvcc_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the port from the checkout's sources
   (nvcc, sm_90a, into build/torch_ext/);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (K=256, S=1024, P=192*256 per
   768x1024 frame, B=4), in bf16 and f32, plus one awkward size;
3. serve full-width DGModel ``final`` (VGG16-BN, 1024x256 bank, seeded
   random weights, bf16, fused_mem=True) through VideoCounter: 768x1024
   frames by count_frames (B=4) and stream (4 batches of 16), a
   1080x1920 batch through bucket padding and through 2x3 tiles of 768.
   Every path must launch the kernel and agree with the same counter on
   the einsum path (fused_mem=False). Then the command line,
   ``python -m dgvcc_tpu_torch --task serve`` with configs/sta_final.yml,
   counts four JPEG frames;
4. time the serving path (frames/s at B=1, 4, 16; stream) and the kernel
   alone against its plain version and one library call (SDPA).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repo, the script exits non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K, S = 256, 1024                    # bank width and prototypes of `final`
FRAME = (768, 1024)                 # serving frame; P = 192 * 256 = 49152
P = (FRAME[0] // 4) * (FRAME[1] // 4)
TOL_F32 = 1e-4                      # f32 kernel vs plain (summation order)
TOL_BF16 = 2e-2                     # bf16 output vs f32 plain (one bf16 rounding)
TOL_COUNTS = 2e-2                   # fused vs einsum serving counts, relative:
                                    # the einsum path rounds the attention to bf16


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(ma, b, p, dtype, tol, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(b, p, K, generator=g, device="cuda").to(dtype)
    mem = torch.randn(K, S, generator=g, device="cuda").to(dtype)
    out = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    ref = ma.memory_attention_reference(y.float(), mem.float())
    err = (out.float() - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol))
    log(f"kernel {str(dtype):>14} B={b} P={p} K={K} S={S}: max_abs_err="
        f"{max_abs:.3e} max_rel_err(|ref|>=1e-3)={max_rel:.3e} tol={tol} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_fused disagrees with its plain version "
             f"({dtype}, B={b}, P={p})")
    return max_abs


def check_counts(name, got, want, want_label="einsum path"):
    got, want = np.asarray(got), np.asarray(want)
    if not np.isfinite(got).all():
        fail(f"{name}: non-finite counts {got}")
    scale = max(1.0, float(np.abs(want).max()))
    diff = float(np.abs(got - want).max())
    log(f"{name}: counts {np.round(got[:4], 3).tolist()} ... {want_label} "
        f"{np.round(want[:4], 3).tolist()} ... max |diff| {diff:.4g} "
        f"(tol {TOL_COUNTS} x {scale:.4g})")
    if diff > TOL_COUNTS * scale:
        fail(f"{name}: counts disagree with the {want_label}")


def check_cli(frames, VideoCounter):
    """The serve task of the command line on JPEG frames (sta_final.yml:
    seed 2112, bf16, the kernel path by default), against a counter with
    the same seeded weights on the same decoded frames."""
    import tempfile

    from PIL import Image

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(tmp, f"frame{i}.jpg"), quality=95)
        decoded = np.stack([np.asarray(Image.open(os.path.join(tmp, f"frame{i}.jpg"))
                                       .convert("RGB")) for i in range(len(frames))])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "dgvcc_tpu_torch", "--config",
             os.path.join(root, "configs", "sta_final.yml"), "--task", "serve",
             "--frames", tmp, "--batch", str(len(frames))],
            capture_output=True, text=True, timeout=300, cwd=root)
    if out.returncode:
        fail(f"CLI serve exited {out.returncode}:\n{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    log(f"CLI serve ({time.perf_counter() - t0:.1f}s with start-up): {lines[-1]}")
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    if len(counts) != len(frames):
        fail(f"CLI serve printed {len(counts)} counts for {len(frames)} frames")
    want = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                        seed=2112).count_frames(decoded)
    check_counts("CLI serve sta_final.yml, 4 JPEG 768x1024", counts, want,
                 "VideoCounter")


def main():
    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dgvcc_tpu_torch.ops import _build
    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.serve import VideoCounter

    t_start = time.perf_counter()
    gpu = card()
    print(gpu, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 2. kernels vs plain versions -------------------------------------
    err_bf16 = check_kernel(ma, 4, P, torch.bfloat16, TOL_BF16, 1)
    err_f32 = check_kernel(ma, 4, P, torch.float32, TOL_F32, 2)
    check_kernel(ma, 3, 6400 + 37, torch.bfloat16, TOL_BF16, 3)
    check_kernel(ma, 3, 6400 + 37, torch.float32, TOL_F32, 4)

    # ---- 3. serve the main path -------------------------------------------
    torch.backends.cudnn.benchmark = True
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                           fused_mem=True, seed=0)
    plain = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                         fused_mem=False, seed=0)
    for (k1, v1), (k2, v2) in zip(counter.model.state_dict().items(),
                                  plain.model.state_dict().items()):
        if k1 != k2 or not torch.equal(v1, v2):
            fail(f"seeded weights differ between the two counters at {k1}")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    batches = [rng.integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(4)]
    big = rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)

    def tiled(c, on):
        c.tile_threshold = 1536 if on else 4096

    paths = [
        ("count_frames B=4 768x1024", lambda c: c.count_frames(frames)),
        ("stream 4x B=16 768x1024",
         lambda c: np.concatenate(list(c.stream(iter(batches), prefetch=2)))),
        ("count_frames B=2 1080x1920 padded", lambda c: c.count_frames(big)),
        ("count_frames B=2 1080x1920 tiled 2x3x768",
         lambda c: (tiled(c, True), c.count_frames(big), tiled(c, False))[1]),
    ]
    launches = 0
    for name, run in paths:
        ma.LAUNCHES = 0
        fused_counts = run(counter)
        n = ma.LAUNCHES
        launches += n
        log(f"{name}: memory_attention_fused launched {n}x")
        if n == 0:
            fail(f"{name}: the serving path never launched the kernel")
        check_counts(name, fused_counts, run(plain))
    check_cli(frames, VideoCounter)

    # ---- 4. times ---------------------------------------------------------
    log(f"card: {gpu}")
    for b in (1, 4, 16):
        f = np.ascontiguousarray(batches[0][:b])
        for c in (counter, plain):
            c.count_frames(f)
        for label, c in (("fused_mem=True", counter), ("fused_mem=False", plain)):
            iters = 8 if b < 16 else 4
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                c.count_frames(f)
            dt = time.perf_counter() - t0
            log(f"serve count_frames B={b} 768x1024 bf16 {label}: "
                f"{b * iters / dt:.2f} frames/s ({1e3 * dt / (b * iters):.3f} "
                f"ms/frame) [{gpu}]")
    list(counter.stream(iter(batches[:2])))
    t0 = time.perf_counter()
    n_frames = sum(len(x) for x in counter.stream(iter(batches + batches), prefetch=2))
    dt = time.perf_counter() - t0
    log(f"serve stream 8x B=16 768x1024 bf16 fused_mem=True: "
        f"{n_frames / dt:.2f} frames/s [{gpu}]")

    times = {}
    for b in (1, 4):
        g = torch.Generator(device="cuda").manual_seed(10 + b)
        y = torch.randn(b, P, K, generator=g, device="cuda").to(torch.bfloat16)
        mem = torch.randn(K, S, generator=g, device="cuda").to(torch.bfloat16)
        memt = mem.t().contiguous()[None, None].expand(b, 1, S, K)
        kern = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 20)
        ref = cuda_ms(lambda: ma.memory_attention_reference(y, mem), 5, warmup=1)
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            y[:, None], memt, memt, scale=1.0 / math.sqrt(K)), 20)
        flops = 4.0 * b * P * K * S
        nbytes = 2.0 * (2 * b * P * K + K * S)
        bound_ops, bound_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
        times[b] = dict(ms=kern, plain_ms=ref, library_ms=sdpa,
                        bound_ms=max(bound_ops, bound_bytes),
                        bound_by="operations" if bound_ops >= bound_bytes else "bytes")
        log(f"kernel B={b} P={P} K={K} S={S} bf16: memory_attention_fused "
            f"{kern:.4f} ms, plain {ref:.4f} ms, SDPA {sdpa:.4f} ms, bound "
            f"{times[b]['bound_ms']:.4f} ms ({times[b]['bound_by']}; "
            f"{flops / kern / 1e9:.1f} TFLOP/s achieved) [{gpu}]")
    g = torch.Generator(device="cuda").manual_seed(20)
    y = torch.randn(4, P, K, generator=g, device="cuda")
    mem = torch.randn(K, S, generator=g, device="cuda")
    kern32 = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 5)
    log(f"kernel B=4 f32: memory_attention_fused {kern32:.4f} ms, bound "
        f"{1e3 * 4.0 * 4 * P * K * S / PEAK_F32_FLOPS:.4f} ms (f32 CUDA-core "
        f"peak) [{gpu}]")
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # ---- 5. result --------------------------------------------------------
    t4 = times[4]
    print(json.dumps({"kernels": [{
        "name": "memory_attention_fused", "route": "cuda",
        "source": "dgvcc_tpu_torch/csrc/mem_attention.cu",
        "replaces": "dgvcc_tpu/ops/mem_attention.py:59",
        "launches": launches, "ok": True,
        "max_abs_err": err_bf16, "max_err": err_bf16, "max_abs_err_f32": err_f32,
        "ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
        "shape": {"B": 4, "P": P, "K": K, "S": S, "dtype": "bfloat16"}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
