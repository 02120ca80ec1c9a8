#!/usr/bin/env python3
"""Tile-shape sweep of the port's bf16 memory-attention kernel.

Builds variants of ``dgvcc_tpu_torch/csrc/mem_attention.cu`` that differ
only in warps per block (``kWarps``, 16 rows each) and prototypes per
S-chunk (``kChunk``), into ``build/sweep/``, then times each one at the
serving shape (K=256, S=1024, P=192*256, B=4 and 1) with CUDA events, in
turns, and checks it against the plain version. Needs one NVIDIA GPU
with nvcc:

    python3 scripts/sweep_mem_attention.py
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (warps per block, prototypes per chunk, blocks per SM in __launch_bounds__)
VARIANTS = {"w8c64": (8, 64, 1), "w8c32": (8, 32, 1),
            "w4c64": (4, 64, 2), "w4c32": (4, 32, 2)}


def build(out):
    src = open(os.path.join(REPO, "dgvcc_tpu_torch/csrc/mem_attention.cu")).read()
    procs = {}
    for name, (warps, chunk, blocks) in VARIANTS.items():
        s = re.sub(r"constexpr int kWarps = \d+;", f"constexpr int kWarps = {warps};", src)
        s = re.sub(r"constexpr int kChunk = \d+;", f"constexpr int kChunk = {chunk};", s)
        s = re.sub(r"__launch_bounds__\(kThreads, \d\)",
                   f"__launch_bounds__(kThreads, {blocks})", s)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-o", os.path.join(out, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        # ptxas reports kernels in template order; K=256's bf16 kernel is the second
        report = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(report[2:4])}")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from dgvcc_tpu_torch.ops.mem_attention import memory_attention_reference

    out = os.path.join(REPO, "build", "sweep")
    os.makedirs(out, exist_ok=True)
    build(out)
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(os.path.join(out, f"lib{name}.so")).mem_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    k, s, p = 256, 1024, 192 * 256
    for b in (4, 1):
        g = torch.Generator(device="cuda").manual_seed(b)
        y = torch.randn(b, p, k, generator=g, device="cuda").bfloat16()
        mem = torch.randn(k, s, generator=g, device="cuda").bfloat16()
        ref = memory_attention_reference(y.float(), mem.float())
        out_t = torch.empty_like(y)
        for _ in range(2):
            for name, fn in fns.items():
                def call():
                    err = fn(y.data_ptr(), mem.data_ptr(), out_t.data_ptr(), b * p,
                             k, s, 1, torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"{name}: launch failed ({err})")
                call()
                torch.cuda.synchronize()
                max_err = (out_t.float() - ref).abs().max().item()
                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                print(f"B={b} {name}: {ms:.4f} ms {4 * b * p * k * s / ms / 1e9:.1f} "
                      f"TFLOP/s max_abs_err {max_err:.3e}", flush=True)


if __name__ == "__main__":
    main()
