#!/usr/bin/env python3
"""Design sweep of the port's bf16 memory-attention kernel (#1).

Builds variants of ``dgvcc_tpu_torch/csrc/mem_attention.cu`` that differ
only in its pipeline constants -- prototypes per S-chunk (``kChunk``), M
stages in flight (``kStages``) and y tiles in flight (``kYBufs``) -- into
``build/sweep/``. A constant that a substitution does not find stops the
script: a variant that silently equals another is worse than none. It
prints ptxas's registers and spills of each variant's K=256 bf16 kernel
(and any fault of that report: a serialised wgmma or a spill), checks
every variant against the f32 plain version in a process of its own (a
fault in one does not take the others down), then times the ones that
pass at the serving shape (K=256, S=1024, P=192*256, B=4 and 1) with CUDA
events, in turns, beside SDPA on the same inputs. Needs one NVIDIA GPU
with nvcc:

    python3 scripts/sweep_mem_attention.py [--variants c64s3y2,c64s4y1]
"""

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "dgvcc_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "sweep")
CONSTANTS = {"kChunk": r"constexpr int kChunk = \d+;",
             "kStages": r"constexpr int kStages = \d+;",
             "kYBufs": r"constexpr int kYBufs = \d+;"}
# name: (kChunk, kStages, kYBufs); shared memory at K=256 is
# kYBufs * 64 KiB + kStages * kChunk * 512 B of the block's 227 KB
VARIANTS = {"c64s3y2": (64, 3, 2), "c64s2y2": (64, 2, 2), "c64s4y1": (64, 4, 1),
            "c64s3y1": (64, 3, 1), "c128s2y1": (128, 2, 1)}
K, S, P = 256, 1024, 192 * 256
TOL = 2e-2  # bf16 output against the f32 plain version: one bf16 rounding
# (B, P, K, S) checked for every variant: the serving shape, a tail tile, a
# chunk tail with a padded M pitch, S below one chunk, the smallest width
CHECKS = ((4, P, 256, 1024), (1, 37, 256, 1024), (1, 1000, 256, 1001),
          (2, 300, 256, 40), (2, 333, 16, 200))


def variant_source(src, params):
    for (name, pattern), value in zip(CONSTANTS.items(), params):
        src, n = re.subn(pattern, f"constexpr int {name} = {value};", src)
        if n != 1:
            sys.exit(f"sweep: {name} matched {n} times in mem_attention.cu; "
                     "update CONSTANTS to the kernel's parameters")
    return src


def build(names):
    from dgvcc_tpu_torch.ops import _build

    src = open(os.path.join(CSRC, "mem_attention.cu")).read()
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
             "-o", os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = []
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"{name}: nvcc failed:\n{log[-4000:]}", flush=True)
            continue
        report = _build.ptxas_report(log, "mem_attention_bf16_kernelILi256E")
        faults = _build.ptxas_faults(report)
        print(f"{name} {VARIANTS[name]}: ptxas K=256 bf16: {' | '.join(report)}"
              f"{' -- ' + '; '.join(faults) if faults else ''}", flush=True)
        built.append(name)
    return built


def kernel_fn(name):
    fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).mem_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(y, mem, out):
        s = mem.shape[1]
        if s % 8:
            mem = torch.nn.functional.pad(mem, (0, 8 - s % 8))
        err = fn(y.data_ptr(), mem.data_ptr(), out.data_ptr(), y.shape[0] * y.shape[1],
                 y.shape[2], s, mem.shape[1], 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
    return call


def check(name):
    """Child process: the variant against the f32 plain version at CHECKS,
    and two calls bit for bit; prints one JSON line."""
    from dgvcc_tpu_torch.ops.mem_attention import memory_attention_reference

    call, worst, same = kernel_fn(name), 0.0, True
    for i, (b, p, k, s) in enumerate(CHECKS):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        y = torch.randn(b, p, k, generator=g, device="cuda").bfloat16()
        mem = torch.randn(k, s, generator=g, device="cuda").bfloat16()
        out, again = torch.empty_like(y), torch.empty_like(y)
        call(y, mem, out)
        call(y, mem, again)
        torch.cuda.synchronize()
        ref = memory_attention_reference(y.float(), mem.float())
        err = (out.float() - ref).abs().max().item()
        ok = bool(torch.allclose(out.float(), ref, atol=TOL, rtol=TOL))
        same = same and bool(torch.equal(out, again))
        print(f"{name} B={b} P={p} K={k} S={s}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        worst = max(worst, err if ok else math.inf)
    print(json.dumps({"variant": name, "max_abs_err": worst, "deterministic": same}))


def cuda_ms(fn, iters=20, warmup=3):
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


def time_variants(names, turns=2):
    calls = {n: kernel_fn(n) for n in names}
    for b in (4, 1):
        g = torch.Generator(device="cuda").manual_seed(b)
        y = torch.randn(b, P, K, generator=g, device="cuda").bfloat16()
        mem = torch.randn(K, S, generator=g, device="cuda").bfloat16()
        memt = mem.t().contiguous()[None, None].expand(b, 1, S, K)
        out = torch.empty_like(y)
        flops = 4.0 * b * P * K * S
        for turn in range(turns):
            for name in names:
                ms = cuda_ms(lambda: calls[name](y, mem, out))
                print(f"B={b} turn {turn} {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
                      f"TFLOP/s", flush=True)
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                y[:, None], memt, memt, scale=1.0 / math.sqrt(K)))
            print(f"B={b} turn {turn} SDPA: {sdpa:.4f} ms", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--check", help=argparse.SUPPRESS)  # child process: one variant
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    if args.check:
        check(args.check)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        sys.exit(f"unknown variants {sorted(unknown)}; have {sorted(VARIANTS)}")
    passed = []
    for name in build(names):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--check", name],
                             capture_output=True, text=True, timeout=600)
        print(res.stdout.strip() or res.stderr.strip()[-2000:], flush=True)
        last = res.stdout.strip().splitlines()[-1:] if res.returncode == 0 else []
        verdict = json.loads(last[0]) if last else {}
        if verdict.get("deterministic") and math.isfinite(verdict["max_abs_err"]):
            passed.append(name)
    print(f"passed: {passed}", flush=True)
    if passed:
        time_variants(passed)
    if len(passed) != len(names):
        sys.exit(1)


if __name__ == "__main__":
    main()
