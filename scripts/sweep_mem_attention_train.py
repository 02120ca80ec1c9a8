#!/usr/bin/env python3
"""Design sweep of the port's bf16 training forward kernel (#2).

Builds variants of ``dgvcc_tpu_torch/csrc/mem_attention_train.cu`` that
differ only in the forward's pipeline constants -- M chunks in flight
(``kStagesF``), row tiles in flight (``kYBufsF``) and how far a row's max
may rise before its running max moves (``kLazyF``) -- into ``build/sweep_train/``. A
constant that a substitution does not find stops the script. It prints
ptxas's registers and spills of each variant's K=256 bf16 forward (and
any fault of that report), checks every variant against the plain
version in a process of its own (out, loss_con and q, also with views that
agree to 0.001, and two calls bit for bit), then times the ones that pass
at the training shape (B=16, P=6400, K=256, S=1024, two views) with CUDA
events, in turns. Needs one NVIDIA GPU with nvcc:

    python3 scripts/sweep_mem_attention_train.py [--variants s2y2l8,s3y1l8]
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
OUT = os.path.join(REPO, "build", "sweep_train")
CONSTANTS = ("kStagesF", "kYBufsF", "kLazyF")
# name: the constants' values; shared memory at K=256 is kYBufsF * 64 KiB +
# kStagesF * 32 KiB + 20 KiB of the block's 227 KB
VARIANTS = {"s2y2l8": (2, 2, 8), "s2y2l0": (2, 2, 0), "s3y1l8": (3, 1, 8),
            "s2y1l8": (2, 1, 8)}
B, P, K, S = 16, 80 * 80, 256, 1024
# (B, P, K, S, eps) checked for every variant: eps None draws the views
# independently, else y2 = y1 + eps N(0, 1)
CHECKS = ((16, P, 256, 1024, None), (16, P, 256, 1024, 0.001), (3, 6437, 256, 1001, None),
          (2, 437, 16, 1001, 0.01), (2, 300, 256, 40, None))
TOL_OUT, TOL_CON, TOL_Q = 2e-2, 1e-3, 1e-4  # chip_smoke.py's bf16 limits


def variant_source(src, params):
    for name, value in zip(CONSTANTS, params):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            sys.exit(f"sweep: {name} matched {n} times in mem_attention_train.cu; "
                     "update CONSTANTS to the kernel's parameters")
    return src


def build(names):
    from dgvcc_tpu_torch.ops import _build

    src = open(os.path.join(CSRC, "mem_attention_train.cu")).read()
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC,
             "-o", os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = []
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"{name}: nvcc failed:\n{log[-4000:]}", flush=True)
            continue
        report = _build.ptxas_report(log, "mat_fwd_bf16ILi256E")
        faults = _build.ptxas_faults(report)
        print(f"{name} {VARIANTS[name]}: ptxas K=256 bf16 forward: {' | '.join(report)}"
              f"{' -- ' + '; '.join(faults) if faults else ''}", flush=True)
        built.append(name)
    return built


def forward_fn(name):
    """The variant's forward, as mt.memory_attention_train_forward returns it."""
    from dgvcc_tpu_torch.ops import mem_attention_train as mt

    lib = mt._bind(ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")))

    def call(y1, y2, mem):
        saved, mt._lib = mt._lib, lib
        try:
            return mt.memory_attention_train_forward(y1, y2, mem)
        finally:
            mt._lib = saved
    return call


def inputs(b, p, k, s, eps, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y1 = torch.randn(b, p, k, generator=g, device="cuda")
    y2 = (torch.randn(b, p, k, generator=g, device="cuda") if eps is None
          else y1 + eps * torch.randn(b, p, k, generator=g, device="cuda"))
    mem = torch.randn(k, s, generator=g, device="cuda")
    return y1.bfloat16(), y2.bfloat16(), mem.bfloat16()


def check(name):
    """Child process: the variant against the plain version at CHECKS;
    prints one JSON line."""
    from dgvcc_tpu_torch.ops import mem_attention_train as mt

    torch.backends.cuda.matmul.allow_tf32 = False
    call, ok_all, same = forward_fn(name), True, True
    for i, (b, p, k, s, eps) in enumerate(CHECKS):
        y1, y2, mem = inputs(b, p, k, s, eps, 200 + i)
        got, again = call(y1, y2, mem), call(y1, y2, mem)
        torch.cuda.synchronize()
        r1, r2, rcon = mt.memory_attention_train_reference(y1, y2, mem)
        _, rq = mt.saved_reference(y1, y2, mem)
        out = max((got[0].float() - r1.float()).abs().max().item(),
                  (got[1].float() - r2.float()).abs().max().item())
        con = abs(got[2].item() - rcon.item()) / rcon.item()
        q = ((got[4] - rq).abs() / rq).max().item()
        ok = out <= TOL_OUT and con <= TOL_CON and q <= TOL_Q
        same = same and all(torch.equal(x, z) for x, z in zip(got, again))
        ok_all = ok_all and ok
        print(f"{name} B={b} P={p} K={k} S={s} eps={eps}: out max_abs_err {out:.3e}, loss_con "
              f"rel {con:.3e}, q max rel {q:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    print(json.dumps({"variant": name, "ok": ok_all, "deterministic": same}))


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


def time_variants(names, turns=3):
    calls = {n: forward_fn(n) for n in names}
    y1, y2, mem = inputs(B, P, K, S, None, 30)
    flops = 2 * 4.0 * B * P * K * S
    for turn in range(turns):
        for name in names:
            ms = cuda_ms(lambda: calls[name](y1, y2, mem))
            print(f"turn {turn} {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s",
                  flush=True)


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
        if verdict.get("ok") and verdict.get("deterministic"):
            passed.append(name)
    print(f"passed: {passed}", flush=True)
    if passed:
        time_variants(passed)
    if len(passed) != len(names):
        sys.exit(1)


if __name__ == "__main__":
    main()
