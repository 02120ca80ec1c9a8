#!/usr/bin/env python3
"""Kernel #4 (the Gaussian density map) of two trees, timed in turns.

Imports ``dgvcc_tpu_torch.ops.dmap`` of this checkout ("C") and, with
``--parent DIR``, of another tree ("P", e.g. the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists); each builds
its own ``csrc/dmap.cu`` into its own ``build/torch_ext/``. Both run in
one process on one card, in turns (P C C P, or C C without a parent), at
chip_smoke.py's DMAP_CASES S1 (768x1024, 1,024 uniform points), S2
(2048x3072, 25,000 clustered) and S3 (2048x3072, 1,000 uniform). For
each tree, shape and turn it prints:

  * the device time per call: the durations of the device activities of
    one call (kernels, memsets) summed, from torch.profiler (CUPTI),
    median over 50 calls (chip_smoke.py's device_ms_per_call);
  * the back-to-back time: CUDA events around 200 calls, over 200 (the
    earlier method, which times the host's launch rate when the host is
    slower than the kernel);
  * the host time per call (the clock around the call, no synchronise),
    and once more with the trees called in turn, call by call;
  * cuBLAS A . B^T's device time on the prebuilt f32 operands (TF32 off).

Before timing it checks each tree against its plain version (atol 1e-5,
rtol 1e-4), a second call bit for bit, and whether C's map equals P's bit
for bit. Needs one NVIDIA GPU with nvcc:

    git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/sweep_dmap.py --parent build/parent [--shapes S1,S2,S3]

The last line is a JSON object of every reading.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_CALLS = {"S1": 50, "S2": 20, "S3": 50}   # cuBLAS calls (about 6 ms each at S2)


def load_tree(path):
    """``dgvcc_tpu_torch.ops.dmap`` imported from the tree at ``path``; the
    package is dropped from sys.modules again, so the next tree imports its
    own."""
    def drop():
        for name in [m for m in sys.modules
                     if m == "dgvcc_tpu_torch" or m.startswith("dgvcc_tpu_torch.")]:
            del sys.modules[name]

    drop()
    sys.path.insert(0, path)
    try:
        module = importlib.import_module("dgvcc_tpu_torch.ops.dmap")
    finally:
        sys.path.remove(path)
        drop()
    if not module.__file__.startswith(os.path.abspath(path)):
        sys.exit(f"sweep: imported {module.__file__}, not the tree at {path}")
    return module


def check(cs, trees, shapes):
    """Each tree against its plain version and itself; C against P, bit for
    bit. Returns {tree: {shape: max_abs_err}}, {shape: C equals P}."""
    errs, equal = {}, {}
    for name in shapes:
        h, w, n, _, sigma, truncate = cs.DMAP_CASES[name]
        pts, mask = cs.dmap_case(name, seed=60)
        outs = {}
        for label, dm in trees.items():
            out = dm.gaussian_density(pts, mask, h, w, sigma, truncate)
            again = dm.gaussian_density(pts, mask, h, w, sigma, truncate)
            torch.cuda.synchronize()
            ref = dm.gaussian_density_reference(pts, mask, h, w, sigma, truncate)
            err = (out - ref).abs().max().item()
            ok = bool(torch.allclose(out, ref, **cs.TOL_DMAP)) and bool(torch.equal(out, again))
            errs.setdefault(label, {})[name] = err
            outs[label] = out
            print(f"check {label} {name} {h}x{w} N={n}: max_abs_err {err:.3e} vs plain, two "
                  f"calls {'bit-identical' if torch.equal(out, again) else 'DIFFER'} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                sys.exit(f"sweep: tree {label} disagrees at {name}")
        if "P" in outs:
            equal[name] = bool(torch.equal(outs["P"], outs["C"]))
            print(f"check {name}: C's map {'equals' if equal[name] else 'differs from'} P's "
                  f"bit for bit", flush=True)
    return errs, equal


def interleaved_host_ms(cs, trees, shapes, rounds=300):
    """Host time per call of each tree, the trees called in turn within
    each round (so a drift of the host's speed falls on all of them):
    {tree: {shape: median ms}}."""
    out = {label: {} for label in trees}
    for name in shapes:
        h, w, _, _, sigma, truncate = cs.DMAP_CASES[name]
        pts, mask = cs.dmap_case(name, seed=50)
        times = {label: [] for label in trees}
        for i in range(rounds):
            if i % 50 == 0:
                torch.cuda.synchronize()
            for label, dm in trees.items():
                t = time.perf_counter()
                dm.gaussian_density(pts, mask, h, w, sigma, truncate)
                times[label].append(time.perf_counter() - t)
        torch.cuda.synchronize()
        for label in trees:
            out[label][name] = 1e3 * float(np.median(times[label]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the tree to compare with (P)")
    ap.add_argument("--shapes", default="S1,S2,S3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(gpu, flush=True)
    shapes = [s for s in args.shapes.split(",") if s]
    trees = {"C": load_tree(REPO)}
    if args.parent:
        trees = {"P": load_tree(os.path.abspath(args.parent)), **trees}
    turns = "PCCP" if args.parent else "CC"
    errs, equal = check(cs, trees, shapes)
    for label, dm in trees.items():  # ptxas's registers and spills of each build
        for line in dm._build.build_log("dmap").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {label}: {line.strip()}", flush=True)
    readings = []
    for i, label in enumerate(turns):
        for name in shapes:
            t = cs.dmap_timing(trees[label], name, LIB_CALLS.get(name, 20), plain_calls=0,
                               seed=50)
            t.update(turn=i, tree=label, shape=name)
            readings.append(t)
            print(f"turn {i} {label} {name} {t['H']}x{t['W']} N={t['N']}: device "
                  f"{t['device_ms']:.5f} ms a call ({t['device_method']}; "
                  f"{t['kernels_per_call']} a call: {cs.ops(t)}), "
                  f"back-to-back {t['b2b_ms']:.5f} ms, host {t['host_ms']:.5f} ms a call, "
                  f"cuBLAS device {t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}) [{gpu}]", flush=True)
    host = interleaved_host_ms(cs, trees, shapes)
    for name in shapes:
        for label in trees:
            rows = [t for t in readings if t["tree"] == label and t["shape"] == name]
            med = {k: float(np.median([t[k] for t in rows]))
                   for k in ("device_ms", "b2b_ms", "host_ms", "library_ms")}
            print(f"median {label} {name}: " + ", ".join(f"{k} {v:.5f}" for k, v in med.items())
                  + f"; host, interleaved: {host[label][name]:.5f}", flush=True)
    result = {"card": gpu, "turns": turns, "max_abs_err": errs, "c_equals_p": equal,
              "readings": readings, "host_ms_interleaved": host}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
