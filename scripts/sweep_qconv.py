#!/usr/bin/env python3
"""The int8 convolution ``qconv_int8`` of two trees, timed in turns at the
shapes of `final`'s 21 int8 sites, and CCTrans's strided sites.

Imports ``dgvcc_tpu_torch.ops.qconv`` of this checkout ("C") and, with
``--parent DIR``, of another tree ("P", e.g. the parent commit unpacked with
``git archive`` into a directory that .gitignore lists); each builds its own
``csrc/qconv.cu`` into its own ``build/torch_ext/``. Both run in one process
on one card, in turns (P C C P, or C C without a parent), on the same seeded
int8 inputs at B=``--batch`` and 768x1024 (chip_smoke.py's FINAL_INT8_SITES
and final_site, the table phase 14 holds a real forward's sites to). For
each site it prints:

  * each tree's device time per call (chip_smoke.py's device_ms_cold:
    median of ``--calls`` calls, L2 cold, CUDA events; for Cin = 3 it holds
    C's padding of the activations too), the method and the inputs phase 14
    times the heaviest sites by;
  * cuDNN's bf16 convolution at the same shape (the yardstick), timed the
    same way, and the bound at the site's own Cin (chip_smoke.py's
    qconv_bound_ms);
  * C's plan (``ops/qconv.py::plan``: the schedule, BN, kBK, the tile).

Then CCTrans's strided sites (chip_smoke.py's CCTRANS_STRIDED_SITES, k x k
windows at stride k) at CCTrans's int8 batch floor (``nn/quant.py``'s
CCTRANS_MIN_BATCH), the same way; a tree whose kernel takes no stride is not
timed there.

Before timing it holds each tree's int32 accumulator and bf16 output bit for
bit against the plain version (chip_smoke.py's check_qconv), and prints
ptxas's report and the SASS instruction counts of C's kernel bodies. Needs
one NVIDIA GPU with nvcc:

    git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/sweep_qconv.py --parent build/parent

The last line is a JSON object of every reading.
"""

import argparse
import importlib
import inspect
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (the timing, bound, check and site table)


def load_tree(path):
    """``dgvcc_tpu_torch.ops.qconv`` imported from the tree at ``path``; the
    package is dropped from sys.modules again, so the next tree imports its
    own."""
    def drop():
        for name in [m for m in sys.modules
                     if m == "dgvcc_tpu_torch" or m.startswith("dgvcc_tpu_torch.")]:
            del sys.modules[name]

    drop()
    sys.path.insert(0, path)
    try:
        module = importlib.import_module("dgvcc_tpu_torch.ops.qconv")
        module._kernel()  # build and load now, from this tree's csrc
        build = importlib.import_module("dgvcc_tpu_torch.ops._build")
    finally:
        sys.path.remove(path)
        drop()
    return module, build


def kernel_report(build):
    """ptxas's lines and the SASS op counts of the kernel bodies."""
    lines = build.ptxas_report(build.build_log("qconv"), "qconv_")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path("qconv"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return lines, cs.sass_counts(sass, "qconv_(wgmma|halo)_kernel", cs.SASS_OPS_INT8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another tree's root, timed in turns with this one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--calls", type=int, default=cs.QCONV_CALLS)
    args = ap.parse_args()
    from dgvcc_tpu_torch.nn.quant import CCTRANS_MIN_BATCH  # load_tree drops the package
    if not torch.cuda.is_available():
        raise SystemExit("sweep_qconv.py times the kernel on an NVIDIA GPU; none is visible")
    gpu = cs.card()
    print(gpu, flush=True)
    trees = {"C": load_tree(REPO)}
    if args.parent:
        trees["P"] = load_tree(os.path.abspath(args.parent))
    order = ["P", "C", "C", "P"] if args.parent else ["C", "C"]
    lines, bodies = kernel_report(trees["C"][1])
    for ln in lines:
        print(f"ptxas: {ln}")
    for name, c in bodies.items():
        print(f"SASS {name}: {c}")
    torch.backends.cudnn.benchmark = True
    b = args.batch
    rows = []
    for i, (h, w, cin, cout, k) in enumerate(cs.FINAL_INT8_SITES):
        site = cs.final_site(i, b)
        for qc, _ in trees.values():
            cs.check_qconv(qc, site)
        times = {}
        for label in order:
            qc = trees[label][0]
            times.setdefault(label, []).append(
                cs.device_ms_cold(lambda: qc.qconv_int8(**site), args.calls))
        xb = (site["xq"].float() * site["s"]).to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = site["w8"].to(torch.bfloat16).permute(0, 3, 1, 2)
        lib = cs.device_ms_cold(lambda: torch.nn.functional.conv2d(xb, wb, padding=k // 2),
                                args.calls)
        bound, by, _ = cs.qconv_bound_ms(b, h, w, cin, cout, k)
        row = dict(site=i, shape=[b, h, w, cin, cout, k], ms=times, cudnn_bf16_ms=lib,
                   bound_ms=bound, bound_by=by,
                   plan=trees["C"][0].plan(site["xq"].shape, site["w8"].shape))
        rows.append(row)
        print(f"site {i:2d} {tuple(site['xq'].shape)} -> {cout} {k}x{k}: C "
              f"{', '.join(f'{t:.4f}' for t in times['C'])} ms"
              + (f", P {', '.join(f'{t:.4f}' for t in times['P'])}" if "P" in times else "")
              + f"; cuDNN bf16 {lib:.4f}; bound {bound:.4f} ({by}); plan {row['plan']}",
              flush=True)
        del site, xb, wb
        torch.cuda.empty_cache()
    total = {label: [sum(r["ms"][label][j] for r in rows) for j in range(len(rows[0]["ms"][label]))]
             for label in trees}
    total_lib = sum(r["cudnn_bf16_ms"] for r in rows)
    print(f"the {len(rows)} sites at B={b}: " + "; ".join(
        f"{label} {', '.join(f'{t:.3f}' for t in v)} ms" for label, v in total.items())
        + f"; cuDNN bf16 {total_lib:.3f} ms; bound {sum(r['bound_ms'] for r in rows):.3f} ms "
        f"[{gpu}]")
    strided = []
    nb = CCTRANS_MIN_BATCH
    for i, (h, w, cin, cout, k, n) in enumerate(cs.CCTRANS_STRIDED_SITES):
        site = cs.qconv_site(nb, h, w, cin, cout, k, 1700 + i, relu=False, stride=k)
        times = {}
        for label in order:
            qc = trees[label][0]
            if "stride" not in inspect.signature(qc.qconv_int8).parameters:
                continue
            if label not in times:
                cs.check_qconv(qc, site)
            times.setdefault(label, []).append(
                cs.device_ms_cold(lambda: qc.qconv_int8(**site), args.calls))
        _, lib = cs.timed_against_cudnn(trees["C"][0], site)
        bound, by, _ = cs.qconv_bound_ms(nb, h, w, cin, cout, k, stride=k)
        row = dict(shape=[nb, h, w, cin, cout, k], stride=k, sites=n, ms=times,
                   cudnn_bf16_ms=lib, bound_ms=bound, bound_by=by,
                   plan=trees["C"][0].plan(site["xq"].shape, site["w8"].shape, stride=k))
        strided.append(row)
        print(f"strided {tuple(site['xq'].shape)} -> {cout} {k}x{k}/{k} (x{n}): "
              + "; ".join(f"{label} {', '.join(f'{t:.4f}' for t in v)} ms"
                          for label, v in times.items())
              + f"; cuDNN bf16 {lib:.4f}; bound {bound:.4f} ({by}); plan {row['plan']} [{gpu}]",
              flush=True)
        del site
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "batch": b, "ptxas": lines, "sass": bodies, "sites": rows,
                      "total_ms": total, "total_cudnn_bf16_ms": total_lib,
                      "strided_batch": nb, "strided": strided}))


if __name__ == "__main__":
    main()
