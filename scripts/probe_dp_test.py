#!/usr/bin/env python3
"""What moves phase 12's test MAE: the 2-rank ``--task train_test`` against
one process's ``--task test`` of the same ``last.pth``.

chip_smoke.py phase 12 (``dp_files_run``) holds the two at 1e-4 relative.
This script runs the same pair on the same kind of files (chip_smoke.py's
``write_dataset``, maps by ``dmap_cli``) and adds the runs that tell the
possible causes apart, each with ``test_report`` (per-image counts):

  A  torchrun, 2 ranks (gloo on cuda:0), ``--task train_test``, 1 epoch:
     rank 0 tests from its weights in memory;
  B, C  ``python -m dgvcc_tpu_torch --task test`` of A's ``last.pth``, each
     in a fresh process (cuDNN's heuristics pick the algorithms, as in A);
  D  the same test in this process with ``cudnn.benchmark`` on: each
     convolution's algorithm is chosen by timing;
  E  once more in this process with the benchmark off. PyTorch keeps the
     algorithm a convolution key first ran with, whatever the flag says
     later, so E runs D's algorithms: the condition of chip_smoke.py's
     in-process reference, which runs after phases 3 and 6 timed these
     shapes with the benchmark on.

A == B means rank 0's weights in memory are ``last.pth``'s (the EMA shadow,
the averaged running statistics and the casts included); B == C that a fresh
``--task test`` repeats; D against B what the algorithm choice moves.
Needs one NVIDIA GPU:

    python3 scripts/probe_dp_test.py

The last line is a JSON object: each run's MAE and the largest per-image
difference of each run from A.
"""

import contextlib
import csv
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report(path):
    with open(path) as f:
        return {r["name"]: float(r["pred_count"]) for r in csv.DictReader(f)}


def mae_of(text):
    return float(re.findall(r"Testing results: mae: (\S+)", text)[-1])


def main():
    if not torch.cuda.is_available():
        print("probe_dp_test: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dgvcc_tpu_torch.cli.main import main as cli_main

    gpu = cs.card()
    print(gpu, flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_dp_")
    try:
        root = os.path.join(tmp, "data")
        cs.write_dataset(root)
        out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch.data.dmap_cli", "--path",
                              root], capture_output=True, text=True, timeout=300, cwd=ROOT)
        if out.returncode:
            raise SystemExit(f"dmap_cli exited {out.returncode}:\n{out.stderr[-3000:]}")
        with open(os.path.join(ROOT, "configs", "sta_final.yml")) as f:
            raw = yaml.safe_load(f)
        for split in ("train", "val", "test"):
            raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
                raw[f"{split}_dataset"]["params"], root=root))
        raw.update(num_epochs=1, log_dir=os.path.join(tmp, "logs"),
                   mesh={"data": cs.DP_RANKS}, test_report=os.path.join(tmp, "A.csv"))
        cfg = os.path.join(tmp, "dp.yml")
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
        ranks = os.path.join(tmp, "ranks")
        os.makedirs(ranks)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={cs.DP_RANKS}", os.path.join(ROOT, "chip_smoke.py"),
             "--cli-rank", ranks, "--config", cfg, "--task", "train_test", "--dist-backend",
             "gloo"], capture_output=True, text=True, timeout=900, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT))
        if out.returncode:
            raise SystemExit(f"torchrun exited {out.returncode}:\n{out.stderr[-4000:]}")
        log_dir = os.path.join(raw["log_dir"], raw["version"])
        last = os.path.join(log_dir, "last.pth")
        runs = {"A": (mae_of(open(os.path.join(log_dir, "log.txt")).read()),
                      report(os.path.join(tmp, "A.csv")))}
        print(f"A torchrun train_test: {time.perf_counter() - t0:.1f} s", flush=True)

        def one_config(label):
            one = dict(raw, version=f"one_{label}", test_report=os.path.join(tmp, f"{label}.csv"))
            one.pop("mesh")
            path = os.path.join(tmp, f"one_{label}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(one, f)
            return path

        for label in ("B", "C"):
            out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch", "--config",
                                  one_config(label), "--task", "test", "--ckpt", last],
                                 capture_output=True, text=True, timeout=600, cwd=ROOT,
                                 env=dict(os.environ, PYTHONPATH=ROOT))
            if out.returncode:
                raise SystemExit(f"--task test exited {out.returncode}:\n{out.stderr[-4000:]}")
            runs[label] = (mae_of(out.stdout), report(os.path.join(tmp, f"{label}.csv")))
        for label, bench in (("D", True), ("E", False)):
            torch.backends.cudnn.benchmark = bench
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(["--config", one_config(label), "--task", "test", "--ckpt", last])
            runs[label] = (mae_of(buf.getvalue()), report(os.path.join(tmp, f"{label}.csv")))
        a = runs["A"][1]
        result = {"device": gpu, "mae": {k: v[0] for k, v in runs.items()},
                  "max_image_diff_from_A": {k: max(abs(v[1][n] - a[n]) for n in a)
                                            for k, v in runs.items()},
                  "images": {k: v[1] for k, v in runs.items()}}
        for k, (mae, counts) in runs.items():
            rel = abs(mae - runs["A"][0]) / max(abs(runs["A"][0]), 1.0)
            print(f"{k}: MAE {mae:.4f} (rel diff from A {rel:.3e}); largest per-image count "
                  f"difference from A {result['max_image_diff_from_A'][k]:.3f}; "
                  f"counts {counts}", flush=True)
        print(json.dumps(result))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
