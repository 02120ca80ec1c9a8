"""Serving frames/s of one checkout's port, for A/B runs of two trees on one
card: ``count_frames`` of a full-width counter (``--model``, ``final`` by
default: seeded weights, bf16, kernel #1 on for ``final``, cuDNN's
benchmark on) on 768x1024 frames, 200 calls at B=1 and 100 at B=4 after 10
warm-up calls, on the host clock; with ``--int8`` also its int8 graph
(calibrated on 4 seeded frames), the same calls.

    python3 scripts/ab_serve_torch.py TREE [--int8] [--model NAME]
    # prints "AB TREE NAME B=1 f B=4 f [int8 B=1 f B=4 f]"

TREE is the root of a checkout (``git archive`` of a commit, unpacked): its
``dgvcc_tpu_torch`` is imported and its serving kernels built. Run two trees
in turns from one shell (parent, change, change, parent, ...), each turn a
process of its own.
"""

import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgvcc_tpu_torch.ops import _build  # noqa: E402
from dgvcc_tpu_torch.serve import VideoCounter  # noqa: E402

_build.build_all(["mem_attention", "qconv"])
torch.backends.cudnn.benchmark = True
frames = np.random.default_rng(0).integers(0, 256, (4, 768, 1024, 3), dtype=np.uint8)


def frames_per_s(counter):
    fps = []
    for b, calls in ((1, 200), (4, 100)):
        f = np.ascontiguousarray(frames[:b])
        for _ in range(10):
            counter.count_frames(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            counter.count_frames(f)
        fps.append(b * calls / (time.perf_counter() - t0))
    return f"B=1 {fps[0]:.2f} B=4 {fps[1]:.2f}"


args = sys.argv[2:]
model = args[args.index("--model") + 1] if "--model" in args else "final"
kw = {"fused_mem": True} if model == "final" else {}
line = f"AB {os.path.basename(tree)} {model} " + frames_per_s(VideoCounter.from_checkpoint(
    model, None, dtype=torch.bfloat16, seed=0, **kw))
if "--int8" in args:
    calib = np.random.default_rng(1).integers(0, 256, (4, 768, 1024, 3), dtype=np.uint8)
    line += " int8 " + frames_per_s(VideoCounter.from_checkpoint(
        model, None, dtype=torch.bfloat16, seed=0, quantize=True, calib_frames=calib))
print(line, flush=True)
