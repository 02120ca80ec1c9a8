"""``quantize="auto"``'s default law in the port: int8 at no dispatch batch.

``serve.py::AUTO_INT8_MIN_BATCH`` is None because on an NVIDIA H100 the
int8 graph of `final` served below bf16's frames/s at B=1, 4 and 16
(chip_smoke.py phase 14; PERF.md section 2), with the wgmma int8 kernel
too: the activation quantize passes outweigh what the kernel saves. So a counter
in auto mode with no ``auto_threshold`` serves bf16 at every batch and never
calibrates; an integer threshold still opts a deployment into int8
(tests/test_torch_port_quant_io.py). The JAX package's law, measured on a
TPU v5e, differs on purpose (ROADMAP.md, Queue 3)."""

import numpy as np
import torch

from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch import serve
from dgvcc_tpu_torch.serve import VideoCounter


def test_auto_without_a_threshold_serves_bf16_at_every_batch():
    assert serve.AUTO_INT8_MIN_BATCH is None
    c = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu", seed=3,
                                     quantize="auto", **TINY_MEM)
    rng = np.random.default_rng(0)
    for b in (1, 4, 16):
        frames = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        assert not c._prefers_int8(frames), b
        c.count_frames(frames)
    assert c.quantized is None and c.dispatches == {"fp": 3, "int8": 0}
