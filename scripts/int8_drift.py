"""int8 against bf16 drift of served counts in the JAX package, with the
weights the port serves, on the CPU: the gate chip_smoke.py phase 14 holds
the port's int8 serving to.

    JAX_PLATFORMS=cpu python scripts/int8_drift.py final --hw 256 384 --frames 2
    JAX_PLATFORMS=cpu python scripts/int8_drift.py csrnet --port-seed 11 --hw 256 384
    JAX_PLATFORMS=cpu python scripts/int8_drift.py bl --sensitivity --hw 32 48
    JAX_PLATFORMS=cpu python scripts/int8_drift.py cctrans --port-seed 11 --hw 384 512 \
        --frames 4 --calib 8

Weights: the port model's own ``reset_parameters`` at torch seed
``--port-seed`` (the weights chip_smoke.py serves), read into the JAX model
by the JAX package's reference-checkpoint reader. Frames: uint8 from numpy
seed 10; calibration frames: ``--calib`` frames of numpy seed 11 at the
same size, normalised as ``VideoCounter`` does. For each frame it prints
|count(int8) - count(bf16)| over the map's mass sum(|d_bf16|), the mass
floored at one count (``LOG_PARA``, as chip_smoke.py's gate floors it: an
untrained CCTrans's ReLU'd map can be all but empty), of the JAX package's
``build_quantized`` graph (``min_ch`` 128 for the baselines) and, for the DG
family, of its ``weight_only`` graph, both in bf16, against the JAX model's
bf16 forward, and the bf16 counts.

For CCTrans, whose untrained counts are all but zero, it also prints
what phase 14 holds its int8 map by: the head's last site before its ReLU
(``reg_res2``), int8 graph against the bf16 model, as |a - b| / |b| over each
frame's map (L2), and the control: the same int8 map against the next
frame's bf16 map.

``--sensitivity``: the JAX int8 graph's own counts in float32 under
relative input noise of 1e-6 and 1e-5 (numpy seed 9), |dcount| over the
mass: how far rounding-size differences move an untrained int8 graph's
counts (tests/test_torch_port_quant.py).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

LOG_PARA = 1000.0  # the density's sum over one count (every config's log_para)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=["final", "csrnet", "mcnn", "bl", "sasnet", "dssinet",
                                       "cctrans"])
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 384))
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--calib", type=int, default=8)
    ap.add_argument("--port-seed", type=int, default=0)
    ap.add_argument("--sensitivity", action="store_true")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import torch
    from flax.core import unfreeze

    import dgvcc_tpu.models  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
    from dgvcc_tpu.nn import quant as jq
    from dgvcc_tpu.nn.torch_io import load_reference_checkpoint
    from dgvcc_tpu_torch.core.registry import MODELS
    from chip_smoke import rel_l2, without_last_relu

    name, (h, w) = args.family, args.hw
    jm32, jm16 = JAX_MODELS.build(name), JAX_MODELS.build(name, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm32.init({"params": jax.random.PRNGKey(0),
                                               "dropout": jax.random.PRNGKey(1)},
                                              jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), unfreeze(shapes))
    pm = MODELS.build(name)
    pm.reset_parameters(torch.Generator().manual_seed(args.port_seed))
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    variables = load_reference_checkpoint(
        {"params": zeros["params"], "batch_stats": zeros.get("batch_stats", {})}, sd, jm32)

    def norm(u8):
        return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5

    frames = norm(np.random.default_rng(10).integers(0, 256, (args.frames, h, w, 3), np.uint8))
    calib = norm(np.random.default_rng(11).integers(0, 256, (args.calib, h, w, 3), np.uint8))

    def density(out):
        out = out[0] if isinstance(out, (tuple, list)) else out
        return np.asarray(out, np.float32)

    if args.sensitivity:
        q = jq.build_quantized(jm32, variables, calib, dtype=jnp.float32)
        base = density(q(jnp.asarray(frames)))
        mass = np.abs(base).sum(axis=(1, 2, 3))
        for eps in (1e-6, 1e-5):
            noise = np.random.default_rng(9).standard_normal(frames.shape).astype(np.float32)
            moved = density(q(jnp.asarray(frames * (1 + eps * noise))))
            diff = np.abs(moved.sum(axis=(1, 2, 3)) - base.sum(axis=(1, 2, 3)))
            print(f"{name} {h}x{w} jax int8 f32, input noise {eps:g}: |dcount| / mass per "
                  f"frame {np.round(diff / mass, 6).tolist()}")
        return 0

    fp = density(jax.jit(lambda v, x: jm16.apply(v, x))(variables, jnp.asarray(frames,
                                                                              jnp.bfloat16)))
    mass = np.maximum(np.abs(fp).sum(axis=(1, 2, 3)), LOG_PARA)
    graphs = {"int8": jq.build_quantized(jm16, variables, calib, dtype=jnp.bfloat16)}
    if name == "final":
        graphs["weight_only"] = jq.QuantizedDG.from_model(jm16, variables, None,
                                                          dtype=jnp.bfloat16, weight_only=True)
    for label, q in graphs.items():
        got = density(q(jnp.asarray(frames, jnp.bfloat16)))
        diff = np.abs(got.sum(axis=(1, 2, 3)) - fp.sum(axis=(1, 2, 3)))
        print(f"{name} {h}x{w} jax {label} vs jax bf16 (port seed {args.port_seed}, "
              f"{args.calib} calibration frames): |dcount| / mass per frame "
              f"{np.round(diff / mass, 6).tolist()}; bf16 counts "
              f"{np.round(fp.sum(axis=(1, 2, 3)) / LOG_PARA, 4).tolist()}")
    if name == "cctrans":
        x = jnp.asarray(frames, jnp.bfloat16)
        _, st = jax.jit(lambda v, t: jm16.apply(
            v, t, capture_intermediates=lambda m, _: m.name == "res2",
            mutable=["intermediates"]))(variables, x)
        want = np.asarray(st["intermediates"]["regression"]["res2"]["__call__"][0], np.float32)
        q = graphs["int8"]
        q.forward_fn = without_last_relu(q.forward_fn, "reg_res2")
        q._jitted = jax.jit(q._forward)
        got = np.asarray(q(x), np.float32)
        print(f"{name} {h}x{w} jax int8 vs jax bf16, reg_res2 before its ReLU: "
              f"|a - b| / |b| per frame {np.round(rel_l2(got, want), 6).tolist()}; control, "
              f"against the next frame's: "
              f"{np.round(rel_l2(got, np.roll(want, -1, axis=0)), 6).tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
