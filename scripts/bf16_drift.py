"""bf16 against float32 drift of a regressor's or a classic baseline's
counts, in the JAX package and in the port, with the same weights, on the
CPU.

    JAX_PLATFORMS=cpu python scripts/bf16_drift.py reg --hw 768 1024 --frames 4
    JAX_PLATFORMS=cpu python scripts/bf16_drift.py sasnet --hw 384 512 --frames 2

Weights: He-normal convolutions and dense layers (numpy seed 10), zero
biases, unit batch and layer norm, PReLU slopes 0.25 and a standard-normal
bank, as the port's ``reset_parameters`` draws them; or, with ``--port-seed
N``, the port model's own ``reset_parameters`` at torch seed N (the weights
``chip_smoke.py`` serves), read into the JAX model by the JAX package's
reference-checkpoint reader; the JAX variables reach the port through ``nn/convert.py``. Frames:
uint8 from numpy seed 10, normalised as ``VideoCounter`` does. For each
frame it prints |count(bf16) - count(f32)| over the map's mass
sum(|d_f32|), for the served density (the first output) and, for ``reg``,
its ungated density ``d`` (the second): the served count moves where a
binarised classifier block flips between the two precisions.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _init(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _init(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            a = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif k in ("scale", "var"):
            a = np.ones(shape)
        elif k == "alpha":
            a = np.full(shape, 0.25)
        elif k == "mem":
            a = rng.normal(0, 1, shape)
        else:
            a = np.zeros(shape)
        out[k] = a.astype(np.float32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=["dgnet", "dgnet_cls", "reg", "reg_mem", "csrnet", "mcnn",
                                       "bl", "sasnet", "dssinet", "cctrans"])
    ap.add_argument("--hw", type=int, nargs=2, default=(768, 1024))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--port-seed", type=int, default=None,
                    help="the port's reset_parameters at this seed (families the JAX "
                         "package's reference reader takes)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import torch
    from flax.core import unfreeze

    import dgvcc_tpu.models  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.nn.convert import state_dict_from_flax

    name, (h, w) = args.family, args.hw
    jm32, jm16 = JAX_MODELS.build(name), JAX_MODELS.build(name, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm32.init({"params": jax.random.PRNGKey(0),
                                               "dropout": jax.random.PRNGKey(1)},
                                              jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(10)
    params = _init(unfreeze(shapes["params"]), rng)
    stats = _init(unfreeze(shapes.get("batch_stats", {})), rng)
    if args.port_seed is not None:
        from dgvcc_tpu.nn.torch_io import load_reference_checkpoint

        pm = MODELS.build(name)
        pm.reset_parameters(torch.Generator().manual_seed(args.port_seed))
        sd = {k: v.numpy() for k, v in pm.state_dict().items()}
        v = load_reference_checkpoint({"params": params, "batch_stats": stats}, sd, jm32)
        params, stats = unfreeze(v["params"]), unfreeze(v.get("batch_stats", {}))
    frames = np.random.default_rng(10).integers(0, 256, (args.frames, h, w, 3), dtype=np.uint8)
    x = (frames.astype(np.float32) / 255.0 - 0.5) / 0.5
    outputs = [0, 1] if name == "reg" else [0]

    def pick(out, i):
        out = out[i] if isinstance(out, (tuple, list)) else out
        return out[0] if isinstance(out, (tuple, list)) else out

    maps = {}
    for tag, m, dt in (("jax f32", jm32, jnp.float32), ("jax bf16", jm16, jnp.bfloat16)):
        out = jax.jit(lambda v, xx, m=m: m.apply(v, xx))({"params": params, "batch_stats": stats},
                                                         jnp.asarray(x, dt))
        maps[tag] = [np.asarray(pick(out, i), np.float32).transpose(0, 3, 1, 2) for i in outputs]
    for tag, dt in (("port f32", torch.float32), ("port bf16", torch.bfloat16)):
        pm = MODELS.build(name, dtype=dt)
        pm.load_state_dict(state_dict_from_flax(pm, params, stats), strict=True)
        with torch.no_grad():
            out = pm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(dt))
        maps[tag] = [pick(out, i).float().numpy() for i in outputs]
    for i, label in zip(outputs, ("served density", "ungated density d")):
        mass = np.abs(maps["jax f32"][i]).sum(axis=(1, 2, 3))
        for a, b in (("jax bf16", "jax f32"), ("port bf16", "port f32"),
                     ("port bf16", "jax bf16"), ("port f32", "jax f32")):
            diff = np.abs(maps[a][i].sum(axis=(1, 2, 3)) - maps[b][i].sum(axis=(1, 2, 3)))
            print(f"{name} {h}x{w} {label}: {a} vs {b}: |dcount| / mass per frame "
                  f"{np.round(diff / mass, 5).tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
