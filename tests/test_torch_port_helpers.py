"""Shared set-up of the port's parity tests (this module holds no tests):
one JAX DGModel and its port twin with the same seeded weights, and the
time limit of a test that starts process workers.

Weights come from numpy (``np.random.default_rng``), go into the JAX
variables, and reach the port through its own bridge
(``dgvcc_tpu_torch.nn.convert.dg_state_dict_from_flax``). Batch-norm
statistics are random too, so no BN is an identity.
"""

import contextlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import unfreeze

import dgvcc_tpu.models  # noqa: F401  (registers the JAX variants)
import dgvcc_tpu_torch.models  # noqa: F401  (registers the port's)
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.core.registry import MODELS as PORT_MODELS
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax

VARIANTS = ("base", "mem", "memadd", "cls", "memcls", "final")


def randomize(tree, rng):
    """Seeded values for every leaf of a flax params / batch_stats tree:
    He-normal kernels, small biases, BN scale in [0.5, 1.5], running
    mean N(0, 0.1), running var in [0.5, 2], a standard-normal bank."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = randomize(leaf, rng)
            continue
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name == "mem":
            v = rng.normal(0, 1, shape)
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        out[name] = v.astype(np.float32)
    return out


def jax_variables(model, rng, hw=(64, 64)):
    v = model.init({"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)},
                   jnp.zeros((1,) + tuple(hw) + (3,), jnp.float32))
    return (randomize(unfreeze(v["params"]), rng),
            randomize(unfreeze(v.get("batch_stats", {})), rng))


def dg_pair(variant, seed=0, fused_mem=False, geometry=TINY_MEM):
    """(jax_model, jax_variables, port_model) with identical f32 weights."""
    rng = np.random.default_rng(seed)
    jm = JAX_MODELS.build(variant, **geometry)
    params, stats = jax_variables(jm, rng)
    pm = PORT_MODELS.build(variant, fused_mem=fused_mem, **geometry)
    pm.load_state_dict(dg_state_dict_from_flax(
        params, stats, geometry.get("stage_splits", (0, 23, 33, 43))),
        strict=True)
    return jm, {"params": params, "batch_stats": stats}, pm.eval()


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy().transpose(0, 2, 3, 1)


POOL_SECONDS = 120  # the time limit of a test that starts process workers


@contextlib.contextmanager
def time_limit(seconds=POOL_SECONDS):
    """Raise TimeoutError in the test (its main thread) if it runs longer
    than ``seconds``, so a stuck worker pool cannot hang the test run."""
    def expire(signum, frame):
        raise TimeoutError(f"the test ran longer than {seconds} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
