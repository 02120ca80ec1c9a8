"""Shared set-up of the port's parity tests (this module holds no tests):
one JAX DGModel and its port twin with the same seeded weights, and the
time limit of a test that starts process workers.

The whitening family's tests share ``randomize_whitening``,
``variable_shapes``, ``close`` and ``close_grads``.

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


# ---- the whitening family's tests

def close(got, want, rel, what="", floor=1e-30):
    """max |got - want| <= rel * max(max |want|, floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: max |diff| / max |want| = {err:.3e} > {rel}"


def randomize_whitening(tree, rng):
    """Seeded leaves: He-normal kernels, small biases, norm scales and SW
    affine weights in [0.5, 1.5], BN variances in [0.5, 2], SW mix logits
    N(0, 0.5), SPD SW running covariances."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_whitening(v, rng)
            continue
        s = tuple(v.shape)
        if k == "kernel":
            a = rng.normal(0, np.sqrt(2.0 / np.prod(s[:-1])), s)
        elif k in ("scale", "weight"):
            a = rng.uniform(0.5, 1.5, s)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, s)
        elif k == "running_cov":
            g, c, _ = s
            m = rng.normal(0, 1, (g, c, 2 * c))
            a = 0.5 * m @ m.transpose(0, 2, 1) / (2 * c) + 0.5 * np.eye(c)
        elif k.startswith("sw_"):
            a = rng.normal(0, 0.5, s)
        else:  # bias, mean, running_mean
            a = rng.normal(0, 0.1, s)
        out[k] = a.astype(np.float32)
    return out


def variable_shapes(module, x, **kw):
    """The shapes of a module's variables (``randomize_whitening`` fills them)."""
    v = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                           jnp.asarray(x), **kw))
    return unfreeze(v.get("params", {})), unfreeze(v.get("batch_stats", {}))


def close_grads(model, want_grads, rel):
    """Every parameter's gradient within ``rel`` in relative norm (against
    1e-3 of the largest gradient norm at least)."""
    floor = 1e-3 * max(float(v.norm()) for v in want_grads.values())
    for name, p in model.named_parameters():
        want = want_grads[name].float()
        err = float((p.grad - want).norm()) / max(float(want.norm()), floor)
        assert err <= rel, f"d{name}: ||diff|| / ||want|| = {err:.3e} > {rel}"


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
