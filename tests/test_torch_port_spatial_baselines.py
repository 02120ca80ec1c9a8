"""Spatial sharding of the convolutional baselines (``mesh: {spatial: N}``
for mcnn, csrnet, bl, sasnet and dssinet: parallel/spatial.py's row rules,
nn/layers.py's sharded resizes, nn/collectives.py's halo past the nearest
neighbour, losses/bayesian.py on a rank's rows) against one process on
the CPU, in float32.

The port runs as 2 gloo ranks and as 4, each group spawned once for the
file (the rank side is tests/test_torch_port_spatial_baselines_ranks.py,
which imports no JAX). Each family takes a crop that meets its row rule at
4 ranks: 64 (mcnn with ``downsample: 4`` as tests/test_spatial.py runs it,
csrnet at 8, bl, dssinet), 128 for sasnet (``block_size`` 32: 32 rows a
rank), two crops a batch (sasnet and dssinet one). Weights are made with
numpy from a seed and reach the port through nn/convert.py. Tolerances, as
the largest absolute difference over the largest absolute reference value:

  * the sharded layers alone (the align_corners x2 resize, the half-pixel
    x2 and x0.5 resizes, sasnet's cell pooling, 7x7 and 9x9 convolutions
    on shards of 2 rows, whose halos reach two ranks away) against the
    whole tensor: output and input gradient 1e-6;
  * the Bayesian loss on a rank's rows against the whole prediction: the
    loss 1e-6, the gradient of each rank's rows 1e-6 once divided by N (each
    rank backpropagates the whole loss; the step's mean over the ranks
    divides the N back out);
  * each family's eval forward on sharded rows against one process (run
    with one thread, as each rank runs): 1e-5. Not 1e-6: the CPU's float32
    convolutions round differently at another shape, and one process's own
    forward of a crop moves by up to 2.4e-6 between a batch of 1 and of 2,
    on one thread (csrnet; dssinet 2.0e-6, bl 1.6e-6).

The first step against JAX's is in
tests/test_torch_port_spatial_baselines_steps.py, the trainer, the
refusals and the row rules in tests/test_torch_port_spatial_baselines_trainer.py,
serving in tests/test_torch_port_spatial_baselines_serve.py.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.losses  # noqa: F401
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.parallel import launch
from test_torch_port_helpers import close, randomize
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_spatial_baselines_ranks import layer_fns, one_thread, run_cases

WORLDS = (2, 4)
# family -> (crop, the target's downsample (None: the Bayesian loss), batch):
# sasnet (at 128^2) and dssinet (whose pyramid runs at 2x) take one crop,
# the costliest steps of these files
FAMILIES = {"mcnn": (64, 4, 2), "csrnet": (64, 8, 2), "bl": (64, None, 2),
            "sasnet": (128, 1, 1), "dssinet": (64, 1, 1)}
BL_LOSS = {"sigma": 8.0, "c_size": 64, "stride": 8, "background_ratio": 0.15,
           "use_background": True}


def _pair(name, seed):
    """(JAX model, its seeded variables, the port's state_dict of them)."""
    jm = JAX_MODELS.build(name)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    v = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), unfreeze(shapes))
    params = randomize(unfreeze(v["params"]), rng)
    stats = randomize(unfreeze(v.get("batch_stats", {})), rng)
    pm = MODELS.build(name)
    sd = state_dict_from_flax(pm, params, stats)
    return jm, {"params": params, "batch_stats": stats}, sd


def _batch(name, seed):
    crop, ds, b = FAMILIES[name]
    rng = np.random.default_rng(seed)
    batch = {"img1": rng.uniform(-1, 1, (b, crop, crop, 3)).astype(np.float32)}
    if ds is None:  # seeded points, the second image without one
        n = 12
        batch["points"] = rng.uniform(-4, crop + 4, (b, n, 2)).astype(np.float32)
        batch["pt_mask"] = np.zeros((b, n), bool)
        batch["pt_mask"][0, :9] = True
        batch["targets"] = (rng.uniform(0.3, 1.0, (b, n)) * batch["pt_mask"]).astype(np.float32)
        batch["st_sizes"] = rng.uniform(crop, 2 * crop, b).astype(np.float32)
    else:
        side = crop // ds
        batch["dmap"] = rng.uniform(0, 0.01, (b, side, side, 1)).astype(np.float32)
    return batch


def _loss(name):
    return ({"name": "bl", "params": BL_LOSS} if FAMILIES[name][1] is None
            else {"name": "mse", "params": {}})


def family(name):
    """A family's seeded JAX model and variables, and the port's side: its
    state_dict of them, its batch, loss and log_para."""
    seed = list(FAMILIES).index(name)
    jm, variables, sd = _pair(name, 30 + seed)
    return {"jax": (jm, variables),
            "port": {"name": name, "params": {}, "state_dict": sd,
                     "batch": _batch(name, 40 + seed), "loss": _loss(name),
                     "log_para": 1.0 if name == "bl" else 1000.0}}


@pytest.fixture(scope="module")
def families():
    return {name: family(name) for name in FAMILIES}


def layer_spec(seed=3, b=2, c=3, h=8, w=10):
    """Seeded inputs of the layer case: x (2 rows a rank at 4 ranks), the
    convolutions' weights, each output's weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    weights = {f"conv{k}": {"weight": torch.from_numpy(
        (0.2 * rng.normal(size=(3, c, k, k))).astype(np.float32)),
        "bias": torch.from_numpy((0.1 * rng.normal(size=3)).astype(np.float32))}
        for k in (7, 9)}
    shapes = {n: fn(torch.from_numpy(x), weights).shape for n, fn in layer_fns().items()}
    return {"x": x, "weights": weights,
            "w": {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}}


def bayes_spec(seed=5, h=8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8 * h + 8, (3, 16, 2)).astype(np.float32)
    mask = np.zeros((3, 16), bool)
    mask[0, :16], mask[1, :3] = True, True
    return {"points": pts, "pt_mask": mask,
            "targets": (rng.uniform(0.3, 1.0, (3, 16)) * mask).astype(np.float32),
            "st_sizes": rng.uniform(8 * h, 16 * h, 3).astype(np.float32),
            "pred": rng.uniform(0, 0.05, (3, 1, h, h)).astype(np.float32),
            "params": dict(BL_LOSS, c_size=8 * h)}


@pytest.fixture(scope="module")
def ranks(families, tmp_path_factory):
    """The cases of each group size, 2 ranks and 4, one launch each."""
    fams = {k: v["port"] for k, v in families.items()}
    out = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"spb_ranks{world}")
        spec_file(str(work), {"layers": ("layers", layer_spec()),
                              "bayes": ("bayes", bayes_spec()),
                              "forward": ("forward", {"families": fams})})
        launch.run_ranks(run_cases, world, (str(work),), init_file=str(work / "init"),
                         timeout=600)
        out[world] = results(str(work), world)
        shutil.rmtree(work)  # the weights, a few hundred MB a group
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["ac_up2", "up2", "down2", "cells", "conv7", "conv9"])
def test_sharded_layers_match_the_whole_tensor(name, world, ranks):
    """Each rank's rows of the output and of the input gradient of
    sum(y * w), concatenated, against the layer on the whole tensor."""
    spec = layer_spec()
    x = torch.from_numpy(spec["x"]).requires_grad_()
    with one_thread():
        y = layer_fns()[name](x, spec["weights"])
        (y * torch.from_numpy(spec["w"][name])).sum().backward()
    parts = [r["layers"][name] for r in ranks[world]]
    close(torch.cat([p["y"] for p in parts], dim=2), y.detach().numpy(), 1e-6, f"{name} y")
    close(torch.cat([p["dx"] for p in parts], dim=2), x.grad.numpy(), 1e-6, f"{name} dx")


@pytest.mark.parametrize("world", WORLDS)
def test_the_bayesian_loss_on_a_ranks_rows_is_the_whole_loss(world, ranks):
    spec = bayes_spec()
    pred = torch.from_numpy(spec["pred"]).requires_grad_()
    loss = LOSSES.build("bl", **spec["params"])(
        *(torch.from_numpy(spec[k]) for k in ("points", "pt_mask", "targets", "st_sizes")), pred)
    loss.backward()
    for r in ranks[world]:
        close(r["bayes"]["loss"], loss.detach().numpy(), 1e-6, "loss")
    grad = torch.cat([r["bayes"]["grad"] for r in ranks[world]], dim=2) / world
    close(grad, pred.grad.numpy(), 1e-6, "d loss / d pred")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_on_sharded_rows_matches_one_process(name, world, families, ranks):
    fam = families[name]["port"]
    model = MODELS.build(name)
    model.load_state_dict(fam["state_dict"], strict=True)
    with torch.no_grad(), one_thread():
        want = model.eval()(torch.from_numpy(fam["batch"]["img1"].transpose(0, 3, 1, 2).copy()))
    got = torch.cat([r["forward"][name] for r in ranks[world]], dim=2)
    close(got, want.numpy(), 1e-5, name)
