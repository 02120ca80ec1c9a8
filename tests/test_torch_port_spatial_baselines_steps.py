"""The first spatial step of the convolutional baselines (``mesh:
{spatial: N}`` for mcnn, csrnet, bl, sasnet and dssinet, mode simple)
against the JAX package's one-device step on the CPU, in float32.

The port runs as 2 gloo ranks and as 4, each group spawned once for the
file (the rank side is tests/test_torch_port_spatial_baselines_ranks.py,
which imports no JAX), at tests/test_torch_port_spatial_baselines.py's
crops and seeded weights (``family``): mcnn, csrnet and bl here, sasnet and
dssinet in tests/test_torch_port_spatial_baselines_steps_deep.py, which
shares this file's helpers. SGD at lr 5e-5 (the ranks'
``SGD``): the MSE, and for bl the Bayesian loss with seeded points and an
image without a point, whose expected counts each rank sums over the group.
Tolerances, as the largest absolute difference over the largest absolute
reference value:

  * against JAX's one-device step: loss parts 1e-5, parameters after the
    step 1e-4 (the port's own one-process step is up to 6.4e-5 from it,
    bl's second block, through ReLU kinks);
  * against the port's one-process step (one thread, as each rank runs):
    loss parts 1e-6, parameters 1e-5;
  * every rank holds the same model.

A gradient N times too large or too small (the Bayesian loss's trap)
moves bl's parameters by (N - 1) times the step, 2.6% of the largest.
"""

import shutil

import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze

from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu.train.optim import build_optimizer
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_train_step
from test_torch_port_helpers import close
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_spatial_baselines import WORLDS, family
from test_torch_port_spatial_baselines_ranks import SGD, one_thread, run_cases


STEP_FAMILIES = ("mcnn", "csrnet", "bl")


def rank_steps(fams, tmp_path_factory, tag):
    """Each family's first step on 2 ranks and on 4, one launch each."""
    spec = {k: v["port"] for k, v in fams.items()}
    out = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"{tag}{world}")
        spec_file(str(work), {"step": ("step", {"families": spec})})
        launch.run_ranks(run_cases, world, (str(work),), init_file=str(work / "init"),
                         timeout=600)
        out[world] = results(str(work), world)
        shutil.rmtree(work)  # the weights, a few hundred MB a group
    return out


def jax_step(fam):
    """JAX's first one-device step (SGD, mode simple) of a family:
    (metrics, the port state_dict after it); kept in ``fam``."""
    if "jax_step" not in fam:
        fam["jax_step"] = _jax_step(fam)
    return fam["jax_step"]


def _jax_step(fam):
    jm, variables = fam["jax"]
    spec = fam["port"]
    loss = JAX_LOSSES.build(spec["loss"]["name"], **spec["loss"]["params"])
    step = jax.jit(jsteps.build_train_step(jm, loss, "simple", spec["log_para"]))
    tx = build_optimizer(SGD)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in spec["batch"].items()},
                          jax.random.PRNGKey(0), jnp.int32(0))
    state = jax.device_get(state)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_flax(MODELS.build(spec["name"]), unfreeze(state.params),
                                 unfreeze(state.batch_stats)))


def port_step(fam):
    """The port's first one-process step of a family (one thread):
    (metrics, the state_dict after it); kept in ``fam``."""
    if "port_step" not in fam:
        fam["port_step"] = _port_step(fam)
    return fam["port_step"]


def _port_step(fam):
    spec = fam["port"]
    model = MODELS.build(spec["name"])
    model.load_state_dict(spec["state_dict"], strict=True)
    state = create_train_state(model, SGD, device="cpu")
    step = build_train_step(model, LOSSES.build(spec["loss"]["name"], **spec["loss"]["params"]),
                            "simple", spec["log_para"])
    batch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy() if v.ndim == 4 else v)
             for k, v in spec["batch"].items()}
    with one_thread():
        _, metrics = step(state, batch, None, 0)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in model.state_dict().items()})


def hold_against_jax(got_ranks, name, want):
    """The ranks' first step against JAX's one-device step: the loss parts
    and the parameters (bl: through the Bayesian loss, whose expected
    counts sum over the ranks). Every rank holds the same model."""
    metrics, sd = want
    got = got_ranks[0]["step"][name]
    assert set(got["metrics"]) == set(metrics)
    for k, v in metrics.items():
        close(got["metrics"][k], v, 1e-5, k)
    for k, _ in MODELS.build(name).named_parameters():
        close(got["state_dict"][k], sd[k].numpy(), 1e-4, k)
    assert {r["step"][name]["digest"] for r in got_ranks} == {got["digest"]}


def hold_against_one_process(got_ranks, name, want):
    metrics, sd = want
    got = got_ranks[0]["step"][name]
    for k, v in metrics.items():
        close(got["metrics"][k], v, 1e-6, k)
    for k, v in sd.items():
        if v.is_floating_point():
            close(got["state_dict"][k], v.numpy(), 1e-5, k)


@pytest.fixture(scope="module")
def fams():
    return {name: family(name) for name in STEP_FAMILIES}


@pytest.fixture(scope="module")
def ranks(fams, tmp_path_factory):
    return rank_steps(fams, tmp_path_factory, "spb_steps")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_first_spatial_step_matches_the_jax_one_device_step(name, world, fams, ranks):
    hold_against_jax(ranks[world], name, jax_step(fams[name]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_first_spatial_step_matches_the_ports_one_process_step(name, world, fams, ranks):
    hold_against_one_process(ranks[world], name, port_step(fams[name]))
