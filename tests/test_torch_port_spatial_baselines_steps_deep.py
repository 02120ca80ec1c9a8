"""The first spatial step of sasnet (crop 128, 32 rows a rank at 4 ranks)
and dssinet against the JAX package's one-device step and the port's one
process, as tests/test_torch_port_spatial_baselines_steps.py holds mcnn,
csrnet and bl (its helpers, geometry and tolerances), split off to keep
each file's time down: 2 gloo ranks and 4, each group spawned once for the
file.
"""

import pytest

from test_torch_port_spatial_baselines import WORLDS, family
from test_torch_port_spatial_baselines_steps import (hold_against_jax, hold_against_one_process,
                                                     jax_step, port_step, rank_steps)

STEP_FAMILIES = ("sasnet", "dssinet")


@pytest.fixture(scope="module")
def fams():
    return {name: family(name) for name in STEP_FAMILIES}


@pytest.fixture(scope="module")
def ranks(fams, tmp_path_factory):
    return rank_steps(fams, tmp_path_factory, "spb_steps_deep")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_first_spatial_step_matches_the_jax_one_device_step(name, world, fams, ranks):
    hold_against_jax(ranks[world], name, jax_step(fams[name]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_first_spatial_step_matches_the_ports_one_process_step(name, world, fams, ranks):
    hold_against_one_process(ranks[world], name, port_step(fams[name]))
