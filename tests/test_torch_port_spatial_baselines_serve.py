"""Serving the convolutional baselines with ``shard="spatial"``
(dgvcc_tpu_torch/serve.py, nn/quant.py's sharded graphs, the families' row
rules) against one process on the CPU, in float32.

The port runs as 2 gloo ranks and as 4, each group spawned once for the
file (the rank side is tests/test_torch_port_spatial_baselines_ranks.py).
Frames: B=1 of 100x64, padded to 128 rows in one process and on either
mesh (lcm(64, R N) divides 128 for every row rule R), so every rank's
padding rows are the one process's. Weights are seeded He-normal. Each
rank must return the whole batch's counts. Tolerances, relative:

  * counts of the five in float32 against one process: 1e-5; and against
    the JAX package's ``VideoCounter`` with ``shard="spatial"`` on
    ``make_mesh(N)`` (the suite's virtual CPU devices, the port's weights
    read back by the JAX package's checkpoint readers): 1e-4, the bar of
    tests/test_torch_port_serve_mesh.py (float32 forwards of two
    frameworks);
  * the int8 graphs of csrnet, bl, sasnet and dssinet (artifacts
    calibrated on the frames, every site of 128 channels and more in int8):
    counts against one process's 1e-5, and each rank's rows of the density
    against one process's graph on the whole frames: csrnet's and bl's bit
    for bit, sasnet's and dssinet's 1e-6 (their fp sites' CPU convolutions
    round a few outputs differently on a rank's haloed rows, by about
    1e-7, and no int8 input on these frames sits on a rounding boundary).

The one process's references run with one thread, as each rank does: the
CPU kernels round differently with more (a bilinear upsample by an ulp,
which an int8 site's rounding can turn into a step).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.parallel import make_mesh
from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.quant import build_quantized
from dgvcc_tpu_torch.nn.quant_io import save_quantized
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_baselines import READERS
from test_torch_port_helpers import close
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_spatial_baselines_ranks import one_thread, run_cases

WORLDS = (2, 4)
FAMILIES = ("mcnn", "csrnet", "bl", "sasnet", "dssinet")
INT8 = ("csrnet", "bl", "sasnet", "dssinet")
# the graphs whose density rows equal one process's bit for bit
EXACT = ("csrnet", "bl")


def _normalised(frames):
    return (frames.astype(np.float32) / 255.0 - 0.5) / 0.5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The seeded models, the frames, the int8 artifacts, and the one
    process's counts and densities."""
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (1, 100, 64, 3), dtype=np.uint8)
    padded = np.full((1, 128, 64, 3), -1.0, np.float32)
    padded[:, :100] = _normalised(frames)
    tmp = tmp_path_factory.mktemp("spb_serve")
    fams, one, artifacts, one_int8, one_rows = {}, {}, {}, {}, {}
    with one_thread():
        _references(frames, padded, tmp, fams, one, artifacts, one_int8, one_rows)
    return {"frames": frames, "padded": padded, "families": fams, "artifacts": artifacts,
            "one": one, "one_int8": one_int8, "one_rows": one_rows}


def _references(frames, padded, tmp, fams, one, artifacts, one_int8, one_rows):
    for seed, name in enumerate(FAMILIES):
        model = MODELS.build(name)
        model.reset_parameters(torch.Generator().manual_seed(50 + seed))
        fams[name] = {"name": name, "params": {}, "state_dict": model.state_dict()}
        one[name] = VideoCounter(model, dtype=torch.float32, device="cpu").count_frames(frames)
        if name in INT8:
            path = str(tmp / f"{name}.int8")
            save_quantized(build_quantized(model.eval(), padded,
                                           dtype=torch.float32, device="cpu"), path, name, {})
            artifacts[name] = path
            c = VideoCounter.from_artifact(path, dtype=torch.float32, device="cpu")
            one_int8[name] = c.count_frames(frames)
            with torch.inference_mode():
                one_rows[name] = c.quantized(torch.from_numpy(padded))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    out = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"spb_serve{world}")
        spec_file(str(work), {"serve": ("serve", {k: setup[k] for k in (
            "frames", "padded", "families", "artifacts")})})
        launch.run_ranks(run_cases, world, (str(work),), init_file=str(work / "init"),
                         timeout=600)
        out[world] = results(str(work), world)
        shutil.rmtree(work)  # the weights, a few hundred MB a group
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_spatial_counts_match_one_process(name, world, setup, ranks):
    for r in ranks[world]:
        got = r["serve"]["fp"][name]
        assert got.shape == (1,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, setup["one"][name], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_counts(setup):
    """The JAX package's spatial counts, by (family, N)."""
    out = {}
    for name, fam in setup["families"].items():
        params, stats = READERS[name]({k: v.numpy() for k, v in fam["state_dict"].items()})
        for world in WORLDS:
            c = JaxCounter(JAX_MODELS.build(name), {"params": params, "batch_stats": stats},
                           dtype=jnp.float32, mesh=make_mesh(world), shard="spatial")
            out[name, world] = np.asarray(c.count_frames(setup["frames"]))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_spatial_counts_match_the_jax_mesh_counter(name, world, ranks, jax_counts):
    for r in ranks[world]:
        np.testing.assert_allclose(r["serve"]["fp"][name], jax_counts[name, world], rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", INT8)
def test_int8_graph_on_sharded_rows_matches_one_process(name, world, setup, ranks):
    for r in ranks[world]:
        np.testing.assert_allclose(r["serve"]["int8"][name], setup["one_int8"][name], rtol=1e-5)
    rows = torch.cat([r["serve"]["rows"][name] for r in ranks[world]], dim=1)
    want = setup["one_rows"][name]
    if name in EXACT:
        assert torch.equal(rows, want), name
    else:
        close(rows, want.numpy(), 1e-6, name)
