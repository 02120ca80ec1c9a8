"""Serving on a mesh (dgvcc_tpu_torch/serve.py with ``mesh`` / ``shard``,
parallel/serving.py, nn/quant.py's spatial sites) against the JAX package's
mesh counter on the CPU, in float32.

The port runs as 2 gloo ranks, spawned once for the file (the rank side is
tests/test_torch_port_serve_mesh_ranks.py, which imports no JAX); every
rank counts the same frames and must return the whole batch's counts. The
JAX side is ``dgvcc_tpu.serve.VideoCounter`` with ``make_mesh(2)`` on the
suite's virtual CPU devices, as tests/test_serve_mesh.py runs it. ``final``
is at the tiny geometry (TINY_MEM) and ``mcnn`` is the family outside the
DG family; weights are made with numpy from a seed and reach the port
through nn/convert.py. Frames: B=4 and a ragged B=3 for the batch shard;
a whole 100x96 frame and an odd B=3 of 72x80 (padded to 128 rows in both
packages: lcm(64, N) and lcm(64, 16 N) are both 64; rank 1's rows hold the
padding, which its mask must drop at their offset) and a tiled B=2 of
180x180 (3x3 = 9 tiles of 64, T not divisible by N) for the spatial shard.
Tolerances, relative:

  * counts against the JAX mesh counter and the JAX one-device counter, and
    against the port's own one-process counts: 1e-4 (float32 forwards, sums
    in another order);
  * an int8 artifact (``save_quantized`` of the port) served batch-sharded
    and spatially against the port's one-process artifact counts: 1e-5 (the
    int8 sites and the bank act per output row on equal inputs; only the
    order of the final sum differs);
  * every rank's calibration scales equal rank 0's, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import dgvcc_tpu.models  # noqa: F401
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.parallel import make_mesh
from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.nn.convert import state_dict_from_flax
from dgvcc_tpu_torch.nn.quant_io import save_quantized
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_helpers import dg_pair, randomize
from test_torch_port_parallel_ranks import results, spec_file
from test_torch_port_serve_mesh_ranks import run_cases

TOL = dict(rtol=1e-4, atol=1e-6)
INT8_TOL = dict(rtol=1e-5, atol=1e-7)
TILES = dict(tile_size=64, tile_threshold=96)
WORLD = 2
BATCH_SETS = ("b4", "b3")
SPATIAL_SETS = ("whole", "odd", "tiled")
DISPATCH_SHAPES = ((4, 64, 96), (3, 72, 80), (1, 100, 96), (2, 180, 180), (3, 100, 200))


def _frames():
    rng = np.random.default_rng(20)

    def f(*shape):
        return rng.integers(0, 256, shape + (3,), dtype=np.uint8)

    return {"b4": f(4, 64, 96), "b3": f(3, 64, 96), "whole": f(1, 100, 96),
            "odd": f(3, 72, 80), "tiled": f(2, 180, 180)}


def _mcnn_pair(seed=1):
    jm = JAX_MODELS.build("mcnn")
    rng = np.random.default_rng(seed)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = randomize(unfreeze(v["params"]), rng)
    stats = randomize(unfreeze(v.get("batch_stats", {})), rng)
    pm = MODELS.build("mcnn")
    pm.load_state_dict(state_dict_from_flax(pm, params, stats), strict=True)
    return jm, {"params": params, "batch_stats": stats}, pm.eval()


@pytest.fixture(scope="module")
def pairs():
    jm, variables, pm = dg_pair("final", seed=9)
    return {"final": (jm, variables, pm, "final", dict(TINY_MEM)),
            "mcnn": _mcnn_pair() + ("mcnn", {})}


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def artifact(pairs, frames, tmp_path_factory):
    """The port's int8 graph of ``final`` (f32, calibrated on the B=4
    frames) saved as an artifact, and its one-process counts."""
    _, _, pm, _, params = pairs["final"]
    built = VideoCounter(pm, dtype=torch.float32, device="cpu", quantize=True,
                         calib_frames=frames["b4"])
    path = str(tmp_path_factory.mktemp("int8") / "final.int8")
    save_quantized(built.quantized, path, "final", params)
    one = VideoCounter.from_artifact(path, dtype=torch.float32, device="cpu", **TILES)
    return path, {k: one.count_frames(frames[k]) for k in ("b4", "whole", "odd")}, \
        built.quantized.scales


@pytest.fixture(scope="module")
def ranks(pairs, frames, artifact, tmp_path_factory):
    """Every case on 2 ranks, one launch for the file."""
    work = tmp_path_factory.mktemp("serve_mesh")
    families = {k: (name, params, {n: t.clone() for n, t in pm.state_dict().items()})
                for k, (_, _, pm, name, params) in pairs.items()}
    base = {"families": families, "tiles": TILES, "frames": frames}
    runs = [("final", "batch", BATCH_SETS), ("mcnn", "batch", BATCH_SETS),
            ("final", "spatial", SPATIAL_SETS)]
    spec_file(str(work), {
        "counts": ("counts", dict(base, runs=runs)),
        "int8": ("int8", dict(base, artifact=artifact[0], sets=("b4", "whole", "odd"))),
        "dispatch": ("dispatch", dict(base, shapes=DISPATCH_SHAPES))})
    launch.run_ranks(run_cases, WORLD, (str(work),), init_file=str(work / "init"),
                     timeout=300)
    return results(str(work), WORLD)


@pytest.fixture(scope="module")
def jax_counts(pairs, frames):
    """The JAX package's counts: one device, and the 2-device mesh of each
    shard, by (family, shard or 'one', frame set)."""
    out = {}
    mesh = make_mesh(WORLD)
    for family, shard, sets in (("final", "batch", BATCH_SETS), ("mcnn", "batch", BATCH_SETS),
                                ("final", "spatial", SPATIAL_SETS)):
        jm, variables = pairs[family][:2]
        one = JaxCounter(jm, variables, dtype=jnp.float32, **TILES)
        sharded = JaxCounter(jm, variables, dtype=jnp.float32, mesh=mesh, shard=shard,
                             **TILES)
        for key in sets:
            out[family, "one", key] = np.asarray(one.count_frames(frames[key]))
            out[family, shard, key] = np.asarray(sharded.count_frames(frames[key]))
    return out


@pytest.mark.parametrize("family,shard,key", [
    ("final", "batch", "b4"), ("final", "batch", "b3"), ("mcnn", "batch", "b4"),
    ("mcnn", "batch", "b3"), ("final", "spatial", "whole"), ("final", "spatial", "odd"),
    ("final", "spatial", "tiled")])
def test_mesh_counts_match_the_jax_mesh_and_one_device(ranks, jax_counts, pairs, frames,
                                                        family, shard, key):
    """Each rank's counts, count_frames and streamed, against the JAX mesh
    counter's, the JAX one-device counter's and the port's one process."""
    pm = pairs[family][2]
    one = VideoCounter(pm, dtype=torch.float32, device="cpu", **TILES).count_frames(
        frames[key])
    for r in ranks:
        for got in (r["counts"][family, shard, key], r["counts"][family, shard, key, "stream"]):
            assert got.shape == (len(frames[key]),) and np.isfinite(got).all()
            np.testing.assert_allclose(got, jax_counts[family, shard, key], **TOL)
            np.testing.assert_allclose(got, jax_counts[family, "one", key], **TOL)
            np.testing.assert_allclose(got, one, **TOL)


def test_spatial_refuses_a_family_outside_the_dg_family(ranks):
    """CCTrans's rows do not shard yet (the convolutional baselines' do:
    tests/test_torch_port_spatial_baselines_serve.py)."""
    for r in ranks:
        assert "'ALTGVT'" in r["counts"]["refused"]
        assert "ROADMAP.md, Queue 1 item 1" in r["counts"]["refused"]


def test_spatial_refuses_a_baselines_int8_graph(pairs, frames):
    """CCTrans's int8 graph (a ``QuantizedConvNet`` without a row rule) has
    no rows to shard: refused with the same pointer, before the mesh is
    read."""
    from dgvcc_tpu_torch.nn.quant import QuantizedConvNet, build_quantized
    from test_torch_port_serve_mesh_ranks import TINY_CCTRANS

    calib = (frames["b4"][:, :, :64].astype(np.float32) / 255.0 - 0.5) / 0.5
    graph = build_quantized(MODELS.build("cctrans", **TINY_CCTRANS).eval(), calib,
                            dtype=torch.float32, device="cpu")
    assert isinstance(graph, QuantizedConvNet) and graph.row_rule is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 1"):
        VideoCounter(None, quantized=graph, mesh=object(), shard="spatial", device="cpu")


@pytest.mark.parametrize("shard", ["batch", "spatial"])
def test_int8_artifact_on_the_mesh_matches_one_process(ranks, artifact, shard):
    _, want, _ = artifact
    for r in ranks:
        for key, w in want.items():
            got = r["int8"][shard, key]
            assert got.shape == w.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, w, **INT8_TOL)


def test_every_rank_takes_rank_0s_scales(ranks, artifact):
    """Calibration on the mesh, at construction and lazily on the first
    batch: every rank holds rank 0's scales exactly, and they are the one
    process's on the same frames (1e-6: this process runs more threads)."""
    scales = [r["int8"]["scales"] for r in ranks]
    for s in scales[1:]:
        assert s == scales[0]
    want = artifact[2]
    for got in scales[0].values():
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-6)


def test_dispatch_batch_is_the_jax_counters(ranks, pairs):
    """quantize="auto"'s per-rank dispatch batch under an integer
    auto_threshold, padded and tiled, batch and spatial."""
    jm, variables = pairs["final"][:2]
    mesh = make_mesh(WORLD)
    for shard in ("batch", "spatial"):
        jc = JaxCounter(jm, variables, dtype=jnp.float32, mesh=mesh, shard=shard, **TILES)
        for shape in DISPATCH_SHAPES:
            want = jc._dispatch_batch(np.zeros(shape + (3,), np.uint8))
            assert [r["dispatch"][shard, shape] for r in ranks] == [want] * WORLD, (shard,
                                                                                   shape)
