"""Data parallelism of the port (dgvcc_tpu_torch/parallel/, the synced
norms of nn/layers.py and nn/whitening.py, the loader's rank rows) against
the JAX package's ``mesh: {data: N}`` path on the CPU, in float32.

The port runs as 2 gloo ranks (and 4 ranks on 2 "nodes" of 2 for the
several-node data rule), spawned once for the whole file by a module
fixture: every rank-side case runs in one group
(tests/test_torch_port_parallel_ranks.py, which imports no JAX). The JAX
side runs on the suite's virtual CPU devices, a 2-device mesh. Weights are
made with numpy from a seed and reach the port through nn/convert.py;
dropout rates are 0, or the masks are injected in call order.

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result:
  * ``final`` (the second rule: each rank's own batch statistics, running
    statistics averaged after the step) against JAX's DP step: loss parts
    1e-4, parameters after one SGD step 1e-4, running statistics 1e-5;
  * ``sw`` (layers (1, 1, 1)) and ``isw`` with real masks (the first rule:
    statistics averaged in the forward) against JAX's DP step and the JAX
    one-device full-batch step, at JAX's own tolerances
    (tests/test_sync_whitening.py:99-108): loss 1e-4, parameters and
    statistics rtol 5e-4 / atol 5e-6;
  * the synced BatchNorm2d and SwitchWhiten alone against the JAX layer on
    the full batch: output, input gradient and running statistics 1e-5;
  * mode joint against JAX's ``build_parallel_joint_step``: loss parts and
    both models' parameters after SGD 1e-4;
  * accumulation (2 micro steps) against JAX's DP step with
    ``optax.MultiSteps``: 1e-5;
  * ``ShardedTiledCounter`` against JAX's, on an image larger than the tile
    and one smaller: 1e-4;
  * the sampler and the ranks' rows: bit for bit; ``device_aug``'s rows
    5e-6 (the batch's own tolerance, tests/test_torch_port_device_aug.py).
"""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import unfreeze
from PIL import Image

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.models import regressors as jreg
from dgvcc_tpu.models.whitening import ISW_WT_CHANNELS, IswCovTracker
from dgvcc_tpu.nn import layers as jlayers
from dgvcc_tpu.nn.whitening import SwitchWhiten as JaxSwitchWhiten
from dgvcc_tpu.parallel import eval as jeval
from dgvcc_tpu.parallel import mesh as jmesh
from dgvcc_tpu.parallel import multihost as jmultihost
from dgvcc_tpu.testing import TINY_MEM, TINY_VGG, TINY_VGG19
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu.train.optim import build_optimizer
from dgvcc_tpu.train.state import TrainState as JaxTrainState
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.data import datasets as pdatasets
from dgvcc_tpu_torch.data import device_pipeline as dp
from dgvcc_tpu_torch.data.loader import DataLoader
from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax, state_dict_from_flax
from dgvcc_tpu_torch.ops import dmap
from dgvcc_tpu_torch.parallel import launch
from dgvcc_tpu_torch.parallel import multihost as pmultihost
from test_torch_port_helpers import (close, jax_variables, nchw, randomize,
                                     randomize_whitening, variable_shapes)
from test_torch_port_parallel_ranks import results, run_cases, spec_file

SPLITS = TINY_MEM["stage_splits"]
PARITY = dict(TINY_MEM, den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
TINY_GEN = dict(vgg_cfg=TINY_VGG19, enc_stop=9)
TINY_REG_MEM = dict(vgg_cfg=TINY_VGG, stage_splits=(0, 8, 12, 16),
                    dec_widths=((16, 16), (16, 16), (16, 8)), part_num=16, final_dim=16,
                    fused_mem=False)
SGD = {"name": "sgd", "params": {"lr": 0.05}}
B, HW = 4, 32
JAX_TOL = dict(rtol=5e-4, atol=5e-6)  # tests/test_sync_whitening.py:99-108


def _jax_state(params, stats, tx):
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), tx=tx)


def _images(seed, b=B, hw=(HW, HW)):
    rng = np.random.default_rng(seed)
    img1 = rng.normal(size=(b,) + hw + (3,)).astype(np.float32)
    return {"img1": img1,
            "img2": (img1 + 0.5 * rng.normal(size=img1.shape)).astype(np.float32),
            "dmap": rng.uniform(0, 2e-3, (b,) + hw + (1,)).astype(np.float32),
            "bmap": (rng.uniform(size=(b, hw[0] // 16, hw[1] // 16, 1)) > 0.5)
            .astype(np.float32)}


def _final():
    jm = JAX_MODELS.build("final", **PARITY)
    params, stats = jax_variables(jm, np.random.default_rng(40))
    return jm, params, stats


def _whitening(name):
    jm = JAX_MODELS.build(name, layers=(1, 1, 1))
    params, stats = variable_shapes(jm, np.zeros((1, HW, HW, 3), np.float32), train=False)
    rng = np.random.default_rng(50 + len(name))
    params, stats = randomize_whitening(params, rng), randomize_whitening(stats, rng)
    pm = MODELS.build(name, layers=(1, 1, 1))
    return jm, params, stats, pm


def _isw_masks():
    tracker = IswCovTracker()
    rng = np.random.default_rng(5)
    tracker.add({f"m{i}": rng.uniform(size=(c, c)) for i, c in enumerate(ISW_WT_CHANNELS)})
    tracker.set_mask_matrix()
    masks, nums, _ = tracker.mask_batch()
    return ({k: np.array(v) for k, v in masks.items()},
            {k: np.array(v) for k, v in nums.items()})


def _joint_pair(name, seed, geometry, hw):
    jm = JAX_MODELS.build(name, **{k: v for k, v in geometry.items() if k != "fused_mem"})
    rng = np.random.default_rng(seed)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)},
                                       jnp.zeros((1,) + hw + (3,), jnp.float32)))
    params = randomize(unfreeze(v["params"]), rng)
    stats = randomize(unfreeze(v.get("batch_stats", {})), rng)
    pm = MODELS.build(name, **geometry)
    return jm, params, stats, pm


def _layer_inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, 8, 5, 5)) + 0.3).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    bn = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
          "bias": torch.from_numpy(rng.normal(0, 0.1, 8).astype(np.float32))}
    sw = {"sw_mean_weight": torch.from_numpy(rng.normal(0, 0.5, 2).astype(np.float32)),
          "sw_var_weight": torch.from_numpy(rng.normal(0, 0.5, 2).astype(np.float32)),
          "weight": torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
          "bias": torch.from_numpy(rng.normal(0, 0.1, 8).astype(np.float32))}
    return x, w, bn, sw


@pytest.fixture(scope="module")
def jax_inputs():
    """Every case's weights and batches, made once for both frameworks."""
    final = _final()
    whitening = {n: _whitening(n) for n in ("sw", "isw")}
    gen = _joint_pair("gen", 7, TINY_GEN, (64, 64))
    reg = _joint_pair("reg_mem", 8, TINY_REG_MEM, (64, 64))
    images = [np.random.default_rng(s).uniform(-1, 1, hw + (3,)).astype(np.float32)
              for s, hw in ((1, (96, 112)), (2, (48, 40)))]
    counter = JAX_MODELS.build("final", **TINY_MEM)
    counter_vars = jax_variables(counter, np.random.default_rng(24))
    return {"final": final, "whitening": whitening, "gen": gen, "reg": reg,
            "counter": (counter, *counter_vars),
            "batches": [_images(10), _images(11)], "joint_batch": _images(12, hw=(64, 64)),
            "masks": _isw_masks(), "layers": _layer_inputs(), "images": images}


@pytest.fixture(scope="module")
def ranks(jax_inputs, tmp_path_factory):
    """Every 2-rank case in one gloo group; the ranks' results."""
    work = tmp_path_factory.mktemp("ranks2")
    jm, params, stats = jax_inputs["final"]
    final_sd = dg_state_dict_from_flax(params, stats, SPLITS)
    final = {"model": "final", "params": PARITY, "state_dict": final_sd, "mode": "final"}
    cases = {
        "final": ("step", dict(final, batches=jax_inputs["batches"][:1])),
        "accum": ("step", dict(final, batches=jax_inputs["batches"])),
    }
    masks, nums = jax_inputs["masks"]
    for name, (_, wp, ws, pm) in jax_inputs["whitening"].items():
        batch = {k: jax_inputs["batches"][0][k] for k in ("img1", "dmap")}
        spec = {"model": name, "params": {"layers": (1, 1, 1)}, "synced": True,
                "state_dict": state_dict_from_flax(pm, wp, ws), "mode": "simple",
                "batches": [batch]}
        if name == "isw":
            batch.update(isw_masks={k: torch.from_numpy(v) for k, v in masks.items()},
                         isw_nums={k: torch.tensor(float(v)) for k, v in nums.items()})
            spec.update(mode="isw", epoch=6)
        cases[name] = ("step", spec)
    joint = {}
    for key in ("gen", "reg"):
        _, jp, js, pm = jax_inputs[key]
        joint[key] = {"model": "gen" if key == "gen" else "reg_mem",
                      "params": TINY_GEN if key == "gen" else TINY_REG_MEM,
                      "state_dict": state_dict_from_flax(pm, jp, js),
                      "optimizer": {"name": "sgd", "params": {"lr": 0.01}}}
    cases["joint"] = ("joint", dict(joint, batch=jax_inputs["joint_batch"]))
    x, w, bn, sw = jax_inputs["layers"]
    cases["layers"] = ("layers", {"x": x, "w": w, "bn": bn, "sw": sw})
    _, cp, cs = jax_inputs["counter"]
    cases["counter"] = ("counter", {"params": TINY_MEM,
                                    "state_dict": dg_state_dict_from_flax(cp, cs, SPLITS),
                                    "patch_size": 64, "images": jax_inputs["images"]})
    cases["allgather"] = ("allgather", {})
    spec_file(str(work), cases)
    launch.run_ranks(run_cases, 2, (str(work),), init_file=str(work / "init"), timeout=240)
    return results(str(work), 2)


def _flat_sd(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_sd(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _hold_state_dict(got, want, rel_params, rel_stats, params):
    """Each parameter within rel_params, each running statistic within
    rel_stats (relative to the largest JAX value)."""
    assert set(params) <= set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        close(got[k], w.numpy(), rel_params if k in params else rel_stats, k)


def _same_on_every_rank(ranks, key, sd="state_dict"):
    a, b = ranks[0][key][sd], ranks[1][key][sd]
    for k in a:
        assert torch.equal(a[k], b[k]), (key, k)


# ------------------------------------------------------------------ steps

def _jax_dp(jm, params, stats, batches, mode="final", tx=None, epoch=0, extra=None):
    mesh = jmesh.make_mesh(2)
    tx = tx or build_optimizer(SGD)
    step = jmesh.build_parallel_train_step(jm, JAX_LOSSES.build("mse"), mode, 1000.0, mesh,
                                           donate=False)
    state = jmesh.replicate(mesh, _jax_state(params, stats, tx))
    for batch in batches:
        b = jmesh.shard_batch(mesh, {k: v for k, v in batch.items()})
        b.update(extra or {})
        state, metrics = step(state, b, jax.random.PRNGKey(0), jnp.int32(epoch))
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}


def test_final_dp_step_matches_jax(jax_inputs, ranks):
    """The second rule: each rank normalises its rows with their own
    statistics; the gradients and the running statistics are averaged."""
    jm, params, stats = jax_inputs["final"]
    jstate, jmetrics = _jax_dp(jm, params, stats, jax_inputs["batches"][:1])
    got = ranks[0]["final"]
    assert set(got["metrics"]) == set(jmetrics)
    for k, v in jmetrics.items():
        close(got["metrics"][k], v, 1e-4, k)
    pm = MODELS.build("final", **PARITY)
    want = dg_state_dict_from_flax(unfreeze(jstate.params), unfreeze(jstate.batch_stats),
                                   SPLITS)
    before = dg_state_dict_from_flax(params, stats, SPLITS)
    names = [n for n, _ in pm.named_parameters()]
    _hold_state_dict(got["state_dict"], want, 1e-4, 1e-5, names)
    assert all(not torch.equal(got["state_dict"][n], before[n]) for n in names
               if not n.endswith(".bias"))
    _same_on_every_rank(ranks, "final")


def test_accumulation_under_dp_matches_jax_multisteps(jax_inputs, ranks):
    """accum_steps 2: the port all-reduces the window's mean once, JAX each
    micro step's gradient; the update agrees to 1e-5."""
    jm, params, stats = jax_inputs["final"]
    tx = optax.MultiSteps(build_optimizer(SGD), every_k_schedule=2)
    jstate, _ = _jax_dp(jm, params, stats, jax_inputs["batches"], tx=tx)
    want = dg_state_dict_from_flax(unfreeze(jstate.params), unfreeze(jstate.batch_stats),
                                   SPLITS)
    names = [n for n, _ in MODELS.build("final", **PARITY).named_parameters()]
    _hold_state_dict(ranks[0]["accum"]["state_dict"], want, 1e-5, 1e-5, names)
    before = dg_state_dict_from_flax(params, stats, SPLITS)
    assert not torch.equal(ranks[0]["accum"]["state_dict"]["mem"], before["mem"])
    _same_on_every_rank(ranks, "accum")


@pytest.mark.parametrize("name", ["sw", "isw"])
def test_whitening_dp_step_matches_jax_dp_and_the_full_batch(name, jax_inputs, ranks):
    """The first rule: batch norm and SwitchWhiten statistics averaged over
    the ranks in the forward, so the step is the full-batch step."""
    _, params, stats, pm = jax_inputs["whitening"][name]
    mode, epoch, extra = "simple", 0, {}
    batch = {k: jax_inputs["batches"][0][k] for k in ("img1", "dmap")}
    if name == "isw":
        masks, nums = jax_inputs["masks"]
        mode, epoch = "isw", 6
        extra = {"isw_masks": {k: jnp.asarray(v) for k, v in masks.items()},
                 "isw_nums": {k: jnp.asarray(v) for k, v in nums.items()}}
    synced = JAX_MODELS.build(name, layers=(1, 1, 1), axis_name=jmesh.DATA_AXIS)
    dp_state, dp_metrics = _jax_dp(synced, params, stats, [batch], mode, epoch=epoch,
                                   extra=extra)
    plain = JAX_MODELS.build(name, layers=(1, 1, 1))
    tx = build_optimizer(SGD)
    single = jax.jit(jsteps.build_train_step(plain, JAX_LOSSES.build("mse"), mode, 1000.0))
    full = {k: jnp.asarray(v) for k, v in batch.items()}
    full.update(extra)
    s_state, s_metrics = single(_jax_state(params, stats, tx), full, jax.random.PRNGKey(0),
                                jnp.int32(epoch))
    got = ranks[0][name]
    if name == "isw":
        assert got["metrics"]["loss_wt"] > 0.0  # the whitening loss is on
    for jstate, jmetrics in ((dp_state, dp_metrics), (jax.device_get(s_state), s_metrics)):
        assert got["metrics"]["loss_total"] == pytest.approx(float(jmetrics["loss_total"]),
                                                             rel=1e-4)
        want = state_dict_from_flax(pm, unfreeze(jstate.params), unfreeze(jstate.batch_stats))
        for k, w in want.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(),
                                           err_msg=k, **JAX_TOL)
    _same_on_every_rank(ranks, name)


def test_synced_layers_match_the_full_batch_layer(jax_inputs, ranks):
    """BatchNorm2d and SwitchWhiten with the data group, each rank on its
    rows, against the JAX layers on the whole batch: the output, the input
    gradient (each rank's loss reaches every rank's rows through the mean),
    the summed parameter gradients and the running statistics."""
    x, w, bn, sw = jax_inputs["layers"]
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    wh = jnp.asarray(w.transpose(0, 2, 3, 1))
    layers = {
        "bn": (jlayers.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5),
               {"params": {"scale": bn["weight"].numpy(), "bias": bn["bias"].numpy()},
                "batch_stats": {"mean": np.zeros(8, np.float32),
                                "var": np.ones(8, np.float32)}}, {}),
        "sw": (JaxSwitchWhiten(8, num_pergroup=4),
               {"params": {k: v.numpy() for k, v in sw.items()},
                "batch_stats": {"running_mean": np.zeros((2, 4, 1), np.float32),
                                "running_cov": np.zeros((2, 4, 4), np.float32)}},
               {"train": True})}
    for name, (layer, variables, kw) in layers.items():
        def loss(params, xin):
            y, mut = layer.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]}, xin,
                                 mutable=["batch_stats"], **kw)
            return jnp.sum(y * wh), (y, mut["batch_stats"])

        (_, (y, new_stats)), (g_params, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"], xh)
        got = [r["layers"][name] for r in ranks]
        cat = {k: torch.cat([g[k] for g in got]).numpy().transpose(0, 2, 3, 1)
               for k in ("y", "dx")}
        close(cat["y"], np.asarray(y), 1e-5, f"{name} y")
        close(cat["dx"], np.asarray(g_x), 1e-5, f"{name} dx")
        names = {"bn": {"weight": "scale", "bias": "bias"}}.get(name, {})
        for n in got[0]["grads"]:
            summed = got[0]["grads"][n] + got[1]["grads"][n]
            close(summed, np.asarray(g_params[names.get(n, n)]), 1e-5, f"{name} d{n}")
        stat_names = {"running_mean": "mean", "running_var": "var"} if name == "bn" else {}
        for n, b in got[0]["buffers"].items():
            if n != "num_batches_tracked":
                close(b, np.asarray(new_stats[stat_names.get(n, n)]), 1e-5, f"{name} {n}")
                assert torch.equal(b, got[1]["buffers"][n])


def test_joint_dp_step_matches_jax(jax_inputs, ranks, monkeypatch):
    """Mode joint: the generator's and the regressor's gradients and running
    statistics each averaged over the ranks; the regressor's dropout takes
    the same seeded masks in call order in both frameworks."""
    def jax_drop(x, rate, rng, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        m = np.random.default_rng(3000 + calls[0]).random((x.shape[0], x.shape[-1])) < 1 - rate
        calls[0] += 1
        return jnp.where(m[:, None, None, :], x / (1.0 - rate), 0.0)

    calls = [0]
    for mod in (jlayers, jreg):
        monkeypatch.setattr(mod, "dropout2d", jax_drop)
    mesh = jmesh.make_mesh(2)
    tx = build_optimizer({"name": "sgd", "params": {"lr": 0.01}})
    (jg, gp, gs, pg), (jr, rp, rs, pr) = jax_inputs["gen"], jax_inputs["reg"]
    step = jmesh.build_parallel_joint_step(jg, jr, JAX_LOSSES.build("mse"), 1000.0, mesh,
                                           donate=False)
    g_state, r_state, metrics = step(
        jmesh.replicate(mesh, _jax_state(gp, gs, tx)), jmesh.replicate(mesh, _jax_state(rp, rs, tx)),
        jmesh.shard_batch(mesh, dict(jax_inputs["joint_batch"])), jax.random.PRNGKey(0),
        jnp.int32(0))
    got = ranks[0]["joint"]
    assert got["masks"] == calls[0] == 4
    assert set(got["metrics"]) == set(metrics)
    for k, v in metrics.items():
        close(got["metrics"][k], float(v), 1e-4, k)
    for key, model, state, (p0, s0) in (("gen", pg, g_state, (gp, gs)),
                                        ("reg", pr, r_state, (rp, rs))):
        state = jax.device_get(state)
        want = state_dict_from_flax(model, unfreeze(state.params), unfreeze(state.batch_stats))
        before = state_dict_from_flax(model, p0, s0)
        names = [n for n, _ in model.named_parameters()]
        _hold_state_dict(got[key], want, 1e-4, 1e-4, names)
        assert sum(not torch.equal(got[key][n], before[n]) for n in names) > len(names) // 2
        for k in got[key]:
            assert torch.equal(got[key][k], ranks[1]["joint"][key][k]), (key, k)


# ------------------------------------------------------------------ eval

@pytest.mark.parametrize("index", [0, 1], ids=["larger_than_the_tile", "smaller"])
def test_sharded_counter_matches_jax(index, jax_inputs, ranks):
    """96x112 in 64-px tiles (4 tiles, 2 a rank) and 48x40 whole (1 tile
    and a zero tile): the same count on every rank, JAX's to 1e-4."""
    jm, params, stats = jax_inputs["counter"]
    jc = jeval.ShardedTiledCounter(lambda v, t: jm.apply(v, t), 1000.0, 64,
                                   jmesh.make_mesh(2))
    want = jc.count({"params": params, "batch_stats": stats}, jax_inputs["images"][index])
    got = [r["counter"][index] for r in ranks]
    assert got[0] == got[1]
    close(got[0], want, 1e-4)
    assert abs(want) > 1e-3  # the map is not all zero


def test_allgather_sum_and_mean_over_two_ranks(ranks):
    for r in ranks:
        out = r["allgather"]
        np.testing.assert_array_equal(out["sum"]["a"],
                                      np.arange(6, dtype=np.float32).reshape(2, 3) * 3)
        assert out["sum"]["a"].dtype == np.float32
        assert out["sum"]["b"][0] == 2.0 and out["mean"]["b"][0] == 1.0
        np.testing.assert_array_equal(out["sum"]["b"][1], np.ones(3, np.int64))
        np.testing.assert_array_equal(out["mean"]["a"],
                                      np.arange(6, dtype=np.float32).reshape(2, 3) * 1.5)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("n,batch,world,epoch", [
    (10, 2, 2, 0), (10, 2, 2, 3), (7, 3, 2, 1), (5, 4, 3, 0), (64, 8, 4, 2), (3, 2, 4, 5)])
def test_distributed_sampler_is_jax_bit_for_bit(n, batch, world, epoch):
    for shuffle in (True, False):
        for rank in range(world):
            want = jmultihost.DistributedSampler(n, batch, seed=9, shuffle=shuffle, rank=rank,
                                                 world_size=world)
            got = pmultihost.DistributedSampler(n, batch, seed=9, shuffle=shuffle, rank=rank,
                                                world_size=world)
            np.testing.assert_array_equal(got.epoch_indices(epoch), want.epoch_indices(epoch))
            assert len(got) == len(want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Canonical layout: 96x112 JPEGs, 12 head points each, their maps."""
    root = tmp_path_factory.mktemp("dp_data")
    rng = np.random.default_rng(3)
    (root / "train").mkdir()
    for k in range(8):
        Image.fromarray(rng.uniform(0, 255, (96, 112, 3)).astype(np.uint8)).save(
            root / "train" / f"img{k:03d}.jpg")
        pts = rng.uniform(0, [112, 96], (12, 2)).astype(np.float32)
        np.save(root / "train" / f"img{k:03d}.npy", pts)
        np.save(root / "train" / f"img{k:03d}_dmap.npy",
                dmap.gaussian_density_fixed_np((96, 112), pts))
    return str(root)


def _den_cls(root, **kw):
    return pdatasets.DenClsDataset(root, method="train", crop_size=64, downsample=1,
                                   unit_size=16, **kw)


def test_rank_rows_concatenate_to_the_one_process_batch(root):
    """Each rank's loader fetches only its rows; concatenated they are the
    one-process loader's batch, bit for bit, epoch after epoch."""
    ds = _den_cls(root)
    one = DataLoader(ds, batch_size=4, shuffle=True, seed=5)
    shards = [DataLoader(ds, batch_size=4, shuffle=True, seed=5, shard=(r, 2),
                         num_workers=2) for r in range(2)]
    for epoch in (0, 1):
        for loader in (one, *shards):
            loader.set_epoch(epoch)
        for whole, *parts in zip(one, *shards):
            assert set(whole) == set(parts[0])
            for k in whole:
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        DataLoader(ds, batch_size=4, shuffle=True, shard=(0, 3))


def test_device_aug_rows_equal_the_one_process_batch(root):
    """With device_aug every rank draws the whole batch's augmentation from
    the same generator and applies its own rows' draws."""
    ds = pdatasets.RawCropDataset(_den_cls(root), pre_crop=80)
    whole = next(iter(DataLoader(ds, batch_size=4, shuffle=True, seed=5)))

    def aug(batch, shard):
        g = torch.Generator().manual_seed(11)
        return dp.augment_two_view_batch(torch.from_numpy(batch["frames_u8"]),
                                         torch.from_numpy(batch["dmaps"]), g, 48, shard=shard)

    want = aug(whole, None)
    parts = []
    for r in range(2):
        rows = next(iter(DataLoader(ds, batch_size=4, shuffle=True, seed=5, shard=(r, 2))))
        parts.append(aug(rows, (r, 2)))
    for k, v in want.items():
        np.testing.assert_allclose(torch.cat([p[k] for p in parts]).numpy(), v.numpy(),
                                   atol=5e-6, rtol=0, err_msg=k)


def test_four_ranks_on_two_nodes_take_jax_sampler_rows(tmp_path):
    """4 ranks with LOCAL_WORLD_SIZE 2: the JAX pod's rule, each node's
    batch from the DistributedSampler (batch_size per node), then split over
    the node's 2 ranks as JAX's shard_batch splits it over the host's chips."""
    n, batch, seed, epochs = 11, 4, 3, 2
    spec_file(str(tmp_path), {"rows": ("rows", {"n": n, "batch_size": batch, "seed": seed,
                                                "epochs": epochs})})
    launch.run_ranks(run_cases, 4, (str(tmp_path),), init_file=str(tmp_path / "init"),
                     local_world=2, timeout=120)
    got = results(str(tmp_path), 4)
    host_mesh = jmesh.make_mesh(2)

    def chips(rows):
        """The node batch's rows on each of the host's 2 chips."""
        arr = jmesh.shard_batch(host_mesh, {"i": rows})["i"]
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
        return [np.asarray(s.data).tolist() for s in shards]

    for rank, r in enumerate(got):
        node, local = divmod(rank, 2)
        assert r["rows"]["layout"] == (node, 2, local)
        sampler = jmultihost.DistributedSampler(n, batch, seed=seed, rank=node, world_size=2)
        for epoch in range(epochs):
            idx = sampler.epoch_indices(epoch)
            want = [chips(idx[b * batch:(b + 1) * batch])[local] for b in range(len(sampler))]
            assert r["rows"]["rows"][epoch] == want


def test_the_parallel_modules_stand_alone():
    """The isolation scan reaches dgvcc_tpu_torch/parallel/: none of its
    modules, nor the ranks' side of these tests, imports JAX or the JAX
    package."""
    from pathlib import Path

    from test_torch_port_isolation import PORT, _banned, _imports

    files = sorted((PORT / "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "mesh.py", "multihost.py", "eval.py",
                                       "launch.py"}
    files.append(Path(__file__).with_name("test_torch_port_parallel_ranks.py"))
    assert not [(f.name, n) for f in files for n in _imports(f) if _banned(n)]
