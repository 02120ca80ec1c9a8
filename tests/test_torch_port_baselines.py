"""The port's classic baselines (dgvcc_tpu_torch/models/baselines/: csrnet,
mcnn, bl, sasnet, dssinet, cctrans), their bridges and pretrained installs
(nn/convert.py) and their serving (serve.py), against the JAX package on the
CPU in float32.

Only CCTrans has a tiny knob (tests/test_baselines.py's dims); the others
run at full width on 32-64 px inputs: sasnet also at 100x100, whose
confidence cells (3 a side) divide neither the input nor block 32, and
cctrans also at 80x80 with window 7, which pads every stage's windows and
(at the last stage) its strided convs. bl runs in both batch_norm layouts.
Weights come from numpy seeds into the JAX variables and reach the port
through its bridge.

Tolerances, as the largest absolute difference over the largest absolute
value of the JAX result:
  * eval and train-mode forwards, the loss, the running statistics and the
    VideoCounter counts: 1e-4 (float32, another order of summation);
  * parameter gradients: 1e-3 in relative norm (against 1e-3 of the largest
    gradient norm at least); 5e-2 for full-width sasnet, whose gradients
    differ by up to 1.6e-2 between JAX's own jit and eager runs
    (``GRAD_SPREAD``);
  * the bridge round trip and the pretrained installs: bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import dgvcc_tpu.losses  # noqa: F401
import dgvcc_tpu.models  # noqa: F401
import dgvcc_tpu_torch.losses  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu.core.registry import LOSSES as JAX_LOSSES
from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
from dgvcc_tpu.nn import torch_io
from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu.train import steps as jsteps
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.nn.convert import install_pretrained, state_dict_from_flax
from dgvcc_tpu_torch.nn.vgg import VGG16_CFG, VGG19_CFG, feature_layout
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train.steps import build_loss_fn
from test_torch_port_helpers import close, close_grads, nchw, nhwc, randomize

FWD, GRAD = 1e-4, 1e-3
# full-width sasnet's gradients at 64 and 100 px: JAX's own jit and eager
# runs differ by up to 1.6e-2 in relative norm (density_head4's branches,
# the trunk's convs; ReLU and BN inputs within rounding of their kinks), the
# port by up to 2.0e-2 from either
GRAD_SPREAD = {"sasnet": 5e-2, "sasnet_100": 5e-2}
CCTRANS = dict(embed_dims=(32, 64, 128, 256), num_heads=(2, 4, 8, 16), depths=(1, 1, 2, 1),
               wss=(4, 4, 4, 4), sr_ratios=(8, 4, 2, 1))
# case -> (model, params, input H x W)
CASES = {
    "csrnet": ("csrnet", {}, (32, 48)),
    "mcnn": ("mcnn", {}, (32, 48)),
    "bl": ("bl", {}, (32, 48)),
    "bl_bn": ("bl", {"batch_norm": True}, (32, 48)),
    "sasnet": ("sasnet", {}, (64, 64)),
    "sasnet_100": ("sasnet", {}, (100, 100)),
    "dssinet": ("dssinet", {}, (32, 48)),
    "cctrans": ("cctrans", CCTRANS, (64, 64)),
    "cctrans_pad": ("cctrans", dict(CCTRANS, wss=(7, 7, 7, 7), depths=(1, 1, 1, 1)), (80, 80)),
}
# the JAX package's reader of each family's reference checkpoint
READERS = {"csrnet": torch_io.csrnet_checkpoint_to_flax,
           "mcnn": torch_io.mcnn_checkpoint_to_flax,
           "bl": lambda sd: torch_io.bl_checkpoint_to_flax(sd, batch_norm=False),
           "bl_bn": lambda sd: torch_io.bl_checkpoint_to_flax(sd, batch_norm=True),
           "sasnet": torch_io.sasnet_checkpoint_to_flax,
           "dssinet": torch_io.dssinet_checkpoint_to_flax,
           "cctrans": torch_io.cctrans_checkpoint_to_flax}


def _variable_shapes(jm, hw):
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)},
                                       jnp.zeros((1,) + tuple(hw) + (3,), jnp.float32)))
    return unfreeze(v["params"]), unfreeze(v.get("batch_stats", {}))


@functools.lru_cache(maxsize=None)
def _jax_variables(case, seed=1):
    name, params, hw = CASES[case]
    jm = JAX_MODELS.build(name, **params)
    rng = np.random.default_rng(seed)
    p, s = _variable_shapes(jm, hw)
    return jm, {"params": randomize(p, rng), "batch_stats": randomize(s, rng)}


def _pair(case):
    """(JAX model, its variables, the port model) with identical f32 weights."""
    name, params, _ = CASES[case]
    jm, variables = _jax_variables(case)
    pm = MODELS.build(name, **params)
    pm.load_state_dict(state_dict_from_flax(pm, variables["params"], variables["batch_stats"]),
                       strict=True)
    return jm, variables, pm


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case):
    jm, variables, pm = _pair(case)
    x = np.random.default_rng(2).normal(size=(2,) + CASES[case][2] + (3,)).astype(np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(nchw(x))
    close(nhwc(got), want, FWD, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_forward_loss_and_gradients_match_jax(case):
    """Mode simple's MSE count loss on a density map at the model's stride:
    the train-mode forward (batch statistics), the loss, every parameter's
    gradient and the running statistics it leaves."""
    jm, variables, pm = _pair(case)
    b, (h, w) = 2, CASES[case][2]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    out_hw = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x))).shape[1:3]
    batch = {"img1": x, "dmap": rng.uniform(0, 2e-3, (b,) + out_hw + (1,)).astype(np.float32)}
    (total, (new_stats, _)), grads = jax.jit(jax.value_and_grad(
        jsteps.build_loss_fn(jm, JAX_LOSSES.build("mse"), "simple", 1000.0), has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), jnp.int32(0))
    got_total, _ = build_loss_fn(pm, LOSSES.build("mse"), "simple", 1000.0)(
        {k: nchw(v) for k, v in batch.items()}, None, 0)
    got_total.backward()
    close(got_total.detach(), total, FWD, "loss")
    want = state_dict_from_flax(pm, unfreeze(grads), None)
    assert {n for n, _ in pm.named_parameters()} == set(want)
    close_grads(pm, want, GRAD_SPREAD.get(case, GRAD))
    want_stats = state_dict_from_flax(pm, variables["params"], unfreeze(new_stats))
    for k, v in pm.named_buffers():
        if not k.endswith("num_batches_tracked"):
            close(v, want_stats[k].numpy(), FWD, k)


@pytest.mark.parametrize("case", ["csrnet", "mcnn", "bl", "bl_bn", "sasnet", "dssinet",
                                  "cctrans"])
def test_bridge_round_trips_through_the_jax_reader(case, tmp_path):
    """JAX variables -> the port's strict state_dict -> the JAX package's
    reader of the family's reference checkpoint gives them back exactly;
    the .pth strict-loads into VideoCounter.from_checkpoint (dssinet's with
    the reference's two PReLUs its forward never crosses)."""
    _, variables, pm = _pair(case)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    got_p, got_s = READERS[case](sd)
    for tree, got in (("params", got_p), ("batch_stats", got_s)):
        want, got = dict(_flat(variables[tree])), dict(_flat(got))
        assert set(got) == set(want), tree
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    ref = dict(pm.state_dict())
    if case == "dssinet":
        ref.update({f"front_end.features.{r}.weight": torch.full((1,), 0.25)
                    for r in ("relu8", "relu15")})
    path = str(tmp_path / f"{case}.pth")
    torch.save(ref, path)
    name, params, _ = CASES[case]
    c = VideoCounter.from_checkpoint(name, path, dtype=torch.float32, device="cpu", **params)
    for k, v in pm.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k


def _torchvision_vgg(cfg, batch_norm, rng):
    sd, ch = {}, 3
    for kind, idx, arg in feature_layout(cfg, batch_norm):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (arg, ch, 3, 3)).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.1, arg)
                                                          .astype(np.float32))
            ch = arg
        elif kind == "bn":
            for f, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.1, 0.1),
                              ("running_mean", -0.1, 0.1), ("running_var", 0.5, 2.0)):
                sd[f"features.{idx}.{f}"] = torch.from_numpy(
                    rng.uniform(lo, hi, arg).astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # a key no model takes
    return sd


def _altgvt(pm, rng):
    """An alt_gvt state_dict: the backbone's keys at their shapes, an
    ImageNet head the model lacks, and one key of another shape."""
    sd = {k: torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape)).astype(np.float32))
          for k, v in pm.state_dict().items() if k.startswith(("patch_embeds", "pos_block",
                                                                "blocks"))}
    sd["head.weight"] = torch.zeros(1000, 256)
    sd["patch_embeds.0.norm.weight"] = torch.ones(7)
    return sd


# case -> (the torchvision weights' name, how they are made, how many of
# the model's entries they move)
PRETRAINED = {
    "csrnet": ("vgg16", lambda pm, rng: _torchvision_vgg(VGG16_CFG, False, rng), 20),
    "dssinet": ("vgg16", lambda pm, rng: _torchvision_vgg(VGG16_CFG, False, rng), 20),
    "bl": ("vgg19", lambda pm, rng: _torchvision_vgg(VGG19_CFG, False, rng), 32),
    "bl_bn": ("vgg19_bn", lambda pm, rng: _torchvision_vgg(VGG19_CFG, True, rng), 96),
    "sasnet": ("vgg16_bn", lambda pm, rng: _torchvision_vgg(VGG16_CFG, True, rng), 78),
    "cctrans": ("alt_gvt", _altgvt, None),
}


@pytest.mark.parametrize("case", sorted(PRETRAINED))
def test_pretrained_lands_where_the_jax_mapping_puts_it(case, tmp_path):
    """load_pretrained_backbone's variables, through the bridge, equal the
    port's model after install_pretrained, key for key."""
    name, params, _ = CASES[case]
    key, make, moved = PRETRAINED[case]
    _, variables, pm = _pair(case)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    path = str(tmp_path / f"{key}.pth")
    torch.save(make(pm, np.random.default_rng(40)), path)
    want_vars, want_desc = torch_io.load_pretrained_backbone(
        variables, name, {key: path}, model_params=params)
    assert install_pretrained(pm, name, {key: path}) == want_desc
    want = state_dict_from_flax(pm, want_vars["params"], want_vars["batch_stats"])
    got = pm.state_dict()
    changed = {k for k, w in want.items() if not torch.equal(w, before[k])}
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    if moved is None:  # cctrans: the backbone but the mis-shaped norm
        assert changed and all(k.startswith(("patch_embeds", "pos_block", "blocks"))
                               for k in changed)
        assert "patch_embeds.0.norm.weight" not in changed
    else:
        assert len(changed) == moved


def test_bl_takes_only_the_vgg19_of_its_batch_norm_flag(tmp_path):
    """The JAX message when bl is given the other layout's weights."""
    for case, wrong in (("bl", "vgg19_bn"), ("bl_bn", "vgg19")):
        name, params, _ = CASES[case]
        jm, variables, pm = _pair(case)
        path = str(tmp_path / f"{wrong}.pth")
        torch.save({}, path)
        _, want = torch_io.load_pretrained_backbone(variables, name, {wrong: path},
                                                    model_params=params)
        assert install_pretrained(pm, name, {wrong: path}) == want
        assert want.startswith("no pretrained mapping: bl(batch_norm=")


@pytest.mark.parametrize("case", ["csrnet", "mcnn", "bl", "sasnet", "dssinet", "cctrans"])
def test_video_counter_counts_match_jax(case):
    """uint8 frames of 70x90 (padded to the 64 bucket) through both
    VideoCounters in float32."""
    jm, variables, pm = _pair(case)
    frames = np.random.default_rng(5).integers(0, 256, (2, 70, 90, 3), dtype=np.uint8)
    want = np.asarray(JaxCounter(jm, variables, dtype=jnp.float32).count_frames(frames))
    got = VideoCounter(pm, dtype=torch.float32, device="cpu").count_frames(frames)
    assert got.shape == (2,) and np.isfinite(got).all()
    close(got, want, FWD, f"{case} counts")
