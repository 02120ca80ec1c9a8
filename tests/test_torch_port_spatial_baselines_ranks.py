"""The rank side of the convolutional baselines' spatial tests (this module
holds no tests): cases run on every rank of a gloo group started by
``dgvcc_tpu_torch.parallel.launch.run_ranks``. Like
tests/test_torch_port_mesh_ranks.py it imports neither JAX nor the tests'
conftest, and shares its file protocol.

``run_cases(rank, workdir)`` reads ``workdir/spec.pt``, runs each case on
this rank and writes ``workdir/rank{r}.pt``.
"""

import contextlib
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import dgvcc_tpu_torch.losses  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.nn.layers import Conv2d, resize_bilinear, resize_bilinear_ac
from dgvcc_tpu_torch.parallel import mesh, spatial
from dgvcc_tpu_torch.serve import VideoCounter
from dgvcc_tpu_torch.train.state import create_train_state
from test_torch_port_parallel_ranks import case_trainer, nchw

# the family steps' optimizer: at lr 5e-5 the step moves a parameter by up
# to 4.1% of the largest (dssinet; bl 2.6%), and the port's one-process
# step stays within 6.4e-5 of JAX's (bl; at the 0.05 of
# tests/test_torch_port_spatial.py the gradients' spread at ReLU kinks puts
# the parameters up to 4e-3 apart)
SGD = {"name": "sgd", "params": {"lr": 5e-5}}


@contextlib.contextmanager
def one_thread():
    """The ranks run one thread each, and CPU kernels round differently with
    more (a bilinear upsample by an ulp): a one-process reference runs with
    one thread too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _model(fam):
    model = MODELS.build(fam["name"], **fam["params"])
    model.load_state_dict(fam["state_dict"], strict=True)
    return model


def _rows(t, rank, world, dim=2):
    per = t.shape[dim] // world
    return t.narrow(dim, rank * per, per)


def layer_fns(group=None):
    """The layers held against the whole tensor: name -> fn(x, weights)."""
    def conv(k):
        def fn(x, w):
            layer = Conv2d(x.shape[1], 3, k, padding=k // 2, bias=True)
            layer.load_state_dict(w[f"conv{k}"])
            layer.spatial_group = group
            return layer(x)
        return fn

    def cells(x, w):  # sasnet's cell pooling: 2 rows a cell, local under the row rule
        return F.adaptive_avg_pool2d(x, (x.shape[2] // 2, x.shape[3] // 2))

    return {"ac_up2": lambda x, w: resize_bilinear_ac(x, (2 * x.shape[2], 2 * x.shape[3]),
                                                      group),
            "up2": lambda x, w: resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), group),
            "down2": lambda x, w: resize_bilinear(x, (x.shape[2] // 2, x.shape[3] // 2), group),
            "cells": cells, "conv7": conv(7), "conv9": conv(9)}


def case_layers(rank, spec):
    """Each layer on this rank's rows: its rows of the output and the input
    gradient of sum(y * w)."""
    world = dist.get_world_size()
    group = spatial.make_spatial_mesh(world)
    out = {}
    for name, fn in layer_fns(group).items():
        x = _rows(torch.from_numpy(spec["x"]), rank, world).clone().requires_grad_()
        y = fn(x, spec["weights"])
        (y * _rows(torch.from_numpy(spec["w"][name]), rank, world)).sum().backward()
        out[name] = {"y": y.detach(), "dx": x.grad}
    return out


def case_bayes(rank, spec):
    """The Bayesian loss on this rank's rows of a stride-8 prediction: the
    loss, and the gradient of this rank's rows."""
    world = dist.get_world_size()
    group = spatial.make_spatial_mesh(world)
    pred = _rows(torch.from_numpy(spec["pred"]), rank, world).clone().requires_grad_()
    loss = LOSSES.build("bl", **spec["params"]).over_rows(group)(
        *(torch.from_numpy(spec[k]) for k in ("points", "pt_mask", "targets", "st_sizes")), pred)
    loss.backward()
    return {"loss": loss.detach(), "grad": pred.grad}


def case_forward(rank, spec):
    """Each family's eval forward on this rank's rows."""
    world = dist.get_world_size()
    group = spatial.make_spatial_mesh(world)
    out = {}
    for key, fam in spec["families"].items():
        model = spatial.shard_height(_model(fam), group).eval()
        with torch.no_grad():
            out[key] = model(_rows(nchw(fam["batch"]["img1"]), rank, world))
    return out


def _batch(rows):
    return {k: nchw(v) if np.ndim(v) == 4 else torch.from_numpy(np.asarray(v))
            for k, v in rows.items()}


def case_step(rank, spec):
    """Each family's first spatial step (mode simple, SGD): the metrics
    averaged over the ranks and the model after it."""
    world = dist.get_world_size()
    group = spatial.make_spatial_mesh(world)
    out = {}
    for key, fam in spec["families"].items():
        model = spatial.shard_height(_model(fam), group)
        state = create_train_state(model, SGD, device="cpu")
        loss = LOSSES.build(fam["loss"]["name"], **fam["loss"].get("params", {}))
        step = spatial.build_spatial_train_step(model, loss, "simple", fam["log_para"], group)
        rows = spatial.shard_batch_spatial(fam["batch"], rank, world)
        _, metrics = step(state, _batch(rows), None, 0)
        sd = model.state_dict()
        out[key] = {"metrics": {k: float(v) for k, v in
                                mesh.average_metrics(metrics, group).items()},
                    "digest": digest(sd)}
        if rank == 0:  # the others' models are held equal to it by digest
            out[key]["state_dict"] = {k: v.clone() for k, v in sd.items()}
    return out


def digest(state_dict):
    """A hash of a state_dict's names and bytes."""
    h = hashlib.sha256()
    for k, v in state_dict.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def case_unsharded_target(rank, spec):
    """A spatial step whose dmap's height does not divide by N: the error."""
    world = dist.get_world_size()
    group = spatial.make_spatial_mesh(world)
    fam = spec["family"]
    model = spatial.shard_height(_model(fam), group)
    state = create_train_state(model, SGD, device="cpu")
    step = spatial.build_spatial_train_step(model, LOSSES.build("mse"), "simple", 1000.0,
                                            group)
    try:
        step(state, _batch(spatial.shard_batch_spatial(fam["batch"], rank, world)), None, 0)
    except ValueError as e:
        return str(e)
    return None


def case_serve(rank, spec):
    """Each family's counts with shard="spatial" in float32, and each int8
    artifact's: counts, and the graph's density on this rank's rows of the
    padded frames."""
    world = dist.get_world_size()
    group = mesh.make_mesh(world)
    frames = spec["frames"]
    out = {"fp": {}, "int8": {}, "rows": {}}
    for key, fam in spec["families"].items():
        c = VideoCounter(_model(fam), dtype=torch.float32, device="cpu", mesh=group,
                         shard="spatial")
        out["fp"][key] = c.count_frames(frames)
    for key, path in spec["artifacts"].items():
        c = VideoCounter.from_artifact(path, dtype=torch.float32, device="cpu", mesh=group,
                                       shard="spatial")
        out["int8"][key] = c.count_frames(frames)
        with torch.inference_mode():  # the counter's graph, its rows sharded
            out["rows"][key] = c.quantized(_rows(torch.from_numpy(spec["padded"]), rank,
                                                 world, 1))
    return out


CASES = {"layers": case_layers, "bayes": case_bayes, "forward": case_forward, "step": case_step,
         "unsharded_target": case_unsharded_target, "serve": case_serve,
         "trainer": case_trainer}


def run_cases(rank, workdir):
    """Every case of ``workdir/spec.pt`` in order, on every rank."""
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    out = {}
    for key, (case, inputs) in spec.items():
        out[key] = CASES[case](rank, inputs)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
