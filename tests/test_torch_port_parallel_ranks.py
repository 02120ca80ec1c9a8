"""The rank side of the data-parallel parity tests (this module holds no
tests): the cases run on every rank of a gloo group started by
``dgvcc_tpu_torch.parallel.launch.run_ranks``. It imports neither JAX nor
the tests' conftest, since ``spawn`` imports it again in each rank.

``run_cases(rank, workdir)`` reads ``workdir/spec.pt`` (case name -> its
inputs: port state_dicts, numpy batches, settings, written by the test
process), runs each case on this rank and writes ``workdir/rank{r}.pt``
(case name -> what the test holds against the JAX package).
"""

import os
import signal

import numpy as np
import torch
import torch.distributed as dist

import dgvcc_tpu_torch.losses  # noqa: F401
import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
from dgvcc_tpu_torch.data.loader import build_loader
from dgvcc_tpu_torch.nn.layers import BatchNorm2d
from dgvcc_tpu_torch.nn.whitening import SwitchWhiten
from dgvcc_tpu_torch.parallel import mesh
from dgvcc_tpu_torch.parallel.eval import ShardedTiledCounter
from dgvcc_tpu_torch.parallel.multihost import allgather_mean, allgather_sum, node_layout
from dgvcc_tpu_torch.train.state import create_train_state

SGD = {"name": "sgd", "params": {"lr": 0.05}}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _batch(spec_batch, rank, world):
    """This rank's rows of a global NHWC batch, NCHW; isw_ keys whole."""
    out = {}
    for k, v in mesh.shard_batch(spec_batch, rank, world).items():
        out[k] = v if k.startswith(mesh.REPLICATED_PREFIX) else nchw(v)
    return out


def _state(spec, process_group=None, accum_steps=1):
    kw = dict(spec.get("params", {}))
    if process_group is not None:
        kw["process_group"] = process_group
    model = MODELS.build(spec["model"], **kw)
    model.load_state_dict(spec["state_dict"], strict=True)
    return model, create_train_state(model, spec.get("optimizer", SGD), device="cpu",
                                     accum_steps=accum_steps)


def _after(model, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}


def case_step(rank, spec):
    """One data-parallel step (``accum`` micro steps, one batch each): the
    metrics averaged over the ranks and the model after it."""
    world = dist.get_world_size()
    group = mesh.make_mesh(world)
    model, state = _state(spec, group if spec.get("synced") else None,
                          accum_steps=len(spec["batches"]))
    step = mesh.build_parallel_train_step(model, LOSSES.build("mse"), spec["mode"], 1000.0,
                                          group)
    for batch in spec["batches"]:
        state, metrics = step(state, _batch(batch, rank, world), None, spec.get("epoch", 0))
    return _after(model, mesh.average_metrics(metrics, group))


def case_joint(rank, spec):
    """Mode joint's data-parallel step with seeded dropout masks in call
    order (the same on every rank, as the JAX step traced once)."""
    from dgvcc_tpu_torch.models import regressors as preg
    from dgvcc_tpu_torch.nn import layers as players

    orig, calls = players.dropout2d, [0]

    def drop(x, rate, generator=None, mask=None):
        if rate == 0.0:
            return x
        m = np.random.default_rng(3000 + calls[0]).random((x.shape[0], x.shape[1])) < 1 - rate
        calls[0] += 1
        return orig(x, rate, mask=torch.from_numpy(m))

    players.dropout2d = preg.dropout2d = drop
    world = dist.get_world_size()
    group = mesh.make_mesh(world)
    gen, gen_state = _state(spec["gen"])
    reg, reg_state = _state(spec["reg"])
    step = mesh.build_parallel_joint_step(gen, reg, LOSSES.build("mse"), 1000.0, group)
    _, _, metrics = step(gen_state, reg_state, _batch(spec["batch"], rank, world), None, 0)
    return {"metrics": {k: float(v) for k, v in mesh.average_metrics(metrics, group).items()},
            "gen": {k: v.clone() for k, v in gen.state_dict().items()},
            "reg": {k: v.clone() for k, v in reg.state_dict().items()}, "masks": calls[0]}


def case_layers(rank, spec):
    """The synced BatchNorm2d and SwitchWhiten alone on this rank's rows:
    output, input gradient of sum(y * w), parameter gradients (this rank's
    share) and running statistics."""
    world = dist.get_world_size()
    rows = mesh.shard_rows(len(spec["x"]), rank, world)
    out = {}
    for name, layer in (("bn", BatchNorm2d(spec["x"].shape[1])),
                        ("sw", SwitchWhiten(spec["x"].shape[1], num_pergroup=4))):
        layer.load_state_dict(spec[name], strict=False)
        layer.process_group = dist.group.WORLD
        x = torch.from_numpy(spec["x"][rows]).requires_grad_()
        y = layer(x)
        (y * torch.from_numpy(spec["w"][rows])).sum().backward()
        out[name] = {"y": y.detach(), "dx": x.grad,
                     "grads": {n: p.grad for n, p in layer.named_parameters()},
                     "buffers": {n: b.clone() for n, b in layer.named_buffers()}}
    return out


def case_counter(rank, spec):
    """ShardedTiledCounter's counts of each image, on every rank."""
    group = mesh.make_mesh(dist.get_world_size())
    model = MODELS.build("final", **spec["params"])
    model.load_state_dict(spec["state_dict"], strict=True)
    counter = ShardedTiledCounter(model, 1000.0, spec["patch_size"], group, device="cpu")
    return [counter.count(img) for img in spec["images"]]


def case_allgather(rank, spec):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1),
            "b": [np.float64(rank + 0.5), np.full(3, rank, np.int64)]}
    return {"sum": allgather_sum(tree), "mean": allgather_mean(tree)}


class IndexDataset:
    """Samples that are their own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        return {"i": np.int64(index)}

    @staticmethod
    def collate(samples):
        return {"i": np.array([s["i"] for s in samples])}


def case_rows(rank, spec):
    """The indices of this rank's rows of each train batch, epoch by
    epoch, through ``build_loader`` with this rank's node layout."""
    layout = node_layout()
    loader = build_loader(IndexDataset(spec["n"]), {"batch_size": spec["batch_size"],
                                                     "shuffle": True},
                          seed=spec["seed"], layout=layout)
    out = []
    for epoch in range(spec["epochs"]):
        loader.set_epoch(epoch)
        out.append([b["i"].tolist() for b in loader])
    return {"layout": (layout.node, layout.nodes, layout.local_rank), "rows": out}


def case_trainer(rank, spec):
    """The port's CLI on this rank (a torchrun rank's ``python -m
    dgvcc_tpu_torch``), and which steps it ran."""
    from dgvcc_tpu_torch.cli.main import main
    from dgvcc_tpu_torch.train import trainer as ptrainer

    steps, build = [], ptrainer.DGTrainer.build

    def counted_build(self):
        build(self)
        step = self.train_step

        def counted(state, batch, generator, epoch=0):
            steps.append(epoch)
            if (rank, epoch, sum(e == epoch for e in steps)) == spec.get("signal_at"):
                os.kill(os.getpid(), signal.SIGTERM)  # this rank alone
            return step(state, batch, generator, epoch)

        self.train_step = counted

    ptrainer.DGTrainer.build = counted_build
    try:
        main(spec["argv"])
    finally:
        ptrainer.DGTrainer.build = build
    return {"steps": steps}


def case_refusals(rank, spec):
    """What a joined job refuses: a mesh of another size than the job."""
    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    try:
        DGTrainer(Config.from_dict(spec["config"]), device="cpu")
    except ValueError as e:
        return str(e)
    return None


CASES = {"step": case_step, "joint": case_joint, "layers": case_layers,
         "counter": case_counter, "allgather": case_allgather, "rows": case_rows,
         "trainer": case_trainer, "refusals": case_refusals}


def run_cases(rank, workdir):
    """Every case of ``workdir/spec.pt`` in order, on every rank."""
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    out = {}
    for key, (case, inputs) in spec.items():
        out[key] = CASES[case](rank, inputs)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def spec_file(workdir, cases):
    """Write the cases (key -> (case name, inputs)) for ``run_cases``."""
    torch.save(cases, os.path.join(workdir, "spec.pt"))


def results(workdir, world):
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

