"""Spatial training parallelism, counterpart of dgvcc_tpu/parallel/spatial.py:
the crop height sharded over the ranks of ``mesh: {spatial: N}``.

The JAX package jits the unchanged one-device step with the batch's height
sharded, and GSPMD inserts what the one-device result needs: halo rows for
every convolution, batch statistics over all rows, loss sums over all
rows. The port writes that by hand, one process a rank:

  * the batch (``shard_batch_spatial``): every rank takes the same global
    batch and keeps its contiguous rows of the image keys, JAX's key rules
    and error text; a rank's height must also be a multiple of the
    family's row rule (``row_rule``, ``check_rank_rows``: its deepest
    stride, 16 for the DG family, bl and dssinet, 8 for csrnet, 4 for mcnn,
    lcm(16, block_size) for sasnet, whose confidence cells must not
    straddle two ranks), stricter than JAX's "divisible by N" (ROADMAP.md,
    Queue 3);
  * the layers (``shard_height``, a build-time switch like
    ``nn/layers.py::sync_statistics``): each convolution taller than one row
    takes a halo of dilation (kh - 1) / 2 rows from the ranks around it
    (``exchange_halo``, past the nearest neighbour when the halo is taller
    than a shard, as mcnn's 7x7 convolutions after two pools can be; zeros
    at the crop's top and bottom) and convolves without padding in height;
    each batch norm averages its statistics over the group (the mean of the
    ranks' means is exact: the shards have equal rows); a bilinear resize
    (half-pixel x2, or align_corners=True at the whole crop's sample
    positions) takes one row from each neighbour (the whole crop's clamp
    at its ends) and keeps its rows of the output; the instance norm
    averages its per-(sample, channel) moments over the group. Nearest
    upsampling at an integer ratio, a x0.5 half-pixel resize of an even
    shard, 2x2 max pooling, sasnet's cell pooling under the row rule, 1x1
    convolutions, ReLU, PReLU and the bank are already local;
  * dropout: every rank draws from one generator seeded as the one-process
    run's (the trainer's), so every rank draws the one-process masks;
  * the step (``build_spatial_train_step``): the data-parallel step of
    ``parallel/mesh.py`` over the spatial group, on each rank's local loss.
    Every MSE term of modes simple, base, add, cls and final is a mean over
    the rank's equal share of the pixels, so the one-process loss is the
    mean of the ranks' losses; a prediction whose target was not sharded
    raises. The Bayesian loss is not such a mean: its expected counts sum
    over all rows, so each rank sums its rows' share over the group
    (``losses/bayesian.py``, ``sum_over_ranks``) and every rank holds the
    one-process loss, whose mean over the ranks is itself. Each rank's
    backward reaches the other ranks' rows through the collectives'
    backwards, which are linear, so the mean of the ranks' gradients is the
    one-process gradient, and the mean of the ranks' metrics the
    one-process metrics (``average_metrics``). The training kernels (#2,
    #3) run unchanged on each rank's rows.

The halo exchange and the sums over ranks are in ``nn/collectives.py``
(``halo_transport`` names how the rows travel). The families with a row
rule shard: the DG family and the convolutional baselines mcnn, csrnet,
bl, sasnet and dssinet. The whitening family, the regressors, the
generator and CCTrans, and the modes with a loss of their own (isw and the
custom-loss modes), raise (ROADMAP.md, Queue 1 item 1).

Serving (``serve.py``, ``shard="spatial"``) uses the same switch on the
eval forward, where the batch norms read their running statistics and need
no group, and ``shard_graph_height`` on the families' int8 graphs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch.distributed as dist
from torch import nn

from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d
from dgvcc_tpu_torch.parallel.mesh import build_parallel_train_step, torchrun_command

SPATIAL_AXIS = "spatial"
# batch arrays carrying the image height (dim 1 of NHWC, dim 2 of NCHW):
# these shard; everything else replicates
SPATIAL_KEYS = frozenset({"img1", "img2", "dmap", "bmap", "frames_u8", "dmaps"})
# the full-resolution subset whose replication would defeat the mode
IMAGE_KEYS = frozenset({"img1", "img2", "frames_u8"})
# the modes whose every loss term is a mean over equal shares of the pixels
MODES = ("simple", "base", "add", "cls", "final")
UNPORTED = "see ROADMAP.md, Queue 1 item 1 (spatial sharding for the rest)"


def make_spatial_mesh(n: int):
    """The spatial group of ``mesh: {spatial: n}``: every rank of the job.
    Raises outside a distributed job (naming the torchrun command) and when
    the job has another number of ranks."""
    if not dist.is_initialized():
        raise RuntimeError(f"mesh: {{spatial: {n}}} runs one process a rank: start it with "
                           f"{torchrun_command(n)}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh: {{spatial: {n}}} but the job has {world} ranks; start it "
                         f"with {torchrun_command(n)}")
    return dist.group.WORLD


def shard_batch_spatial(batch: Dict[str, Any], rank: int, world: int,
                        dim: int = 1) -> Dict[str, Any]:
    """This rank's rows of every spatial key of a global batch (``dim``: the
    height axis, 1 for NHWC numpy, 2 for NCHW tensors). A non-image spatial
    key whose height does not divide stays whole (a low-resolution target);
    an image key whose height does not divide raises: replicating it would
    run every rank at full activation memory."""
    out = {}
    for k, v in batch.items():
        shape = np.shape(v)
        divisible = len(shape) > dim and shape[dim] % world == 0
        if k in IMAGE_KEYS and not divisible:
            raise ValueError(
                f"mesh: {{spatial: {world}}} needs the crop height divisible "
                f"by {world}, but batch['{k}'] has height {shape[dim]} — "
                "adjust crop_size (replicating the image would defeat "
                "the sharding)")
        if k in SPATIAL_KEYS and divisible:
            per = shape[dim] // world
            index = (slice(None),) * dim + (slice(rank * per, (rank + 1) * per),)
            v = v[index]
        out[k] = v
    return out


def check_rank_rows(height: int, world: int, rule: int) -> None:
    """A rank's share of a crop of ``height`` rows must be a multiple of the
    family's row rule (``row_rule``)."""
    if height % (world * rule):
        raise ValueError(
            f"mesh: {{spatial: {world}}} needs each rank's rows to be a multiple of "
            f"{rule} (the model's deepest stride), but a crop of {height} rows gives "
            f"{height / world:g} a rank — pick a crop_size that is a multiple of "
            f"{world * rule}")


# ---------------------------------------------------------------- the model

def row_rule(model) -> int:
    """The multiple of rows a rank's share of a crop must be for ``model``
    (a module, or an int8 serving graph): its family's ``row_rule``. Raises
    for the families that do not shard."""
    rule = getattr(model, "row_rule", None)
    if rule is None:
        raise NotImplementedError(f"mesh: {{spatial: N}} for model "
                                  f"'{type(model).__name__}' is not ported; {UNPORTED}")
    return rule


def shard_height(model: nn.Module, group) -> nn.Module:
    """Build-time switch: the layers of a family with a row rule compute
    the one-process result on this rank's rows of the crop, over ``group``
    (None: each rank its whole input again). It sets ``spatial_group`` on
    each module that reads it (the convolutions taller than one row, and
    the model, whose resizes and instance norms take it) and the batch
    norms' ``process_group``. Returns the model."""
    row_rule(model)
    for m in model.modules():
        if isinstance(m, Conv2d):
            kh, dh = m.kernel_size[0], m.dilation[0]
            if kh > 1 and (m.stride[0] != 1 or m.padding[0] != dh * (kh - 1) // 2
                           or m.padding_mode != "zeros"):
                raise NotImplementedError(f"{m}: only stride-1 convolutions padded to "
                                          "their input's height shard over rows")
            m.spatial_group = group if kh > 1 else None
        elif isinstance(m, BatchNorm2d):
            m.process_group = group
        elif isinstance(m, nn.MaxPool2d):
            if m.kernel_size not in (2, (2, 2)) or m.stride not in (2, (2, 2)):
                raise NotImplementedError(f"{m}: only 2x2 pooling shards over rows")
        elif isinstance(m, (nn.Conv2d, nn.modules.batchnorm._NormBase)):
            raise NotImplementedError(f"{type(m).__name__} does not shard over rows")
    model.spatial_group = group
    return model


def shard_graph_height(graph, group):
    """``shard_height`` for an int8 serving graph (``nn/quant.py``'s
    ``QuantizedDG``, and the ``QuantizedConvNet`` of a family with a row
    rule): each site taller than one row takes its halo from the ranks
    around it, and each resize its neighbour rows, over ``group`` (None:
    whole rows again). Returns the graph."""
    row_rule(graph)
    graph.spatial_group = group
    return graph


class _RowsMSE:
    """The MSE count loss on a rank's rows: the prediction's rows and its
    target's must agree (a target whose height does not divide by N stays
    whole in ``shard_batch_spatial``)."""

    kind = "mse"

    def __init__(self, loss, world: int):
        self.loss, self.world = loss, world

    def __call__(self, pred, gt_dmap, log_para: float = 1000.0, weights=None):
        if pred.shape[2:] != gt_dmap.shape[2:]:
            raise ValueError(
                f"mesh: {{spatial: {self.world}}}: a rank's prediction has "
                f"{tuple(pred.shape[2:])} rows x columns but its target "
                f"{tuple(gt_dmap.shape[2:])}; the target map's height must divide by "
                f"{self.world} to be sharded with the image (crop_size / downsample)")
        return self.loss(pred, gt_dmap, log_para, weights)


def build_spatial_train_step(model, loss, mode: str, log_para: float, group,
                             loss_fn: Optional[Callable] = None,
                             con_weight: float = 10.0) -> Callable:
    """``train/steps.py::build_train_step`` over a spatial group, for a
    model built with ``shard_height``: step(state, batch of this rank's
    rows, generator, epoch) -> (state, this rank's metrics;
    ``average_metrics`` gives the one-process ones). The count loss is the
    MSE or the Bayesian loss, each on the rank's rows."""
    from dgvcc_tpu_torch.train.steps import build_loss_fn

    if loss_fn is not None or mode not in MODES:
        raise NotImplementedError(f"mesh: {{spatial: N}} for mode '{mode}' is not ported; "
                                  f"{UNPORTED}")
    kind = getattr(loss, "kind", "mse")
    if kind not in ("mse", "bl"):
        raise NotImplementedError(f"mesh: {{spatial: N}} with the {kind!r} loss is not "
                                  f"ported; {UNPORTED}")
    if getattr(model, "spatial_group", None) is not group:
        raise ValueError("build the model with parallel/spatial.py::shard_height first")
    world = dist.get_world_size(group)
    rule = row_rule(model)
    rows_loss = _RowsMSE(loss, world) if kind == "mse" else loss.over_rows(group)
    local = build_loss_fn(model, rows_loss, mode, log_para, con_weight)

    def rank_loss(batch, generator, epoch=0):
        check_rank_rows(batch["img1"].shape[2] * world, world, rule)
        return local(batch, generator, epoch)

    return build_parallel_train_step(model, loss, mode, log_para, group, loss_fn=rank_loss)
