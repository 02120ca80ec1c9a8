"""Spatial training parallelism, counterpart of dgvcc_tpu/parallel/spatial.py:
the crop height sharded over the ranks of ``mesh: {spatial: N}``.

The JAX package jits the unchanged one-device step with the batch's height
sharded, and GSPMD inserts what the one-device result needs: halo rows for
every convolution, batch statistics over all rows, loss sums over all
rows. The port writes that by hand, one process a rank:

  * the batch (``shard_batch_spatial``): every rank takes the same global
    batch and keeps its contiguous rows of the image keys, JAX's key rules
    and error text; a rank's height must also be a multiple of the U-Net's
    deepest stride, 16 (``check_rank_rows``, stricter than JAX's "divisible
    by N": ROADMAP.md, Queue 3);
  * the layers (``shard_height``, a build-time switch like
    ``nn/layers.py::sync_statistics``): each convolution taller than one row
    takes a halo of dilation (kh - 1) / 2 rows from its neighbours
    (``exchange_halo``; zeros at the crop's top and bottom) and convolves
    without padding in height; each batch norm averages its statistics over
    the group (the mean of the ranks' means is exact: the shards have equal
    rows); a bilinear upsample takes one low-resolution row from each
    neighbour (an edge copy at the crop's ends) and crops its output; the
    instance norm averages its per-(sample, channel) moments over the group.
    Nearest upsampling, 2x2 max pooling, 1x1 convolutions, ReLU and the bank
    are already local;
  * dropout: every rank draws from one generator seeded as the one-process
    run's (the trainer's), so every rank draws the one-process masks;
  * the step (``build_spatial_train_step``): the data-parallel step of
    ``parallel/mesh.py`` over the spatial group, on each rank's local loss.
    Every term of modes simple, base, add, cls and final is a mean over the
    rank's equal share of the pixels, so the one-process loss is the mean
    of the ranks' losses. Each rank's backward reaches the other ranks'
    rows through the collectives' backwards, which are linear, so the mean
    of the ranks' gradients is the one-process gradient, and the mean of
    the ranks' metrics the one-process metrics (``average_metrics``). The
    training kernels (#2, #3) run unchanged on each rank's rows.

The halo exchange and the mean over ranks are in ``nn/collectives.py``
(``halo_transport`` names how the rows travel). Other model families, and
the modes with a loss function of their own, raise (ROADMAP.md, Queue 1
item 1).

Serving (``serve.py``, ``shard="spatial"``) uses the same switch on the
eval forward, where the batch norms read their running statistics and need
no group, and ``shard_graph_height`` on the DG family's int8 graph.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch.distributed as dist
from torch import nn

from dgvcc_tpu_torch.models.dg import DGModel
from dgvcc_tpu_torch.nn.layers import BatchNorm2d, Conv2d
from dgvcc_tpu_torch.parallel.mesh import build_parallel_train_step, torchrun_command

SPATIAL_AXIS = "spatial"
# batch arrays carrying the image height (dim 1 of NHWC, dim 2 of NCHW):
# these shard; everything else replicates
SPATIAL_KEYS = frozenset({"img1", "img2", "dmap", "bmap", "frames_u8", "dmaps"})
# the full-resolution subset whose replication would defeat the mode
IMAGE_KEYS = frozenset({"img1", "img2", "frames_u8"})
# the U-Net's deepest stride: a rank's rows pool down to whole rows
STRIDE = 16
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


def check_rank_rows(height: int, world: int) -> None:
    """A rank's share of a crop of ``height`` rows must pool to whole rows
    through the U-Net's four 2x2 poolings."""
    if height % (world * STRIDE):
        raise ValueError(
            f"mesh: {{spatial: {world}}} needs each rank's rows to be a multiple of "
            f"{STRIDE} (the model's deepest stride), but a crop of {height} rows gives "
            f"{height / world:g} a rank — pick a crop_size that is a multiple of "
            f"{world * STRIDE}")


# ---------------------------------------------------------------- the model

def shard_height(model: nn.Module, group) -> nn.Module:
    """Build-time switch: the DGModel family's layers compute the
    one-process result on this rank's rows of the crop, over ``group``
    (None: each rank its whole input again). It sets ``spatial_group`` on
    each module that reads it (the convolutions taller than one row, and
    the model, whose bilinear upsamples and instance norms take it) and the
    batch norms' ``process_group``. Returns the model."""
    if not isinstance(model, DGModel):
        raise NotImplementedError(f"mesh: {{spatial: N}} for model "
                                  f"'{type(model).__name__}' is not ported; {UNPORTED}")
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


def check_spatial_family(model) -> None:
    """Raise unless ``model`` (a module, or an int8 serving graph) has its
    rows sharded by ``shard_height`` or ``shard_graph_height``."""
    from dgvcc_tpu_torch.nn.quant import QuantizedDG

    if not isinstance(model, (DGModel, QuantizedDG)):
        raise NotImplementedError(f"mesh: {{spatial: N}} for model "
                                  f"'{type(model).__name__}' is not ported; {UNPORTED}")


def shard_graph_height(graph, group):
    """``shard_height`` for the DG family's int8 serving graph
    (``nn/quant.py::QuantizedDG``): each site taller than one row takes its
    halo from the neighbours, and each bilinear upsample its neighbour rows,
    over ``group`` (None: whole rows again). Returns the graph."""
    check_spatial_family(graph)
    graph.spatial_group = group
    return graph


def build_spatial_train_step(model, loss, mode: str, log_para: float, group,
                             loss_fn: Optional[Callable] = None,
                             con_weight: float = 10.0) -> Callable:
    """``train/steps.py::build_train_step`` over a spatial group, for a
    model built with ``shard_height``: step(state, batch of this rank's
    rows, generator, epoch) -> (state, this rank's metrics;
    ``average_metrics`` gives the one-process ones)."""
    from dgvcc_tpu_torch.train.steps import build_loss_fn

    if loss_fn is not None or mode not in MODES:
        raise NotImplementedError(f"mesh: {{spatial: N}} for mode '{mode}' is not ported; "
                                  f"{UNPORTED}")
    if getattr(loss, "kind", "mse") != "mse":
        raise NotImplementedError(f"mesh: {{spatial: N}} with the {loss.kind!r} loss is not "
                                  f"ported; {UNPORTED}")
    if getattr(model, "spatial_group", None) is not group:
        raise ValueError("build the model with parallel/spatial.py::shard_height first")
    world = dist.get_world_size(group)
    local = build_loss_fn(model, loss, mode, log_para, con_weight)

    def rank_loss(batch, generator, epoch=0):
        check_rank_rows(batch["img1"].shape[2] * world, world)
        return local(batch, generator, epoch)

    return build_parallel_train_step(model, loss, mode, log_para, group, loss_fn=rank_loss)
