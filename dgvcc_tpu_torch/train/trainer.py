"""Experiment trainer, counterpart of dgvcc_tpu/train/trainer.py: on one
device, or over the ranks of a torchrun job (data parallel, the bank sharded
over a 2-D mesh, or the crop's height sharded).

The reference's protocol (trainers/trainer.py:20, trainers/dgtrainer.py:27):
epoch loop -> per-epoch scheduler step -> per-image validation (MAE
criterion, MSE extra) -> rolling last / best checkpoints; test with the
hard-coded re-save thresholds; train_and_test tests only when val
improves (the BaseTrainer's models test every epoch). The ``log.txt`` lines
are the JAX trainer's, word for word.

On the card:
  * a batch goes from NHWC numpy to NCHW device tensors through pinned
    memory and a non-blocking copy, in the channels-last layout the model
    is kept in; the train step (``train/steps.py``) runs the two-view
    training kernels (#2, #3) in modes add / final;
  * the loss is read back once per epoch, then the NaN guard;
  * validation and test count through ``ops/tiling.py::TiledCounter``,
    whose forward runs the bank's serving kernel (#1) at B=1. The JAX
    trainer's B=1 eval takes the einsum path by a TPU v5e rule
    (dgvcc_tpu/models/dg.py:110-116) that the H100 does not share;
  * checkpoints are ``.pth`` state_dicts in the reference layout with a
    training-state sidecar (``train/checkpoint.py``), so resume is exact;
  * mode ``isw`` (the ISW counter): a covariance tracker (``wt_type``
    'isw' or 'irw' among the model params) whose masks ride in every train
    batch of an epoch; validation runs the covariance pass on each val
    sample's two views and selects the sensitive entries after it;
  * mode ``generation`` trains the generator (``gen``, whatever model the
    config names) and validates and tests it by the masked reconstruction
    MSE of the padded image; mode ``joint`` trains ``gen`` and ``reg_mem``
    together (``genjoint.build_joint_step``), counts with ``reg_mem``, and
    saves and loads [gen, reg] checkpoint pairs (``last_gen`` /
    ``last_reg``, ``best_*_gen`` / ``_reg``); both states take the config's
    optimizer, accumulation and EMA and the scheduler's lr each epoch;
    ``generate`` writes restyled train images with the generator;
  * the Bayesian loss (``bl``) takes the batch's padded points, their mask,
    targets and the crops' sizes, uploaded with the images;
  * the dropout draws of epoch e come from a generator seeded from (seed,
    e), so a resumed epoch draws what the uninterrupted run drew; so do
    the ``device_aug`` draws, from a stream of their own.

The JAX trainer's extra config keys:
  * ``device_aug: true``: the host ships uint8 pre-crops of crop + 64
    (``RawCropDataset``, through pinned memory and a non-blocking copy)
    and the two-view augmentation runs batched on the card
    (``data/device_pipeline.py``); needs an MSE-mode den / den_cls set;
  * ``accum_steps: k``, ``ema: d``: gradient accumulation and EMA shadow
    weights (``train/state.py``); validation, test and vis evaluate the
    shadow;
  * ``async_save: true``: checkpoints written by a background thread
    (``train/checkpoint.py::AsyncWriter``), flushed at the end of train,
    test and train_and_test, also when they raise;
  * ``pretrained_weights: {vgg16_bn: path}``: a torchvision state_dict
    into enc1/enc2/enc3 when the model's ``pretrained`` param is true (the
    default); the EMA shadow restarts from it;
  * ``profile_epoch: N``: a ``torch.profiler`` trace of epoch N's train
    loop (CPU and CUDA activities) under ``{log_dir}/trace``.

``train`` stops cleanly on SIGTERM / SIGINT (a flag set by a handler in
the main thread, the previous handlers restored after): a stop between
epochs finishes the epoch as usual; a stop inside one returns with
``last`` at epoch - 1, as it was when that epoch ended, so a resume redoes
the stopped epoch exactly.

``mesh: {data: N}`` trains, validates and tests data parallel, one process
a card under ``torchrun --nproc_per_node=N`` (``parallel/``; the JAX
trainer's ``:102-166``, ``:288-348``, ``:406-423``, ``:615-638``,
``:755-770``):
  * the six whitening models are built with the data group (their batch
    norms and SwitchWhitens average the batch statistics over the ranks);
    the others average their running statistics after each step; the
    gradients are averaged over the ranks (``parallel/mesh.py``);
  * each rank loads and decodes its own rows of the global batch (with
    ``device_aug``, draws of the whole batch, its own rows applied), and
    draws its dropout from its own generator;
  * validation and test share each image's tiles over the ranks
    (``parallel/eval.py::ShardedTiledCounter``); every rank walks the whole
    set and gets the same counts, and the ISW tracker's statistics are
    averaged before the masks are set;
  * a SIGTERM / SIGINT on any rank stops every rank at the same step (an
    all-reduce MAX of the flag once a step);
  * rank 0 alone writes log.txt, TensorBoard and the checkpoints (the JAX
    pod writes from every process: ROADMAP.md, Queue 3); every rank loads
    the checkpoint it resumes from, after a barrier.
``mesh: {data: N, model: M}`` (the JAX trainer's ``:134-201``,
``:326-337``, ``:406-423``) runs N M ranks, rank d M + m at data index d and
model index m (``parallel/mesh.py::make_mesh_2d``): the DGModel's bank is
sharded over the model group (``parallel/tp.py``), each data group takes
its rows of the batch and averages its gradients and running statistics,
dropout draws from a generator of the data index. Validation and test run
the whole model (the bank gathered, kernel #1) over all N M ranks as a 1-D
mesh (``ShardedTiledCounter``); checkpoints hold the whole bank and its
optimizer moments and EMA, gathered before rank 0 writes and sliced again
on a load.

``mesh: {spatial: N}`` (the JAX trainer's ``:115-133``, ``:349-361``) runs
N ranks on the rows of one crop (``parallel/spatial.py``; the DG family and
the baselines mcnn, csrnet, bl with either loss, sasnet and dssinet, each a
rank's rows a multiple of its family's row rule): every rank loads
the whole global batch and keeps its rows, draws the one-process dropout
masks, and computes its share of the one-process loss through halo
exchanges and synced statistics; the gradients are summed. Validation and
test share each image's tiles over the ranks, the model unsharded
(``ShardedTiledCounter``; the JAX trainer evaluates on one device).

Outside torchrun, or with another number of ranks, a mesh raises; the 2-D
and spatial meshes run on one node. The JAX trainer's refusals are kept
(``check_ported``, ``DGTrainer.build``), and so are its messages.

``test_quantized: true`` tests through the int8 serving graph
(``nn/quant.py``), calibrated on the first 4 test samples, as the JAX
trainer does, but of the weights the test evaluates (the EMA shadow under
``ema:``).
"""

from __future__ import annotations

import contextlib
import csv
import inspect
import itertools
import math
import os
import random
import signal
import time
from typing import Optional

import numpy as np
import torch

from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.logging import RunLogger
from dgvcc_tpu_torch.core.registry import DATASETS, LOSSES, MODELS
from dgvcc_tpu_torch.core.tb import ScalarWriter
from dgvcc_tpu_torch.data import transforms as T
from dgvcc_tpu_torch.data.datasets import DensityMapDataset, RawCropDataset
from dgvcc_tpu_torch.data.device_pipeline import augment_two_view_batch
from dgvcc_tpu_torch.data.loader import build_loader
from dgvcc_tpu_torch.models.dg import DGModel
from dgvcc_tpu_torch.nn.collectives import halo_transport
from dgvcc_tpu_torch.nn.convert import install_pretrained
from dgvcc_tpu_torch.ops.tiling import TiledCounter, tile_image
from dgvcc_tpu_torch.parallel import mesh as dp_mesh
from dgvcc_tpu_torch.parallel import spatial, tp
from dgvcc_tpu_torch.parallel.multihost import (NodeLayout, allgather_mean,
                                                initialize_distributed, node_layout, rank_card)
from dgvcc_tpu_torch.serve import resolve_device
from dgvcc_tpu_torch.train.checkpoint import (AsyncWriter, CheckpointRotator, load_checkpoint,
                                              wait_for_rank0)
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_train_step
from dgvcc_tpu_torch.utils.misc import (AverageMeter, DictAvgMeter, denormalize,
                                        get_current_datetime, progress, seed_everything)

# models the reference drives through main_base.py / BaseTrainer
# (main_base.py:36-52): they test after every epoch and tile evaluation at
# 800 px whatever the config's patch_size (basetrainer.py:51-66, 149-173)
BASETRAINER_MODELS = frozenset({"csrnet", "mcnn", "sasnet", "dssinet", "cctrans", "bl",
                                "dgnet", "dgnet_cls"})
BASETRAINER_EVAL_PATCH = 800
BATCH_KEYS = ("img1", "img2", "dmap", "bmap")
# the Bayesian loss's keys: uploaded as they are
POINT_KEYS = ("points", "pt_mask", "targets", "st_sizes")
# the draws of device_aug: a stream apart from the dropout draws
AUG_STREAM = 7_919_000_003
# data parallel: rank r's dropout draws come from stream r * RANK_STREAM
RANK_STREAM = 104_729_000_017


def config_device(cfg: Config, override: Optional[str] = None) -> str:
    """``cuda`` unless the override or the config's ``device:`` starts with
    ``cpu``; ``cuda:N`` is kept, the JAX package's ``tpu`` reads as cuda."""
    dev = str(override or cfg.device)
    if dev.startswith("cpu"):
        return "cpu"
    return dev if dev.startswith("cuda") else "cuda"


def mesh_size(cfg: Config, axis: str) -> int:
    return int((cfg.mesh or {}).get(axis, 1))


# the modes that train through a loss function of their own
CUSTOM_LOSS_MODES = ("regression", "discrimination", "generation")


def check_ported(cfg: Config):
    """Raise on the mesh combinations the JAX trainer refuses (its
    ``:115-148``, ``:326-330``), with its messages."""
    dp, mp, sp = (mesh_size(cfg, a) for a in ("data", "model", "spatial"))
    if sp > 1 and (dp > 1 or mp > 1):
        raise ValueError("mesh: {spatial: N} does not compose with data/model axes — "
                         "spatial is for samples too large for one chip")
    for axis, n in (("spatial", sp), ("model", mp)):
        if n > 1 and cfg.mode == "joint":
            raise ValueError(f"mesh: {{{axis}: {n}}} is not supported for joint mode")
    if mp > 1 and cfg.mode in CUSTOM_LOSS_MODES:
        raise ValueError(f"mesh: {{model: {mp}}} is not supported for mode '{cfg.mode}'")
    if sp > 1 and cfg.mode not in spatial.MODES:
        raise NotImplementedError(f"mesh: {{spatial: {sp}}} for mode '{cfg.mode}' is not "
                                  f"ported; {spatial.UNPORTED}")


def eval_patch_size(cfg: Config) -> int:
    """The tile of validation and test: ``eval_patch_size`` when the config
    sets it, else 800 px for the BaseTrainer's models and ``patch_size`` for
    the others (dgvcc_tpu/train/trainer.py:396-405)."""
    ps = cfg.extra.get("eval_patch_size")
    if ps is None:
        ps = (BASETRAINER_EVAL_PATCH if cfg.model.get("name") in BASETRAINER_MODELS
              else cfg.patch_size)
    return int(ps)


def every_epoch_test(cfg: Config) -> bool:
    """Whether ``train_and_test`` tests after every epoch: the config's
    ``test_every_epoch``, else whether the model is one of the
    BaseTrainer's (dgvcc_tpu/train/trainer.py:966-977)."""
    knob = cfg.extra.get("test_every_epoch")
    if knob is not None:
        return bool(knob)
    return cfg.model.get("name") in BASETRAINER_MODELS


def covariance_views(counter: TiledCounter, sample, patch_size: int):
    """The inputs of ISW's covariance pass on a val sample (its two views
    concatenated, NCHW, on the counter's device): one per real tile of
    ``patch_size`` when the image reaches it (the bucket's filler tiles left
    out), else the image itself, unpadded, as the reference's predict2
    (dgtrainer.py:86-102). The JAX trainer pads that image with black to
    multiples of 128 first (ROADMAP.md, Queue 3)."""
    h, w, _ = sample["img1"].shape
    x1, x2 = (counter._upload(sample[k]) for k in ("img1", "img2"))
    if h >= patch_size or w >= patch_size:
        t1, _, nh, nw = tile_image(x1, patch_size)
        t2, _, _, _ = tile_image(x2, patch_size)
        pairs = [(t1[i:i + 1], t2[i:i + 1]) for i in range(nh * nw)]
    else:
        pairs = [(x1[None], x2[None])]
    return [torch.cat([a, b]).permute(0, 3, 1, 2) for a, b in pairs]


class DGTrainer:
    def __init__(self, cfg: Config, device: Optional[str] = None):
        check_ported(cfg)
        self.cfg = cfg
        device = str(device or config_device(cfg))
        # a mesh: the groups of a torchrun job (joined here from torchrun's
        # environment unless the caller joined it) and this rank's card.
        # `group` averages the gradients (data, the 2-D mesh's data group) or
        # sums them (spatial); `host` carries the flags and numpy
        # statistics; `rows` is the layout whose rows of a batch the loaders
        # fetch (None: the whole batch)
        self.dp, self.mp, self.sp = (mesh_size(cfg, a) for a in ("data", "model", "spatial"))
        self.group = self.host = self.layout = self.rows = self.mesh2d = None
        if max(self.dp, self.mp, self.sp) > 1:
            initialize_distributed(device=device)
            if self.sp > 1:
                self.group = spatial.make_spatial_mesh(self.sp)
            elif self.mp > 1:
                self.mesh2d = dp_mesh.make_mesh_2d(self.dp, self.mp)
                self.group = self.mesh2d.data
            else:
                self.group = dp_mesh.make_mesh(self.dp)
            self.host = dp_mesh.host_group()
            self.layout = self.rows = node_layout()
            if self.layout.nodes > 1 and (self.sp > 1 or self.mp > 1):
                axis = "spatial" if self.sp > 1 else "model"
                raise ValueError(f"mesh {axis}-axis sharding is single-node for now (pod "
                                 "runs use data only)")
            if self.sp > 1:
                self.rows = None
            elif self.mesh2d is not None:
                d = self.mesh2d.data_index
                self.rows = NodeLayout(d, self.dp, d, self.dp)
            if not device.startswith("cpu"):
                device = f"cuda:{rank_card(self.layout.local_rank)}"
        self.main = self.layout is None or self.layout.rank == 0
        self.device = resolve_device(device)
        seed_everything(cfg.seed)
        self.log_dir = os.path.join(cfg.log_dir, cfg.version)
        self.logger = RunLogger(self.log_dir, write=self.main)
        # `async_save: true`: the epoch loop pays a clone on the card, a
        # background thread the host copy and the disk
        self.ckpt_writer = (AsyncWriter() if cfg.extra.get("async_save") and self.main
                            else None)
        self.rotator = CheckpointRotator(self.log_dir, writer=self.ckpt_writer,
                                         write=self.main)
        # `tensorboard: true` adds TB scalars under {log_dir}/tb, additive to
        # log.txt; a no-op (and no extra readback) when off
        self.tb = ScalarWriter(os.path.join(self.log_dir, "tb"),
                               enabled=bool(cfg.extra.get("tensorboard")) and self.main,
                               warn=self.log)
        self.mode = cfg.mode
        self.log_para = float(cfg.log_para)
        self.patch_size = cfg.patch_size
        self.joint = self.mode == "joint"
        self._resume = None
        self._built = False
        self._preempted = False
        # the epoch of the newest `last` this trainer saved or resumed from
        self._last_epoch = None

    # ---- construction ----------------------------------------------------

    def log(self, msg, **kw):
        self.logger.log(msg, **kw)

    def _progress(self, iterable, description: str):
        """Per-batch progress line on a TTY; config ``progress:`` forces it."""
        return progress(iterable, description, enabled=self.cfg.extra.get("progress"))

    def build(self):
        if self._built:
            return
        cfg = self.cfg
        import dgvcc_tpu_torch.data  # noqa: F401  (registers the datasets)
        import dgvcc_tpu_torch.losses  # noqa: F401
        import dgvcc_tpu_torch.models  # noqa: F401

        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        params = dict(cfg.model.get("params", {}))
        if params.pop("tp_axis", None) is not None:
            raise ValueError("model params must not set tp_axis — use "
                             "mesh: {data: N, model: M} instead")
        # the reference's configs name 'dgnet' for modes regression and joint,
        # but their trainers drove the models2 pair, Generator and
        # DensityRegressorM (dgvcc_tpu/train/trainer.py:262-286)
        if self.mode == "generation" and cfg.model["name"] not in ("gen", "gen0"):
            self.model = MODELS.build("gen", dtype=dtype)
        elif self.joint or (self.mode == "regression"
                            and cfg.model["name"] not in ("reg_mem", "reg")):
            self.model = MODELS.build("reg_mem", dtype=dtype)
        else:
            # data parallel: the models with a `process_group` (the JAX
            # models with an `axis_name` field: the six whitening models)
            # average their batch statistics over the ranks in the forward
            target = inspect.signature(MODELS.get(cfg.model["name"])).parameters
            if self.dp > 1 and self.mp == 1 and "process_group" in target:
                params.setdefault("process_group", self.group)
            self.model = MODELS.build(cfg.model["name"], dtype=dtype, **params)
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        if self.mesh2d is not None:
            if not isinstance(self.model, DGModel):
                raise ValueError(f"model '{cfg.model['name']}' has no model-axis sharding "
                                 "surface (tp_axis) — mesh: {model: M} supports the DG "
                                 "memory-bank family")
            tp.shard_model_bank(self.model, self.mesh2d.model)
        if self.sp > 1:
            spatial.shard_height(self.model, self.group)
            if cfg.train_dataset is not None:
                crop = cfg.train_dataset.get("params", {}).get("crop_size", 320)
                spatial.check_rank_rows(int(crop), self.sp, spatial.row_rule(self.model))
        self.loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))

        self.device_aug = bool(cfg.extra.get("device_aug"))
        self._train_crop = None
        self.loaders = {}
        for split in ("train", "val", "test"):
            spec = getattr(cfg, f"{split}_dataset")
            if spec is None:
                continue
            ds = DATASETS.build(spec["name"], method=split, **spec.get("params", {}))
            if split == "train" and self.device_aug:
                kind = getattr(self.loss, "kind", "mse")
                if not isinstance(ds, DensityMapDataset) or kind != "mse":
                    raise ValueError("device_aug needs an MSE-mode den / den_cls train "
                                     f"dataset, not {spec['name']!r} with the {kind!r} loss")
                self._train_crop = int(spec.get("params", {}).get("crop_size", 320))
                ds = RawCropDataset(ds, pre_crop=self._train_crop + 64)
            self.loaders[split] = build_loader(ds, getattr(cfg, f"{split}_loader") or {},
                                               seed=cfg.seed, layout=self.rows)
            # process workers fork before the model reaches the card
            self.loaders[split].start()

        ema = float(cfg.extra.get("ema", 0) or 0)
        accum = int(cfg.extra.get("accum_steps", 1) or 1)
        self.state = create_train_state(self.model, cfg.optimizer, cfg.scheduler,
                                        device=self.device, accum_steps=accum, ema=ema)
        if self.joint:
            # the generator takes the config's optimizer, accumulation and
            # EMA; its lr is the scheduler's, set each epoch
            self.gen_model = MODELS.build("gen", dtype=dtype)
            self.gen_model.reset_parameters(torch.Generator().manual_seed(cfg.seed + 7))
            self.gen_state = create_train_state(self.gen_model, cfg.optimizer, None,
                                                device=self.device, accum_steps=accum,
                                                ema=ema)
        if ema:
            self.log(f"EMA enabled: decay {ema} per optimizer update (validation, test "
                     "and vis use the averaged weights)")
        self.scheduler = self.state.scheduler
        # the 'nocon' ablation zeroes the final-mode consistency weight
        con_weight = 0.0 if cfg.extra.get("no_consistency") else 10.0
        if self.joint:
            from dgvcc_tpu_torch.train.genjoint import build_joint_step

            if self.group is not None:
                self.joint_step = dp_mesh.build_parallel_joint_step(
                    self.gen_model, self.model, self.loss, self.log_para, self.group)
                self.log(f"Joint data parallel over {self.dp} devices")
            else:
                self.joint_step = build_joint_step(self.gen_model, self.model, self.loss,
                                                   self.log_para)
        elif self.mesh2d is not None:
            self.train_step = dp_mesh.build_parallel_train_step_2d(
                self.model, self.loss, self.mode, self.log_para, self.mesh2d,
                con_weight=con_weight)
            self.log(f"2-D mesh: data={self.dp} x model={self.mp} (memory bank sharded)")
        elif self.sp > 1:
            self.train_step = spatial.build_spatial_train_step(
                self.model, self.loss, self.mode, self.log_para, self.group,
                con_weight=con_weight)
            self.log(f"Spatial parallel over {self.sp} devices (crop height sharded, "
                     "halo exchange by send/recv over torch.distributed)")
            if self.main:  # the console only
                print(f"[spatial] halo rows travel by "
                      f"{halo_transport(self.group, self.device)}", flush=True)
        elif self.group is not None:
            self.train_step = dp_mesh.build_parallel_train_step(
                self.model, self.loss, self.mode, self.log_para, self.group,
                con_weight=con_weight)
            self.log(f"Data parallel over {self.dp} devices")
        else:
            self.train_step = build_train_step(self.model, self.loss, self.mode,
                                               self.log_para, con_weight=con_weight)
        # pretrained ImageNet backbones, `pretrained_weights: {vgg16_bn: path}`
        weights = cfg.extra.get("pretrained_weights")
        if weights and cfg.model.get("params", {}).get("pretrained", True):
            desc = install_pretrained(self.model, cfg.model["name"], weights)
            self.state.seed_ema()
            self.log(f"Loaded pretrained backbone: {desc}")
        # the DGTrainer's models tile at the config's patch_size
        # (dgtrainer.py:71-84), the BaseTrainer's at 800 px
        self.eval_patch_size = eval_patch_size(cfg)
        if self.eval_patch_size != self.patch_size:
            # the console only: log.txt keeps the JAX trainer's lines
            print(f"[eval] validation and test on tiles of {self.eval_patch_size} px "
                  f"(patch_size {self.patch_size})", flush=True)
        if self.group is not None:
            from dgvcc_tpu_torch.parallel.eval import ShardedTiledCounter

            # the 2-D mesh counts over all its ranks as one data mesh
            group = torch.distributed.group.WORLD if self.mesh2d is not None else self.group
            self.counter = ShardedTiledCounter(self.model, self.log_para,
                                               self.eval_patch_size, group,
                                               device=self.device)
        else:
            self.counter = TiledCounter(self.model, self.log_para, self.eval_patch_size,
                                        device=self.device)
        # ISW's two-pass covariance protocol (dgtrainer.py:86-102)
        self.isw_tracker = None
        if self.mode == "isw":
            from dgvcc_tpu_torch.models.whitening import IrwCovTracker, IswCovTracker

            tracker = IrwCovTracker if params.get("wt_type", "isw") == "irw" else IswCovTracker
            self.isw_tracker = tracker(relax_denom=params.get("relax_denom", 2.0),
                                       clusters=params.get("clusters", 3))
        self._built = True

    def _epoch_generator(self, epoch: int, stream: int = 0) -> torch.Generator:
        """Dropout draws (stream 0, also on every spatial rank; data
        parallel, data index d's stream d * RANK_STREAM) or augmentation
        draws (AUG_STREAM, the same on every rank) of one epoch, seeded from
        (seed, epoch)."""
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.cfg.seed * 1_000_003 + epoch + 1 + stream) % (2**63))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """numpy -> the device, through pinned memory and a non-blocking copy."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device(self, batch):
        """NHWC numpy images -> NCHW (channels-last) tensors on the device;
        the Bayesian loss's points as they are."""
        out = {k: self._upload(batch[k]).permute(0, 3, 1, 2) for k in BATCH_KEYS
               if k in batch}
        out.update({k: self._upload(batch[k]) for k in POINT_KEYS if k in batch})
        return out

    def _train_batch(self, batch, aug_generator):
        """This rank's rows of a train batch on the device; under a spatial
        mesh its rows of the crop (with ``device_aug``, of the whole batch's
        augmentation)."""
        rank = self.layout.rank if self.layout else 0
        if self.device_aug:
            shard = self.rows and (self.rows.local_rank, self.rows.local_world)
            out = augment_two_view_batch(self._upload(batch["frames_u8"]),
                                         self._upload(batch["dmaps"]), aug_generator,
                                         self._train_crop, shard=shard or None)
            if self.sp > 1:
                out = spatial.shard_batch_spatial(out, rank, self.sp, dim=2)
            return out
        if self.sp > 1:
            batch = spatial.shard_batch_spatial(batch, rank, self.sp)
        return self._to_device(batch)

    def _bank(self, state=None):
        """The whole bank inside (2-D mesh; with ``state`` its optimizer
        moments, EMA and accumulation mean too), this rank's columns after:
        for evaluation and checkpoints. A no-op without a model axis."""
        return tp.full_bank(self.model, self.mesh2d and self.mesh2d.model, state)

    @contextlib.contextmanager
    def _whole_model(self):
        """Evaluation runs the model whole on each rank's tiles: the bank
        gathered (2-D mesh), the crop's height unsharded (spatial)."""
        if self.sp > 1:
            spatial.shard_height(self.model, None)
            try:
                yield
            finally:
                spatial.shard_height(self.model, self.group)
            return
        with self._bank():
            yield

    def _stop_requested(self) -> bool:
        """The preemption flag; data parallel, set on any rank (every rank
        then stops at the same step, none waits in a collective)."""
        if self.host is not None:
            self._preempted = dp_mesh.any_rank(self._preempted, self.host)
        return self._preempted

    # ---- checkpoints -----------------------------------------------------

    def load_ckpt(self, path, strict: bool = False):
        """A port or reference ``.pth`` and its training-state sidecar when
        there is one, or a JAX ``.ckpt``; or a [gen, reg] pair of them
        (dgtrainer.py:35-41): a 1-list on a single-model trainer is its one
        checkpoint, a 2-list on one that is not joint loads the regressor's
        and ignores the generator's. ``strict`` raises on a missing,
        unexpected or mis-shaped weight."""
        if path is None:
            return
        if self.host is not None:
            # the file may be rank 0's newest save
            wait_for_rank0(self.rotator, self.host)
        gen_path = None
        if isinstance(path, (list, tuple)):
            if not 1 <= len(path) <= 2:
                raise ValueError("pair checkpoint must be [gen_ckpt, reg_ckpt] or "
                                 f"[gen_ckpt]; got {len(path)} entries: {path!r}")
            if not self.joint:
                if len(path) == 1:
                    return self.load_ckpt(path[0], strict=strict)
                self.log(f"[ckpt] non-joint config: loading {path[1]} into the model; "
                         f"generator entry {path[0]} ignored")
            else:
                gen_path = path[0]
            path = path[1] if len(path) > 1 else None
        extra = {}
        if gen_path:
            self.log(f"Loading generator checkpoint from {gen_path}")
            extra = self._load_into(gen_path, self.gen_state, strict)
        if path:
            self.log(f"Loading {'regressor ' if gen_path else ''}checkpoint from {path}")
            # a 2-D mesh: the file's whole bank, then each rank's columns
            with self._bank(self.state):
                extra = self._load_into(path, self.state, strict)
        # exact resume: epoch, best and the scheduler from the sidecar (or
        # the JAX checkpoint's extra); a pair's two carry the same
        self._resume = extra if "epoch" in extra else None
        if self._resume and self.scheduler is not None and "scheduler" in self._resume:
            self.scheduler.load_state_dict(self._resume["scheduler"])
        last = os.path.join(self.log_dir, "last_reg.pth" if self.joint else "last.pth")
        if self._resume and path and os.path.exists(last) and os.path.samefile(path, last):
            self._last_epoch = int(self._resume["epoch"])

    def _load_into(self, path, state, strict):
        extra, warnings = load_checkpoint(path, state, strict=strict)
        for w in warnings[:10]:
            self.log(f"  [ckpt] {w}")
        return extra

    def _ckpt_extra(self, epoch, best):
        extra = {"epoch": epoch, "best": best}
        if self.scheduler is not None:
            extra["scheduler"] = self.scheduler.state_dict()
        return extra

    # ---- loops -------------------------------------------------------------

    def _save_last(self, epoch: int, best: float):
        extra = self._ckpt_extra(epoch, best)
        if self.joint:
            self.rotator.save_last_pair(self.gen_state, self.state, extra)
        else:
            with self._bank(self.state):
                self.rotator.save_last(self.state, extra)
        self._last_epoch = epoch

    def _save_best(self, epoch: int, criterion: float):
        if self.joint:
            self.rotator.save_best_pair(self.gen_state, self.state, epoch, criterion,
                                        self._ckpt_extra(epoch, criterion))
        else:
            with self._bank(self.state):
                self.rotator.save_best(self.state, epoch, criterion)

    def _stop_mid_epoch(self, epoch: int, steps: int, best: float):
        """A preemption seen before step ``steps`` of ``epoch``: ``last`` is
        left at epoch - 1 as that epoch ended, so a resume redoes this one
        exactly."""
        if steps == 0:  # nothing of this epoch ran: the state is epoch - 1's
            self._save_last(epoch - 1, best)
            self.log(f"Preemption: saved last.pth at epoch {epoch - 1} (mid-epoch stop)")
        elif self._last_epoch == epoch - 1:
            self.log(f"Preemption: last.pth stays at epoch {epoch - 1} (mid-epoch stop; "
                     f"the {steps} steps of epoch {epoch} are dropped)")
        else:
            self.log(f"Preemption: mid-epoch stop in epoch {epoch}, the first of this "
                     f"run; nothing saved (the {steps} steps are dropped)")

    @contextlib.contextmanager
    def _profiling(self, epoch: int):
        """`profile_epoch: N`: a torch.profiler trace of epoch N's train loop
        under {log_dir}/trace (data parallel: one a rank)."""
        target = self.cfg.extra.get("profile_epoch")
        if target is None or int(target) != epoch:
            yield
            return
        trace_dir = os.path.join(self.log_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.log(f"[profiler] tracing epoch {epoch} -> {trace_dir}")
        with torch.profiler.profile(activities=activities) as prof:
            yield
        rank = f".rank{self.layout.rank}" if self.layout else ""
        prof.export_chrome_trace(os.path.join(trace_dir, f"epoch{epoch}{rank}.pt.trace.json"))

    def train_epoch(self, epoch: int, best_criterion: float, best_epoch: int):
        start = time.time()
        self._epoch = epoch
        if self.scheduler is not None:
            self.state.set_learning_rate(self.scheduler.current_lr)
            if self.joint:
                self.gen_state.set_learning_rate(self.scheduler.current_lr)
        index = (0 if self.layout is None or self.sp > 1 else
                 self.mesh2d.data_index if self.mesh2d is not None else self.layout.rank)
        generator = self._epoch_generator(epoch, index * RANK_STREAM)
        aug_generator = self._epoch_generator(epoch, AUG_STREAM) if self.device_aug else None
        train_loader = self.loaders["train"]
        train_loader.set_epoch(epoch)
        metrics = None
        isw_extra = self._isw_masks()
        with self._profiling(epoch):
            for i, batch in enumerate(self._progress(train_loader,
                                                     f"Epoch {epoch}: Training...")):
                if self._stop_requested():
                    self._stop_mid_epoch(epoch, i, best_criterion)
                    return best_criterion, best_epoch
                batch = self._train_batch(batch, aug_generator)
                batch.update(isw_extra)
                if self.joint:
                    self.gen_state, self.state, metrics = self.joint_step(
                        self.gen_state, self.state, batch, generator, epoch)
                else:
                    self.state, metrics = self.train_step(self.state, batch, generator, epoch)
        if self.group is not None and metrics is not None:
            metrics = dp_mesh.average_metrics(metrics, self.group)
        # the loss is read back once per epoch: a per-batch read would
        # wait for the card every step
        train_loss = float(metrics["loss_total"]) if metrics is not None else float("nan")
        if metrics is not None and not math.isfinite(train_loss):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch}: "
                f"{ {k: float(v) for k, v in metrics.items()} }")
        self.log(f"Epoch {epoch}: Training loss: {train_loss:.4f} "
                 f"Version: {self.cfg.version}")
        if self.tb.enabled and metrics is not None:
            self.tb.scalars({k: float(v) for k, v in metrics.items()}, epoch,
                            prefix="train/")
            if self.scheduler is not None:
                self.tb.scalar("train/lr", self.scheduler.current_lr, epoch)

        # the scheduler steps per epoch, before validation (trainer.py:82-87)
        if self.scheduler is not None:
            self.scheduler.step(getattr(self, "_last_criterion", None))

        criterion = self.validate(epoch, best_criterion)
        self._last_criterion = criterion
        if self.tb.enabled:
            self.tb.scalar("val/criterion", criterion, epoch)
            self.tb.scalars(self._last_val_extra, epoch, prefix="val/")
            self.tb.scalar("time/epoch_s", time.time() - start, epoch)
            self.tb.flush()

        if criterion < best_criterion:
            best_criterion = criterion
            best_epoch = epoch
            self._save_last(epoch, best_criterion)
            self.log(f"Epoch {epoch}: saving best model...")
            self._save_best(epoch, criterion)
        else:
            self._save_last(epoch, best_criterion)
        return best_criterion, best_epoch

    def _isw_masks(self):
        """The tracker's (masks, nums, margins) on the device, for every
        train batch of an epoch; {} without a tracker."""
        if self.isw_tracker is None:
            return {}
        trees = self.isw_tracker.mask_batch()
        return {key: {k: v.to(self.device) for k, v in tree.items()}
                for key, tree in zip(("isw_masks", "isw_nums", "isw_margins"), trees)}

    def _cov_pass(self, sample):
        """ISW's covariance statistics of a val sample's two views, into
        the tracker."""
        with self.counter.evaluating():
            for x2 in covariance_views(self.counter, sample, self.patch_size):
                stats = self.model.cov_stats(x2)
                self.isw_tracker.add({k: v.cpu().numpy() for k, v in stats.items()})

    def _reconstruction_mse(self, sample) -> float:
        """The generator on img2 against img1, each padded whole to the
        counter's bucket: the MSE over the image's pixels and channels
        (the padding masked out; call inside ``counter.evaluating``)."""
        up = self.counter._upload
        img1, mask = self.counter._whole_image(up(sample["img1"]))
        img2, _ = self.counter._whole_image(up(sample.get("img2", sample["img1"])))
        out = self.counter.forward(img2).float().permute(0, 2, 3, 1)
        err = ((out - img1.float()) ** 2 * mask).sum()
        return float(err / (mask.sum() * img1.shape[-1]))

    def validate(self, epoch: int, best_criterion: float) -> float:
        crit = AverageMeter()
        extra = DictAvgMeter()
        start = time.time()
        if self.mode == "generation":
            # the generator's quality: the reconstruction error of the
            # photometric view, masked to the real image
            with self.state.ema_weights(), self.counter.evaluating():
                for sample in self.loaders["val"]:
                    crit.update(self._reconstruction_mse(sample))
            self.log(f"Epoch {epoch}: Val criterion: {crit.avg:.4f}", end=" ")
            self.log(f"best: {best_criterion:.4f}, time: {time.time() - start:.4f}")
            self._last_val_extra = {}
            return self._agreed(crit.avg)
        with self.state.ema_weights(), self._whole_model():
            for sample in self._progress(self.loaders["val"],
                                         f"Epoch {epoch}: Validating..."):
                pred = self.counter.count(sample["img1"])
                if self.isw_tracker is not None and "img2" in sample:
                    self._cov_pass(sample)
                gt_count = float(len(sample["gt"]))
                crit.update(abs(pred - gt_count))
                extra.update({"mse": (pred - gt_count) ** 2})
        if self.isw_tracker is not None and self.isw_tracker.has_stats():
            if self.host is not None:
                # every rank gathered the whole set: the mean gives every
                # rank the same bits, hence the same masks
                merged = allgather_mean({"var": self.isw_tracker.var,
                                         "count": np.float64(self.isw_tracker.count)},
                                        self.host)
                self.isw_tracker.var = list(merged["var"])
                self.isw_tracker.count = float(merged["count"])
            self.isw_tracker.set_mask_matrix()
        self.log(f"Epoch {epoch}: Val criterion: {crit.avg:.4f}", end=" ")
        for k, v in extra.avg.items():
            self.log(f"{k}: {v:.4f}", end=" ")
        self.log(f"best: {best_criterion:.4f}, time: {time.time() - start:.4f}")
        self._last_val_extra = dict(extra.avg)
        return self._agreed(crit.avg)

    def _agreed(self, value: float) -> float:
        """Rank 0's value on every rank (data parallel), so that the best
        epoch, the test after it and the early stop agree."""
        return value if self.host is None else dp_mesh.broadcast_float(value, self.host)

    def _one_process(self, task: str):
        if self.group is not None:
            raise NotImplementedError(f"{task} runs in one process on one card: drop the "
                                      "mesh key from the config for it")

    def _early_stop(self, epoch: int, best_epoch: int, best_criterion: float) -> bool:
        """`early_stop: N`: stop when the val criterion has not improved for
        N consecutive epochs (best_epoch survives a resume)."""
        patience = int(self.cfg.extra.get("early_stop", 0) or 0)
        if patience and epoch - best_epoch >= patience:
            self.log(f"Early stopping at epoch {epoch}: no val "
                     f"improvement for {patience} epochs "
                     f"(best {best_criterion:.4f} at epoch {best_epoch})")
            return True
        return False

    def _resume_point(self):
        """(start_epoch, best_criterion, best_epoch) after a checkpoint load."""
        r = self._resume
        if r:
            epoch = int(r["epoch"])
            best = float(r.get("best", 1e10))
            self.log(f"Resuming from epoch {epoch} (best {best:.4f})")
            return epoch + 1, best, epoch
        return 0, 1e10, -1

    def train(self, checkpoint=None, num_epochs: Optional[int] = None):
        self.build()
        self.log(f"Start training at {get_current_datetime()}")
        self.load_ckpt(checkpoint if checkpoint is not None else self.cfg.checkpoint)
        start_epoch, best_criterion, best_epoch = self._resume_point()
        try:
            with self._graceful_shutdown():
                for epoch in range(start_epoch, num_epochs or self.cfg.num_epochs):
                    best_criterion, best_epoch = self.train_epoch(epoch, best_criterion,
                                                                  best_epoch)
                    if self._stop_requested():
                        self.log(f"Preemption: stopped in or after epoch {epoch}; "
                                 "resume from last.pth")
                        break
                    if self._early_stop(epoch, best_epoch, best_criterion):
                        break
        finally:
            # deferred saves reach the disk also when the loop raises
            self.rotator.flush()
            self._close_loaders()
            self.tb.close()
        self.log(f"Best epoch: {best_epoch}, best criterion: {best_criterion}")
        self.log(f"Training results saved to {self.log_dir}")
        self.log(f"End training at {get_current_datetime()}")
        return best_criterion, best_epoch

    @contextlib.contextmanager
    def _graceful_shutdown(self):
        """SIGTERM / SIGINT only set ``_preempted`` inside: the epoch loop
        stops at the next batch or after the epoch. Handlers are installed
        from the main thread only, and the previous ones put back."""
        self._preempted = False

        def handler(signum, _frame):
            self._preempted = True
            self.log(f"Received signal {signum}: stopping at the next batch or after "
                     "this epoch, with last.pth saved")

        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev[sig] = signal.signal(sig, handler)
                except ValueError:  # not the main thread: no handler possible
                    pass
            yield
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)

    def _close_loaders(self):
        for loader in self.loaders.values():
            loader.close()

    def test(self, checkpoint=None, loader=None):
        self.build()
        self.log(f"Start testing at {get_current_datetime()}")
        if checkpoint is not None:
            self.load_ckpt(checkpoint)
        try:
            return self._test(loader or self.loaders["test"])
        finally:
            self.rotator.flush()

    def _test(self, loader):
        if self.mode == "generation":
            # no density: the test is validation's reconstruction error
            self.validate(-1, 1e10)
            self.log(f"End testing at {get_current_datetime()}")
            return {}
        meter = DictAvgMeter()
        rows = []
        counter, samples = self.counter, loader
        with self.state.ema_weights(), self._whole_model():
            if self.cfg.extra.get("test_quantized"):
                # a local counter on each rank (validate() keeps the fp one);
                # the calibration samples are replayed into the metric loop
                it = iter(loader)
                calib = list(itertools.islice(it, 4))
                counter = self._quantized_counter(calib)
                samples = itertools.chain(calib, it)
                self.log("Testing through the int8 PTQ serving graph")
            for i, sample in enumerate(self._progress(samples, "Testing...")):
                pred = counter.count(sample["img1"])
                gt_count = float(len(sample["gt"]))
                meter.update({"mae": abs(pred - gt_count), "mse": (pred - gt_count) ** 2})
                rows.append((str(sample.get("name", i)), gt_count, pred))
        if self.cfg.extra.get("test_report") and self.main:
            self._test_report(rows)
        self.log("Testing results:", end=" ")
        for k, v in meter.avg.items():
            self.log(f"{k}: {v:.4f}", end=" ")
        self.log("")

        # hard-coded re-save thresholds (trainer.py:154-160)
        test_mae = meter.avg["mae"]
        threshold = 15.5 if self.cfg.version.startswith("sta") else 105
        if test_mae < threshold:
            self.log("Saving test model...")
            with self._bank(self.state):
                self.rotator.save_test(self.state, test_mae)
        self.log(f"Testing results saved to {self.log_dir}")
        self.log(f"End testing at {get_current_datetime()}")
        if self.tb.enabled:
            self.tb.scalars(meter.avg, getattr(self, "_epoch", 0), prefix="test/")
            self.tb.flush()
        return meter.avg

    def _quantized_counter(self, calib_samples) -> TiledCounter:
        """``test_quantized: true``: a TiledCounter over the int8 serving graph
        (``nn/quant.py::build_quantized``) of the weights the test evaluates
        (the EMA shadow when ``ema:`` is on; the JAX trainer quantizes the raw
        parameters, ROADMAP.md Queue 3), calibrated on square top-left crops
        of min(256, the shortest side) of the given test samples."""
        from dgvcc_tpu_torch.nn.quant import GraphModule, build_quantized

        imgs = [s["img1"] for s in calib_samples]
        if not imgs:
            raise ValueError("test_quantized: empty test loader — nothing to calibrate "
                             "activation scales on")
        side = min(256, *(min(i.shape[0], i.shape[1]) for i in imgs))
        q = build_quantized(self.model, np.stack([i[:side, :side] for i in imgs]),
                            device=self.device)
        return TiledCounter(GraphModule(q), self.log_para, self.eval_patch_size,
                            device=self.device)

    def _test_report(self, rows):
        """`test_report: true` (or a path): a per-image CSV (name, gt, pred,
        error), worst first."""
        tr = self.cfg.extra["test_report"]
        path = os.path.join(self.log_dir, "test_report.csv") if tr is True else str(tr)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "gt_count", "pred_count", "abs_err"])
            for name, gt, pred in sorted(rows, key=lambda r: -abs(r[2] - r[1])):
                w.writerow([name, f"{gt:.1f}", f"{pred:.3f}", f"{abs(pred - gt):.3f}"])
        self.log(f"Per-image test report: {path} ({len(rows)} rows)")

    def train_and_test(self, checkpoint=None, num_epochs: Optional[int] = None):
        """Test on the target domain when val improves (dgtrainer.py:301-327),
        or after every epoch (``test_every_epoch``; basetrainer.py:149-173)."""
        self.build()
        every_epoch = every_epoch_test(self.cfg)
        self.log(f"Start training and testing at {get_current_datetime()}")
        self.load_ckpt(checkpoint if checkpoint is not None else self.cfg.checkpoint)
        start_epoch, best_criterion, best_epoch = self._resume_point()
        try:
            for epoch in range(start_epoch, num_epochs or self.cfg.num_epochs):
                prev = best_criterion
                best_criterion, best_epoch = self.train_epoch(epoch, best_criterion,
                                                              best_epoch)
                if every_epoch or best_criterion < prev:
                    self.test()
                if self._early_stop(epoch, best_epoch, best_criterion):
                    break
        finally:
            self.rotator.flush()
            self._close_loaders()
        self.log(f"Best epoch: {best_epoch}, best criterion: {best_criterion}")
        self.log(f"Training results saved to {self.log_dir}")
        self.log(f"End training and testing at {get_current_datetime()}")
        return best_criterion, best_epoch

    # ---- visualization -----------------------------------------------------

    def vis(self, checkpoint=None):
        """Per test image: the image, its density map and count for both
        views (and the classifier maps of a cls model), as PNGs under
        {log_dir}/vis."""
        self._one_process("--task vis")
        self.build()
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.log(f"Start visualization at {get_current_datetime()}")
        if checkpoint is not None:
            self.load_ckpt(checkpoint)
        vis_dir = os.path.join(self.log_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        has_cls = getattr(self.model, "use_cls", False) and self.mode != "base"
        with self.state.ema_weights():
            self._vis(vis_dir, has_cls, plt)
        self.log(f"Visualization results saved to {self.log_dir}")
        self.log(f"End visualization at {get_current_datetime()}")

    def _vis(self, vis_dir, has_cls, plt):
        for sample in self._progress(self.loaders["test"], "Visualizing..."):
            name = sample["name"]
            img1 = sample["img1"]
            img2 = sample.get("img2", img1)
            gt_count = len(sample["gt"])
            dmap1, dmap2 = (self.counter.density_map(x) for x in (img1, img2))
            c1, c2 = (self.counter.count(x) for x in (img1, img2))
            im1, im2 = (np.clip(denormalize(x), 0, 1) for x in (img1, img2))
            if has_cls:
                cmap1, cmap2 = (self._cls_map(x) for x in (img1, img2))
                datas = [im1, dmap1, cmap1, im2, dmap2, cmap2]
                titles = [name, f"Pred1: {c1:.2f}", "Cls1", f"GT: {gt_count}",
                          f"Pred2: {c2:.2f}", "Cls2"]
                fig = plt.figure(figsize=(15, 6))
                cols = 3
                plt.imsave(os.path.join(vis_dir, f"{name}_Cls.png"), cmap1)
                plt.imsave(os.path.join(vis_dir, f"{name}_BCls.png"),
                           (cmap1 >= 0.5).astype(np.float32))
                plt.imsave(os.path.join(vis_dir, f"{name}_Pred_{c1:.2f}.png"), dmap1)
            else:
                datas = [im1, dmap1, im2, dmap2]
                titles = [name, f"Pred1: {c1:.2f}", f"GT: {gt_count}", f"Pred2: {c2:.2f}"]
                fig = plt.figure(figsize=(10, 6))
                cols = 2
            for i, (d, t) in enumerate(zip(datas, titles)):
                ax = fig.add_subplot(2, cols, i + 1)
                ax.set_title(t)
                ax.imshow(d)
            fig.savefig(os.path.join(vis_dir, f"{name}.png"))
            plt.close(fig)

    def generate(self, checkpoint=None) -> str:
        """Restyled train images from the generator (its EMA shadow where the
        run keeps one) as ``{log_dir}/gen/{name}_a.jpg`` (JPEG quality 95;
        files that exist are kept): each image through the two-view
        photometric transform, seeded ``gen:{seed}:{index}``, padded to
        multiples of 16, then cropped back, denormalised and clipped. The
        datasets alias such names to their source's points (gen_root)."""
        self._one_process("--task generate")
        self.build()
        from PIL import Image

        if self.mode != "generation" and not self.joint:
            raise ValueError("generate requires mode 'generation' or 'joint'")
        if checkpoint is not None:
            self.load_ckpt(checkpoint)
        gen_dir = os.path.join(self.log_dir, "gen")
        os.makedirs(gen_dir, exist_ok=True)
        model = self.gen_model if self.joint else self.model
        state = self.gen_state if self.joint else self.state
        ds = self.loaders["train"].dataset
        base = getattr(ds, "base", ds)  # the dataset under a RawCropDataset
        photo = T.TwoViewPhotometric()
        was_training = model.training
        model.eval()
        try:
            with state.ema_weights(), torch.inference_mode():
                for idx, img_fn in enumerate(base.img_fns):
                    name = os.path.basename(img_fn).rsplit(".", 1)[0]
                    out_path = os.path.join(gen_dir, f"{name}_a.jpg")
                    if os.path.exists(out_path):
                        continue
                    img, _ = base._load_img(img_fn)
                    rng = random.Random(f"gen:{self.cfg.seed}:{idx}")
                    w, h = img.size
                    nw, nh = (w + 15) // 16 * 16, (h + 15) // 16 * 16
                    img_p = T.pil_pad(photo(img, rng), (0, 0, nw - w, nh - h))
                    x = self._upload(T.to_tensor_normalize(img_p)[None]).permute(0, 3, 1, 2)
                    out = model(x)[0, :, :h, :w].float().permute(1, 2, 0).cpu().numpy()
                    out = np.clip(denormalize(out), 0, 1)
                    Image.fromarray((out * 255).astype(np.uint8)).save(out_path, quality=95)
        finally:
            model.train(was_training)
        self.log(f"Generated images saved to {gen_dir}")
        return gen_dir

    def _cls_map(self, img):
        """Whole-image classifier map (stride 16, sigmoid probabilities)."""
        h, w, _ = img.shape
        with self.counter.evaluating():
            tiles, _ = self.counter._whole_image(self.counter._upload(img))
            c = self.counter.forward(tiles)[1]
        return c[0, 0, : h // 16, : w // 16].float().cpu().numpy()
