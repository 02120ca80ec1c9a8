"""Experiment trainer on one device, counterpart of dgvcc_tpu/train/trainer.py.

The reference's protocol (trainers/trainer.py:20, trainers/dgtrainer.py:27):
epoch loop -> per-epoch scheduler step -> per-image validation (MAE
criterion, MSE extra) -> rolling last / best checkpoints; test with the
hard-coded re-save thresholds; train_and_test tests only when val
improves. The ``log.txt`` lines are the JAX trainer's, word for word.

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
  * the dropout draws of epoch e come from a generator seeded from (seed,
    e), so a resumed epoch draws what the uninterrupted run drew.

Config keys of modules not ported raise with a pointer to ROADMAP.md
(``UNPORTED_KEYS``, ``UNPORTED_MODES``), as does ``pretrained_weights``.
"""

from __future__ import annotations

import csv
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from dgvcc_tpu_torch.core.config import Config
from dgvcc_tpu_torch.core.logging import RunLogger
from dgvcc_tpu_torch.core.registry import DATASETS, LOSSES, MODELS
from dgvcc_tpu_torch.core.tb import ScalarWriter
from dgvcc_tpu_torch.data.loader import build_loader
from dgvcc_tpu_torch.ops.tiling import TiledCounter
from dgvcc_tpu_torch.serve import resolve_device
from dgvcc_tpu_torch.train.checkpoint import CheckpointRotator, load_checkpoint
from dgvcc_tpu_torch.train.state import create_train_state
from dgvcc_tpu_torch.train.steps import build_train_step
from dgvcc_tpu_torch.utils.misc import (AverageMeter, DictAvgMeter, denormalize,
                                        get_current_datetime, progress, seed_everything)

# extra keys of the JAX trainer whose modules are not ported, and where
# ROADMAP.md lists them
UNPORTED_KEYS = {
    "device_aug": "Queue 1 item 5 (data on device)",
    "accum_steps": "Queue 1 item 8 (training extras)",
    "ema": "Queue 1 item 8 (training extras)",
    "async_save": "Queue 1 item 8 (training extras)",
    "test_quantized": "Queue 1 item 8 (int8)",
    "profile_epoch": "Queue 1 item 9",
    "pretrained_weights": "Queue 1 item 9",
}
UNPORTED_MODES = ("isw", "joint", "generation", "regression", "discrimination")
BATCH_KEYS = ("img1", "img2", "dmap", "bmap")


def config_device(cfg: Config, override: Optional[str] = None) -> str:
    """``cuda`` unless the override or the config's ``device:`` starts with
    ``cpu``; ``cuda:N`` is kept, the JAX package's ``tpu`` reads as cuda."""
    dev = str(override or cfg.device)
    if dev.startswith("cpu"):
        return "cpu"
    return dev if dev.startswith("cuda") else "cuda"


def check_ported(cfg: Config):
    """Raise on what the config asks of modules the port does not have."""
    for key, where in UNPORTED_KEYS.items():
        if cfg.extra.get(key):
            raise NotImplementedError(f"config key {key!r} is not ported to "
                                      f"dgvcc_tpu_torch yet; see ROADMAP.md, {where}")
    if any(int(v) > 1 for v in (cfg.mesh or {}).values()):
        raise NotImplementedError("config key 'mesh' (multi-device training) is not "
                                  "ported to dgvcc_tpu_torch yet; see ROADMAP.md, "
                                  "Queue 1 item 7")
    if cfg.mode in UNPORTED_MODES:
        raise NotImplementedError(f"mode {cfg.mode!r} is not ported to dgvcc_tpu_torch "
                                  "yet; see ROADMAP.md, Queue 1 item 6")


class DGTrainer:
    def __init__(self, cfg: Config, device: Optional[str] = None):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device or config_device(cfg))
        seed_everything(cfg.seed)
        self.log_dir = os.path.join(cfg.log_dir, cfg.version)
        self.logger = RunLogger(self.log_dir)
        self.rotator = CheckpointRotator(self.log_dir)
        # `tensorboard: true` adds TB scalars under {log_dir}/tb, additive to
        # log.txt; a no-op (and no extra readback) when off
        self.tb = ScalarWriter(os.path.join(self.log_dir, "tb"),
                               enabled=bool(cfg.extra.get("tensorboard")), warn=self.log)
        self.mode = cfg.mode
        self.log_para = float(cfg.log_para)
        self.patch_size = cfg.patch_size
        self._resume = None
        self._built = False

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

        if cfg.model["name"] not in MODELS:
            raise NotImplementedError(f"model {cfg.model['name']!r} is not ported to "
                                      "dgvcc_tpu_torch yet (the DG family is); see "
                                      "ROADMAP.md, Queue 1 item 6")
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        params = dict(cfg.model.get("params", {}))
        if params.pop("tp_axis", None) is not None:
            raise ValueError("model params must not set tp_axis")
        self.model = MODELS.build(cfg.model["name"], dtype=dtype, **params)
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))

        self.loaders = {}
        for split in ("train", "val", "test"):
            spec = getattr(cfg, f"{split}_dataset")
            if spec is None:
                continue
            ds = DATASETS.build(spec["name"], method=split, **spec.get("params", {}))
            self.loaders[split] = build_loader(ds, getattr(cfg, f"{split}_loader") or {},
                                               seed=cfg.seed)

        self.state = create_train_state(self.model, cfg.optimizer, cfg.scheduler,
                                        device=self.device)
        self.scheduler = self.state.scheduler
        # the 'nocon' ablation zeroes the final-mode consistency weight
        con_weight = 0.0 if cfg.extra.get("no_consistency") else 10.0
        self.train_step = build_train_step(self.model, self.loss, self.mode,
                                           self.log_para, con_weight=con_weight)
        # the DG family tiles at the config's patch_size (dgtrainer.py:71-84)
        self.counter = TiledCounter(self.model, self.log_para, self.patch_size,
                                    device=self.device)
        self._built = True

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        """Dropout draws of one epoch, seeded from (seed, epoch)."""
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.cfg.seed * 1_000_003 + epoch + 1) % (2**63))

    def _to_device(self, batch):
        """NHWC numpy -> NCHW (channels-last) tensors on the device, through
        pinned memory and a non-blocking copy."""
        out = {}
        for k in BATCH_KEYS:
            if k not in batch:
                continue
            t = torch.from_numpy(batch[k])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.permute(0, 3, 1, 2)
        return out

    # ---- checkpoints -----------------------------------------------------

    def load_ckpt(self, path, strict: bool = False):
        """A port or reference ``.pth`` and its training-state sidecar when
        there is one. ``strict`` raises on a missing, unexpected or
        mis-shaped weight."""
        if path is None:
            return
        if isinstance(path, (list, tuple)):
            raise NotImplementedError(
                "[gen_ckpt, reg_ckpt] checkpoint pairs belong to the joint and "
                "generation modes, which are not ported to dgvcc_tpu_torch yet; see "
                "ROADMAP.md, Queue 1 item 6")
        self.log(f"Loading checkpoint from {path}")
        extra, warnings = load_checkpoint(path, self.state, strict=strict)
        for w in warnings[:10]:
            self.log(f"  [ckpt] {w}")
        # exact resume: epoch, best and the scheduler from the sidecar
        self._resume = extra if "epoch" in extra else None
        if self._resume and self.scheduler is not None and "scheduler" in self._resume:
            self.scheduler.load_state_dict(self._resume["scheduler"])

    def _ckpt_extra(self, epoch, best):
        extra = {"epoch": epoch, "best": best}
        if self.scheduler is not None:
            extra["scheduler"] = self.scheduler.state_dict()
        return extra

    # ---- loops -------------------------------------------------------------

    def train_epoch(self, epoch: int, best_criterion: float, best_epoch: int):
        start = time.time()
        self._epoch = epoch
        if self.scheduler is not None:
            self.state.set_learning_rate(self.scheduler.current_lr)
        generator = self._epoch_generator(epoch)
        train_loader = self.loaders["train"]
        train_loader.set_epoch(epoch)
        metrics = None
        for batch in self._progress(train_loader, f"Epoch {epoch}: Training..."):
            self.state, metrics = self.train_step(self.state, self._to_device(batch),
                                                  generator, epoch)
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
            self.rotator.save_last(self.state, self._ckpt_extra(epoch, best_criterion))
            self.log(f"Epoch {epoch}: saving best model...")
            self.rotator.save_best(self.state, epoch, criterion)
        else:
            self.rotator.save_last(self.state, self._ckpt_extra(epoch, best_criterion))
        return best_criterion, best_epoch

    def validate(self, epoch: int, best_criterion: float) -> float:
        crit = AverageMeter()
        extra = DictAvgMeter()
        start = time.time()
        for sample in self._progress(self.loaders["val"], f"Epoch {epoch}: Validating..."):
            pred = self.counter.count(sample["img1"])
            gt_count = float(len(sample["gt"]))
            crit.update(abs(pred - gt_count))
            extra.update({"mse": (pred - gt_count) ** 2})
        self.log(f"Epoch {epoch}: Val criterion: {crit.avg:.4f}", end=" ")
        for k, v in extra.avg.items():
            self.log(f"{k}: {v:.4f}", end=" ")
        self.log(f"best: {best_criterion:.4f}, time: {time.time() - start:.4f}")
        self._last_val_extra = dict(extra.avg)
        return crit.avg

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
            for epoch in range(start_epoch, num_epochs or self.cfg.num_epochs):
                best_criterion, best_epoch = self.train_epoch(epoch, best_criterion,
                                                              best_epoch)
                if self._early_stop(epoch, best_epoch, best_criterion):
                    break
        finally:
            self.tb.close()
        self.log(f"Best epoch: {best_epoch}, best criterion: {best_criterion}")
        self.log(f"Training results saved to {self.log_dir}")
        self.log(f"End training at {get_current_datetime()}")
        return best_criterion, best_epoch

    def test(self, checkpoint=None, loader=None):
        self.build()
        self.log(f"Start testing at {get_current_datetime()}")
        if checkpoint is not None:
            self.load_ckpt(checkpoint)
        meter = DictAvgMeter()
        rows = []
        for i, sample in enumerate(self._progress(loader or self.loaders["test"],
                                                  "Testing...")):
            pred = self.counter.count(sample["img1"])
            gt_count = float(len(sample["gt"]))
            meter.update({"mae": abs(pred - gt_count), "mse": (pred - gt_count) ** 2})
            rows.append((str(sample.get("name", i)), gt_count, pred))
        if self.cfg.extra.get("test_report"):
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
            self.rotator.save_test(self.state, test_mae)
        self.log(f"Testing results saved to {self.log_dir}")
        self.log(f"End testing at {get_current_datetime()}")
        if self.tb.enabled:
            self.tb.scalars(meter.avg, getattr(self, "_epoch", 0), prefix="test/")
            self.tb.flush()
        return meter.avg

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
        """Test on the target domain when val improves (dgtrainer.py:301-327)."""
        self.build()
        self.log(f"Start training and testing at {get_current_datetime()}")
        self.load_ckpt(checkpoint if checkpoint is not None else self.cfg.checkpoint)
        start_epoch, best_criterion, best_epoch = self._resume_point()
        for epoch in range(start_epoch, num_epochs or self.cfg.num_epochs):
            prev = best_criterion
            best_criterion, best_epoch = self.train_epoch(epoch, best_criterion, best_epoch)
            if best_criterion < prev:
                self.test()
            if self._early_stop(epoch, best_epoch, best_criterion):
                break
        self.log(f"Best epoch: {best_epoch}, best criterion: {best_criterion}")
        self.log(f"Training results saved to {self.log_dir}")
        self.log(f"End training and testing at {get_current_datetime()}")
        return best_criterion, best_epoch

    # ---- visualization -----------------------------------------------------

    def vis(self, checkpoint=None):
        """Per test image: the image, its density map and count for both
        views (and the classifier maps of a cls model), as PNGs under
        {log_dir}/vis."""
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
        self.log(f"Visualization results saved to {self.log_dir}")
        self.log(f"End visualization at {get_current_datetime()}")

    def _cls_map(self, img):
        """Whole-image classifier map (stride 16, sigmoid probabilities)."""
        h, w, _ = img.shape
        with self.counter.evaluating():
            tiles, _ = self.counter._whole_image(self.counter._upload(img))
            c = self.counter.forward(tiles)[1]
        return c[0, 0, : h // 16, : w // 16].float().cpu().numpy()
