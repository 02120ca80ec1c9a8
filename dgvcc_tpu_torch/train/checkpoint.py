"""Checkpoints, counterpart of dgvcc_tpu/train/checkpoint.py.

The reference's artifact contract (trainers/trainer.py:106-115): a rolling
``last``, a rolling ``best_{epoch}_{criterion:.4f}`` and the
threshold-gated ``test_{mae}``, under the run's log dir. Each is a
``.pth`` holding a plain state_dict of the raw weights in the reference
DGVCC key layout, so a reference DGModel and
``VideoCounter.from_checkpoint`` strict-load it.

Beside each goes a training-state sidecar, ``{stem}.state.pt``: the
optimizer's ``state_dict`` (AdamW moments), the step count, ``extra``
(``epoch``, ``best``, the scheduler's state), and where the run keeps
them the EMA shadow (``ema``) and the accumulation window (``accum``: its
length, the micro steps folded in and the running mean). With it a resume
is exact, also in the middle of a window, as from the JAX package's
``last.ckpt``. Both files are written to ``.tmp`` names first and renamed
only when both are complete; the rotation purge runs after the write and
removes a sidecar with its checkpoint. ``async_save`` hands the writes to
one background thread (``AsyncWriter``) after a clone of the state on the
device, so the next step can change the state in place.

Loading is non-strict like the reference (``load_state_dict(strict=False)``,
trainer.py:41-44): matching weights are restored, a missing, unexpected or
mis-shaped one is a warning; ``strict=True`` raises on any of them. The
JAX package's msgpack ``.ckpt`` loads too (``train/jax_ckpt.py``): its
params and batch statistics (and EMA params) go through
``nn/convert.py::state_dict_from_flax`` for the model's family; step and
extra are restored;
its optax state is not mapped onto ``torch.optim`` (a warning, as for a
changed optimizer).
"""

from __future__ import annotations

import atexit
import copy
import os
import queue
import threading
from glob import glob
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dgvcc_tpu_torch.nn.convert import (drop_reference_unused, load_reference_pth,
                                        state_dict_from_flax)
from dgvcc_tpu_torch.train.jax_ckpt import read_jax_checkpoint, to_python

SUFFIX = ".pth"
SIDECAR = ".state.pt"
JAX_SUFFIX = ".ckpt"


def sidecar_path(path: str) -> str:
    """The training-state file that goes with checkpoint ``path``."""
    stem = path[: -len(SUFFIX)] if path.endswith(SUFFIX) else path
    return stem + SIDECAR


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return copy.deepcopy(obj)


def _payload(state, extra: Optional[Dict[str, Any]], clone: bool):
    """(weights, training state) of ``state``; with ``clone`` every tensor
    is copied on its device, so the next step may change the state."""
    take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
    weights = {k: take(v) for k, v in state.model.state_dict().items()}
    train = {"optimizer": _map_tensors(state.optimizer.state_dict(), take),
             "step": int(state.step), "extra": copy.deepcopy(dict(extra or {}))}
    if state.ema_params is not None:
        train["ema"] = {k: take(v) for k, v in state.ema_params.items()}
    if state.accum_steps > 1:
        names = [n for n, _ in state.model.named_parameters()]
        train["accum"] = {"steps": state.accum_steps, "mini_step": state.mini_step,
                          "acc_grads": {n: take(a) for n, a in zip(names, state.acc_grads)}}
    return weights, train


def _write(*items) -> None:
    """Each (path, weights, training state) as the checkpoint and its
    sidecar: every file staged on the host before any rename, so a crash
    leaves the previous set whole (a [gen, reg] pair never mixes epochs)."""
    staged = []
    for path, weights, train in items:
        for p, obj in ((path, weights), (sidecar_path(path), train)):
            torch.save(_map_tensors(obj, lambda t: t.cpu()), p + ".tmp")
            staged.append(p)
    for p in staged:
        os.replace(p + ".tmp", p)


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state``'s model weights to ``path`` and the rest of it and
    ``extra`` to the sidecar."""
    _write((path, *_payload(state, extra, clone=False)))


def _merge(state, loaded: Dict[str, torch.Tensor], warnings: List[str]):
    """The loaded weights that fit the model; what does not fit is a
    warning."""
    current = state.model.state_dict()
    warnings += [f"unexpected in checkpoint: {k}" for k in loaded if k not in current]
    merged = {}
    for k, v in current.items():
        if k not in loaded:
            warnings.append(f"missing in checkpoint: {k}")
        elif tuple(loaded[k].shape) != tuple(v.shape):
            warnings.append(f"shape mismatch at {k}: ckpt {tuple(loaded[k].shape)} vs "
                            f"model {tuple(v.shape)}")
        else:
            merged[k] = loaded[k]
    return merged


def _restore_ema(state, ema: Optional[Dict[str, torch.Tensor]], warnings: List[str]):
    if state.ema_params is None:
        if ema is not None:
            warnings.append("ema: present in the checkpoint but ema is off for this "
                            "run; ignored (set `ema:` in the config to evaluate it)")
        return
    if ema is None:
        state.seed_ema()
        warnings.append("ema: seeded from the checkpoint's weights (none saved)")
        return
    for name, e in state.ema_params.items():
        if name in ema and tuple(ema[name].shape) == tuple(e.shape):
            e.copy_(ema[name])
        else:
            e.copy_(dict(state.model.named_parameters())[name].detach())
            warnings.append(f"ema: {name} seeded from the weights (not in the checkpoint)")


def _restore_accum(state, accum: Optional[Dict[str, Any]], warnings: List[str]):
    if state.accum_steps == 1:
        if accum is not None and accum["mini_step"]:
            warnings.append(f"accumulator: a window of {accum['mini_step']} micro steps "
                            "is in the checkpoint but this run does not accumulate; "
                            "ignored")
        return
    state.mini_step = 0
    torch._foreach_zero_(state.acc_grads)
    if accum is None or accum["steps"] != state.accum_steps:
        warnings.append("accumulator not restored: "
                        + ("none saved" if accum is None else
                           f"saved for accum_steps {accum['steps']}")
                        + f"; a new window of {state.accum_steps} starts")
        return
    names = [n for n, _ in state.model.named_parameters()]
    for name, acc in zip(names, state.acc_grads):
        acc.copy_(accum["acc_grads"][name])
    state.mini_step = int(accum["mini_step"])


def _load_jax(path: str, state, warnings: List[str]):
    """The JAX package's msgpack checkpoint -> (weights, training state)."""
    loaded = read_jax_checkpoint(path)
    weights = state_dict_from_flax(state.model, loaded.get("params", {}),
                                   loaded.get("batch_stats", {}))
    train = {"step": int(loaded.get("step", state.step)),
             "extra": to_python(loaded.get("extra", {}))}
    if "ema_params" in loaded:
        train["ema"] = state_dict_from_flax(state.model, loaded["ema_params"], None)
    if "opt_state" in loaded:
        warnings.append("optimizer state not restored: the JAX package's optax state "
                        "is not mapped onto torch.optim")
    return weights, train


def load_checkpoint(path: str, state, strict: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    """Restore checkpoint ``path`` into ``state``: a port or reference
    ``.pth`` and its sidecar when there is one, or a JAX ``.ckpt``.
    Returns (extra, warnings); ``extra`` is {} without a training state.
    ``strict`` raises on the weights' warnings only: the optimizer, EMA and
    accumulator states are derived, and a changed optimizer is no fault."""
    path = str(path)
    train_warnings: List[str] = []
    if path.endswith(JAX_SUFFIX):
        weights, train = _load_jax(path, state, train_warnings)
    elif path.endswith((".pth", ".pt")):
        weights = drop_reference_unused(load_reference_pth(path), state.model)
        side = sidecar_path(path)
        train = (torch.load(side, map_location="cpu", weights_only=True)
                 if os.path.exists(side) else None)
    else:
        raise ValueError(f"checkpoint {path!r}: not a .pth, .pt or .ckpt file")
    warnings: List[str] = []
    merged = _merge(state, weights, warnings)
    if strict and warnings:
        raise ValueError("strict load failed:\n" + "\n".join(warnings))
    state.model.load_state_dict(merged, strict=False)
    warnings += train_warnings
    train = train or {}
    if "optimizer" in train:
        try:
            state.optimizer.load_state_dict(train["optimizer"])
        except (ValueError, KeyError) as e:  # the optimizer changed: weights only
            warnings.append(f"optimizer state not restored: {e}")
    _restore_ema(state, train.get("ema"), warnings)
    _restore_accum(state, train.get("accum"), warnings)
    state.step = int(train.get("step", state.step))
    return train.get("extra", {}), warnings


class AsyncWriter:
    """One background writer: jobs (the host copy, ``torch.save``, rename
    and rotation) run in submission order on one daemon thread.
    ``flush()`` waits for the queue and re-raises the first failure; call
    it before reading a file this writer may still be writing."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._loop, name="checkpoint-writer",
                                   daemon=True)
        self._t.start()
        # a daemon thread dies with the interpreter: drain it first
        atexit.register(self.flush)

    def _loop(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                job()
            except Exception as e:  # surfaced by flush() / submit()
                self._err = self._err or e
            finally:
                self._q.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        if self._err is not None:
            self.flush()  # raises
        self._q.put(job)

    def flush(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def close(self) -> None:
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        atexit.unregister(self.flush)
        self.flush()


class CheckpointRotator:
    """The reference's rolling last / best files (trainer.py:106-115) under
    a log dir, single or as [gen, reg] pairs (``last_gen`` / ``last_reg``,
    ``best_{epoch}_{crit}_gen`` / ``_reg``: dgtrainer.py:43-48, as the JAX
    package names them); with a ``writer`` the saves are deferred to it.
    ``write=False`` (a data-parallel rank other than 0) saves nothing: rank
    0 alone writes, whose parameters and statistics are every rank's."""

    def __init__(self, log_dir: str, writer: Optional[AsyncWriter] = None,
                 write: bool = True):
        self.log_dir = log_dir
        self.writer = writer
        self.write = write

    def _path(self, stem: str) -> str:
        return os.path.join(self.log_dir, stem + SUFFIX)

    def _purge(self, pattern: str, keep):
        for old in glob(os.path.join(self.log_dir, pattern + SUFFIX)):
            if old not in keep:
                os.remove(old)
                if os.path.exists(sidecar_path(old)):
                    os.remove(sidecar_path(old))

    def _save(self, entries, extra, purge: Optional[str] = None):
        """One save of (stem, state) entries, then the rotation purge: purging
        first would open a window in which the previous checkpoint is gone
        and the new one not yet written. Async: the states are cloned now,
        on their device, and written, then purged, on the writer's thread.
        Returns the first path."""
        paths = [self._path(stem) for stem, _ in entries]
        if not self.write:
            return paths[0]

        def job(payloads):
            _write(*((p, *payload) for p, payload in zip(paths, payloads)))
            if purge:
                self._purge(purge, keep=set(paths))

        clone = self.writer is not None
        payloads = [_payload(state, extra, clone=clone) for _, state in entries]
        if clone:
            self.writer.submit(lambda: job(payloads))
        else:
            job(payloads)
        return paths[0]

    def flush(self):
        """Wait until every deferred save is on disk (no-op when sync)."""
        if self.writer is not None:
            self.writer.flush()

    def save_last(self, state, extra=None):
        return self._save([("last", state)], extra, purge="last*")

    def save_best(self, state, epoch: int, criterion: float, extra=None):
        return self._save([(f"best_{epoch}_{criterion:.4f}", state)], extra, purge="best*")

    def save_test(self, state, mae: float, extra=None):
        return self._save([(f"test_{mae}", state)], extra)

    def save_last_pair(self, gen_state, reg_state, extra=None):
        return self._save([("last_gen", gen_state), ("last_reg", reg_state)], extra,
                          purge="last*")

    def save_best_pair(self, gen_state, reg_state, epoch: int, criterion: float, extra=None):
        stem = f"best_{epoch}_{criterion:.4f}"
        return self._save([(stem + "_gen", gen_state), (stem + "_reg", reg_state)], extra,
                          purge="best*")


def wait_for_rank0(rotator: CheckpointRotator, group=None) -> None:
    """Before a data-parallel rank reads a file that rank 0 may have just
    saved: rank 0's deferred saves reach the disk, then every rank waits
    at a barrier of ``group``."""
    rotator.flush()
    torch.distributed.barrier(group=group)
