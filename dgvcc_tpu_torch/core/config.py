"""YAML experiment configs.

A copy of ``dgvcc_tpu/core/config.py``, so that the port reads the same
files (``configs/*.yml``) without importing the JAX package. The schema
is the reference's: top-level keys ``seed, version, device, log_para,
patch_size, mode, num_epochs, checkpoint, model,
{train,val,test}_dataset, {train,val,test}_loader, loss, optimizer,
scheduler``, plus ``compute_dtype`` ('bfloat16' | 'float32') and the
JAX package's extensions, which land in ``extra`` when this dataclass
does not name them.

``device``: the port serves on ``cuda`` unless the value starts with
``cpu`` (cli/main.py); the JAX package's ``tpu`` reads as ``cuda``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import yaml


@dataclasses.dataclass
class Config:
    seed: int = 0
    version: str = "debug"
    device: str = "tpu"
    log_para: float = 1000.0
    patch_size: int = 1440
    mode: str = "simple"
    num_epochs: int = 100
    checkpoint: Optional[Any] = None  # path or [gen_path, reg_path]
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loss: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train_dataset: Optional[Dict[str, Any]] = None
    val_dataset: Optional[Dict[str, Any]] = None
    test_dataset: Optional[Dict[str, Any]] = None
    train_loader: Dict[str, Any] = dataclasses.field(default_factory=dict)
    val_loader: Dict[str, Any] = dataclasses.field(default_factory=dict)
    test_loader: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scheduler: Optional[Dict[str, Any]] = None
    compute_dtype: str = "bfloat16"
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    donate: bool = True
    log_dir: str = "logs"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**kwargs)
        cfg.extra.update(extra)
        return cfg


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f)
    return Config.from_dict(raw)
