"""Factory registry of the PyTorch port.

A copy of ``dgvcc_tpu/core/registry.py``: the port keeps its own
registry so that its variant names (``final``, ``base``, ...) never
collide with the JAX package's, and so that it imports nothing of that
package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._fns: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, fn: Callable[..., Any] | None = None):
        """Register ``fn`` under ``name``; usable as a decorator."""

        def _do(f):
            if name in self._fns:
                raise KeyError(f"{self.name}: duplicate registration {name!r}")
            self._fns[name] = f
            return f

        if fn is not None:
            return _do(fn)
        return _do

    def build(self, name: str, **kwargs):
        return self.get(name)(**kwargs)

    def get(self, name: str):
        if name not in self._fns:
            raise ValueError(
                f"Unknown {self.name} {name!r}. Available: {sorted(self._fns)}"
            )
        return self._fns[name]


MODELS = Registry("model")
LOSSES = Registry("loss")
OPTIMIZERS = Registry("optimizer")
SCHEDULERS = Registry("scheduler")
