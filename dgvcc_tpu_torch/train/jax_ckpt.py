"""The JAX package's checkpoints (``*.ckpt``) read without JAX, flax or
msgpack.

``dgvcc_tpu/train/checkpoint.py`` writes the train state as one msgpack
document through ``flax.serialization``: a map of ``params``,
``batch_stats``, ``opt_state``, ``step``, optionally ``ema_params`` and
``extra`` (epoch, best, the scheduler's state). This module decodes the
subset of msgpack that writer emits (maps, arrays, strings, bin, ints,
floats, nil, bool, and flax's ext types: 1 = ndarray as ``(shape, dtype
name, buffer)``, 3 = a numpy scalar packed the same way), and flax's
chunked form of arrays above 2**30 bytes. Arrays come back as numpy
arrays (bfloat16 widened to float32, numpy has no bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated document")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _LENGTHS:  # bin, str, ext, array, map with a length field
            kind, fmt = _LENGTHS[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(self.unpack(">b"), n)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1 .. 16
            code = self.unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} is not in the subset "
                         "flax.serialization writes")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).read()
            arr = _array(buf, dtype.decode() if isinstance(dtype, bytes) else dtype, shape)
            return arr[()] if code == EXT_NPSCALAR else arr
        if code == EXT_COMPLEX:
            re_, im = _Reader(payload).read()
            return complex(re_, im)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _array(buf: bytes, dtype: str, shape) -> np.ndarray:
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """One msgpack document of flax.serialization's subset -> Python
    objects and numpy arrays (chunked arrays joined)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the document")
    return _unchunk(out)


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's ``.ckpt`` as a dict of numpy trees."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def to_python(tree):
    """0-d arrays in ``extra`` (epoch, best, scheduler state) -> Python
    scalars."""
    if isinstance(tree, dict):
        return {k: to_python(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim == 0:
        return tree.item()
    if isinstance(tree, np.generic):
        return tree.item()
    return tree
