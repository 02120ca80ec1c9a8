"""The subset of msgpack that ``flax.serialization`` writes, read and written
without msgpack, flax or JAX.

``unpackb`` decodes maps, arrays, strings, bin, ints, floats, nil, bool, and
flax's ext types (1 = ndarray as ``(shape, dtype name, buffer)``, 3 = a
numpy scalar packed the same way), and flax's chunked form of arrays above
2**30 bytes. Arrays come back as numpy arrays (bfloat16 widened to float32,
numpy has no bfloat16). ``packb`` writes the same subset as
``flax.serialization.msgpack_serialize`` does: dicts with string keys,
lists, str, bool, None, Python ints and floats (float64), numpy arrays as
ext type 1 and numpy scalars as ext type 3 (arrays above 2**30 bytes are
refused, not chunked). The JAX package's checkpoints (``train/jax_ckpt.py``)
and int8 artifacts (``nn/quant_io.py``) go through here.
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


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        if 0 <= obj <= 0x7F:
            out.append(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            out.append(b"\xcf" + struct.pack(">Q", obj))
        else:
            out.append(b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        _header(out, len(obj.encode("utf-8")), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out.append(obj.encode("utf-8"))
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, list):
        _header(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.nbytes > 2**30:
            raise TypeError(f"msgpack: cannot pack a {arr.dtype} array of {arr.nbytes} bytes")
        body = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], body)
        payload = b"".join(body)
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        _header(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
        out.append(payload)
    else:
        raise TypeError(f"msgpack: {type(obj).__name__} is not in the subset flax writes")


def _header(out: list, n: int, fix, fix_max: int, wide) -> None:
    """A length header: the fix form below ``fix_max``, else 8, 16 or 32 bits
    (``wide``: the three type bytes; None where the form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, limit in zip(wide, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def packb(obj: Any) -> bytes:
    """One msgpack document of the subset ``flax.serialization`` writes;
    ``flax.serialization.msgpack_restore`` and ``unpackb`` read it back."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
