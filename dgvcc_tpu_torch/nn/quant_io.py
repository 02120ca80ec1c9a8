"""Int8 serving artifacts, counterpart of dgvcc_tpu/nn/quant_io.py.

``save_quantized`` writes a finished int8 graph (``nn/quant.py``) as one
msgpack document in the JAX package's ``dgvcc-int8-v1`` format, and
``load_quantized`` rebuilds the graph from it: no checkpoint, no
calibration frames, no fp forward. A replica serves it with
``VideoCounter.from_artifact`` or ``--task serve --artifact``; ``--task
quantize`` writes it.

The document is the JAX package's: ``format``, ``model_name``,
``model_params``, ``dtype``, ``family`` (``dg`` or ``convnet``),
``scales`` (site -> activation scale), ``sites`` in the JAX layout (an int8
site's ``w8`` HWIO int8 with ``ws`` and ``bias`` f32; an fp site's
``kernel`` HWIO and ``bias``, f32), the DG bank ``mem`` (K, S) f32 and a
convnet's ``extras`` f32 (dssinet's PReLU slopes; CCTrans's LayerNorm
parameters, a ``{scale, bias}`` dict a norm). So an artifact crosses between the packages
both ways (``utils/msgpack.py`` reads and writes flax's encoding; the port
turns the sites into the kernel's layout when it places them).

Beyond the JAX package (whose faults ROADMAP.md Queue 3 records), the port's
artifact also stores ``weight_only`` and ``int8_min_batch`` and honours
them on load; a JAX artifact, which has neither, loads as a full-int8 graph
with its family's batch floor (``nn/quant.py::family_min_batch``: CCTrans
8, the others 1).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from dgvcc_tpu_torch.utils import msgpack

ARTIFACT_FORMAT = "dgvcc-int8-v1"
_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}


def _plain(v):
    """msgpack-safe model params: tuples become lists, torch dtypes their
    names."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, torch.dtype):
        return _DTYPES[v]
    return v


def save_quantized(q, path: str, model_name: str,
                   model_params: Optional[Dict[str, Any]] = None) -> None:
    """Write a ``QuantizedDG`` / ``QuantizedConvNet`` as an artifact.
    ``model_name`` / ``model_params``: the registry identity
    (``MODELS.build(model_name, **model_params)``) the loader rebuilds the
    model's flags from."""
    from dgvcc_tpu_torch.nn.quant import QuantizedConvNet, QuantizedDG, tree_map

    params = {k: v for k, v in dict(model_params or {}).items() if k != "dtype"}
    doc: Dict[str, Any] = {
        "format": ARTIFACT_FORMAT,
        "model_name": model_name,
        "model_params": _plain(params),
        "dtype": _DTYPES[q.dtype],
        "scales": {k: float(v) for k, v in q.scales.items()},
        "sites": {name: {k: np.asarray(v) for k, v in site.items()}
                  for name, site in q.sites.items()},
        "weight_only": bool(q.weight_only),
        "int8_min_batch": int(getattr(q, "int8_min_batch", 1)),
    }
    if isinstance(q, QuantizedDG):
        doc["family"] = "dg"
        if "mem" in q.qparams:
            doc["mem"] = q.qparams["mem"].float().cpu().numpy()
    elif isinstance(q, QuantizedConvNet):
        doc["family"] = "convnet"
        if "extras" in q.qparams:
            doc["extras"] = tree_map(lambda t: t.float().cpu().numpy(), q.qparams["extras"])
    else:
        raise TypeError(f"not a quantized serving graph: {type(q).__name__}")
    with open(path, "wb") as f:
        f.write(msgpack.packb(doc))


class LoadedArtifact(NamedTuple):
    quantized: Any   # QuantizedDG | QuantizedConvNet, ready to call
    model: Any       # the registry-built module on the meta device: its flags, no weights
    doc: Dict[str, Any]  # the artifact's fields (model_name, scales, ...)


def load_quantized(path: str, dtype: Optional[torch.dtype] = None,
                   device="cuda") -> LoadedArtifact:
    """Rebuild the int8 serving graph of an artifact on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``). ``dtype`` overrides the stored
    serving dtype (float32 on the CPU). The model is built on the meta
    device, for its flags alone: nothing of it is allocated."""
    import dgvcc_tpu_torch.models  # noqa: F401  (registry population)
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.nn.quant import (QuantizedConvNet, QuantizedDG, _family_spec,
                                          family_min_batch)

    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read())
    if doc.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: not a {ARTIFACT_FORMAT} artifact "
                         f"(format={doc.get('format')!r})")
    dt = dtype if dtype is not None else getattr(torch, doc["dtype"])
    with torch.device("meta"):
        model = MODELS.build(doc["model_name"], dtype=dt, **doc.get("model_params", {}))
    if doc["family"] == "dg":
        q = QuantizedDG(doc["sites"], doc["scales"], QuantizedDG.model_flags(model),
                        doc.get("mem"), dt, device, bool(doc.get("weight_only", False)))
    elif doc["family"] == "convnet":
        if _family_spec(model) is None:
            raise ValueError(f"{path}: model {doc['model_name']!r} has no int8 serving spec")
        q = QuantizedConvNet.of(model, doc["sites"], doc["scales"], doc.get("extras"), dt,
                                device)
    else:
        raise ValueError(f"{path}: unknown family {doc['family']!r}")
    q.int8_min_batch = int(doc.get("int8_min_batch", family_min_batch(model)))
    return LoadedArtifact(q, model, doc)
